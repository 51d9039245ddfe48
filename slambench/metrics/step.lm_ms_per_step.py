"""Stream milliseconds per batched frame of the pose LMs: the program's two
``step.lm`` spans a frame (``optimize_pose`` in ``TrackingStep.track``)
of the profiled call, from their CUDA events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "loc", "step.lm")
