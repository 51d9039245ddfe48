"""Stream milliseconds per batched frame of the projection matches: the
program's two ``step.match`` spans a frame (``search_by_projection`` in
``TrackingStep.track``) of the profiled call, from their CUDA events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "loc", "step.match")
