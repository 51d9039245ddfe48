"""Stream milliseconds per batched frame of the extraction: the program's
``step.extract`` spans (``slam/fused_step.TrackingStep.extract``: ORB
extraction and undistortion) of the profiled call, from their CUDA
events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "loc", "step.extract")
