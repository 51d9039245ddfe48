"""Kernel launch calls the host makes per batched frame of the
multi-sequence runner (``parallel/multiseq`` over ``slam/fused_step``),
from the profiled call's runtime events."""


def read(r):
    if r["kind"] != "loc":
        return None
    return r["launches"] / r["steps"]
