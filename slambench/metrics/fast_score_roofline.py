"""Share of its roofline that the ``fast_score`` kernel reaches in the
profiled call, in %: the least time the card could take (the larger of
its bytes over 3.35 TB/s and its operations over their peak, from the
cell's shapes, ``slambench/peaks.py``) over the kernel's mean traced
time a launch."""

from slambench.peaks import bound_s


def read(r):
    seconds, launches = r["kernels"].get("fast_score", (0.0, 0))
    work = r["work"].get("fast_score")
    if not launches or not work or seconds <= 0.0:
        return None
    return 100.0 * bound_s(*work) / (seconds / launches)
