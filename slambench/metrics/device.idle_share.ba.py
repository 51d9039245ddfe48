"""Share of the profiled global BA solves' wall time in which no operation
ran on the device, in %: 100 (1 - busy / window)."""


def read(r):
    if r["kind"] != "ba":
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
