"""Share of the profiled localization call's wall time in which no
operation ran on the device, in %: 100 (1 - busy / window), busy the
union of the device intervals."""


def read(r):
    if r["kind"] != "loc":
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
