"""Device milliseconds per global BA solve: the kernels, copies and fills
of the profiled solves, summed."""


def read(r):
    if r["kind"] != "ba":
        return None
    return r["device_s"] * 1e3 / r["steps"]
