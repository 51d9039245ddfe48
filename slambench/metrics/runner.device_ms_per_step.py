"""Device milliseconds per batched frame of the multi-sequence runner: the
kernels, copies and fills of the profiled call, summed."""


def read(r):
    if r["kind"] != "loc":
        return None
    return r["device_s"] * 1e3 / r["steps"]
