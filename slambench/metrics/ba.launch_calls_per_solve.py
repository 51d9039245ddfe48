"""Kernel launch calls the host makes per global BA solve (``optim/ba.py``,
``optim/segment.py``), from the profiled solves' runtime events."""


def read(r):
    if r["kind"] != "ba":
        return None
    return r["launches"] / r["steps"]
