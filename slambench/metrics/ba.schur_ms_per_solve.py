"""Stream milliseconds per global BA solve of the Schur assembly: the
program's ``ba.schur`` spans (``optim/ba``: the damping, ``V^-1`` and the
reduced camera system with its right-hand side, once an LM iteration) of
the profiled solves, from their CUDA events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "ba", "ba.schur")
