"""Stream milliseconds per global BA solve of the factor and update: the
program's ``ba.factor`` spans (``optim/ba``: the Cholesky solve, the
points' back-substitution, the update's cost and the gate, once an LM
iteration) of the profiled solves, from their CUDA events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "ba", "ba.factor")
