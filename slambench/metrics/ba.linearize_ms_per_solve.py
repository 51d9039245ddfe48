"""Stream milliseconds per global BA solve of the linearization: the
program's ``ba.linearize`` spans (``optim/ba``: residuals, Jacobians and
the segment sums up to ``W``, once an LM iteration) of the profiled
solves, from their CUDA events."""

from slambench.spans import stream_ms


def read(r):
    return stream_ms(r, "ba", "ba.linearize")
