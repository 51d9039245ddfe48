"""Share of the 6x6 blocks of the reduced camera system that the Schur
assembly computes and that are structurally nonzero, in %: 100 x the
program's counter ``ba.schur_blocks_nonzero`` (pairs of in-window free
cameras that observe one valid point) over ``ba.schur_blocks_computed``
of the profiled solves."""

from slambench.spans import share


def read(r):
    return share(r, "ba", "ba.schur_blocks_nonzero", "ba.schur_blocks_computed")
