"""Share of the map slots the projection matches project that fall in the
frame (``n_visible``), in %: 100 x the program's counter
``step.visible_slots`` over ``step.projected_slots`` (B x P a match) of
the profiled call."""

from slambench.spans import share


def read(r):
    return share(r, "loc", "step.visible_slots", "step.projected_slots")
