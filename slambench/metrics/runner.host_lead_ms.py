"""How far the host runs ahead of the card at the step's stage boundaries,
in ms: the median, over every ``step.*`` span's close in the profiled
call, of the time the stream reached the closing CUDA event less the
host time at which the host recorded it. Tens of ms where the card paces
(the launch queue is full); about 0 where the card waits for the host."""

from slambench.spans import host_lead_ms


def read(r):
    return host_lead_ms(r, "loc", "step.")
