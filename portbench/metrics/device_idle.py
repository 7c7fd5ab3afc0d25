"""device_idle: the share of the profiled sub-window in which no kernel, copy
or fill ran on the card (1 - their union over the window), in percent
(device trace; offline cells)."""

from portbench.devtrace import idle_percent


def read(rec):
    return idle_percent(rec.trace)
