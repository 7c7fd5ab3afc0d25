"""device_idle.rt: ``device_idle`` of a realtime cell's profiled steps, in
percent (device trace)."""

from portbench.devtrace import idle_percent


def read(rec):
    return idle_percent(rec.trace)
