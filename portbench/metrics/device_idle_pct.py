"""Share of the traced span of requests in which no device op ran, %."""

from portbench import readers


def read(rec):
    return readers.device_idle_pct(rec)
