"""95th percentile of every request's latency in the window, ms."""

from portbench import readers


def read(rec):
    return readers.request_p95_ms(rec)
