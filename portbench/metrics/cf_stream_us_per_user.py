"""Device-stream us of the program's `cf` span a user of the traced requests."""

from portbench import spans


def read(rec):
    return spans.per_row_stream_us(rec, "cf")
