"""Device-stream ms of the program's `pack` span in the traced index build."""

from portbench import spans


def read(rec):
    return spans.per_call_stream_ms(rec, "pack")
