"""Device-stream ms of `retrieve` less its `k1` and `s1` spans a traced request."""

from portbench import spans


def read(rec):
    return spans.glue_ms(rec)
