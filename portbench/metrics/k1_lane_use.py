"""K1's lanes that hold rows of the query's own bucket window over its lanes, %."""

from portbench import spans


def read(rec):
    return spans.counter_share_pct(rec, "k1.window_rows", "k1.lanes")
