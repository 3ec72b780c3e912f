"""K2's FFMA bound over its device time in a traced index build, %."""

from portbench import readers


def read(rec):
    return readers.k2_build_pct(rec)
