"""Users whose top-N coins returned in the window, a second."""

from portbench import readers


def read(rec):
    return readers.rows_per_s(rec)
