"""Seconds from the start of the process to the start of the window."""

from portbench import readers


def read(rec):
    return rec.setup_s
