"""Mean seconds of build_index + pack_index over the timed rebuilds of set-up."""

from portbench import readers


def read(rec):
    return readers.mean_build_s(rec)
