"""Least time of a request's retrieval work over its synchronised retrieval span, %."""

from portbench import readers


def read(rec):
    return readers.retrieve_bound_pct(rec)
