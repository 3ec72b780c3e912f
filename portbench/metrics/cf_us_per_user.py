"""Synchronised span of recommend_topk_retrieved, us a user."""

from portbench import readers


def read(rec):
    return readers.after_retrieval_us_per_row(rec)
