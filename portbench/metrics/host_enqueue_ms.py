"""Mean host ms a request spends in the library's calls before it synchronises."""

from portbench import readers


def read(rec):
    return readers.host_enqueue_ms(rec)
