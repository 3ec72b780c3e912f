"""S1's byte bound over the device time of its kernels in the traced requests, %."""

from portbench import readers


def read(rec):
    return readers.traced_share_pct(rec, readers.S1_KERNELS, readers.s1_seconds)
