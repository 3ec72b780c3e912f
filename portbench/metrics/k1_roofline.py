"""K1's bound over the device time of its kernels in the traced requests, %."""

from portbench import readers


def read(rec):
    return readers.traced_share_pct(rec, readers.K1_KERNELS, readers.k1_seconds)
