"""Distances, top-k, the exact-NN oracle, Hamming probe schedules and the
hand-written kernels."""
