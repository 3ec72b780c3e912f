"""Distances, top-k, the exact-NN oracle and the hand-written kernels."""
