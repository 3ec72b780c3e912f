"""Cosine hyperplane LSH and its CSR / packed-slab index."""
