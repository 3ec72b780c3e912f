"""Cosine hyperplane and euclidean p-stable LSH, the CSR / packed-slab index,
the hypercube and the MultiCube."""
