"""Random-hyperplane (cosine / SimHash) LSH.

Reference semantics:
* one h-function = one hyperplane r ~ N(0,1)^d, bit = 1 iff r.x >= 0
  (reference lib/generators/cosine_h_gen.hpp:53-76);
* one g-function = k h-bits concatenated MSB-first into a bucket id in
  [0, 2^k) (cosine_g_gen.hpp:62-72);
* L independent g-functions = L tables (lsh_cube.hpp:63-66).

The n * L * k dot products are one [n, d] x [d, L*k] product plus a sign
and bit pack: kernel K2 (ops/kernels/signproj.py) on CUDA tensors, its
plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids


@dataclasses.dataclass
class CosineLsh:
    """Parameters of L tables x k hyperplanes."""

    proj: torch.Tensor  # [d, L * k] float32, N(0, 1)
    k: int
    L: int

    @property
    def n_buckets(self) -> int:
        return 1 << self.k

    @classmethod
    def create(
        cls, generator: torch.Generator, dim: int, k: int, L: int,
        device: torch.device,
    ) -> "CosineLsh":
        """Draw the hyperplanes from `generator` (on its own device) and
        place them on `device`."""
        proj = torch.randn(
            dim, L * k, generator=generator, dtype=torch.float32,
            device=generator.device,
        )
        return cls(proj=proj.to(device), k=k, L=L)

    def bucket_ids(self, x: torch.Tensor) -> torch.Tensor:
        """[n, d] -> [n, L] int32 bucket ids, bits packed MSB-first
        (cosine_g_gen.hpp:62-72: first h occupies the highest bit)."""
        return signproj_bucket_ids(x, self.proj, self.k, self.L)
