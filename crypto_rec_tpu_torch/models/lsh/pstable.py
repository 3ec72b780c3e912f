"""p-stable (euclidean / E2LSH) LSH.

Reference semantics (as the JAX package's `models/lsh/pstable.py`):
* one h-function: v ~ N(0,1)^d, t ~ U(0, w); h(x) = floor((v.x + t) / w)
  (reference lib/generators/euclidean_h_gen.hpp:58-82);
* one phi function: k h's plus random integer weights r_i in [0, 100],
  summed with int32 wrap-around (euclidean_phi_gen.hpp:60-97, whose
  "modular" hash overflows the same way), then a floor-mod into the table;
* the k-tuple "detailed hash" (euclidean_phi_gen.hpp:83-94) is one int32
  murmur3 fingerprint per (row, table): equal fingerprints stand in for
  equal tuples, up to a ~2^-32 collision that can only admit a candidate.

The h-values of n rows, L tables and k functions are one [n, d] x [d, L*k]
`torch.matmul` and a floor, as the JAX package computes them outside
Pallas.  Integer hashing runs in int64 and wraps explicitly to int32 /
uint32: torch's uint32 arithmetic is incomplete, and a 32 x 32-bit product
would overflow int64, so every multiply modulo 2^32 is split in 16-bit
halves (`_mul32`).
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the signed int32 value with the same low 32 bits, in int64."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    without int64 overflow: x*c_lo < 2^48, and of x*c_hi only the low 16
    bits survive the shift."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


@dataclasses.dataclass
class PStableLsh:
    proj: torch.Tensor     # [d, L * k] float32 v-vectors
    offsets: torch.Tensor  # [L, k] float32 t ~ U(0, w)
    weights: torch.Tensor  # [L, k] int32 r ~ U{0..100} (euclidean_phi_gen.hpp:63-68)
    w: float
    k: int
    L: int

    @classmethod
    def create(
        cls, generator: torch.Generator, dim: int, k: int, L: int, w: float,
        device: torch.device,
    ) -> "PStableLsh":
        """Draw the parameters from `generator` (on its own device) and
        place them on `device`."""
        g, gdev = generator, generator.device
        proj = torch.randn(dim, L * k, generator=g, dtype=torch.float32, device=gdev)
        offsets = torch.rand(L, k, generator=g, dtype=torch.float32, device=gdev) * w
        weights = torch.randint(0, 101, (L, k), generator=g, dtype=torch.int32,
                                device=gdev)
        return cls(proj=proj.to(device), offsets=offsets.to(device),
                   weights=weights.to(device), w=float(w), k=k, L=L)

    def hash_values(self, x: torch.Tensor) -> torch.Tensor:
        """[n, d] -> [n, L, k] int32 h-values: floor((v.x + t) / w)."""
        dots = torch.matmul(x.float(), self.proj).reshape(x.shape[0], self.L, self.k)
        return torch.floor((dots + self.offsets[None]) / self.w).to(torch.int32)

    def bucket_ids(self, x: torch.Tensor, n_buckets: int) -> torch.Tensor:
        """[n, d] -> [n, L] int32 bucket ids in [0, n_buckets)."""
        return self.bucket_ids_from_hashes(self.hash_values(x), n_buckets)

    def bucket_ids_from_hashes(self, h: torch.Tensor, n_buckets: int) -> torch.Tensor:
        """phi over h-values [n, L, k] -> [n, L]: the int32 wrap-around
        weighted sum, then a nonnegative mod (reference utils.hpp:97-98)."""
        phi = torch.sum(h.long() * self.weights.long()[None], dim=-1)
        return torch.remainder(wrap_int32(phi), n_buckets).to(torch.int32)

    def fingerprints_from_hashes(self, h: torch.Tensor) -> torch.Tensor:
        """[..., L, k] h-values -> [..., L] int32 tuple fingerprints:
        murmur3's stream body over the k lanes (uint32 wrap-around), then
        its fmix32 avalanche, exactly as the JAX package's."""
        u = h.long() & _M32                    # astype(uint32): two's complement bits
        fp = torch.full(h.shape[:-1], 0x9747B28C, dtype=torch.int64, device=h.device)
        for i in range(self.k):
            x = _mul32(u[..., i], 0xCC9E2D51)
            x = _mul32(_rotl32(x, 15), 0x1B873593)
            fp = _rotl32(fp ^ x, 13)
            fp = (_mul32(fp, 5) + 0xE6546B64) & _M32
        fp = fp ^ (fp >> 16)
        fp = _mul32(fp, 0x85EBCA6B)
        fp = fp ^ (fp >> 13)
        fp = _mul32(fp, 0xC2B2AE35)
        fp = fp ^ (fp >> 16)
        return wrap_int32(fp).to(torch.int32)   # astype(int32)
