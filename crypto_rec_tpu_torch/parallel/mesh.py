"""Logical (dp, mp) mesh, its collectives, and multi-process init.

The JAX package maps each cell of its (dp, mp) mesh to one device and
reaches XLA's collectives through shard_map.  Here the mesh is a grid of
LOGICAL cells, and each `torch.distributed` rank owns a contiguous block
of them in row-major order (cell (i, j) is number i * mp + j).  With no
process group one process owns every cell, which is how a single card
holds four index shards, and how the CPU tests run an 8-cell mesh in one
process; with a group each rank owns dp * mp / world cells.  The
collectives are plain functions over a rank's cells:

* `all_gather_cells`: each rank's per-cell values, in cell order, gathered
  across ranks with `dist.all_gather` (which returns rank order, and rank
  blocks are row-major), so the result is always [dp, mp, ...] in cell
  order and shard j of a row is always at position j.  Merges therefore
  see shards in shard order, and ties go to the lower shard as JAX's
  `lax.top_k` over an all_gather gives them.
* `all_gather_mp` / `psum_mp`: the same over a rank's distinct shards
  (the sharded index is replicated over dp, so row 0 stands for all).
* `all_to_all_mp`: block s of cell (i, j) goes to cell (i, s), through
  one `dist.all_to_all_single`.

Whenever the mesh has a process group the helpers call `torch.distributed`,
with no shortcut for a world of one, so a single-card run goes through
NCCL.  Axis conventions as the JAX package's: "dp" shards the query batch,
"mp" the indexed corpus.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, mp) grid of logical cells and this rank's block of them."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    device: torch.device
    group: Optional[object]     # a torch.distributed process group, or None
    rank: int
    world: int

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def mp(self) -> int:
        return self.shape[1]

    def cells_of(self, rank: int) -> List[Tuple[int, int]]:
        """The (i, j) cells rank `rank` owns, in cell order."""
        per = self.dp * self.mp // self.world
        return [divmod(c, self.mp) for c in range(rank * per, (rank + 1) * per)]

    @property
    def cells(self) -> List[Tuple[int, int]]:
        return self.cells_of(self.rank)

    @property
    def local_shards(self) -> List[int]:
        """The distinct mp shards this rank's cells hold, ascending."""
        return sorted({j for _, j in self.cells})


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "mp"),
    device=None,
    group=None,
) -> Mesh:
    """A (dp, mp) mesh of logical cells on `device` (cuda by default).

    `group` defaults to the default process group when one is initialized
    (else None: this process owns every cell).  Default shape: one cell a
    rank, all on "mp".  The cell count must divide evenly over the ranks."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if shape is None:
        shape = (1, world)
    shape = (int(shape[0]), int(shape[1]))
    per = shape[0] * shape[1] // world
    if shape[0] * shape[1] % world or (per % shape[1] and shape[1] % per):
        raise ValueError(f"mesh shape {shape} does not divide over {world} ranks "
                         f"in whole rows or whole parts of one row")
    return Mesh(shape, tuple(axis_names), device, group, rank, world)


def shard_rows(mesh: Mesh, x) -> torch.Tensor:
    """Global rows [n, ...] (every rank holds them) -> this rank's shards
    [S_loc, n / mp, ...] on the mesh's device: shard j is rows
    [j n / mp, (j + 1) n / mp).  A view where x is already there."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.mp:
        raise ValueError(f"rows {n} must divide the mp axis {mesh.mp}")
    shards = mesh.local_shards
    lo, hi = shards[0], shards[-1] + 1
    n_loc = n // mesh.mp
    return x[lo * n_loc:hi * n_loc].to(mesh.device).reshape(hi - lo, n_loc, *x.shape[1:])


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (not every backend takes bool)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather_cells(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[C, ...] values of this rank's cells (cell order) -> [dp, mp, ...]
    values of every cell, on every rank."""
    if mesh.group is not None:
        w = _wire(x)
        parts = [torch.empty_like(w) for _ in range(mesh.world)]
        dist.all_gather(parts, w, group=mesh.group)
        x = torch.cat(parts).to(x.dtype)
    return x.reshape(mesh.dp, mesh.mp, *x.shape[1:])


def _cells_from_shards(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    pos = {j: p for p, j in enumerate(mesh.local_shards)}
    return x[torch.tensor([pos[j] for _, j in mesh.cells], device=x.device)]


def all_gather_mp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[S_loc, ...] values of this rank's shards (`local_shards` order) ->
    [mp, ...] values of every shard, in shard order, on every rank."""
    return all_gather_cells(mesh, _cells_from_shards(mesh, x))[0]


def psum_mp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the mp shards of per-shard values [S_loc, ...]."""
    return all_gather_mp(mesh, x).sum(dim=0)


def _a2a_pairs(mesh: Mesh, src_rank: int, dst_rank: int):
    """(src cell position in src_rank's cells, destination shard s, dst cell
    position in dst_rank's cells, source shard j) of every block src_rank
    sends dst_rank, in the order both sides list them."""
    src, dst = mesh.cells_of(src_rank), mesh.cells_of(dst_rank)
    return [(ci, s, di, j) for di, (i, s) in enumerate(dst)
            for ci, (i2, j) in enumerate(src) if i2 == i]


def all_to_all_mp(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """send [C, mp, ...]: block s of cell (i, j) is for cell (i, s).
    -> recv [C, mp, ...]: recv[(i, s)][j] = send[(i, j)][s]."""
    C, S = send.shape[:2]
    if S != mesh.mp or C != len(mesh.cells):
        raise ValueError(f"send must be [{len(mesh.cells)}, {mesh.mp}, ...]")
    blk = send.shape[2:]
    if mesh.group is None:
        out = send.reshape(mesh.dp, S, S, *blk).transpose(1, 2)
        return out.reshape(send.shape).contiguous()
    flat = _wire(send).reshape(C, S, -1)
    out_pairs = [_a2a_pairs(mesh, mesh.rank, r) for r in range(mesh.world)]
    in_pairs = [_a2a_pairs(mesh, r, mesh.rank) for r in range(mesh.world)]
    sel = [(ci, s) for pairs in out_pairs for ci, s, _, _ in pairs]
    dev = send.device
    inp = flat[torch.tensor([c for c, _ in sel], device=dev, dtype=torch.long),
               torch.tensor([s for _, s in sel], device=dev, dtype=torch.long)]
    out = torch.empty(sum(len(p) for p in in_pairs), flat.shape[2], dtype=flat.dtype,
                      device=dev)
    dist.all_to_all_single(out, inp.contiguous(), [len(p) for p in in_pairs],
                           [len(p) for p in out_pairs], group=mesh.group)
    recv = torch.empty_like(flat)
    got = [(di, j) for pairs in in_pairs for _, _, di, j in pairs]
    recv[torch.tensor([d for d, _ in got], device=dev, dtype=torch.long),
         torch.tensor([j for _, j in got], device=dev, dtype=torch.long)] = out
    return recv.reshape(send.shape).to(send.dtype)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: int = 3,
    retry_delay_s: float = 5.0,
    device=None,
) -> None:
    """`dist.init_process_group` for N >= 2 processes, retried on failure as
    the JAX package retries its coordinator; a no-op for one process.

    coordinator_address: an init_method URL (tcp://host:port, file://path;
    env://, the default, reads torchrun's variables) or host:port.  NCCL when `device` is a CUDA device (the default: this
    process's current card, bound as device_id), gloo for the CPU."""
    if num_processes is None or num_processes <= 1:
        return
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    kw = dict(backend="nccl", device_id=device) if device.type == "cuda" else dict(
        backend="gloo")
    last_err = None
    for attempt in range(retries):
        try:
            dist.init_process_group(init_method=url, world_size=num_processes,
                                    rank=process_id, **kw)
            return
        except (RuntimeError, ValueError, OSError) as e:
            last_err = e
            if attempt + 1 < retries:
                time.sleep(retry_delay_s * (attempt + 1))
    raise RuntimeError(
        f"torch.distributed init failed after {retries} attempts") from last_err
