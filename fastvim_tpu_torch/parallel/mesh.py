"""The mesh: one process per device, launched by ``torchrun``, laid out
as a ``(data, seq)`` grid of ranks.

Counterpart of ``fastvim_tpu/parallel/mesh.py``. The JAX package jits
one program over a ``("data", "seq")`` mesh of devices and lets XLA
insert the collectives; PyTorch's idiom is one process per GPU
(``torchrun --standalone --nproc_per_node N -m ...``), each holding a
replica of the parameters, and explicit collectives: the all-reduce of
the gradients (``train/trainer.py``) and, over ``seq``, the token
traffic (``parallel/tokens.py``). On the card the processes talk over
NCCL, each on ``cuda:$LOCAL_RANK``; on the CPU over gloo.

:class:`Mesh` is that process group seen as the JAX mesh: ``shape``
``{"data": D, "seq": S}``, rank r at ``(r // S, r % S)`` (JAX's
``reshape(data, seq)`` of the devices). The batch is split over the data
index: the S ranks of a seq group hold the same rows. :func:`make_mesh`
caches it for the process, as the JAX package caches its mesh, because
what reads it (the models' random draws, the BatchNorm statistics, the
loaders) sits far below the entry point; ``torch.distributed`` keeps its
process group the same way. Without a process group the mesh has one
rank and nothing changes: no collective is called and every draw is the
single-process one.

The seq axis shards the tokens of a ``VisionMamba`` over the S ranks of
a seq group (:func:`token_shard`, the counterpart of
``maybe_shard_tokens``): each rank holds contiguous whole rows of the
token grid, split as :meth:`Mesh.rows` splits a batch, so that a layer
pooling over columns pools locally. The layout is the port's own (GSPMD
picks JAX's), so the cases JAX leaves unsharded stay unsharded here: a
cls-token model, a grid that is not 2-D, and L not divisible by S; and
so do a grid with fewer rows than S and the full-length (unpooled) scan.
There every rank runs the whole grid, which computes the same function.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_MESH: Optional["Mesh"] = None


def _part(i: int, parts: int, n: int) -> slice:
    """Part ``i`` of ``parts`` contiguous parts of ``range(n)``; the parts
    differ by at most one where ``parts`` does not divide ``n``."""
    return slice(i * n // parts, (i + 1) * n // parts)


@dataclass(frozen=True)
class Mesh:
    """``world`` processes, this one ``rank``; ``backend`` "nccl" or
    "gloo" once a process group is up, None for a lone process. ``seq``
    ranks make a seq group (the ranks that share a data index);
    ``seq_group`` and ``data_group`` are this rank's two process
    subgroups, made where ``seq`` > 1 (None otherwise, where the seq
    group is this rank alone and the data group the whole world)."""
    world: int = 1
    rank: int = 0
    backend: Optional[str] = None
    seq: int = 1
    seq_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def data(self) -> int:
        return self.world // self.seq

    @property
    def data_index(self) -> int:
        return self.rank // self.seq

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seq": self.seq}

    @property
    def distributed(self) -> bool:
        """A process group is up (also at world 1 under ``torchrun``):
        the gradients go through the all-reduce."""
        return self.backend is not None

    @property
    def sharded(self) -> bool:
        """More than one data index shares the batch."""
        return self.data > 1

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``, in
        data-index order (``shard_batch``'s split); the parts differ by
        at most one row where ``data`` does not divide ``n`` (a ragged
        eval batch). The ranks of a seq group hold the same rows."""
        return _part(self.data_index, self.data, n)


@dataclass(frozen=True)
class TokenShard:
    """This rank's part of a token grid sharded over its seq group:
    ``grid`` the whole (rows, cols) grid in scan orientation, ``index``
    this rank's place among the group's ``size`` ranks, each holding the
    contiguous grid rows :meth:`rows` gives; ``group`` the process
    group and ``backend`` its backend (gloo stages CUDA tensors through
    the host)."""
    grid: Tuple[int, int]
    index: int
    size: int
    group: Any = field(compare=False, repr=False)
    backend: Optional[str] = None

    def rows(self, i: Optional[int] = None) -> slice:
        """Rank ``i``'s grid rows (this rank's by default)."""
        return _part(self.index if i is None else i, self.size,
                     self.grid[0])

    @property
    def local_grid(self) -> Tuple[int, int]:
        r = self.rows()
        return (r.stop - r.start, self.grid[1])

    def tokens(self, i: Optional[int] = None) -> slice:
        """Rank ``i``'s tokens of the raster-order sequence."""
        r, cols = self.rows(i), self.grid[1]
        return slice(r.start * cols, r.stop * cols)

    @property
    def last(self) -> bool:
        return self.index == self.size - 1


def token_shard(grid: Sequence[int], cls_token: bool = False,
                pooled: bool = True,
                mesh: Optional["Mesh"] = None) -> Optional[TokenShard]:
    """This rank's part of a model's token ``grid`` over the mesh's seq
    axis, or None where the tokens stay whole (the counterpart of
    ``maybe_shard_tokens``): without a seq axis, for a cls-token model,
    a grid that is not 2-D, L not divisible by S, fewer grid rows than
    S, and a full-length (not ``pooled``) scan."""
    mesh = mesh or get_mesh()
    S = mesh.seq
    if S <= 1 or cls_token or not pooled or len(grid) != 2:
        return None
    rows, cols = grid
    if (rows * cols) % S or rows < S:
        return None
    return TokenShard((int(rows), int(cols)), mesh.seq_index, S,
                      mesh.seq_group, mesh.backend)


def launched() -> bool:
    """The process was started by ``torchrun`` (its env is set)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(device_type: str = "cuda",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group: NCCL for ``device_type`` "cuda", gloo for
    "cpu". Without arguments it reads ``torchrun``'s env (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and does nothing outside
    ``torchrun``; ``init_method`` (e.g. ``file://...``), ``world_size``
    and ``rank`` name the group instead. Returns whether a group is up.
    A failed init raises."""
    if dist.is_initialized():
        return True
    if init_method is None and not launched():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if init_method is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return True


def _groups(world: int, rank: int, seq: int):
    """(seq group, data group) of ``rank``: every group made on every
    rank, in one order, as ``dist.new_group`` needs."""
    data = world // seq
    seq_groups = [dist.new_group([d * seq + s for s in range(seq)])
                  for d in range(data)]
    data_groups = [dist.new_group([d * seq + s for d in range(data)])
                   for s in range(seq)]
    return seq_groups[rank // seq], data_groups[rank % seq]


def make_mesh(data: Optional[int] = None, seq: int = 1) -> Mesh:
    """Create (and cache) the ``(data, seq)`` mesh of the current process
    group: its world is ``data`` × ``seq`` (``data`` defaults to world //
    seq), or it raises."""
    global _MESH
    if dist.is_initialized():
        world, rank, backend = (dist.get_world_size(), dist.get_rank(),
                                dist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    if seq < 1:
        raise ValueError(f"make_mesh(seq={seq}): seq must be at least 1")
    if data is None:
        data = max(world // seq, 1)
    if data * seq != world:
        raise ValueError(f"make_mesh(data={data}, seq={seq}) needs "
                         f"{data * seq} processes, the process group has "
                         f"{world}; launch with torchrun --nproc_per_node "
                         f"{data * seq}")
    groups = _groups(world, rank, seq) if seq > 1 else (None, None)
    _MESH = Mesh(world, rank, backend, seq, *groups)
    return _MESH


def get_mesh() -> Mesh:
    """The cached mesh, made from the current process group at first
    use."""
    return _MESH if _MESH is not None else make_mesh()


def reset_mesh() -> None:
    """Forget the cached mesh (after ``destroy_process_group``)."""
    global _MESH
    _MESH = None


# per-batch leaves, held whole on every rank whatever their length: the
# JAX package may place such a vector in shards, but its program still
# reads all of it, where a rank here reads only what it holds
WHOLE = ("channel_ids",)


def shard_batch(batch: Mapping[str, Any],
                mesh: Optional[Mesh] = None) -> dict:
    """This rank's part of a global batch: the contiguous rows, by data
    index, of each leaf whose leading dimension the mesh's data size
    divides; a leaf it does not divide, or one named in ``WHOLE``, is
    kept whole, as the JAX package replicates it."""
    mesh = mesh or get_mesh()
    out = {}
    for k, v in batch.items():
        shape = getattr(v, "shape", None) or np.shape(v)
        if k not in WHOLE and len(shape) >= 1 and shape[0] >= mesh.data \
                and shape[0] % mesh.data == 0:
            out[k] = v[mesh.rows(shape[0])]
        else:
            out[k] = v
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module,
              mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place;
    returns ``module``."""
    mesh = mesh or get_mesh()
    if mesh.world > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)
    return module
