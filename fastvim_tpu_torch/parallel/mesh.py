"""The data-parallel mesh: one process per device, launched by
``torchrun``, the batch split over the processes in rank order.

Counterpart of ``fastvim_tpu/parallel/mesh.py``. The JAX package jits
one program over a ``("data", "seq")`` mesh of devices and lets XLA
insert the gradient all-reduce; PyTorch's idiom is one process per GPU
(``torchrun --standalone --nproc_per_node N -m ...``), each holding a
replica of the parameters and a contiguous slice of the global batch,
and an explicit all-reduce of the gradients (``train/trainer.py``). On
the card the processes talk over NCCL, each on ``cuda:$LOCAL_RANK``; on
the CPU over gloo.

:class:`Mesh` is that process group seen as the JAX mesh: ``shape``
``{"data": world, "seq": 1}``. :func:`make_mesh` caches it for the
process, as the JAX package caches its mesh, because what reads it (the
models' random draws, the BatchNorm statistics, the loaders) sits far
below the entry point; ``torch.distributed`` keeps its process group the
same way. Without a process group the mesh has one rank and nothing
changes: no collective is called and every draw is the single-process
one.

The ``seq`` axis (token sharding at high resolution, ``maybe_shard_tokens``
in the JAX package) is not ported: GSPMD shards the tokens there, and a
port needs a halo exchange for the causal conv (ROADMAP.md).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

_MESH: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """``world`` processes, this one ``rank``; ``backend`` "nccl" or
    "gloo" once a process group is up, None for a lone process."""
    world: int = 1
    rank: int = 0
    backend: Optional[str] = None

    @property
    def shape(self) -> dict:
        return {"data": self.world, "seq": 1}

    @property
    def distributed(self) -> bool:
        """A process group is up (also at world 1 under ``torchrun``):
        the gradients go through the all-reduce."""
        return self.backend is not None

    @property
    def sharded(self) -> bool:
        """More than one rank shares the batch."""
        return self.world > 1

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``, in rank
        order (``shard_batch``'s split); the parts differ by at most one
        row where ``world`` does not divide ``n`` (a ragged eval batch)."""
        return slice(self.rank * n // self.world,
                     (self.rank + 1) * n // self.world)


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


def make_mesh(data: Optional[int] = None, seq: int = 1) -> Mesh:
    """Create (and cache) the mesh of the current process group: ``data``
    is its world size (the default), or raises where it is not."""
    global _MESH
    if seq != 1:
        raise NotImplementedError(
            f"make_mesh(seq={seq}): the token axis is not ported (it needs a "
            "halo exchange for the causal conv); see ROADMAP.md")
    if dist.is_initialized():
        mesh = Mesh(dist.get_world_size(), dist.get_rank(),
                    dist.get_backend())
    else:
        mesh = Mesh()
    if data is not None and data != mesh.world:
        raise ValueError(f"make_mesh(data={data}) needs {data} processes, "
                         f"the process group has {mesh.world}; launch with "
                         f"torchrun --nproc_per_node {data}")
    _MESH = mesh
    return mesh


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
    """This rank's part of a global batch: the contiguous rows of each
    leaf whose leading dimension the world size divides; a leaf it does
    not divide, or one named in ``WHOLE``, is kept whole, as the JAX
    package replicates it."""
    mesh = mesh or get_mesh()
    out = {}
    for k, v in batch.items():
        shape = getattr(v, "shape", None) or np.shape(v)
        if k not in WHOLE and len(shape) >= 1 and shape[0] >= mesh.world \
                and shape[0] % mesh.world == 0:
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
    if mesh.sharded:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)
    return module
