"""What a data-parallel step computes over the global batch: the random
draws, the batch statistics, the loss denominators, the metrics, and the
gradient all-reduce.

The JAX step is one program over the whole global batch, so every draw,
mean and sum in it covers all ranks' rows. Here each rank holds its rows
only, and these helpers give it what the JAX program would have:

* a draw over the batch (DropPath's per-sample mask, dropout's, MAE's
  noise, the device augment's) is made for the whole global batch from
  the generator every rank seeds alike, and each rank keeps its rows;
* mixup's partner, the reversed global batch, comes from the rank at
  the mirrored data index;
* BatchNorm's moments and a loss's denominator (a count of pixels or of
  sampled boxes) are summed over ranks.

Over a ``(data, seq)`` mesh the S ranks of a seq group hold the same
rows: a draw is the same on each of them, a sum of per-sample values
(eval sums, gathered predictions) runs over the data group, and a mean
over every rank of values the seq group holds alike equals the mean over
the data group.

With one rank (no process group, or ``torchrun`` with one process) each
helper returns what the single-process code computed, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fastvim_tpu_torch.parallel.mesh import TokenShard, get_mesh


def rand_rows(shape: Sequence[int], generator: torch.Generator,
              device: torch.device,
              tokens: Optional[TokenShard] = None) -> torch.Tensor:
    """``torch.rand(shape)`` for a batch whose leading dimension is this
    rank's share: drawn for the global batch (``shape[0] * data`` rows)
    and cut to this rank's rows, so that N ranks draw what one process
    draws for the whole batch; the ranks of a seq group draw alike. With
    ``tokens``, dimension 1 is this rank's tokens of a sharded grid: the
    draw covers the whole grid and keeps them."""
    mesh = get_mesh()
    if not mesh.sharded and tokens is None:
        return torch.rand(tuple(shape), device=device, generator=generator)
    full = [shape[0] * mesh.data, *shape[1:]]
    if tokens is not None:
        full[1] = tokens.grid[0] * tokens.grid[1]
    u = torch.rand(tuple(full), device=device,
                   generator=generator)[mesh.rows(full[0])]
    return u if tokens is None else u[:, tokens.tokens()]


def mirror_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows that ``global_batch.flip(0)`` holds where ``t`` holds this
    rank's: data index d's part of the reversed batch is data index
    (D-1-d)'s part, reversed, taken from the rank there with this rank's
    seq index. Exchanged point to point (staged through the host under
    gloo, whose send takes CPU tensors)."""
    mesh = get_mesh()
    if not mesh.sharded:
        return t.flip(0)
    peer = (mesh.data - 1 - mesh.data_index) * mesh.seq + mesh.seq_index
    if peer == mesh.rank:
        return t.flip(0)
    host = mesh.backend == "gloo" and t.device.type != "cpu"
    send = (t.cpu() if host else t).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                       dist.P2POp(dist.irecv, recv, peer)]):
        req.wait()
    return recv.to(t.device).flip(0)


class _SumOverRanks(torch.autograd.Function):
    """all-reduce SUM with the all-reduce SUM of the gradient as its
    backward (SyncBatchNorm's rule): the sum's gradient reaches every
    rank's terms."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def batch_moments(x32: torch.Tensor, dims: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) of ``x32`` over ``dims`` and over every
    rank's rows: the global batch's moments, as BatchNorm under ``jit``
    over a sharded batch takes them. Summed over the whole world: a seq
    group's S equal terms and the divisor's S cancel."""
    if not get_mesh().sharded:
        return x32.mean(dims), x32.square().mean(dims)
    n = 1
    for d in dims:
        n *= x32.shape[d]
    stacked = torch.stack([x32.sum(dims), x32.square().sum(dims)])
    total = _SumOverRanks.apply(stacked) / (n * get_mesh().world)
    return total[0], total[1]


def denominator(count: torch.Tensor) -> torch.Tensor:
    """A loss's denominator, ``max(count, 1)``, for a count over the
    global batch: the count summed over ranks, clamped, and divided by
    the world size. A rank's ``sum / denominator(count)``, averaged over
    ranks as the gradients are, is the global sum over the global count.
    Over the whole world, like the gradients: a seq group's S equal
    counts and the divisor's S cancel."""
    if not get_mesh().sharded:
        return count.clamp_min(1)
    total = count.detach().clone()
    dist.all_reduce(total)
    return total.clamp_min(1) / get_mesh().world


def mean_over_ranks(values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over ranks, in one all-reduce: the global
    batch's value of a per-rank mean over equal shares (a seq group's
    ranks hold equal values, so the world's mean is the data group's)."""
    if not get_mesh().sharded or not values:
        return values
    flat = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(flat)
    flat /= get_mesh().world
    return dict(zip(values, flat.unbind()))


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group in place, without autograd (eval
    sums, confusion matrices: each seq group counts its samples once);
    returns ``t``."""
    mesh = get_mesh()
    if mesh.sharded:
        dist.all_reduce(t, group=mesh.data_group)
    return t


def allreduce_grads(grads: Dict[str, torch.Tensor],
                    compress_dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """The gradients averaged over ranks, in one flat buffer per dtype and
    device: cast to ``compress_dtype`` (bf16: the arithmetic of the JAX
    package's ``make_compressed_grads_fn`` and of DDP's
    ``bf16_compress_hook``), summed over ranks, divided by the world size
    in that dtype and cast back to each gradient's dtype. The all-reduce
    runs after the whole backward pass, so buckets would overlap nothing;
    the flat buffer costs one gradient's size more for the call. Without
    a process group the gradients come back as they are."""
    mesh = get_mesh()
    if not mesh.distributed:
        return grads
    groups: Dict[tuple, List[str]] = {}
    for k, g in grads.items():
        groups.setdefault((g.dtype, g.device), []).append(k)
    out: Dict[str, torch.Tensor] = {}
    for (dtype, _), names in groups.items():
        flat = torch.cat([grads[k].reshape(-1).to(compress_dtype or dtype)
                          for k in names])
        dist.all_reduce(flat)
        flat /= mesh.world
        for k, piece in zip(names, flat.split([grads[k].numel()
                                               for k in names])):
            out[k] = piece.view_as(grads[k]).to(dtype)
    return {k: out[k] for k in grads}


def barrier() -> None:
    """Wait for every rank (after rank 0 has written a file the others
    read)."""
    if get_mesh().distributed:
        dist.barrier()


def is_writer() -> bool:
    """Rank 0 writes the logs and checkpoints."""
    return get_mesh().rank == 0


def gather_objects(items: Iterable) -> list:
    """Every data index's ``items`` (picklable), concatenated in data
    order: gathered over the data group, each seq group's once."""
    items = list(items)
    mesh = get_mesh()
    if not mesh.sharded:
        return items
    parts: list = [None] * mesh.data
    dist.all_gather_object(parts, items, group=mesh.data_group)
    return [x for part in parts for x in part]
