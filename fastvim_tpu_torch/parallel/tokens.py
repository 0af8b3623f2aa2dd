"""The seq group's collectives: what the ranks of a token grid sharded
over a seq group (``mesh.token_shard``) exchange, as autograd Functions.

The JAX package shards the tokens with a sharding constraint and lets
GSPMD insert the traffic; here each rank holds contiguous whole rows of
the grid and a ``VisionMamba`` layer (``models/mixer.py``) calls:

* :func:`halo_dual_conv`: the causal and anticausal depthwise convs with
  the ``d_conv - 1`` tokens that lie across a shard boundary. Even layers
  convolve along the raster: the causal taps of a rank's first tokens
  reach the last tokens of the ranks before it, the anticausal taps of
  its last tokens the first tokens after it. Odd layers convolve along
  the transposed raster in place: every column's first rows tap the rows
  above them, and the grid's first rows tap the previous column's last
  rows, which the last rank holds (the anticausal taps of the last rows
  the next column's first rows, on rank 0). A halo may span several
  ranks (one grid row a rank).
* :func:`pool_whole`: the pooled sequence made whole on every rank. Even
  layers pool over columns, locally, then gather the rows; odd layers
  pool over rows: partial column sums added over the group (mean), or a
  max over the group whose gradient goes to the rows that hold it,
  shared among ties as one process's ``amax`` shares it. Every rank then
  runs the projections and the whole pooled scan (K1, K2 in the
  backward) and keeps its rows (:func:`local_rows`): the pooled sequence
  is small (at 2048 px, 128 steps of d_inner), so replicating the scan
  costs less than passing scan states between ranks.
* :func:`mean_tokens`, :func:`last_token`, :func:`gather_tokens` and
  :func:`gather_rows`: the final pool and the feature maps.

One gradient rule holds for every Function that makes a tensor whole on
each rank: its backward sums the cotangents over the group (a gather's
backward is a reduce-scatter, an all-reduce's an all-reduce). Each rank's
backward then computes the gradient of the group's summed losses, S
times its own loss, and ``parallel.allreduce_grads``, which sums the
gradients over the world and divides by it, gives the data-parallel
mean. The token-local parameters (in_proj, the convs, the norms,
out_proj) get S partial sums. The replicated ones get S equal copies:
the head by construction, and the pooled projections, A and D because
the pooled scan's output, computed alike on every rank, passes through
:func:`local_rows`, whose backward averages the cotangents over the
group: every rank differentiates the replicated scan with the whole
grid's cotangent of its own loss, as one process does (the same sums, so
a bf16 gradient is rounded as one process rounds it), and hands S times
that to the pool's backward, which the rule above expects.

Every collective is an all-reduce over the seq group (a gather is an
all-reduce of zeros but for this rank's part), which NCCL and gloo both
take; under gloo a CUDA tensor is staged through the host, as
``parallel.mirror_rows`` stages its send. Every rank must call these in
the same order with tensors that require a gradient alike.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fastvim_tpu_torch.ops.conv import _finish
from fastvim_tpu_torch.parallel.mesh import TokenShard


def _all_reduce(t: torch.Tensor, shard: TokenShard,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over the shard's group, as a new tensor on
    ``t``'s device and of its dtype (under gloo 16-bit floats are reduced
    in fp32)."""
    gloo = shard.backend == "gloo"
    buf = t.detach().cpu() if gloo and t.device.type != "cpu" else \
        t.detach().clone()
    if gloo and buf.dtype in (torch.bfloat16, torch.float16):
        buf = buf.float()
    buf = buf.contiguous()
    dist.all_reduce(buf, op=op, group=shard.group)
    return buf.to(t.device, t.dtype)


class _Gather(torch.autograd.Function):
    """This rank's ``local`` placed at ``start`` along ``dim`` of a
    tensor ``total`` long there, the other ranks' parts filled in by an
    all-reduce of zeros; the backward sums the cotangents over the group
    and keeps this rank's part."""

    @staticmethod
    def forward(ctx, local, shard, dim, start, total):
        ctx.shard, ctx.dim, ctx.start = shard, dim, start
        ctx.length = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = total
        buf = local.new_zeros(shape)
        buf.narrow(dim, start, ctx.length).copy_(local)
        return _all_reduce(buf, shard)

    @staticmethod
    def backward(ctx, grad):
        g = _all_reduce(grad, ctx.shard)
        return g.narrow(ctx.dim, ctx.start, ctx.length), None, None, None, \
            None


class _Sum(torch.autograd.Function):
    """The sum over the group of each rank's ``t`` (zeros for a rank
    without ``keep``); the backward sums the cotangents over the group."""

    @staticmethod
    def forward(ctx, t, shard, keep):
        ctx.shard, ctx.keep = shard, keep
        return _all_reduce(t if keep else torch.zeros_like(t), shard)

    @staticmethod
    def backward(ctx, grad):
        g = _all_reduce(grad, ctx.shard)
        return (g if ctx.keep else torch.zeros_like(g)), None, None


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank of the group computes alike;
    the backward averages the cotangents over the group."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard) / ctx.shard.size, None


class _Max(torch.autograd.Function):
    """``x.amax(dim)`` over this rank's and the group's ``x``: the max of
    the local maxima. The backward sums the cotangents over the group and
    shares them among every element equal to the max, over all ranks,
    as ``amax``'s gradient shares them among ties."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        m = _all_reduce(x.amax(dim), shard, dist.ReduceOp.MAX)
        hit = x == m.unsqueeze(dim)
        count = _all_reduce(hit.sum(dim, dtype=torch.float32), shard)
        ctx.shard, ctx.dim = shard, dim
        ctx.save_for_backward(hit, count)
        return m

    @staticmethod
    def backward(ctx, grad):
        hit, count = ctx.saved_tensors
        g = _all_reduce(grad, ctx.shard) / count.to(grad.dtype)
        return hit * g.unsqueeze(ctx.dim), None, None


def _parts(shard: TokenShard, transposed: bool) -> Tuple[List[int],
                                                         List[int], int]:
    """(starts, lengths, line length) of every rank's segment of a conv
    line: along the raster, each rank's tokens of the one line; along
    the transposed raster, each rank's rows of every column."""
    H, W = shard.grid
    rows = [shard.rows(i) for i in range(shard.size)]
    scale, total = (1, H) if transposed else (W, H * W)
    return ([r.start * scale for r in rows],
            [(r.stop - r.start) * scale for r in rows], total)


def _shift(t: torch.Tensor, k: int) -> torch.Tensor:
    """``out[:, g] = t[:, g + k]``, zero where ``g + k`` is outside."""
    n = t.shape[1]
    if k == 0:
        return t
    if abs(k) >= n:
        return torch.zeros_like(t)
    pad = (0, 0, -k, 0) if k < 0 else (0, 0, 0, k)
    return F.pad(t[:, :k] if k < 0 else t[:, k:], pad)


def halo_dual_conv(x: torch.Tensor, weight_c: torch.Tensor,
                   bias_c: Optional[torch.Tensor], weight_a: torch.Tensor,
                   bias_a: Optional[torch.Tensor], shard: TokenShard,
                   transposed: bool, activation: Optional[str] = "silu"):
    """The causal and anticausal convs (weights ``(width, d)``) of this
    rank's tokens ``x`` (batch, its rows · cols, d), raster order, along
    the raster or, ``transposed``, along the transposed raster: what
    ``ops.conv.grid_dual_conv1d`` computes on the whole grid, this rank's
    tokens of it. Returns (yc, ya)."""
    B, n, d = x.shape
    H, W = shard.grid
    rows = shard.local_grid[0]
    h = weight_c.shape[0] - 1
    # segments (batch, lines, length, d): the one raster line, or each
    # column's rows
    seg = (x.reshape(B, rows, W, d).transpose(1, 2) if transposed
           else x.reshape(B, 1, n, d))
    length = seg.shape[2]
    starts, lengths, total = _parts(shard, transposed)
    start = starts[shard.index]

    if h > 0:
        head = F.pad(seg[:, :, :h], (0, 0, 0, h - min(h, length)))
        tail = F.pad(seg[:, :, -h:], (0, 0, h - min(h, length), 0))
        edges = torch.cat([head, tail], 2)  # (B, lines, 2h, d)
        every = _Gather.apply(edges.unsqueeze(0), shard, 0, shard.index,
                              shard.size)

    def token(pos: int) -> torch.Tensor:
        """Position ``pos`` of each line's conv order, relative to the
        line this rank's segment lies on: (B, lines, d)."""
        line, q = divmod(pos, total)
        owner = next(i for i in range(shard.size)
                     if starts[i] <= q < starts[i] + lengths[i])
        off = q - starts[owner]
        if off >= lengths[owner] - h:  # the owner's tail
            slot = 2 * h - lengths[owner] + off
        elif off < h:  # its head
            slot = off
        else:
            raise AssertionError(f"position {q} lies in no halo")
        return _shift(every[owner][:, :, slot], line)

    def conv(xp, weight, order):
        return sum(xp[:, :, j:j + length] * weight[k] for j, k in order)

    if h > 0:
        before = torch.stack([token(p) for p in range(start - h, start)], 2)
        after = torch.stack([token(p) for p in range(start + length,
                                                     start + length + h)], 2)
        yc = conv(torch.cat([before, seg], 2), weight_c,
                  [(k, k) for k in range(h + 1)])
        ya = conv(torch.cat([seg, after], 2), weight_a,
                  [(j, h - j) for j in range(h + 1)])
    else:
        yc, ya = seg * weight_c[0], seg * weight_a[0]

    def back(y):
        return (y.transpose(1, 2) if transposed else y).reshape(B, n, d)

    return (back(_finish(yc, bias_c, activation)),
            back(_finish(ya, bias_a, activation)))


def pool_whole(xc: torch.Tensor, shard: TokenShard, transposed: bool,
               method: str = "mean", scaling_factor: float = 1.0
               ) -> torch.Tensor:
    """The whole grid's pooled sequence, on every rank, from this rank's
    conv output ``xc`` (batch, its rows · cols, d): pooled over columns,
    (batch, rows, d); ``transposed``, over rows, (batch, cols, d). What
    ``ops.scan.pool_grid`` computes on the whole grid."""
    B, _, d = xc.shape
    H, W = shard.grid
    rows = shard.local_grid[0]
    xg = xc.reshape(B, rows, W, d)
    if not transposed:
        if method == "mean":
            local = xg.mean(2)
            if scaling_factor != 1.0:
                local = local * scaling_factor
        elif method == "max":
            local = xg.amax(2)
        else:
            raise ValueError(f"unknown collapse method {method!r}")
        return _Gather.apply(local, shard, 1, shard.rows().start, H)
    if method == "mean":
        out = _Sum.apply(xg.sum(1, dtype=torch.float32), shard, True) / H
        if scaling_factor != 1.0:
            out = out * scaling_factor
        return out.to(xc.dtype)
    if method == "max":
        return _Max.apply(xg, shard, 1)
    raise ValueError(f"unknown collapse method {method!r}")


def local_rows(y: torch.Tensor, shard: TokenShard,
               transposed: bool) -> torch.Tensor:
    """This rank's tokens (batch, its rows · cols, d) of the whole pooled
    output ``y``, which every rank computes alike, broadcast back over the
    pooled axis: each of its rows' outputs over the row's columns, or,
    ``transposed``, each column's output over its rows
    (``ops.scan.broadcast_grid``'s). The backward averages ``y``'s
    cotangents over the group (see the module docstring)."""
    y = _Replicated.apply(y, shard)
    B, _, d = y.shape
    rows, W = shard.local_grid
    if transposed:
        yg = y[:, None].expand(B, rows, W, d)
    else:
        yg = y[:, shard.rows()][:, :, None].expand(B, rows, W, d)
    return yg.reshape(B, rows * W, d)


def mean_tokens(hidden: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """The mean over the whole grid's tokens of (batch, its tokens, d):
    fp32 partial sums added over the group."""
    H, W = shard.grid
    total = _Sum.apply(hidden.sum(1, dtype=torch.float32), shard, True)
    return (total / (H * W)).to(hidden.dtype)


def last_token(hidden: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """The grid's last token (batch, d), which the last rank holds."""
    return _Sum.apply(hidden[:, -1], shard, shard.last)


def gather_tokens(hidden: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """The whole grid's tokens (batch, L, d) on every rank."""
    H, W = shard.grid
    return _Gather.apply(hidden, shard, 1, shard.tokens().start, H * W)


def gather_rows(maps: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """A feature map (batch, its rows, cols, d) made whole, (batch, rows,
    cols, d), on every rank."""
    return _Gather.apply(maps, shard, 1, shard.rows().start, shard.grid[0])
