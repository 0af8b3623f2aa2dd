"""K8 and K9: the fused block kernels of the unfused mixer path
(``csrc/fused_block.cu``).

Counterpart of ``fastvim_tpu/ops/pallas/fused_block.py``. Between the
in-projection and the out-projection the dense pooled mixer does

  x ──dual conv──silu──┬─► (cf, cb) ──pool over each row──► pf, pb
                       │    pf/pb ──x_proj, dt_proj, scans──► yf, yb
  x, z, yf, yb ────────┴─► ½(yf + D_f·cf + yb + D_b·cb) ──LN──· silu(z)

``conv_pool`` (K8) is the first line in one read of x, with the conv
outputs never written to memory; ``merge_gate`` (K9) is the last, with
both convs computed again from x instead of read back. The conv runs
along the flat raster of a (rows, cols) grid, pooling is over each row
(``pool_axes=(1,)``), and the conv outputs are rounded to x's dtype, the
type the unfused path holds them in, before they are pooled or merged.

Conv weights are ``(d, 4)`` (``conv1d.weight`` reshaped); x and z may be
the two column halves of the in-projection's output, uncopied. K9 stages
tiles of consecutive tokens in shared memory; :func:`merge_gate_plan`
sizes them from d and hands the kernel its tile and block size. Both are
forward kernels: ``ConvPoolFn`` and ``MergeGateFn`` take the gradient by
autograd through the plain versions, as the JAX package takes it through
its references.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.conv import dual_conv1d
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import broadcast_grid, pool_grid


# K9's launch plan (csrc/fused_block.cu): threads a block at most (its
# __launch_bounds__), the shared memory a block may use, and the tile
# sizes tried, largest first
MG_MAX_THREADS = 384
SMEM_BLOCK = 232448
MG_TILES = (32, 16, 8, 4, 2, 1)


def fusable(rows: int, cols: int, d: int) -> bool:
    """What K8 and K9 take: any grid (rows shorter than the conv's reach
    and single rows included) and any d_inner that is a multiple of 32 and
    leaves K9 a tile of one token in shared memory in either dtype (fp32
    needs the most: d <= 2752; FastVim-H's d_inner is 2560). The TPU
    kernels' tile rules (rows % 8, a VMEM budget per tile) have no
    counterpart here."""
    return (rows >= 1 and cols >= 1 and d >= 32 and d % 32 == 0
            and merge_gate_smem(1, d, rows, cols, 4) <= SMEM_BLOCK)


class MergeGatePlan(NamedTuple):
    tile: int     # consecutive raster tokens a block stages and computes
    threads: int  # threads a block: 4 channels each, times the chunks
    smem: int     # bytes of shared memory a block asks for


def merge_rows_staged(tile: int, rows: int, cols: int) -> int:
    """The yf / yb rows a K9 buffer holds: the most rows a tile of
    ``tile`` consecutive raster tokens touches, wherever it starts."""
    return min(tile, rows, (tile + cols - 2) // cols + 1)


def merge_gate_smem(tile: int, d: int, rows: int, cols: int,
                    elem_bytes: int) -> int:
    """Shared memory of a K9 block: two buffers, each of x (tile + 6 rows,
    the conv's halo included), z (tile rows) and the yf / yb rows a tile
    touches; m (tile rows, fp32); μ, rstd and the staged row of each
    token. The kernel counts its layout by ``merge_smem`` in
    csrc/fused_block.cu and refuses a launch whose count differs."""
    nr = merge_rows_staged(tile, rows, cols)
    buf = (2 * tile + 6) * d * elem_bytes + 2 * nr * d * 4
    return 2 * buf + tile * d * 4 + tile * 12


def merge_gate_plan(d: int, rows: int, cols: int,
                    elem_bytes: int) -> MergeGatePlan:
    """K9's tile and block for d channels on a (rows, cols) grid. A
    thread owns 4 channels: d/4 threads, times the largest power of two
    that stays within 384, side by side on 4-token chunks (past d = 1536,
    384 threads take several quads of channels each). The tile is the
    largest of 32, 16, 8, ... tokens, at most two chunks a thread, whose
    buffers fit in shared memory: wide d gets fewer tokens a tile, never
    another code path."""
    q = d // 4
    s = 1
    while q * s * 2 <= MG_MAX_THREADS:
        s *= 2
    threads = min(q * s, MG_MAX_THREADS)
    tiles = [t for t in MG_TILES if t <= 8 * s and
             merge_gate_smem(t, d, rows, cols, elem_bytes) <= SMEM_BLOCK]
    if not tiles:
        raise ValueError(f"merge_gate: d={d} leaves no tile in shared memory")
    return MergeGatePlan(tiles[0], threads,
                         merge_gate_smem(tiles[0], d, rows, cols, elem_bytes))


def _convs_plain(x, w_cf, b_cf, w_ab, b_ab):
    """Causal and anticausal conv + SiLU of x (B, L, d) along the flat
    sequence in fp32, rounded to x's dtype; returned as float32."""
    f = lambda t: None if t is None else t.float()
    cf, cb = dual_conv1d(x.float(), w_cf.float().t(), f(b_cf),
                         w_ab.float().t(), f(b_ab))
    return cf.to(x.dtype).float(), cb.to(x.dtype).float()


def conv_pool_plain(x, w_cf, b_cf, w_ab, b_ab, rows: int, cols: int,
                    method: str = "mean", scaling: float = 1.0):
    """x: (B, rows·cols, d); w_cf, w_ab: (d, 4); b_cf, b_ab: (d,) or None.
    Returns pf, pb (B, rows, d) float32: the mean over each row of the
    conv outputs × scaling (summed in fp32), or with ``method="max"`` the
    row maximum, without scaling."""
    cf, cb = _convs_plain(x, w_cf, b_cf, w_ab, b_ab)
    return (pool_grid(cf, (rows, cols), (1,), method, scaling),
            pool_grid(cb, (rows, cols), (1,), method, scaling))


def _check_conv_args(name, x, w_cf, b_cf, w_ab, b_ab, rows, cols):
    B, L, d = x.shape
    if L != rows * cols:
        raise ValueError(f"{name}: L={L} does not match grid ({rows}, {cols})")
    if not fusable(rows, cols, d):
        raise ValueError(f"{name}: needs d % 32 == 0 and d <= 2752, got "
                         f"d={d}")
    for arg, t, shape in (("w_cf", w_cf, (d, 4)), ("w_ab", w_ab, (d, 4)),
                          ("b_cf", b_cf, (d,)), ("b_ab", b_ab, (d,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    return B, L, d


def conv_pool(x, w_cf, b_cf, w_ab, b_ab, rows: int, cols: int,
              method: str = "mean",
              scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8; same contract as :func:`conv_pool_plain`. On CUDA the weights
    and biases must be float32 and d a multiple of 32; x may be a column
    slice of a wider contiguous array."""
    if method not in ("mean", "max"):
        raise ValueError(f"unknown collapse method {method!r}")
    if x.device.type == "cpu":
        return conv_pool_plain(x, w_cf, b_cf, w_ab, b_ab, rows, cols, method,
                               scaling)
    name = "conv_pool_fwd"
    kernels.check_cuda_args(name, x.device, token_strided=("x",), x=x,
                            w_cf=w_cf, b_cf=b_cf, w_ab=w_ab, b_ab=b_ab)
    code = kernels.dtype_code(name, x)
    B, L, d = _check_conv_args(name, x, w_cf, b_cf, w_ab, b_ab, rows, cols)
    pf = torch.empty(B, rows, d, dtype=torch.float32, device=x.device)
    pb = torch.empty_like(pf)
    err = _build.library().fv_conv_pool_fwd(
        *map(kernels.ptr, (x, w_cf, b_cf, w_ab, b_ab, pf, pb)),
        B, rows, cols, d, kernels.token_stride(name, "x", x),
        int(method == "max"), code, float(scaling),
        kernels.stream_ptr(x.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return pf, pb


def merge_gate_plain(x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b, ln_w,
                     ln_b, rows: int, cols: int, eps: float = 1e-5,
                     use_norm: bool = True):
    """x, z: (B, rows·cols, d); yf, yb: (B, rows, d) float32 pooled scan
    outputs; w_cf, w_ab: (d, 4); d_f, d_b: (d,); b_cf, b_ab, ln_w, ln_b:
    (d,) or None. Math in fp32: both convs of x, yf/yb broadcast over
    their rows, D-skip, the ½ merge, LayerNorm over d with the variance as
    the mean of (m − μ)² (``use_norm``), × silu(z). Returns (B, L, d) in
    x's dtype."""
    cf, cb = _convs_plain(x, w_cf, b_cf, w_ab, b_ab)
    bc = lambda y: broadcast_grid(y.float(), (rows, cols), (1,))
    m = (bc(yf) + d_f.float() * cf + bc(yb) + d_b.float() * cb) * 0.5
    if use_norm:
        mu = m.mean(-1, keepdim=True)
        var = ((m - mu) ** 2).mean(-1, keepdim=True)
        m = (m - mu) * torch.rsqrt(var + eps)
        if ln_w is not None:
            m = m * ln_w.float()
        if ln_b is not None:
            m = m + ln_b.float()
    return (m * F.silu(z.float())).to(x.dtype)


def merge_gate(x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b, ln_w, ln_b,
               rows: int, cols: int, eps: float = 1e-5,
               use_norm: bool = True) -> torch.Tensor:
    """K9; same contract as :func:`merge_gate_plain`. On CUDA yf, yb and
    every vector must be float32, z of x's dtype and d a multiple of 32;
    x and z may be column slices of a wider contiguous array."""
    if x.device.type == "cpu":
        return merge_gate_plain(x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f,
                                d_b, ln_w, ln_b, rows, cols, eps, use_norm)
    name = "merge_gate_fwd"
    if not use_norm:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x.device, token_strided=("x", "z"), x=x,
                            z=z, yf=yf, yb=yb, w_cf=w_cf, b_cf=b_cf,
                            w_ab=w_ab, b_ab=b_ab, d_f=d_f, d_b=d_b, ln_w=ln_w,
                            ln_b=ln_b)
    code = kernels.dtype_code(name, x)
    B, L, d = _check_conv_args(name, x, w_cf, b_cf, w_ab, b_ab, rows, cols)
    if z.dtype != x.dtype or z.shape != x.shape:
        raise ValueError(f"{name}: z must be {x.dtype} {tuple(x.shape)}, got "
                         f"{z.dtype} {tuple(z.shape)}")
    for arg, t, shape in (("yf", yf, (B, rows, d)), ("yb", yb, (B, rows, d)),
                          ("d_f", d_f, (d,)), ("d_b", d_b, (d,)),
                          ("ln_w", ln_w, (d,)), ("ln_b", ln_b, (d,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    out = torch.empty(B, L, d, dtype=x.dtype, device=x.device)
    plan = merge_gate_plan(d, rows, cols, x.element_size())
    err = _build.library().fv_merge_gate_fwd(
        *map(kernels.ptr, (x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b,
                           ln_w, ln_b, out)),
        B, rows, cols, d, kernels.token_stride(name, "x", x),
        kernels.token_stride(name, "z", z), code, int(use_norm), plan.tile,
        plan.threads, plan.smem, float(eps), kernels.stream_ptr(x.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


class ConvPoolFn(torch.autograd.Function):
    """(pf, pb) = conv_pool(...): K8 forward (its plain version on the
    CPU); backward by autograd through :func:`conv_pool_plain`."""

    @staticmethod
    def forward(ctx, x, w_cf, b_cf, w_ab, b_ab, rows, cols, method, scaling):
        ctx.save_for_backward(x, w_cf, b_cf, w_ab, b_ab)
        ctx.static = (rows, cols, method, scaling)
        return conv_pool(x, w_cf, b_cf, w_ab, b_ab, *ctx.static)

    @staticmethod
    def backward(ctx, g_pf, g_pb):
        return kernels.plain_vjp(conv_pool_plain, ctx.saved_tensors,
                                 ctx.static, (g_pf, g_pb),
                                 ctx.needs_input_grad[:5]) + (None,) * 4


class MergeGateFn(torch.autograd.Function):
    """out = merge_gate(...): K9 forward (its plain version on the CPU);
    backward by autograd through :func:`merge_gate_plain`."""

    @staticmethod
    def forward(ctx, x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b, ln_w,
                ln_b, rows, cols, eps, use_norm):
        ctx.save_for_backward(x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b,
                              ln_w, ln_b)
        ctx.static = (rows, cols, eps, use_norm)
        return merge_gate(x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b,
                          ln_w, ln_b, *ctx.static)

    @staticmethod
    def backward(ctx, g):
        return kernels.plain_vjp(merge_gate_plain, ctx.saved_tensors,
                                 ctx.static, g,
                                 ctx.needs_input_grad[:12]) + (None,) * 4
