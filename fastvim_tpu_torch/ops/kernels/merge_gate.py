"""K10: broadcast + D-skip + merge + LayerNorm + gate from materialized
conv outputs (``csrc/merge_gate.cu``).

Counterpart of ``fastvim_tpu/ops/pallas/merge_gate.py``: the unfused
mixer's chain after the pooled scans,

  LN(½(bcast(yf) + D_f·xc_f + bcast(yb) + D_b·xc_b)) · silu(z),

in one pass over xc_f, xc_b and z. Two broadcast patterns: with
``pool_axes=(1,)`` (even layers) token (h, w) reads pooled row h; with
``(0,)`` (the odd layers' in-place orientation) pooled column w. A team
of threads holds a token's channels in registers; :func:`ln_gate_plan`
sizes it from d and hands the kernel its pieces a thread and team size.
A forward kernel: ``MergeLnGateFn`` takes the gradient by autograd
through the plain version, as the JAX package takes it through its
reference.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import broadcast_grid


# K10's launch plan (csrc/merge_gate.cu): the widest d it takes (kMaxD),
# the threads a block where a team fits in a warp (kSmallTeamBlock), and
# the pieces a thread may hold, most first
MAX_D = 4096
SMALL_TEAM_BLOCK = 256
PIECES = (3, 2, 1)


class LnGatePlan(NamedTuple):
    pieces: int   # K: 16-byte pieces of a token's channels a thread holds
    team: int     # G: threads a token, a power of 2 up to 32 or a multiple
    threads: int  # threads a block: 256 teams-worth, or one team


def ln_gate_max_threads(pieces: int, elem_bytes: int) -> int:
    """Threads a K10 block may have with ``pieces`` pieces a thread: the
    kernel's ``__launch_bounds__`` (``max_threads`` in
    csrc/merge_gate.cu), which caps the registers a thread takes."""
    if pieces == 2:
        return 512 if elem_bytes == 4 else 256
    return {1: 512, 3: 256}[pieces]


def _team_ok(team: int) -> bool:
    return team in (1, 2, 4, 8, 16, 32) or team % 32 == 0


def _block(team: int) -> int:
    return SMALL_TEAM_BLOCK if team <= 32 else team


def ln_gate_plan(d: int, elem_bytes: int) -> LnGatePlan:
    """K10's plan for d channels of ``elem_bytes`` bytes: a token is d /
    (16 / elem_bytes) 16-byte pieces, split over a team of threads, K
    pieces each, K as large as divides them into a legal team (the
    registry's widths all fit so, with K 2 or 3); else one piece a thread,
    or two where one would take more threads than a block may have, and
    the team rounded up, its spare pieces masked in the kernel."""
    if d % 32 or not 32 <= d <= MAX_D:
        raise ValueError(f"merge_ln_gate: no plan for d={d} (d % 32 == 0 "
                         f"and 32 <= d <= {MAX_D})")
    n = d * elem_bytes // 16
    for k in PIECES[:-1]:
        team = n // k
        if (n % k == 0 and _team_ok(team)
                and _block(team) <= ln_gate_max_threads(k, elem_bytes)):
            return LnGatePlan(k, team, _block(team))
    for k in (1, 2):
        need = -(-n // k)
        team = (1 << (need - 1).bit_length() if need <= 32
                else -(-need // 32) * 32)
        if _block(team) <= ln_gate_max_threads(k, elem_bytes):
            return LnGatePlan(k, team, _block(team))
    raise AssertionError(f"merge_ln_gate: no plan for d={d}")


def fusable(grid_shape: Sequence[int], pool_axes: Sequence[int],
            d_inner: int) -> bool:
    """What K10 takes: a 2-D grid pooled over one of its axes and a
    d_inner that is a multiple of 32, up to ``MAX_D`` (FastVim-H's is
    2560). The TPU kernel's W % 8 and d_inner % 128 were its block rules
    and have no counterpart here."""
    return (len(grid_shape) == 2 and tuple(pool_axes) in ((0,), (1,))
            and min(grid_shape) >= 1 and 32 <= d_inner <= MAX_D
            and d_inner % 32 == 0)


def merge_ln_gate_plain(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b,
                        grid_shape, pool_axes, eps: float, use_ln: bool):
    """xc_f, xc_b, z: (B, H·W, d); yf, yb: (B, P, d) pooled scan outputs,
    P = H for ``pool_axes=(1,)`` and W for ``(0,)``; d_f, d_b: (d,);
    ln_w, ln_b: (d,) or None. Math in fp32, LayerNorm over d with the
    variance as the mean of (m − μ)². Returns (B, H·W, d) in xc_f's
    dtype."""
    bc = lambda y: broadcast_grid(y.float(), grid_shape, pool_axes)
    m = (bc(yf) + d_f.float() * xc_f.float()
         + bc(yb) + d_b.float() * xc_b.float()) * 0.5
    if use_ln:
        mu = m.mean(-1, keepdim=True)
        var = ((m - mu) ** 2).mean(-1, keepdim=True)
        m = (m - mu) * torch.rsqrt(var + eps)
        if ln_w is not None:
            m = m * ln_w.float()
        if ln_b is not None:
            m = m + ln_b.float()
    return (m * F.silu(z.float())).to(xc_f.dtype)


def merge_ln_gate(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, grid_shape,
                  pool_axes, eps: float, use_ln: bool) -> torch.Tensor:
    """K10; same contract as :func:`merge_ln_gate_plain`. On CUDA xc_f,
    xc_b, z, yf and yb share one dtype, the vectors are float32, d is a
    multiple of 32 up to ``MAX_D``, and xc_f, xc_b, yf and yb start on a
    32-byte boundary; z may be a column slice of a wider contiguous
    array."""
    if xc_f.device.type == "cpu":
        return merge_ln_gate_plain(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w,
                                   ln_b, grid_shape, pool_axes, eps, use_ln)
    name = "merge_ln_gate_fwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, xc_f.device, token_strided=("z",),
                            xc_f=xc_f, xc_b=xc_b, z=z, yf=yf, yb=yb, d_f=d_f,
                            d_b=d_b, ln_w=ln_w, ln_b=ln_b)
    code = kernels.dtype_code(name, xc_f)
    B, L, d = xc_f.shape
    if not fusable(grid_shape, pool_axes, d):
        raise ValueError(f"{name}: needs a 2-D grid pooled over one axis and "
                         f"d % 32 == 0, d <= {MAX_D}, got grid "
                         f"{tuple(grid_shape)}, "
                         f"pool_axes {tuple(pool_axes)}, d={d}")
    H, W = grid_shape
    along_w = tuple(pool_axes) == (1,)
    P = H if along_w else W
    for arg, t, shape in (("xc_f", xc_f, (B, H * W, d)),
                          ("xc_b", xc_b, (B, H * W, d)),
                          ("z", z, (B, H * W, d)), ("yf", yf, (B, P, d)),
                          ("yb", yb, (B, P, d))):
        if t.dtype != xc_f.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {xc_f.dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for arg, t in (("d_f", d_f), ("d_b", d_b), ("ln_w", ln_w),
                   ("ln_b", ln_b)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (d,)):
            raise ValueError(f"{name}: {arg} must be float32 ({d},)")
    kernels.check_aligned(name, xc_f=xc_f, xc_b=xc_b, yf=yf, yb=yb)
    plan = ln_gate_plan(d, xc_f.element_size())
    out = torch.empty_like(xc_f)
    err = _build.library().fv_merge_ln_gate_fwd(
        *map(kernels.ptr, (xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, out)),
        B, H, W, d, kernels.token_stride(name, "z", z), int(along_w), code,
        int(use_ln), plan.pieces, plan.team, float(eps),
        kernels.stream_ptr(xc_f.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


class MergeLnGateFn(torch.autograd.Function):
    """out = merge_ln_gate(...): K10 forward (its plain version on the
    CPU); backward by autograd through :func:`merge_ln_gate_plain`, also
    where the layer has no LayerNorm (ln_w, ln_b None)."""

    @staticmethod
    def forward(ctx, xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, grid_shape,
                pool_axes, eps, use_ln):
        ctx.save_for_backward(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b)
        ctx.static = (tuple(grid_shape), tuple(pool_axes), eps, use_ln)
        return merge_ln_gate(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b,
                             *ctx.static)

    @staticmethod
    def backward(ctx, g):
        return kernels.plain_vjp(merge_ln_gate_plain, ctx.saved_tensors,
                                 ctx.static, g,
                                 ctx.needs_input_grad[:9]) + (None,) * 4
