"""K3-K7: the two passes of the fused FastVim mixer layer, forward
(``csrc/layer_fused_fwd_wgmma.cu`` in bf16, ``csrc/layer_fused_fwd_tf32.cu``
in fp32 on the tensor cores in split precision, ``csrc/layer_fused_fwd.cu``
for the entry points), backward (``csrc/layer_fused_bwd_wgmma.cu``
in bf16, ``csrc/layer_fused_bwd_tf32.cu`` in fp32 on the tensor cores in
split precision, ``csrc/layer_fused_bwd.cu`` for the entry points) and
pass B in its recompute form (``csrc/layer_fused_recompute_wgmma.cu`` in
bf16, ``csrc/layer_fused_recompute_tf32.cu`` in fp32 on the tensor cores in
split precision, ``csrc/layer_fused_recompute.cu`` for the entry point),
and ``fused_mixer_core``, which chains pass A → the pooled scans → pass B
and differentiates through ``FusedMixerCoreFn``.

Counterpart of ``fastvim_tpu/ops/pallas/layer_fused.py``:

  pass A:  x̂ ──x̂·W_x──dual conv──silu──┬─► xc_f, xc_b
                                        └─mean over each line─► pf, pb
  between: pf/pb ──x_proj, dt_proj GEMMs──K1 scans──► yf, yb (pooled)
  pass B:  x̂ ──x̂·W_z──silu─┐
           xc, yf/yb ──broadcast + D·xc──merge──LN──·──·W_out─► out
  backward: pass B backward (K5) ─► VJP of the section between (GEMMs by
           autograd, scans by K2) ─► pass A backward (K6)
  recompute: pass A writes pf, pb only; pass B (K7) computes the conv
           stage again from x̂ before its tail, so xc_f and xc_b never
           reach device memory; its backward is the rematerializing one.
           K3-K7 take every registry width, FastVim-T to -H

Weights are in the torch reference layout (``in_proj.weight`` is
``(2·d_inner, d_model)``, conv weights ``(d_inner, 4)``, ``out_proj.weight``
``(d_model, d_inner)``); activations keep the JAX layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.conv import dual_conv1d, grid_dual_conv1d
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.norms import layer_norm
from fastvim_tpu_torch.ops.scan import (
    broadcast_grid,
    pool_grid,
    selective_scan,
)


FWD_MAX_DM = 1280       # widest d_model K3 / K4 take (fvf::kFwdMaxDm)
FWD_MAX_DI = 2560       # ... and d_inner (fvf::kFwdMaxDi): FastVim-H's
BWD_MAX_DM = 1280       # widest d_model K5 / K6 take (fvb::kBwdMaxDm)
BWD_MAX_DI = 2560       # ... and d_inner (fvb::kBwdMaxDi): FastVim-H's
BWD_NARROW_DM = 384     # past these the bf16 K5 / K6 take their wide
BWD_NARROW_DI = 768     # forms (fvb::kNarrowDm, kNarrowDi)
BWD_ROUTE_DM = 1024     # past it fp32 training on short lines takes remat
BWD_ROUTE_LINE = 16     # ... on lines of up to it: FastVim-H's at 224 px
BWD_RUN_B = 64          # tokens a block of the fp32 K5's middle (kMRun)
BWD_RUN_A = 122         # own tokens a block of the fp32 K6 (kAM - 2·kPad)
A_BWD_WINDOW = 58       # tokens a K6 block of the bf16 path owns (kAWin)
BWD_WIDE_TM = 128       # tokens a tile of the bf16 wide forms (kWideTM)
BWD_WIDE_TN = 128       # d_inner channels a K5 / K6 tile of them (kWideTN)
A_BWD_WINDOW_WIDE = 122  # tokens a wide K6 window owns (kAWinWide)
FWD_ROUTE_DM = 768      # past it fp32 forwards on short lines run unfused
FWD_ROUTE_LINE = 16     # ... on lines of up to it: FastVim-H's at 224 px
RECOMPUTE_MAX_DM = 1280  # widest d_model K7 takes (kRcMaxDm in both of
RECOMPUTE_MAX_DI = 2560  # its files), and d_inner (kRcMaxDi): FastVim-H's
RC_CONV_SLAB = 64       # d_inner channels of a K7 conv slab in bf16 (kCS)
RC_TF32_TOKENS = 32     # tokens a tile of the fp32 K7 (kRcTok)
RC_TF32_SLICE = 768     # widest d_inner slice a CTA of its cluster keeps
RC_TF32_COLS = 384      # ... and widest group of out columns (kRcSlice,
                        # kRcCols in csrc/layer_fused_recompute_tf32.cu)


def pass_a_widths_ok(d_model: int, d_inner: int) -> bool:
    """The widths K3's launcher takes: d_model in multiples of 32 (zero-
    padded to 64 in bf16) up to 1280, d_inner in slabs of 64 channels up
    to 2560. Lines may be of any length of 4 tokens or more, in both
    dtypes: a line longer than a block's tile is walked in segments."""
    return (0 < d_model <= FWD_MAX_DM and d_model % 32 == 0
            and 0 < d_inner <= FWD_MAX_DI and d_inner % 64 == 0)


def pass_b_widths_ok(d_model: int, d_inner: int,
                     recompute: bool = False) -> bool:
    """The widths K4's launcher takes (with ``recompute`` K7's): whole
    32-column tiles, d_model <= 1280 and d_inner <= 2560."""
    if d_model <= 0 or d_model % 32 or d_inner <= 0 or d_inner % 32:
        return False
    if recompute:
        return d_inner <= RECOMPUTE_MAX_DI and d_model <= RECOMPUTE_MAX_DM
    return d_inner <= FWD_MAX_DI and d_model <= FWD_MAX_DM


def pass_bwd_widths_ok(d_model: int, d_inner: int) -> bool:
    """The widths the launchers of K5 and K6 take: whole 64-column tiles,
    d_model <= d_inner, d_model <= 1280 and d_inner <= 2560 (every registry
    width, FastVim-H's the widest)."""
    return (d_model >= 64 and d_model % 64 == 0 and d_inner % 64 == 0
            and d_model <= d_inner <= BWD_MAX_DI and d_model <= BWD_MAX_DM)


def fused_bwd_route(d_model: int, d_inner: int, bwd_mode: str) -> str:
    """The backward a fused layer of these widths takes when a gradient is
    needed: ``bwd_mode`` ("fused": the K5 and K6 adjoint kernels;
    "remat": autograd through the unfused math, recomputed) where
    :func:`pass_bwd_widths_ok` holds, else "remat", which takes every
    width the fused forward takes. Decided from the widths alone, before
    the forward runs, on every device alike."""
    if bwd_mode not in ("fused", "remat"):
        raise ValueError(f"bwd_mode must be fused|remat, got {bwd_mode!r}")
    return bwd_mode if pass_bwd_widths_ok(d_model, d_inner) else "remat"


def default_bwd_mode(d_model: int, dtype: torch.dtype, line: int) -> str:
    """The backward a mixer whose ``layer_fused_bwd`` is "auto" takes,
    from what it sees before the forward: its width, its dtype and the
    tokens of each of its lines (the grid's columns, its rows when
    transposed). "fused" (the K5 and K6 adjoint) everywhere but one case:
    "remat" for fp32 past d_model ``BWD_ROUTE_DM`` (FastVim-H) on lines of
    up to ``BWD_ROUTE_LINE`` tokens (224 px), where the conv outputs the
    adjoint keeps a layer do not fit B = 128 on an 80 GB card (ROADMAP §3
    fault 5). The fp32 adjoint (3xTF32, csrc/layer_fused_bwd_tf32.cu)
    measured faster than remat at 224 px, B = 128 on an NVIDIA H100 80GB
    HBM3 at 700 W (``chip_smoke.py --fwd-224``, a step in turns with the
    fused forward): FastVim-B 570.1-570.3 ms against 894.8-898.2 remat
    (and 745.8-748.4 ``layer_fused="off"``), peak 16.10 GiB against 8.76;
    FastVim-T 100.9-128.5 against 211.3-252.0; FastVim-L 2034.9-2037.2
    against 2819.1-2819.2 (41.67 GiB against 20.01; its unfused step does
    not fit). Other batch sizes unmeasured (PERF.md §2, §6)."""
    if dtype == torch.float32 and line <= BWD_ROUTE_LINE \
            and d_model > BWD_ROUTE_DM:
        return "remat"
    return "fused"


def default_fwd_mode(d_model: int, dtype: torch.dtype, line: int,
                     grad: bool) -> str:
    """The forward a mixer whose ``layer_fused`` is "auto" (or "on", the
    same here) takes, from what it sees before the forward: its widths,
    its dtype, the tokens of each of its lines (the grid's columns, its
    rows when transposed) and whether a gradient will be taken. "fused"
    (K3 → K1 → K4) everywhere but one case: "off", the unfused path (which
    the JAX package takes on 14 × 14 grids), for fp32 past FastVim-B's
    widths (d_model > ``FWD_ROUTE_DM``: FastVim-L and -H) on lines of up
    to ``FWD_ROUTE_LINE`` tokens (FastVim-L's 14 and FastVim-H's 16 at
    224 px) with no gradient, where the fused forward measured slower at
    224 px, B = 128 on an H100 80GB HBM3 at 700 W (``chip_smoke.py
    --fwd-224``; FastVim-B's fused forward measured faster; the numbers
    and their runs in PERF.md §2 and §6; other batch sizes unmeasured).
    With a gradient the fused forward stays: its backward, the adjoint or
    remat, keeps the unfused activations out of memory between the passes
    (FastVim-B's step at B = 128 peaks at 16.10 GiB through the adjoint,
    8.76 through remat, against 56.85 unfused)."""
    if (dtype == torch.float32 and line <= FWD_ROUTE_LINE and not grad
            and d_model > FWD_ROUTE_DM):
        return "off"
    return "fused"


def _check_bwd_widths(name: str, dm: int, di: int) -> None:
    if not pass_bwd_widths_ok(dm, di):
        raise ValueError(
            f"{name}: the fused backward kernels need d_model, d_inner % 64 "
            f"== 0, d_model <= d_inner <= {BWD_MAX_DI} and d_model <= "
            f"{BWD_MAX_DM}, got d_model={dm}, d_inner={di}")


def fusable(grid_shape: Sequence[int], pool_axes: Sequence[int],
            transposed: bool, d_model: int, d_inner: int, d_conv: int,
            collapse_method: str, recompute: bool = False) -> bool:
    """The limits of what pass A/B compute: a 2-D grid, width-4 convs,
    mean pooling over the axis that matches the orientation, grid axes
    long enough that conv taps wrap at most one line, and widths that the
    pass A and pass B (with ``recompute``: K7) launchers take. A layer
    outside them runs the unfused path, which computes the same
    function."""
    if len(grid_shape) != 2 or d_conv != 4 or collapse_method != "mean":
        return False
    if tuple(pool_axes) != ((0,) if transposed else (1,)):
        return False
    H, W = grid_shape
    return (H >= d_conv and W >= d_conv
            and pass_a_widths_ok(d_model, d_inner)
            and pass_b_widths_ok(d_model, d_inner, recompute))


# ----------------------------------------------------------------------
# K3: pass A
# ----------------------------------------------------------------------

def _conv_stage_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab,
                      transposed: bool):
    """xin = x̂·W_xᵀ + b_x and its dual conv + SiLU along the line
    direction, in fp32: (xc_f, xc_b), each (B, H, W, di) float32."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    xin = x4.reshape(B, H * W, dm).float() @ w_x.float().t()
    if b_x is not None:
        xin = xin + b_x.float()
    xcf, xcb = grid_dual_conv1d(xin, w_cf.float().t(), b_cf,
                                w_ab.float().t(), b_ab, (H, W),
                                axis=0 if transposed else 1)
    return xcf.reshape(B, H, W, di), xcb.reshape(B, H, W, di)


def pass_a_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling: float,
                 transposed: bool):
    """x4: (B, H, W, dm); w_x: (di, dm) in x4's dtype; b_x, b_cf, b_ab:
    (di,) float32 or None; w_cf, w_ab: (di, 4) float32. Math in fp32 on
    the given values. Returns xc_f, xc_b (B, H, W, di) and pf, pb (B, P,
    di), P = W if transposed else H, all in x4's dtype; the pools are taken
    from the fp32 conv outputs."""
    H, W = x4.shape[1:3]
    dtype = x4.dtype
    xcf, xcb = _conv_stage_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab,
                                 transposed)
    line_axis, ln = (1, H) if transposed else (2, W)
    pool = lambda xc: (xc.sum(line_axis) * (scaling / ln)).to(dtype)
    return xcf.to(dtype), xcb.to(dtype), pool(xcf), pool(xcb)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: the 13 low bits of the fp32 pattern cleared after adding
    half of their weight, as ``cvt.rna.tf32.f32`` rounds."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul_plain(a: torch.Tensor, w: torch.Tensor,
                        terms: int = 3) -> torch.Tensor:
    """a @ wᵀ (a: (M, K), w: (N, K), fp32) as the fp32 K3 and K4 form their
    products on the tensor cores: each operand split into hi = tf32(v) and
    lo = tf32(v − hi), and lo·hi + hi·lo + hi·hi summed in fp32 (``terms``
    3), or hi·hi alone (``terms`` 1, one TF32 product). Products of TF32
    values are exact in fp32. A model of the kernels' precision for the
    tests; nothing on the main path calls it."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    a_hi, w_hi = tf32_round(a), tf32_round(w)
    out = a_hi @ w_hi.t()
    if terms == 3:
        a_lo, w_lo = tf32_round(a.float() - a_hi), tf32_round(w.float() - w_hi)
        out = (a_lo @ w_hi.t() + a_hi @ w_lo.t()) + out
    return out


def pass_a(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling: float,
           transposed: bool, write_xc: bool = True):
    """Pass A (K3); same contract as :func:`pass_a_plain`. With
    ``write_xc=False`` only the pools are computed and xc_f, xc_b come
    back as None (the recompute mode's pass A). On CUDA the widths must
    pass :func:`pass_a_widths_ok`; a call is one launch."""
    if x4.device.type == "cpu":
        out = pass_a_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling,
                           transposed)
        return out if write_xc else (None, None) + out[2:]
    name = "pass_a_fwd"
    kernels.check_cuda_args(name, x4.device, x4=x4, w_x=w_x, b_x=b_x,
                            w_cf=w_cf, b_cf=b_cf, w_ab=w_ab, b_ab=b_ab)
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    code = kernels.dtype_code(name, x4)
    if w_x.dtype != x4.dtype or tuple(w_x.shape) != (di, dm):
        raise ValueError(f"{name}: w_x must be {x4.dtype} ({di}, {dm})")
    for arg, t, shape in (("w_cf", w_cf, (di, 4)), ("w_ab", w_ab, (di, 4)),
                          ("b_x", b_x, (di,)), ("b_cf", b_cf, (di,)),
                          ("b_ab", b_ab, (di,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if not pass_a_widths_ok(dm, di) or min(H, W) < 4:
        raise ValueError(f"{name}: needs d_model % 32 == 0, d_model <= "
                         f"{FWD_MAX_DM}, d_inner % 64 == 0, d_inner <= "
                         f"{FWD_MAX_DI} and H, W >= 4, got d_model={dm}, "
                         f"d_inner={di}, grid=({H}, {W})")
    kernels.check_aligned(name, x4=x4, w_x=w_x)
    P = W if transposed else H
    xc_f = x4.new_empty(B, H, W, di) if write_xc else None
    xc_b = x4.new_empty(B, H, W, di) if write_xc else None
    pf = x4.new_empty(B, P, di)
    pb = x4.new_empty(B, P, di)
    err = _build.library().fv_pass_a_fwd(
        *map(kernels.ptr, (x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b,
                           pf, pb)),
        B, H, W, dm, di, int(transposed), code, float(scaling),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return xc_f, xc_b, pf, pb


# ----------------------------------------------------------------------
# K4: pass B
# ----------------------------------------------------------------------

def pass_b_plain(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
                 w_out, b_out, eps: float, use_ln: bool, transposed: bool,
                 slab_stats: bool = False):
    """x4: (B, H, W, dm); xc_f, xc_b: (B, H, W, di); yf, yb: (B, P, di);
    w_z: (di, dm); w_out: (dm, di), all in x4's dtype. b_z, d_f, d_b,
    ln_w, ln_b: (di,) and b_out: (dm,) float32 (biases may be None). Math
    in fp32; LayerNorm variance E[m²]−μ² (not clamped), its sums in K7's
    bf16 order with ``slab_stats`` (:func:`_slab_ln_stats`); the gated
    value is rounded to the dtype before the out projection. Returns (B, H,
    W, dm) in x4's dtype."""
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    dtype = x4.dtype
    z = x4.reshape(-1, dm).float() @ w_z.float().t()
    if b_z is not None:
        z = z + b_z.float()
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    m = (yf.float().reshape(bshape) + d_f.float() * xc_f.float()
         + yb.float().reshape(bshape) + d_b.float() * xc_b.float()) * 0.5
    if use_ln:
        if slab_stats:
            mu, rstd = _slab_ln_stats(m, eps)
        else:
            mu = m.mean(-1, keepdim=True)
            var = (m * m).mean(-1, keepdim=True) - mu * mu
            rstd = torch.rsqrt(var + eps)
        m = (m - mu) * rstd * ln_w.float() + ln_b.float()
    g = (m.reshape(-1, di) * F.silu(z)).to(dtype).float()
    out = g @ w_out.float().t()
    if b_out is not None:
        out = out + b_out.float()
    return out.to(dtype).reshape(B, H, W, dm)


def pass_b(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out,
           b_out, eps: float, use_ln: bool, transposed: bool):
    """Pass B (K4); same contract as :func:`pass_b_plain`. On CUDA the
    widths must pass :func:`pass_b_widths_ok`; a call is one launch."""
    if x4.device.type == "cpu":
        return pass_b_plain(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                            ln_w, ln_b, w_out, b_out, eps, use_ln,
                            transposed)
    name = "pass_b_fwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x4.device, x4=x4, xc_f=xc_f, xc_b=xc_b,
                            yf=yf, yb=yb, w_z=w_z, b_z=b_z, d_f=d_f, d_b=d_b,
                            ln_w=ln_w, ln_b=ln_b, w_out=w_out, b_out=b_out)
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("xc_f", xc_f, (B, H, W, di)),
                          ("xc_b", xc_b, (B, H, W, di)),
                          ("yf", yf, (B, P, di)), ("yb", yb, (B, P, di)),
                          ("w_z", w_z, (di, dm)), ("w_out", w_out, (dm, di))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t, shape in (("b_z", b_z, (di,)), ("d_f", d_f, (di,)),
                          ("d_b", d_b, (di,)), ("ln_w", ln_w, (di,)),
                          ("ln_b", ln_b, (di,)), ("b_out", b_out, (dm,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if use_ln and (ln_w is None or ln_b is None):
        raise ValueError(f"{name}: use_ln needs ln_w and ln_b")
    if not pass_b_widths_ok(dm, di):
        raise ValueError(f"{name}: needs d_model, d_inner % 32 == 0, "
                         f"d_model <= {FWD_MAX_DM} and d_inner <= "
                         f"{FWD_MAX_DI}, got d_model={dm}, d_inner={di}")
    kernels.check_aligned(name, x4=x4, w_z=w_z, w_out=w_out)
    out = torch.empty_like(x4)
    err = _build.library().fv_pass_b_fwd(
        *map(kernels.ptr, (x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                           ln_b, w_out, b_out, out)),
        B, H, W, dm, di, int(transposed), code, int(use_ln), float(eps),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


# ----------------------------------------------------------------------
# K7: pass B with the conv stage recomputed
# ----------------------------------------------------------------------

def pass_b_recompute_plain(x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z,
                           b_z, d_f, d_b, ln_w, ln_b, w_out, b_out,
                           eps: float, use_ln: bool, transposed: bool):
    """Pass B without materialized conv outputs: xc_f and xc_b are
    computed again from x4 as in :func:`pass_a_plain`, kept in fp32, and
    enter :func:`pass_b_plain`'s tail. x4: (B, H, W, dm); yf, yb: (B, P,
    di); w_x, w_z: (di, dm) and w_out: (dm, di) in x4's dtype; the rest
    float32 as in the two passes. Returns (B, H, W, dm) in x4's dtype."""
    xcf, xcb = _conv_stage_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab,
                                 transposed)
    return pass_b_plain(x4, xcf, xcb, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
                        w_out, b_out, eps, use_ln, transposed)


def _slab_ln_stats(m: torch.Tensor, eps: float):
    """LayerNorm mean and 1/std over the last axis of m (fp32) with the sums
    in the order of K7's bf16 kernel: per conv slab of 64 channels
    (zero-padded), each thread's 4 channels in order, then a butterfly over
    the slab's 16 threads, the slab totals added one after another."""
    di = m.shape[-1]
    v = F.pad(m, (0, -di % RC_CONV_SLAB)).unflatten(-1, (-1, 16, 4))

    def slab_sums(t):
        s = t[..., 0] + t[..., 1] + t[..., 2] + t[..., 3]
        while s.shape[-1] > 1:  # xor 1, 2, 4, 8
            s = s[..., 0::2] + s[..., 1::2]
        return s[..., 0]

    sums, sqs = slab_sums(v), slab_sums(v * v)
    total, total_sq = torch.zeros_like(sums[..., 0]), torch.zeros_like(
        sums[..., 0])
    for k in range(sums.shape[-1]):
        total, total_sq = total + sums[..., k], total_sq + sqs[..., k]
    inv = 1.0 / di
    mu = (total * inv).unsqueeze(-1)
    return mu, torch.rsqrt(total_sq.unsqueeze(-1) * inv - mu * mu + eps)


def pass_b_recompute_slabs_plain(x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab,
                                 b_ab, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out,
                                 b_out, eps: float, use_ln: bool,
                                 transposed: bool):
    """:func:`pass_b_recompute_plain` with the LayerNorm sums in the order
    of K7's bf16 kernel (:func:`_slab_ln_stats`): the plain mirror of that
    order, held against the JAX package by the CPU tests."""
    xcf, xcb = _conv_stage_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab,
                                 transposed)
    return pass_b_plain(x4, xcf, xcb, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
                        w_out, b_out, eps, use_ln, transposed,
                        slab_stats=True)


def rc_tf32_ranks(d_model: int, d_inner: int) -> int:
    """CTAs in a cluster of the fp32 K7 (``rc_ranks`` in
    csrc/layer_fused_recompute_tf32.cu): enough that each keeps the m of
    at most ``RC_TF32_SLICE`` channels and forms at most ``RC_TF32_COLS``
    columns of out. 1 at FastVim-T and -S, 2 at -B, 3 at -L, 4 at -H."""
    return max(_cdiv(d_inner, RC_TF32_SLICE), _cdiv(d_model, RC_TF32_COLS))


def _rc_shares(width: int, ranks: int):
    """[start, end) of each rank's share of ``width`` in whole 32s, as the
    kernel splits d_inner into slices and d_model into column groups."""
    units = width // 32
    return [(32 * (units * r // ranks), 32 * (units * (r + 1) // ranks))
            for r in range(ranks)]


def _warp_sums(v: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as a warp of the fp32 K7 takes it: lane l adds
    channels l, l + 32, ... in order, then a butterfly over the lanes
    (xor 16, 8, 4, 2, 1). An empty axis sums to 0."""
    lanes = v.new_zeros(*v.shape[:-1], 32)
    for k in range(0, v.shape[-1], 32):
        lanes = lanes + v[..., k:k + 32]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def pass_b_recompute_tf32_plain(x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab,
                                w_z, b_z, d_f, d_b, ln_w, ln_b, w_out, b_out,
                                eps: float, use_ln: bool, transposed: bool,
                                ranks: Optional[int] = None):
    """:func:`pass_b_recompute_plain` (fp32) in the products and the order
    of sums of the fp32 K7 (csrc/layer_fused_recompute_tf32.cu): xin, z
    and out through :func:`tf32x3_steps_plain` (k-steps of 8 in order over
    d_model, and over all of d_inner for out); the dual conv and the merge
    as the plain version takes them; each token's Σm and Σm² over each
    rank's slice of d_inner as a warp adds them (:func:`_warp_sums`), the
    ``ranks`` partials (:func:`rc_tf32_ranks` unless given) added in rank
    order. The tile of 32 tokens changes no sum. The plain mirror of the
    kernel, held against the JAX package by the CPU tests; the same
    contract."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    ranks = ranks or rc_tf32_ranks(dm, di)
    T = B * H * W
    x = x4.reshape(T, dm).float()
    xin = tf32x3_steps_plain(x, w_x.float().t())
    if b_x is not None:
        xin = xin + b_x.float()
    xcf, xcb = grid_dual_conv1d(xin.reshape(B, H * W, di), w_cf.float().t(),
                                b_cf, w_ab.float().t(), b_ab, (H, W),
                                axis=0 if transposed else 1)
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    m = ((yf.float().reshape(bshape) + d_f.float() * xcf.reshape(B, H, W, di)
          + yb.float().reshape(bshape) + d_b.float()
          * xcb.reshape(B, H, W, di)) * 0.5).reshape(T, di)
    z = tf32x3_steps_plain(x, w_z.float().t())
    if b_z is not None:
        z = z + b_z.float()
    if use_ln:
        total = total_sq = torch.zeros(T)
        for lo, hi in _rc_shares(di, ranks):
            total = total + _warp_sums(m[:, lo:hi])
            total_sq = total_sq + _warp_sums(m[:, lo:hi] * m[:, lo:hi])
        mu = (total / di).unsqueeze(-1)
        rstd = torch.rsqrt(total_sq.unsqueeze(-1) / di - mu * mu + eps)
        m = (m - mu) * rstd * ln_w.float() + ln_b.float()
    out = tf32x3_steps_plain(m * F.silu(z), w_out.float().t())
    if b_out is not None:
        out = out + b_out.float()
    return out.reshape(B, H, W, dm)


def pass_b_recompute(x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z, b_z,
                     d_f, d_b, ln_w, ln_b, w_out, b_out, eps: float,
                     use_ln: bool, transposed: bool):
    """Pass B in its recompute form (K7); same contract as
    :func:`pass_b_recompute_plain`. On CUDA the widths must pass
    :func:`pass_b_widths_ok` with ``recompute`` (d_model <= 1280, d_inner
    <= 2560, multiples of 32) and H, W >= 4; a call is one launch (in bf16
    past d_model 384 or d_inner 768 the wide form; in fp32 the 3xTF32
    kernel, a cluster of :func:`rc_tf32_ranks` CTAs a tile). A failed
    build or launch raises."""
    if x4.device.type == "cpu":
        return pass_b_recompute_plain(x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab,
                                      b_ab, w_z, b_z, d_f, d_b, ln_w, ln_b,
                                      w_out, b_out, eps, use_ln, transposed)
    name = "pass_b_recompute_fwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x4.device, x4=x4, yf=yf, yb=yb, w_x=w_x,
                            b_x=b_x, w_cf=w_cf, b_cf=b_cf, w_ab=w_ab,
                            b_ab=b_ab, w_z=w_z, b_z=b_z, d_f=d_f, d_b=d_b,
                            ln_w=ln_w, ln_b=ln_b, w_out=w_out, b_out=b_out)
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("yf", yf, (B, P, di)), ("yb", yb, (B, P, di)),
                          ("w_x", w_x, (di, dm)), ("w_z", w_z, (di, dm)),
                          ("w_out", w_out, (dm, di))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t, shape in (("w_cf", w_cf, (di, 4)), ("w_ab", w_ab, (di, 4)),
                          ("b_x", b_x, (di,)), ("b_cf", b_cf, (di,)),
                          ("b_ab", b_ab, (di,)), ("b_z", b_z, (di,)),
                          ("d_f", d_f, (di,)), ("d_b", d_b, (di,)),
                          ("ln_w", ln_w, (di,)), ("ln_b", ln_b, (di,)),
                          ("b_out", b_out, (dm,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if use_ln and (ln_w is None or ln_b is None):
        raise ValueError(f"{name}: use_ln needs ln_w and ln_b")
    if not pass_b_widths_ok(dm, di, recompute=True) or min(H, W) < 4:
        raise ValueError(
            f"{name}: needs d_model, d_inner % 32 == 0, d_model <= "
            f"{RECOMPUTE_MAX_DM}, d_inner <= {RECOMPUTE_MAX_DI} and H, W >= "
            f"4, got d_model={dm}, d_inner={di}, grid=({H}, {W})")
    kernels.check_aligned(name, x4=x4, yf=yf, yb=yb, w_x=w_x, w_z=w_z,
                          w_out=w_out)
    out = torch.empty_like(x4)
    err = _build.library().fv_pass_b_recompute_fwd(
        *map(kernels.ptr, (x4, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z,
                           b_z, d_f, d_b, ln_w, ln_b, w_out, b_out, out)),
        B, H, W, dm, di, int(transposed), code, int(use_ln), float(eps),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


# ----------------------------------------------------------------------
# K5: pass B backward
# ----------------------------------------------------------------------

def _dsilu(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1 + v * (1 - s))


def _wgrad_splits(ntokens: int, dm: int, di: int, jobs: int,
                  bf16: bool) -> int:
    """Token slices the weight-gradient GEMMs are split into: enough
    blocks over the launch's output tiles to fill an H100's 132 SMs (bf16:
    one wave of 128 x 192 tiles on wgmma, a block an SM; fp32: four waves
    of 128 x 128 tiles of 3xTF32 products, two blocks an SM, so that the
    last wave's idle share is small), each slice with at least ~512
    tokens. More slices only add partials to write and to add up."""
    if bf16:
        blocks, tiles = 132, -(-di // 128) * -(-dm // 192)
    else:
        blocks, tiles = 4 * 2 * 132, -(-di // 128) * -(-dm // 128)
    return max(1, min(ntokens // 512, round(blocks / (tiles * jobs))))


def _wide_wgrad_splits(ntokens: int, dm: int, di: int, jobs: int) -> int:
    """Token slices the weight-gradient products of the bf16 wide forms
    are split into (csrc/layer_fused_bwd_wide.cu): tiles of 128 rows ×
    64·nb columns (nb = 4, 2 or 1: the widest that divides d_model and
    d_inner in 64s), one block an SM of an H100's 132. The fewest slices,
    each of at least 256 tokens, whose blocks fill 90 % of their waves;
    else the fullest. One slice writes the gradients as they are, with no
    partials to add up."""
    nb = next(n for n in (4, 2, 1) if dm % (64 * n) == di % (64 * n) == 0)
    tiles = max(_cdiv(dm, 128) * (di // (64 * nb)),
                _cdiv(di, 128) * (dm // (64 * nb)))
    best, best_eff = 1, 0.0
    for n in range(1, 33):
        if n > 1 and ntokens < 256 * n:
            break
        blocks = tiles * jobs * n
        eff = blocks / (132 * _cdiv(blocks, 132))
        if eff >= 0.9:
            return n
        if eff > best_eff:
            best, best_eff = n, eff
    return best


def _wide_b_scratch(B: int, P: int, T: int, dm: int, di: int) -> int:
    """fp32 words of the bf16 wide K5's scratch (``vec_part``), as
    ``fvb::pass_b_bwd_wide`` lays it out: the column sums of each token
    tile (3·di), dD_f, dD_b and db_out of each line (2·di + dm), the
    LayerNorm statistics (2 a token), the rows' sums of each channel tile
    (2 a token)."""
    ntt, nct = _cdiv(T, BWD_WIDE_TM), _cdiv(di, BWD_WIDE_TN)
    return ntt * 3 * di + B * P * (2 * di + dm) + 2 * T + 2 * T * nct


def bwd_wide(d_model: int, d_inner: int, dtype: torch.dtype) -> bool:
    """Whether K5 and K6 take their wide forms: bf16 past d_model 384 or
    d_inner 768 (fvb::wide_form)."""
    return dtype == torch.bfloat16 and (d_model > BWD_NARROW_DM
                                        or d_inner > BWD_NARROW_DI)


def pass_b_bwd_plain(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                     ln_b, w_out, eps: float, use_ln: bool, transposed: bool):
    """The adjoint of :func:`pass_b_plain`, written out in tensor ops
    (not autograd). g4: (B, H, W, dm) cotangent of the output in x4's
    dtype; the other arguments as in :func:`pass_b_plain`. z, m and the
    LayerNorm statistics are recomputed in fp32; the GEMM operands dz and
    the gated value are rounded to the dtype as the TPU kernel rounds
    them. Returns

      dx (B, H, W, dm) float32: the z-half part of the gradient of x4,
      dxc_f, dxc_b (B, H, W, di) and dy (B, P, di) in the dtype (yf and
      yb enter the merge alike, so both take dy),
      dw_out (dm, di), db_out (dm,), dw_z (di, dm), db_z, dln_w, dln_b,
      dd_f, dd_b (di,), all float32 (dln_* are zeros without use_ln).
    """
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    dtype = x4.dtype
    rnd = lambda t: t.to(dtype).float()
    x = x4.reshape(-1, dm).float()
    g = g4.reshape(-1, dm).float()
    z = x @ w_z.float().t()
    if b_z is not None:
        z = z + b_z.float()
    sz = F.silu(z)
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    xcf, xcb = xc_f.float(), xc_b.float()
    m0 = ((yf.float().reshape(bshape) + d_f.float() * xcf
           + yb.float().reshape(bshape) + d_b.float() * xcb)
          * 0.5).reshape(-1, di)
    dmg = g @ w_out.float()
    if use_ln:
        mu = m0.mean(-1, keepdim=True)
        var = (m0 * m0).mean(-1, keepdim=True) - mu * mu
        rstd = torch.rsqrt(var + eps)
        mhat = (m0 - mu) * rstd
        mln = mhat * ln_w.float() + ln_b.float()
    else:
        mhat = mln = m0
    dmln = dmg * sz
    dz = dmg * mln * _dsilu(z)
    dw_out = g.t() @ rnd(mln * sz)
    if use_ln:
        dln_w, dln_b = (dmln * mhat).sum(0), dmln.sum(0)
        dmhat = dmln * ln_w.float()
        dm0 = rstd * (dmhat - dmhat.mean(-1, keepdim=True)
                      - mhat * (dmhat * mhat).mean(-1, keepdim=True))
    else:
        dln_w = dln_b = z.new_zeros(di)
        dm0 = dmln
    dzr = rnd(dz)
    dm0h = (dm0 * 0.5).reshape(B, H, W, di)
    return ((dzr @ w_z.float()).reshape(B, H, W, dm),
            (dm0h * d_f.float()).to(dtype), (dm0h * d_b.float()).to(dtype),
            dm0h.sum(1 if transposed else 2).to(dtype),
            dw_out, g.sum(0), dzr.t() @ x, dz.sum(0), dln_w, dln_b,
            (dm0h * xcf).sum((0, 1, 2)), (dm0h * xcb).sum((0, 1, 2)))


def pass_b_bwd(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
               w_out, eps: float, use_ln: bool, transposed: bool):
    """Pass B backward (K5); same contract as :func:`pass_b_bwd_plain`.
    On CUDA the widths must pass :func:`pass_bwd_widths_ok`. The sums
    over all tokens (weight and vector gradients) are written as
    per-block partials and added by one more kernel in a fixed order;
    a call is three launches in bf16; six past d_model 384 or d_inner
    768 (the wide form: the LayerNorm statistics, z and dgated with the
    gate epilogue, the per-line second pass, dx̂, the weight gradients, the
    sums) and in fp32 (z, dgated, the elementwise middle, dx̂, the weight
    gradients, the sums). Both dtypes read the weights as they lie."""
    if x4.device.type == "cpu":
        return pass_b_bwd_plain(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f,
                                d_b, ln_w, ln_b, w_out, eps, use_ln,
                                transposed)
    name = "pass_b_bwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x4.device, g4=g4, x4=x4, xc_f=xc_f,
                            xc_b=xc_b, yf=yf, yb=yb, w_z=w_z, b_z=b_z,
                            d_f=d_f, d_b=d_b, ln_w=ln_w, ln_b=ln_b,
                            w_out=w_out)
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("g4", g4, (B, H, W, dm)),
                          ("xc_f", xc_f, (B, H, W, di)),
                          ("xc_b", xc_b, (B, H, W, di)),
                          ("yf", yf, (B, P, di)), ("yb", yb, (B, P, di)),
                          ("w_z", w_z, (di, dm)), ("w_out", w_out, (dm, di))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t in (("b_z", b_z), ("d_f", d_f), ("d_b", d_b), ("ln_w", ln_w),
                   ("ln_b", ln_b)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (di,)):
            raise ValueError(f"{name}: {arg} must be float32 ({di},)")
    if use_ln and (ln_w is None or ln_b is None):
        raise ValueError(f"{name}: use_ln needs ln_w and ln_b")
    _check_bwd_widths(name, dm, di)
    kernels.check_aligned(name, g4=g4, x4=x4, xc_f=xc_f, xc_b=xc_b, yf=yf,
                          yb=yb, w_z=w_z, w_out=w_out)
    T = B * H * W
    wide = bwd_wide(dm, di, x4.dtype)
    nsplit = (_wide_wgrad_splits(T, dm, di, 2) if wide
              else _wgrad_splits(T, dm, di, 2, code == 1))
    f32 = dict(dtype=torch.float32, device=x4.device)
    dx = torch.empty(B, H, W, dm, **f32)
    dxc_f, dxc_b = torch.empty_like(xc_f), torch.empty_like(xc_b)
    dy = x4.new_empty(B, P, di)
    mg, dz = x4.new_empty(T, di), x4.new_empty(T, di)  # GEMM operands
    nvec = 5 * di + dm
    vec_part = (torch.empty(_wide_b_scratch(B, P, T, dm, di), **f32) if wide
                else torch.empty(B * P, nvec, **f32))
    vec = torch.empty(nvec, **f32)
    # the wide form writes one slice's gradients as they are
    w_part = torch.empty(2, nsplit, di * dm if nsplit > 1 or not wide else 1,
                         **f32)
    dw_out = torch.empty(dm, di, **f32)
    dw_z = torch.empty(di, dm, **f32)
    err = _build.library().fv_pass_b_bwd(
        *map(kernels.ptr, (g4, x4, xc_f, xc_b, yf, yb, w_z, None, b_z, d_f,
                           d_b, ln_w, ln_b, w_out, None, dx, dxc_f, dxc_b,
                           dy, mg, dz, vec_part, vec, w_part, dw_out, dw_z)),
        B, H, W, dm, di, int(transposed), code, int(use_ln), nsplit,
        float(eps), kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    db_z, dln_w, dln_b, dd_f, dd_b = vec[:5 * di].view(5, di).unbind(0)
    return (dx, dxc_f, dxc_b, dy, dw_out, vec[5 * di:], dw_z, db_z, dln_w,
            dln_b, dd_f, dd_b)


# ----------------------------------------------------------------------
# K6: pass A backward
# ----------------------------------------------------------------------

def _to_lines(t4: torch.Tensor, transposed: bool) -> torch.Tensor:
    """(B, H, W, c) → (B, H·W, c) in the order the conv runs in: the
    raster, or the column-major raster when transposed."""
    B, H, W, c = t4.shape
    return (t4.transpose(1, 2) if transposed else t4).reshape(B, H * W, c)


def pass_a_bwd_plain(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, b_cf,
                     w_ab, b_ab, scaling: float, transposed: bool):
    """The adjoint of :func:`pass_a_plain`, written out in tensor ops
    (not autograd). dx_b: (B, H, W, dm) float32, pass B's part of the
    gradient of x4; dxc_f, dxc_b: (B, H, W, di) and dpf, dpb: (B, P, di)
    cotangents in x4's dtype; the rest as in :func:`pass_a_plain`. The
    conv pre-activations are recomputed in fp32; the GEMM operand dxin is
    rounded to the dtype. Returns dx (B, H, W, dm) float32 (dx_b plus the
    x-half part), dw_x (di, dm), db_x (di,), dw_cf (di, 4), db_cf,
    dw_ab (di, 4), db_ab, all float32."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    dtype = x4.dtype
    L = H * W
    x = x4.reshape(-1, dm).float()
    xin = x @ w_x.float().t()
    if b_x is not None:
        xin = xin + b_x.float()
    xp = F.pad(_to_lines(xin.reshape(B, H, W, di), transposed), (0, 0, 3, 3))
    wc, wa = w_cf.float(), w_ab.float()
    yc = sum(xp[:, k:k + L] * wc[:, k] for k in range(4))
    ya = sum(xp[:, 3 + k:3 + k + L] * wa[:, 3 - k] for k in range(4))
    if b_cf is not None:
        yc = yc + b_cf.float()
    if b_ab is not None:
        ya = ya + b_ab.float()
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    s = scaling / (H if transposed else W)
    dyc = _to_lines(dxc_f.float() + dpf.float().reshape(bshape) * s,
                    transposed) * _dsilu(yc)
    dya = _to_lines(dxc_b.float() + dpb.float().reshape(bshape) * s,
                    transposed) * _dsilu(ya)
    dycp, dyap = F.pad(dyc, (0, 0, 3, 3)), F.pad(dya, (0, 0, 3, 3))
    dxin = sum(dycp[:, 6 - k:6 - k + L] * wc[:, k]
               + dyap[:, 3 - k:3 - k + L] * wa[:, 3 - k] for k in range(4))
    dw_cf = torch.stack([(xp[:, k:k + L] * dyc).sum((0, 1))
                         for k in range(4)], 1)
    dw_ab = torch.stack([(xp[:, 6 - k:6 - k + L] * dya).sum((0, 1))
                         for k in range(4)], 1)
    if transposed:  # back to raster order
        dxin = dxin.reshape(B, W, H, di).transpose(1, 2)
    dxr = dxin.reshape(-1, di).to(dtype).float()
    dx = dx_b.reshape(-1, dm).float() + dxr @ w_x.float()
    return (dx.reshape(B, H, W, dm), dxr.t() @ x,
            dxin.reshape(-1, di).sum(0), dw_cf, dyc.sum((0, 1)), dw_ab,
            dya.sum((0, 1)))


def pass_a_bwd(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, b_cf, w_ab,
               b_ab, scaling: float, transposed: bool):
    """Pass A backward (K6); same contract as :func:`pass_a_bwd_plain`.
    On CUDA the widths must pass :func:`pass_bwd_widths_ok`. The sums
    over all tokens are per-block partials added by one more kernel in a
    fixed order; a call is three launches in bf16 up to d_model 384 and
    d_inner 768, else four (xin on 128-row conv windows with the conv
    adjoint, dx̂, the weight gradient, the sums); four in fp32 (xin again
    with the conv adjoint, dx̂, the weight gradient, the sums)."""
    if x4.device.type == "cpu":
        return pass_a_bwd_plain(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x,
                                w_cf, b_cf, w_ab, b_ab, scaling, transposed)
    name = "pass_a_bwd"
    kernels.check_cuda_args(name, x4.device, x4=x4, dx_b=dx_b, dxc_f=dxc_f,
                            dxc_b=dxc_b, dpf=dpf, dpb=dpb, w_x=w_x, b_x=b_x,
                            w_cf=w_cf, b_cf=b_cf, w_ab=w_ab, b_ab=b_ab)
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("dxc_f", dxc_f, (B, H, W, di)),
                          ("dxc_b", dxc_b, (B, H, W, di)),
                          ("dpf", dpf, (B, P, di)), ("dpb", dpb, (B, P, di)),
                          ("w_x", w_x, (di, dm))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dx_b.dtype != torch.float32 or dx_b.shape != x4.shape:
        raise ValueError(f"{name}: dx_b must be float32 {tuple(x4.shape)}")
    for arg, t, shape in (("w_cf", w_cf, (di, 4)), ("w_ab", w_ab, (di, 4)),
                          ("b_x", b_x, (di,)), ("b_cf", b_cf, (di,)),
                          ("b_ab", b_ab, (di,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    _check_bwd_widths(name, dm, di)
    if min(H, W) < 4:
        raise ValueError(f"{name}: needs H, W >= 4, got grid=({H}, {W})")
    kernels.check_aligned(name, x4=x4, dx_b=dx_b, dxc_f=dxc_f, dxc_b=dxc_b,
                          w_x=w_x)
    T = B * H * W
    wide = bwd_wide(dm, di, x4.dtype)
    nsplit = (_wide_wgrad_splits(T, dm, di, 1) if wide
              else _wgrad_splits(T, dm, di, 1, code == 1))
    f32 = dict(dtype=torch.float32, device=x4.device)
    dx = torch.empty(B, H, W, dm, **f32)
    dxin = x4.new_empty(T, di)  # GEMM operand
    # a partial per block: at most a line in fp32 (a run of whole lines,
    # or one line), a window of the conv order in bf16
    nblk = (P if code == 0 else
            _cdiv(H * W, A_BWD_WINDOW_WIDE if wide else A_BWD_WINDOW))
    c_part = torch.empty(B * nblk, 11 * di, **f32)
    c_vec = torch.empty(11, di, **f32)
    w_part = torch.empty(nsplit, di * dm if nsplit > 1 or not wide else 1,
                         **f32)
    dw_x = torch.empty(di, dm, **f32)
    err = _build.library().fv_pass_a_bwd(
        *map(kernels.ptr, (x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, None, b_x,
                           w_cf, b_cf, w_ab, b_ab, dx, dxin, c_part, c_vec,
                           w_part, dw_x)),
        B, H, W, dm, di, int(transposed), code, nsplit, float(scaling),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    # c_vec rows: dw_cf[:, 0..3], dw_ab[:, 0..3], db_cf, db_ab, db_x
    return (dx, dw_x, c_vec[10], c_vec[0:4].t(), c_vec[8], c_vec[4:8].t(),
            c_vec[9])


# ----------------------------------------------------------------------
# K5 and K6 in fp32: their products and order of sums, in tensor ops
# ----------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_runs(P: int, ln: int, cap: int) -> Tuple[int, int]:
    """(lines, tokens a segment) of a block of the fp32 K5 (``cap``
    ``BWD_RUN_B``) or K6 (``BWD_RUN_A``), as ``runs_of`` in
    csrc/layer_fused_bwd_tf32.cu: whole lines, as many as fit ``cap``
    tokens, in one segment; a longer line alone, in balanced segments."""
    if ln <= cap:
        nl = min(P, cap // ln)
        return nl, nl * ln
    return 1, _cdiv(ln, _cdiv(ln, cap))


def _segment_sum(parts: torch.Tensor) -> torch.Tensor:
    """Σ over axis 0 in the order of ``sum_segments_kernel``
    (csrc/layer_fused_bwd.cuh): partial s into running sum s % 8, in
    order, then the 8 sums one after another."""
    sums = [torch.zeros_like(parts[0]) for _ in range(8)]
    for i, part in enumerate(parts):
        sums[i % 8] = sums[i % 8] + part
    out = sums[0]
    for t in sums[1:]:
        out = out + t
    return out


def tf32x3_steps_plain(a: torch.Tensor, b: torch.Tensor, nsplit: int = 1,
                       terms: int = 3) -> torch.Tensor:
    """a @ b (a: (M, K), b: (K, N), fp32) as the fp32 K5 and K6 form their
    products (csrc/layer_fused_bwd_tf32.cu): K in ``nsplit`` slices of
    whole 32-deep stages (the weight gradients' token slices), each walked
    in k-steps of 8 whose products (``terms`` 3: lo·hi + hi·lo + hi·hi of
    :func:`tf32_round`'s split; 1: hi·hi) are summed in a fresh tile and
    added to the slice's running sum in fp32; the slices added in
    ``sum_segments``' order. A model of the kernels' precision and order of
    sums for the tests; nothing on the main path calls it."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    K = a.shape[1]
    kper = _cdiv(_cdiv(K, nsplit), 32) * 32
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    parts = []
    for k_beg in range(0, nsplit * kper, kper):
        acc = a_hi.new_zeros(a.shape[0], b.shape[1])
        for k0 in range(k_beg, min(K, k_beg + kper), 8):
            k = slice(k0, k0 + 8)
            t = a_hi[:, k] @ b_hi[k]
            if terms == 3:
                t = (a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k]) + t
            acc = acc + t
        parts.append(acc)
    return _segment_sum(torch.stack(parts))


def _run_sums(t: torch.Tensor, P: int, ln: int, cap: int,
              halves: bool = False) -> torch.Tensor:
    """t: (B, P·ln, c) in line order. The sums of each block's tokens in
    the order its kernel takes them (:func:`bwd_runs` of ``cap``): each
    segment's tokens one after another, the segments' sums added in order
    (K5); with ``halves`` a thread sums each segment's first half, another
    its second half, across the block's segments, and the two are added at
    the end (K6). Returns (B·blocks, c), block b·blocks + run."""
    nl, seg = bwd_runs(P, ln, cap)
    out = []
    for f0 in range(0, P * ln, nl * ln):
        f1 = min(P * ln, f0 + nl * ln)
        run = [torch.zeros_like(t[:, 0]) for _ in range(2)]
        for s0 in range(f0, f1, seg):
            n = min(seg, f1 - s0)
            if halves:
                cut = s0 + (n + 1) // 2
                for f in range(s0, s0 + n):
                    run[f >= cut] = run[f >= cut] + t[:, f]
            else:
                acc = torch.zeros_like(run[0])
                for f in range(s0, s0 + n):
                    acc = acc + t[:, f]
                run[0] = run[0] + acc
        out.append(run[0] + run[1])
    return torch.stack(out, 1).reshape(-1, t.shape[2])


def pass_b_bwd_tf32_plain(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                          ln_w, ln_b, w_out, eps: float, use_ln: bool,
                          transposed: bool):
    """:func:`pass_b_bwd_plain` (fp32) in the products and the order of
    sums of the fp32 K5 (csrc/layer_fused_bwd_tf32.cu): every product
    through :func:`tf32x3_steps_plain`, the weight gradients over
    :func:`_wgrad_splits`' token slices, the column sums per block
    (:func:`_run_sums`, ``BWD_RUN_B``) added over the blocks in
    ``sum_segments``' order, each line's dy summed token by token. The
    plain mirror of that order, held against the JAX package by the CPU
    tests; the same contract."""
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P, ln = (W, H) if transposed else (H, W)
    T = B * H * W
    x, g = x4.reshape(T, dm).float(), g4.reshape(T, dm).float()
    z = tf32x3_steps_plain(x, w_z.float().t())
    if b_z is not None:
        z = z + b_z.float()
    dmg = tf32x3_steps_plain(g, w_out.float())
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    xcf, xcb = xc_f.float(), xc_b.float()
    m0 = ((yf.float().reshape(bshape) + d_f.float() * xcf
           + yb.float().reshape(bshape) + d_b.float() * xcb)
          * 0.5).reshape(T, di)
    sig = torch.sigmoid(z)
    if use_ln:
        mu = m0.mean(-1, keepdim=True)
        rstd = torch.rsqrt((m0 * m0).mean(-1, keepdim=True) - mu * mu + eps)
        mhat = (m0 - mu) * rstd
        mln = mhat * ln_w.float() + ln_b.float()
    else:
        mhat = mln = m0
    dmln = dmg * (z * sig)
    dz = dmg * mln * sig * (1 + z * (1 - sig))
    mg = mln * (z * sig)
    if use_ln:
        dmh = dmln * ln_w.float()
        dm0 = rstd * (dmh - dmh.mean(-1, keepdim=True)
                      - mhat * (dmh * mhat).mean(-1, keepdim=True))
        dln = (dmln * mhat, dmln)
    else:
        dm0 = dmln
        dln = (torch.zeros_like(dmln),) * 2
    h = (dm0 * 0.5).reshape(B, H, W, di)
    lines = lambda t4: _to_lines(t4, transposed)  # (B, P·ln, c)
    cols = torch.cat([lines(v.reshape(B, H, W, -1)) for v in (
        dz, *dln, h * xcf, h * xcb, g)], -1)
    vec = _segment_sum(_run_sums(cols, P, ln, BWD_RUN_B))
    dy = torch.zeros(B, P, di)
    for i, hi in enumerate(lines(h).reshape(B, P, ln, di).unbind(2)):
        dy = dy + hi
    nsplit = _wgrad_splits(T, dm, di, 2, False)
    return (tf32x3_steps_plain(dz, w_z.float()).reshape(B, H, W, dm),
            h * d_f.float(), h * d_b.float(), dy,
            tf32x3_steps_plain(mg.t(), g, nsplit).t(), vec[5 * di:],
            tf32x3_steps_plain(dz.t(), x, nsplit),
            *vec[:5 * di].reshape(5, di).unbind(0))


def pass_a_bwd_tf32_plain(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf,
                          b_cf, w_ab, b_ab, scaling: float, transposed: bool):
    """:func:`pass_a_bwd_plain` (fp32) in the products and the order of
    sums of the fp32 K6 (csrc/layer_fused_bwd_tf32.cu): xin, dxin·W_x and
    the weight gradient through :func:`tf32x3_steps_plain` (dW_x over
    :func:`_wgrad_splits`' token slices), the conv sums per block and half
    (:func:`_run_sums`, ``BWD_RUN_A``) added over the blocks in
    ``sum_segments``' order. The plain mirror of that order, held against
    the JAX package by the CPU tests; the same contract."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    P, ln = (W, H) if transposed else (H, W)
    T = B * H * W
    x = x4.reshape(T, dm).float()
    xin = tf32x3_steps_plain(x, w_x.float().t())
    if b_x is not None:
        xin = xin + b_x.float()
    xp = F.pad(_to_lines(xin.reshape(B, H, W, di), transposed), (0, 0, 3, 3))
    wc, wa = w_cf.float(), w_ab.float()
    L = H * W
    yc = sum(xp[:, k:k + L] * wc[:, k] for k in range(4))
    ya = sum(xp[:, 3 + k:3 + k + L] * wa[:, 3 - k] for k in range(4))
    if b_cf is not None:
        yc = yc + b_cf.float()
    if b_ab is not None:
        ya = ya + b_ab.float()
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    s = scaling / ln
    dyc = _to_lines(dxc_f.float() + dpf.float().reshape(bshape) * s,
                    transposed) * _dsilu(yc)
    dya = _to_lines(dxc_b.float() + dpb.float().reshape(bshape) * s,
                    transposed) * _dsilu(ya)
    dycp, dyap = F.pad(dyc, (0, 0, 3, 3)), F.pad(dya, (0, 0, 3, 3))
    dxin = sum(dycp[:, 6 - k:6 - k + L] * wc[:, k]
               + dyap[:, 3 - k:3 - k + L] * wa[:, 3 - k] for k in range(4))
    terms = torch.cat([xp[:, k:k + L] * dyc for k in range(4)]
                      + [xp[:, 6 - k:6 - k + L] * dya for k in range(4)]
                      + [dyc, dya, dxin], -1)
    c_vec = _segment_sum(_run_sums(terms, P, ln, BWD_RUN_A, halves=True))
    c_vec = c_vec.reshape(11, di)
    if transposed:  # back to raster order
        dxin = dxin.reshape(B, W, H, di).transpose(1, 2)
    dxr = dxin.reshape(T, di)
    dx = dx_b.reshape(T, dm).float() + tf32x3_steps_plain(dxr, w_x.float())
    nsplit = _wgrad_splits(T, dm, di, 1, False)
    return (dx.reshape(B, H, W, dm), tf32x3_steps_plain(dxr.t(), x, nsplit),
            c_vec[10], c_vec[0:4].t(), c_vec[8], c_vec[4:8].t(), c_vec[9])


# ----------------------------------------------------------------------
# the fused layer
# ----------------------------------------------------------------------

class FusedParams(NamedTuple):
    """One mixer's parameters, torch reference layouts, float32."""
    in_w: torch.Tensor                 # (2·di, dm)
    in_b: Optional[torch.Tensor]       # (2·di,)
    conv_f_w: torch.Tensor             # (di, 4)
    conv_f_b: Optional[torch.Tensor]
    conv_b_w: torch.Tensor
    conv_b_b: Optional[torch.Tensor]
    x_proj_f: torch.Tensor             # (dt_rank + 2n, di)
    dt_w_f: torch.Tensor               # (di, dt_rank)
    dt_b_f: torch.Tensor               # (di,)
    A_log_f: torch.Tensor              # (di, n)
    D_f: torch.Tensor                  # (di,)
    x_proj_b: torch.Tensor
    dt_w_b: torch.Tensor
    dt_b_b: torch.Tensor
    A_log_b: torch.Tensor
    D_b: torch.Tensor
    ln_w: Optional[torch.Tensor]       # (di,)
    ln_b: Optional[torch.Tensor]
    out_w: torch.Tensor                # (dm, di)
    out_b: Optional[torch.Tensor]      # (dm,)


def proj_scan(xp: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
              dt_b: torch.Tensor, A_log: torch.Tensor, dtype: torch.dtype,
              scan_impl: str, reverse: bool) -> torch.Tensor:
    """x_proj → (dt, B, C) → dt_proj → selective scan of a (pooled)
    sequence xp (batch, L, di); the GEMMs run in ``dtype``. Counterpart
    of ``MambaMixer._proj_scan`` / ``layer_fused._proj_scan``."""
    xp = xp.to(dtype)
    dbl = F.linear(xp, x_proj_w.to(dtype))
    r = dt_w.shape[1]
    n = A_log.shape[1]
    dt = F.linear(dbl[..., :r], dt_w.to(dtype))
    A = -torch.exp(A_log.float())
    return selective_scan(xp, dt, A, dbl[..., r:r + n].contiguous(),
                          dbl[..., r + n:].contiguous(),
                          delta_bias=dt_b.float(), delta_softplus=True,
                          reverse=reverse, impl=scan_impl)




def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def reference_core(x_hat: torch.Tensor, p: FusedParams,
                   grid: Tuple[int, int], transposed: bool, scaling: float,
                   eps: float, use_ln: bool, dtype: torch.dtype,
                   scan_impl: str = "auto") -> torch.Tensor:
    """The unfused mixer math for the dense pooled-mean layer, in plain
    differentiable ops (the scans through
    :func:`~fastvim_tpu_torch.ops.scan.selective_scan`). Counterpart of
    ``_reference_core`` of the JAX package: what the "remat" backward
    differentiates, and the oracle of the fused layer on any grid."""
    c = lambda t: None if t is None else t.to(dtype)
    di = p.conv_f_w.shape[0]
    xz = F.linear(x_hat.to(dtype), p.in_w.to(dtype), c(p.in_b))
    xin, z = xz[..., :di], xz[..., di:]
    conv_args = (xin, p.conv_f_w.reshape(di, -1).t().to(dtype),
                 c(p.conv_f_b), p.conv_b_w.reshape(di, -1).t().to(dtype),
                 c(p.conv_b_b))
    if transposed:
        xc_f, xc_b = grid_dual_conv1d(*conv_args, grid, axis=0)
        pool_axes = (0,)
    else:
        xc_f, xc_b = dual_conv1d(*conv_args)
        pool_axes = (1,)
    pf = pool_grid(xc_f, grid, pool_axes, "mean", scaling)
    pb = pool_grid(xc_b, grid, pool_axes, "mean", scaling)
    yf = proj_scan(pf, p.x_proj_f, p.dt_w_f, p.dt_b_f, p.A_log_f, dtype,
                   scan_impl, False)
    yb = proj_scan(pb, p.x_proj_b, p.dt_w_b, p.dt_b_b, p.A_log_b, dtype,
                   scan_impl, True)
    y_f = broadcast_grid(yf.to(dtype), grid, pool_axes) + c(p.D_f) * xc_f
    y_b = broadcast_grid(yb.to(dtype), grid, pool_axes) + c(p.D_b) * xc_b
    merged = (y_f + y_b) * 0.5
    if use_ln:
        merged = layer_norm(merged, p.ln_w, p.ln_b, eps=eps)
    merged = merged * F.silu(z)
    return F.linear(merged, p.out_w.to(dtype), c(p.out_b))


def _fused_forward(x_hat, p: FusedParams, grid, transposed, scaling, eps,
                   use_ln, dtype, scan_impl, keep_mid_graph: bool = False,
                   recompute: bool = False):
    """Pass A → pooled scans → pass B. Returns (out (B, H, W, dm), x4,
    the pass B arguments, (xc_f, xc_b, pf, pb, yf, yb), mid). With
    ``keep_mid_graph`` the x_proj / dt_proj / scan section between the
    passes runs with autograd recording on detached leaves, and ``mid`` =
    (leaves, yf, yb) is that graph, for the fused backward to
    differentiate. With ``recompute`` pass A writes the pools only (xc_f
    and xc_b are None) and pass B is K7, which computes them again."""
    B, L, dm = x_hat.shape
    H, W = grid
    if L != H * W:
        raise ValueError(f"L={L} does not match grid {grid}")
    di = p.conv_f_w.shape[0]
    x4 = x_hat.reshape(B, H, W, dm).to(dtype).contiguous()
    in_w = p.in_w.to(dtype)
    in_b = (None, None) if p.in_b is None else (_f32(p.in_b[:di]),
                                                _f32(p.in_b[di:]))
    a_args = (in_w[:di], in_b[0], _f32(p.conv_f_w.reshape(di, -1)),
              _f32(p.conv_f_b), _f32(p.conv_b_w.reshape(di, -1)),
              _f32(p.conv_b_b))
    xc_f, xc_b, pf, pb = pass_a(x4, *a_args, scaling, transposed,
                                write_xc=not recompute)
    scan_p = (p.x_proj_f, p.dt_w_f, p.dt_b_f, p.A_log_f,
              p.x_proj_b, p.dt_w_b, p.dt_b_b, p.A_log_b)
    mid = None
    if keep_mid_graph:
        leaves = [t.detach().requires_grad_() for t in (pf, pb) + scan_p]
        with torch.enable_grad():
            yf = proj_scan(leaves[0], *leaves[2:6], dtype, scan_impl,
                           False).to(dtype)
            yb = proj_scan(leaves[1], *leaves[6:10], dtype, scan_impl,
                           True).to(dtype)
        mid = (leaves, yf, yb)
        yf, yb = yf.detach(), yb.detach()
    else:
        yf = proj_scan(pf, *scan_p[:4], dtype, scan_impl, False).to(dtype)
        yb = proj_scan(pb, *scan_p[4:], dtype, scan_impl, True).to(dtype)
    b_args = (in_w[di:], in_b[1], _f32(p.D_f), _f32(p.D_b),
              _f32(p.ln_w) if use_ln else None,
              _f32(p.ln_b) if use_ln else None, p.out_w.to(dtype))
    if recompute:
        out = pass_b_recompute(x4, yf, yb, *a_args, *b_args, _f32(p.out_b),
                               eps, use_ln, transposed)
    else:
        out = pass_b(x4, xc_f, xc_b, yf, yb, *b_args, _f32(p.out_b), eps,
                     use_ln, transposed)
    return out, x4, a_args, b_args, (xc_f, xc_b, pf, pb, yf, yb), mid


def _param_grads(p: FusedParams, grads: dict, needs) -> tuple:
    """Gradients in FusedParams order, cast to each parameter's dtype and
    shape; None for an absent parameter or one that needs none."""
    return tuple(
        None if t is None or not need or grads.get(name) is None
        else grads[name].to(t.dtype).reshape(t.shape)
        for (name, t), need in zip(p._asdict().items(), needs))


class FusedMixerCoreFn(torch.autograd.Function):
    """The fused layer with the fused backward: forward = pass A (K3) →
    pooled scans (K1, states saved) → pass B (K4), saving (x̂, xc_f, xc_b,
    pf, pb) and the graph of the section between the passes; backward =
    pass B backward (K5) → the VJP of that section (its GEMMs by
    autograd, its scans by K2) → pass A backward (K6). Counterpart of
    ``fused_mixer_core`` with ``bwd_mode="fused"`` in the JAX package."""

    @staticmethod
    def forward(ctx, x_hat, grid, transposed, scaling, eps, use_ln, dtype,
                scan_impl, *params):
        p = FusedParams(*params)
        out, x4, a_args, b_args, saved, mid = _fused_forward(
            x_hat, p, grid, transposed, scaling, eps, use_ln, dtype,
            scan_impl, keep_mid_graph=True)
        ctx.p, ctx.mid = p, mid
        ctx.tensors = (x4, a_args, b_args, saved[:2], saved[4:])
        ctx.cfg = (transposed, scaling, eps, use_ln, x_hat.dtype)
        return out.reshape(x_hat.shape[0], -1, x4.shape[-1])

    @staticmethod
    def backward(ctx, g):
        p, (leaves, yf_g, yb_g) = ctx.p, ctx.mid
        x4, a_args, b_args, (xc_f, xc_b), (yf, yb) = ctx.tensors
        transposed, scaling, eps, use_ln, x_dtype = ctx.cfg
        di = p.conv_f_w.shape[0]
        g4 = g.reshape(x4.shape).to(x4.dtype).contiguous()
        (dx_b, dxc_f, dxc_b, dy, dw_out, db_out, dw_z, db_z, dln_w, dln_b,
         dd_f, dd_b) = pass_b_bwd(g4, x4, xc_f, xc_b, yf, yb, *b_args, eps,
                                  use_ln, transposed)
        mid = torch.autograd.grad((yf_g, yb_g), leaves, (dy, dy))
        dx, dw_x, db_x, dw_cf, db_cf, dw_ab, db_ab = pass_a_bwd(
            x4, dx_b, dxc_f, dxc_b, mid[0].contiguous(),
            mid[1].contiguous(), *a_args, scaling, transposed)
        grads = dict(
            in_w=torch.cat([dw_x, dw_z], 0), in_b=torch.cat([db_x, db_z]),
            conv_f_w=dw_cf, conv_f_b=db_cf, conv_b_w=dw_ab, conv_b_b=db_ab,
            x_proj_f=mid[2], dt_w_f=mid[3], dt_b_f=mid[4], A_log_f=mid[5],
            D_f=dd_f, x_proj_b=mid[6], dt_w_b=mid[7], dt_b_b=mid[8],
            A_log_b=mid[9], D_b=dd_b, ln_w=dln_w if use_ln else None,
            ln_b=dln_b if use_ln else None, out_w=dw_out, out_b=db_out)
        ctx.mid = ctx.tensors = None
        return ((dx.reshape(g.shape).to(x_dtype),) + (None,) * 7
                + _param_grads(p, grads, ctx.needs_input_grad[8:]))


class FusedMixerCoreRematFn(torch.autograd.Function):
    """The fused forward (with ``recompute``: in its recompute form) with
    the rematerializing backward: autograd through :func:`reference_core`,
    recomputed from x̂ and the parameters. Counterpart of
    ``bwd_mode="remat"`` in the JAX package, and of its recompute mode,
    which saves no conv outputs for the adjoint kernels."""

    @staticmethod
    def forward(ctx, x_hat, grid, transposed, scaling, eps, use_ln, dtype,
                scan_impl, recompute, *params):
        p = FusedParams(*params)
        out, x4, *_ = _fused_forward(x_hat, p, grid, transposed, scaling,
                                     eps, use_ln, dtype, scan_impl,
                                     recompute=recompute)
        ctx.p, ctx.x_hat = p, x_hat
        ctx.cfg = (grid, transposed, scaling, eps, use_ln, dtype, scan_impl)
        return out.reshape(x_hat.shape[0], -1, x4.shape[-1])

    @staticmethod
    def backward(ctx, g):
        present = [i for i, t in enumerate(ctx.p) if t is not None]
        leaves = [ctx.x_hat.detach().requires_grad_()] + [
            ctx.p[i].detach().requires_grad_() for i in present]
        params = [None] * len(ctx.p)
        for i, leaf in zip(present, leaves[1:]):
            params[i] = leaf
        with torch.enable_grad():
            out = reference_core(leaves[0], FusedParams(*params), *ctx.cfg)
        grads = torch.autograd.grad(out, leaves, g.to(out.dtype),
                                    allow_unused=True)
        dp = [None] * len(ctx.p)
        for i, gr in zip(present, grads[1:]):
            dp[i] = gr
        return (grads[0],) + (None,) * 8 + tuple(dp)


def fused_mixer_core(x_hat: torch.Tensor, p: FusedParams,
                     grid: Tuple[int, int], transposed: bool, scaling: float,
                     eps: float, use_ln: bool, dtype: torch.dtype,
                     scan_impl: str = "auto", return_saved: bool = False,
                     bwd_mode: str = "fused", recompute: bool = False):
    """The fused mixer layer, in_proj → … → out_proj. x_hat: (B, L, dm)
    normed block input. Returns (B, L, dm) in ``dtype``; with
    ``return_saved`` (forward only) also ``(xc_f, xc_b, pf, pb, yf, yb)``.
    With ``recompute`` pass A writes the pools only and pass B is K7
    (xc_f and xc_b are then None).

    When a gradient is needed the call goes through
    :class:`FusedMixerCoreFn` (the K5 and K6 adjoint kernels) where
    :func:`fused_bwd_route` says "fused", and through
    :class:`FusedMixerCoreRematFn` (autograd through
    :func:`reference_core`) where it says "remat": for ``bwd_mode="remat"``,
    and for any ``bwd_mode`` at widths the adjoint kernels do not take
    (d_model not a multiple of 64 or > d_inner). Every registry width,
    FastVim-T to -H, takes the adjoint kernels. With ``recompute``, which
    keeps no conv outputs for the adjoint kernels, it is always the
    latter. On CUDA, widths the forward kernels do not take raise here,
    before anything is launched."""
    dm, di = x_hat.shape[-1], p.conv_f_w.shape[0]
    route = fused_bwd_route(dm, di, bwd_mode)
    if x_hat.is_cuda and not (pass_a_widths_ok(dm, di)
                              and pass_b_widths_ok(dm, di, recompute)):
        raise ValueError(
            f"fused_mixer_core: the fused forward kernels take d_model % 32 "
            f"== 0, d_inner % 64 == 0, d_model <= {FWD_MAX_DM} and d_inner "
            f"<= {FWD_MAX_DI} (with recompute: d_model <= "
            f"{RECOMPUTE_MAX_DM}, d_inner <= {RECOMPUTE_MAX_DI}), got "
            f"d_model={dm}, d_inner={di}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x_hat,) + tuple(p))
    if needs_grad:
        if return_saved:
            raise ValueError("return_saved is a forward-only option")
        args = (x_hat, tuple(grid), transposed, scaling, eps, use_ln, dtype,
                scan_impl)
        if recompute or route == "remat":
            return FusedMixerCoreRematFn.apply(*args, recompute, *p)
        return FusedMixerCoreFn.apply(*args, *p)
    out, _, _, _, saved, _ = _fused_forward(x_hat, p, grid, transposed,
                                            scaling, eps, use_ln, dtype,
                                            scan_impl, recompute=recompute)
    out = out.reshape(x_hat.shape[0], -1, x_hat.shape[-1])
    return (out, saved) if return_saved else out
