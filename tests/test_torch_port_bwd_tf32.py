"""The fp32 K5 and K6 (csrc/layer_fused_bwd_tf32.cu: 3xTF32 products on
the tensor cores, blocks of whole lines), on the CPU.

First their precision: the products of the layer's adjoint under the
kernels' model (``tf32x3_steps_plain``: each operand split into TF32 hi
and lo, each 8-deep k-step's lo·hi + hi·lo + hi·hi summed in a fresh tile
and added in fp32, the weight gradients over the token slices
``_wgrad_splits`` picks, added in the fixed order of the sums kernel)
against fp64 within FP32_TOL (|got − want| <= tol + tol·|want|, tol =
1e-4, as chip_smoke.py states it), and one TF32 product missing it. Then
the plain mirror of the kernels' order of sums (``pass_b_bwd_tf32_plain``,
``pass_a_bwd_tf32_plain``: those products, the column sums per block of
lines and half, the segments of a line longer than a block, the blocks
added in the sums kernel's order) against the plain versions, which the
card holds the kernels to, and, put in for the adjoint of the fused layer
on the CPU, against the JAX package as tests/test_torch_port_bwd_wide.py
runs it: its Pallas adjoint kernels in interpret mode on the grids they
take (8 × 8), ``jax.grad`` of ``_reference_core`` on the others (14-token
lines, lines longer than a block). Inputs and weights come from numpy with
a seed and go to both sides, in fp32.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.ops.pallas.layer_fused import fusable as jax_fusable
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fused_mixer_core,
)

FP32_TOL = 1e-4
R, N = 8, 16
CSRC = Path(lf.__file__).parent / "csrc"
_TRANSPOSED = {"in_w", "conv_f_w", "conv_b_w", "x_proj_f", "dt_w_f",
               "x_proj_b", "dt_w_b", "out_w"}


def _within(got, want, tol=FP32_TOL):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _exact(a, b):
    return (a.double() @ b.double()).float()


@pytest.mark.parametrize("K", [384, 1536, 2560])
def test_dx_products_keep_the_fp32_contract(K):
    """dx̂ = dz·W_z + dxin·W_x contracts over d_inner: dz-like operands
    (about N(0, 1)) against a (d_inner, d_model) weight at its init scale
    K^-½, up to FastVim-H's d_inner."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((256, K)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1.0, 1.0, (K, 64)).astype(np.float32)
                         * np.float32(K ** -0.5))
    assert _within(lf.tf32x3_steps_plain(a, b), _exact(a, b))


@pytest.mark.parametrize("dm,di,jobs", [(192, 384, 2), (768, 1536, 2),
                                        (1280, 2560, 1)])
def test_weight_gradients_keep_the_fp32_contract(dm, di, jobs):
    """dW = Xᵀ·Y contracts over every token: 3,136 tokens (16 images of a
    14 × 14 grid) in the token slices ``_wgrad_splits`` picks for these
    widths (K5's two jobs, K6's one), a 128 × 64 corner of the gradient
    (the sums do not depend on its size). X a cotangent (dz, dxin: N(0,
    0.1)), Y x̂ (N(0, 1))."""
    T = 16 * 196
    nsplit = lf._wgrad_splits(T, dm, di, jobs, False)
    assert nsplit > 1
    rng = np.random.default_rng(di)
    x = torch.from_numpy(rng.normal(0.0, 0.1, (T, 128)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
    got = lf.tf32x3_steps_plain(x.t(), y, nsplit)
    assert _within(got, _exact(x.t(), y))


def test_one_tf32_product_misses_the_fp32_contract():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((256, 1536)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1.0, 1.0, (1536, 64)).astype(
        np.float32) * np.float32(1536 ** -0.5))
    assert not _within(lf.tf32x3_steps_plain(a, b, terms=1), _exact(a, b))
    assert _within(lf.tf32x3_steps_plain(a, b, terms=3), _exact(a, b))


def test_segment_sum_order():
    """The sums kernel's order: partial s into running sum s % 8, then the
    eight in order; one partial comes back unchanged."""
    parts = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (19, 5)).astype(np.float32))
    sums = [parts[k::8].sum(0) * 0 for k in range(8)]
    for k in range(8):
        for p in parts[k::8]:
            sums[k] = sums[k] + p
    want = sums[0]
    for s in sums[1:]:
        want = want + s
    assert torch.equal(lf._segment_sum(parts), want)
    assert torch.equal(lf._segment_sum(parts[:1]), parts[0])


@pytest.mark.parametrize("P,ln,cap,want", [
    (14, 14, 64, (4, 56)), (14, 14, 122, (8, 112)),   # 224 px
    (9, 4, 64, (9, 36)), (3, 130, 64, (1, 44)),       # a line in 3 segments
    (3, 130, 122, (1, 65)), (5, 64, 64, (1, 64)), (2, 65, 64, (1, 33)),
])
def test_bwd_runs(P, ln, cap, want):
    assert lf.bwd_runs(P, ln, cap) == want


def _b_args(seed, B, H, W, dm, di, transposed, use_ln=True):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32))
    P = W if transposed else H
    return (r(B, H, W, dm), r(B, H, W, dm), r(B, H, W, di), r(B, H, W, di),
            r(B, P, di), r(B, P, di), r(di, dm, sc=dm ** -0.5), r(di, sc=.3),
            r(di), r(di), 1 + r(di, sc=.1), r(di, sc=.1),
            r(dm, di, sc=di ** -0.5), 1e-5, use_ln, transposed)


def _a_args(seed, B, H, W, dm, di, transposed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32))
    P = W if transposed else H
    return (r(B, H, W, dm), r(B, H, W, dm), r(B, H, W, di), r(B, H, W, di),
            r(B, P, di), r(B, P, di), r(di, dm, sc=dm ** -0.5), r(di, sc=.3),
            r(di, 4, sc=.5), r(di), r(di, 4, sc=.5), r(di), 0.7, transposed)


def _close_all(got, want, n_per_token):
    """As tests/test_torch_port_cuda.py holds the kernels to the plain
    versions: per-token outputs to FP32_TOL, sums over every token with
    atol scaled by the tensor's largest entry."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        atol = FP32_TOL * max(1.0, w.abs().max().item()) \
            if i >= n_per_token else FP32_TOL
        assert ((g - w).abs() <= atol + FP32_TOL * w.abs()).all(), i


@pytest.mark.parametrize("grid,transposed,batch,use_ln", [
    ((9, 4), False, 2, True),     # lines of 4: one block an image
    ((4, 14), False, 2, True),    # 14-token lines (224 px), and
    ((14, 4), True, 2, False),    # columns, without the LayerNorm
    ((20, 16), False, 1, True),   # blocks of 4 lines (K5), 7 + 7 + 6 (K6)
    ((17, 17), True, 2, True),    # ragged last blocks both
    ((31, 6), True, 1, True),     # 31-token columns
    ((5, 32), False, 2, True),    # 32-token lines (512 px)
    ((4, 130), False, 1, True),   # longer than a block: segments
    ((130, 4), True, 1, True),
])
def test_tf32_mirror_matches_plain(grid, transposed, batch, use_ln):
    """The mirror of the fp32 kernels' products and order of sums keeps
    the contract the card holds the kernels to (dm 64, di 128)."""
    seed = grid[0] * 100 + grid[1]
    b = _b_args(seed, batch, *grid, 64, 128, transposed, use_ln)
    _close_all(lf.pass_b_bwd_tf32_plain(*b), lf.pass_b_bwd_plain(*b), 4)
    a = _a_args(seed, batch, *grid, 64, 128, transposed)
    _close_all(lf.pass_a_bwd_tf32_plain(*a), lf.pass_a_bwd_plain(*a), 1)


def _layer_params(seed, dm, di):
    """The JAX fused layer's parameter tuple from numpy, and the port's
    FusedParams of the same values (torch layouts); all 20 present."""
    rng = np.random.default_rng(seed)
    u = lambda shape, s=0.2: rng.uniform(-s, s, shape).astype(np.float32)
    p = dict(
        win=u((dm, 2 * di), dm ** -0.5), bin_=u((2 * di,)),
        wcf=u((4, di)), bcf=u((di,)), wab=u((4, di)), bab=u((di,)),
        xpf=u((di, R + 2 * N), di ** -0.5), dtwf=u((R, di)),
        dtbf=u((di,), 0.5), Af=u((di, N), 1.0), Df=u((di,)),
        xpb=u((di, R + 2 * N), di ** -0.5), dtwb=u((R, di)),
        dtbb=u((di,), 0.5), Ab=u((di, N), 1.0), Db=u((di,)),
        lnw=1.0 + u((di,), 0.1), lnb=u((di,), 0.1),
        wout=u((di, dm), di ** -0.5), bout=u((dm,)))
    jp = tuple(jnp.asarray(v) for v in p.values())
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    mats = {"win", "wcf", "wab", "xpf", "dtwf", "xpb", "dtwb", "wout"}
    tp = FusedParams(*(t(v.T if k in mats else v) for k, v in p.items()))
    return jp, tp


@pytest.mark.parametrize("grid,transposed,batch,dm,di", [
    ((4, 14), False, 2, 64, 128),    # 14-token lines: reference core
    ((14, 4), True, 2, 64, 128),     # ... down the columns
    ((8, 8), False, 2, 64, 128),     # the Pallas adjoint, interpreted
    ((4, 14), True, 1, 448, 896),    # past d_model 384, d_inner 768
    ((4, 136), False, 1, 64, 128),   # lines of 136: segments in K5 and K6
])
def test_tf32_mirror_layer_grads_match_jax(monkeypatch, grid, transposed,
                                           batch, dm, di):
    """``FusedMixerCoreFn`` with its backward passes replaced by the
    mirrors of the fp32 kernels: the gradients of Σ out² with respect to
    x̂ and all 20 parameters within 1e-4 of each tensor's largest entry
    of the JAX package's (its fused adjoint kernels interpreted where
    ``fusable``, else ``jax.grad`` of ``_reference_core``)."""
    monkeypatch.setattr(lf, "pass_b_bwd", lf.pass_b_bwd_tf32_plain)
    monkeypatch.setattr(lf, "pass_a_bwd", lf.pass_a_bwd_tf32_plain)
    x = np.random.default_rng(dm + grid[1]).standard_normal(
        (batch, grid[0] * grid[1], dm)).astype(np.float32)
    jp, tp = _layer_params(di + grid[0], dm, di)
    args = (grid, transposed, 0.5, 1e-5, True)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = FusedParams(*(t.clone().requires_grad_() for t in tp))
    out = fused_mixer_core(xt, leaves, *args, torch.float32)
    assert type(out.grad_fn).__name__ == "FusedMixerCoreFnBackward"
    gx, *gp = torch.autograd.grad((out ** 2).sum(), [xt, *leaves])
    pool_axes = (0,) if transposed else (1,)
    if jax_fusable(grid, pool_axes, transposed, di, 4, "mean"):
        assert grid == (8, 8)
        fn, extra = jax_fused_mixer_core, (True, "fused")
    else:
        fn, extra = _reference_core, ()
    want_x, want_p = jax.jit(jax.grad(lambda xx, pp: jnp.sum(
        fn(xx, pp, *args, jnp.float32, "ref", *extra) ** 2),
        argnums=(0, 1)))(jnp.asarray(x), jp)
    for name, g, w in (("x_hat", gx, want_x),
                       *zip(FusedParams._fields, gp, want_p)):
        g, w = g.numpy(), np.asarray(w)
        g = g.T if name in _TRANSPOSED else g
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= FP32_TOL * np.abs(w).max(), name


def test_fp32_entry_points_take_the_tf32_kernels():
    """Both C entry points hand fp32 to the 3xTF32 kernels, and no source
    holds an FMA-tile fp32 kernel of K5 or K6 any more (no fallback)."""
    entry = (CSRC / "layer_fused_bwd.cu").read_text()
    assert "fvb::pass_b_bwd_f32" in entry and "fvb::pass_a_bwd_f32" in entry
    for old in ("pass_b_bwd_kernel", "pass_b_bwd_wide_kernel",
                "pass_a_bwd_conv_kernel", "wgrad_kernel", "dx_rows_kernel",
                "kF32NarrowDi"):
        for src in CSRC.glob("*.cu*"):  # the JAX names start with "_"
            assert not re.search(rf"\b{old}\b", src.read_text()), (
                old, src.name)
