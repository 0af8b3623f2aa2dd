"""The port's block-kernel, fused-merge, recompute and lanes paths
(K7, K8, K9, K10, lanes) against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold those to the Pallas kernels they stand in for, run in interpret mode
as the JAX package's own tests run them, and to the JAX references, then
the autograd Functions to ``jax.grad`` of the JAX entry points, then the
four model configurations that reach the kernels to the JAX VisionMamba.
Inputs and weights are made with numpy from a seed and fed to both sides,
in fp32. Sizes: grids 16 × 16 and 8 × 24, d_model 64, d_inner 128, d_state
8, depth 4, batch 2.

Tolerances: rtol = atol = 2e-5 against an fp32 reference (the same fp32
operations in another order); 2e-4 for the scans, as tests/test_scan.py
uses (sums over L in another order); 1e-4 on logits (depth 4 of the
former); gradients as tests/test_torch_port_grad.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.ops.pallas import fused_block as jfb
from fastvim_tpu.ops.pallas import merge_gate as jmg
from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu.ops.pallas.selective_scan import selective_scan_pallas
from fastvim_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from fastvim_tpu.train.mixup import cross_entropy as jax_cross_entropy
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import fused_block as fb
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels import merge_gate as mg
from fastvim_tpu_torch.ops.kernels import selective_scan as ss
from fastvim_tpu_torch.ops.scan import selective_scan
from fastvim_tpu_torch.train import (
    TrainState,
    constant,
    make_optimizer,
    make_supervised_train_step,
)
from fastvim_tpu_torch.utils import from_jax_params, grads_to_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=3e-3, atol=3e-4)
DM, DI, R, N = 64, 128, 4, 8
GRIDS = [(16, 16), (8, 24)]

T = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
J = lambda a: None if a is None else jnp.asarray(a)


def _block_args(seed, rows, cols, d=DI, batch=2, scale=1.0):
    """The merge kernel's arguments in the JAX order (conv weights (4, d)):
    x, z, yf, yb, wf, bf, wb, bb, df, db, lnw, lnb."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (k * rng.standard_normal(s)).astype(np.float32)
    L = rows * cols
    return [f(batch, L, d, k=scale), f(batch, L, d), f(batch, rows, d, k=scale),
            f(batch, rows, d, k=scale), f(4, d, k=0.5), f(d, k=0.1 * scale),
            f(4, d, k=0.5), f(d, k=0.1 * scale), f(d), f(d),
            1.0 + f(d, k=0.1), f(d, k=0.1)]


def _port_block_args(a):
    """The same values in the port's layout: conv weights (d, 4)."""
    a = list(a)
    a[4], a[6] = a[4].T, a[6].T
    return [T(v) for v in a]


# ----------------------------------------------------------------------
# K8: conv + pool
# ----------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("method,scaling,tiles", [
    ("mean", 0.25, 1), ("mean", 1.0, 2), ("max", 1.0, 1), ("max", 1.0, 2)])
def test_conv_pool_matches_pallas_and_ref(grid, method, scaling, tiles,
                                          monkeypatch):
    """K8's plain version against the Pallas kernel in interpret mode, in
    one tile and (with its VMEM budget cut so that a tile is half the
    rows, where the rows are 16) in two, whose halo rows come from the
    neighbouring tile; and against conv_pool_ref. ``max`` takes no
    scaling."""
    rows, cols = grid
    if tiles == 2:
        monkeypatch.setattr(jfb, "_FP32_WORK_BUDGET",
                            8 * cols * DI * 4 * jfb._FP32_TEMPS)
        assert jfb._pick_tile(rows, cols, DI) == 8
    a = _block_args(rows, rows, cols)
    x, wf, bf, wb, bb = (a[i] for i in (0, 4, 5, 6, 7))
    got = fb.conv_pool(T(x), T(wf.T), T(bf), T(wb.T), T(bb), rows, cols,
                       method, scaling)
    pal = jfb.conv_pool(J(x), J(wf), J(bf), J(wb), J(bb), rows, cols, method,
                        scaling, True)
    ref = jfb.conv_pool_ref(J(x), J(wf), J(bf), J(wb), J(bb), rows, cols,
                            method, scaling)
    for g, p, r in zip(got, pal, ref):
        assert g.dtype == torch.float32 and g.shape == (2, rows, DI)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("grid", [(1, 12), (6, 2), (5, 1)])
def test_conv_pool_short_rows_match_ref(grid):
    """Rows shorter than the conv's reach and a single-row grid, which the
    flat conv crosses like any other: against conv_pool_ref."""
    rows, cols = grid
    a = _block_args(7, rows, cols, d=32)
    x, wf, bf, wb, bb = (a[i] for i in (0, 4, 5, 6, 7))
    assert fb.fusable(rows, cols, 32)
    got = fb.conv_pool(T(x), T(wf.T), None, T(wb.T), T(bb), rows, cols)
    ref = jfb.conv_pool_ref(J(x), J(wf), jnp.zeros(32), J(wb), J(bb), rows,
                            cols)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ----------------------------------------------------------------------
# K9: conv again + merge + LN + gate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("use_norm", [True, False])
def test_merge_gate_matches_pallas_and_ref(grid, use_norm):
    """K9's plain version against the Pallas kernel in interpret mode and
    merge_gate_ref. The Pallas kernel takes the variance as E[m²] − μ² of
    2·m, which rounds at 1e-6 of E[m²]: 1e-4 against it, 2e-5 against the
    reference, which takes the mean of (m − μ)² as the port does."""
    rows, cols = grid
    a = _block_args(rows + 1, rows, cols)
    got = fb.merge_gate(*_port_block_args(a), rows, cols, 1e-5, use_norm)
    ja = [J(v) for v in a]
    pal = jfb.merge_gate(*ja, rows, cols, 1e-5, use_norm, True)
    ref = jfb.merge_gate_ref(*ja, rows, cols, 1e-5, use_norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_merge_gate_tiny_variance_uses_eps_of_m():
    """Inputs 1e-3 of the usual size: the variance of m over the channels
    is about 1e-6, below eps = 1e-5, so the result depends on eps. The
    TPU kernel normalizes 2·m with 4·eps; the port normalizes m with eps,
    which is the same function, and not 2·m with eps, which is not."""
    rows, cols = 8, 24
    a = _block_args(3, rows, cols, scale=1e-3)
    got = fb.merge_gate(*_port_block_args(a), rows, cols, 1e-5, True).numpy()
    ja = [J(v) for v in a]
    ref = np.asarray(jfb.merge_gate_ref(*ja, rows, cols, 1e-5, True))
    pal = np.asarray(jfb.merge_gate(*ja, rows, cols, 1e-5, True, True))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, rtol=1e-4, atol=1e-4)
    wrong = np.asarray(jfb.merge_gate_ref(*ja, rows, cols, 0.25e-5, True))
    assert np.abs(got - wrong).max() > 1e-2


# ----------------------------------------------------------------------
# K10: merge + LN + gate from materialized conv outputs
# ----------------------------------------------------------------------

def _merge_ln_args(seed, grid, pool_axes, with_ln):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (k * rng.standard_normal(s)).astype(np.float32)
    H, W = grid
    P = H if pool_axes == (1,) else W
    ln = (1.0 + f(DI, k=0.1), f(DI, k=0.1)) if with_ln else (None, None)
    return [f(2, H * W, DI), f(2, H * W, DI), f(2, H * W, DI), f(2, P, DI),
            f(2, P, DI), f(DI), f(DI), *ln]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("pool_axes", [(1,), (0,)])
@pytest.mark.parametrize("with_ln", [True, False])
def test_merge_ln_gate_matches_pallas_and_ref(grid, pool_axes, with_ln):
    """K10's plain version against the Pallas kernel in interpret mode
    and its reference _merge_ref, both broadcast patterns, with LayerNorm
    and without (ln_w, ln_b None)."""
    a = _merge_ln_args(grid[0], grid, pool_axes, with_ln)
    static = (grid, pool_axes, 1e-5, with_ln)
    got = mg.merge_ln_gate(*(T(v) for v in a), *static)
    ja = [J(v) for v in a]
    pal = jmg.merge_ln_gate(*ja, *static, True)
    ref = jmg._merge_ref(*ja, *static)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_block_kernels_take_grids_the_tpu_kernels_refuse():
    """The 14 × 14 grid of 224 px and d_inner that is no multiple of 128:
    Mosaic's block rules are gone, d % 32 is what is left."""
    assert not jmg.fusable((14, 14), (1,), 384)
    assert mg.fusable((14, 14), (1,), 384) and mg.fusable((14, 14), (0,), 96)
    assert fb.fusable(14, 14, 2560)
    assert not mg.fusable((14, 14), (1,), 100)
    assert not mg.fusable((14, 14), (0, 1), 384)
    assert not mg.fusable((14, 14, 3), (1,), 384)
    assert not fb.fusable(14, 14, 100)


# ----------------------------------------------------------------------
# K7: the fused layer in its recompute form
# ----------------------------------------------------------------------

def _layer_params(seed, bias=False, dm=DM, di=DI):
    """The JAX fused layer's parameter tuple from numpy, and the port's
    FusedParams of the same values (torch layouts)."""
    rng = np.random.default_rng(seed)
    u = lambda shape, s=0.2: rng.uniform(-s, s, shape).astype(np.float32)
    p = dict(
        win=u((dm, 2 * di)), bin_=u((2 * di,)) if bias else None,
        wcf=u((4, di)), bcf=u((di,)), wab=u((4, di)), bab=u((di,)),
        xpf=u((di, R + 2 * N)), dtwf=u((R, di)), dtbf=u((di,), 0.5),
        Af=u((di, N), 1.0), Df=u((di,)),
        xpb=u((di, R + 2 * N)), dtwb=u((R, di)), dtbb=u((di,), 0.5),
        Ab=u((di, N), 1.0), Db=u((di,)),
        lnw=1.0 + u((di,), 0.1), lnb=u((di,), 0.1),
        wout=u((di, dm)), bout=u((dm,)) if bias else None)
    jp = tuple(J(v) for v in p.values())
    tr = lambda k: T(p[k].T)
    tp = lf.FusedParams(
        tr("win"), T(p["bin_"]), tr("wcf"), T(p["bcf"]), tr("wab"),
        T(p["bab"]), tr("xpf"), tr("dtwf"), T(p["dtbf"]), T(p["Af"]),
        T(p["Df"]), tr("xpb"), tr("dtwb"), T(p["dtbb"]), T(p["Ab"]),
        T(p["Db"]), T(p["lnw"]), T(p["lnb"]), tr("wout"), T(p["bout"]))
    return jp, tp


_TRANSPOSED = {"in_w", "conv_f_w", "conv_b_w", "x_proj_f", "dt_w_f",
               "x_proj_b", "dt_w_b", "out_w"}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("transposed", [False, True])
def test_recompute_core_matches_pallas_and_reference(grid, transposed,
                                                     monkeypatch):
    """fused_mixer_core(recompute=True) — pass A's pools-only form, the
    scans, K7's plain version — against the JAX fused layer in its
    recompute mode (FASTVIM_LF_RECOMPUTE=1, read each time the untraced
    forward runs; Pallas in interpret mode) and against _reference_core,
    both orientations; it keeps no conv outputs."""
    x = np.random.default_rng(1).standard_normal(
        (2, grid[0] * grid[1], DM)).astype(np.float32)
    jp, tp = _layer_params(2, bias=transposed)
    args = (grid, transposed, 0.5, 1e-5, True)
    out, saved = lf.fused_mixer_core(T(x), tp, *args, torch.float32,
                                     return_saved=True, recompute=True)
    assert saved[0] is None and saved[1] is None
    monkeypatch.setenv("FASTVIM_LF_RECOMPUTE", "1")
    pal = jax_fused_mixer_core(J(x), jp, *args, jnp.float32, "ref", True)
    ref = _reference_core(J(x), jp, *args, jnp.float32, "ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("pass_b", ["plain", "slab-order mirror"])
def test_recompute_core_at_fastvim_s_width_matches_pallas(transposed, pass_b,
                                                          monkeypatch):
    """fused_mixer_core(recompute=True) at FastVim-S's widths (d_model 384,
    d_inner 768), which K7 now takes as the JAX package's recompute mode
    does, against the JAX fused layer in that mode (Pallas in interpret
    mode), 8 x 8 grid, batch 1, both orientations; with pass B's plain
    version, and with its mirror of the bf16 kernel's LayerNorm sum order
    (pass_b_recompute_slabs_plain) in its place."""
    dm, di = 384, 768
    assert lf.pass_b_widths_ok(dm, di, recompute=True)
    if pass_b != "plain":
        monkeypatch.setattr(lf, "pass_b_recompute",
                            lf.pass_b_recompute_slabs_plain)
    x = np.random.default_rng(7).standard_normal((1, 64, dm)).astype(
        np.float32)
    jp, tp = _layer_params(8, bias=transposed, dm=dm, di=di)
    args = ((8, 8), transposed, 0.5, 1e-5, True)
    out = lf.fused_mixer_core(T(x), tp, *args, torch.float32, recompute=True)
    monkeypatch.setenv("FASTVIM_LF_RECOMPUTE", "1")
    pal = jax_fused_mixer_core(J(x), jp, *args, jnp.float32, "ref", True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL)


@pytest.mark.parametrize("di", [128, 160, 768])
def test_slab_ln_stats_match_mean_and_variance(di):
    """The mirror of K7's LayerNorm sum order gives the statistics of
    pass_b_plain's mean-based ones, d_inner a whole number of 64-channel
    slabs or not."""
    m = torch.from_numpy(np.random.default_rng(di).standard_normal(
        (3, 5, di)).astype(np.float32))
    mu, rstd = lf._slab_ln_stats(m, 1e-5)
    want_mu = m.mean(-1, keepdim=True)
    want_var = (m * m).mean(-1, keepdim=True) - want_mu * want_mu
    np.testing.assert_allclose(mu.numpy(), want_mu.numpy(), **TOL)
    np.testing.assert_allclose(rstd.numpy(),
                               torch.rsqrt(want_var + 1e-5).numpy(), **TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bwd_mode", ["fused", "remat"])
def test_recompute_grads_match_jax(transposed, bwd_mode, monkeypatch):
    """With a gradient the recompute form goes through the rematerializing
    Function whatever bwd_mode says; its gradients of Σ out² against
    jax.grad of the JAX fused layer in recompute mode."""
    grid = (8, 24)
    x = np.random.default_rng(4).standard_normal(
        (2, grid[0] * grid[1], DM)).astype(np.float32)
    jp, tp = _layer_params(5)
    args = (grid, transposed, 1.0, 1e-5, True)
    xt = T(x).requires_grad_()
    leaves = lf.FusedParams(*(None if t is None else t.requires_grad_()
                              for t in tp))
    out = lf.fused_mixer_core(xt, leaves, *args, torch.float32,
                              bwd_mode=bwd_mode, recompute=True)
    assert type(out.grad_fn).__name__ == "FusedMixerCoreRematFnBackward"
    present = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad((out ** 2).sum(), [xt] + present))
    gx = next(grads).numpy()
    gp = [None if t is None else next(grads).numpy() for t in leaves]
    monkeypatch.setenv("FASTVIM_LF_RECOMPUTE", "1")
    want_x, want_p = jax.jit(jax.grad(lambda xx, pp: jnp.sum(
        jax_fused_mixer_core(xx, pp, *args, jnp.float32, "ref", True,
                             bwd_mode) ** 2), argnums=(0, 1)))(J(x), jp)
    np.testing.assert_allclose(gx, np.asarray(want_x), **GRAD_TOL)
    for name, g, w in zip(lf.FusedParams._fields, gp, want_p):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g.T if name in _TRANSPOSED else g,
                                       np.asarray(w), err_msg=name,
                                       **GRAD_TOL)


# ----------------------------------------------------------------------
# lanes
# ----------------------------------------------------------------------

SCAN_ARGS = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _scan_inputs(seed, batch, L, d, n=N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
                A=-np.exp(rng.uniform(-1, 1, (d, n))).astype(np.float32),
                B=f(batch, L, n), C=f(batch, L, n),
                D=rng.uniform(-1, 1, d).astype(np.float32),
                delta_bias=rng.uniform(-0.5, 0.5, d).astype(np.float32),
                w=f(batch, L, d))


def test_lanes_scan_matches_pallas_and_ref():
    """selective_scan(variant="lanes") — on the CPU the doubling scan in
    tensor ops — against the Pallas lanes kernel in interpret mode
    (L = 300 with 128-step chunks: two whole chunks and a padded one) and
    the sequential JAX reference; 128-step chunks as the CUDA kernel's
    and 32-step ones agree; reverse raises."""
    a = _scan_inputs(11, 2, 300, DI)
    t = {k: T(v) for k, v in a.items()}
    kw = dict(D=t["D"], delta_bias=t["delta_bias"], delta_softplus=True)
    got = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                         variant="lanes", **kw)
    wide = ss.selective_scan_fwd_lanes_plain(t["u"], t["delta"], t["A"],
                                             t["B"], t["C"], chunk=32, **kw)
    j = {k: J(v) for k, v in a.items()}
    jkw = dict(D=j["D"], delta_bias=j["delta_bias"], delta_softplus=True)
    pal = selective_scan_pallas(j["u"], j["delta"], j["A"], j["B"], j["C"],
                                block_l=128, block_d=128, interpret=True,
                                variant="lanes", **jkw)
    ref = jax_scan_ref(j["u"], j["delta"], j["A"], j["B"], j["C"], **jkw)
    assert got.shape == (2, 300, DI)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCAN_TOL)
    np.testing.assert_allclose(wide.numpy(), got.numpy(), **SCAN_TOL)
    with pytest.raises(NotImplementedError, match="forward-only"):
        selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                       reverse=True, variant="lanes")
    with pytest.raises(ValueError, match="sublane|lanes"):
        selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                       variant="rows")


def test_lanes_scan_grads_match_jax():
    """The lanes Function's gradients of Σ y·w (on the CPU: autograd
    through the sequential reference) against jax.grad of the Pallas
    lanes scan, which recomputes through the associative scan."""
    a = _scan_inputs(12, 2, 70, 32)
    t = {k: T(a[k]).requires_grad_() for k in SCAN_ARGS}
    y = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                       delta_bias=t["delta_bias"], delta_softplus=True,
                       variant="lanes")
    assert type(y.grad_fn).__name__ == "SelectiveScanLanesFnBackward"
    got = torch.autograd.grad((y * T(a["w"])).sum(),
                              [t[k] for k in SCAN_ARGS])
    w = J(a["w"])
    want = jax.jit(jax.grad(lambda u, dl, A, B, C, D, b: jnp.sum(
        selective_scan_pallas(u, dl, A, B, C, D=D, delta_bias=b,
                              delta_softplus=True, block_l=32, block_d=32,
                              interpret=True, variant="lanes") * w),
        argnums=tuple(range(7))))(*(J(a[k]) for k in SCAN_ARGS))
    for name, g, r in zip(SCAN_ARGS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **SCAN_TOL)


# ----------------------------------------------------------------------
# gradients of K8, K9, K10 through their Functions
# ----------------------------------------------------------------------

def _port_grads(fn, args, static, weight):
    leaves = [None if a is None else T(a).requires_grad_() for a in args]
    out = fn.apply(*leaves, *static)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * T(w)).sum() for o, w in zip(outs, weight))
    present = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(loss, present))
    return [None if t is None else next(grads).numpy() for t in leaves]


def test_conv_pool_grads_match_jax():
    """ConvPoolFn (backward: autograd through conv_pool_plain) against
    jax.grad of conv_pool, mean with scaling and max."""
    rows, cols = 8, 24
    a = _block_args(21, rows, cols)
    x, wf, bf, wb, bb = (a[i] for i in (0, 4, 5, 6, 7))
    rng = np.random.default_rng(22)
    w = [rng.standard_normal((2, rows, DI)).astype(np.float32)
         for _ in range(2)]
    for method, scaling in (("mean", 0.5), ("max", 1.0)):
        got = _port_grads(fb.ConvPoolFn, (x, wf.T, bf, wb.T, bb),
                          (rows, cols, method, scaling), w)
        got[1], got[3] = got[1].T, got[3].T

        def loss(*p):
            pf, pb = jfb.conv_pool(*p, rows, cols, method, scaling, True)
            return jnp.sum(pf * w[0]) + jnp.sum(pb * w[1])

        want = jax.grad(loss, argnums=tuple(range(5)))(
            *(J(v) for v in (x, wf, bf, wb, bb)))
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(r), **TOL)


@pytest.mark.parametrize("use_norm", [True, False])
def test_merge_gate_grads_match_jax(use_norm):
    """MergeGateFn against jax.grad of merge_gate, all 12 arguments. With
    use_norm false the LayerNorm parameters take no part: no gradient in
    the port, zeros in JAX."""
    rows, cols = 8, 24
    a = _block_args(23, rows, cols)
    w = np.random.default_rng(24).standard_normal(a[0].shape).astype(
        np.float32)
    pa = list(a)
    pa[4], pa[6] = pa[4].T, pa[6].T
    leaves = [T(v).requires_grad_() for v in pa]
    out = fb.MergeGateFn.apply(*leaves, rows, cols, 1e-5, use_norm)
    got = [None if g is None else g.numpy() for g in torch.autograd.grad(
        (out * T(w)).sum(), leaves, allow_unused=True)]
    got[4], got[6] = got[4].T, got[6].T
    want = jax.grad(lambda *p: jnp.sum(jfb.merge_gate(
        *p, rows, cols, 1e-5, use_norm, True) * w),
        argnums=tuple(range(12)))(*(J(v) for v in a))
    for i, (g, r) in enumerate(zip(got, want)):
        if g is None:
            assert not use_norm and i in (10, 11)
            assert not np.asarray(r).any()
        else:
            np.testing.assert_allclose(g, np.asarray(r), err_msg=str(i),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pool_axes,with_ln", [((1,), True), ((0,), True),
                                               ((0,), False)])
def test_merge_ln_gate_grads_match_jax(pool_axes, with_ln):
    """MergeLnGateFn against jax.grad of merge_ln_gate, both broadcast
    patterns, and the layer without LayerNorm (ln_w, ln_b None: no
    gradient slot on either side)."""
    grid = (8, 24)
    a = _merge_ln_args(25, grid, pool_axes, with_ln)
    w = np.random.default_rng(26).standard_normal(a[0].shape).astype(
        np.float32)
    static = (grid, pool_axes, 1e-5, with_ln)
    got = _port_grads(mg.MergeLnGateFn, a, static, [w])
    n = 9 if with_ln else 7
    want = jax.grad(lambda *p: jnp.sum(jmg.merge_ln_gate(
        *p, *([] if with_ln else [None, None]), *static, True) * w),
        argnums=tuple(range(n)))(*(J(v) for v in a[:n]))
    assert all(g is None for g in got[n:])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the slice as a whole: four configurations of a small model
# ----------------------------------------------------------------------

SMALL = dict(patch_size=16, depth=4, embed_dim=DM, num_classes=10,
             drop_path_rate=0.0)
# configuration → (the port's fields, the JAX model's fields, the JAX
# package's environment switch)
CONFIGS = {
    "fused_kernels_always": (
        dict(layer_fused="off", ssm_cfg={"d_state": N,
                                         "fused_kernels": "always"}),
        dict(layer_fused="off", ssm_cfg={"d_state": N,
                                         "fused_kernels": "always"}), None),
    "fused_kernels_merge": (
        dict(layer_fused="off", ssm_cfg={"d_state": N,
                                         "fused_kernels": "merge"}),
        dict(layer_fused="off", ssm_cfg={"d_state": N,
                                         "fused_kernels": "merge"}), None),
    "fused_merge": (
        dict(layer_fused="off", ssm_cfg={"d_state": N, "fused_merge": True}),
        dict(layer_fused="off", ssm_cfg={"d_state": N}),
        "FASTVIM_FUSED_MERGE"),
    "recompute": (
        dict(layer_fused="recompute", ssm_cfg={"d_state": N}),
        dict(layer_fused="on", ssm_cfg={"d_state": N}),
        "FASTVIM_LF_RECOMPUTE"),
}


def _jax_model(img_size, **kw):
    model = jax_create_model("fastvim_tiny", img_size=img_size,
                             scan_impl="ref", **SMALL, **kw)
    x = np.random.default_rng(0).standard_normal(
        (2, *img_size, 3)).astype(np.float32)
    return model, model.init(jax.random.PRNGKey(1), J(x)), x


def _port_model(img_size, params, **kw):
    model = create_model("fastvim_tiny", img_size=img_size, device="cpu",
                         **SMALL, **kw)
    model.load_state_dict({k: T(np.array(v))
                           for k, v in from_jax_params(params).items()},
                          strict=True)
    return model


@pytest.mark.parametrize("config,img_size", [
    ("fused_kernels_always", (256, 256)),   # 16 × 16 grid
    ("fused_kernels_merge", (128, 384)),    # 8 × 24
    ("fused_merge", (256, 256)),
    ("fused_merge", (128, 384)),
    ("recompute", (128, 384)),
])
def test_configurations_match_jax_and_default(config, img_size, monkeypatch):
    """Each configuration of the small model, weights carried across with
    from_jax_params (one parameter tree serves all four), against the JAX
    VisionMamba in the same configuration (its Pallas kernels in interpret
    mode) and against the port's own default configuration."""
    port_kw, jax_kw, env = CONFIGS[config]
    jmodel, params, x = _jax_model(img_size, **jax_kw)
    if env:
        monkeypatch.setenv(env, "1")
    want = np.asarray(jmodel.apply(params, J(x)))
    model = _port_model(img_size, params, **port_kw)
    default = _port_model(img_size, params, ssm_cfg={"d_state": N})
    assert sorted(model.state_dict()) == sorted(default.state_dict())
    with torch.no_grad():
        got = model(T(x)).numpy()
        base = default(T(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(got, base, **LOGIT_TOL)


def test_fused_kernels_model_rotates_odd_layers():
    """A model whose fused_kernels is not "never" materializes the
    odd-layer rotation: every mixer pools over its last axis, the odd ones
    on the swapped grid; fused_merge keeps the in-place orientation."""
    seen = []

    def record(module, args, kwargs):
        seen.append((args[1], kwargs.get("pool_axes"),
                     kwargs.get("transposed", False)))

    for ssm_cfg, odd in (({"fused_kernels": "merge"}, ((24, 8), None, False)),
                         ({"fused_merge": True}, ((8, 24), (0,), True))):
        model = create_model("fastvim_tiny", img_size=(128, 384),
                             device="cpu", layer_fused="off", ssm_cfg=ssm_cfg,
                             **{**SMALL, "depth": 2})
        seen.clear()
        hooks = [blk.mixer.register_forward_pre_hook(record, with_kwargs=True)
                 for blk in model.layers]
        with torch.no_grad():
            model(torch.zeros(1, 128, 384, 3))
        for h in hooks:
            h.remove()
        assert seen == [((8, 24), None, False), odd]


def test_train_step_fused_kernels_always_matches_jax():
    """One supervised train step of the fused_kernels="always" model
    through make_supervised_train_step: its loss and gradient norm, and
    every parameter's gradient, against jax.value_and_grad of the JAX model
    in that configuration (both sides differentiate K8 and K9 through
    their references)."""
    img_size = (128, 384)
    port_kw, jax_kw, _ = CONFIGS["fused_kernels_always"]
    small = {**SMALL, "depth": 2}
    jmodel = jax_create_model("fastvim_tiny", img_size=img_size,
                              scan_impl="ref", **small, **jax_kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *img_size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 2)
    params = jmodel.init(jax.random.PRNGKey(1), J(x))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_cross_entropy(jmodel.apply(p, J(x)), J(labels),
                                    0.1)))(params)
    want = from_jax_params(want_grads)

    model = create_model("fastvim_tiny", img_size=img_size, device="cpu",
                         **small, **port_kw)
    model.load_state_dict({k: T(np.array(v))
                           for k, v in from_jax_params(params).items()})
    state = TrainState.create(model, make_optimizer(constant(1e-3),
                                                    params=model))
    step = make_supervised_train_step(model, 10, label_smoothing=0.1,
                                      ema_decay=None)
    batch = {"image": T(x), "label": T(labels)}
    state, metrics = step(state, batch)
    np.testing.assert_allclose(metrics["train_loss"].item(), float(want_loss),
                               rtol=1e-5)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=1e-3)

    model.load_state_dict({k: T(np.array(v))
                           for k, v in from_jax_params(params).items()})
    model.zero_grad()
    from fastvim_tpu_torch.train import cross_entropy
    cross_entropy(model(T(x)), T(labels), 0.1).backward()
    got = grads_to_numpy(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


# ----------------------------------------------------------------------
# the repair: dispatch by width
# ----------------------------------------------------------------------

@pytest.mark.parametrize("d_model,fused,recompute", [
    (192, True, True),     # FastVim-T: d_inner 384
    (384, True, True),     # FastVim-S: 768, which K7 walks in slabs
    (768, True, True),     # FastVim-B: 1536, K7's wide forms
    (1280, True, True),    # FastVim-H: 2560, the widest K3, K4 and K7 take
])
def test_wide_mixers_dispatch_to_the_unfused_path(d_model, fused, recompute):
    """fusable is false for every width the K3 or K4 launcher refuses
    (with ``recompute``: K7), and the mixer asks it with its own widths: a
    mixer of FastVim-B's or -H's width, built on the CPU, dispatches as it
    would on the card, to the fused layer by default and in the recompute
    mode; only a wider one would take the unfused path. No kernel runs
    here; the launchers' own limits are the same predicates."""
    mixer = MambaMixer(d_model=d_model, n_layer=2)
    grid, di = (14, 14), 2 * d_model
    assert mixer.d_inner == di
    ask = lambda **kw: lf.fusable(grid, (1,), False, mixer.d_model,
                                  mixer.d_inner, mixer.d_conv,
                                  mixer.collapse_method, **kw)
    assert ask() is fused
    assert ask(recompute=True) is recompute
    assert fused == (lf.pass_a_widths_ok(d_model, di)
                     and lf.pass_b_widths_ok(d_model, di))
    assert recompute == lf.pass_b_widths_ok(d_model, di, recompute=True)
    # whichever path it takes, K8-K10 have no width limit of their own
    assert fb.fusable(*grid, di) and mg.fusable(grid, (0,), di)


def test_wide_mixer_forward_runs_unfused_on_cpu(monkeypatch):
    """d_model 768 (FastVim-B) at a short grid: the default dispatch and
    the recompute mode (K7's wide forms on the card) both take
    fused_mixer_core (its plain versions here) and give what
    layer_fused="off" gives, the unfused path, within 1e-4 of the largest
    entry."""
    from fastvim_tpu_torch.models import mixer as mixer_mod

    g = torch.Generator().manual_seed(0)
    a = MambaMixer(d_model=768, n_layer=2)
    a.reset_parameters(g)
    b = MambaMixer(d_model=768, n_layer=2, layer_fused="off")
    b.load_state_dict(a.state_dict())
    c = MambaMixer(d_model=768, n_layer=2, layer_fused="recompute")
    c.load_state_dict(a.state_dict())
    x = torch.randn(1, 16, 768, generator=g)
    fused = []
    monkeypatch.setattr(mixer_mod, "fused_mixer_core", lambda *args, **kw:
                        fused.append(1) or lf.fused_mixer_core(*args, **kw))
    with torch.no_grad():
        got, want, rc = a(x, (4, 4)), b(x, (4, 4)), c(x, (4, 4))
    assert fused == [1, 1]
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(rc, want, rtol=1e-4, atol=1e-4 * scale)


# ----------------------------------------------------------------------
# hygiene
# ----------------------------------------------------------------------

def test_new_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the five new wrappers run their plain versions and
    launch nothing; every kernel has its counter."""
    kernels.reset_launch_counts()
    rows, cols = 4, 6
    a = _port_block_args(_block_args(1, rows, cols, d=32))
    fb.conv_pool(a[0], a[4], a[5], a[6], a[7], rows, cols)
    fb.merge_gate(*a, rows, cols)
    b = [T(v) for v in _merge_ln_args(2, (8, 24), (0,), True)]
    mg.merge_ln_gate(*b, (8, 24), (0,), 1e-5, True)
    s = {k: T(v) for k, v in _scan_inputs(3, 1, 40, 8).items()}
    ss.selective_scan_fwd_lanes(s["u"], s["delta"], s["A"], s["B"], s["C"])
    _, tp = _layer_params(4)
    lf.fused_mixer_core(torch.zeros(1, 64, DM), tp, (8, 8), False, 1.0, 1e-5,
                        True, torch.float32, recompute=True)
    counts = kernels.launch_counts()
    assert set(counts) >= {"pass_b_recompute_fwd", "conv_pool_fwd",
                           "merge_gate_fwd", "merge_ln_gate_fwd",
                           "selective_scan_fwd_lanes"}
    assert len(counts) == 11 and not any(counts.values())


def test_new_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises: no wrapper
    falls back to its plain version."""
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fb.conv_pool(m(1, 24, 32), m(32, 4), None, m(32, 4), None, 4, 6)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.merge_gate(m(1, 24, 32), m(1, 24, 32), m(1, 4, 32), m(1, 4, 32),
                      m(32, 4), None, m(32, 4), None, m(32), m(32), None, None,
                      4, 6)
    with pytest.raises(ValueError, match="unsupported device"):
        mg.merge_ln_gate(m(1, 24, 32), m(1, 24, 32), m(1, 24, 32),
                         m(1, 4, 32), m(1, 4, 32), m(32), m(32), None, None,
                         (4, 6), (1,), 1e-5, False)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.selective_scan_fwd_lanes(m(1, 8, 32), m(1, 8, 32), m(32, N),
                                    m(1, 8, N), m(1, 8, N))
    with pytest.raises(ValueError, match="unsupported device"):
        lf.pass_b_recompute(m(1, 8, 8, DM), m(1, 8, DI), m(1, 8, DI),
                            m(DI, DM), None, m(DI, 4), None, m(DI, 4), None,
                            m(DI, DM), None, m(DI), m(DI), m(DI), m(DI),
                            m(DM, DI), None, 1e-5, True, False)


def test_token_stride_takes_column_slices_only():
    """x and z reach K8-K10 as the two column halves of the in-projection's
    output; anything else that is not contiguous is refused."""
    xz = torch.zeros(2, 12, 64)
    assert kernels.token_stride("k", "x", xz[..., :32]) == 64
    assert kernels.token_stride("k", "z", xz[..., 32:]) == 64
    assert kernels.token_stride("k", "x", xz) == 64
    assert kernels.token_stride("k", "x", xz[:, ::2]) == 128
    for bad in (xz[..., ::2], xz.transpose(1, 2), xz[..., 1:33],
                torch.zeros(3, 12, 64)[::2, :, :32]):
        with pytest.raises(ValueError, match="column slice"):
            kernels.token_stride("k", "x", bad)


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    """chip_smoke.py imports torch and the port only (no jax, nothing of
    fastvim_tpu), lists all eleven kernels, and without a CUDA device exits
    non-zero and prints no result."""
    import ast
    import pathlib
    import subprocess
    import sys

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "fastvim_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "fastvim_tpu"}
    for name in kernels.LAUNCHES:
        assert f'("{name}", "' in path.read_text(), name
    if torch.cuda.is_available():
        return  # with a card the script is the card's own check
    proc = subprocess.run([sys.executable, str(path)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
