"""The port's backward passes (fastvim_tpu_torch) against the JAX package,
on the CPU.

On CPU tensors the autograd Functions around the kernels run the plain
backward versions (K2 ``selective_scan_bwd_plain``, K5 ``pass_b_bwd_plain``,
K6 ``pass_a_bwd_plain``); these tests hold them to ``jax.grad`` of the
Pallas kernels in interpret mode (the fused backward kernels), and to
``jax.grad`` of the JAX references. Inputs and weights come from numpy
with a seed and go to both sides, in fp32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu.ops.pallas.selective_scan import selective_scan_pallas
from fastvim_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from fastvim_tpu.train.mixup import cross_entropy as jax_cross_entropy
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fused_mixer_core,
    reference_core,
)
from fastvim_tpu_torch.ops.scan import selective_scan
from fastvim_tpu_torch.train import cross_entropy
from fastvim_tpu_torch.utils import from_jax_params, grads_to_numpy

# K2: fp32 sums over L in another order on the two sides
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# K5/K6: the tolerance of tests/test_layer_fused.py, for its reason: the
# kernels' tile-sequential fp32 reductions against autodiff's reach ~2e-3
# relative on a handful of near-zero elements; a structural error is O(1)
LAYER_TOL = dict(rtol=3e-3, atol=3e-4)
# whole models: gradients pass through two layers of the above
MODEL_TOL = dict(rtol=3e-3, atol=3e-4)
DM, DI, R, N = 64, 128, 4, 16
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


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L,block_l", [(37, 16), (200, 128)])
def test_scan_grads_match_pallas_and_ref(reverse, L, block_l):
    """K2's plain version, through the port's autograd Function: the
    gradients of Σ y·w with respect to u, Δ, A, B, C, D and delta_bias
    against jax.grad of the Pallas scan in interpret mode (its fused
    backward kernel; block_l 16 makes L = 37 ragged) and of the
    sequential JAX reference."""
    a = _scan_inputs(L, 2, L, 128)
    kw = dict(delta_softplus=True, reverse=reverse)
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in SCAN_ARGS}
    y = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                       delta_bias=t["delta_bias"], **kw)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    got = torch.autograd.grad((y * torch.from_numpy(a["w"])).sum(),
                              [t[k] for k in SCAN_ARGS])
    j = [jnp.asarray(a[k]) for k in SCAN_ARGS]
    w = jnp.asarray(a["w"])

    def loss(fn, **extra):
        return lambda u, dl, A, B, C, D, b: jnp.sum(
            fn(u, dl, A, B, C, D=D, delta_bias=b, **kw, **extra) * w)

    pal = jax.jit(jax.grad(
        loss(selective_scan_pallas, block_l=block_l, block_d=128,
             interpret=True), argnums=tuple(range(7))))(*j)
    ref = jax.jit(jax.grad(loss(jax_scan_ref), argnums=tuple(range(7))))(*j)
    for name, g, p, r in zip(SCAN_ARGS, got, pal, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name,
                                   **SCAN_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **SCAN_TOL)


def test_scan_grads_without_d_and_bias():
    """D and delta_bias of None: no gradient slot for them, the rest as
    the sequential reference under autograd gives."""
    a = _scan_inputs(5, 1, 70, 8)
    names = SCAN_ARGS[:5]

    def grads(impl):
        t = {k: torch.from_numpy(a[k]).requires_grad_() for k in names}
        y = selective_scan(*(t[k] for k in names), delta_softplus=False,
                           reverse=True, impl=impl)
        return torch.autograd.grad((y * torch.from_numpy(a["w"])).sum(),
                                   list(t.values()))

    for name, g, r in zip(names, grads("auto"), grads("ref")):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name,
                                   **SCAN_TOL)


def _layer_params(seed, bias=False):
    """The JAX fused layer's parameter tuple from numpy, and the port's
    FusedParams of the same values (torch layouts)."""
    rng = np.random.default_rng(seed)
    u = lambda shape, s=0.2: rng.uniform(-s, s, shape).astype(np.float32)
    p = dict(
        win=u((DM, 2 * DI)), bin_=u((2 * DI,)) if bias else None,
        wcf=u((4, DI)), bcf=u((DI,)), wab=u((4, DI)), bab=u((DI,)),
        xpf=u((DI, R + 2 * N)), dtwf=u((R, DI)), dtbf=u((DI,), 0.5),
        Af=u((DI, N), 1.0), Df=u((DI,)),
        xpb=u((DI, R + 2 * N)), dtwb=u((R, DI)), dtbb=u((DI,), 0.5),
        Ab=u((DI, N), 1.0), Db=u((DI,)),
        lnw=1.0 + u((DI,), 0.1), lnb=u((DI,), 0.1),
        wout=u((DI, DM)), bout=u((DM,)) if bias else None)
    jp = tuple(None if v is None else jnp.asarray(v) for v in p.values())
    t = lambda v: None if v is None else torch.from_numpy(
        np.ascontiguousarray(v))
    tp = FusedParams(
        t(p["win"].T), t(p["bin_"]), t(p["wcf"].T), t(p["bcf"]),
        t(p["wab"].T), t(p["bab"]), t(p["xpf"].T), t(p["dtwf"].T),
        t(p["dtbf"]), t(p["Af"]), t(p["Df"]), t(p["xpb"].T), t(p["dtwb"].T),
        t(p["dtbb"]), t(p["Ab"]), t(p["Db"]), t(p["lnw"]), t(p["lnb"]),
        t(p["wout"].T), t(p["bout"]))
    return jp, tp


# the torch layout of each parameter is the transpose of the JAX one
# where it is a matrix, except A_log
_TRANSPOSED = {"in_w", "conv_f_w", "conv_b_w", "x_proj_f", "dt_w_f",
               "x_proj_b", "dt_w_b", "out_w"}


def _port_layer_grads(fn, x, tp, args, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    leaves = FusedParams(*(None if t is None else t.clone().requires_grad_()
                           for t in tp))
    out = fn(xt, leaves, *args, torch.float32, **kw)
    present = [t for t in leaves if t is not None]
    # a parameter the layer does not read (LayerNorm's, without use_ln)
    # gets no gradient from autograd: zeros, as jax.grad gives
    grads = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(
        torch.autograd.grad((out ** 2).sum(), [xt] + present,
                            allow_unused=True), [xt] + present))
    gx = next(grads).numpy()
    gp = [None if t is None else next(grads).numpy() for t in leaves]
    return out, gx, [g.T if g is not None and name in _TRANSPOSED else g
                     for name, g in zip(FusedParams._fields, gp)]


def _jax_layer_grads(fn, x, jp, args, *extra, tile=None):
    old = os.environ.get("FASTVIM_LF_TILE")
    if tile:
        os.environ["FASTVIM_LF_TILE"] = str(tile)
    try:
        return jax.jit(jax.grad(lambda xx, pp: jnp.sum(
            fn(xx, pp, *args, jnp.float32, "ref", *extra) ** 2),
            argnums=(0, 1)))(jnp.asarray(x), jp)
    finally:
        if tile:
            if old is None:
                del os.environ["FASTVIM_LF_TILE"]
            else:
                os.environ["FASTVIM_LF_TILE"] = old


def _assert_layer_grads(gx, gp, want_x, want_p):
    np.testing.assert_allclose(gx, np.asarray(want_x), **LAYER_TOL)
    for name, g, w in zip(FusedParams._fields, gp, want_p):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                       **LAYER_TOL)


@pytest.mark.parametrize("grid,transposed,tile,bias,use_ln,scaling", [
    ((8, 8), False, None, False, True, 1.0),    # one tile per image
    ((8, 8), True, None, False, True, 1.0),
    ((16, 8), False, 8, False, True, 1.0),      # two tiles: cross-tile halos
    ((8, 16), True, 8, False, True, 1.0),
    ((8, 16), False, None, True, False, 0.25),  # biases, scaling, no LN
])
def test_fused_layer_grads_match_pallas_and_reference(grid, transposed, tile,
                                                      bias, use_ln, scaling):
    """K5, K6 and the Function around the fused layer: the gradients of
    Σ out² with respect to x̂ and all 20 parameters, against the JAX
    fused_mixer_core with bwd_mode="fused" (the Pallas adjoint kernels,
    interpreted) and against jax.grad of _reference_core."""
    x = np.random.default_rng(4).standard_normal(
        (2, grid[0] * grid[1], DM)).astype(np.float32)
    jp, tp = _layer_params(5, bias=bias)
    args = (grid, transposed, scaling, 1e-5, use_ln)
    out, gx, gp = _port_layer_grads(fused_mixer_core, x, tp, args)
    assert type(out.grad_fn).__name__ == "FusedMixerCoreFnBackward"
    fused = _jax_layer_grads(jax_fused_mixer_core, x, jp, args, True, "fused",
                             tile=tile)
    _assert_layer_grads(gx, gp, *fused)
    _assert_layer_grads(gx, gp, *_jax_layer_grads(_reference_core, x, jp,
                                                  args))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bwd_mode", ["fused", "remat"])
def test_fused_layer_grads_unaligned_grid(transposed, bwd_mode):
    """A 6×10 grid, which the JAX kernels cannot take: the port's fused
    and remat backwards against jax.grad of _reference_core; and the
    port's own reference_core agrees too."""
    grid = (6, 10)
    x = np.random.default_rng(6).standard_normal((2, 60, DM)).astype(
        np.float32)
    jp, tp = _layer_params(7, bias=True)
    args = (grid, transposed, 1.0, 1e-5, True)
    want = _jax_layer_grads(_reference_core, x, jp, args)
    out, gx, gp = _port_layer_grads(fused_mixer_core, x, tp, args,
                                    bwd_mode=bwd_mode)
    _assert_layer_grads(gx, gp, *want)
    ref_out, gx, gp = _port_layer_grads(reference_core, x, tp, args)
    _assert_layer_grads(gx, gp, *want)
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().numpy(), rtol=2e-5, atol=2e-5)


SMALL = dict(patch_size=16, depth=2, embed_dim=64, num_classes=10,
             drop_path_rate=0.0)


@pytest.mark.parametrize("name,img_size,bwd", [
    ("fastvim_tiny", 128, "fused"),       # 8×8 grid: fused on both sides
    ("fastvim_tiny", 128, "remat"),
    ("fastvim_tiny", (96, 160), "fused"),  # 6×10: fused in the port only
    ("vim_tiny", 64, "fused"),             # full scans: K1/K2 plain versions
    ("vim_tiny_midclstok", 64, "fused"),
])
def test_model_loss_and_grads_match_jax(name, img_size, bwd):
    """One batch through the small model on both sides from one set of
    weights: the smoothed cross entropy and every parameter's gradient
    against jax.value_and_grad, carried across by from_jax_params."""
    hw = img_size if isinstance(img_size, tuple) else (img_size, img_size)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 2)
    jmodel = jax_create_model(name, img_size=img_size, layer_fused="off",
                              scan_impl="ref", **SMALL)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def jloss(p):
        return jax_cross_entropy(jmodel.apply(p, jnp.asarray(x)),
                                 jnp.asarray(labels), 0.1)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = from_jax_params(want_grads)

    model = create_model(name, img_size=img_size, device="cpu",
                         layer_fused_bwd=bwd, **SMALL)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in from_jax_params(params).items()})
    model.train()
    loss = cross_entropy(model(torch.from_numpy(x)),
                         torch.from_numpy(labels), 0.1)
    loss.backward()
    got = grads_to_numpy(model)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MODEL_TOL)
