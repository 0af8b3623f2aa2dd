"""The fused layer's backward at the widths K5 and K6 take since their
redesign (several 128-channel slabs, d_inner > 384), on the CPU against
the JAX package.

On CPU tensors ``FusedMixerCoreFn`` runs the plain backward versions
(``pass_b_bwd_plain``, ``pass_a_bwd_plain``), which are the contract the
CUDA kernels are held to on the card. Here they are held to the JAX
package: on an 8 × 8 grid to ``fused_mixer_core`` with its fused backward
(the Pallas adjoint kernels in interpret mode), on a 6 × 10 grid, which
those kernels do not take, to ``jax.grad`` of ``_reference_core``. Then a
``fastvim``-shaped model of d_inner 512 takes a supervised train step
with its default fields, and the width predicate's truth table is spelled
out, with the backward route of every width ``fusable`` accepts: a width
the adjoint kernels refuse takes the remat backward, and a d_model 96
model (d_inner 192, which the JAX package runs unfused) trains through it
with default fields. Inputs and weights come from numpy with a seed and go to both sides,
in fp32. The JAX side of each model (its init, jitted, its loss and
gradients and its train step) is computed once for the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.ops.pallas.layer_fused import fusable as jax_fusable
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.mixup import cross_entropy as jax_cross_entropy
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fused_mixer_core,
)
from fastvim_tpu_torch.train import (
    TrainState,
    cosine_with_warmup,
    cross_entropy,
    make_optimizer,
    make_supervised_train_step,
)
from fastvim_tpu_torch.utils import from_jax_params, grads_to_numpy

R, N = 8, 16
# the torch layout of each parameter is the transpose of the JAX one where
# it is a matrix, except A_log
_TRANSPOSED = {"in_w", "conv_f_w", "conv_b_w", "x_proj_f", "dt_w_f",
               "x_proj_b", "dt_w_b", "out_w"}
# gradients summed over every token or line (all 20 parameters); the
# gradient of x̂ is the only per-token value
SUMMED_TOL = 1e-4  # of the tensor's largest entry


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


def _port_grads(x, tp, args):
    xt = torch.from_numpy(x).requires_grad_()
    leaves = FusedParams(*(t.clone().requires_grad_() for t in tp))
    out = fused_mixer_core(xt, leaves, *args, torch.float32)
    assert type(out.grad_fn).__name__ == "FusedMixerCoreFnBackward"
    gx, *gp = torch.autograd.grad((out ** 2).sum(), [xt, *leaves])
    return gx.numpy(), [g.numpy().T if name in _TRANSPOSED else g.numpy()
                        for name, g in zip(FusedParams._fields, gp)]


def _jax_grads(fn, x, jp, args, *extra):
    return jax.jit(jax.grad(lambda xx, pp: jnp.sum(
        fn(xx, pp, *args, jnp.float32, "ref", *extra) ** 2),
        argnums=(0, 1)))(jnp.asarray(x), jp)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("grid", [(8, 8), (6, 10)])
@pytest.mark.parametrize("dm,di", [(128, 256), (128, 512)])
def test_wide_layer_grads_match_jax(dm, di, grid, transposed):
    """The gradients of Σ out² with respect to x̂ and all 20 parameters at
    a two-slab width and at d_inner > 384. x̂'s gradient to rtol = atol =
    1e-5 of its largest entry (fp32 GEMM sums over up to 512 channels in
    another order); the parameters', summed over every token, to 1e-4 of
    each tensor's largest entry."""
    x = np.random.default_rng(di + grid[0]).standard_normal(
        (2, grid[0] * grid[1], dm)).astype(np.float32)
    jp, tp = _layer_params(di + grid[1], dm, di)
    args = (grid, transposed, 0.5, 1e-5, True)
    gx, gp = _port_grads(x, tp, args)
    pool_axes = (0,) if transposed else (1,)
    if jax_fusable(grid, pool_axes, transposed, di, 4, "mean"):
        assert grid == (8, 8)
        want_x, want_p = _jax_grads(jax_fused_mixer_core, x, jp, args, True,
                                    "fused")
    else:
        assert grid == (6, 10)
        want_x, want_p = _jax_grads(_reference_core, x, jp, args)
    want_x = np.asarray(want_x)
    scale = np.abs(want_x).max()
    np.testing.assert_allclose(gx, want_x, rtol=1e-5, atol=1e-5 * scale)
    for name, g, w in zip(FusedParams._fields, gp, want_p):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= SUMMED_TOL * np.abs(w).max(), name


WIDE = dict(patch_size=16, depth=1, embed_dim=256, num_classes=10,
            drop_path_rate=0.0)  # d_inner 512


def _jax_side(jmodel, x, labels, key):
    """A JAX model's init (jitted: an eager flax init takes seconds), its
    smoothed cross entropy and gradients, and the loss and parameters after
    one make_supervised_train_step step."""
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(key), jnp.asarray(x))

    def jloss(p):
        return jax_cross_entropy(jmodel.apply(p, jnp.asarray(x)),
                                 jnp.asarray(labels), 0.1)

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    jtx = joptim.make_optimizer(
        jsched.cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4), weight_decay=0.05,
        params=params)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  jtx, ema=False)
    jstep = jax_make_train_step(jmodel, 10, label_smoothing=0.1,
                                ema_decay=None)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(x),
                                "label": jnp.asarray(labels)},
                       jax.random.PRNGKey(0))
    return (from_jax_params(params), float(loss), from_jax_params(grads),
            float(jm["train_loss"]), from_jax_params(jstate.params))


@functools.lru_cache(maxsize=2)
def _wide_jax(img_size):
    """The JAX side of the d_inner 512 model at one image size, once for
    both of its tests: inputs, then :func:`_jax_side`'s weights, loss,
    gradients, step loss and stepped parameters."""
    hw = img_size if isinstance(img_size, tuple) else (img_size, img_size)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 2)
    jmodel = jax_create_model("fastvim_tiny", img_size=img_size,
                              layer_fused="off", scan_impl="ref", **WIDE)
    return (x, labels) + _jax_side(jmodel, x, labels, 2)


def _wide_model(img_size, params):
    model = create_model("fastvim_tiny", img_size=img_size, device="cpu",
                         **WIDE)  # default fields: fused layer, fused backward
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    assert model.layers[0].mixer.d_inner == 512
    return model


@pytest.mark.parametrize("img_size", [128, (96, 160)])
def test_wide_model_loss_and_grads_match_jax(img_size):
    """A model of d_inner 512 with default fields: the smoothed cross
    entropy and every parameter's gradient against jax.value_and_grad."""
    x, labels, params, want_loss, want, _, _ = _wide_jax(img_size)
    model = _wide_model(img_size, params)
    model.train()
    loss = cross_entropy(model(torch.from_numpy(x)),
                         torch.from_numpy(labels), 0.1)
    loss.backward()
    got = grads_to_numpy(model)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            SUMMED_TOL * np.abs(want[k]).max(), k


@pytest.mark.parametrize("img_size", [128, (96, 160)])
def test_wide_model_train_step_matches_jax(img_size):
    """One make_supervised_train_step step of that model on the CPU, from
    the same weights: the loss and every updated parameter agree with the
    JAX trainer's (the same AdamW arithmetic in another order)."""
    x, labels, params, _, _, want_step_loss, want = _wide_jax(img_size)
    model = _wide_model(img_size, params)
    tx = make_optimizer(cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4),
                        weight_decay=0.05, params=model)
    state = TrainState.create(model, tx)
    step = make_supervised_train_step(model, 10, label_smoothing=0.1,
                                      ema_decay=None)
    state, m = step(state, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(labels)})
    assert state.step == 1
    np.testing.assert_allclose(m["train_loss"].item(), want_step_loss,
                               rtol=1e-5)
    before = params
    moved = 0
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
        moved += bool(np.abs(want[k] - np.array(before[k])).max() > 0)
    assert moved == len(want)


@pytest.mark.parametrize("dm,di,ok", [
    (192, 384, True),    # FastVim-T
    (384, 768, True),    # FastVim-S: the widest narrow form
    (64, 64, True),      # the narrowest: half a slab
    (128, 512, True),
    (320, 640, True),
    (384, 832, True),    # d_inner beyond 768: K5's wide form
    (448, 768, True),    # d_model beyond 384: both wide forms
    (768, 1536, True),   # FastVim-B
    (1024, 2048, True),  # FastVim-L
    (1280, 2560, True),  # FastVim-H: the widest on both counts
    (1344, 2560, False),  # d_model beyond 1280
    (1280, 2624, False),  # d_inner beyond 2560
    (96, 384, False),    # d_model not a multiple of 64
    (192, 416, False),   # d_inner not a multiple of 64
    (256, 128, False),   # d_model > d_inner
    (0, 64, False),
])
def test_bwd_width_predicate(dm, di, ok):
    """What K5 and K6 take; K3 and K4 take every such width too, so a
    layer whose backward fuses also fuses forward. K3 and K4 take more:
    every case here but a d_inner that is not a multiple of 64, a width
    past 1280 / 2560 (and the empty one) fuses forward, and those K5 and
    K6 refuse take the remat backward."""
    assert lf.pass_bwd_widths_ok(dm, di) is ok
    fwd = lf.pass_a_widths_ok(dm, di) and lf.pass_b_widths_ok(dm, di)
    assert fwd is (0 < dm <= 1280 and di % 64 == 0 and di <= 2560)
    assert lf.fusable((8, 8), (1,), False, dm, di, 4, "mean") is fwd
    if ok:
        assert fwd
    elif fwd:
        assert lf.fused_bwd_route(dm, di, "fused") == "remat"


@pytest.mark.parametrize("dm,di,fused", [
    (96, 192, False),    # d_model an odd multiple of 32
    (160, 320, False),
    (192, 384, True),    # FastVim-T
    (256, 512, True),
    (352, 704, False),
    (384, 768, True),    # FastVim-S
    (224, 448, False),
    (320, 256, False),   # d_model > d_inner (expand < 2)
    (1280, 2560, True),  # FastVim-H
])
def test_fused_bwd_route(dm, di, fused):
    """Every width fusable accepts gets a backward that takes it: the
    adjoint kernels where pass_bwd_widths_ok holds and the field asks for
    them, the remat backward otherwise, chosen by width before the
    forward runs and taken by fused_mixer_core on the CPU as on the
    card."""
    assert lf.fusable((4, 4), (1,), False, dm, di, 4, "mean")
    assert lf.pass_bwd_widths_ok(dm, di) is fused
    assert lf.fused_bwd_route(dm, di, "fused") == ("fused" if fused
                                                   else "remat")
    assert lf.fused_bwd_route(dm, di, "remat") == "remat"
    with pytest.raises(ValueError, match="bwd_mode"):
        lf.fused_bwd_route(dm, di, "auto")
    _, tp = _layer_params(dm, dm, di)
    x = torch.zeros(1, 16, dm, requires_grad=True)
    for mode in ("fused", "remat"):
        out = fused_mixer_core(x, tp, (4, 4), False, 1.0, 1e-5, True,
                               torch.float32, bwd_mode=mode)
        want = "FusedMixerCoreFn" if lf.fused_bwd_route(
            dm, di, mode) == "fused" else "FusedMixerCoreRematFn"
        assert type(out.grad_fn).__name__ == want + "Backward"


NARROW = dict(img_size=32, patch_size=4, depth=2, embed_dim=96,
              num_classes=10, drop_path_rate=0.0)  # d_inner 192


@functools.lru_cache(maxsize=1)
def _narrow_jax():
    """The JAX side of the d_model 96 model, once for every case: inputs,
    weights in the port's names, the loss and gradients, and the loss and
    parameters after one train step."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 2)
    jmodel = jax_create_model("fastvim_tiny", layer_fused="off",
                              scan_impl="ref", **NARROW)
    return (x, labels) + _jax_side(jmodel, x, labels, 4)


@pytest.mark.parametrize("bwd", ["fused", "remat"])
def test_narrow_model_trains_through_remat(monkeypatch, bwd):
    """A d_model 96 model fuses forward but not backward: with either
    value of layer_fused_bwd both layers take
    FusedMixerCoreRematFn. Its loss and gradients, and one
    make_supervised_train_step step, against the JAX package, which runs
    those layers unfused (d_inner 192 fails its d_inner % 128): values to
    rtol = atol = 1e-5, gradients (sums over tokens) to 1e-4 of each
    tensor's largest entry."""
    x, labels, params, want_loss, want, want_step_loss, new = _narrow_jax()
    weights = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    models = []
    for _ in range(2):
        m = create_model("fastvim_tiny", device="cpu", layer_fused_bwd=bwd,
                         **NARROW)
        m.load_state_dict(weights)
        models.append(m)
    mixer = models[0].layers[0].mixer
    assert (mixer.d_model, mixer.d_inner) == (96, 192)
    assert lf.fused_bwd_route(96, 192, mixer.layer_fused_bwd) == "remat"
    calls = {"FusedMixerCoreFn": 0, "FusedMixerCoreRematFn": 0}
    for cls in (lf.FusedMixerCoreFn, lf.FusedMixerCoreRematFn):
        def counted(*a, _apply=cls.apply, _name=cls.__name__):
            calls[_name] += 1
            return _apply(*a)
        monkeypatch.setattr(cls, "apply", counted)

    model = models[0]
    model.train()
    loss = cross_entropy(model(torch.from_numpy(x)),
                         torch.from_numpy(labels), 0.1)
    loss.backward()
    assert calls == {"FusedMixerCoreFn": 0, "FusedMixerCoreRematFn": 2}
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=1e-5)
    got = grads_to_numpy(model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            SUMMED_TOL * np.abs(want[k]).max(), k

    model = models[1]
    tx = make_optimizer(cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4),
                        weight_decay=0.05, params=model)
    state = TrainState.create(model, tx)
    step = make_supervised_train_step(model, 10, label_smoothing=0.1,
                                      ema_decay=None)
    state, m = step(state, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(labels)})
    assert calls["FusedMixerCoreRematFn"] == 4
    np.testing.assert_allclose(m["train_loss"].item(), want_step_loss,
                               rtol=1e-5, atol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), new[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
