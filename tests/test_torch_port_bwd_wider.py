"""The fused layer's backward at FastVim-B/L/H widths (d_model 768-1280,
d_inner 1536-2560), which K5 and K6 take in their wide forms, on the CPU
against the JAX package.

On CPU tensors ``FusedMixerCoreFn`` runs the plain backward versions
(``pass_b_bwd_plain``, ``pass_a_bwd_plain``), the contract the wide forms
are held to on the card. Here they are held to ``jax.grad`` of the JAX
package's jitted ``_reference_core`` (the layer's unfused math, which its
Pallas adjoint kernels compute; interpreting those at these widths takes
over 5 s a case) on an 8 × 8 grid in both orientations; then a depth-2
``fastvim_base`` at 128 px built with ``layer_fused_bwd="fused"``, whose
layers train through ``FusedMixerCoreFn``, against the JAX model; the
backward "auto" picks at each registry width and dtype; and the width
limits against the C constants the launchers check. Inputs and weights
come from numpy with a seed, or from the port's own seeded init, and go
to both sides, in fp32.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.train.mixup import cross_entropy as jax_cross_entropy
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fused_mixer_core,
)
from fastvim_tpu_torch.train import cross_entropy
from fastvim_tpu_torch.utils import from_jax_params, grads_to_numpy
from fastvim_tpu_torch.utils import to_jax_params

R, N = 8, 16
CSRC = Path(lf.__file__).parent / "csrc"
# the torch layout of each parameter is the transpose of the JAX one where
# it is a matrix, except A_log
_TRANSPOSED = {"in_w", "conv_f_w", "conv_b_w", "x_proj_f", "dt_w_f",
               "x_proj_b", "dt_w_b", "out_w"}
TOL = 1e-4  # of each tensor's largest entry


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


def _assert_close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), name


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dm,di", [(768, 1536), (1280, 2560)])
def test_wide_layer_grads_match_jax(dm, di, transposed):
    """FastVim-B's and -H's widths on an 8 × 8 grid, batch 1: the gradients
    of Σ out² with respect to x̂ and all 20 parameters through
    ``FusedMixerCoreFn``, against jax.grad of the jitted
    ``_reference_core``, within 1e-4 of each tensor's largest entry (fp32
    sums over up to 2560 channels and 64 tokens in another order)."""
    grid = (8, 8)
    x = np.random.default_rng(dm + int(transposed)).standard_normal(
        (1, 64, dm)).astype(np.float32)
    jp, tp = _layer_params(di + int(transposed), dm, di)
    args = (grid, transposed, 0.5, 1e-5, True)
    assert lf.fused_bwd_route(dm, di, "fused") == "fused"
    xt = torch.from_numpy(x).requires_grad_()
    leaves = FusedParams(*(t.clone().requires_grad_() for t in tp))
    out = fused_mixer_core(xt, leaves, *args, torch.float32)
    assert type(out.grad_fn).__name__ == "FusedMixerCoreFnBackward"
    gx, *gp = torch.autograd.grad((out ** 2).sum(), [xt, *leaves])
    want_x, want_p = jax.jit(jax.grad(
        lambda xx, pp: jnp.sum(_reference_core(
            xx, pp, *args, jnp.float32, "ref") ** 2), argnums=(0, 1)))(
        jnp.asarray(x), jp)
    _assert_close(gx.numpy(), want_x, "x_hat")
    for name, g, w in zip(FusedParams._fields, gp, want_p):
        g = g.numpy()
        _assert_close(g.T if name in _TRANSPOSED else g, w, name)


def test_base_model_trains_fused_and_matches_jax(monkeypatch):
    """A depth-2 ``fastvim_base`` at 128 px (an 8 × 8 grid), weights made
    by the port and carried into the JAX model: with
    ``layer_fused_bwd="fused"`` (fp32's default at these widths too,
    ``test_auto_bwd_mode``) both layers take ``FusedMixerCoreFn`` (the K5
    and K6 adjoint), and the
    smoothed cross entropy and every parameter's gradient agree with
    jax.value_and_grad of the JAX model (its unfused path): the loss to
    1e-5 relative, the gradients within 1e-4 of each tensor's largest
    entry."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 2)
    model = create_model("fastvim_base", img_size=128, depth=2, device="cpu",
                         drop_path_rate=0.0, layer_fused_bwd="fused",
                         generator=torch.Generator().manual_seed(9))
    mixer = model.layers[0].mixer
    assert (mixer.d_model, mixer.d_inner, mixer.layer_fused_bwd) == (
        768, 1536, "fused")
    calls = {"FusedMixerCoreFn": 0, "FusedMixerCoreRematFn": 0}
    for cls in (lf.FusedMixerCoreFn, lf.FusedMixerCoreRematFn):
        def counted(*a, _apply=cls.apply, _name=cls.__name__):
            calls[_name] += 1
            return _apply(*a)
        monkeypatch.setattr(cls, "apply", counted)
    model.train()
    loss = cross_entropy(model(torch.from_numpy(x)),
                         torch.from_numpy(labels), 0.1)
    loss.backward()
    assert calls == {"FusedMixerCoreFn": 2, "FusedMixerCoreRematFn": 0}
    got = grads_to_numpy(model)

    jmodel = jax_create_model("fastvim_base", img_size=128, depth=2,
                              drop_path_rate=0.0, layer_fused="off",
                              scan_impl="ref")
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}))

    def jloss(v):
        return jax_cross_entropy(jmodel.apply(v, jnp.asarray(x)),
                                 jnp.asarray(labels), 0.1)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(variables)
    want = from_jax_params(want_grads)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_close(got[k], want[k], k)


@pytest.mark.parametrize("dm,dtype,line,want", [
    (192, torch.float32, 14, "fused"),    # FastVim-T, 224 px
    (384, torch.float32, 14, "fused"),    # FastVim-S
    (768, torch.float32, 14, "fused"),    # FastVim-B, 224 px
    (1024, torch.float32, 14, "fused"),   # FastVim-L
    (1280, torch.float32, 16, "remat"),   # FastVim-H, 224 px (patch 14)
    (1280, torch.float32, 14, "remat"),   # ... patch 16
    (768, torch.float32, 17, "fused"),    # lines past BWD_ROUTE_LINE
    (1280, torch.float32, 17, "fused"),
    (768, torch.float32, 32, "fused"),    # FastVim-B, 512 px
    (1280, torch.float32, 32, "fused"),   # FastVim-H, 448 px
    (192, torch.bfloat16, 14, "fused"),
    (768, torch.bfloat16, 14, "fused"),
    (1280, torch.bfloat16, 16, "fused"),
])
def test_auto_bwd_mode(dm, dtype, line, want):
    """``layer_fused_bwd="auto"`` (the default) takes the backward
    ``default_bwd_mode`` picks from the widths, the dtype and the line
    length: the fused adjoint, but for fp32 FastVim-H (d_model past
    ``BWD_ROUTE_DM``) on lines of up to ``BWD_ROUTE_LINE`` tokens, where
    it does not fit B = 128 and the remat backward runs."""
    assert (lf.BWD_ROUTE_DM, lf.BWD_ROUTE_LINE) == (1024, 16)
    assert lf.default_bwd_mode(dm, dtype, line) == want


@pytest.mark.parametrize("grid,transposed,want", [
    ((8, 8), False, "FusedMixerCoreRematFn"),
    ((8, 20), False, "FusedMixerCoreFn"),     # 20-token rows
    ((8, 20), True, "FusedMixerCoreRematFn"),  # 8-token columns
    ((20, 8), True, "FusedMixerCoreFn"),
])
def test_auto_bwd_mode_dispatch(monkeypatch, grid, transposed, want):
    """An fp32 FastVim-H mixer with its default field resolves "auto" in
    each forward from the length of its lines (rows, or columns when
    transposed) and takes that backward; "fused" and "remat" stay as
    given, and other values raise."""
    from fastvim_tpu_torch.models.mixer import MambaMixer

    calls = []
    for cls in (lf.FusedMixerCoreFn, lf.FusedMixerCoreRematFn):
        def counted(*a, _apply=cls.apply, _name=cls.__name__):
            calls.append(_name)
            return _apply(*a)
        monkeypatch.setattr(cls, "apply", counted)
    mixer = MambaMixer(1280)
    mixer.reset_parameters(torch.Generator().manual_seed(0))
    assert mixer.layer_fused_bwd == "auto"
    x = torch.zeros(1, grid[0] * grid[1], 1280, requires_grad=True)
    pool = (0,) if transposed else (1,)
    for mode, name in (("auto", want), ("fused", "FusedMixerCoreFn"),
                       ("remat", "FusedMixerCoreRematFn")):
        mixer.layer_fused_bwd = mode
        mixer(x, grid, pool, transposed)
        assert calls.pop() == name, mode
    with pytest.raises(ValueError, match="auto|fused|remat"):
        MambaMixer(1280, layer_fused_bwd="on")


def _c_limit(name, file="layer_fused_bwd.cuh"):
    text = (CSRC / file).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_bwd_width_limits_are_the_kernels():
    """BWD_MAX_DM and BWD_MAX_DI are fvb::kBwdMaxDm and kBwdMaxDi, which
    both C entry points check, BWD_NARROW_DM / _DI, past which the bf16
    wide forms run, are kNarrowDm / kNarrowDi, and BWD_RUN_B / _A, the
    tokens a block of the fp32 K5's middle and of the fp32 K6 owns, are
    kMRun and kAM - 2·kPad of layer_fused_bwd_tf32.cu; every registry
    width (d_inner = 2·d_model) passes the predicate and takes the fused
    route, and a width just past either limit does neither."""
    assert (lf.BWD_MAX_DM, lf.BWD_MAX_DI) == (_c_limit("kBwdMaxDm"),
                                              _c_limit("kBwdMaxDi"))
    assert (lf.BWD_NARROW_DM, lf.BWD_NARROW_DI) == (_c_limit("kNarrowDm"),
                                                    _c_limit("kNarrowDi"))
    tf32 = "layer_fused_bwd_tf32.cu"
    assert lf.BWD_RUN_B == _c_limit("kMRun", tf32)
    assert lf.BWD_RUN_A == _c_limit("kAM", tf32) - 2 * _c_limit("kPad", tf32)
    bwd = (CSRC / "layer_fused_bwd.cu").read_text()
    assert bwd.count("dm > fvb::kBwdMaxDm") == 2
    assert bwd.count("di > fvb::kBwdMaxDi") == 2
    for dm in (192, 384, 768, 1024, 1280):
        assert lf.pass_bwd_widths_ok(dm, 2 * dm)
        assert lf.fused_bwd_route(dm, 2 * dm, "fused") == "fused"
    dm, di = lf.BWD_MAX_DM, lf.BWD_MAX_DI
    for past in ((dm + 64, di), (dm, di + 64), (dm + 64, di + 64)):
        assert not lf.pass_bwd_widths_ok(*past), past
        assert lf.fused_bwd_route(*past, "fused") == "remat", past
