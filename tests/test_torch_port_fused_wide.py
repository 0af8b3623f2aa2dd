"""The fused layer's forward at FastVim-B/L/H widths (d_model 768-1280,
d_inner 1536-2560), which K3 and K4 take, on the CPU against the JAX
package.

On CPU tensors ``fused_mixer_core`` runs the plain versions of pass A and
pass B (``pass_a_plain``, ``pass_b_plain``), the contract K3's streamed
form and K4's wide form are held to on the card. Here they are held to
the JAX package: at FastVim-B's widths to its ``fused_mixer_core`` with
the Pallas passes in interpret mode, at FastVim-H's to its
``_reference_core`` (jitted: interpreting the passes at that width takes
too long). Then a depth-2 ``fastvim_base``, whose layers now fuse by
default, against the JAX model, and the width predicate against the C
limits it must agree with. Inputs and weights come from numpy with a
seed, or from the port's own seeded init, and go to both sides, in fp32.
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
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fused_mixer_core,
)
from fastvim_tpu_torch.utils import to_jax_params

R, N = 8, 16
CSRC = Path(lf.__file__).parent / "csrc"


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


def _layer_case(dm, di, grid, transposed):
    x = np.random.default_rng(dm + grid[0]).standard_normal(
        (1, grid[0] * grid[1], dm)).astype(np.float32)
    jp, tp = _layer_params(di + int(transposed), dm, di)
    args = (grid, transposed, 0.5, 1e-5, True)
    with torch.no_grad():
        got = fused_mixer_core(torch.from_numpy(x), tp, *args,
                               torch.float32).numpy()
    return x, jp, args, got


def _assert_close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("transposed", [False, True])
def test_base_width_layer_matches_jax_pallas(transposed):
    """d_model 768 / d_inner 1536 on an 8 × 8 grid: the port's fused
    layer (its plain passes) against the JAX fused layer with its Pallas
    passes interpreted, within 1e-4 of the largest entry (fp32 GEMM sums
    over 768-1536 terms in another order)."""
    x, jp, args, got = _layer_case(768, 1536, (8, 8), transposed)
    want = jax_fused_mixer_core(jnp.asarray(x), jp, *args, jnp.float32,
                                "ref", True)
    _assert_close(got, want, 1e-4)


@pytest.mark.parametrize("transposed", [False, True])
def test_huge_width_layer_matches_jax_reference(transposed):
    """d_model 1280 / d_inner 2560 on an 8 × 8 grid, against the JAX
    package's unfused reference of the layer, within 1e-4 of the largest
    entry."""
    x, jp, args, got = _layer_case(1280, 2560, (8, 8), transposed)
    want = jax.jit(_reference_core, static_argnums=(2, 3, 4, 5, 6, 7, 8))(
        jnp.asarray(x), jp, *args, jnp.float32, "ref")
    _assert_close(got, want, 1e-4)


def test_base_model_fuses_and_matches_jax(monkeypatch):
    """A depth-2 ``fastvim_base`` at 128 px (an 8 × 8 grid), weights made
    by the port and carried into the JAX model: both layers take the fused
    layer with default fields, and the logits agree with the JAX model's
    (its unfused path) within 1e-3 of the largest."""
    x = np.random.default_rng(5).standard_normal(
        (2, 128, 128, 3)).astype(np.float32)
    model = create_model("fastvim_base", img_size=128, depth=2, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    calls, fused_forward = [], lf._fused_forward
    monkeypatch.setattr(lf, "_fused_forward", lambda *a, **k: calls.append(1)
                        or fused_forward(*a, **k))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert len(calls) == 2
    jmodel = jax_create_model("fastvim_base", img_size=128, depth=2,
                              layer_fused="off", scan_impl="ref")
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    _assert_close(got, want, 1e-3)


def _c_limit(name):
    text = (CSRC / "layer_fused_fwd.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_width_limits_are_the_kernels():
    """The predicates state the C launchers' limits: FWD_MAX_DM and
    FWD_MAX_DI are fvf::kFwdMaxDm and kFwdMaxDi, which both entry points
    check; K7 keeps its own (kRcMaxDm, kRcMaxDi)."""
    assert (lf.FWD_MAX_DM, lf.FWD_MAX_DI) == (_c_limit("kFwdMaxDm"),
                                              _c_limit("kFwdMaxDi"))
    fwd = (CSRC / "layer_fused_fwd.cu").read_text()
    assert fwd.count("dm > fvf::kFwdMaxDm") == 2
    assert fwd.count("di > fvf::kFwdMaxDi") == 2
    rc = (CSRC / "layer_fused_recompute.cu").read_text()
    assert (lf.RECOMPUTE_MAX_DM, lf.RECOMPUTE_MAX_DI) == tuple(
        int(re.search(rf"constexpr int {n} = (\d+);", rc).group(1))
        for n in ("kRcMaxDm", "kRcMaxDi"))
    # lines: the C entry refuses only lines of fewer than 4 tokens, in
    # both dtypes, as fusable does (H, W >= 4): a long fp32 line is walked
    # in segments, with no shared-memory limit of its own
    assert "ln < 4 ||" in fwd and "pass_a_smem" not in fwd
    dm, di = lf.FWD_MAX_DM, lf.FWD_MAX_DI
    assert lf.pass_a_widths_ok(dm, di) and lf.pass_b_widths_ok(dm, di)
    assert not lf.pass_a_widths_ok(dm + 32, di)
    assert not lf.pass_a_widths_ok(dm, di + 64)
    assert not lf.pass_b_widths_ok(dm + 32, di)
    assert not lf.pass_b_widths_ok(dm, di + 32)


@pytest.mark.parametrize("grid", [(14, 14), (32, 32), (128, 128)])
@pytest.mark.parametrize("dm", [768, 1024, 1280])  # FastVim-B, -L, -H
def test_registry_widths_fuse(dm, grid):
    """FastVim-B/L/H fuse on 224 px, 448 px (patch 14) and 2048 px grids
    in both orientations, by default and in the recompute mode (K7's wide
    forms), and train through the fused adjoint (K5, K6)."""
    di = 2 * dm
    for transposed in (False, True):
        pool = (0,) if transposed else (1,)
        assert lf.fusable(grid, pool, transposed, dm, di, 4, "mean")
        assert lf.fusable(grid, pool, transposed, dm, di, 4, "mean",
                          recompute=True)
    assert lf.fused_bwd_route(dm, di, "fused") == "fused"


@pytest.mark.parametrize("dm,dtype,line,grad,want", [
    (1280, torch.float32, 14, False, "off"),    # FastVim-H, 224 px
    (1280, torch.float32, 16, False, "off"),    # ... patch 14
    (1280, torch.float32, 17, False, "fused"),  # just past FWD_ROUTE_LINE
    (1280, torch.float32, 32, False, "fused"),  # FastVim-H, 448 px
    (1280, torch.float32, 14, True, "fused"),   # training: remat backward
    (1280, torch.bfloat16, 14, False, "fused"),
    (1024, torch.float32, 14, False, "off"),    # FastVim-L
    (1024, torch.float32, 14, True, "fused"),
    (768, torch.float32, 14, False, "fused"),   # FastVim-B: fused wins
    (192, torch.float32, 14, False, "fused"),   # FastVim-T
])
def test_auto_fwd_mode(dm, dtype, line, grad, want):
    """``default_fwd_mode``: the fused forward everywhere but fp32 past
    FastVim-B's widths on lines of up to 16 tokens with no gradient, where
    it measured slower than the unfused path."""
    assert lf.default_fwd_mode(dm, dtype, line, grad) == want


@pytest.fixture(scope="module")
def huge_mixer():
    from fastvim_tpu_torch.models.mixer import MambaMixer

    mixer = MambaMixer(1280, d_state=4)
    mixer.reset_parameters(torch.Generator().manual_seed(0))
    return mixer


@pytest.mark.parametrize("grid,transposed,grad,fused", [
    ((14, 14), False, False, False),
    ((14, 14), True, False, False),
    ((14, 14), False, True, True),
    ((8, 20), False, False, True),    # 20-token rows
    ((8, 20), True, False, False),    # 8-token columns
])
def test_auto_fwd_mode_dispatch(monkeypatch, huge_mixer, grid, transposed,
                                grad, fused):
    """An fp32 FastVim-H mixer with its default fields resolves the route
    in each forward from its line length and from whether it is
    differentiated; ``layer_fused="recompute"`` stays fused. Both paths
    compute the same function."""
    from fastvim_tpu_torch.models import mixer as mixer_mod

    calls = []

    def counted(*a, _f=mixer_mod.fused_mixer_core, **k):
        calls.append(1)
        return _f(*a, **k)

    monkeypatch.setattr(mixer_mod, "fused_mixer_core", counted)
    mixer = huge_mixer
    mixer.layer_fused = "auto"
    mixer.requires_grad_(grad)
    x = torch.randn(1, grid[0] * grid[1], 1280,
                    generator=torch.Generator().manual_seed(1))
    pool = (0,) if transposed else (1,)
    out = mixer(x, grid, pool, transposed)
    assert len(calls) == int(fused)
    calls.clear()
    mixer.layer_fused = "off"
    with torch.no_grad():
        want = mixer(x, grid, pool, transposed)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    mixer.layer_fused = "recompute"
    with torch.no_grad():
        mixer(x, grid, pool, transposed)
    assert calls == [1]
