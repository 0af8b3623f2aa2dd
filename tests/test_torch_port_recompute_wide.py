"""The fused layer in its recompute form at FastVim-B/L/H widths (d_model
768-1280, d_inner 1536-2560), which K7's wide forms take, on the CPU
against the JAX package.

On CPU tensors ``fused_mixer_core(..., recompute=True)`` runs pass A's
pools-only plain version and K7's plain version
(``pass_b_recompute_plain``), the contract K7's wide forms are held to on
the card. Here they are held to the JAX package: at FastVim-B's widths to
its fused layer in its recompute mode (``FASTVIM_LF_RECOMPUTE=1``, the
Pallas passes in interpret mode), with K7's plain version and with its
mirror of the bf16 kernel's LayerNorm sum order
(``pass_b_recompute_slabs_plain``); at FastVim-H's to its
``_reference_core`` (jitted: interpreting the passes at that width takes
too long). Then a depth-2 ``fastvim_base`` in the recompute mode, whose
layers now fuse, against the JAX model, and the K7 limits against the C
constants of both K7 files. fp32 throughout, tolerances as
tests/test_torch_port_fused_wide.py holds the default mode: 1e-4 of the
largest entry for a layer (fp32 GEMM sums over 768-2560 terms in another
order), 1e-3 for the logits.
"""

import functools
import os
import re
from pathlib import Path
from unittest import mock

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
from fastvim_tpu_torch.utils import to_jax_params
from test_torch_port_fused_wide import _assert_close, _layer_params

CSRC = Path(lf.__file__).parent / "csrc"
K7_FILES = ("layer_fused_recompute.cu", "layer_fused_recompute_wgmma.cu",
            "layer_fused_recompute_tf32.cu")


def _case(dm, di, transposed):
    x = np.random.default_rng(dm + int(transposed)).standard_normal(
        (1, 64, dm)).astype(np.float32)
    jp, tp = _layer_params(di + 7 * int(transposed), dm, di)
    return x, jp, tp, ((8, 8), transposed, 0.5, 1e-5, True)


@functools.lru_cache(maxsize=None)
def _jax_recompute_base(transposed):
    """The JAX fused layer in its recompute mode at FastVim-B's widths:
    computed once for both pass B variants."""
    x, jp, _, args = _case(768, 1536, transposed)
    with mock.patch.dict(os.environ, {"FASTVIM_LF_RECOMPUTE": "1"}):
        return np.asarray(jax_fused_mixer_core(
            jnp.asarray(x), jp, *args, jnp.float32, "ref", True))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("pass_b", ["plain", "slab-order mirror"])
def test_recompute_layer_at_base_width_matches_jax_pallas(transposed, pass_b,
                                                          monkeypatch):
    """d_model 768 / d_inner 1536 on an 8 × 8 grid, batch 1, both
    orientations: the port's recompute layer (pass A's pools only, the
    scans, K7's plain version, or its slab-order mirror) against the JAX
    fused layer in its recompute mode with the Pallas passes interpreted.
    It keeps no conv outputs."""
    if pass_b != "plain":
        monkeypatch.setattr(lf, "pass_b_recompute",
                            lf.pass_b_recompute_slabs_plain)
    x, _, tp, args = _case(768, 1536, transposed)
    with torch.no_grad():
        got, saved = lf.fused_mixer_core(torch.from_numpy(x), tp, *args,
                                         torch.float32, return_saved=True,
                                         recompute=True)
    assert saved[0] is None and saved[1] is None
    _assert_close(got.numpy(), _jax_recompute_base(transposed), 1e-4)


@pytest.mark.parametrize("transposed", [False, True])
def test_recompute_layer_at_huge_width_matches_jax_reference(transposed):
    """d_model 1280 / d_inner 2560 on an 8 × 8 grid against the JAX
    package's unfused reference of the layer."""
    x, jp, tp, args = _case(1280, 2560, transposed)
    with torch.no_grad():
        got = lf.fused_mixer_core(torch.from_numpy(x), tp, *args,
                                  torch.float32, recompute=True).numpy()
    want = jax.jit(_reference_core, static_argnums=(2, 3, 4, 5, 6, 7, 8))(
        jnp.asarray(x), jp, *args, jnp.float32, "ref")
    _assert_close(got, want, 1e-4)


def test_base_model_recompute_fuses_and_matches_jax(monkeypatch):
    """A depth-2 ``fastvim_base`` at 128 px with ``layer_fused=
    "recompute"``, weights made by the port and carried into the JAX
    model: both layers take the fused layer in its recompute form, and the
    logits agree with the JAX model's within 1e-3 of the largest."""
    x = np.random.default_rng(9).standard_normal(
        (2, 128, 128, 3)).astype(np.float32)
    model = create_model("fastvim_base", img_size=128, depth=2, device="cpu",
                         layer_fused="recompute",
                         generator=torch.Generator().manual_seed(4))
    calls, fused_forward = [], lf._fused_forward
    monkeypatch.setattr(lf, "_fused_forward", lambda *a, **k: calls.append(
        k.get("recompute")) or fused_forward(*a, **k))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert calls == [True, True]
    jmodel = jax_create_model("fastvim_base", img_size=128, depth=2,
                              layer_fused="off", scan_impl="ref")
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    _assert_close(got, want, 1e-3)


@pytest.mark.parametrize("name", K7_FILES)
def test_k7_limits_are_the_c_constants(name):
    """RECOMPUTE_MAX_DM / RECOMPUTE_MAX_DI are kRcMaxDm / kRcMaxDi of each
    K7 file, each file checks them, and pass_b_widths_ok(recompute=True)
    takes exactly up to them: FastVim-H's widths, as K3 and K4 do. The
    fp32 kernel's tile and cluster constants (kRcTok, kRcSlice, kRcCols)
    are RC_TF32_TOKENS, RC_TF32_SLICE and RC_TF32_COLS."""
    text = (CSRC / name).read_text()
    limits = tuple(int(re.search(rf"constexpr int {n} = (\d+);",
                                 text).group(1))
                   for n in ("kRcMaxDm", "kRcMaxDi"))
    assert (lf.RECOMPUTE_MAX_DM, lf.RECOMPUTE_MAX_DI) == limits
    assert "dm > kRcMaxDm" in text and "di > kRcMaxDi" in text
    for const, twin in (("kRcTok", lf.RC_TF32_TOKENS),
                        ("kRcSlice", lf.RC_TF32_SLICE),
                        ("kRcCols", lf.RC_TF32_COLS)):
        found = re.search(rf"constexpr int {const} = (\d+);", text)
        assert bool(found) == name.endswith("_tf32.cu"), const
        assert not found or int(found.group(1)) == twin, const
    assert limits == (lf.FWD_MAX_DM, lf.FWD_MAX_DI)
    dm, di = limits
    assert lf.pass_b_widths_ok(dm, di, recompute=True)
    assert not lf.pass_b_widths_ok(dm + 32, di, recompute=True)
    assert not lf.pass_b_widths_ok(dm, di + 32, recompute=True)
