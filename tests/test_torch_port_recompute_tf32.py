"""The fp32 K7 (csrc/layer_fused_recompute_tf32.cu: 3xTF32 products on the
tensor cores, thread-block clusters that split d_inner), on the CPU.

The kernel cannot run here, so its plain model does:
``pass_b_recompute_tf32_plain`` forms xin, z and out through
``tf32x3_steps_plain`` (each operand split into TF32 hi and lo, each
8-deep k-step's lo·hi + hi·lo + hi·hi summed in a fresh tile and added in
fp32), takes each token's LayerNorm sums as a warp of the kernel does over
each CTA's slice of d_inner and adds the slices in rank order. It is held
to:
- the JAX package's fused layer in its recompute mode
  (``FASTVIM_LF_RECOMPUTE=1``, its Pallas passes interpreted), put into
  the port's recompute layer for K7's plain version, within 1e-4 of the
  largest entry, on the grids the JAX passes take (H, W multiples of 8:
  8 × 8 and 8 × 16 / 16 × 8, both orientations); on 6 × 8 and 8 × 6,
  which they do not take, against its ``_reference_core``;
- an fp64 evaluation of ``pass_b_recompute_plain`` within FP32_TOL
  (|got − want| <= tol + tol·|want|, tol = 1e-4, as chip_smoke.py and the
  card tests hold the kernel to its plain version), with every split of
  d_inner over 1-4 ranks, and one TF32 product missing it;
- the cluster's ranks and shares at each registry width.
Inputs and weights come from numpy with a seed and go to both sides.
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

from fastvim_tpu.ops.pallas.layer_fused import _reference_core
from fastvim_tpu.ops.pallas.layer_fused import (
    fused_mixer_core as jax_fused_mixer_core,
)
from fastvim_tpu.ops.pallas.layer_fused import fusable as jax_fusable
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from test_torch_port_fused_wide import _assert_close, _layer_params

FP32_TOL = 1e-4
CSRC = Path(lf.__file__).parent / "csrc"
TF32_FILE = CSRC / "layer_fused_recompute_tf32.cu"


def _case(dm, di, grid, transposed, batch=2):
    x = np.random.default_rng(dm + grid[0] + int(transposed)).standard_normal(
        (batch, grid[0] * grid[1], dm)).astype(np.float32)
    jp, tp = _layer_params(di + grid[1] + 7 * int(transposed), dm, di)
    return x, jp, tp, (grid, transposed, 0.5, 1e-5, True)


@functools.lru_cache(maxsize=None)
def _jax_recompute(dm, di, grid, transposed):
    """The JAX fused layer in its recompute mode (Pallas interpreted) where
    the JAX passes take the grid, else its reference core."""
    x, jp, _, args = _case(dm, di, grid, transposed)
    pool_axes = (0,) if transposed else (1,)
    if jax_fusable(grid, pool_axes, transposed, di, 4, "mean"):
        with mock.patch.dict(os.environ, {"FASTVIM_LF_RECOMPUTE": "1"}):
            return np.asarray(jax_fused_mixer_core(
                jnp.asarray(x), jp, *args, jnp.float32, "ref", True))
    return np.asarray(jax.jit(_reference_core, static_argnums=tuple(
        range(2, 9)))(jnp.asarray(x), jp, *args, jnp.float32, "ref"))


@pytest.mark.parametrize("dm,di,grid,transposed", [
    (64, 128, (8, 8), False), (64, 128, (8, 8), True),
    (128, 256, (8, 16), False), (128, 256, (16, 8), True),
    (64, 128, (6, 8), False), (96, 256, (8, 6), True),
    (128, 256, (6, 8), True), (64, 128, (8, 6), False),
])
def test_tf32_model_layer_matches_jax(monkeypatch, dm, di, grid, transposed):
    """The port's recompute layer with K7's plain model in the kernel's
    place (pass A's pools, the scans, then the model) against the JAX
    package's recompute layer, within 1e-4 of the largest entry."""
    monkeypatch.setattr(lf, "pass_b_recompute",
                        lf.pass_b_recompute_tf32_plain)
    x, _, tp, args = _case(dm, di, grid, transposed)
    with torch.no_grad():
        got, saved = lf.fused_mixer_core(torch.from_numpy(x), tp, *args,
                                         torch.float32, return_saved=True,
                                         recompute=True)
    assert saved[0] is None and saved[1] is None
    _assert_close(got.numpy(), _jax_recompute(dm, di, grid, transposed), 1e-4)


def _args(seed, B, H, W, dm, di, transposed, bias=True, use_ln=True,
          dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dtype)
    P = W if transposed else H
    cb = (lambda k: r(k, sc=0.3)) if bias else (lambda k: None)
    return (r(B, H, W, dm), r(B, P, di), r(B, P, di),
            r(di, dm, sc=dm ** -0.5), cb(di), r(di, 4, sc=0.5), cb(di),
            r(di, 4, sc=0.5), cb(di), r(di, dm, sc=dm ** -0.5), cb(di),
            r(di), r(di), 1 + r(di, sc=0.1), r(di, sc=0.1),
            r(dm, di, sc=di ** -0.5), cb(dm), 1e-5, use_ln, transposed)


def _fp64_plain(args):
    """``pass_b_recompute_plain`` evaluated in fp64: the inputs in fp64 and
    its casts to fp32 (``Tensor.float``) kept in fp64."""
    wide = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        out = lf.pass_b_recompute_plain(*wide)
    assert out.dtype == torch.float64
    return out


def _within(got, want, tol=FP32_TOL):
    return bool(((got.double() - want).abs() <= tol + tol * want.abs()).all())


@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln,ranks", [
    ((6, 8), False, 2, 64, 128, True, True, None),   # one rank
    ((8, 6), True, 2, 64, 128, False, True, 2),     # slices of 64
    ((6, 8), True, 1, 96, 192, True, False, 3),     # 64 each, no LN
    ((8, 6), False, 2, 128, 256, True, True, 4),    # 64 each
    ((4, 5), True, 3, 64, 160, True, True, 3),      # 32, 64, 64; 4-token lines
    ((5, 14), False, 1, 128, 128, False, True, 4),  # 32 each; 14-token lines
])
def test_tf32_model_keeps_the_fp32_contract(grid, transposed, batch, dm, di,
                                            bias, use_ln, ranks):
    """The model against the plain version evaluated in fp64, with d_inner
    split over 1-4 ranks (forced where the widths would take one): the
    split changes the order of the LayerNorm sums only."""
    a = _args(di + grid[0], batch, *grid, dm, di, transposed, bias, use_ln)
    want = _fp64_plain(a)
    got = lf.pass_b_recompute_tf32_plain(*a, ranks=ranks)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _within(got, want)


def test_one_tf32_product_misses_the_fp32_contract(monkeypatch):
    """The same model with one TF32 product (hi·hi) a k-step misses it."""
    a = _args(3, 2, 8, 8, 128, 256, False)
    want = _fp64_plain(a)
    steps = lf.tf32x3_steps_plain
    monkeypatch.setattr(lf, "tf32x3_steps_plain",
                        lambda x, w: steps(x, w, terms=1))
    assert not _within(lf.pass_b_recompute_tf32_plain(*a), want)


def test_warp_sums_order():
    """Lane l adds channels l, l + 32, ... in order, then the butterfly:
    exact on integers, and 0 over an empty slice."""
    v = torch.arange(96, dtype=torch.float32).reshape(1, 96)
    assert lf._warp_sums(v).item() == float(sum(range(96)))
    assert lf._warp_sums(v[:, :0]).item() == 0.0


@pytest.mark.parametrize("dm,di,ranks", [
    (192, 384, 1), (384, 768, 1), (768, 1536, 2), (1024, 2048, 3),
    (1280, 2560, 4), (1280, 64, 4), (32, 800, 2),
])
def test_cluster_split(dm, di, ranks):
    """The cluster's ranks at the registry widths (FastVim-T to -H) and at
    two lopsided ones; every slice and column group within the kernel's
    limits, whole 32s, covering the width in rank order."""
    assert lf.rc_tf32_ranks(dm, di) == ranks
    for width, cap in ((di, lf.RC_TF32_SLICE), (dm, lf.RC_TF32_COLS)):
        shares = lf._rc_shares(width, ranks)
        assert shares[0][0] == 0 and shares[-1][1] == width
        for (lo, hi), (nlo, _) in zip(shares, shares[1:] + [(width, 0)]):
            assert hi == nlo and lo % 32 == 0 and 0 <= hi - lo <= cap


def test_fp32_entry_takes_the_tf32_kernel():
    """The C entry hands fp32 to the 3xTF32 kernel, launched as clusters
    (its constants: tests/test_torch_port_recompute_wide.py), and no
    source holds K7's FMA-tile kernels any more (no fallback)."""
    entry = (CSRC / "layer_fused_recompute.cu").read_text()
    assert "fvf::pass_b_recompute_fwd_f32" in entry
    assert "cudaLaunchAttributeClusterDimension" in TF32_FILE.read_text()
    assert not (CSRC / "layer_fused.cuh").exists()
    for old in ("pass_b_rc_kernel", "pass_b_rc_wide_kernel", "gemm_rows",
                "pass_b_rc_smem", "pass_b_rc_wide_smem"):
        for src in CSRC.glob("*.cu*"):
            assert not re.search(rf"\b{old}\b", src.read_text()), (
                old, src.name)
