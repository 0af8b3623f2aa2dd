"""The launch plan of K5's and K6's bf16 wide forms
(csrc/layer_fused_bwd_wide.cu), on the CPU: the tile and window sizes the
wrappers size their scratch by, against the C constants; the weight
gradients' token slices; the form's width predicate. The kernels themselves
are held to their plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 2)."""

import re

import pytest
import torch

from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.kernels import layer_fused as lf

REGISTRY_WIDE = [(768, 1536), (1024, 2048), (1280, 2560)]


def _c_constants(source: str) -> dict:
    """The `constexpr int name = expr;` lines of a source, evaluated in
    order (an expression may name an earlier constant)."""
    found = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 source):
        found[name] = eval(expr, {}, dict(found))  # noqa: S307 (our source)
    return found


def test_wide_tile_constants_match_the_sources():
    c = _c_constants((_build.CSRC / "layer_fused_bwd.cuh").read_text())
    assert (lf.BWD_WIDE_TM, lf.BWD_WIDE_TN, lf.A_BWD_WINDOW_WIDE) == (
        c["kWideTM"], c["kWideTN"], c["kAWinWide"])
    # the window's own rows and 3 halo rows each side fill one tile
    assert lf.A_BWD_WINDOW_WIDE + 6 == lf.BWD_WIDE_TM
    # the wide file builds its tiles from these, not from numbers of its own
    wide = (_build.CSRC / "layer_fused_bwd_wide.cu").read_text()
    for name in ("kWideTM", "kWideTN", "kAWinWide"):
        assert f"fvb::{name}" in wide


@pytest.mark.parametrize("dm,di", REGISTRY_WIDE)
@pytest.mark.parametrize("ntokens", [1568, 8192, 32768, 200704])
@pytest.mark.parametrize("jobs", [1, 2])
def test_wide_wgrad_splits_fill_the_waves(dm, di, ntokens, jobs):
    """The fewest token slices whose tiles fill 90 % of their waves on 132
    SMs, each of at least 256 tokens; where none does, the fullest."""
    n = lf._wide_wgrad_splits(ntokens, dm, di, jobs)
    nb = 4 if dm % 256 == di % 256 == 0 else 2
    tiles = -(-dm // 128) * (di // (64 * nb))
    eff = lambda k: tiles * jobs * k / (132 * -(-tiles * jobs * k // 132))
    allowed = [k for k in range(1, 33) if k == 1 or ntokens >= 256 * k]
    assert n in allowed
    if eff(n) >= 0.9:
        assert all(eff(k) < 0.9 for k in allowed if k < n)
    else:
        assert eff(n) == max(eff(k) for k in allowed)


def test_wide_wgrad_splits_at_the_main_shapes():
    # FastVim-B at 2048 px, B = 2: K5's two products in 5 slices (360
    # tiles, 2.7 waves), K6's one in 7 (252 tiles); FastVim-L at 224 px, B
    # = 8: one slice for K5 (128 tiles), two for K6
    assert lf._wide_wgrad_splits(32768, 768, 1536, 2) == 5
    assert lf._wide_wgrad_splits(32768, 768, 1536, 1) == 7
    assert lf._wide_wgrad_splits(1568, 1024, 2048, 2) == 1
    assert lf._wide_wgrad_splits(1568, 1024, 2048, 1) == 2
    assert lf._wide_wgrad_splits(100, 768, 1536, 2) == 1


@pytest.mark.parametrize("B,H,W,dm,di", [(2, 128, 128, 768, 1536),
                                         (8, 14, 14, 1024, 2048),
                                         (3, 9, 7, 512, 832)])
def test_wide_scratch_keeps_the_sums_aligned(B, H, W, dm, di):
    """K5's wide scratch: the segments the float4 sums read start 16 bytes
    apart and the statistics after them 8 bytes apart, at either
    orientation."""
    T = B * H * W
    ntt, nct = -(-T // lf.BWD_WIDE_TM), -(-di // lf.BWD_WIDE_TN)
    for P in (H, W):
        col, dd = ntt * 3 * di, B * P * (2 * di + dm)
        assert col % 4 == 0 and dd % 4 == 0
        assert lf._wide_b_scratch(B, P, T, dm, di) == (
            col + dd + 2 * T + 2 * T * nct)


def test_bwd_wide_predicate_matches_the_sources():
    c = _c_constants((_build.CSRC / "layer_fused_bwd.cuh").read_text())
    for dm, di in [(192, 384), (384, 768), (384, 832), (448, 768),
                   *REGISTRY_WIDE]:
        wide = dm > c["kNarrowDm"] or di > c["kNarrowDi"]
        assert lf.bwd_wide(dm, di, torch.bfloat16) == wide
        assert not lf.bwd_wide(dm, di, torch.float32)
