"""K9's launch plan (``fused_block.merge_gate_plan``), on the CPU.

The wrapper hands the plan's tile, thread count and shared-memory bytes to
the kernel, which counts its own layout (``merge_smem`` in
csrc/fused_block.cu) and refuses a launch whose bytes differ or do not
fit; the card tests launch it at every tile size. Here: every width
``fusable`` accepts, FastVim-H's d_inner (2560) and past it, gets a tile
of at least one token that fits, on grids with long and short rows, and
the first width past them is refused by both.
"""

import re

import pytest

from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.kernels import fused_block as fb

GRIDS = [(128, 128), (14, 14), (6, 10), (170, 5), (4, 200), (1, 12),
         (2048, 1), (6, 2)]
D_MAX = 2752  # the widest d whose one-token tile fits in fp32


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("rows,cols", GRIDS)
def test_merge_gate_plan_fits_every_width(rows, cols, elem_bytes):
    for d in range(32, D_MAX + 1, 32):
        assert fb.fusable(rows, cols, d), d
        plan = fb.merge_gate_plan(d, rows, cols, elem_bytes)
        tile, threads = plan.tile, plan.threads
        assert 1 <= tile <= 32 and tile & (tile - 1) == 0, (d, plan)
        assert plan.smem == fb.merge_gate_smem(tile, d, rows, cols,
                                               elem_bytes)
        assert plan.smem <= fb.SMEM_BLOCK, (d, plan)
        # a thread owns 4 channels; up to 384 of them keep one quad each
        assert 32 <= threads <= fb.MG_MAX_THREADS
        if d // 4 <= fb.MG_MAX_THREADS:
            assert threads % (d // 4) == 0
        # the largest tile that fits was taken, up to 2 chunks a thread
        bigger = 2 * tile
        if bigger <= 32 and bigger <= 8 * max(1, threads // (d // 4)):
            assert fb.merge_gate_smem(bigger, d, rows, cols,
                                      elem_bytes) > fb.SMEM_BLOCK
    # the yf / yb rows staged cover every tile's rows, wherever it starts
    for tile in fb.MG_TILES:
        nr = fb.merge_rows_staged(tile, rows, cols)
        for c0 in range(cols):
            assert min(rows, (c0 + tile - 1) // cols + 1) <= nr, (tile, c0)


@pytest.mark.parametrize("rows,cols", [(14, 14), (2048, 1)])
def test_widths_past_the_plan_are_not_fused(rows, cols):
    """fusable stops where fp32's one-token tile stops fitting, so the
    mixer never hands K9 a width its launcher refuses."""
    assert fb.fusable(rows, cols, D_MAX)
    assert not fb.fusable(rows, cols, D_MAX + 32)
    with pytest.raises(ValueError, match="no tile"):
        fb.merge_gate_plan(D_MAX + 32, rows, cols, 4)
    fb.merge_gate_plan(D_MAX + 32, rows, cols, 2)  # bf16 alone would fit


def test_merge_gate_plan_matches_the_kernel_source():
    """The plan's limits are the kernel's: its thread bound and the shared
    memory a block may use; the wrapper passes its tile, threads and
    bytes."""
    src = (_build.CSRC / "fused_block.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    assert re.search(rf"kMgMaxThreads = {fb.MG_MAX_THREADS};", src)
    assert re.search(rf"kMaxSmem = {fb.SMEM_BLOCK};", common)
    assert _build.SIGNATURES["fv_merge_gate_fwd"][21:24] == [
        _build.ctypes.c_int] * 3
