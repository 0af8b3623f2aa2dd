"""K10's launch plan (``merge_gate.ln_gate_plan``), on the CPU.

The wrapper hands the plan's pieces a thread (K) and team size (G) to the
kernel, which checks that they cover d and that the block fits its
``__launch_bounds__`` (csrc/merge_gate.cu); the card tests launch it at
every width. Here: every width ``fusable`` accepts gets a legal plan in
both dtypes, the registry's widths fit exactly with K 2 or 3, the first
width past ``MAX_D`` is refused by both, and the plan's constants are the
kernel's.
"""

import ctypes
import re

import pytest

from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.kernels import merge_gate as mg

REGISTRY_D = (384, 768, 1536, 2048, 2560)  # FastVim-T/S/B/L/H d_inner


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_plan_covers_every_width(elem_bytes):
    per_piece = 16 // elem_bytes
    for d in range(32, mg.MAX_D + 1, 32):
        assert mg.fusable((14, 14), (1,), d) and mg.fusable((5, 7), (0,), d)
        plan = mg.ln_gate_plan(d, elem_bytes)
        k, team, threads = plan
        n = d // per_piece  # 16-byte pieces of a token
        assert k in mg.PIECES, (d, plan)
        assert team in (1, 2, 4, 8, 16, 32) or team % 32 == 0, (d, plan)
        need = -(-n // k)  # the team that covers the pieces, unrounded
        assert need <= team and (team < 2 * need if need <= 32
                                 else team < need + 32), (d, plan)
        assert threads == (mg.SMALL_TEAM_BLOCK if team <= 32 else team)
        assert threads % team == 0
        assert threads <= mg.ln_gate_max_threads(k, elem_bytes), (d, plan)
    for d in REGISTRY_D:
        k, team, _ = mg.ln_gate_plan(d, elem_bytes)
        assert k >= 2 and k * team == d // per_piece, d


def test_widths_past_the_plan_are_not_fused():
    """fusable stops where the plan does, so the mixer never hands K10 a
    width its launcher refuses."""
    assert mg.fusable((14, 14), (0,), mg.MAX_D)
    assert not mg.fusable((14, 14), (0,), mg.MAX_D + 32)
    assert not mg.fusable((14, 14), (1,), 48)
    for elem_bytes in (2, 4):
        with pytest.raises(ValueError, match="no plan"):
            mg.ln_gate_plan(mg.MAX_D + 32, elem_bytes)


def test_plan_matches_the_kernel_source():
    """The plan's limits are the kernel's: the widest d, the block of
    small teams and the threads a block may have by K; the wrapper passes
    K and G as two ints before eps."""
    src = (_build.CSRC / "merge_gate.cu").read_text()
    assert re.search(rf"kMaxD = {mg.MAX_D};", src)
    assert re.search(rf"kSmallTeamBlock = {mg.SMALL_TEAM_BLOCK};", src)
    bounds = re.search(r"return K == 3 \? (\d+) : K == 2 \? \(sizeof\(T\) "
                       r"== 4 \? (\d+) : (\d+)\) : (\d+);", src)
    assert bounds is not None
    k3, k2_fp32, k2_bf16, k1 = map(int, bounds.groups())
    for elem_bytes in (2, 4):
        assert (k3, k1) == (mg.ln_gate_max_threads(3, elem_bytes),
                            mg.ln_gate_max_threads(1, elem_bytes))
    assert (k2_fp32, k2_bf16) == (mg.ln_gate_max_threads(2, 4),
                                  mg.ln_gate_max_threads(2, 2))
    sig = _build.SIGNATURES["fv_merge_ln_gate_fwd"]
    assert sig[18:21] == [ctypes.c_int, ctypes.c_int, ctypes.c_float]


def test_z_slice_of_one_token_images():
    """On a 1 × 1 grid z is still the second column block of the
    in-projection's output: its images, each of one token, are ldz
    apart, which token_stride reads from the image stride."""
    import torch

    from fastvim_tpu_torch.ops import kernels

    xz = torch.zeros(2, 1, 64)
    assert kernels.token_stride("k", "z", xz[..., 32:]) == 64
    assert kernels.token_stride("k", "z", xz[:1, :, 32:]) == 32
    assert kernels.token_stride("k", "z", torch.zeros(2, 1, 32)) == 32
    for bad in (xz[..., 1:33], xz[..., ::2]):
        with pytest.raises(ValueError, match="column slice"):
            kernels.token_stride("k", "z", bad)
