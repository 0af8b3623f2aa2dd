"""The precision design of the fp32 K3 and K4 (csrc/layer_fused_fwd_tf32.cu),
on the CPU: products of TF32 halves (3xTF32) keep the fp32 contract that
chip_smoke.py and the card tests hold the kernels to, and one TF32 product
does not.

The operands are those of the layer's GEMMs: x̂ (RMS-normalized, about
N(0, 1)) against W_x or W_z (d_model = K from 192 to 1280), and the gated
value against W_out (d_inner = K from 384 to 2560), with the weights at
their init scale K^-½. FP32_TOL: |got − want| <= tol + tol·|want|, tol =
1e-4, as chip_smoke.py states it.
"""

import numpy as np
import pytest
import torch

from fastvim_tpu_torch.ops.kernels.layer_fused import (
    tf32_round,
    tf32x3_matmul_plain,
)

FP32_TOL = 1e-4


def _operands(K: int, M: int = 512, N: int = 64):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1.0, 1.0, (N, K)).astype(np.float32)
                         * np.float32(K ** -0.5))
    return a, w


def _within(got, want, tol=FP32_TOL):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def test_tf32_round_to_nearest_ties_away():
    bits = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000,
                         0xBF801000 - (1 << 32), 0x3F802000],
                        dtype=torch.int32)
    got = tf32_round(bits.view(torch.float32)).view(torch.int32)
    want = torch.tensor([0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000,
                         0xBF802000 - (1 << 32), 0x3F802000],
                        dtype=torch.int32)
    assert torch.equal(got, want)
    v = _operands(768)[0]
    hi = tf32_round(v)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert ((hi - v).abs() <= v.abs() * 2.0 ** -11).all()
    # hi + lo keeps about 21 bits: lo·lo, which the kernels drop, is below
    lo = tf32_round(v - hi)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("K", [192, 768, 1280, 1536, 2560])
def test_three_tf32_products_keep_the_fp32_contract(K):
    a, w = _operands(K)
    want = a @ w.t()
    got = tf32x3_matmul_plain(a, w)
    assert _within(got, want)
    # and a tenth of the tolerance against the exact product
    exact = (a.double() @ w.double().t()).float()
    assert _within(got, exact, FP32_TOL / 10)


@pytest.mark.parametrize("K", [192, 768, 1536, 2560])
def test_one_tf32_product_misses_the_fp32_contract(K):
    a, w = _operands(K)
    got = tf32x3_matmul_plain(a, w, terms=1)
    assert not _within(got, a @ w.t())
