"""The port's box operations (``fastvim_tpu_torch/ops/boxes.py``) against
the JAX package's, on the CPU, on seeded numpy inputs.

Exact: the anchors, the three NMS (indices and validity, with equal
scores, ``-inf`` and NaN scores and the odd round cap), the max-IoU
assignment with and without low-quality matches (the highest-index gt
winning ties), and ``sample_from_draws`` given the draws JAX's
``random_sample`` makes from its key. Within 1e-6: the delta coder and
``box_iou``. RoIAlign and its multi-level form within 1e-5 in fp32 (R
not a multiple of JAX's chunk, both of JAX's contraction orders) and
2e-2 of the largest entry in bf16, and the gradient with respect to the features
against ``jax.vjp`` within 1e-5 of its largest entry. The JAX side runs
jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.ops import boxes as jboxes
from fastvim_tpu_torch.ops import boxes


def _boxes(rng, n, lo=0.0, hi=60.0, wlo=4.0, whi=30.0):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(wlo, whi, (n, 2))],
                          1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("sizes,strides,scales,ratios", [
    ([(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)], [4, 8, 16, 32, 64], (8,),
     (0.5, 1.0, 2.0)),
    ([(5, 7), (3, 2)], [8, 16], (4, 8), (0.25, 1.0))])
def test_anchors_equal_jax(sizes, strides, scales, ratios):
    got = boxes.generate_anchors(sizes, strides, scales, ratios)
    want = jboxes.generate_anchors(sizes, strides, scales, ratios)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_delta_coder_and_iou_match_jax():
    rng = np.random.default_rng(0)
    src, gt = _boxes(rng, 64), _boxes(rng, 64)
    deltas = rng.normal(scale=2.0, size=(64, 4)).astype(np.float32)
    deltas[:4, 2:] = [[9.0, -9.0], [-9.0, 9.0], [5.0, 0.0], [0.0, -5.0]]
    stds = (0.033, 0.033, 0.067, 0.067)
    enc = jax.jit(functools.partial(jboxes.delta_encode, stds=stds))
    dec = jax.jit(functools.partial(jboxes.delta_decode, stds=stds,
                                    max_shape=(64, 80)))
    np.testing.assert_allclose(
        boxes.delta_encode(_t(src), _t(gt), stds=stds).numpy(),
        np.asarray(enc(src, gt)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        boxes.delta_decode(_t(src), _t(deltas), stds=stds,
                           max_shape=(64, 80)).numpy(),
        np.asarray(dec(src, deltas)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        boxes.delta_decode(_t(src), _t(deltas)).numpy(),
        np.asarray(jax.jit(jboxes.delta_decode)(src, deltas)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        boxes.box_iou(_t(src), _t(gt[:9])).numpy(),
        np.asarray(jax.jit(jboxes.box_iou)(src, gt[:9])), rtol=1e-6,
        atol=1e-6)


def _chain(n):
    """Box k overlaps only box k + 1, scores descending: greedy NMS at
    0.2 keeps the evens, after n rounds of the fixpoint."""
    b = np.stack([np.arange(n) * 6.0, np.zeros(n), np.arange(n) * 6.0 + 10.0,
                  np.full(n, 10.0)], 1).astype(np.float32)
    return b, np.linspace(1.0, 0.5, n).astype(np.float32)


def _nms_cases():
    rng = np.random.default_rng(3)
    cases = []
    for n, thr, cap in [(30, 0.5, 30), (64, 0.3, 16), (96, 0.7, 128)]:
        b = _boxes(rng, n, hi=40.0)
        s = rng.uniform(0, 1, n).astype(np.float32)
        cases.append((f"random n{n}", b, s, thr, cap, 65))
    b = _boxes(rng, 48, hi=30.0)
    s = np.round(rng.uniform(0, 1, 48), 1).astype(np.float32)  # ties
    s[::7] = -np.inf
    s[3::11] = np.nan
    cases.append(("ties, -inf, NaN", b, s, 0.4, 40, 65))
    s2 = np.full(48, 0.5, np.float32)  # every score equal
    s2[:5] = -np.inf
    cases.append(("all equal", b, s2, 0.4, 24, 65))
    b, s = _chain(40)
    cases.append(("chain", b, s, 0.2, 40, 65))
    for cap in (5, 6):  # 6 is forced to 7
        cases.append((f"chain cap {cap}", *_chain(80), 0.2, 80, cap))
    return cases


@pytest.mark.parametrize("case", _nms_cases(), ids=lambda c: c[0])
def test_nms_equal_jax(case):
    """``nms`` (fixpoint, with the round cap), ``nms_scan`` and
    ``fast_nms``: indices and validity exactly JAX's."""
    _, b, s, thr, max_out, rounds = case
    jnms = jax.jit(jboxes.nms, static_argnums=(2, 3, 4))
    got = boxes.nms(_t(b), _t(s), thr, max_out, max_rounds=rounds)
    want = jnms(b, s, thr, max_out, rounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if rounds == 65:
        got = boxes.nms_scan(_t(b), _t(s), thr, max_out)
        want = jax.jit(jboxes.nms_scan, static_argnums=(2, 3))(b, s, thr,
                                                               max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = boxes.fast_nms(_t(b), _t(s), thr, max_out)
    want = jax.jit(jboxes.fast_nms, static_argnums=(2, 3))(b, s, thr,
                                                           max_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("low_quality", [False, True])
def test_max_iou_assign_equal_jax(low_quality):
    """Random anchors against padded gts, with a duplicated gt (its
    claims tie: the higher index wins) and a duplicated anchor."""
    rng = np.random.default_rng(5)
    anchors = _boxes(rng, 200, hi=50.0)
    anchors[7] = anchors[3]
    gt = _boxes(rng, 6, hi=40.0, wlo=10.0)
    gt[4] = gt[1]
    anchors[0] = gt[1]  # IoU 1 with gts 1 and 4
    gt_valid = np.array([True, True, False, True, True, False])
    fn = jax.jit(jboxes.max_iou_assign, static_argnums=(3, 4, 5, 6))
    results = []
    for thr in ((0.7, 0.3, 0.3), (0.5, 0.5, 0.5), (0.6, 0.6, 0.6)):
        got = boxes.max_iou_assign(_t(anchors), _t(gt), _t(gt_valid), *thr,
                                   match_low_quality=low_quality)
        want = fn(anchors, gt, gt_valid, *thr, low_quality)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        results.append(got.numpy())
    # argmax takes the first of equal IoUs, a claim the highest gt index
    assert results[0][0] == (4 if low_quality else 1)


@pytest.mark.parametrize("num,pos_fraction,npos", [
    (16, 0.5, 30), (16, 0.25, 2), (64, 0.25, 0), (40, 0.5, 50)])
def test_sample_from_draws_equals_jax_random_sample(num, pos_fraction, npos):
    """Given the two uniform draws JAX's ``random_sample`` makes from its
    key, the port selects exactly what it selects (few positives,
    ignored boxes, candidates running out)."""
    n = 80
    rng = np.random.default_rng(npos)
    assigned = np.full(n, -1, np.int32)
    assigned[rng.permutation(n)[:npos]] = rng.integers(0, 4, npos)
    assigned[rng.permutation(n)[:10]] = -2
    if num == 40:
        assigned[:70] = -2  # fewer candidates than num
    key = jax.random.PRNGKey(num + npos)
    want = jax.jit(jboxes.random_sample, static_argnums=(2, 3))(
        key, assigned, num, pos_fraction)
    r_pos, r_neg = jax.random.split(key)
    u_pos = np.asarray(jax.random.uniform(r_pos, (n,)))
    u_neg = np.asarray(jax.random.uniform(r_neg, (n,)))
    got = boxes.sample_from_draws(_t(assigned).long(), _t(u_pos), _t(u_neg),
                                  num, pos_fraction)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gen = torch.Generator().manual_seed(0)
    idx, is_pos, valid = boxes.random_sample(gen, _t(assigned).long(), num,
                                             pos_fraction)
    assert idx.shape == (num,) and int(is_pos.sum()) <= int(
        num * pos_fraction)


def _rois(rng, R, size):
    xy = rng.uniform(-4, size * 0.8, (R, 2))
    wh = rng.uniform(1, size * 0.6, (R, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def test_roi_align_matches_jax_with_gradient():
    """fp32, R = 37 (not a multiple of the JAX package's chunk of 16 RoIs),
    a quarter scale, both of JAX's contraction orders; and the gradient
    with respect to the features against ``jax.vjp``."""
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(24, 20, 8)).astype(np.float32)
    rois = _rois(rng, 37, 80)
    f = _t(feat).requires_grad_(True)
    got = boxes.roi_align(f, _t(rois), 7, 0.25)
    cot = rng.normal(size=tuple(got.shape)).astype(np.float32)
    (g,) = torch.autograd.grad(got, f, _t(cot))
    for xfirst in (True, False):
        ja = functools.partial(jboxes.roi_align, out_size=7,
                               spatial_scale=0.25, xfirst=xfirst)
        want, vjp = jax.vjp(lambda f: ja(f, jnp.asarray(rois)),
                            jnp.asarray(feat))
        (want_g,) = jax.jit(vjp)(jnp.asarray(cot))
        assert _rel(got.detach().numpy(), want) <= 1e-5
        assert _rel(g.numpy(), want_g) <= 1e-5


def test_roi_align_bf16_matches_jax():
    rng = np.random.default_rng(12)
    feat = rng.normal(size=(16, 16, 8)).astype(np.float32)
    rois = _rois(rng, 20, 64)
    want = jax.jit(functools.partial(jboxes.roi_align, out_size=7,
                                     spatial_scale=0.25))(
        jnp.asarray(feat, jnp.bfloat16), rois)
    got = boxes.roi_align(_t(feat).bfloat16(), _t(rois), 7, 0.25)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_multilevel_roi_align_matches_jax_with_gradient():
    """Four levels (strides 4-32 of a 64 px image), RoIs of every level's
    size, 14² outputs; the gradient of every level's map."""
    rng = np.random.default_rng(13)
    feats = [rng.normal(size=(64 // s, 64 // s, 4)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    xy = rng.uniform(0, 40, (21, 2))
    side = np.geomspace(8, 700, 21)[:, None]
    wh = side * rng.uniform(0.8, 1.25, (21, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lv = boxes.roi_levels(_t(rois), 4).numpy()
    assert set(lv.tolist()) == {0, 1, 2, 3}
    ja = functools.partial(jboxes.multilevel_roi_align, out_size=14,
                           strides=(4, 8, 16, 32))
    want, vjp = jax.vjp(lambda *fs: ja(list(fs), jnp.asarray(rois)),
                        *map(jnp.asarray, feats))
    cot = rng.normal(size=want.shape).astype(np.float32)
    want_g = jax.jit(vjp)(jnp.asarray(cot))
    fs = [_t(f).requires_grad_(True) for f in feats]
    got = boxes.multilevel_roi_align(fs, _t(rois), 14, (4, 8, 16, 32))
    assert _rel(got.detach().numpy(), want) <= 1e-5
    for g, w in zip(torch.autograd.grad(got, fs, _t(cot)), want_g):
        assert _rel(g.numpy(), w) <= 1e-5
