"""The port's data pieces and resampling against the JAX package, on the
CPU: the host loader's synthetic batches (bitwise), the pos-embed resize
and a model forward at another resolution, and the device-resident
augment and eval resize fed the JAX package's own draws.

Inputs come from numpy with a seed; the port's resampling builds the
weight matrices the way ``jax.image`` does (``ops/resize.py``), so the
tolerances are those of fp32 sums in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.data import create_imagenet_loader as jax_loader
from fastvim_tpu.data import device as jdevice
from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models.patch_embed import resize_pos_embed as jax_resize_pe
from fastvim_tpu_torch.data import create_imagenet_loader
from fastvim_tpu_torch.data import device as pdevice
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models.patch_embed import resize_pos_embed
from fastvim_tpu_torch.utils import from_jax_params


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_loader_batches_bitwise_equal_jax(split):
    """Two epochs of the synthetic loader (RRC + RandAugment + erasing for
    train, resize + center crop for val): every batch bitwise equal to the
    JAX package's, with the same shuffle and per-image draws. Both sides
    take PIL: neither package routes the supervised recipe or a
    synthetic eval through its native library (tests/test_torch_port_
    native.py holds the MAE recipe and the folder loader, which do)."""
    kw = dict(batch_size=4, img_size=32, training=split == "train",
              num_workers=3, seed=3, synthetic_samples=10)
    ours = create_imagenet_loader(None, split, **kw)
    theirs = jax_loader(None, split, **kw)
    assert len(ours) == len(theirs) == 2
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("scanpath", ["rowwise", "colwise"])
@pytest.mark.parametrize("old_hw,new_hw", [((14, 14), (16, 16)),
                                           ((16, 16), (14, 14)),
                                           ((14, 14), (8, 20))])
def test_resize_pos_embed_matches_jax(scanpath, old_hw, new_hw):
    """Bicubic (Keys, a = -0.5), antialiased when shrinking, half-pixel
    centres; up, down and to another aspect, both scan orientations: to
    1e-5."""
    rng = np.random.default_rng(0)
    pe = rng.standard_normal((1, old_hw[0] * old_hw[1], 24)).astype(
        np.float32)
    want = np.asarray(jax_resize_pe(jnp.asarray(pe), new_hw, old_hw,
                                    scanpath))
    got = resize_pos_embed(torch.from_numpy(pe), new_hw, old_hw, scanpath)
    assert got.shape == want.shape == (1, new_hw[0] * new_hw[1], 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scanpath", ["rowwise", "colwise"])
def test_forward_at_another_resolution_matches_jax(scanpath):
    """A model trained at 32 px (a 4 × 4 grid) run at 48 × 40 px: the
    pos-embed is resized to the 6 × 5 grid on both sides; logits to 1e-4
    of the largest."""
    kw = dict(img_size=32, patch_size=8, depth=2, embed_dim=64,
              num_classes=10, drop_path_rate=0.0, scanpath_type=scanpath)
    x = np.random.default_rng(1).standard_normal((2, 48, 40, 3)).astype(
        np.float32)
    jmodel = jax_create_model("fastvim_tiny", layer_fused="off",
                              scan_impl="ref", **kw)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    model = create_model("fastvim_tiny", device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in from_jax_params(params).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _jax_draws(keys, scale, ratio, jitter):
    """The draws of fastvim_tpu.data.device.make_device_augment, taken
    from each image's key as it takes them."""
    cols = {k: [] for k in pdevice.AugmentDraws._fields}
    for key in keys:
        ka, kr, kx, ky, kf, kb, kc = jax.random.split(key, 7)
        cols["area"].append(jax.random.uniform(ka, (), minval=scale[0],
                                               maxval=scale[1]))
        cols["logr"].append(jax.random.uniform(
            kr, (), minval=float(np.log(ratio[0])),
            maxval=float(np.log(ratio[1]))))
        cols["ux"].append(jax.random.uniform(kx, (), maxval=1.0))
        cols["uy"].append(jax.random.uniform(ky, (), maxval=1.0))
        cols["flip"].append(jax.random.bernoulli(kf))
        cols["fb"].append(jax.random.uniform(kb, (), minval=1 - jitter,
                                             maxval=1 + jitter))
        cols["fc"].append(jax.random.uniform(kc, (), minval=1 - jitter,
                                             maxval=1 + jitter))
    return pdevice.AugmentDraws(**{k: torch.from_numpy(np.array(v))
                                   for k, v in cols.items()})


@pytest.mark.parametrize("hw,size,hflip,scale", [
    ((8, 8), 32, False, (0.64, 1.0)),     # the digits recipe, upsampled
    ((20, 12), 16, True, (0.3, 1.0)),     # rectangular, flips, shrinks
])
def test_device_augment_matches_jax_on_its_draws(hw, size, hflip, scale):
    """The pure part of the device augment (crop box, bilinear resample
    without antialiasing, flip, brightness and contrast, normalize) fed
    the draws JAX takes from each image's key: to 1e-4, edge pixels
    included."""
    ratio, jitter, B = (0.8, 1.25), 0.2, 8
    imgs = np.random.default_rng(2).integers(0, 256, (B, *hw, 3), np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    aug = jdevice.make_device_augment(size, scale=scale, ratio=ratio,
                                      jitter=jitter, hflip=hflip)
    want = np.asarray(jax.vmap(aug)(jnp.asarray(imgs), keys))
    draws = _jax_draws(keys, scale, ratio, jitter)
    if hflip:
        assert 0 < int(draws.flip.sum()) < B
    got = pdevice.apply_device_augment(torch.from_numpy(imgs), draws, size,
                                       jitter, hflip)
    assert got.shape == want.shape == (B, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_device_augment_draws_are_seeded_and_in_range():
    """The port's draws come from the generator alone and lie in the
    ranges the JAX package draws from."""
    g = lambda: torch.Generator().manual_seed(4)
    a = pdevice.sample_augment_draws(g(), 64, (0.64, 1.0), (0.8, 1.25), 0.2)
    b = pdevice.sample_augment_draws(g(), 64, (0.64, 1.0), (0.8, 1.25), 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ((a.area >= 0.64) & (a.area <= 1.0)).all()
    assert ((a.logr >= math.log(0.8)) & (a.logr <= math.log(1.25))).all()
    assert ((a.fb >= 0.8) & (a.fb <= 1.2)).all()
    assert 0 < int(a.flip.sum()) < 64


@pytest.mark.parametrize("hw,size", [((8, 8), 16), ((20, 12), 16)])
def test_resize_eval_batch_matches_jax(hw, size):
    """The device eval transform: bilinear resize (antialiased when
    shrinking, an unchanged axis left alone) + normalize, to 1e-4."""
    imgs = np.random.default_rng(3).integers(0, 256, (3, *hw, 3), np.uint8)
    want = np.asarray(jdevice.resize_eval_batch(jnp.asarray(imgs), size))
    got = pdevice.resize_eval_batch(torch.from_numpy(imgs), size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
