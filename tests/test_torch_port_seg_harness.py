"""The port's segmentation harness against the JAX package, on the CPU:
``SegmentationLoader`` batches bitwise over two epochs (train and eval,
on synthetic data and on an ADE20K folder of generated JPEG / PNG
files), the three segmentation configs, ``poly_schedule``, the
weight-decay mask over the segmentor, and the CLIs: ``train_segmentation``
trains and evaluates, ``--eval_only`` reads its checkpoint, a run resumed
mid-epoch equals an uninterrupted one, ``extract_features --with_fpn``,
and both take the card unless asked for the CPU.

The CLIs run the registry's models cut to width 32 and the heads to 32
channels, at img 32 (a 2 × 2 grid at patch 16).
"""

import csv
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu import config as jconfig
from fastvim_tpu.cli import train_segmentation as jtrain_seg
from fastvim_tpu.data import segmentation as jseg_data
from fastvim_tpu.train import optim as joptim
from fastvim_tpu_torch import config as pconfig
from fastvim_tpu_torch.cli import extract_features, train_segmentation
from fastvim_tpu_torch.data import segmentation as seg_data
from fastvim_tpu_torch.models import UperNetSegmentor, upernet
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.train import wd_mask
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

SEG_CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(pconfig.CONFIG_ROOT, "segmentation")))


@pytest.fixture
def tiny_port_models(monkeypatch):
    """The port's registry models at width 32 (their depth, which the
    configs' ``out_indices`` need), the segmentor's heads at 32
    channels."""
    for name, factory in list(preg._REGISTRY.items()):
        monkeypatch.setitem(preg._REGISTRY, name,
                            lambda f=factory, **kw: f(**dict(
                                kw, embed_dim=32)))
    for head in ("UPerHead", "FCNHead"):
        monkeypatch.setattr(upernet, head, functools.partial(
            getattr(upernet, head), channels=32))


@pytest.fixture(scope="module")
def ade_dir(tmp_path_factory):
    """An ADEChallengeData2016 layout: JPEG and PNG images of several
    sizes and aspects, PNG annotations with 0 (unlabeled) and classes
    1..5, one image without an annotation and one stray file."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ade")
    rng = np.random.default_rng(0)
    sizes = {"training": [(40, 56), (64, 48), (36, 36), (50, 70), (33, 45),
                          (48, 64)],
             "validation": [(40, 56), (30, 70), (36, 36)]}
    for split, hws in sizes.items():
        os.makedirs(root / "images" / split)
        os.makedirs(root / "annotations" / split)
        for i, (h, w) in enumerate(hws):
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            ext = ".jpg" if i % 2 else ".png"
            Image.fromarray(img).save(root / "images" / split / f"a{i}{ext}")
            ann = rng.integers(0, 6, (h // 4 + 1, w // 4 + 1), np.uint8)
            ann = np.kron(ann, np.ones((4, 4), np.uint8))[:h, :w]
            Image.fromarray(ann).save(root / "annotations" / split
                                      / f"a{i}.png")
        Image.fromarray(rng.integers(0, 256, (20, 20, 3), np.uint8)).save(
            root / "images" / split / "unlabeled.jpg")
        (root / "images" / split / "notes.txt").write_text("x")
    return str(root)


# --- the loader -----------------------------------------------------------

def _epochs(loader, n=2):
    return [[{k: v.copy() for k, v in b.items()} for b in loader]
            for _ in range(n)]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("source", ["synthetic", "ade20k"])
def test_loader_batches_bitwise_over_two_epochs(source, training, ade_dir):
    """The same batches as the JAX loader's, bit for bit: train crops
    (random resize, cat_max_ratio crop, flip, pad with 255) and the eval
    batch padded to one 32-aligned canvas."""
    data_dir = ade_dir if source == "ade20k" else None
    split = "training" if training else "validation"
    kw = dict(batch_size=2, crop=32, training=training, num_classes=5,
              num_workers=2, seed=3, synthetic_samples=5)
    got = _epochs(seg_data.create_segmentation_loader(data_dir, split, **kw))
    want = _epochs(jseg_data.create_segmentation_loader(data_dir, split,
                                                        **kw))
    n_batches = 0
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for g, w in zip(g_epoch, w_epoch):
            assert g.keys() == w.keys() == {"image", "label"}
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
            n_batches += 1
            if training:
                assert g["image"].shape == (2, 32, 32, 3)
            else:
                assert g["image"].shape[1] % 32 == 0
    assert n_batches >= 2
    if training:  # the two epochs draw differently
        assert not np.array_equal(got[0][0]["image"], got[1][0]["image"])
    if source == "ade20k":
        ds = seg_data.ADE20KDataset(ade_dir, split)
        assert len(ds) == (6 if training else 3)
        _, label = ds.load(0)
        assert set(np.unique(label)) <= {0, 1, 2, 3, 4, 255}


def test_loader_resumes_mid_epoch():
    """``epoch`` and ``start_batch`` set on a fresh loader: the rest of
    that epoch, then whole epochs, as one loader going through them."""
    ds = seg_data.SyntheticSegDataset(7, 32, 5)
    straight = seg_data.SegmentationLoader(ds, 2, 32, seed=1, num_workers=1)
    want = _epochs(straight, 3)
    resumed = seg_data.SegmentationLoader(ds, 2, 32, seed=1, num_workers=1)
    resumed.epoch, resumed.start_batch = 1, 2
    got = _epochs(resumed, 2)
    assert len(got[0]) == 1 and len(got[1]) == 3
    for g, w in zip(got[0] + got[1], want[1][2:] + want[2]):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


# --- configs, schedule, mask ----------------------------------------------

@pytest.mark.parametrize("name", SEG_CONFIGS)
def test_seg_configs_load_like_jax_and_build(name, tiny_port_models):
    assert len(SEG_CONFIGS) == 3
    over = ["img_size=32", "head_norm=bn", "data.dir=/data/ade"]
    for overrides in ([], over):
        got = pconfig.load_config(name, "segmentation", overrides)
        assert got == jconfig.load_config(name, "segmentation", overrides)
    cfg = pconfig.load_config(name, "segmentation", over)
    seg = train_segmentation.build_segmentor(cfg, torch.device("cpu"))
    assert isinstance(seg, UperNetSegmentor) and not seg.training
    assert seg.backbone.out_indices == (5, 11, 17, 23)
    assert seg.backbone.embed_dim == 32  # the cut registry
    with torch.no_grad():
        out = seg(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 150) and torch.isfinite(out).all()


def test_poly_schedule_matches_jax():
    args = (6e-5, 160000, 1.0, 0.0, 1500, 1e-6)
    port, jax_sched = (train_segmentation.poly_schedule(*args),
                       jtrain_seg.poly_schedule(*args))
    for step in (0, 1, 750, 1499, 1500, 1501, 80000, 159999, 160000, 170000):
        np.testing.assert_allclose(port(step), float(jax_sched(step)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))
    sq = (1e-3, 100, 2.0, 1e-5, 10, 0.1)
    for step in (0, 5, 10, 50, 99, 100):
        np.testing.assert_allclose(
            train_segmentation.poly_schedule(*sq)(step),
            float(jtrain_seg.poly_schedule(*sq)(step)), rtol=1e-6)


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_wd_mask_over_the_segmentor_matches_jax(norm, tiny_port_models):
    """Weight decay exactly where the JAX CLI's mask puts it, name for
    name under the converter."""
    cfg = pconfig.load_config("upernet_FastVimT_ade20k", "segmentation",
                              ["img_size=32", f"head_norm={norm}"])
    seg = train_segmentation.build_segmentor(cfg, torch.device("cpu"))
    params = to_jax_params({k: v.numpy()
                            for k, v in seg.state_dict().items()})
    jmask = joptim.wd_mask(jax.tree_util.tree_map(jnp.asarray,
                                                  params["params"]))
    full = from_jax_params(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m), jmask, params["params"]))
    mask = wd_mask(seg)
    assert set(mask) == set(full) - {
        k for k in full if "running" in k}
    for name, decays in mask.items():
        assert decays == bool(full[name].all()), name
    assert mask["decode_head.conv_seg.weight"]
    assert not mask["decode_head.conv_seg.bias"]
    assert not mask["backbone.pos_embed"]


# --- the CLIs ---------------------------------------------------------------

def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _train(out, *more, data_dir=None):
    args = ["--config_name", "upernet_FastVimT_ade20k", "--model_save_dir",
            str(out), "--device", "cpu", "--synthetic_samples", "6",
            "--eval_every", "2", *more, "img_size=32", "batch_size=2",
            "num_workers=1", "lr_schedule.warmup_iters=2"]
    if data_dir:
        args += ["--data_dir", data_dir]
    return train_segmentation.main(args)


def test_train_segmentation_then_eval_only(tmp_path, tiny_port_models,
                                           ade_dir):
    """On the ADE20K folder (eval images wider than the crop go through
    slide inference): 2 iterations and an eval, the log's row, then
    ``--eval_only`` from the checkpoint gives that row's mIoU."""
    state = _train(tmp_path, "--total_iters", "2", data_dir=ade_dir)
    assert state.step == 2 and state.tx.count == 2
    rows = _rows(tmp_path / "log.csv")
    assert [r["iter"] for r in rows] == ["2"]
    for r in rows:
        assert 0.0 <= float(r["mIoU"]) <= 1.0
        assert np.isfinite(float(r["train_loss"]))
        assert float(r["steps_per_sec"]) > 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2"]
    miou = _train(tmp_path, "--eval_only", data_dir=ade_dir)
    assert miou == float(rows[-1]["mIoU"])


def test_train_segmentation_resume_equals_uninterrupted(tmp_path,
                                                        tiny_port_models):
    """4 iterations straight (3 an epoch on 6 synthetic images), and the
    same run cut after iteration 2 (its directory with only the step-2
    checkpoint) and resumed mid-epoch: the same parameters and BatchNorm
    statistics bit for bit, AdamW count and log rows, so the resumed run
    drew the batches and dropout masks of the uninterrupted one."""
    more = ("--total_iters", "4", "head_norm=bn")
    straight = _train(tmp_path / "straight", *more)
    shutil.copytree(tmp_path / "straight", tmp_path / "cut")
    os.remove(tmp_path / "cut" / "ckpt" / "step_4")
    resumed = _train(tmp_path / "cut", "--resume", *more)
    assert resumed.step == straight.step == 4
    assert resumed.tx.count == straight.tx.count == 4
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got, want = (_rows(tmp_path / d / "log.csv") for d in ("cut", "straight"))
    assert [r["iter"] for r in got] == ["2", "4"]
    for g, w in zip(got, want):
        assert (g["mIoU"], g["train_loss"]) == (w["mIoU"], w["train_loss"])


def test_extract_features_with_fpn(tmp_path, tiny_port_models, ade_dir):
    out = extract_features.main(
        ["--config_name", "upernet_FastVimT_ade20k", "img_size=64",
         "--with_fpn", "--device", "cpu", "--images",
         os.path.join(ade_dir, "images", "validation", "a0.png"),
         os.path.join(ade_dir, "images", "validation", "a1.jpg")])
    assert [tuple(f.shape) for f in out["features"]] == [(2, 4, 4, 32)] * 4
    assert [tuple(f.shape) for f in out["pyramid"]] == [
        (2, 16, 16, 256), (2, 8, 8, 256), (2, 4, 4, 256), (2, 2, 2, 256),
        (2, 1, 1, 256)]
    plain = extract_features.main(
        ["--config_name", "upernet_FastVimT_ade20k", "--device", "cpu",
         "img_size=64"])
    assert plain["pyramid"] is None and len(plain["features"]) == 4


@pytest.mark.parametrize("cli", [train_segmentation, extract_features])
def test_seg_clis_raise_without_a_card_unless_asked_for_the_cpu(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config_name", "upernet_FastVimT_ade20k"])
