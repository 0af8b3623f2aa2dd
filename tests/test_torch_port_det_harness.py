"""The port's detection harness against the JAX package, on the CPU: the
COCO AP metrics (box and mask AP, ``paste_mask``, ``coco_map``,
``box_iou``) exactly on seeded predictions, the LSJ transform and
``DetectionLoader`` batches bitwise over two epochs, the COCO folder
reader on a folder the test writes, the four detection configs against
the JAX loader, and the ``train_detection`` CLI: one epoch and a
``--resume`` to two bit for bit equal to two epochs straight,
``--eval_only``, and the card taken unless the CPU is asked for.

The CLI runs the registry's models cut to width 32 (their full depth: the
configs' ``out_indices`` [23]) and the detector's heads to 32 channels
(fc 64), at img 64, batch 1, on 2 synthetic images.
"""

import csv
import functools
import json
import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu import config as jconfig
from fastvim_tpu.data import detection as jdata
from fastvim_tpu.train import metrics as jmetrics
from fastvim_tpu_torch import config as pconfig
from fastvim_tpu_torch.cli import train_detection
from fastvim_tpu_torch.data import detection as pdata
from fastvim_tpu_torch.models import detection
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.train import metrics

IMG, MAX_GT, NC = 64, 4, 3
DET_CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(pconfig.CONFIG_ROOT, "detection")))


def _preds_and_gts(seed, n_img=3, size=48):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_img):
        G, N = int(rng.integers(1, 5)), 12
        gb = np.concatenate([rng.uniform(0, 30, (G, 2)),
                             rng.uniform(0, 30, (G, 2)) + 8], 1)
        gm = np.zeros((G, size, size), np.uint8)
        for g, b in enumerate(gb.astype(int)):
            gm[g, b[1]:b[3], b[0]:b[2]] = 1
        gl = rng.integers(0, NC, G)
        pb = np.concatenate([gb[rng.integers(0, G, N)]
                             + rng.normal(0, 3, (N, 4))], 0)
        pb[:, 2:] = np.maximum(pb[:, 2:], pb[:, :2] + 1)
        preds.append(dict(
            boxes=pb.astype(np.float32),
            scores=np.round(rng.uniform(0, 1, N), 2).astype(np.float32),
            labels=rng.integers(0, NC, N), valid=rng.uniform(size=N) < 0.8,
            masks=rng.uniform(size=(N, 28, 28)).astype(np.float32)))
        gts.append(dict(boxes=gb.astype(np.float32), labels=gl, masks=gm,
                        valid=np.arange(G) < max(G - 1, 1)))
    return preds, gts


def test_ap_metrics_match_jax():
    preds, gts = _preds_and_gts(0)
    for thr in (0.5, 0.75):
        assert metrics.box_average_precision(preds, gts, thr, NC) == \
            jmetrics.box_average_precision(preds, gts, thr, NC)
    assert metrics.mask_average_precision(preds, gts, 0.5, NC) == \
        jmetrics.mask_average_precision(preds, gts, 0.5, NC)
    assert metrics.coco_map(preds, gts, NC) == jmetrics.coco_map(preds, gts,
                                                                 NC)
    m = preds[0]["masks"][0]
    for box in ([3.2, 4.7, 30.1, 22.9], [-10, -5, 12, 9], [40, 40, 90, 70],
                [60, 60, 70, 70]):
        np.testing.assert_array_equal(metrics.paste_mask(m, box, 48, 48),
                                      jmetrics.paste_mask(m, box, 48, 48))
    a, b = preds[0]["boxes"], gts[0]["boxes"]
    np.testing.assert_allclose(
        metrics.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmetrics.box_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("training", [True, False])
def test_lsj_and_loader_batches_equal_jax(training):
    ds, jds = (m.SyntheticDetectionDataset(6, 64, num_classes=NC)
               for m in (pdata, jdata))
    img, b, lbl, msk = ds.load(2)
    for seed in range(3):
        got = pdata.lsj_transform(img, b, lbl, msk, random.Random(seed), 48,
                                  (0.5, 1.5), training)
        want = jdata.lsj_transform(img, b, lbl, msk, random.Random(seed), 48,
                                   (0.5, 1.5), training)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    loaders = [m.DetectionLoader(d, batch_size=2, img_size=64, max_gt=MAX_GT,
                                 training=training, shuffle=training,
                                 num_workers=2, seed=3)
               for m, d in ((pdata, ds), (jdata, jds))]
    for epoch in (0, 1):
        for dl in loaders:
            dl.epoch = epoch
        batches = [list(dl) for dl in loaders]
        assert len(batches[0]) == len(batches[1]) == 3
        for g, w in zip(*batches):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A COCO layout: 3 images (one without annotations, one crowd-only),
    polygon annotations, categories with gaps in their ids."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    os.makedirs(root / "train2017")
    os.makedirs(root / "annotations")
    images, anns = [], []
    for i, (h, w) in enumerate([(40, 56), (64, 48), (30, 30), (50, 50)]):
        name = f"{i:06d}.{'jpg' if i % 2 else 'png'}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / "train2017" / name)
        images.append({"id": 10 + i, "file_name": name, "height": h,
                       "width": w})
    for k, (img, cat, crowd) in enumerate([(10, 3, 0), (10, 7, 0), (11, 1, 0),
                                           (12, 3, 1), (11, 7, 0)]):
        x, y = float(rng.uniform(1, 10)), float(rng.uniform(1, 10))
        poly = [x, y, x + 15, y, x + 12, y + 18, x, y + 10]
        anns.append({"id": k, "image_id": img, "category_id": cat,
                     "iscrowd": crowd, "bbox": [x, y, 15.0, 18.0],
                     "segmentation": [poly]})
    with open(root / "annotations" / "instances_train2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c} for c in (1, 3, 7)]}, f)
    return str(root)


def test_coco_reader_and_loader_match_jax(coco_dir):
    """The reader's remapped labels, boxes and rasterized polygons, and
    the loader built on the folder, equal JAX's; RLE raises."""
    args = (os.path.join(coco_dir, "train2017"),
            os.path.join(coco_dir, "annotations", "instances_train2017.json"))
    ds, jds = pdata.CocoDetectionDataset(*args), jdata.CocoDetectionDataset(
        *args)
    assert len(ds) == len(jds) == 2 and ds.num_classes == 3
    for i in range(len(ds)):
        for g, w in zip(ds.load(i), jds.load(i)):
            np.testing.assert_array_equal(g, w)
    got = pdata.create_detection_loader(coco_dir, "train", 2, 64, True,
                                        max_gt=MAX_GT, num_workers=1, seed=1)
    want = jdata.create_detection_loader(coco_dir, "train", 2, 64, True,
                                         max_gt=MAX_GT, num_workers=1, seed=1)
    assert isinstance(got.dataset, pdata.CocoDetectionDataset)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    ds.items[0][1][0]["segmentation"] = {"counts": "abc", "size": [40, 56]}
    with pytest.raises(NotImplementedError, match="RLE"):
        ds.load(0)


@pytest.mark.parametrize("name", DET_CONFIGS)
def test_det_configs_load_like_jax(name):
    assert len(DET_CONFIGS) == 4
    for overrides in ([], ["img_size=64", "det.rcnn_sample=16"]):
        got = pconfig.load_config(name, "detection", overrides)
        assert got == jconfig.load_config(name, "detection", overrides)
    if name != "vitdet_VimS_coco":
        assert got["layer_fused"] == "off"


# --- the CLI -----------------------------------------------------------------

@pytest.fixture
def tiny_cli_models(monkeypatch):
    """The registry's models at width 32 (full depth: ``out_indices``
    [23]), the detector's heads at 32 channels and fc 64."""
    for name, factory in list(preg._REGISTRY.items()):
        monkeypatch.setitem(preg._REGISTRY, name,
                            lambda f=factory, **kw: f(**dict(
                                kw, embed_dim=32)))
    monkeypatch.setattr(detection, "CascadeMaskRCNN", functools.partial(
        detection.CascadeMaskRCNN, fpn_channels=32))
    monkeypatch.setattr(detection, "Shared2FCBBoxHead", functools.partial(
        detection.Shared2FCBBoxHead, fc_out=64))
    monkeypatch.setattr(detection, "FCNMaskHead", functools.partial(
        detection.FCNMaskHead, channels=32))


def _cli(out, *more):
    return train_detection.main([
        "--config_name", "vitdet_FastVimT_coco", "--model_save_dir", str(out),
        "--device", "cpu", "--synthetic_samples", "2", *more,
        f"img_size={IMG}", "batch_size=1", "num_workers=1", f"max_gt={MAX_GT}",
        f"num_classes={NC}", "det.rpn_sample=16", "det.nms_pre=32",
        "det.num_proposals=16", "det.rcnn_sample=16", "warmup_iters=2"])


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_detection_resume_equals_uninterrupted(tmp_path,
                                                     tiny_cli_models):
    """Two epochs straight (2 steps each on 2 synthetic images), and one
    epoch then ``--resume`` to two: the same parameters bit for bit, the
    same AdamW count and log rows. Then ``--eval_only`` gives box and
    mask AP in [0, 1]."""
    straight = _cli(tmp_path / "straight", "--epochs", "2")
    _cli(tmp_path / "cut", "--epochs", "1")
    assert sorted(os.listdir(tmp_path / "cut" / "ckpt")) == ["step_2"]
    resumed = _cli(tmp_path / "cut", "--epochs", "2", "--resume")
    assert resumed.step == straight.step == 4
    assert resumed.tx.count == straight.tx.count == 4
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got, want = (_rows(tmp_path / d / "log.csv") for d in ("cut", "straight"))
    assert [r["epoch"] for r in got] == ["0", "1"]
    for g, w in zip(got, want):
        for k in ("train_loss", *(f"train_{n}" for n in
                                  detection.LOSS_NAMES)):
            assert g[k] == w[k], k
    assert resumed.model.backbone.embed_dim == 32
    assert len(resumed.model.backbone.layers) == 24
    shutil.rmtree(tmp_path / "straight")
    out = _cli(tmp_path / "cut", "--eval_only")
    assert set(out) == {"box_ap50", "mask_ap50"}
    assert all(0.0 <= v <= 1.0 for v in out.values())


def test_train_detection_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_detection.main(["--config_name", "vitdet_FastVimT_coco"])
