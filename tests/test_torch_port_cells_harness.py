"""The port's cell-imaging harness against the JAX package, on the CPU:
``split_indices`` and ``cell_augment`` bitwise on the same draws, the
``CellLoader`` bitwise over two epochs (both loaders on their Python
path: ``fastvim_tpu.native.available`` and the port's
``fastvim_tpu_torch.native.available`` patched to False there only;
tests/test_torch_port_native.py holds the native path), a
CSV manifest read without pandas, the eight cells configs, one
supervised train step with ``channel_model=True`` against the JAX step
(AdamW with the cosine weight-decay schedule), and the ``train_cells``
CLI: a run resumed after one epoch equals an uninterrupted one, HCS
draws included, and it takes the card unless asked for the CPU.

The CLI runs the registry's models cut to depth 2, width 64, at img 32
on 16 synthetic images (batch 4: 4 steps an epoch).
"""

import csv
import os
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvim_tpu.native
import fastvim_tpu_torch.native
from fastvim_tpu import config as jconfig
from fastvim_tpu.data import cells as jcells
from fastvim_tpu.models import channel as jchannel
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu_torch import config as pconfig
from fastvim_tpu_torch.cli import train_cells
from fastvim_tpu_torch.data import cells as pcells
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.models.channel import ChannelVisionMamba
from fastvim_tpu_torch.train import (
    TrainState,
    cosine_with_warmup,
    make_optimizer,
    make_supervised_eval_step,
    make_supervised_train_step,
)
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

MEAN = [1.0, 2.0, 0.5, -1.0, 3.0]
STD = [2.0, 1.5, 1.0, 4.0, 0.5]


# --- splits, augmentation and the loader ----------------------------------

def test_split_indices_match_jax():
    for n in (10, 37, 161):
        for seed in (0, 42):
            parts = [pcells.split_indices(n, s, seed)
                     for s in ("train", "val", "test")]
            for got, s in zip(parts, ("train", "val", "test")):
                assert np.array_equal(got, jcells.split_indices(n, s, seed))
            assert sorted(np.concatenate(parts)) == list(range(n))
    with pytest.raises(ValueError):
        pcells.split_indices(10, "holdout")


@pytest.mark.parametrize("training", [True, False])
def test_cell_augment_bitwise(training):
    """Images smaller, equal and larger than the crop, with and without
    normalization, each from one random.Random seed on both sides."""
    arr_rng = np.random.default_rng(1)
    for i, (hw, size) in enumerate([(32, 32), (40, 32), (24, 32)] * 3):
        arr = arr_rng.standard_normal((hw, hw, 5)).astype(np.float32)
        norm = (dict(mean=np.asarray(MEAN, np.float32),
                     std=np.asarray(STD, np.float32)) if i % 2 else {})
        got = pcells.cell_augment(arr, random.Random(i), size,
                                  training=training, **norm)
        want = jcells.cell_augment(arr, random.Random(i), size,
                                   training=training, **norm)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), (hw, size)


@pytest.mark.parametrize("training", [True, False])
def test_cell_loader_bitwise_over_two_epochs(monkeypatch, training):
    """Two epochs of the port's loader against the JAX loader, both on
    their Python path (both packages' native libraries reported absent);
    and a fresh loader set to epoch 1 (a resumed run) gives the second
    epoch again."""
    monkeypatch.setattr(fastvim_tpu.native, "available", lambda: False)
    monkeypatch.setattr(fastvim_tpu_torch.native, "available",
                        lambda library="augment": False)
    kw = dict(batch_size=4, size=32, training=training, seed=3, mean=MEAN,
              std=STD)
    got = pcells.CellLoader(pcells.SyntheticCellDataset(10, 32, 5, 7), **kw)
    want = jcells.CellLoader(jcells.SyntheticCellDataset(10, 32, 5, 7), **kw)
    assert len(got) == len(want) == 2
    epochs = []
    for _ in range(2):
        batches = list(got)
        epochs.append(batches)
        wbatches = list(want)
        assert len(batches) == len(wbatches) == 2
        for b, w in zip(batches, wbatches):
            assert set(b) == set(w) == {"image", "label"}
            assert b["image"].dtype == np.float32
            assert b["label"].dtype == np.int64
            assert np.array_equal(b["image"], w["image"])
            assert np.array_equal(b["label"], w["label"])
    resumed = pcells.CellLoader(pcells.SyntheticCellDataset(10, 32, 5, 7),
                                **kw)
    resumed.epoch = 1
    for b, w in zip(resumed, epochs[1]):
        assert np.array_equal(b["image"], w["image"])


def _manifest(tmp_path, n=10):
    rows = []
    rng = np.random.default_rng(2)
    for i in range(n):
        arr = rng.standard_normal((16, 16, 3)).astype(np.float32)
        if i % 2:
            arr = arr.transpose(2, 0, 1)  # some crops stored CHW
        path = str(tmp_path / f"crop{i}.npy")
        np.save(path, arr)
        rows.append({"path": path, "label": (3 * i) % 5})
    rows.append({"path": str(tmp_path / "missing.npy"), "label": 1})
    csv_path = tmp_path / "manifest.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "label"])
        w.writeheader()
        w.writerows(rows)
    return str(csv_path)


def test_csv_manifest_without_pandas(tmp_path, monkeypatch):
    """The port reads a CSV manifest with pandas unimportable and gives
    the JAX dataset's splits, arrays (CHW crops turned HWC), labels and
    class count; a missing file is dropped after its retries; a parquet
    manifest asks for pandas."""
    path = _manifest(tmp_path)
    want = {s: jcells.CellDataset(path, s, seed=5, retry_wait=0.0)
            for s in ("train", "val", "test")}
    monkeypatch.setitem(sys.modules, "pandas", None)
    for split, w in want.items():
        got = pcells.CellDataset(path, split, seed=5, retry_wait=0.0)
        assert len(got) == len(w) and got.num_classes == w.num_classes == 5
        for i in range(len(got)):
            g, ww = got.load(i), w.load(i)
            if ww is None:
                assert g is None
            else:
                assert g[1] == ww[1] and np.array_equal(g[0], ww[0])
                assert g[0].shape == (16, 16, 3)
    with pytest.raises(ImportError, match="needs pandas"):
        pcells.CellDataset(str(tmp_path / "manifest.parquet"))


CELLS_CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(pconfig.CONFIG_ROOT, "cells")))


@pytest.fixture
def tiny_port_models(monkeypatch):
    """The port's registry models at depth 2, width 64."""
    for name, factory in list(preg._REGISTRY.items()):
        monkeypatch.setitem(preg._REGISTRY, name,
                            lambda f=factory, **kw: f(**dict(
                                kw, depth=2, embed_dim=64)))


@pytest.mark.parametrize("name", CELLS_CONFIGS)
def test_cells_configs_load_like_jax_and_build(name, tiny_port_models):
    assert len(CELLS_CONFIGS) == 8
    over = ["batch_size=8", "img_size=32", "data.manifest=/data/m.csv"]
    for overrides in ([], over):
        got = pconfig.load_config(name, "cells", overrides)
        assert got == jconfig.load_config(name, "cells", overrides)
    cfg = pconfig.load_config(name, "cells", over)
    model = train_cells.create_channel_model(cfg, torch.device("cpu"))
    assert isinstance(model, ChannelVisionMamba)
    # the config's fields override the registry's: ChannelVimS.yaml's
    # unpooled baseline trains mean-pooled
    assert model.layers[0].mixer.collapse_method == cfg["collapse_method"]
    assert model.patch_size == cfg["patch_size"]
    x = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        out = model(x, torch.tensor([0, 4, 7]))
    assert out.shape == (2, 161) and torch.isfinite(out).all()


# --- the train step -------------------------------------------------------

TINY = dict(img_size=16, patch_size=8, depth=2, embed_dim=32, channels=5,
            num_classes=7, drop_path_rate=0.0, ssm_cfg=dict(d_state=4))


def test_channel_train_step_matches_jax():
    """Two steps of make_supervised_train_step(channel_model=True) on a
    batch of 3 of 5 channels, from one set of weights: the losses, and
    the parameters after AdamW with the learning rate and the weight
    decay both on cosine schedules, within 1e-4."""
    rng = np.random.default_rng(3)
    chans = [0, 2, 4]
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    labels = np.array([1, 6])
    ids = np.asarray(chans, np.int32)
    model = ChannelVisionMamba(**TINY)
    model.reset_parameters(torch.Generator().manual_seed(4))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}))

    lr = (2e-3, 1e-5, 10, 2, 5e-4)
    wd = (0.04, 0.4, 10)
    jmodel = jchannel.ChannelVisionMamba(**TINY, scan_impl="ref")
    jtx = joptim.make_optimizer(jsched.cosine_with_warmup(*lr),
                                params=params,
                                wd_schedule=jsched.cosine_with_warmup(*wd))
    jstate = JaxTrainState.create(params, jtx, ema=False)
    jstep = jax_make_train_step(jmodel, 7, label_smoothing=0.0,
                                ema_decay=None, channel_model=True)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(labels),
              "channel_ids": jnp.asarray(ids)}
    jlosses = []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        jlosses.append(float(m["train_loss"]))

    tx = make_optimizer(cosine_with_warmup(*lr), params=model,
                        wd_schedule=cosine_with_warmup(*wd))
    state = TrainState.create(model, tx, ema=False)
    step = make_supervised_train_step(model, 7, label_smoothing=0.0,
                                      ema_decay=None, channel_model=True)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels),
             "channel_ids": torch.from_numpy(ids)}
    losses = [step(state, batch)[1]["train_loss"].item() for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = from_jax_params(jstate.params)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # the eval step passes the ids too: all 5 channels differ from 3
    ev = make_supervised_eval_step(model, channel_model=True)
    assert ev(batch)["loss"].item() != ev(
        {"image": torch.from_numpy(rng.standard_normal(
            (2, 16, 16, 5)).astype(np.float32)),
         "label": batch["label"]})["loss"].item()


# --- the CLI --------------------------------------------------------------

def test_hcs_loader_draws_as_jax_and_resumes():
    """The wrapper's channel subsets are the JAX CLI's stream
    (hcs_sample of default_rng(seed).integers(2³¹), one a training
    batch); a fresh wrapper set to epoch 1 continues that stream."""
    ds = pcells.SyntheticCellDataset(8, 16, 8, 7)
    loader = train_cells.HCSLoader(pcells.CellLoader(ds, 2, 16), 8, 5)
    jrng = np.random.default_rng(5)
    epochs = []
    for epoch in range(2):
        loader.epoch = epoch
        epochs.append([b["channel_ids"].tolist() for b in loader])
    want = [jchannel.hcs_sample(int(jrng.integers(2 ** 31)), 8)
            for _ in range(8)]
    assert epochs[0] + epochs[1] == want
    resumed = train_cells.HCSLoader(pcells.CellLoader(ds, 2, 16), 8, 5)
    resumed.epoch = 1
    batches = list(resumed)
    assert [b["channel_ids"].tolist() for b in batches] == epochs[1]
    assert batches[0]["image"].shape[-1] == len(epochs[1][0])
    assert resumed.loader.epoch == 2
    off = train_cells.HCSLoader(pcells.CellLoader(ds, 2, 16), 8, None)
    assert all("channel_ids" not in b and b["image"].shape[-1] == 8
               for b in off)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_cells_resume_equals_uninterrupted(tmp_path, tiny_port_models):
    """FastChannelVimS.yaml for 2 epochs straight, and the same run cut
    after its first epoch (its directory with only the step-4 checkpoint)
    and resumed: the same parameters bit for bit, AdamW count, steps and
    log, so the resumed epoch drew the HCS subsets, DropPath masks and
    batches of the uninterrupted one."""
    run = lambda out, *more: train_cells.main(
        ["--config_name", "FastChannelVimS", "--model_save_dir",
         str(tmp_path / out), "--synthetic_samples", "16", "--device", "cpu",
         *more, "img_size=32", "batch_size=4", "training_epochs=2",
         "warmup_epochs=1"])
    straight = run("straight")
    shutil.copytree(tmp_path / "straight", tmp_path / "cut")
    os.remove(tmp_path / "cut" / "ckpt" / "step_8")
    resumed = run("cut", "--resume")
    assert resumed.step == straight.step == 8
    assert resumed.tx.count == straight.tx.count == 8
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got, want = (_rows(tmp_path / d / "log.csv") for d in ("cut", "straight"))
    assert [r["epoch"] for r in got] == ["0", "1"]
    for g, w in zip(got, want):
        for c in ("train_loss", "grad_norm", "val_loss", "val_acc"):
            assert np.isfinite(float(g[c])) and g[c] == w[c], c


def test_train_cells_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cells.main(["--config_name", "FastChannelVimS"])
