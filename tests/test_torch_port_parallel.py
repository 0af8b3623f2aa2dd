"""The port's data parallelism (fastvim_tpu_torch.parallel) on the CPU:
two gloo ranks, spawned with file stores, against the JAX package on a
2-device mesh and against one process over the same global batch.

* which rows each rank holds, and which leaves are kept whole, against
  JAX's ``shard_batch``; the loaders' and the device pipeline's rows;
* a supervised AdamW step (no mixup, no DropPath) on 2 ranks against
  JAX's ``make_supervised_train_step`` over 2 devices, from the same
  weights (the port's, through ``to_jax_params``): the loss to rtol
  1e-4, the parameters and the EMA to rtol = atol = 1e-4
  (tests/test_torch_port_train.py's tolerances: fp32, the same
  arithmetic in another order);
* the bf16 gradient all-reduce against JAX's ``make_compressed_grads_fn``
  over 2 devices: within 2⁻⁷ (a bf16 rounding) of each gradient's largest
  entry, and measurably off the fp32 all-reduce;
* 2 ranks against 1 process on the same global batch and seeds, to 1e-5
  (fp32 sums in another order), the parameters bitwise equal across
  ranks: mixup + cutmix + DropPath through the fused layer's adjoint and
  through remat, MAE, ChannelVim with channel ids,
  UperNet with BatchNorm (running statistics included) and a detection
  step (SGD, so that the parameters after the step compare gradients);
* ``train_classification digits64`` on 2 ranks joined from a
  torchrun-like env: one ``log.csv``, the checkpoint equal to one
  process's;
* ``dryrun_multichip(2, device="cpu")``.

The ranks run every scenario in one spawn (tests/torch_parallel_ranks.py,
which imports no JAX), once a module.
"""

import csv
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.parallel.mesh import shard_batch as jax_shard_batch
from fastvim_tpu.train import mixup as jmixup
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_compressed_grads_fn,
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.parallel import Mesh, shard_batch
from fastvim_tpu_torch.parallel import mesh as pmesh
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

import torch_parallel_ranks as ranks

B = 4  # the global batch: 2 rows a rank
SCENARIOS = list(ranks.SCENARIOS)
EQUAL_TO_ONE = ("mixup", "remat", "mae", "cells", "upernet", "detection")
DIGITS = ["--config_name", "digits64", "--device", "cpu", "--epochs", "1",
          "img_size=16", "batch_size=256"]


def _jax_model():
    kw = dict(ranks.VIM, drop_path_rate=0.0)
    return jax_create_model("fastvim_tiny", layer_fused="off",
                            scan_impl="ref", **kw)


def _inputs():
    rng = np.random.default_rng(0)
    seg_labels = rng.integers(0, 6, (B, 32, 32))
    seg_labels[rng.random(seg_labels.shape) < 0.3] = 255  # ignored pixels
    from fastvim_tpu_torch.data.detection import create_detection_loader

    det = next(iter(create_detection_loader(
        None, "train", 2, 64, training=True, max_gt=4, synthetic_samples=2,
        num_classes=3, num_workers=1)))
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, ranks.CLASSES, B)}
    weights = ranks.init_weights()
    jparams = jax.tree_util.tree_map(
        jnp.asarray, to_jax_params(weights["supervised"]))
    return jparams, {
        "weights": weights, "batch": batch,
        "cells": {"image": rng.standard_normal((B, 16, 16, 3)).astype(
            np.float32), "label": rng.integers(0, 7, B),
            "channel_ids": np.array([0, 2, 4])},
        "seg": {"image": rng.standard_normal((B, 32, 32, 3)).astype(
            np.float32), "label": seg_labels},
        "det": det}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as each rank has: the steps here are small, and
    more threads only contend (several test processes share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX params, inputs, one process's results, the 2 ranks' results,
    the digits run's folders)."""
    jparams, inputs = _inputs()
    tmp = tmp_path_factory.mktemp("parallel")
    two_dir, one_dir = str(tmp / "two"), str(tmp / "one")
    inputs["argv"] = DIGITS + ["--model_save_dir", two_dir]
    # the ranks join the CLI's group as torchrun's workers do: through a
    # store that the launcher hosts, here on a port the OS picks as it
    # binds, so that no other process can take it first
    store = torch.distributed.TCPStore("localhost", 0, is_master=True,
                                       wait_for_workers=False)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(store.port),
           "TORCHELASTIC_USE_AGENT_STORE": "True"}

    def one_process():
        """The same work here, while the ranks run."""
        from fastvim_tpu_torch.cli import train_classification

        here = ranks.run_here(EQUAL_TO_ONE, inputs)
        with pytest.MonkeyPatch.context() as mp:
            for name, factory in list(preg._REGISTRY.items()):
                mp.setitem(preg._REGISTRY, name,
                           lambda f=factory, **kw: f(**dict(
                               kw, depth=2, embed_dim=64)))
            state = train_classification.main(
                DIGITS + ["--model_save_dir", one_dir])
        return here, state

    two, (here, state) = ranks.spawn(2, SCENARIOS, inputs, str(tmp),
                                     env=env, meanwhile=one_process)
    return jparams, inputs, here, two, state, (one_dir, two_dir)


def _flat(tensors, keys):
    return np.concatenate([np.ravel(tensors[k]).astype(np.float64)
                           for k in keys])


def _close(got, want, tol, what):
    """Every entry within tol + tol·|want| (checked on the flattened
    tensors at once; on failure tensor by tensor, to name it)."""
    keys = sorted(want)
    assert sorted(got) == keys, what
    g, w = _flat(got, keys), _flat(want, keys)
    if not np.all(np.abs(g - w) <= tol + tol * np.abs(w)):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=f"{what} {k}")


def _ranks_equal(two, name, key="params"):
    a, b = two[0][name][key], two[1][name][key]
    keys = sorted(a)
    assert np.array_equal(_flat(a, keys), _flat(b, keys)), (
        f"{name} {key}: the ranks differ")


def _jax_mesh():
    return JaxMesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                   ("data", "seq"))


def test_shard_batch_rows_match_jax():
    """Each rank's rows are the ones JAX's shard_batch places on its
    device; a leaf the world size does not divide, and the channel ids
    whatever their length, are held whole."""
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((6, 4, 4, 3)).astype(np.float32),
             "label": np.arange(6), "channel_ids": np.array([1, 3, 4]),
             "odd": np.arange(5)}
    placed = jax_shard_batch(batch, _jax_mesh())
    for rank in range(2):
        got = shard_batch(batch, Mesh(2, rank))
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
        assert got["image"].shape[0] == 3 and got["odd"].shape[0] == 5
    # four channel ids split over two devices in JAX, whole here
    four = shard_batch({"channel_ids": np.arange(4)}, Mesh(2, 1))
    np.testing.assert_array_equal(four["channel_ids"], np.arange(4))
    # without a 2-rank group, a seq axis of 2 names the ranks it needs
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.make_mesh(seq=2)


def test_loaders_give_each_rank_its_rows(monkeypatch, tmp_path):
    """A shuffled (training) loader gives rank r rows [2r, 2r+2) of each
    global batch of 4, bitwise as one process decodes them (the PIL
    loader, the MAE recipe's native augment, the native JPEG decode of
    an ImageFolder, CellLoader's native cell augment); an eval loader
    deals whole batches round-robin; the device pipeline's augment draws
    are the global batch's rows."""
    from PIL import Image

    from fastvim_tpu_torch import native
    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.data.cells import CellLoader, SyntheticCellDataset
    from fastvim_tpu_torch.data.device import make_device_augment
    from fastvim_tpu_torch.data.loader import NativeJpegDataLoader

    rng = np.random.default_rng(2)
    for i in range(8):
        os.makedirs(tmp_path / "train" / f"c{i % 2}", exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
                        ).save(tmp_path / "train" / f"c{i % 2}" / f"{i}.jpg")

    def loaders():
        return {
            "jpeg": create_imagenet_loader(str(tmp_path), "train", 4, 16,
                                           True, mae=True, num_workers=2,
                                           seed=3),
            "pil": create_imagenet_loader(None, "train", 4, 16, True,
                                          num_workers=2, seed=3,
                                          synthetic_samples=8),
            "mae": create_imagenet_loader(None, "train", 4, 16, True,
                                          mae=True, num_workers=2, seed=3,
                                          synthetic_samples=8),
            "cells": CellLoader(SyntheticCellDataset(8, 16, 4, 5), 4, 16,
                                seed=3, mean=[0.1] * 4, std=[2.0] * 4),
            "eval": create_imagenet_loader(None, "val", 2, 16, False,
                                           synthetic_samples=8)}

    augment = make_device_augment(16)
    u8 = torch.randint(0, 256, (4, 8, 8, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    seen = {}
    for rank in (None, 0, 1):
        if rank is not None:
            monkeypatch.setattr(pmesh, "_MESH", Mesh(2, rank, "gloo"))
        out = {k: list(v) for k, v in loaders().items()}
        rows = slice(None) if rank is None else slice(2 * rank, 2 * rank + 2)
        out["device"] = [augment(u8[rows],
                                 torch.Generator().manual_seed(4))]
        seen[rank] = out
    assert isinstance(loaders()["jpeg"], NativeJpegDataLoader) == \
        native.available("decode")
    for name in ("jpeg", "pil", "mae", "cells"):
        for b, whole in enumerate(seen[None][name]):
            for rank in (0, 1):
                part = seen[rank][name][b]
                for k in whole:
                    np.testing.assert_array_equal(
                        part[k], whole[k][2 * rank:2 * rank + 2],
                        err_msg=f"{name} batch {b} rank {rank} {k}")
    for rank in (0, 1):
        assert len(seen[rank]["eval"]) == 2
        for b, part in enumerate(seen[rank]["eval"]):
            np.testing.assert_array_equal(
                part["image"], seen[None]["eval"][2 * b + rank]["image"])
        torch.testing.assert_close(
            seen[rank]["device"][0],
            seen[None]["device"][0][2 * rank:2 * rank + 2], rtol=0, atol=0)


def test_supervised_step_matches_jax_on_two_devices(runs):
    jparams, inputs, _, two, _, _ = runs
    jmodel = _jax_model()
    jtx = joptim.make_optimizer(
        jsched.cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4), weight_decay=0.05,
        params=jparams)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, jparams),
                                  jtx, ema=True)
    jstep = jax_make_train_step(jmodel, ranks.CLASSES, label_smoothing=0.1,
                                ema_decay=0.9)
    jstate, m = jstep(jstate, jax_shard_batch(inputs["batch"], _jax_mesh()),
                      jax.random.PRNGKey(0))
    for rank in (0, 1):
        got = two[rank]["supervised"]
        np.testing.assert_allclose(got["metrics"]["train_loss"],
                                   float(m["train_loss"]), rtol=1e-4)
        want = from_jax_params(jstate.params)
        assert sorted(got["params"]) == sorted(want)
        _close(got["params"], want, 1e-4, "params")
        _close(got["ema"], from_jax_params(jstate.ema_params), 1e-4, "ema")
    _ranks_equal(two, "supervised")
    _ranks_equal(two, "supervised", "ema")


def test_bf16_allreduce_matches_jax_compressed_grads(runs):
    jparams, inputs, _, two, _, _ = runs
    jmodel = _jax_model()

    def loss_fn(params, batch, rng):
        logits = jmodel.apply(params, batch["image"], deterministic=True)
        loss = jmixup.soft_target_cross_entropy(
            logits, jmixup.one_hot_smooth(batch["label"], ranks.CLASSES,
                                          0.1))
        return loss, loss

    grads_fn = jax.jit(make_compressed_grads_fn(
        loss_fn, _jax_mesh(), jnp.bfloat16, batch_spec=P("data")))
    _, jgrads = grads_fn(jparams, jax_shard_batch(inputs["batch"],
                                                  _jax_mesh()),
                         jax.random.PRNGKey(0))
    want = from_jax_params(jgrads)
    got = two[0]["compressed_grads"]
    off = 0.0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got["bf16"][k] - w).max())
        assert err <= 2.0 ** -7 * scale, (k, err, scale)
        off = max(off, float(np.abs(got["bf16"][k] - got["fp32"][k]).max())
                  / max(float(np.abs(got["fp32"][k]).max()), 1e-30))
    assert off > 1e-4, off  # bf16 keeps 8 bits: the rounding shows
    _ranks_equal(two, "compressed_grads", "bf16")


@pytest.mark.parametrize("name", EQUAL_TO_ONE)
def test_two_ranks_equal_one_process(runs, name):
    _, _, here, two, _, _ = runs
    want = here[name]
    for rank in (0, 1):
        got = two[rank][name]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=f"{name} rank {rank} {k}")
        _close(got["params"], want["params"], 1e-5, f"{name} rank {rank}")
        if "ema" in want:
            _close(got["ema"], want["ema"], 1e-5, f"{name} ema")
    _ranks_equal(two, name)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cli_digits_on_two_ranks_equals_one(runs):
    """train_classification digits64 (the device-resident path, 5 steps of
    a global batch of 256) on 2 ranks joined from a torchrun-like env, and
    in one process: one log.csv with one row, and the final parameters
    and EMA copy (and the saved checkpoint) within 1e-5, equal on both
    ranks."""
    from fastvim_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )

    _, _, _, two, state, (one_dir, two_dir) = runs
    assert state.step == two[0]["cli_digits"]["step"] == 1497 // 256
    [row] = _rows(os.path.join(two_dir, "log.csv"))
    [want_row] = _rows(os.path.join(one_dir, "log.csv"))
    for k in ("train_loss", "grad_norm", "val_loss", "val_acc",
              "val_loss_ema", "val_acc_ema"):
        assert math.isclose(float(row[k]), float(want_row[k]), rel_tol=1e-4,
                            abs_tol=1e-6), k
    ckpt = restore_checkpoint(latest_checkpoint(os.path.join(two_dir,
                                                             "ckpt")))
    for key, want in (("params", state.model.state_dict()),
                      ("ema", state.ema_params)):
        got = two[0]["cli_digits"][key]
        _close(got, {k: v.numpy() for k, v in want.items()}, 1e-5, key)
        saved = ckpt["params" if key == "params" else "ema_params"]
        _close({k: v.numpy() for k, v in saved.items()}, got, 0.0, key)
    _ranks_equal(two, "cli_digits")
    _ranks_equal(two, "cli_digits", "ema")


def test_dryrun_multichip_two_ranks(capfd):
    from fastvim_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    losses = re.findall(r"dryrun_multichip\(2\) (?:step|fused layer): "
                        r"mesh=\{'data': 2, 'seq': 1\} loss=(\S+) step=1",
                        out)
    assert len(losses) == 2, out
    assert all(math.isfinite(float(v)) for v in losses), losses
