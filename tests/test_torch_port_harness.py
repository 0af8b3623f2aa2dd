"""The port's classification harness against the JAX package, on the CPU:
the config loader, the TensorBoard writer, the epoch loop end to end
(both packages from one set of weights on the same batches), resume
through the port's CLI, ``remat``, a JAX checkpoint evaluated by the
port's test CLI, the state_dict names the torch reference uses, and the
CLIs' device rule.

Models are cut to img 32, patch 8, depth 2, embed 64 (the registries are
patched, as tests/test_cli.py does for the JAX package); the synthetic
dataset's labels run to 1000, so the heads have 1000 classes.
"""

import ast
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fastvim_tpu import config as jconfig
from fastvim_tpu.data import create_imagenet_loader as jax_loader
from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.loop import run_training as jax_run_training
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_supervised_eval_step as jax_make_eval_step,
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu.utils import tboard as jtboard
from fastvim_tpu.utils.torch_convert import (
    convert_vision_mamba,
    export_vision_mamba,
)
from fastvim_tpu_torch import config as pconfig
from fastvim_tpu_torch.cli import test_classification, train_classification
from fastvim_tpu_torch.data import create_imagenet_loader
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.train import (
    TrainState,
    cosine_with_warmup,
    make_optimizer,
    make_supervised_eval_step,
    make_supervised_train_step,
)
from fastvim_tpu_torch.train.loop import run_training
from fastvim_tpu_torch.utils import from_jax_params
from fastvim_tpu_torch.utils import tboard as ptboard

TINY = dict(depth=2, embed_dim=64)
IMG, PATCH, CLASSES = 32, 8, 1000
COLUMNS = ("train_loss", "grad_norm", "val_loss", "val_acc", "val_loss_ema",
           "val_acc_ema")


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _tiny_config(tmp_path, **over):
    cfg = {
        "task": "classification", "seed": 0, "model": "fastvim_tiny",
        "num_classes": CLASSES, "img_size": IMG, "patch_size": PATCH,
        "channels": 3, "drop_path_rate": 0.2, "batch_size": 4,
        "num_workers": 2, "training_epochs": 2, "warmup_epochs": 0,
        "lr": 1e-3, "warmup_initial_lr": 1e-4, "min_lr": 1e-5,
        "scaling_rule": "none", "weight_decay": 0.05,
        "use_ema_weights": True, "ema_decay": 0.9, "label_smoothing": 0.1,
        "mixup": 0.8, "cutmix": 1.0,
        "data": {"dir": None, "img_size": "${img_size}"}}
    cfg.update(over)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path)


@pytest.fixture
def tiny_port_models(monkeypatch):
    """The port's registry models at depth 2, width 64."""
    for name, factory in list(preg._REGISTRY.items()):
        monkeypatch.setitem(preg._REGISTRY, name,
                            lambda f=factory, **kw: f(**dict(kw, **TINY)))


@pytest.fixture
def tiny_jax_models(monkeypatch):
    """The JAX package's registry models at depth 2, width 64, patch 8."""
    from fastvim_tpu.models import registry as jreg
    from fastvim_tpu.models.vision_mamba import VisionMamba

    def tiny(**kw):
        kw.update(TINY)
        kw.setdefault("patch_size", PATCH)
        return VisionMamba(**{k: v for k, v in kw.items()
                              if k in VisionMamba.__dataclass_fields__})

    for name in list(jreg._REGISTRY):
        monkeypatch.setitem(jreg._REGISTRY, name, tiny)


# --- (a) configs ----------------------------------------------------------

CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(pconfig.CONFIG_ROOT, "classification")))


@pytest.mark.parametrize("overrides", [
    [], ["batch_size=8", "lr=0.01", "img_size=64", "data.re_prob=0.5",
         "data.dir=/data/imagenet", "mixup=null", "use_ema_weights=false",
         "data.auto_augment=none"]])
@pytest.mark.parametrize("name", CONFIGS)
def test_config_loader_matches_jax(name, overrides):
    """Every classification YAML of the port loads to the JAX package's
    dict, with and without overrides (interpolation follows them)."""
    assert CONFIGS == ["FastVimB", "FastVimS", "FastVimT", "VimB",
                       "digits64"]
    got = pconfig.load_config(name, "classification", overrides)
    want = jconfig.load_config(name, "classification", overrides)
    assert got == want
    assert got["data"]["img_size"] == got["img_size"]


# --- (b) TensorBoard -------------------------------------------------------

def test_tboard_event_files_bytewise_equal_jax(tmp_path, monkeypatch):
    """The same scalars give the same event file, byte for byte, with the
    wall time and host name pinned."""
    for mod in (jtboard, ptboard):
        monkeypatch.setattr(mod.time, "time", lambda: 1234567890.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    rows = [(0, {"epoch": 0, "steps": 4, "train_loss": 6.5,
                 "val_acc": np.float32(0.125), "flag": True, "tag": "x"}),
            (8, {"train_loss": torch.tensor(2.75), "lr": 1e-3})]
    files = []
    for mod, sub in ((jtboard, "jax"), (ptboard, "port")):
        with mod.SummaryWriter(str(tmp_path / sub)) as w:
            for step, row in rows:
                w.add_scalars(step, {k: (float(v) if mod is jtboard and
                                         torch.is_tensor(v) else v)
                                     for k, v in row.items()})
        [f] = os.listdir(tmp_path / sub)
        files.append((f, (tmp_path / sub / f).read_bytes()))
    assert files[0] == files[1]
    assert len(files[0][1]) > 100


# --- (f) the loop end to end ----------------------------------------------

def test_run_training_matches_jax(tmp_path):
    """run_training in both packages, 2 epochs × 2 steps, from the JAX
    init's weights on the same synthetic batches, mixup off, no drop path,
    EMA 0.99 (both packages' loaders on PIL: the supervised recipe and a
    synthetic eval take no native path): every CSV column to 1e-4
    relative, the final parameters
    and EMA copy to 1e-4 of the largest entry of each tree. (Per tensor
    that is too tight for AdamW: an entry whose gradient is near zero
    moves by lr · m / (√v + eps), which the order of fp32 sums decides.)"""
    kw = dict(img_size=IMG, patch_size=PATCH, num_classes=CLASSES,
              drop_path_rate=0.0, **TINY)
    sched = dict(base_value=2e-3, final_value=1e-5, total_steps=4,
                 warmup_steps=1)
    loaders = lambda make: (
        make(None, "train", 4, IMG, training=True, num_workers=2, seed=0,
             synthetic_samples=8),
        make(None, "val", 4, IMG, training=False, synthetic_samples=8))

    jmodel = jax_create_model("fastvim_tiny", layer_fused="off",
                              scan_impl="ref", **kw)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((2, IMG, IMG, 3), jnp.float32))
    jtx = joptim.make_optimizer(jsched.cosine_with_warmup(**sched),
                                weight_decay=0.05, params=params)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  jtx, ema=True)
    jtrain, jval = loaders(jax_loader)
    jstate = jax_run_training(
        state=jstate, train_step=jax_make_train_step(
            jmodel, CLASSES, label_smoothing=0.1, ema_decay=0.99),
        train_loader=jtrain, epochs=2, rng=jax.random.PRNGKey(0),
        eval_step=jax_make_eval_step(jmodel), eval_loader=jval,
        save_dir=str(tmp_path / "jax"))

    model = create_model("fastvim_tiny", device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in from_jax_params(params).items()})
    tx = make_optimizer(cosine_with_warmup(**sched), weight_decay=0.05,
                        params=model)
    state = TrainState.create(model, tx, ema=True)
    ptrain, pval = loaders(create_imagenet_loader)
    state = run_training(
        state=state, train_step=make_supervised_train_step(
            model, CLASSES, label_smoothing=0.1, ema_decay=0.99),
        train_loader=ptrain, epochs=2,
        eval_step=make_supervised_eval_step(model), eval_loader=pval,
        save_dir=str(tmp_path / "port"))
    assert state.step == int(jstate.step) == 4

    got = _read_csv(tmp_path / "port" / "log.csv")
    want = _read_csv(tmp_path / "jax" / "log.csv")
    assert set(got[0]) == set(want[0])  # jit returns metrics by sorted key
    assert [r["epoch"] for r in got] == ["0", "1"]
    for g, w in zip(got, want):
        assert g["steps"] == w["steps"] == "2"
        np.testing.assert_allclose([float(g[c]) for c in COLUMNS],
                                   [float(w[c]) for c in COLUMNS],
                                   rtol=1e-4)
    for ours, theirs in ((model.state_dict(), jstate.params),
                         (state.ema_params, jstate.ema_params)):
        theirs = from_jax_params(theirs)
        assert set(ours) == set(theirs)
        top = max(np.abs(v).max() for v in theirs.values())
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k].detach().numpy(), v, rtol=0,
                                       atol=1e-4 * top, err_msg=k)
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == [
        "step_2", "step_4"]
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "port" / "tb"))


# --- (g) resume through the CLI -------------------------------------------

def test_cli_resume_equals_uninterrupted_run(tmp_path, tiny_port_models):
    """1 epoch, then --resume to 2, against 2 epochs straight, through the
    port's CLI with mixup and drop path on: the same parameters, EMA and
    optimizer step, and a log of two rows with the same numbers. The
    warmup spans both epochs, so that --epochs 1, which stands in for a
    run cut after its first epoch, leaves the LR schedule as it is."""
    cfg = _tiny_config(tmp_path, warmup_epochs=2)
    run = lambda out, *more: train_classification.main(
        ["--config_name", cfg, "--model_save_dir", str(tmp_path / out),
         "--synthetic_samples", "8", "--device", "cpu", *more])
    first = run("cut", "--epochs", "1")
    assert first.step == 2
    resumed = run("cut", "--resume")
    straight = run("straight")
    assert resumed.step == straight.step == 4
    for a, b in ((resumed.model.state_dict(), straight.model.state_dict()),
                 (resumed.ema_params, straight.ema_params)):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)
    assert resumed.tx.count == straight.tx.count == 4
    got = _read_csv(tmp_path / "cut" / "log.csv")
    want = _read_csv(tmp_path / "straight" / "log.csv")
    assert [r["epoch"] for r in got] == ["0", "1"]
    for g, w in zip(got, want):
        np.testing.assert_allclose([float(g[c]) for c in COLUMNS],
                                   [float(w[c]) for c in COLUMNS],
                                   rtol=1e-6)


def test_checkpoint_round_trip_and_pruning(tmp_path, tiny_port_models):
    """A checkpoint restores the parameters, the EMA copy, the AdamW
    moments, the update count and the step exactly, loads with
    weights_only, and only the newest five are kept."""
    from fastvim_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )

    def fresh():
        model = create_model("fastvim_tiny", device="cpu", img_size=IMG,
                             patch_size=PATCH, num_classes=10,
                             drop_path_rate=0.0)
        tx = make_optimizer(cosine_with_warmup(1e-3, 1e-5, 10),
                            params=model, accum_steps=2)
        return TrainState.create(model, tx, ema=True)

    state = fresh()
    step = make_supervised_train_step(state.model, 10, ema_decay=0.9)
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    batch = {"image": x, "label": torch.tensor([1, 7])}
    for _ in range(3):  # an odd count leaves a gradient accumulated
        step(state, batch)
    for n in range(7):
        path = save_checkpoint(str(tmp_path / "ckpt"), state, step=n)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        f"step_{n}" for n in range(2, 7)]
    assert latest_checkpoint(str(tmp_path / "ckpt")) == path
    other = fresh()
    other.load_state_dict(restore_checkpoint(path))
    assert other.step == 6 and other.tx.count == 1 and other.tx.mini_step == 1
    for a, b in ((other.model.state_dict(), state.model.state_dict()),
                 (other.ema_params, state.ema_params), (other.tx._acc,
                                                        state.tx._acc)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    # the next step of both is the same
    other.step = state.step
    step(state, batch)
    make_supervised_train_step(other.model, 10, ema_decay=0.9)(other, batch)
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


@pytest.fixture
def one_torch_thread():
    """One torch thread: the steps of a tiny model are a few ms, and more
    threads only contend, most of all when several test processes share
    the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_trains_digits_device_resident(tmp_path, tiny_port_models,
                                           one_torch_thread):
    """digits64.yaml's path end to end on the CPU: the digits set held as
    a tensor, the permutation, gather and augment on its device, one epoch
    of 1497 // 768 = 1 step (a batch of more than half the set: the
    fewest images an epoch can take), the EMA columns in the log; a
    second run with --resume goes on from the checkpoint with the same
    permutation and draws as an uninterrupted run (the warmup spans both
    epochs, so that --epochs leaves the LR schedule as it is)."""
    run = lambda out, *more: train_classification.main(
        ["--config_name", "digits64", "--model_save_dir", str(tmp_path / out),
         "--device", "cpu", *more, "img_size=16", "batch_size=768",
         "warmup_epochs=2"])
    state = run("a", "--epochs", "1")
    assert state.step == 1497 // 768
    [row] = _read_csv(tmp_path / "a" / "log.csv")
    assert {"val_loss", "val_acc", "val_loss_ema", "val_acc_ema"} <= set(row)
    assert 0.0 <= float(row["val_acc"]) <= 1.0 and float(row["train_loss"]) > 0
    resumed = run("a", "--epochs", "2", "--resume")
    straight = run("b", "--epochs", "2")
    assert resumed.step == straight.step == 2 * (1497 // 768)
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


# --- (h) remat ------------------------------------------------------------

def test_remat_matches_plain_backward_with_drop_path():
    """remat=True recomputes each block in the backward pass; its DropPath
    masks are replayed from the generator state of the forward, so the
    loss, every gradient and the generator's final state equal
    remat=False's."""
    kw = dict(img_size=IMG, patch_size=PATCH, depth=4, embed_dim=64,
              num_classes=10, drop_path_rate=0.6)
    x = torch.randn(6, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    out = []
    for remat in (False, True):
        model = create_model("fastvim_tiny", device="cpu", remat=remat,
                             **kw).train()
        gen = torch.Generator().manual_seed(3)
        model.set_drop_path_generator(gen)
        loss = model(x).square().mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads, gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][2], out[1][2])


# --- (i) a JAX checkpoint through the port's test CLI ---------------------

def test_jax_checkpoint_evaluates_the_same_in_the_port(
        tmp_path, capsys, tiny_jax_models, tiny_port_models):
    """fastvim_tpu's train CLI writes an orbax checkpoint (1 epoch); its
    parameters and EMA copy, through from_jax_params, evaluated by the
    port's test_classification equal fastvim_tpu's test_classification
    numbers within 1e-4, raw and EMA."""
    from fastvim_tpu.cli import test_classification as jax_test
    from fastvim_tpu.cli import train_classification as jax_train
    from fastvim_tpu.train.checkpoint import restore_checkpoint

    cfg = _tiny_config(tmp_path, drop_path_rate=0.0, training_epochs=1,
                       mixup=0.0, cutmix=0.0)
    common = ["--config_name", cfg, "--synthetic_samples", "8"]
    jax_train.main(common + ["--model_save_dir", str(tmp_path / "jax")])
    jckpt = str(tmp_path / "jax" / "ckpt" / "step_2")
    restored = restore_checkpoint(jckpt)
    payload = {k: {n: torch.from_numpy(np.array(v))
                   for n, v in from_jax_params(restored[k]).items()}
               for k in ("params", "ema_params")}
    payload["step"] = int(restored["step"])
    os.makedirs(tmp_path / "port")
    torch.save(payload, tmp_path / "port" / "step_2")
    for ema in ([], ["--ema"]):
        capsys.readouterr()
        jax_test.main(common + ["--checkpoint", jckpt, *ema])
        want = ast.literal_eval(capsys.readouterr().out.strip()
                                .splitlines()[-1])
        got = test_classification.main(
            common + ["--checkpoint", str(tmp_path / "port" / "step_2"),
                      "--device", "cpu", *ema])
        assert set(got) == {"test_loss", "test_acc"}
        np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                                   atol=1e-4)


# --- (j) the torch reference's names ---------------------------------------

@pytest.mark.parametrize("name", ["fastvim_tiny", "vim_tiny_midclstok"])
def test_state_dict_matches_torch_convert(name):
    """The port's state_dict has exactly the names and shapes that
    fastvim_tpu/utils/torch_convert.py maps to and from the torch
    reference's checkpoints."""
    kw = dict(img_size=IMG, patch_size=PATCH, num_classes=10, **TINY)
    sd = {k: v.numpy() for k, v in
          create_model(name, device="cpu", **kw).state_dict().items()}
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jax_create_model(name, **kw).init,
                       jax.random.PRNGKey(0),
                       jnp.zeros((1, IMG, IMG, 3), jnp.float32)))
    exported = export_vision_mamba(params)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in exported.items()}
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert shapes(convert_vision_mamba(sd)) == shapes(dict(params))


# --- (k) the device rule ---------------------------------------------------

def test_clis_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cli in (train_classification, test_classification):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config_name", "FastVimT"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config_name", "FastVimT", "--device", "cuda:0"])
