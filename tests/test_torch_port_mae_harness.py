"""The port's MAE harness against the JAX package, on the CPU: SGD and
LARS against optax, the linear probe's head against the flax head,
``load_pretrained_backbone``, the MAE configs, and the three MAE CLIs
end to end (pretrain with a resume equal to an uninterrupted run, then
finetune and the linear probe from its checkpoint).

The CLIs run on the registries' models cut to depth 2, width 64 (MAE
decoder 32 × 2), at img 32, patch 8, batch 4 on 8 synthetic images; the
synthetic labels run to 1000, so the heads have 1000 classes.
"""

import contextlib
import copy
import csv
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvim_tpu import config as jconfig
from fastvim_tpu.cli.linear_probe import ProbeHead as FlaxProbeHead
from fastvim_tpu.models.mae import get_2d_sincos_pos_embed
from fastvim_tpu.models.patch_embed import resize_pos_embed as jax_resize
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu_torch import config as pconfig
from fastvim_tpu_torch.cli import finetune_mae, linear_probe, pretrain_mae
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models import registry as preg
from fastvim_tpu_torch.train import (
    TrainState,
    cosine_with_warmup,
    make_lars,
    make_optimizer,
    make_sgd,
)
from fastvim_tpu_torch.train.checkpoint import (
    load_pretrained_backbone,
    restore_checkpoint,
    save_checkpoint,
)

TINY = dict(depth=2, embed_dim=64)
TINY_MAE = dict(TINY, decoder_embed_dim=32, decoder_depth=2)
SMALL = ["img_size=32", "patch_size=8", "batch_size=4", "num_workers=2"]


@pytest.fixture
def tiny_port_models(monkeypatch):
    """The port's registry models at depth 2, width 64."""
    for name, factory in list(preg._REGISTRY.items()):
        cut = TINY_MAE if name.startswith("mae_") else TINY
        monkeypatch.setitem(preg._REGISTRY, name,
                            lambda f=factory, c=cut, **kw: f(**dict(kw, **c)))


# --- SGD and LARS ---------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["sgd", "lars"])
def test_sgd_and_lars_match_optax(kind, weight_decay):
    """Five updates of make_sgd / make_lars against the JAX package's
    (optax's sgd and lars) on the same gradients, the warmup-cosine
    schedule indexed by the update count; a second optimizer loaded from
    the first's state_dict after three updates goes on identically."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32)}  # a zero norm: trust ratio 1
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    sched = (0.5, 0.01, 5, 2)
    jmake = {"sgd": joptim.make_sgd, "lars": joptim.make_lars}[kind]
    pmake = {"sgd": make_sgd, "lars": make_lars}[kind]
    tx = jmake(jsched.cosine_with_warmup(*sched), momentum=0.9,
               weight_decay=weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = pmake(cosine_with_warmup(*sched), momentum=0.9,
                weight_decay=weight_decay, params=ours)
    twin = {k: v.clone() for k, v in ours.items()}
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply({k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        if i == 2:
            for k, v in ours.items():
                twin[k].copy_(v)
            other = pmake(cosine_with_warmup(*sched), momentum=0.9,
                          weight_decay=weight_decay, params=twin)
            # a deep copy, as torch.save / torch.load make one
            other.load_state_dict(copy.deepcopy(opt.state_dict()))
        elif i > 2:
            other.apply({k: torch.from_numpy(v) for k, v in g.items()})
            assert all(torch.equal(twin[k], ours[k]) for k in ours)
    assert opt.count == 5


# --- the linear probe's head ----------------------------------------------

def test_probe_head_matches_flax():
    """ProbeHead against fastvim_tpu's: the train-mode output of two
    batches (batch statistics), the running statistics after them (the
    biased variance, momentum 0.9, eps 1e-6), and the eval-mode output
    of a third batch."""
    rng = np.random.default_rng(1)
    feats = [(2.0 * rng.standard_normal((8, 16)) + 0.5).astype(np.float32)
             for _ in range(3)]
    fhead = FlaxProbeHead(10)
    variables = fhead.init(jax.random.PRNGKey(0), jnp.asarray(feats[0]))
    head = linear_probe.ProbeHead(16, 10)
    with torch.no_grad():
        head.head.weight.copy_(torch.from_numpy(np.array(
            variables["params"]["head"]["kernel"]).T))
        head.head.bias.copy_(torch.from_numpy(np.array(
            variables["params"]["head"]["bias"])))
    head.train()
    for f in feats[:2]:
        want, upd = fhead.apply(variables, jnp.asarray(f), train=True,
                                mutable=["batch_stats"])
        variables = {**variables, **upd}
        got = head(torch.from_numpy(f))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    stats = variables["batch_stats"]["bn"]
    np.testing.assert_allclose(head.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(head.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    head.eval()
    want = fhead.apply(variables, jnp.asarray(feats[2]), train=False)
    np.testing.assert_allclose(head(torch.from_numpy(feats[2])).detach()
                               .numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --- load_pretrained_backbone ---------------------------------------------

def _vim(img, classes, seed):
    return create_model("fastvim_tiny", device="cpu", img_size=img,
                        patch_size=8, num_classes=classes, **TINY,
                        generator=torch.Generator().manual_seed(seed))


def _save(tmp_path, model, ema=False):
    state = TrainState.create(model, make_optimizer(
        cosine_with_warmup(1e-3, 0.0, 10), params=model), ema=ema)
    if ema:  # an EMA copy that differs from the raw weights
        for v in state.ema_params.values():
            v.add_(1.0)
    return save_checkpoint(str(tmp_path / "ckpt"), state)


def _counts(text):
    return tuple(map(int, re.search(
        r"loaded (\d+), kept-init (\d+), sincos-filled (\d+)", text).groups()))


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_load_pretrained_takes_ema_first(tmp_path, capsys, prefer_ema):
    src = _vim(16, 5, 0)
    path = _save(tmp_path, src, ema=True)
    out = load_pretrained_backbone(path, _vim(16, 5, 1).state_dict(),
                                   prefer_ema=prefer_ema)
    n = len(out)
    assert _counts(capsys.readouterr().out) == (n, 0, 0)
    shift = 1.0 if prefer_ema else 0.0
    for k, v in src.state_dict().items():
        torch.testing.assert_close(out[k], v + shift, rtol=0, atol=0)


def test_load_pretrained_resizes_and_prunes(tmp_path, capsys):
    """A 2 × 2 grid's pos_embed resized bicubically to 4 × 4 as the JAX
    package resizes it; the head of another class count keeps the
    target's init; the rest is loaded."""
    src, tgt = _vim(16, 5, 0), _vim(32, 7, 1)
    path = _save(tmp_path, src)
    target = tgt.state_dict()
    out = load_pretrained_backbone(path, target, prefer_ema=False,
                                   new_grid=(4, 4), old_grid=(2, 2))
    assert _counts(capsys.readouterr().out) == (len(out) - 2, 2, 0)
    want = jax_resize(jnp.asarray(src.pos_embed.detach().numpy()), (4, 4),
                      (2, 2))
    np.testing.assert_allclose(out["pos_embed"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for k in ("head.weight", "head.bias"):
        assert torch.equal(out[k], target[k])
    assert torch.equal(out["layers.1.mixer.A_log"],
                       src.state_dict()["layers.1.mixer.A_log"])
    tgt.load_state_dict(out)
    assert tgt(torch.zeros(1, 32, 32, 3)).shape == (1, 7)


def test_load_pretrained_fills_sincos_from_an_mae_checkpoint(tmp_path,
                                                             capsys):
    """An MAE encoder saves no pos_embed: the target's is the sin-cos
    table; the encoder's weights load, the decoder's are left out."""
    mae = create_model("mae_FastVim_tiny_dec512d2b", device="cpu",
                       img_size=32, patch_size=8, **TINY_MAE)
    path = _save(tmp_path, mae)
    tgt = _vim(32, 7, 1)
    out = load_pretrained_backbone(path, tgt.state_dict(), prefer_ema=False)
    assert _counts(capsys.readouterr().out) == (len(out) - 3, 2, 1)
    np.testing.assert_array_equal(out["pos_embed"][0].numpy(),
                                  get_2d_sincos_pos_embed(64, 4))
    for k, v in mae.state_dict().items():
        if k in out:
            assert torch.equal(out[k], v), k


def test_load_pretrained_grafts_under_a_subtree(tmp_path, capsys):
    src = _vim(16, 5, 0)
    path = _save(tmp_path, src)
    target = {f"backbone.{k}": torch.zeros_like(v)
              for k, v in src.state_dict().items()}
    target["neck.weight"] = torch.ones(3)
    out = load_pretrained_backbone(path, target, prefer_ema=False,
                                   subtree="backbone")
    assert _counts(capsys.readouterr().out) == (len(target) - 1, 1, 0)
    for k, v in src.state_dict().items():
        assert torch.equal(out[f"backbone.{k}"], v)


# --- the configs ----------------------------------------------------------

MAE_CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(pconfig.CONFIG_ROOT, "mae")))


@pytest.mark.parametrize("name", MAE_CONFIGS)
def test_mae_configs_load_like_jax(name):
    assert len(MAE_CONFIGS) == 15
    over = ["batch_size=8", "img_size=64", "data.dir=/data/imagenet"]
    for overrides in ([], over):
        got = pconfig.load_config(name, "mae", overrides)
        assert got == jconfig.load_config(name, "mae", overrides)
        assert got["data"]["img_size"] == got["img_size"]


# --- the CLIs -------------------------------------------------------------

def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_mae_clis_pretrain_resume_finetune_probe(tmp_path, tiny_port_models):
    """pretrain_mae for 1 epoch and --resume to 2 equals 2 epochs
    straight (parameters, AdamW count, log); finetune_mae from its
    checkpoint takes the encoder, the sin-cos pos_embed and a fresh head;
    linear_probe from it trains the BatchNorm statistics and the head
    and leaves the frozen backbone bitwise as loaded."""
    pre = lambda out, *more: pretrain_mae.main(
        ["--config_name", "pretrain_FastVimT", "--model_save_dir",
         str(tmp_path / out), "--synthetic_samples", "8", "--device", "cpu",
         *more, *SMALL, "training_epochs=2", "warmup_epochs=2"])
    assert pre("cut", "--epochs", "1").step == 2
    resumed = pre("cut", "--resume")
    straight = pre("straight")
    assert resumed.step == straight.step == 4
    assert resumed.tx.count == straight.tx.count == 4
    for k, v in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v,
                                   rtol=0, atol=1e-6)
    got, want = (_rows(tmp_path / d / "log.csv") for d in ("cut", "straight"))
    assert [r["epoch"] for r in got] == ["0", "1"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g["train_loss"]),
                                   float(w["train_loss"]), rtol=1e-6)
    ckpt = str(tmp_path / "cut" / "ckpt" / "step_4")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = finetune_mae.main(
            ["--config_name", "finetune_FastVimB", "--model_save_dir",
             str(tmp_path / "ft"), "--synthetic_samples", "8", "--device",
             "cpu", *SMALL, "training_epochs=1", "warmup_epochs=0",
             "pretrain_img_size=32", f"pretrained_checkpoint_path={ckpt}"])
    n = len(state.model.state_dict())
    assert _counts(out.getvalue()) == (n - 3, 2, 1)
    assert state.step == 2
    x = torch.zeros(2, 32, 32, 3)
    assert state.model(x, return_features=True).shape == (2, 64)
    [row] = _rows(tmp_path / "ft" / "log.csv")
    assert np.isfinite([float(row[c]) for c in
                        ("train_loss", "val_loss", "val_acc")]).all()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = linear_probe.main(
            ["--config_name", "linear_FastVimL", "--model_save_dir",
             str(tmp_path / "lp"), "--synthetic_samples", "8", "--device",
             "cpu", "model=fastvim_base", *SMALL, "training_epochs=1",
             "warmup_epochs=0", f"pretrained_checkpoint_path={ckpt}"])
    n = len(state.backbone.state_dict())
    assert _counts(out.getvalue()) == (n - 1, 0, 1)
    pretrained = restore_checkpoint(ckpt)["params"]
    for k, v in state.backbone.state_dict().items():
        if k != "pos_embed":
            assert torch.equal(v, pretrained[k]), k
    assert not torch.equal(state.model.bn.running_mean,
                           torch.zeros_like(state.model.bn.running_mean))
    assert state.step == 2
    [row] = _rows(tmp_path / "lp" / "log.csv")
    assert {"train_loss", "train_acc", "val_loss", "val_acc"} <= set(row)


def test_mae_clis_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cli, cfg in ((pretrain_mae, "pretrain_FastVimB"),
                     (finetune_mae, "finetune_FastVimB"),
                     (linear_probe, "linear_FastVimL")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config_name", cfg])
