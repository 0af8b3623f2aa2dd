"""The port's training slice (fastvim_tpu_torch.train) against the JAX
package, on the CPU: a short AdamW trajectory of the supervised train step
from one set of weights on both sides, and the pieces (schedules, mixup,
weight-decay mask, layer decay, EMA, DropPath) one by one.

fp32 throughout; the port runs the kernels' plain versions. Weights come
from the JAX model's init and cross through ``from_jax_params``; batches
come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.train import mixup as jmixup
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models.layers import DropPath
from fastvim_tpu_torch.train import (
    TrainState,
    apply_mixup_cutmix,
    constant,
    cosine_with_warmup,
    ema_update,
    layer_decay_scales,
    make_optimizer,
    make_supervised_eval_step,
    make_supervised_train_step,
    sample_mixup_draws,
    scale_lr,
    warmup_multistep,
    wd_mask,
)
from fastvim_tpu_torch.train.mixup import MixupDraws
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

TINY = dict(patch_size=16, depth=2, embed_dim=32, num_classes=10,
            drop_path_rate=0.0)
IMG, CLASSES, STEPS = 64, 10, 5


def _init():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, IMG, IMG, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 4)
    jmodel = jax_create_model("fastvim_tiny", img_size=IMG,
                              layer_fused="off", scan_impl="ref", **TINY)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    return jmodel, params, x, labels


def _port_model(params):
    model = create_model("fastvim_tiny", img_size=IMG, device="cpu", **TINY)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in from_jax_params(params).items()})
    return model


# one option of make_optimizer / the train step per case, as keyword
# arguments of the port and of the JAX package
CASES = {
    "plain": ({}, {}),
    "grad_clip": (dict(grad_clip=0.5), dict(grad_clip=0.5)),
    "layer_decay": (dict(layer_decay=0.75, depth=2),
                    dict(layer_decay=0.75, depth=2)),
    "wd_schedule": (
        dict(wd_schedule=cosine_with_warmup(0.1, 0.4, 10)),
        dict(wd_schedule=jsched.cosine_with_warmup(0.1, 0.4, 10))),
    "accum_steps": (dict(accum_steps=2), dict(accum_steps=2)),
    "ema": ({}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_trajectory_matches_jax(case):
    """5 steps of make_supervised_train_step on one fixed batch, mixup off,
    no drop path, from the same weights: the losses agree to 1e-4
    relative and the final parameters (and the EMA copy) to rtol = atol =
    1e-4: fp32 on both sides, the same AdamW arithmetic in another order."""
    jmodel, params, x, labels = _init()
    port_kw, jax_kw = CASES[case]
    ema = 0.9 if case == "ema" else None

    # warmup from a non-zero LR, so that the first step moves the weights
    jtx = joptim.make_optimizer(
        jsched.cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4), weight_decay=0.05,
        params=params, **jax_kw)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  jtx, ema=ema is not None)
    jstep = jax_make_train_step(jmodel, CLASSES, label_smoothing=0.1,
                                ema_decay=ema)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    jlosses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        jlosses.append(float(m["train_loss"]))

    model = _port_model(params)
    tx = make_optimizer(cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4),
                        weight_decay=0.05, params=model, **port_kw)
    state = TrainState.create(model, tx, ema=ema is not None)
    step = make_supervised_train_step(model, CLASSES, label_smoothing=0.1,
                                      ema_decay=ema)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(m["train_loss"].item())
    assert state.step == STEPS and model.training

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    want = from_jax_params(jstate.params)
    got = {k: v.detach().numpy() for k, v in state.params.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    if ema is not None:
        want_ema = from_jax_params(jstate.ema_params)
        for k, v in state.ema_params.items():
            np.testing.assert_allclose(v.numpy(), want_ema[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        # the eval step on the EMA copy is the model run on those weights
        ev = make_supervised_eval_step(model)
        on_ema = ev(batch, params=state.ema_params)
        shadow = _port_model(to_jax_params(
            {k: v.numpy() for k, v in state.ema_params.items()}))
        on_shadow = make_supervised_eval_step(shadow)(batch)
        assert not model.training
        np.testing.assert_allclose(on_ema["loss"].item(),
                                   on_shadow["loss"].item(), rtol=1e-6)
        assert on_ema["acc"].item() == on_shadow["acc"].item()
        assert ev(batch)["loss"].item() != on_ema["loss"].item()


def test_schedules_match_jax():
    """Each schedule at a list of steps, to 1e-6 of its largest value (the
    JAX functions compute in fp32, the port's in Python floats)."""
    steps = [0, 1, 2, 4, 5, 9, 10, 11, 50, 99, 100, 101, 250]
    pairs = [  # (largest value, port schedule, JAX schedule)
        (1e-3, cosine_with_warmup(1e-3, 1e-5, 100, 10),
         jsched.cosine_with_warmup(1e-3, 1e-5, 100, 10)),
        (1e-3, cosine_with_warmup(1e-3, 1e-6, 100, 5, 1e-4),
         jsched.cosine_with_warmup(1e-3, 1e-6, 100, 5, 1e-4)),
        (0.5, cosine_with_warmup(0.05, 0.5, 100),
         jsched.cosine_with_warmup(0.05, 0.5, 100)),
        (1e-3, cosine_with_warmup(1e-3, 1e-5, 100, 1),
         jsched.cosine_with_warmup(1e-3, 1e-5, 100, 1)),
        (1e-4, warmup_multistep(1e-4, 10, (50, 100)),
         jsched.warmup_multistep(1e-4, 10, (50, 100))),
        (1e-4, warmup_multistep(1e-4, 0, (5,), gamma=0.5),
         jsched.warmup_multistep(1e-4, 0, (5,), gamma=0.5)),
        (0.3, constant(0.3), jsched.constant(0.3)),
    ]
    for top, ours, theirs in pairs:
        for s in steps:
            np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=0,
                                       atol=1e-6 * top)
    for rule in ("linear", "deit", "sqrt", "none"):
        assert scale_lr(5e-4, 128, 8, rule) == pytest.approx(
            jsched.scale_lr(5e-4, 128, 8, rule), rel=1e-12)
    with pytest.raises(ValueError):
        scale_lr(1e-3, 1, 1, "cube")


def _jax_mixup_draws(rng, H, W, mixup_alpha, cutmix_alpha, prob, switch_prob):
    """The draws fastvim_tpu.train.mixup.mixup_cutmix makes from ``rng``."""
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(rng, 5)
    r1, r2 = jax.random.split(r_box)
    return MixupDraws(
        bool(jax.random.bernoulli(r_apply, prob)),
        bool(jax.random.bernoulli(r_switch, switch_prob)),
        float(jax.random.beta(r_lam_m, mixup_alpha, mixup_alpha)),
        float(jax.random.beta(r_lam_c, cutmix_alpha, cutmix_alpha)),
        int(jax.random.randint(r1, (), 0, H)),
        int(jax.random.randint(r2, (), 0, W)))


def test_mixup_pure_part_matches_jax():
    """apply_mixup_cutmix, fed the draws the JAX function makes from its
    key, gives the JAX function's images and soft targets; the keys cover
    Mixup, CutMix and the batch left alone."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((6, 12, 20, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 6)
    cfg = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.7, switch_prob=0.5)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        draws = _jax_mixup_draws(key, 12, 20, **cfg)
        seen.add((draws.apply, draws.apply and draws.use_cutmix))
        want_x, want_y = jmixup.mixup_cutmix(
            key, jnp.asarray(images), jnp.asarray(labels), 7, smoothing=0.1,
            **cfg)
        got_x, got_y = apply_mixup_cutmix(
            torch.from_numpy(images), torch.from_numpy(labels), 7, draws, 0.1)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=1e-6, atol=1e-6)
    assert seen == {(False, False), (True, False), (True, True)}


def test_mixup_sampler_is_seeded_and_in_range():
    gen = lambda: torch.Generator().manual_seed(11)
    a = [sample_mixup_draws(g, 12, 20) for g in [gen()] for _ in range(50)]
    b = [sample_mixup_draws(g, 12, 20) for g in [gen()] for _ in range(50)]
    assert a == b
    assert all(0 < d.lam_m < 1 and 0 < d.lam_c < 1 and 0 <= d.cy < 12
               and 0 <= d.cx < 20 and d.apply for d in a)
    assert {d.use_cutmix for d in a} == {False, True}
    # Beta(0.8, 0.8) has mean 1/2
    assert abs(np.mean([d.lam_m for d in a]) - 0.5) < 0.15
    only_cut = sample_mixup_draws(gen(), 12, 20, mixup_alpha=0.0)
    assert only_cut.use_cutmix and only_cut.lam_m == 1.0


def test_wd_mask_and_layer_decay_match_jax_name_for_name():
    """The port's masks read its own parameter names; carried through the
    converter's table, the JAX package's masks mark the same parameters."""
    for name in ("fastvim_tiny", "vim_tiny_midclstok"):
        jmodel = jax_create_model(name, img_size=IMG, **TINY)
        params = jmodel.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, IMG, IMG, 3)))
        model = create_model(name, img_size=IMG, device="cpu", **TINY)
        full = lambda tree: from_jax_params(jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, m), tree, params))
        jmask = full(joptim.wd_mask(params))
        mask = wd_mask(model)
        assert sorted(mask) == sorted(jmask)
        for k, v in mask.items():
            assert (jmask[k] == v).all(), k
        assert not mask["layers.1.mixer.dt_proj_b.bias"]
        assert not mask["layers.0.mixer.D"] and not mask["pos_embed"]
        assert mask["layers.0.mixer.conv1d.weight"] and mask["head.weight"]
        jscale = full(joptim.layer_decay_scales(params, 0.75, 2))
        scale = layer_decay_scales(model, 0.75, 2)
        for k, v in scale.items():
            np.testing.assert_allclose(jscale[k], v, rtol=1e-12, err_msg=k)
        assert scale["pos_embed"] == 0.75 ** 2
        assert scale["layers.1.norm.weight"] == 0.75
        assert scale["head.bias"] == 1.0


def test_ema_update_matches_jax():
    rng = np.random.default_rng(5)
    e = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    p = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in e.items()}
    want = joptim.ema_update({k: jnp.asarray(v) for k, v in e.items()},
                             {k: jnp.asarray(v) for k, v in p.items()}, 0.99)
    ema = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    out = ema_update(ema, {k: torch.from_numpy(v) for k, v in p.items()},
                     0.99)
    assert out is ema  # in place
    for k in e:
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_drop_path_is_seeded_per_sample_and_rescaled():
    x = torch.ones(64, 5, 3)
    dp = DropPath(0.25, generator=torch.Generator().manual_seed(2)).train()
    y = dp(x)
    kept = y[:, 0, 0] != 0
    assert 0 < kept.sum() < 64                     # some samples dropped
    assert ((y == 0) | (y == 1 / 0.75)).all()      # kept ones rescaled
    assert (y == y[:, :1, :1]).all()               # one draw per sample
    dp.generator = torch.Generator().manual_seed(2)
    assert torch.equal(dp(x), y)                   # the seed decides
    assert torch.equal(dp.eval()(x), x)            # identity in eval mode
    with pytest.raises(RuntimeError, match="needs a generator"):
        DropPath(0.25).train()(x)
    assert torch.equal(DropPath(0.0).train()(x), x)


def test_train_mode_drops_paths_from_the_given_generator():
    """A model with drop_path_rate > 0 trains only with a generator; the
    same seed gives the same loss, and eval mode ignores it."""
    model = create_model("fastvim_tiny", img_size=IMG, device="cpu",
                         **dict(TINY, drop_path_rate=0.5))
    x = torch.randn(8, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    model.train()
    with pytest.raises(RuntimeError, match="needs a generator"):
        model(x)
    outs = []
    for seed in (1, 1, 2):
        model.set_drop_path_generator(torch.Generator().manual_seed(seed))
        outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    model.eval()
    assert torch.equal(model(x), model(x))


def test_entry_points_ask_for_the_cpu_explicitly():
    """create_model without a device builds on the card and raises where
    there is none; make_optimizer needs its parameters."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("fastvim_tiny", img_size=IMG, **TINY)
    model = create_model("fastvim_tiny", img_size=IMG, device="cpu", **TINY)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(ValueError, match="needs params"):
        make_optimizer(constant(1e-3))
    with pytest.raises(ValueError, match="mixup needs a generator"):
        make_supervised_train_step(model, CLASSES,
                                   mixup_config=dict(prob=1.0))


def test_to_jax_params_inverts_from_jax_params():
    _, params, _, _ = _init()
    back = to_jax_params(from_jax_params(params))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
