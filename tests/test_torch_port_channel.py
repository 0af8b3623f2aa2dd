"""The port's ChannelVim (fastvim_tpu_torch.models.channel) against the
JAX package, on the CPU, in fp32.

The per-channel patch embed in both scan orders and both scan paths with
a subset of the channels; the mixer on 3-D grids (pooled over (1,), (2,),
(0, 1) and (1, 2), mean and max) and the generic Block; the model's
logits in both scan orders, with max pooling, with 2dcompress, the
unpooled baseline, the last-token and max final pools and HCS channel
subsets, down to one channel; the loss and every gradient under HCS;
``remat``; ``hcs_sample``; and the converter for every model family the
registry holds (every leaf of the JAX tree lands in the port's
state_dict and comes back equal; an unknown leaf raises) and the names
``fastvim_tpu/utils/torch_convert.convert_channel_vim`` reads.

Models are cut as ``tests/test_channel.py`` cuts them: img 16, patch 8,
depth 3, embed 32, 5 channels, d_state 4. Weights are drawn by the port
from a seed, carried to the JAX package by ``to_jax_params`` and back by
``from_jax_params``; inputs come from numpy seeds; the JAX side scans
with ``scan_impl="ref"``. Tolerance: 1e-4 of
each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvim_tpu.models import channel as jchannel
from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models.blocks import Block as JaxBlock
from fastvim_tpu.models.mixer import MambaMixer as JaxMixer
from fastvim_tpu.utils.torch_convert import convert_channel_vim
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models.blocks import Block
from fastvim_tpu_torch.models.channel import (
    ChannelVisionMamba,
    PatchEmbedPerChannel,
    hcs_sample,
)
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.utils import (
    from_jax_params,
    grads_to_numpy,
    to_jax_params,
)

TINY = dict(img_size=16, patch_size=8, depth=3, embed_dim=32, channels=5,
            num_classes=7, drop_path_rate=0.0, ssm_cfg=dict(d_state=4))
TOL = 1e-4


def _close(got, want, name=""):
    """|got - want| within TOL of want's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), f"{name}: {err:.3e}"


def _images(seed=0, channels=5, batch=2, h=16, w=16):
    return np.random.default_rng(seed).standard_normal(
        (batch, h, w, channels)).astype(np.float32)


def _state_dict(params, prefix=""):
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in from_jax_params(params).items()
            if k.startswith(prefix)}


def _pair(**kw):
    """The JAX model (scan_impl "ref") on weights drawn from a seed, and
    the port's model on the same weights, carried by from_jax_params."""
    cfg = dict(TINY, **kw)
    init = ChannelVisionMamba(**cfg)
    init.reset_parameters(torch.Generator().manual_seed(1))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in init.state_dict().items()}))
    model = ChannelVisionMamba(**cfg)
    model.load_state_dict(_state_dict(params))
    jmodel = jchannel.ChannelVisionMamba(**cfg, scan_impl="ref")
    return jmodel, params, model.eval()


# --- the patch embed --------------------------------------------------------

@pytest.mark.parametrize("scanpath_type", ["rowwise", "colwise"])
@pytest.mark.parametrize("scan_order", ["Channel-First", "Spatial-First"])
def test_patch_embed_per_channel_matches_jax(scan_order, scanpath_type):
    """A 16 × 24 image with 3 of 5 channels (ids 0, 2, 4): the same
    tokens, in the same order, and the same grid."""
    cfg = dict(patch_size=8, in_chans=5, embed_dim=16, scan_order=scan_order,
               scanpath_type=scanpath_type)
    x = _images(channels=3, w=24)
    ids = np.array([0, 2, 4])
    jpe = jchannel.PatchEmbedPerChannel(**cfg)
    params = jpe.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(ids))
    want, wgrid = jpe.apply(params, jnp.asarray(x), jnp.asarray(ids))
    pe = PatchEmbedPerChannel(**cfg)
    pe.load_state_dict(_state_dict({"patch_embed": params["params"]},
                                   "patch_embed."))
    got, grid = pe(torch.from_numpy(x), torch.from_numpy(ids))
    assert grid == tuple(wgrid)
    _close(got.detach().numpy(), want)


# --- the mixer and the block on 3-D grids -----------------------------------

def _mixer_pair(collapse, d_model=32, seed=3):
    mixer = MambaMixer(d_model, d_state=4, collapse_method=collapse)
    mixer.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {f"layers.0.mixer.{k}": v.detach().numpy()
          for k, v in mixer.state_dict().items()}
    params = {"params": to_jax_params(sd)["params"]["layers_0"]["mixer"]}
    return mixer, jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("collapse", ["mean", "max"])
@pytest.mark.parametrize("grid,pool_axes", [
    ((3, 4, 5), (1,)),      # Channel-First: cols pooled, a rows·C scan
    ((5, 3, 4), (2,)),      # Spatial-First: cols pooled, a C·rows scan
    ((3, 4, 5), (0, 1)),    # 2dcompress: the spatial grid pooled, C steps
    ((3, 4, 5), (1, 2)),    # 2dcompress: cols·C pooled, rows steps
    ((3, 4, 1), (0, 1)),    # one channel kept: a one-step scan
])
def test_mixer_on_3d_grids_matches_jax(grid, pool_axes, collapse):
    x = np.random.default_rng(4).standard_normal(
        (2, int(np.prod(grid)), 32)).astype(np.float32)
    mixer, params = _mixer_pair(collapse)
    with torch.no_grad():
        got = mixer(torch.from_numpy(x), grid, pool_axes=pool_axes)
    jmixer = JaxMixer(d_model=32, d_state=4, collapse_method=collapse,
                      scan_impl="ref")
    want = jax.jit(jmixer.apply, static_argnums=(2, 3))(
        params, jnp.asarray(x), grid, pool_axes)
    _close(got.numpy(), want)


@pytest.mark.parametrize("grid,transpose_axes,pool_axes,layer,rotate", [
    ((3, 4, 5), (0, 1), (1,), 1, None),     # Channel-First, rotated
    ((5, 3, 4), (1, 2), (2,), 1, None),     # Spatial-First, rotated
    ((3, 4, 5), (0, 1), (1, 2), 1, True),   # 2dcompress' rotated layer
    ((3, 4, 5), (0, 1), (0, 1), 3, False),  # an odd layer kept unrotated
])
def test_block_matches_jax(grid, transpose_axes, pool_axes, layer, rotate):
    """The generic Block on 3-D grids: the rotation of ``transpose_axes``,
    the pooled axes and the ``rotate`` override, against the JAX Block."""
    d = 32
    mixer_kwargs = dict(d_state=4, scan_impl="ref")
    blk = Block(d, layer, mixer_kwargs, pool_axes=pool_axes,
                transpose_axes=transpose_axes, rotate=rotate)
    blk.reset_parameters(torch.Generator().manual_seed(6))
    params = {"params": to_jax_params(
        {f"layers.0.{k}": v.numpy() for k, v in blk.state_dict().items()})[
        "params"]["layers_0"]}
    jblk = JaxBlock(dim=d, layer_idx=layer, token_size=grid,
                    mixer_kwargs=dict(mixer_kwargs, layer_fused="off"),
                    pool_axes=pool_axes, transpose_axes=transpose_axes,
                    rotate=rotate)
    rng = np.random.default_rng(5)
    L = int(np.prod(grid))
    hidden = rng.standard_normal((2, L, d)).astype(np.float32)
    residual = rng.standard_normal((2, L, d)).astype(np.float32)
    want = jax.jit(jblk.apply)(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(hidden), jnp.asarray(residual))
    with torch.no_grad():
        got = blk(torch.from_numpy(hidden), torch.from_numpy(residual), grid)
    _close(got[0].numpy(), want[0], "hidden")
    _close(got[1].numpy(), want[1], "residual")


# --- the model --------------------------------------------------------------

MODEL_CASES = {
    "channel-first": ({}, None),
    "spatial-first": (dict(scan_order="Spatial-First"), None),
    "maxpool": (dict(collapse_method="max"), None),
    "2dcompress": (dict(compress_2d=True), None),
    "baseline": (dict(collapse_method="none"), None),
    "final-pool-none": (dict(final_pool_type="none"), None),
    "final-pool-max": (dict(final_pool_type="max"), None),
    "hcs-channel-first": ({}, [1, 3, 4]),
    "hcs-spatial-first": (dict(scan_order="Spatial-First"), [0, 2]),
    "hcs-2dcompress-one-channel": (dict(compress_2d=True), [3]),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_channel_logits_match_jax(case):
    kw, chans = MODEL_CASES[case]
    jmodel, params, model = _pair(**kw)
    x = _images(seed=7)
    ids = None
    if chans is not None:
        x, ids = x[..., chans], np.asarray(chans, np.int32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x),
                                 None if ids is None else jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    None if ids is None else torch.from_numpy(ids))
    assert got.shape == (2, 7)
    _close(got.numpy(), want)


def test_return_features_match_jax():
    jmodel, params, model = _pair()
    x = _images(seed=8)
    want = jax.jit(jmodel.apply, static_argnames="return_features")(
        params, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_features=True)
    _close(got.numpy(), want)


CHANS = [0, 2, 3]


@pytest.fixture(scope="module")
def grads():
    """Channel-First under an HCS subset: the port's loss and gradients,
    and a jitted jax.value_and_grad's, from the same weights and batch."""
    jmodel, params, model = _pair()
    x = _images(seed=9)[..., CHANS]
    ids = np.asarray(CHANS, np.int32)
    labels = np.array([1, 5])

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x), jnp.asarray(ids))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), labels])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = F.cross_entropy(model(torch.from_numpy(x), torch.from_numpy(ids)),
                           torch.from_numpy(labels))
    loss.backward()
    return dict(params=params, x=x, ids=ids, labels=labels, model=model,
                port=(loss.item(), grads_to_numpy(model)),
                jax=(float(jloss), from_jax_params(jgrads)))


def test_channel_loss_and_gradients_match_jax(grads):
    loss, got = grads["port"]
    jloss, want = grads["jax"]
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    assert set(got) == set(want) == set(grads["model"].state_dict())
    for k, w in want.items():
        _close(got[k], w, k)


def test_channel_remat_gradients_bitwise():
    """remat=True gives the loss and gradients of remat=False bit for bit,
    in training mode with dropout after the position embedding and drop
    path on the blocks, both drawn from the one generator."""
    out = []
    for remat in (False, True):
        cfg = dict(TINY, drop_rate=0.2, drop_path_rate=0.3, remat=remat)
        model = ChannelVisionMamba(**cfg)
        model.reset_parameters(torch.Generator().manual_seed(10))
        model.set_drop_path_generator(torch.Generator().manual_seed(11))
        model.train()
        x = torch.from_numpy(_images(seed=12)[..., CHANS])
        loss = model(x, torch.tensor(CHANS)).square().mean()
        loss.backward()
        out.append((loss, grads_to_numpy(model)))
    (loss, want), (rloss, got) = out
    assert torch.equal(loss, rloss)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("num_channels", [5, 8])
def test_hcs_sample_matches_jax(num_channels):
    for seed in range(20):
        got = hcs_sample(seed, num_channels)
        assert got == jchannel.hcs_sample(seed, num_channels)
        assert got == sorted(set(got)) and 1 <= len(got) <= num_channels


def test_channel_registry_matches_jax():
    """The nine names, each with the JAX factory's fields."""
    assert len(jchannel.CHANNEL_MODELS) == 9
    for name in jchannel.CHANNEL_MODELS:
        j = jchannel.CHANNEL_MODELS[name]()
        p = create_model(name, device="cpu", depth=1, embed_dim=32)
        assert (p.patch_size, p.final_pool_type, p.scan_order) == (
            j.patch_size, j.final_pool_type, j.scan_order), name
        assert p.layers[0].mixer.collapse_method == j.collapse_method, name
        compress = [b.pool_axes for b in p.layers] == [(1, 2)]
        assert compress == j.compress_2d, name
        assert (j.embed_dim, j.depth) == (384, 24)


# --- the converter ----------------------------------------------------------

def _jax_tree(jmodel, x):
    """The JAX model's parameter tree (its init's structure, names and
    shapes, from ``jax.eval_shape``), filled with numpy draws."""
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "mask": jax.random.PRNGKey(1)}, x)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def families():
    """One small model of each registered family: the JAX tree and the
    port's model of the same configuration."""
    x3 = jnp.zeros((1, 32, 32, 3))
    small = dict(img_size=32, patch_size=8, depth=2, embed_dim=32)
    out = {}
    for name, kw in (("fastvim_tiny", {}), ("vim_tiny_midclstok", {}),
                     ("mae_FastVim_tiny_dec512d2b",
                      dict(decoder_embed_dim=32, decoder_depth=2))):
        out[name] = (_jax_tree(jax_create_model(name, **small, **kw), x3),
                     create_model(name, device="cpu", **small, **kw))
    out["fastchannelvim"] = (
        _jax_tree(jchannel.ChannelVisionMamba(**TINY),
                  jnp.asarray(_images())),
        ChannelVisionMamba(**TINY))
    return out


@pytest.mark.parametrize("family", ["fastvim_tiny", "vim_tiny_midclstok",
                                    "mae_FastVim_tiny_dec512d2b",
                                    "fastchannelvim"])
def test_converter_carries_every_leaf(families, family):
    """Every leaf of the JAX tree lands in the port's state_dict, under a
    name and a shape the port's model has, and comes back equal."""
    params, model = families[family]
    sd = from_jax_params(params)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    back = to_jax_params(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_converter_refuses_an_unknown_leaf(families):
    params = families["fastchannelvim"][0]
    params = dict(params, params=dict(params["params"], patch_embed=dict(
        params["params"]["patch_embed"], extra=np.zeros(3))))
    with pytest.raises(ValueError, match="patch_embed/extra"):
        from_jax_params(params)


class _Reads(dict):
    """A state_dict that records the names read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def test_state_dict_names_are_convert_channel_vims(families):
    """convert_channel_vim, the JAX package's reader of the torch
    reference's ChannelVim checkpoints, reads every name of the port's
    state_dict and builds the JAX model's tree from it."""
    params, _ = families["fastchannelvim"]
    sd = _Reads(from_jax_params(params))
    tree = convert_channel_vim(sd)
    assert sd.read == set(sd)
    assert sd["patch_embed.proj.weight"].shape == (32, 1, 1, 8, 8)
    want = params
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)
