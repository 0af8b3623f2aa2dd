"""The port's MAE (fastvim_tpu_torch.models.mae) against the JAX package,
on the CPU, in fp32.

The sin-cos table and the masking bitwise; the masked mixer with real
masking in both orientations against the JAX mixer and the flip-based
numpy reproduction of the reference masked math
(``tests/test_parity_masked.py``), and against the dense mixer when
nothing is masked; ``MaskedAutoencoderVim``'s loss, prediction, mask and
every gradient for both encoder types, the JAX model applied with
``rng=key`` and the port given ``jax.random.uniform(key, (B, L))``, the
mask the JAX model draws; ``remat``; the converter both ways; and the
names ``fastvim_tpu/utils/torch_convert.py:convert_mae`` reads.

Models are cut to img 32, patch 8, depth 4, embed 64, decoder 32 × 2,
d_state 8 (``tests/test_mae.py``'s tiny MAE). Weights are drawn by the
port from a seed and carried to the JAX package by ``to_jax_params``, and
back by ``from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import mae as jmae
from fastvim_tpu.models.mixer import MambaMixer as JaxMixer
from fastvim_tpu.utils.torch_convert import convert_mae
from fastvim_tpu_torch.models import mae as pmae
from fastvim_tpu_torch.models.mae import MaskedAutoencoderVim
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.utils import (
    from_jax_params,
    grads_to_numpy,
    to_jax_params,
)
from tests.test_parity_masked import np_masked_mixer

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(img_size=32, patch_size=8, depth=4, embed_dim=64,
            decoder_embed_dim=32, decoder_depth=2, ssm_cfg=dict(d_state=8))
L = (32 // 8) ** 2


def _images(seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)


def _tree(model):
    """The port model's weights as the JAX package's parameter tree."""
    return jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}))


def _load(model, params):
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in from_jax_params(params).items()})
    return model


# --- the table and the masking --------------------------------------------

@pytest.mark.parametrize("dim,grid", [(64, 4), (768, 14), (512, 14)])
def test_sincos_table_bitwise(dim, grid):
    got = pmae.get_2d_sincos_pos_embed(dim, grid)
    want = jmae.get_2d_sincos_pos_embed(dim, grid)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batch,length,keep", [(3, 16, 4), (4, 196, 49)])
def test_sorted_random_masking_bitwise(batch, length, keep):
    """The same uniform draw gives the same kept ids (ascending), mask and
    restore permutation."""
    noise = jax.random.uniform(jax.random.PRNGKey(length), (batch, length))
    want = jmae.sorted_random_masking(None, batch, length, keep, noise=noise)
    got = pmae.sorted_random_masking(torch.from_numpy(np.array(noise)),
                                     keep)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[0].diff(dim=1) > 0).all()


# --- the masked mixer -----------------------------------------------------

def _mixer_pair(rows, cols, d_model=32, seed=1, init_layer_scale=None):
    """A port mixer from a seed and its weights as flax params, with D = 0
    in both directions: the output is then the scans' alone (with the
    init's D = 1 the skip term hides a wrong bin order, which moves the
    output by 1e-5)."""
    mixer = MambaMixer(d_model, d_state=8, collapse_method="mean",
                       layer_fused="off", init_layer_scale=init_layer_scale)
    mixer.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        mixer.D.zero_()
        mixer.D_b.zero_()
    sd = {f"layers.0.mixer.{k}": v.detach().numpy()
          for k, v in mixer.state_dict().items()}
    params = {"params": to_jax_params(sd)["params"]["layers_0"]["mixer"]}
    return mixer, jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("rows,cols,scale", [(4, 5, None), (5, 4, 0.5)])
def test_masked_mixer_matches_jax_and_reference(rows, cols, scale):
    """Real sorted masking on a 4 × 5 grid and its transpose (the two
    orientations a masked encoder alternates): the port's masked mixer
    against the JAX mixer's ``row_onehot`` path and the flip-based numpy
    reproduction of the reference (times the layer scale ``gamma`` where
    ``init_layer_scale`` is set). The reverse branch must scatter with
    the reversed row ids and scan its bins ascending (ROADMAP fault 4):
    either mistake moves the output by O(1)."""
    keep = 8
    ids_keep, _, _ = jmae.sorted_random_masking(
        jax.random.PRNGKey(7), 2, rows * cols, keep)
    ids_keep = np.asarray(ids_keep)
    x = np.random.default_rng(0).standard_normal((2, keep, 32)).astype(
        np.float32)
    mixer, params = _mixer_pair(rows, cols, init_layer_scale=scale)
    got = mixer(torch.from_numpy(x), (rows, cols),
                row_ids=torch.from_numpy(ids_keep // cols)).detach().numpy()
    onehot = jax.nn.one_hot(ids_keep // cols, rows)
    jax_out = JaxMixer(d_model=32, d_state=8, collapse_method="mean",
                       init_layer_scale=scale).apply(
        params, jnp.asarray(x), (rows, cols), row_onehot=onehot)
    np.testing.assert_allclose(got, np.asarray(jax_out), **TOL)
    want = np_masked_mixer(params, x.astype(np.float64), ids_keep, rows,
                           cols, d_state=8, dt_rank=mixer.dt_rank)
    if scale is not None:
        want = want * np.asarray(params["params"]["gamma"])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rows,cols", [(4, 4), (3, 5)])
def test_masked_mixer_equals_dense_when_nothing_is_masked(rows, cols):
    """With every token visible, the masked path's constant-divide
    scatter-pool equals the dense mean pool, and its ascending scan of
    the reversed bins equals the dense reverse scan."""
    mixer, _ = _mixer_pair(rows, cols)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, rows * cols, 32)).astype(np.float32))
    ids = torch.arange(rows * cols).expand(2, -1)
    with torch.no_grad():
        dense = mixer(x, (rows, cols))
        masked = mixer(x, (rows, cols), row_ids=ids // cols)
    torch.testing.assert_close(masked, dense, rtol=1e-5, atol=1e-5)


# --- the whole model ------------------------------------------------------

@pytest.fixture(scope="module", params=["fastvim", "vim"])
def run(request):
    """One model of each encoder type: the port's loss, prediction, mask
    and gradients, and the JAX package's on the same weights and noise."""
    enc = request.param
    cfg = dict(TINY, encoder_type=enc, use_cls_token=enc == "vim")
    model = MaskedAutoencoderVim(**cfg)
    model.reset_parameters(torch.Generator().manual_seed(5))
    params = _tree(model)
    _load(model, params)
    x = _images()
    key = jax.random.PRNGKey(3)
    jm = jmae.MaskedAutoencoderVim(**cfg, scan_impl="ref")

    def loss_fn(p):
        loss, pred, mask = jm.apply(p, jnp.asarray(x), rng=key)
        return loss, (pred, mask)

    (jloss, (jpred, jmask)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (2, L))))
    loss, pred, mask = model(torch.from_numpy(x), noise=noise)
    loss.backward()
    return dict(cfg=cfg, model=model, params=params, x=x, noise=noise,
                port=(loss, pred, mask, grads_to_numpy(model)),
                jax=(jloss, jpred, jmask, from_jax_params(jgrads)))


def test_mae_loss_pred_mask_match_jax(run):
    loss, pred, mask, _ = run["port"]
    jloss, jpred, jmask, _ = run["jax"]
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert pred.shape == (2, L, 8 * 8 * 3)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


def test_mae_gradients_match_jax(run):
    """Every parameter's gradient (the converter maps the JAX gradient
    tree onto the port's names: they are the same set)."""
    got, want = run["port"][3], run["jax"][3]
    assert set(got) == set(want) == set(run["model"].state_dict())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)


def test_mae_remat_gradients_bitwise(run):
    """remat=True (encoder and decoder blocks recomputed in the backward)
    gives the loss and gradients of remat=False, bit for bit."""
    model = _load(MaskedAutoencoderVim(**run["cfg"], remat=True),
                  run["params"])
    loss, _, _ = model(torch.from_numpy(run["x"]), noise=run["noise"])
    loss.backward()
    assert torch.equal(loss, run["port"][0])
    got = grads_to_numpy(model)
    for k, w in run["port"][3].items():
        assert np.array_equal(got[k], w), k


def test_converter_round_trips(run):
    """to_jax_params ∘ from_jax_params is the identity on the JAX tree
    (structure and values), and the port's state_dict survives the other
    way round."""
    params = jax.tree_util.tree_map(np.asarray, run["params"])
    back = to_jax_params(from_jax_params(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)
    sd = {k: v.numpy() for k, v in run["model"].state_dict().items()}
    again = from_jax_params(to_jax_params(sd))
    assert set(again) == set(sd)
    assert all(np.array_equal(again[k], v) for k, v in sd.items())


class _Reads(dict):
    """A state_dict that records the names read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def test_state_dict_names_are_convert_maes(run):
    """convert_mae, the JAX package's reader of the torch reference's MAE
    checkpoints, reads every name of the port's state_dict and no other,
    and builds the tree the JAX model was applied with."""
    sd = _Reads({k: v.numpy() for k, v in run["model"].state_dict().items()})
    tree = convert_mae(sd)
    assert sd.read == set(sd)
    want = jax.tree_util.tree_map(np.asarray, run["params"])
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)
