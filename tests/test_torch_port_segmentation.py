"""The port's segmentation models against the JAX package, on the CPU:
the trunk's feature-map mode (``out_indices``, odd indices included, so
rotated layers) and its other fields (``drop_rate``, ``final_pool_type``,
``if_abs_pos_embed``), ``PSPModule``, ``UPerHead`` and ``FCNHead`` with
LayerNorm and with BatchNorm in training mode (outputs and the running
statistics against flax's ``batch_stats``), ``UperNetSegmentor`` logits,
``segmentation_loss`` and gradients, ``slide_inference``, the confusion
matrix and mIoU, ``SimpleFPN``, and the converter on these trees.

Small models: img 32, patch 8 (a 4 × 4 grid), depth 4, embed 64, d_state
4, 6 classes; the segmentor's heads at their real widths (512 and 256
channels), the heads alone at 32. The weights are the port's init, norms
and statistics moved off their init values, carried to JAX by
``to_jax_params`` (each tree's names and shapes are held against flax's
own init by ``jax.eval_shape``); the JAX applies are jitted. The JAX
trunk runs unfused with the sequential reference scan, the port's fused
(its plain versions on the CPU). Tolerances, fp32: feature maps within
1e-5 of their largest entry, logits rtol = atol = 1e-4 (the heads sum
thousands of products in another order), gradients within 1e-4 of each
tensor's largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models import heads as jheads
from fastvim_tpu.models import upernet as jup
from fastvim_tpu.train import metrics as jmetrics
from fastvim_tpu_torch.models import create_model
from fastvim_tpu_torch.models import heads, upernet
from fastvim_tpu_torch.train import metrics
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

TINY = dict(img_size=32, patch_size=8, depth=4, embed_dim=64,
            drop_path_rate=0.0, ssm_cfg=dict(d_state=4))
JAX_PATH = dict(layer_fused="off", scan_impl="ref")
TOL = dict(rtol=1e-4, atol=1e-4)
NC = 6


def _images(shape=(2, 32, 32, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@torch.no_grad()
def _moved(module, seed=0):
    """``module`` with every norm's weight, bias and running statistics
    moved off their init values (ones, zeros), by a seeded draw."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if t.dim() == 1 and any(
                n in name for n in ("norm", "running", ".ln.", ".bn.")):
            t.add_(0.5 * torch.rand(t.shape, generator=gen))
    return module


def _jax_vars(module, prefix=""):
    """The port module's state_dict as flax variables; with ``prefix``
    (a segmentor's head name) its keys are taken under that name and the
    head's own subtrees returned. Copies: the port's in-place updates
    (BatchNorm statistics) must not reach them."""
    sd = {prefix + k: v.numpy().copy()
          for k, v in module.state_dict().items()}
    tree = to_jax_params(sd)
    if prefix:
        tree = {k: v[prefix[:-1]] for k, v in tree.items()}
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _structure(tree):
    return jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), tree)


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / (
        np.abs(np.asarray(want)).max() + 1e-12)


def _trunk(**kw):
    return _moved(create_model("fastvim_tiny", device="cpu",
                               generator=torch.Generator().manual_seed(1),
                               **TINY, **kw))


# --- the trunk ------------------------------------------------------------

@pytest.mark.parametrize("out_indices", [(0, 1, 2, 3), (1, 3)])
def test_feature_maps_match_jax(out_indices):
    """Each listed block's mixer output under its own LayerNorm, as a
    (B, rows, cols, D) map; odd blocks are the rotated ones. The port's
    names are flax's."""
    x = _images()
    port = _trunk(num_classes=0, out_indices=out_indices)
    assert port.norm_f is None and port.head is None
    jmodel = jax_create_model("fastvim_tiny", num_classes=0,
                              out_indices=out_indices, **TINY, **JAX_PATH)
    variables = _jax_vars(port)
    assert _structure(variables) == _structure(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == len(out_indices)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 4, 4, 64) and g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("fields", [
    dict(drop_rate=0.1), dict(final_pool_type="max"),
    dict(final_pool_type="none"), dict(final_pool_type="all"),
    dict(if_abs_pos_embed=False)], ids=str)
def test_trunk_fields_match_jax(fields):
    """Eval-mode logits (dropout off) of each field against the JAX
    model's; "all" gives per-token logits."""
    x = _images(seed=1)
    port = _trunk(num_classes=NC, **fields)
    assert (port.pos_embed is None) == (not fields.get(
        "if_abs_pos_embed", True))
    jmodel = jax_create_model("fastvim_tiny", num_classes=NC, **fields,
                              **TINY, **JAX_PATH)
    want = np.asarray(jax.jit(jmodel.apply)(_jax_vars(port), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_create_model_takes_the_segmentation_fields():
    """The registry call of the segmentation CLI, with dropout; in
    training mode the dropout draws from the handed generator only."""
    model = create_model("fastvim_tiny", device="cpu", img_size=32,
                         num_classes=0, drop_path_rate=0.0, drop_rate=0.1,
                         out_indices=(5, 11, 17, 23), depth=24,
                         embed_dim=32)
    x = torch.from_numpy(_images(seed=2))
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(x)
    outs = []
    for _ in range(2):
        model.set_drop_path_generator(torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append(model(x))
    assert len(outs[0]) == 4
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --- the heads ------------------------------------------------------------

@pytest.mark.parametrize("grid", [4, 7])
def test_psp_module_matches_jax(grid):
    """Grid 4 reaches the min(s, H) clamp (s = 6) and windows of 1; grid
    7 drops remainder rows (s = 2, 3)."""
    x = _images((2, grid, grid, 16), seed=3)
    psp = upernet.PSPModule(16, channels=8)
    psp.reset_parameters(torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in _moved(psp).state_dict().items()}
    params = {f"ConvModule_{i}": {
        "Conv_0": {"kernel": sd[f"stages.{i}.conv.weight"].transpose(
            2, 3, 1, 0)},
        "LayerNorm_0": {"scale": sd[f"stages.{i}.ln.weight"],
                        "bias": sd[f"stages.{i}.ln.bias"]}}
        for i in range(4)}
    jpsp = jup.PSPModule(channels=8)
    assert _structure({"params": params}) == _structure(jax.eval_shape(
        jpsp.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(jpsp.apply)({"params": params},
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = psp(torch.from_numpy(x)).numpy()
    assert got.shape == (2, grid, grid, 16 + 4 * 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _feats(n=4, dim=64, hw=4, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, hw, hw, dim)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("norm", ["ln", "bn"])
@pytest.mark.parametrize("kind", ["decode_head", "aux_head"])
def test_heads_train_mode_match_jax(kind, norm):
    """Training mode with dropout 0 (32 channels): the outputs, and with
    BatchNorm the running statistics after the step against flax's
    batch_stats, then eval mode on them."""
    feats = _feats()
    if kind == "decode_head":
        jhead = jup.UPerHead(num_classes=NC, channels=32, dropout=0.0,
                             norm=norm)
        head = upernet.UPerHead((64,) * 4, NC, channels=32, dropout=0.0,
                                norm=norm)
        jin, tin = [jnp.asarray(f) for f in feats], [
            torch.from_numpy(f) for f in feats]
    else:
        jhead = jup.FCNHead(num_classes=NC, channels=32, dropout=0.0,
                            norm=norm)
        head = upernet.FCNHead(64, NC, channels=32, dropout=0.0, norm=norm)
        jin, tin = jnp.asarray(feats[2]), torch.from_numpy(feats[2])
    head.reset_parameters(torch.Generator().manual_seed(6))
    variables = _jax_vars(_moved(head), f"{kind}.")
    assert _structure(variables) == _structure(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), jin))
    want, upd = jax.jit(lambda v, f: jhead.apply(
        v, f, deterministic=False, mutable=["batch_stats"]))(variables, jin)
    head.train()
    got = head(tin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if norm == "ln":
        return
    moved = from_jax_params({"params": {kind: variables["params"]},
                             "batch_stats": {kind: upd["batch_stats"]}})
    stats = {k: v for k, v in head.state_dict().items() if "running" in k}
    assert len(stats) == (2 * 12 if kind == "decode_head" else 2)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), moved[f"{kind}.{k}"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    head.eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            head(tin).numpy(), np.asarray(jax.jit(jhead.apply)(
                dict(variables, batch_stats=upd["batch_stats"]), jin)),
            **TOL)


def _port_segmentor(norm, channels=None):
    """The port's segmentor (moved norms and statistics, eval mode);
    ``channels``: its heads' width instead of 512 and 256."""
    seg = upernet.UperNetSegmentor(_trunk(num_classes=0,
                                          out_indices=(0, 1, 2, 3)),
                                   NC, norm=norm)
    if channels:
        seg.decode_head = upernet.UPerHead((64,) * 4, NC, channels=channels,
                                           norm=norm)
        seg.aux_head = upernet.FCNHead(64, NC, channels=channels, norm=norm)
    seg.reset_parameters(torch.Generator().manual_seed(7))
    return _moved(seg).eval()


@functools.lru_cache(maxsize=None)
def _segmentors():
    """The port's segmentor with LayerNorm heads, the JAX one and its
    variables, which flax's init shapes and names."""
    x = _images()
    seg = _port_segmentor("ln")
    jback = jax_create_model("fastvim_tiny", num_classes=0,
                             out_indices=(0, 1, 2, 3), **TINY, **JAX_PATH)
    jseg = jup.UperNetSegmentor(backbone=jback, num_classes=NC)
    variables = _jax_vars(seg)
    assert _structure(variables) == _structure(jax.eval_shape(
        functools.partial(jseg.init, with_aux=True), jax.random.PRNGKey(0),
        jnp.asarray(x)))
    return jseg, variables, seg, x


def _labels(seed=8, ignore_rows=0):
    lbl = np.random.default_rng(seed).integers(0, NC, (2, 32, 32))
    lbl[:, :ignore_rows] = 255
    lbl[0, 5, 7] = 255
    return lbl.astype(np.int32)


def test_segmentor_logits_loss_and_gradients_match_jax():
    """Eval mode (no dropout): the logits and aux logits, the loss with
    aux, and every parameter's gradient within 1e-4 of its largest entry;
    the loss of a crop whose every pixel is ignored is 0, not NaN."""
    jseg, variables, seg, x = _segmentors()
    lbl = _labels(ignore_rows=3)

    def jloss(p):
        lg, ax = jseg.apply({"params": p}, jnp.asarray(x), with_aux=True)
        return jup.segmentation_loss(lg, jnp.asarray(lbl), ax), (lg, ax)

    (jl, (jlog, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    log, aux = seg(torch.from_numpy(x), with_aux=True)
    assert log.shape == (2, 32, 32, NC) and aux.shape == log.shape
    np.testing.assert_allclose(log.detach().numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux), **TOL)
    with torch.no_grad():
        assert torch.equal(seg(torch.from_numpy(x)), log)
    loss = upernet.segmentation_loss(log, torch.from_numpy(lbl), aux)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    params = dict(seg.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    jgrads = from_jax_params(jgrads)
    assert set(params) == set(jgrads)
    for name, g in zip(params, grads):
        assert _rel_err(g.numpy(), jgrads[name]) <= 1e-4, name

    log, aux = log.detach(), aux.detach()
    for rows in (0, 20, 32):  # 32: every pixel ignored
        lb = _labels(ignore_rows=rows)
        want = float(jup.segmentation_loss(jlog, jnp.asarray(lb), jaux))
        got = upernet.segmentation_loss(log, torch.from_numpy(lb),
                                        aux).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got == 0.0 if rows == 32 else got > 0.0
    lb = torch.from_numpy(_labels())
    assert (upernet.segmentation_loss(log, lb).item()
            < upernet.segmentation_loss(log, lb, aux).item())


def test_slide_inference_matches_jax():
    """40 × 56 with crop 32, stride 16: 2 × 3 overlapping windows, each
    through the port's segmentor on both sides (its parity with the JAX
    segmentor is the test above), averaged as the JAX package does."""
    _, _, seg, _ = _segmentors()
    x = _images((2, 40, 56, 3), seed=9)
    calls = []

    @torch.no_grad()
    def fn(im):
        calls.append(tuple(im.shape))
        return seg(im)

    want = jup.slide_inference(
        lambda im: jnp.asarray(fn(torch.from_numpy(np.asarray(im))).numpy()),
        jnp.asarray(x), crop=32, stride=16, num_classes=NC)
    calls.clear()
    got = upernet.slide_inference(fn, torch.from_numpy(x), crop=32,
                                  stride=16, num_classes=NC)
    assert calls == [(2, 32, 32, 3)] * 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@functools.partial(jax.jit, static_argnums=2)
def _jax_confusion_and_miou(pred, label, n):
    cm = jmetrics.confusion_matrix(pred, label, n)
    return cm, jmetrics.miou_from_confusion(cm)


def test_confusion_matrix_and_miou_match_jax():
    """The confusion matrix and the mIoU bitwise, at class counts below and
    above the 32 values that XLA sums in one run (the JAX side jitted: one
    compile a class count in place of one an op)."""
    rng = np.random.default_rng(10)
    for n in (5, 7, 45, 150):
        pred = rng.integers(0, n, (3, 17, 19))
        lbl = rng.integers(0, n, (3, 17, 19))
        lbl[rng.random(lbl.shape) < 0.2] = 255
        lbl[lbl == n - 1] = 255  # a class absent from the labels
        want, want_miou = _jax_confusion_and_miou(jnp.asarray(pred),
                                                  jnp.asarray(lbl), n)
        got = metrics.confusion_matrix(torch.from_numpy(pred),
                                       torch.from_numpy(lbl), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.sum().item() == (lbl != 255).sum()
        np.testing.assert_array_equal(
            metrics.miou_from_confusion(got).numpy(),
            np.asarray(want_miou))
    assert metrics.miou_from_confusion(torch.zeros(4, 4)).item() == 0.0


def test_simple_fpn_matches_jax():
    """The deconvs' flipped kernels, the tanh GELU, the floor of the 2 × 2
    max pool and the ceil of the extra levels' stride-2 picks (a 5 × 6
    map)."""
    x = _images((2, 5, 6, 64), seed=11)
    fpn = heads.SimpleFPN(64, out_channels=32, num_outs=6)
    fpn.reset_parameters(torch.Generator().manual_seed(12))
    variables = _jax_vars(_moved(fpn))
    jfpn = jheads.SimpleFPN(backbone_channel=64, out_channels=32, num_outs=6)
    assert _structure(variables) == _structure(jax.eval_shape(
        jfpn.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(jfpn.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = fpn(torch.from_numpy(x))
        normed = heads.ChannelLayerNorm(64)(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [g.shape[1:3] for g in got] == [(20, 24), (10, 12), (5, 6),
                                           (2, 3), (1, 2), (1, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        normed.numpy(),
        np.asarray(jheads.ChannelLayerNorm().apply(
            {"params": {"weight": jnp.ones(64), "bias": jnp.zeros(64)}},
            jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_converter_round_trips_the_segmentor(norm):
    """Every leaf of the segmentor's variables (batch_stats included) and
    of a SimpleFPN's comes back exactly through both directions, the
    port's model takes the names, and an unknown leaf raises. That the
    names are flax's, the heads' BatchNorm ones included, the tests above
    hold against ``jax.eval_shape`` of flax's init."""
    seg = _port_segmentor(norm, channels=16)  # flax's names: tests above
    variables = to_jax_params({k: v.numpy()
                               for k, v in seg.state_dict().items()})
    assert ("batch_stats" in variables) == (norm == "bn")
    sd = from_jax_params(variables)
    assert sorted(sd) == sorted(seg.state_dict())
    for k, v in seg.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    want, got = _leaves(variables), _leaves(to_jax_params(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "params/backbone/outnorm_3_bias" in want
    fpn = heads.SimpleFPN(64)
    fpn.reset_parameters(torch.Generator().manual_seed(0))
    fsd = {k: v.numpy() for k, v in fpn.state_dict().items()}
    back = from_jax_params(to_jax_params(fsd))
    assert sorted(back) == sorted(fsd)
    for k in fsd:
        np.testing.assert_array_equal(back[k], fsd[k], err_msg=k)

    params = variables["params"]
    bad = {"params": dict(params, decode_head=dict(
        params["decode_head"], extra={"kernel": np.zeros(3)}))}
    with pytest.raises(ValueError, match="decode_head/extra"):
        from_jax_params(bad)
    if norm == "bn":
        stats = variables["batch_stats"]
        bad = dict(variables, batch_stats=dict(stats, aux_head=dict(
            stats["aux_head"], Stray_0={"mean": np.zeros(2)})))
        with pytest.raises(ValueError, match="Stray_0"):
            from_jax_params(bad)
    bad = dict(to_jax_params(fsd)["params"], neck={"kernel": np.zeros(2)})
    with pytest.raises(ValueError, match="neck"):
        from_jax_params(bad)
