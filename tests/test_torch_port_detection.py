"""The port's cascade Mask R-CNN against the JAX package, on the CPU: its
heads, its 11 training losses, their sum and every parameter's gradient,
its prediction, the converter both ways and the ViTDet LR scales
(``tests/test_torch_port_det_harness.py`` holds the data, the metrics,
the configs and the CLI).

The detector is tiny: img 64, patch 16, FastVim depth 2, embed 32, d_state
4, 3 classes, ``out_indices`` (1,) (a rotated layer), ``rpn_sample`` 16,
``nms_pre`` 32, ``num_proposals`` 16, ``rcnn_sample`` 16, ``max_gt`` 4.
Its weights are the port's init (norms moved off their init values),
carried to JAX by ``to_jax_params``; the tree's names and shapes are held
against ``jax.eval_shape`` of flax's init, and the JAX applies are
jitted (an eager flax init of this detector takes about a minute). Both
packages' ``random_sample`` are patched to one sampler that selects with
JAX's draws from a fixed key, so that both sample the same boxes. The
JAX backbone runs unfused with the sequential reference scan.
Tolerances, fp32: head outputs, losses and predicted boxes and scores
rtol = atol = 1e-4; gradients within 1e-4 of each tensor's largest
entry; prediction validity and labels exactly.

ReLU is not differentiable at 0: a fc1 / fc2 pre-activation of the bbox
heads within rounding of 0 can be kept by one package and dropped by the
other, and a row of those layers' weight gradient sums over only 32 RoIs,
so one such element moves it by about 1e-2 of its largest entry. The
gradient test therefore takes JAX's fc1 / fc2 pre-activations (captured
through the stage scan) and makes the port's heads keep the elements JAX
keeps; it asserts that every element whose own mask differs lies within
1e-4 of the layer's largest pre-activation of 0.
"""

import contextlib

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models import detection as jdet
from fastvim_tpu.ops import boxes as jboxes
from fastvim_tpu.train import optim as joptim
from fastvim_tpu_torch.models import create_model, detection
from fastvim_tpu_torch.ops import boxes
from fastvim_tpu_torch.train import vitdet_layer_decay_scales
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

IMG, MAX_GT, NC = 64, 4, 3
TINY = dict(img_size=IMG, patch_size=16, depth=2, embed_dim=32,
            num_classes=0, out_indices=(1,), drop_path_rate=0.0,
            ssm_cfg=dict(d_state=4))
DET = dict(num_classes=NC, backbone_channel=32, img_size=IMG, rpn_sample=16,
           nms_pre=32, num_proposals=16, rcnn_sample=16)
TOL = dict(rtol=1e-4, atol=1e-4)
SAMPLE_KEY = 7


def tiny_batch(B=2, seed=0):
    """``tests/test_detection.py``'s batch: 2 painted objects an image."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    gtb = np.zeros((B, MAX_GT, 4), np.float32)
    labels = np.zeros((B, MAX_GT), np.int32)
    masks = np.zeros((B, MAX_GT, IMG, IMG), np.uint8)
    valid = np.zeros((B, MAX_GT), bool)
    for i in range(B):
        for g in range(2):
            x1, y1 = rng.uniform(4, 30, 2)
            w, h = rng.uniform(12, 24, 2)
            gtb[i, g] = [x1, y1, min(x1 + w, IMG - 1), min(y1 + h, IMG - 1)]
            labels[i, g] = rng.integers(0, NC)
            b = gtb[i, g].astype(int)
            masks[i, g, b[1]:b[3], b[0]:b[2]] = 1
            images[i, b[1]:b[3], b[0]:b[2]] += 2.0 + labels[i, g]
        valid[i, :2] = True
    return dict(image=images, boxes=gtb, labels=labels, masks=masks,
                gt_valid=valid)


_DRAWS = {}


def _draws(n):
    """JAX's two uniform draws of ``random_sample`` from the fixed key."""
    if n not in _DRAWS:
        r_pos, r_neg = jax.random.split(jax.random.PRNGKey(SAMPLE_KEY))
        _DRAWS[n] = tuple(np.array(jax.random.uniform(r, (n,)))
                          for r in (r_pos, r_neg))
    return _DRAWS[n]


def jax_sampler(rng, assigned, num, pos_fraction):
    return jboxes.random_sample(jax.random.PRNGKey(SAMPLE_KEY), assigned,
                                num, pos_fraction)


def port_sampler(generator, assigned, num, pos_fraction):
    u_pos, u_neg = (torch.from_numpy(u) for u in _draws(assigned.shape[0]))
    return boxes.sample_from_draws(assigned, u_pos, u_neg, num, pos_fraction)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _structure(tree):
    return jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), tree)


@torch.no_grad()
def _moved(module, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if t.dim() == 1 and "norm" in name:
            t.add_(0.5 * torch.rand(t.shape, generator=gen))
    return module


def port_detector():
    gen = torch.Generator().manual_seed(1)
    backbone = create_model("fastvim_tiny", device="cpu", generator=gen,
                            **TINY)
    model = detection.CascadeMaskRCNN(backbone, **DET)
    model.reset_parameters(gen)
    return _moved(model)


def jax_detector():
    backbone = jax_create_model("fastvim_tiny", layer_fused="off",
                                scan_impl="ref", **TINY)
    return jdet.CascadeMaskRCNN(backbone=backbone, **DET)


def _gt(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return dict(gt_boxes=conv(batch["boxes"]), gt_labels=conv(batch["labels"]),
                gt_masks=conv(batch["masks"]), gt_valid=conv(batch["gt_valid"]))


@pytest.fixture(scope="module")
def det():
    """The port's detector, its JAX twin and weights, a batch, and the
    JAX side's jitted losses, gradients, fc1 / fc2 pre-activations and
    prediction (both packages' samplers patched for the module)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdet, "random_sample", jax_sampler)
    mp.setattr(detection, "random_sample", port_sampler)
    port, jmodel = port_detector(), jax_detector()
    batch = tiny_batch()
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in port.state_dict().items()}))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key}, jnp.asarray(batch["image"])))
    scan = nn.scan

    def scan_keeping_intermediates(target, variable_axes, **kw):
        return scan(target, variable_axes={**variable_axes,
                                           "intermediates": 0}, **kw)

    def loss_fn(v, images, gt):
        losses, inter = jmodel.apply(
            v, images, **gt, rngs={"sampler": key}, mutable=["intermediates"],
            capture_intermediates=lambda m, _: m.name in ("fc1", "fc2"))
        return losses["loss"], (losses, inter)

    def train_and_predict(v, images, gt):
        return (jax.value_and_grad(loss_fn, has_aux=True)(v, images, gt),
                jmodel.apply(v, images))

    with mp.context() as scoped:
        scoped.setattr(nn, "scan", scan_keeping_intermediates)
        ((_, (losses, inter)), grads), pred = jax.jit(train_and_predict)(
            variables, jnp.asarray(batch["image"]), _gt(batch, "jax"))
    heads = inter["intermediates"]["stages"]["head"]
    pre = {k: np.asarray(heads[k]["__call__"][0]) for k in ("fc1", "fc2")}
    yield dict(port=port, jmodel=jmodel, variables=variables, shapes=shapes,
               batch=batch, losses=losses, grads=grads, pred=pred, pre=pre)
    mp.undo()


class JaxReluBranch:
    """While entered, the port's bbox heads keep the fc1 / fc2 elements
    that JAX's pre-activations ``pre`` ((3 stages, RoIs, 1024) each) keep,
    stage after stage; ``worst`` is the largest |pre-activation| of an
    element whose own mask differs, relative to its layer's largest."""

    def __init__(self, pre):
        self.pre, self.calls, self.flips, self.worst = pre, 0, 0, 0.0

    @contextlib.contextmanager
    def patched(self):
        head_cls = detection.Shared2FCBBoxHead
        original = head_cls.forward
        branch = self

        def forward(head, roi_feats):
            s = branch.calls
            branch.calls += 1
            x = roi_feats.reshape(roi_feats.shape[0], -1)
            x = branch.relu(head.fc1(x), "fc1", s)
            x = branch.relu(head.fc2(x), "fc2", s)
            return head.cls(x), head.reg(x)

        head_cls.forward = forward
        try:
            yield self
        finally:
            head_cls.forward = original

    def relu(self, y, name, s):
        keep = torch.from_numpy(self.pre[name][s] > 0)
        own = y.detach()
        flip = (own > 0) != keep
        self.flips += int(flip.sum())
        if flip.any():
            self.worst = max(self.worst, float(
                own[flip].abs().max() / own.abs().max()))
        return torch.where(keep, y, torch.zeros_like(y))


def test_detector_tree_matches_flax_init(det):
    """The port's state_dict, through the converter, has flax's tree:
    ``stages/head`` stacked (3, …), ``mask_head/upsample`` a deconv."""
    assert _structure(det["variables"]) == _structure(det["shapes"])
    head = det["variables"]["params"]["stages"]["head"]
    assert head["fc1"]["kernel"].shape == (3, 7 * 7 * 256, 1024)
    assert set(det["variables"]["params"]) == {
        "backbone", "neck", "rpn", "stages", "mask_head"}


def test_heads_match_jax(det):
    """RPNHead on five maps, one stage's Shared2FCBBoxHead and the
    FCNMaskHead, fed the same seeded features."""
    port, p = det["port"], det["variables"]["params"]
    rng = np.random.default_rng(4)
    maps = [rng.normal(size=(2, s, s, 256)).astype(np.float32)
            for s in (16, 8, 4, 2, 1)]
    want = jax.jit(jdet.RPNHead().apply)({"params": p["rpn"]}, maps)
    with torch.no_grad():
        got = port.rpn([torch.from_numpy(m) for m in maps])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    r7 = rng.normal(size=(5, 7, 7, 256)).astype(np.float32)
    stage1 = jax.tree_util.tree_map(lambda a: a[1], p["stages"]["head"])
    want = jax.jit(jdet.Shared2FCBBoxHead(NC).apply)({"params": stage1}, r7)
    with torch.no_grad():
        got = port.stages[1].head(torch.from_numpy(r7))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    r14 = rng.normal(size=(3, 14, 14, 256)).astype(np.float32)
    want = jax.jit(jdet.FCNMaskHead(NC).apply)({"params": p["mask_head"]},
                                              r14)
    with torch.no_grad():
        got = port.mask_head(torch.from_numpy(r14))
    assert got.shape == (3, 28, 28, NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        detection.smooth_l1(torch.linspace(-1, 1, 41), torch.zeros(41),
                            1 / 9).numpy(),
        np.asarray(jdet.smooth_l1(jnp.linspace(-1, 1, 41), 0.0, 1 / 9)),
        rtol=1e-6, atol=1e-7)


def test_train_losses_and_gradients_match_jax(det):
    """The 11 losses and their sum, then the gradient of every parameter,
    under the shared sampler; through the decomposed methods too."""
    port, batch = det["port"], det["batch"]
    port.train()
    images = torch.from_numpy(batch["image"])
    branch = JaxReluBranch(det["pre"])
    with branch.patched():
        losses = port(images, **_gt(batch, "torch"),
                      generator=[torch.Generator().manual_seed(0)]
                      * images.shape[0])
    assert branch.calls == 3 and branch.worst <= 1e-4, (branch.flips,
                                                        branch.worst)
    assert list(losses) == [*detection.LOSS_NAMES, "loss"]
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(det["losses"][k]), **TOL,
                                   err_msg=k)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(losses["loss"], list(params.values()))
    want = from_jax_params(det["grads"])
    assert set(want) == set(params)
    for (name, p), g in zip(params.items(), grads):
        assert _rel_err(g.numpy(), want[name]) <= 1e-4, name
    # the decomposition: the cascade given the RPN's proposals
    with torch.no_grad():
        feats = port.features(images)
        gt = _gt(batch, "torch")
        rpn, props, pvalid = port.rpn_losses(
            feats, *port.rpn(feats), gt["gt_boxes"], gt["gt_valid"],
            [torch.Generator()] * images.shape[0])
        casc = port.cascade_losses(
            feats, props, pvalid, **gt,
            generator=[torch.Generator()] * images.shape[0])
    assert props.shape == (2, 16, 4) and pvalid.dtype == torch.bool
    for k, v in {**rpn, **casc}.items():
        np.testing.assert_allclose(float(v), losses[k].item(), rtol=1e-6,
                                   err_msg=k)
    port.eval()


def test_predict_matches_jax(det):
    """The prediction dict: ``valid`` and the labels exactly, boxes,
    scores and masks on the valid slots."""
    port, want = det["port"], det["pred"]
    with torch.no_grad():
        got = port(torch.from_numpy(det["batch"]["image"]))
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.any()
    np.testing.assert_array_equal(got["labels"].numpy()[valid],
                                  np.asarray(want["labels"])[valid])
    for k in ("boxes", "scores", "masks"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], **TOL,
                                   err_msg=k)


def test_converter_round_trip(det):
    """from_jax_params ∘ to_jax_params is the identity on the detector's
    state_dict; an unknown leaf raises."""
    sd = {k: v.numpy() for k, v in det["port"].state_dict().items()}
    back = from_jax_params(to_jax_params(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back["mask_head.upsample.weight"].shape == (256, 256, 2, 2)
    tree = to_jax_params(sd)
    tree["params"]["mask_head"]["conv9"] = {"kernel": np.zeros((1,))}
    with pytest.raises(ValueError, match="no port name"):
        from_jax_params(tree)


def test_vitdet_scales_match_jax(det):
    """Every parameter's ViTDet LR scale equals JAX's for its leaf."""
    port, variables = det["port"], det["variables"]
    want = joptim.vitdet_layer_decay_scales(variables, 0.7, num_layers=2)
    full = from_jax_params(jax.tree_util.tree_map(
        lambda s, p: np.full(np.shape(p), s), want, variables))
    got = vitdet_layer_decay_scales(port, 0.7, num_layers=2)
    assert set(got) == set(full)
    for name, s in got.items():
        np.testing.assert_allclose(full[name], s, rtol=1e-12, err_msg=name)
    assert got["backbone.pos_embed"] == pytest.approx(0.7 ** 3)
    assert got["backbone.layers.1.mixer.in_proj.weight"] == pytest.approx(0.7)
    assert got["backbone.outnorm_0.weight"] == got["rpn.rpn_cls.bias"] == 1.0
