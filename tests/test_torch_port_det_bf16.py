"""The port's cascade Mask R-CNN in bf16, as the JAX CLI's ``dtype: bf16``
builds it, against the JAX package's bf16 detector, on the CPU.

The detector is ``tests/test_torch_port_detection.py``'s tiny one (img
64, patch 16, FastVim depth 2, embed 32, d_state 4, 3 classes), its
backbone and every head built with the bf16 dtype on both sides from the
same fp32 weights (the port's init, carried to JAX by ``to_jax_params``),
and both packages' ``random_sample`` patched to one sampler that selects
with JAX's draws. The JAX applies are jitted.

bf16 rounding reorders the RPN's proposals (their scores are bf16 and
tie or swap across the two packages), so the stage losses and the
prediction are compared on JAX's proposals, replayed into the port: the
training ones into ``cascade_losses``, the eval ones into ``predict``
through ``_proposals``. The prediction's near-tied candidates may still
come out in swapped slots, so each JAX detection is matched to the
port's of the same label with the nearest box.

Tolerances: a bf16 rounding is 2⁻⁸ (0.4 %) of a value, and the two
packages round at different places (flax rounds a conv's output before
adding its bias, the CPU convolutions and GEMMs of XLA and PyTorch sum in
other orders, the elementwise chains keep fp32 for different spans), so
maps are held within a few roundings of their largest entry: the
backbone map and the FPN maps it gives 4e-2, the FPN maps and the RPN
outputs given JAX's inputs 2e-2; the losses (fp32 sums of bf16 terms, the
RPN's BCE in bf16) within 1e-2 relative; predicted boxes within 0.5 px,
scores within 2e-2 of the largest score, mask probabilities within 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models import detection as jdet
from fastvim_tpu.models.heads import SimpleFPN as JaxSimpleFPN
from fastvim_tpu_torch.cli import train_detection
from fastvim_tpu_torch.models import create_model, detection
from fastvim_tpu_torch.ops import boxes
from fastvim_tpu_torch.utils import to_jax_params
from test_torch_port_det_harness import (  # noqa: F401 (a fixture)
    _cli,
    _rows,
    tiny_cli_models,
)
from test_torch_port_detection import (
    DET,
    TINY,
    _gt,
    _moved,
    jax_sampler,
    port_sampler,
    tiny_batch,
)

BF16 = torch.bfloat16
N_IMG = 2


def _max_rel(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    return np.array(t, np.float32)


@pytest.fixture(scope="module")
def det16():
    """The port's bf16 detector and its JAX twin, a batch, and the JAX
    side's backbone map, FPN maps, RPN outputs, training and eval
    proposals, losses and prediction (both samplers patched)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdet, "random_sample", jax_sampler)
    mp.setattr(detection, "random_sample", port_sampler)
    gen = torch.Generator().manual_seed(1)
    backbone = create_model("fastvim_tiny", device="cpu", generator=gen,
                            dtype=BF16, **TINY)
    port = detection.CascadeMaskRCNN(backbone, dtype=BF16, **DET)
    port.reset_parameters(gen)
    _moved(port)
    jbackbone = jax_create_model("fastvim_tiny", layer_fused="off",
                                 scan_impl="ref", dtype=jnp.bfloat16, **TINY)
    jmodel = jdet.CascadeMaskRCNN(backbone=jbackbone, dtype=jnp.bfloat16,
                                  **DET)
    batch = tiny_batch(N_IMG)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.numpy() for k, v in port.state_dict().items()}))
    p = variables["params"]
    images = jnp.asarray(batch["image"])
    fpn = JaxSimpleFPN(DET["backbone_channel"], dtype=jnp.bfloat16)
    rpn = jdet.RPNHead(dtype=jnp.bfloat16)

    def heads(v, images):
        bmap = jbackbone.apply({"params": v["params"]["backbone"]},
                               images)[-1]
        feats = fpn.apply({"params": v["params"]["neck"]}, bmap)
        return bmap, feats, rpn.apply({"params": v["params"]["rpn"]}, feats)

    bmap, feats, (logits, deltas) = jax.jit(heads)(variables, images)
    anchors = jmodel._anchors(feats)
    slices = jmodel._level_slices(feats)
    proposals = {fast: [jax.jit(functools.partial(
        jmodel._proposals, slices=slices, fast=fast))(
            anchors, logits[b], deltas[b]) for b in range(N_IMG)]
        for fast in (True, False)}
    key = jax.random.PRNGKey(0)
    losses = jax.jit(lambda v, im, gt: jmodel.apply(
        v, im, **gt, rngs={"sampler": key}))(variables, images,
                                              _gt(batch, "jax"))
    pred = jax.jit(jmodel.apply)(variables, images)
    yield dict(port=port, p=p, batch=batch, bmap=bmap, feats=feats,
               logits=logits, deltas=deltas, proposals=proposals,
               losses=losses, pred=pred)
    mp.undo()


def test_bf16_fpn_and_rpn_match_jax(det16):
    """The backbone's map and the five FPN maps from the images, then the
    FPN on JAX's backbone map and the RPN on JAX's FPN maps: every map in
    bf16 on both sides (the backbone's normed map in fp32), each within a
    few bf16 roundings of its largest entry."""
    port = det16["port"]
    images = torch.from_numpy(det16["batch"]["image"])
    with torch.no_grad():
        bmap = port.backbone(images)[-1]
        feats = port.neck(bmap)
        assert bmap.dtype == torch.float32
        assert _max_rel(bmap, det16["bmap"]) <= 4e-2
        for got, want in zip(feats, det16["feats"]):
            assert got.dtype == BF16 and want.dtype == jnp.bfloat16
            assert _max_rel(got, _np(want)) <= 4e-2
        feats = port.neck(torch.from_numpy(_np(det16["bmap"])))
        for got, want in zip(feats, det16["feats"]):
            assert _max_rel(got, _np(want)) <= 2e-2
        jfeats = [torch.from_numpy(_np(f)).to(BF16) for f in det16["feats"]]
        logits, deltas = port.rpn(jfeats)
    assert logits.dtype == deltas.dtype == BF16
    assert _max_rel(logits, _np(det16["logits"])) <= 2e-2
    assert _max_rel(deltas, _np(det16["deltas"])) <= 2e-2


def test_bf16_losses_match_jax_on_its_proposals(det16):
    """The 11 losses under the shared sampler: the RPN's two from the
    port's own maps, the stages' and the masks' on JAX's training
    proposals replayed. The RPN's BCE stays bf16 on both sides, every
    other loss is fp32; the full forward gives the same dtypes."""
    port, batch, want = det16["port"], det16["batch"], det16["losses"]
    images = torch.from_numpy(batch["image"])
    gt = _gt(batch, "torch")
    gens = [torch.Generator()] * N_IMG
    props = det16["proposals"][True]
    jprops = torch.from_numpy(np.stack([_np(b) for b, _ in props]))
    jvalid = torch.from_numpy(np.stack([np.array(v) for _, v in props]))
    port.train()
    try:
        with torch.no_grad():
            feats = port.features(images)
            rpn, own, _ = port.rpn_losses(feats, *port.rpn(feats),
                                          gt["gt_boxes"], gt["gt_valid"],
                                          gens)
            got = {**rpn, **port.cascade_losses(feats, jprops, jvalid, **gt,
                                                generator=gens)}
            full = port(images, **gt, generator=gens)
    finally:
        port.eval()
    assert own.shape == jprops.shape
    assert sorted(got) == sorted(detection.LOSS_NAMES)
    for k in detection.LOSS_NAMES:
        dtype = BF16 if k == "rpn_cls" else torch.float32
        assert got[k].dtype == full[k].dtype == dtype, k
        assert str(want[k].dtype) == str(dtype).split(".")[1], k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-2,
                                   err_msg=k)
    assert torch.isfinite(full["loss"]) and full["loss"].dtype == torch.float32


def test_bf16_predict_matches_jax_on_its_proposals(det16, monkeypatch):
    """The prediction on JAX's eval proposals replayed: as many valid
    detections, each JAX detection matched by one of the port's with the
    same label, its box within 0.5 px, its score and mask probabilities
    within 2e-2; the masks bf16 on both sides."""
    port, want = det16["port"], det16["pred"]
    replay = iter([(torch.from_numpy(_np(b)), torch.from_numpy(np.array(v)))
                   for b, v in det16["proposals"][False]])
    monkeypatch.setattr(port, "_proposals", lambda *a, **k: next(replay))
    with torch.no_grad():
        got = port(torch.from_numpy(det16["batch"]["image"]))
    assert got["masks"].dtype == BF16 and want["masks"].dtype == jnp.bfloat16
    valid, labels = np.asarray(want["valid"]), np.asarray(want["labels"])
    boxes, scores = _np(want["boxes"]), _np(want["scores"])
    masks = _np(want["masks"])
    g_valid, g_labels = got["valid"].numpy(), got["labels"].numpy()
    g_boxes, g_scores = got["boxes"].numpy(), got["scores"].numpy()
    g_masks = got["masks"].float().numpy()
    assert valid.any() and g_valid.sum() == valid.sum()
    top = scores.max()
    for b, i in zip(*np.nonzero(valid)):
        cand = np.nonzero(g_valid[b] & (g_labels[b] == labels[b, i]))[0]
        assert cand.size, (b, i)
        j = cand[np.abs(g_boxes[b, cand] - boxes[b, i]).max(-1).argmin()]
        assert np.abs(g_boxes[b, j] - boxes[b, i]).max() <= 0.5, (b, i)
        assert abs(g_scores[b, j] - scores[b, i]) <= 2e-2 * top, (b, i)
        assert np.abs(g_masks[b, j] - masks[b, i]).max() <= 2e-2, (b, i)


def test_build_model_bf16_heads_over_fp32_parameters(tiny_cli_models):
    """``build_model`` with ``dtype: bf16``: every parameter fp32, the
    backbone and the heads computing in bf16 (FPN maps, RPN outputs, the
    bbox and mask heads' outputs), RoIAlign keeping a bf16 map bf16; with
    the shipped fp32 the same outputs in fp32."""
    cfg = dict(model="fastvim_tiny", img_size=64, patch_size=16,
               out_indices=[23], num_classes=3, layer_fused="off",
               det=dict(rpn_sample=16, nms_pre=32, num_proposals=16,
                        rcnn_sample=16))
    images = torch.randn(1, 64, 64, 3,
                         generator=torch.Generator().manual_seed(2))
    rois = torch.tensor([[4.0, 6.0, 40.0, 30.0], [10.0, 12.0, 60.0, 50.0]])
    for dtype, want in (("bf16", BF16), ("fp32", torch.float32)):
        model, depth = train_detection.build_model(
            {**cfg, "dtype": dtype}, torch.device("cpu"))
        assert depth == 24
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert model.dtype == model.backbone.dtype == want
        with torch.no_grad():
            feats = model.features(images)
            logits, deltas = model.rpn(feats)
            r7 = boxes.multilevel_roi_align([f[0] for f in feats[:4]], rois,
                                            7, detection.ROI_STRIDES)
            r14 = boxes.roi_align(feats[0][0], rois, 14, 0.25)
            cls, reg = model.stages[0].head(r7)
            mask = model.mask_head(r14)
        for t in (*feats, logits, deltas, r7, r14, cls, reg, mask):
            assert t.dtype == want


def test_train_detection_bf16_trains_and_evaluates(tmp_path,
                                                   tiny_cli_models):
    """``train_detection dtype=bf16`` (the registry at width 32): one
    epoch of 2 steps with finite losses in its log, then ``--eval_only``
    gives box and mask AP from its checkpoint."""
    _cli(tmp_path, "--epochs", "1", "dtype=bf16")
    rows = _rows(tmp_path / "log.csv")
    assert len(rows) == 1
    assert np.isfinite(float(rows[0]["train_loss"]))
    metrics = _cli(tmp_path, "--eval_only", "dtype=bf16")
    assert set(metrics) == {"box_ap50", "mask_ap50"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
