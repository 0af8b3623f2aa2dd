"""ViTDet cascade Mask R-CNN: backbone → SimpleFPN → RPN → three cascade
bbox stages → a shared FCN mask head.

Counterpart of ``fastvim_tpu/models/detection.py`` (the mmdetection
recipe cascade-mask-rcnn_r50_fpn.py): an RPN with sigmoid-BCE and
SmoothL1 (β = 1/9) losses, three Shared2FC bbox stages with IoU
thresholds 0.5 / 0.6 / 0.7, per-stage target stds and loss weights 1 /
0.5 / 0.25, and the mask head trained on each stage's positives. Box sets
keep the JAX package's fixed sizes and validity masks. NHWC at the module
boundaries; the RoI features are NHWC too, so ``fc1`` reads the same
flatten of (7, 7, C) as the flax ``Dense``.

``dtype`` (bf16 in the JAX CLI's ``dtype: bf16``) is the heads'
computation dtype, as flax's ``dtype=``: fp32 parameters, the inputs and
weights of every conv and dense layer cast to it, its outputs in it.
RoIAlign keeps a map's dtype (fp32 coordinates and hat weights); anchors,
box deltas, IoUs, the assigner and the sampler stay fp32, and the losses
take fp32 where the JAX model casts them (the stage CE and SmoothL1, the
mask BCE; the RPN's SmoothL1 by promotion against its fp32 targets, its
BCE in the logits' dtype).

PyTorch idiom in place of flax's:

* the ``nn.scan`` over the stages is a loop over ``stages`` (an
  ``nn.ModuleList`` of three ``head``s, ``stages.{s}.head``); the JAX
  ``vmap`` over images is a loop over the batch;
* ``model.train()`` / ``model.eval()`` switch the backbone's DropPath;
  the path (losses or prediction) follows from whether ``gt_boxes`` is
  given, as in JAX;
* the samplers draw from the ``generator`` the caller hands the forward,
  a sequence of generators, one per image: each image's RPN sample,
  then its stage samples, from its own. The train step seeds each from
  (seed, step, the image's index in the global batch), so that an
  image's draws do not depend on the other images, nor on the rank that
  holds it; ``[gen] * B`` draws every image's samples from one
  generator, image after image. A CPU generator gives the same draws
  wherever the model runs;
* over several ranks the stage and mask losses' denominators (the valid
  samples, the positives) are counted over the global batch
  (``parallel.denominator``), as the JAX program counts them.

The forward is also split into methods that can be called alone
(:meth:`features`, :meth:`rpn_losses`, :meth:`cascade_losses`,
:meth:`predict`), so that two runs can share one set of proposals.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastvim_tpu_torch.models.heads import SimpleFPN
from fastvim_tpu_torch.models.layers import lecun_normal_init_
from fastvim_tpu_torch.models.upernet import conv_nhwc
from fastvim_tpu_torch.ops.boxes import (
    delta_decode,
    delta_encode,
    fast_nms,
    generate_anchors,
    hat_matrices,
    max_iou_assign,
    multilevel_roi_align,
    nms,
    random_sample,
    top_k_indices,
)
from fastvim_tpu_torch.parallel import denominator

# cascade recipe constants (cascade-mask-rcnn_r50_fpn.py)
STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
STAGE_WEIGHTS = (1.0, 0.5, 0.25)
FPN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)

LOSS_NAMES = ("rpn_cls", "rpn_reg", "s0_cls", "s0_reg", "s1_cls", "s1_reg",
              "s2_cls", "s2_reg", "s0_mask", "s1_mask", "s2_mask")


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def _bce_with_logits(logit: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """max(x, 0) − x·t + log1p(exp(−|x|)), elementwise, as written in the
    JAX package."""
    return (logit.clamp_min(0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


def _reset_flax(module: nn.Module, generator: torch.Generator) -> None:
    """flax's ``Dense`` / ``Conv`` / ``ConvTranspose`` init: a
    lecun-normal kernel, a zero bias."""
    w = module.weight
    if isinstance(module, nn.Linear):
        fan_in = w.shape[1]
    elif isinstance(module, nn.ConvTranspose2d):
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]
    else:
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    lecun_normal_init_(w, fan_in, generator)
    nn.init.zeros_(module.bias)


class RPNHead(nn.Module):
    """A shared 3 × 3 conv, then 1 × 1 objectness and delta convs, over
    every pyramid level (mmdet RPNHead; 3 anchors a position), in
    ``dtype``."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3,
                 feat_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            _reset_flax(m, generator)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats: NHWC maps. Returns logits (B, Σ H·W·A) and deltas
        (B, Σ H·W·A, 4), in the anchors' order."""
        logits, deltas = [], []
        for f in feats:
            h = torch.relu(conv_nhwc(self.rpn_conv, f, self.dtype))
            B = h.shape[0]
            logits.append(conv_nhwc(self.rpn_cls, h, self.dtype).reshape(
                B, -1))
            deltas.append(conv_nhwc(self.rpn_reg, h, self.dtype).reshape(
                B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class Shared2FCBBoxHead(nn.Module):
    """flatten(7·7·C, NHWC) → fc 1024 → fc 1024 → {cls (K+1), reg 4}
    (mmdet Shared2FCBBoxHead, class-agnostic regression), in ``dtype``."""

    def __init__(self, in_features: int, num_classes: int,
                 fc_out: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, fc_out)
        self.fc2 = nn.Linear(fc_out, fc_out)
        self.cls = nn.Linear(fc_out, num_classes + 1)
        self.reg = nn.Linear(fc_out, 4)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.fc1, self.fc2, self.cls, self.reg):
            _reset_flax(m, generator)

    def dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``layer`` on x, both cast to ``dtype``."""
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = torch.relu(self.dense(self.fc1, x))
        x = torch.relu(self.dense(self.fc2, x))
        return self.dense(self.cls, x), self.dense(self.reg, x)


class FCNMaskHead(nn.Module):
    """4 × (3 × 3 conv, ReLU) → 2 × 2 deconv stride 2, ReLU → 1 × 1
    per-class mask logits (mmdet FCNMaskHead: 14² RoIs → 28² masks),
    NHWC, in ``dtype``. The deconv's weight holds the flax kernel flipped
    on both spatial axes (``utils/convert.py``)."""

    def __init__(self, in_channels: int, num_classes: int,
                 channels: int = 256, num_convs: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        self.dtype = dtype
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1))
        self.upsample = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.logits = nn.Conv2d(channels, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_convs):
            _reset_flax(getattr(self, f"conv{i}"), generator)
        _reset_flax(self.upsample, generator)
        _reset_flax(self.logits, generator)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats
        for i in range(self.num_convs):
            x = torch.relu(conv_nhwc(getattr(self, f"conv{i}"), x,
                                     self.dtype))
        x = torch.relu(conv_nhwc(self.upsample, x, self.dtype))
        return conv_nhwc(self.logits, x, self.dtype)


class CascadeStage(nn.Module):
    """One cascade stage's bbox head (``stages.{s}.head``)."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = Shared2FCBBoxHead(in_features, num_classes, dtype=dtype)


class CascadeMaskRCNN(nn.Module):
    """Backbone → SimpleFPN → RPN → 3-stage cascade + mask head.

    ``backbone`` returns a single NHWC stride-16 map, or a list whose last
    entry is one (a ``VisionMamba`` with ``out_indices=[depth − 1]``).
    ``forward(images, gt_boxes, gt_labels, gt_masks, gt_valid,
    generator=...)`` returns the 11 losses and their sum ``"loss"``;
    ``forward(images)`` the prediction dict. Ground truth comes padded:
    boxes (B, G, 4) xyxy, labels (B, G), masks (B, G, H, W) {0, 1},
    gt_valid (B, G) bool. ``dtype``: the heads' computation dtype (the
    backbone keeps its own)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 backbone_channel: int = 768, fpn_channels: int = 256,
                 img_size: int = 1024, rpn_sample: int = 256,
                 nms_pre: int = 1000, num_proposals: int = 512,
                 rcnn_sample: int = 512, mask_size: int = 28,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = backbone
        self.num_classes = num_classes
        self.img_size = img_size
        self.rpn_sample = rpn_sample
        self.nms_pre = nms_pre
        self.num_proposals = num_proposals
        self.rcnn_sample = rcnn_sample
        self.mask_size = mask_size
        self.neck = SimpleFPN(backbone_channel, fpn_channels, dtype=dtype)
        self.rpn = RPNHead(fpn_channels, dtype=dtype)
        self.stages = nn.ModuleList(
            CascadeStage(7 * 7 * fpn_channels, num_classes, dtype=dtype)
            for _ in STAGE_IOUS)
        self.mask_head = FCNMaskHead(fpn_channels, num_classes, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The heads' flax initializers, from ``generator`` (the backbone
        keeps its own)."""
        self.neck.reset_parameters(generator)
        self.rpn.reset_parameters(generator)
        for stage in self.stages:
            stage.head.reset_parameters(generator)
        self.mask_head.reset_parameters(generator)

    def set_drop_path_generator(self, generator: Optional[torch.Generator]
                                ) -> None:
        if hasattr(self.backbone, "set_drop_path_generator"):
            self.backbone.set_drop_path_generator(generator)

    # ------------------------------------------------------------------
    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) → the five FPN maps (strides 4-64), NHWC."""
        out = self.backbone(images)
        if isinstance(out, (tuple, list)):
            out = out[-1]
        return self.neck(out)

    @staticmethod
    def anchors(feats: Sequence[torch.Tensor]) -> torch.Tensor:
        sizes = [(f.shape[1], f.shape[2]) for f in feats]
        return torch.from_numpy(generate_anchors(sizes, FPN_STRIDES)).to(
            feats[0].device)

    @staticmethod
    def _level_slices(feats) -> List[Tuple[int, int]]:
        sizes = [f.shape[1] * f.shape[2] * 3 for f in feats]
        offs = [0]
        for n in sizes:
            offs.append(offs[-1] + n)
        return list(zip(offs[:-1], offs[1:]))

    def _proposals(self, anchors, logits_i, deltas_i, slices,
                   fast: bool = False):
        """Per-level top ``nms_pre`` → joint NMS at IoU 0.7 →
        (num_proposals, 4) boxes and their validity (mmdet
        rpn_proposal). ``fast`` takes the one-shot matrix NMS (training),
        else the exact one (eval)."""
        top_boxes, top_scores = [], []
        for a, b in slices:
            k = min(self.nms_pre, b - a)
            sc = logits_i[a:b]
            idx = top_k_indices(sc, k)
            top_boxes.append(delta_decode(
                anchors[a:b][idx], deltas_i[a:b][idx],
                max_shape=(self.img_size, self.img_size)))
            top_scores.append(sc[idx])
        boxes = torch.cat(top_boxes)
        scores = torch.cat(top_scores)
        wh_ok = (((boxes[:, 2] - boxes[:, 0]) > 1e-3)
                 & ((boxes[:, 3] - boxes[:, 1]) > 1e-3))
        scores = torch.where(wh_ok, scores,
                             torch.full_like(scores, -math.inf))
        keep, valid = (fast_nms if fast else nms)(boxes, scores, 0.7,
                                                  self.num_proposals)
        return boxes[keep], valid

    # ------------------------------------------------------------------
    def rpn_losses(self, feats, rpn_logits, rpn_deltas, gt_boxes, gt_valid,
                   generator: Sequence[torch.Generator]):
        """The RPN's losses (each image: max-IoU assignment at 0.7 / 0.3
        with low-quality matches, ``rpn_sample`` anchors at half
        positives; BCE and SmoothL1 over the sample, averaged over the
        images) and its training proposals (fast NMS, no gradient).
        Returns ({"rpn_cls", "rpn_reg"}, proposals (B, P, 4), valid (B,
        P))."""
        anchors = self.anchors(feats)
        slices = self._level_slices(feats)
        cls_l, reg_l, props, pvalid = [], [], [], []
        for b in range(rpn_logits.shape[0]):
            gtb, gtv = gt_boxes[b], gt_valid[b]
            assigned = max_iou_assign(anchors, gtb, gtv, pos_iou_thr=0.7,
                                      neg_iou_thr=0.3, min_pos_iou=0.3,
                                      match_low_quality=True)
            idx, is_pos, valid = random_sample(generator[b], assigned,
                                               self.rpn_sample, 0.5)
            logit = rpn_logits[b, idx]
            bce = _bce_with_logits(logit, is_pos.to(logit.dtype))
            denom = valid.sum().clamp_min(1)
            cls_l.append((bce * valid).sum() / denom)
            g = assigned[idx].clamp_min(0)
            reg_t = delta_encode(anchors[idx], gtb[g])
            reg = smooth_l1(rpn_deltas[b, idx], reg_t, beta=1.0 / 9.0)
            reg_l.append((reg.sum(-1) * (is_pos & valid)).sum() / denom)
            with torch.no_grad():
                pb, pv = self._proposals(anchors, rpn_logits[b].detach(),
                                         rpn_deltas[b].detach(), slices,
                                         fast=True)
            props.append(pb)
            pvalid.append(pv)
        losses = {"rpn_cls": torch.stack(cls_l).mean(),
                  "rpn_reg": torch.stack(reg_l).mean()}
        return losses, torch.stack(props), torch.stack(pvalid)

    def _stage_sample(self, s, props_i, pvalid_i, gtb, gtv, gtl, gtm, feats_i,
                      generator):
        """One image's stage-``s`` sample: assignment, sampling, targets,
        7² and 14² RoI features and 28² mask targets."""
        N, iou = self.rcnn_sample, STAGE_IOUS[s]
        cand = torch.cat([props_i, gtb])
        cand_valid = torch.cat([pvalid_i, gtv])
        assigned = max_iou_assign(cand, gtb, gtv, pos_iou_thr=iou,
                                  neg_iou_thr=iou, min_pos_iou=iou,
                                  match_low_quality=False)
        assigned = torch.where(cand_valid, assigned,
                               torch.full_like(assigned, -2))
        idx, is_pos, valid = random_sample(generator, assigned, N, 0.25)
        rois = cand[idx]
        g = assigned[idx].clamp_min(0)
        lbl = torch.where(is_pos, gtl[g].long(),
                          torch.full_like(g, self.num_classes))
        regt = delta_encode(rois, gtb[g], stds=STAGE_STDS[s])
        rfeat7 = multilevel_roi_align(feats_i, rois, 7, ROI_STRIDES)
        # the mask branch on the positives only, packed into M slots (the
        # sampler caps them at M)
        M = max(1, int(N * 0.25))
        pos_rank = torch.cumsum(is_pos, 0) - 1
        slot = torch.where(is_pos, pos_rank, torch.full_like(pos_rank, M))
        midx = torch.zeros(M + 1, dtype=torch.long, device=idx.device)
        midx.scatter_(0, slot, torch.arange(N, device=idx.device))
        midx = midx[:M]
        mvalid = torch.arange(M, device=idx.device) < (is_pos & valid).sum()
        rois_m = rois[midx]
        rfeat14 = multilevel_roi_align(feats_i, rois_m, 14, ROI_STRIDES)
        with torch.no_grad():
            mt = self._mask_targets(gtm, g[midx], rois_m)
        return (rois, rfeat7, rfeat14, lbl, regt, is_pos, valid, mt,
                lbl[midx], mvalid)

    def _mask_targets(self, gt_masks, gt_idx, rois) -> torch.Tensor:
        """RoIAlign of each RoI's {0, 1} gt mask at ``mask_size``², then
        > 0.5: (M, mask_size, mask_size) float32."""
        masks = gt_masks[gt_idx].float()  # (M, H, W)
        H, W = masks.shape[1:]
        Y, X = hat_matrices(rois, H, W, self.mask_size, 1.0)
        tmp = X @ masks.transpose(1, 2)            # (M, j, H)
        crop = Y @ tmp.transpose(1, 2)             # (M, i, j)
        return (crop > 0.5).float()

    def cascade_losses(self, feats, props, pvalid, gt_boxes, gt_labels,
                       gt_masks, gt_valid,
                       generator: Sequence[torch.Generator]
                       ) -> Dict[str, torch.Tensor]:
        """The three stages' cls / reg losses and their mask losses, from
        proposals (B, P, 4) and their validity (no gradient), padded to
        max(P, rcnn_sample); each stage refines its sampled RoIs into the
        next stage's proposals."""
        B, N = props.shape[0], self.rcnn_sample
        if props.shape[1] < N:
            pad = N - props.shape[1]
            props = F.pad(props, (0, 0, 0, pad))
            pvalid = F.pad(pvalid, (0, pad))
        Wc = props.shape[1]
        feats4 = feats[:len(ROI_STRIDES)]
        losses: Dict[str, torch.Tensor] = {}
        masks_in = []
        for s, stage in enumerate(self.stages):
            per = [self._stage_sample(s, props[b], pvalid[b], gt_boxes[b],
                                      gt_valid[b], gt_labels[b], gt_masks[b],
                                      [f[b] for f in feats4],
                                      generator[b])
                   for b in range(B)]
            (rois_b, rfeat7, rfeat14, labels, regt, is_pos, valid, mt, mlab,
             mvalid) = (torch.stack(t) for t in zip(*per))
            cls_logits, reg = stage.head(rfeat7.reshape(B * N,
                                                        *rfeat7.shape[2:]))
            labels, valid = labels.reshape(B * N), valid.reshape(B * N)
            is_pos, regt = is_pos.reshape(B * N), regt.reshape(B * N, 4)
            w = STAGE_WEIGHTS[s]
            denom = denominator(valid.sum())
            ce = -torch.log_softmax(cls_logits.float(), -1).gather(
                1, labels[:, None])[:, 0]
            losses[f"s{s}_cls"] = w * (ce * valid).sum() / denom
            rl = smooth_l1(reg.float(), regt, beta=1.0)
            losses[f"s{s}_reg"] = w * (rl.sum(-1) * (is_pos & valid)).sum() \
                / denom
            # refine the sampled RoIs for the next stage, padded back
            props = delta_decode(rois_b, reg.detach().reshape(B, N, 4),
                                 stds=STAGE_STDS[s],
                                 max_shape=(self.img_size, self.img_size))
            props = F.pad(props, (0, 0, 0, Wc - N))
            pvalid = F.pad(valid.reshape(B, N), (0, Wc - N))
            masks_in.append((rfeat14, mt, mlab, mvalid))

        # the shared mask head, once, on the three stages' stacked RoIs
        rfeat14 = torch.stack([m[0] for m in masks_in])  # (3, B, M, 14, 14, C)
        M = rfeat14.shape[2]
        mask_logits = self.mask_head(rfeat14.reshape(3 * B * M,
                                                     *rfeat14.shape[3:]))
        mpos = torch.stack([m[3] for m in masks_in]).reshape(3, B * M)
        mlab = torch.stack([m[2] for m in masks_in]).reshape(3 * B * M)
        mt = torch.stack([m[1] for m in masks_in]).reshape(
            3 * B * M, self.mask_size, self.mask_size)
        sel = mask_logits.gather(
            -1, mlab.clamp(0, self.num_classes - 1)[:, None, None, None]
            .expand(-1, *mask_logits.shape[1:3], 1))[..., 0].float()
        per = _bce_with_logits(sel, mt).mean((1, 2)).reshape(3, B * M)
        for s in range(len(self.stages)):
            losses[f"s{s}_mask"] = STAGE_WEIGHTS[s] * (
                per[s] * mpos[s]).sum() / denominator(mpos[s].sum())
        return losses

    # ------------------------------------------------------------------
    def forward(self, images: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, *,
                generator: Optional[Sequence[torch.Generator]] = None):
        feats = self.features(images)
        rpn_logits, rpn_deltas = self.rpn(feats)
        if gt_boxes is None:
            return self.predict(feats, rpn_logits, rpn_deltas)
        if generator is None:
            raise ValueError("the training forward samples: pass generator="
                             "a torch.Generator per image")
        losses, props, pvalid = self.rpn_losses(
            feats, rpn_logits, rpn_deltas, gt_boxes, gt_valid, generator)
        losses.update(self.cascade_losses(feats, props, pvalid, gt_boxes,
                                          gt_labels, gt_masks, gt_valid,
                                          generator))
        losses = {k: losses[k] for k in LOSS_NAMES}
        total = losses["rpn_cls"]
        for k in LOSS_NAMES[1:]:
            total = total + losses[k]
        losses["loss"] = total
        return losses

    def predict(self, feats, rpn_logits, rpn_deltas,
                max_per_img: int = 100) -> Dict[str, torch.Tensor]:
        """Cascade inference: exact-NMS proposals refined through the
        three stages, the stages' softmax scores averaged, class-wise NMS
        at 0.5 on the top 4·``max_per_img`` (class, box) candidates, the
        mask head on the survivors. Returns padded (B, max_per_img, …)
        "boxes", "scores" (0 where not valid), "labels", "valid" (NMS kept
        and score > 0.05) and "masks" (28² probabilities)."""
        anchors = self.anchors(feats)
        slices = self._level_slices(feats)
        B = rpn_logits.shape[0]
        K = self.num_classes
        per = [self._proposals(anchors, rpn_logits[b], rpn_deltas[b], slices)
               for b in range(B)]
        rois = torch.stack([p[0] for p in per])       # (B, P, 4)
        pvalid = torch.stack([p[1] for p in per])
        P = rois.shape[1]
        feats4 = feats[:len(ROI_STRIDES)]
        scores_sum = rois.new_zeros(B, P, K + 1, dtype=torch.float32)
        for s, stage in enumerate(self.stages):
            rfeat = torch.stack([
                multilevel_roi_align([f[b] for f in feats4], rois[b], 7,
                                     ROI_STRIDES) for b in range(B)])
            cls_logits, reg = stage.head(rfeat.reshape(B * P,
                                                       *rfeat.shape[2:]))
            scores_sum = scores_sum + torch.softmax(
                cls_logits.reshape(B, P, -1).float(), -1)
            rois = delta_decode(rois, reg.reshape(B, P, 4),
                                stds=STAGE_STDS[s],
                                max_shape=(self.img_size, self.img_size))
        probs = (scores_sum / 3.0)[..., :K]  # drop the background
        # class-wise NMS by offsetting each class's boxes, on the top
        # candidates only
        Kc = min(4 * max_per_img, P * K)
        out = []
        for b in range(B):
            flat = torch.where(pvalid[b][:, None], probs[b],
                               torch.full_like(probs[b], -math.inf)
                               ).reshape(-1)
            top_idx = top_k_indices(flat, Kc)
            top_scores = flat[top_idx]
            cand_boxes = rois[b][top_idx // K]
            cand_labels = top_idx % K
            offset = cand_labels.to(rois.dtype)[:, None] * (
                2.0 * self.img_size)
            keep, valid = nms(cand_boxes + offset, top_scores, 0.5,
                              max_per_img)
            scores = top_scores[keep]
            out.append((cand_boxes[keep], scores, cand_labels[keep],
                        valid & (scores > 0.05)))
        boxes, scores, labels, valid = (torch.stack(t) for t in zip(*out))
        rfeat14 = torch.stack([
            multilevel_roi_align([f[b] for f in feats4], boxes[b], 14,
                                 ROI_STRIDES) for b in range(B)])
        mlogits = self.mask_head(rfeat14.reshape(B * max_per_img,
                                                 *rfeat14.shape[2:]))
        mlogits = mlogits.reshape(B, max_per_img, *mlogits.shape[1:])
        masks = torch.sigmoid(mlogits.gather(
            -1, labels[:, :, None, None, None].expand(
                -1, -1, *mlogits.shape[2:4], 1))[..., 0])
        return {"boxes": boxes,
                "scores": torch.where(valid, scores,
                                      torch.zeros_like(scores)),
                "labels": labels, "valid": valid, "masks": masks}
