#!/usr/bin/env python3
"""Drive the PyTorch port (fastvim_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. print the card's name and power limit, the torch / CUDA / nvcc
   versions, and build the CUDA kernels from ``ops/kernels/csrc`` and,
   with g++, the native host pipeline's libraries from
   ``native/csrc`` (augment; decode where libjpeg-turbo's header is);
2. hold each of the eleven kernels (K1 scan, K3 pass A, K4 pass B; the
   backward kernels K2 scan, K5 pass B, K6 pass A; K7 pass B in its
   recompute form, K8 conv + pool, K9 and K10 the two merge kernels, and
   the lanes scan) against its plain PyTorch version on the card, at the
   main path's shapes, in fp32 and bf16, and time both; K3-K6 also at
   FastVim-S's widths (d_model 384, d_inner 768, grid 128 × 128, batch 2,
   both orientations), K3 and K4 also at FastVim-B's (768 / 1536: grid
   128 × 128, batch 2, and 14 × 14, batch 8), -L's (1024 / 2048, 14 × 14)
   and -H's (1280 / 2560, 32 × 32), both orientations, where K3 streams x̂
   through its ring and K4 splits d_model into groups of 384 columns,
   and K5 and K6 at the same wide shapes, their wide forms (x̂ and g
   streamed through the ring, dx̂ a product of its own), each timed beside
   its bound and with the number of device kernels one call launches
   (counted by a child process from a CUDA graph of one call, and
   checked for K5 and K6: 3 in bf16 at FastVim-T's widths, 4 in the wide
   forms, fp32 as ``BWD_KERNELS_A_CALL`` states); K1 in both of its
   forms, sequential (L = 128) and chunked (Vim-T's L = 16,384 and
   16,385, also held against its own plain version and the sequential
   kernel, y and the saved states), with the form the launcher picks at
   each length; K2 likewise, in its
   sequential (L = 128) and chunked (L = 16,384 and 16,385) forms, all
   seven gradients; K7 at FastVim-T's and FastVim-S's widths, both
   orientations, beside its pass A, K3's pools-only form, and its wide
   forms at K3-K6's wide shapes (FastVim-B, -L, -H) in both dtypes, each
   timed beside its bound, fp32 (3xTF32 on the tensor cores, clusters of
   1-4 CTAs that split d_inner) also at 224 px and B = 128 at
   ``FP32_RC_WIDTHS`` (FastVim-T's, -S's and -B's widths, both
   orientations, beside its plain version, the three fp32 SGEMMs alone,
   its 3xTF32 bound and the FMA units' bound); K3 and K4 in fp32
   (products as three TF32 products on the tensor cores) at each of
   those shapes and at
   ``FP32_FWD_SHAPES`` (224 px and B = 128 at FastVim-T's and -B's
   widths, timed in both orientations beside their plain versions, the
   fp32 SGEMM of the same products and their bound; lines of 4, 7 and
   16 tokens), K3 also pools-only; K5 and K6 in fp32 (every product as
   three TF32 products on the tensor cores) at each of K5/K6's shapes and
   at ``FP32_BWD_SHAPES`` (224 px and B = 128 at FastVim-T's and -B's
   widths, timed in the even orientation beside their plain versions,
   the fp32 SGEMMs of the same products, their 3xTF32 bound and the FMA
   units' bound); K8, K9 and K10
   at FastVim-T's and FastVim-S's widths (K10 in both orientations), each
   with its share of the bound; the lanes scan at L = 128 and 16,384,
   beside K1; and K1 and K2 in fp32 at the MAE slice's shapes (batch,
   L, d_inner): (128, 14, 1536), the masked encoder's row bins at MAE-B,
   (128, 196, 1024), the decoder's tokens, and (128, 50, 1536), the
   Vim-MAE-B encoder's visible tokens and cls token, both directions,
   each timed beside its plain version and its bound;
3. build ``fastvim_tiny`` and ``vim_tiny`` at 224 px, full width, fp32,
   from one seed, and compare their logits, then their loss and every
   parameter's gradient, on the card (kernels) with the same models on
   the CPU (plain versions), and the loss and gradients of
   ``fastvim_small`` at depth 2 and of ``fastvim_tiny`` with
   ``embed_dim=96`` at depth 2, whose layers fuse forward (2 K3 and 2 K4
   launches) and take the remat backward (no K5 or K6 launch); the same
   for the logits of the four configurations of ``fastvim_tiny`` that
   reach K7-K10, for ``fastvim_small`` (depth 2) with
   ``layer_fused="recompute"``, which must fuse (2 K3, 2 K7), and for
   ``fastvim_tiny`` at d_inner 4096 (depth 2) with ``fused_merge``, the
   widest K10 takes (2 K10); then ``fastvim_base`` and ``fastvim_large``
   at 224 px and ``fastvim_huge`` at 448 px (patch 14, a 32 × 32 grid),
   depth 2, with their default fields: B and H must fuse (2 K3, 2 K4, 4
   K1 a forward), L's forward, which takes no gradient, the unfused
   route (``default_fwd_mode``: no K3 or K4, 4 K1); their logits, and,
   built with ``layer_fused_bwd="fused"`` (fp32's "auto" takes the remat
   backward at these widths on lines of up to 16 tokens, B's and L's
   here), their loss and every gradient through the fused forward and
   adjoint (2 K3, 2 K4 a forward, 2 K5 and 2 K6 a backward, their wide
   forms); and the same three in the recompute mode
   (``layer_fused="recompute"``, K7's wide forms in fp32): their logits,
   2 K3 (pools only) + 2 K7 + 4 K1 a forward;
4. run FastVim-T, Vim-T and FastVim-B (full depth) forward at 2048 px,
   batch 2, bf16. Logits must be finite, and the kernels' launch
   counters must show 24 pass A + 24 pass B + 48 scans for FastVim-T and
   FastVim-B and 48 scans for Vim-T per forward. Then time forwards with
   CUDA events (median of 5 windows) and print img/s, FastVim-T's and
   FastVim-B's also as a CUDA-graph replay (static input, captured after
   warm-up), where the forward is the device's time and not the host's;
5. train: ``fastvim_tiny`` at 2048 px, batch 3, bf16, built on the card by
   ``create_model`` → ``make_optimizer`` (AdamW, cosine schedule with
   warmup, weight decay 0.05) → ``TrainState`` →
   ``make_supervised_train_step`` (label smoothing 0.1, no EMA): 5 steps
   on one fixed batch. Every loss must be finite, the last below the
   first, the parameters changed, and each step must launch 24 K3, 24 K4,
   48 K1, 24 K5, 24 K6 and 48 K2. Then 3 steps of ``fastvim_small`` and
   of ``fastvim_base`` at batch 2, full width and depth, with their
   default fields (the same launches per step; FastVim-B's K5 and K6 in
   their wide forms), one step of ``fastvim_base`` with
   ``layer_fused_bwd="remat"`` (24 K3, 24 K4, 96 K1, 48 K2) and one step
   of ``vim_tiny`` at batch 2 (48 K1, 48 K2), and the step time of each
   as img/s;
6. the configurations: ``fastvim_tiny`` at 2048 px, batch 2, bf16, full
   depth, with ``fused_kernels="always"`` (24 K8, 24 K9, 48 K1 per
   forward), ``fused_kernels="merge"`` (24 K9, 48 K1), ``fused_merge``
   (24 K10, 48 K1) and ``layer_fused="recompute"`` (24 K3 pools-only, 24
   K7, 48 K1): finite logits within 2e-2 of the largest logit of the
   default configuration's from the same seed, exactly those launches,
   and img/s beside the default's, the recompute, ``fused_kernels=
   "always"`` and ``fused_merge`` forms also as CUDA-graph replays beside
   the default's;
   ``fastvim_small`` and ``fastvim_base`` (K7's wide form) at full depth
   with ``layer_fused="recompute"`` (24 K3 pools-only, 24 K7, 48 K1;
   logits within 2e-2 of the largest of its default's), both replayed,
   FastVim-B's also eager, beside its default's; one train
   step of ``fused_kernels="always"``; and the lanes scan through
   ``selective_scan(variant="lanes")`` at L = 16,384 beside K1;
7. the classification CLIs, in-process, into a temporary directory:
   ``train_classification --config_name FastVimT`` (``fastvim_tiny`` at
   full width and depth, 224 px, 1000 classes, batch 128, fp32,
   mixup/cutmix, drop path 0.05, EMA; the host loader with RandAugment
   on 512 synthetic images, 4 steps an epoch) for one epoch, then
   ``--resume`` to two: ``log.csv`` must hold epochs 0 and 1 with finite
   numbers and the EMA columns, ``tb/`` an event file, the state step 8,
   and each epoch exactly 4 × (24 K3, 24 K4, 48 K1, 24 K5, 24 K6, 48 K2)
   plus 8 eval forwards (24 K3, 24 K4, 48 K1 each). Then
   ``test_classification --ema`` on ``ckpt/step_8`` must give the last
   row's ``val_loss_ema`` within 1e-5 relative. It prints the CLI's
   img/s and step time of both epochs, and the device's idle share over
   the resumed epoch's training (a torch.profiler trace of it). Then
   ``test_classification --config_name FastVimB`` (``fastvim_base`` at
   full width and depth, 224 px, batch 128, fp32) on a checkpoint saved
   from the CLI's seeded model, over 256 synthetic images: 24 K3 + 24 K4
   + 48 K1 a batch, and a test_loss within 1e-4 relative of the same
   checkpoint's with ``layer_fused=off``, with its img/s;
8. MAE: ``mae_FastVim_base_dec512d2b`` (full width, encoder depth 4) and
   ``mae_vim_base_dec512d2b`` (depth 2, its middle cls token) in fp32 at
   224 px, B = 8, from one seed and one mask draw, card against CPU: the
   loss, the prediction and every parameter's gradient within 1e-4 of
   each tensor's largest entry, the masks equal, and 12 / 8 K1 and K2
   launches. Then the MAE CLIs, in-process, at full width and depth on
   512 synthetic images (4 steps of 128): ``pretrain_mae --config_name
   pretrain_FastVimB`` for one epoch and ``--resume`` to two (52 K1 and
   52 K2 a step: 24 masked layers and 2 decoder layers, two scans each;
   the log's two rows, step 8, img/s, step time, the device's idle
   share over the resumed epoch and its peak memory; epoch 1 with the
   loader's MAE augment in the native library, the default, one
   ``augment_batch`` call an image, counted; the resumed epoch from its
   checkpoint twice, with the native path off, PIL, and on);
   ``finetune_mae --config_name
   finetune_FastVimB`` from its newest checkpoint for one epoch
   (``fastvim_base``, every layer fused: the printed counts show the
   sin-cos ``pos_embed`` and the kept-init head; a step 24 K3 + 24 K4 +
   48 K1 + 24 K5 + 24 K6 + 48 K2, the fused forward and the fused
   adjoint, fp32's default there, an eval batch 24 K3 + 24 K4 + 48 K1;
   img/s and peak memory);
   ``linear_probe --config_name linear_FastVimL model=fastvim_base batch_size=128`` from
   the same checkpoint (24 K3 + 24 K4 + 48 K1 a step and an eval batch,
   the frozen backbone fused; bitwise as loaded, the BatchNorm statistics
   moved);
9. ChannelVim (FastChannelVim), whose 3-D token grids never fuse: every
   layer runs the unfused mixer with its scans on K1 and K2. K1 and K2
   against their plain versions in fp32 at its scan shapes (batch, L,
   d_inner): L = 1, 8, 14, 112 and 224 at batch 32, d_inner 768 (a
   2dcompress channel scan of 1 and of 8 channels, a rows scan, ps16's
   and ps8's rows·C), and the unpooled baseline's L = 1568 at batch 8
   (the chunked forms), both directions, each timed beside its other
   form, its plain version and its bound. Then FastChannelVim-S at full
   width (depth 2) in both scan orders, with max pooling, and in its
   2dcompress form (depth 3), fp32, 224 px, B = 4, each with all 8
   channels and with the ids of 3 and of 1 channel, card against CPU:
   logits, loss and every gradient within 1e-4 of each tensor's largest
   entry, and 2 K1 and 2 K2 a layer. Then the cells CLI, in-process:
   ``train_cells --config_name FastChannelVimS`` at full width and depth
   (Channel-First, HCS, batch 32, fp32) on 128 synthetic images for one
   epoch and ``--resume`` to two (the log's two rows, step 8, 48 K1 + 48
   K2 a step and 48 K1 an eval batch; img/s, step time, the device's idle
   share over the resumed epoch, peak memory; epoch 1 with the loaders'
   augment in the native library, the default, one ``cell_augment_batch``
   call a batch, counted; the resumed epoch from its checkpoint twice,
   with the native path off, Python image by image, and on). Last, train
   steps through
   the model API: ``channelvim_small_ps16_baseline`` at full depth, B = 8
   (its L = 1568 scans in the chunked forms), and
   ``fastchannelvim_small_ps8`` at B = 32 with ``remat=True`` (a batch
   that does not fit is halved until one does), with the step time and
   the peak memory;
10. segmentation: ``UperNetSegmentor`` over ``fastvim_tiny`` in feature
   mode (maps after layers 5, 11, 17 and 23) at 512 px (a 32 × 32 grid,
   which fuses), full depth, fp32, B = 1, from seed 0, card against CPU:
   the eval-mode logits within 1e-3 (24 K3, 24 K4, 48 K1), and
   ``slide_inference`` on one 512 × 683 image (two overlapping windows,
   twice those launches); the same model at depth 4 in training mode
   (LayerNorm heads, dropout off): the loss and every gradient within
   1e-4 of each tensor's largest entry (4 K5, 4 K6, 8 K2). Then the CLIs,
   in-process: ``train_segmentation --config_name
   upernet_FastVimT_ade20k`` (B = 2, 512 px, 150 classes, synthetic
   data) for 3 iterations and an mIoU eval, ``--resume`` to 9 and an
   eval, and ``--eval_only`` from the checkpoint, which must give the
   last row's mIoU; each step 24 K3, 24 K4, 48 K1, 24 K5, 24 K6, 48 K2,
   each eval image 24 K3, 24 K4, 48 K1; img/s, step time, the device's
   idle share over the resumed run's training and its peak memory; and
   ``extract_features --with_fpn``: four (1, 32, 32, 192) maps and the
   pyramid. Then ``train_segmentation --config_name
   upernet_FastVimB_ade20k`` as shipped (``fastvim_base``, B = 2, 512 px,
   fp32) for 3 iterations on 2 synthetic images and their eval: each
   step 24 K3, 24 K4, 48 K1, 24 K5, 24 K6, 48 K2 (fp32's default takes
   the fused adjoint on its 32-token lines), each eval image 24 K3, 24
   K4, 48 K1; img/s, step time, peak memory; then its segmentor's train
   step on one batch with the mixers set to ``layer_fused_bwd="fused"``
   and to "remat" (24 K3, 24 K4, 96 K1, 48 K2), timed in turns, with
   each route's peak memory.
11. detection: ``vitdet_FastVimT_coco``'s cascade Mask R-CNN as
   ``train_detection`` builds it (``fastvim_tiny`` at full width and
   depth, unfused as the config pins it, 1024 px: a 64 × 64 grid, scans
   of L = 64; SimpleFPN 256, 80 classes), fp32, seed 0, B = 1, card
   against CPU in training mode: the backbone's map, the FPN maps and the
   RPN's outputs within 1e-3, then, with the card's proposals, samples,
   head ReLU masks and FPN max-pool argmax replayed on the CPU
   (``DetBranch``), the 11 losses and every gradient within 1e-4 of each
   tensor's largest entry (48 K1, 48 K2); the same step with the backbone
   built ``layer_fused="on"`` against it (24 K3, 24 K4, 48 K1, 24 K5, 24
   K6, 48 K2); the exact and the fast NMS over the RPN's 4768 eval boxes,
   timed. Then ``train_detection`` as shipped (B = 8) on 16 synthetic
   images for one epoch, ``--resume`` to two under the profiler and
   ``--eval_only`` on 8 images (48 K1 + 48 K2 a step, 48 K1 an eval
   image): img/s, step time, the idle share, the peak memory, the loader
   alone and the top kernels. Then in bf16 (``dtype=bf16``, the backbone
   and every head computing in bf16 over fp32 parameters): the B = 1 step
   card against CPU on the card's replayed branch (maps and losses within
   ``DET_BF16_TOL`` of the largest entry, gradients within
   ``DET_BF16_GRAD_TOL`` of each tensor's norm), at the CLI's B = 8 the
   fp32 step, the bf16 step and the bf16 step through the fused adjoint
   (``layer_fused="on"``: 24 K3, K4, K5, K6) on one branch, the fused
   one no farther from the fp32 step than twice the unfused one, each
   timed with its peak memory; and ``train_detection dtype=bf16`` for one
   epoch of 2 steps under the profiler (48 K1 + 48 K2 a step): img/s,
   step time, idle share, peak memory.
12. the native host pipeline (``fastvim_tpu_torch/native``): nproc and
   whether libjpeg-turbo's header is there; each entry point against its
   plain numpy version (``native/plain.py``; the resize within
   ``plain.resize_tol``, the cell augment exactly, the decode within the
   test JPEGs' noise as a mean per image) and timed per batch on the
   host, on all cores and on one, beside its plain version and the
   Python path: ``augment_batch`` and ``decode_augment_batch`` at B =
   128, 224 px, from 500 × 375 JPEGs written here by Pillow,
   ``cell_augment_batch`` at B = 32, 224 × 224 × 8, and ``jpeg_dims``
   (the decode half reported unavailable, with the reason, where the
   header is missing); the MAE and cells train loaders alone as phases 8
   and 9 build them, native on and off in turns; then
   ``test_classification --config_name
   FastVimT --data_dir`` over 512 such JPEGs with the native path on and
   off (24 K3 + 24 K4 + 48 K1 a batch, the native calls, img/s, the
   device's idle share over the call, the loader alone).
13. data parallel (``fastvim_tpu_torch.parallel``): FastVim-T at full
   width and depth, 224 px, fp32, DropPath 0.1, on a global batch of 8:
   2 ranks on cuda:0 over gloo against the 1-rank step (the loss to 1e-5
   relative, every gradient to ``GRAD_TOL``; 48 K1 + 24 K3 + 24 K4 + 48
   K2 + 24 K5 + 24 K6 a step and rank), 1 rank over NCCL with the bf16
   gradient all-reduce against fp32 (within a bf16 rounding), ``torchrun
   --standalone --nproc_per_node 1 -m
   fastvim_tpu_torch.cli.train_classification --config_name FastVimT
   --epochs 1 --synthetic_samples 256`` to its end, and 2 ranks over NCCL
   where the machine has two cards; the step and all-reduce times.
14. the language model (``fastvim_tpu_torch.models.lm``) at mamba-130m's
   published widths (d_model 768, 24 layers, vocab 50277 padded to 50280,
   d_state 16, d_inner 1536, dt_rank 48), seeded random weights: K1 with
   the gate z and the final state against its plain version at the
   prefill's shapes (B = 4, d 1536; L = 128 sequential, 2048 chunked;
   fp32 and bf16, both directions); the prefill's logits and caches
   against a token-by-token replay through the cached step (B = 2, L =
   64, fp32; 24 K1 launches, none in the 64 steps); greedy generation of
   32 tokens from a 16-token prompt, card against CPU, logits
   teacher-forced on the CPU's tokens and the tokens wherever the CPU's
   top-2 gap is clear; prefill tokens/s at B = 1 and 8, L = 2048, and
   decode tokens/s over 128 steps at B = 1 and 16, fp32 and bf16, with
   peak memory.
15. the token (seq) axis (``parallel.token_shard``,
   ``parallel/tokens.py``): FastVim-T at full width and depth, B = 2,
   built with its default fields, over ``make_mesh(data=1, seq=2)``: 2
   spawned ranks on cuda:0 over gloo (NCCL refuses two ranks on one
   device), each holding half the token grid's rows, against the
   unsharded unfused run of one rank here (``layer_fused="off"``): fp32
   at 512 px with DropPath 0.1 (logits ``FP32_TOL``, loss 1e-5 relative,
   gradients ``GRAD_TOL`` of the largest entry: phase 13's bounds), and
   bf16 at 2048 px (logits, loss and gradients ``BF16_TOL`` of the
   largest entry) with two timed train steps through the trainer and the
   peak memory on each rank and on the one; each rank's forward 48 K1,
   its gradient pass and each train step 48 K1 + 48 K2, no K3-K10 (a
   sharded layer runs unfused); where the machine has two cards, 2 NCCL
   ranks, one a card, repeat the 2048 px check.

After a line with the card's name and power limit, the line before the
last is a JSON object with one entry per kernel (``ms`` a call's time by
CUDA events, for K8, K9, K10 and lanes also ``device_ms``, the device
time a call from CUDA-graph replays; ``bound_ms`` is the larger of bytes
/ 3.35 TB/s and operations / the H100's peak for their type, for the
inputs of the timed call), K3 and K4 also once for each wide width
(``"pass_a_fwd d_model=768"``: FastVim-B at 2048 px, -L and -H at their
phase 2 shapes; launches from phase 4's FastVim-B forward, phase 3's -H
forward and -L's forward with a gradient), and so K5 and K6 (``"pass_b_bwd d_model=768"``;
launches from phase 5's FastVim-B train step and phase 3's -L and -H
backwards) and K7 (``"pass_b_recompute_fwd d_model=768"``; launches
from phase 6's FastVim-B recompute forward and phase 3's -L and -H
recompute forwards), K7 in fp32 (``"pass_b_recompute_fwd fp32"`` at
FastVim-T's widths, ``"... fp32 d_model=768"`` at -B's, 224 px, B = 128;
launches from phase 3's fp32 recompute forwards of ``fastvim_tiny``
(24) and the depth-2 ``fastvim_base`` (2)), K3 and K4 in fp32
(``"pass_a_fwd fp32"`` at FastVim-T's widths, ``"pass_a_fwd fp32
d_model=768"`` at -B's, 224 px, B = 128; launches from phase 7's fp32
``train_classification FastVimT`` and ``test_classification
FastVimB``), K5 and K6 in fp32
(``"pass_b_bwd fp32"``, ``"pass_b_bwd fp32 d_model=768"``, the same
shapes, 3xTF32 on the tensor cores; launches from phase 7's
``train_classification FastVimT`` and phase 10's ``train_segmentation
upernet_FastVimB_ade20k``; ``max_abs_err`` of their per-token outputs,
``summed_rel_err`` of the gradients they sum over every token, over
max(1, the largest entry)), and K1 once more with
the gate and the final state at the LM
prefill's shapes (``"selective_scan_fwd lm"``: B = 4, L = 2048, fp32;
launches from phase 14's prefill); the last line is ``{"ok": true,
"device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result. Before the ``kernels``
line, a ``{"native": [...]}`` line holds phase 12's entries (these are
not TPU kernels).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from functools import partial

FP32_TOL = 1e-4  # |got - want| <= tol + tol·|want|: fp32 sums in another order
BF16_TOL = 2e-2  # ≈ 5 bf16 ulps: the outputs are rounded to bf16 on both sides
MODEL_TOL = 1e-3  # fp32 logits after 24 layers, card vs CPU
GRAD_TOL = 1e-4   # fp32 gradients after 24 layers, relative to the largest

# NVIDIA H100 SXM peaks (data sheet, dense): the yardstick of bound_ms.
# "tf32x3": fp32 products as three TF32 products on the tensor cores (the
# fp32 K3 and K4), 495 TFLOP/s / 3; "fp32" the FMA units
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 495e12 / 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, tol, summed=False):
    """Max abs error of got against want; raise beyond
    |got - want| <= atol + tol·|want| with atol = tol, or, for a tensor
    ``summed`` over all tokens or steps, atol = tol · max(1, max|want|):
    the rounding of a long fp32 sum grows with the size of its terms, not
    with the result, which may be near 0 where the terms cancel."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    err = (got - want).abs()
    abs_err = err.max().item()
    rel_err = (err / want.abs().clamp_min(1e-6)).max().item()
    atol = tol * max(1.0, want.abs().max().item()) if summed else tol
    ok = bool((err <= atol + tol * want.abs()).all())
    log(f"[check] {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
        f" atol={atol:.3g} rtol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance {tol}")
    return abs_err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: int, flops: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take
    to move n_bytes once and do flops operations of the given kind."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int, windows: int = 1) -> float:
    """ms per call: the median over ``windows`` windows of the mean over
    ``iters`` calls, after one warm-up call. Eager forwards at batch 2 are
    host-bound, and the host is shared, so one window is noisy."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def count_launches() -> int:
    """``chip_smoke.py --count-launches``: print, as JSON, how many device
    kernels (copies included) one call of K3-K10 launches in bf16 and in
    fp32, from a CUDA graph captured from a small call (K3, K4 and K7 also
    at FastVim-B's widths), and
    one call of K1 and of K2 in each of their forms and one of the lanes
    scan at L = 128 and 16,384 in bf16. It runs as a process of its own (see
    :func:`launches_per_call`), so that its captures and their memory
    pools never sit under a timed phase."""
    import torch

    from fastvim_tpu_torch.ops.kernels import fused_block as fb
    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import merge_gate as mg
    from fastvim_tpu_torch.utils.profiling import kernels_a_call

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.3
    batch, H, W, dm, di = 2, 14, 14, 192, 384
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tok = lambda c: rnd(batch, H, W, c).to(dtype)
        pooled = lambda: rnd(batch, H, di).to(dtype)
        calls = {
            "pass_a_fwd": lambda a=(
                tok(dm), rnd(di, dm).to(dtype), None, rnd(di, 4), rnd(di),
                rnd(di, 4), rnd(di), 1.0, False): lf.pass_a(*a),
            "pass_b_fwd": lambda a=(
                tok(dm), tok(di), tok(di), pooled(), pooled(),
                rnd(di, dm).to(dtype), None, rnd(di), rnd(di), rnd(di),
                rnd(di), rnd(dm, di).to(dtype), None, 1e-5, True, False):
                lf.pass_b(*a),
            "pass_b_bwd": lambda a=(
                tok(dm), tok(dm), tok(di), tok(di), pooled(), pooled(),
                rnd(di, dm).to(dtype), None, rnd(di), rnd(di), rnd(di),
                rnd(di), rnd(dm, di).to(dtype), 1e-5, True, False):
                lf.pass_b_bwd(*a),
            "pass_a_bwd": lambda a=(
                tok(dm), rnd(batch, H, W, dm), tok(di), tok(di), pooled(),
                pooled(), rnd(di, dm).to(dtype), None, rnd(di, 4), rnd(di),
                rnd(di, 4), rnd(di), 1.0, False): lf.pass_a_bwd(*a),
            "pass_b_recompute_fwd": lambda a=(
                tok(dm), pooled(), pooled(), rnd(di, dm).to(dtype), None,
                rnd(di, 4), rnd(di), rnd(di, 4), rnd(di),
                rnd(di, dm).to(dtype), None, rnd(di), rnd(di), rnd(di),
                rnd(di), rnd(dm, di).to(dtype), None, 1e-5, True, False):
                lf.pass_b_recompute(*a)}
        # K8 and K9 on the column halves of one in-projection output
        xz = rnd(batch, H * W, 2 * di).to(dtype)
        conv = (rnd(di, 4), rnd(di), rnd(di, 4), rnd(di))
        calls["conv_pool_fwd"] = lambda: fb.conv_pool(
            xz[..., :di], *conv, H, W, "mean", 1.0)
        calls["merge_gate_fwd"] = lambda a=(
            rnd(batch, H, di), rnd(batch, H, di), *conv, rnd(di), rnd(di),
            rnd(di), rnd(di)): fb.merge_gate(xz[..., :di], xz[..., di:],
                                            *a, H, W, 1e-5, True)
        # K10 on materialized conv outputs, z a column slice
        xc = [rnd(batch, H * W, di).to(dtype) for _ in range(2)]
        calls["merge_ln_gate_fwd"] = lambda a=(
            rnd(batch, H, di).to(dtype), rnd(batch, H, di).to(dtype),
            rnd(di), rnd(di), rnd(di), rnd(di)): mg.merge_ln_gate(
                *xc, xz[..., di:], *a, (H, W), (1,), 1e-5, True)
        for name, fn in calls.items():
            out.setdefault(name, {})[str(dtype)] = kernels_a_call(fn)
        # K3's streamed form and K4's wide form, at FastVim-B's widths
        wdm, wdi = 768, 1536
        wx = rnd(batch, H, W, wdm).to(dtype)
        wc = (rnd(wdi, 4), rnd(wdi), rnd(wdi, 4), rnd(wdi))
        wide = {
            "pass_a_fwd": lambda a=(wx, rnd(wdi, wdm).to(dtype), None, *wc,
                                    1.0, False): lf.pass_a(*a),
            "pass_b_fwd": lambda a=(
                wx, rnd(batch, H, W, wdi).to(dtype),
                rnd(batch, H, W, wdi).to(dtype), rnd(batch, H, wdi).to(dtype),
                rnd(batch, H, wdi).to(dtype), rnd(wdi, wdm).to(dtype), None,
                rnd(wdi), rnd(wdi), rnd(wdi), rnd(wdi),
                rnd(wdm, wdi).to(dtype), None, 1e-5, True, False):
                lf.pass_b(*a)}
        # K5's and K6's wide forms there too
        wtok = lambda c: rnd(batch, H, W, c).to(dtype)
        wpool = lambda: rnd(batch, H, wdi).to(dtype)
        wide["pass_b_bwd"] = lambda a=(
            wtok(wdm), wtok(wdm), wtok(wdi), wtok(wdi), wpool(), wpool(),
            rnd(wdi, wdm).to(dtype), None, rnd(wdi), rnd(wdi), rnd(wdi),
            rnd(wdi), rnd(wdm, wdi).to(dtype), 1e-5, True, False): \
            lf.pass_b_bwd(*a)
        wide["pass_a_bwd"] = lambda a=(
            wtok(wdm), rnd(batch, H, W, wdm), wtok(wdi), wtok(wdi), wpool(),
            wpool(), rnd(wdi, wdm).to(dtype), None, rnd(wdi, 4), rnd(wdi),
            rnd(wdi, 4), rnd(wdi), 1.0, False): lf.pass_a_bwd(*a)
        # K7's wide form there too
        wide["pass_b_recompute_fwd"] = lambda a=(
            wx, wpool(), wpool(), rnd(wdi, wdm).to(dtype), None, *wc,
            rnd(wdi, wdm).to(dtype), None, rnd(wdi), rnd(wdi), rnd(wdi),
            rnd(wdi), rnd(wdm, wdi).to(dtype), None, 1e-5, True, False): \
            lf.pass_b_recompute(*a)
        for name, fn in wide.items():
            out.setdefault(f"{name} d_model={wdm}", {})[str(dtype)] = \
                kernels_a_call(fn)
    # K1 and K2 in both forms at FastVim's and Vim-T's lengths, bf16
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    d, n = 384, 16
    A, bias = -torch.exp(rnd(d, n)), rnd(d)
    for L in (128, 16384):
        args = [rnd(2, L, c).bfloat16() for c in (d, d, n, n)]
        args.insert(2, A)
        _, states = ss.selective_scan_fwd(*args, delta_bias=bias,
                                          delta_softplus=True,
                                          save_states=True)
        gy = rnd(2, L, d).bfloat16()
        for route in ("sequential", "chunked"):
            out[f"selective_scan_fwd L={L} {route}"] = kernels_a_call(
                lambda: ss._launch_fwd(route, *args, delta_bias=bias,
                                       delta_softplus=True))
            out[f"selective_scan_bwd L={L} {route}"] = kernels_a_call(
                lambda: ss._launch_bwd(route, *args, None, bias, gy, states,
                                       True))
        out[f"selective_scan_fwd_lanes L={L}"] = kernels_a_call(
            lambda: ss.selective_scan_fwd_lanes(*args, delta_bias=bias,
                                                delta_softplus=True))
        # K1 with the gate (a column slice) and the final state, as the
        # LM's prefill calls it
        z = rnd(2, L, 2 * d).bfloat16()[..., d:]
        out[f"selective_scan_fwd lm L={L}"] = kernels_a_call(
            lambda: ss.selective_scan_fwd(*args, delta_bias=bias,
                                          delta_softplus=True, z=z,
                                          return_last_state=True))
    print(json.dumps(out), flush=True)
    return 0


def launches_per_call() -> dict:
    """{kernel: {dtype: device kernels a call launches}} for K3-K10, and
    {"selective_scan_fwd L=<L> <form>": device kernels} for K1 and the
    same for K2 (``selective_scan_bwd``) and the lanes scan, counted by a
    child process (the library is built by then). K1's chunked form must
    be its three phases and the sequential form one kernel; K2's chunked
    form its three phases and three fixed-order sums, the sequential form
    one kernel and the same sums; the lanes scan a memset (its flags) and
    one kernel; K3, K4 and K7 (also at FastVim-B's widths, ``"pass_a_fwd
    d_model=768"``), K8, K9 and K10 one kernel in either dtype; K5 and
    K6 at FastVim-T's widths 3 kernels in bf16 (the main kernel, the
    weight-gradient product, the fixed-order sums), and at FastVim-B's
    (``"pass_b_bwd
    d_model=768"``), their wide forms, 4 (the dx̂ product after the main
    kernel); in fp32 K5 6 and K6 4 at both widths
    (``BWD_KERNELS_A_CALL``)."""
    run = subprocess.run([sys.executable, __file__, "--count-launches"],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"--count-launches failed: {run.stderr[-2000:]}")
    counts = json.loads(run.stdout.strip().splitlines()[-1])
    for name in ("pass_a_fwd", "pass_b_fwd", "pass_a_fwd d_model=768",
                 "pass_b_fwd d_model=768", "pass_b_recompute_fwd",
                 "pass_b_recompute_fwd d_model=768", "conv_pool_fwd",
                 "merge_gate_fwd", "merge_ln_gate_fwd"):
        if set(counts[name].values()) != {1}:
            raise AssertionError(f"{name}: {counts[name]} device kernels a "
                                 "call, not 1")
    for name, want in BWD_KERNELS_A_CALL.items():
        got = {k: counts[name][k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: {got} device kernels a call, not "
                                 f"{want}")
    for L in (128, 16384):
        for kernel, form, want in (
                ("selective_scan_fwd", "sequential", 1),
                ("selective_scan_fwd", "chunked", 3),
                ("selective_scan_bwd", "sequential", 4),
                ("selective_scan_bwd", "chunked", 6),
                ("selective_scan_fwd_lanes", None, 2),
                ("selective_scan_fwd lm", None, 1 if L < 512 else 3)):
            got = counts[f"{kernel} L={L}" + (f" {form}" if form else "")]
            if got != want:
                raise AssertionError(f"{kernel} {form} L={L}: {got} device "
                                     f"kernels a call, not {want}")
    return counts


# device kernels one call of K5 and of K6 launches: in bf16 the main
# kernel, the weight-gradient product and the fixed-order sums, and the
# dx̂ product in the wide forms past d_model 384 or d_inner 768; in fp32
# (3xTF32) at every width K5's z, dgated, middle, dx̂, weight gradients and
# sums, K6's xin with the conv adjoint, dx̂, weight gradient and sums
BWD_KERNELS_A_CALL = {
    "pass_b_bwd": {"torch.bfloat16": 3, "torch.float32": 6},
    "pass_a_bwd": {"torch.bfloat16": 3, "torch.float32": 4},
    "pass_b_bwd d_model=768": {"torch.bfloat16": 4, "torch.float32": 6},
    "pass_a_bwd d_model=768": {"torch.bfloat16": 4, "torch.float32": 4},
}

# K3-K6 at FastVim-B's, -L's and -H's widths in phase 2: (d_model,
# d_inner, ((grid, batch), ...)), the first shape the kernels line's
WIDE_SHAPES = ((768, 1536, (((128, 128), 2), ((14, 14), 8))),
               (1024, 2048, (((14, 14), 8),)),
               (1280, 2560, (((32, 32), 8),)))
WIDE_DM = tuple(dm for dm, _, _ in WIDE_SHAPES)

# the fp32 K7 alone in phase 2, timed at 224 px, B = 128: FastVim-T's,
# -S's and -B's widths (one, one and two CTAs a cluster)
FP32_RC_WIDTHS = ((192, 384), (384, 768), (768, 1536))

# K5 and K6 in fp32 alone in phase 2, timed: 224 px at B = 128 (K5's
# blocks of 4 lines, K6's of 8 + 6), by d_model
FP32_BWD_SHAPES = {192: (((14, 14), 128),), 768: (((14, 14), 128),)}

# K3 and K4 in fp32 alone in phase 2 (their tensor-core forms: runs of
# whole lines, up to 122 tokens a block), by d_model: 224 px at B = 128,
# timed (runs of 8 + 6 lines, each meeting its image's first or last
# line); at FastVim-T's widths lines of 4, 7 and 16 tokens (one run an
# image; runs of 17 + 17 + 6 lines; 7 + 7 + 2 over 3 images)
FP32_FWD_SHAPES = {192: (((14, 14), 128), ((24, 4), 3), ((40, 7), 2),
                         ((16, 16), 3)),
                   768: (((14, 14), 128),)}


def check_kernels(dev, card, per_call):
    """Phase 2: K1, K3 and K4 against their plain versions on the card.
    Returns (errors, times) by the kernels line's names; K3's and K4's
    fp32 forms (csrc/layer_fused_fwd_tf32.cu) under ``"pass_a_fwd
    fp32"``, their bf16 ones under ``"pass_a_fwd"``."""
    import torch

    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    errs = {"selective_scan_fwd": 0.0, "pass_a_fwd": 0.0, "pass_b_fwd": 0.0}
    times = {}

    # K1: the pooled scans of FastVim-T at 2048 px (L = 128) and the
    # full-length scans of Vim-T (L = 16,384; 16,385 with the middle cls
    # token exercises the tail chunk), the launcher against the plain
    # version: its error and its L = 128 time are the kernels line's. The
    # launcher takes the sequential form at L = 128 and the chunked one at
    # Vim-T's lengths; there the chunked form is also held against its
    # plain version (the same three phases in tensor ops) and against the
    # sequential kernel on the same inputs, y and the chunk-entry states,
    # and both forms are timed in the [time] line of each length
    d, n = 384, 16
    A = -torch.exp(uni(d, n, bound=1.0))
    bias = uni(d, bound=0.5)
    chunked_err = 0.0
    for L, batch in ((128, 2), (16384, 2), (16385, 1)):
        route = ss.fwd_route(L)
        log(f"[route] selective_scan_fwd L={L}: {route}")
        base = dict(u=rnd(batch, L, d), delta=rnd(batch, L, d, scale=0.5),
                    B=rnd(batch, L, n), C=rnd(batch, L, n))
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            if L == 16385 and dtype == torch.bfloat16:
                continue
            t = {k: v.to(dtype) for k, v in base.items()}
            args = (t["u"], t["delta"], A, t["B"], t["C"])
            kw = dict(delta_bias=bias, delta_softplus=True)
            for reverse in (False, True):
                tag = f"L={L} B={batch} {dtype} reverse={reverse}"
                got = ss.selective_scan_fwd(*args, reverse=reverse, **kw)
                want = ss.selective_scan_plain(*args, reverse=reverse, **kw)
                e = compare(f"selective_scan_fwd {tag}", got, want, tol)
                errs["selective_scan_fwd"] = max(errs["selective_scan_fwd"],
                                                 e)
                if L == 128:
                    continue
                y_c, st_c = ss._launch_fwd("chunked", *args, reverse=reverse,
                                           save_states=True, **kw)
                y_p, st_p = ss.selective_scan_fwd_chunked_plain(
                    *args, None, bias, True, reverse)
                y_s, st_s = ss._launch_fwd("sequential", *args,
                                           reverse=reverse, save_states=True,
                                           **kw)
                for what, gt, wt in (("y vs plain", y_c, y_p),
                                     ("states vs plain", st_c, st_p),
                                     ("y vs sequential", y_c, y_s),
                                     ("states vs sequential", st_c, st_s)):
                    chunked_err = max(chunked_err, compare(
                        f"selective_scan_fwd chunked {what} {tag}", gt, wt,
                        tol))
                del y_c, st_c, y_p, st_p, y_s, st_s
            if dtype == torch.bfloat16:
                kern = lambda: ss.selective_scan_fwd(*args, reverse=True, **kw)
                other = "chunked" if route == "sequential" else "sequential"
                alt = lambda: ss._launch_fwd(other, *args, reverse=True, **kw)
                plain = lambda: ss.selective_scan_plain(*args, reverse=True,
                                                        **kw)
                k_ms = cuda_ms(kern, 200 if L == 128 else 5)
                o_ms = cuda_ms(alt, 200 if L == 128 else 5)
                p_ms = cuda_ms(plain, 3 if L == 128 else 1)
                # per (b, t, d, n): exp, the recurrence (4), h·C and its sum
                b_ms, by = bound(nbytes(*args, bias, got), 9.0 * batch * L * d
                                 * n, "fp32")
                per = lambda r: per_call[f"selective_scan_fwd L={L} {r}"]
                log(f"[time] selective_scan_fwd bf16 B={batch} L={L} d={d}: "
                    f"kernel ({route}, {per(route):g} launches) {k_ms:.4f} "
                    f"ms, {other} ({per(other):g} launches) {o_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                    f"({card})")
                times.setdefault("selective_scan_fwd", (k_ms, p_ms, b_ms, by))
            del got, want
        del base, t
        torch.cuda.empty_cache()
    log(f"[check] selective_scan_fwd chunked form at L = 16,384 and 16,385: "
        f"max abs err {chunked_err:.3g} against its plain version and the "
        f"sequential kernel")

    # K3 / K4 at FastVim-T's widths (the main path: 2048 px, batch 2, and
    # 224 px), FastVim-S's (2048 px, batch 2), and FastVim-B's, -L's and
    # -H's (K3's streamed form, K4's wide one): B at 2048 px (batch 2) and
    # 224 px (batch 8), L at 224 px, H at 448 px with patch 14 (a 32 × 32
    # grid); then fp32 alone at FP32_FWD_SHAPES, and K3 pools-only in
    # fp32. The kernels line takes FastVim-T's times under the kernel's
    # name and each wide width's first shape under "<name> d_model=<dm>";
    # the fp32 forms' at B = 128 (their even orientation) under
    # "<name> fp32" and "<name> fp32 d_model=768", timed beside the fp32
    # SGEMM of the same products (TF32 off: a yardstick the port never
    # calls), their bound max(bytes / 3.35 TB/s, 3 × FLOP / 495 TFLOP/s)
    # and the FMA units' bound (FLOP / 67 TFLOP/s)
    for dm, di, shapes in ((192, 384, (((128, 128), 2), ((14, 14), 8))),
                           (384, 768, (((128, 128), 2),)),
                           *WIDE_SHAPES):
        wide = dm in WIDE_DM
        w_in = uni(2 * di, dm, bound=dm ** -0.5)
        conv = [uni(di, 4, bound=0.5) for _ in range(2)]
        cbias = [uni(di, bound=0.5) for _ in range(2)]
        w_out = uni(dm, di, bound=di ** -0.5 / 24 ** 0.5)
        d_f, d_b = uni(di, bound=1.0), uni(di, bound=1.0)
        ln_w, ln_b = 1 + uni(di, bound=0.1), uni(di, bound=0.1)
        f32_only = FP32_FWD_SHAPES.get(dm, ())
        for i, ((H, W), batch) in enumerate(shapes + f32_only):
            base_x = rnd(batch, H, W, dm)
            dtypes = ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL))
            for transposed in (False, True):
                P = W if transposed else H
                base_b = dict(xc_f=rnd(batch, H, W, di),
                              xc_b=rnd(batch, H, W, di),
                              yf=rnd(batch, P, di), yb=rnd(batch, P, di))
                for dtype, tol in dtypes[:1 if i >= len(shapes) else 2]:
                    fp32 = dtype == torch.float32
                    x4 = base_x.to(dtype)
                    wx, wz = w_in[:di].to(dtype), w_in[di:].to(dtype)
                    a_args = (x4, wx, None, conv[0], cbias[0], conv[1],
                              cbias[1], 1.0, transposed)
                    tag = (f"d_model={dm} d_inner={di} grid={H}x{W} "
                           f"B={batch} {dtype} transposed={transposed}")
                    got = lf.pass_a(*a_args)
                    want = lf.pass_a_plain(*a_args)
                    key = lambda name: (name + (" fp32" if fp32 else "")
                                        + (f" d_model={dm}" if wide else ""))
                    for part, gt, wt in zip(("xc_f", "xc_b", "pf", "pb"), got,
                                            want):
                        e = compare(f"pass_a_fwd {part} {tag}", gt, wt, tol)
                        errs[key("pass_a_fwd")] = max(
                            errs.get(key("pass_a_fwd"), 0.0), e)
                    if fp32:
                        for part, gt, wt in zip(
                                ("pf", "pb"),
                                lf.pass_a(*a_args, write_xc=False)[2:],
                                want[2:]):
                            e = compare(f"pass_a_fwd pools-only {part} {tag}",
                                        gt, wt, tol)
                            errs[key("pass_a_fwd")] = max(
                                errs[key("pass_a_fwd")], e)
                    bb = {k: v.to(dtype) for k, v in base_b.items()}
                    b_args = (x4, bb["xc_f"], bb["xc_b"], bb["yf"], bb["yb"],
                              wz, None, d_f, d_b, ln_w, ln_b, w_out.to(dtype),
                              None, 1e-5, True, transposed)
                    e = compare(f"pass_b_fwd {tag}", lf.pass_b(*b_args),
                                lf.pass_b_plain(*b_args), tol)
                    errs[key("pass_b_fwd")] = max(
                        errs.get(key("pass_b_fwd"), 0.0), e)
                    if not (batch == 128 if fp32
                            else wide or (H, W) == (128, 128)):
                        continue
                    gemm = 2.0 * batch * H * W * dm * di  # one GEMM's FLOP
                    # the child counted the wide forms at FastVim-B's widths
                    per = "" if not wide else f" d_model={WIDE_DM[0]}"
                    xm = x4.reshape(-1, dm)
                    gm = bb["xc_f"].reshape(-1, di)
                    for name, kern, plain, args, outs, flops, sgemm in (
                            ("pass_a_fwd", lf.pass_a, lf.pass_a_plain, a_args,
                             got, gemm, lambda: xm @ wx.t()),
                            ("pass_b_fwd", lf.pass_b, lf.pass_b_plain, b_args,
                             (x4,), 2 * gemm,
                             lambda: (xm @ wz.t(), gm @ b_args[11].t()))):
                        k_ms = cuda_ms(lambda: kern(*args), 20)
                        p_ms = cuda_ms(lambda: plain(*args), 3 if fp32 else 20)
                        b_ms, by = bound(
                            nbytes(*(a for a in args
                                     if isinstance(a, torch.Tensor)), *outs),
                            flops, "tf32x3" if fp32 else "bf16")
                        n = per_call[name + per][str(dtype)]
                        more = (f", SGEMM {cuda_ms(sgemm, 20):.4f} ms"
                                if fp32 else "")
                        fma = (f"; FMA bound "
                               f"{flops / PEAK_FLOPS['fp32'] * 1e3:.4f} ms"
                               if fp32 else "")
                        log(f"[time] {name} {'fp32' if fp32 else 'bf16'} "
                            f"{tag}: kernel {k_ms:.4f} ms in {n:g} launches, "
                            f"plain {p_ms:.4f} ms{more}, bound {b_ms:.4f} ms "
                            f"({by}{'; 3xTF32' if fp32 else ''}), "
                            f"{b_ms / k_ms:.1%} of the bound{fma} ({card})")
                        # the kernels line takes the main path's widths,
                        # and each wide width's first shape
                        times.setdefault(key(name), (k_ms, p_ms, b_ms, by))
                    del xm, gm
                del got, want
            del base_x, base_b
            torch.cuda.empty_cache()
    return errs, times


def compare_all(name, got, want, tol, n_per_token, parts=False):
    """compare() over two tuples of tensors, the first ``n_per_token`` of
    them per token or step and the rest summed over all of them; returns
    the largest error, or with ``parts`` (the largest error of the
    per-token tensors, the largest of the summed ones over max(1, their
    largest entry): the quantities the tolerance holds to tol)."""
    errs = [compare(f"{name} [{i}]", g, w, tol, summed=i >= n_per_token)
            for i, (g, w) in enumerate(zip(got, want))]
    if not parts:
        return max(errs)
    return max(errs[:n_per_token]), max(
        e / max(1.0, w.float().abs().max().item())
        for e, w in zip(errs[n_per_token:], want[n_per_token:]))


def check_bwd_kernels(dev, card, per_call):
    """Phase 2, the backward kernels: K2, K5 and K6 against their plain
    versions on the card."""
    import torch

    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    errs = {"selective_scan_bwd": 0.0, "pass_b_bwd": 0.0, "pass_a_bwd": 0.0}
    times = {}

    # K2: the pooled scans of a FastVim-T train step at 2048 px (L = 128,
    # batch 3) and Vim-T's full-length scans (L = 16,384; 16,385 is the
    # ragged last chunk of the middle-cls-token model), the launcher
    # against the plain version: its error and its L = 128 time are the
    # kernels line's. The launcher takes the sequential form at L = 128 and
    # the chunked one at Vim-T's lengths; there the chunked form is also
    # held against its plain version (the same three phases in tensor ops)
    # and against the sequential kernel on the same inputs, and both forms
    # are timed in the [time] line of each length
    d, n = 384, 16
    A = -torch.exp(uni(d, n, bound=1.0))
    bias, D = uni(d, bound=0.5), uni(d, bound=1.0)
    order = (0, 1, 3, 4, 2, 5, 6)  # du, ddelta, dB, dC per step; then sums
    pick = lambda grads: [grads[i] for i in order]
    chunked_err = 0.0
    for L, batch in ((128, 3), (16384, 2), (16385, 1)):
        route = ss.bwd_route(L)
        log(f"[route] selective_scan_bwd L={L}: {route}")
        base = dict(u=rnd(batch, L, d), delta=rnd(batch, L, d, scale=0.5),
                    B=rnd(batch, L, n), C=rnd(batch, L, n),
                    g=rnd(batch, L, d))
        for dtype in (torch.float32, torch.bfloat16):
            if L == 16385 and dtype == torch.bfloat16:
                continue
            bf = dtype == torch.bfloat16
            tol = BF16_TOL if bf else FP32_TOL
            t = {k: v.to(dtype) for k, v in base.items()}
            ins = (t["u"], t["delta"], A, t["B"], t["C"], D, bias)
            for reverse in (False, True):
                tag = f"L={L} B={batch} {dtype} reverse={reverse}"
                _, states = ss.selective_scan_fwd(
                    *ins[:5], D=D, delta_bias=bias, delta_softplus=True,
                    reverse=reverse, save_states=True)
                got = ss.selective_scan_bwd(*ins, t["g"], states, True,
                                            reverse)
                want = ss.selective_scan_bwd_plain(*ins, t["g"], True,
                                                   reverse)
                # du, ddelta, dB, dC per step first; dA, dD, dbias are
                # summed over every step of every batch element
                e = compare_all(f"selective_scan_bwd {tag}", pick(got),
                                pick(want), tol, 4)
                errs["selective_scan_bwd"] = max(errs["selective_scan_bwd"],
                                                 e)
                del want
                if L == 128:
                    continue
                for what, fn in (
                        ("plain", ss.selective_scan_bwd_chunked_plain),
                        ("sequential", partial(ss._launch_bwd, "sequential"))):
                    chunked_err = max(chunked_err, compare_all(
                        f"selective_scan_bwd chunked vs {what} {tag}",
                        pick(got), pick(fn(*ins, t["g"], states, True,
                                           reverse)), tol, 4))
                torch.cuda.empty_cache()
            if bf and L != 16385:
                kern = lambda: ss.selective_scan_bwd(*ins, t["g"], states,
                                                     True, True)
                other = "chunked" if route == "sequential" else "sequential"
                alt = lambda: ss._launch_bwd(other, *ins, t["g"], states,
                                             True, True)
                plain = lambda: ss.selective_scan_bwd_plain(*ins, t["g"],
                                                            True, True)
                k_ms = cuda_ms(kern, 100 if L == 128 else 3)
                o_ms = cuda_ms(alt, 100 if L == 128 else 3)
                p_ms = cuda_ms(plain, 2 if L == 128 else 1)
                # per (b, t, d, n): h rebuilt (6), lam and the products (14)
                b_ms, by = bound(nbytes(*ins, t["g"], states, *got),
                                 20.0 * batch * L * d * n, "fp32")
                per = lambda r: per_call[f"selective_scan_bwd L={L} {r}"]
                log(f"[time] selective_scan_bwd bf16 B={batch} L={L} d={d}: "
                    f"kernel ({route}, {per(route):g} launches) {k_ms:.4f} "
                    f"ms, {other} ({per(other):g} launches) {o_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                    f"({card})")
                times.setdefault("selective_scan_bwd", (k_ms, p_ms, b_ms, by))
            del got, states
        del base, t
        torch.cuda.empty_cache()
    log(f"[check] selective_scan_bwd chunked form at L = 16,384 and 16,385: "
        f"max abs err {chunked_err:.3g} against its plain version and the "
        f"sequential kernel")

    # K5 / K6 at FastVim-T's widths (the main path: 2048 px, batch 3) and
    # FastVim-S's (batch 2): grid 128×128 (2048 px) and 14×14 (224 px);
    # then FastVim-B's, -L's and -H's (the wide forms) at phase 2's wide
    # shapes; then fp32 alone at FP32_BWD_SHAPES. The kernels line takes
    # FastVim-T's times under the kernel's name and each wide width's
    # first shape under "<name> d_model=<dm>"; the fp32 forms' at 224 px,
    # B = 128 (their even orientation) under "<name> fp32" and "<name>
    # fp32 d_model=768", timed beside the fp32 SGEMMs of the same products
    # (TF32 off: a yardstick the port never calls), their bound max(bytes
    # / 3.35 TB/s, 3 × FLOP / 495 TFLOP/s) and the FMA units' bound
    for dm, di, shapes in ((192, 384, (((128, 128), 3), ((14, 14), 8))),
                           (384, 768, (((128, 128), 2), ((14, 14), 8))),
                           *WIDE_SHAPES):
        wide = dm in WIDE_DM
        f32_only = FP32_BWD_SHAPES.get(dm, ())
        shapes = shapes + f32_only
        w_in = uni(2 * di, dm, bound=dm ** -0.5)
        conv = [uni(di, 4, bound=0.5) for _ in range(2)]
        cbias = [uni(di, bound=0.5) for _ in range(2)]
        w_out = uni(dm, di, bound=di ** -0.5)
        d_f, d_b = uni(di, bound=1.0), uni(di, bound=1.0)
        ln_w, ln_b = 1 + uni(di, bound=0.1), uni(di, bound=0.1)
        for (H, W), batch in shapes:
            base = dict(x=rnd(batch, H, W, dm), g=rnd(batch, H, W, dm),
                        xc_f=rnd(batch, H, W, di), xc_b=rnd(batch, H, W, di),
                        dxc_f=rnd(batch, H, W, di), dxc_b=rnd(batch, H, W, di))
            dx_b = rnd(batch, H, W, dm)
            for transposed in (False, True):
                P = W if transposed else H
                pooled = dict(yf=rnd(batch, P, di), yb=rnd(batch, P, di),
                              dpf=rnd(batch, P, di), dpb=rnd(batch, P, di))
                timed_f32 = ((H, W), batch) in f32_only
                for dtype in (torch.float32,) + (
                        () if timed_f32 else (torch.bfloat16,)):
                    bf = dtype == torch.bfloat16
                    key = lambda name: (name + ("" if bf else " fp32")
                                        * timed_f32
                                        + (f" d_model={dm}" if wide else ""))
                    t = {k: v.to(dtype)
                         for k, v in {**base, **pooled}.items()}
                    wx, wz = w_in[:di].to(dtype), w_in[di:].to(dtype)
                    tag = (f"d_model={dm} d_inner={di} grid={H}x{W} B={batch} "
                           f"{dtype} transposed={transposed}")
                    # K5: dx, dxc_f, dxc_b, dy per token or line; the 8
                    # weight and vector gradients summed over every token
                    b_args = (t["g"], t["x"], t["xc_f"], t["xc_b"], t["yf"],
                              t["yb"], wz, None, d_f, d_b, ln_w, ln_b,
                              w_out.to(dtype), 1e-5, True, transposed)
                    got_b = lf.pass_b_bwd(*b_args)
                    tol = BF16_TOL if bf else FP32_TOL
                    e = compare_all(f"pass_b_bwd {tag}", got_b,
                                    lf.pass_b_bwd_plain(*b_args), tol, 4,
                                    parts=timed_f32)
                    if timed_f32:  # the kernels line: per token, summed
                        e, es = e
                        errs[key("pass_b_bwd") + " summed"] = max(
                            errs.get(key("pass_b_bwd") + " summed", 0.0), es)
                    errs[key("pass_b_bwd")] = max(
                        errs.get(key("pass_b_bwd"), 0.0), e)
                    # K6: dx per token; 6 gradients summed over every token
                    a_args = (t["x"], dx_b, t["dxc_f"], t["dxc_b"], t["dpf"],
                              t["dpb"], wx, None, conv[0], cbias[0], conv[1],
                              cbias[1], 1.0, transposed)
                    got_a = lf.pass_a_bwd(*a_args)
                    e = compare_all(f"pass_a_bwd {tag}", got_a,
                                    lf.pass_a_bwd_plain(*a_args), tol, 1,
                                    parts=timed_f32)
                    if timed_f32:  # the kernels line: per token, summed
                        e, es = e
                        errs[key("pass_a_bwd") + " summed"] = max(
                            errs.get(key("pass_a_bwd") + " summed", 0.0), es)
                    errs[key("pass_a_bwd")] = max(
                        errs.get(key("pass_a_bwd"), 0.0), e)
                    if not (bf and (wide or (H, W) == (128, 128))
                            or timed_f32 and not transposed):
                        continue
                    gemm = 2.0 * batch * H * W * dm * di  # one GEMM's FLOP
                    # the child counted the wide forms at FastVim-B's widths
                    per = "" if not wide else f" d_model={WIDE_DM[0]}"
                    T = batch * H * W
                    xm, gm = t["x"].reshape(T, dm), t["g"].reshape(T, dm)
                    zm = t["xc_f"].reshape(T, di)  # a (T, d_inner) operand
                    # the same products alone: K5's z, dgated, dx̂, dW_out,
                    # dW_z; K6's xin, dx̂, dW_x
                    sgemms = {"pass_b_bwd": lambda: (
                        xm @ wz.t(), gm @ b_args[12], zm @ wz, zm.t() @ gm,
                        zm.t() @ xm),
                        "pass_a_bwd": lambda: (xm @ wx.t(), zm @ wx,
                                               zm.t() @ xm)}
                    for name, kern, plain, args, outs, flops in (
                            ("pass_b_bwd", lf.pass_b_bwd, lf.pass_b_bwd_plain,
                             b_args, got_b, 5 * gemm),
                            ("pass_a_bwd", lf.pass_a_bwd, lf.pass_a_bwd_plain,
                             a_args, got_a, 3 * gemm)):
                        k_ms = cuda_ms(lambda: kern(*args), 10)
                        p_ms = cuda_ms(lambda: plain(*args), 5 if bf else 3)
                        b_ms, by = bound(
                            nbytes(*(a for a in args
                                     if isinstance(a, torch.Tensor)), *outs),
                            flops, "bf16" if bf else "tf32x3")
                        n = per_call[name + per][str(dtype)]
                        more = ("" if bf else
                                f", SGEMMs {cuda_ms(sgemms[name], 5):.4f} ms")
                        fma = ("" if bf else
                               f"; FMA bound "
                               f"{flops / PEAK_FLOPS['fp32'] * 1e3:.4f} ms")
                        log(f"[time] {name} {'bf16' if bf else 'fp32'} "
                            f"{tag}: kernel {k_ms:.4f} ms in {n:g} launches, "
                            f"plain {p_ms:.4f} ms{more}, bound {b_ms:.4f} ms "
                            f"({by}{'' if bf else '; 3xTF32'}), "
                            f"{b_ms / k_ms:.1%} of the bound{fma} ({card})")
                        # the kernels line takes the main path's widths,
                        # and each wide width's first shape
                        times.setdefault(key(name), (k_ms, p_ms, b_ms, by))
                    del xm, gm, zm
            del base, dx_b, t
            torch.cuda.empty_cache()
    return errs, times


def timed(name, tag, kern, plain, n_bytes, flops, kind, card, iters=20,
          plain_iters=20, graph=False):
    """Time a kernel and its plain version by CUDA events, a call at a
    time, and log both beside the bound; with ``graph`` also the kernel's
    device time a call, from replays of a CUDA graph of ``iters`` calls
    (``profiling.graph_ms``; K8 runs shorter than its wrapper's host
    time). Returns (ms, plain ms, bound ms, bound by, device ms or None)."""
    from fastvim_tpu_torch.utils.profiling import graph_ms

    k_ms = cuda_ms(kern, iters)
    dev_ms = graph_ms(kern, iters) if graph else None
    p_ms = cuda_ms(plain, plain_iters)
    b_ms, by = bound(n_bytes, flops, kind)
    dev = "" if dev_ms is None else (
        f", device {dev_ms:.4f} ms a call ({b_ms / dev_ms:.1%} of the bound;"
        f" graph replay)")
    log(f"[time] {name} {tag}: kernel {k_ms:.4f} ms{dev}, plain {p_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({by}) ({card})")
    return k_ms, p_ms, b_ms, by, dev_ms


def check_fp32_recompute(dev, card, per_call, errs, times):
    """Phase 2, the fp32 K7 (3xTF32, clusters of ``lf.rc_tf32_ranks`` CTAs)
    at the 224 px CLIs' shape, B = 128, at ``FP32_RC_WIDTHS``
    (FastVim-T's, -S's and -B's widths), both orientations: against its
    plain version, timed beside it, the three fp32 SGEMMs alone (TF32 off:
    a yardstick the port never calls), the 3xTF32 bound and the FMA
    units' bound. The kernels line takes the even orientation at
    FastVim-T's widths (``"pass_b_recompute_fwd fp32"``) and at -B's
    (``"... fp32 d_model=768"``); ``errs`` and ``times`` are filled in."""
    import torch

    from fastvim_tpu_torch.ops.kernels import layer_fused as lf

    g = torch.Generator(device=dev).manual_seed(27)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    tensors = lambda args: [a for a in args if isinstance(a, torch.Tensor)]
    batch, (H, W) = 128, (14, 14)
    for dm, di in FP32_RC_WIDTHS:
        w_in = uni(2 * di, dm, bound=dm ** -0.5)
        w_out = uni(dm, di, bound=di ** -0.5 / 24 ** 0.5)
        conv = [uni(di, 4, bound=0.5) for _ in range(2)]
        cbias = [uni(di, bound=0.5) for _ in range(2)]
        vec = [uni(di, bound=1.0), uni(di, bound=1.0),
               1 + uni(di, bound=0.1), uni(di, bound=0.1)]
        x4 = rnd(batch, H, W, dm)
        key = "pass_b_recompute_fwd fp32" + (
            "" if dm == FP32_RC_WIDTHS[0][0] else f" d_model={dm}")
        for transposed in (False, True):
            ys = rnd(batch, W if transposed else H, di)
            args = (x4, ys, ys.flip(-1), w_in[:di], None, conv[0],
                    cbias[0], conv[1], cbias[1], w_in[di:], None, *vec,
                    w_out, None, 1e-5, True, transposed)
            tag = (f"d_model={dm} d_inner={di} grid={H}x{W} B={batch} "
                   f"torch.float32 transposed={transposed}")
            got = lf.pass_b_recompute(*args)
            want = lf.pass_b_recompute_plain(*args)
            e = compare(f"pass_b_recompute_fwd {tag}", got, want, FP32_TOL)
            errs[key] = max(errs.get(key, 0.0), e)
            del want
            flops = 3 * 2.0 * batch * H * W * dm * di
            k_ms, p_ms, b_ms, by, _ = timed(
                "pass_b_recompute_fwd", f"{tag} in "
                f"{per_call['pass_b_recompute_fwd']['torch.float32']:g} "
                f"launches ({lf.rc_tf32_ranks(dm, di)} CTAs a cluster)",
                lambda: lf.pass_b_recompute(*args),
                lambda: lf.pass_b_recompute_plain(*args),
                nbytes(*tensors(args), got), flops, "tf32x3", card, iters=10,
                plain_iters=3)
            xm = x4.reshape(-1, dm)
            gm = got.new_empty(batch * H * W, di).normal_(generator=g)
            sgemm = cuda_ms(lambda: (xm @ args[3].t(), xm @ args[9].t(),
                                     gm @ w_out.t()), 10)
            log(f"[time] pass_b_recompute_fwd fp32 {tag}: SGEMMs alone "
                f"{sgemm:.4f} ms, {b_ms / k_ms:.1%} of the 3xTF32 bound, "
                f"FMA bound {flops / PEAK_FLOPS['fp32'] * 1e3:.4f} ms "
                f"({card})")
            if not transposed:
                times[key] = (k_ms, p_ms, b_ms, by)
            del got, gm, args
        del x4, w_in, w_out
        torch.cuda.empty_cache()


def check_config_kernels(dev, card, per_call):
    """Phase 2, the kernels of the other configurations: K7, K8, K9, K10
    and lanes against their plain versions on the card, at FastVim-T's
    2048 px shapes (grid 128 × 128, batch 2, d_model 192, d_inner 384), K7,
    K8 and K9 also at FastVim-S's widths (d_model 384, d_inner 768), K7
    also at FastVim-B's, -L's and -H's (``WIDE_SHAPES``)."""
    import torch

    from fastvim_tpu_torch.ops.kernels import fused_block as fb
    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import merge_gate as mg
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss
    from fastvim_tpu_torch.utils.profiling import graph_ms

    g = torch.Generator(device=dev).manual_seed(20)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    names = ("pass_b_recompute_fwd", "conv_pool_fwd", "merge_gate_fwd",
             "merge_ln_gate_fwd", "selective_scan_fwd_lanes")
    errs = dict.fromkeys(names, 0.0)
    times = {}
    worst = lambda name, e: errs.__setitem__(name, max(errs[name], e))
    cases = ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL))
    tensors = lambda args: [a for a in args if isinstance(a, torch.Tensor)]

    batch, (H, W), dm, di = 2, (128, 128), 192, 384
    L = H * W
    d_f, d_b = uni(di, bound=1.0), uni(di, bound=1.0)
    ln_w, ln_b = 1 + uni(di, bound=0.1), uni(di, bound=0.1)

    # K8 / K9: x and z are the column halves of the in-projection's
    # output, at FastVim-T's widths (the kernels line's) and FastVim-S's
    yf, yb = rnd(batch, H, di), rnd(batch, H, di)
    for di_ in (di, 768):
        conv_ = [uni(di_, 4, bound=0.5) for _ in range(2)]
        cbias_ = [uni(di_, bound=0.5) for _ in range(2)]
        vec = (uni(di_, bound=1.0), uni(di_, bound=1.0),
               1 + uni(di_, bound=0.1), uni(di_, bound=0.1))
        cargs = (conv_[0], cbias_[0], conv_[1], cbias_[1])
        base_xz = rnd(batch, L, 2 * di_)
        ys = (yf, yb) if di_ == di else (rnd(batch, H, di_),
                                         rnd(batch, H, di_))
        for dtype, tol in cases:
            bf = dtype == torch.bfloat16
            xz = base_xz.to(dtype)
            x, z = xz[..., :di_], xz[..., di_:]
            tag = f"bf16 B={batch} L={L} d={di_}"
            for method in ("mean", "max"):
                args = (x, *cargs, H, W, method, 0.5)
                got = fb.conv_pool(*args)
                for part, gt, wt in zip(("pf", "pb"), got,
                                        fb.conv_pool_plain(*args)):
                    worst("conv_pool_fwd", compare(
                        f"conv_pool_fwd {part} {method} {dtype} d={di_}", gt,
                        wt, tol))
                if bf and method == "mean":
                    # per element: 2 convs of 4 taps (16), 2 SiLU (~10), sums
                    tm = timed("conv_pool_fwd", tag,
                               lambda: fb.conv_pool(*args),
                               lambda: fb.conv_pool_plain(*args),
                               nbytes(*tensors(args), *got),
                               30.0 * batch * L * di_, "fp32", card,
                               graph=True)
                    log(f"[time] conv_pool_fwd {tag}: "
                        f"{per_call['conv_pool_fwd'][str(dtype)]} device "
                        f"kernel a call ({card})")
                    times.setdefault("conv_pool_fwd", tm)
            for use_norm in (True, False):
                args = (x, z, *ys, *cargs, *vec, H, W, 1e-5, use_norm)
                got = fb.merge_gate(*args)
                worst("merge_gate_fwd", compare(
                    f"merge_gate_fwd use_norm={use_norm} {dtype} d={di_}",
                    got, fb.merge_gate_plain(*args), tol))
                if bf and use_norm:
                    # K8's conv stage, then the merge, LN and gate (~25)
                    tm = timed("merge_gate_fwd", tag,
                               lambda: fb.merge_gate(*args),
                               lambda: fb.merge_gate_plain(*args),
                               nbytes(*tensors(args), got),
                               55.0 * batch * L * di_, "fp32", card,
                               graph=True)
                    log(f"[time] merge_gate_fwd {tag}: "
                        f"{per_call['merge_gate_fwd'][str(dtype)]} device "
                        f"kernel a call ({card})")
                    times.setdefault("merge_gate_fwd", tm)
        del base_xz, xz, x, z, got
        torch.cuda.empty_cache()

    # K10: both broadcast patterns (P = H = W here), at FastVim-T's widths
    # (the kernels line's) and FastVim-S's
    for di_ in (di, 768):
        base = dict(xc_f=rnd(batch, L, di_), xc_b=rnd(batch, L, di_),
                    yf=rnd(batch, H, di_), yb=rnd(batch, H, di_))
        base_z = rnd(batch, L, 2 * di_)
        vec = ((d_f, d_b, ln_w, ln_b) if di_ == di else
               (uni(di_, bound=1.0), uni(di_, bound=1.0),
                1 + uni(di_, bound=0.1), uni(di_, bound=0.1)))
        for dtype, tol in cases:
            t = {k: v.to(dtype) for k, v in base.items()}
            z = base_z.to(dtype)[..., di_:]
            for pool_axes in ((1,), (0,)):
                args = (t["xc_f"], t["xc_b"], z, t["yf"], t["yb"], *vec,
                        (H, W), pool_axes, 1e-5, True)
                got = mg.merge_ln_gate(*args)
                worst("merge_ln_gate_fwd", compare(
                    f"merge_ln_gate_fwd pool_axes={pool_axes} {dtype} "
                    f"d={di_}", got, mg.merge_ln_gate_plain(*args), tol))
                if dtype == torch.bfloat16:
                    tag = (f"bf16 B={batch} L={L} d={di_} pool_axes="
                           f"{pool_axes}")
                    tm = timed("merge_ln_gate_fwd", tag,
                               lambda: mg.merge_ln_gate(*args),
                               lambda: mg.merge_ln_gate_plain(*args),
                               nbytes(*tensors(args), got),
                               25.0 * batch * L * di_, "fp32", card,
                               graph=True)
                    log(f"[time] merge_ln_gate_fwd {tag}: "
                        f"{per_call['merge_ln_gate_fwd'][str(dtype)]} device "
                        f"kernel a call ({card})")
                    times.setdefault("merge_ln_gate_fwd", tm)
        del base, base_z, t, z, got
        torch.cuda.empty_cache()

    # K7 at FastVim-T's widths (the kernels line's) and FastVim-S's, both
    # orientations; its pass A, K3 without the xc stores, timed beside it
    for dm_, di_ in ((dm, di), (384, 768)):
        w_in = uni(2 * di_, dm_, bound=dm_ ** -0.5)
        w_out = uni(dm_, di_, bound=di_ ** -0.5 / 24 ** 0.5)
        conv_ = [uni(di_, 4, bound=0.5) for _ in range(2)]
        cbias_ = [uni(di_, bound=0.5) for _ in range(2)]
        vec = [uni(di_, bound=1.0), uni(di_, bound=1.0),
               1 + uni(di_, bound=0.1), uni(di_, bound=0.1)]
        base_x = rnd(batch, H, W, dm_)
        ys = rnd(batch, H, di_), rnd(batch, H, di_)
        for dtype, tol in cases:
            x4 = base_x.to(dtype)
            wx, wz = w_in[:di_].to(dtype), w_in[di_:].to(dtype)
            for transposed in (False, True):
                args = (x4, ys[0].to(dtype), ys[1].to(dtype), wx, None,
                        conv_[0], cbias_[0], conv_[1], cbias_[1], wz, None,
                        *vec, w_out.to(dtype), None, 1e-5, True, transposed)
                tag = (f"d_model={dm_} d_inner={di_} grid={H}x{W} B={batch} "
                       f"{dtype} transposed={transposed}")
                got = lf.pass_b_recompute(*args)
                worst("pass_b_recompute_fwd", compare(
                    f"pass_b_recompute_fwd {tag}", got,
                    lf.pass_b_recompute_plain(*args), tol))
                if dtype != torch.bfloat16:
                    continue
                # three GEMMs of d_model × d_inner per token
                k_ms, p_ms, b_ms, by, _ = timed(
                    "pass_b_recompute_fwd", f"{tag} in "
                    f"{per_call['pass_b_recompute_fwd']['torch.bfloat16']:g}"
                    f" launches", lambda: lf.pass_b_recompute(*args),
                    lambda: lf.pass_b_recompute_plain(*args),
                    nbytes(*tensors(args), got),
                    3 * 2.0 * batch * L * dm_ * di_, "bf16", card)
                log(f"[time] pass_b_recompute_fwd {tag}: {b_ms / k_ms:.1%} "
                    f"of the bound ({card})")
                times.setdefault("pass_b_recompute_fwd",
                                 (k_ms, p_ms, b_ms, by))
                a_args = (x4, wx, None, conv_[0], cbias_[0], conv_[1],
                          cbias_[1], 1.0, transposed)
                pools = lf.pass_a(*a_args, write_xc=False)[2:]
                for part, gt, wt in zip(("pf", "pb"), pools,
                                        lf.pass_a(*a_args)[2:]):
                    compare(f"pass_a_fwd pools-only {part} {tag}", gt, wt,
                            0.0)
                a_ms = cuda_ms(lambda: lf.pass_a(*a_args, write_xc=False), 20)
                log(f"[time] pass_a_fwd pools-only {tag}: kernel {a_ms:.4f} "
                    f"ms ({card})")
        del base_x, x4, got
        torch.cuda.empty_cache()

    # K7's wide forms at FastVim-B's, -L's and -H's widths (the shapes of
    # K3-K6's wide rows), both orientations and dtypes, each timed beside
    # its bound (fp32 in fewer calls) with its pass A, K3's pools-only
    # form; the kernels line takes each width's first shape in bf16 under
    # "pass_b_recompute_fwd d_model=<dm>"
    for dm_, di_, shapes in WIDE_SHAPES:
        key = f"pass_b_recompute_fwd d_model={dm_}"
        w_in = uni(2 * di_, dm_, bound=dm_ ** -0.5)
        w_out = uni(dm_, di_, bound=di_ ** -0.5 / 24 ** 0.5)
        conv_ = [uni(di_, 4, bound=0.5) for _ in range(2)]
        cbias_ = [uni(di_, bound=0.5) for _ in range(2)]
        vec = [uni(di_, bound=1.0), uni(di_, bound=1.0),
               1 + uni(di_, bound=0.1), uni(di_, bound=0.1)]
        for (H_, W_), batch_ in shapes:
            base_x = rnd(batch_, H_, W_, dm_)
            for transposed in (False, True):
                P = W_ if transposed else H_
                ys = rnd(batch_, P, di_), rnd(batch_, P, di_)
                for dtype, tol in cases:
                    x4 = base_x.to(dtype)
                    wx, wz = w_in[:di_].to(dtype), w_in[di_:].to(dtype)
                    args = (x4, ys[0].to(dtype), ys[1].to(dtype), wx, None,
                            conv_[0], cbias_[0], conv_[1], cbias_[1], wz,
                            None, *vec, w_out.to(dtype), None, 1e-5, True,
                            transposed)
                    tag = (f"d_model={dm_} d_inner={di_} grid={H_}x{W_} "
                           f"B={batch_} {dtype} transposed={transposed}")
                    got = lf.pass_b_recompute(*args)
                    errs[key] = max(errs.get(key, 0.0), compare(
                        f"pass_b_recompute_fwd {tag}", got,
                        lf.pass_b_recompute_plain(*args), tol))
                    bf = dtype == torch.bfloat16
                    n = per_call["pass_b_recompute_fwd d_model=768"][
                        str(dtype)]
                    k_ms, p_ms, b_ms, by, _ = timed(
                        "pass_b_recompute_fwd", f"{tag} in {n:g} launches",
                        lambda: lf.pass_b_recompute(*args),
                        lambda: lf.pass_b_recompute_plain(*args),
                        nbytes(*tensors(args), got),
                        3 * 2.0 * batch_ * H_ * W_ * dm_ * di_,
                        "bf16" if bf else "tf32x3", card,
                        iters=10 if bf else 5, plain_iters=10 if bf else 3)
                    log(f"[time] pass_b_recompute_fwd {tag}: "
                        f"{b_ms / k_ms:.1%} of the bound ({card})")
                    if not bf:
                        continue
                    times.setdefault(key, (k_ms, p_ms, b_ms, by))
                    a_args = (x4, wx, None, conv_[0], cbias_[0], conv_[1],
                              cbias_[1], 1.0, transposed)
                    a_ms = cuda_ms(lambda: lf.pass_a(*a_args,
                                                     write_xc=False), 10)
                    log(f"[time] pass_a_fwd pools-only {tag}: kernel "
                        f"{a_ms:.4f} ms ({card})")
                del x4, got, args
            del base_x
            torch.cuda.empty_cache()

    check_fp32_recompute(dev, card, per_call, errs, times)

    # lanes: the pooled scan's length and Vim-T's, beside K1 on the same
    # inputs
    d, n = 384, 16
    A = -torch.exp(uni(d, n, bound=1.0))
    bias = uni(d, bound=0.5)
    kw = dict(delta_bias=bias, delta_softplus=True)
    for Ls in (128, 16384):
        base = dict(u=rnd(batch, Ls, d), delta=rnd(batch, Ls, d, scale=0.5),
                    B=rnd(batch, Ls, n), C=rnd(batch, Ls, n))
        for dtype, tol in cases:
            t = {k: v.to(dtype) for k, v in base.items()}
            args = (t["u"], t["delta"], A, t["B"], t["C"])
            got = ss.selective_scan_fwd_lanes(*args, **kw)
            worst("selective_scan_fwd_lanes", compare(
                f"selective_scan_fwd_lanes L={Ls} B={batch} {dtype}", got,
                ss.selective_scan_fwd_lanes_plain(*args, **kw), tol))
            compare(f"selective_scan_fwd_lanes vs K1 L={Ls} {dtype}", got,
                    ss.selective_scan_fwd(*args, **kw), tol)
            if dtype == torch.bfloat16:
                # the same function as K1: its bytes and its 9 operations
                # per (b, t, d, n)
                tm = timed("selective_scan_fwd_lanes",
                           f"bf16 B={batch} L={Ls} d={d} in "
                           f"{per_call[f'selective_scan_fwd_lanes L={Ls}']}"
                           f" device kernels",
                           lambda: ss.selective_scan_fwd_lanes(*args, **kw),
                           lambda: ss.selective_scan_fwd_lanes_plain(*args,
                                                                     **kw),
                           nbytes(*args, bias, got),
                           9.0 * batch * Ls * d * n, "fp32", card,
                           iters=200 if Ls == 128 else 10,
                           plain_iters=20 if Ls == 128 else 2, graph=True)
                k1 = cuda_ms(lambda: ss.selective_scan_fwd(*args, **kw),
                             200 if Ls == 128 else 10)
                k1_dev = graph_ms(lambda: ss.selective_scan_fwd(*args, **kw),
                                  200 if Ls == 128 else 10)
                log(f"[time] selective_scan_fwd (K1, forward direction) bf16 "
                    f"B={batch} L={Ls} d={d}: {k1:.4f} ms a call, device "
                    f"{k1_dev:.4f} ms ({card})")
                if Ls == 16384:  # the length phase 6 drives it at
                    times["selective_scan_fwd_lanes"] = tm
        del base, t, got
        torch.cuda.empty_cache()
    return errs, times


# the configurations of fastvim_tiny that reach K7-K10: model fields, and
# the launches of one forward at depth 24
CONFIGS = {
    "fused_kernels=always": (
        dict(layer_fused="off", ssm_cfg={"fused_kernels": "always"}),
        {"conv_pool_fwd": 24, "merge_gate_fwd": 24,
         "selective_scan_fwd": 48}),
    "fused_kernels=merge": (
        dict(layer_fused="off", ssm_cfg={"fused_kernels": "merge"}),
        {"merge_gate_fwd": 24, "selective_scan_fwd": 48}),
    "fused_merge": (
        dict(layer_fused="off", ssm_cfg={"fused_merge": True}),
        {"merge_ln_gate_fwd": 24, "selective_scan_fwd": 48}),
    "layer_fused=recompute": (
        dict(layer_fused="recompute"),
        {"pass_a_fwd": 24, "pass_b_recompute_fwd": 24,
         "selective_scan_fwd": 48}),
}


def check_models_224(dev):
    """Phase 3: 224 px fp32 logits, card (kernels) vs CPU (plain)."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.ops.kernels import merge_gate

    x = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    # fastvim_small in the recompute form: K7 launches in fp32 at the
    # widest d_inner fusable accepts (2 K3 pools-only, 2 K7)
    # fastvim_tiny at d_inner 4096 with fused_merge: K10 at the widest d
    # its fusable accepts (2 launches)
    recompute_s = dict(depth=2, layer_fused="recompute")
    launches_rc = {}
    merge_widest = dict(depth=2, embed_dim=merge_gate.MAX_D // 2,
                        **CONFIGS["fused_merge"][0])
    models = [("fastvim_tiny", {}), ("vim_tiny", {}),
              *(("fastvim_tiny", kw) for kw, _ in CONFIGS.values()),
              ("fastvim_small", recompute_s), ("fastvim_tiny", merge_widest)]
    for name, kw in models:
        cpu_model = create_model(name, img_size=224, device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        want = cpu_model(x)
        kernels.reset_launch_counts()
        got = gpu_model(x.to(dev)).cpu()
        seen = kernels.launch_counts()
        compare(f"{name} {kw} 224px fp32 logits, card vs CPU", got, want,
                MODEL_TOL)
        if kw is CONFIGS["layer_fused=recompute"][0]:
            # the fp32 K7's launches at FastVim-T's widths
            launches_rc["pass_b_recompute_fwd fp32"] = \
                seen["pass_b_recompute_fwd"]
        if kw is merge_widest and seen["merge_ln_gate_fwd"] != 2:
            raise AssertionError(f"{name} {kw}: {seen['merge_ln_gate_fwd']} "
                                 "K10 launches, expected 2")
        if kw is recompute_s:
            k3_k7 = (seen["pass_a_fwd"], seen["pass_b_recompute_fwd"])
            log(f"[check] {name} {kw}: K3, K7 launches {k3_k7}")
            if k3_k7 != (2, 2):
                raise AssertionError(f"{name} {kw}: K3, K7 launches {k3_k7}, "
                                     f"expected (2, 2)")
    # FastVim-B, -L and -H at depth 2 with their default fields: B and H
    # fuse, K3's streamed form and K4's wide one, 2 K3 + 2 K4 + 4 K1 a
    # forward, and L's forward at 224 px, which takes no gradient, runs
    # unfused (default_fwd_mode: fp32 past d_model 768 on 14-token lines);
    # and in the recompute mode, K3's pools-only form and K7's wide forms,
    # 2 K3 + 2 K7 + 4 K1 (the widths where a launcher that refuses a
    # registry width shows)
    wide = {}
    for name, img, dm, x_ in wide_inputs():
        default = (WIDE_ROUTE, "unfused route: no K3, K4") \
            if name == "fastvim_large" else \
            (WIDE_FWD, "fused: K3 streamed, K4 wide")
        for kw, expected, what in (
                ({}, *default),
                (dict(layer_fused="recompute"), WIDE_RC_FWD,
                 "recompute: K3 pools-only, K7 wide")):
            cpu_model = create_model(
                name, img_size=img, depth=2, device="cpu",
                generator=torch.Generator().manual_seed(0), **kw)
            gpu_model = copy.deepcopy(cpu_model).to(dev)
            want = cpu_model(x_)
            kernels.reset_launch_counts()
            got = gpu_model(x_.to(dev)).cpu()
            seen = kernels.launch_counts()
            compare(f"{name} depth 2 {img}px fp32 logits ({what}), card vs "
                    f"CPU", got, want, MODEL_TOL)
            expect_launches(f"{name} {kw} depth 2 {img}px forward", seen,
                            expected)
            for k, n in expected.items():
                if k != "selective_scan_fwd" and n:
                    wide[f"{k} d_model={dm}"] = seen[k]
            if kw and dm == WIDE_DM[0]:  # the fp32 K7 at FastVim-B's widths
                launches_rc["pass_b_recompute_fwd fp32 d_model=768"] = \
                    seen["pass_b_recompute_fwd"]
            del cpu_model, gpu_model
    wide.update(launches_rc)
    return wide


# a forward of a depth-2 FastVim-B/L/H: both layers fused, by default and
# in the recompute mode; or both unfused (the route)
WIDE_FWD = {"pass_a_fwd": 2, "pass_b_fwd": 2, "selective_scan_fwd": 4}
WIDE_ROUTE = {"pass_a_fwd": 0, "pass_b_fwd": 0, "selective_scan_fwd": 4}
WIDE_RC_FWD = {"pass_a_fwd": 2, "pass_b_recompute_fwd": 2,
               "selective_scan_fwd": 4}


def wide_inputs(batch: int = 2):
    """(model, img_size, d_model, CPU images) of phase 3's FastVim-B, -L
    and -H: 224 px, and FastVim-H at 448 px with its patch of 14, the 32 ×
    32 grid of finetune_FastVimH_448.yaml."""
    import torch

    gen = torch.Generator().manual_seed(6)
    return [(name, img, dm, torch.randn(batch, img, img, 3, generator=gen))
            for name, img, dm in (("fastvim_base", 224, 768),
                                  ("fastvim_large", 224, 1024),
                                  ("fastvim_huge", 448, 1280))]


def check_grads_224(dev):
    """Phase 3, training: the loss and every parameter's gradient at
    224 px in fp32, card (kernels) vs CPU (plain versions). The d_model 96
    model fuses forward (K3, K4) but not backward: its layers take the
    remat backward, so no K5 or K6 launches. FastVim-B, -L and -H (depth
    2; -H at 448 px), built with ``layer_fused_bwd="fused"`` (fp32's
    "auto" takes the remat backward at -H's widths on 14- and 16-token
    lines), fuse both ways: 2 K3 + 2 K4 a forward (a forward that takes
    a gradient stays fused, ``default_fwd_mode``) and 2 K5 + 2 K6 a
    backward, the wide forms of the adjoint. Returns the launches of the
    wide models' forwards and backwards, and their K3-K6 launches by
    d_model."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train import cross_entropy

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 224, 224, 3, generator=gen)
    labels = torch.randint(1000, (2,), generator=gen)
    narrow = {"embed_dim": 96, "depth": 2}
    cases = [(name, kw, x, "") for name, kw in (
        ("fastvim_tiny", {}), ("vim_tiny", {}),
        ("fastvim_small", {"depth": 2}), ("fastvim_tiny", narrow))]
    wide = wide_inputs()
    cases += [(name, {"depth": 2, "img_size": img,
                      "layer_fused_bwd": "fused"}, x_, " fused backward")
              for name, img, _, x_ in wide]
    wide_dm = {name: dm for name, _, dm, _ in wide}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    by_dm = {}
    for name, kw, x_, what in cases:
        cpu_model = create_model(name, device="cpu", drop_path_rate=0.0,
                                 generator=torch.Generator().manual_seed(0),
                                 **{"img_size": 224, **kw})
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        results = []
        for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
            model.train()
            kernels.reset_launch_counts()
            loss = cross_entropy(model(x_.to(d)), labels.to(d), 0.1)
            fwd = kernels.launch_counts()
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
            bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
            results.append((loss.detach().cpu(),
                            {n: gr.cpu() for n, gr in zip(params, grads)}))
        if kw is narrow or what:
            seen = (fwd["pass_a_fwd"], fwd["pass_b_fwd"], bwd["pass_b_bwd"],
                    bwd["pass_a_bwd"])
            log(f"[check] {name} {kw}: K3, K4 launches per forward "
                f"{seen[:2]}, K5, K6 in its backward {seen[2:]}; all "
                f"{ {k: v for k, v in kernels.launch_counts().items() if v} }")
            want = (2, 2, 2, 2) if what else (2, 2, 0, 0)
            if seen != want:
                raise AssertionError(f"{name} {kw}: K3, K4, K5, K6 launches "
                                     f"{seen}, expected {want}")
        if what:
            for k, v in kernels.launch_counts().items():
                total[k] += v
            by_dm[wide_dm[name]] = {"pass_a_fwd": fwd["pass_a_fwd"],
                                    "pass_b_fwd": fwd["pass_b_fwd"],
                                    "pass_b_bwd": bwd["pass_b_bwd"],
                                    "pass_a_bwd": bwd["pass_a_bwd"]}
        (want_loss, want), (got_loss, got) = results
        compare(f"{name} {kw} fp32 loss{what}, card vs CPU", got_loss,
                want_loss, MODEL_TOL)
        worst, worst_name = 0.0, ""
        for n, w in want.items():
            scale = w.abs().max().item() + 1e-12
            e = (got[n] - w).abs().max().item() / scale
            if not torch.isfinite(got[n]).all() or e > GRAD_TOL:
                raise AssertionError(f"{name}: gradient of {n} off by {e:.3e} "
                                     f"of its largest entry (> {GRAD_TOL})")
            if e > worst:
                worst, worst_name = e, n
        log(f"[check] {name} {kw} fp32 gradients{what} of {len(want)} "
            f"parameters, card vs CPU: worst {worst:.3e} of the largest "
            f"entry ({worst_name}) tol={GRAD_TOL:g} ok")
        del cpu_model, gpu_model, results
    return total, by_dm


def run_main_path(dev, card):
    """Phase 4: FastVim-T, Vim-T and FastVim-B at 2048 px, batch 2, bf16.
    Returns the launch counts of the three forwards, and FastVim-B's."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.utils.profiling import captured_forward

    batch, img = 2, 2048
    models = {name: create_model(name, img_size=img, dtype=torch.bfloat16,
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
              for name in ("fastvim_tiny", "vim_tiny", "fastvim_base")}
    x = torch.randn(batch, img, img, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    dtype=torch.bfloat16)
    none = dict.fromkeys(kernels.launch_counts(), 0)
    expected = {
        "fastvim_tiny": {**none, "selective_scan_fwd": 48, "pass_a_fwd": 24,
                         "pass_b_fwd": 24},
        "vim_tiny": {**none, "selective_scan_fwd": 48},
    }
    # FastVim-B: K3's streamed form and K4's wide one in every layer
    expected["fastvim_base"] = expected["fastvim_tiny"]
    kernels.reset_launch_counts()
    seen = {}
    for name, model in models.items():
        before = kernels.launch_counts()
        logits = model(x)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        seen[name] = {k: after[k] - before[k] for k in after}
        if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                                 "not finite or of the wrong shape")
        log(f"[main] {name} {img}px B={batch} bf16: logits finite, "
            f"launches {seen[name]}")
        if seen[name] != expected[name]:
            raise AssertionError(f"{name}: launches {seen[name]}, expected "
                                 f"{expected[name]}")
    total = kernels.launch_counts()

    for name, model in models.items():
        ms = cuda_ms(lambda: model(x), 5, windows=5)
        log(f"[time] {name} {img}px B={batch} bf16 forward: {ms:.3f} ms, "
            f"{batch / ms * 1e3:.2f} img/s ({card})")
    # eager FastVim-T is host-bound; replayed as a CUDA graph (static input,
    # captured after warm-up) its forward is the device's time
    for name in ("fastvim_tiny", "fastvim_base"):
        replay = captured_forward(models[name], x)
        ms = cuda_ms(replay, 10, windows=5)
        log(f"[time] {name} {img}px B={batch} bf16 forward, CUDA-graph "
            f"replay: {ms:.3f} ms, {batch / ms * 1e3:.2f} img/s ({card})")
        del replay
    b224 = 40
    x224 = torch.randn(b224, 224, 224, 3, device=dev, dtype=torch.bfloat16,
                       generator=torch.Generator(device=dev).manual_seed(3))
    m224 = create_model("fastvim_tiny", img_size=224, dtype=torch.bfloat16,
                        device=dev)
    ms = cuda_ms(lambda: m224(x224), 10, windows=5)
    log(f"[time] fastvim_tiny 224px B={b224} bf16 forward: {ms:.3f} ms, "
        f"{b224 / ms * 1e3:.2f} img/s ({card})")
    return total, seen["fastvim_base"]


def run_train_path(dev, card):
    """Phase 5: supervised train steps at 2048 px in bf16, through the
    entry points a user calls; FastVim-B's (full depth, B = 2) through the
    wide forms of K5 and K6, timed beside the same step with
    ``layer_fused_bwd="remat"``. Returns the launch counts of all steps,
    and those counted in one FastVim-B step through the fused adjoint."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    img, classes = 2048, 1000
    none = dict.fromkeys(kernels.launch_counts(), 0)
    per_step = {
        "fastvim_tiny": {**none, "selective_scan_fwd": 48,
                         "selective_scan_bwd": 48, "pass_a_fwd": 24,
                         "pass_b_fwd": 24, "pass_b_bwd": 24, "pass_a_bwd": 24},
        "vim_tiny": {**none, "selective_scan_fwd": 48,
                     "selective_scan_bwd": 48},
    }
    # FastVim-S and -B: 24 layers too, each through the same six kernels
    # (FastVim-B's K5 and K6 in their wide forms); FastVim-B with the remat
    # backward runs each layer's two scans again and no K5 or K6
    per_step["fastvim_small"] = per_step["fastvim_tiny"]
    per_step["fastvim_base"] = per_step["fastvim_tiny"]
    remat = {**per_step["fastvim_tiny"], "selective_scan_fwd": 96,
             "pass_b_bwd": 0, "pass_a_bwd": 0}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    step_ms, base_step = {}, None
    for name, batch, steps, fields in (
            ("fastvim_tiny", 3, 5, {}), ("fastvim_small", 2, 3, {}),
            ("fastvim_base", 2, 3, {}),
            ("fastvim_base", 2, 1, {"layer_fused_bwd": "remat"}),
            ("vim_tiny", 2, 1, {})):
        want = remat if fields else per_step[name]
        # no device argument: the entry point builds on the card
        model = create_model(name, img_size=img, dtype=torch.bfloat16,
                             drop_path_rate=0.0,
                             generator=torch.Generator().manual_seed(0),
                             **fields)
        if next(model.parameters()).device.type != "cuda":
            raise AssertionError("create_model did not build on the card")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        tx = make_optimizer(cosine_with_warmup(1e-3, 1e-5, 1000, 20),
                            weight_decay=0.05, params=model)
        state = TrainState.create(model, tx)
        train_step = make_supervised_train_step(
            model, classes, label_smoothing=0.1, ema_decay=None)
        gen = torch.Generator(device=dev).manual_seed(5)
        batch_ = {"image": torch.randn(batch, img, img, 3, device=dev,
                                       generator=gen, dtype=torch.bfloat16),
                  "label": torch.randint(classes, (batch,), device=dev,
                                         generator=gen)}
        losses = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            kernels.reset_launch_counts()
            state, metrics = train_step(state, batch_)
            torch.cuda.synchronize()
            seen = kernels.launch_counts()
            losses.append(metrics["train_loss"].item())
            if seen != want:
                raise AssertionError(f"{name} {fields} step {i}: launches "
                                     f"{seen}, expected {want}")
            if name == "fastvim_base" and not fields:
                base_step = seen
            for k, v in seen.items():
                total[k] += v
        log(f"[train] {name} {fields} {img}px B={batch} bf16: losses "
            f"{[round(v, 5) for v in losses]}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, launches per step "
            f"{ {k: v for k, v in want.items() if v} }, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if steps > 1:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{name}: loss did not fall: {losses}")
            if not any((p.detach() != before[n]).any()
                       for n, p in model.named_parameters()):
                raise AssertionError(f"{name}: parameters did not change")
        if state.step != steps:
            raise AssertionError(f"{name}: step count {state.step}")
        iters, windows = (1, 3) if name == "vim_tiny" else (3, 3)
        ms = cuda_ms(lambda: train_step(state, batch_), iters, windows)
        step_ms[(name, bool(fields))] = ms
        log(f"[time] {name} {fields} {img}px B={batch} bf16 train step: "
            f"{ms:.3f} ms, {batch / ms * 1e3:.2f} img/s ({card})")
        del model, state, tx, train_step, before, batch_
        torch.cuda.empty_cache()
    fused, rematted = (step_ms[("fastvim_base", r)] for r in (False, True))
    log(f"[time] fastvim_base {img}px B=2 bf16 train step: fused adjoint "
        f"(K5, K6) {fused:.3f} ms, {2 / fused * 1e3:.2f} img/s; remat "
        f"backward {rematted:.3f} ms, {2 / rematted * 1e3:.2f} img/s "
        f"({card})")
    return total, base_step


def run_config_path(dev, card):
    """Phase 6: the four configurations of FastVim-T at 2048 px, batch 2,
    bf16, full depth and width, built by ``create_model``; FastVim-S and
    FastVim-B in the recompute form; one train step of
    ``fused_kernels="always"``; the lanes scan at Vim-T's length. Returns
    the launch counts of the forwards, the step and the scan, and those of
    FastVim-B's recompute forward."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.ops.scan import selective_scan
    from fastvim_tpu_torch.train import (
        TrainState,
        constant,
        make_optimizer,
        make_supervised_train_step,
    )
    from fastvim_tpu_torch.utils.profiling import captured_forward

    batch, img = 2, 2048
    none = dict.fromkeys(kernels.launch_counts(), 0)
    total = dict(none)

    def counted(fn, expected, what):
        """Run fn with the counts at 0; check and add what it launched."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        if seen != {**none, **expected}:
            raise AssertionError(f"{what}: launches "
                                 f"{ {k: v for k, v in seen.items() if v} }, "
                                 f"expected {expected}")
        for k, v in seen.items():
            total[k] += v
        return out

    def replays(what, models, iters=10):
        """Each model's forward as a CUDA-graph replay, in turns: the
        device's time, without the host's launches."""
        graphs = {k: captured_forward(m, x) for k, m in models.items()}
        for k, replay in [*graphs.items(), *reversed(graphs.items())]:
            ms = cuda_ms(replay, iters, windows=3)
            log(f"[time] {what} {k} forward, CUDA-graph replay: {ms:.3f} ms, "
                f"{batch / ms * 1e3:.2f} img/s ({card})")
        graphs.clear()
        torch.cuda.empty_cache()

    build = lambda **kw: create_model(
        "fastvim_tiny", img_size=img, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), **kw)
    x = torch.randn(batch, img, img, 3, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(2))
    with torch.inference_mode():
        default = build()
        want = default(x).float()
        scale = want.abs().max().item()
        d_ms = cuda_ms(lambda: default(x), 5, windows=5)
        log(f"[time] fastvim_tiny default {img}px B={batch} bf16 forward: "
            f"{d_ms:.3f} ms, {batch / d_ms * 1e3:.2f} img/s ({card})")
        for name, (kw, expected) in CONFIGS.items():
            model = build(**kw)
            logits = counted(lambda: model(x), expected, name).float()
            if (logits.shape != (batch, 1000)
                    or not torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                                     "not finite or of the wrong shape")
            off = (logits - want).abs().max().item()
            log(f"[config] {name} {img}px B={batch} bf16: logits finite, "
                f"{off:.3e} from the default configuration's (largest logit "
                f"{scale:.3e}), launches {expected}")
            if off > BF16_TOL * scale:
                raise AssertionError(f"{name}: logits {off:.3e} from the "
                                     f"default's, over {BF16_TOL} of {scale}")
            ms = cuda_ms(lambda: model(x), 5, windows=5)
            log(f"[time] fastvim_tiny {name} {img}px B={batch} bf16 forward: "
                f"{ms:.3f} ms, {batch / ms * 1e3:.2f} img/s; default "
                f"{batch / d_ms * 1e3:.2f} img/s ({card})")
            if name in ("layer_fused=recompute", "fused_kernels=always",
                        "fused_merge"):
                replays(f"fastvim_tiny {img}px B={batch} bf16",
                        {"default": default, name: model})
            del model
        del default

        # FastVim-S in the recompute form (the widths K7's narrow form
        # walks twice) and FastVim-B (its wide form), full depth, against
        # their defaults; FastVim-B's launches are the kernels line's
        kw, expected = CONFIGS["layer_fused=recompute"]
        for name in ("fastvim_small", "fastvim_base"):
            build_w = lambda **kw: create_model(
                name, img_size=img, dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0), **kw)
            default = build_w()
            want = default(x).float()
            scale = want.abs().max().item()
            model = build_w(**kw)
            before = dict(total)
            logits = counted(lambda: model(x), expected,
                             f"{name} layer_fused=recompute").float()
            if name == "fastvim_base":
                base_rc = {k: total[k] - before[k] for k in total}
            off = (logits - want).abs().max().item()
            log(f"[config] {name} layer_fused=recompute {img}px B={batch} "
                f"bf16: {off:.3e} from the default configuration's (largest "
                f"logit {scale:.3e}), launches {expected}")
            if (logits.shape != (batch, 1000)
                    or not torch.isfinite(logits).all()
                    or off > BF16_TOL * scale):
                raise AssertionError(f"{name} layer_fused=recompute: logits "
                                     f"{off:.3e} from the default's, over "
                                     f"{BF16_TOL} of {scale}, or not finite")
            if name == "fastvim_base":
                for what, m in (("default", default),
                                ("layer_fused=recompute", model),
                                ("layer_fused=recompute", model),
                                ("default", default)):
                    ms = cuda_ms(lambda: m(x), 3, windows=2)
                    log(f"[time] {name} {what} {img}px B={batch} bf16 "
                        f"forward: {ms:.3f} ms, {batch / ms * 1e3:.2f} img/s "
                        f"({card})")
            replays(f"{name} {img}px B={batch} bf16",
                    {"default": default, "layer_fused=recompute": model},
                    iters=3 if name == "fastvim_base" else 10)
            del default, model
            torch.cuda.empty_cache()

    # one train step through K8 and K9 (their backward is autograd through
    # the plain versions; the scans' is K2)
    kw, fwd = CONFIGS["fused_kernels=always"]
    model = build(drop_path_rate=0.0, **kw)
    state = TrainState.create(model, make_optimizer(constant(1e-4),
                                                    weight_decay=0.05,
                                                    params=model))
    train_step = make_supervised_train_step(model, 1000, label_smoothing=0.1,
                                            ema_decay=None)
    gen = torch.Generator(device=dev).manual_seed(5)
    batch_ = {"image": x, "label": torch.randint(1000, (batch,), device=dev,
                                                 generator=gen)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = counted(lambda: train_step(state, batch_),
                         {**fwd, "selective_scan_bwd": 48},
                         "fused_kernels=always train step")
    loss = metrics["train_loss"].item()
    log(f"[train] fastvim_tiny fused_kernels=always {img}px B={batch} bf16: "
        f"loss {loss:.5f}, grad_norm {metrics['grad_norm'].item():.4f}, "
        f"first step {(time.perf_counter() - t0) * 1e3:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    if not math.isfinite(loss):
        raise AssertionError(f"fused_kernels=always: non-finite loss {loss}")
    del model, state, train_step
    torch.cuda.empty_cache()

    # lanes through the op's entry point, at Vim-T's scan shape
    g = torch.Generator(device=dev).manual_seed(6)
    Ls, d, n = 16384, 384, 16
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()
    u, delta, B, C = rnd(batch, Ls, d), rnd(batch, Ls, d) * 0.5, \
        rnd(batch, Ls, n), rnd(batch, Ls, n)
    A = -torch.exp(torch.rand(d, n, generator=g, device=dev) * 2 - 1)
    with torch.inference_mode():
        scan = lambda variant: selective_scan(u, delta, A, B, C,
                                              delta_softplus=True,
                                              variant=variant)
        y = counted(lambda: scan("lanes"), {"selective_scan_fwd_lanes": 1},
                    "lanes scan")
        compare(f"selective_scan variant=lanes vs sublane L={Ls} bf16", y,
                scan("sublane"), BF16_TOL)
        l_ms, k_ms = cuda_ms(lambda: scan("lanes"), 10), \
            cuda_ms(lambda: scan("sublane"), 10)
        log(f"[time] selective_scan bf16 B={batch} L={Ls} d={d}: lanes "
            f"{l_ms:.4f} ms, K1 {k_ms:.4f} ms ({card})")
    return total, base_rc


def device_idle_share(prof, span: str = "train_epoch"):
    """(idle share, busy ms, wall ms) of the card over the first host span
    named ``span`` of a torch.profiler run: the share of the span's wall
    time in which no kernel, copy or memset ran (their intervals' union),
    or None for the share when the profiler saw no device event. Read
    from the run's raw events (``trace_events``)."""
    from torch.autograd import DeviceType

    events = trace_events(prof)
    t0, t1 = min((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == span and e.device_type() == DeviceType.CPU)
    ivs = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() == DeviceType.CUDA
                 and not e.is_user_annotation()
                 and t0 <= e.start_ns() < t1)
    busy, end = 0, t0
    for a, b in ivs:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    wall = t1 - t0
    return (1.0 - busy / wall if ivs else None), busy / 1e6, wall / 1e6


def trace_events(prof):
    """A finished torch.profiler run's raw events, as the profiler keeps
    them: ``prof.events()`` would first build the tree of every host op,
    tens of seconds for a CLI's epoch."""
    return prof.profiler.kineto_results.events()


@contextlib.contextmanager
def native_path(on: bool):
    """With ``on`` False, the port's native libraries reported absent
    in-process (``native.available`` patched to answer False): every
    loader takes its Python path, as on a machine without them."""
    from fastvim_tpu_torch import native

    real = native.available
    if not on:
        native.available = lambda library="augment": False
    try:
        yield
    finally:
        native.available = real


def top_kernels(prof, n: int = 8) -> dict:
    """The device ms of a torch.profiler run's ``n`` costliest kernel
    groups (``utils/profiling.group_rows``: the port's kernels by id, the
    rest by name), from its raw events (``trace_events``)."""
    from torch.autograd import DeviceType

    from fastvim_tpu_torch.utils.profiling import group_rows

    by_name = {}
    for e in trace_events(prof):
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = [(k, ms, count) for k, (ms, count) in by_name.items() if ms > 0]
    return {k[:60]: (round(ms, 2), count) for k, (ms, count) in
            list(group_rows(rows).items())[:n]}


def run_cli_path(dev, card):
    """Phase 7: the port's CLIs on the card, in-process, at FastVimT.yaml
    (fastvim_tiny, 224 px, 1000 classes, batch 128, fp32, mixup/cutmix,
    drop path 0.05, EMA) on 512 synthetic images, 4 steps an epoch: one
    epoch, then ``--resume`` to two; checks the log, the step count, the
    launches and the checkpoint round trip through test_classification.
    Returns the launch counts of all three runs."""
    import csv
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch.cli import test_classification, train_classification
    from fastvim_tpu_torch.ops import kernels

    batch, samples = 128, 512
    steps, val_batches = samples // batch, samples // batch
    fwd = {"selective_scan_fwd": 48, "pass_a_fwd": 24, "pass_b_fwd": 24}
    bwd = {"selective_scan_bwd": 48, "pass_b_bwd": 24, "pass_a_bwd": 24}
    none = dict.fromkeys(kernels.launch_counts(), 0)
    # an epoch: its train steps, then each val batch through the raw and
    # the EMA weights; the backward kernels launch in the steps only
    per_epoch = {**none, **{k: v * (steps + 2 * val_batches)
                            for k, v in fwd.items()},
                 **{k: v * steps for k, v in bwd.items()}}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    with tempfile.TemporaryDirectory() as out:
        common = ["--config_name", "FastVimT", "--model_save_dir", out,
                  "--synthetic_samples", str(samples), "--device", str(dev)]
        kernels.reset_launch_counts()
        state = train_classification.main(common + ["--epochs", "1"])
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        if seen != per_epoch:
            raise AssertionError(f"CLI epoch 1: launches {seen}, expected "
                                 f"{per_epoch} ({steps} steps of 24 K3, 24 "
                                 "K4, 48 K1, 24 K5, 24 K6, 48 K2; "
                                 f"{2 * val_batches} eval forwards)")
        total = {k: total[k] + v for k, v in seen.items()}
        del state
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = train_classification.main(
                common + ["--epochs", "2", "--resume"])
            torch.cuda.synchronize()
        seen = kernels.launch_counts()
        if seen != per_epoch:
            raise AssertionError(f"CLI epoch 2 (resumed): launches {seen}, "
                                 f"expected {per_epoch}")
        total = {k: total[k] + v for k, v in seen.items()}
        if state.step != 2 * steps:
            raise AssertionError(f"CLI: step {state.step}, not {2 * steps}")
        idle, busy_ms, wall_ms = device_idle_share(prof)
        log(f"[cli] device ms by kernel over the resumed run (4 steps, 8 "
            f"eval forwards): {top_kernels(prof)}")
        del state, prof
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != [0, 1]:
            raise AssertionError(f"log.csv epochs "
                                 f"{[r['epoch'] for r in rows]}, not [0, 1]")
        cols = ("train_loss", "grad_norm", "val_loss", "val_acc",
                "val_loss_ema", "val_acc_ema")
        for r in rows:
            if not all(math.isfinite(float(r[c])) for c in cols):
                raise AssertionError(f"log.csv row not finite: {r}")
        if not any(f.startswith("events.out.tfevents")
                   for f in os.listdir(os.path.join(out, "tb"))):
            raise AssertionError("no TensorBoard event file under tb/")
        log(f"[cli] log.csv: {[{c: r[c] for c in ('epoch', *cols)} for r in rows]}")
        kernels.reset_launch_counts()
        result = test_classification.main(
            common[:2] + ["--checkpoint",
                          os.path.join(out, "ckpt", f"step_{2 * steps}"),
                          "--ema"] + common[4:])
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        want = {**none, **{k: v * val_batches for k, v in fwd.items()}}
        if seen != want:
            raise AssertionError(f"test_classification: launches {seen}, "
                                 f"expected {want}")
        total = {k: total[k] + v for k, v in seen.items()}
        ema = float(rows[-1]["val_loss_ema"])
        if not abs(result["test_loss"] - ema) <= 1e-5 * abs(ema):
            raise AssertionError(f"test_classification --ema: test_loss "
                                 f"{result['test_loss']} against the last "
                                 f"val_loss_ema {ema}")
        log(f"[cli] test_classification --ema on step_{2 * steps}: "
            f"{result}, val_loss_ema {ema}")
    # the host loader alone, as the CLI builds it: the rate the CLI's
    # epochs could reach if the card took no time
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.data import create_imagenet_loader

    cfg = load_config("FastVimT", "classification")
    loader = create_imagenet_loader(
        None, "train", batch, cfg["img_size"], training=True,
        num_workers=cfg["num_workers"], seed=cfg["seed"],
        synthetic_samples=samples)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    loader_img_s = n / (time.perf_counter() - t0)
    sps = [float(r["steps_per_sec"]) for r in rows]
    share = "not measured (no device event)" if idle is None else \
        f"{idle:.4f}"
    log(f"[time] CLI train_classification FastVimT.yaml B={batch} fp32 224px:"
        f" epoch 1 {sps[0] * batch:.2f} img/s ({1e3 / sps[0]:.1f} ms a "
        f"step), epoch 2 (resumed, under the profiler) {sps[1] * batch:.2f} "
        f"img/s ({1e3 / sps[1]:.1f} ms a step); device idle share over "
        f"epoch 2's training {share} (busy {busy_ms:.1f} of {wall_ms:.1f} "
        f"ms); the host loader alone (RandAugment, {cfg['num_workers']} "
        f"threads) {loader_img_s:.2f} img/s ({card})")
    return total


def run_serving_path(dev, card):
    """Phase 7, serving FastVim-B: ``test_classification --config_name
    FastVimB`` (``fastvim_base`` at full width and depth, 224 px, batch
    128, fp32), in-process, on a checkpoint saved here from the CLI's own
    seeded ``create_classifier``, over 256 synthetic val images: each
    batch 24 K3 + 24 K4 + 48 K1 (every layer fused), and its test_loss
    within 1e-4 relative of the same checkpoint evaluated with
    ``layer_fused=off`` (48 K1 a batch). Prints the CLI's img/s (its whole
    call: the model built, the checkpoint restored, the loader) and the
    forward's alone on a resident batch. Returns the launch counts."""
    import os
    import tempfile
    import types

    import torch

    from fastvim_tpu_torch.cli import test_classification
    from fastvim_tpu_torch.cli.train_classification import create_classifier
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train.checkpoint import save_checkpoint

    batch, samples = 128, 256
    cfg = load_config("FastVimB", "classification")
    model = create_classifier(cfg, dev, drop_path_rate=0.0)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    results = {}
    with tempfile.TemporaryDirectory() as out:
        ckpt = save_checkpoint(os.path.join(out, "ckpt"), types.SimpleNamespace(
            state_dict=lambda: {"params": model.state_dict()}), step=0)
        for fused, extra, want in (
                ("fused", [], FUSED_FWD),
                ("layer_fused=off", ["layer_fused=off"],
                 {"selective_scan_fwd": 48})):
            argv = ["--config_name", "FastVimB", "--checkpoint", ckpt,
                    "--synthetic_samples", str(samples), "--device",
                    str(dev), *extra]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results[fused] = test_classification.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seen = kernels.launch_counts()
            expect_launches(f"test_classification FastVimB {fused}", seen,
                            scaled(want, samples // batch))
            for k, v in seen.items():
                total[k] += v
            log(f"[cli] test_classification --config_name FastVimB "
                f"({fused}) on a seeded checkpoint, {samples} images: "
                f"{results[fused]}; {samples / wall:.2f} img/s over the "
                f"whole call ({wall:.2f} s) ({card})")
    got, want = (results[k]["test_loss"] for k in ("fused", "layer_fused=off"))
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError(f"test_classification FastVimB: fused test_loss "
                             f"{got} against {want} unfused")
    log(f"[check] test_classification FastVimB: test_loss fused {got} vs "
        f"unfused {want}, relative {abs(got - want) / abs(want):.3e} "
        f"(tol 1e-4) ok")
    # the forward alone on a resident batch, fused (the serving path's)
    # and unfused, in turns, then the fused one's device time by kernel
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(batch, 224, 224, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    unfused = copy.deepcopy(model)
    for m in unfused.modules():
        if hasattr(m, "layer_fused"):
            m.layer_fused = "off"
    model.eval()
    unfused.eval()
    with torch.inference_mode():
        for name, m in (("fused", model), ("unfused", unfused),
                        ("unfused", unfused), ("fused", model)):
            ms = cuda_ms(lambda: m(x), 2, windows=2)
            log(f"[time] fastvim_base 224px B={batch} fp32 forward ({name}): "
                f"{ms:.3f} ms, {batch / ms * 1e3:.2f} img/s ({card})")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    log(f"[time] fastvim_base 224px B={batch} fp32 fused forward, device ms "
        f"by kernel: {top_kernels(prof)} ({card})")
    del model, unfused, prof
    torch.cuda.empty_cache()
    return total


# the MAE slice's scan shapes, fp32 (batch, L, d_inner): the masked
# encoder's 14 row bins at MAE-B, the plain-Vim decoder's 196 tokens, the
# Vim-MAE-B encoder's 49 visible tokens and its cls token
MAE_SCANS = (("MAE-B encoder", 128, 14, 1536),
             ("MAE decoder", 128, 196, 1024),
             ("Vim-MAE-B encoder", 128, 50, 1536))


# ChannelVim's scan shapes, fp32 (batch, L, d_inner), FastChannelVim-S
# (d_inner 768) at batch 32: a 2dcompress channel scan of one channel
# (HCS) and of all 8, a rows scan (2dcompress, or ps16 with one channel),
# ps16's rows·C with 8 channels, ps8's; and the unpooled baseline's
# full-length scan at batch 8, in the chunked forms
CHANNEL_SCANS = (("ChannelVim C scan, 1 channel", 32, 1, 768),
                 ("ChannelVim C scan, 8 channels", 32, 8, 768),
                 ("ChannelVim rows scan", 32, 14, 768),
                 ("FastChannelVim-S ps16, 8 channels", 32, 112, 768),
                 ("FastChannelVim-S ps8, 8 channels", 32, 224, 768),
                 ("ChannelVim-S baseline, unpooled", 8, 1568, 768))


def check_mae_scans(dev, card, shapes=MAE_SCANS, seed=20):
    """Phase 2, the MAE shapes (phase 9: ChannelVim's, ``CHANNEL_SCANS``):
    K1 and K2 against their plain versions in fp32 at ``shapes``, both
    directions, with D = None as the mixers call them; each timed by CUDA
    events beside its other form, its plain version and its bound
    (reverse direction). Returns the largest errors."""
    import torch

    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    errs = {"selective_scan_fwd": 0.0, "selective_scan_bwd": 0.0}
    n = 16
    order = (0, 1, 3, 4, 2, 5, 6)  # du, ddelta, dB, dC per step; then sums
    pick = lambda grads: [grads[i] for i in order]
    for what, batch, L, d in shapes:
        A = -torch.exp(uni(d, n, bound=1.0))
        bias = uni(d, bound=0.5)
        ins = (rnd(batch, L, d), rnd(batch, L, d, scale=0.5), A,
               rnd(batch, L, n), rnd(batch, L, n))
        gy = rnd(batch, L, d)
        kw = dict(delta_bias=bias, delta_softplus=True)
        for reverse in (False, True):
            tag = f"{what} B={batch} L={L} d={d} fp32 reverse={reverse}"
            y, states = ss.selective_scan_fwd(*ins, reverse=reverse,
                                              save_states=True, **kw)
            errs["selective_scan_fwd"] = max(
                errs["selective_scan_fwd"],
                compare(f"selective_scan_fwd {tag}", y,
                        ss.selective_scan_plain(*ins, reverse=reverse, **kw),
                        FP32_TOL))
            got = ss.selective_scan_bwd(*ins, None, bias, gy, states, True,
                                        reverse)
            want = ss.selective_scan_bwd_plain(*ins, None, bias, gy, True,
                                               reverse)
            errs["selective_scan_bwd"] = max(
                errs["selective_scan_bwd"],
                compare_all(f"selective_scan_bwd {tag}", pick(got),
                            pick(want), FP32_TOL, 4))
            del want
        k1 = lambda: ss.selective_scan_fwd(*ins, reverse=True,
                                           save_states=True, **kw)
        k1_plain = lambda: ss.selective_scan_plain(*ins, reverse=True, **kw)
        k2 = lambda: ss.selective_scan_bwd(*ins, None, bias, gy, states, True,
                                           True)
        k2_plain = lambda: ss.selective_scan_bwd_plain(*ins, None, bias, gy,
                                                       True, True)
        other = {"sequential": "chunked", "chunked": "sequential"}
        k1_alt = lambda: ss._launch_fwd(other[ss.fwd_route(L)], *ins,
                                        reverse=True, save_states=True, **kw)
        k2_alt = lambda: ss._launch_bwd(other[ss.bwd_route(L)], *ins, None,
                                        bias, gy, states, True, True)
        for name, kern, alt, plain, n_bytes, flops, route in (
                ("selective_scan_fwd", k1, k1_alt, k1_plain,
                 nbytes(*ins, bias, y, states), 9.0, ss.fwd_route(L)),
                ("selective_scan_bwd", k2, k2_alt, k2_plain,
                 nbytes(*ins, bias, gy, states, *got), 20.0,
                 ss.bwd_route(L))):
            k_ms = cuda_ms(kern, 50)
            o_ms = cuda_ms(alt, 50)
            p_ms = cuda_ms(plain, 3)
            b_ms, by = bound(n_bytes, flops * batch * L * d * n, "fp32")
            log(f"[time] {name} {tag}: kernel ({route}) {k_ms:.4f} ms, "
                f"{other[route]} {o_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}) ({card})")
        del ins, gy, y, states, got
        torch.cuda.empty_cache()
    return errs


def compare_grads(name, got, want, tol=GRAD_TOL):
    """Each tensor of ``got`` (name → tensor) within ``tol`` of the largest
    entry of its ``want``; raises otherwise, logs the worst."""
    import torch

    if set(got) != set(want):
        raise AssertionError(f"{name}: tensors {sorted(set(got) ^ set(want))}"
                             " on one side only")
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        e = (got[k].float() - w.float()).abs().max().item() / (
            w.abs().max().item() + 1e-12)
        if not torch.isfinite(got[k]).all() or e > tol:
            raise AssertionError(f"{name}: {k} off by {e:.3e} of its largest "
                                 f"entry (> {tol})")
        if e > worst:
            worst, worst_name = e, k
    log(f"[check] {name}: {len(want)} tensors, worst {worst:.3e} of the "
        f"largest entry ({worst_name}) tol={tol:g} ok")


def check_mae_224(dev):
    """Phase 8, card against CPU: ``mae_FastVim_base_dec512d2b`` at full
    width, encoder depth 4, and ``mae_vim_base_dec512d2b`` (cls token) at
    depth 2, fp32, B = 8, 224 px, one generator's weights, the same mask
    noise: the loss, the prediction and every parameter's gradient within
    1e-4 of each tensor's largest entry (phase 3's tolerance). Returns the
    card's launches."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(6)
    x = torch.randn(8, 224, 224, 3, generator=gen)
    noise = torch.rand(8, 196, generator=gen)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    for name, depth, scans in (("mae_FastVim_base_dec512d2b", 4, 2 * 4 + 4),
                               ("mae_vim_base_dec512d2b", 2, 2 * 2 + 4)):
        cpu_model = create_model(name, device="cpu", depth=depth,
                                 generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        results = []
        for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
            kernels.reset_launch_counts()
            loss, pred, mask = model(x.to(d), noise=noise.to(d))
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
            seen = kernels.launch_counts()
            results.append(({"loss": loss.detach().cpu(),
                             "pred": pred.detach().cpu(),
                             "mask": mask.cpu()},
                            {n: gr.cpu() for n, gr in zip(params, grads)}))
        want_launch = (scans, scans)
        got_launch = (seen["selective_scan_fwd"], seen["selective_scan_bwd"])
        if got_launch != want_launch:
            raise AssertionError(f"{name} depth {depth}: K1, K2 launches "
                                 f"{got_launch}, expected {want_launch}")
        total = {k: total[k] + v for k, v in seen.items()}
        (want_out, want), (got_out, got) = results
        if not torch.equal(got_out.pop("mask"), want_out.pop("mask")):
            raise AssertionError(f"{name}: the masks differ")
        compare_grads(f"{name} depth {depth} 224px B=8 fp32 loss and pred, "
                      "card vs CPU", got_out, want_out)
        compare_grads(f"{name} depth {depth} 224px B=8 fp32 gradients, card "
                      "vs CPU", got, want)
        del cpu_model, gpu_model, results
    return total


# a forward of a 24-layer fused FastVim, and a train step of FastVim-B in
# fp32 at 224 px: the fused forward and the fused adjoint ("auto" there)
FUSED_FWD = {"pass_a_fwd": 24, "pass_b_fwd": 24, "selective_scan_fwd": 48}
FUSED_ADJOINT_STEP = {**FUSED_FWD, "selective_scan_bwd": 48,
                      "pass_b_bwd": 24, "pass_a_bwd": 24}


def run_mae_cli_path(dev, card):
    """Phase 8, the MAE CLIs on the card, in-process, at full width and
    depth, on 512 synthetic images (4 steps of 128 an epoch):
    ``pretrain_mae --config_name pretrain_FastVimB`` for one epoch (the
    loader's MAE augment in the native library, the default) and, from
    its checkpoint, ``--resume`` to two with the native path off (PIL)
    and on (52 K1 and 52 K2 a step; the native calls; the device's idle
    share and the peak memory over each resumed epoch); ``finetune_mae
    --config_name
    finetune_FastVimB`` from its newest checkpoint for one epoch (the
    sin-cos ``pos_embed`` and the kept-init head in the printed counts;
    every layer fused forward and, fp32's default on its 14-token lines,
    the fused adjoint: a step 24 K3 + 24 K4 + 48 K1 + 24 K5 + 24 K6 + 48
    K2, an eval batch 24 K3 + 24 K4 + 48 K1; its img/s and peak memory
    beside the unfused run's); ``linear_probe
    --config_name linear_FastVimL model=fastvim_base batch_size=128`` from
    the same checkpoint (24 K3 + 24 K4 + 48 K1 a step and an eval batch;
    the backbone bitwise as loaded, the BatchNorm statistics moved).
    Returns the launch counts of all runs."""
    import contextlib
    import csv
    import io
    import os
    import re
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch import native
    from fastvim_tpu_torch.cli import finetune_mae, linear_probe, pretrain_mae
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train.checkpoint import restore_checkpoint

    batch, samples = 128, 512
    steps = samples // batch
    none = dict.fromkeys(kernels.launch_counts(), 0)
    total = dict(none)

    def run(what, cli, argv, want):
        """cli.main(argv) with its launches held to ``want`` and its
        standard output returned beside its state."""
        kernels.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = cli.main(argv)
        torch.cuda.synchronize()
        print(out.getvalue(), end="", flush=True)
        seen = kernels.launch_counts()
        want = {**none, **want}
        if seen != want:
            raise AssertionError(f"{what}: launches {seen}, expected {want}")
        for k, v in seen.items():
            total[k] += v
        return state, out.getvalue()

    def rates(path, what, extra=""):
        with open(path) as f:
            rows = list(csv.DictReader(f))
        for r in rows:
            if not math.isfinite(float(r["train_loss"])):
                raise AssertionError(f"{what}: log row not finite: {r}")
        sps = [float(r["steps_per_sec"]) for r in rows]
        log(f"[time] CLI {what} B={batch} fp32 224px: " + ", ".join(
            f"epoch {r['epoch']} {s * batch:.2f} img/s ({1e3 / s:.1f} ms a "
            f"step)" for r, s in zip(rows, sps)) + f"{extra} ({card})")
        return rows

    def counts(text):
        m = re.search(r"loaded (\d+), kept-init (\d+), sincos-filled (\d+)",
                      text)
        return tuple(map(int, m.groups()))

    with tempfile.TemporaryDirectory() as tmp:
        # 1. pretrain: 24 masked layers and 2 decoder layers, two scans
        # each; the loader's MAE augment in the native library (the
        # default: one augment_batch call an image). Epoch 1 once, then
        # epoch 2 resumed from its checkpoint with the native path off
        # (PIL) and on, each under the profiler
        per_epoch = {"selective_scan_fwd": 52 * steps,
                     "selective_scan_bwd": 52 * steps}
        dirs = {m: os.path.join(tmp, m.replace(" ", "_"))
                for m in ("native", "native off")}
        common = lambda d: ["--config_name", "pretrain_FastVimB",
                            "--model_save_dir", d, "--synthetic_samples",
                            str(samples), "--device", str(dev)]
        native.reset_call_counts()
        state, _ = run("pretrain_mae (native) epoch 1", pretrain_mae,
                       common(dirs["native"]) + ["--epochs", "1"], per_epoch)
        del state
        if native.call_counts()["augment_batch"] != samples:
            raise AssertionError(f"pretrain_mae epoch 1: native calls "
                                 f"{native.call_counts()}, expected "
                                 f"{samples} augment_batch")
        shutil.copytree(dirs["native"], dirs["native off"])
        for mode in ("native off", "native"):
            with native_path(mode == "native"):
                native.reset_call_counts()
                torch.cuda.reset_peak_memory_stats()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, _ = run(f"pretrain_mae ({mode}) epoch 2 "
                                   "(resumed)", pretrain_mae,
                                   common(dirs[mode]) + ["--epochs", "2",
                                                         "--resume"],
                                   per_epoch)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                calls = native.call_counts()
            want_calls = samples if mode == "native" else 0
            if calls["augment_batch"] != want_calls or any(
                    v for k, v in calls.items() if k != "augment_batch"):
                raise AssertionError(f"pretrain_mae ({mode}): native calls "
                                     f"{calls}, expected {want_calls} "
                                     "augment_batch")
            if state.step != 2 * steps:
                raise AssertionError(f"pretrain_mae: step {state.step}, not "
                                     f"{2 * steps}")
            del state
            idle, busy_ms, wall_ms = device_idle_share(prof)
            log(f"[cli] pretrain_mae ({mode}) device ms by kernel over the "
                f"resumed epoch: {top_kernels(prof)}")
            del prof
            share = ("not measured (no device event)" if idle is None
                     else f"{idle:.4f}")
            rows = rates(os.path.join(dirs[mode], "log.csv"),
                         f"pretrain_mae pretrain_FastVimB.yaml (epoch 0 "
                         f"native, epoch 1 resumed {mode})",
                         f"; device idle share over epoch 1's training "
                         f"(resumed, under the profiler) {share} (busy "
                         f"{busy_ms:.1f} of {wall_ms:.1f} ms); peak memory "
                         f"of the resumed run {peak:.2f} GiB; native "
                         f"augment_batch calls {calls['augment_batch']}; 52 "
                         "K1 + 52 K2 a step")
            if [int(r["epoch"]) for r in rows] != [0, 1]:
                raise AssertionError(f"pretrain_mae log epochs "
                                     f"{[r['epoch'] for r in rows]}")
        ckpt = os.path.join(tmp, "native", "ckpt", f"step_{2 * steps}")

        # 2. finetune fastvim_base from it: 24 fused layers (K3, 2 K1, K4)
        # whose backward is fp32's default there, the adjoint (K5, 2 K2,
        # K6), and each eval batch the fused forward
        ft = os.path.join(tmp, "finetune")
        torch.cuda.reset_peak_memory_stats()
        state, text = run(
            "finetune_mae", finetune_mae,
            ["--config_name", "finetune_FastVimB", "--model_save_dir", ft,
             "--synthetic_samples", str(samples), "--device", str(dev),
             "training_epochs=1", f"pretrained_checkpoint_path={ckpt}"],
            scaled({k: v + FUSED_FWD.get(k, 0)
                    for k, v in FUSED_ADJOINT_STEP.items()}, steps))
        n = len(state.model.state_dict())
        if counts(text) != (n - 3, 2, 1):
            raise AssertionError(f"finetune_mae: counts {counts(text)}, "
                                 f"expected {(n - 3, 2, 1)}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[cli] finetune_mae: load_pretrained_backbone loaded, kept-init, "
            f"sincos-filled {counts(text)} (pos_embed the sin-cos table, the"
            f" head its init); peak memory {peak:.2f} GiB (PERF.md §2: the "
            f"remat backward 9.60 GiB, unfused 57.60 GiB)")
        del state
        rates(os.path.join(ft, "log.csv"), "finetune_mae finetune_FastVimB."
              "yaml (fastvim_base)", "; a step 24 K3 + 24 K4 + 48 K1 + 24 "
              "K5 + 24 K6 + 48 K2 (the fused forward, the fused adjoint), "
              "an eval batch 24 K3 + 24 K4 + 48 K1; peak "
              f"{peak:.2f} GiB (PERF.md §2: the remat backward 99.87-106.06 "
              "img/s, 9.60 GiB; unfused 114.51 img/s, 57.60 GiB)")

        # 3. the linear probe of the same checkpoint on fastvim_base: its
        # frozen backbone runs without gradients, fused, in steps and evals
        lp = os.path.join(tmp, "probe")
        state, text = run(
            "linear_probe", linear_probe,
            ["--config_name", "linear_FastVimL", "--model_save_dir", lp,
             "--synthetic_samples", str(samples), "--device", str(dev),
             "model=fastvim_base", "batch_size=128", "training_epochs=1",
             f"pretrained_checkpoint_path={ckpt}"],
            scaled(FUSED_FWD, steps + steps))
        n = len(state.backbone.state_dict())
        if counts(text) != (n - 1, 0, 1):
            raise AssertionError(f"linear_probe: counts {counts(text)}, "
                                 f"expected {(n - 1, 0, 1)}")
        pretrained = restore_checkpoint(ckpt, dev)["params"]
        for k, v in state.backbone.state_dict().items():
            if k != "pos_embed" and not torch.equal(v, pretrained[k]):
                raise AssertionError(f"linear_probe: backbone {k} changed")
        bn = state.model.bn
        if (torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
                or torch.equal(bn.running_var,
                               torch.ones_like(bn.running_var))):
            raise AssertionError("linear_probe: BatchNorm statistics did not "
                                 "move")
        log(f"[cli] linear_probe: counts {counts(text)}, backbone bitwise as "
            "loaded, BatchNorm statistics moved")
        del state, pretrained
        rates(os.path.join(lp, "log.csv"), "linear_probe linear_FastVimL."
              "yaml (fastvim_base, batch 128)", "; 24 K3 + 24 K4 + 48 K1 a "
              "step and an eval batch")
    torch.cuda.empty_cache()
    return total


class MaxPoolBranch:
    """Max pooling is not differentiable where two candidates tie, and
    the card's forward and the CPU's differ by ~1e-6: at a near-tie they
    can pick different maxima, and the gradient then flows to another
    token. While entered, this records the card's argmax of every max
    pool (the model pools as it always does) or, with ``replay``, makes
    the CPU's pools take the recorded argmax, so that both sides'
    gradients are those of one branch; it counts the pooled groups whose
    own argmax differs from the card's."""

    def __init__(self):
        self.recorded, self.replay, self.flips, self.groups = [], False, 0, 0

    def __enter__(self):
        from fastvim_tpu_torch.models import mixer

        self.original = mixer.pool_grid
        self.pos = 0
        mixer.pool_grid = self.pool
        return self

    def __exit__(self, *exc):
        from fastvim_tpu_torch.models import mixer

        mixer.pool_grid = self.original
        return False

    def pool(self, x, grid_shape, pool_axes, method="mean",
             scaling_factor=1.0):
        if method != "max":
            return self.original(x, grid_shape, pool_axes, method,
                                 scaling_factor)
        (axis,) = pool_axes
        xg = x.reshape(x.shape[0], *grid_shape, x.shape[-1])
        own = xg.detach().argmax(dim=axis + 1, keepdim=True)
        if not self.replay:
            self.recorded.append(own.cpu())
            return self.original(x, grid_shape, pool_axes, method,
                                 scaling_factor)
        card = self.recorded[self.pos].to(x.device)
        self.pos += 1
        self.flips += int((own != card).sum())
        self.groups += own.numel()
        out = xg.take_along_dim(card, dim=axis + 1).squeeze(axis + 1)
        return out.reshape(x.shape[0], -1, x.shape[-1])


class ReluBranch:
    """ReLU is not differentiable at 0, and the card's forward and the
    CPU's differ by ~1e-6: a pre-activation that near 0 can be kept on
    one side and dropped on the other, and one such element of a head's
    32 × 32 map moves its conv's weight gradient by about 1/1024 of its
    largest entry. While entered, this records the card's ReLU mask of
    every ``ConvModule`` (which computes as it always does) or, with
    ``replay``, makes the CPU's ConvModules keep the recorded elements,
    so that both sides' gradients are those of one branch; it counts the
    elements whose own mask differs from the card's."""

    def __init__(self):
        self.recorded, self.replay, self.flips, self.elements = [], False, 0, 0

    def __enter__(self):
        from fastvim_tpu_torch.models import upernet

        self.original = upernet.ConvModule.forward
        self.pos = 0
        branch = self

        def forward(module, x):
            return branch.relu(module.norm(upernet.conv_nhwc(module.conv,
                                                              x)))

        upernet.ConvModule.forward = forward
        return self

    def __exit__(self, *exc):
        from fastvim_tpu_torch.models import upernet

        upernet.ConvModule.forward = self.original
        return False

    def relu(self, y):
        import torch

        own = y.detach() > 0
        if not self.replay:
            self.recorded.append(own.cpu())
            return torch.relu(y)
        card = self.recorded[self.pos].to(y.device)
        self.pos += 1
        self.flips += int((own != card).sum())
        self.elements += own.numel()
        return torch.where(card, y, torch.zeros_like(y))


def check_channel_224(dev):
    """Phase 9, card against CPU: FastChannelVim-S at full width (384),
    depth 2, fp32, 224 px, B = 4, one generator's weights, in both scan
    orders, with max pooling, and in its 2dcompress form at depth 3 (its
    third layer scans the channels), each with all 8 channels and with
    the channel ids of 3 and of 1: the logits, the loss and every
    parameter's gradient within 1e-4 of each tensor's largest entry (the
    CPU's max pools on the card's branch, ``MaxPoolBranch``), and exactly
    2 K1 a layer in the forward and 2 K2 a layer in the backward (a 3-D
    grid never fuses). Returns the card's launches."""
    import torch
    import torch.nn.functional as F

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 224, 224, 8, generator=gen)
    labels = torch.randint(161, (4,), generator=gen)
    none = dict.fromkeys(kernels.launch_counts(), 0)
    total = dict(none)
    for name, kw in (("fastchannelvim_small_ps16", dict(depth=2)),
                     ("fastchannelvim_small_ps16",
                      dict(depth=2, scan_order="Spatial-First")),
                     ("fastchannelvim_small_ps16_maxpool", dict(depth=2)),
                     ("fastchannelvim_small_ps16_2dcompress", dict(depth=3))):
        cpu_model = create_model(name, device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        scans = 2 * kw["depth"]
        for chans in (list(range(8)), [1, 4, 6], [5]):
            results = []
            branch = MaxPoolBranch()
            for model, d in ((gpu_model, dev), (cpu_model, "cpu")):
                kernels.reset_launch_counts()
                branch.replay = d == "cpu"
                with branch:
                    logits = model(x[..., chans].to(d),
                                   torch.tensor(chans, device=d))
                loss = F.cross_entropy(logits, labels.to(d))
                params = dict(model.named_parameters())
                grads = torch.autograd.grad(loss, list(params.values()))
                results.append(({"logits": logits.detach().cpu(),
                                 "loss": loss.detach().cpu()},
                                {n: gr.cpu() for n, gr in zip(params, grads)}))
                if d != "cpu":
                    seen = kernels.launch_counts()
            if branch.groups:
                log(f"[check] {name} channels {chans}: the CPU's own max pool"
                    f" picks another token than the card's in {branch.flips}"
                    f" of {branch.groups} pooled groups")
            want = {**none, "selective_scan_fwd": scans,
                    "selective_scan_bwd": scans}
            if seen != want:
                raise AssertionError(f"{name} {kw} channels {chans}: launches"
                                     f" {seen}, expected {want}")
            total = {k: total[k] + v for k, v in seen.items()}
            (got_out, got_grads), (want_out, want_grads) = results
            tag = f"{name} {kw} channels {chans} 224px B=4 fp32"
            compare_grads(f"{tag} logits and loss, card vs CPU", got_out,
                          want_out)
            compare_grads(f"{tag} gradients, card vs CPU", got_grads,
                          want_grads)
        del cpu_model, gpu_model, results
    return total


def run_cells_cli_path(dev, card):
    """Phase 9, the cells CLI on the card, in-process, at
    FastChannelVimS.yaml (FastChannelVim-S at full width and depth,
    Channel-First, HCS, mean pooling, batch 32, fp32) on 128 synthetic
    images, 4 steps an epoch: one epoch with the loaders' augment in the
    native library (the default: one ``cell_augment_batch`` call a batch,
    train and eval), then, from its checkpoint, ``--resume`` to two with
    the native path off (the Python ``cell_augment``) and on; checks the
    log, the step count, 48 K1 + 48 K2 a step and 48 K1 an eval batch,
    and the native calls; prints img/s, step time, the device's idle
    share over each resumed epoch and its peak memory. Returns the launch
    counts."""
    import csv
    import os
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch import native
    from fastvim_tpu_torch.cli import train_cells
    from fastvim_tpu_torch.ops import kernels

    batch, samples = 32, 128
    steps, val_batches = samples // batch, samples // 4 // batch
    none = dict.fromkeys(kernels.launch_counts(), 0)
    per_epoch = {**none, "selective_scan_fwd": 48 * (steps + val_batches),
                 "selective_scan_bwd": 48 * steps}
    total = dict(none)

    def run(what, out, more, on):
        """train_cells into ``out`` with the native path ``on``: its
        state and the native calls, its launches held to an epoch's."""
        with native_path(on):
            native.reset_call_counts()
            kernels.reset_launch_counts()
            state = train_cells.main(
                ["--config_name", "FastChannelVimS", "--model_save_dir",
                 out, "--synthetic_samples", str(samples), "--device",
                 str(dev), *more])
            torch.cuda.synchronize()
            calls = native.call_counts()
        seen = kernels.launch_counts()
        if seen != per_epoch:
            raise AssertionError(
                f"train_cells {what}: launches {seen}, expected {per_epoch}"
                f" ({steps} steps of 48 K1 + 48 K2, {val_batches} eval "
                "batch of 48 K1)")
        for k, v in seen.items():
            total[k] += v
        want = steps + val_batches if on else 0
        if calls["cell_augment_batch"] != want or any(
                v for k, v in calls.items() if k != "cell_augment_batch"):
            raise AssertionError(f"train_cells {what}: native calls {calls},"
                                 f" expected {want} cell_augment_batch")
        return state, calls

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {m: os.path.join(tmp, m.replace(" ", "_"))
                for m in ("native", "native off")}
        state, _ = run("(native) epoch 1", dirs["native"], ["--epochs", "1"],
                       True)
        del state
        shutil.copytree(dirs["native"], dirs["native off"])
        for mode in ("native off", "native"):
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, calls = run(f"({mode}) epoch 2 (resumed)",
                                   dirs[mode], ["--epochs", "2", "--resume"],
                                   mode == "native")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if state.step != 2 * steps:
                raise AssertionError(f"train_cells: step {state.step}, not "
                                     f"{2 * steps}")
            del state
            idle, busy_ms, wall_ms = device_idle_share(prof)
            log(f"[cli] train_cells ({mode}) device ms by kernel over the "
                f"resumed epoch: {top_kernels(prof)}")
            del prof
            with open(os.path.join(dirs[mode], "log.csv")) as f:
                rows = list(csv.DictReader(f))
            if [int(r["epoch"]) for r in rows] != [0, 1]:
                raise AssertionError(f"train_cells log epochs "
                                     f"{[r['epoch'] for r in rows]}, not "
                                     "[0, 1]")
            cols = ("train_loss", "grad_norm", "val_loss", "val_acc")
            for r in rows:
                if not all(math.isfinite(float(r[c])) for c in cols):
                    raise AssertionError(f"train_cells log row not finite: "
                                         f"{r}")
            log(f"[cli] train_cells ({mode}) log.csv: "
                f"{[{c: r[c] for c in ('epoch', *cols)} for r in rows]}")
            sps = [float(r["steps_per_sec"]) for r in rows]
            share = ("not measured (no device event)" if idle is None
                     else f"{idle:.4f}")
            log(f"[time] CLI train_cells FastChannelVimS.yaml B={batch} fp32"
                f" 224px 8 channels, HCS: epoch 1 (native) "
                f"{sps[0] * batch:.2f} img/s ({1e3 / sps[0]:.1f} ms a step),"
                f" epoch 2 (resumed from it, {mode}, under the profiler) "
                f"{sps[1] * batch:.2f} img/s ({1e3 / sps[1]:.1f} ms a step);"
                f" device idle share over epoch 2's training {share} (busy "
                f"{busy_ms:.1f} of {wall_ms:.1f} ms); peak memory of the "
                f"resumed run {peak:.2f} GiB; native cell_augment_batch "
                f"calls {calls['cell_augment_batch']}; 48 K1 + 48 K2 a step "
                f"({card})")
    return total


def run_channel_steps(dev, card):
    """Phase 9, train steps through the model API (AdamW, all 8
    channels): ``channelvim_small_ps16_baseline`` (unpooled: its scans at
    L = 1568 take K1's and K2's chunked forms) at full depth, B = 8, and
    ``fastchannelvim_small_ps8`` (FastChannelVimS_ps8.yaml's model, L =
    224 scans over 6272 tokens) at B = 32 with ``remat=True``, its fit
    lever; a batch that does not fit is halved until one does, and the
    one that fits is printed. Two steps each, the second timed; 48 K1 +
    48 K2 a step (with remat 96 K1: the forward again in the backward).
    Returns the launch counts."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss
    from fastvim_tpu_torch.train import (
        TrainState,
        constant,
        make_optimizer,
        make_supervised_train_step,
    )

    none = dict.fromkeys(kernels.launch_counts(), 0)
    total = dict(none)

    def two_steps(name, batch, **kw):
        gen = torch.Generator(device=dev).manual_seed(9)
        model = create_model(name, device=dev, **kw)
        state = TrainState.create(model, make_optimizer(constant(1e-4),
                                                        params=model))
        step = make_supervised_train_step(
            model, 161, label_smoothing=0.0, ema_decay=None,
            generator=torch.Generator(device=dev).manual_seed(0),
            channel_model=True)
        data = {"image": torch.randn(batch, 224, 224, 8, generator=gen,
                                     device=dev),
                "label": torch.randint(161, (batch,), generator=gen,
                                       device=dev),
                "channel_ids": torch.arange(8, device=dev)}
        losses = [step(state, data)[1]["train_loss"].item()]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(step(state, data)[1]["train_loss"].item())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        seen = kernels.launch_counts()
        # remat runs each block's forward again in the backward
        want = {**none, "selective_scan_fwd": 96 if kw.get("remat") else 48,
                "selective_scan_bwd": 48}
        if seen != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name} B={batch} {kw}: launches {seen} "
                                 f"(expected {want}), losses {losses}")
        return ms, seen, losses

    ms, seen, losses = two_steps("channelvim_small_ps16_baseline", 8)
    total = {k: total[k] + v for k, v in seen.items()}
    log(f"[time] channelvim_small_ps16_baseline train step, B=8 fp32 224px "
        f"8 channels, L = 1568 scans (K1 {ss.fwd_route(1568)}, K2 "
        f"{ss.bwd_route(1568)}): {ms:.1f} ms ({8e3 / ms:.2f} img/s), losses "
        f"{losses} ({card})")
    batch = 32
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            ms, seen, losses = two_steps("fastchannelvim_small_ps8", batch,
                                         remat=True)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"[check] fastchannelvim_small_ps8 remat=True B={batch}: out "
                "of memory")
            if batch == 1:
                raise
            batch //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = {k: total[k] + v for k, v in seen.items()}
    log(f"[time] fastchannelvim_small_ps8 (FastChannelVimS_ps8.yaml) "
        f"remat=True train step, B={batch} fp32 224px 8 channels, 6272 "
        f"tokens, L = 224 scans: {ms:.1f} ms ({batch * 1e3 / ms:.2f} img/s), "
        f"peak memory {peak:.2f} GiB, losses {losses} ({card})")
    torch.cuda.empty_cache()
    return total


SEG_CONFIG = "upernet_FastVimT_ade20k"
SEG_B_CONFIG = "upernet_FastVimB_ade20k"
SEG_FWD = {"pass_a_fwd": 24, "pass_b_fwd": 24, "selective_scan_fwd": 48}
SEG_BWD = {"pass_b_bwd": 24, "pass_a_bwd": 24, "selective_scan_bwd": 48}
# FastVim-B's step through the remat backward: the fused forward, each
# layer's two scans again and their backward on K2
SEG_B_REMAT = {**SEG_FWD, "selective_scan_fwd": 96, "selective_scan_bwd": 48}
# the share of the heads' ReLU elements whose mask may differ between the
# card and the CPU (3 of 4,482,048 on an H100): past it the forwards
# disagree by more than rounding, which the shared masks would hide
RELU_FLIPS = 1e-5


def seg_pair(dev, depth: int, out_indices):
    """``UperNetSegmentor`` over ``fastvim_tiny`` at 512 px, fp32, 150
    classes, weights from seed 0, on the CPU and a copy on the card."""
    import torch

    from fastvim_tpu_torch.models import UperNetSegmentor, create_model

    gen = torch.Generator().manual_seed(0)
    backbone = create_model("fastvim_tiny", device="cpu", generator=gen,
                            img_size=512, num_classes=0, drop_path_rate=0.0,
                            depth=depth, out_indices=out_indices)
    cpu_seg = UperNetSegmentor(backbone, 150)
    cpu_seg.decode_head.reset_parameters(gen)
    cpu_seg.aux_head.reset_parameters(gen)
    return cpu_seg.eval(), copy.deepcopy(cpu_seg).to(dev)


def expect_launches(name, seen, want):
    """Raise unless the kernels' launch counts are ``want`` (others 0)."""
    want = {**dict.fromkeys(seen, 0), **want}
    if seen != want:
        raise AssertionError(f"{name}: launches {seen}, expected {want}")


def scaled(counts, n):
    return {k: v * n for k, v in counts.items()}


def check_seg_512(dev):
    """Phase 10, card against CPU: the segmentor's eval-mode logits at
    512 px (full depth, B = 1) and slide inference on a 512 × 683 image
    within 1e-3 (phase 3's tolerance); at depth 4 in training mode the
    loss and gradients within 1e-4 of each tensor's largest entry (the
    CPU's ReLUs on the card's branch, ``ReluBranch``, which may differ
    from the CPU's own in at most ``RELU_FLIPS`` of the elements). Returns
    the card's launches."""
    import torch

    from fastvim_tpu_torch.models.upernet import (
        segmentation_loss,
        slide_inference,
    )
    from fastvim_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(10)
    x = torch.randn(1, 512, 512, 3, generator=gen)
    wide = torch.randn(1, 512, 683, 3, generator=gen)
    slide = dict(crop=512, stride=341, num_classes=150)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    cpu_seg, gpu_seg = seg_pair(dev, 24, (5, 11, 17, 23))
    with torch.no_grad():
        want = cpu_seg(x)
        kernels.reset_launch_counts()
        got = gpu_seg(x.to(dev)).cpu()
        seen = kernels.launch_counts()
        expect_launches("segmentor 512px forward", seen, SEG_FWD)
        total = {k: total[k] + v for k, v in seen.items()}
        compare("UperNet fastvim_tiny 512px B=1 fp32 logits (1, 512, 512, "
                "150), card vs CPU", got, want, MODEL_TOL)
        want = slide_inference(cpu_seg, wide, **slide)
        kernels.reset_launch_counts()
        got = slide_inference(gpu_seg, wide.to(dev), **slide).cpu()
        seen = kernels.launch_counts()
        expect_launches("slide_inference 512 x 683 (2 windows)", seen,
                        scaled(SEG_FWD, 2))
        total = {k: total[k] + v for k, v in seen.items()}
        compare("slide_inference 512 x 683, crop 512, stride 341, 2 windows,"
                " card vs CPU", got, want, MODEL_TOL)
    del cpu_seg, gpu_seg

    labels = torch.randint(150, (1, 512, 512), generator=gen)
    labels[:, :64] = 255
    results = []
    branch = ReluBranch()
    for seg, d in zip(reversed(seg_pair(dev, 4, (0, 1, 2, 3))),
                      (dev, "cpu")):
        seg.train()
        seg.decode_head.dropout.rate = seg.aux_head.dropout.rate = 0.0
        kernels.reset_launch_counts()
        branch.replay = d == "cpu"
        with branch:
            logits, aux = seg(x.to(d), with_aux=True)
        loss = segmentation_loss(logits, labels.to(d), aux)
        fwd = kernels.launch_counts()
        params = dict(seg.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
        results.append(({"loss": loss.detach().cpu(),
                         "logits": logits.detach().cpu()},
                        {n: g.cpu() for n, g in zip(params, grads)}))
        if d != "cpu":
            seen_fwd, seen_bwd = fwd, bwd
    log(f"[check] segmentor depth 4: the CPU's own ReLU keeps another "
        f"element than the card's in {branch.flips} of {branch.elements}")
    if branch.flips > RELU_FLIPS * branch.elements:
        raise AssertionError(f"segmentor depth 4: the CPU's ReLU masks differ "
                             f"from the card's in {branch.flips} of "
                             f"{branch.elements} elements, more than "
                             f"{RELU_FLIPS:g} of them")
    fwd, bwd = seen_fwd, seen_bwd
    expect_launches("segmentor depth 4 forward", fwd,
                    {k: v // 6 for k, v in SEG_FWD.items()})
    expect_launches("segmentor depth 4 backward", bwd,
                    {k: v // 6 for k, v in SEG_BWD.items()})
    total = {k: total[k] + fwd[k] + bwd[k] for k in total}
    (got_out, got), (want_out, want) = results
    compare_grads("UperNet fastvim_tiny depth 4 512px B=1 fp32 train-mode "
                  "loss and logits, card vs CPU", got_out, want_out)
    compare_grads("UperNet fastvim_tiny depth 4 512px B=1 fp32 gradients, "
                  "card vs CPU", got, want)
    return total


def run_seg_cli_path(dev, card):
    """Phase 10, the segmentation CLIs on the card, in-process:
    ``train_segmentation --config_name upernet_FastVimT_ade20k`` (B = 2,
    512 px, 8 synthetic images: 4 steps an epoch; 8 eval images) for 3
    iterations and an eval, ``--resume`` to 9 (mid-epoch) and an eval
    under the profiler, then ``--eval_only``, which must give the last
    row's mIoU; then ``extract_features --with_fpn``. Checks the launches
    and prints img/s, step time, the idle share over the resumed run's
    training and its peak memory. Returns the launch counts."""
    import csv
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch.cli import extract_features, train_segmentation
    from fastvim_tpu_torch.ops import kernels

    batch, val, g = 2, 8, 32
    step = {**SEG_FWD, **SEG_BWD}
    total = dict.fromkeys(kernels.launch_counts(), 0)

    def run(argv, steps, name):
        nonlocal total
        kernels.reset_launch_counts()
        result = train_segmentation.main(argv)
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        want = {k: steps * step.get(k, 0) + val * SEG_FWD.get(k, 0)
                for k in seen}
        expect_launches(f"train_segmentation {name} ({steps} steps, {val} "
                        "eval images)", seen, want)
        total = {k: total[k] + v for k, v in seen.items()}
        return result

    with tempfile.TemporaryDirectory() as out:
        common = ["--config_name", SEG_CONFIG, "--model_save_dir", out,
                  "--synthetic_samples", str(val), "--device", str(dev)]
        state = run(common + ["--total_iters", "3", "--eval_every", "3"], 3,
                    "iterations 1-3")
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = run(common + ["--total_iters", "9", "--eval_every", "9",
                                  "--resume"], 6, "resumed, iterations 4-9")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != 9:
            raise AssertionError(f"train_segmentation: step {state.step}, "
                                 "not 9")
        del state
        idle, busy_ms, wall_ms = device_idle_share(prof, "train_iters")
        log(f"[cli] train_segmentation device ms by kernel over the resumed "
            f"run (6 steps, 8 eval images): {top_kernels(prof, 12)}")
        del prof
        miou = run(common + ["--eval_only"], 0, "--eval_only")
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
    if [r["iter"] for r in rows] != ["3", "9"]:
        raise AssertionError(f"train_segmentation log rows "
                             f"{[r['iter'] for r in rows]}, not [3, 9]")
    for r in rows:
        vals = [float(r[c]) for c in ("train_loss", "mIoU", "steps_per_sec")]
        if not (all(map(math.isfinite, vals)) and 0.0 <= vals[1] <= 1.0):
            raise AssertionError(f"train_segmentation log row: {r}")
    if abs(miou - float(rows[-1]["mIoU"])) > 1e-6:
        raise AssertionError(f"--eval_only mIoU {miou} against the last "
                             f"row's {rows[-1]['mIoU']}")
    log(f"[cli] train_segmentation log.csv: {rows}; --eval_only mIoU {miou}")
    # the host loader alone, as the CLI builds it: the rate its steps
    # could reach if the card took no time
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.data import create_segmentation_loader

    cfg = load_config(SEG_CONFIG, "segmentation")
    loader = create_segmentation_loader(
        None, "training", batch, cfg["img_size"], training=True,
        num_classes=cfg["num_classes"], num_workers=cfg.get("num_workers", 2),
        synthetic_samples=16)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    loader_img_s = n / (time.perf_counter() - t0)
    sps = [float(r["steps_per_sec"]) for r in rows]
    share = ("not measured (no device event)" if idle is None
             else f"{idle:.4f}")
    log(f"[time] CLI train_segmentation {SEG_CONFIG}.yaml B={batch} fp32 "
        f"512px, 150 classes: iterations 1-3 {sps[0] * batch:.2f} img/s "
        f"({1e3 / sps[0]:.1f} ms a step), resumed 4-9 under the profiler "
        f"{sps[1] * batch:.2f} img/s ({1e3 / sps[1]:.1f} ms a step); device "
        f"idle share over the resumed training {share} (busy {busy_ms:.1f} "
        f"of {wall_ms:.1f} ms); peak memory of the resumed run {peak:.2f} "
        f"GiB; the host loader alone ({cfg.get('num_workers', 2)} threads) "
        f"{loader_img_s:.2f} img/s; a step launches {step} ({card})")

    kernels.reset_launch_counts()
    feats = extract_features.main(["--config_name", SEG_CONFIG, "--with_fpn",
                                   "--device", str(dev)])
    seen = kernels.launch_counts()
    expect_launches("extract_features", seen, SEG_FWD)
    total = {k: total[k] + v for k, v in seen.items()}
    shapes = [tuple(f.shape) for f in feats["features"]]
    pyramid = [tuple(f.shape) for f in feats["pyramid"]]
    if (shapes != [(1, g, g, 192)] * 4 or pyramid != [
            (1, g * 4, g * 4, 256), (1, g * 2, g * 2, 256), (1, g, g, 256),
            (1, g // 2, g // 2, 256), (1, g // 4, g // 4, 256)] or not all(
            torch.isfinite(f).all() for f in (*feats["features"],
                                              *feats["pyramid"]))):
        raise AssertionError(f"extract_features: maps {shapes}, pyramid "
                             f"{pyramid}")
    log(f"[check] extract_features --with_fpn: maps {shapes}, pyramid "
        f"{pyramid} ok")
    return total


def run_seg_base_cli(dev, card):
    """Phase 10, FastVim-B: ``train_segmentation --config_name
    upernet_FastVimB_ade20k`` as shipped (``fastvim_base`` in feature mode,
    B = 2, 512 px, fp32) for 3 iterations on 2 synthetic images and the
    eval at the last one: each step 24 K3, 24 K4, 48 K1, 24 K5, 24 K6 and
    48 K2 (every layer fused both ways: fp32's default takes the adjoint
    on 32-token lines, K5 and K6 in their wide forms), each eval image 24 K3 + 24 K4 + 48 K1. Prints img/s, step time and the
    peak memory. Returns the launch counts."""
    import csv
    import os
    import tempfile

    import torch

    from fastvim_tpu_torch.cli import train_segmentation
    from fastvim_tpu_torch.ops import kernels

    batch, images, iters = 2, 2, 3
    step = {**SEG_FWD, **SEG_BWD}
    with tempfile.TemporaryDirectory() as out:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_segmentation.main([
            "--config_name", SEG_B_CONFIG, "--model_save_dir", out,
            "--synthetic_samples", str(images), "--device", str(dev),
            "--total_iters", str(iters), "--eval_every", str(iters)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != iters:
            raise AssertionError(f"train_segmentation {SEG_B_CONFIG}: step "
                                 f"{state.step}, not {iters}")
        del state
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
    expect_launches(f"train_segmentation {SEG_B_CONFIG} ({iters} steps, "
                    f"{images} eval images)", seen,
                    {k: iters * step.get(k, 0) + images * SEG_FWD.get(k, 0)
                     for k in seen})
    if [r["iter"] for r in rows] != [str(iters)]:
        raise AssertionError(f"train_segmentation {SEG_B_CONFIG} log rows "
                             f"{[r['iter'] for r in rows]}, not [{iters}]")
    vals = [float(rows[0][c]) for c in ("train_loss", "mIoU",
                                        "steps_per_sec")]
    if not (all(map(math.isfinite, vals)) and 0.0 <= vals[1] <= 1.0):
        raise AssertionError(f"train_segmentation {SEG_B_CONFIG} log row: "
                             f"{rows[0]}")
    sps = vals[2]
    log(f"[time] CLI train_segmentation {SEG_B_CONFIG}.yaml B={batch} fp32 "
        f"512px, 150 classes: iterations 1-{iters} {sps * batch:.2f} img/s "
        f"({1e3 / sps:.1f} ms a step), train_loss {vals[0]:.4f}, mIoU "
        f"{vals[1]:.4f}; peak memory {peak:.2f} GiB; the whole call "
        f"{wall:.1f} s; a step launches {step} ({card})")
    return seen


def time_seg_base_routes(dev, card):
    """Phase 10, FastVim-B's segmentation step through both backwards: the
    segmentor ``train_segmentation`` builds from ``upernet_FastVimB_ade20k``
    (B = 2, 512 px, fp32; every mixer "auto", which takes the fused
    adjoint there), with its mixers' ``layer_fused_bwd`` set to "fused"
    (24 K5, 24 K6, 48 K2 a step) and to "remat" (96 K1, 48 K2), on one
    batch on the card: each route
    built anew, its first step's launches checked, then timed (CUDA
    events), in the order fused, remat, remat, fused; the peak memory of
    each route's steps. Returns the launch counts."""
    import torch

    from fastvim_tpu_torch.cli.train_segmentation import (
        build_segmentor,
        make_seg_train_step,
    )
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.models.mixer import MambaMixer
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train import TrainState, constant, make_optimizer

    cfg = load_config(SEG_B_CONFIG, "segmentation")
    batch, img = cfg["batch_size"], cfg["img_size"]
    gen = torch.Generator(device=dev).manual_seed(7)
    data = {"image": torch.randn(batch, img, img, 3, device=dev,
                                 generator=gen),
            "label": torch.randint(cfg["num_classes"], (batch, img, img),
                                   device=dev, generator=gen,
                                   dtype=torch.int32)}
    want = {"fused": {**SEG_FWD, **SEG_BWD}, "remat": SEG_B_REMAT}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    ms, peak = {"fused": [], "remat": []}, {}
    for bwd in ("fused", "remat", "remat", "fused"):
        seg = build_segmentor(cfg, dev)
        mixers = [m for m in seg.modules() if isinstance(m, MambaMixer)]
        if {m.layer_fused_bwd for m in mixers} != {"auto"}:
            raise AssertionError(f"{SEG_B_CONFIG}: the mixers' backward is "
                                 "not the default")
        for m in mixers:
            m.layer_fused_bwd = bwd
        state = TrainState.create(seg, make_optimizer(
            constant(6e-5), weight_decay=0.01, params=seg))
        step = make_seg_train_step(
            seg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        loss = step(state, data)
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        expect_launches(f"{SEG_B_CONFIG} step, layer_fused_bwd={bwd}", seen,
                        want[bwd])
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{SEG_B_CONFIG} {bwd}: loss {loss.item()}")
        for k, v in seen.items():
            total[k] += v
        ms[bwd].append(cuda_ms(lambda: step(state, data), 3, windows=3))
        peak[bwd] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del seg, mixers, state, step
        torch.cuda.empty_cache()
    for bwd, t in ms.items():
        log(f"[time] {SEG_B_CONFIG} train step B={batch} {img}px fp32, "
            f"layer_fused_bwd={bwd}: {t[0]:.3f} / {t[1]:.3f} ms, "
            f"{batch / t[0] * 1e3:.2f} / {batch / t[1] * 1e3:.2f} img/s; "
            f"the step's peak above the model and optimizer state "
            f"{peak[bwd]:.2f} GiB ({card})")
    return total


DET_CONFIG = "vitdet_FastVimT_coco"
DET_FWD = {"selective_scan_fwd": 48}
DET_BWD = {"selective_scan_bwd": 48}
DET_FUSED_FWD = {"pass_a_fwd": 24, "pass_b_fwd": 24, "selective_scan_fwd": 48}
DET_FUSED_BWD = {"pass_b_bwd": 24, "pass_a_bwd": 24, "selective_scan_bwd": 48}


class DetBranch:
    """The detector's discrete choices, recorded while the card runs and
    replayed where ``replay`` is set: each sampler's selection
    (``random_sample``, whose draws are the same on both sides, but whose
    inputs differ by rounding from the second stage on), the mask of
    every ReLU of the heads (``torch.relu``, which only the RPN, the bbox
    and the mask heads call) and the argmax of SimpleFPN's 2 × 2 max pool
    (``F.max_pool2d``), so that both sides' gradients are those of one
    branch. A replay counts the ReLU elements, the pooled windows and the
    samples whose own choice differs from the recorded one."""

    def __init__(self):
        self.masks, self.samples, self.argmax = [], [], []
        self.replay = False

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from fastvim_tpu_torch.models import detection

        self.relu_fn, self.sample_fn = torch.relu, detection.random_sample
        self.pool_fn = F.max_pool2d
        self.pos_r = self.pos_s = self.pos_p = self.flips = self.elements = 0
        self.sample_diffs = self.pool_flips = self.windows = 0
        torch.relu, detection.random_sample = self.relu, self.sample
        F.max_pool2d = self.max_pool
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F

        from fastvim_tpu_torch.models import detection

        torch.relu, detection.random_sample = self.relu_fn, self.sample_fn
        F.max_pool2d = self.pool_fn
        return False

    def max_pool(self, x, kernel_size):
        out, own = self.pool_fn(x, kernel_size, return_indices=True)
        if not self.replay:
            self.argmax.append(own.cpu())
            return out
        kept = self.argmax[self.pos_p].to(x.device)
        self.pos_p += 1
        self.pool_flips += int((own != kept).sum())
        self.windows += own.numel()
        return x.flatten(2).gather(2, kept.flatten(2)).view_as(out)

    def relu(self, y):
        import torch

        own = y.detach() > 0
        if not self.replay:
            self.masks.append(own.cpu())
            return self.relu_fn(y)
        kept = self.masks[self.pos_r].to(y.device)
        self.pos_r += 1
        self.flips += int((own != kept).sum())
        self.elements += own.numel()
        return torch.where(kept, y, torch.zeros_like(y))

    def sample(self, generator, assigned, num, pos_fraction):
        import torch

        own = self.sample_fn(generator, assigned, num, pos_fraction)
        if not self.replay:
            self.samples.append(tuple(t.cpu() for t in own))
            return own
        kept = self.samples[self.pos_s]
        self.pos_s += 1
        if not all(torch.equal(a.cpu(), b) for a, b in zip(own, kept)):
            self.sample_diffs += 1
        return tuple(t.to(assigned.device) for t in kept)


def det_step(model, batch, branch, props=None):
    """One detection train step's forward and backward, without an update,
    through the detector's methods: the backbone's map, the FPN maps, the
    RPN's outputs, the 11 losses (from ``props``, the proposals and their
    validity, when given, else the RPN's own) and every gradient; the
    samplers draw from one CPU generator seeded 0, image after image.
    Returns (outputs, losses, grads, the gradient at the backbone's map,
    proposals, forward launches, backward launches)."""
    import torch

    from fastvim_tpu_torch.models.detection import LOSS_NAMES
    from fastvim_tpu_torch.ops import kernels

    d = next(model.parameters()).device
    b = {k: v.to(d) for k, v in batch.items()}
    gt = dict(gt_boxes=b["boxes"], gt_labels=b["labels"],
              gt_masks=b["masks"], gt_valid=b["gt_valid"])
    model.train()
    gens = [torch.Generator().manual_seed(0)] * b["image"].shape[0]
    seen = {}

    def keep(module, inputs, out):
        seen["map"] = out[-1].detach()
        out[-1].register_hook(lambda g: seen.update(grad=g.detach().cpu()))

    hook = model.backbone.register_forward_hook(keep)
    kernels.reset_launch_counts()
    with branch:
        feats = model.features(b["image"])
        logits, deltas = model.rpn(feats)
        losses, own, pvalid = model.rpn_losses(
            feats, logits, deltas, gt["gt_boxes"], gt["gt_valid"], gens)
        if props is None:
            props = (own.cpu(), pvalid.cpu())
        losses.update(model.cascade_losses(
            feats, props[0].to(d), props[1].to(d), **gt, generator=gens))
        fwd = kernels.launch_counts()
        total = losses[LOSS_NAMES[0]]
        for k in LOSS_NAMES[1:]:
            total = total + losses[k]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
    hook.remove()
    bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
    outputs = {"backbone_map": seen["map"].cpu(),
               **{f"fpn_{i}": f.detach().cpu() for i, f in enumerate(feats)},
               "rpn_logits": logits.detach().cpu(),
               "rpn_deltas": deltas.detach().cpu()}
    losses = {k: v.detach().cpu() for k, v in losses.items()}
    losses["loss"] = total.detach().cpu()
    return (outputs, losses, {n: g.cpu() for n, g in zip(params, grads)},
            seen["grad"], props, fwd, bwd)


def check_det_1024(dev, card):
    """Phase 11, card against CPU: ``vitdet_FastVimT_coco``'s detector as
    the CLI builds it (fastvim_tiny at full width and depth, unfused as the
    config pins it, 1024 px, a 64 × 64 grid, SimpleFPN 256, 80 classes),
    fp32, weights from seed 0, B = 1 (one synthetic LSJ image): in training
    mode the backbone's map, the five FPN maps and the RPN's logits and
    deltas within 1e-3 (phase 3's tolerance); then, with the card's RPN
    proposals, samples and head ReLU masks replayed on the CPU
    (``DetBranch``, which may differ from the CPU's own in at most
    ``RELU_FLIPS`` of the elements), the 11 losses and every gradient
    within 1e-4 of each tensor's largest entry; 48 K1 in the forward and
    48 K2 in the backward. Then the same step with the backbone built
    ``layer_fused="on"`` (the config's pin lifted for this step only): 24
    K3, 24 K4 and 48 K1, then 24 K5, 24 K6 and 48 K2, its losses and
    gradients against the unfused step's on the same replay. Times the
    exact and the fast NMS at the RPN's eval shape. Returns the card's
    launches."""
    import torch

    from fastvim_tpu_torch.cli.train_detection import build_model
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.ops import boxes

    cfg = load_config(DET_CONFIG, "detection")
    cpu_model, depth = build_model(cfg, torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = det_batch(cfg, 1)
    branch = DetBranch()
    got, got_l, got_g, got_m, props, fwd, bwd = det_step(gpu_model, batch,
                                                         branch)
    expect_launches("detector 1024px train forward", fwd, DET_FWD)
    expect_launches("detector 1024px train backward", bwd, DET_BWD)
    total = {k: fwd[k] + bwd[k] for k in fwd}
    t0 = time.perf_counter()
    branch.replay = True
    want, want_l, want_g, want_m, *_ = det_step(cpu_model, batch, branch,
                                                props)
    cpu_s = time.perf_counter() - t0
    log(f"[check] detector 1024px B=1: the CPU's own ReLU keeps another "
        f"element than the card's in {branch.flips} of {branch.elements}, "
        f"its own FPN max pool another token in {branch.pool_flips} of "
        f"{branch.windows} windows, its own samples differ in "
        f"{branch.sample_diffs} of {len(branch.samples)} draws (CPU step "
        f"{cpu_s:.1f} s)")
    if branch.flips > RELU_FLIPS * branch.elements:
        raise AssertionError(f"detector: the CPU's ReLU masks differ from "
                             f"the card's in {branch.flips} of "
                             f"{branch.elements} elements")
    for k, w in want.items():
        compare(f"detector fastvim_tiny 1024px B=1 fp32 {k} {tuple(w.shape)}"
                ", card vs CPU", got[k], w, MODEL_TOL)
    compare_grads("detector 1024px B=1 fp32 11 losses and their sum, card "
                  "vs CPU", got_l, want_l)
    # the heads' gradient reaching the backbone, then the parameters'
    compare_grads("detector 1024px B=1 fp32 gradient at the backbone's map "
                  "(1, 64, 64, 192), card vs CPU", {"map": got_m},
                  {"map": want_m})
    compare_grads("detector 1024px B=1 fp32 gradients, card vs CPU", got_g,
                  want_g)
    del cpu_model, want, want_g

    # ROADMAP fault 2, the card half: the fused adjoint in this program
    fused, _ = build_model(dict(cfg, layer_fused="on"), torch.device("cpu"))
    fused.load_state_dict(gpu_model.state_dict())
    fused = fused.to(dev)
    del gpu_model
    _, f_l, f_g, _, _, ffwd, fbwd = det_step(fused, batch, branch, props)
    expect_launches("detector 1024px layer_fused=on forward", ffwd,
                    DET_FUSED_FWD)
    expect_launches("detector 1024px layer_fused=on backward", fbwd,
                    DET_FUSED_BWD)
    total = {k: total[k] + ffwd[k] + fbwd[k] for k in total}
    log(f"[check] detector layer_fused=on: its own ReLU keeps another "
        f"element than the unfused step's in {branch.flips} of "
        f"{branch.elements}, its max pool another token in "
        f"{branch.pool_flips} of {branch.windows} windows")
    if branch.flips > RELU_FLIPS * branch.elements:
        raise AssertionError("detector layer_fused=on: the ReLU masks differ"
                             " from the unfused step's")
    compare_grads("detector 1024px layer_fused=on, losses against "
                  "layer_fused=off (card)", f_l, got_l)
    compare_grads("detector 1024px layer_fused=on, gradients against "
                  "layer_fused=off (card)", f_g, got_g)
    del fused
    torch.cuda.empty_cache()

    # the RPN's eval NMS (exact; a device sync a round) and the training
    # one (fast), over nms_pre per level of 1024 px: 4 × 1000 + 768 boxes
    g = torch.Generator(device=dev).manual_seed(11)
    bx = torch.rand(4768, 4, generator=g, device=dev) * 900
    bx[:, 2:] += bx[:, :2] + 10
    sc = torch.rand(4768, generator=g, device=dev)
    with torch.no_grad():
        exact_ms = cuda_ms(lambda: boxes.nms(bx, sc, 0.7, 512), 10)
        fast_ms = cuda_ms(lambda: boxes.fast_nms(bx, sc, 0.7, 512), 10)
        i_e, v_e = boxes.nms(bx, sc, 0.7, 512)
        i_s, v_s = boxes.nms_scan(bx, sc, 0.7, 512)
    if not (torch.equal(v_e, v_s) and torch.equal(i_e, i_s)):
        raise AssertionError("nms differs from nms_scan on the card")
    log(f"[time] nms over 4768 RPN boxes at IoU 0.7, 512 kept: exact "
        f"(fixpoint, a host sync a round) {exact_ms:.3f} ms, fast "
        f"{fast_ms:.3f} ms a call; exact equals nms_scan ({card})")
    return total


# phase 11 in bf16. A bf16 rounding is 2⁻⁸ (0.4 %) of a value, and two
# bf16 runs that sum in other orders (the card's kernels and the CPU's
# plain versions) or round at other places (the fused layer rounds its
# gated value and its adjoint's operands where the unfused ops do not)
# part by a few roundings of a map's or a loss's largest entry
# (DET_BF16_TOL, of the largest entry), and by more in the gradients,
# which carry those differences back through 24 layers and sum them over
# thousands of tokens and RoIs with cancellation: the plain versions of
# the unfused and the fused bf16 step (fastvim_tiny, 64 px, B = 2, on the
# CPU, the fp32 step's branch replayed) put their worst gradient tensor
# (an x_proj weight) 10.5 % and 10.3 % of its norm from the fp32 step's.
# So gradients are held by the norm of their difference
# (DET_BF16_GRAD_TOL, of the tensor's norm), and the fused adjoint's bf16
# step against the unfused bf16 step by how far each lies from the fp32
# step: the fused one at most twice as far as the unfused one, or within
# the tolerances above. Up to DET_BF16_FLIPS of the heads' ReLU elements
# may change sign between two runs (replayed: all take one branch; 0.4 %
# in that CPU run).
DET_BF16_TOL = 5e-2
DET_BF16_GRAD_TOL = 2e-1
DET_BF16_FLIPS = 5e-2


def norm_errors(got, want):
    """{name: ‖got − want‖ / ‖want‖} over the tensors of ``want``."""
    import torch

    out = {}
    for k, w in want.items():
        g = got[k].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{k}: non-finite values")
        out[k] = ((g - w.float()).norm() / (w.float().norm() + 1e-12)).item()
    return out


def max_errors(got, want):
    """{name: max |got − want| / max |want|} over the tensors of
    ``want``."""
    return {k: (got[k].float() - w.float()).abs().max().item()
            / (w.float().abs().max().item() + 1e-12) for k, w in want.items()}


def worst(errors):
    """(the largest error, its tensor's name)."""
    k = max(errors, key=errors.get)
    return errors[k], k


def det_batch(cfg, n):
    """The first synthetic LSJ batch of n images of the config's loader."""
    import torch

    from fastvim_tpu_torch.data import create_detection_loader

    loader = create_detection_loader(
        None, "train", n, cfg["img_size"], training=True,
        max_gt=cfg.get("max_gt", 32), num_workers=1, synthetic_samples=n,
        num_classes=cfg.get("num_classes", 80))
    return {k: torch.as_tensor(v) for k, v in next(iter(loader)).items()}


def check_det_bf16(dev, card):
    """Phase 11 in bf16: ``vitdet_FastVimT_coco``'s detector built with
    ``dtype=bf16`` as the CLI builds it (the backbone and every head
    computing in bf16 over fp32 parameters, the losses in fp32 where the
    JAX model casts them), 1024 px, B = 1, card against CPU with the
    card's proposals, samples, head ReLU masks and FPN max-pool argmax
    replayed (``DetBranch``): the maps, the 11 losses and every gradient
    within ``DET_BF16_TOL`` / ``DET_BF16_GRAD_TOL`` of each tensor's
    largest entry (the gradients by the norm of their difference); 48 K1
    and 48 K2. Then at the CLI's B = 8 the fp32 step, the bf16 step and
    the bf16 step with the backbone built ``layer_fused="on"`` (24 K3, 24
    K4, 48 K1; 24 K5, 24 K6, 48 K2: ROADMAP fault 2's fused adjoint), on
    the fp32 step's replayed branch: the fused bf16 step no farther from
    the fp32 step than twice the unfused bf16 step (or within the
    tolerances), each step timed by the host clock (the forward and
    backward, the gradients copied to the host). Returns the card's
    launches."""
    import torch

    from fastvim_tpu_torch.cli.train_detection import build_model
    from fastvim_tpu_torch.config import load_config

    t_phase = time.perf_counter()
    cfg = dict(load_config(DET_CONFIG, "detection"), dtype="bf16")
    cpu_model, _ = build_model(cfg, torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = det_batch(cfg, 1)
    branch = DetBranch()
    got, got_l, got_g, got_m, props, fwd, bwd = det_step(gpu_model, batch,
                                                         branch)
    expect_launches("bf16 detector 1024px train forward", fwd, DET_FWD)
    expect_launches("bf16 detector 1024px train backward", bwd, DET_BWD)
    total = {k: fwd[k] + bwd[k] for k in fwd}
    t0 = time.perf_counter()
    branch.replay = True
    want, want_l, want_g, want_m, *_ = det_step(cpu_model, batch, branch,
                                                props)
    cpu_s = time.perf_counter() - t0
    log(f"[check] bf16 detector 1024px B=1: the CPU's own ReLU keeps "
        f"another element than the card's in {branch.flips} of "
        f"{branch.elements}, its own FPN max pool another token in "
        f"{branch.pool_flips} of {branch.windows} windows, its own samples "
        f"differ in {branch.sample_diffs} of {len(branch.samples)} draws "
        f"(CPU step {cpu_s:.1f} s)")
    if branch.flips > DET_BF16_FLIPS * branch.elements:
        raise AssertionError(f"bf16 detector: the CPU's ReLU masks differ "
                             f"from the card's in {branch.flips} of "
                             f"{branch.elements} elements")
    dtypes = {k: str(v.dtype) for k, v in got.items()}
    log(f"[check] bf16 detector 1024px B=1 dtypes: {dtypes}; losses "
        f"{ {k: str(v.dtype) for k, v in got_l.items()} }")
    if any(v != "torch.bfloat16" for k, v in dtypes.items()
           if k != "backbone_map"):
        raise AssertionError(f"bf16 detector: heads' outputs {dtypes}")
    compare_grads("bf16 detector 1024px B=1 backbone map, FPN maps, RPN "
                  "outputs, card vs CPU", got, want, DET_BF16_TOL)
    compare_grads("bf16 detector 1024px B=1 11 losses and their sum, card "
                  "vs CPU", got_l, want_l, DET_BF16_TOL)
    e, k = worst(norm_errors({"map": got_m, **got_g},
                             {"map": want_m, **want_g}))
    log(f"[check] bf16 detector 1024px B=1 gradient at the backbone's map "
        f"and {len(want_g)} parameters' gradients, card vs CPU: worst "
        f"{e:.3e} of the tensor's norm ({k}) tol={DET_BF16_GRAD_TOL:g} "
        f"{'ok' if e <= DET_BF16_GRAD_TOL else 'FAIL'}")
    if e > DET_BF16_GRAD_TOL:
        raise AssertionError(f"bf16 detector: gradient of {k} off by {e:.3e}"
                             " of its norm")
    del cpu_model, want, want_g, got, got_g

    # fault 2's card half: the fused adjoint in the bf16 step at the CLI's
    # B = 8, against the unfused bf16 step, each against the fp32 step on
    # its branch
    n = cfg["batch_size"]
    batch = det_batch(cfg, n)
    branch = DetBranch()
    steps = {}

    def step(what, model, props=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = det_step(model, batch, branch, props)
        torch.cuda.synchronize()
        steps[what] = ((time.perf_counter() - t0) * 1e3,
                       torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    def built(**kw):
        model, _ = build_model(dict(cfg, **kw), torch.device("cpu"))
        model.load_state_dict(gpu_model.state_dict())
        return model.to(dev)

    ref = built(dtype="fp32")
    _, r_l, r_g, _, props, rfwd, rbwd = step("fp32 unfused", ref)
    del ref
    branch.replay = True
    _, u_l, u_g, _, _, ufwd, ubwd = step("bf16 unfused", gpu_model, props)
    fused = built(layer_fused="on")
    del gpu_model
    flips = branch.flips
    _, f_l, f_g, _, _, ffwd, fbwd = step("bf16 layer_fused=on", fused, props)
    del fused
    torch.cuda.empty_cache()
    for what, (fw, bw, wf, wb) in {
            "fp32": (rfwd, rbwd, DET_FWD, DET_BWD),
            "bf16": (ufwd, ubwd, DET_FWD, DET_BWD),
            "bf16 layer_fused=on": (ffwd, fbwd, DET_FUSED_FWD,
                                    DET_FUSED_BWD)}.items():
        expect_launches(f"detector B={n} {what} forward", fw, wf)
        expect_launches(f"detector B={n} {what} backward", bw, wb)
        total = {k: total[k] + fw[k] + bw[k] for k in total}
    log(f"[check] detector B={n}: against the fp32 step's branch, the bf16 "
        f"step's own ReLU keeps another element in {flips}, the fused bf16 "
        f"step's in {branch.flips} of {branch.elements}")
    if max(flips, branch.flips) > DET_BF16_FLIPS * branch.elements:
        raise AssertionError(f"detector B={n}: the bf16 steps' ReLU masks "
                             "differ from the fp32 step's")
    loss_u, loss_f = max_errors(u_l, r_l), max_errors(f_l, r_l)
    grad_u, grad_f = norm_errors(u_g, r_g), norm_errors(f_g, r_g)
    for what, (eu, ef), tol in (("losses", (loss_u, loss_f), DET_BF16_TOL),
                                ("gradients", (grad_u, grad_f),
                                 DET_BF16_GRAD_TOL)):
        (wu, ku), (wf, kf) = worst(eu), worst(ef)
        ok = wf <= max(2 * wu, tol)
        log(f"[check] bf16 detector 1024px B={n} {what} against the fp32 "
            f"step (card): unfused worst {wu:.3e} ({ku}), layer_fused=on "
            f"(24 K5, 24 K6) worst {wf:.3e} ({kf}); the fused one within "
            f"max(2 x unfused, {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bf16 detector layer_fused=on {what}: "
                                 f"{wf:.3e} from the fp32 step, the unfused "
                                 f"bf16 step {wu:.3e}")
    wl, kl = worst(max_errors(f_l, u_l))
    wg, kg = worst(norm_errors(f_g, u_g))
    log(f"[check] bf16 detector 1024px B={n} layer_fused=on against the "
        f"unfused bf16 step: losses worst {wl:.3e} ({kl}), gradients worst "
        f"{wg:.3e} of the norm ({kg})")
    log(f"[time] detector 1024px B={n} step (forward, backward, the "
        f"gradients copied to the host; the first call of each), ms and "
        f"peak GiB: { {k: (round(t, 1), round(m, 2)) for k, (t, m) in steps.items()} } ({card})")
    log(f"[time] phase 11 bf16 checks {time.perf_counter() - t_phase:.1f} s")
    return total


def run_det_bf16_cli(dev, card):
    """Phase 11, the detection CLI in bf16 on the card, in-process:
    ``train_detection --config_name vitdet_FastVimT_coco dtype=bf16`` (B =
    8, 1024 px; 16 synthetic images, 2 steps) for one epoch under the
    profiler: 48 K1 + 48 K2 a step, finite log, img/s, step time, the idle
    share over the epoch's training, peak memory. Returns the launches."""
    import csv
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch.cli import train_detection
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.ops import kernels

    batch, n_train = load_config(DET_CONFIG, "detection")["batch_size"], 16
    steps = n_train // batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = train_detection.main([
                "--config_name", DET_CONFIG, "--model_save_dir", out,
                "--synthetic_samples", str(n_train), "--device", str(dev),
                "--epochs", "1", "dtype=bf16"])
            torch.cuda.synchronize()
        seen = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != steps:
            raise AssertionError(f"train_detection dtype=bf16: step "
                                 f"{state.step}")
        del state
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
    expect_launches("train_detection dtype=bf16 epoch 1", seen,
                    scaled({**DET_FWD, **DET_BWD}, steps))
    if len(rows) != 1 or not all(math.isfinite(float(v))
                                 for k, v in rows[0].items() if k != "epoch"):
        raise AssertionError(f"train_detection dtype=bf16 log rows {rows}")
    t1 = time.perf_counter()
    idle, busy_ms, wall_ms = device_idle_share(prof)
    log(f"[cli] train_detection dtype=bf16 device ms by kernel over its "
        f"epoch ({steps} steps): {top_kernels(prof, 12)}; the CLI under the "
        f"profiler {t1 - t0:.1f} s, reading the trace "
        f"{time.perf_counter() - t1:.1f} s")
    del prof
    torch.cuda.empty_cache()
    sps = float(rows[0]["steps_per_sec"])
    share = ("not measured (no device event)" if idle is None
             else f"{idle:.4f}")
    log(f"[time] CLI train_detection {DET_CONFIG}.yaml dtype=bf16 B={batch} "
        f"1024px, 80 classes, one epoch under the profiler: "
        f"{sps * batch:.2f} img/s ({1e3 / sps:.1f} ms a step); device idle "
        f"share over its training {share} (busy {busy_ms:.1f} of "
        f"{wall_ms:.1f} ms); peak memory {peak:.2f} GiB; log {rows[0]} "
        f"({card})")
    return seen


def run_det_cli_path(dev, card):
    """Phase 11, the detection CLI on the card, in-process:
    ``train_detection --config_name vitdet_FastVimT_coco`` as shipped (B =
    8, 1024 px, fp32, 80 classes; 16 synthetic images, 2 steps an epoch)
    for one epoch, ``--resume`` to two under the profiler, then
    ``--eval_only`` from the checkpoint on 8 val images (B = 1), which must
    give box and mask AP in [0, 1]. Each step 48 K1 + 48 K2, each eval
    image 48 K1. Prints img/s, step time, the idle share over the resumed
    epoch's training (span ``train_epoch``), its peak memory, the host
    loader alone and the top kernels. Returns the launch counts."""
    import csv
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvim_tpu_torch.cli import train_detection
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.data import create_detection_loader
    from fastvim_tpu_torch.ops import kernels

    cfg = load_config(DET_CONFIG, "detection")
    batch, n_train, val = cfg["batch_size"], 16, 8
    steps = n_train // batch
    step = {**DET_FWD, **DET_BWD}
    total = dict.fromkeys(kernels.launch_counts(), 0)

    def run(argv, n_steps, n_eval, name):
        nonlocal total
        kernels.reset_launch_counts()
        result = train_detection.main(argv)
        torch.cuda.synchronize()
        seen = kernels.launch_counts()
        want = {k: n_steps * step.get(k, 0) + n_eval * DET_FWD.get(k, 0)
                for k in seen}
        expect_launches(f"train_detection {name}", seen, want)
        total = {k: total[k] + v for k, v in seen.items()}
        return result

    with tempfile.TemporaryDirectory() as out:
        common = ["--config_name", DET_CONFIG, "--model_save_dir", out,
                  "--synthetic_samples", str(n_train), "--device", str(dev)]
        state = run(common + ["--epochs", "1"], steps, 0, "epoch 1")
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = run(common + ["--epochs", "2", "--resume"], steps, 0,
                        "--resume, epoch 2")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != 2 * steps:
            raise AssertionError(f"train_detection: step {state.step}")
        del state
        idle, busy_ms, wall_ms = device_idle_share(prof)
        log(f"[cli] train_detection device ms by kernel over the resumed "
            f"epoch ({steps} steps): {top_kernels(prof, 12)}")
        del prof
        torch.cuda.empty_cache()
        aps = run(common + ["--eval_only"], 0, val, "--eval_only")
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
    if [r["epoch"] for r in rows] != ["0", "1"]:
        raise AssertionError(f"train_detection log rows {rows}")
    for r in rows:
        if not all(math.isfinite(float(v)) for k, v in r.items()
                   if k != "epoch"):
            raise AssertionError(f"train_detection log row: {r}")
    if set(aps) != {"box_ap50", "mask_ap50"} or not all(
            0.0 <= v <= 1.0 for v in aps.values()):
        raise AssertionError(f"train_detection --eval_only: {aps}")
    log(f"[cli] train_detection log.csv: {rows}; --eval_only {aps}")
    loader = create_detection_loader(
        None, "train", batch, cfg["img_size"], training=True,
        max_gt=cfg.get("max_gt", 32), num_workers=cfg.get("num_workers", 4),
        synthetic_samples=n_train, num_classes=cfg.get("num_classes", 80))
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    loader_img_s = n / (time.perf_counter() - t0)
    sps = [float(r["steps_per_sec"]) for r in rows]
    share = ("not measured (no device event)" if idle is None
             else f"{idle:.4f}")
    log(f"[time] CLI train_detection {DET_CONFIG}.yaml B={batch} fp32 "
        f"1024px, 80 classes: epoch 1 {sps[0] * batch:.2f} img/s "
        f"({1e3 / sps[0]:.1f} ms a step), epoch 2 resumed under the profiler "
        f"{sps[1] * batch:.2f} img/s ({1e3 / sps[1]:.1f} ms a step); device "
        f"idle share over epoch 2's training {share} (busy {busy_ms:.1f} of "
        f"{wall_ms:.1f} ms); peak memory of the resumed run {peak:.2f} GiB; "
        f"the host loader alone ({cfg.get('num_workers', 4)} threads) "
        f"{loader_img_s:.2f} img/s; a step launches {step} ({card})")
    return total


# the native pipeline's tolerances against its plain numpy versions
# (fastvim_tpu_torch/native/plain.py): the resize within
# plain.resize_tol(375, 500, std), 2.8e-4 (g++ may fuse a multiply and an
# add under -march=native, numpy does not: a sample coordinate moves by up
# to one float32 ulp of the source's width); the cell augment exactly; the
# decode as a mean per image within the noise write_jpeg_folder puts in
# its JPEGs, 16 grey levels / (255 · 0.225) = 0.279 in normalized units
# (libjpeg's DCT scaling decodes a num/8 version of the image, which
# averages that noise away, where PIL's full-size decode sampled
# bilinearly keeps it)
JPEG_NOISE = 16
NATIVE_DECODE_MEAN_TOL = JPEG_NOISE / (255 * 0.225)


def write_jpeg_folder(root, n, classes=8, seed=12):
    """n 500 × 375 JPEGs (quality 90, the ImageNet val median's shape)
    written by Pillow under ``root/val/class<k>/``: a few low-frequency
    waves per channel plus noise of ±``JPEG_NOISE`` grey levels, from
    ``seed`` (drawn in order, then made and encoded on 8 threads).
    Returns their paths."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    y = np.arange(375, dtype=np.float32)[:, None]
    x = np.arange(500, dtype=np.float32)[None, :]
    noise = rng.integers(-JPEG_NOISE, JPEG_NOISE + 1,
                         (375, 564, 3)).astype(np.float32)
    waves = rng.uniform(0.5, 6, (n, 3, 2)) / (375, 500)
    phases = rng.uniform(0, 2 * np.pi, (n, 3))
    paths = [os.path.join(root, "val", f"class{i % classes}",
                          f"img{i:04d}.jpg") for i in range(n)]
    for k in range(classes):
        os.makedirs(os.path.join(root, "val", f"class{k}"), exist_ok=True)

    def write(i):
        img = noise[:, i % 64:i % 64 + 500] + 128
        for c in range(3):
            img[..., c] += 60 * np.sin(
                2 * np.pi * (waves[i, c, 0] * y + waves[i, c, 1] * x)
                + phases[i, c])
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            paths[i], "JPEG", quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n)))
    return paths


def host_ms(fn, reps: int) -> float:
    """ms a call on the host's clock: the median of ``reps`` calls after
    one warm-up call."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_native(card, paths):
    """Phase 12: the native host pipeline (fastvim_tpu_torch/native). Each
    entry point against its plain numpy version on this run's inputs, and
    timed per batch (host clock, median of 5 calls after a warm-up; with
    all cores and with one thread, as the loaders call it from each of
    their threads) beside one call of its plain version (the one checked)
    and of the Python path the loaders take without it: ``augment_batch`` and
    ``decode_augment_batch`` at B = 128 to 224 px, train and eval, from
    ``paths`` (500 × 375 JPEGs, decoded by PIL for the former),
    ``cell_augment_batch`` at B = 32, 224 × 224 × 8, train and eval, and
    ``jpeg_dims`` over the 128 streams. Where this machine has no
    libjpeg-turbo header the decode library is not built: its entry points
    are reported unavailable, with the reason, and are tested on the CPU
    only. Returns the ``native`` line's entries."""
    import io
    import os
    import random

    import numpy as np
    from PIL import Image

    from fastvim_tpu_torch import native
    from fastvim_tpu_torch.data import cells
    from fastvim_tpu_torch.data import transforms as T
    from fastvim_tpu_torch.native import _build, plain

    src = "fastvim_tpu_torch/native/csrc/"
    no_jpeg = _build.missing("decode")
    log(f"[native] nproc {os.cpu_count()}; compiler {_build.compiler()}; "
        f"libjpeg-turbo's jpeglib.h: "
        f"{'found' if no_jpeg is None else 'missing: ' + no_jpeg}; "
        f"libraries: "
        f"augment {_build.library_path('augment').name}, decode "
        + (_build.library_path("decode").name if native.available("decode")
           else "not built"))
    if not native.available("augment"):
        raise AssertionError("the native augment library is required")
    if (no_jpeg is None) != native.available("decode"):
        raise AssertionError("the decode library must be built where its "
                             "header is found")
    B, size = 128, 224
    streams = []
    for p in paths[:B]:
        with open(p, "rb") as f:
            streams.append(f.read())
    pil = [Image.open(io.BytesIO(b)).convert("RGB") for b in streams]
    rgb = np.stack([np.asarray(im, np.uint8) for im in pil])
    kw = dict(mean=T.IMAGENET_MEAN, std=T.IMAGENET_STD, scale=(0.2, 1.0))
    entries = []

    def once(fn):
        """(fn's result, its ms on the host's clock)."""
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def entry(name, source, shape, fn, plain_fn, python_fn, compare, tol):
        native.reset_call_counts()
        got = fn(None)
        calls = sum(native.call_counts().values())
        want, plain_ms = once(plain_fn)
        err, mean_err = compare(got, want)
        ok = err <= tol if mean_err is None else mean_err <= tol
        log(f"[check] native {name}: max_abs_err={err:.3e}"
            + ("" if mean_err is None else
               f" largest per-image mean err={mean_err:.3e}")
            + f" tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok or not calls:
            raise AssertionError(f"native {name}: outside tolerance {tol} "
                                 f"or not called ({calls} calls)")
        e = {"name": name, "source": src + source, "shape": shape,
             "max_abs_err": err, "tol": tol,
             "threads": os.cpu_count(),
             "ms": host_ms(lambda: fn(None), 5),
             "ms_1_thread": host_ms(lambda: fn(1), 3),
             "plain_ms": plain_ms,
             "python_ms": None if python_fn is None else once(python_fn)[1]}
        if mean_err is not None:
            e["mean_abs_err"] = mean_err
        log(f"[time] native {name} ({shape}): {e['ms']:.2f} ms a batch on "
            f"{e['threads']} threads, {e['ms_1_thread']:.2f} ms on one; plain "
            f"{e['plain_ms']:.2f} ms; the Python path "
            + ("-" if e["python_ms"] is None else f"{e['python_ms']:.2f} ms")
            + f" (host clock; {card})")
        entries.append(e)

    def exact(got, want):
        return float(np.abs(got - want).max()), None

    def per_image(got, want):
        (g, gf), (w, wf) = got, want
        if not np.array_equal(gf, wf):
            raise AssertionError(f"decode fail flags {gf} vs {wf}")
        d = np.abs(g - w).reshape(len(g), -1)
        return float(d.max()), float(d.mean(axis=1).max())

    for training in (True, False):
        mode = "train" if training else "eval"
        pil_tf = ((lambda im, r: T.mae_transform(im, size, r)) if training
                  else (lambda im, r: T.eval_transform(im, size)))
        entry(f"augment_batch {mode}", "augment.cpp",
              f"{B} x 375 x 500 x 3 uint8 -> {size} px",
              lambda nt, t=training: native.augment_batch(
                  rgb, size, 7, t, num_threads=nt, **kw),
              lambda t=training: plain.augment_batch(rgb, size, 7, t, **kw),
              lambda f=pil_tf: [f(im, random.Random(i))
                                for i, im in enumerate(pil)],
              exact, plain.resize_tol(375, 500, T.IMAGENET_STD))
    cx = np.random.default_rng(13).standard_normal(
        (32, 224, 224, 8)).astype(np.float32)
    cmean = np.linspace(-0.5, 0.5, 8).astype(np.float32)
    cstd = np.linspace(0.5, 1.5, 8).astype(np.float32)
    for training in (True, False):
        mode = "train" if training else "eval"
        entry(f"cell_augment_batch {mode}", "augment.cpp",
              "32 x 224 x 224 x 8 float32",
              lambda nt, t=training: native.cell_augment_batch(
                  cx, 9, t, cmean, cstd, num_threads=nt),
              lambda t=training: plain.cell_augment_batch(cx, 9, t, cmean,
                                                          cstd),
              lambda t=training: [cells.cell_augment(
                  x, random.Random(i), 224, cmean, cstd, training=t)
                  for i, x in enumerate(cx)],
              exact, 0.0)
    if no_jpeg is not None:
        log(f"[native] decode_augment_batch and jpeg_dims not run here: "
            f"{no_jpeg}; they are held against the JAX package's library and "
            "their plain versions on the CPU (tests/test_torch_port_"
            "native.py)")
        for name in ("decode_augment_batch train", "decode_augment_batch "
                     "eval", "jpeg_dims"):
            entries.append({"name": name, "source": src + "decode.cpp",
                            "available": False, "why": no_jpeg})
        return entries
    for training in (True, False):
        mode = "train" if training else "eval"
        pil_tf = ((lambda im, r: T.mae_transform(im, size, r)) if training
                  else (lambda im, r: T.eval_transform(im, size)))
        entry(f"decode_augment_batch {mode}", "decode.cpp",
              f"{B} JPEGs 500 x 375 -> {size} px",
              lambda nt, t=training: native.decode_augment_batch(
                  streams, size, 11, t, num_threads=nt, **kw),
              lambda t=training: plain.decode_augment_batch(
                  streams, size, 11, t, **kw),
              lambda f=pil_tf: [f(Image.open(io.BytesIO(b)).convert("RGB"),
                                  random.Random(i))
                                for i, b in enumerate(streams)],
              per_image, NATIVE_DECODE_MEAN_TOL)
    entry("jpeg_dims", "decode.cpp", f"{B} JPEGs 500 x 375",
          lambda nt: [native.jpeg_dims(b) for b in streams],
          lambda: [plain.jpeg_dims(b) for b in streams], None,
          lambda g, w: (float(g != w), None), 0.0)
    return entries


def time_loaders(card):
    """Phase 12, the loaders alone, as the CLIs of phases 8 and 9 build
    them, with the native path on and off in turns (on, off, off, on):
    the MAE train loader (pretrain_FastVimB.yaml: B = 128, 224 px, its
    12 threads, 512 synthetic images) and the cells train loader
    (FastChannelVimS.yaml: B = 32, 224 × 224 × 8, its normalization, 128
    synthetic images, on the calling thread). img/s of a whole epoch on
    the host's clock. Returns the ``native`` line's entries."""
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.data import (CellLoader, SyntheticCellDataset,
                                        create_imagenet_loader)

    mae = load_config("pretrain_FastVimB", "mae")
    cells = load_config("FastChannelVimS", "cells")
    makers = {
        "MAE train loader": lambda on: create_imagenet_loader(
            None, "train", mae["batch_size"], mae["img_size"],
            training=True, mae=True, num_workers=mae["num_workers"],
            seed=mae["seed"], synthetic_samples=512, use_native=on),
        "cells train loader": lambda on: CellLoader(
            SyntheticCellDataset(128, cells["img_size"], 8,
                                 cells["num_classes"]),
            cells["batch_size"], cells["img_size"], training=True,
            seed=cells["seed"], mean=cells["data"]["normalization_mean"],
            std=cells["data"]["normalization_std"]),
    }
    entries = []
    for name, make in makers.items():
        rates = {True: [], False: []}
        for on in (True, False, False, True):
            with native_path(on):
                loader = make(on)
                t0 = time.perf_counter()
                n = sum(b["image"].shape[0] for b in loader)
                rates[on].append(n / (time.perf_counter() - t0))
        log(f"[time] native {name} alone, in turns (on, off, off, on): "
            f"native {rates[True][0]:.2f} / {rates[True][1]:.2f} img/s, "
            f"off {rates[False][0]:.2f} / {rates[False][1]:.2f} img/s "
            f"(host clock; {card})")
        entries.append({"name": f"{name} alone", "img_s_native": rates[True],
                        "img_s_off": rates[False]})
    return entries


def run_folder_eval(dev, card, root, n):
    """Phase 12, the folder eval: ``test_classification --config_name
    FastVimT --data_dir root`` (fastvim_tiny at full width and depth,
    seeded weights, batch 128, fp32) over the ``n`` JPEGs of
    ``root/val``, in-process, with the native path on (the default: the
    fused decode + augment where the decode library is built) and off
    (PIL), each under the profiler: 24 K3 + 24 K4 + 48 K1 a batch, the
    native calls, img/s over the whole call and the device's idle share
    over it; and the host loader alone on both paths. Returns the launch
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fastvim_tpu_torch import native
    from fastvim_tpu_torch.cli import test_classification
    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.ops import kernels

    batch = 128
    decode = native.available("decode")
    total = dict.fromkeys(kernels.launch_counts(), 0)
    for mode in ("native", "native off"):
        with native_path(mode == "native"):
            kernels.reset_launch_counts()
            native.reset_call_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("folder_eval"):
                    t0 = time.perf_counter()
                    result = test_classification.main(
                        ["--config_name", "FastVimT", "--data_dir", root,
                         "--device", str(dev)])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            seen, calls = kernels.launch_counts(), native.call_counts()
            expect_launches(f"test_classification --data_dir ({mode})", seen,
                            scaled(FUSED_FWD, n // batch))
            for k, v in seen.items():
                total[k] += v
            want = n // batch if mode == "native" and decode else 0
            if calls["decode_augment_batch"] != want:
                raise AssertionError(f"folder eval ({mode}): native calls "
                                     f"{calls}, expected {want} "
                                     "decode_augment_batch")
            if not math.isfinite(result["test_loss"]):
                raise AssertionError(f"folder eval ({mode}): {result}")
            idle, busy_ms, wall_ms = device_idle_share(prof, "folder_eval")
            del prof
            loader = create_imagenet_loader(root, "val", batch, 224,
                                            training=False)
            t0 = time.perf_counter()
            m = sum(b["image"].shape[0] for b in loader)
            loader_img_s = m / (time.perf_counter() - t0)
        share = ("not measured (no device event)" if idle is None
                 else f"{idle:.4f}")
        path = ("the fused native decode + augment" if mode == "native"
                and decode else "PIL decode + eval_transform" + (
                    " (no decode library here)" if mode == "native" else ""))
        log(f"[time] CLI test_classification FastVimT --data_dir ({mode}: "
            f"{path}) B={batch} fp32 224px, {n} JPEGs 500 x 375: {result}; "
            f"{n / wall:.2f} img/s over the whole call ({wall:.2f} s); device"
            f" idle share over the call {share} (busy {busy_ms:.1f} of "
            f"{wall_ms:.1f} ms); native decode_augment_batch calls "
            f"{calls['decode_augment_batch']}; the host loader alone "
            f"{loader_img_s:.2f} img/s ({type(loader).__name__}, "
            f"{loader.num_workers} threads) ({card})")
    return total


DP_BATCH = 8  # the global batch of phase 13 (data parallel)
# FastVim-T's launches a train step at 224 px in fp32: 24 fused layers,
# forward (K3, K4, two K1 scans each) and the fused adjoint (K5, K6, two
# K2 scans each)
DP_STEP = {"selective_scan_fwd": 48, "pass_a_fwd": 24, "pass_b_fwd": 24,
           "selective_scan_bwd": 48, "pass_b_bwd": 24, "pass_a_bwd": 24}


def dp_inputs():
    """Phase 13's global batch (CPU tensors, from a seed)."""
    import torch

    gen = torch.Generator().manual_seed(13)
    return {"image": torch.randn(DP_BATCH, 224, 224, 3, generator=gen),
            "label": torch.randint(1000, (DP_BATCH,), generator=gen)}


def dp_model(dev):
    """FastVim-T at full width and depth, 224 px, fp32, DropPath 0.1
    (its masks drawn over the global batch), from one seed."""
    import torch

    from fastvim_tpu_torch.models import create_model

    model = create_model("fastvim_tiny", device=dev, drop_path_rate=0.1,
                         generator=torch.Generator().manual_seed(0)).train()
    model.dp_generator = torch.Generator(device=dev)
    model.set_drop_path_generator(model.dp_generator)
    return model


def dp_grads(model, batch, dev):
    """This rank's loss (smoothed cross entropy over its rows) and
    gradients, the DropPath generator seeded alike on every rank."""
    import torch

    from fastvim_tpu_torch.parallel import shard_batch
    from fastvim_tpu_torch.train import (
        one_hot_smooth,
        soft_target_cross_entropy,
    )

    rows = {k: v.to(dev) for k, v in shard_batch(batch).items()}
    model.dp_generator.manual_seed(7)
    loss = soft_target_cross_entropy(model(rows["image"]),
                                     one_hot_smooth(rows["label"], 1000, 0.1))
    params = dict(model.named_parameters())
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def dp_step(model, batch, dev, compress=None):
    """(global loss, all-reduced gradients, step ms, all-reduce ms): one
    data-parallel forward and backward pass and the gradient all-reduce,
    by the host clock around work that ends in a synchronize."""
    import torch

    from fastvim_tpu_torch.parallel import allreduce_grads, mean_over_ranks

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = dp_grads(model, batch, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = allreduce_grads(grads, compress)
    loss = mean_over_ranks({"loss": loss})["loss"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return loss, grads, (t2 - t0) * 1e3, (t2 - t1) * 1e3


def dp_rank(rank, world, backend, store, out):
    """A rank of phase 13: ``backend`` "gloo" (every rank on cuda:0) or
    "nccl" (rank r on cuda:r). One data-parallel step, its launches
    checked, then three timed; saves rank 0's loss and gradients and every
    rank's launches and times. Rank 0 of the gloo pair then joins a
    one-rank NCCL group and all-reduces its gradients in bf16 and in
    fp32."""
    import statistics

    import torch
    import torch.distributed as dist

    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.parallel import (
        allreduce_grads,
        make_mesh,
        replicate,
        reset_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    batch = dp_inputs()
    dist.init_process_group(backend, init_method=f"file://{store}.{backend}",
                            world_size=world, rank=rank)
    make_mesh(data=world)
    model = replicate(dp_model(dev))
    kernels.reset_launch_counts()
    loss, grads, _, _ = dp_step(model, batch, dev)
    seen = kernels.launch_counts()
    expect_launches(f"phase 13 {backend} rank {rank} step", seen,
                    DP_STEP)
    times = [dp_step(model, batch, dev)[2:] for _ in range(3)]
    counts = kernels.launch_counts()
    result = {"counts": counts,
              "step_ms": statistics.median(t[0] for t in times),
              "allreduce_ms": statistics.median(t[1] for t in times)}
    if rank == 0:
        result.update(loss=loss.cpu(),
                      grads={k: v.cpu() for k, v in grads.items()})
    dist.destroy_process_group()
    reset_mesh()
    if backend == "gloo" and rank == 0:
        dist.init_process_group("nccl", init_method=f"file://{store}.one",
                                world_size=1, rank=0)
        make_mesh(data=1)
        kernels.reset_launch_counts()
        _, raw = dp_grads(model, batch, dev)
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            allreduce_grads(raw, dtype)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduced = allreduce_grads(raw, dtype)
            torch.cuda.synchronize()
            result[f"nccl1_{name}_ms"] = (time.perf_counter() - t0) * 1e3
            result[f"nccl1_{name}"] = {k: v.cpu() for k, v in reduced.items()}
        # one rank's fp32 mean is its own gradient, bit for bit
        result["nccl1_fp32_exact"] = all(
            torch.equal(result["nccl1_fp32"][k], v.cpu())
            for k, v in raw.items())
        for k, v in kernels.launch_counts().items():
            counts[k] += v
        dist.destroy_process_group()
        reset_mesh()
    torch.save(result, f"{out}.{backend}.{rank}")


def spawn_dp(world, backend, folder):
    """Run ``dp_rank`` in ``world`` spawned processes; returns their
    results in rank order."""
    import torch
    import torch.multiprocessing as mp

    store, out = f"{folder}/store", f"{folder}/rank"
    mp.spawn(dp_rank, args=(world, backend, store, out), nprocs=world,
             join=True)
    return [torch.load(f"{out}.{backend}.{r}", weights_only=True)
            for r in range(world)]


def run_data_parallel(dev, card):
    """Phase 13: ``fastvim_tpu_torch.parallel`` on the card. FastVim-T
    (full width and depth, 224 px, fp32, DropPath 0.1; the fused layer
    K3-K6 and the scans K1/K2) on a global batch of 8: 2 ranks on cuda:0
    over gloo (2 rows each) against the 1-rank step here (the loss to
    1e-5 relative, every gradient to ``GRAD_TOL`` of its largest entry);
    1 rank over NCCL, its gradients all-reduced in bf16 against fp32
    (within a bf16 rounding, 2⁻⁸ of each entry); ``torchrun
    --standalone --nproc_per_node 1`` of ``train_classification
    --config_name FastVimT --epochs 1 --synthetic_samples 256`` to its
    end; and, where the machine has two cards, 2 ranks over NCCL against
    the same 1-rank step. Returns the ranks' launches."""
    import csv
    import os
    import shutil
    import statistics
    import tempfile

    import torch

    from fastvim_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    batch = dp_inputs()
    model = dp_model(dev)
    loss_ref, grads_ref, ref_ms, _ = dp_step(model, batch, dev)
    ref_ms = statistics.median(dp_step(model, batch, dev)[2]
                               for _ in range(3))
    n_grads = sum(v.numel() for v in grads_ref.values()) / 1e6
    del model
    torch.cuda.empty_cache()
    total = dict.fromkeys(kernels.launch_counts(), 0)
    runs = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", 2))
    log(f"[dp] runs: 2 ranks on cuda:0 over gloo; 1 rank over NCCL (bf16 "
        f"and fp32 all-reduce); torchrun --nproc_per_node 1 CLI"
        + ("; 2 ranks over NCCL on cuda:0 and cuda:1" if len(runs) == 2
           else f"; not 2 ranks over NCCL ({torch.cuda.device_count()} "
                "card)"))
    with tempfile.TemporaryDirectory() as folder:
        for backend, world in runs:
            results = spawn_dp(world, backend, folder)
            r0 = results[0]
            rel = abs(r0["loss"].item() - loss_ref.item()) / abs(
                loss_ref.item())
            log(f"[check] phase 13 {backend} {world} ranks loss "
                f"{r0['loss'].item():.6f} vs 1 rank {loss_ref.item():.6f}: "
                f"rel {rel:.3e} tol=1e-05 {'ok' if rel <= 1e-5 else 'FAIL'}")
            if rel > 1e-5:
                raise AssertionError(f"phase 13 {backend}: loss off by {rel}")
            compare_grads(f"phase 13 {backend} {world} ranks gradients",
                          r0["grads"], {k: v.cpu()
                                        for k, v in grads_ref.items()})
            for r in results:
                for k, v in r["counts"].items():
                    total[k] += v
            log(f"[time] phase 13 FastVim-T 224px fp32 global B="
                f"{DP_BATCH}, {world} ranks over {backend}"
                f"{' on cuda:0' if backend == 'gloo' else ''}: step "
                f"{r0['step_ms']:.3f} ms (forward, backward and all-reduce, "
                f"median of 3, rank 0), all-reduce {r0['allreduce_ms']:.3f} "
                f"ms ({n_grads:.2f}M fp32 gradients); 1 rank without a "
                f"process group {ref_ms:.3f} ms (median of 3) ({card})")
            if backend == "gloo":
                bf16, fp32 = r0["nccl1_bf16"], r0["nccl1_fp32"]
                worst = max(((bf16[k] - fp32[k]).abs()
                             / fp32[k].abs().clamp_min(1e-30)).max().item()
                            for k in fp32)
                ok = 0.0 < worst <= 2 ** -8 and r0["nccl1_fp32_exact"]
                log(f"[check] phase 13 nccl 1 rank bf16 all-reduce vs fp32: "
                    f"worst {worst:.3e} of an entry tol={2 ** -8:g}, fp32 "
                    f"equal to the rank's own gradients: "
                    f"{r0['nccl1_fp32_exact']} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"phase 13 bf16 all-reduce: {worst}")
                log(f"[time] phase 13 1 rank over NCCL, all-reduce of "
                    f"{n_grads:.2f}M gradients: bf16 "
                    f"{r0['nccl1_bf16_ms']:.3f} ms, fp32 "
                    f"{r0['nccl1_fp32_ms']:.3f} ms ({card})")
        out = os.path.join(folder, "cli")
        runner = shutil.which("torchrun")
        cmd = ([runner] if runner else
               [sys.executable, "-m", "torch.distributed.run"]) + [
            "--standalone", "--nproc_per_node", "1", "-m",
            "fastvim_tpu_torch.cli.train_classification", "--config_name",
            "FastVimT", "--epochs", "1", "--synthetic_samples", "256",
            "--model_save_dir", out]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} failed ({proc.returncode})"
                                 f":\n{proc.stderr[-4000:]}")
        with open(os.path.join(out, "log.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or not os.path.exists(
                os.path.join(out, "ckpt", "step_2")):
            raise AssertionError(f"torchrun CLI: log rows {rows}, "
                                 f"{os.listdir(out)}")
        sps = float(rows[0]["steps_per_sec"])
        log(f"[dp] {' '.join(cmd[1:])} (1 rank, NCCL): "
            f"{time.perf_counter() - t1:.1f} s, 2 steps of B=128 at "
            f"{sps * 128:.2f} img/s, val_loss {float(rows[0]['val_loss']):.4f}"
            f" ({card})")
    log(f"[time] phase 13 (data parallel) {time.perf_counter() - t0:.1f} s")
    return total


# phase 14: mamba-130m's published widths (state-spaces/mamba-130m's
# config, the JAX package's MambaLMHeadModel defaults), depth 24, random
# weights from a seed
LM_FIELDS = dict(vocab_size=50277, d_model=768, n_layer=24, d_state=16)
LM_SEED = 14


def lm_logits_along(model, prompt, tokens):
    """Logits (batch, T, vocab) of the prefill's last position and then of
    each cached step fed ``tokens`` (batch, T) but its last: the logits
    that predicted each of ``tokens``, teacher-forced."""
    import torch

    logits, caches = model(prompt, prefill=True)
    out = [logits[:, -1]]
    for t in range(tokens.shape[1] - 1):
        logits, caches = model(tokens[:, t:t + 1], caches=caches)
        out.append(logits[:, -1])
    return torch.stack(out, 1)


def check_lm_scans(dev, card):
    """Phase 14, K1 at the LM's prefill shapes (B = 4, d_inner 1536, n 16;
    L = 128, the sequential form, and 2048, the chunked one), fp32 and
    bf16, both directions, with the gate z (the z half of an
    in-projection output, a column slice) and the final state, against
    the plain version on the card: y within the dtype's tolerance, the
    fp32 state within fp32's (both sides scan the same rounded inputs in
    fp32). Times the forward scan at L = 2048 in both dtypes beside the
    plain version and the bound. Returns (max error, the fp32 L = 2048
    times for the kernels line)."""
    import torch

    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g,
                                            device=dev) * scale
    batch, d, n = 4, 1536, 16
    A = -torch.exp(rnd(d, n, scale=0.5))
    kw = dict(D=rnd(d), delta_bias=rnd(d, scale=0.5) - 2.0,
              delta_softplus=True)
    worst, entry = 0.0, None
    for L in (128, 2048):
        base = dict(u=rnd(batch, L, d), delta=rnd(batch, L, d, scale=0.5),
                    B=rnd(batch, L, n), C=rnd(batch, L, n),
                    xz=rnd(batch, L, 2 * d))
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            t = {k: v.to(dtype) for k, v in base.items()}
            z = t["xz"][..., d:]
            args = (t["u"], t["delta"], A, t["B"], t["C"])
            for reverse in (False, True):
                tag = (f"L={L} ({ss.fwd_route(L)}) B={batch} d={d} {dtype} "
                       f"reverse={reverse}")
                y, last = ss.selective_scan_fwd(
                    *args, **kw, reverse=reverse, z=z,
                    return_last_state=True)
                wy, wlast = ss.selective_scan_plain(
                    *args, **kw, reverse=reverse, z=z.contiguous(),
                    return_last_state=True)
                worst = max(worst,
                            compare(f"phase 14 K1 y with z {tag}", y, wy,
                                    tol),
                            compare(f"phase 14 K1 last state {tag}", last,
                                    wlast, FP32_TOL))
                del y, last, wy, wlast
            if L == 2048:
                kern = lambda: ss.selective_scan_fwd(
                    *args, **kw, z=z, return_last_state=True)
                plain = lambda: ss.selective_scan_plain(
                    *args, **kw, z=z, return_last_state=True)
                out = kern()
                k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 1)
                # per (b, t, d, n): exp, the recurrence (4), h·C and its sum
                b_ms, by = bound(nbytes(*args, z, kw["D"], kw["delta_bias"],
                                        *out), 9.0 * batch * L * d * n,
                                 "fp32")
                log(f"[time] phase 14 K1 with z and the final state, "
                    f"{dtype} B={batch} L={L} d={d} (chunked, 3 device "
                    f"kernels): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({by}), {b_ms / k_ms:.1%} of the "
                    f"bound ({card})")
                if dtype == torch.float32:
                    entry = (k_ms, p_ms, b_ms, by)
                del out
            del t, z, args
        del base
        torch.cuda.empty_cache()
    return worst, entry


def run_lm_path(dev, card):
    """Phase 14, the language model: ``create_lm`` at mamba-130m's widths
    (``LM_FIELDS``: d_model 768, 24 layers, vocab 50277 padded to 50280,
    d_state 16, d_inner 1536, dt_rank 48) with seeded random weights, on
    the card.

    1. K1 at the prefill's shapes with z and the final state
       (:func:`check_lm_scans`).
    2. Prefill against replay, B = 2, L = 64, fp32: the prefill's logits
       at every position and its 24 caches against the same tokens fed
       one by one through the cached step from zero caches, within
       ``MODEL_TOL``; the prefill 24 K1 launches, the 64 steps none.
    3. Card against CPU: greedy generation of 32 tokens from a 16-token
       prompt on both; the card's logits with the CPU's tokens fed back
       (teacher-forced) within ``MODEL_TOL`` of the CPU's; the card's
       argmax equal to the CPU's token wherever the CPU's top-2 gap
       exceeds the tolerance, and the card's own tokens equal to the
       CPU's up to the first step where they may differ.
    4. Rates: prefill tokens/s at B = 1 and 8, L = 2048, and decode
       tokens/s (128 cached steps after a 16-token prefill and 8 steps'
       warm-up) at B = 1 and 16, fp32 and bf16, each with its peak
       memory.

    Returns (launch counts of the prefill-against-replay run, K1's max
    error, its times for the kernels line)."""
    import copy

    import torch

    from fastvim_tpu_torch.models.lm import create_lm, generate
    from fastvim_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    with torch.inference_mode():
        k1_err, k1_times = check_lm_scans(dev, card)
    seed = lambda: torch.Generator().manual_seed(LM_SEED)
    model = create_lm(dev, seed(), **LM_FIELDS)
    cfg = model.backbone.layers[0].mixer
    log(f"[lm] mamba-130m widths: d_model {model.d_model}, {model.n_layer} "
        f"layers, vocab {model.vocab_size} padded to {model.padded_vocab}, "
        f"d_state {cfg.d_state}, d_inner {cfg.d_inner}, dt_rank "
        f"{cfg.dt_rank}; {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
        f"M parameters, seed {LM_SEED}")
    tok = lambda *s: torch.randint(0, LM_FIELDS["vocab_size"], s,
                                   generator=seed())
    with torch.inference_mode():
        # 2. prefill against replay
        toks = tok(2, 64).to(dev)
        kernels.reset_launch_counts()
        pre, pre_caches = model(toks, prefill=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        expect_launches("phase 14 prefill B=2 L=64", counts,
                        {"selective_scan_fwd": LM_FIELDS["n_layer"]})
        kernels.reset_launch_counts()
        caches = model.init_cache(2)
        steps = []
        for t in range(toks.shape[1]):
            logits, caches = model(toks[:, t:t + 1], caches=caches)
            steps.append(logits[:, 0])
        torch.cuda.synchronize()
        expect_launches("phase 14 replay, 64 cached steps",
                        kernels.launch_counts(), {})
        compare("phase 14 prefill logits vs replay (B=2 L=64 fp32)",
                pre, torch.stack(steps, 1), MODEL_TOL)
        compare("phase 14 prefill conv windows vs replay",
                torch.stack([c[0] for c in pre_caches]),
                torch.stack([c[0] for c in caches]), MODEL_TOL)
        compare("phase 14 prefill ssm states vs replay",
                torch.stack([c[1] for c in pre_caches]),
                torch.stack([c[1] for c in caches]), MODEL_TOL)
        del pre, pre_caches, caches, steps

        # 3. card against CPU, greedy, 32 tokens from a 16-token prompt
        cpu = copy.deepcopy(model).to("cpu")
        prompt = tok(1, 16)
        t1 = time.perf_counter()
        want = generate(cpu, prompt, 32, temperature=0.0)[:, 16:]
        want_logits = lm_logits_along(cpu, prompt, want)
        cpu_s = time.perf_counter() - t1
        got = generate(model, prompt.to(dev), 32, temperature=0.0)[:, 16:]
        got_logits = lm_logits_along(model, prompt.to(dev), want.to(dev))
        compare("phase 14 card vs CPU logits, the CPU's 32 greedy tokens "
                "fed back", got_logits.cpu(), want_logits, MODEL_TOL)
        top2 = want_logits[0].topk(2, -1).values
        gap = top2[:, 0] - top2[:, 1]
        clear = gap > MODEL_TOL
        argmax = got_logits[0].argmax(-1).cpu()
        bad = (clear & (argmax != want[0])).nonzero().flatten().tolist()
        differ = (got.cpu()[0] != want[0]).nonzero().flatten().tolist()
        ok = not bad and (not differ or not clear[differ[0]])
        log(f"[check] phase 14 greedy tokens card vs CPU: teacher-forced "
            f"argmax differs at clear steps {bad}; free-running tokens "
            f"differ from step {differ[0] if differ else None} (the CPU's "
            f"top-2 gap there "
            f"{gap[differ[0]].item() if differ else float('nan'):.3e}); "
            f"{int(clear.sum())} of 32 steps have a gap over {MODEL_TOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14: the card's greedy tokens differ "
                                 "from the CPU's where the CPU's choice is "
                                 "clear")
        log(f"[time] phase 14 the CPU's greedy generation and teacher-forced "
            f"logits: {cpu_s:.1f} s")
        del cpu, got_logits, want_logits

        # 4. rates, fp32 then bf16 (the same weights)
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16:
                model = create_lm(dev, seed(), dtype=dtype, **LM_FIELDS)
            for batch in (1, 8):
                x = tok(batch, 2048).to(dev)
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                ms = cuda_ms(lambda: model(x, prefill=True), 3)
                n_calls = kernels.launch_counts()["selective_scan_fwd"]
                log(f"[time] phase 14 LM prefill {dtype} B={batch} L=2048: "
                    f"{ms:.3f} ms, {batch * 2048 / ms * 1e3:.1f} tokens/s, "
                    f"{n_calls // 4} K1 launches a prefill, peak "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                    f"({card})")
            for batch in (1, 16):
                prompt = tok(batch, 16).to(dev)
                torch.cuda.reset_peak_memory_stats()
                logits, caches = model(prompt, prefill=True)
                nxt = logits[:, -1:].argmax(-1)
                for steps in (8, 128):  # a warm-up, then the timed steps
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                    t1 = time.perf_counter()
                    for _ in range(steps):
                        logits, caches = model(nxt, caches=caches)
                        nxt = logits[:, -1:].argmax(-1)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t1
                expect_launches(f"phase 14 decode {dtype} B={batch}",
                                kernels.launch_counts(), {})
                log(f"[time] phase 14 LM decode {dtype} B={batch}, 128 "
                    f"cached steps after a 16-token prefill and 8 steps: "
                    f"{dt / 128 * 1e3:.3f} ms a step, "
                    f"{batch * 128 / dt:.1f} tokens/s; peak "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                    f"({card})")
            del x, logits, caches
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 14 (LM) {time.perf_counter() - t0:.1f} s")
    return counts, k1_err, k1_times

# phase 15: the seq axis. FastVim-T (fastvim_tiny) at full width and
# depth over (data 1, seq 2), B = 2: (name, px, dtype, DropPath rate, tol,
# timed train steps); the full-width check is the one with train steps
SEQ_CHECKS = (("fp32 512px", 512, "float32", 0.1, GRAD_TOL, 0),
              ("bf16 2048px", 2048, "bfloat16", 0.0, BF16_TOL, 2))
SEQ_BATCH = 2
SEQ_SEED = 15
# a rank's launches: the two pooled scans of each of the 24 layers, run
# whole on every rank (K1), and in a gradient pass their adjoints (K2);
# no K3-K10, since a sharded layer runs unfused
SEQ_FWD = {"selective_scan_fwd": 48}
SEQ_STEP = {"selective_scan_fwd": 48, "selective_scan_bwd": 48}


def seq_inputs(img):
    """Phase 15's global batch at ``img`` px (CPU tensors, from a seed)."""
    import torch

    gen = torch.Generator().manual_seed(SEQ_SEED)
    return {"image": torch.randn(SEQ_BATCH, img, img, 3, generator=gen),
            "label": torch.randint(1000, (SEQ_BATCH,), generator=gen)}


def seq_model(dev, img, dtype, drop, **fields):
    """FastVim-T at full width and depth from one seed, in training mode,
    its DropPath generator on ``model.seq_generator``."""
    import torch

    from fastvim_tpu_torch.models import create_model

    model = create_model("fastvim_tiny", device=dev, img_size=img,
                         dtype=getattr(torch, dtype), drop_path_rate=drop,
                         generator=torch.Generator().manual_seed(0),
                         **fields).train()
    model.seq_generator = torch.Generator(device=dev)
    model.set_drop_path_generator(model.seq_generator)
    return model


def seq_pass(model, batch, dev):
    """(eval-mode logits, loss, gradients, the forward's launches, the
    gradient pass's launches, the gradient pass's ms): the loss and
    gradients of the smoothed cross entropy in training mode, averaged
    over ranks (``allreduce_grads``; as they are without a process
    group), the DropPath generator seeded alike on every rank."""
    import torch

    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.parallel import (
        allreduce_grads,
        mean_over_ranks,
        shard_batch,
    )
    from fastvim_tpu_torch.train import (
        one_hot_smooth,
        soft_target_cross_entropy,
    )

    rows = {k: v.to(dev) for k, v in shard_batch(batch).items()}
    model.eval()
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = model(rows["image"]).float()
    torch.cuda.synchronize()
    fwd = kernels.launch_counts()
    model.train()
    model.seq_generator.manual_seed(7)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = soft_target_cross_entropy(model(rows["image"]),
                                     one_hot_smooth(rows["label"], 1000, 0.1))
    params = dict(model.named_parameters())
    grads = allreduce_grads(dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    loss = mean_over_ranks({"loss": loss.detach()})["loss"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return logits, loss, grads, fwd, kernels.launch_counts(), ms


def seq_train_steps(model, batch, dev, n=2):
    """([ms of each step], peak GiB, launches of each step): ``n``
    supervised steps through the entry points a user calls
    (``make_optimizer`` AdamW, ``TrainState``,
    ``make_supervised_train_step``), by the host clock around work that
    ends in a synchronize."""
    import torch

    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.parallel import shard_batch
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    rows = {k: v.to(dev) for k, v in shard_batch(batch).items()}
    tx = make_optimizer(cosine_with_warmup(1e-3, 1e-5, 100, 10),
                        weight_decay=0.05, params=model)
    state = TrainState.create(model, tx, ema=False)
    step = make_supervised_train_step(model, 1000, label_smoothing=0.1,
                                      ema_decay=None,
                                      generator=model.seq_generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, counts = [], []
    for _ in range(n):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(kernels.launch_counts())
        if not torch.isfinite(metrics["train_loss"]):
            raise AssertionError(f"train step: loss {metrics['train_loss']}")
    return times, torch.cuda.max_memory_allocated(dev) / 2 ** 30, counts


def seq_rank(rank, world, backend, store, out):
    """A rank of phase 15: ``backend`` "gloo" (every rank on cuda:0) or
    "nccl" (rank r on cuda:r), over a ``(data 1, seq world)`` mesh. For
    each of ``SEQ_CHECKS`` (NCCL: the 2048 px one) FastVim-T built with
    its default fields (its layers would fuse; sharded, they run
    unfused): the eval forward and the gradient pass, their launches
    checked, and at 2048 px two timed train steps; saves rank 0's logits,
    loss and gradients and every rank's launches, times and peak
    memory."""
    import torch
    import torch.distributed as dist

    from fastvim_tpu_torch.parallel import make_mesh, reset_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}.{backend}",
                            world_size=world, rank=rank)
    make_mesh(data=1, seq=world)
    result = {}
    for name, img, dtype, drop, _, steps in SEQ_CHECKS:
        if backend == "nccl" and not steps:
            continue
        batch = seq_inputs(img)
        model = seq_model(dev, img, dtype, drop)
        shard = model.token_shard(batch["image"])
        if shard is None or shard.size != world:
            raise AssertionError(f"phase 15 {name}: tokens not sharded")
        torch.cuda.reset_peak_memory_stats(dev)
        logits, loss, grads, fwd, step, ms = seq_pass(model, batch, dev)
        what = f"phase 15 {backend} rank {rank} {name}"
        expect_launches(f"{what} forward", fwd, SEQ_FWD)
        expect_launches(f"{what} gradient pass", step, SEQ_STEP)
        entry = {"counts": {k: fwd[k] + step[k] for k in fwd},
                 "grad_ms": ms, "rows": str(shard.rows()),
                 "grad_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        if rank == 0:
            entry.update(logits=logits.cpu(), loss=loss.cpu(),
                         grads={k: v.cpu() for k, v in grads.items()})
        del grads
        if steps:
            times, gib, counts = seq_train_steps(model, batch, dev, steps)
            for i, c in enumerate(counts):
                expect_launches(f"{what} train step {i}", c, SEQ_STEP)
                for k, v in c.items():
                    entry["counts"][k] += v
            entry.update(step_ms=times, step_gib=gib)
        result[name] = entry
        del model
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    reset_mesh()
    torch.save(result, f"{out}.{backend}.{rank}")


def run_seq_path(dev, card):
    """Phase 15: the seq axis (``parallel.token_shard``,
    ``parallel/tokens.py``) on the card. FastVim-T at full width and
    depth, B = 2, over ``(data 1, seq 2)``: 2 ranks on cuda:0 over gloo
    (NCCL refuses two ranks on one device), each holding half the grid's
    rows, against the 1-rank unsharded unfused (``layer_fused="off"``)
    run here of the same function:

    1. fp32 at 512 px (a 32 × 32 grid), DropPath 0.1: the eval-mode
       logits within ``FP32_TOL``, the loss to 1e-5 relative and every
       gradient within ``GRAD_TOL`` of its largest entry (phase 13's
       bounds);
    2. bf16 at 2048 px (a 128 × 128 grid, L = 16,384): the logits, the
       loss and every gradient within ``BF16_TOL`` of the largest entry;
       then two train steps through the trainer, timed, with the peak
       memory, on each rank and on the 1 rank. Gloo stages the traffic
       through the host and the two ranks share the card: a record of
       the path, not a speed.

    Each rank's forward launches 48 K1 and its gradient pass and each
    train step 48 K1 + 48 K2 (the pooled scans, whole on every rank), and
    no K3-K10. Where the machine has two cards, 2 NCCL ranks, one a card,
    repeat the 2048 px check. Returns the ranks' launches."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from fastvim_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    refs = {}
    for name, img, dtype, drop, _, steps in SEQ_CHECKS:
        batch = seq_inputs(img)
        model = seq_model(dev, img, dtype, drop, layer_fused="off")
        torch.cuda.reset_peak_memory_stats(dev)
        logits, loss, grads, fwd, step, ms = seq_pass(model, batch, dev)
        expect_launches(f"phase 15 1 rank {name} forward", fwd, SEQ_FWD)
        expect_launches(f"phase 15 1 rank {name} gradient pass", step,
                        SEQ_STEP)
        gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        timed = ""
        if steps:
            times, gib, counts = seq_train_steps(model, batch, dev, steps)
            for i, c in enumerate(counts):
                expect_launches(f"phase 15 1 rank {name} train step {i}", c,
                                SEQ_STEP)
            timed = (f"train steps {', '.join(f'{t:.1f}' for t in times)} "
                     "ms, ")
        refs[name] = (logits.cpu(), loss.cpu(),
                      {k: v.cpu() for k, v in grads.items()},
                      f"gradient pass (a first call) {ms:.1f} ms, {timed}"
                      f"peak {gib:.2f} GiB")
        del model, grads
        torch.cuda.empty_cache()
    total = dict.fromkeys(kernels.launch_counts(), 0)
    runs = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", 2))
    log("[seq] runs: 2 ranks on cuda:0 over gloo (seq 2)"
        + ("; 2 ranks over NCCL on cuda:0 and cuda:1 (seq 2, 2048 px)"
           if len(runs) == 2 else "; 2 ranks over NCCL skipped "
           f"({torch.cuda.device_count()} card)"))
    with tempfile.TemporaryDirectory() as folder:
        store, out = os.path.join(folder, "store"), os.path.join(folder,
                                                                  "rank")
        for backend, world in runs:
            mp.spawn(seq_rank, args=(world, backend, store, out),
                     nprocs=world, join=True)
            results = [torch.load(f"{out}.{backend}.{r}", weights_only=True)
                       for r in range(world)]
            for name, _, dtype, _, tol, _ in SEQ_CHECKS:
                if name not in results[0]:
                    continue
                got, (logits, loss, grads, one) = results[0][name], refs[name]
                what = f"phase 15 {backend} {world} ranks {name}"
                if dtype == "float32":
                    compare(f"{what} logits", got["logits"], logits, FP32_TOL)
                else:
                    compare_grads(f"{what} logits", {"logits": got["logits"]},
                                  {"logits": logits}, tol)
                rel = abs(got["loss"].item() - loss.item()) / abs(loss.item())
                loss_tol = 1e-5 if dtype == "float32" else tol
                log(f"[check] {what} loss {got['loss'].item():.6f} vs 1 rank "
                    f"{loss.item():.6f}: rel {rel:.3e} tol={loss_tol:g} "
                    f"{'ok' if rel <= loss_tol else 'FAIL'}")
                if rel > loss_tol:
                    raise AssertionError(f"{what}: loss off by {rel}")
                compare_grads(f"{what} gradients", got["grads"], grads, tol)
                for r, res in enumerate(results):
                    e = res[name]
                    steps = ", ".join(f"{t:.1f}" for t in e.get("step_ms", []))
                    log(f"[time] {what} rank {r} (grid rows {e['rows']}): "
                        f"gradient pass (a first call) {e['grad_ms']:.1f} "
                        "ms, " + (f"train steps {steps} ms, peak "
                                  f"{e['step_gib']:.2f} GiB" if steps else
                                  f"peak {e['grad_gib']:.2f} GiB")
                        + f"; 1 rank unsharded unfused: {one} ({card})")
                    for k, v in e["counts"].items():
                        total[k] += v
    log(f"[time] phase 15 (seq axis) {time.perf_counter() - t0:.1f} s")
    return total


FWD_224_MODELS = ("fastvim_tiny", "fastvim_base")
STEP_224_MODELS = ("fastvim_tiny", "fastvim_base", "fastvim_large")


def fwd_224(argv) -> int:
    """``chip_smoke.py --fwd-224 [ROOT] [MODEL ...]``: the 224 px fp32
    forward at B = 128 of each model (default ``FWD_224_MODELS``) built
    with its default fields and the fused layer taken in every forward
    (where ``default_fwd_mode`` would route it unfused, it is made to
    answer "fused"; ``auto_launches`` are the launches of the default
    forward, ``auto_max_abs_diff`` its logits against the unfused ones),
    with ``layer_fused="off"`` and with ``layer_fused="recompute"`` (K3's
    pools-only form and K7; ``recompute_launches``,
    ``recompute_max_abs_diff`` against the unfused logits; a tree without
    an fp32 K7 of its own would take it too), in turns (fused, off,
    recompute, recompute, off, fused; each the median of 2 windows of 2
    forwards), their logits against each other, and for the models of ``STEP_224_MODELS`` (FastVim-L only
    when named) also a train step (cross-entropy, backward) three ways in
    turns (adjoint, remat, off, off, remat, adjoint; each the median of 2
    windows of one step): the fused forward with the fused adjoint
    (``layer_fused_bwd="fused"``: K5 and K6) and with the remat backward,
    and ``layer_fused="off"``, with the peak memory and the launches of
    three steps (a way that runs out of memory reads null, with the
    error). The
    package is imported from the checkout ROOT (default: this one), so
    that two trees can be timed in turns on one card, one process each.
    Prints one ``[fwd224]`` JSON line per model."""
    import os

    import torch

    root = os.path.abspath(argv[0] if argv else os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.models import mixer as mixer_mod
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.ops.kernels import _build

    # the forward route (absent from a tree older than it)
    auto_route = getattr(mixer_mod, "default_fwd_mode", None)

    def always_fused(on):
        if auto_route is not None:
            mixer_mod.default_fwd_mode = (lambda *a: "fused") if on \
                else auto_route

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    card = card_line()
    batch = 128
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(batch, 224, 224, 3, device=dev, generator=g)
    y = torch.randint(0, 1000, (batch,), device=dev, generator=g)
    for name in argv[1:] or FWD_224_MODELS:
        fused = create_model(name, img_size=224, device=dev)
        off, rc = copy.deepcopy(fused), copy.deepcopy(fused)
        for copy_, mode in ((off, "off"), (rc, "recompute")):
            for m in copy_.modules():
                if hasattr(m, "layer_fused"):
                    m.layer_fused = mode
        res = {"root": root, "model": name, "card": card}
        with torch.inference_mode():
            kernels.reset_launch_counts()
            auto = fused(x)
            res["auto_launches"] = {k: v for k, v in
                                    kernels.launch_counts().items() if v}
            always_fused(True)
            kernels.reset_launch_counts()
            got = fused(x)
            res["launches"] = {k: v for k, v in
                               kernels.launch_counts().items() if v}
            want = off(x)
            res["logits_max_abs_diff"] = (got - want).abs().max().item()
            res["auto_max_abs_diff"] = (auto - want).abs().max().item()
            kernels.reset_launch_counts()
            got_rc = rc(x)
            res["recompute_launches"] = {k: v for k, v in
                                         kernels.launch_counts().items() if v}
            res["recompute_max_abs_diff"] = (got_rc - want).abs().max().item()
            del auto, got, want, got_rc
            for tag, m in (("fused", fused), ("off", off), ("recompute", rc),
                           ("recompute", rc), ("off", off),
                           ("fused", fused)):
                res.setdefault(f"{tag}_ms", []).append(
                    cuda_ms(lambda: m(x), 2, windows=2))
            always_fused(False)
        if name in STEP_224_MODELS:
            # the fused forward with the fused adjoint (K5, K6) and with
            # the remat backward, and layer_fused="off", in turns
            ways = {"adjoint": (fused, "fused"), "remat": (fused, "remat"),
                    "off": (off, "auto")}
            for tag in ("adjoint", "remat", "off", "off", "remat",
                        "adjoint"):
                m, bwd = ways[tag]
                for mod in m.modules():
                    if hasattr(mod, "layer_fused_bwd"):
                        mod.layer_fused_bwd = bwd
                m.train()  # DropPath 0.1, the model's default
                m.set_drop_path_generator(
                    torch.Generator(device=dev).manual_seed(0))

                def step():
                    loss = F.cross_entropy(m(x), y)
                    loss.backward()
                    m.zero_grad(set_to_none=True)

                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                try:  # FastVim-L's unfused step does not fit B = 128
                    ms = cuda_ms(step, 1, windows=2)
                except torch.cuda.OutOfMemoryError as e:
                    m.zero_grad(set_to_none=True)
                    ms = None
                    res[f"step_{tag}_error"] = str(e).splitlines()[0]
                res.setdefault(f"step_{tag}_ms", []).append(ms)
                res[f"step_{tag}_peak_gib"] = \
                    torch.cuda.max_memory_allocated() / 2 ** 30
                # three steps: the warm-up and two windows of one
                res[f"step_{tag}_launches_3_steps"] = {
                    k: v for k, v in kernels.launch_counts().items() if v}
        print("[fwd224] " + json.dumps(res), flush=True)
        del fused, off, rc
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--count-launches"]:
        return count_launches()
    if sys.argv[1:2] == ["--fwd-224"]:
        return fwd_224(sys.argv[2:])
    try:
        from fastvim_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    log(card)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    # the native host pipeline's libraries (g++), before any loader runs
    from fastvim_tpu_torch import native

    t0 = time.perf_counter()
    built = {lib: native.available(lib) for lib in ("augment", "decode")}
    log(f"[build] native libraries {built} in "
        f"{time.perf_counter() - t0:.1f} s")

    t_start = time.perf_counter()

    def stamp(what):
        log(f"[time] {what} done, {time.perf_counter() - t_start:.1f} s "
            f"after the build")

    per_call = launches_per_call()
    log(f"[launches] device kernels per call, weight transposes included: "
        f"{per_call}")
    stamp("the launch counts")
    with torch.inference_mode():
        errs, times = check_kernels(dev, card, per_call)
    stamp("K1, K3, K4")
    with torch.no_grad():
        errs_bwd, times_bwd = check_bwd_kernels(dev, card, per_call)
    errs.update(errs_bwd)
    times.update(times_bwd)
    stamp("K2, K5, K6")
    with torch.inference_mode():
        errs_cfg, times_cfg = check_config_kernels(dev, card, per_call)
    errs.update(errs_cfg)
    times.update(times_cfg)
    stamp("K7-K10, lanes")
    with torch.no_grad():
        for name, e in check_mae_scans(dev, card).items():
            errs[name] = max(errs[name], e)
    stamp("phase 2")
    t0 = time.perf_counter()
    with torch.inference_mode():
        wide = check_models_224(dev)
    grads_wide, bwd_wide = check_grads_224(dev)
    log(f"[time] phase 3 {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        launches, base_2048 = run_main_path(dev, card)
    stamp("phase 4")
    # the wide widths' launches: FastVim-B's 2048 px forward and train
    # step, FastVim-L's and -H's depth-2 forwards and backwards
    wide.update({f"{k} d_model=768": base_2048[k]
                 for k in ("pass_a_fwd", "pass_b_fwd")})
    t0 = time.perf_counter()
    train, base_step = run_train_path(dev, card)
    log(f"[time] phase 5 {time.perf_counter() - t0:.1f} s")
    # FastVim-B's from its train step, not from phase 3's depth-2 model
    wide.update({f"{k} d_model={dm}": n
                 for dm, counts in (*bwd_wide.items(), (768, base_step))
                 for k, n in counts.items()
                 if k in ("pass_b_bwd", "pass_a_bwd")})
    # FastVim-L's K4 from its forward with a gradient: its inference
    # forward at 224 px takes the unfused route
    for dm, counts in bwd_wide.items():
        for k in ("pass_a_fwd", "pass_b_fwd"):
            wide.setdefault(f"{k} d_model={dm}", counts[k])
    config_counts, base_rc = run_config_path(dev, card)
    wide["pass_b_recompute_fwd d_model=768"] = base_rc["pass_b_recompute_fwd"]
    stamp("phase 6")
    cli_counts = run_cli_path(dev, card)
    stamp("phase 7, train_classification")
    serving = run_serving_path(dev, card)
    for counts in (grads_wide, train, config_counts, cli_counts, serving):
        for name, count in counts.items():
            launches[name] += count
    # the fp32 forms' launches: FastVimT.yaml's train_classification and
    # FastVim-B's test_classification, both fp32 at 224 px
    wide.update({f"{k} fp32{dm}": counts[k]
                 for dm, counts in (("", cli_counts), (" d_model=768",
                                                        serving))
                 for k in ("pass_a_fwd", "pass_b_fwd")})
    stamp("phase 7")
    for name, count in check_mae_224(dev).items():
        launches[name] += count
    for name, count in run_mae_cli_path(dev, card).items():
        launches[name] += count
    stamp("phase 8")
    with torch.no_grad():
        for name, e in check_mae_scans(dev, card, CHANNEL_SCANS, 21).items():
            errs[name] = max(errs[name], e)
    for counts in (check_channel_224(dev), run_cells_cli_path(dev, card),
                   run_channel_steps(dev, card)):
        for name, count in counts.items():
            launches[name] += count
    stamp("phase 9")
    t0 = time.perf_counter()
    seg_base = run_seg_base_cli(dev, card)
    for counts in (check_seg_512(dev), run_seg_cli_path(dev, card), seg_base,
                   time_seg_base_routes(dev, card)):
        for name, count in counts.items():
            launches[name] += count
    # the fp32 K5 and K6: FastVimT.yaml's train_classification (phase 7)
    # and upernet_FastVimB_ade20k's train_segmentation, both fp32
    wide.update({f"{k} fp32{dm}": counts[k]
                 for dm, counts in (("", cli_counts), (" d_model=768",
                                                        seg_base))
                 for k in ("pass_b_bwd", "pass_a_bwd")})
    log(f"[time] phase 10 (segmentation) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for what, fn in (("fp32 card against CPU", check_det_1024),
                     ("fp32 CLI", run_det_cli_path),
                     ("bf16 checks", check_det_bf16),
                     ("bf16 CLI", run_det_bf16_cli)):
        for name, count in fn(dev, card).items():
            launches[name] += count
        stamp(f"phase 11 {what}")
    log(f"[time] phase 11 (detection) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        n_jpegs = 512
        paths = write_jpeg_folder(folder, n_jpegs)
        log(f"[native] {n_jpegs} JPEGs 500 x 375 written in "
            f"{time.perf_counter() - t0:.1f} s")
        native_entries = check_native(card, paths) + time_loaders(card)
        for name, count in run_folder_eval(dev, card, folder,
                                           n_jpegs).items():
            launches[name] += count
    log(f"[time] phase 12 (native) {time.perf_counter() - t0:.1f} s")
    for name, count in run_data_parallel(dev, card).items():
        launches[name] += count
    lm_counts, errs["selective_scan_fwd lm"], times["selective_scan_fwd lm"] \
        = run_lm_path(dev, card)
    for name, count in lm_counts.items():
        launches[name] += count
    launches["selective_scan_fwd lm"] = lm_counts["selective_scan_fwd"]
    for name, count in run_seq_path(dev, card).items():
        launches[name] += count

    # each kernel's files: the main path's (bf16) kernel, then the fp32
    # route, the C entry points and the headers they include (K1 and K2:
    # the sequential form, timed at FastVim's L = 128, then the chunked
    # one, which the launcher takes at Vim-T's L = 16,384)
    src = "fastvim_tpu_torch/ops/kernels/csrc/"
    fwd = ("layer_fused_fwd.cu", "layer_fused_fwd.cuh", "wgmma.cuh")
    bwd = ("layer_fused_bwd.cu", "layer_fused_bwd.cuh", "wgmma.cuh")
    table = [
        ("selective_scan_fwd", "selective_scan_fwd.cu",
         ("selective_scan_fwd_chunked.cu", "scan_chunked.cuh"),
         "fastvim_tpu/ops/pallas/selective_scan.py:79"),
        ("selective_scan_bwd", "selective_scan_bwd.cu",
         ("selective_scan_bwd_chunked.cu", "scan_chunked.cuh"),
         "fastvim_tpu/ops/pallas/selective_scan.py:294"),
        ("pass_a_fwd", "layer_fused_fwd_wgmma.cu", fwd,
         "fastvim_tpu/ops/pallas/layer_fused.py:303"),
        ("pass_b_fwd", "layer_fused_fwd_wgmma.cu", fwd,
         "fastvim_tpu/ops/pallas/layer_fused.py:409"),
        ("pass_b_bwd", "layer_fused_bwd_wgmma.cu", bwd,
         "fastvim_tpu/ops/pallas/layer_fused.py:453"),
        ("pass_a_bwd", "layer_fused_bwd_wgmma.cu", bwd,
         "fastvim_tpu/ops/pallas/layer_fused.py:555"),
        ("pass_b_recompute_fwd", "layer_fused_recompute_wgmma.cu",
         ("layer_fused_recompute.cu", "layer_fused_fwd.cuh", "wgmma.cuh"),
         "fastvim_tpu/ops/pallas/layer_fused.py:374"),
        ("conv_pool_fwd", "fused_block.cu", (),
         "fastvim_tpu/ops/pallas/fused_block.py:130"),
        ("merge_gate_fwd", "fused_block.cu", (),
         "fastvim_tpu/ops/pallas/fused_block.py:151"),
        ("merge_ln_gate_fwd", "merge_gate.cu", (),
         "fastvim_tpu/ops/pallas/merge_gate.py:54"),
        ("selective_scan_fwd_lanes", "selective_scan_lanes.cu", (),
         "fastvim_tpu/ops/pallas/selective_scan.py:115"),
    ]
    # K3's streamed form and K4's wide one, then K5's and K6's wide forms,
    # then K7's, at each wide width
    table += [(f"{name} d_model={dm}", main_file, more, tpu)
              for rows in (table[2:4], table[4:6], table[6:7])
              for dm in WIDE_DM for name, main_file, more, tpu in rows]
    # the fp32 K3 and K4 (3xTF32 on the tensor cores) at FastVim-T's and
    # -B's widths, 224 px
    table += [(f"{name} fp32{dm}", "layer_fused_fwd_tf32.cu",
               fwd + ("tf32.cuh",), tpu)
              for dm in ("", " d_model=768")
              for name, tpu in (
                  ("pass_a_fwd", "fastvim_tpu/ops/pallas/layer_fused.py:303"),
                  ("pass_b_fwd", "fastvim_tpu/ops/pallas/layer_fused.py:409"))]
    # the fp32 K5 and K6 (3xTF32 on the tensor cores) likewise
    table += [(f"{name} fp32{dm}", "layer_fused_bwd_tf32.cu",
               bwd + ("tf32.cuh",), tpu)
              for dm in ("", " d_model=768")
              for name, tpu in (
                  ("pass_b_bwd", "fastvim_tpu/ops/pallas/layer_fused.py:453"),
                  ("pass_a_bwd", "fastvim_tpu/ops/pallas/layer_fused.py:555"))]
    # the fp32 K7 (3xTF32 on the tensor cores, clusters splitting d_inner)
    # at FastVim-T's and -B's widths, 224 px
    table += [(f"pass_b_recompute_fwd fp32{dm}", "layer_fused_recompute_tf32.cu",
               ("layer_fused_recompute.cu", "layer_fused_fwd.cuh", "tf32.cuh",
                "wgmma.cuh"), "fastvim_tpu/ops/pallas/layer_fused.py:374")
              for dm in ("", " d_model=768")]
    # K1 with the gate and the final state at the LM prefill's shapes
    # (phase 14: launches of one B = 2 prefill, times at B = 4, L = 2048,
    # fp32, the chunked form)
    table.append(("selective_scan_fwd lm", "selective_scan_fwd_chunked.cu",
                  ("selective_scan_fwd.cu", "scan_chunked.cuh"),
                  "fastvim_tpu/ops/pallas/selective_scan.py:79"))
    launches.update(wide)
    for name, *_ in table:
        if launches[name] < 1:
            raise AssertionError(f"{name}: not launched on the main path")
    print(card, flush=True)
    # library_ms: no single PyTorch call computes any of these functions.
    # ms is a call's time by CUDA events for every kernel; device_ms, where
    # timed, the device time a call from CUDA-graph replays. The fp32 K5
    # and K6 rows' max_abs_err is that of their per-token outputs, and
    # summed_rel_err that of their gradients summed over every token over
    # max(1, the largest entry): both held to 1e-4
    entries = []
    for name, main_file, more, tpu in table:
        ms, plain_ms, bound_ms, bound_by, *dev_ms = times[name]
        entries.append(
            {"name": name, "route": "cuda", "source": src + main_file,
             "sources": [src + f for f in (main_file, *more, "common.cuh")],
             "replaces": tpu, "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        if dev_ms and dev_ms[0] is not None:
            entries[-1]["device_ms"] = dev_ms[0]
        if name + " summed" in errs:
            entries[-1]["summed_rel_err"] = errs[name + " summed"]
    print(json.dumps({"native": native_entries}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
