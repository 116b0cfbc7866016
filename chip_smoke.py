#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its serving and training
paths on one card.

    python3 chip_smoke.py

Three models: the segmentation UNet (``unet_6stage``), the autoencoder
(``autoencoder_6stage``, phase 9), whose encoder the transfer recipe grafts
onto the UNet and freezes, and the CLIP_UNet model (``unet_6stage`` with
``clip_fusion``, phase 10) with its frozen ViT-B/16 tower. Two layouts of the
model are served and trained (the recipes of phases 8-10 run the default,
dense): dense, and the JAX model's space-to-depth layout (``s2d_level0`` and
``s2d_low_channel_decoders``: level 0 and decoder_3 in s2d). Seven kernels: K1 (InstanceNorm+LeakyReLU) and
K1bwd (its backward), K2a (2x upsample, dense), K2b (2x upsample into s2d),
K3 (the fused s2d block tail) and K4/K4f (the Winograd s2d conv, with the
unfolded and the folded U).

Phases (any failure makes the script exit non-zero without the kernels line):

1. Card and build: the card's name and power limit, then nvcc's register,
   shared-memory and spill report for every kernel; K3's bf16 conv kernel
   must spill nothing.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the 512² forward of a batch of 8 gives it; K1bwd at the shapes the b8
   train step gives it, in both layouts. A second bf16 call of K3, and a
   second call of K1bwd, must repeat the first bit for bit.
3. The slice, in each layout: ``unet_6stage`` in bf16 from a seeded
   generator, saved as a reference-schema ``.pth``, reloaded through
   ``load_reference_checkpoint``, and three batches of 8 images answered by
   ``predict_arrays``. The launch counts of that run must be, per batch,
   K1/K2a/K2b/K3 = 22/5/0/0 dense and 16/3/2/3 s2d. The same requests are
   then answered with the plain versions and by the float32 model, and the
   masks are held to the bounds of phase 4.
4. The whole 512² forward (batch 8) with the kernels against the same model
   with the plain versions, in bf16 and float32, in each layout; and the
   float32 s2d forward against the float32 dense one (an exact rewrite).
5. Times with CUDA events: the b128 512² bf16 forward of each layout (then
   held to the bounds of phase 4 at b128), and each kernel, its plain
   version and the single PyTorch call that computes the same function
   (where there is one), at the b128 main-path shapes, beside the kernel's
   bound. Each kernel output timed there is first held to its plain
   version. K1's forward is also timed pass by pass (statistics, apply), and
   K1bwd at the 22 shapes of a b32 dense train step, each level logged with
   its share of the bound, its rate, and its plan (fused or two-pass, pieces,
   rounds, bytes read twice). K3's conv launch is
   also timed alone, beside its bound and cuDNN's time for the
   dense-equivalent conv (not the same function: context).
6. K4 through its differentiable entry point ``winograd_conv_s2d``, at b32
   on the eligible convs of ``unet_6stage`` (encoder_2..4 conv_1, decoder_0
   conv_0), in both U layouts: forward and, through autograd, dx, dW and db
   against the plain version and the direct conv in float32 (TF32 off), and
   in bf16 against the float32 direct conv; one launch per forward and one
   more per backward; times of the forward and of dx (the kernel alone, on
   U packed beforehand) against the bound and cuDNN's ``F.conv2d`` of the
   same shape. The bf16 kernel's nvcc report (registers, shared memory,
   spills) is printed; it must spill nothing, and with the unfolded U every
   bf16 call, forward and dx, must be faster than its plain version.
7. The train step of each layout: ``unet_6stage`` at full width, 512², bf16
   compute with float32 parameters, from the reference ``.pth`` of phase 3,
   SGD-Nesterov at the JAX defaults, seeded synthetic uint8 batches. Launch
   counts per step (K1/K2a/K2b/K3/K1bwd: 22/5/0/0/22 dense, 22/3/2/0/22 s2d,
   where training takes no fused tail; 0 with the plain versions), and the
   layouts of the cotangents K1bwd receives in one step; at b8 one step
   with the kernels against one with the plain versions (float32 and bf16,
   the same weights and dropout seed), and in float32 against one whose K1
   outputs are the kernel's values with the plain version's gradient; 10
   steps on one b8 batch must lower the loss; then the b32 step time,
   images/s and peak memory, and one b32 eval step.
8. The recipe, through ``cli.main`` in this process: a dataset in the
   reference directory schema (256 train, 64 val, 64 test images of 512²
   from ``synthetic_sample``, original sizes 200-500) served from a warm
   decode cache that the loader's own functions write, since the card has no
   cv2 (the file decode is covered by the CPU tests). ``our_unet train`` for
   2 epochs at b32 (bf16, dense): launch counts K1/K2a/K1bwd 22/5/22 per step
   and 22/5/0 per validation forward, K2b and K3 none; the CSV header, two
   rows, learning rates 0.0050000 and poly_lr(5e-3, 2)(1), finite values, a
   lower train loss in epoch 2; ``checkpoints/epoch_{1,2}/`` and
   ``best_model/`` with ``model.pth`` and ``meta.json``, the latter loading
   strictly through ``load_reference_checkpoint``. A resume from epoch_2 for
   a third epoch keeps rows 1-2 as they were. ``our_unet evaluate`` of
   ``best_model`` in float32 with the kernels (22/5 per test forward) and
   with the plain versions (none): the JAX package's keys, every scalar
   within 2e-3; then in bf16, every scalar finite. cv2 is never imported.
   Printed, not gated: epoch 2's time per step beside phase 7's b32 dense
   step (whole, and after the epoch's first batch), the loader's share of
   it, validation ms per batch, the evaluate command's wall time, and one
   b32 batch's copy to the card from pageable and from pinned memory.
9. The AE_pretrained path, dense, bf16 with float32 parameters. The AE train
   step (``autoencoder_6stage``, MSE, Adam-L2): launch counts K1/K2a/K1bwd
   22/5/22; at b8 the loss and gradients against the plain versions at
   phase 7's gates; 10 b8 steps must lower the MSE; the b32 time and peak
   memory. The transfer step (``unet_6stage`` with the encoder grafted from
   the autoencoder's checkpoint by ``extract_encoder_params`` and frozen by
   ``with_frozen``, SGD-Nesterov on the rest): 22/5/10 (autograd records
   nothing in the encoder, so only the 10 decoder norms run K1's backward);
   after 10 b8 steps the six encoder stages are bit for bit the
   autoencoder's and every decoder and head weight moved; the b32 time and
   peak memory. The autoencoder's b8 forward in both layouts (22/5/0/0 and
   16/3/2/3) against the plain versions at phase 4's rel-L2 bounds, and f32
   s2d against f32 dense. Then through ``cli.main`` on phase 8's dataset,
   with reconstruction-mode decode caches written beside its segmentation
   ones: ``ae_recon train`` 2 epochs at b32 (the AE CSV header, cosine
   learning rates, finite values, epoch 2's train loss below epoch 1's,
   ``best_model`` loading strictly as ``arch="ae_recon"``); ``ae_recon
   evaluate`` in float32 with the kernels and with the plain versions (the
   JAX package's keys; mse, psnr and ssim within 2e-3 relative) and in bf16
   (finite); ``ae_transfer train --pretrained_encoder <ae>/best_model`` 2
   epochs (the segmentation CSV checks, and its ``best_model``'s encoder bit
   for bit the autoencoder's); ``ae_transfer evaluate``. Printed, not gated:
   the AE and transfer step times, and both recipes' time per step after
   their first batch, beside phase 7's b32 dense step.

10. The CLIP_UNet path, dense, bf16 with float32 parameters. The frozen
   ViT-B/16 tower (random weights from seed 0, as every ``clip_unet`` command
   draws them) at b64 224²: bf16 against float32 (TF32 off) within
   TOWER_BF16_REL_L2 (rel-L2 of the embeddings), a second bf16 call bit for
   bit, no kernel launch, and its time by CUDA events beside its bound (the
   products at the bf16 tensor peak). The fusion model's train step
   (``use_clip``; its embeddings are the tower's): K1/K2a/K2b/K3/K1bwd
   23/5/0/0/23 per step (the fusion's norm is one more K1 and K1bwd); at b8
   phase 7's gates against the plain versions; 10 b8 steps lower the loss;
   the b16 time and peak memory. Its b8 forward in both layouts against the
   plain versions at phase 4's bounds (23/5/0/0 dense, 17/3/2/3 s2d;
   22/5/0/0 without features), and f32 s2d against f32 dense. Then through
   ``cli.main`` on phase 8's dataset, from decode caches that hold the CLIP
   view (written with the loader's functions; ``clips.npy``): ``clip_unet
   embed`` (every table's rows equal a live extraction at b64 by a tower
   built anew, bit for bit), ``clip_unet train --embeddings_dir`` at b16 for
   CLIP_EPOCHS epochs (phase 9's CSV checks; ``checkpoints/epoch_N`` and
   ``best_model`` loading strictly, fusion keys included, ``meta.json`` carrying
   ``with_clip_features`` and ``clip_dim``), and ``clip_unet evaluate`` with
   the tables, with live extraction (every scalar within CLIP_TABLE_ATOL of
   the tables' run), with ``--no_clip_features`` (22/5 per forward), and in
   float32 with the kernels and with the plain versions (within 2e-3).
   Printed, not gated: the b16 step beside phase 7's b32 dense step; the
   tower's controls (TOWER_SLIPS); the recipe's overhead per step: epochs
   2-4 after their first batch against the isolated step timed as the loop
   times it (an epoch's steps back to back by the host clock), each thrice.
11. Online augmentation (``data/augment.py``, plain PyTorch: no kernel of
   its own), on b32 512² synthetic images, 16 cats and 16 dogs, uint8.
   ``sample_params`` on a CUDA generator, then ``apply_params`` on the card
   against ``apply_params`` on the CPU on the same draws (image max |error|
   AUG_IMAGE_MAX_ABS, mask agreement AUG_MASK_AGREEMENT; the pre-histogram
   values in another uint8 bin are counted), a second card call bit for bit,
   no launch of K1-K4. ``augment_and_normalize`` runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronization
   inside it) and is timed by CUDA events (median of AUG_TIMED after
   AUG_WARMUP), beside its bytes bound, its device kernels and their device
   time (``torch.profiler``) and its peak memory. Then through ``cli.main``
   on phase 8's dataset, each with ``--online_augment``: ``our_unet train``
   2 epochs at b32 (22/5/22 per step, 22/5/0 per validation forward; phase
   8's CSV and checkpoint checks; ``training_config.json`` records the
   flag), ``clip_unet train`` 2 epochs at b16 (23/5/23 per step; the tower
   once per training batch on its augmented 224² view; only the Val table is
   computed; phase 8's CSV checks), ``ae_transfer train`` 1 epoch on phase
   9's autoencoder
   (22/5/10). Printed, not gated: each recipe's time per step after its first
   batch, beside phase 7's isolated step and the runs of phases 8-10 without
   augmentation.
12. Gradient accumulation and data parallelism, ``unet_6stage`` at 512² with
   float32 parameters. (a) One b32 step as ACCUM=4 microbatches of b8
   (``make_accum_train_step``, float32 compute, kernels, cuDNN deterministic)
   against the sequential oracle with the same kernels (four plain b8
   forward and backward passes of ``batch[i::4]`` with the microbatches'
   dropout generators, gradients summed in float32, one update): loss and
   updated parameters within ACCUM_REL relative, a second call bit for bit,
   launches K1/K2a/K1bwd 88/20/88 per step. Printed, not gated: the bf16
   times and peak memory of b32 as 4 x b8 and b128 as 4 x b32, beside phase
   7's b32 step, and for one more step when the host returns from it against
   when the card finishes it (close together: bound by the host's dispatch). (b) ``cli our_unet train --grad_accum 4`` and ``cli ae_recon
   train --grad_accum 2``, one epoch each on phase 8's dataset (phase 8's CSV
   and checkpoint checks, the config's ``grad_accum``). (c) The
   ``DistributedDataParallel`` step (``parallel/mesh.py::wrap``) over NCCL at
   world size 1, the group joined by ``maybe_initialize_distributed`` from a
   torchrun-style environment, against the plain step: b8 bf16, parameters
   within DDP_REL. (d) DP_RANKS processes (this script with ``--dp-worker``)
   over gloo on the one card (NCCL refuses two ranks on one device), each
   with b8 of a global b16, float32 and dropout rates 0: each rank's updated
   parameters and global loss within DP_REL of one process's b16 step, the
   ranks equal, 22/5/22 launches each; then ``python -m
   torch.distributed.run --nproc_per_node 2 chip_smoke.py --cli-worker
   our_unet train ...`` (each rank joins over gloo and runs ``cli.main``)
   for one epoch from warm decode caches of each rank's stripe: one CSV row,
   the global ``batch_size`` in the config, each rank's 128-image stripe, and
   checkpoints that load strictly. The two gloo ranks time-slice the card, so
   their times mean nothing; a failed rank fails the phase.
13. Spatial partitioning (``parallel/spatial.py``): SP_RANKS processes (this
   script with ``--sp-worker``) over gloo on the one card, one space group,
   each rank holding half of every image's rows. (a) Float32, full-width
   ``unet_6stage`` dense at 512² b2, dropout rates 0: the spatial forward
   with the kernels (``spatial_forward``, gathered) against one process's
   forward with the kernels (rel-L2 SP_FWD_REL); the spatial step with the
   kernels (``spatial_train_step``) against one process's step (the loss
   within SP_LOSS_REL relative, the parameters, worst group rel-L2, within
   phase 7's TRAIN_F32_PLAIN_GRAD_REL: the ranks' K1 sums run in another
   order, and slopes flip as in phase 7) and against the rank's own step
   with the split K1's values differentiated as the plain version (the same
   forward and slopes; parameters within SP_PARAM_REL); the ranks'
   parameters equal. (b) Per rank, per forward and per step, K1/K2a 22/5
   and K1bwd 22, every K1 split around its all-reduce and every K1bwd
   two-pass (the split counts 22 and 22); the step with the split K1's
   values K1 22 alone; the same forward and step through the plain versions
   (K1's plain forward and backward with the space group, K2a's plain
   halo'd call): no launch. (c) In this process, the halo'd K2a
   (``upsample2x_nhwc_halo``) on two row shards of each K2a input of the b2
   forward, float32 and bf16, against the unsharded K2a: bit for bit. (e)
   ``python -m torch.distributed.run --nproc_per_node 2 chip_smoke.py
   --cli-worker our_unet train --spatial 2`` for one epoch on phase 8's
   dataset (one CSV row, ``spatial`` 2 in the config, checkpoints that load
   strictly), then ``... --cli-worker predict --spatial 2 --f32`` on
   SP_SERVE images against one process's ``cli predict``: the masks equal
   wherever one process's top logit leads the next by SP_MARGIN or more,
   with at most SP_TIE_SHARE of the pixels within it. (d) Printed beside the
   card, not gated: the bf16 step
   at SP_BIG² b1 (``unet_6stage`` with its dropout, the same generator on both
   ranks), its ms (host clock around a synchronized step, median of
   SP_BIG_STEPS after one) and each rank's peak memory, against one
   process's. The ranks time-slice the card and their collectives cross the
   host, so those times are correctness-run times; the peaks are what
   spatial partitioning is for.

14. The serving artifact (``serving/export.py``): K1's forward, K2a, K2b and
   K3 are operators, so ``torch.export`` captures each launch as one node.
   (a) ``unet_6stage`` in bf16, dense and s2d, exported on the card at b8
   (``save_exported`` -> ``load_exported``): the replay bit for bit the eager
   forward, launches 22/5/0/0 and 16/3/2/3 counted inside the operators
   while the artifact replays, the graph holding one operator node per
   launch; the eager forward with the plain versions launches none. (b) The
   same for the CLIP_UNet model (23/5) and ``autoencoder_6stage`` (22/5). (c)
   A fresh ``python -c`` process loads the dense artifact without
   ``models/`` and replays it bit for bit (22/5). (d) A float32 artifact
   against the eager forward with the plain versions at phase 4's bounds.
   (f) ``cli export`` of phase 8's ``best_model`` (b8), then ``cli predict``
   from the artifact on CLI_SERVE_IMAGES jpgs of phase 3's sizes (cv2): its
   masks byte for byte those of ``cli predict`` from the checkpoint. (g) The
   raw-data chain ``cli pipeline -> sanity_checks -> augment`` on a
   synthesized raw tree (RAW_PER_CLASS cats and dogs, RAW_TEST test images),
   which needs cv2 and PIL (see RAW_PER_CLASS). Printed, not gated: (e) the
   b128 dense artifact forward beside the eager one (CUDA events, phase 5's
   method, eager and artifact in turns), the request latency of
   ``predict_arrays`` from b1 and b8 artifacts beside the eager model (host
   clock, the two in turns, LATENCY_REPEATS each after one), each export's
   time and the artifact's size.

15. The analysis tools, ``unet_6stage`` at 512² (phase 8's ``best_model``),
   bf16 with float32 parameters unless said. It prints whether matplotlib
   and scikit-learn import (the branch each step takes). (a) ``cli our_unet
   evaluate --visualize_samples 2`` (without matplotlib: the ImportError,
   naming matplotlib and ``--visualize_samples 0``, before any launch; with
   it: the two batches' figures and the confusion matrix, the results equal
   those of ``--visualize_samples 0``, one more forward a drawn batch), beside
   ``--visualize_samples 0`` (22/5 a test forward), their wall times printed;
   then ``our_unet.eval_fns``'s probability forward at b8 float32, 22/5, held
   to the plain versions at phase 4's E2E_F32_REL_L2. (b) Grad-CAM of a test
   image, b1 512², float32 and bf16: at the first decoder block's output
   (BLOCK_TARGET) the float32 card CAM within CAM_F32_ATOL of the plain
   versions' (see CAM_F32_ATOL for the fallback); at the default target and at
   the block, each CAM in [0, 1], of its shape, bit for bit on a second call
   (cuDNN deterministic), with K1/K2a 22/5 and K1bwd 10 (default) or 8
   (block) a CAM; the ms of one default-target CAM by CUDA events. (c)
   ``utils.profiling.profile_table`` (``cli profile``) of each ``--arch``:
   the b128 forward and the b32 train step (CLIP at b16); each port
   operator's row counts its kernel's launches (K1, K2a, K1bwd), the rows'
   device time within PROFILE_BUSY_REL of the busy time, the our_unet
   forward's within PROFILE_PHASE5_REL of phase 5's; each table's top
   PROFILE_TOP rows printed. (d) The VGG16 loader on a seeded
   torchvision-layout state dict: the card's features within VGG_REL_L2 of
   the CPU's. (e) ``ae_recon evaluate --analyze_latent_space`` on phase 9's
   autoencoder (both plots and ``n`` with scikit-learn and matplotlib; else
   the ImportError before any launch). Phases 8-10 pass ``--visualize_samples
   0`` to their evaluates, and phases 9 and 12 count ``ae_recon train``'s
   snapshot forwards (one a checkpoint) where matplotlib imports.

``python3 chip_smoke.py --ab-steps ROOT LABEL=DIR ...`` is the in-call
comparison of versions: for each checkout DIR in turn (list them A, B, B, A),
phase 7's b32 dense step (10 steps by CUDA events after 3 warm-ups), the
same b32 batch as ACCUM microbatches (``make_accum_train_step``, as phase 12;
bound by the host's dispatch, so it shows a change of per-call cost first) and
phase 8's ``cli our_unet train`` for 2 epochs at b32 (epoch 2's time per
step after its first batch), from phase 8's dataset written under ROOT. The
timing program uses only the package's entry points, so it runs against an
earlier checkout as well.

``python3 chip_smoke.py --spatial-cards`` runs spatial partitioning as a user
launches it on a machine of four or more cards, one rank a card over NCCL:
``python -m torch.distributed.run --nproc_per_node N -m
unet_implementations_tpu_torch.cli our_unet train --spatial N`` for one epoch
(one space group), the same with ``--spatial N/2`` (two data ranks), and
``predict --spatial N --f32`` against one process, with phase 13's checks
and TF32 off in every process (``NVIDIA_TF32_OVERRIDE=0``).

Every forward and train step runs with the launch counts set to 0 just
before it: one with the kernels must read its counts after it, one with the
plain versions 0. The ``launches`` of the kernels line add up those counted
runs of the main paths (phases 3, 6-13, 14's replays and 15; phase 13's in
its ranks).

The last three lines are the card (as nvidia-smi reports it), a JSON line
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``; after a failed
phase the last line is ``{"ok": false, "failed": [...]}`` and the exit code 1.
"""

from __future__ import annotations

import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data import augment, loader
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch, synthetic_sample
from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels import instance_norm as k1
from unet_implementations_tpu_torch.kernels import s2d_region as k3
from unet_implementations_tpu_torch.kernels import upsample as k2
from unet_implementations_tpu_torch.kernels import winograd as k4
from unet_implementations_tpu_torch.models import blocks, convert
from unet_implementations_tpu_torch.models import clip as clip_model
from unet_implementations_tpu_torch.models.clip import ClipFeatureExtractor
from unet_implementations_tpu_torch.ops.s2d import (
    depth_to_space,
    space_to_depth,
    upsample2x_into_s2d,
)
from unet_implementations_tpu_torch.models.unet import (
    DEFAULT_FEATURES,
    S2D_LAYOUT,
    UNet,
    autoencoder_6stage,
    encoder_param_names,
    unet_6stage,
)
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.ops.resize import resize_bilinear, upsample2x_nhwc
from unet_implementations_tpu_torch.parallel import distributed
from unet_implementations_tpu_torch.parallel import mesh as dp_mesh
from unet_implementations_tpu_torch.parallel import spatial
from unet_implementations_tpu_torch.models import vgg
from unet_implementations_tpu_torch.recipes import clip_unet, our_unet
from unet_implementations_tpu_torch.recipes.common import predict_arrays
from unet_implementations_tpu_torch.serving import load_exported, save_exported
from unet_implementations_tpu_torch.training.checkpoint import (
    extract_encoder_params,
    load_checkpoint,
    restore_params,
    save_checkpoint,
)
from unet_implementations_tpu_torch.training.steps import (
    make_accum_train_step,
    make_reconstruction_train_step,
    make_segmentation_eval_step,
    make_segmentation_loss_fn,
    make_segmentation_train_step,
    microbatch_generator,
    to_device,
)
from unet_implementations_tpu_torch.training.loop import AE_CSV_HEADER, SEG_CSV_HEADER
from unet_implementations_tpu_torch.training.train_state import (
    adam_l2,
    cosine_lr,
    poly_lr,
    sgd_nesterov,
    with_frozen,
)
from unet_implementations_tpu_torch.utils import profiling
from unet_implementations_tpu_torch.utils.gradcam import DEFAULT_TARGET as DEFAULT_CAM_TARGET
from unet_implementations_tpu_torch.utils.gradcam import gradcam
from unet_implementations_tpu_torch.utils.profiling import (
    BF16_TENSOR_FLOPS_PER_S,
    F32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
)

SEED = 0
IMG = 512
# The batch of the predict path (phases 2-4) and of the timed forward (5).
SERVE_BATCH = 8
TIMED_BATCH = 128
# Level l of the 6-stage model at 512²: (side, channels).
LEVELS = [(IMG >> l, c) for l, c in enumerate(DEFAULT_FEATURES)]
# K1 calls per forward at each level: 2 per encoder stage, 2 per decoder.
K1_CALLS = [4, 4, 4, 4, 4, 2]
# K2a input shapes (side, channels), one call per dense decoder.
K2_INPUTS = [(16, 512), (32, 512), (64, 256), (128, 128), (256, 64)]
# The s2d layout: K2b inputs (side, channels) of decoder_3 and decoder_4, and
# K3 calls (block, s2d side, original channels C; the input has 4C).
K2B_INPUTS = [(128, 128), (256, 64)]
K3_CALLS = [("encoder_0", 256, 32), ("decoder_3", 128, 64), ("decoder_4", 256, 32)]
LAYOUTS = {"dense": {}, "s2d": S2D_LAYOUT}
KERNELS = ("K1", "K1bwd", "K2a", "K2b", "K3", "K4", "K4f")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# Kernel launches of one forward with the kernels, and with the plain versions.
PER_FORWARD = {"dense": {**NO_LAUNCHES, "K1": sum(K1_CALLS), "K2a": len(K2_INPUTS)},
               "s2d": {**NO_LAUNCHES, "K1": sum(K1_CALLS) - 2 * len(K3_CALLS),
                       "K2a": len(K2_INPUTS) - 2, "K2b": len(K2B_INPUTS), "K3": len(K3_CALLS)}}
# A train step takes no fused tail: every s2d block runs its module path, and
# each of its 22 norms runs K1's backward.
PER_STEP = {"dense": {**PER_FORWARD["dense"], "K1bwd": sum(K1_CALLS)},
            "s2d": {**PER_FORWARD["s2d"], "K1": sum(K1_CALLS), "K3": 0,
                    "K1bwd": sum(K1_CALLS)}}
# The s2d norms of a train step (side, channels 4C, group 4): level 0's and
# decoder_3's.
K1_S2D_NORMS = [(IMG // 2, 4 * DEFAULT_FEATURES[0]), (IMG // 4, 4 * DEFAULT_FEATURES[1])]
# K4 (phase 6): the eligible 3x3 convs of unet_6stage at b32, (conv, dense
# side, Cin, Cout); Cin and Cout multiples of 128.
K4_BATCH = 32
K4_CONVS = [("encoder_2 conv_1", 128, 128, 128), ("encoder_3 conv_1", 64, 256, 256),
            ("encoder_4 conv_1", 32, 512, 512), ("decoder_0 conv_0", 32, 1024, 512)]
K4_MODES = {"K4": False, "K4f": True}  # kernel -> _FOLDED
# The train step (phase 7): the check batch and the timed batch.
CHECK_BATCH = 8
TRAIN_BATCH = 32
TRAIN_STEPS_DOWN = 10
TIMED_STEPS, WARMUP_STEPS = 5, 2
# The recipe (phase 8): images per split and their label directory, the
# batch, and the epochs of the first run (the resume adds one). Original
# sizes are drawn per image and side from RECIPE_DIMS.
RECIPE_SPLITS = {"Train": ("resized_label", 256), "Val": ("processed_labels", 64),
                 "Test": ("processed_labels", 64)}
RECIPE_BATCH = 32
RECIPE_EPOCHS = 2
RECIPE_DIMS = (200, 500)
# The float32 evaluate with the kernels against the one with the plain
# versions: every scalar of evaluation_results.json within this (absolute).
RECIPE_EVAL_ATOL = 2e-3
# The keys of the JAX package's evaluation_results.json.
EVAL_CLASSES = ("background", "cat", "dog")
EVAL_CLASS_KEYS = ("dice", "iou", "precision", "recall")
EVAL_KEYS = ("pixel_accuracy", "mean_iou", *EVAL_CLASSES, "mean_foreground_dice")
# The AE_pretrained path (phase 9). The transfer step's K1 backwards: one per
# decoder norm, since autograd records nothing in the frozen encoder.
TRANSFER_PER_STEP = {**PER_STEP["dense"], "K1bwd": 2 * len(K2_INPUTS)}
# The float32 ae_recon evaluate with the kernels against the one with the
# plain versions: mse, psnr and ssim within this (relative).
AE_EVAL_REL = 2e-3
# The keys of the JAX package's reconstruction_metrics.json.
AE_METRIC_KEYS = ("mse", "psnr", "ssim", "num_images")
# The CLIP_UNet path (phase 10): the fusion's InstanceNorm+LeakyReLU at the
# bottleneck is one more K1 per forward and one more K1bwd per train step.
CLIP_PER_FORWARD = {layout: {**fwd, "K1": fwd["K1"] + 1} for layout, fwd in PER_FORWARD.items()}
CLIP_PER_STEP = {layout: {**step, "K1": step["K1"] + 1, "K1bwd": step["K1bwd"] + 1}
                 for layout, step in PER_STEP.items()}
# The recipe's batch (JAX's and the reference's default), the tower's
# batch (``clip_unet embed``'s default) and its input side.
CLIP_BATCH = 16
TOWER_BATCH = 64
TOWER_SIDE = 224
# The bf16 tower against the float32 tower (TF32 off) on the same weights
# and images: rel-L2 of the (B, 512) embeddings at most this. The residual
# stream and the LayerNorms stay float32; every product and the attention
# round to bf16 (unit roundoff 2^-9 = 2e-3) and 12 blocks add their errors.
# On an H100 (80GB HBM3, 700 W) three runs read 5.518e-3, and two controls,
# each a precision slip that Flax's numerics rule out (TOWER_SLIPS), read
# 8.119e-3 (the residual stream kept in bf16) and 6.160e-3 (the LayerNorms
# in bf16): the bound sits between the tower and the first control, so a
# bf16 residual stream fails; the LayerNorm slip stays under any bound that
# leaves the tower room. A tower wrong as a whole (a head split, the q
# scale, the token order) reads near 1.
TOWER_BF16_REL_L2 = 7e-3
# The evaluate with the embedding tables against the one with live
# extraction: every scalar within this (absolute). The tables were computed
# at the tower's batch (64), the live features at the recipe's (16): bf16
# products of another shape may round otherwise.
CLIP_TABLE_ATOL = 2e-3
# The clip_unet recipe's epochs: epochs 2-4 each give one reading of its
# time per step after the first batch, against as many readings of the
# isolated step over an epoch's steps by the host clock (OVERHEAD_REPEATS).
CLIP_EPOCHS = 4
OVERHEAD_REPEATS = 3
# Online augmentation (phase 11): the batch held card against CPU and timed,
# and its gates. The stages ahead of the histogram's uint8 truncation are
# elementwise float32 in a fixed order on both, so the pre-histogram pixels
# should match bit for bit; what follows (the LUTs' cumulative sums, the
# blur's exponentials) differs by float32 roundings of values in [0, 1].
AUG_BATCH = 32
AUG_IMAGE_MAX_ABS = 1e-4
AUG_MASK_AGREEMENT = 0.999
# Gradient accumulation and data parallelism (phase 12). The accumulated
# step: b32 as ACCUM microbatches of b8 against the sequential oracle (float32,
# relative ACCUM_REL), and b128 as ACCUM x b32, timed. The DDP step at world
# size 1 over NCCL against the plain step (DDP_REL), and DP_RANKS gloo ranks
# on the one card, each with b8 of a global b16, against one process's b16
# step (DP_REL). NCCL refuses two ranks on one device, so the two ranks speak
# gloo (the card's tensors cross the host); their times mean nothing.
ACCUM = 4
ACCUM_REL = 1e-4
ACCUM_BIG_BATCH = 4 * TRAIN_BATCH
ACCUM_TIMED, ACCUM_WARMUP = 3, 1
DDP_REL = 1e-6
DP_RANKS = 2
DP_BATCH = 16
DP_REL = 1e-4
DP_TIMEOUT_S = 420
# Spatial partitioning (phase 13): SP_RANKS gloo ranks on the one card, one
# space group. (a) float32, b2 at 512², against one process with the same
# kernels: the forward's rel-L2 and the step's loss (relative). A rank's K1
# sums its half's chunks, then the halves: another order than one process's,
# so pre-activations within a float32 rounding of zero take the other slope
# and the gradients jump, as in phase 7. On an H100 (80GB HBM3, 700 W) it read
# 6.544e-3 (worst group, an InstanceNorm bias at level 4, whose update from 0
# is its gradient) against one process's step, so that comparison takes phase 7's
# TRAIN_F32_PLAIN_GRAD_REL; SP_PARAM_REL holds the step against the rank's
# own step with the split K1's values and the plain backward (the same
# slopes), as phase 7's TRAIN_F32_GRAD_REL does. (d) the bf16 step at SP_BIG²
# b1, timed over SP_BIG_STEPS steps after one. (e) the served masks: equal
# where one process's top-two logit margin is at least SP_MARGIN; within it,
# at most SP_TIE_SHARE of the pixels.
SP_RANKS = 2
SP_BATCH = 2
SP_FWD_REL = 1e-4
SP_LOSS_REL = 1e-5
SP_PARAM_REL = 1e-4
SP_BIG = 2048
SP_BIG_STEPS = 3
SP_SERVE = 4
SP_MARGIN = 1e-3
SP_TIE_SHARE = 1e-3
# Per rank, of a forward and of a step: every K1 split, every K1bwd two-pass.
SP_SPLIT = {"K1 split": sum(K1_CALLS), "K1bwd split": sum(K1_CALLS)}
# One checkout's run of ``--ab-steps`` (its kernels' build included).
AB_TIMEOUT_S = 600
PER_ACCUM_STEP = {k: v * ACCUM for k, v in PER_STEP["dense"].items()}
AUG_TIMED, AUG_WARMUP = 5, 2

# Original sizes of the eight images of a request batch.
SIZES = [(375, 500), (512, 512), (240, 320), (500, 333), (64, 96), (1024, 768),
         (300, 300), (181, 257)]
# Tolerances of the kernel checks (K2 is bitwise). K1 sums in float32 in
# another order than the plain version: float32 outputs move by well under
# 1e-4 (sums of up to 2^18 terms). In bf16 that same float32 difference can
# tip the final rounding to the neighbouring bf16 value, so a bf16 output may
# differ by one bf16 ulp at its value plus the float32 tolerance (the latter
# matters only near zero, where an ulp is tiny).
K1_F32_TOL = 1e-4
K1_BF16_ULPS = 1.0
# K1bwd against the plain backward on the same inputs and statistics: dx,
# dscale and dbias within K1_F32_TOL of their largest magnitude in float32
# (sum orders, and the kernel's factored sums: it adds dpre and multiplies by
# scale once per channel, where the plain version adds dpre·scale rounded per
# element); in bf16, dx within K1_BF16_ULPS plus K1_F32_TOL (the float32
# difference may tip the rounding), dscale and dbias (float32) as in float32.
# Forward bounds (phases 3-5). The forward in float32 (TF32 off,
# deterministic cuDNN) differs between kernels and plain versions only by
# K1's sum order, so its logits agree to E2E_F32_REL_L2 and its argmax to
# E2E_F32_AGREEMENT. In bf16 each of the 22 norms may round some outputs the
# other way, and the network carries those one-ulp flips to the logits like
# any other bf16 rounding; the bf16 path with kernels is therefore held to the
# float32 plain forward no worse than the bf16 path with plain versions is,
# within E2E_BF16_SLACK (relative) on rel-L2 and E2E_BF16_AGREEMENT_SLACK on
# argmax agreement.
E2E_F32_REL_L2 = 1e-4
E2E_F32_AGREEMENT = 0.999
E2E_BF16_SLACK = 0.25
E2E_BF16_AGREEMENT_SLACK = 0.005
# K3 against its plain version. float32: 1e-4 (rtol and atol), from the sum
# orders of the statistics and of the conv. bfloat16, elementwise: the conv
# sums in another order than cuDNN, so a conv output may round one bf16 ulp
# the other way, and IN2 carries that ulp into the result scaled by
# |scale2 · rstd2| (``_torch_tail(carried_ulp=True)`` gives it per element);
# the result may then round once more the other way, and K1's apply pass
# activates before it rounds (one more): two bf16 ulps of the result plus the
# carried conv ulp plus 1e-4. IN1's statistics, summed in another order, also
# round a few conv inputs the other way; a conv output near zero can then
# move by more than its own ulp. So at most K3_BF16_OUTLIER_SHARE of the
# elements may exceed the elementwise bound, and the kernel must be as close
# to the float32 computation of the same function on the same bf16 values as
# the plain version is: max and mean |error| within E2E_BF16_SLACK of the
# plain version's.
K3_F32_TOL = 1e-4
K3_BF16_ULPS = 2.0
K3_BF16_OUTLIER_SHARE = 1e-4
# K4 in float32 (TF32 off): max |error| / max |reference| of the forward and
# of dx, dW and db, against the plain version and against the direct conv
# (the tolerance of tests/test_winograd.py: Winograd reassociates the sums).
# In bf16 the kernel transforms in float32 and rounds once where the plain
# version (as JAX) rounds after each add, so both are held to the float32
# direct conv: the kernel's rel-L2 within E2E_BF16_SLACK of the plain one's.
K4_F32_TOL = 1e-4
# And in bf16 the kernel's rel-L2 to the float32 direct conv, y and dx, at
# most this: a transform in float32 rounded once reads 4.28e-3 to 4.32e-3 at
# these shapes (PERF.md), the plain version about 5e-3.
K4_BF16_REL_L2 = 4.8e-3
# The bf16 kernels, as their mangled names show in nvcc's report.
K4_BF16_KERNEL = "winograd_s2d_wgmma_kernel"
K3_BF16_KERNEL = "s2d_conv_wgmma_kernel"
# The train step at b8 in float32 (TF32 off, deterministic cuDNN). The loss
# with the kernels against the plain versions: TRAIN_F32_LOSS_REL. Gradients
# are compared per group: each parameter alone, except that a conv followed
# by InstanceNorm goes with its bias, whose exact gradient is zero (the norm
# removes it) and whose computed gradient is rounding noise.
#
# Against the plain step, the gradients cannot meet 1e-4: K1 sums in another
# order than the plain version, a pre-activation within a float32 rounding of
# zero then takes the other slope of the LeakyReLU, and its gradient jumps.
# A plain step whose K1 sums run over the flipped input (``k1_reordered``,
# logged in every run) shows how far the order alone moves them: worst group
# 3.416e-3 dense, 5.718e-3 s2d, where the step with the kernels read 3.479e-3
# and 4.806e-3 (H100 80GB HBM3, 700 W; the same in three runs of this
# script). TRAIN_F32_PLAIN_GRAD_REL sits 2.6x above the larger reading; a
# backward that is wrong as a whole reads more, but one that is a little off
# may not. So the gradients are also gated at TRAIN_F32_GRAD_REL against a
# step whose K1 outputs and statistics are the kernel's values,
# differentiated as the plain version (autograd through its ops): the same
# forward and the same slopes, so the two differ only by the backward's
# arithmetic (K1's backward kernel against autograd of the plain ops, K2's
# transpose against autograd of the plain lerps).
#
# In bf16 the step with the kernels must be no further from the float32
# plain step than the bf16 plain step is, within E2E_BF16_SLACK.
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_PLAIN_GRAD_REL = 1.5e-2
TRAIN_F32_GRAD_REL = 1e-4
# Timed calls cycle through copies of their input that together hold at
# least this many times the card's L2, so no call reads its input from L2.
L2_MULTIPLE = 4

failures: list[str] = []
report: dict = {"err": dict.fromkeys(KERNELS, 0.0), "path_launches": dict.fromkeys(KERNELS, 0),
                "rows": {}, "bound_by": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    def wrap(fn):
        def run(*args, **kwargs):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except Exception:
                failures.append(name)
                log(f"!! phase failed: {name}\n{traceback.format_exc()}")
                return None
            finally:
                log(f"   ({time.perf_counter() - t0:.1f} s)")
        return run
    return wrap


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


WRAPPERS = {"K1": k1.fused_instance_norm, "K2a": k2.upsample2x_nhwc_fast,
            "K2b": k2.upsample2x_into_s2d_fast, "K3": k3.fused_s2d_tail}


def launches() -> dict:
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts["K1bwd"] = k1.fused_instance_norm.backward_launches
    counts["K4"] = k4.winograd_conv_s2d.launches
    counts["K4f"] = k4.winograd_conv_s2d.launches_folded
    return counts


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    k1.fused_instance_norm.backward_launches = 0
    k1.fused_instance_norm.split_launches = 0
    k1.fused_instance_norm.split_backward_launches = 0
    k4.winograd_conv_s2d.launches = 0
    k4.winograd_conv_s2d.launches_folded = 0


def add_path_launches() -> None:
    """Add the counts read now, just after a run of a main path that started
    with them at 0, to the kernels line's launches."""
    for name, n in launches().items():
        report["path_launches"][name] += n


def counted(fn, expected: dict):
    """``fn()`` with the launch counts set to 0 just before it; fails unless
    they read ``expected`` just after."""
    reset_launches()
    out = fn()
    if launches() != expected:
        raise AssertionError(f"expected launches {expected}, got {launches()}")
    return out


def counted_path(fn, expected: dict):
    """``counted`` for a run of a main path: its counts go into the kernels
    line."""
    out = counted(fn, expected)
    add_path_launches()
    return out


def times(expected: dict, n: int) -> dict:
    return {k: v * n for k, v in expected.items()}


class _SpaceK1(torch.autograd.Function):
    """K1 on row shards (a space group) under one autograd node whose backward
    is the plain version (``_torch_backward``, its sums all-reduced): the
    forward is the plain version too (the wrapper's route for CPU tensors, on
    the card), or with ``kernel`` the split kernel's values (one launch)."""

    @staticmethod
    def forward(ctx, x, s, b, eps, slope, group, space_group, kernel):
        run = k1._cuda_forward if kernel else k1._torch_forward
        y, mean, rstd = run(x, s, b, eps, slope, group, space_group)
        ctx.save_for_backward(x, s, b, mean, rstd)
        ctx.args = (slope, group, space_group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, ds, db = k1._torch_backward(*ctx.saved_tensors, dy, *ctx.args)
        return dx, ds, db, None, None, None, None, None


def k1_plain(x, s, b, eps, slope, group=1, space_group=None):
    if space_group is not None:
        return _SpaceK1.apply(x, s, b, eps, slope, group, space_group, False)
    return k1._torch_forward(x, s, b, eps, slope, group)[0]


def k2_halo_plain(x, above, below):
    """The plain version of ``upsample2x_nhwc_halo``."""
    return upsample2x_nhwc(torch.cat([above, x, below], dim=1))[:, 2:2 * x.shape[1] + 2]


class _Values(torch.autograd.Function):
    """``values`` in the forward, the gradient of ``differentiable`` in the
    backward."""

    @staticmethod
    def forward(ctx, differentiable, values):
        return values.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def k1_kernel_values(x, s, b, eps, slope, group=1, space_group=None):
    """K1's output, mean and rstd (one launch), differentiated as the plain
    version: its op sequence with the kernel's statistics in value, so the
    LeakyReLU takes the slope K1's backward takes at every element. On row
    shards (``space_group``): the split kernel's values under one node whose
    backward is the plain one."""
    if space_group is not None:
        return _SpaceK1.apply(x, s, b, eps, slope, group, space_group, True)
    with torch.no_grad():
        y_k, mean_k, rstd_k = k1._cuda_forward(x, s, b, eps, slope, group)
    _, mean, rstd = k1._torch_forward(x, s, b, eps, slope, group)
    mean, rstd = _Values.apply(mean, mean_k), _Values.apply(rstd, rstd_k)
    y = (x.to(torch.float32) - mean[:, None, None, :]) * rstd[:, None, None, :]
    y = y * s.to(torch.float32).repeat(group) + b.to(torch.float32).repeat(group)
    y = torch.where(y >= 0, y, y * slope).to(x.dtype)
    return _Values.apply(y, y_k)


def k1_reordered(x, s, b, eps, slope, group=1, space_group=None):
    """The plain version with its sums over the spatially flipped input: the
    same function, its float32 sums in another order."""
    return k1_plain(x.flip((1, 2)), s, b, eps, slope, group, space_group).flip((1, 2))


@contextmanager
def plain_versions(k1_version=k1_plain):
    """Route the model's blocks through the plain PyTorch versions (K1
    through ``k1_version``)."""
    names = ("fused_instance_norm", "upsample2x_nhwc_fast", "upsample2x_into_s2d_fast",
             "fused_s2d_tail", "upsample2x_nhwc_halo")
    saved = [getattr(blocks, name) for name in names]
    plain = (k1_version, upsample2x_nhwc, upsample2x_into_s2d, k3._torch_tail, k2_halo_plain)
    for name, fn in zip(names, plain):
        setattr(blocks, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(blocks, name, fn)


@contextmanager
def deterministic():
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def bf16_ulps_map(a: torch.Tensor, b: torch.Tensor, atol=0.0) -> torch.Tensor:
    """max(|a - b| - atol, 0) in units of the bf16 spacing at max(|a|, |b|),
    per element; ``atol`` a number or a tensor like a."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    excess = ((a - b).abs() - atol).clamp_min(0.0)
    return excess / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol=0.0) -> float:
    return float(bf16_ulps_map(a, b, atol).max())


def check_k1(x, scale, bias, group: int = 1) -> str:
    """K1 against its plain version on the same inputs; fails beyond the tolerance."""
    got = counted(lambda: k1.fused_instance_norm(x, scale, bias, 1e-5, 0.01, group),
                  one_launch("K1"))
    want = k1._torch_forward(x, scale, bias, 1e-5, 0.01, group)[0]
    err = float((got.float() - want.float()).abs().max())
    report["err"]["K1"] = max(report["err"]["K1"], err)
    if x.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=K1_F32_TOL, atol=K1_F32_TOL)
        detail = f"max_abs_err {err:.3e} (tol {K1_F32_TOL:g})"
    else:
        ulps = bf16_ulps(got, want, K1_F32_TOL)
        ok = ulps <= K1_BF16_ULPS
        detail = (f"max_abs_err {err:.3e}, max {bf16_ulps(got, want):.0f} bf16 ulp; "
                  f"beyond {K1_F32_TOL:g}: {ulps:.0f} ulp (tol 1 ulp + {K1_F32_TOL:g})")
    label = f"K1 {tuple(x.shape)} {str(x.dtype)[6:]} group {group}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def one_launch(kernel: str) -> dict:
    return {**NO_LAUNCHES, kernel: 1}


def k1_bwd_inputs(b: int, side: int, c: int, dtype, group: int = 1, seed: int = SEED):
    """x, scale, bias, the forward's mean and rstd (from the kernel), and dy."""
    x, scale, bias = k1_inputs(b, side, c, dtype, group, seed)
    with torch.no_grad():
        _, mean, rstd = k1._cuda_forward(x, scale, bias, 1e-5, 0.01, group)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    return x, scale, bias, mean, rstd, dy


def check_k1_bwd(args, group: int = 1) -> str:
    """K1bwd against the plain backward on the same inputs and statistics;
    fails beyond the tolerances (K1_F32_TOL of the max; K1_BF16_ULPS + K1_F32_TOL
    for bf16 dx), or unless a second call repeats the first bit for bit."""
    x = args[0]
    got = counted(lambda: k1._cuda_backward(*args, 0.01, group), one_launch("K1bwd"))
    want = k1._torch_backward(*args, 0.01, group)
    errs = {name: rel_of_max(g, w) for name, g, w in zip(("dx", "dscale", "dbias"), got, want)}
    report["err"]["K1bwd"] = max(report["err"]["K1bwd"],
                                 float((got[0].float() - want[0].float()).abs().max()))
    ok = all(errs[k] <= K1_F32_TOL for k in ("dscale", "dbias"))
    detail = ", ".join(f"{k} {v:.2e} of max" for k, v in errs.items())
    if x.dtype == torch.float32:
        ok = ok and errs["dx"] <= K1_F32_TOL
        detail += f" (tol {K1_F32_TOL:g})"
    else:
        ulps = bf16_ulps(got[0], want[0], K1_F32_TOL)
        ok = ok and ulps <= K1_BF16_ULPS
        detail += (f"; dx max {bf16_ulps(got[0], want[0]):.0f} bf16 ulp, beyond {K1_F32_TOL:g}: "
                   f"{ulps:.0f} ulp (tol 1 ulp + {K1_F32_TOL:g}; dscale, dbias {K1_F32_TOL:g})")
    # No atomic touches a sum: a second call repeats the first bit for bit.
    repeats = all(torch.equal(a, b) for a, b in zip(got, k1._cuda_backward(*args, 0.01, group)))
    ok = ok and repeats
    plan = k1.bwd_plan(x.shape[0], x.shape[1] * x.shape[2], x.shape[3], group, x.element_size(),
                       *_build.device_limits(x.device.index))
    detail += (f"; a second call {'repeats bit for bit' if repeats else 'DIFFERS'}; "
               f"{'fused' if plan.fused else 'two-pass'}")
    label = f"K1bwd {tuple(x.shape)} {str(x.dtype)[6:]} group {group}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def check_k2(x, s2d: bool = False) -> str:
    """K2a (or K2b) against its plain version on the same input; fails unless
    bitwise equal."""
    kernel = "K2b" if s2d else "K2a"
    fast, plain = ((k2.upsample2x_into_s2d_fast, upsample2x_into_s2d) if s2d
                   else (k2.upsample2x_nhwc_fast, upsample2x_nhwc))
    got = counted(lambda: fast(x), one_launch(kernel))
    want = plain(x)
    err = float((got.float() - want.float()).abs().max())
    report["err"][kernel] = max(report["err"][kernel], err)
    label = f"{kernel} {tuple(x.shape)} {str(x.dtype)[6:]}"
    if not torch.equal(got, want):
        raise AssertionError(f"{label} differs from its plain version (max_abs_err {err:.3e})")
    return f"{label}: bitwise equal ({tuple(got.shape)}, {got.numel()} elements)"


def check_k3(args, label: str) -> str:
    """K3 against its plain version on the same inputs; fails beyond the
    tolerances (K3_F32_TOL; K3_BF16_ULPS, K3_BF16_OUTLIER_SHARE and the
    float32 comparison for bf16)."""
    x = args[0]
    got = counted(lambda: k3.fused_s2d_tail(*args), one_launch("K3"))
    want, carried = k3._torch_tail(*args, 1e-5, 0.01, carried_ulp=True)
    err = float((got.float() - want.float()).abs().max())
    report["err"]["K3"] = max(report["err"]["K3"], err)
    if x.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=K3_F32_TOL, atol=K3_F32_TOL)
        detail = f"max_abs_err {err:.3e} (tol {K3_F32_TOL:g})"
    else:
        ulps = bf16_ulps_map(got, want, carried + K3_F32_TOL)
        share = float((ulps > K3_BF16_ULPS).float().mean())
        ref = k3._torch_tail(x.float(), *args[1:], 1e-5, 0.01)
        e_k, e_p = (got.float() - ref).abs(), (want.float() - ref).abs()
        max_k, max_p, mean_k, mean_p = (float(e_k.max()), float(e_p.max()), float(e_k.mean()),
                                        float(e_p.mean()))
        ok = (share <= K3_BF16_OUTLIER_SHARE and max_k <= max_p * (1 + E2E_BF16_SLACK)
              and mean_k <= mean_p * (1 + E2E_BF16_SLACK))
        detail = (f"max_abs_err {err:.3e}, max {bf16_ulps(got, want):.2f} bf16 ulp; beyond 2 ulp "
                  f"+ carried conv ulp + {K3_F32_TOL:g}: {share:.2e} of elements (tol "
                  f"{K3_BF16_OUTLIER_SHARE:g}), at most {float(ulps.max()):.2f} ulp; |error| "
                  f"against float32, kernel/plain: max {max_k:.4e}/{max_p:.4e}, mean "
                  f"{mean_k:.4e}/{mean_p:.4e} (slack {E2E_BF16_SLACK:g})")
        del ref, e_k, e_p, ulps
        # No atomics anywhere in the tail: a second call repeats bit for bit.
        repeats = torch.equal(got, k3.fused_s2d_tail(*args))
        ok = ok and repeats
        detail += f"; a second call {'repeats bit for bit' if repeats else 'DIFFERS'}"
    label = f"K3 {label} {tuple(x.shape)} {str(x.dtype)[6:]}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def check_forwards(served, reference, x: torch.Tensor, per_forward: dict,
                   agreement: bool = True, path: bool = False) -> dict:
    """The bf16 and float32 models with the kernels and with the plain
    versions on the same input ``x``; fails unless the bounds are met. Returns
    the rel-L2 and argmax agreement of each pair, and the float32 outputs with
    the kernels. ``agreement``: gate the argmax agreement too (logits; not
    for reconstructions). ``path``: the runs with the kernels count in the
    kernels line."""
    count = counted_path if path else counted
    with deterministic(), torch.inference_mode():
        out = {"bf16": count(lambda: served(x), per_forward),
               "bf16 again": count(lambda: served(x), per_forward),
               "f32": count(lambda: reference(x), per_forward)}
        with plain_versions():
            out["bf16 plain"] = counted(lambda: served(x), NO_LAUNCHES)
            out["f32 plain"] = counted(lambda: reference(x), NO_LAUNCHES)

    pairs = [("bf16", "bf16 plain"), ("f32", "f32 plain"), ("bf16", "f32 plain"),
             ("bf16 plain", "f32 plain")]
    e2e = {f"{a} vs {b}": compare(out[a], out[b]) for a, b in pairs}
    for name, (r, a) in e2e.items():
        log(f"{name}: logits rel-L2 {r:.4e}, argmax agreement {a:.6f}")
    repeat = torch.equal(out["bf16"], out["bf16 again"])
    log(f"bf16 forward repeats bit for bit: {repeat}")
    f32_r, f32_a = e2e["f32 vs f32 plain"]
    (k_r, k_a), (p_r, p_a) = e2e["bf16 vs f32 plain"], e2e["bf16 plain vs f32 plain"]
    checks = {
        "finite": all(bool(torch.isfinite(v).all()) for v in out.values()),
        "repeat": repeat,
        "f32 rel-L2": f32_r <= E2E_F32_REL_L2,
        "f32 agreement": f32_a >= E2E_F32_AGREEMENT or not agreement,
        "bf16 rel-L2 vs f32": k_r <= p_r * (1 + E2E_BF16_SLACK),
        "bf16 agreement vs f32": k_a >= p_a - E2E_BF16_AGREEMENT_SLACK or not agreement,
    }
    log(f"bounds: f32 rel-L2 <= {E2E_F32_REL_L2:g}, agreement >= {E2E_F32_AGREEMENT:g}; "
        f"bf16 rel-L2 to f32 plain <= {p_r * (1 + E2E_BF16_SLACK):.4e}, agreement to f32 "
        f"plain >= {p_a - E2E_BF16_AGREEMENT_SLACK:.6f}; {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the forward with kernels misses its bounds: {checks}")
    return {"pairs": e2e, "f32": out["f32"]}


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """Logits rel-L2 of a against b, and the share of equal argmaxes."""
    return (float((a - b).norm() / b.norm()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def check_layouts_agree(f32_s2d: torch.Tensor, f32_dense: torch.Tensor, label: str,
                        agreement: bool = True) -> tuple:
    """The float32 s2d forward against the float32 dense forward on the same
    weights and input: the layout is an exact rewrite, so the bounds of the
    float32 kernel checks hold (the argmax agreement only with
    ``agreement``)."""
    r, a = compare(f32_s2d, f32_dense)
    ok = r <= E2E_F32_REL_L2 and (a >= E2E_F32_AGREEMENT or not agreement)
    log(f"{label} f32 s2d vs f32 dense (kernels, TF32 off): logits rel-L2 {r:.4e}, argmax "
        f"agreement {a:.6f} (bounds {E2E_F32_REL_L2:g}, {E2E_F32_AGREEMENT:g}): {ok}")
    if not ok:
        raise AssertionError(f"the f32 s2d forward is not the dense one: {r:.4e}, {a:.6f}")
    return r, a


def cuda_times(fn, inputs: list, iters: int, warmup: int = 2) -> list[float]:
    """Milliseconds of each of ``iters`` back-to-back calls ``fn(input)`` on
    the card (a pair of CUDA events around each), cycling through ``inputs``."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    for i, (start, end) in enumerate(events):
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def spread(ms: list[float]) -> str:
    return f"median {statistics.median(ms):.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, n {len(ms)})"


def n_copies(nbytes: int) -> int:
    """Copies of an input of ``nbytes`` that together hold L2_MULTIPLE x L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, -(-L2_MULTIPLE * l2 // nbytes))


def k1_inputs(b: int, side: int, c: int, dtype, group: int = 1, seed: int = SEED):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, side, side, c), generator=g, device="cuda") * 2 + 0.5).to(dtype)
    cg = c // group
    scale = torch.randn(cg, generator=g, device="cuda") * 0.5 + 1.0
    bias = torch.randn(cg, generator=g, device="cuda") * 0.3
    return x, scale, bias


def k2_input(b: int, side: int, c: int, seed: int = SEED, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, side, side, c), generator=g, device="cuda").to(dtype)


def k3_inputs(b: int, side: int, c: int, dtype, seed: int = SEED):
    """conv_0's output (B, side, side, 4C) and the tail's parameters."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (randn(b, side, side, 4 * c) * 2 + 0.5).to(dtype)
    return (x, randn(c) * 0.25 + 1.0, randn(c) * 0.1, randn(c, c, 3, 3) * (2 / (9 * c)) ** 0.5,
            randn(c) * 0.25 + 1.0, randn(c) * 0.1)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(by_bytes: float, by_ops: float) -> tuple[float, str]:
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# The bytes and operations of each kernel come from its module, where the
# cost table of ``utils/profiling.py`` reads them too.
def k1_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    return bound(bytes_ms(k1.forward_bytes(x.shape, x.element_size())),
                 k1.forward_operations(x.shape) / F32_FLOPS_PER_S * 1e3)


def k1_bwd_bound_ms(x: torch.Tensor, group: int = 1) -> tuple[float, str]:
    return bound(bytes_ms(k1.backward_bytes(x.shape, x.element_size(), group)),
                 k1.backward_operations(x.shape) / F32_FLOPS_PER_S * 1e3)


def k2_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    return bound(bytes_ms(k2.upsample_bytes(x.shape, x.element_size())),
                 k2.upsample_operations(x.shape) / F32_FLOPS_PER_S * 1e3)


def k3_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    """The conv's multiply-adds run on the tensor cores (bf16) beside the
    norms' float32 operations on the CUDA cores: the slower of the two."""
    by_ops = max(k3.tail_conv_flops(x.shape) / BF16_TENSOR_FLOPS_PER_S,
                 k3.tail_norm_operations(x.shape) / F32_FLOPS_PER_S) * 1e3
    return bound(bytes_ms(k3.tail_bytes(x.shape, x.element_size())), by_ops)


def k3_conv_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    """K3's conv launch alone: one read of x and one write of its output, or
    its multiply-adds at the bf16 tensor rate."""
    return bound(bytes_ms(k3.tail_bytes(x.shape, x.element_size())),
                 k3.tail_conv_flops(x.shape) / BF16_TENSOR_FLOPS_PER_S * 1e3)


def time_k3_conv(args) -> list[float]:
    """Times of K3's conv launch alone (``conv_only``), on IN1's statistics
    that one full launch left in the buffers; fails unless it writes what the
    full launch's conv wrote."""
    x = args[0]
    w = k3.kernel_weights(args[3], x.dtype)
    buffers = k3.tail_buffers(x)
    k3.launch_tail(x, *args[1:3], w, *args[4:], buffers, 1e-5, 0.01)
    full = buffers["y_conv"].clone()
    buffers["y_conv"].zero_()
    t = cuda_times(lambda a: k3.launch_tail(a, *args[1:3], w, *args[4:], buffers, 1e-5, 0.01,
                                            conv_only=True), [x], iters=10)
    if not torch.equal(full, buffers["y_conv"]):
        raise AssertionError("K3's conv launch alone wrote another y_conv than the full launch")
    return t


@phase("1. card and build")
def phase_build():
    report["card"] = nvidia_smi_card()
    log(f"nvidia-smi: {report['card']}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if line.startswith("[nvcc") or "ptxas info" in line and (
                "Used" in line or "spill" in line or "Compiling entry" in line):
            log(f"   {line.strip()}")
    log(f"{K3_BF16_KERNEL} (K3's bf16 conv):")
    check_no_spills(K3_BF16_KERNEL)


@phase(f"2. kernels against their plain versions (b{SERVE_BATCH}, main-path shapes)")
def phase_kernels():
    b = SERVE_BATCH
    with torch.inference_mode():
        for side, c in LEVELS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1(*k1_inputs(b, side, c, dt)))
        # Level 0 in the space-to-depth layout.
        log(check_k1(*k1_inputs(b, IMG // 2, 4 * DEFAULT_FEATURES[0], torch.bfloat16, 4), 4))
        # K1bwd at the b8 train step's shapes: each dense level, and the s2d norms.
        for side, c in LEVELS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1_bwd(k1_bwd_inputs(b, side, c, dt)))
        for side, c in K1_S2D_NORMS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1_bwd(k1_bwd_inputs(b, side, c, dt, 4), 4))
        torch.cuda.empty_cache()
        for side, c in K2_INPUTS:
            log(check_k2(k2_input(b, side, c, seed=side)))
        for side, c in K2B_INPUTS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k2(k2_input(b, side, c, seed=side, dtype=dt), s2d=True))
        with deterministic():
            for i, (block, side, c) in enumerate(K3_CALLS):
                for dt in (torch.bfloat16, torch.float32):
                    log(check_k3(k3_inputs(b, side, c, dt, seed=SEED + i), block))


def serve_layout(layout: str, path: Path, batches: list, seed_model) -> None:
    """Load the ``.pth`` in ``layout``, answer the request batches with the
    kernels (checking the launch counts), then with the plain versions and by
    the float32 model, and hold the masks to the bounds of phase 4."""
    per_forward = PER_FORWARD[layout]
    served = convert.load_reference_checkpoint(path, device="cuda", dtype=torch.bfloat16,
                                               **LAYOUTS[layout])
    for (name, a), b in zip(seed_model.state_dict().items(), served.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"reloaded weight differs: {name}")
    reference = unet_6stage(dtype=torch.float32, device="cuda", **LAYOUTS[layout])
    reference.load_state_dict(served.state_dict())
    reference.eval()
    report["models"][layout] = served, reference

    def serve(m):
        return [predict_arrays(m, images, SIZES) for images in batches]

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = serve(served)
    elapsed = time.perf_counter() - t0
    report["launches"][layout] = launches()
    add_path_launches()
    log(f"{layout}: 3 batches of {SERVE_BATCH} answered in {elapsed * 1e3:.1f} ms (host clock, "
        f"first calls included); launches {report['launches'][layout]}")
    for masks in results:
        for mask, size in zip(masks, SIZES):
            if mask.shape != size or mask.dtype != np.uint8:
                raise AssertionError(f"mask {mask.shape} {mask.dtype} for original size {size}")
            if not set(np.unique(mask)) <= {0, 1, 2}:
                raise AssertionError(f"mask values {np.unique(mask)} outside {{0,1,2}}")
    flat = {"bf16": np.concatenate([mask.ravel() for ms in results for mask in ms])}
    log(f"{layout}: mask class counts {np.bincount(flat['bf16'], minlength=3).tolist()}")
    if report["launches"][layout] != times(per_forward, len(batches)):
        raise AssertionError(f"expected {times(per_forward, len(batches))} launches, "
                             f"got {report['launches'][layout]}")

    # The same requests with the plain versions and by the float32 model.
    for name, m, plain in (("bf16 plain", served, True), ("f32", reference, False),
                           ("f32 plain", reference, True)):
        with deterministic(), plain_versions() if plain else nullcontext():
            masks = counted(lambda: serve(m),
                            NO_LAUNCHES if plain else times(per_forward, len(batches)))
        flat[name] = np.concatenate([mask.ravel() for ms in masks for mask in ms])

    def agree(a, b):
        return float((flat[a] == flat[b]).mean())

    f32_a, k_a, p_a = (agree("f32", "f32 plain"), agree("bf16", "f32 plain"),
                       agree("bf16 plain", "f32 plain"))
    report["mask_agreement"][layout] = {
        "f32 vs f32 plain": f32_a, "bf16 vs f32 plain": k_a, "bf16 plain vs f32 plain": p_a,
        "bf16 vs bf16 plain": agree("bf16", "bf16 plain")}
    report["masks"][layout] = flat
    for name, a in report["mask_agreement"][layout].items():
        log(f"{layout}: masks {name}: agreement {a:.6f}")
    checks = {"f32 agreement": f32_a >= E2E_F32_AGREEMENT,
              "bf16 agreement vs f32": k_a >= p_a - E2E_BF16_AGREEMENT_SLACK}
    log(f"{layout}: bounds: f32 agreement >= {E2E_F32_AGREEMENT:g}, bf16 agreement to f32 "
        f"plain >= {p_a - E2E_BF16_AGREEMENT_SLACK:.6f}; {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the served masks with kernels miss their bounds: {checks}")


@phase("3. the slice: reference .pth -> load_reference_checkpoint -> predict_arrays")
def phase_slice():
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (SERVE_BATCH, IMG, IMG, 3), dtype=np.uint8)
               for _ in range(3)]
    report.update(models={}, launches={}, mask_agreement={}, masks={})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "unet_6stage.pth"
        convert.save_reference_checkpoint(model, path)
        for layout in LAYOUTS:
            serve_layout(layout, path, batches, model)
    # One .pth, two layouts: the float32 masks of the two agree as the f32
    # masks with kernels agree with their plain versions.
    a = float((report["masks"]["s2d"]["f32"] == report["masks"]["dense"]["f32"]).mean())
    report["mask_agreement"]["f32 s2d vs f32 dense"] = a
    log(f"masks f32 s2d vs f32 dense: agreement {a:.6f} (bound {E2E_F32_AGREEMENT:g})")
    if a < E2E_F32_AGREEMENT:
        raise AssertionError(f"f32 s2d masks agree with the dense ones on only {a:.6f}")


@phase(f"4. whole forward: kernels against plain versions (b{SERVE_BATCH} 512²)")
def phase_e2e():
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    results = {}
    for layout in LAYOUTS:
        log(f"-- {layout}")
        results[layout] = check_forwards(*report["models"][layout], x, PER_FORWARD[layout])
    report["e2e"] = {k: v["pairs"] for k, v in results.items()}
    report["layouts_b8"] = check_layouts_agree(results["s2d"]["f32"], results["dense"]["f32"],
                                               f"b{SERVE_BATCH}")


def time_kernel(name: str, fn, plain, inputs: list, bound: tuple, library=None,
                iters: int = 10) -> list:
    """[kernel ms, plain ms, bound ms, library ms] medians of one call, logged."""
    t = cuda_times(fn, inputs, iters=iters)
    tp = cuda_times(plain, inputs, iters=3)
    tl = cuda_times(library, inputs, iters=iters) if library else None
    lib = f", library {spread(tl)}" if tl else ""
    log(f"{name} ({len(inputs)} input(s)): kernel {spread(t)}, plain {spread(tp)}{lib}, bound "
        f"{bound[0]:.4f} ms ({bound[1]}), {bound[0] / statistics.median(t):.1%} of bound")
    return [statistics.median(t), statistics.median(tp), bound[0],
            statistics.median(tl) if tl else None]


@phase(f"5. times (CUDA events, b{TIMED_BATCH} 512² bf16) and checks at b{TIMED_BATCH}")
def phase_times():
    batch = TIMED_BATCH
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    pixels = torch.randint(0, 256, (batch, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    xb = x.to(torch.bfloat16)
    report["forward"] = {}
    for layout in LAYOUTS:
        model = report["models"][layout][0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fwd = cuda_times(lambda inp: counted(lambda: model(inp), PER_FORWARD[layout]), [xb],
                             iters=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(fwd)
        report["forward"][layout] = {"batch": batch, "ms": ms, "img_per_s": batch / ms * 1e3,
                                     "peak_gib": peak}
        log(f"{layout} forward b{batch}: {spread(fwd)}, {batch / ms * 1e3:.1f} img/s, "
            f"peak memory {peak:.2f} GiB")
    del xb
    results = {}
    for layout in LAYOUTS:
        log(f"-- {layout} at b{batch}")
        results[layout] = check_forwards(*report["models"][layout], x, PER_FORWARD[layout])
    report["e2e_b128"] = {k: v["pairs"] for k, v in results.items()}
    report["layouts_b128"] = check_layouts_agree(results["s2d"]["f32"],
                                                 results["dense"]["f32"], f"b{batch}")
    del x, pixels, results

    # ms, plain, bound, library per forward; and K1's bound split into its
    # statistics pass (one read of x) and its apply pass (a read of x and a
    # write of y). K1 and K2a per dense forward, K2b and K3 per s2d forward.
    rows = {"K1": [0.0, 0.0, 0.0, None], "K1bwd": [0.0, 0.0, 0.0, None],
            "K2a": [0.0, 0.0, 0.0, 0.0], "K2b": [0.0, 0.0, 0.0, None],
            "K3": [0.0, 0.0, 0.0, None]}
    bound_by = {}
    k1_split = [0.0, 0.0]
    k1_passes = [0.0, 0.0]  # statistics, apply: ms per forward
    with torch.inference_mode():
        for level, ((side, c), calls) in enumerate(zip(LEVELS, K1_CALLS)):
            inputs = [k1_inputs(batch, side, c, torch.bfloat16)]
            log(check_k1(*inputs[0]))
            x = inputs[0][0]
            nbytes = x.numel() * x.element_size()
            inputs += [k1_inputs(batch, side, c, torch.bfloat16, seed=SEED + i)
                       for i in range(1, n_copies(nbytes))]
            bound = k1_bound_ms(x)
            row = time_kernel(f"K1 level {level} {tuple(x.shape)} x{calls}",
                              lambda inp: k1.fused_instance_norm(*inp),
                              lambda inp: k1._torch_forward(*inp, 1e-5, 0.01, 1), inputs, bound)
            for i in range(3):
                rows["K1"][i] += calls * row[i]
            bound_by["K1"] = bound[1]
            k1_split[0] += calls * bytes_ms(nbytes)
            k1_split[1] += calls * bytes_ms(2 * nbytes)
            # Each pass alone, on buffers made once (the apply pass reads the
            # mean and rstd the statistics pass left).
            buffers = k1.forward_buffers(x)

            def one_pass(passes, buffers=buffers):
                return lambda inp: k1.launch_forward(inp[0], inp[1], inp[2], buffers, 1e-5, 0.01,
                                                     1, passes)

            one_pass(k1.STATS)(inputs[0])
            t_stats = cuda_times(one_pass(k1.STATS), inputs, iters=10)
            t_apply = cuda_times(one_pass(k1.APPLY), inputs, iters=10)
            k1_passes[0] += calls * statistics.median(t_stats)
            k1_passes[1] += calls * statistics.median(t_apply)
            log(f"   statistics pass {spread(t_stats)}, bound {bytes_ms(nbytes):.4f} ms; apply "
                f"pass {spread(t_apply)}, bound {bytes_ms(2 * nbytes):.4f} ms")
            del inputs, x, buffers
        log(f"K1 per b{batch} dense forward by pass: statistics {k1_passes[0]:.3f} ms (bound "
            f"{k1_split[0]:.3f}), apply {k1_passes[1]:.3f} ms (bound {k1_split[1]:.3f})")
        for side, c in K2_INPUTS:
            x = k2_input(batch, side, c, seed=side)
            log(check_k2(x))
            nbytes = x.numel() * x.element_size()
            inputs = [x] + [k2_input(batch, side, c, seed=side + i)
                            for i in range(1, n_copies(nbytes))]
            # The library call on the NCHW view (channels_last memory). Its
            # NHWC kernel indexes with 32-bit ints: an output of 2^31 or more
            # elements is timed as one call per half batch.
            parts = 2 if 4 * x.numel() >= 2**31 else 1
            views = [[xh.permute(0, 3, 1, 2) for xh in xi.chunk(parts)] for xi in inputs]
            bound = k2_bound_ms(x)
            row = time_kernel(f"K2a {tuple(x.shape)}", k2.upsample2x_nhwc_fast, upsample2x_nhwc,
                              inputs, bound)
            row[3] = statistics.median(cuda_times(
                lambda halves: [F.interpolate(xh, scale_factor=2, mode="bilinear",
                                              align_corners=False) for xh in halves],
                views, iters=10))
            log(f"   F.interpolate ({parts} call(s)): median {row[3]:.4f} ms")
            for i in range(4):
                rows["K2a"][i] += row[i]
            bound_by["K2a"] = bound[1]
            del x, inputs, views
        for side, c in K2B_INPUTS:
            x = k2_input(batch, side, c, seed=side)
            log(check_k2(x, s2d=True))
            nbytes = x.numel() * x.element_size()
            inputs = [x] + [k2_input(batch, side, c, seed=side + i)
                            for i in range(1, n_copies(nbytes))]
            bound = k2_bound_ms(x)
            row = time_kernel(f"K2b {tuple(x.shape)}", k2.upsample2x_into_s2d_fast,
                              upsample2x_into_s2d, inputs, bound)
            for i in range(3):
                rows["K2b"][i] += row[i]
            bound_by["K2b"] = bound[1]
            del x, inputs
        log("K2b: no single PyTorch call writes the q-major s2d layout (F.pixel_unshuffle is "
            "c-major, channel c*4 + q), so library_ms is null.")
        with deterministic():
            timed = {}
            k3_conv = {}  # per (side, c): conv alone, cuDNN's dense conv, conv bound (ms)
            for i, (block, side, c) in enumerate(K3_CALLS):
                if (side, c) in timed:  # the same shape as an earlier call
                    row = timed[(side, c)]
                    log(f"K3 {block}: same shape as an earlier call, its times count again")
                else:
                    args = k3_inputs(batch, side, c, torch.bfloat16, seed=SEED + i)
                    log(check_k3(args, block))
                    bound = k3_bound_ms(args[0])
                    row = timed[(side, c)] = time_kernel(
                        f"K3 {block} {tuple(args[0].shape)}", lambda a: k3.fused_s2d_tail(*a),
                        lambda a: k3._torch_tail(*a, 1e-5, 0.01), [args], bound, iters=5)
                    bound_by["K3"] = bound[1]
                    # Context for a later redesign: cuDNN's conv of the same
                    # work in the dense geometry (not the same function).
                    xd = torch.randn((batch, c, 2 * side, 2 * side), device="cuda",
                                     dtype=torch.bfloat16).contiguous(
                                         memory_format=torch.channels_last)
                    wd = args[3].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                    td = cuda_times(lambda inp: F.conv2d(inp, wd, padding=1), [xd], iters=10)
                    log(f"   context: cuDNN F.conv2d of the dense-equivalent conv_1 "
                        f"{tuple(xd.shape)} {c}->{c} 3x3 bf16 channels_last: {spread(td)}")
                    del xd, wd
                    tc = time_k3_conv(args)
                    cbound = k3_conv_bound_ms(args[0])
                    k3_conv[(side, c)] = [statistics.median(tc), statistics.median(td), cbound[0]]
                    log(f"   K3's conv launch alone: {spread(tc)}, bound {cbound[0]:.4f} ms "
                        f"({cbound[1]}), {cbound[0] / statistics.median(tc):.1%} of bound; "
                        f"cuDNN's dense-equivalent conv {statistics.median(td):.4f} ms; whole K3 "
                        f"{row[0]:.4f} ms, bound {bound[0]:.4f} ms")
                    del args
                for j in range(3):
                    rows["K3"][j] += row[j]
        log("K3: no single PyTorch call computes IN+LeakyReLU -> conv -> IN+LeakyReLU, so "
            "library_ms is null.")
        conv_sum = [sum(k3_conv[(side, c)][j] for _, side, c in K3_CALLS) for j in range(3)]
        report["k3_conv"] = conv_sum
        log(f"K3 per b{batch} s2d forward (its {len(K3_CALLS)} calls): conv launch alone "
            f"{conv_sum[0]:.3f} ms (bound {conv_sum[2]:.3f} ms), cuDNN's dense-equivalent conv "
            f"{conv_sum[1]:.3f} ms, whole K3 {rows['K3'][0]:.3f} ms (bound "
            f"{rows['K3'][2]:.3f} ms)")
        # K1bwd at the 22 shapes of a b32 dense train step, timed last: its
        # plain version's float32 temporaries (about 10 GB at b32) change
        # where the caching allocator places the inputs timed after them.
        for level, ((side, c), calls) in enumerate(zip(LEVELS, K1_CALLS)):
            seed = SEED + 20 + 10 * level
            inputs = [k1_bwd_inputs(TRAIN_BATCH, side, c, torch.bfloat16, seed=seed)]
            log(check_k1_bwd(inputs[0]))
            x = inputs[0][0]
            inputs += [k1_bwd_inputs(TRAIN_BATCH, side, c, torch.bfloat16, seed=seed + i)
                       for i in range(1, n_copies(2 * x.numel() * x.element_size()))]
            bound = k1_bwd_bound_ms(x)
            row = time_kernel(f"K1bwd level {level} {tuple(x.shape)} x{calls}",
                              lambda a: k1._cuda_backward(*a, 0.01, 1),
                              lambda a: k1._torch_backward(*a, 0.01, 1), inputs, bound)
            plan = k1.bwd_plan(TRAIN_BATCH, side * side, c, 1, x.element_size(),
                               *_build.device_limits(x.device.index))
            log(f"   level {level}: kernel {row[0]:.4f} ms, {row[2] / row[0]:.1%} of bound, "
                f"{3 * x.numel() * x.element_size() / row[0] / 1e6:.0f} GB/s of x, dy and dx; "
                + (f"fused: {plan.pieces} pieces ({plan.parts} a pair of {plan.cs} channels) in "
                   f"{-(-plan.pieces // plan.grid)} rounds of {plan.grid} blocks"
                   if plan.fused else "two-pass")
                + f", {plan.reread_bytes} bytes read twice")
            for i in range(3):
                rows["K1bwd"][i] += calls * row[i]
            bound_by["K1bwd"] = bound[1]
            del inputs, x
            torch.cuda.empty_cache()
        log("K1bwd: no single PyTorch call computes the InstanceNorm+LeakyReLU backward "
            "(library_ms null).")
        log(f"K1bwd per b{TRAIN_BATCH} dense train step (sum over its 22 calls of the medians): "
            f"kernel {rows['K1bwd'][0]:.3f} ms, plain {rows['K1bwd'][1]:.3f} ms, bound "
            f"{rows['K1bwd'][2]:.3f} ms")
    report["rows"].update(rows)
    report["bound_by"].update(bound_by)
    log("K1 has no single PyTorch call computing InstanceNorm+LeakyReLU (library_ms null).")
    log(f"per b{batch} forward (sum over the main-path calls of the medians; K1, K2a dense, "
        "K2b, K3 s2d): "
        + "; ".join(f"{k}: kernel {v[0]:.3f} ms, plain {v[1]:.3f} ms, bound {v[2]:.3f} ms"
                    for k, v in rows.items() if k != "K1bwd"))
    log(f"K1 bound by pass per b{batch} forward: statistics (read x) {k1_split[0]:.3f} ms, "
        f"apply (read x, write y) {k1_split[1]:.3f} ms")


def k4_inputs(side: int, cin: int, cout: int, dtype, seed: int):
    """x (b32, side/2, side/2, 4·Cin) q-major, a Kaiming-scaled float32
    (Cout, Cin, 3, 3) kernel and a float32 bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((K4_BATCH, side // 2, side // 2, 4 * cin), generator=g, device="cuda")
    w = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=g, device="cuda") * 0.1
    return x.to(dtype), w, b


def dense_nchw(x: torch.Tensor) -> torch.Tensor:
    """The dense NCHW view (channels_last memory) of a q-major s2d tensor."""
    return depth_to_space(x).permute(0, 3, 1, 2)


def direct_conv_s2d(x, w, b):
    """The reference: cuDNN's SAME 3x3 conv of the dense view, back in s2d."""
    return space_to_depth(F.conv2d(dense_nchw(x), w, b, padding=1).permute(0, 2, 3, 1))


def rel_of_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.float(), ref.float()
    return float((a - ref).norm() / ref.norm())


@contextmanager
def k4_mode(kernel: str):
    saved = k4._FOLDED
    k4._FOLDED = K4_MODES[kernel]
    try:
        yield
    finally:
        k4._FOLDED = saved


def k4_u(w: torch.Tensor, kernel: str, dtype) -> torch.Tensor:
    tw = k4.transform_weights_folded if K4_MODES[kernel] else k4.transform_weights
    return tw(w).to(dtype)


def check_k4(conv: str, side: int, cin: int, cout: int, kernel: str, dtype, seed: int) -> str:
    """One forward and backward through ``winograd_conv_s2d`` (counted: one
    launch each) against the plain version and the direct conv."""
    x, w, b = k4_inputs(side, cin, cout, dtype, seed)
    gy = torch.randn((K4_BATCH, side // 2, side // 2, 4 * cout), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 1)).to(dtype)
    xk, wk, bk = (t.clone().requires_grad_() for t in (x, w, b))
    with k4_mode(kernel):
        y = counted_path(lambda: k4.winograd_conv_s2d(xk, wk, bk), one_launch(kernel))
        counted_path(lambda: y.backward(gy), one_launch(kernel))
    # The plain version on the same U, and on the flipped kernel for dx.
    w_flip = w.flip((2, 3)).transpose(0, 1)
    y_p = k4._torch_winograd_s2d(x, k4_u(w, kernel, dtype), b)
    dx_p = k4._torch_winograd_s2d(gy, k4_u(w_flip, kernel, dtype),
                                  torch.zeros(cin, device="cuda"))
    # The float32 direct conv on the same (rounded) values, and its grads.
    xr, wr, br = (t.detach().float().clone().requires_grad_() for t in (x, w, b))
    y_r = direct_conv_s2d(xr, wr, br)
    y_r.backward(gy.float())
    label = f"{kernel} {conv} {tuple(x.shape)} {str(dtype)[6:]}"
    report["err"][kernel] = max(report["err"][kernel], float((y.float() - y_p.float()).abs().max()))
    if dtype == torch.float32:
        errs = {"y vs plain": rel_of_max(y, y_p), "y vs direct": rel_of_max(y, y_r),
                "dx vs plain": rel_of_max(xk.grad, dx_p), "dx vs direct": rel_of_max(xk.grad, xr.grad),
                "dW vs direct": rel_of_max(wk.grad, wr.grad),
                "db vs direct": rel_of_max(bk.grad, br.grad)}
        ok = all(e <= K4_F32_TOL for e in errs.values())
        detail = ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {K4_F32_TOL:g} of max)"
    else:
        errs = {"y": (rel_l2(y, y_r), rel_l2(y_p, y_r)), "dx": (rel_l2(xk.grad, xr.grad),
                                                             rel_l2(dx_p, xr.grad))}
        ok = all(k_ <= p_ * (1 + E2E_BF16_SLACK) and k_ <= K4_BF16_REL_L2
                 for k_, p_ in errs.values())
        detail = ", ".join(f"{k} rel-L2 to f32 direct kernel/plain {a:.4e}/{p_:.4e}"
                           for k, (a, p_) in errs.items())
        detail += (f" (slack {E2E_BF16_SLACK:g}, at most {K4_BF16_REL_L2:g}); dW, db rel-L2 "
                   "to f32 direct "
                   f"{rel_l2(wk.grad, wr.grad):.4e}, {rel_l2(bk.grad, br.grad):.4e}")
    if not ok:
        raise AssertionError(f"{label} disagrees: {detail}")
    return f"{label}: {detail} ok"


def k4_bound_ms(n_tiles: int, cin: int, cout: int, kernel: str) -> tuple[float, str]:
    """Bytes: x (n_tiles x 4·Cin), U (16 Cin x Cout matrices unfolded, 8 of
    3·Cin x Cout folded) and y (n_tiles x 4·Cout) in bf16, the f32 bias.
    Operations: the function's 16 Winograd products per tile, 2·Cin·Cout each
    (4/9 of the direct conv), on the bf16 tensor cores, in both layouts: the
    folded kernel multiplies more (24 per tile) for the same function."""
    u_mats = 24 if K4_MODES[kernel] else 16
    nbytes = 2 * (n_tiles * 4 * cin + u_mats * cin * cout + n_tiles * 4 * cout) + 4 * cout
    by_bytes = bytes_ms(nbytes)
    by_ops = 2 * 16 * cin * cout * n_tiles / BF16_TENSOR_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def ptxas_report(kernel: str) -> list[str]:
    """nvcc's ``-Xptxas -v`` lines for every instantiation of ``kernel`` in
    the build this process made ([] when it loaded a cached library)."""
    lines, keep = [], False
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("ptxas info" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def check_no_spills(kernel: str) -> None:
    """Log nvcc's report for ``kernel`` and fail if it spills registers."""
    report_lines = ptxas_report(kernel)
    for line in report_lines:
        log(f"   {line}")
    if not report_lines:
        log(f"   no nvcc report for {kernel}: the library was loaded from an earlier build")
    spills = [line for line in report_lines
              if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))]
    if spills:
        raise AssertionError(f"{kernel} spills registers: {spills}")


@phase(f"6. K4 winograd_conv_s2d: kernel against plain version and direct conv (b{K4_BATCH})")
def phase_k4():
    check_no_spills(K4_BF16_KERNEL)
    with deterministic():
        for i, (conv, side, cin, cout) in enumerate(K4_CONVS):
            for kernel in K4_MODES:
                for dt in (torch.float32, torch.bfloat16):
                    log(check_k4(conv, side, cin, cout, kernel, dt, seed=SEED + 10 * i))
                    torch.cuda.empty_cache()
    # Times of the kernel launch (U transformed and packed beforehand), its
    # plain version (on the unpacked U) and cuDNN's F.conv2d + bias of the
    # same shape (bf16, channels_last), for the forward and for dx (the
    # kernel on the cotangent, Cout -> Cin).
    slower = []
    for kernel in K4_MODES:
        row = [0.0, 0.0, 0.0, 0.0]
        for i, (conv, side, cin, cout) in enumerate(K4_CONVS):
            x, w, b = k4_inputs(side, cin, cout, torch.bfloat16, seed=SEED + 10 * i)
            n_tiles = x.shape[0] * x.shape[1] * x.shape[2]
            for what, ci, co, wt in (("forward", cin, cout, w),
                                     ("dx", cout, cin, w.flip((2, 3)).transpose(0, 1))):
                # dx runs on a cotangent of y's shape, into Cin channels.
                xs = x if what == "forward" else k4_inputs(side, ci, co, torch.bfloat16,
                                                           seed=SEED + 10 * i + 1)[0]
                u = k4_u(wt, kernel, torch.bfloat16)
                packed = k4.pack_weights(u)
                bias = b if what == "forward" else torch.zeros(co, device="cuda")
                nbytes = xs.numel() * xs.element_size()
                inputs = [(xs, u, packed, bias)] + [(torch.randn_like(
                    xs, dtype=torch.float32).to(torch.bfloat16), u, packed, bias)
                    for _ in range(1, n_copies(nbytes))]
                bound = k4_bound_ms(n_tiles, ci, co, kernel)
                wd = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                bd = bias.to(torch.bfloat16)
                dense = [dense_nchw(a[0]).contiguous(memory_format=torch.channels_last)
                         for a in inputs]
                t = time_kernel(f"{kernel} {what} {conv} {tuple(xs.shape)} {ci}->{co}",
                                lambda a: k4._cuda_winograd_s2d(a[0], a[2], a[3]),
                                lambda a: k4._torch_winograd_s2d(a[0], a[1], a[3]), inputs,
                                bound)
                if not K4_MODES[kernel] and t[0] >= t[1]:
                    slower.append(f"{what} {conv}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms")
                tl = cuda_times(lambda d: F.conv2d(d, wd, bd, padding=1), dense, iters=10)
                log(f"   cuDNN F.conv2d + bias {tuple(dense[0].shape)} {ci}->{co} bf16 "
                    f"channels_last: {spread(tl)}")
                if what == "forward":
                    row = [row[0] + t[0], row[1] + t[1], row[2] + bound[0],
                           row[3] + statistics.median(tl)]
                    report["bound_by"][kernel] = bound[1]
                del inputs, dense, xs
            del x
            torch.cuda.empty_cache()
        report["rows"][kernel] = row
        log(f"{kernel} per b{K4_BATCH} set of the four convs' forwards: kernel {row[0]:.3f} ms, "
            f"plain {row[1]:.3f} ms, bound {row[2]:.3f} ms, cuDNN {row[3]:.3f} ms")
    if slower:
        raise AssertionError(f"K4 bf16 calls not faster than the plain version: {slower}")


def grad_groups(model) -> dict:
    """Parameter names by comparison group: each parameter alone, except a
    conv followed by InstanceNorm (inside a block, and the CLIP fusion's),
    whose bias goes with its weight (the norm cancels the bias: its exact
    gradient is zero)."""
    groups = {}
    for name, _ in model.named_parameters():
        prefix = name.rsplit(".", 1)[0]
        if (".block." in name or name.startswith("clip_fusion_conv.")) and isinstance(
                model.get_submodule(prefix), torch.nn.Conv2d):
            groups.setdefault(prefix, []).append(name)
        else:
            groups[name] = [name]
    return groups


def group_rel_l2(grads: dict, ref: dict, groups: dict) -> dict:
    return {g: rel_l2(torch.cat([grads[n].reshape(-1) for n in names]),
                      torch.cat([ref[n].reshape(-1) for n in names]))
            for g, names in groups.items()}


# The two training objectives: the model's constructor, and its train step
# with the recipe's optimizer at the JAX defaults.
OBJECTIVES = {
    "segmentation": (unet_6stage, lambda m: make_segmentation_train_step(
        m, sgd_nesterov(m.parameters()))),
    "reconstruction": (autoencoder_6stage, lambda m: make_reconstruction_train_step(
        m, adam_l2(m.parameters()))),
    "clip": (lambda **kw: unet_6stage(clip_fusion=True, **kw),
             lambda m: make_segmentation_train_step(m, sgd_nesterov(m.parameters()),
                                                    use_clip=True)),
}
# Each objective's launches per train step, and its name in the log.
STEP_LAUNCHES = {"segmentation": PER_STEP, "reconstruction": PER_STEP, "clip": CLIP_PER_STEP}
OBJECTIVE_NAMES = {"segmentation": "", "reconstruction": "AE ", "clip": "CLIP "}


def train_model(layout: str, state: dict, dtype, objective: str = "segmentation"):
    model = OBJECTIVES[objective][0](dtype=dtype, device="cuda", **LAYOUTS[layout])
    model.load_state_dict(state, strict=True)
    return model


def device_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


# The step variants of the b8 check: the launches each makes, and the
# version of K1 its blocks run (None: the wrappers, with the kernels).
STEP_MODES = {"kernels": None, "plain": k1_plain, "kernel values": k1_kernel_values,
              "reordered": k1_reordered}


def one_step(layout: str, state: dict, dtype, batch: dict, mode: str,
             objective: str = "segmentation"):
    """One train step from ``state`` (counted): the loss and every gradient."""
    model = train_model(layout, state, dtype, objective)
    step = OBJECTIVES[objective][1](model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_step = STEP_LAUNCHES[objective][layout]
    expected = {"kernels": per_step, "kernel values": {
        **NO_LAUNCHES, "K1": per_step["K1"]}}.get(mode, NO_LAUNCHES)
    k1_version = STEP_MODES[mode]
    with deterministic(), plain_versions(k1_version) if k1_version else nullcontext():
        loss = (counted_path if mode == "kernels" else counted)(lambda: float(step(batch, gen)),
                                                                 expected)
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    return loss, grads, grad_groups(model)


def check_train_step(layout: str, state: dict, batch: dict,
                     objective: str = "segmentation") -> dict:
    runs = {(torch.float32, mode): one_step(layout, state, torch.float32, batch, mode, objective)
            for mode in STEP_MODES}
    runs.update({(torch.bfloat16, mode): one_step(layout, state, torch.bfloat16, batch, mode,
                                                  objective)
                 for mode in ("kernels", "plain")})
    name = OBJECTIVE_NAMES[objective] + layout
    f32, f32_plain = runs[(torch.float32, "kernels")], runs[(torch.float32, "plain")]
    f32_values, f32_reordered = (runs[(torch.float32, "kernel values")],
                                 runs[(torch.float32, "reordered")])
    bf, bf_plain = runs[(torch.bfloat16, "kernels")], runs[(torch.bfloat16, "plain")]
    groups = f32[2]
    loss_rel = abs(f32[0] - f32_plain[0]) / abs(f32_plain[0])
    values_loss_rel = abs(f32[0] - f32_values[0]) / abs(f32_values[0])
    g32 = group_rel_l2(f32[1], f32_values[1], groups)
    worst32 = max(g32, key=g32.get)
    g_plain = group_rel_l2(f32[1], f32_plain[1], groups)
    g_reord = group_rel_l2(f32_reordered[1], f32_plain[1], groups)
    gk = group_rel_l2(bf[1], f32_plain[1], groups)
    gp = group_rel_l2(bf_plain[1], f32_plain[1], groups)
    ratio = {g: gk[g] / gp[g] for g in groups}
    worst_ratio = max(ratio, key=ratio.get)

    def all_rel(a, b):
        return rel_l2(torch.cat([v.reshape(-1) for v in a.values()]),
                      torch.cat([v.reshape(-1) for v in b.values()]))

    all_k, all_p = all_rel(bf[1], f32_plain[1]), all_rel(bf_plain[1], f32_plain[1])
    dl_k, dl_p = abs(bf[0] - f32_plain[0]), abs(bf_plain[0] - f32_plain[0])
    med = statistics.median
    log(f"{name} b{CHECK_BATCH} step losses: f32 {f32[0]:.7f} / plain {f32_plain[0]:.7f} "
        f"(rel {loss_rel:.3e}) / kernel values {f32_values[0]:.7f} (rel {values_loss_rel:.3e}); "
        f"bf16 {bf[0]:.7f} / plain {bf_plain[0]:.7f}")
    log(f"{name} f32 gradients vs the step with the kernel's values and the plain gradient: "
        f"worst group rel-L2 {g32[worst32]:.3e} ({worst32}), median {med(g32.values()):.3e} over "
        f"{len(groups)} groups")
    worst_plain = max(g_plain, key=g_plain.get)
    log(f"{name} f32 gradients vs the plain step: all parameters "
        f"{all_rel(f32[1], f32_plain[1]):.3e}, worst group {g_plain[worst_plain]:.3e} "
        f"({worst_plain}), median {med(g_plain.values()):.3e}; the plain step with K1's sums "
        f"reordered vs the plain step: all parameters "
        f"{all_rel(f32_reordered[1], f32_plain[1]):.3e}, worst group "
        f"{max(g_reord.values()):.3e}, median {med(g_reord.values()):.3e}")
    log(f"{name} bf16 gradients to f32 plain, kernels/plain: all parameters {all_k:.4e}/"
        f"{all_p:.4e}; worst group ratio {ratio[worst_ratio]:.3f} ({worst_ratio}: "
        f"{gk[worst_ratio]:.4e}/{gp[worst_ratio]:.4e}); |loss - f32 plain| {dl_k:.3e}/{dl_p:.3e}")
    checks = {"f32 loss": loss_rel <= TRAIN_F32_LOSS_REL,
              "f32 loss, kernel values": values_loss_rel <= TRAIN_F32_LOSS_REL,
              "f32 grads": g32[worst32] <= TRAIN_F32_GRAD_REL,
              "f32 grads vs plain": g_plain[worst_plain] <= TRAIN_F32_PLAIN_GRAD_REL,
              "bf16 grads": ratio[worst_ratio] <= 1 + E2E_BF16_SLACK,
              "bf16 all grads": all_k <= all_p * (1 + E2E_BF16_SLACK),
              "bf16 loss": dl_k <= dl_p * (1 + E2E_BF16_SLACK),
              "finite": all(math.isfinite(r[0]) for r in runs.values())}
    log(f"{name} train-step bounds: f32 loss rel <= {TRAIN_F32_LOSS_REL:g}, f32 grad rel-L2 "
        f"<= {TRAIN_F32_GRAD_REL:g} (against the kernel's values with the plain gradient) and "
        f"<= {TRAIN_F32_PLAIN_GRAD_REL:g} (against the plain step), bf16 within "
        f"{E2E_BF16_SLACK:g} of the bf16 plain step: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: the train step with kernels misses its bounds: {checks}")
    return {"f32 loss rel": loss_rel, "f32 worst grad rel-L2": g32[worst32],
            "f32 vs plain worst grad rel-L2": max(g_plain.values()),
            "f32 reordered vs plain worst grad rel-L2": max(g_reord.values()),
            "bf16 worst grad ratio": ratio[worst_ratio], "bf16 all grads": (all_k, all_p),
            "bf16 loss err": (dl_k, dl_p)}


def timed_steps(label: str, step, batch: dict, expected: dict,
                batch_size: int = TRAIN_BATCH) -> tuple[float, float]:
    """The median of TIMED_STEPS steps (of ``batch_size`` images) by CUDA
    events after WARMUP_STEPS and the peak memory, every step counted; fails
    unless the loss of one more step is finite. Returns (median ms, peak
    GiB)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_times(lambda b: counted_path(lambda: step(b, gen), expected), [batch],
                    iters=TIMED_STEPS, warmup=WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(ms)
    last = counted_path(lambda: float(step(batch, gen)), expected)
    log(f"{label} b{batch_size} 512² bf16: {spread(ms)}, "
        f"{batch_size / med * 1e3:.1f} img/s, peak memory {peak:.2f} GiB; loss after "
        f"{WARMUP_STEPS + TIMED_STEPS + 1} steps {last:.4f}")
    if not math.isfinite(last):
        raise AssertionError(f"{label}: the b{batch_size} loss is not finite")
    return med, peak


@contextmanager
def dy_layouts(seen: list):
    """Records (shape, strides, contiguous) of each cotangent K1bwd receives:
    the kernel takes dy contiguous, and copies any other."""
    launch = k1._cuda_backward

    def spy(x, scale, bias, mean, rstd, dy, *rest):
        seen.append((tuple(dy.shape), tuple(dy.stride()), dy.is_contiguous()))
        return launch(x, scale, bias, mean, rstd, dy, *rest)

    k1._cuda_backward = spy
    try:
        yield
    finally:
        k1._cuda_backward = launch


def train_layout(layout: str, path: Path) -> None:
    served = convert.load_reference_checkpoint(path, device="cuda", dtype=torch.bfloat16,
                                               **LAYOUTS[layout])
    if any(p.dtype != torch.float32 for p in served.parameters()):
        raise AssertionError("the model's parameters are not float32")
    state = {k: v.clone() for k, v in served.state_dict().items()}
    check = device_batch(as_uint8(synthetic_batch(SEED + 3, CHECK_BATCH, IMG)))
    report["train"][layout] = {"check": check_train_step(layout, state, check)}
    torch.cuda.empty_cache()

    # Ten steps on one b8 batch (bf16, kernels) must lower the loss.
    model = train_model(layout, state, torch.bfloat16)
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses, seen = [], []
    for i in range(TRAIN_STEPS_DOWN):
        with dy_layouts(seen) if i == 0 else nullcontext():
            losses.append(counted_path(lambda: float(step(check, gen)), PER_STEP[layout]))
    copied = [(shape, stride) for shape, stride, contiguous in seen if not contiguous]
    log(f"{layout} K1bwd cotangents of one b{CHECK_BATCH} step: {len(seen)}, "
        f"{len(seen) - len(copied)} contiguous; not contiguous (copied first): {copied}")
    log(f"{layout} {TRAIN_STEPS_DOWN} steps on one b{CHECK_BATCH} batch: losses "
        + " ".join(f"{v:.4f}" for v in losses))
    report["train"][layout]["losses"] = losses
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{layout}: the loss did not go down: {losses}")
    del model, step, check
    torch.cuda.empty_cache()

    # The b32 step: the model loaded from the .pth, a batch already on the card.
    batch = device_batch(as_uint8(synthetic_batch(SEED + 4, TRAIN_BATCH, IMG)))
    step = make_segmentation_train_step(served, sgd_nesterov(served.parameters()))
    med, peak = timed_steps(f"{layout} train step", step, batch, PER_STEP[layout])
    evaluate = make_segmentation_eval_step(served)
    evaluate(batch)
    torch.cuda.synchronize()
    ev = cuda_times(lambda b: counted_path(lambda: evaluate(b), PER_FORWARD[layout]), [batch],
                    iters=1, warmup=0)
    out = counted_path(lambda: evaluate(batch), PER_FORWARD[layout])
    cm = out["confusion"]
    if float(cm.sum()) != float((batch["mask"] != 255).sum()) or not bool(
            torch.isfinite(out["loss"])):
        raise AssertionError(f"{layout}: eval step confusion {cm.tolist()} or loss {out['loss']}")
    log(f"{layout} eval step b{TRAIN_BATCH}: {ev[0]:.3f} ms, loss {float(out['loss']):.4f}, dice "
        f"{[round(float(v), 4) for v in out['dice']]}")
    report["train"][layout].update(step_ms=med, img_per_s=TRAIN_BATCH / med * 1e3, peak_gib=peak,
                                   eval_ms=ev[0])


@phase(f"7. the train step: unet_6stage 512² bf16, f32 params, SGD-Nesterov (b{CHECK_BATCH} "
       f"checks, b{TRAIN_BATCH} times)")
def phase_train():
    report["train"] = {}
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 5))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "unet_6stage_train.pth"
        convert.save_reference_checkpoint(model, path)
        del model
        for layout in LAYOUTS:
            log(f"-- {layout}")
            train_layout(layout, path)
            torch.cuda.empty_cache()


def recipe_item(split_seed: tuple, i: int) -> dict:
    """One cached item: a 512² synthetic sample as uint8 pixels, its
    {0, 1, 2, 255} mask, and an original size drawn from RECIPE_DIMS."""
    rng = np.random.default_rng([*split_seed, i])
    image, mask = synthetic_sample(rng, IMG)
    dims = rng.integers(RECIPE_DIMS[0], RECIPE_DIMS[1] + 1, 2).astype(np.int32)
    return {"image": as_uint8({"image": image})["image"], "mask": mask.astype(np.uint8),
            "original_dims": dims}


def recipe_data(root: Path) -> tuple[Path, Path]:
    """``root/data`` and ``root/cache``, written by the first phase that asks
    (8, or 9 when 8 failed before writing them)."""
    data, cache = root / "data", root / "cache"
    if not data.exists():
        t0 = time.perf_counter()
        write_recipe_data(data, cache)
        n_train, n_val, n_test = (n for _, n in RECIPE_SPLITS.values())
        log(f"dataset: {n_train}/{n_val}/{n_test} images of {IMG}² (original sizes "
            f"{RECIPE_DIMS[0]}-{RECIPE_DIMS[1]}) in a warm decode cache "
            f"({time.perf_counter() - t0:.1f} s); stand-in files, so no decode: "
            f"the file-decode path is covered by the CPU tests (tests/test_torch_loader.py)")
    return data, cache


def per_epoch(per_step: dict, epochs: int, batch: int = RECIPE_BATCH,
              fwd: dict = PER_FORWARD["dense"]) -> dict:
    """Launches of ``epochs`` recipe epochs at ``batch``: the train steps and
    the validation forwards (dense, ``fwd`` each)."""
    steps = RECIPE_SPLITS["Train"][1] // batch
    val_fwd = -(-RECIPE_SPLITS["Val"][1] // batch)
    return {k: epochs * (steps * per_step[k] + val_fwd * fwd[k]) for k in KERNELS}


def importable(name: str) -> bool:
    try:
        __import__(name)
        return True
    except ImportError:
        return False


def plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in KERNELS}


def ae_snapshots(checkpoints: int) -> dict:
    """The launches of ``ae_recon train``'s reconstruction snapshots: one
    forward a checkpoint, drawn only where matplotlib imports."""
    return times(PER_FORWARD["dense"], checkpoints if importable("matplotlib") else 0)


def write_recipe_data(data: Path, cache: Path) -> None:
    """The reference directory schema under ``data``, with stand-in image and
    mask files, and a warm decode cache under ``cache`` written with the
    loader's own functions: the datasets read the cache and decode no file
    (the card has no cv2)."""
    for k, (split, (labels, n)) in enumerate(RECIPE_SPLITS.items()):
        images_dir, masks_dir = data / split / "resized", data / split / labels
        images_dir.mkdir(parents=True)
        masks_dir.mkdir(parents=True)
        for i in range(n):
            (images_dir / f"{split.lower()}_{i:04d}.jpg").write_bytes(b"stand-in")
            (masks_dir / f"{split.lower()}_{i:04d}.png").write_bytes(b"stand-in")
        files = sorted(images_dir.glob("*.jpg"))
        size = (IMG, IMG)
        with ThreadPoolExecutor(max_workers=8) as pool:
            items = pool.map(lambda i: recipe_item((SEED + 8, k), i), range(n))
            loader.write_cache(loader.cache_path(cache, images_dir, masks_dir, size),
                               loader.cache_identity(files, size, True), items, n, size, True)


def eval_scalars(results: dict) -> dict:
    """The scalars of an evaluation_results.json, by dotted name; fails
    unless its keys are the JAX package's."""
    if tuple(results) != EVAL_KEYS or any(tuple(results[c]) != EVAL_CLASS_KEYS
                                          for c in EVAL_CLASSES):
        raise AssertionError(f"evaluation_results.json keys {list(results)}")
    out = {k: results[k] for k in ("pixel_accuracy", "mean_iou", "mean_foreground_dice")}
    for c in EVAL_CLASSES:
        out.update({f"{c}.{k}": results[c][k] for k in EVAL_CLASS_KEYS})
    return out


def batch_copy_ms() -> dict:
    """Host-to-card time of one recipe batch from pageable memory and
    through ``to_device`` (pinned), each the median of 5 after one warm-up."""
    batch = {"image": np.zeros((RECIPE_BATCH, IMG, IMG, 3), np.uint8),
             "mask": np.zeros((RECIPE_BATCH, IMG, IMG), np.int32)}
    ways = {"pageable": lambda a: torch.from_numpy(a).to("cuda", non_blocking=True),
            "pinned": lambda a: to_device(a, torch.device("cuda"))}
    out = {}
    for name, move in ways.items():
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved = [move(a) for a in batch.values()]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            del moved
        out[name] = statistics.median(ms[1:])
    return out


@phase(f"8. the recipe: cli our_unet train -> resume -> evaluate, unet_6stage "
       f"b{RECIPE_BATCH} 512² bf16")
def phase_recipe(root: Path):
    if "cv2" in sys.modules:
        raise AssertionError("cv2 was imported before the recipe ran")
    n_test = RECIPE_SPLITS["Test"][1]
    test_fwd = -(-n_test // RECIPE_BATCH)

    data, cache = recipe_data(root)
    out = root / "run"
    train = ["our_unet", "train", "--data_dir", str(data), "--output_dir", str(out),
             "--batch_size", str(RECIPE_BATCH), "--save_every", "1",
             "--decode_cache", str(cache)]

    # Train.
    t0 = time.perf_counter()
    result = counted_path(lambda: cli.main(train + ["--epochs", str(RECIPE_EPOCHS)]),
                          per_epoch(PER_STEP["dense"], RECIPE_EPOCHS))
    train_wall = time.perf_counter() - t0
    log_file = out / "training_log.csv"
    lines = log_file.read_text().splitlines()
    log("\n".join(["training_log.csv:", *lines]))
    if lines[0] != SEG_CSV_HEADER:
        raise AssertionError(f"CSV header {lines[0]!r}")
    rows = [ln.split(",") for ln in lines[1:]]
    if [r[0] for r in rows] != [str(e + 1) for e in range(RECIPE_EPOCHS)]:
        raise AssertionError(f"CSV epochs {[r[0] for r in rows]}")
    want_lr = [f"{poly_lr(5e-3, RECIPE_EPOCHS)(e):.7f}" for e in range(RECIPE_EPOCHS)]
    if [r[7] for r in rows] != want_lr or want_lr[0] != "0.0050000":
        raise AssertionError(f"learning rates {[r[7] for r in rows]}, want {want_lr}")
    losses = [float(v) for r in rows for v in r[1:7]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a CSV value is not finite: {rows}")
    if not float(rows[1][1]) < float(rows[0][1]):
        raise AssertionError(f"epoch 2's train loss {rows[1][1]} is not below epoch "
                             f"1's {rows[0][1]}")
    ckpts = [out / "checkpoints" / f"epoch_{e + 1}" for e in range(RECIPE_EPOCHS)]
    for d in [*ckpts, out / "best_model"]:
        if not ((d / "model.pth").is_file() and (d / "meta.json").is_file()):
            raise AssertionError(f"{d} lacks model.pth or meta.json")
    convert.load_reference_checkpoint(out / "best_model" / "model.pth", device="cuda")
    log(f"checkpoints: {[d.name for d in ckpts]} and best_model; best_model/model.pth "
        f"loads strictly through load_reference_checkpoint")

    # Resume for one more epoch.
    counted_path(lambda: cli.main(train + ["--epochs", str(RECIPE_EPOCHS + 1),
                                           "--resume", str(ckpts[-1])]),
                 per_epoch(PER_STEP["dense"], 1))
    resumed = log_file.read_text().splitlines()
    if resumed[:RECIPE_EPOCHS + 1] != lines or len(resumed) != RECIPE_EPOCHS + 2 or \
            not resumed[-1].startswith(f"{RECIPE_EPOCHS + 1},"):
        raise AssertionError("the resumed CSV:\n" + "\n".join(resumed))
    log(f"resume from epoch_{RECIPE_EPOCHS}: {resumed[-1]}")
    torch.cuda.empty_cache()

    # Evaluate: float32 with the kernels and with the plain versions, then bf16.
    def evaluate(name: str, *flags: str) -> tuple[dict, float]:
        t0 = time.perf_counter()
        cli.main(["our_unet", "evaluate", "--model_path", str(out / "best_model"),
                  "--data_dir", str(data), "--output_dir", str(out / name),
                  "--batch_size", str(RECIPE_BATCH), "--decode_cache", str(cache),
                  "--visualize_samples", "0", *flags])
        wall = time.perf_counter() - t0
        results = json.loads((out / name / "evaluation_results.json").read_text())
        return eval_scalars(results), wall

    per_test = times(PER_FORWARD["dense"], test_fwd)
    f32, f32_wall = counted_path(lambda: evaluate("eval_f32", "--f32"), per_test)
    with plain_versions():
        plain, _ = counted(lambda: evaluate("eval_f32_plain", "--f32"), NO_LAUNCHES)
    bf16, bf16_wall = counted_path(lambda: evaluate("eval_bf16"), per_test)
    log(f"{'scalar':<22} {'f32 kernels':>12} {'f32 plain':>12} {'bf16 kernels':>12}")
    for k in f32:
        log(f"{k:<22} {f32[k]:12.6f} {plain[k]:12.6f} {bf16[k]:12.6f}")
    # Two NaNs agree: a class that neither run predicts has no precision.
    far = {k: (f32[k], plain[k]) for k in f32
           if not (abs(f32[k] - plain[k]) <= RECIPE_EVAL_ATOL
                   or math.isnan(f32[k]) and math.isnan(plain[k]))}
    if far:
        raise AssertionError(f"f32 evaluate, kernels against plain, beyond "
                             f"{RECIPE_EVAL_ATOL}: {far}")
    if not all(math.isfinite(v) for v in bf16.values()):
        raise AssertionError(f"a bf16 evaluation scalar is not finite: {bf16}")

    if "cv2" in sys.modules:
        raise AssertionError("the recipe imported cv2")
    # Times, printed and not gated: the loop's own timers of epoch 2.
    epoch = result["epochs"][-1]
    step_ms = epoch["train_s"] / epoch["steps"] * 1e3
    steady_ms = (epoch["train_s"] - epoch["first_batch_s"]) / epoch["steps"] * 1e3
    phase7 = report.get("train", {}).get("dense", {}).get("step_ms")

    def beside(ms: float) -> str:
        return (f"; phase 7's b{TRAIN_BATCH} dense step {phase7:.3f} ms, ratio "
                f"{ms / phase7:.3f}" if phase7 else "")

    log(f"epoch {epoch['epoch']}: {epoch['steps']} steps, train phase {epoch['train_s']:.3f} s, "
        f"{step_ms:.3f} ms per step{beside(step_ms)}")
    log(f"epoch {epoch['epoch']}: first batch after {epoch['first_batch_s'] * 1e3:.3f} ms (the "
        f"device has no work yet); after it {steady_ms:.3f} ms per step{beside(steady_ms)}")
    log(f"epoch {epoch['epoch']}: the host waited {epoch['data_s']:.3f} s for the loader = "
        f"{epoch['data_s'] / epoch['epoch_s']:.1%} of the epoch ({epoch['epoch_s']:.3f} s), "
        f"{epoch['data_s'] / epoch['train_s']:.1%} of its train phase; step dispatch and "
        f"waits {epoch['step_s']:.3f} s")
    copy_ms = batch_copy_ms()
    log(f"one b{RECIPE_BATCH} batch (uint8 pixels, int32 masks) to the card, host clock with "
        f"a synchronize, median of 5: pageable {copy_ms['pageable']:.3f} ms, through pinned "
        f"memory (training.steps.to_device) {copy_ms['pinned']:.3f} ms")
    log(f"validation: {epoch['val_s'] / epoch['val_batches'] * 1e3:.3f} ms per "
        f"b{RECIPE_BATCH} batch ({epoch['val_batches']} batches)")
    log(f"evaluate wall time: {f32_wall:.3f} s f32, {bf16_wall:.3f} s bf16 ({n_test} images); "
        f"train command {train_wall:.3f} s for {RECIPE_EPOCHS} epochs")
    report["recipe"] = {"step_ms": step_ms, "steady_step_ms": steady_ms,
                        "phase7_step_ms": phase7, "copy_ms": copy_ms,
                        "data_share": epoch["data_s"] / epoch["epoch_s"],
                        "val_ms_per_batch": epoch["val_s"] / epoch["val_batches"] * 1e3,
                        "eval_wall_s": bf16_wall}


def recon_batch(seed: int, batch: int) -> dict:
    """A reconstruction batch on the card: the uint8 pixels of seeded
    synthetic images, the target the image (as the loader gives it)."""
    pixels = torch.from_numpy(as_uint8(synthetic_batch(seed, batch, IMG))["image"]).to("cuda")
    return {"image": pixels, "target": pixels}


def ae_train_steps() -> torch.nn.Module:
    """The AE train step (dense, bf16, Adam-L2): the b8 checks against the
    plain versions, 10 steps that must lower the MSE, then the b32 time.
    Returns the b32-trained autoencoder."""
    ae = autoencoder_6stage(dtype=torch.bfloat16, device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 9))
    state = {k: v.clone() for k, v in ae.state_dict().items()}
    check = recon_batch(SEED + 10, CHECK_BATCH)
    report["ae"]["check"] = check_train_step("dense", state, check, "reconstruction")
    torch.cuda.empty_cache()

    model = train_model("dense", state, torch.bfloat16, "reconstruction")
    step = OBJECTIVES["reconstruction"][1](model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = [counted_path(lambda: float(step(check, gen)), PER_STEP["dense"])
              for _ in range(TRAIN_STEPS_DOWN)]
    log(f"AE {TRAIN_STEPS_DOWN} steps on one b{CHECK_BATCH} batch: MSE "
        + " ".join(f"{v:.5f}" for v in losses))
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the AE's MSE did not go down: {losses}")
    del model, step, check
    torch.cuda.empty_cache()

    batch = recon_batch(SEED + 11, TRAIN_BATCH)
    med, peak = timed_steps("AE train step", OBJECTIVES["reconstruction"][1](ae), batch,
                            PER_STEP["dense"])
    report["ae"].update(step_ms=med, peak_gib=peak)
    return ae


def transfer_steps(ae: torch.nn.Module, tmp: Path) -> None:
    """The transfer step: ``unet_6stage`` with the encoder grafted from the
    autoencoder's checkpoint and frozen, SGD-Nesterov on the rest. 10 b8 steps
    leave the six encoder stages bit for bit and move every decoder; then the
    b32 time."""
    save_checkpoint(tmp / "ae", ae, None, 0, 0.0)
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 12))
    extract_encoder_params(tmp / "ae", model, n_stages=model.n_stages)
    with_frozen(model, encoder_param_names(model.n_stages))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    encoder = [k for k in before if k.startswith("encoder_stages.")]
    ae_state = ae.state_dict()
    if not all(torch.equal(before[k], ae_state[k]) for k in encoder):
        raise AssertionError("the grafted encoder differs from the autoencoder's")
    trainable = [p for p in model.parameters() if p.requires_grad]
    step = make_segmentation_train_step(model, sgd_nesterov(trainable))
    check = device_batch(as_uint8(synthetic_batch(SEED + 13, CHECK_BATCH, IMG)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = [counted_path(lambda: float(step(check, gen)), TRANSFER_PER_STEP)
              for _ in range(TRAIN_STEPS_DOWN)]
    after = model.state_dict()
    changed = [k for k in encoder if not torch.equal(after[k], before[k])]
    still = [k for k in before if k not in encoder and k.endswith("weight")
             and torch.equal(after[k], before[k])]
    log(f"transfer: {len(encoder)} encoder tensors frozen, {len(trainable)} trainable; "
        f"{TRAIN_STEPS_DOWN} b{CHECK_BATCH} steps, losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; encoder tensors changed: {len(changed)}; decoder and head weights unchanged: "
          f"{len(still)}")
    if changed or still or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"transfer: encoder changed {changed}, unchanged {still}, "
                             f"losses {losses}")
    del check
    torch.cuda.empty_cache()
    batch = device_batch(as_uint8(synthetic_batch(SEED + 4, TRAIN_BATCH, IMG)))
    med, peak = timed_steps("transfer train step", step, batch, TRANSFER_PER_STEP)
    report["ae"].update(transfer_step_ms=med, transfer_peak_gib=peak)


def ae_forwards(ae: torch.nn.Module) -> None:
    """The autoencoder's b8 forward in both layouts, bf16 and float32, with
    the kernels against the plain versions (phase 4's rel-L2 bounds), and the
    float32 s2d forward against the dense one."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels, mode="unit")
    state = ae.state_dict()
    results = {}
    for layout in LAYOUTS:
        log(f"-- AE forward, {layout}")
        served, reference = (autoencoder_6stage(dtype=dt, device="cuda", **LAYOUTS[layout])
                             for dt in (torch.bfloat16, torch.float32))
        for m in (served, reference):
            m.load_state_dict(state, strict=True)
            m.eval()
        results[layout] = check_forwards(served, reference, x, PER_FORWARD[layout],
                                         agreement=False, path=True)
        del served, reference
    report["ae"]["forwards"] = {k: v["pairs"] for k, v in results.items()}
    report["ae"]["layouts"] = check_layouts_agree(results["s2d"]["f32"],
                                                  results["dense"]["f32"], "AE b8",
                                                  agreement=False)


def write_recon_caches(data: Path, cache: Path) -> None:
    """Reconstruction-mode decode caches (no masks: a cache of its own) of the
    three splits, from the images of phase 8's segmentation caches, with the
    loader's functions."""
    size = (IMG, IMG)
    for split, (labels, n) in RECIPE_SPLITS.items():
        images_dir = data / split / "resized"
        seg = loader.open_cache(loader.cache_path(cache, images_dir, data / split / labels, size))
        items = ({"image": seg["image"][i], "original_dims": seg["original_dims"][i]}
                 for i in range(n))
        loader.write_cache(loader.cache_path(cache, images_dir, None, size, mode="reconstruction"),
                           loader.cache_identity(sorted(images_dir.glob("*.jpg")), size, False,
                                                 "reconstruction"), items, n, size, False)


def check_csv(path: Path, header: str, lr: list, lr_col: int, loss_cols: slice) -> list:
    """The rows of a training_log.csv; fails unless its header, epochs and
    learning rates are ``header``, 1..n and ``lr``, its losses finite, and
    (with two epochs or more) epoch 2's train loss below epoch 1's."""
    lines = path.read_text().splitlines()
    log("\n".join([f"{path.parent.name}/training_log.csv:", *lines]))
    if lines[0] != header:
        raise AssertionError(f"CSV header {lines[0]!r}")
    rows = [ln.split(",") for ln in lines[1:]]
    if [r[0] for r in rows] != [str(e + 1) for e in range(len(lr))]:
        raise AssertionError(f"CSV epochs {[r[0] for r in rows]}")
    if [r[lr_col] for r in rows] != lr:
        raise AssertionError(f"learning rates {[r[lr_col] for r in rows]}, want {lr}")
    if not all(math.isfinite(float(v)) for r in rows for v in r[loss_cols]):
        raise AssertionError(f"a CSV value is not finite: {rows}")
    if len(rows) > 1 and not float(rows[1][1]) < float(rows[0][1]):
        raise AssertionError(f"epoch 2's train loss {rows[1][1]} is not below epoch 1's "
                             f"{rows[0][1]}")
    return rows


def steady_step_ms(result: dict) -> float:
    """The last epoch's train phase per step, from its first batch on."""
    epoch = result["epochs"][-1]
    return (epoch["train_s"] - epoch["first_batch_s"]) / epoch["steps"] * 1e3


def ae_chain(root: Path) -> None:
    """``cli ae_recon train -> evaluate -> ae_transfer train -> evaluate`` on
    phase 8's dataset, read from warm reconstruction and segmentation caches."""
    data, cache = recipe_data(root)
    write_recon_caches(data, cache)
    test_fwd = -(-RECIPE_SPLITS["Test"][1] // RECIPE_BATCH)
    per_test = times(PER_FORWARD["dense"], test_fwd)
    ae_out, tr_out = root / "ae", root / "transfer"
    common = ["--data_dir", str(data), "--batch_size", str(RECIPE_BATCH),
              "--decode_cache", str(cache)]
    train = ["--save_every", "1", "--epochs", str(RECIPE_EPOCHS), *common]

    result = counted_path(lambda: cli.main(["ae_recon", "train", "--output_dir", str(ae_out),
                                            *train]),
                          plus(per_epoch(PER_STEP["dense"], RECIPE_EPOCHS),
                               ae_snapshots(RECIPE_EPOCHS)))
    check_csv(ae_out / "training_log.csv", AE_CSV_HEADER,
              [f"{cosine_lr(1e-3, RECIPE_EPOCHS)(e):.7f}" for e in range(RECIPE_EPOCHS)], 5,
              slice(1, 5))
    convert.load_reference_checkpoint(ae_out / "best_model" / "model.pth", device="cuda",
                                      arch="ae_recon")
    log("ae_recon best_model/model.pth loads strictly through "
        "load_reference_checkpoint(arch='ae_recon')")
    report["ae"]["recipe_steady_ms"] = steady_step_ms(result)
    torch.cuda.empty_cache()

    def ae_evaluate(name: str, *flags: str) -> dict:
        cli.main(["ae_recon", "evaluate", "--model_path", str(ae_out / "best_model"),
                  "--output_dir", str(ae_out / name), "--visualize_samples", "0", *common,
                  *flags])
        results = json.loads((ae_out / name / "reconstruction_metrics.json").read_text())
        if tuple(results) != AE_METRIC_KEYS:
            raise AssertionError(f"reconstruction_metrics.json keys {list(results)}")
        return results

    f32 = counted_path(lambda: ae_evaluate("eval_f32", "--f32"), per_test)
    with plain_versions():
        plain = counted(lambda: ae_evaluate("eval_f32_plain", "--f32"), NO_LAUNCHES)
    bf16 = counted_path(lambda: ae_evaluate("eval_bf16"), per_test)
    for k in AE_METRIC_KEYS:
        log(f"ae_recon evaluate {k:<10}: f32 kernels {f32[k]:.7f}, f32 plain {plain[k]:.7f}, "
            f"bf16 kernels {bf16[k]:.7f}")
    far = {k: (f32[k], plain[k]) for k in AE_METRIC_KEYS[:3]
           if not abs(f32[k] - plain[k]) <= AE_EVAL_REL * abs(plain[k])}
    if far or f32["num_images"] != RECIPE_SPLITS["Test"][1]:
        raise AssertionError(f"f32 ae_recon evaluate, kernels against plain, beyond "
                             f"{AE_EVAL_REL} relative: {far}; {f32['num_images']} images")
    if not all(math.isfinite(bf16[k]) for k in AE_METRIC_KEYS[:3]):
        raise AssertionError(f"a bf16 reconstruction metric is not finite: {bf16}")
    torch.cuda.empty_cache()

    result = counted_path(lambda: cli.main([
        "ae_transfer", "train", "--output_dir", str(tr_out), "--pretrained_encoder",
        str(ae_out / "best_model"), *train]), per_epoch(TRANSFER_PER_STEP, RECIPE_EPOCHS))
    check_csv(tr_out / "training_log.csv", SEG_CSV_HEADER,
              [f"{poly_lr(5e-3, RECIPE_EPOCHS)(e):.7f}" for e in range(RECIPE_EPOCHS)], 7,
              slice(1, 7))
    ae_sd = load_checkpoint(ae_out / "best_model")["model_state_dict"]
    tr_sd = load_checkpoint(tr_out / "best_model")["model_state_dict"]
    encoder = [k for k in tr_sd if k.startswith("encoder_stages.")]
    differ = [k for k in encoder if not torch.equal(tr_sd[k], ae_sd[k])]
    log(f"ae_transfer best_model: {len(encoder)} encoder tensors, {len(differ)} differ from "
        f"the ae_recon best_model's")
    if differ or len(encoder) != 6 * 8:
        raise AssertionError(f"the transfer's encoder is not the AE's: {differ}")
    report["ae"]["transfer_recipe_steady_ms"] = steady_step_ms(result)
    torch.cuda.empty_cache()

    counted_path(lambda: cli.main(["ae_transfer", "evaluate", "--model_path",
                                   str(tr_out / "best_model"), "--output_dir",
                                   str(tr_out / "eval"), "--visualize_samples", "0", *common]),
                 per_test)
    scalars = eval_scalars(json.loads((tr_out / "eval" / "evaluation_results.json").read_text()))
    log(f"ae_transfer evaluate (bf16): {scalars}")
    if not all(math.isfinite(v) for v in scalars.values() if not math.isnan(v)):
        raise AssertionError(f"an ae_transfer evaluation scalar is not finite: {scalars}")


@phase(f"9. the AE_pretrained path: autoencoder_6stage and the frozen-encoder transfer "
       f"(b{CHECK_BATCH} checks, b{TRAIN_BATCH} times), then cli ae_recon -> ae_transfer")
def phase_ae(root: Path):
    report["ae"] = {}
    ae = ae_train_steps()
    with tempfile.TemporaryDirectory() as tmp:
        transfer_steps(ae, Path(tmp))
    torch.cuda.empty_cache()
    ae_forwards(ae)
    del ae
    torch.cuda.empty_cache()
    ae_chain(root)
    if "cv2" in sys.modules:
        raise AssertionError("the AE recipes imported cv2")
    phase7 = report.get("train", {}).get("dense", {}).get("step_ms")
    ae = report["ae"]
    for label, key in (("AE train step", "step_ms"), ("transfer train step", "transfer_step_ms"),
                       ("ae_recon recipe, epoch 2 after its first batch", "recipe_steady_ms"),
                       ("ae_transfer recipe, epoch 2 after its first batch",
                        "transfer_recipe_steady_ms")):
        ratio = f", ratio {ae[key] / phase7:.3f}" if phase7 else ""
        log(f"{label}: {ae[key]:.3f} ms per b{TRAIN_BATCH} step; phase 7's b{TRAIN_BATCH} "
            f"dense step {phase7 if phase7 else float('nan'):.3f} ms{ratio}")


def tower_flops(config, batch: int) -> float:
    """Multiply-adds x 2 of the tower's forward on ``batch`` images: the
    patch conv, and per block the q/k/v, the scores, the weighted sum, the
    out projection and the MLP (the LayerNorms, softmax and activations are
    elementwise and left out); ``ln_post``'s projection on one token."""
    w, n, p = config.width, config.grid ** 2 + 1, config.patch_size
    patch = config.grid ** 2 * w * 3 * p * p
    block = n * w * 3 * w + 2 * n * n * w + n * w * w + 2 * n * w * 4 * w
    return 2.0 * batch * (patch + config.layers * block + w * config.output_dim)


def _bf16_stream_block(block, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ResidualAttentionBlock.forward`` with a precision slip: the residual
    stream rounded to ``dtype`` at each addition (Flax keeps it float32)."""
    x = (x + block.attn(clip_model._layer_norm(x, block.ln_1), dtype)).to(dtype)
    y = clip_model.quick_gelu(clip_model._linear(clip_model._layer_norm(x, block.ln_2),
                                                 block.mlp.c_fc, dtype))
    return (x + clip_model._linear(y, block.mlp.c_proj, dtype)).to(dtype)


def _bf16_layer_norm(x: torch.Tensor, ln: torch.nn.LayerNorm) -> torch.Tensor:
    """``_layer_norm`` with a precision slip: input, affine and output in
    bf16 (Flax computes them in float32), widened after."""
    bf = torch.bfloat16
    return F.layer_norm(x.to(bf), ln.normalized_shape, ln.weight.to(bf), ln.bias.to(bf),
                        ln.eps).float()


# The tower's controls: (owner, attribute, replacement) of each slip.
TOWER_SLIPS = {
    "residual stream in bf16": (clip_model.ResidualAttentionBlock, "forward", _bf16_stream_block),
    "LayerNorms in bf16": (clip_model, "_layer_norm", _bf16_layer_norm),
}


def clip_tower() -> torch.Tensor:
    """The frozen ViT-B/16 tower from seed CLIP_SEED at b64 224²: bf16
    against float32 (TF32 off) within TOWER_BF16_REL_L2, a second bf16 call
    bit for bit, no kernel launch; the bf16 time by CUDA events beside the
    bound; the controls of TOWER_SLIPS against float32, printed. Returns the
    bf16 embeddings."""
    extractor = ClipFeatureExtractor("ViT-B/16", dtype=torch.bfloat16, device="cuda",
                                     seed=clip_unet.CLIP_SEED)
    tower = extractor.model
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    pixels = torch.randint(0, 256, (TOWER_BATCH, TOWER_SIDE, TOWER_SIDE, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    with torch.inference_mode():
        bf16 = counted(lambda: extractor(pixels), NO_LAUNCHES)
        again = counted(lambda: extractor(pixels), NO_LAUNCHES)
        x = normalize_image(pixels)
        tower.dtype = torch.float32
        f32 = counted(lambda: tower(x), NO_LAUNCHES)
        tower.dtype = torch.bfloat16
        ms = cuda_times(tower, [x], iters=10, warmup=3)
        controls = {}
        for name, (owner, attr, slip) in TOWER_SLIPS.items():
            with mock.patch.object(owner, attr, slip):
                controls[name] = rel_l2(counted(lambda: tower(x), NO_LAUNCHES), f32)
    rel, repeat = rel_l2(bf16, f32), torch.equal(bf16, again)
    flops = tower_flops(tower.config, TOWER_BATCH)
    bound = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    med = statistics.median(ms)
    log(f"tower ViT-B/16 b{TOWER_BATCH} {TOWER_SIDE}²: bf16 vs f32 embeddings rel-L2 {rel:.4e} "
        f"(bound {TOWER_BF16_REL_L2:g}); a second bf16 call repeats bit for bit: {repeat}; "
        f"no kernel launch")
    log("tower controls, each a precision slip, bf16 vs f32 embeddings rel-L2: "
        + "; ".join(f"{k} {v:.4e} ({v / TOWER_BF16_REL_L2:.2f}x the bound)"
                    for k, v in controls.items()))
    log(f"tower ViT-B/16 b{TOWER_BATCH} bf16 forward: {spread(ms)}; bound {bound:.4f} ms "
        f"({flops / 1e12:.4f} TFLOP at {BF16_TENSOR_FLOPS_PER_S / 1e12:g} TFLOP/s bf16, "
        f"{bound / med:.1%} of it); {TOWER_BATCH / med * 1e3:.1f} img/s")
    report["clip"].update(tower_rel_l2=rel, tower_ms=med, tower_bound_ms=bound,
                          tower_controls=controls)
    if not (rel <= TOWER_BF16_REL_L2 and repeat and bool(torch.isfinite(bf16).all())):
        raise AssertionError(f"the bf16 tower: rel-L2 {rel:.4e}, repeats {repeat}")
    return bf16


def clip_batch(seed: int, batch: int, features: torch.Tensor) -> dict:
    """A segmentation batch on the card with the tower's embeddings."""
    out = device_batch(as_uint8(synthetic_batch(seed, batch, IMG)))
    out["clip_features"] = features[:batch].clone()
    return out


def clip_train_steps(features: torch.Tensor) -> torch.nn.Module:
    """The fusion model's train step (dense, bf16, SGD-Nesterov): the b8
    checks of phase 7, 10 b8 steps that must lower the loss, the b16 time
    and peak memory. Returns the model after the timed steps."""
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 16), clip_fusion=True)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    check = clip_batch(SEED + 17, CHECK_BATCH, features)
    report["clip"]["check"] = check_train_step("dense", state, check, "clip")
    torch.cuda.empty_cache()

    trained = train_model("dense", state, torch.bfloat16, "clip")
    step = OBJECTIVES["clip"][1](trained)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = [counted_path(lambda: float(step(check, gen)), CLIP_PER_STEP["dense"])
              for _ in range(TRAIN_STEPS_DOWN)]
    log(f"CLIP {TRAIN_STEPS_DOWN} steps on one b{CHECK_BATCH} batch: losses "
        + " ".join(f"{v:.4f}" for v in losses))
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the CLIP model's loss did not go down: {losses}")
    del trained, step, check
    torch.cuda.empty_cache()

    batch = clip_batch(SEED + 18, CLIP_BATCH, features)
    step = OBJECTIVES["clip"][1](model)
    med, peak = timed_steps("CLIP train step", step, batch, CLIP_PER_STEP["dense"],
                            batch_size=CLIP_BATCH)
    n = RECIPE_SPLITS["Train"][1] // CLIP_BATCH
    host = [host_steps_ms(step, batch, n, CLIP_PER_STEP["dense"])
            for _ in range(OVERHEAD_REPEATS)]
    log(f"CLIP train step b{CLIP_BATCH}, {n} steps back to back by the host clock: "
        + ", ".join(f"{v:.3f}" for v in host) + " ms per step")
    report["clip"].update(step_ms=med, peak_gib=peak, host_step_ms=host)
    return model


def host_steps_ms(step, batch: dict, n: int, expected: dict) -> float:
    """Milliseconds per step of ``n`` steps issued back to back, by the
    host clock with the card synchronized at both ends: the recipe loop's
    own timer around the same work, without its loader and copies."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        counted_path(lambda: step(batch, gen), expected)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def clip_forwards(model: torch.nn.Module, features: torch.Tensor) -> None:
    """The fusion model's b8 forward in both layouts, bf16 and float32, with
    the kernels against the plain versions (phase 4's bounds), without
    features (22/5/0/0), and float32 s2d against float32 dense."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x, cf = normalize_image(pixels), features[:SERVE_BATCH]
    state = model.state_dict()
    results = {}
    for layout in LAYOUTS:
        log(f"-- CLIP forward, {layout}")
        served, reference = (unet_6stage(dtype=dt, device="cuda", clip_fusion=True,
                                         **LAYOUTS[layout])
                             for dt in (torch.bfloat16, torch.float32))
        for m in (served, reference):
            m.load_state_dict(state, strict=True)
            m.eval()
        results[layout] = check_forwards(lambda v: served(v, cf), lambda v: reference(v, cf), x,
                                         CLIP_PER_FORWARD[layout], path=True)
        if layout == "dense":
            with torch.inference_mode():
                plain = counted_path(lambda: served(x), PER_FORWARD["dense"])
                fused = served(x, cf)
            moved = rel_l2(fused, plain)
            log(f"dense forward without features: launches {PER_FORWARD['dense']}; its logits "
                f"against the fused forward's: rel-L2 {moved:.4e}")
            if not moved > 0:
                raise AssertionError("the features do not change the fused forward")
        del served, reference
    report["clip"]["forwards"] = {k: v["pairs"] for k, v in results.items()}
    report["clip"]["layouts"] = check_layouts_agree(results["s2d"]["f32"],
                                                    results["dense"]["f32"], "CLIP b8")


def write_clip_caches(data: Path, cache: Path) -> None:
    """Decode caches with the CLIP view for phase 8's dataset, written with
    the loader's functions: for each split, the segmentation dataset's (its
    masks) and ``clip_unet embed``'s (no masks). Each view is the 512² image
    resized to 224² bilinearly on the card (the card has no cv2)."""
    size, cs = (IMG, IMG), TOWER_SIDE
    for split, (labels, n) in RECIPE_SPLITS.items():
        images_dir, masks_dir = data / split / "resized", data / split / labels
        seg = loader.open_cache(loader.cache_path(cache, images_dir, masks_dir, size))
        with torch.inference_mode():
            views = torch.cat([
                resize_bilinear(torch.from_numpy(np.array(seg["image"][i:i + 64])).to(
                    "cuda", torch.float32), (cs, cs)).round().clamp(0, 255).to(torch.uint8)
                for i in range(0, n, 64)]).cpu().numpy()
        files = sorted(images_dir.glob("*.jpg"))
        for masks in (masks_dir, None):
            def items():
                for i in range(n):
                    item = {"image": seg["image"][i], "original_dims": seg["original_dims"][i],
                            "clip_image": views[i]}
                    if masks is not None:
                        item["mask"] = seg["mask"][i]
                    yield item

            has_masks = masks is not None
            loader.write_cache(loader.cache_path(cache, images_dir, masks, size, clip_size=cs),
                               loader.cache_identity(files, size, has_masks, clip_size=cs),
                               items(), n, size, has_masks, clip_size=cs)


def clip_chain(root: Path) -> None:
    """``cli clip_unet embed -> train --embeddings_dir -> evaluate`` (with the
    tables, with live extraction, without features; float32 with the kernels
    and with the plain versions) on phase 8's dataset, from warm decode caches
    that hold the CLIP view."""
    data, cache = recipe_data(root)
    write_clip_caches(data, cache)
    emb, out = data / "clip_embeddings", root / "clip"
    common = ["--data_dir", str(data), "--decode_cache", str(cache)]
    n_test = RECIPE_SPLITS["Test"][1]
    test_fwd = -(-n_test // CLIP_BATCH)

    written = counted(lambda: cli.main(["clip_unet", "embed", *common]), NO_LAUNCHES)
    # The tables against a live extraction of the same images at the same
    # batch, by a tower built anew from the same seed: bit for bit.
    extractor = ClipFeatureExtractor("ViT-B/16", dtype=torch.bfloat16, device="cuda",
                                     seed=clip_unet.CLIP_SEED)
    for split in RECIPE_SPLITS:
        ds = loader.PetDataset(data / split / "resized", None, include_augmented=False,
                               clip_dir=data / split / "resized_clip", cache_dir=cache)
        table = clip_unet._load_embedding_table(emb, split, ds, "ViT-B/16", verbose=False)
        live = clip_unet._embedding_table(extractor, ds, TOWER_BATCH)
        if table is None or not np.array_equal(table, live):
            raise AssertionError(f"the {split} table differs from live extraction")
    del extractor
    log(f"clip_unet embed: {sorted(written)}; each table's rows equal a live extraction at "
        f"b{TOWER_BATCH} bit for bit")

    result = counted_path(lambda: cli.main([
        "clip_unet", "train", "--output_dir", str(out), "--save_every", "1", "--epochs",
        str(CLIP_EPOCHS), "--embeddings_dir", str(emb), *common]),
        per_epoch(CLIP_PER_STEP["dense"], CLIP_EPOCHS, CLIP_BATCH, CLIP_PER_FORWARD["dense"]))
    check_csv(out / "training_log.csv", SEG_CSV_HEADER,
              [f"{poly_lr(5e-3, CLIP_EPOCHS)(e):.7f}" for e in range(CLIP_EPOCHS)], 7,
              slice(1, 7))
    model = unet_6stage(device="cuda", clip_fusion=True)
    for d in [*(out / "checkpoints" / f"epoch_{e + 1}" for e in range(CLIP_EPOCHS)),
              out / "best_model"]:
        model.load_state_dict(load_checkpoint(d)["model_state_dict"], strict=True)
        config = json.loads((d / "meta.json").read_text())["config"]
        if config != clip_unet.ARCH_CONFIG or not config["with_clip_features"]:
            raise AssertionError(f"{d}/meta.json config {config}")
    del model
    log(f"checkpoints epoch_1..{CLIP_EPOCHS} and best_model load strictly, the fusion's keys "
        f"included; meta.json config {clip_unet.ARCH_CONFIG}")
    report["clip"]["recipe_steady_ms"] = [
        (e["train_s"] - e["first_batch_s"]) / e["steps"] * 1e3 for e in result["epochs"][1:]]
    torch.cuda.empty_cache()

    def evaluate(name: str, expected: dict, *flags: str) -> dict:
        def run():
            cli.main(["clip_unet", "evaluate", "--model_path", str(out / "best_model"),
                      "--output_dir", str(out / name), "--batch_size", str(CLIP_BATCH),
                      "--visualize_samples", "0", *common, *flags])
        (counted_path if expected != NO_LAUNCHES else counted)(run, expected)
        return eval_scalars(json.loads((out / name / "evaluation_results.json").read_text()))

    per_test = times(CLIP_PER_FORWARD["dense"], test_fwd)
    runs = {"tables": evaluate("eval_tables", per_test, "--embeddings_dir", str(emb)),
            "live": evaluate("eval_live", per_test),
            "no features": evaluate("eval_plain", times(PER_FORWARD["dense"], test_fwd),
                                    "--no_clip_features"),
            "f32 tables": evaluate("eval_f32", per_test, "--f32", "--embeddings_dir", str(emb))}
    with plain_versions():
        runs["f32 plain"] = evaluate("eval_f32_plain", NO_LAUNCHES, "--f32", "--embeddings_dir",
                                     str(emb))
    log(f"{'scalar':<22} " + " ".join(f"{k:>12}" for k in runs))
    for k in runs["tables"]:
        log(f"{k:<22} " + " ".join(f"{r[k]:12.6f}" for r in runs.values()))

    def far(a: dict, b: dict, atol: float) -> dict:
        # Two NaNs agree: a class that neither run predicts has no precision.
        return {k: (a[k], b[k]) for k in a
                if not (abs(a[k] - b[k]) <= atol or math.isnan(a[k]) and math.isnan(b[k]))}

    far_live = far(runs["tables"], runs["live"], CLIP_TABLE_ATOL)
    far_plain = far(runs["f32 tables"], runs["f32 plain"], RECIPE_EVAL_ATOL)
    if far_live or far_plain:
        raise AssertionError(f"evaluate: tables against live beyond {CLIP_TABLE_ATOL}: "
                             f"{far_live}; f32 kernels against plain beyond {RECIPE_EVAL_ATOL}: "
                             f"{far_plain}")
    if not all(math.isfinite(v) for v in runs["no features"].values() if not math.isnan(v)):
        raise AssertionError(f"an evaluation scalar without features is not finite: {runs}")


@phase(f"10. the CLIP_UNet path: the ViT-B/16 tower (b{TOWER_BATCH}), unet_6stage with "
       f"clip_fusion (b{CHECK_BATCH} checks, b{CLIP_BATCH} times), then cli clip_unet "
       f"embed -> train -> evaluate")
def phase_clip(root: Path):
    report["clip"] = {}
    parts, t0 = {}, time.perf_counter()
    features = clip_tower()
    torch.cuda.empty_cache()
    parts["tower"], t0 = time.perf_counter() - t0, time.perf_counter()
    model = clip_train_steps(features)
    torch.cuda.empty_cache()
    parts["train steps"], t0 = time.perf_counter() - t0, time.perf_counter()
    clip_forwards(model, features)
    del model
    torch.cuda.empty_cache()
    parts["forwards"], t0 = time.perf_counter() - t0, time.perf_counter()
    clip_chain(root)
    parts["cli chain"] = time.perf_counter() - t0
    log("phase 10 wall time by part: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    if "cv2" in sys.modules:
        raise AssertionError("the CLIP recipe imported cv2")
    phase7 = report.get("train", {}).get("dense", {}).get("step_ms")
    clip = report["clip"]
    ratio = f", ratio {clip['step_ms'] / phase7:.3f}" if phase7 else ""
    log(f"CLIP train step: {clip['step_ms']:.3f} ms per b{CLIP_BATCH} step (peak "
        f"{clip['peak_gib']:.2f} GiB); phase 7's b{TRAIN_BATCH} dense step "
        f"{phase7 if phase7 else float('nan'):.3f} ms{ratio}")
    # The recipe's overhead: each of epochs 2..CLIP_EPOCHS after its first
    # batch against each host-clock reading of the isolated step, both over
    # an epoch's steps; the mean difference and its range.
    recipe, host = clip["recipe_steady_ms"], clip["host_step_ms"]
    diffs = [r - h for r in recipe for h in host]
    log(f"clip_unet recipe after the first batch, epochs 2-{CLIP_EPOCHS}: "
        + ", ".join(f"{v:.3f}" for v in recipe) + f" ms per step; the isolated step by the "
        f"host clock: " + ", ".join(f"{v:.3f}" for v in host) + " ms per step")
    log(f"clip_unet recipe overhead per b{CLIP_BATCH} step: mean "
        f"{statistics.mean(recipe) - statistics.mean(host):+.3f} ms "
        f"(range {min(diffs):+.3f} to {max(diffs):+.3f} ms over {len(diffs)} pairs; "
        f"ratio {statistics.mean(recipe) / statistics.mean(host):.3f})")


def augment_batch_u8() -> tuple[torch.Tensor, torch.Tensor]:
    """AUG_BATCH synthetic 512² images, half cats and half dogs, as uint8
    pixels and uint8 {0, 1, 2, 255} masks on the card."""
    rng = np.random.default_rng(SEED + 20)
    pairs = {1: [], 2: []}
    while min(len(v) for v in pairs.values()) < AUG_BATCH // 2:
        image, mask = synthetic_sample(rng, IMG)
        cls = int(mask.max(initial=0, where=mask != 255))
        if len(pairs[cls]) < AUG_BATCH // 2:
            pairs[cls].append((image, mask))
    images, masks = zip(*(pairs[1] + pairs[2]))
    pixels = as_uint8({"image": np.stack(images)})["image"]
    return (torch.from_numpy(pixels).to("cuda"),
            torch.from_numpy(np.stack(masks).astype(np.uint8)).to("cuda"))


def augment_bytes_bound_ms(images: torch.Tensor, masks: torch.Tensor) -> float:
    """One read of the uint8 image and mask, one write of the float32 image
    and of the mask, at the memory rate."""
    return bytes_ms(images.numel() * (1 + 4) + masks.numel() * 2 * masks.element_size())


def augment_on_card() -> None:
    """``sample_params`` on a CUDA generator at b32 512², ``apply_params`` on
    the card against the CPU on the same draws, a repeat bit for bit, no
    host synchronization inside ``augment_and_normalize``, and its time."""
    images, masks = augment_batch_u8()
    classes = augment.mask_classes(masks)
    if classes.tolist() != [0] * (AUG_BATCH // 2) + [1] * (AUG_BATCH // 2):
        raise AssertionError(f"classes from the masks: {classes.tolist()}")
    images01 = normalize_image(images, mode="unit")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    params = augment.sample_params(gen, classes, None, IMG, IMG)
    card = counted(lambda: augment.apply_params(params, images01, masks), NO_LAUNCHES)
    again = augment.apply_params(params, images01, masks)
    if not (torch.equal(card[0], again[0]) and torch.equal(card[1], again[1])):
        raise AssertionError("a second apply_params on the card differs")
    t0 = time.perf_counter()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu = augment.apply_params(cpu_params, images01.cpu(), masks.cpu())
    cpu_s = time.perf_counter() - t0
    err = (card[0].cpu() - cpu[0]).abs().max().item()
    agree = (card[1].cpu() == cpu[1]).float().mean().item()
    pre_card = augment._warp_and_colour(params, images01, masks)[0].cpu()
    pre_cpu = augment._warp_and_colour(cpu_params, images01.cpu(), masks.cpu())[0]

    def u8(x):
        return torch.clamp(x * 255.0, 0, 255).to(torch.int32)

    bins = int((u8(pre_card) != u8(pre_cpu)).sum())
    gates = {k: int(params[k].sum()) for k in ("flip", "ssr", "rrc", "perspective", "distort",
                                                "dropout", "color", "hist", "noise",
                                                "saltpepper", "iso", "lighting")}
    log(f"apply_params b{AUG_BATCH} 512², card against CPU on the card's draws: image max "
        f"|error| {err:.3e} (gate {AUG_IMAGE_MAX_ABS}), mask agreement {agree:.6f} (gate "
        f"{AUG_MASK_AGREEMENT}), pre-histogram values in another uint8 bin {bins}; a second "
        f"card call bit for bit; the CPU took {cpu_s:.1f} s; gates taken of {AUG_BATCH}: {gates}")
    if not (err <= AUG_IMAGE_MAX_ABS and agree >= AUG_MASK_AGREEMENT):
        raise AssertionError(f"apply_params on the card against the CPU: max |error| {err}, "
                             f"mask agreement {agree}")
    if not (card[0].min() >= 0 and card[0].max() <= 1 and
            set(card[1].unique().tolist()) <= {0, 1, 2, 255}):
        raise AssertionError("augmented pixels leave [0, 1] or masks leave {0, 1, 2, 255}")
    del card, again, cpu, params, cpu_params, pre_card, pre_cpu
    torch.cuda.empty_cache()

    # Time: the whole online call, uint8 in, normalized float32 out.
    tables = augment.policy_arrays(None, torch.device("cuda"))
    gens = [torch.Generator(device="cuda").manual_seed(SEED + 22 + i) for i in range(8)]

    def call(g):
        return augment.augment_and_normalize(g, images, masks, policy=tables)

    call(gens[0])  # first use: the per-device constants are copied to the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counted(lambda: call(gens[1]), NO_LAUNCHES)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_times(call, gens, iters=AUG_TIMED, warmup=AUG_WARMUP)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        call(gens[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # Device time by the aten op that launched it.
    ops = [(e.key, e.count, getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0)) for e in prof.key_averages()
           if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda o: -o[2])[:10]
    bound = augment_bytes_bound_ms(images, masks)
    med = statistics.median(ms)
    log(f"augment_and_normalize b{AUG_BATCH} 512² (uint8 in, float32 out), CUDA events: "
        f"{spread(ms)}; {len(kernels)} device kernels and copies per call, their device time "
        f"{device_ms:.3f} ms; peak memory above its inputs {peak:.2f} GiB; bytes bound "
        f"{bound:.4f} ms ({bound / med:.2%} of the median); no host synchronization inside "
        f"the call (torch.cuda.set_sync_debug_mode('error'))")
    log("its device time by aten op, the largest: " + "; ".join(
        f"{name} x{n} {us / 1e3:.3f} ms" for name, n, us in top))
    report["augment"].update(ms=med, launches=len(kernels), device_ms=device_ms, peak_gib=peak,
                             bound_ms=bound, max_abs=err, mask_agreement=agree, bins=bins)


def pretrained_ae(root: Path) -> Path:
    """Phase 9's autoencoder ``best_model``; where phase 9 wrote none, one
    saved from a seeded ``autoencoder_6stage``."""
    path = root / "ae" / "best_model"
    if not (path / "model.pth").is_file():
        save_checkpoint(root / "ae_seeded", autoencoder_6stage(
            device="cuda", generator=torch.Generator().manual_seed(SEED + 23)), None, 0, 0.0)
        path = root / "ae_seeded"
    return path


def augment_recipes(root: Path) -> None:
    """``cli our_unet|clip_unet|ae_transfer train --online_augment`` on phase
    8's dataset: launch counts, the tower once per training batch and no
    Train table in clip_unet, the CSVs and checkpoints, the time per step."""
    data, cache = recipe_data(root)
    common = ["--data_dir", str(data), "--decode_cache", str(cache), "--online_augment",
              "--save_every", "1"]
    out = root / "aug_run"
    result = counted_path(lambda: cli.main([
        "our_unet", "train", "--output_dir", str(out), "--batch_size", str(RECIPE_BATCH),
        "--epochs", str(RECIPE_EPOCHS), *common]), per_epoch(PER_STEP["dense"], RECIPE_EPOCHS))
    check_csv(out / "training_log.csv", SEG_CSV_HEADER,
              [f"{poly_lr(5e-3, RECIPE_EPOCHS)(e):.7f}" for e in range(RECIPE_EPOCHS)], 7,
              slice(1, 7))
    for d in [*(out / "checkpoints" / f"epoch_{e + 1}" for e in range(RECIPE_EPOCHS)),
              out / "best_model"]:
        if not ((d / "model.pth").is_file() and (d / "meta.json").is_file()):
            raise AssertionError(f"{d} lacks model.pth or meta.json")
    convert.load_reference_checkpoint(out / "best_model" / "model.pth", device="cuda")
    if json.loads((out / "training_config.json").read_text())["online_augment"] is not True:
        raise AssertionError("training_config.json does not record online_augment")
    report["augment"]["recipe_steady_ms"] = steady_step_ms(result)
    torch.cuda.empty_cache()

    # CLIP: live extraction from the augmented view, no Train table.
    val = data / "Val"
    if not (loader.cache_path(cache, val / "resized", val / "processed_labels", (IMG, IMG),
                              clip_size=TOWER_SIDE) / loader.MANIFEST).exists():
        write_clip_caches(data, cache)
    tower_calls, tables_built = [], []
    extract, build = ClipFeatureExtractor.__call__, clip_unet._embedding_table

    def counted_extract(self, images):
        tower_calls.append(tuple(images.shape))
        return extract(self, images)

    def counted_build(extractor, dataset, *args):
        tables_built.append(dataset.images_dir.parent.name)
        return build(extractor, dataset, *args)

    with mock.patch.object(ClipFeatureExtractor, "__call__", counted_extract), \
            mock.patch.object(clip_unet, "_embedding_table", counted_build):
        result = counted_path(lambda: cli.main([
            "clip_unet", "train", "--output_dir", str(root / "aug_clip"), "--batch_size",
            str(CLIP_BATCH), "--epochs", str(RECIPE_EPOCHS), *common]),
            per_epoch(CLIP_PER_STEP["dense"], RECIPE_EPOCHS, CLIP_BATCH,
                      CLIP_PER_FORWARD["dense"]))
    check_csv(root / "aug_clip" / "training_log.csv", SEG_CSV_HEADER,
              [f"{poly_lr(5e-3, RECIPE_EPOCHS)(e):.7f}" for e in range(RECIPE_EPOCHS)], 7,
              slice(1, 7))
    steps = RECIPE_EPOCHS * (RECIPE_SPLITS["Train"][1] // CLIP_BATCH)
    live = [s for s in tower_calls if s == (CLIP_BATCH, TOWER_SIDE, TOWER_SIDE, 3)]
    log(f"clip_unet --online_augment: {result['step']} steps, {len(live)} tower calls on "
        f"b{CLIP_BATCH} augmented views, tables computed for {tables_built}")
    if result["step"] != steps or len(live) != steps or tables_built != ["Val"]:
        raise AssertionError(f"clip_unet --online_augment: {result['step']} steps, tower calls "
                             f"{tower_calls}, tables {tables_built}")
    report["augment"]["clip_steady_ms"] = steady_step_ms(result)
    torch.cuda.empty_cache()

    result = counted_path(lambda: cli.main([
        "ae_transfer", "train", "--output_dir", str(root / "aug_transfer"),
        "--pretrained_encoder", str(pretrained_ae(root)), "--batch_size", str(RECIPE_BATCH),
        "--epochs", "1", *common]), per_epoch(TRANSFER_PER_STEP, 1))
    report["augment"]["transfer_steady_ms"] = steady_step_ms(result)


@phase(f"11. online augmentation: data/augment.py at b{AUG_BATCH} 512² on the card against "
       f"the CPU and timed, then cli our_unet|clip_unet|ae_transfer train --online_augment")
def phase_augment(root: Path):
    report["augment"] = {}
    augment_on_card()
    augment_recipes(root)
    if "cv2" in sys.modules:
        raise AssertionError("online augmentation imported cv2")
    a = report["augment"]
    phase7 = report.get("train", {}).get("dense", {}).get("step_ms")
    phase8 = report.get("recipe", {}).get("steady_step_ms")
    clip = report.get("clip", {})
    beside = [f"phase 7's isolated b{TRAIN_BATCH} step {phase7:.3f} ms (ratio "
              f"{a['recipe_steady_ms'] / phase7:.3f})" if phase7 else "",
              f"phase 8's run without augmentation {phase8:.3f} ms (ratio "
              f"{a['recipe_steady_ms'] / phase8:.3f}, {a['recipe_steady_ms'] - phase8:+.3f} ms)"
              if phase8 else ""]
    log(f"our_unet --online_augment, epoch {RECIPE_EPOCHS} after its first batch: "
        f"{a['recipe_steady_ms']:.3f} ms per b{RECIPE_BATCH} step; "
        + "; ".join(b for b in beside if b))
    clip_steady = statistics.mean(clip["recipe_steady_ms"]) if clip.get("recipe_steady_ms") \
        else None
    log(f"clip_unet --online_augment, epoch {RECIPE_EPOCHS} after its first batch: "
        f"{a['clip_steady_ms']:.3f} ms "
        f"per b{CLIP_BATCH} step" + (f"; phase 10's run on tables {clip_steady:.3f} ms "
                                     f"({a['clip_steady_ms'] - clip_steady:+.3f} ms)"
                                     if clip_steady else ""))
    transfer = report.get("ae", {}).get("transfer_recipe_steady_ms")
    log(f"ae_transfer --online_augment, epoch 1 after its first batch: "
        f"{a['transfer_steady_ms']:.3f} ms per b{RECIPE_BATCH} step"
        + (f"; phase 9's run without augmentation (epoch 2) {transfer:.3f} ms" if transfer
           else ""))


def params_of(model: torch.nn.Module) -> dict:
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}


def worst_rel(params: dict, ref: dict, groups: dict) -> tuple[float, str]:
    """The largest rel-L2 of a parameter group (``grad_groups``: a conv's
    bias goes with its weight where an InstanceNorm cancels the bias, whose
    exact gradient is zero) of ``params`` to ``ref``, and the group's
    name."""
    rel = group_rel_l2(params, ref, groups)
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def moved(params: dict, before: dict) -> float:
    """The rel-L2 of one update: all parameters after it against before."""
    return rel_l2(torch.cat([params[k].reshape(-1) for k in before]),
                  torch.cat([before[k].float().reshape(-1) for k in before]))


def accum_run(state: dict, batch: dict) -> tuple[float, dict]:
    """One float32 b32 step as ACCUM microbatches (counted: PER_ACCUM_STEP):
    the loss and the updated parameters."""
    model = train_model("dense", state, torch.float32)
    step = make_accum_train_step(model, sgd_nesterov(model.parameters()),
                                 make_segmentation_loss_fn(), ACCUM)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with deterministic():
        loss = counted_path(lambda: float(step(batch, gen)), PER_ACCUM_STEP)
    return loss, params_of(model)


def accum_oracle(state: dict, batch: dict) -> tuple[float, dict]:
    """The accumulated step spelled out: ACCUM plain forward and backward
    passes of the microbatches ``batch[i::ACCUM]`` with the kernels, each with
    ``microbatch_generator``'s dropout, their gradients summed in float32 and
    divided by ACCUM, one update."""
    model = train_model("dense", state, torch.float32)
    optimizer = sgd_nesterov(model.parameters())
    loss_fn = make_segmentation_loss_fn()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = list(model.parameters())
    sums = [torch.zeros_like(p) for p in params]
    losses = []

    def passes():
        model.train()
        for i in range(ACCUM):
            micro = {k: v[i::ACCUM].contiguous() for k, v in batch.items()}
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model, micro, microbatch_generator(gen, i))
            loss.backward()
            for acc, p in zip(sums, params):
                acc += p.grad
            losses.append(float(loss.detach()))

    with deterministic():
        counted(passes, PER_ACCUM_STEP)
    for acc, p in zip(sums, params):
        p.grad = acc / ACCUM
    optimizer.step()
    return sum(losses) / ACCUM, params_of(model)


def accum_steps() -> None:
    """(a): the accumulated step against its oracle, repeated bit for bit,
    then the bf16 times of b32 as 4 x b8 and b128 as 4 x b32."""
    model = unet_6stage(dtype=torch.float32, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 12))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    groups = grad_groups(model)
    del model
    check = device_batch(as_uint8(synthetic_batch(SEED + 12, TRAIN_BATCH, IMG)))
    loss, params = accum_run(state, check)
    oracle_loss, oracle = accum_oracle(state, check)
    loss2, params2 = accum_run(state, check)
    loss_rel = abs(loss - oracle_loss) / abs(oracle_loss)
    rel, worst = worst_rel(params, oracle, groups)
    repeat = loss2 == loss and all(torch.equal(params2[k], params[k]) for k in params)
    log(f"accumulated b{TRAIN_BATCH} = {ACCUM} x b{TRAIN_BATCH // ACCUM} step, float32, kernels: "
        f"loss {loss:.7f}, oracle {oracle_loss:.7f} (rel {loss_rel:.3e}); updated parameters "
        f"worst group rel-L2 {rel:.3e} ({worst}), the update itself {moved(params, state):.3e}; "
        f"a second call bit for bit: {repeat}; launches per step "
        f"{ {k: v for k, v in PER_ACCUM_STEP.items() if v} }")
    if not (loss_rel <= ACCUM_REL and rel <= ACCUM_REL and repeat and math.isfinite(loss)):
        raise AssertionError(f"the accumulated step misses its gates (loss rel {loss_rel:.3e}, "
                             f"params {rel:.3e}, repeat {repeat}; bound {ACCUM_REL:g})")
    report["accum"] = {"loss_rel": loss_rel, "param_rel": rel}
    del check, params, params2, oracle
    torch.cuda.empty_cache()

    phase7 = report.get("train", {}).get("dense", {})
    for batch_size in (TRAIN_BATCH, ACCUM_BIG_BATCH):
        model = train_model("dense", state, torch.bfloat16)
        step = make_accum_train_step(model, sgd_nesterov(model.parameters()),
                                     make_segmentation_loss_fn(), ACCUM)
        batch = device_batch(as_uint8(synthetic_batch(SEED + 13, batch_size, IMG)))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_times(lambda b: counted_path(lambda: step(b, gen), PER_ACCUM_STEP), [batch],
                        iters=ACCUM_TIMED, warmup=ACCUM_WARMUP)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # One more step by the host clock: when the host returns from it
        # (every op enqueued, no synchronize inside) and when the card is done.
        # Close together, the step is bound by the host's dispatch.
        t0 = time.perf_counter()
        loss = counted_path(lambda: step(batch, gen), PER_ACCUM_STEP)
        host_ms = (time.perf_counter() - t0) * 1e3
        last = float(loss)
        done_ms = (time.perf_counter() - t0) * 1e3
        med = statistics.median(ms)
        log(f"b{batch_size} as {ACCUM} x b{batch_size // ACCUM}, bf16: {spread(ms)}, "
            f"{batch_size / med * 1e3:.1f} img/s, peak memory {peak:.2f} GiB, loss {last:.4f}; "
            f"one more step: the host returned after {host_ms:.3f} ms, the card finished after "
            f"{done_ms:.3f} ms; phase 7's plain b{TRAIN_BATCH} step "
            f"{phase7.get('step_ms', float('nan')):.3f} ms, peak "
            f"{phase7.get('peak_gib', float('nan')):.2f} GiB")
        if not math.isfinite(last):
            raise AssertionError(f"the b{batch_size} accumulated loss is not finite")
        report["accum"][f"b{batch_size}"] = {"ms": med, "peak_gib": peak, "host_ms": host_ms}
        del model, step, batch
        torch.cuda.empty_cache()


def accum_recipes(root: Path) -> None:
    """(b): ``cli our_unet train --grad_accum 4`` and ``cli ae_recon train
    --grad_accum 2``, one epoch each on phase 8's dataset."""
    data, cache = recipe_data(root)
    recon = loader.cache_path(cache, data / "Train" / "resized", None, (IMG, IMG),
                              mode="reconstruction")
    if not (recon / loader.MANIFEST).exists():
        write_recon_caches(data, cache)
    common = ["--data_dir", str(data), "--batch_size", str(RECIPE_BATCH), "--decode_cache",
              str(cache), "--save_every", "1", "--epochs", "1"]
    runs = (("our_unet", ACCUM, SEG_CSV_HEADER, f"{poly_lr(5e-3, 1)(0):.7f}", 7, slice(1, 7),
             "our_unet"),
            ("ae_recon", 2, AE_CSV_HEADER, f"{cosine_lr(1e-3, 1)(0):.7f}", 5, slice(1, 5),
             "ae_recon"))
    for recipe, accum, header, lr, lr_col, loss_cols, arch in runs:
        out = root / f"{recipe}_accum"
        per_step = {k: v * accum for k, v in PER_STEP["dense"].items()}
        result = counted_path(lambda: cli.main([recipe, "train", "--output_dir", str(out),
                                                "--grad_accum", str(accum), *common]),
                              plus(per_epoch(per_step, 1),
                                   ae_snapshots(1 if recipe == "ae_recon" else 0)))
        check_csv(out / "training_log.csv", header, [lr], lr_col, loss_cols)
        config = json.loads((out / "training_config.json").read_text())
        if config["grad_accum"] != accum:
            raise AssertionError(f"{recipe}: training_config.json grad_accum "
                                 f"{config['grad_accum']}")
        for d in (out / "checkpoints" / "epoch_1", out / "best_model"):
            if not ((d / "model.pth").is_file() and (d / "meta.json").is_file()):
                raise AssertionError(f"{d} lacks model.pth or meta.json")
        convert.load_reference_checkpoint(out / "best_model" / "model.pth", device="cuda",
                                          arch=arch)
        log(f"{recipe} train --grad_accum {accum}: 1 epoch, "
            f"{result['epochs'][-1]['steps']} steps of {accum} x b{RECIPE_BATCH // accum} "
            f"({steady_step_ms(result):.3f} ms a step after the first batch); CSV, config and "
            f"checkpoints as phase 8's; best_model loads strictly")
        torch.cuda.empty_cache()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_world_one() -> None:
    """(c): a DDP-wrapped step over NCCL at world size 1, the process group
    joined by ``maybe_initialize_distributed`` from a torchrun-style
    environment, against the plain step."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 14))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    groups = grad_groups(model)
    del model
    batch = device_batch(as_uint8(synthetic_batch(SEED + 14, CHECK_BATCH, IMG)))

    def one_step(wrap: bool):
        model = train_model("dense", state, torch.bfloat16)
        trained = dp_mesh.wrap(model) if wrap else model
        step = make_segmentation_train_step(trained, sgd_nesterov(model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with deterministic():
            loss = counted_path(lambda: float(step(batch, gen)), PER_STEP["dense"])
        return loss, params_of(model)

    with mock.patch.dict(os.environ, env):
        if not distributed.maybe_initialize_distributed():
            raise AssertionError("maybe_initialize_distributed joined no process group")
        try:
            backend = torch.distributed.get_backend()
            device = str(torch.device("cuda", distributed.local_rank()))
            ddp_loss, ddp = one_step(wrap=True)
        finally:
            distributed.shutdown()
    loss, plain = one_step(wrap=False)
    rel, worst = worst_rel(ddp, plain, groups)
    loss_rel = abs(ddp_loss - loss) / abs(loss)
    log(f"DDP at world size 1 ({backend}, {device}), b{CHECK_BATCH} bf16 step against the plain "
        f"step: loss {ddp_loss:.7f} / {loss:.7f} (rel {loss_rel:.3e}), parameters worst group "
        f"rel-L2 {rel:.3e} ({worst}); bound {DDP_REL:g}")
    if backend != "nccl" or rel > DDP_REL or loss_rel > DDP_REL:
        raise AssertionError(f"DDP at world size 1: backend {backend}, params {rel:.3e}, loss "
                             f"{loss_rel:.3e}")


def dp_model() -> UNet:
    """The full-width UNet with dropout rates 0 (the ranks and the reference
    must draw no masks), float32."""
    return UNet(encoder_dropout_rates=(0.0,) * len(DEFAULT_FEATURES),
                decoder_dropout_rates=(0.0,) * (len(DEFAULT_FEATURES) - 1),
                generator=torch.Generator().manual_seed(SEED + 15))


def dp_worker(rank: int, port: int, d: Path) -> int:
    """One gloo rank on the card: b8 of the global b16 through the wrapped
    model's step; writes its parameters, its global loss and its launches."""
    torch.backends.cudnn.allow_tf32 = False  # as main(): float32 is compared
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", DP_RANKS, rank,
                                             backend="gloo", device="cuda:0")
    try:
        model = dp_model().to("cuda:0")
        model.load_state_dict(torch.load(d / "init.pt"), strict=True)
        step = make_segmentation_train_step(dp_mesh.wrap(model), sgd_nesterov(model.parameters()))
        rows = slice(rank * DP_BATCH // DP_RANKS, (rank + 1) * DP_BATCH // DP_RANKS)
        batch = device_batch({k: v[rows] for k, v in np.load(d / "batch.npz").items()})
        reset_launches()
        loss = float(step(batch, None))
        torch.save({"params": {k: v.cpu() for k, v in params_of(model).items()}, "loss": loss,
                    "launches": launches()}, d / f"rank{rank}.pt")
    finally:
        distributed.shutdown()
    return 0


def cli_worker(argv: list) -> int:
    """One rank of ``torch.distributed.run`` on the one card: joins the
    launcher's group over gloo (NCCL refuses two ranks on one device), then
    runs ``cli.main(argv)``."""
    torch.backends.cudnn.allow_tf32 = False  # as main(): float32 is compared
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.maybe_initialize_distributed(backend="gloo", device="cuda:0")
    try:
        cli.main(argv)
    finally:
        distributed.shutdown()
    return 0


def run_ranks(cmds: list, label: str, **kwargs) -> list[str]:
    """Start every command at once and wait for all; fails if one fails or
    runs out of time (every process is stopped either way)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH", "")]))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, **kwargs) for cmd in cmds]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [i for i, proc in enumerate(procs) if proc.returncode != 0]
    if bad:
        raise AssertionError(f"{label}: process {bad} failed:\n" + "\n".join(
            outs[i][-3000:] if i < len(outs) else "(no output)" for i in bad))
    return outs


def write_stripe_caches(data: Path, cache: Path, ranks: int) -> None:
    """The warm decode caches of each rank's stripe of the Train split (the
    cache keys on the stripe), from phase 8's cache with the loader's
    functions; the stripes are the loader's equal contiguous shards."""
    size = (IMG, IMG)
    labels, n = RECIPE_SPLITS["Train"]
    images_dir, masks_dir = data / "Train" / "resized", data / "Train" / labels
    files = sorted(images_dir.glob("*.jpg"))
    full = loader.open_cache(loader.cache_path(cache, images_dir, masks_dir, size))
    per = n // ranks
    for r in range(ranks):
        rows = range(r * per, (r + 1) * per)
        items = ({k: full[k][i] for k in ("image", "mask", "original_dims")} for i in rows)
        loader.write_cache(loader.cache_path(cache, images_dir, masks_dir, size, r, ranks),
                           loader.cache_identity(files[r * per:(r + 1) * per], size, True),
                           items, per, size, True)


def dp_two_ranks(root: Path) -> None:
    """(d): DP_RANKS gloo ranks on the one card against one process's step,
    then ``cli our_unet train`` for one epoch under ``torch.distributed.run``
    with DP_RANKS ranks."""
    d = root / "dp"
    d.mkdir()
    model = dp_model()
    torch.save(model.state_dict(), d / "init.pt")
    batch = as_uint8(synthetic_batch(SEED + 16, DP_BATCH, IMG))
    np.savez(d / "batch.npz", image=batch["image"], mask=batch["mask"])
    torch.cuda.empty_cache()
    port = free_port()
    run_ranks([[sys.executable, str(Path(__file__).resolve()), "--dp-worker", str(r), str(port),
                str(d)] for r in range(DP_RANKS)], "the data-parallel step")
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(DP_RANKS)]

    model = model.cuda()
    groups = grad_groups(model)
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    loss = counted_path(lambda: float(step(device_batch(batch), None)), PER_STEP["dense"])
    ref = params_of(model)
    del model, step
    torch.cuda.empty_cache()
    for r, out in enumerate(ranks):
        params = {k: v.cuda() for k, v in out["params"].items()}
        rel, worst = worst_rel(params, ref, groups)
        loss_rel = abs(out["loss"] - loss) / abs(loss)
        same = all(torch.equal(out["params"][k], ranks[0]["params"][k]) for k in out["params"])
        log(f"gloo rank {r} of {DP_RANKS} (b{DP_BATCH // DP_RANKS} of a global b{DP_BATCH}, "
            f"float32) against one process's b{DP_BATCH} step: global loss {out['loss']:.7f} / "
            f"{loss:.7f} (rel {loss_rel:.3e}), parameters worst group rel-L2 {rel:.3e} ({worst}); "
            f"equal to rank 0's: {same}; launches {out['launches']}")
        if not (rel <= DP_REL and loss_rel <= DP_REL and same
                and out["launches"] == PER_STEP["dense"]):
            raise AssertionError(f"gloo rank {r}: params {rel:.3e}, loss {loss_rel:.3e}, same "
                                 f"{same}, launches {out['launches']} (bound {DP_REL:g})")

    data, cache = recipe_data(root)
    write_stripe_caches(data, cache, DP_RANKS)
    out = root / "dp_run"
    t0 = time.perf_counter()
    logs = run_ranks([[sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                       str(DP_RANKS), "--master_addr", "localhost", "--master_port",
                       str(free_port()), str(Path(__file__).resolve()), "--cli-worker",
                       "our_unet", "train", "--data_dir", str(data), "--output_dir", str(out),
                       "--batch_size", str(RECIPE_BATCH), "--epochs", "1", "--save_every", "1",
                       "--decode_cache", str(cache), "--device", "cuda:0", "--num_threads",
                       "4"]], "torch.distributed.run our_unet train",
                     cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    lines = (out / "training_log.csv").read_text().splitlines()
    check_csv(out / "training_log.csv", SEG_CSV_HEADER, [f"{poly_lr(5e-3, 1)(0):.7f}"], 7,
              slice(1, 7))
    config = json.loads((out / "training_config.json").read_text())
    sizes = [ln for ln in logs[0].splitlines() if "Training dataset size" in ln]
    for ck in (out / "checkpoints" / "epoch_1", out / "best_model"):
        convert.load_reference_checkpoint(ck / "model.pth", device="cuda")
    log(f"torch.distributed.run --nproc_per_node {DP_RANKS} cli our_unet train (gloo, one "
        f"card): {wall:.1f} s for 1 epoch; {len(lines) - 1} CSV row; config batch_size "
        f"{config['batch_size']}; {sizes}; epoch_1 and best_model load strictly")
    if config["batch_size"] != RECIPE_BATCH or len(sizes) != DP_RANKS or any(
            not ln.endswith(str(RECIPE_SPLITS["Train"][1] // DP_RANKS)) for ln in sizes):
        raise AssertionError(f"the two-rank recipe: config {config}, dataset sizes {sizes}")


@phase(f"12. gradient accumulation ({ACCUM} microbatches) and data parallelism: unet_6stage "
       f"512², the accumulated step, the recipes, DDP over NCCL and {DP_RANKS} gloo ranks")
def phase_parallel(root: Path):
    accum_steps()
    accum_recipes(root)
    ddp_world_one()
    torch.cuda.empty_cache()
    dp_two_ranks(root)


def sp_launches() -> dict:
    return {**launches(), "K1 split": k1.fused_instance_norm.split_launches,
            "K1bwd split": k1.fused_instance_norm.split_backward_launches}


def sp_counted(fn, expected: dict, out: dict, key: str):
    """``fn()`` with the counts set to 0 just before it; their reading just
    after goes into ``out[key]`` beside ``expected`` (the parent checks)."""
    reset_launches()
    result = fn()
    torch.cuda.synchronize()
    out[key] = {"got": sp_launches(), "expected": expected}
    return result


def no_backward(expected: dict) -> dict:
    return {**expected, "K1bwd": 0, "K1bwd split": 0}


# Phase 13's step variants: the version of K1 the blocks run (None: the
# wrappers, with the kernels), and the launches of a step.
SP_MODES = {
    "kernels": (None, {**PER_STEP["dense"], **SP_SPLIT}),
    "kernel values": (k1_kernel_values, {**NO_LAUNCHES, "K1": sum(K1_CALLS),
                                        "K1 split": sum(K1_CALLS), "K1bwd split": 0}),
    "plain": (k1_plain, {**NO_LAUNCHES, "K1 split": 0, "K1bwd split": 0}),
}


def sp_worker(rank: int, port: int, d: Path) -> int:
    """One gloo rank of the space group on the card: (a) and (b) the float32
    spatial forward and step in each of SP_MODES, (d) the bf16 step at
    SP_BIG² b1; writes what the parent compares."""
    torch.backends.cudnn.allow_tf32 = False  # as main(): float32 is compared
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", SP_RANKS, rank,
                                             backend="gloo", device="cuda:0")
    try:
        grid = spatial.create_mesh_dp_sp(SP_RANKS, device="cuda:0")
        data = dict(np.load(d / "batch.npz"))
        batch = device_batch({k: data[k] for k in ("image", "mask")})
        x = torch.from_numpy(data["x"]).cuda()
        out = {}
        for mode, (k1_version, expected) in SP_MODES.items():
            model = dp_model().to("cuda:0")
            model.load_state_dict(torch.load(d / "init.pt"), strict=True)
            step = spatial.spatial_train_step(model, sgd_nesterov(model.parameters()), grid)
            with deterministic(), plain_versions(k1_version) if k1_version else nullcontext():
                logits = sp_counted(lambda: spatial.spatial_forward(model, grid, x),
                                    no_backward(expected), out, f"{mode} forward")
                out[f"{mode} logits"] = spatial.gather_rows(logits, grid.context).cpu()
                out[f"{mode} loss"] = sp_counted(lambda: float(step(batch, None)), expected,
                                                 out, f"{mode} step")
            out[f"{mode} params"] = {k: v.cpu() for k, v in params_of(model).items()}
            del model, step
        torch.cuda.empty_cache()

        big = device_batch(dict(np.load(d / "big.npz")))
        model = unet_6stage(dtype=torch.bfloat16, device="cuda:0",
                            generator=torch.Generator().manual_seed(SEED + 18))
        step = spatial.spatial_train_step(model, sgd_nesterov(model.parameters()), grid)
        gen = torch.Generator(device="cuda:0").manual_seed(SEED)  # alike on both ranks
        torch.cuda.reset_peak_memory_stats()
        sp_counted(lambda: step(big, gen), SP_MODES["kernels"][1], out, "big step")
        ms = []
        for _ in range(SP_BIG_STEPS):
            t0 = time.perf_counter()
            step(big, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["big ms"], out["big peak"] = ms, torch.cuda.max_memory_allocated()
        torch.save(out, d / f"sp_rank{rank}.pt")
    finally:
        distributed.shutdown()
    return 0


def sp_halo_k2() -> None:
    """(c): the halo'd K2a on two row shards of each K2a input of the b2
    forward against the unsharded K2a, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        for side, c in K2_INPUTS:
            x = k2_input(SP_BATCH, side, c, seed=SEED + 19, dtype=dtype)
            full = k2.upsample2x_nhwc_fast(x)
            h = side // 2
            top = k2.upsample2x_nhwc_halo(x[:, :h], x[:, :1], x[:, h:h + 1])
            bottom = k2.upsample2x_nhwc_halo(x[:, h:], x[:, h - 1:h], x[:, -1:])
            if not torch.equal(torch.cat([top, bottom], dim=1), full):
                raise AssertionError(f"halo'd K2a {tuple(x.shape)} {dtype}: rows differ from "
                                     f"the unsharded K2a")
    log(f"(c) halo'd K2a on two row shards of each of the {len(K2_INPUTS)} K2a inputs (b"
        f"{SP_BATCH}, float32 and bf16): bit for bit the unsharded K2a")


def sp_check_launches(ranks: list) -> None:
    """(b): every counted run of every rank read its expected launches; the
    runs with the kernels go into the kernels line."""
    for r, out in enumerate(ranks):
        for key in [f"{m} {run}" for m in SP_MODES for run in ("forward", "step")] + ["big step"]:
            got, expected = out[key]["got"], out[key]["expected"]
            if got != expected:
                raise AssertionError(f"rank {r} {key}: launches {got}, expected {expected}")
            if key.startswith("kernels") or key == "big step":
                for name in KERNELS:
                    report["path_launches"][name] += got[name]
    log(f"(b) launches a rank: forward {ranks[0]['kernels forward']['got']}, step "
        f"{ranks[0]['kernels step']['got']}; kernel values {ranks[0]['kernel values step']['got']}"
        f"; plain versions none")


def sp_one_process(state: dict, data: dict) -> dict:
    """The one-process float32 forward and step on the same inputs, with the
    kernels."""
    model = dp_model().cuda()
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(data["x"]).cuda()
    batch = device_batch({k: data[k] for k in ("image", "mask")})
    model.eval()
    with deterministic(), torch.no_grad():
        logits = counted_path(lambda: model(x), PER_FORWARD["dense"]).cpu()
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    with deterministic():
        loss = counted_path(lambda: float(step(batch, None)), PER_STEP["dense"])
    return {"logits": logits, "loss": loss, "params": params_of(model)}


def sp_big_one_process(big: dict) -> tuple[list, int]:
    """One process's bf16 step at SP_BIG² b1: ms (as the ranks time it) and
    peak memory."""
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 18))
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = device_batch(big)
    torch.cuda.reset_peak_memory_stats()
    counted_path(lambda: step(batch, gen), PER_STEP["dense"])
    ms = []
    for _ in range(SP_BIG_STEPS):
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, torch.cuda.max_memory_allocated()


def sp_step_gates(ranks: list, ref: dict, groups: dict) -> None:
    """(a)'s step gates: each rank's step with the kernels against one
    process's (the loss, and the parameters at the bound K1's summation order
    allows) and against its own step with the split K1's values
    differentiated as the plain version (the parameters at SP_PARAM_REL)."""
    ref_params = {k: v.cuda() for k, v in ref["params"].items()}
    for r, out in enumerate(ranks):
        got = {k: v.cuda() for k, v in out["kernels params"].items()}
        loss_rel = abs(out["kernels loss"] - ref["loss"]) / abs(ref["loss"])
        rel, worst = worst_rel(got, ref_params, groups)
        values = {k: v.cuda() for k, v in out["kernel values params"].items()}
        v_rel, v_worst = worst_rel(got, values, groups)
        p_rel, p_worst = worst_rel({k: v.cuda() for k, v in out["plain params"].items()},
                                   ref_params, groups)
        log(f"(a) rank {r} spatial step with the kernels: loss {out['kernels loss']:.7f} / one "
            f"process {ref['loss']:.7f} (rel {loss_rel:.3e}, bound {SP_LOSS_REL:g}); parameters "
            f"worst group rel-L2 {rel:.3e} ({worst}; bound {TRAIN_F32_PLAIN_GRAD_REL:g}) against "
            f"one process's, {v_rel:.3e} ({v_worst}; bound {SP_PARAM_REL:g}) against its step "
            f"with the split K1's values and the plain backward; the plain versions' step "
            f"{p_rel:.3e} ({p_worst}) against one process's")
        if not (loss_rel <= SP_LOSS_REL and rel <= TRAIN_F32_PLAIN_GRAD_REL
                and v_rel <= SP_PARAM_REL):
            raise AssertionError(f"rank {r} spatial step: loss {loss_rel:.3e}, parameters "
                                 f"{rel:.3e} / {v_rel:.3e}")
    for key in ranks[0]["kernels params"]:
        if not all(torch.equal(out["kernels params"][key], ranks[0]["kernels params"][key])
                   for out in ranks):
            raise AssertionError(f"the ranks' parameters differ at {key}")


def sp_ranks(root: Path) -> None:
    """(a), (b) and (d): the ranks against one process."""
    d = root / "sp"
    d.mkdir()
    model = dp_model()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(state, d / "init.pt")
    groups = grad_groups(model)
    del model
    rng = np.random.default_rng(SEED + 17)
    batch = as_uint8(synthetic_batch(SEED + 17, SP_BATCH, IMG))
    data = {"image": batch["image"], "mask": batch["mask"],
            "x": rng.normal(size=(SP_BATCH, IMG, IMG, 3)).astype(np.float32)}
    np.savez(d / "batch.npz", **data)
    big = as_uint8(synthetic_batch(SEED + 18, 1, SP_BIG))
    np.savez(d / "big.npz", image=big["image"], mask=big["mask"])
    torch.cuda.empty_cache()
    port = free_port()
    run_ranks([[sys.executable, str(Path(__file__).resolve()), "--sp-worker", str(r), str(port),
                str(d)] for r in range(SP_RANKS)], "the spatial ranks")
    ranks = [torch.load(d / f"sp_rank{r}.pt") for r in range(SP_RANKS)]
    sp_check_launches(ranks)

    ref = sp_one_process(state, data)
    fwd = rel_l2(ranks[0]["kernels logits"], ref["logits"])
    same = all(torch.equal(out["kernels logits"], ranks[0]["kernels logits"]) for out in ranks)
    log(f"(a) spatial forward (b{SP_BATCH} 512² float32, kernels) against one process's: "
        f"rel-L2 {fwd:.3e} (bound {SP_FWD_REL:g}); the ranks' gathered logits equal: {same}; "
        f"with the plain versions {rel_l2(ranks[0]['plain logits'], ref['logits']):.3e}")
    if not (fwd <= SP_FWD_REL and same):
        raise AssertionError(f"the spatial forward: rel-L2 {fwd:.3e}, ranks equal {same}")
    sp_step_gates(ranks, ref, groups)

    torch.cuda.empty_cache()
    one_ms, one_peak = sp_big_one_process({k: big[k] for k in ("image", "mask")})
    gib = 2.0 ** 30
    log(f"(d) bf16 step at {SP_BIG}² b1 ({report['card']}): one process "
        f"{statistics.median(one_ms):.1f} ms ({spread(one_ms)}), peak {one_peak / gib:.3f} GiB; "
        + "; ".join(f"rank {r} of {SP_RANKS} {statistics.median(out['big ms']):.1f} ms "
                    f"({spread(out['big ms'])}), peak {out['big peak'] / gib:.3f} GiB"
                    for r, out in enumerate(ranks)))


def sp_launch(argv: list, label: str, ranks: int = SP_RANKS, nccl: bool = False) -> float:
    """``cli.main(argv)`` in ``ranks`` ranks under ``torch.distributed.run``,
    each joined over gloo on the one card (``--cli-worker``), or with
    ``nccl`` as a user launches it, one card a rank; returns the wall time."""
    entry = (["-m", "unet_implementations_tpu_torch.cli"] if nccl
             else [str(Path(__file__).resolve()), "--cli-worker"])
    t0 = time.perf_counter()
    run_ranks([[sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
                "--master_addr", "localhost", "--master_port", str(free_port()), *entry,
                *argv]], label, cwd=Path(__file__).resolve().parent)
    return time.perf_counter() - t0


def sp_train(root: Path, spatial: int, ranks: int = SP_RANKS, nccl: bool = False) -> None:
    """``cli our_unet train --spatial`` for one epoch at b32 on phase 8's
    dataset: one CSV row, ``spatial`` in the config, checkpoints that load
    strictly."""
    data, cache = recipe_data(root)
    if ranks // spatial > 1:  # the data ranks read their stripes
        write_stripe_caches(data, cache, ranks // spatial)
    out = root / f"sp_run_{ranks}_{spatial}"
    device = [] if nccl else ["--device", "cuda:0"]
    label = f"torch.distributed.run --nproc_per_node {ranks} our_unet train --spatial {spatial}"
    wall = sp_launch(["our_unet", "train", "--data_dir", str(data), "--output_dir", str(out),
                      "--batch_size", str(RECIPE_BATCH), "--epochs", "1", "--save_every", "1",
                      "--decode_cache", str(cache), "--num_threads", "4", "--spatial",
                      str(spatial), *device], label, ranks, nccl)
    lines = (out / "training_log.csv").read_text().splitlines()
    check_csv(out / "training_log.csv", SEG_CSV_HEADER, [f"{poly_lr(5e-3, 1)(0):.7f}"], 7,
              slice(1, 7))
    config = json.loads((out / "training_config.json").read_text())
    for ck in (out / "checkpoints" / "epoch_1", out / "best_model"):
        convert.load_reference_checkpoint(ck / "model.pth", device="cuda")
    log(f"(e) {label} ({'NCCL' if nccl else 'gloo, one card'}): {wall:.1f} s for 1 epoch of "
        f"b{RECIPE_BATCH}; {len(lines) - 1} CSV row; config spatial {config['spatial']}; "
        f"epoch_1 and best_model load strictly")
    if config["spatial"] != spatial:
        raise AssertionError(f"the spatial recipe's config: {config}")


def sp_predict(root: Path, ranks: int = SP_RANKS, nccl: bool = False) -> None:
    """``cli predict --spatial`` on SP_SERVE jpgs of phase 3's original sizes
    against one process's ``cli predict`` (float32): the masks equal wherever
    one process's top logit leads the next by SP_MARGIN."""
    import cv2

    from unet_implementations_tpu_torch.recipes.common import resize_nearest_np

    d = root / f"sp_predict_{ranks}"
    images = d / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 20)
    sizes = SIZES[:SP_SERVE]
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(images / f"p{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    # The reference schema has the dropout slots: unet_6stage's own rates.
    model = unet_6stage(dtype=torch.float32, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 20)).eval()
    pth = d / "model.pth"
    convert.save_reference_checkpoint(model, pth)
    flags = ["--model_path", str(pth), "--input", str(images), "--f32", "--no_overlay"]
    device = [] if nccl else ["--device", "cuda:0"]
    wall = sp_launch(["predict", *flags, "--output_dir", str(d / "spatial"), "--spatial",
                      str(ranks), *device], f"torch.distributed.run predict --spatial {ranks}",
                     ranks, nccl)
    with deterministic():
        counted_path(lambda: cli.main(["predict", *flags, "--output_dir", str(d / "one")]),
                     PER_FORWARD["dense"])
    for i, (h, w) in enumerate(sizes):
        rgb = cv2.cvtColor(cv2.imread(str(images / f"p{i}.jpg")), cv2.COLOR_BGR2RGB)
        pixels = torch.from_numpy(cv2.resize(rgb, (IMG, IMG), interpolation=cv2.INTER_LINEAR))
        with torch.no_grad():
            top2 = model(normalize_image(pixels[None].cuda()))[0].topk(2, dim=-1).values
        ties = resize_nearest_np((top2[..., 0] - top2[..., 1] < SP_MARGIN).cpu().numpy(), (h, w))
        got = cv2.imread(str(d / "spatial" / f"p{i}_mask.png"), cv2.IMREAD_GRAYSCALE)
        want = cv2.imread(str(d / "one" / f"p{i}_mask.png"), cv2.IMREAD_GRAYSCALE)
        differ = got != want
        log(f"(e) predict --spatial {ranks} p{i} ({h}x{w}): {int(differ.sum())} pixels differ "
            f"from one process's mask, {int((differ & ~ties).sum())} outside the margin "
            f"{SP_MARGIN:g}; pixels within it {ties.mean():.2e} (at most {SP_TIE_SHARE:g})")
        if (differ & ~ties).any() or ties.mean() > SP_TIE_SHARE:
            raise AssertionError(f"predict --spatial {ranks}: p{i}'s mask differs from one "
                                 f"process's")
    log(f"(e) torch.distributed.run --nproc_per_node {ranks} cli predict --spatial {ranks} "
        f"({'NCCL' if nccl else 'gloo, one card'}): {wall:.1f} s for {SP_SERVE} images")


@phase(f"13. spatial partitioning: unet_6stage dense, {SP_RANKS} gloo ranks of one space group "
       f"on the card, against one process")
def phase_spatial(root: Path):
    sp_halo_k2()
    sp_ranks(root)
    torch.cuda.empty_cache()
    sp_train(root, SP_RANKS)
    sp_predict(root)


def spatial_cards(root: Path) -> int:
    """``--spatial-cards``: the user's launch over NCCL, one rank a card of
    this machine (four or more: its cards must divide into space groups of
    two), from the package's entry point: ``our_unet train --spatial N`` for
    one epoch on N ranks (one space group) and on a (data 2, space N/2) grid,
    and ``predict --spatial N`` against one process."""
    n = torch.cuda.device_count()
    log(f"nvidia-smi: {nvidia_smi_card()} x{n}")
    if n < 4 or n % 2:
        raise SystemExit(f"--spatial-cards needs an even number of cards, four or more; have {n}")
    # Float32 is compared: TF32 off in every process the launcher starts.
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    _build.library()  # once, before the ranks load it
    for spatial in (n, n // 2):
        sp_train(root, spatial, n, nccl=True)
    sp_predict(root, n, nccl=True)
    return 0


# Serving (phase 14): the artifacts' batch (phase 3's), the timed one
# (phase 5's), the request batches whose latency is timed by the host clock,
# and the requests of ``cli predict`` (two full b8 batches: no padding, so
# the artifact's chunks are the checkpoint's batches and the masks can match
# bit for bit).
LATENCY_BATCHES = (1, SERVE_BATCH)
LATENCY_REPEATS = 20
CLI_SERVE_IMAGES = 2 * SERVE_BATCH
# The raw-data chain on the card (``cli pipeline -> sanity_checks ->
# augment``). ``data/pipeline.py`` needs cv2 and PIL, and the H100 machine
# this script was written for has both (cv2 4.13.0, PIL 12.2.0, beside torch
# 2.11.0+cu128), so the phase drives the chain, and fails if either is
# missing rather than skipping it. Train images per class of the synthesized
# raw tree, and its Test images.
RAW_PER_CLASS = 5
RAW_TEST = 3


def artifact(model, path: Path, batch: int, clip_dim=None, recipe: str = "our_unet"):
    """``save_exported`` of ``model`` at ``batch`` on the card, then
    ``load_exported``: (served, export seconds, artifact MiB)."""
    t0 = time.perf_counter()
    save_exported(path, model, recipe=recipe, batch_size=batch, img_size=IMG,
                  clip_dim=clip_dim, input_dtype=model.dtype)
    export_s = time.perf_counter() - t0
    mib = sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 2**20
    return load_exported(path), export_s, mib


def graph_launches(served) -> dict:
    """Kernel operator nodes of an artifact's graph, by kernel."""
    ops = {"in_lrelu_fwd": "K1", "upsample2x": "K2a", "upsample2x_s2d": "K2b", "s2d_tail": "K3"}
    counts = dict(NO_LAUNCHES)
    for node in served.program.graph.nodes:
        name = str(node.target).split(".")
        if node.op == "call_function" and name[0] == "unet_torch":
            counts[ops[name[1]]] += 1
    return counts


def replay_check(label: str, model, served, args: tuple, per_forward: dict) -> torch.Tensor:
    """The replayed artifact against the eager forward on the same inputs:
    bit for bit, each with ``per_forward`` launches (the replay's counted
    inside the operators, into the kernels line), the graph holding one
    operator node per launch; the eager forward with the plain versions
    launches none."""
    with torch.inference_mode():
        eager = counted(lambda: model(*args), per_forward)
        replay = counted_path(lambda: served(*args), per_forward)
        with plain_versions():
            counted(lambda: model(*args), NO_LAUNCHES)
    nodes = graph_launches(served)
    same = torch.equal(replay, eager)
    log(f"(a) {label}: replay {tuple(replay.shape)} bit for bit the eager forward: {same}; "
        f"launches {({k: v for k, v in per_forward.items() if v})} each, the plain versions "
        f"0; graph nodes {({k: v for k, v in nodes.items() if v})}")
    if not same or nodes != per_forward:
        raise AssertionError(f"{label}: the replay differs from the eager forward, or its "
                             f"graph holds {nodes}")
    return eager


FRESH_REPLAY = r"""
import json, sys
import torch
from unet_implementations_tpu_torch.kernels import _build, instance_norm, upsample
from unet_implementations_tpu_torch.serving import load_exported
_build.library()
served = load_exported(sys.argv[1])
x, want = torch.load(sys.argv[2]), torch.load(sys.argv[3])
got = served(x.cuda())
torch.cuda.synchronize()
print(json.dumps({"equal": torch.equal(got.cpu(), want),
                  "launches": [instance_norm.fused_instance_norm.launches,
                               upsample.upsample2x_nhwc_fast.launches],
                  "models": sorted(m for m in sys.modules
                                   if m.startswith("unet_implementations_tpu_torch.models"))}))
"""


def fresh_replay(path: Path, x: torch.Tensor, want: torch.Tensor, tmp: Path) -> None:
    """(c) A fresh ``python -c`` process loads the dense artifact (the
    kernel modules, nothing of ``models/``) and replays it bit for bit."""
    torch.save(x.cpu(), tmp / "x.pt")
    torch.save(want.cpu(), tmp / "want.pt")
    t0 = time.perf_counter()
    out = run_ranks([[sys.executable, "-c", FRESH_REPLAY, str(path), str(tmp / "x.pt"),
                      str(tmp / "want.pt")]], "fresh replay",
                    cwd=Path(__file__).resolve().parent)[0]
    result = json.loads(out.strip().splitlines()[-1])
    log(f"(c) a fresh process loads and replays the dense artifact "
        f"({time.perf_counter() - t0:.1f} s with its start): {result}")
    if result != {"equal": True, "launches": [PER_FORWARD["dense"]["K1"],
                                              PER_FORWARD["dense"]["K2a"]], "models": []}:
        raise AssertionError(f"the fresh process's replay: {result}")


def serving_artifacts(tmp: Path) -> None:
    """(a) dense and s2d, (b) the CLIP fusion and the autoencoder, (c) a
    fresh process, (d) float32 against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    xb = x.to(torch.bfloat16)
    report["artifacts"] = {}

    def export(label, model, batch=SERVE_BATCH, **kwargs):
        served, export_s, mib = artifact(model, tmp / label, batch, **kwargs)
        report["artifacts"][label] = {"export_s": export_s, "mib": mib}
        log(f"export {label} (b{batch}): {export_s:.2f} s, artifact {mib:.1f} MiB")
        return served

    for layout in LAYOUTS:
        model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 30),
                            **LAYOUTS[layout]).eval()
        served = export(f"{layout} bf16", model)
        eager = replay_check(f"unet_6stage {layout} bf16 b{SERVE_BATCH}", model, served, (xb,),
                             PER_FORWARD[layout])
        if layout == "dense":
            fresh_replay(tmp / "dense bf16", xb, eager, tmp)
        del model, served
    features = torch.randn((SERVE_BATCH, 512), generator=g, device="cuda").to(torch.bfloat16)
    clip = unet_6stage(dtype=torch.bfloat16, device="cuda", clip_fusion=True,
                       generator=torch.Generator().manual_seed(SEED + 31)).eval()
    replay_check(f"CLIP_UNet dense bf16 b{SERVE_BATCH}", clip,
                 export("clip bf16", clip, clip_dim=512, recipe="clip_unet"), (xb, features),
                 CLIP_PER_FORWARD["dense"])
    ae = autoencoder_6stage(dtype=torch.bfloat16, device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 32)).eval()
    replay_check(f"autoencoder_6stage dense bf16 b{SERVE_BATCH}", ae,
                 export("autoencoder bf16", ae, recipe="ae_recon"), (xb,), PER_FORWARD["dense"])
    del clip, ae
    # (d) float32, TF32 off: the replay against the eager forward with the
    # plain versions, at phase 4's bounds.
    f32 = unet_6stage(dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(SEED + 30)).eval()
    served = export("dense f32", f32)
    with deterministic(), torch.inference_mode():
        got = counted_path(lambda: served(x), PER_FORWARD["dense"])
        with plain_versions():
            want = counted(lambda: f32(x), NO_LAUNCHES)
    r, a = compare(got, want)
    log(f"(d) dense f32 artifact against the eager forward with the plain versions: logits "
        f"rel-L2 {r:.4e} (bound {E2E_F32_REL_L2:g}), argmax agreement {a:.6f} (bound "
        f"{E2E_F32_AGREEMENT:g})")
    if r > E2E_F32_REL_L2 or a < E2E_F32_AGREEMENT:
        raise AssertionError(f"the f32 artifact misses phase 4's bounds: {r:.4e}, {a:.6f}")


def request_ms(fns: dict, images: np.ndarray, repeats: int = LATENCY_REPEATS) -> dict:
    """Host-clock milliseconds of each ``fn(images)`` of ``fns`` (uint8 in,
    masks out at the original sizes: a request), the functions in turns,
    after one warm-up each."""
    ms = {name: [] for name in fns}
    for i in range(repeats + 1):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(images)
            if i:
                ms[name].append((time.perf_counter() - t0) * 1e3)
    return ms


def serving_times(tmp: Path) -> None:
    """(e) Printed, not gated: the b128 dense artifact forward beside the
    eager one (CUDA events, phase 5's method), and the request latency of
    ``predict_arrays`` from b1 and b8 artifacts beside the eager model."""
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 33)).eval()
    served, export_s, mib = artifact(model, tmp / "dense b128", TIMED_BATCH)
    log(f"export dense bf16 b{TIMED_BATCH}: {export_s:.2f} s, artifact {mib:.1f} MiB")
    g = torch.Generator(device="cuda").manual_seed(SEED + 34)
    xb = normalize_image(torch.randint(0, 256, (TIMED_BATCH, IMG, IMG, 3), generator=g,
                                       device="cuda", dtype=torch.uint8)).to(torch.bfloat16)
    ms = {}
    with torch.inference_mode():
        for _ in range(2):  # eager, artifact, eager, artifact
            for name, fn in (("eager", model), ("artifact", served)):
                ms.setdefault(name, []).extend(cuda_times(
                    lambda inp, fn=fn: counted(lambda: fn(inp), PER_FORWARD["dense"]), [xb],
                    iters=5))
    del xb
    for name, t in ms.items():
        log(f"(e) dense b{TIMED_BATCH} bf16 forward, {name}: {spread(t)}, "
            f"{TIMED_BATCH / statistics.median(t) * 1e3:.1f} img/s")
    ratio = statistics.median(ms["artifact"]) / statistics.median(ms["eager"])
    log(f"(e) artifact / eager: {ratio:.4f}")
    report["serving"] = {"b128_ms": {k: statistics.median(v) for k, v in ms.items()},
                         "latency_ms": {}}
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 35)
    for batch in LATENCY_BATCHES:
        small, export_s, mib = artifact(model, tmp / f"dense b{batch}", batch)
        images = rng.integers(0, 256, (batch, IMG, IMG, 3), dtype=np.uint8)
        dims = (SIZES * batch)[:batch]
        lat = request_ms({"eager": lambda a: predict_arrays(model, a, dims),
                          "artifact": lambda a: predict_arrays(small, a, dims)}, images)
        for name, t in lat.items():
            log(f"(e) request latency b{batch} (predict_arrays: uint8 to the card, normalize, "
                f"forward, argmax, masks back and resized; host clock), {name}: {spread(t)}")
        report["serving"]["latency_ms"][batch] = {k: statistics.median(v)
                                                  for k, v in lat.items()}
        del small


def serving_cli(root: Path) -> None:
    """(f) ``cli export`` of phase 8's ``best_model`` (b8 bf16, on the card),
    then ``cli predict`` from the artifact on CLI_SERVE_IMAGES jpgs of phase
    3's original sizes, against ``cli predict`` from the checkpoint: the
    same masks, byte for byte."""
    import cv2

    ckpt = root / "run" / "best_model"
    art, images = root / "serve_artifact", root / "serve_jpgs"
    t0 = time.perf_counter()
    meta = cli.main(["export", "--model_path", str(ckpt), "--output_dir", str(art),
                     "--batch_size", str(SERVE_BATCH)])
    log(f"(f) cli export of phase 8's best_model: {time.perf_counter() - t0:.2f} s, {meta}")
    images.mkdir()
    rng = np.random.default_rng(SEED + 36)
    for i in range(CLI_SERVE_IMAGES):
        h, w = SIZES[i % len(SIZES)]
        cv2.imwrite(str(images / f"r{i:02d}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
    per_run = times(PER_FORWARD["dense"], CLI_SERVE_IMAGES // SERVE_BATCH)
    walls = {}
    for name, path in (("artifact", art), ("checkpoint", ckpt)):
        t0 = time.perf_counter()
        run = counted_path if name == "artifact" else counted
        run(lambda: cli.main(["predict", "--model_path", str(path), "--input", str(images),
                              "--output_dir", str(root / f"served_{name}"), "--batch_size",
                              str(SERVE_BATCH)]), per_run)
        walls[name] = time.perf_counter() - t0
    masks = sorted((root / "served_artifact").glob("*_mask.png"))
    differ = [m.name for m in masks
              if m.read_bytes() != (root / "served_checkpoint" / m.name).read_bytes()]
    log(f"(f) cli predict of {CLI_SERVE_IMAGES} jpgs at b{SERVE_BATCH}: from the artifact "
        f"{walls['artifact']:.2f} s, from the checkpoint {walls['checkpoint']:.2f} s (wall, "
        f"load included); {len(masks)} masks, {len(differ)} differ")
    if len(masks) != CLI_SERVE_IMAGES or differ:
        raise AssertionError(f"cli predict from the artifact: {len(masks)} masks, these differ "
                             f"from the checkpoint's: {differ}")


def write_raw_tree(raw: Path) -> None:
    """A raw archive tree (``Dataset_filtered/{TrainVal,Test}/{color,label}``)
    as the CPU tests synthesize it: breed file names, TrainVal masks {0,
    1|2, 255}, 3-channel Test masks whose foreground is 128."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(SEED + 37)
    stems = {"TrainVal": [f"Abyssinian_{i}" for i in range(RAW_PER_CLASS)]
             + [f"beagle_{i}" for i in range(RAW_PER_CLASS)],
             "Test": [f"Siamese_{i}" if i % 2 else f"boxer_{i}" for i in range(RAW_TEST)]}
    for split, names in stems.items():
        base = raw / "Dataset_filtered" / split
        (base / "color").mkdir(parents=True)
        (base / "label").mkdir(parents=True)
        for stem in names:
            h, w = (int(v) for v in rng.integers(*RECIPE_DIMS, 2))
            cv2.imwrite(str(base / "color" / f"{stem}.jpg"),
                        rng.integers(0, 256, (h, w, 3), np.uint8))
            cls = 1 if stem[0].isupper() else 2
            m = np.zeros((h, w, 3) if split == "Test" else (h, w), np.uint8)
            m[h // 4:h // 2, w // 4:w // 2] = 128 if split == "Test" else cls
            m[:3] = 255
            Image.fromarray(m).save(base / "label" / f"{stem}.png")


def raw_chain(root: Path) -> None:
    """(g) ``cli pipeline -> sanity_checks -> augment`` on a synthesized raw
    tree: the split's counts, every check passing, one augmented copy per
    training image written on the card."""
    raw, data = root / "raw", root / "processed"
    write_raw_tree(raw)
    t0 = time.perf_counter()
    stats = cli.main(["pipeline", "--raw_dir", str(raw), "--processed_dir", str(data)])
    try:
        reports = cli.main(["sanity_checks", "--data_dir", str(data)])
    except SystemExit as e:  # a failed check exits 1; fail the phase instead
        raise AssertionError("cli sanity_checks found a failing check") from e
    aug = cli.main(["augment", "--data_dir", str(data), "--cat_augmentations", "1",
                    "--dog_augmentations", "1"])
    n_train = stats["train"]["images"]
    log(f"(g) cli pipeline -> sanity_checks -> augment: {time.perf_counter() - t0:.1f} s; "
        f"{stats}; {len(reports)} checks pass; {aug}")
    want_val = 2 * int(RAW_PER_CLASS * 0.2)
    if (n_train + stats["val"]["images"] != 2 * RAW_PER_CLASS or stats["val"]["images"] != want_val
            or stats["test"]["images"] != RAW_TEST or aug["outputs"] != n_train
            or aug["errors"]):
        raise AssertionError(f"the raw chain: {stats}, {aug}")


@phase("14. the serving artifact: save_exported -> load_exported -> replay on the card, "
       "cli export -> cli predict, and the raw-data chain")
def phase_serving(root: Path):
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        serving_artifacts(Path(tmp))
        torch.cuda.empty_cache()
        serving_times(Path(tmp))
    torch.cuda.empty_cache()
    serving_cli(root)
    raw_chain(root)


# The analysis tools (phase 15). (a) The evaluate that draws the first
# VIZ_SAMPLES batches; the probability forward against the plain versions at
# phase 4's float32 bound. (b) Grad-CAM at b1 512²: at the first decoder
# block's output (BLOCK_TARGET) the CAM does not depend on roundings, so the
# float32 card CAM is held to the plain versions' within CAM_F32_ATOL (max
# abs, [0, 1] units); at the default target, an InstanceNorm's input, the
# gradient's spatial mean is zero up to rounding (utils/gradcam.py), so that
# CAM is checked for shape, range and repeatability only. Where the card's
# block-target CAM is beyond CAM_F32_ATOL of the plain versions', it is held
# instead to a CAM whose K1 outputs are the kernel's values with the plain
# backward (phase 7's k1_kernel_values), and the log says so: K1's reordered
# float32 sums flip LeakyReLU slopes within a rounding of zero, as in phase 7.
# On an H100 (80GB HBM3, 700 W) it read 6.504e-3 and 4.842e-4 (two runs)
# against the plain versions, and 1.413e-5 against the K1-values CAM. (c) cli
# profile
# per --arch: PROFILE_ITERS iterations after the table's 2 warm-ups, the
# rows' measured time within PROFILE_BUSY_REL of the device's busy time, the
# our_unet forward's within PROFILE_PHASE5_REL of phase 5's b128 forward.
# (d) The VGG16 loader on a seeded torchvision-layout state dict at
# VGG_SIDE² bVGG_BATCH: the card's features within VGG_REL_L2 of the CPU's.
VIZ_SAMPLES = 2
BLOCK_TARGET = "decoder_stages.0.conv_block"
CAM_F32_ATOL = 1e-3
CAM_TIMED = 5
# Per CAM: the forward's launches, and K1bwd over the norms after the target
# (decoder_0's two and decoders 1-4's at the default target; 1-4's after the
# block).
CAM_PER_CALL = {"default": {**PER_FORWARD["dense"], "K1bwd": 10},
                "block": {**PER_FORWARD["dense"], "K1bwd": 8}}
PROFILE_ITERS = 3
PROFILE_BATCH = {"forward": TIMED_BATCH, "train": TRAIN_BATCH, "clip train": CLIP_BATCH}
PROFILE_BUSY_REL = 0.03
PROFILE_PHASE5_REL = 0.10
PROFILE_TOP = 10
# Each port operator's row and the count of its launches.
PROFILE_ROWS = {"unet_torch::in_lrelu_fwd": "K1", "unet_torch::upsample2x": "K2a",
                "_FusedInstanceNormBackward": "K1bwd"}
VGG_BATCH, VGG_SIDE = 2, 224
VGG_REL_L2 = 1e-4


def analysis_model(root: Path) -> Path:
    """Phase 8's ``best_model``; where phase 8 wrote none, one saved from a
    seeded ``unet_6stage``."""
    path = root / "run" / "best_model"
    if not (path / "model.pth").is_file():
        path = root / "unet_seeded"
        save_checkpoint(path, unet_6stage(device="cuda",
                                          generator=torch.Generator().manual_seed(SEED + 31)),
                        None, 0, 0.0)
    return path


def first_test_images(data: Path, n: int) -> dict:
    """The first ``n`` test images of phase 8's dataset (from its cache)."""
    ds = loader.PetDataset(data / "Test" / "resized", data / "Test" / "processed_labels",
                           include_augmented=False)
    batches = loader.batch_iterator(ds, n, num_threads=1)
    try:
        return next(batches)
    finally:
        batches.close()


def viz_evaluate(root: Path, best: Path, mpl: bool) -> None:
    """(a) ``our_unet evaluate --visualize_samples 2`` with matplotlib, or its
    early ImportError without; the probability forward on the card against
    the plain versions."""
    data, cache = recipe_data(root)
    test_fwd = -(-RECIPE_SPLITS["Test"][1] // RECIPE_BATCH)

    def evaluate(name: str, n: int) -> float:
        t0 = time.perf_counter()
        cli.main(["our_unet", "evaluate", "--model_path", str(best), "--data_dir", str(data),
                  "--output_dir", str(root / name), "--batch_size", str(RECIPE_BATCH),
                  "--decode_cache", str(cache), "--visualize_samples", str(n)])
        return time.perf_counter() - t0

    plain_wall = counted_path(lambda: evaluate("eval_noviz", 0),
                              times(PER_FORWARD["dense"], test_fwd))
    if mpl:
        drawn = min(VIZ_SAMPLES, test_fwd)
        wall = counted_path(lambda: evaluate("eval_viz", VIZ_SAMPLES),
                            times(PER_FORWARD["dense"], test_fwd + drawn))
        viz = root / "eval_viz" / "visualizations"
        want = {f"{kind}_batch{i}.png" for kind in ("predictions", "error_analysis", "confidence")
                for i in range(drawn)} | {"confusion_matrix.png"}
        if {p.name for p in viz.iterdir()} != want or not all(
                (viz / name).stat().st_size > 0 for name in want):
            raise AssertionError(f"the figures: {sorted(p.name for p in viz.iterdir())}")
        results = [json.loads((root / d / "evaluation_results.json").read_text())
                   for d in ("eval_viz", "eval_noviz")]
        if results[0] != results[1]:
            raise AssertionError("the results with figures differ from those without")
        log(f"branch: matplotlib imports; evaluate --visualize_samples {VIZ_SAMPLES}: "
            f"{len(want)} figures, results equal those without; wall {wall:.3f} s with "
            f"figures, {plain_wall:.3f} s without")
    else:
        reset_launches()
        try:
            evaluate("eval_viz", VIZ_SAMPLES)
        except ImportError as e:
            if "matplotlib" not in str(e) or "--visualize_samples 0" not in str(e):
                raise AssertionError(f"the ImportError names no way out: {e}") from e
            log(f"branch: matplotlib does not import; evaluate --visualize_samples "
                f"{VIZ_SAMPLES} raised before the model loaded: {e}")
        else:
            raise AssertionError("evaluate --visualize_samples drew without matplotlib")
        if launches() != NO_LAUNCHES or (root / "eval_viz").exists():
            raise AssertionError(f"the refused evaluate launched {launches()} or wrote files")
        log(f"evaluate --visualize_samples 0: wall {plain_wall:.3f} s")
    model = restore_params(best, our_unet.build_model(torch.float32, "cuda")).eval()
    _, probs_fn = our_unet.eval_fns(model, torch.float32)
    batch = first_test_images(data, SERVE_BATCH)
    probs = counted_path(lambda: probs_fn(batch), PER_FORWARD["dense"])
    with plain_versions():
        plain = counted(lambda: probs_fn(batch), NO_LAUNCHES)
    err = rel_l2(probs, plain)
    log(f"probs_fn b{SERVE_BATCH} float32: rel-L2 {err:.4e} against the plain versions "
        f"(bound {E2E_F32_REL_L2}), K1/K2a {PER_FORWARD['dense']['K1']}/"
        f"{PER_FORWARD['dense']['K2a']} a probability forward")
    if not err <= E2E_F32_REL_L2:
        raise AssertionError(f"probs_fn: rel-L2 {err} against the plain versions")
    report["analysis"]["eval_wall_s"] = {"without": plain_wall,
                                         "with": wall if mpl else None}


def cams(best: Path, data: Path) -> None:
    """(b) Grad-CAM of the first test image, b1 512², float32 and bf16."""
    image = first_test_images(data, 1)["image"]
    models = {dt: restore_params(best, our_unet.build_model(dt, "cuda")).eval()
              for dt in (torch.float32, torch.bfloat16)}
    f32 = models[torch.float32]
    with deterministic():
        cam = counted_path(lambda: gradcam(f32, image, 1, BLOCK_TARGET), CAM_PER_CALL["block"])
        with plain_versions():
            plain = counted(lambda: gradcam(f32, image, 1, BLOCK_TARGET), NO_LAUNCHES)
        err = float(np.abs(cam - plain).max())
        log(f"Grad-CAM float32 at {BLOCK_TARGET}: max |card - plain| {err:.4e} (bound "
            f"{CAM_F32_ATOL}); launches {CAM_PER_CALL['block']}")
        if not err <= CAM_F32_ATOL:
            with plain_versions(k1_kernel_values):
                values = counted(lambda: gradcam(f32, image, 1, BLOCK_TARGET),
                                 {**NO_LAUNCHES, "K1": PER_FORWARD["dense"]["K1"]})
            err = float(np.abs(cam - values).max())
            log(f"  beyond it: held instead to the CAM with K1's values and the plain "
                f"backward: max |difference| {err:.4e}")
            if not err <= CAM_F32_ATOL:
                raise AssertionError(f"Grad-CAM float32: {err} from the K1-values CAM")
        for dt, model in models.items():
            for label, target in (("default", DEFAULT_CAM_TARGET), ("block", BLOCK_TARGET)):
                first = counted_path(lambda: gradcam(model, image, 1, target),
                                     CAM_PER_CALL[label])
                again = counted_path(lambda: gradcam(model, image, 1, target),
                                     CAM_PER_CALL[label])
                if first.shape != (IMG, IMG) or not np.isfinite(first).all() or \
                        first.min() < 0 or first.max() > 1 + 1e-6:
                    raise AssertionError(f"Grad-CAM {dt} {label}: shape {first.shape}, range "
                                         f"[{first.min()}, {first.max()}]")
                if not np.array_equal(first, again):
                    raise AssertionError(f"Grad-CAM {dt} {label}: a second call differs")
            ms = cuda_times(lambda img: gradcam(model, img, 1), [image], iters=CAM_TIMED)
            report["analysis"][f"cam_ms_{str(dt).removeprefix('torch.')}"] = \
                statistics.median(ms)
            log(f"Grad-CAM {dt} b1 {IMG}² at the default target ({DEFAULT_CAM_TARGET}), "
                f"forward + backward to it + CAM, CUDA events: {spread(ms)}; both targets in "
                f"range and bit for bit on a second call")


def profiles() -> None:
    """(c) The cost table of each recipe's model, forward and train step."""
    phase5 = report.get("forward", {}).get("dense", {}).get("ms")
    for arch in profiling.ARCHES:
        for train in (False, True):
            batch = PROFILE_BATCH[("clip train" if arch == "clip_unet" else "train")
                                  if train else "forward"]
            reset_launches()
            table = profiling.profile_table(arch, batch, IMG, train, torch.bfloat16, "cuda",
                                            iters=PROFILE_ITERS, seed=SEED + 33)
            counts = launches()
            log(profiling.format_table(table["rows"], top=PROFILE_TOP, meta=table))
            rows = {r["name"]: r for r in table["rows"]}
            runs = PROFILE_ITERS + profiling.WARMUPS
            for name, kernel in PROFILE_ROWS.items():
                calls = rows[name]["calls"] if name in rows else 0
                if calls * runs != counts[kernel]:
                    raise AssertionError(f"{arch} {train}: row {name} {calls} calls an "
                                         f"iteration, {counts[kernel]} {kernel} launches in "
                                         f"{runs} runs")
            total = sum(r["device_us"] for r in table["rows"])
            if not abs(total - table["busy_us"]) <= PROFILE_BUSY_REL * table["busy_us"]:
                raise AssertionError(f"{arch} {train}: rows {total} us, busy "
                                     f"{table['busy_us']} us")
            key = f"{arch} {'train' if train else 'forward'} b{batch}"
            report["analysis"].setdefault("profile_ms", {})[key] = total / 1e3
            if arch == "our_unet" and not train and phase5:
                log(f"our_unet forward b{batch}: profiled device total {total / 1e3:.3f} ms, "
                    f"phase 5's event-timed b{TIMED_BATCH} forward {phase5:.3f} ms, ratio "
                    f"{total / 1e3 / phase5:.4f}")
                if not abs(total / 1e3 - phase5) <= PROFILE_PHASE5_REL * phase5:
                    raise AssertionError(f"the profiled forward {total / 1e3} ms against "
                                         f"phase 5's {phase5} ms")
            torch.cuda.empty_cache()


def vgg_on_card() -> None:
    """(d) A seeded torchvision-layout state dict loaded on the card and on
    the CPU: the features of the same images."""
    g = torch.Generator().manual_seed(SEED + 35)
    sd, cin = {}, 3
    plan = [ch for n, ch in vgg.VGG16_PLAN for _ in range(n)]
    for idx, cout in zip(vgg.TORCHVISION_CONV_INDICES, plan):
        sd[f"features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * \
            (2 / (9 * cout)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.1
        cin = cout
    x = torch.rand((VGG_BATCH, VGG_SIDE, VGG_SIDE, 3), generator=g)
    models = {d: vgg.load_torch_vgg16_weights(sd, vgg.VGG16Features().to(d).eval())
              for d in ("cpu", "cuda")}
    with torch.no_grad():
        want = models["cpu"](x)
        got = models["cuda"](x.to("cuda"))
    errs = {tap: rel_l2(got[tap].cpu(), want[tap]) for tap in want}
    log(f"VGG16 loader, b{VGG_BATCH} {VGG_SIDE}² float32, card against CPU, rel-L2 by tap: "
        + ", ".join(f"{t} {e:.3e}" for t, e in errs.items()) + f" (bound {VGG_REL_L2})")
    if not all(e <= VGG_REL_L2 for e in errs.values()):
        raise AssertionError(f"VGG16 features, card against CPU: {errs}")


def latent(root: Path) -> None:
    """(e) ``ae_recon evaluate --analyze_latent_space`` on phase 9's
    autoencoder, or its early ImportError without scikit-learn or
    matplotlib."""
    data, cache = recipe_data(root)
    recon = loader.cache_path(cache, data / "Test" / "resized", None, (IMG, IMG),
                              mode="reconstruction")
    if not (recon / loader.MANIFEST).exists():
        write_recon_caches(data, cache)
    argv = ["ae_recon", "evaluate", "--model_path", str(pretrained_ae(root)), "--data_dir",
            str(data), "--output_dir", str(root / "latent"), "--batch_size", str(RECIPE_BATCH),
            "--decode_cache", str(cache), "--visualize_samples", "0", "--analyze_latent_space"]
    if importable("sklearn") and importable("matplotlib"):
        test_fwd = -(-RECIPE_SPLITS["Test"][1] // RECIPE_BATCH)
        t0 = time.perf_counter()
        results = counted_path(lambda: cli.main(argv),
                               times(PER_FORWARD["dense"], 2 * test_fwd))
        wall = time.perf_counter() - t0
        plots = [p.name for p in (root / "latent").glob("latent_space_*.png")]
        if results["latent_analysis"] != {"pca_explained": None,
                                          "n": RECIPE_SPLITS["Test"][1]} or len(plots) != 2:
            raise AssertionError(f"latent analysis: {results['latent_analysis']}, {plots}")
        log(f"branch: scikit-learn and matplotlib import; analyze_latent on "
            f"{RECIPE_SPLITS['Test'][1]} test images: {sorted(plots)}, {wall:.3f} s")
        return
    reset_launches()
    try:
        cli.main(argv)
    except ImportError as e:
        log(f"branch: scikit-learn {'imports' if importable('sklearn') else 'does not import'},"
            f" matplotlib {'imports' if importable('matplotlib') else 'does not import'}; "
            f"--analyze_latent_space raised before the first encode: {e}")
    else:
        raise AssertionError("--analyze_latent_space ran without its packages")
    if launches() != NO_LAUNCHES:
        raise AssertionError(f"the refused latent analysis launched {launches()}")


@phase("15. the analysis tools: evaluate --visualize_samples, Grad-CAM, cli profile, the "
       "VGG16 loader, the latent analysis")
def phase_analysis(root: Path):
    report["analysis"] = {}
    mpl = importable("matplotlib")
    log(f"matplotlib {'imports' if mpl else 'does not import'}, scikit-learn "
        f"{'imports' if importable('sklearn') else 'does not import'} on this machine")
    best = analysis_model(root)
    data, cache = recipe_data(root)
    os.environ["UNET_TPU_DECODE_CACHE"] = str(cache)
    viz_evaluate(root, best, mpl)
    torch.cuda.empty_cache()
    cams(best, data)
    torch.cuda.empty_cache()
    profiles()
    vgg_on_card()
    torch.cuda.empty_cache()
    latent(root)


# ``--ab-steps``: one checkout's phase-7 step and phase-8 recipe, through the
# package's entry points only. Arguments: LABEL DATA CACHE.
AB_PROGRAM = f"""
import statistics, sys, tempfile
import torch
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.models.unet import unet_6stage
from unet_implementations_tpu_torch.training.steps import (
    make_accum_train_step, make_segmentation_loss_fn, make_segmentation_train_step)
from unet_implementations_tpu_torch.training.train_state import sgd_nesterov

label, data, cache = sys.argv[1:]
_build.library()
batch = {{k: torch.from_numpy(v).to("cuda")
         for k, v in as_uint8(synthetic_batch({SEED + 4}, {TRAIN_BATCH}, {IMG})).items()}}
gen = torch.Generator(device="cuda").manual_seed({SEED})


def timed(make_step):
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed({SEED + 5}))
    step = make_step(model, sgd_nesterov(model.parameters()))
    for _ in range(3):
        step(batch, gen)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(10)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        step(batch, gen)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


ms = timed(make_segmentation_train_step)
accum = timed(lambda m, o: make_accum_train_step(m, o, make_segmentation_loss_fn(), {ACCUM}))
del batch
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as out:
    result = cli.main(["our_unet", "train", "--data_dir", data, "--output_dir", out,
                       "--batch_size", "{RECIPE_BATCH}", "--epochs", "2", "--save_every",
                       "100", "--decode_cache", cache])
epoch = result["epochs"][-1]
recipe = (epoch["train_s"] - epoch["first_batch_s"]) / epoch["steps"] * 1e3
print(f"{{label}} b{TRAIN_BATCH} dense train step: median {{statistics.median(ms):.4f}} ms "
      f"(min {{min(ms):.4f}}, max {{max(ms):.4f}}, n {{len(ms)}}); as {ACCUM} x "
      f"b{TRAIN_BATCH // ACCUM}: median {{statistics.median(accum):.4f}} ms (min "
      f"{{min(accum):.4f}}, max {{max(accum):.4f}}); our_unet recipe, epoch 2 after its first "
      f"batch: {{recipe:.3f}} ms a step", flush=True)
"""


def ab_steps(root: Path, versions: list) -> int:
    """``--ab-steps``: AB_PROGRAM from each ``LABEL=DIR`` of ``versions`` in
    turn, each in a process that imports the package from DIR."""
    log(f"nvidia-smi: {nvidia_smi_card()}")
    data, cache = recipe_data(root.resolve())
    for version in versions:
        label, checkout = version.split("=", 1)
        checkout = Path(checkout).resolve()
        out = subprocess.run([sys.executable, "-c", AB_PROGRAM, label, str(data), str(cache)],
                             cwd=checkout, env=dict(os.environ, PYTHONPATH=str(checkout)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=AB_TIMEOUT_S)
        lines = out.stdout.splitlines()
        if out.returncode != 0:
            print("\n".join(lines[-40:]), file=sys.stderr)
            raise AssertionError(f"--ab-steps {label}: exit code {out.returncode}")
        log(lines[-1])
    return 0


def kernels_line() -> dict:
    rows = report["rows"]
    bound_by = report["bound_by"]
    meta = [
        ("K1 fused_instance_norm (InstanceNorm+LeakyReLU fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/instance_norm.cu",
         "unet_implementations_tpu/kernels/instance_norm.py:80", "K1"),
        ("K1bwd fused_instance_norm backward (InstanceNorm+LeakyReLU bwd)",
         "unet_implementations_tpu_torch/kernels/csrc/instance_norm.cu",
         "unet_implementations_tpu/kernels/instance_norm.py:186", "K1bwd"),
        ("K2a upsample2x_nhwc_fast (2x bilinear, dense fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/upsample.cu",
         "unet_implementations_tpu/kernels/upsample.py:118", "K2a"),
        ("K2b upsample2x_into_s2d_fast (2x bilinear into s2d, fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/upsample.cu",
         "unet_implementations_tpu/kernels/upsample.py:134", "K2b"),
        ("K3 fused_s2d_tail (s2d block tail IN-lrelu-conv3x3-IN-lrelu, fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/s2d_region.cu",
         "unet_implementations_tpu/kernels/s2d_region.py:204", "K3"),
        ("K4 winograd_conv_s2d (Winograd F(2,3) s2d conv, unfolded U, fwd and dx)",
         "unet_implementations_tpu_torch/kernels/csrc/winograd.cu",
         "unet_implementations_tpu/kernels/winograd.py:365", "K4"),
        ("K4f winograd_conv_s2d (Winograd F(2,3) s2d conv, folded U, fwd and dx)",
         "unet_implementations_tpu_torch/kernels/csrc/winograd.cu",
         "unet_implementations_tpu/kernels/winograd.py:266", "K4f"),
    ]
    out = []
    for name, source, replaces, key in meta:
        ms, plain_ms, bound_ms, library_ms = rows.get(key, [None] * 4)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # The counted runs of the main paths (phases 3, 6-15).
            "launches": report["path_launches"][key],
            "max_abs_err": report["err"][key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by.get(key, "bytes"), "library_ms": library_ms,
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # Float32 is compared throughout: no TF32 in convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    phase_build()
    if not failures:
        phase_kernels()
        phase_slice()
        if len(report.get("models", {})) == len(LAYOUTS):
            phase_e2e()
            phase_times()
        report.pop("models", None)
        torch.cuda.empty_cache()
        phase_k4()
        phase_train()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as recipe_root:
            phase_recipe(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_ae(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_clip(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_augment(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_parallel(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_spatial(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_serving(Path(recipe_root))
            torch.cuda.empty_cache()
            phase_analysis(Path(recipe_root))
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        print(json.dumps({"ok": False, "failed": failures}))
        return 1
    print(report["card"])
    print(json.dumps(kernels_line()))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])))
    if sys.argv[1:2] == ["--cli-worker"]:
        sys.exit(cli_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--spatial-cards"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with tempfile.TemporaryDirectory() as cards_root:
            sys.exit(spatial_cards(Path(cards_root)))
    if sys.argv[1:2] == ["--ab-steps"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is available")
        sys.exit(ab_steps(Path(sys.argv[2]), sys.argv[3:]))
    sys.exit(main())
