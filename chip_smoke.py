#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dmmfods_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports no JAX. In order, and any failure ends the run with a non-zero
exit code:

1. Device: requires CUDA and prints the card's name and power limit.
2. Build: compiles the CUDA kernels from ``dmmfods_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time and ptxas's
   registers and spills of each kernel instantiation, with the dynamic
   shared memory of the tensor-core kernels (the bf16 bodies of K1, K2, K3,
   K4, K5 and K6, K1's at each N slice, K6's at each channel count 1-8,
   K2's, K4's and K5's in each (K, G) layout of the layer bodies, (128, 32)
   and (192, 48), K4's at each tile, and K3's in each layout, narrow and
   wide, with its f32 body at c_mid 64 and 96); fails if any instantiation
   spills.
3. K1 (the fused concat+BN+ReLU+1x1 kernel) against its plain PyTorch
   version: in bf16 on operands folded and packed beforehand
   (``fuse_operands``) at the 128x192 serving shape (16x24 pixels, 128/128
   -> 128 channels) at b1, b8, b32 and b256, at the 1280x1920 shape (80x120
   pixels, 256/256 -> 256), at a row count that is not a multiple of its
   tile, at 48/16 -> 40 (K and N padding), at 512/512 -> 512 (64-column N
   slices) and at 12/20 -> 24 (not multiples of 8: the CUDA-core body, which
   the C entry picks by shape); in bf16 folded per call at b8; in f32 (the
   CUDA-core body) at b8, b256 and a ragged shape.
4. K2 (the dense block) against its plain version at DenseNet-121's
   1280x1920 block shapes (320x480, c0 64, 6 layers; 160x240, c0 128, 12
   layers) and at two ragged shapes (G 8, K 32; G 12, K 48) in bf16, with
   its bf16 wave plan, and at a ragged shape in f32; at DenseNet-161's
   (growth 48, K 192: the layer bodies' wide layout; c0 96 and 192) in bf16
   and f32; and at three wide ragged shapes (G 40, K 160; G 48 on a ragged
   plane; 12 layers) in both; K5 (the dense block as independent strips
   that recompute their halo) at the same four block shapes, against K2 bit
   for bit in bf16 (both run one layer body at one tile), and in f32 and
   bf16 (there against K2 bit for bit too) at a ragged shape whose last
   strip is short, at a plane that is a single strip, at a block deeper
   than its strips and at the wide ragged shapes; growth 64 (K 256)
   refused by each wrapper and each C entry; K3 (the head) at DenseNet-121's
   1280x1920 shape and at two ragged shapes (c_mid 20 and 3 classes, 64 and
   8) in bf16 and at a ragged shape in f32, and in its wide layout at
   DenseNet-161's 1280x1920 head (c_up 192, c_mid 96: source 208) and at
   three wide ragged shapes (source 212 with c_mid 90 and 5 classes, source
   256, c_mid 64 on source 208) in bf16 and f32, c_mid 128 refused by the
   wrapper and the C entry;
   K4 (the whole-block kernel) at the
   four DenseNet-121 block shapes of 128x192 in bf16, at each batch of the
   opt-in path that runs the block as K4 (``K4_PATH_BATCHES``) and at b256,
   at DenseNet-161's blocks 1 and 2 there at b1, b32 and b256 in bf16 and
   b8 in f32, after holding its launch plan (tile, cluster, warp split,
   shared memory) from ``dmm_dense_block_plan`` against the Python mirror
   ``block_plan`` in each layout, at a ragged shape in bf16 and f32, at a
   small-plane shape in f32, and at the wide ragged and small-plane shapes
   in both; K6
   (the fused stem + pool0) at 1280x1920 and at 128x192, each with 3 and 1
   channels, and at two ragged shapes (4 and 8 channels) in bf16, on
   weights packed beforehand (``pack_stem_weights``), and at a ragged shape
   in f32.
4b. The eval BN-ReLU pass (``ops/bn_relu.py``, which replaces no TPU
   kernel): one bf16 eval forward of DenseNet-121 at 128x192 b256 and of
   DenseNet-161 at 1280x1920 b1 (mid fusion before blocks 2 and 3) launches
   it once at each plain-path site (142 and 135) and folds each form of
   eval operands it runs once (``BN_FOLDS`` 21 and 23, then 0), a
   train-mode forward launches none; the kernel against the exact value rounded once (bf16,
   one ulp) and its plain version (f32, 1e-6) at every site shape the
   forwards met and at six more (channel counts not multiples of 8, a 1x1
   plane); NCHW-contiguous, float16 and an unaligned start refused. Timed
   there: the forward's sites in sequence (device time alone) as the
   kernel, its plain version and the per-call passes it replaces, against
   their bound; their host enqueue; the fold cache's checks in a forward;
   the forward with the kernel in turns with the per-call fold. From phase 5
   on, each served device batch and each eval step also launches the pass
   once at each site ``_bn_relu_sites`` derives from the architecture (less
   the blocks a kernel takes and the stems K6 takes), and a train step none;
   the kernel JSON line's ``bn_relu`` launches add up those runs.
5. Serve at 128x192 with the default config: the full-width DenseNet-121
   mid-fusion model (random weights from a seed) in bf16 through
   ``InferenceEngine``: warm-up, the worker with four requests, one
   synchronous request, stop. Checks the heat maps, that every device batch
   went through K1 and none through K2, K3, K4 or K6 (the head runs in
   phase space, stock PyTorch), K1's output inside a served batch, and the
   served output against the same weights in f32. Then the last request
   again through a model with ``gpu.use_fused_kernels = False`` (the plain
   concat and head): no kernel launched, its heat maps within the bf16
   bound of the default path's.
6. Serve at 1280x1920 batch 1 with the default config: DenseNet-121 with
   mid fusion before block 3 (BASELINE.json config 3) in bf16: warm-up, two
   requests through the worker, one synchronous request, stop. Checks the
   heat maps, that every device batch ran K1 once, K2 four times, K3 once
   and no K4 or K6, and the served output against the same weights in f32.
7. Serve at 128x192 with the opt-ins ``gpu.dense_block_impl = "pallas"`` and
   ``gpu.stem_pool_strip = "on"``, buckets (1, 8, 32): one synchronous
   request per bucket, each checked for the launches of its device batch
   (``OPT_IN_LAUNCHES``), then the worker with three requests. Checks the
   heat maps and the served output against the same weights in f32 on the
   default path.
8. Serve at 1280x1920 batch 1, config 3, with the opt-ins: K1 once, K2 four
   times, K3 once, K6 twice and no K4 per device batch; served against f32.
9. Serve at 1280x1920 batch 1, config 3, with ``gpu.dense_block_strip =
   "on"``: warm-up, the worker, one synchronous request; K1 once, K5 four
   times, K3 once and no K2, K4 or K6 per device batch; served against the
   same weights in f32 on the default path. Every earlier phase runs no K5.
10. Train: the full-width DenseNet-121 mid-fusion model at 128x192 in bf16
   (f32 params, random weights from a seed) through
   ``dmmfods_tpu_torch.trainer``: ten steps of the config's Adam on one
   fixed batch of 32 frames. Checks that every loss is finite, the last
   below the first, and that no kernel launches in train mode.
11. Eval after training: the eval step on the same batch runs K1 once and
   no other kernel; its metrics are finite, AP and accuracy in [0, 1]; and
   the trained model's eval logits equal bit for bit those of a fresh model
   that loaded the trained ``state_dict`` (the eval folds were made before
   training, so a stale fold shows).
12. The bf16 step-0 loss against one train step of the same weights in f32.
13. Raw records (preprocessing in the step), on the trained model and its
   optimizer: a b32 batch of ``bench_suite.py``'s config 5 traffic (32,768
   points and 64 boxes a frame, 1280x1920 full resolution) from the port's
   ``make_raw_batch`` in both splat modes, the host splat by the native
   library, which must have built (``data/native_io.py``, with the kernels
   in phase 2). Checks ``rasterize_heatmaps_direct`` on the card equal to
   the CPU's, ``lidar_points_to_model_input_pooled`` on the card against the
   native host splat (1e-4), three steps each of ``make_train_step_ht`` and
   ``make_train_step_raw`` with finite losses and no kernel launched,
   ``make_eval_step_ht`` and ``make_eval_step_raw`` each with K1 once and no
   other kernel and finite metrics, and ``make_eval_step_ht`` equal bit for
   bit to ``make_eval_step`` on the rasterized maps.
14. DenseNet-161 (growth 48: K2, K4 and K5 in the layer bodies' wide
   layout) through ``InferenceEngine``: at 1280x1920 batch 1 with mid
   fusion before block 3, one synchronous request on the default path (K1
   once, K2 four times, K3 once in its wide layout) and one with
   ``dense_block_strip = "on"`` (K1 once, K5 four times, K3 once); at 128x192
   with ``dense_block_impl = "pallas"``, one request at b1 and one at b32
   (K1 once, K4 three times: stream 1's blocks 1-2 and stream 2's block 1,
   the blocks JAX's rule takes). Each against the same weights in f32. On
   the default path JAX's gates (``kernel_limits=False``) are counted
   beside the port's on the blocks and head the request ran: K2 4 / K3 1
   both. The phase fails if either moves.
15. Time, by CUDA events: the engine's forward with the opt-ins and with
   ``use_fused_kernels = False`` in turns with the default config at
   b1/b8/b32/b256 at 128x192 (each profiled at b256) and at b1 at
   1280x1920, and the K5 path's forward in turns with the default one, then
   ``torch.profiler`` breakdowns of the device time of the default 1280x1920
   forward, the K5 path's, the opt-in 1280x1920 forward (K6's share of it)
   and the opt-in b256 forward; K1 at the b256
   shape, K2 and K5 at both block shapes (K5 also against K2; K2's packing
   of its bf16 weights timed apart), K3 at the
   1280x1920 shape on weights folded beforehand, with the fold
   (``kernel_weights``) timed apart, and at DenseNet-161's head beside its
   plain version, the model's plain head and the phase-space eval head; the
   phase-space head's two eval forms of refine1 (four 3x3 convs, the
   port's, or JAX's one 4x4 conv, held against each other) and the plain
   head at 128x192 b32 and b256; K4 at the four
   b256 block shapes and K6
   at 1280x1920 with 3 and with 1 channel and at 128x192 with 3, on weights
   packed beforehand with the packing timed apart, each against its plain
   version in turns; K4 and K6 also
   against the model's own plain block loop and unfused stem, the code they
   replace. K2, K4 and K5 take their bf16 weights packed beforehand, as the
   eval ``DenseBlock`` keeps them. K1 on operands folded beforehand, as the
   eval ``ConcatFuse`` keeps them, at b1, b8, b32, b256 and 1280x1920, each
   in turns with its plain version and the fold (``fuse_operands``), and at
   b256 with the bare cuBLAS product of the normalized concat as a
   yardstick; each also as device time alone (the stream held busy while
   the host enqueues the call, so the event window holds no host time). Each kernel's bound is computed from the
   timed inputs: the larger of its operations over the card's peak rate for
   the inputs' type and the bytes it must move over the memory rate. Last,
   the train step at b32 and b128 (median ms, frames/s, peak memory, and
   its conv work counted by ``FlopCounterMode`` over the bf16 peak as its
   bound), the eval step at b32, and a ``torch.profiler`` breakdown of a
   b32 train step by phase (forward, loss, backward, optimizer, metrics)
   and kernel class. DenseNet-161's 1280x1920 forward on the K2 path, the
   K5 path and with its plain blocks (``dense_block_strip = "off"``), in
   turns, each with a ``torch.profiler`` breakdown; K2 and K5 at its two
   block shapes and K4 at its two 128x192 blocks at b256, each against its
   plain version and the model's own loop on the same block. The raw-record b32
   steps (``ht``, ``raw``) in turns with the dense step on the same frames,
   each profiled by phase with ``train_step/preprocess`` apart; the
   rasterizer and the device splat alone (by events and as device time
   alone); the host splat, native at two threads and its numpy form once.

Its last two lines are a JSON summary of the kernels (the six TPU kernels'
counterparts and the BN-ReLU pass) and the run's result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
HEIGHT, WIDTH = 128, 192
FULL_HEIGHT, FULL_WIDTH = 1280, 1920
NUM_PARAMS_DENSENET121 = 22_409_544
NUM_PARAMS_CONFIG3 = 23_560_136        # mid fusion before block 3
# Kernel bounds (K1, K2, K3), on max|kernel - plain| / max|plain|. f32: both
# accumulate in f32 (TF32 off) and differ only in summation order. bf16: the
# plain version runs in f32 from the same bf16 inputs and weights, so the
# bound covers the kernel's bf16 roundings (2^-9 relative each) with margin.
BOUND_F32 = 1e-4
BOUND_BF16 = 1e-2
# served bf16 heat maps against the same weights run in f32 (sigmoid
# outputs, absolute): bf16 rounding through ~130 conv layers. Measured
# 3.2e-3 on an H100 at 128x192 at the seed below.
BOUND_SERVED_VS_F32 = 2e-2
# The 1280x1920 path's kernel shapes: K2 and K5 per dense block (h, w, c0,
# layers), DenseNet-121's (growth 32, K 128: the layer bodies' narrow
# layout) and DenseNet-161's (growth 48, K 192: the wide layout), K3 (hh,
# hw, c_up, raw channels, c_mid, classes), DenseNet-121's head (the bf16
# body's narrow layout) and DenseNet-161's (c_mid 96, source 208: the wide
# layout, two passes over the mid channels).
K2_BLOCKS = {"block1": (320, 480, 64, 6), "block2": (160, 240, 128, 12)}
K2_BLOCKS_161 = {"block1": (320, 480, 96, 6), "block2": (160, 240, 192, 12)}
K3_FULL = (640, 960, 128, 4, 64, 3)
K3_FULL_161 = (640, 960, 192, 4, 96, 3)
# K4 per DenseNet-121 block at 128x192 (h, w, c0, layers), checked at the
# batches the opt-in path gives each block (the kernel picks its cluster of
# blocks per image from the batch: block 2 runs 4-block clusters at b1, b8
# and b32, block 1 6 at b1 and b8 and 4 at b32) and at b256 (one block per
# image), and timed at b256; K6's timed shapes (h, w, channels; 64
# features): the model's two stems at 1280x1920 and the RGB stem at 128x192
K4_BLOCKS = {"block1": (32, 48, 64, 6), "block2": (16, 24, 128, 12),
             "block3": (8, 12, 256, 24), "block4": (4, 6, 512, 16)}
K4_PATH_BATCHES = {"block1": (1, 8, 32), "block2": (1, 8, 32), "block3": (8, 32),
                   "block4": (32,)}
# K4 on DenseNet-161's 128x192 blocks 1 and 2 (h, w, c0, layers), which
# JAX's sample-group rule takes at every batch (blocks 3 and 4 at none),
# checked at the opt-in path's batches here and at b256, timed at b256
K4_BLOCKS_161 = {"block1": (32, 48, 96, 6), "block2": (16, 24, 192, 12)}
K4_BATCHES_161 = (1, 32)
K6_TIMED = {"": (FULL_HEIGHT, FULL_WIDTH, 3), "_c1": (FULL_HEIGHT, FULL_WIDTH, 1),
            "_128x192": (HEIGHT, WIDTH, 3)}
# K5's shapes besides the path's (name, h, w, c0, layers, growth, K): its
# plan cuts 37 rows into strips of 24 and 13, keeps 8 rows as one strip, and
# cuts 16 rows into strips of 8 under 12 layers
K5_EXTRA = [("ragged", 37, 53, 24, 3, 8, 32), ("single strip", 8, 24, 16, 3, 8, 32),
            ("deeper than its strips", 16, 40, 16, 12, 8, 32)]
# launches per device batch at 128x192 with both opt-ins: K4 on stream 1's
# blocks 1-2 and stream 2's block 1, block 3 from b8 and block 4 from b32
# (JAX's sample-group rule); K6 on both stems at b1 only
OPT_IN_LAUNCHES = {1: dict(K1=1, K2=0, K3=0, K4=3, K5=0, K6=2),
                   8: dict(K1=1, K2=0, K3=0, K4=4, K5=0, K6=0),
                   32: dict(K1=1, K2=0, K3=0, K4=5, K5=0, K6=0)}
# with gpu.use_fused_kernels = False: the plain concat and head, no kernel
NO_FUSED_LAUNCHES = dict(K1=0, K2=0, K3=0, K4=0, K5=0, K6=0)
# the (stream, block) pairs, 1-based, that a kernel takes whole on a served
# path, which the eval BN-ReLU pass then skips (_bn_relu_sites): K2 or K5 at
# 1280x1920 with mid fusion before block 3, K4 at 128x192 with the opt-ins
# per bucket (OPT_IN_LAUNCHES) and on DenseNet-161's K4 path
FULL_KERNEL_BLOCKS = ((1, 1), (1, 2), (2, 1), (2, 2))
OPT_IN_KERNEL_BLOCKS = {1: ((1, 1), (1, 2), (2, 1)), 8: ((1, 1), (1, 2), (2, 1), (1, 3)),
                        32: ((1, 1), (1, 2), (2, 1), (1, 3), (1, 4))}
K4_KERNEL_BLOCKS_161 = ((1, 1), (1, 2), (2, 1))
# K2's, K4's and K5's plain version, dense_block_strip_reference
PLAIN_BLOCK = "cuDNN bf16 convs, BN in f32 over each concat prefix"
# K2's and K3's extra bf16 shapes (name, h, w, c0, layers, growth, K; hh, hw,
# c_up, raw channels, c_mid, classes): K and G, c_mid and classes below the
# tensor-core tiles' multiples
K2_RAGGED_BF16 = [("ragged", 37, 53, 24, 3, 8, 32), ("ragged 2", 21, 35, 40, 4, 12, 48)]
# shapes in the wide layout besides DenseNet-161's (name, h, w, c0, layers,
# growth, K), for K2, K5 and K4 (at batch 3) in bf16 and f32: G 40 and K
# 160 padded to (192, 48), G 48 on a ragged plane, and a block deeper than
# K5's strips
WIDE_RAGGED = [("wide ragged", 37, 53, 24, 3, 40, 160), ("wide ragged 2", 21, 35, 48, 4, 48, 192),
               ("wide deeper than its strips", 16, 40, 16, 12, 48, 192)]
K3_RAGGED_BF16 = [(13, 21, 40, 3, 20, 3), (13, 21, 40, 3, 64, 8)]
# K3's wide-layout shapes besides DenseNet-161's head, in bf16 and f32:
# source 212 (224 padded) with c_mid 90 and 5 classes on a ragged plane, the
# widest source (256) at c_mid 96, and c_mid 64 on a source past 192 (the
# wide layout's padding)
K3_RAGGED_WIDE = [(13, 21, 200, 3, 90, 5), (9, 17, 240, 4, 96, 3), (13, 21, 192, 4, 64, 3)]
# The phase-space head's eval forms (refine1 as four 3x3 convs over the
# phases' slices, ops/phase_head.py's and the model's, and JAX's one 4x4
# conv over the masked window grid) beside the plain head, at DenseNet-121's
# 128x192 head (x_lo 64x96, c_up 128, raw 4, c_mid 64) at these batches
PHASE_HEAD_BATCHES = (32, 256)
KERNEL_NAMES = ("bn_relu_kernel", "concat_bn_relu_conv1x1_kernel", "dense_layer_kernel",
                "phase_head_kernel", "dense_block_kernel", "stem_pool_kernel",
                "dense_block_recompute_kernel", "concat_bn_relu_conv1x1_mma_kernel",
                "dense_layer_mma_kernel", "phase_head_mma_kernel", "dense_block_mma_kernel",
                "dense_block_recompute_mma_kernel", "stem_pool_mma_kernel")
# the kernels templated on the layer bodies' (K, G) layout, after their
# tile where they have one
LAYOUT_KERNELS = ("dense_layer_kernel", "dense_layer_mma_kernel", "dense_block_kernel",
                  "dense_block_mma_kernel", "dense_block_recompute_kernel",
                  "dense_block_recompute_mma_kernel")
# K1's shapes on the main path (batch, h, w, Ca, Cb, Cout): the 128x192
# buckets' fuse before block 2 and the 1280x1920 fuse before block 3
K1_PATH = {"b1": (1, 16, 24, 128, 128, 128), "b8": (8, 16, 24, 128, 128, 128),
           "b32": (32, 16, 24, 128, 128, 128), "b256": (256, 16, 24, 128, 128, 128),
           "full": (1, 80, 120, 256, 256, 256)}
# and besides them: 1,599 rows (a ragged last tile), K and N padding, 64-column
# N slices, and widths that are not multiples of 8 (the CUDA-core body)
K1_EXTRA_BF16 = [(3, 13, 41, 128, 128, 128), (2, 5, 7, 48, 16, 40), (4, 8, 12, 512, 512, 512),
                 (1, 25, 40, 12, 20, 24)]
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): the
# rate for the type of a kernel's inputs, and the memory rate. A kernel's
# bound is the larger of its operations over the first and the bytes it must
# move (each input read once, each output written once) over the second.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
# no single PyTorch call computes any of the six kernels' functions
LIBRARY_MS = None
# The train phase: DenseNet-121 mid fusion at 128x192 in bf16, TRAIN_STEPS
# steps of the config's Adam on one fixed batch of TRAIN_BATCH frames; the
# step is timed at each of TIMED_TRAIN_BATCHES.
TRAIN_BATCH = 32
TRAIN_STEPS = 10
TIMED_TRAIN_BATCHES = (32, 128)
# The bf16 step-0 loss (sum-reduced BCE over 2.36M pixels) against the same
# weights' f32 one, relative: the served heat maps of bf16 and f32 differ by
# ~3e-3 (absolute, in probability) through the same ~130 conv layers, and the
# loss sums such differences of both signs; train-mode BN takes its batch
# statistics from the bf16 activations.
BOUND_TRAIN_LOSS_VS_F32 = 2e-2
# bench.py's conv_flops_per_frame of this model at 128x192, printed beside
# the bound for comparison. It counts each stride-2 transposed conv's nine
# taps at every output pixel, four times that conv's work; the bound itself
# comes from the step's conv work as FlopCounterMode counts it (10.40 GFLOP
# a frame forward, 20.64 backward).
CONV_FLOPS_PER_FRAME = 15.83e9
# The raw-record phase: bench_suite.py's config 5 traffic at TRAIN_BATCH,
# the config's tpu.max_points points a frame and 64 boxes, on the 128x192
# model of the train phase; the host splat timed at the config's
# tpu.splat_threads. The device splat against the native host splat: the
# binning x * -6.2 + 255 may be one FMA on one side.
RAW_BOXES = 64
RAW_STEPS = 3
BOUND_SPLAT = 1e-4
# DenseNet-161 (growth 48, c_mid 96) at 1280x1920 b1 with mid fusion before
# block 3: JAX's gates run K2 on blocks 1 and 2 of both streams and K3 once,
# and so do the port's, K2 in the layer bodies' wide layout and K3 in its
# wide layout
NUM_PARAMS_DENSENET161_CONFIG3 = 85_911_080
NUM_PARAMS_DENSENET161 = 83_331_176    # mid fusion before block 2, 128x192
DENSENET161_JAX_KERNELS = dict(K2=4, K3=1)
DENSENET161_PORT_KERNELS = dict(K2=4, K3=1)
# its launches per device batch: at 1280x1920 on the default path and with
# dense_block_strip = "on", and at 128x192 (b1 and b32) with
# dense_block_impl = "pallas": K4 on stream 1's blocks 1-2 and stream 2's
# block 1
DENSENET161_LAUNCHES = {"default": dict(K1=1, K2=4, K3=1, K4=0, K5=0, K6=0),
                        "K5 path": dict(K1=1, K2=0, K3=1, K4=0, K5=4, K6=0),
                        "K4 path": dict(K1=1, K2=0, K3=0, K4=3, K5=0, K6=0)}
# The eval BN-ReLU pass on the two benchmarked forwards (default config,
# bf16): (constructor, mid fusion before block, batch, h, w, BN-ReLU sites of
# the plain path, forms of eval operands the forward folds). DenseNet-121 at
# 128x192: the sites of the stems, blocks 1-4 and stream 2's block 1, the
# transitions and the decoder stages (K1 takes the fuse, the phase-space head
# the head); DenseNet-161 at 1280x1920: the same less blocks 1-2 of both
# streams (K2) and the head (K3). The folds: each of those modules' plain
# form and the four transposed convs', and the fuse's (K1) and the head's
# (phase space; K3), and at 1280x1920 the four K2 blocks' too: 15 + 4 + 2 and
# 13 + 4 + 2 + 4.
BN_RELU_FORWARDS = {
    "densenet121 b256 128x192": ("densenet121_u_lidar", 2, 256, HEIGHT, WIDTH, 142, 21),
    "densenet161 b1 1280x1920": ("densenet161_u_lidar", 3, 1, FULL_HEIGHT, FULL_WIDTH, 135, 23),
}
# and channel counts past the sites': not a multiple of 8 (a vector spans two
# rows), fewer than 8, one channel, a 1x1 plane
BN_RELU_EXTRA = [(2, 132, 16, 24), (3, 3, 5, 7), (1, 1, 3, 3), (2, 7, 9, 11), (1, 44, 1, 1),
                 (5, 2212, 3, 3)]


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _median(values):
    return sorted(values)[len(values) // 2]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(flops, nbytes, dtype):
    """(bound_ms, bound_by) of work of ``flops`` operations on inputs of
    ``dtype`` that must move ``nbytes`` bytes."""
    ops_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _block_flops(batch, h, w, c0, layers, growth, k):
    """A dense block's multiply-adds, twice: each layer's 1x1 over its width
    and 3x3 over K, at every pixel (a recomputed halo is not work)."""
    return 2 * batch * h * w * sum((c0 + l * growth) * k + 9 * k * growth
                                   for l in range(layers))


def _block_bound(x, folded):
    """K2's, K4's and K5's bound on ``x`` and ``folded``: the input, the
    stacks and the (B, H, W, cmax) output."""
    batch, h, w, c0 = x.shape
    layers, _, _, k, growth = folded["w3"].shape
    out_bytes = batch * h * w * (c0 + layers * growth) * x.element_size()
    return _bound(_block_flops(batch, h, w, c0, layers, growth, k),
                  _nbytes(x, *folded.values()) + out_bytes, x.dtype)

def _median_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times), times


def _in_turns(*fns, iters):
    """Median ms of each of ``fns``, timed in turns: in order, then in
    reverse, ``iters`` iterations each time."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        times[i] += _median_ms(fns[i], iters)[1]
    return tuple(_median(t) for t in times)


def _device_ms(fn, iters, warmup=3, sleep=2_000_000):
    """Median ms of ``fn``'s device work alone: the stream sleeps (``sleep``
    cycles, ~1 ms by default) before the start event while the host enqueues
    the call, so the event window holds no host time."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times)


def _host_ms(fn, iters, warmup=2):
    """Median ms the host takes to enqueue ``fn``, from an idle device."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return _median(times)


def _check(name, shape, out, ref):
    """max|out - ref| against the bound of ``out``'s dtype; raises if over."""
    import torch

    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    bound = (BOUND_BF16 if out.dtype == torch.bfloat16 else BOUND_F32) * scale
    print(f"{name} check {shape} {str(out.dtype)[6:]}: max abs err {err:.3e} <= "
          f"bound {bound:.3e} (err / max|plain| {err / scale:.2e})")
    if not err <= bound:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {bound}")
    return err


def _check_equal(name, other, shape, out, ref):
    """Raise unless ``out`` equals ``ref`` bit for bit."""
    import torch

    diff = (out.float() - ref.float()).abs().max().item()
    same = torch.equal(out, ref)
    print(f"{name} vs {other} {shape} {str(out.dtype)[6:]}: bit for bit "
          f"{'equal' if same else 'DIFFERENT'} (max abs diff {diff:.3e})")
    if not same:
        raise AssertionError(f"{name} differs from {other} at {shape}: {diff}")


def _check_block_plan(lib, batch, h, w, sms, label, growth=32, k=128):
    """K4's launch plan from ``dmm_dense_block_plan`` against the Python
    mirror ``block_plan``; prints it and raises if the two differ."""
    import ctypes

    from dmmfods_tpu_torch.ops.dense_block import block_plan

    plan = block_plan(batch, h, w, sms, growth, k)
    got = (ctypes.c_int * len(plan.c_fields()))()
    rc = lib.dmm_dense_block_plan(batch, h, w, sms, growth, k,
                                  ctypes.cast(got, ctypes.c_void_p))
    print(f"K4 plan {label} ({batch}, {h}, {w}) G={growth} K={k}: {plan.tile[0]}x{plan.tile[1]} tiles, "
          f"{plan.tiles} an image, clusters of {plan.cluster}; bf16 body: "
          f"{plan.m16_1x1} m16 tiles of halo, {plan.m16_3x3} of outputs, {plan.units} "
          f"units, at most {plan.warp_units} a warp (warps' (m16 tile, n8 pair): "
          f"{' '.join(str(list(u)) for u in plan.warps)}), {plan.smem} B of shared "
          f"memory; C {'agrees' if rc == 0 and tuple(got) == plan.c_fields() else 'DIFFERS'}")
    if rc != 0 or tuple(got) != plan.c_fields():
        raise AssertionError(f"dmm_dense_block_plan {tuple(got)} (rc {rc}) differs from "
                             f"block_plan {plan.c_fields()}")


def _k1_inputs(gen, batch, h, w, ca, cb, cout, dtype, device):
    import torch

    k = ca + cb
    a = torch.randn(batch, h, w, ca, generator=gen).to(device, dtype)
    b = torch.randn(batch, h, w, cb, generator=gen).to(device, dtype)
    params = dict(
        scale=(torch.rand(k, generator=gen) + 0.5).to(device),
        bias=(torch.randn(k, generator=gen) * 0.1).to(device),
        mean=(torch.randn(k, generator=gen) * 0.1).to(device),
        var=(torch.rand(k, generator=gen) + 0.5).to(device),
        # weights the kernel's dtype holds exactly, so the plain f32 run
        # sees the same numbers
        weight=(torch.randn(cout, k, 1, 1, generator=gen) * 0.05).to(dtype).float().to(device),
    )
    return a, b, params


def _k1_operands(params, dtype):
    from dmmfods_tpu_torch.ops.fused import fuse_operands

    return fuse_operands(params["scale"], params["bias"], params["mean"], params["var"],
                         params["weight"], 1e-5, dtype)


def _k1_bound(a, b, operands, cout):
    """K1's bound: 2 R K Cout operations; a, b, gamma, beta and the weight
    (packed, or f32) read once, the (R, Cout) output written once."""
    rows = a.numel() // a.shape[-1]
    k = a.shape[-1] + b.shape[-1]
    weight_bytes = (_nbytes(operands[2]) if operands[2] is not None
                    else k * cout * 4)
    return _bound(2 * rows * k * cout,
                  _nbytes(a, b, *operands[:2]) + weight_bytes + rows * cout * a.element_size(),
                  a.dtype)


def _k1_error(out, a, b, params):
    """max|K1 - plain| and max|plain|, the plain version in f32."""
    from dmmfods_tpu_torch.ops.fused import concat_bn_relu_conv1x1_reference

    ref = concat_bn_relu_conv1x1_reference(a.float(), b.float(), **params)
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def _k5_recompute(h, layers, rows):
    """The rows K5's layers compute on strips of ``rows`` rows, over the
    block's ``h * L``: the price of the recomputed halo (layer ``l`` of a
    strip also computes the ``L - 1 - l`` rows a side later layers read)."""
    done = sum(min(r0 + rows + e, h) - max(r0 - e, 0)
               for r0 in range(0, h, rows) for e in range(layers))
    return done / (h * layers)


def _k2_inputs(gen, h, w, c0, layers, growth, k, dtype, device, batch=1):
    """Input and folded stacks of a random dense block (K2, K4). BN biases
    are wide enough that some folded BN2 bias is positive: a pixel outside
    the image then reads ReLU(b2) != 0 unless the kernel masks it, so a
    border bug shows. Weights are ones the kernel's dtype holds exactly."""
    import torch

    c_max = c0 + layers * growth
    g1 = torch.zeros(layers, c_max)
    b1 = torch.zeros(layers, c_max)
    w1 = torch.zeros(layers, c_max, k)
    for l in range(layers):
        width = c0 + l * growth
        g1[l, :width] = torch.rand(width, generator=gen) + 0.5
        b1[l, :width] = torch.randn(width, generator=gen) * 0.5
        w1[l, :width] = torch.randn(width, k, generator=gen) * (2 / width) ** 0.5
    folded = dict(
        g1=g1, b1=b1, w1=w1,
        g2=torch.rand(layers, k, generator=gen) + 0.5,
        b2=torch.randn(layers, k, generator=gen) * 0.5,
        w3=torch.randn(layers, 3, 3, k, growth, generator=gen) * (2 / (9 * k)) ** 0.5)
    for name in ("w1", "w3"):
        folded[name] = folded[name].to(dtype).float()
    x = torch.randn(batch, h, w, c0, generator=gen).to(device, dtype)
    return x, {name: t.to(device) for name, t in folded.items()}


def _k3_inputs(gen, hh, hw, c_up, rc, c_mid, n_cls, dtype, device, batch=1):
    """Inputs and folded constants of a random head (weights exact in dtype)."""
    import torch

    c_in = c_up + rc
    x_lo = torch.randn(batch, hh, hw, c_up, generator=gen).to(device, dtype)
    raw = torch.rand(batch, 2 * hh, 2 * hw, rc, generator=gen).to(device, dtype)
    consts = dict(
        g0=torch.rand(c_in, generator=gen) + 0.5,
        b0=torch.randn(c_in, generator=gen) * 0.5,
        w0=(torch.randn(c_mid, c_in, 3, 3, generator=gen) * (2 / (9 * c_in)) ** 0.5
            ).to(dtype).float(),
        g1=torch.rand(c_mid, generator=gen) + 0.5,
        b1=torch.randn(c_mid, generator=gen) * 0.5,
        w1=(torch.randn(n_cls, c_mid, 5, 5, generator=gen) * (2 / (25 * c_mid)) ** 0.5
            ).to(dtype).float())
    return x_lo, raw, {name: t.to(device) for name, t in consts.items()}


def _k6_inputs(gen, batch, h, w, c, f, dtype, device):
    """A random frame (values in [0, 1]) and a random stem: conv0 weights
    exact in dtype, folded norm0 with biases of both signs, so a pool
    padding that contributes ReLU(beta) shows."""
    import torch

    x = torch.rand(batch, h, w, c, generator=gen).to(device, dtype)
    w7 = (torch.randn(7, 7, c, f, generator=gen) * (2 / (49 * c)) ** 0.5).to(dtype).float()
    gamma = torch.rand(f, generator=gen) + 0.5
    beta = torch.randn(f, generator=gen) * 0.5
    return x, w7.to(device), gamma.to(device), beta.to(device)


def _bn_relu_phase(device):
    """Phase 4b: the eval BN-ReLU pass (``ops/bn_relu.py``). One bf16 eval
    forward of each of ``BN_RELU_FORWARDS`` launches it once per plain-path
    site and folds once per form of eval operands it runs, a second forward
    folds nothing, and a train-mode forward launches none; then the kernel
    against the exact value rounded once (bf16: within one ulp) and against
    its plain version (f32: 1e-6) at every site shape the forward met and at
    ``BN_RELU_EXTRA``; a layout and dtype it does not take raise. Timed, as
    device time alone: the forward's sites in sequence as the kernel, as its
    plain version and as the per-call passes it replaces (a broadcast mul
    and add in bf16, a ReLU), against the bound of their bytes; the host's
    time to enqueue the sites both ways; the fold cache's checks; and the
    forward on kept operands in turns with the plain path's per-call fold
    and passes. Returns the kernel's JSON entry."""
    import torch

    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.models import dense_unet_lidar as pm
    from dmmfods_tpu_torch.ops import bn_relu as br

    entry = {"name": "bn_relu", "route": "cuda", "source": "dmmfods_tpu_torch/csrc/bn_relu.cu",
             "replaces": None, "library_ms": LIBRARY_MS}
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0.0
    kept = pm.eval_operands

    def per_call(module, form, dtype, make):   # the plain path folded per call
        return make() if form == "plain" else kept(module, form, dtype, make)

    def check(shape, dt):
        nonlocal worst
        c = shape[1]
        x = torch.randn((shape[0], shape[2], shape[3], c), generator=gen, device=device)
        x = (2 * x).to(dt).permute(0, 3, 1, 2)
        scale = torch.rand(c, generator=gen, device=device) + 0.5
        shift = torch.randn(c, generator=gen, device=device) * 0.3
        out = br.bn_relu(x, scale, shift)
        torch.cuda.synchronize()
        exact = torch.relu(x.double() * scale.double()[:, None, None]
                           + shift.double()[:, None, None])
        if dt == torch.bfloat16:
            want = exact.to(dt).double()
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
            err = (out.double() - want).abs()
            ok = bool((err <= ulp).all())
        else:
            err = (out.double() - br.bn_relu_reference(x, scale, shift).double()).abs()
            ok = bool((err <= 1e-6 * exact.abs() + 1e-6).all())
        worst = max(worst, err.max().item())
        if not ok or out.stride() != x.stride():
            raise AssertionError(f"BN-ReLU at {shape} {dt}: max err {err.max().item()}")

    for label, (constructor, fuse, batch, h, w, sites, forms) in BN_RELU_FORWARDS.items():
        cfg = get_config()
        cfg.model.concat_before_block_num = fuse
        module = getattr(pm, constructor)(config=cfg, device=device, seed=SEED).module
        rgb = torch.rand(batch, h, w, 3, generator=gen, device=device)
        lidar = torch.rand(batch, h, w, 1, generator=gen, device=device)
        shapes = []

        def spy(x, scale, shift):
            shapes.append((tuple(x.shape), x.stride()))
            return br.bn_relu(x, scale, shift)

        pm.bn_relu = spy
        counts = []
        with torch.inference_mode():
            for _ in range(3):
                before = br.BN_RELU_LAUNCHES.value, br.BN_FOLDS.value
                module(rgb, lidar)
                torch.cuda.synchronize()
                counts.append((br.BN_RELU_LAUNCHES.value - before[0],
                               br.BN_FOLDS.value - before[1]))
        pm.bn_relu = br.bn_relu
        launches = br.BN_RELU_LAUNCHES.value
        with torch.no_grad():
            module.train()(rgb, lidar)
        module.eval()
        train_launches = br.BN_RELU_LAUNCHES.value - launches
        shapes = shapes[:sites]
        elements = sum(math.prod(shape) for shape, _ in shapes)
        print(f"BN-ReLU {label}: BN_RELU_LAUNCHES per forward {[n for n, _ in counts]}, "
              f"BN_FOLDS {[f for _, f in counts]} (want {sites} sites, {forms} folds once; "
              f"hit share over 3 forwards {1 - sum(f for _, f in counts) / (3 * forms):.3f}), "
              f"train mode {train_launches}; {elements:,} elements a forward")
        if (counts != [(sites, forms), (sites, 0), (sites, 0)] or train_launches
                or len(shapes) != sites):
            raise AssertionError(f"BN-ReLU launches or folds off: {counts}, train "
                                 f"{train_launches}")
        for shape in sorted({shape for shape, _ in shapes}):
            for dt in (torch.bfloat16, torch.float32):
                check(shape, dt)
        # the forward's sites as three passes, as the plain version, as the kernel
        ops = []
        for shape, stride in shapes:
            x = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=device)
            x.normal_(generator=gen)
            ops.append((x, torch.rand(shape[1], device=device) + 0.5,
                        torch.randn(shape[1], device=device) * 0.1))

        def kernel():
            for x, scale, shift in ops:
                br.bn_relu(x, scale, shift)

        def plain():
            for x, scale, shift in ops:
                br.bn_relu_reference(x, scale, shift)

        def three_passes():
            for x, scale, shift in ops:
                torch.relu(x * scale.to(x.dtype)[:, None, None]
                           + shift.to(x.dtype)[:, None, None])

        bound_ms = elements * 2 * 2 / PEAK_BYTES_PER_S * 1e3
        dev = {name: _device_ms(fn, 10) for name, fn in
               (("kernel", kernel), ("plain", plain), ("three", three_passes))}
        host = {name: _host_ms(fn, 10) for name, fn in
                (("kernel", kernel), ("three", three_passes))}
        print(f"BN-ReLU {label}: the {sites} sites' device time alone, kernel "
              f"{dev['kernel']:.4f} ms ({bound_ms / dev['kernel']:.1%} of the bound), plain "
              f"version {dev['plain']:.4f} ms, the per-call passes (mul, add, ReLU) "
              f"{dev['three']:.4f} ms; bound {bound_ms:.4f} ms (bytes); host enqueue, kernel "
              f"{host['kernel']:.4f} ms, per-call passes {host['three']:.4f} ms")
        spent = []

        def timed(module, form, dtype, make):
            t0 = time.perf_counter()
            ops = kept(module, form, dtype, make)
            spent[-1] += time.perf_counter() - t0
            return ops

        pm.eval_operands = timed
        with torch.inference_mode():
            for _ in range(5):
                spent.append(0.0)
                module(rgb, lidar)
        pm.eval_operands = kept
        check_ms = _median(spent) * 1e3
        fwd = {}
        with torch.inference_mode():
            for name, fn, run in (("kept", kept, br.bn_relu),
                                  ("per call", per_call, br.bn_relu_reference),
                                  ("per call", per_call, br.bn_relu_reference),
                                  ("kept", kept, br.bn_relu)):
                pm.eval_operands, pm.bn_relu = fn, run
                fwd.setdefault(name, []).append(
                    (_device_ms(lambda: module(rgb, lidar), 5, sleep=200_000_000),
                     _host_ms(lambda: module(rgb, lidar), 5)))
            pm.eval_operands, pm.bn_relu = kept, br.bn_relu
        fwd = {name: (_median([d for d, _ in v]), _median([h for _, h in v]))
               for name, v in fwd.items()}
        print(f"BN-ReLU {label}: the fold cache's {forms} checks {check_ms:.4f} ms of host a "
              f"forward; the forward (in turns), device "
              f"time alone / host enqueue: kept operands and the kernel {fwd['kept'][0]:.3f} / "
              f"{fwd['kept'][1]:.3f} ms, the per-call fold and passes {fwd['per call'][0]:.3f} / "
              f"{fwd['per call'][1]:.3f} ms")
        key = "b256" if batch == 256 else "full"
        entry.update({f"ms_{key}": dev["kernel"], f"plain_ms_{key}": dev["plain"],
                      f"per_call_passes_ms_{key}": dev["three"], f"bound_ms_{key}": bound_ms,
                      f"host_ms_{key}": host["kernel"],
                      f"per_call_passes_host_ms_{key}": host["three"],
                      f"forward_device_ms_{key}": fwd["kept"][0],
                      f"forward_host_ms_{key}": fwd["kept"][1],
                      f"per_call_forward_device_ms_{key}": fwd["per call"][0],
                      f"per_call_forward_host_ms_{key}": fwd["per call"][1],
                      f"fold_check_ms_{key}": check_ms, f"sites_{key}": sites})
        del module, ops, rgb, lidar
        torch.cuda.empty_cache()
    for shape in BN_RELU_EXTRA:
        for dt in (torch.bfloat16, torch.float32):
            check(shape, dt)
    scale, shift = torch.ones(16, device=device), torch.zeros(16, device=device)
    refused = []
    for name, x, error in (
            ("NCHW-contiguous", torch.zeros(2, 16, 4, 4, device=device), ValueError),
            ("float16", torch.zeros(2, 4, 4, 16, device=device).half().permute(0, 3, 1, 2),
             TypeError),
            ("off 16 bytes", torch.zeros(2 * 4 * 4 * 16 + 3, dtype=torch.bfloat16,
                                         device=device)[3:].view(2, 4, 4, 16).permute(0, 3, 1, 2),
             ValueError)):
        try:
            br.bn_relu(x, scale, shift)
        except error:
            refused.append(name)
    if len(refused) != 3:
        raise AssertionError(f"BN-ReLU took what it must refuse: only {refused} raised")
    print(f"BN-ReLU checks: every site shape of both forwards and {len(BN_RELU_EXTRA)} more, "
          f"bf16 within one ulp of the exact value rounded once and f32 within 1e-6 of the "
          f"plain version (max abs err {worst:.3e}); refused: {', '.join(refused)}")
    entry.update(max_abs_err=worst,
                 ms=entry["ms_b256"], plain_ms=entry["plain_ms_b256"],
                 bound_ms=entry["bound_ms_b256"], bound_by="bytes")
    return entry


def _launch_counts():
    from dmmfods_tpu_torch.ops import (bn_relu, dense_block, dense_block_strip, fused,
                                       phase_head, stem_pool)

    return {"K1": fused.K1_LAUNCHES, "K2": dense_block_strip.K2_LAUNCHES,
            "K3": phase_head.K3_LAUNCHES, "K4": dense_block.K4_LAUNCHES,
            "K5": dense_block_strip.K5_LAUNCHES, "K6": stem_pool.K6_LAUNCHES,
            "bn_relu": bn_relu.BN_RELU_LAUNCHES}


def _reset_counts():
    for count in _launch_counts().values():
        count.reset()


def _counts():
    return {name: count.value for name, count in _launch_counts().items()}


def _bn_relu_sites(spec, kernel_blocks=(), k6=False):
    """The eval BN-ReLU pass's launches in one forward of a mid-fusion model
    (``spec``), from the architecture alone: each stem's norm0 unless K6
    takes the stems (``k6``), two for each layer of a dense block that no
    kernel takes (``kernel_blocks``: the 1-based ``(stream, block)`` pairs
    K2, K4 or K5 takes whole), one for each transition (stream 2 has one
    after each of its blocks), two for each decoder stage, and without
    ``use_fused_kernels`` the fuse's one and the head's two."""
    if spec.fusion != "mid":
        raise ValueError(f"counts the sites of mid fusion only, got {spec.fusion!r}")
    sites = 0 if k6 else 2
    for stream, blocks in ((1, len(spec.block_config)), (2, spec.concat_before_block_num - 1)):
        sites += sum(2 * layers for i, layers in enumerate(spec.block_config[:blocks])
                     if (stream, i + 1) not in kernel_blocks)
        sites += min(blocks, len(spec.block_config) - 1)
    sites += 2 * len(spec.decoder_stage_features())
    return sites if spec.use_fused_kernels else sites + 3


def _per_batch(counts, batches, want):
    """Raise unless ``counts`` are ``want`` launches per device batch."""
    expected = {name: n * batches for name, n in want.items()}
    if counts != expected:
        raise AssertionError(f"launches {counts} for {batches} device batches, "
                             f"want {want} per batch")
    print("launches per device batch: " + ", ".join(
        f"{name} {n}" for name, n in want.items()) + f" ({batches} batches)")


def _check_heat_maps(requests, results, h, w):
    import numpy as np

    for (rgb, _), out in zip(requests, results):
        want = (rgb.shape[0], h, w, 3)
        if out.shape != want:
            raise AssertionError(f"heat maps {out.shape}, want {want}")
        if not (np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1):
            raise AssertionError("heat maps not finite in [0, 1]")


def _served_vs_f32(bundle, rgb, lidar, served, device, label):
    """The served bf16 heat maps against the same weights run in f32."""
    import numpy as np
    import torch

    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelSpec

    # the default dispatch in f32: the opt-in kernels are held against the
    # default path
    ref_model = DenseUNetLidar(dataclasses.replace(
        bundle.spec, dtype=torch.float32, dense_block_impl=ModelSpec.dense_block_impl,
        dense_block_strip=ModelSpec.dense_block_strip,
        stem_pool_strip=ModelSpec.stem_pool_strip))
    ref_model.load_state_dict(bundle.module.state_dict())
    ref_model = ref_model.to(device, memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        ref = torch.sigmoid(ref_model(torch.from_numpy(rgb).to(device),
                                      torch.from_numpy(lidar).to(device)))
    diff = np.abs(served - ref.cpu().numpy())
    print(f"served bf16 vs f32 model, {label}, {rgb.shape[0]} frames: max abs diff "
          f"{diff.max():.3e} (mean {diff.mean():.3e}) <= bound {BOUND_SERVED_VS_F32}")
    if not diff.max() <= BOUND_SERVED_VS_F32:
        raise AssertionError(f"served heat maps disagree with the f32 model ({label})")


def _serve(engine, requests, sync_request):
    """Warm-up, the worker with ``requests``, one synchronous request, stop.
    Returns the results (the synchronous one last) and the wall seconds."""
    t0 = time.perf_counter()
    engine.warmup()
    engine.start()
    futures = [engine.submit(rgb, lidar) for rgb, lidar in requests]
    results = [f.result(timeout=600) for f in futures]
    results.append(engine.run(*sync_request))
    engine.stop()
    return results, time.perf_counter() - t0


def _ptxas_report(build_log, lib):
    """ptxas's registers, spills and static shared memory per kernel
    instantiation, from the build log, with the tensor-core kernels' dynamic
    shared memory from the library (K4's from ``dense_block.mma_smem`` of its
    tile and layout, which ``dmm_dense_block_plan`` confirms); raises, after
    the whole report, if any instantiation spills."""
    import re

    from dmmfods_tpu_torch.ops.dense_block import mma_smem

    name, kernel, args, spills, spilled = "?", "?", [], (0, 0), []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for n in KERNEL_NAMES if n in line), "?")
            args = [int(n) for n in re.findall(r"Li(\d+)E", line)]
            tile = layout = None
            if name in LAYOUT_KERNELS:
                tile, layout = (args[:2], args[2:4]) if len(args) == 4 else (None, args[:2])
            kernel = (f"{name}<{'bf16' if 'nv_bfloat16' in line else 'f32'}"
                      + (f", {tile[0]}x{tile[1]}" if tile else "")
                      + (f", K {layout[0]} G {layout[1]}" if layout else "")
                      + (f", C={args[0]}" if name == "stem_pool_mma_kernel" else "")
                      + (f", source <= {args[0]}, c_mid <= {args[1]} in passes of {args[2]}"
                         if name == "phase_head_mma_kernel" else "")
                      + (f", c_mid <= {args[0]}" if name == "phase_head_kernel" else "")
                      + (f", N slice {args[0]}" if name == "concat_bn_relu_conv1x1_mma_kernel"
                         else "") + ">")
        elif "spill stores" in line:
            spills = tuple(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "registers" in line:
            dynamic = ""
            if name == "phase_head_mma_kernel":
                dynamic = f", {lib.dmm_phase_head_mma_smem(*args[:2])} bytes dynamic smem"
            elif name in ("dense_layer_mma_kernel", "dense_block_recompute_mma_kernel"):
                dynamic = f", {lib.dmm_dense_layer_mma_smem(*layout)} bytes dynamic smem"
            elif name == "dense_block_mma_kernel":
                dynamic = f", {mma_smem(*tile, *layout)} bytes dynamic smem"
            elif name == "stem_pool_mma_kernel":
                dynamic = f", {lib.dmm_stem_pool_mma_smem(args[0])} bytes dynamic smem"
            elif name == "concat_bn_relu_conv1x1_mma_kernel":
                widths = [s[3:] for s in (*K1_PATH.values(), *K1_EXTRA_BF16)
                          if lib.dmm_concat_bn_relu_conv1x1_tile_n(*s[3:]) == args[0]]
                dynamic = "".join(
                    f", {lib.dmm_concat_bn_relu_conv1x1_mma_smem(*w)} bytes dynamic smem at "
                    f"{w[0]}+{w[1]}->{w[2]}" for w in dict.fromkeys(widths))
            print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}; spill stores "
                  f"{spills[0]} B, loads {spills[1]} B{dynamic}")
            if any(spills):
                spilled.append(f"{kernel} {spills[0]} B stored, {spills[1]} B loaded")
    if spilled:
        raise AssertionError("kernels spill: " + "; ".join(spilled))


# torch.profiler's kernel names -> the classes of the device-time breakdown
PROFILE_CLASSES = (("BN-ReLU", ("bn_relu_kernel",)),
                   ("K1", ("concat_bn_relu",)), ("K2", ("dense_layer",)),
                   ("K3", ("phase_head",)),
                   ("K4", ("dense_block_kernel", "dense_block_mma_kernel")),
                   ("K5", ("dense_block_recompute",)), ("K6", ("stem_pool",)),
                   ("convolutions (cuDNN/CUTLASS)", ("conv", "cudnn", "cutlass", "xmma",
                                                     "gemm", "sm90")),
                   ("matrix products (cuBLAS)", ("nvjet",)),
                   ("concat copies", ("catarray",)), ("pooling", ("pool",)),
                   ("copies and fills", ("memcpy", "memset")),
                   ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")))


def _profile_calls(fn, steps):
    """After a warm-up call: the host's enqueue time of one call of ``fn``
    (ms), and ``torch.profiler``'s events of ``steps`` more calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return enqueue_ms, prof.events()


def _print_profile(tag, fn, event_ms, label, steps=3):
    """Device time of ``fn`` by kernel class over ``steps`` calls after a
    warm-up (``torch.profiler``'s device events), its busy share of
    ``event_ms``, and the host's enqueue time of one call."""
    from torch.autograd import DeviceType

    enqueue_ms, events = _profile_calls(fn, steps)
    by_class, launches = {}, 0
    for ev in events:
        # the program's spans land on the device's timeline as annotations
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        name = ev.name.lower()
        cls = next((c for c, keys in PROFILE_CLASSES if any(k in name for k in keys)),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + ev.time_range.elapsed_us() / 1e3 / steps
        launches += 1
    total = sum(by_class.values())
    if total <= 0:
        raise AssertionError(f"the profile of the {label} shows no device time")
    print(f"{tag} profile of the {label} ({steps} calls after a warm-up): "
          f"{total:.4f} ms of device time per call in {launches / steps:.0f} device "
          f"operations, busy share {total / event_ms:.3f} of the {event_ms:.4f} ms event "
          f"median; the host enqueues one call in {enqueue_ms:.4f} ms; "
          + ", ".join(f"{c} {ms:.4f} ms ({ms / total:.1%})" for c, ms in
                      sorted(by_class.items(), key=lambda kv: -kv[1])))


def _serve_buckets(engine, spec, rng, h, w, label):
    """One synchronous request per bucket of the opt-in engine (``spec``'s
    model), each one device batch: its launches must be
    ``OPT_IN_LAUNCHES``, and the eval BN-ReLU pass's the sites the blocks
    K4 leaves (``OPT_IN_KERNEL_BLOCKS``) and, past b1, the stems. Returns
    the summed counts and the b8 request with its heat maps."""
    import numpy as np

    total = dict.fromkeys(_launch_counts(), 0)
    kept = None
    for bucket, want in OPT_IN_LAUNCHES.items():
        want = {**want, "bn_relu": _bn_relu_sites(spec, OPT_IN_KERNEL_BLOCKS[bucket],
                                                  k6=bool(want["K6"]))}
        rgb = rng.uniform(0, 1, (bucket, h, w, 3)).astype(np.float32)
        lidar = rng.uniform(0, 1, (bucket, h, w, 1)).astype(np.float32)
        before = engine.device_batches
        _reset_counts()
        out = engine.run(rgb, lidar)
        counts = _counts()
        _check_heat_maps([(rgb, lidar)], [out], h, w)
        print(f"{label} b{bucket}: ", end="")
        _per_batch(counts, engine.device_batches - before, want)
        total = {name: total[name] + counts[name] for name in total}
        if bucket == 8:
            kept = (rgb, lidar, out)
    return total, kept


def _train_batch(gen, batch, device):
    """A fixed training batch: RGB in [0, 1), one LiDAR channel, and heat
    maps in [0, 1] (uniform to the 4th power: ~8.5% of each class's pixels
    at or above the 0.7 threshold)."""
    import torch

    rgb = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen)
    lidar = torch.rand(batch, HEIGHT, WIDTH, 1, generator=gen)
    heat = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen) ** 4
    return rgb.to(device), lidar.to(device), heat.to(device)


def _check_eval_metrics(metrics):
    """Raise unless every eval metric is finite and AP and accuracy lie in
    [0, 1]."""
    import torch

    for key, value in metrics.items():
        if not torch.isfinite(value.float()).all():
            raise AssertionError(f"eval metric {key} is not finite: {value}")
    for key in ("ap_per_class", "acc_per_class"):
        if not ((metrics[key] >= 0).all() and (metrics[key] <= 1).all()):
            raise AssertionError(f"eval {key} outside [0, 1]: {metrics[key]}")


def _train(bundle, cfg, device, gen, path_counts, batch=TRAIN_BATCH, steps=TRAIN_STEPS):
    """Phases 10-12 on ``bundle``: ``steps`` train steps on one batch with no
    kernel launched, the eval step after them with K1 once and the trained
    eval logits equal bit for bit to a fresh model's that loaded the trained
    state_dict, and the step-0 loss against the same weights in f32. Returns
    the train state, the step and the eval step."""
    import torch

    from dmmfods_tpu_torch import trainer
    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar

    module = bundle.module
    initial = {k: v.clone() for k, v in module.state_dict().items()}
    rgb, lidar, heat = _train_batch(gen, batch, device)
    forward = trainer.make_forward(module, cfg)
    forward(rgb, lidar)                   # the eval folds exist before training
    optimizer = trainer.make_optimizer(cfg, module.parameters())
    state = trainer.create_train_state(bundle, optimizer)
    step = trainer.make_train_step(module, optimizer, cfg)
    torch.cuda.synchronize(device)

    # 10. train --------------------------------------------------------------
    _reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, rgb, lidar, heat)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist()
    train_s = time.perf_counter() - t0
    counts = _counts()
    path_counts.append(counts)
    print(f"train: {steps} steps of densenet121_u_lidar {bundle.spec.fusion} fusion, "
          f"{str(bundle.spec.dtype)[6:]}, b{batch} {HEIGHT}x{WIDTH}, Adam (lr "
          f"{cfg.optimizer.learning_rate}, amsgrad {cfg.optimizer.amsgrad}, weight decay "
          f"{cfg.optimizer.weight_decay}) on one batch in {train_s:.2f} s wall; losses "
          + ", ".join(f"{x:.1f}" for x in losses) + f"; launches {counts}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower a finite loss: {losses}")
    if any(counts.values()):
        raise AssertionError(f"a kernel launched in train mode: {counts}")
    for key in ("iou_per_class", "acc_per_class", "loss_per_class", "iou_nans"):
        if tuple(metrics[key].shape) != (3,) or not torch.isfinite(metrics[key]).all():
            raise AssertionError(f"train metric {key}: {metrics[key]}")

    # 11. eval after training ----------------------------------------------
    eval_step = trainer.make_eval_step(module, cfg)
    _reset_counts()
    metrics = eval_step(state, rgb, lidar, heat)
    torch.cuda.synchronize(device)
    path_counts.append(_counts())
    print("eval step after training: " + ", ".join(
        f"{k} {[round(x, 5) for x in v.float().reshape(-1).tolist()]}"
        for k, v in metrics.items()
        if k != "ap_bin_counts") + f", ap_bin_counts {int(metrics['ap_bin_counts'][1].sum())} "
        f"pixels; ", end="")
    _per_batch(path_counts[-1], 1, dict(K1=1, K2=0, K3=0, K4=0, K5=0, K6=0,
                                        bn_relu=_bn_relu_sites(bundle.spec)))
    _check_eval_metrics(metrics)
    trained = forward(rgb, lidar)
    fresh = DenseUNetLidar(bundle.spec, generator=torch.Generator().manual_seed(SEED + 1))
    fresh = fresh.to(device, memory_format=torch.channels_last)
    fresh.load_state_dict(module.state_dict())
    _check_equal("eval logits of the trained model", "a fresh model loaded with its "
                 "state_dict", f"b{batch}", trained, trainer.make_forward(fresh, cfg)(rgb, lidar))
    del fresh, trained

    # 12. the step-0 loss against f32 ------------------------------------------
    f32 = DenseUNetLidar(dataclasses.replace(bundle.spec, dtype=torch.float32))
    f32 = f32.to(device, memory_format=torch.channels_last)
    f32.load_state_dict(initial)
    optimizer32 = trainer.make_optimizer(cfg, f32.parameters())
    _, metrics32 = trainer.make_train_step(f32, optimizer32, cfg)(
        trainer.TrainState(f32, optimizer32), rgb, lidar, heat)
    loss32 = metrics32["loss"].item()
    rel = abs(losses[0] - loss32) / abs(loss32)
    print(f"step-0 loss {str(bundle.spec.dtype)[6:]} {losses[0]:.2f} vs f32 (TF32 off) "
          f"{loss32:.2f}: relative "
          f"difference {rel:.3e} <= bound {BOUND_TRAIN_LOSS_VS_F32}")
    if not rel <= BOUND_TRAIN_LOSS_VS_F32:
        raise AssertionError(f"bf16 step-0 loss {losses[0]} disagrees with f32 {loss32}")
    del f32, optimizer32, initial
    return state, step, eval_step


# the train step's phases (record_function ranges of trainer.py and the
# optimizer's own), and device kernels by name
TRAIN_PHASES = (("optimizer", "Optimizer.step#"), ("loss", "train_step/loss"),
                ("metrics", "train_step/metrics"), ("forward", "train_step/forward"),
                ("backward", "train_step/backward"), ("preprocess", "train_step/preprocess"))
TRAIN_KERNELS = (("BN", ("bn_", "batch_norm", "batchnorm", "welford")),
                 ("convolutions", ("conv", "cudnn", "cutlass", "xmma", "gemm", "sm90",
                                   "nvjet", "implicit")),
                 ("concat copies", ("catarray",)), ("pooling", ("pool",)),
                 ("optimizer", ("multi_tensor",)),
                 ("copies and fills", ("memcpy", "memset", "copy")),
                 ("elementwise and reductions", ("elementwise", "vectorized", "unrolled",
                                                 "reduce", "scatter", "scan", "sort")))


def _train_phase(event):
    """The train-step phase of a CPU op, from its ancestors: autograd's
    backward ops run on their own thread under ``evaluate_function``."""
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        for phase, prefix in TRAIN_PHASES:
            if event.name.startswith(prefix):
                return phase
        event = event.cpu_parent
    return "outside the step's ranges"


def _print_train_profile(tag, fn, event_ms, label, steps=3):
    """Device time of train steps by phase and kernel class over ``steps``
    steps after a warm-up: each kernel is charged to the phase of the CPU op
    that launched it. With the busy share of ``event_ms`` and the host's
    enqueue time of one step."""
    from torch.autograd import DeviceType

    enqueue_ms, events = _profile_calls(fn, steps)
    # the device timeline also holds a span per record_function range
    # (a user annotation): not device work
    total = sum(ev.time_range.elapsed_us() for ev in events
                if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation
                ) / 1e3 / steps
    if total <= 0:
        raise AssertionError(f"the profile of the {label} shows no device time")
    host = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.is_user_annotation:
            phase = next((p for p, prefix in TRAIN_PHASES if ev.name.startswith(prefix)),
                         None)
            if phase is not None:
                host[phase] = host.get(phase, 0.0) + ev.time_range.elapsed_us() / 1e3 / steps
    by_class, launches = {}, 0
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        phase = _train_phase(ev)
        for kernel in ev.kernels:
            name = kernel.name.lower()
            cls = next((c for c, keys in TRAIN_KERNELS if any(k in name for k in keys)),
                       "other")
            key = f"{phase}: {cls}"
            by_class[key] = by_class.get(key, 0.0) + kernel.duration / 1e3 / steps
            launches += 1
    attributed = sum(by_class.values())
    print(f"{tag} profile of the {label} ({steps} steps after a warm-up): {total:.4f} ms "
          f"of device time per step in {launches / steps:.0f} attributed device operations "
          f"({attributed:.4f} ms attributed), busy share {total / event_ms:.3f} of the "
          f"{event_ms:.4f} ms event median; the host enqueues one step in {enqueue_ms:.4f} "
          f"ms; " + ", ".join(f"{c} {ms:.4f} ms ({ms / total:.1%})" for c, ms in
                              sorted(by_class.items(), key=lambda kv: -kv[1])))
    print(f"{tag} host time of the {label} by phase, under the profiler (each range's "
          f"wall time on the host, per step): " + ", ".join(
              f"{phase} {host.get(phase, 0.0):.4f} ms" for phase, _ in TRAIN_PHASES))
    return by_class, host


def _time_train(tag, state, step, eval_step, gen, device):
    """The train step's median ms, frames/s and peak memory at each of
    ``TIMED_TRAIN_BATCHES`` beside the conv-work bound, the eval step at the
    first, and the profile of a train step at the first."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    timed = {}
    for batch in TIMED_TRAIN_BATCHES:
        data = _train_batch(gen, batch, device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        ms, _ = _median_ms(lambda: step(state, *data), iters=10)
        peak = torch.cuda.max_memory_allocated(device)
        with FlopCounterMode(display=False) as counter:
            step(state, *data)
        flops = counter.get_total_flops()
        bound_ms = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
        issue_ms = 3 * CONV_FLOPS_PER_FRAME * batch / PEAK_FLOPS["torch.bfloat16"] * 1e3
        timed[batch] = dict(ms=ms, data=data)
        print(f"{tag} train step b{batch} bf16 {HEIGHT}x{WIDTH}: median {ms:.4f} ms, "
              f"{batch / ms * 1e3:.1f} frames/s (10 iterations after 3 of warm-up), peak "
              f"memory allocated {peak / 2**30:.3f} GiB; conv work {flops / 1e12:.4f} TFLOP "
              f"a step (FlopCounterMode: forward and backward convolutions), bound "
              f"{bound_ms:.4f} ms at 989 TFLOP/s, the step at {bound_ms / ms:.4f} of it "
              f"(bench.py's count, 3 x {CONV_FLOPS_PER_FRAME / 1e9:.2f} GFLOP a frame, gives "
              f"{issue_ms:.4f} ms)")
    data = timed[TIMED_TRAIN_BATCHES[0]]["data"]
    torch.cuda.reset_peak_memory_stats(device)
    eval_ms, _ = _median_ms(lambda: eval_step(state, *data), iters=10)
    print(f"{tag} eval step b{TIMED_TRAIN_BATCHES[0]} bf16 {HEIGHT}x{WIDTH}: median "
          f"{eval_ms:.4f} ms, {TIMED_TRAIN_BATCHES[0] / eval_ms * 1e3:.1f} frames/s (10 "
          f"iterations), peak memory allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    _print_train_profile(tag, lambda: step(state, *data), timed[TIMED_TRAIN_BATCHES[0]]["ms"],
                         f"b{TIMED_TRAIN_BATCHES[0]} bf16 {HEIGHT}x{WIDTH} train step")


def _phase_mask(hh, hw, dtype, device):
    """``(4, 1, hh + 1, hw + 1)``: 1 where phase ``p = 2 pu + pv``'s slice of
    the window grid lies (rows ``pu .. pu + hh - 1``, columns ``pv .. pv +
    hw - 1``), else 0."""
    import torch

    mask = torch.zeros(4, 1, hh + 1, hw + 1, dtype=dtype, device=device)
    for p in range(4):
        pu, pv = divmod(p, 2)
        mask[p, :, pu:pu + hh, pv:pv + hw] = 1
    return mask


def _refine1_single(P, g1, b1, w4t, mask):
    """JAX's ``single`` form of the phase-space refine1, timed against the
    port's ``slices`` form (``phase_head.phase_head_refine1``): BN1 + ReLU
    over the whole window grid ``P``, zeroed outside each phase's slice by
    ``mask`` (:func:`_phase_mask`), one 4x4 conv, and the depth-to-space."""
    import torch
    import torch.nn.functional as F

    b, cm4, gh, gw = P.shape
    dt = P.dtype
    h = torch.relu(torch.addcmul(b1.to(dt)[:, None, None], P.view(b, 4, cm4 // 4, gh, gw),
                                 g1.to(dt)[:, None, None]))
    out = F.conv2d((h * mask).reshape(b, cm4, gh, gw), w4t.to(dt), padding=1)
    return F.pixel_shuffle(out, 2).contiguous(memory_format=torch.channels_last)


def _raw_batches(cfg, device):
    """Config 5's raw-record batch in both splat modes, from the same draws:
    ``host``, the host-splat ``(image, lidar, boxes)``, and ``raw``, ``(image,
    points, num_valid, boxes)``, as tensors on ``device``; with the points as
    the host splat takes them (``concat``, ``offsets``). Raises unless the
    native library is available, which is exactly when
    ``host_preprocess.splat_pooled_batch`` serves the host splat with it."""
    import numpy as np
    import torch

    from dmmfods_tpu_torch.data import native_io
    from dmmfods_tpu_torch.data.synthetic import make_raw_batch

    if not native_io.available():
        raise AssertionError(f"the native splat library did not build: "
                             f"{native_io.build_error}")
    t0 = time.perf_counter()
    kwargs = dict(max_points=cfg.tpu.max_points, max_boxes=RAW_BOXES)
    host = make_raw_batch(TRAIN_BATCH, HEIGHT, WIDTH, SEED, splat="host", **kwargs)
    raw = make_raw_batch(TRAIN_BATCH, HEIGHT, WIDTH, SEED, splat="device", **kwargs)
    make_s = time.perf_counter() - t0
    if not (np.array_equal(host[0], raw[0]) and np.array_equal(host[2], raw[3])):
        raise AssertionError("the two splat modes drew different frames")
    _, points, num_valid, boxes = raw
    print(f"raw-record batch (make_raw_batch, {make_s:.2f} s for both modes on the host): "
          f"b{TRAIN_BATCH} {HEIGHT}x{WIDTH} ({FULL_HEIGHT}x{FULL_WIDTH} full resolution), "
          f"{cfg.tpu.max_points} points a frame ({int(num_valid.sum())} valid in all), {RAW_BOXES} "
          f"boxes a frame ({int((boxes[..., 0] != 0).sum())} valid in all); the host splat "
          f"by the native library {native_io.library_path()}")
    concat = np.concatenate([p[:n] for p, n in zip(points, num_valid)])
    offsets = np.cumsum([0] + [int(n) for n in num_valid])
    return dict(host=tuple(torch.from_numpy(x).to(device) for x in host),
                raw=tuple(torch.from_numpy(x).to(device) for x in raw),
                concat=concat, offsets=offsets)


def _raw_record(state, cfg, device, path_counts):
    """Phase 13 on the train phase's model and optimizer: the rasterizer on
    the card equal to the CPU's, the device splat against the native host
    splat, ``RAW_STEPS`` steps of ``make_train_step_ht`` and of
    ``make_train_step_raw`` with finite losses and no kernel launched, each
    eval twin with K1 once and finite metrics, and ``make_eval_step_ht``
    equal to ``make_eval_step`` on the rasterized maps. Returns what the
    timing phase takes."""
    import torch

    from dmmfods_tpu_torch import trainer
    from dmmfods_tpu_torch.ops import preprocess as pp

    data = _raw_batches(cfg, device)
    image, lidar, boxes = data["host"]
    _, points, num_valid, _ = data["raw"]
    full = dict(full_height=FULL_HEIGHT, full_width=FULL_WIDTH)
    heat = trainer._make_heatmap_rasterizer(**full)(image, boxes)
    _check_equal("rasterize_heatmaps_direct on the card", "on the CPU",
                 f"b{TRAIN_BATCH} {RAW_BOXES} boxes", heat.cpu(),
                 pp.rasterize_heatmaps_direct(boxes.cpu(), HEIGHT, WIDTH, FULL_HEIGHT // HEIGHT))
    splat = pp.lidar_points_to_model_input_pooled(points, num_valid, FULL_HEIGHT, FULL_WIDTH)
    diff = (splat - lidar).abs().max().item()
    print(f"device splat (lidar_points_to_model_input_pooled) vs the native host splat "
          f"{tuple(lidar.shape)}: max abs diff {diff:.3e} <= bound {BOUND_SPLAT}")
    if not diff <= BOUND_SPLAT:
        raise AssertionError(f"the device splat disagrees with the host splat: {diff}")

    module, optimizer = state.module, state.optimizer
    steps = {"ht": (trainer.make_train_step_ht(module, optimizer, cfg, **full), data["host"]),
             "raw": (trainer.make_train_step_raw(module, optimizer, cfg, **full), data["raw"])}
    for name, (step, batch) in steps.items():
        _reset_counts()
        losses = []
        for _ in range(RAW_STEPS):
            state, metrics = step(state, *batch)
            losses.append(metrics["loss"])
        losses = torch.stack(losses).tolist()
        counts = _counts()
        path_counts.append(counts)
        print(f"make_train_step_{name}: {RAW_STEPS} steps at b{TRAIN_BATCH}, losses "
              + ", ".join(f"{x:.1f}" for x in losses) + f"; launches {counts}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"make_train_step_{name} losses not finite: {losses}")
        if any(counts.values()):
            raise AssertionError(f"a kernel launched in make_train_step_{name}: {counts}")
    evals = {"ht": (trainer.make_eval_step_ht(module, cfg, **full), data["host"]),
             "raw": (trainer.make_eval_step_raw(module, cfg, **full), data["raw"])}
    for name, (step, batch) in evals.items():
        _reset_counts()
        metrics = step(state, *batch)
        torch.cuda.synchronize(device)
        path_counts.append(_counts())
        print(f"make_eval_step_{name} b{TRAIN_BATCH}: loss {metrics['loss'].item():.2f}, AP "
              f"{[round(x, 5) for x in metrics['ap_per_class'].tolist()]}; ", end="")
        _per_batch(path_counts[-1], 1, dict(K1=1, K2=0, K3=0, K4=0, K5=0, K6=0,
                                            bn_relu=_bn_relu_sites(module.spec)))
        _check_eval_metrics(metrics)
    got = evals["ht"][0](state, image, lidar, boxes)
    want = trainer.make_eval_step(module, cfg)(state, image, lidar, heat)
    same = [key for key in want if torch.equal(got[key], want[key])]
    print(f"make_eval_step_ht vs make_eval_step on (image, lidar, rasterize(image, boxes)): "
          f"{len(same)} of {len(want)} metrics equal bit for bit")
    if len(same) != len(want) or set(got) != set(want):
        raise AssertionError(f"make_eval_step_ht differs from make_eval_step in "
                             f"{sorted(set(want) - set(same))}")
    return dict(data=data, heat=heat, steps=steps)


def _gate_decisions(module, run):
    """Run ``run()`` and count, over the dense blocks and heads it called,
    where JAX's gates pick the strip kernel (K2 / K5) and the head kernel
    (K3), and where the port's gates, with the kernels' limits, do:
    ``(jax, port)``, each ``dict(K2=, K3=)``."""
    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseBlock, Head

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, [a.to("meta") for a in args])))
        for m in module.modules() if isinstance(m, (DenseBlock, Head))]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    counts = []
    for limits in (False, True):
        strip = sum(m._strip_eligible(*a, kernel_limits=limits)
                    for m, a in calls if isinstance(m, DenseBlock))
        head = sum(m._kernel_eligible(*a, kernel_limits=limits)
                   for m, a in calls if isinstance(m, Head))
        counts.append(dict(K2=strip, K3=head))
    return tuple(counts)


def _serve_densenet161(cfgs, device, rng, path_counts):
    """Phase 14: DenseNet-161 (growth 48, head c_mid 96) through
    ``InferenceEngine`` on the paths that run the layer bodies' wide layout:
    at 1280x1920 b1 with mid fusion before block 3, one synchronous request
    on the default path (K1 once, K2 on blocks 1 and 2 of both streams) and
    one with ``dense_block_strip = "on"`` (K5 in K2's place); at 128x192
    with ``dense_block_impl = "pallas"``, one request at b1 and one at b32
    (K4 on JAX's blocks). Each request's heat maps are finite in [0, 1] and
    held against the same weights in f32 on the default path (the f32 model
    runs K3's f32 body, wide, at the full plane). On the default path JAX's
    gates (``kernel_limits=False``) are counted beside the port's: both take
    K2 four times and K3 once (c_mid 96, source 208: K3's wide layout); the
    phase fails if either moves. Returns the 1280x1920 engines of both
    paths."""
    import numpy as np

    from dmmfods_tpu_torch.models.dense_unet_lidar import densenet161_u_lidar
    from dmmfods_tpu_torch.serving import InferenceEngine

    engines = {}
    rgb = rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 3)).astype(np.float32)
    lidar = rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 1)).astype(np.float32)
    for path in ("default", "K5 path"):
        bundle = densenet161_u_lidar(config=cfgs[path], device=device, seed=SEED)
        if bundle.num_params != NUM_PARAMS_DENSENET161_CONFIG3:
            raise AssertionError(f"{bundle.num_params} params, want "
                                 f"{NUM_PARAMS_DENSENET161_CONFIG3}")
        print(f"model: densenet161_u_lidar, {bundle.num_params} params, {bundle.spec.fusion} "
              f"fusion before block {bundle.spec.concat_before_block_num}, "
              f"{bundle.spec.dtype}, {FULL_HEIGHT}x{FULL_WIDTH}, dense_block_strip "
              f"{bundle.spec.dense_block_strip!r}")
        engine = InferenceEngine(bundle, buckets=(1,), height=FULL_HEIGHT, width=FULL_WIDTH)
        served = []
        _reset_counts()
        t0 = time.perf_counter()
        gates = _gate_decisions(bundle.module, lambda: served.append(engine.run(rgb, lidar)))
        path_counts.append(_counts())
        _check_heat_maps([(rgb, lidar)], served, FULL_HEIGHT, FULL_WIDTH)
        print(f"densenet161 {FULL_HEIGHT}x{FULL_WIDTH} {path}: one synchronous request in "
              f"{time.perf_counter() - t0:.2f} s wall (the first call); ", end="")
        _per_batch(path_counts[-1], engine.device_batches,
                   {**DENSENET161_LAUNCHES[path],
                    "bn_relu": _bn_relu_sites(bundle.spec, FULL_KERNEL_BLOCKS)})
        if path == "default":
            jax_gates, port_gates = gates
            print(f"densenet161 gates: JAX's run {jax_gates} here, the port's {port_gates}: "
                  f"growth 48 (K 192) runs in the layer bodies' wide layout, the head (c_mid "
                  f"96, source 208) in K3's wide layout")
            if jax_gates != DENSENET161_JAX_KERNELS or port_gates != DENSENET161_PORT_KERNELS:
                raise AssertionError(
                    f"DenseNet-161's gate decisions moved: JAX {jax_gates} (want "
                    f"{DENSENET161_JAX_KERNELS}), port {port_gates} (want "
                    f"{DENSENET161_PORT_KERNELS}); update this phase and ROADMAP.md section 2")
        _served_vs_f32(bundle, rgb, lidar, served[0], device,
                       f"densenet161 {FULL_HEIGHT}x{FULL_WIDTH} {path}")
        engines[path] = engine
    bundle = densenet161_u_lidar(config=cfgs["K4 path"], device=device, seed=SEED)
    if bundle.num_params != NUM_PARAMS_DENSENET161:
        raise AssertionError(f"{bundle.num_params} params, want {NUM_PARAMS_DENSENET161}")
    print(f"model: densenet161_u_lidar, {bundle.num_params} params, {bundle.spec.fusion} "
          f"fusion before block {bundle.spec.concat_before_block_num}, {HEIGHT}x{WIDTH}, "
          f"dense_block_impl {bundle.spec.dense_block_impl!r}")
    engine = InferenceEngine(bundle, buckets=K4_BATCHES_161)
    for batch in K4_BATCHES_161:
        rgb = rng.uniform(0, 1, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
        lidar = rng.uniform(0, 1, (batch, HEIGHT, WIDTH, 1)).astype(np.float32)
        before = engine.device_batches
        _reset_counts()
        out = engine.run(rgb, lidar)
        path_counts.append(_counts())
        _check_heat_maps([(rgb, lidar)], [out], HEIGHT, WIDTH)
        print(f"densenet161 {HEIGHT}x{WIDTH} b{batch} K4 path: ", end="")
        _per_batch(path_counts[-1], engine.device_batches - before,
                   {**DENSENET161_LAUNCHES["K4 path"],
                    "bn_relu": _bn_relu_sites(bundle.spec, K4_KERNEL_BLOCKS_161)})
        _served_vs_f32(bundle, rgb, lidar, out, device,
                       f"densenet161 {HEIGHT}x{WIDTH} b{batch} K4 path")
    return engines


def _time_raw(tag, state, dense_step, raw, cfg):
    """The raw-record steps at b32 in turns with the dense step on the same
    frames (maps made beforehand), each step's device time by phase
    (``train_step/preprocess`` apart), the rasterizer and the device splat
    alone, and the host splat: native at the config's ``tpu.splat_threads``
    threads, and its numpy form once."""
    import torch

    from dmmfods_tpu_torch.data import host_preprocess, native_io
    from dmmfods_tpu_torch.ops import preprocess as pp

    (ht_step, host_batch), (raw_step, raw_batch) = raw["steps"]["ht"], raw["steps"]["raw"]
    image, lidar, boxes = host_batch
    _, points, num_valid, _ = raw_batch
    dense_ms, ht_ms, raw_ms = _in_turns(lambda: dense_step(state, image, lidar, raw["heat"]),
                                        lambda: ht_step(state, *host_batch),
                                        lambda: raw_step(state, *raw_batch), iters=10)
    print(f"{tag} train step b{TRAIN_BATCH} bf16 {HEIGHT}x{WIDTH} on the raw-record frames "
          f"({cfg.tpu.max_points} points, {RAW_BOXES} boxes a frame): dense (make_train_step, maps "
          f"made beforehand) median {dense_ms:.4f} ms ({TRAIN_BATCH / dense_ms * 1e3:.1f} "
          f"frames/s); ht (make_train_step_ht: host-splat LiDAR, heat maps rasterized in the "
          f"step) {ht_ms:.4f} ms ({TRAIN_BATCH / ht_ms * 1e3:.1f} frames/s); raw "
          f"(make_train_step_raw: splat and rasterization in the step) {raw_ms:.4f} ms "
          f"({TRAIN_BATCH / raw_ms * 1e3:.1f} frames/s) (20 iterations each, in turns)")
    for name, step, batch, ms in (("ht", ht_step, host_batch, ht_ms),
                                  ("raw", raw_step, raw_batch, raw_ms)):
        by_class, host = _print_train_profile(
            tag, lambda: step(state, *batch), ms,
            f"b{TRAIN_BATCH} bf16 {HEIGHT}x{WIDTH} make_train_step_{name} step")
        pre = sum(v for k, v in by_class.items() if k.startswith("preprocess:"))
        print(f"{tag} train_step/preprocess of make_train_step_{name}: {pre:.4f} ms of device "
              f"time a step, {host.get('preprocess', 0.0):.4f} ms of host (profiler)")

    def rasterize():
        return pp.rasterize_heatmaps_direct(boxes, HEIGHT, WIDTH, FULL_HEIGHT // HEIGHT)

    def splat():
        return pp.lidar_points_to_model_input_pooled(points, num_valid, FULL_HEIGHT, FULL_WIDTH)

    rasterize_ms, splat_ms = _in_turns(rasterize, splat, iters=10)
    rasterize_dev, splat_dev = _device_ms(rasterize, iters=20), _device_ms(splat, iters=20)
    print(f"{tag} rasterize_heatmaps_direct b{TRAIN_BATCH} {RAW_BOXES} boxes onto {HEIGHT}x"
          f"{WIDTH}: median {rasterize_ms:.4f} ms, device time alone {rasterize_dev:.4f} ms; "
          f"lidar_points_to_model_input_pooled b{TRAIN_BATCH} {cfg.tpu.max_points} points: median "
          f"{splat_ms:.4f} ms, device time alone {splat_dev:.4f} ms (20 iterations each, in "
          f"turns; device time 20 iterations)")
    concat, offsets = raw["data"]["concat"], raw["data"]["offsets"]
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        native_io.splat_pooled_batch(concat, offsets, FULL_HEIGHT, FULL_WIDTH,
                                     cfg.tpu.splat_threads)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    host_preprocess._splat_pooled_batch_numpy(concat, offsets, FULL_HEIGHT, FULL_WIDTH)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag} host splat b{TRAIN_BATCH} ({len(concat)} points): native (dmmfods_io.cpp, "
          f"{cfg.tpu.splat_threads} threads) median {_median(times):.4f} ms a batch (10 calls, host "
          f"wall time); numpy form {numpy_ms:.4f} ms (once)")


def main() -> int:
    import numpy as np
    import torch

    # 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.data import native_io
    from dmmfods_tpu_torch.models.dense_unet_lidar import (DenseBlock, Encoder, Head,
                                                           ModelSpec, densenet121_u_lidar,
                                                           densenet161_u_lidar)
    from dmmfods_tpu_torch.ops import (_build, dense_block, dense_block_strip, fused,
                                       phase_head, stem_pool)
    from dmmfods_tpu_torch.serving import InferenceEngine

    device = torch.device("cuda", 0)
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # f32 comparisons in full f32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")

    # 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    native = threading.Thread(target=native_io.load)      # g++, beside nvcc
    native.start()
    lib = _build.load()
    load_s = time.perf_counter() - t0
    native.join()
    if not native_io.available():
        raise AssertionError(f"the native splat library did not build: {native_io.build_error}")
    print(f"build: native splat library {native_io.library_path()} "
          f"({time.perf_counter() - t0:.2f} s with the kernels' build)")
    if _build.build_seconds is None:
        print(f"build: reused {_build.library_path()} ({load_s:.2f} s to load)")
    else:
        print(f"build: nvcc {_build.build_seconds:.2f} s for {len(_build.SOURCES)} "
              f"sources in parallel, load {load_s:.2f} s -> {_build.library_path()}")
    _ptxas_report(_build.build_log, lib)

    # 3. K1 against its plain version ----------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0}
    # bf16 on operands folded beforehand at every path shape and the extras;
    # bf16 folded per call at b8; f32 at b8, b256 and a ragged shape
    cases = [(shape, torch.bfloat16, True) for shape in (*K1_PATH.values(), *K1_EXTRA_BF16)]
    cases.append((K1_PATH["b8"], torch.bfloat16, False))
    cases += [(shape, torch.float32, True)
              for shape in (K1_PATH["b8"], K1_PATH["b256"], (1, 25, 40, 48, 16, 40))]
    for (batch, h, w, ca, cb, cout), dt, beforehand in cases:
        a, b, params = _k1_inputs(gen, batch, h, w, ca, cb, cout, dt, device)
        operands = _k1_operands(params, dt) if beforehand else None
        out = fused.concat_bn_relu_conv1x1(a, b, **params, operands=operands)
        torch.cuda.synchronize()
        err, scale = _k1_error(out, a, b, params)
        bound = (BOUND_BF16 if dt == torch.bfloat16 else BOUND_F32) * scale
        slice_n = lib.dmm_concat_bn_relu_conv1x1_tile_n(ca, cb, cout)
        body = (f"tensor cores, N slices of {slice_n}" if dt == torch.bfloat16 and slice_n
                else "CUDA cores")
        print(f"K1 check B={batch} {h}x{w} {ca}+{cb}->{cout} {str(dt)[6:]} ({body}; operands "
              f"{'folded beforehand' if beforehand else 'folded per call'}): max abs err "
              f"{err:.3e} <= bound {bound:.3e} (err / max|plain| {err / scale:.2e})")
        if not err <= bound:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {bound}")
        worst["K1"] = max(worst["K1"], err)

    # 4. K2, K3, K4 and K6 against their plain versions --------------------
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k2_cases = [(name, h, w, c0, layers, 32, 128, torch.bfloat16)
                for name, (h, w, c0, layers) in K2_BLOCKS.items()]
    k2_cases += [(f"densenet161 {name}", h, w, c0, layers, 48, 192, dt)
                 for dt in (torch.bfloat16, torch.float32)
                 for name, (h, w, c0, layers) in K2_BLOCKS_161.items()]
    k2_cases += [(*case, torch.bfloat16) for case in K2_RAGGED_BF16]
    k2_cases.append(("ragged", 37, 53, 24, 3, 8, 32, torch.float32))
    k2_cases += [(*case, dt) for dt in (torch.bfloat16, torch.float32) for case in WIDE_RAGGED]
    for name, h, w, c0, layers, growth, k, dt in k2_cases:
        x, folded = _k2_inputs(gen, h, w, c0, layers, growth, k, dt, device)
        out = dense_block_strip.dense_block_strip(x, folded)
        torch.cuda.synchronize()
        ref = dense_block_strip.dense_block_strip_reference(x.float(), folded)
        layout = dense_block_strip.layout(growth, k)
        plan = f", layout K {layout[0]} G {layout[1]}"
        if dt == torch.bfloat16:
            tiles, waves = dense_block_strip.layer_plan(h, w, sms, growth, k)
            slots = sms * dense_block_strip.BLOCKS_PER_SM[layout][dt]
            plan += f", {tiles} tiles a layer, {waves:.2f} waves of {slots} slots"
        worst["K2"] = max(worst["K2"], _check(
            "K2", f"{name} {h}x{w} c0={c0} L={layers} G={growth} K={k}{plan}", out, ref))
        if name in K2_BLOCKS or name.startswith("densenet161"):   # K5 on the same inputs
            out5 = dense_block_strip.dense_block_strip_recompute(x, folded)
            torch.cuda.synchronize()
            worst["K5"] = max(worst["K5"], _check(
                "K5", f"{name} {h}x{w} c0={c0} L={layers} G={growth} K={k}", out5, ref))
            if dt == torch.bfloat16:
                _check_equal("K5", "K2", name, out5, out)
    for (name, h, w, c0, layers, growth, k), dt in (
            (case, dt) for case in K5_EXTRA + WIDE_RAGGED
            for dt in (torch.float32, torch.bfloat16)):
        x, folded = _k2_inputs(gen, h, w, c0, layers, growth, k, dt, device)
        out = dense_block_strip.dense_block_strip_recompute(x, folded)
        torch.cuda.synchronize()
        ref = dense_block_strip.dense_block_strip_reference(x.float(), folded)
        layout = dense_block_strip.layout(growth, k)
        rows, strips, blocks = dense_block_strip.plan_strips(
            h, w, layers, sms, dense_block_strip.BLOCKS_PER_SM[layout][dt])
        worst["K5"] = max(worst["K5"], _check(
            "K5", f"{name} {h}x{w} c0={c0} L={layers} G={growth} K={k}, {strips} "
            f"strips of {rows} rows, {blocks} blocks", out, ref))
        if dt == torch.bfloat16:
            out2 = dense_block_strip.dense_block_strip(x, folded)
            torch.cuda.synchronize()
            _check_equal("K5", "K2", name, out, out2)
    # growth 64 (K 256) is past the widest layout: each wrapper raises on
    # the card, and each C entry refuses it without launching
    x, folded = _k2_inputs(gen, 16, 16, 16, 2, 64, 256, torch.bfloat16, device)
    for run in (dense_block_strip.dense_block_strip,
                dense_block_strip.dense_block_strip_recompute, dense_block.dense_block):
        try:
            run(x, folded)
        except ValueError:
            continue
        raise AssertionError(f"{run.__name__} took growth 64")
    rcs = (lib.dmm_dense_block_strip(*[None] * 8, 1, 16, 16, 16, 2, 64, 256, 1, None),
           lib.dmm_dense_block(*[None] * 8, 1, 16, 16, 16, 2, 64, 256, 1, None),
           lib.dmm_dense_block_recompute(*[None] * 8, 1, 16, 16, 16, 2, 64, 256, 1, None,
                                         None, None, 8, 2))
    if any(rc == 0 for rc in rcs):
        raise AssertionError(f"a C entry took growth 64: {rcs}")
    print(f"growth 64 (K 256): the three wrappers raise, the C entries return {rcs}")
    k3_cases = [("1280x1920", K3_FULL, torch.bfloat16)]
    k3_cases += [("ragged", shape, torch.bfloat16) for shape in K3_RAGGED_BF16]
    k3_cases.append(("ragged", (13, 21, 40, 3, 20, 3), torch.float32))
    k3_cases += [("densenet161 1280x1920", K3_FULL_161, dt)
                 for dt in (torch.bfloat16, torch.float32)]
    k3_cases += [("wide ragged", shape, dt) for shape in K3_RAGGED_WIDE
                 for dt in (torch.bfloat16, torch.float32)]
    for name, shape, dt in k3_cases:
        x_lo, raw, consts = _k3_inputs(gen, *shape, dt, device)
        out = phase_head.phase_head(x_lo, raw, **consts)
        torch.cuda.synchronize()
        ref = phase_head.phase_head_reference(x_lo.float(), raw.float(), **consts)
        c_src = shape[2] + 4 * shape[3]
        plan = (f"layout {phase_head.bf16_layout(c_src, shape[4])}" if dt == torch.bfloat16
                else "f32 body")
        worst["K3"] = max(worst["K3"], _check(
            "K3", f"{name} x_lo {tuple(x_lo.shape)} raw {tuple(raw.shape)} "
            f"c_mid={shape[4]} classes={shape[5]}, source {c_src}, {plan}", out, ref))
    # past K3's limits the wrapper raises on the card and the C entry refuses
    x_lo, raw, consts = _k3_inputs(gen, 4, 6, 40, 3, 128, 3, torch.bfloat16, device)
    try:
        phase_head.phase_head(x_lo, raw, **consts)
    except ValueError:
        pass
    else:
        raise AssertionError("phase_head took c_mid 128")
    rc = lib.dmm_phase_head(*[None] * 9, 1, 4, 6, 40, 3, 128, 3, 1, None)
    if rc == 0 or lib.dmm_phase_head_mma_smem(272, 96) != 0:
        raise AssertionError(f"K3's C entry took c_mid 128 ({rc}) or a source of 272")
    print(f"K3 past its limits: c_mid 128 raises in the wrapper, the C entry returns {rc}; "
          f"no bf16 layout takes a source of 272")
    k4_cases = [(f"{name} b{batch}", batch, *K4_BLOCKS[name], 32, 128, torch.bfloat16)
                for name, batches in K4_PATH_BATCHES.items() for batch in batches + (256,)]
    k4_cases += [(f"densenet161 {name} b{batch}", batch, *shape, 48, 192, torch.bfloat16)
                 for name, shape in K4_BLOCKS_161.items()
                 for batch in K4_BATCHES_161 + (256,)]
    for name, batch, h, w, c0, layers, growth, k, _ in k4_cases:
        _check_block_plan(lib, batch, h, w, sms, name, growth, k)
    _check_block_plan(lib, 6, 37, 53, sms, "ragged")
    _check_block_plan(lib, 3, 37, 53, sms, "wide ragged", 40, 160)
    _check_block_plan(lib, 40, 4, 6, sms, "wide small planes", 48, 192)
    k4_cases.append(("ragged", 6, 37, 53, 24, 3, 8, 32, torch.bfloat16))
    k4_cases.append(("ragged", 6, 37, 53, 24, 3, 8, 32, torch.float32))
    k4_cases.append(("small planes", 40, 4, 6, 48, 4, 16, 64, torch.float32))
    k4_cases += [(f"densenet161 {name} b8", 8, *shape, 48, 192, torch.float32)
                 for name, shape in K4_BLOCKS_161.items()]
    k4_cases += [(name, 3, *shape, dt) for name, *shape in WIDE_RAGGED
                 for dt in (torch.bfloat16, torch.float32)]
    k4_cases += [("wide small planes", 40, 4, 6, 48, 4, 48, 192, dt)
                 for dt in (torch.bfloat16, torch.float32)]
    for name, batch, h, w, c0, layers, growth, k, dt in k4_cases:
        x, folded = _k2_inputs(gen, h, w, c0, layers, growth, k, dt, device, batch=batch)
        out = dense_block.dense_block(x, folded)
        torch.cuda.synchronize()
        ref = dense_block.dense_block_reference(x.float(), folded)
        worst["K4"] = max(worst["K4"], _check(
            "K4", f"{name} ({batch}, {h}, {w}, {c0}) L={layers} G={growth} K={k}",
            out, ref))
    k6_cases = [((1, h, w, c, 64), torch.bfloat16)
                for h, w in ((FULL_HEIGHT, FULL_WIDTH), (HEIGHT, WIDTH)) for c in (3, 1)]
    k6_cases += [((2, 37, 58, 4, 40), torch.bfloat16), ((1, 30, 46, 8, 64), torch.bfloat16),
                 ((2, 37, 58, 4, 40), torch.float32)]
    for shape, dt in k6_cases:
        x, w7, gamma, beta = _k6_inputs(gen, *shape, dt, device)
        packed = stem_pool.pack_stem_weights(w7) if dt == torch.bfloat16 else None
        out = stem_pool.stem_pool(x, w7, gamma, beta, packed)
        torch.cuda.synchronize()
        ref = stem_pool.stem_pool_reference(x.float(), w7, gamma, beta)
        worst["K6"] = max(worst["K6"], _check(
            "K6", f"x {tuple(x.shape)} F={shape[-1]}", out, ref))
    del x, folded, x_lo, raw, consts, w7, packed, out, out2, out5, ref
    torch.cuda.empty_cache()
    bn_relu_entry = _bn_relu_phase(device)

    with tempfile.TemporaryDirectory() as host:
        cfg, cfg3, cfg_opt, cfg3_opt, cfg3_k5, cfg_train, cfg_nf = (
            get_config(host) for _ in range(7))
        cfg161 = {path: get_config(host) for path in (*DENSENET161_LAUNCHES, "plain blocks")}
    for c in (cfg3, cfg3_opt, cfg3_k5, cfg161["default"], cfg161["K5 path"],
              cfg161["plain blocks"]):
        c.model.concat_before_block_num = 3
    cfg3_k5.gpu.dense_block_strip = "on"
    cfg161["K5 path"].gpu.dense_block_strip = "on"
    cfg161["K4 path"].gpu.dense_block_impl = "pallas"
    cfg161["plain blocks"].gpu.dense_block_strip = "off"    # timed beside the kernels
    for c in (cfg_opt, cfg3_opt):
        c.gpu.dense_block_impl = "pallas"
        c.gpu.stem_pool_strip = "on"
    cfg_nf.gpu.use_fused_kernels = False    # the plain concat and head
    rng = np.random.default_rng(SEED)
    path_counts = []        # the counts of every main-path run below

    # 5. serve at 128x192 --------------------------------------------------------
    bundle = densenet121_u_lidar(config=cfg, device=device, seed=SEED)
    spec = bundle.spec
    if bundle.num_params != NUM_PARAMS_DENSENET121:
        raise AssertionError(f"{bundle.num_params} params, want {NUM_PARAMS_DENSENET121}")
    if spec.fusion != "mid" or spec.dtype != torch.bfloat16:
        raise AssertionError(f"want mid fusion in bf16, got {spec.fusion} {spec.dtype}")
    print(f"model: densenet121_u_lidar, {bundle.num_params} params, "
          f"{spec.fusion} fusion, {spec.dtype}, {HEIGHT}x{WIDTH}, default config")
    buckets = (1, 8, 32)
    engine = InferenceEngine(bundle, buckets=buckets)

    captured = []
    hook = bundle.module.concat_module.register_forward_hook(
        lambda mod, inputs, output: captured.append((inputs[0], inputs[1], output)))
    requests = [(rng.uniform(0, 1, (n, HEIGHT, WIDTH, 3)).astype(np.float32),
                 rng.uniform(0, 1, (n, HEIGHT, WIDTH, 1)).astype(np.float32))
                for n in (1, 3, 8, 20, 5)]

    _reset_counts()
    warm_batches = len(buckets)                 # warm-up runs each bucket once
    results, serve_s = _serve(engine, requests[:-1], requests[-1])
    path_counts.append(_counts())
    batches = engine.device_batches
    hook.remove()

    _check_heat_maps(requests, results, HEIGHT, WIDTH)
    print(f"served {len(requests)} requests ({sum(r[0].shape[0] for r in requests)} "
          f"frames) in {batches} device batches ({warm_batches} warm-up), "
          f"{serve_s:.2f} s wall with warm-up")
    _per_batch(path_counts[-1], batches, dict(K1=1, K2=0, K3=0, K4=0, K5=0, K6=0,
                                              bn_relu=_bn_relu_sites(spec)))

    a, b, out = captured[warm_batches]   # the first batch the worker served
    with torch.inference_mode():
        norm, conv = bundle.module.concat_module.norm, bundle.module.concat_module.conv
        served_params = dict(scale=norm.weight, bias=norm.bias, mean=norm.running_mean,
                             var=norm.running_var,
                             weight=conv.weight.to(a.dtype).float())
        err, scale = _k1_error(out.permute(0, 2, 3, 1), a.permute(0, 2, 3, 1),
                               b.permute(0, 2, 3, 1), served_params)
    print(f"K1 inside a served batch (B={a.shape[0]}, {str(a.dtype)[6:]}): "
          f"max abs err {err:.3e} <= bound {BOUND_BF16 * scale:.3e}")
    if not err <= BOUND_BF16 * scale:
        raise AssertionError("K1 output inside the served batch disagrees")
    worst["K1"] = max(worst["K1"], err)
    _served_vs_f32(bundle, *requests[-1], results[-1], device, f"{HEIGHT}x{WIDTH}")
    del captured

    # the same weights with gpu.use_fused_kernels = False: the plain concat and
    # head (upsample, concat, convs), neither K1 nor K3
    bundle_nf = densenet121_u_lidar(config=cfg_nf, device=device, seed=SEED)
    engine_nf = InferenceEngine(bundle_nf, buckets=buckets)
    _reset_counts()
    served_nf = engine_nf.run(*requests[-1])
    path_counts.append(_counts())
    _check_heat_maps(requests[-1:], [served_nf], HEIGHT, WIDTH)
    print(f"use_fused_kernels False, {HEIGHT}x{WIDTH}, {requests[-1][0].shape[0]} frames: ",
          end="")
    _per_batch(path_counts[-1], engine_nf.device_batches,
               {**NO_FUSED_LAUNCHES, "bn_relu": _bn_relu_sites(bundle_nf.spec)})
    diff = np.abs(served_nf - results[-1])
    print(f"served bf16 without the fused kernels vs the default path (K1, the phase-space "
          f"head): max abs diff {diff.max():.3e} (mean {diff.mean():.3e}) <= bound "
          f"{BOUND_SERVED_VS_F32}")
    if not diff.max() <= BOUND_SERVED_VS_F32:
        raise AssertionError("use_fused_kernels False disagrees with the default path")

    # 6. serve at 1280x1920, batch 1 (config 3) -----------------------------
    bundle3 = densenet121_u_lidar(config=cfg3, device=device, seed=SEED)
    if bundle3.num_params != NUM_PARAMS_CONFIG3:
        raise AssertionError(f"{bundle3.num_params} params, want {NUM_PARAMS_CONFIG3}")
    print(f"model: densenet121_u_lidar, {bundle3.num_params} params, "
          f"{bundle3.spec.fusion} fusion before block "
          f"{bundle3.spec.concat_before_block_num}, {bundle3.spec.dtype}, "
          f"{FULL_HEIGHT}x{FULL_WIDTH}, default config")
    engine3 = InferenceEngine(bundle3, buckets=(1,), height=FULL_HEIGHT, width=FULL_WIDTH)
    requests3 = [(rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 3)).astype(np.float32),
                  rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 1)).astype(np.float32))
                 for _ in range(3)]
    _reset_counts()
    results3, serve3_s = _serve(engine3, requests3[:-1], requests3[-1])
    path_counts.append(_counts())
    batches3 = engine3.device_batches
    _check_heat_maps(requests3, results3, FULL_HEIGHT, FULL_WIDTH)
    print(f"served {len(requests3)} requests of 1 frame at {FULL_HEIGHT}x{FULL_WIDTH} in "
          f"{batches3} device batches (1 warm-up), {serve3_s:.2f} s wall with warm-up")
    _per_batch(path_counts[-1], batches3, dict(
        K1=1, K2=4, K3=1, K4=0, K5=0, K6=0,
        bn_relu=_bn_relu_sites(bundle3.spec, FULL_KERNEL_BLOCKS)))
    _served_vs_f32(bundle3, *requests3[-1], results3[-1], device,
                   f"{FULL_HEIGHT}x{FULL_WIDTH}")
    torch.cuda.empty_cache()

    # 7. serve at 128x192 with the opt-ins (K4, K6) ------------------------------
    bundle_opt = densenet121_u_lidar(config=cfg_opt, device=device, seed=SEED)
    print(f"model: densenet121_u_lidar, {HEIGHT}x{WIDTH}, dense_block_impl "
          f"{bundle_opt.spec.dense_block_impl!r}, stem_pool_strip "
          f"{bundle_opt.spec.stem_pool_strip!r}")
    engine_opt = InferenceEngine(bundle_opt, buckets=buckets)
    t0 = time.perf_counter()
    engine_opt.warmup()
    total, (rgb8, lidar8, served8) = _serve_buckets(
        engine_opt, bundle_opt.spec, rng, HEIGHT, WIDTH, f"opt-in {HEIGHT}x{WIDTH}")
    path_counts.append(total)
    before = engine_opt.device_batches
    _reset_counts()
    engine_opt.start()
    futures = [engine_opt.submit(rgb, lidar) for rgb, lidar in requests[:3]]
    results_opt = [f.result(timeout=600) for f in futures]
    engine_opt.stop()
    counts = _counts()
    path_counts.append(counts)
    served = engine_opt.device_batches - before
    _check_heat_maps(requests[:3], results_opt, HEIGHT, WIDTH)
    # the worker coalesces, so the buckets of its batches are read from the
    # launches: K6 2 at b1 only, K4 3, 4 and 5 at b1, b8 and b32
    mix = {1: counts["K6"] // 2}
    mix[32] = counts["K4"] - 3 * mix[1] - 4 * (served - mix[1])
    mix[8] = served - mix[1] - mix[32]
    sites = sum(n * _bn_relu_sites(bundle_opt.spec, OPT_IN_KERNEL_BLOCKS[bucket],
                                   k6=bucket == 1) for bucket, n in mix.items())
    if not (counts["K1"] == served and counts["K2"] == counts["K3"] == counts["K5"] == 0
            and 3 * served <= counts["K4"] <= 5 * served
            and counts["K6"] % 2 == 0 and counts["K6"] <= 2 * served
            and min(mix.values()) >= 0 and counts["bn_relu"] == sites):
        raise AssertionError(f"worker at {HEIGHT}x{WIDTH} with the opt-ins: launches "
                             f"{counts} for {served} device batches")
    print(f"worker with the opt-ins: {served} device batches (by bucket {mix}), launches "
          f"{counts} (the eval BN-ReLU pass's: {sites} sites), "
          f"{time.perf_counter() - t0:.2f} s wall with warm-up")
    _served_vs_f32(bundle_opt, rgb8, lidar8, served8, device,
                   f"{HEIGHT}x{WIDTH} opt-ins (K4, K6)")

    # 8. serve at 1280x1920, batch 1 (config 3), with the opt-ins ---------------
    bundle3_opt = densenet121_u_lidar(config=cfg3_opt, device=device, seed=SEED)
    engine3_opt = InferenceEngine(bundle3_opt, buckets=(1,), height=FULL_HEIGHT,
                                  width=FULL_WIDTH)
    _reset_counts()
    results3_opt, serve3_opt_s = _serve(engine3_opt, requests3[:-1], requests3[-1])
    path_counts.append(_counts())
    batches3_opt = engine3_opt.device_batches
    _check_heat_maps(requests3, results3_opt, FULL_HEIGHT, FULL_WIDTH)
    print(f"opt-in {FULL_HEIGHT}x{FULL_WIDTH}: served {len(requests3)} requests in "
          f"{batches3_opt} device batches, {serve3_opt_s:.2f} s wall with warm-up")
    _per_batch(path_counts[-1], batches3_opt, dict(
        K1=1, K2=4, K3=1, K4=0, K5=0, K6=2,
        bn_relu=_bn_relu_sites(bundle3_opt.spec, FULL_KERNEL_BLOCKS, k6=True)))
    _served_vs_f32(bundle3_opt, *requests3[-1], results3_opt[-1], device,
                   f"{FULL_HEIGHT}x{FULL_WIDTH} opt-ins (K6)")
    torch.cuda.empty_cache()

    # 9. serve at 1280x1920, batch 1 (config 3), on the K5 path -----------------
    bundle3_k5 = densenet121_u_lidar(config=cfg3_k5, device=device, seed=SEED)
    print(f"model: densenet121_u_lidar, {FULL_HEIGHT}x{FULL_WIDTH}, config 3, "
          f"dense_block_strip {bundle3_k5.spec.dense_block_strip!r}")
    engine3_k5 = InferenceEngine(bundle3_k5, buckets=(1,), height=FULL_HEIGHT,
                                 width=FULL_WIDTH)
    _reset_counts()
    results3_k5, serve3_k5_s = _serve(engine3_k5, requests3[:-1], requests3[-1])
    path_counts.append(_counts())
    batches3_k5 = engine3_k5.device_batches
    _check_heat_maps(requests3, results3_k5, FULL_HEIGHT, FULL_WIDTH)
    print(f"K5 path {FULL_HEIGHT}x{FULL_WIDTH}: served {len(requests3)} requests in "
          f"{batches3_k5} device batches, {serve3_k5_s:.2f} s wall with warm-up")
    _per_batch(path_counts[-1], batches3_k5, dict(
        K1=1, K2=0, K3=1, K4=0, K5=4, K6=0,
        bn_relu=_bn_relu_sites(bundle3_k5.spec, FULL_KERNEL_BLOCKS)))
    _served_vs_f32(bundle3_k5, *requests3[-1], results3_k5[-1], device,
                   f"{FULL_HEIGHT}x{FULL_WIDTH} K5 path")
    torch.cuda.empty_cache()

    # 10-12. train, eval after training, the step-0 loss against f32 ----------
    bundle_train = densenet121_u_lidar(config=cfg_train, device=device, seed=SEED)
    train_state, train_step, eval_step = _train(bundle_train, cfg_train, device, gen,
                                                path_counts)
    torch.cuda.empty_cache()

    # 13. raw records: preprocessing in the step -------------------------------
    raw_record = _raw_record(train_state, cfg_train, device, path_counts)
    torch.cuda.empty_cache()

    # 14. DenseNet-161: K2 and K5 at 1280x1920, K4 at 128x192 ----------------
    engines161 = _serve_densenet161(cfg161, device, rng, path_counts)
    torch.cuda.empty_cache()

    # 15. time -----------------------------------------------------------------
    tag = f"[{card}]"
    for batch in (1, 8, 32, 256):
        rgb = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen).to(device, spec.dtype)
        lidar = torch.rand(batch, HEIGHT, WIDTH, 1, generator=gen).to(device, spec.dtype)
        default_ms, opt_ms, nf_ms = _in_turns(lambda: engine.forward(rgb, lidar),
                                              lambda: engine_opt.forward(rgb, lidar),
                                              lambda: engine_nf.forward(rgb, lidar), iters=10)
        print(f"{tag} engine forward b{batch} bf16 {HEIGHT}x{WIDTH}: default median "
              f"{default_ms:.4f} ms ({batch / default_ms * 1e3:.1f} frames/s); opt-ins "
              f"(K4, K6) {opt_ms:.4f} ms ({batch / opt_ms * 1e3:.1f} frames/s); "
              f"use_fused_kernels False (no K1, the plain head) {nf_ms:.4f} ms "
              f"({batch / nf_ms * 1e3:.1f} frames/s) (20 iterations each, in turns)")
    for label, eng, ms in (("default", engine, default_ms), ("opt-in", engine_opt, opt_ms),
                           ("use_fused_kernels False", engine_nf, nf_ms)):
        _print_profile(tag, lambda: eng.forward(rgb, lidar), ms,
                       f"{label} b256 bf16 {HEIGHT}x{WIDTH} forward")
    del rgb, lidar
    torch.cuda.empty_cache()
    rgb = torch.rand(1, FULL_HEIGHT, FULL_WIDTH, 3, generator=gen).to(device, torch.bfloat16)
    lidar = torch.rand(1, FULL_HEIGHT, FULL_WIDTH, 1, generator=gen).to(device, torch.bfloat16)
    full_ms = {}
    for label, eng in (("default", engine3), ("opt-in", engine3_opt)):
        ms, _ = _median_ms(lambda: eng.forward(rgb, lidar), iters=15)
        full_ms[label] = ms
        print(f"{tag} engine forward {label} b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} (mid "
              f"fusion before block 3): median {ms:.4f} ms, {1e3 / ms:.2f} frames/s "
              f"(15 iterations)")
    k5_path_ms, default_path_ms = _in_turns(lambda: engine3_k5.forward(rgb, lidar),
                                            lambda: engine3.forward(rgb, lidar), iters=8)
    print(f"{tag} engine forward K5 path b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} (config 3, "
          f"dense_block_strip 'on'): median {k5_path_ms:.4f} ms; default path (K2) "
          f"{default_path_ms:.4f} ms (16 iterations each, in turns)")
    _print_profile(tag, lambda: engine3.forward(rgb, lidar), default_path_ms,
                   f"default b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} forward")
    _print_profile(tag, lambda: engine3_k5.forward(rgb, lidar), k5_path_ms,
                   f"K5 path b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} forward")
    _print_profile(tag, lambda: engine3_opt.forward(rgb, lidar), full_ms["opt-in"],
                   f"opt-in (K6) b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} forward")
    # DenseNet-161's forward on the K2 path, the K5 path and with the plain
    # blocks the kernels replace (dense_block_strip = "off": K1 only), in turns
    engines161["plain blocks"] = InferenceEngine(
        densenet161_u_lidar(config=cfg161["plain blocks"], device=device, seed=SEED),
        buckets=(1,), height=FULL_HEIGHT, width=FULL_WIDTH)
    fwd161 = dict(zip(engines161, _in_turns(
        *(lambda eng=eng: eng.forward(rgb, lidar) for eng in engines161.values()), iters=8)))
    print(f"{tag} engine forward densenet161 b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} (mid fusion "
          f"before block 3; K3 on the head): " + "; ".join(
              f"{label} median {ms:.4f} ms, {1e3 / ms:.2f} frames/s" for label, ms in
              fwd161.items()) + " (16 iterations each, in turns)")
    for label, eng in engines161.items():
        _print_profile(tag, lambda: eng.forward(rgb, lidar), fwd161[label],
                       f"densenet161 {label} b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} forward")
    del rgb, lidar, engines161
    torch.cuda.empty_cache()

    k1 = {}
    for key, (batch, h, w, ca, cb, cout) in K1_PATH.items():
        a, b, params = _k1_inputs(gen, batch, h, w, ca, cb, cout, torch.bfloat16, device)
        operands = _k1_operands(params, torch.bfloat16)
        rows = batch * h * w

        def kernel():
            return fused.concat_bn_relu_conv1x1(a, b, **params, operands=operands)

        fns = [kernel, lambda: fused.concat_bn_relu_conv1x1_reference(a, b, **params),
               lambda: _k1_operands(params, torch.bfloat16)]
        if key == "b256":
            # the bare cuBLAS product of the normalized concat: a yardstick of
            # the GEMM alone, not K1's function
            xn = torch.cat([torch.relu(a.float() * operands[0][:ca] + operands[1][:ca]),
                            torch.relu(b.float() * operands[0][ca:] + operands[1][ca:])],
                           dim=-1).to(a.dtype).reshape(rows, ca + cb)
            wt = operands[2][:, :cout].contiguous()
            fns.append(lambda: torch.matmul(xn, wt))
        times = _in_turns(*fns, iters=10)
        device_ms = _device_ms(kernel, iters=20)
        bound = _k1_bound(a, b, operands, cout)
        k1[key] = dict(ms=times[0], plain_ms=times[1], fold_ms=times[2], device_ms=device_ms,
                       bound=bound)
        yardstick = ""
        if key == "b256":
            k1[key]["gemm_ms"] = times[3]
            k1[key]["gemm_device_ms"] = _device_ms(lambda: torch.matmul(xn, wt), iters=20)
            yardstick = (f"; the bare cuBLAS product of the normalized concat ({rows}, "
                         f"{ca + cb}) @ ({ca + cb}, {cout}), a yardstick, {times[3]:.4f} ms "
                         f"(device time alone {k1[key]['gemm_device_ms']:.4f})")
            del xn, wt
        print(f"{tag} K1 {key} ({rows} rows, {ca}+{cb}->{cout}, bf16), operands folded "
              f"beforehand: median {times[0]:.4f} ms, device time alone {device_ms:.4f} ms; "
              f"plain version {times[1]:.4f} ms; the fold (fuse_operands, once per fold) "
              f"{times[2]:.4f} ms{yardstick} (20 iterations each, in turns; device time "
              f"20 iterations); bound {bound[0]:.4f} ms ({bound[1]})")
    del a, b, params, operands
    k2_ms, k5_ms, block_bound = {}, {}, {}
    for name, (h, w, c0, layers) in K2_BLOCKS.items():
        x, folded = _k2_inputs(gen, h, w, c0, layers, 32, 128, torch.bfloat16, device)
        packed = dense_block_strip.pack_layer_weights(folded)
        block_bound[name] = _block_bound(x, folded)
        k2_ms[name] = _in_turns(
            lambda: dense_block_strip.dense_block_strip(x, folded, packed),
            lambda: dense_block_strip.dense_block_strip_reference(x, folded),
            lambda: dense_block_strip.pack_layer_weights(folded), iters=10)
        print(f"{tag} K2 {name} (1, {h}, {w}, {c0}) L={layers} bf16, weights packed "
              f"beforehand: median {k2_ms[name][0]:.4f} ms; plain version ({PLAIN_BLOCK}) "
              f"{k2_ms[name][1]:.4f} ms; the packing (pack_layer_weights, once per fold) "
              f"{k2_ms[name][2]:.4f} ms (20 iterations each, in turns); bound "
              f"{block_bound[name][0]:.4f} ms ({block_bound[name][1]})")
        k5_ms[name] = _in_turns(
            lambda: dense_block_strip.dense_block_strip_recompute(x, folded, packed),
            lambda: dense_block_strip.dense_block_strip_reference(x, folded),
            lambda: dense_block_strip.dense_block_strip(x, folded, packed), iters=10)
        rows5, strips5, blocks5 = dense_block_strip.plan_strips(
            h, w, layers, sms, dense_block_strip.BLOCKS_PER_SM[(128, 32)][torch.bfloat16])
        print(f"{tag} K5 {name} (1, {h}, {w}, {c0}) L={layers} bf16, weights packed "
              f"beforehand, {strips5} strips of "
              f"{rows5} rows, {blocks5} blocks, work "
              f"{_k5_recompute(h, layers, rows5):.4f}x the block's rows: median "
              f"{k5_ms[name][0]:.4f} ms; plain "
              f"version {k5_ms[name][1]:.4f} ms; K2 {k5_ms[name][2]:.4f} ms (20 "
              f"iterations each, in turns); bound {block_bound[name][0]:.4f} ms")
    # K2 and K5 at DenseNet-161's blocks (the wide layout), against the plain
    # version and the model's own loop on the same block, which they replace
    k161 = {}
    for name, (h, w, c0, layers) in K2_BLOCKS_161.items():
        x, folded = _k2_inputs(gen, h, w, c0, layers, 48, 192, torch.bfloat16, device)
        packed = dense_block_strip.pack_layer_weights(folded)
        block = DenseBlock(layers, c0, 4, 48, 0.0, strip="off").to(device).eval()
        x_nchw = x.permute(0, 3, 1, 2)          # channels_last, as the model holds it
        with torch.inference_mode():
            times = _in_turns(
                lambda: dense_block_strip.dense_block_strip(x, folded, packed),
                lambda: dense_block_strip.dense_block_strip_recompute(x, folded, packed),
                lambda: dense_block_strip.dense_block_strip_reference(x, folded),
                lambda: block(x_nchw), lambda: dense_block_strip.pack_layer_weights(folded),
                iters=5)
        k161[name] = dict(zip(("k2", "k5", "plain", "loop", "pack"), times),
                          bound=_block_bound(x, folded))
        rows5, strips5, blocks5 = dense_block_strip.plan_strips(
            h, w, layers, sms, dense_block_strip.BLOCKS_PER_SM[(192, 48)][torch.bfloat16])
        t = k161[name]
        print(f"{tag} K2 / K5 densenet161 {name} (1, {h}, {w}, {c0}) L={layers} G=48 K=192 "
              f"bf16, weights packed beforehand: K2 median {t['k2']:.4f} ms, K5 "
              f"{t['k5']:.4f} ms ({strips5} strips of {rows5} rows, {blocks5} blocks); plain "
              f"version ({PLAIN_BLOCK}) {t['plain']:.4f} ms; the model's plain loop (cuDNN "
              f"bf16 convs, BN in bf16) {t['loop']:.4f} ms; the packing {t['pack']:.4f} ms "
              f"(10 iterations each, in turns); bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
    x_lo, raw, consts = _k3_inputs(gen, *K3_FULL, torch.bfloat16, device)

    def fold():
        return phase_head.kernel_weights(consts["w0"], consts["w1"], x_lo.shape[-1],
                                         x_lo.dtype)

    weights = fold()
    k3_ms, k3_plain_ms, k3_fold_ms = _in_turns(
        lambda: phase_head.phase_head(x_lo, raw, **consts, weights=weights),
        lambda: phase_head.phase_head_reference(x_lo, raw, **consts), fold, iters=10)
    t0 = time.perf_counter()
    for _ in range(20):
        fold()
    torch.cuda.synchronize()
    fold_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    # per low-res pixel, for its 4 full-res pixels: refine0's upsampled part
    # as a 2x2 window over x_lo (the nearest upsample's collapse), its raw
    # part as a 3x3 over rc, and refine1's 5x5; the phase-space weights'
    # structural zeros (7 of 16 raw positions a phase) are not work
    _, hh, hw, c_up = x_lo.shape
    rc, c_mid, n_cls = raw.shape[-1], consts["w0"].shape[0], consts["w1"].shape[0]
    k3_bound = _bound(
        2 * hh * hw * 4 * (4 * c_up * c_mid + 9 * rc * c_mid + 25 * c_mid * n_cls),
        _nbytes(x_lo, raw, *consts.values()) + 4 * hh * hw * n_cls * x_lo.element_size(),
        x_lo.dtype)
    # refine0's weights staged per frame: all of them once per output tile
    staged = []
    for kind, tile, w0_bytes in (("bf16", phase_head.TILE_BF16, _nbytes(weights[0])),
                                 ("f32", phase_head.TILE_F32,
                                  4 * 4 * (c_up + 4 * rc) * 4 * c_mid)):
        tiles = -(-2 * hh // tile[0]) * -(-2 * hw // tile[1])
        staged.append(f"{kind} kernel {tiles} {tile[0]}x{tile[1]} tiles x {w0_bytes} B = "
                      f"{tiles * w0_bytes / 1e9:.3f} GB")
    print("K3 refine0 weights staged per frame: " + "; ".join(staged))
    print(f"{tag} K3 {FULL_HEIGHT}x{FULL_WIDTH} (x_lo {tuple(x_lo.shape)}, raw "
          f"{tuple(raw.shape)}) bf16, weights folded beforehand: median {k3_ms:.4f} ms; "
          f"plain version (cuDNN, bf16) {k3_plain_ms:.4f} ms; the wrapper's fold "
          f"(kernel_weights) {k3_fold_ms:.4f} ms by CUDA events (20 iterations each, in "
          f"turns), {fold_wall_ms:.4f} ms of host wall time with its sync (20 folds); "
          f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    # K3 at DenseNet-161's head (the wide layout) beside its plain version,
    # the model's plain head (use_fused_kernels False: upsample, concat,
    # cuDNN convs in bf16) and the phase-space eval head on the same inputs
    x_lo, raw, consts = _k3_inputs(gen, *K3_FULL_161, torch.bfloat16, device)
    c_up, c_mid = x_lo.shape[-1], consts["w0"].shape[0]
    weights = phase_head.kernel_weights(consts["w0"], consts["w1"], c_up, x_lo.dtype)
    heads = {}
    for fused in (False, True):     # the plain head, and the head's phase-space weights
        head = Head(c_up, raw.shape[-1], c_mid, consts["w1"].shape[0], use_fused=fused)
        with torch.no_grad():   # BN set so that its fold is (g, b): var + eps = 1
            for norm, g, b in ((head.norm0, "g0", "b0"), (head.norm1, "g1", "b1")):
                norm.weight.copy_(consts[g])
                norm.bias.copy_(consts[b])
                norm.running_var.fill_(1 - norm.eps)
            head.refine0.weight.copy_(consts["w0"])
            head.refine1.weight.copy_(consts["w1"])
        heads[fused] = head.to(device, memory_format=torch.channels_last).eval()
    x_nchw, raw_nchw = x_lo.permute(0, 3, 1, 2), raw.permute(0, 3, 1, 2)
    g0, b0, g1, b1 = (consts[k] for k in ("g0", "b0", "g1", "b1"))
    with torch.no_grad():
        w0t, w4t = (w.to(x_lo.dtype) for w in phase_head.phase_space_weights(
            heads[True].refine0.weight, heads[True].refine1.weight, c_up))
    with torch.inference_mode():
        k3_161 = dict(zip(("ms", "plain_ms", "model_head_ms", "phase_space_ms"), _in_turns(
            lambda: phase_head.phase_head(x_lo, raw, **consts, weights=weights),
            lambda: phase_head.phase_head_reference(x_lo, raw, **consts),
            lambda: heads[False](x_nchw, raw_nchw),
            lambda: phase_head.phase_space_head(x_nchw, raw_nchw, g0=g0, b0=b0, g1=g1, b1=b1,
                                                w0t=w0t, w4t=w4t), iters=10)))
    _, hh, hw, _ = x_lo.shape
    rc, n_cls = raw.shape[-1], consts["w1"].shape[0]
    k3_161["bound"] = _bound(
        2 * hh * hw * 4 * (4 * c_up * c_mid + 9 * rc * c_mid + 25 * c_mid * n_cls),
        _nbytes(x_lo, raw, *consts.values()) + 4 * hh * hw * n_cls * x_lo.element_size(),
        x_lo.dtype)
    print(f"{tag} K3 densenet161 {FULL_HEIGHT}x{FULL_WIDTH} (x_lo {tuple(x_lo.shape)}, raw "
          f"{tuple(raw.shape)}, c_mid {c_mid}) bf16, layout "
          f"{phase_head.bf16_layout(c_up + 4 * rc, c_mid)}, weights folded beforehand: "
          f"median {k3_161['ms']:.4f} ms; plain version (cuDNN, bf16) "
          f"{k3_161['plain_ms']:.4f} ms; the model's plain head (use_fused_kernels False) "
          f"{k3_161['model_head_ms']:.4f} ms; the phase-space eval head "
          f"{k3_161['phase_space_ms']:.4f} ms (20 iterations each, in turns); bound "
          f"{k3_161['bound'][0]:.4f} ms ({k3_161['bound'][1]})")
    del heads, w0t, w4t
    # the phase-space head's two eval forms of refine1 (four 3x3 convs over
    # the slices, the model's, or JAX's one 4x4 conv over the masked grid)
    # and the plain head at DenseNet-121's 128x192 head, on the same window grid
    for batch in PHASE_HEAD_BATCHES:
        x_lo, raw, consts = _k3_inputs(gen, HEIGHT // 2, WIDTH // 2, 128, 4, 64, 3,
                                       torch.bfloat16, device, batch=batch)
        x_nchw, raw_nchw = x_lo.permute(0, 3, 1, 2), raw.permute(0, 3, 1, 2)
        g0, b0, g1, b1 = (consts[k] for k in ("g0", "b0", "g1", "b1"))
        w0t, w4t = (w.to(x_lo.dtype) for w in
                    phase_head.phase_space_weights(consts["w0"], consts["w1"], 128))
        g, b = (t.to(x_lo.dtype)[:, None, None] for t in (g0, b0))
        mask = _phase_mask(HEIGHT // 2, WIDTH // 2, x_lo.dtype, device)
        with torch.inference_mode():
            a = torch.relu(torch.addcmul(b[:128], x_nchw, g[:128]))
            rn = torch.relu(torch.addcmul(b[128:], raw_nchw, g[128:]))
            P = phase_head.phase_head_conv0(a, rn, w0t)
            slices = phase_head.phase_head_refine1(P, g1, b1, w4t, HEIGHT // 2, WIDTH // 2)
            err = float((_refine1_single(P, g1, b1, w4t, mask) - slices).abs().max()
                        / slices.abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"the single form of refine1 is {err:.3e} of max|slices| "
                                     "from the slices form (bound 2e-2)")
            slices_ms, single_ms, conv0_ms, plain_ms = _in_turns(
                lambda: phase_head.phase_head_refine1(P, g1, b1, w4t, HEIGHT // 2, WIDTH // 2),
                lambda: _refine1_single(P, g1, b1, w4t, mask),
                lambda: phase_head.phase_head_conv0(a, rn, w0t),
                lambda: phase_head.phase_head_reference(x_lo, raw, **consts), iters=10)
        print(f"{tag} phase-space head forms b{batch} bf16 {HEIGHT}x{WIDTH} (x_lo "
              f"{tuple(x_lo.shape)}, c_mid 64): refine1 as four 3x3 convs over the slices "
              f"(the model's) {slices_ms:.4f} ms; as one 4x4 conv over the masked grid "
              f"{single_ms:.4f} ms (err / max|slices| {err:.3e}); conv0 (the 2x2 window "
              f"conv) {conv0_ms:.4f} ms; the plain head (K3's plain version: upsample, "
              f"concat, BN, 3x3, BN, 5x5) {plain_ms:.4f} ms (20 iterations each, in turns)")
        del x_nchw, raw_nchw, a, rn, P, slices, w0t, w4t, g, b, mask
    k4_ms, k4_bound = {}, {}
    for name, (h, w, c0, layers) in K4_BLOCKS.items():
        x, folded = _k2_inputs(gen, h, w, c0, layers, 32, 128, torch.bfloat16, device,
                               batch=256)
        packed = dense_block_strip.pack_layer_weights(folded)
        k4_bound[name] = _block_bound(x, folded)
        # the model's own plain loop, which K4 replaces on the opt-in path
        block = DenseBlock(layers, c0, 4, 32, 0.0).to(device).eval()
        x_nchw = x.permute(0, 3, 1, 2)          # channels_last, as the model holds it
        with torch.inference_mode():
            k4_ms[name] = _in_turns(
                lambda: dense_block.dense_block(x, folded, packed),
                lambda: dense_block.dense_block_reference(x, folded),
                lambda: block(x_nchw), iters=5)
        tile = dense_block.block_plan(256, h, w, sms).tile
        print(f"{tag} K4 {name} (256, {h}, {w}, {c0}) L={layers} bf16, {tile[0]}x{tile[1]} "
              f"tiles, weights packed beforehand: median "
              f"{k4_ms[name][0]:.4f} ms; plain version ({PLAIN_BLOCK}) "
              f"{k4_ms[name][1]:.4f} ms; the model's plain loop (cuDNN bf16 convs, BN "
              f"in bf16) {k4_ms[name][2]:.4f} ms (10 iterations each, in turns); bound "
              f"{k4_bound[name][0]:.4f} ms ({k4_bound[name][1]})")
    k4_161 = {}
    for name, (h, w, c0, layers) in K4_BLOCKS_161.items():
        x, folded = _k2_inputs(gen, h, w, c0, layers, 48, 192, torch.bfloat16, device,
                               batch=256)
        packed = dense_block_strip.pack_layer_weights(folded)
        block = DenseBlock(layers, c0, 4, 48, 0.0).to(device).eval()
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            times = _in_turns(
                lambda: dense_block.dense_block(x, folded, packed),
                lambda: dense_block.dense_block_reference(x, folded),
                lambda: block(x_nchw), iters=5)
        k4_161[name] = dict(zip(("ms", "plain", "loop"), times), bound=_block_bound(x, folded))
        t = k4_161[name]
        tile = dense_block.block_plan(256, h, w, sms, 48, 192).tile
        print(f"{tag} K4 densenet161 {name} (256, {h}, {w}, {c0}) L={layers} G=48 K=192 bf16, "
              f"{tile[0]}x{tile[1]} tiles, weights packed beforehand: median {t['ms']:.4f} "
              f"ms; plain version ({PLAIN_BLOCK}) {t['plain']:.4f} ms; the model's plain "
              f"loop (cuDNN bf16 convs, BN in bf16) {t['loop']:.4f} ms (10 iterations each, "
              f"in turns); bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    k6 = {}
    for key, (h, w, c) in K6_TIMED.items():
        x, w7, gamma, beta = _k6_inputs(gen, 1, h, w, c, 64, torch.bfloat16, device)
        packed = stem_pool.pack_stem_weights(w7)
        # the model's own unfused stem (conv0, norm0, ReLU, pool0), which K6 replaces
        stem = Encoder(ModelSpec(), c, up_to_block=1).to(device).eval()
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            ms, plain_ms, model_ms, pack_ms = _in_turns(
                lambda: stem_pool.stem_pool(x, w7, gamma, beta, packed),
                lambda: stem_pool.stem_pool_reference(x, w7, gamma, beta),
                lambda: stem(x_nchw), lambda: stem_pool.pack_stem_weights(w7), iters=10)
        # conv0's 7x7 at stride 2; the pool's comparisons are not counted
        f = w7.shape[-1]
        bound = _bound(2 * (h // 2) * (w // 2) * 49 * c * f,
                       _nbytes(x, w7, gamma, beta) + (h // 4) * (w // 4) * f * x.element_size(),
                       x.dtype)
        k6.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                   f"model_stem_ms{key}": model_ms, f"bound_ms{key}": bound[0]})
        if not key:
            k6.update(bound_by=bound[1], pack_ms=pack_ms)
        print(f"{tag} K6 {h}x{w} x {tuple(x.shape)} F=64 bf16, weights packed beforehand: "
              f"median {ms:.4f} ms; plain version (cuDNN conv0 in f32 from bf16 inputs, BN, "
              f"ReLU, max pool in f32) {plain_ms:.4f} ms; the model's unfused stem (cuDNN "
              f"bf16) {model_ms:.4f} ms; the packing (pack_stem_weights, once per fold) "
              f"{pack_ms:.4f} ms (20 iterations each, in turns); bound {bound[0]:.4f} ms "
              f"({bound[1]})")

    del x, folded, packed, x_lo, raw, consts, weights
    torch.cuda.empty_cache()
    _time_train(tag, train_state, train_step, eval_step, gen, device)
    _time_raw(tag, train_state, train_step, raw_record, cfg_train)

    launches = {name: sum(c[name] for c in path_counts) for name in _launch_counts()}
    bn_relu_entry["launches"] = launches["bn_relu"]
    print(json.dumps({"kernels": [
        {"name": "concat_bn_relu_conv1x1", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/concat_bn_relu_conv1x1.cu",
         "replaces": "dmmfods_tpu/ops/fused.py:618",
         "launches": launches["K1"], "max_abs_err": worst["K1"],
         "ms": k1["b256"]["ms"], "plain_ms": k1["b256"]["plain_ms"],
         "bound_ms": k1["b256"]["bound"][0], "bound_by": k1["b256"]["bound"][1],
         "library_ms": LIBRARY_MS, "device_ms": k1["b256"]["device_ms"],
         "fold_ms": k1["b256"]["fold_ms"], "gemm_yardstick_ms": k1["b256"]["gemm_ms"],
         "gemm_yardstick_device_ms": k1["b256"]["gemm_device_ms"],
         **{f"{name}_{key}": (k1[key]["bound"][0] if name == "bound_ms" else k1[key][name])
            for key in ("b1", "b8", "b32", "full")
            for name in ("ms", "device_ms", "plain_ms", "bound_ms")}},
        {"name": "dense_block_strip", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/dense_block_strip.cu",
         "replaces": "dmmfods_tpu/ops/pallas/dense_block_strip.py:341",
         "launches": launches["K2"], "max_abs_err": worst["K2"],
         "ms": k2_ms["block1"][0], "plain_ms": k2_ms["block1"][1],
         "bound_ms": block_bound["block1"][0], "bound_by": block_bound["block1"][1],
         "library_ms": LIBRARY_MS, "pack_ms": k2_ms["block1"][2],
         "ms_block2": k2_ms["block2"][0], "plain_ms_block2": k2_ms["block2"][1],
         "bound_ms_block2": block_bound["block2"][0], "pack_ms_block2": k2_ms["block2"][2],
         **{f"{key}_161_{name}": (t["bound"][0] if key == "bound_ms" else t[field])
            for name, t in k161.items()
            for key, field in (("ms", "k2"), ("plain_ms", "plain"), ("model_loop_ms", "loop"),
                               ("pack_ms", "pack"), ("bound_ms", None))},
         "forward_161_ms": fwd161["default"],
         "forward_161_plain_blocks_ms": fwd161["plain blocks"]},
        {"name": "phase_head", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/phase_head.cu",
         "replaces": "dmmfods_tpu/ops/pallas/phase_head.py:246",
         "launches": launches["K3"], "max_abs_err": worst["K3"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": LIBRARY_MS, "fold_ms": k3_fold_ms,
         **{f"{key}_161": (k3_161["bound"][0] if key == "bound_ms" else k3_161[key])
            for key in ("ms", "plain_ms", "model_head_ms", "phase_space_ms", "bound_ms")},
         "bound_by_161": k3_161["bound"][1]},
        {"name": "dense_block", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/dense_block.cu",
         "replaces": "dmmfods_tpu/ops/pallas/dense_block.py:262",
         "launches": launches["K4"], "max_abs_err": worst["K4"],
         "ms": k4_ms["block1"][0], "plain_ms": k4_ms["block1"][1],
         "bound_ms": k4_bound["block1"][0], "bound_by": k4_bound["block1"][1],
         "library_ms": LIBRARY_MS, "model_loop_ms": k4_ms["block1"][2],
         **{f"{key}_{name}": k4_ms[name][i] for name in ("block2", "block3", "block4")
            for i, key in enumerate(("ms", "plain_ms", "model_loop_ms"))},
         **{f"bound_ms_{name}": k4_bound[name][0]
            for name in ("block2", "block3", "block4")},
         **{f"{key}_161_{name}": (t["bound"][0] if key == "bound_ms" else t[field])
            for name, t in k4_161.items()
            for key, field in (("ms", "ms"), ("plain_ms", "plain"), ("model_loop_ms", "loop"),
                               ("bound_ms", None))}},
        {"name": "stem_pool", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/stem_pool.cu",
         "replaces": "dmmfods_tpu/ops/pallas/stem_pool.py:252",
         "launches": launches["K6"], "max_abs_err": worst["K6"],
         "library_ms": LIBRARY_MS, **k6},
        {"name": "dense_block_strip_recompute", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/dense_block_recompute.cu",
         "replaces": "dmmfods_tpu/ops/pallas/dense_block_strip.py:421",
         "launches": launches["K5"], "max_abs_err": worst["K5"],
         "ms": k5_ms["block1"][0], "plain_ms": k5_ms["block1"][1],
         "bound_ms": block_bound["block1"][0], "bound_by": block_bound["block1"][1],
         "library_ms": LIBRARY_MS, "k2_ms": k5_ms["block1"][2],
         "ms_block2": k5_ms["block2"][0], "plain_ms_block2": k5_ms["block2"][1],
         "bound_ms_block2": block_bound["block2"][0], "k2_ms_block2": k5_ms["block2"][2],
         "path_ms": k5_path_ms, "default_path_ms": default_path_ms,
         **{f"{key}_161_{name}": (t["bound"][0] if key == "bound_ms" else t[field])
            for name, t in k161.items()
            for key, field in (("ms", "k5"), ("plain_ms", "plain"), ("model_loop_ms", "loop"),
                               ("k2_ms", "k2"), ("bound_ms", None))},
         "path_161_ms": fwd161["K5 path"]},
        bn_relu_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
