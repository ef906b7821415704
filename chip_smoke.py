#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dmmfods_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports no JAX. In order, and any failure ends the run with a non-zero
exit code:

1. Device: requires CUDA and prints the card's name and power limit.
2. Build: compiles the CUDA kernels from ``dmmfods_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time and ptxas's
   register report of each kernel.
3. K1 (the fused concat+BN+ReLU+1x1 kernel) against its plain PyTorch
   version at the 128x192 serving shape (16x24 pixels, 128/128 -> 128
   channels) at batch 8 and 256 in bf16 and f32, at the 1280x1920 shape
   (80x120 pixels, 256/256 -> 256) in bf16, and at a ragged shape in f32.
4. K2 (the dense block) against its plain version at the 1280x1920 block
   shapes (320x480, c0 64, 6 layers; 160x240, c0 128, 12 layers) in bf16
   and at a ragged shape in f32; K3 (the head) at the 1280x1920 shape in
   bf16 and at a ragged shape in f32.
5. Serve at 128x192: the full-width DenseNet-121 mid-fusion model (random
   weights from a seed) in bf16 through ``InferenceEngine``: warm-up, the
   worker with four requests, one synchronous request, stop. Checks the heat
   maps, that every device batch went through K1 and none through K2 or K3,
   K1's output inside a served batch, and the served output against the
   same weights in f32.
6. Serve at 1280x1920 batch 1: DenseNet-121 with mid fusion before block 3
   (BASELINE.json config 3) in bf16: warm-up, two requests through the
   worker, one synchronous request, stop. Checks the heat maps, that every
   device batch ran K1 once, K2 four times and K3 once, and the served
   output against the same weights in f32.
7. Time, by CUDA events: the engine's forward at b1/b8/b32/b256 at 128x192
   and at b1 at 1280x1920; K1 at the b256 shape, K2 at both block shapes
   and K3 at the 1280x1920 shape, each against its plain version in turns.

Its last two lines are a JSON summary of the kernels and the run's result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
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
# The 1280x1920 path's kernel shapes: K2 per dense block (h, w, c0, layers;
# growth 32, K 128), K3 (hh, hw, c_up, raw channels, c_mid, classes).
K2_BLOCKS = {"block1": (320, 480, 64, 6), "block2": (160, 240, 128, 12)}
K3_FULL = (640, 960, 128, 4, 64, 3)
KERNEL_NAMES = ("concat_bn_relu_conv1x1_kernel", "dense_layer_kernel",
                "phase_head_kernel")


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _median(values):
    return sorted(values)[len(values) // 2]


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


def _in_turns(kernel, plain, iters):
    """Median ms of ``kernel`` and of ``plain``, timed plain, kernel, kernel,
    plain with ``iters`` iterations each time."""
    times = {"kernel": [], "plain": []}
    for version in ("plain", "kernel", "kernel", "plain"):
        times[version] += _median_ms(kernel if version == "kernel" else plain, iters)[1]
    return _median(times["kernel"]), _median(times["plain"])


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


def _k1_error(out, a, b, params):
    """max|K1 - plain| and max|plain|, the plain version in f32."""
    from dmmfods_tpu_torch.ops.fused import concat_bn_relu_conv1x1_reference

    ref = concat_bn_relu_conv1x1_reference(a.float(), b.float(), **params)
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def _k2_inputs(gen, h, w, c0, layers, growth, k, dtype, device):
    """Input and folded stacks of a random dense block. BN biases are wide
    enough that some folded BN2 bias is positive: a pixel outside the image
    then reads ReLU(b2) != 0 unless the kernel masks it, so a border bug
    shows. Weights are ones the kernel's dtype holds exactly."""
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
    x = torch.randn(1, h, w, c0, generator=gen).to(device, dtype)
    return x, {name: t.to(device) for name, t in folded.items()}


def _k3_inputs(gen, hh, hw, c_up, rc, c_mid, n_cls, dtype, device):
    """Inputs and folded constants of a random head (weights exact in dtype)."""
    import torch

    c_in = c_up + rc
    x_lo = torch.randn(1, hh, hw, c_up, generator=gen).to(device, dtype)
    raw = torch.rand(1, 2 * hh, 2 * hw, rc, generator=gen).to(device, dtype)
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


def _reset_counts():
    from dmmfods_tpu_torch.ops import dense_block_strip, fused, phase_head

    for count in (fused.K1_LAUNCHES, dense_block_strip.K2_LAUNCHES,
                  phase_head.K3_LAUNCHES):
        count.reset()


def _counts():
    from dmmfods_tpu_torch.ops import dense_block_strip, fused, phase_head

    return (fused.K1_LAUNCHES.value, dense_block_strip.K2_LAUNCHES.value,
            phase_head.K3_LAUNCHES.value)


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

    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar

    ref_model = DenseUNetLidar(dataclasses.replace(bundle.spec, dtype=torch.float32))
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


def main() -> int:
    import numpy as np
    import torch

    # 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.models.dense_unet_lidar import densenet121_u_lidar
    from dmmfods_tpu_torch.ops import _build, dense_block_strip, fused, phase_head
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
    _build.load()
    load_s = time.perf_counter() - t0
    if _build.build_seconds is None:
        print(f"build: reused {_build.library_path()} ({load_s:.2f} s to load)")
    else:
        print(f"build: nvcc {_build.build_seconds:.2f} s for {len(_build.SOURCES)} "
              f"sources in parallel, load {load_s:.2f} s -> {_build.library_path()}")
    kernel = "?"
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for n in KERNEL_NAMES if n in line), "?")
            kernel = f"{name}<{'bf16' if 'nv_bfloat16' in line else 'f32'}>"
        elif "registers" in line:
            print(f"  ptxas {kernel}:", line.split(":", 1)[1].strip())

    # 3. K1 against its plain version ----------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    cases = [(batch, 16, 24, 128, 128, 128, dt)
             for dt in (torch.bfloat16, torch.float32) for batch in (8, 256)]
    cases.append((1, 80, 120, 256, 256, 256, torch.bfloat16))   # the 1280x1920 fuse
    cases.append((1, 25, 40, 48, 16, 40, torch.float32))
    for batch, h, w, ca, cb, cout, dt in cases:
        a, b, params = _k1_inputs(gen, batch, h, w, ca, cb, cout, dt, device)
        out = fused.concat_bn_relu_conv1x1(a, b, **params)
        torch.cuda.synchronize()
        err, scale = _k1_error(out, a, b, params)
        bound = (BOUND_BF16 if dt == torch.bfloat16 else BOUND_F32) * scale
        print(f"K1 check B={batch} {h}x{w} {ca}+{cb}->{cout} {str(dt)[6:]}: "
              f"max abs err {err:.3e} <= bound {bound:.3e}")
        if not err <= bound:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {bound}")
        worst["K1"] = max(worst["K1"], err)

    # 4. K2 and K3 against their plain versions ----------------------------
    k2_cases = [(name, h, w, c0, layers, 32, 128, torch.bfloat16)
                for name, (h, w, c0, layers) in K2_BLOCKS.items()]
    k2_cases.append(("ragged", 37, 53, 24, 3, 8, 32, torch.float32))
    for name, h, w, c0, layers, growth, k, dt in k2_cases:
        x, folded = _k2_inputs(gen, h, w, c0, layers, growth, k, dt, device)
        out = dense_block_strip.dense_block_strip(x, folded)
        torch.cuda.synchronize()
        ref = dense_block_strip.dense_block_strip_reference(x.float(), folded)
        worst["K2"] = max(worst["K2"], _check(
            "K2", f"{name} {h}x{w} c0={c0} L={layers} G={growth} K={k}", out, ref))
    for name, shape, dt in (("1280x1920", K3_FULL, torch.bfloat16),
                            ("ragged", (13, 21, 40, 3, 20, 3), torch.float32)):
        x_lo, raw, consts = _k3_inputs(gen, *shape, dt, device)
        out = phase_head.phase_head(x_lo, raw, **consts)
        torch.cuda.synchronize()
        ref = phase_head.phase_head_reference(x_lo.float(), raw.float(), **consts)
        worst["K3"] = max(worst["K3"], _check(
            "K3", f"{name} x_lo {tuple(x_lo.shape)} raw {tuple(raw.shape)} "
            f"c_mid={shape[4]} classes={shape[5]}", out, ref))
    del x, folded, x_lo, raw, consts, out, ref
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as host:
        cfg = get_config(host)
        cfg3 = get_config(host)
    rng = np.random.default_rng(SEED)

    # 5. serve at 128x192 --------------------------------------------------------
    bundle = densenet121_u_lidar(config=cfg, device=device, seed=SEED)
    spec = bundle.spec
    if bundle.num_params != NUM_PARAMS_DENSENET121:
        raise AssertionError(f"{bundle.num_params} params, want {NUM_PARAMS_DENSENET121}")
    if spec.fusion != "mid" or spec.dtype != torch.bfloat16:
        raise AssertionError(f"want mid fusion in bf16, got {spec.fusion} {spec.dtype}")
    print(f"model: densenet121_u_lidar, {bundle.num_params} params, "
          f"{spec.fusion} fusion, {spec.dtype}, {HEIGHT}x{WIDTH}")
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
    launches, k2_small, k3_small = _counts()
    batches = engine.device_batches
    hook.remove()

    _check_heat_maps(requests, results, HEIGHT, WIDTH)
    print(f"served {len(requests)} requests ({sum(r[0].shape[0] for r in requests)} "
          f"frames) in {batches} device batches ({warm_batches} warm-up), "
          f"{serve_s:.2f} s wall with warm-up")
    if launches != batches or launches == 0:
        raise AssertionError(f"K1 launched {launches} times for {batches} device batches")
    if k2_small or k3_small:
        raise AssertionError(f"K2/K3 launched {k2_small}/{k3_small} times at "
                             f"{HEIGHT}x{WIDTH}, where neither engages")
    print(f"K1 launches {launches} == device batches {batches}; K2 0, K3 0")

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

    # 6. serve at 1280x1920, batch 1 (config 3) -----------------------------
    cfg3.model.concat_before_block_num = 3
    bundle3 = densenet121_u_lidar(config=cfg3, device=device, seed=SEED)
    if bundle3.num_params != NUM_PARAMS_CONFIG3:
        raise AssertionError(f"{bundle3.num_params} params, want {NUM_PARAMS_CONFIG3}")
    print(f"model: densenet121_u_lidar, {bundle3.num_params} params, "
          f"{bundle3.spec.fusion} fusion before block "
          f"{bundle3.spec.concat_before_block_num}, {bundle3.spec.dtype}, "
          f"{FULL_HEIGHT}x{FULL_WIDTH}")
    engine3 = InferenceEngine(bundle3, buckets=(1,), height=FULL_HEIGHT, width=FULL_WIDTH)
    requests3 = [(rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 3)).astype(np.float32),
                  rng.uniform(0, 1, (1, FULL_HEIGHT, FULL_WIDTH, 1)).astype(np.float32))
                 for _ in range(3)]
    _reset_counts()
    results3, serve3_s = _serve(engine3, requests3[:-1], requests3[-1])
    full_counts = _counts()
    batches3 = engine3.device_batches
    _check_heat_maps(requests3, results3, FULL_HEIGHT, FULL_WIDTH)
    print(f"served {len(requests3)} requests of 1 frame at {FULL_HEIGHT}x{FULL_WIDTH} in "
          f"{batches3} device batches (1 warm-up), {serve3_s:.2f} s wall with warm-up")
    if full_counts != (batches3, 4 * batches3, batches3):
        raise AssertionError(f"launches K1/K2/K3 {full_counts} for {batches3} device "
                             f"batches, want 1/4/1 per batch")
    print(f"launches per device batch: K1 {full_counts[0] / batches3:g}, "
          f"K2 {full_counts[1] / batches3:g}, K3 {full_counts[2] / batches3:g} "
          f"({batches3} batches)")
    _served_vs_f32(bundle3, *requests3[-1], results3[-1], device,
                   f"{FULL_HEIGHT}x{FULL_WIDTH}")
    torch.cuda.empty_cache()

    # 7. time ------------------------------------------------------------------
    tag = f"[{card}]"
    for batch in (1, 8, 32, 256):
        rgb = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen).to(device, spec.dtype)
        lidar = torch.rand(batch, HEIGHT, WIDTH, 1, generator=gen).to(device, spec.dtype)
        ms, _ = _median_ms(lambda: engine.forward(rgb, lidar), iters=20)
        print(f"{tag} engine forward b{batch} bf16 {HEIGHT}x{WIDTH}: median {ms:.4f} ms, "
              f"{batch / ms * 1e3:.1f} frames/s (20 iterations)")
    rgb = torch.rand(1, FULL_HEIGHT, FULL_WIDTH, 3, generator=gen).to(device, torch.bfloat16)
    lidar = torch.rand(1, FULL_HEIGHT, FULL_WIDTH, 1, generator=gen).to(device, torch.bfloat16)
    ms, _ = _median_ms(lambda: engine3.forward(rgb, lidar), iters=15)
    print(f"{tag} engine forward b1 bf16 {FULL_HEIGHT}x{FULL_WIDTH} (mid fusion before "
          f"block 3): median {ms:.4f} ms, {1e3 / ms:.2f} frames/s (15 iterations)")

    a, b, params = _k1_inputs(gen, 256, 16, 24, 128, 128, 128, torch.bfloat16, device)
    k1_ms, k1_plain_ms = _in_turns(
        lambda: fused.concat_bn_relu_conv1x1(a, b, **params),
        lambda: fused.concat_bn_relu_conv1x1_reference(a, b, **params), 25)
    print(f"{tag} K1 b256 (98304 rows, 128+128->128, bf16): median {k1_ms:.4f} ms; "
          f"plain version {k1_plain_ms:.4f} ms (50 iterations each, in turns)")
    k2_ms = {}
    for name, (h, w, c0, layers) in K2_BLOCKS.items():
        x, folded = _k2_inputs(gen, h, w, c0, layers, 32, 128, torch.bfloat16, device)
        k2_ms[name] = _in_turns(
            lambda: dense_block_strip.dense_block_strip(x, folded),
            lambda: dense_block_strip.dense_block_strip_reference(x, folded), 10)
        print(f"{tag} K2 {name} (1, {h}, {w}, {c0}) L={layers} bf16: median "
              f"{k2_ms[name][0]:.4f} ms; plain version (cuDNN, bf16) "
              f"{k2_ms[name][1]:.4f} ms (20 iterations each, in turns)")
    x_lo, raw, consts = _k3_inputs(gen, *K3_FULL, torch.bfloat16, device)
    k3_ms, k3_plain_ms = _in_turns(
        lambda: phase_head.phase_head(x_lo, raw, **consts),
        lambda: phase_head.phase_head_reference(x_lo, raw, **consts), 10)
    print(f"{tag} K3 {FULL_HEIGHT}x{FULL_WIDTH} (x_lo {tuple(x_lo.shape)}, raw "
          f"{tuple(raw.shape)}) bf16: median {k3_ms:.4f} ms; plain version (cuDNN, "
          f"bf16) {k3_plain_ms:.4f} ms (20 iterations each, in turns)")

    print(json.dumps({"kernels": [
        {"name": "concat_bn_relu_conv1x1", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/concat_bn_relu_conv1x1.cu",
         "replaces": "dmmfods_tpu/ops/fused.py:618",
         "launches": launches + full_counts[0], "max_abs_err": worst["K1"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "dense_block_strip", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/dense_block_strip.cu",
         "replaces": "dmmfods_tpu/ops/pallas/dense_block_strip.py:341",
         "launches": full_counts[1], "max_abs_err": worst["K2"],
         "ms": k2_ms["block1"][0], "plain_ms": k2_ms["block1"][1],
         "ms_block2": k2_ms["block2"][0], "plain_ms_block2": k2_ms["block2"][1]},
        {"name": "phase_head", "route": "cuda",
         "source": "dmmfods_tpu_torch/csrc/phase_head.cu",
         "replaces": "dmmfods_tpu/ops/pallas/phase_head.py:246",
         "launches": full_counts[2], "max_abs_err": worst["K3"],
         "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
