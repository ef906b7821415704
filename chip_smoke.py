#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dmmfods_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports no JAX. In order, and any failure ends the run with a non-zero
exit code:

1. Device: requires CUDA and prints the card's name and power limit.
2. Build: compiles the CUDA kernels from ``dmmfods_tpu_torch/csrc`` and
   prints the build time.
3. K1 (the fused concat+BN+ReLU+1x1 kernel) against its plain PyTorch
   version at the serving shape (16x24 pixels, 128/128 -> 128 channels) at
   batch 8 and 256 in bf16 and f32, and at a ragged shape in f32.
4. Serve: the full-width DenseNet-121 mid-fusion model (random weights from
   a seed) at 128x192 in bf16 through ``InferenceEngine``: warm-up, the
   worker with four requests, one synchronous request, stop. Checks the heat
   maps, that every device batch went through K1, K1's output inside a
   served batch, and the served output against the same weights in f32.
5. Time: the engine's forward at b1/b8/b32/b256, and K1 against its plain
   version at the b256 shape, by CUDA events.

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
NUM_PARAMS_DENSENET121 = 22_409_544
# K1 bounds, on max|K1 - plain| / max|plain|. f32: both accumulate in f32
# (TF32 off) and differ only in summation order. bf16: the plain version
# runs in f32 from the same bf16 inputs and weights, so the bound covers the
# kernel's single bf16 rounding of its output (2^-9 relative) with margin.
BOUND_F32 = 1e-4
BOUND_BF16 = 1e-2
# served bf16 heat maps against the same weights run in f32 (sigmoid
# outputs, absolute): bf16 rounding through ~130 conv layers. Measured
# 3.2e-3 on an H100 at the seed below.
BOUND_SERVED_VS_F32 = 2e-2


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    times.sort()
    return times[len(times) // 2], times


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


def main() -> int:
    import numpy as np
    import torch

    # 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.models.dense_unet_lidar import (
        DenseUNetLidar, densenet121_u_lidar)
    from dmmfods_tpu_torch.ops import _build, fused
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
        print(f"build: nvcc {_build.build_seconds:.2f} s, load {load_s:.2f} s "
              f"-> {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if "registers" in line:
            print("  ptxas:", line.split(":", 1)[1].strip())

    # 3. K1 against its plain version ----------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    cases = [(batch, 16, 24, 128, 128, 128, dt)
             for dt in (torch.bfloat16, torch.float32) for batch in (8, 256)]
    cases.append((1, 25, 40, 48, 16, 40, torch.float32))
    worst_err = 0.0
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
        worst_err = max(worst_err, err)

    # 4. serve -----------------------------------------------------------------
    with tempfile.TemporaryDirectory() as host:
        cfg = get_config(host)
    bundle = densenet121_u_lidar(config=cfg, device=device, seed=SEED)
    spec = bundle.spec
    if bundle.num_params != NUM_PARAMS_DENSENET121:
        raise AssertionError(f"{bundle.num_params} params, want {NUM_PARAMS_DENSENET121}")
    if spec.fusion != "mid" or spec.dtype != torch.bfloat16:
        raise AssertionError(f"want mid fusion in bf16, got {spec.fusion} {spec.dtype}")
    print(f"model: densenet121_u_lidar, {bundle.num_params} params, "
          f"{spec.fusion} fusion, {spec.dtype}, {HEIGHT}x{WIDTH}")
    engine = InferenceEngine(bundle, buckets=(1, 8, 32))

    captured = []
    hook = bundle.module.concat_module.register_forward_hook(
        lambda mod, inputs, output: captured.append((inputs[0], inputs[1], output)))
    rng = np.random.default_rng(SEED)
    sizes = (1, 3, 8, 20)
    requests = [(rng.uniform(0, 1, (n, HEIGHT, WIDTH, 3)).astype(np.float32),
                 rng.uniform(0, 1, (n, HEIGHT, WIDTH, 1)).astype(np.float32))
                for n in sizes + (5,)]

    fused.K1_LAUNCHES.reset()
    t0 = time.perf_counter()
    engine.warmup()
    warm_batches = engine.device_batches
    engine.start()
    futures = [engine.submit(rgb, lidar) for rgb, lidar in requests[:-1]]
    results = [f.result(timeout=600) for f in futures]
    results.append(engine.run(*requests[-1]))
    engine.stop()
    serve_s = time.perf_counter() - t0
    launches = fused.K1_LAUNCHES.value
    batches = engine.device_batches
    hook.remove()

    for (rgb, _), out in zip(requests, results):
        n = rgb.shape[0]
        if out.shape != (n, HEIGHT, WIDTH, 3):
            raise AssertionError(f"heat maps {out.shape}, want {(n, HEIGHT, WIDTH, 3)}")
        if not (np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1):
            raise AssertionError("heat maps not finite in [0, 1]")
    print(f"served {len(requests)} requests ({sum(r[0].shape[0] for r in requests)} "
          f"frames) in {batches} device batches ({warm_batches} warm-up), "
          f"{serve_s:.2f} s wall with warm-up")
    if launches != batches or launches == 0:
        raise AssertionError(f"K1 launched {launches} times for {batches} device batches")
    print(f"K1 launches {launches} == device batches {batches}")

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
    worst_err = max(worst_err, err)

    # the served bf16 heat maps against the same weights in f32
    ref_model = DenseUNetLidar(dataclasses.replace(spec, dtype=torch.float32))
    ref_model.load_state_dict(bundle.module.state_dict())
    ref_model = ref_model.to(device, memory_format=torch.channels_last).eval()
    rgb, lidar = requests[-1]
    with torch.inference_mode():
        ref = torch.sigmoid(ref_model(torch.from_numpy(rgb).to(device),
                                      torch.from_numpy(lidar).to(device)))
    diff = np.abs(results[-1] - ref.cpu().numpy())
    print(f"served bf16 vs f32 model, {rgb.shape[0]} frames: max abs diff "
          f"{diff.max():.3e} (mean {diff.mean():.3e}) <= bound {BOUND_SERVED_VS_F32}")
    if not diff.max() <= BOUND_SERVED_VS_F32:
        raise AssertionError("served heat maps disagree with the f32 model")
    del ref_model, ref, captured

    # 5. time ------------------------------------------------------------------
    tag = f"[{card}]"
    for batch in (1, 8, 32, 256):
        rgb = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen).to(device, spec.dtype)
        lidar = torch.rand(batch, HEIGHT, WIDTH, 1, generator=gen).to(device, spec.dtype)
        ms, _ = _median_ms(lambda: engine.forward(rgb, lidar), iters=30)
        print(f"{tag} engine forward b{batch} bf16 {HEIGHT}x{WIDTH}: median {ms:.4f} ms, "
              f"{batch / ms * 1e3:.1f} frames/s (30 iterations)")
    a, b, params = _k1_inputs(gen, 256, 16, 24, 128, 128, 128, torch.bfloat16, device)
    k1_times, plain_times = [], []
    for version in ("plain", "k1", "k1", "plain"):
        if version == "k1":
            k1_times += _median_ms(lambda: fused.concat_bn_relu_conv1x1(a, b, **params), 25)[1]
        else:
            plain_times += _median_ms(
                lambda: fused.concat_bn_relu_conv1x1_reference(a, b, **params), 25)[1]
    k1_ms = sorted(k1_times)[len(k1_times) // 2]
    plain_ms = sorted(plain_times)[len(plain_times) // 2]
    print(f"{tag} K1 b256 (98304 rows, 128+128->128, bf16): median {k1_ms:.4f} ms; "
          f"plain version {plain_ms:.4f} ms (50 iterations each, in turns)")

    print(json.dumps({"kernels": [{
        "name": "concat_bn_relu_conv1x1",
        "route": "cuda",
        "source": "dmmfods_tpu_torch/csrc/concat_bn_relu_conv1x1.cu",
        "replaces": "dmmfods_tpu/ops/fused.py:618",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
