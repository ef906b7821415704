"""What holds the tensor-core kernels back: K4 (b256, the DenseNet-121
blocks at 128x192) and K5 (the two 1280x1920 blocks) in bf16, timed in turns
against copies of their sources with one part of the tensor-core layer body
(``csrc/dense_layer_mma.cuh``) or of K5's schedule removed; K6 (the fused
stem + pool0 at 1280x1920, 3 and 1 channels) against copies of
``csrc/stem_pool.cu`` with one part of its bf16 body removed; and K1 (the
fused concat + BN + ReLU + 1x1 at b256 and at 1280x1920) against copies of
``csrc/concat_bn_relu_conv1x1.cu`` with one part of its bf16 body removed. A
copy computes wrong numbers; only its time is read.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 -m dmmfods_tpu_torch.tools.layer_body_parts [K1 K4 K5 K6]

(the kernels named, all four without arguments). It builds every copy with
nvcc, all at once, each source into its own library under
``dmmfods_tpu_torch/_build/parts/``, then prints for each shape each
variant's median ms of device time by CUDA events (10 iterations in order,
then 10 in reverse; the stream sleeps before each start event while the
host enqueues the call, so the window holds no host time), with the card's
name and power limit. Without CUDA it exits 1.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from ..ops import _build, dense_block, dense_block_strip, fused, stem_pool

MMA = "dense_layer_mma.cuh"
K1_SOURCE = "concat_bn_relu_conv1x1.cu"
K5_SOURCE = "dense_block_recompute.cu"
K6_SOURCE = "stem_pool.cu"
# variant -> (source, text, replacement) edits that remove one part
VARIANTS = {
    "base": (),
    "no BN1 pass": ((MMA, "      if (p >= kHalo || c >= width || !frame.inside("
                          "y0 - 1 + p / kHW, x0 - 1 + p % kHW))\n", "      if (true)\n"),),
    "no 1x1 MMAs": ((MMA, "        if (wm + 2 * i >= P::kMT1) continue;\n",
                     "        if (true) continue;\n"),),
    "no 3x3 MMAs": ((MMA, "      if (!live) continue;\n#pragma unroll\n      for (int ks",
                     "      if (true) continue;\n#pragma unroll\n      for (int ks"),),
    "no strip barrier": ((K5_SOURCE, "  if (threadIdx.x == 0) {\n    const unsigned int "
                                     "target = st.target += st.nb;",
                          "  if (false) {\n    const unsigned int target = "
                          "st.target += st.nb;"),),
    "no window loads": ((K6_SOURCE, "if (e < kWin && gy >= 0 && gy < H && gx >= 0 && gx < W)",
                         "if (false)"),),
    "no im2col build": ((K6_SOURCE, "      *reinterpret_cast<__nv_bfloat162*>(a + row * kAS + kk)"
                                    " = __halves2bfloat162(lo, hi);\n", ""),),
    "no MMAs": ((K6_SOURCE, "        if (!n0 || k >= kKP) break;",
                 "        if (true) break;"),),
    "no pool": ((K6_SOURCE, "      if (py >= HQ || px >= WQ) continue;",
                 "      if (true) continue;"),),
    "no A loads": ((K1_SOURCE, "        const bool valid = row0 + r < rows && col < width;",
                    "        const bool valid = false;"),),
    "no weight staging": ((K1_SOURCE, "    const bool valid = g >= 0 && col < npad;",
                           "    const bool valid = false;"),),
    "no prologue": ((K1_SOURCE, "      if (row0 + r >= rows) continue;",
                     "      if (true) continue;"),),
    "no K1 MMAs": ((K1_SOURCE, "        if (pr >= live) break;", "        if (true) break;"),),
    "no stores": ((K1_SOURCE, "      if (row0 + r < rows)\n        *reinterpret_cast<uint4*>",
                   "      if (false)\n        *reinterpret_cast<uint4*>"),),
}
# the variants that apply to each kernel
KERNEL_VARIANTS = {"K4": ("base", "no BN1 pass", "no 1x1 MMAs", "no 3x3 MMAs"),
                   "K5": ("base", "no BN1 pass", "no 1x1 MMAs", "no 3x3 MMAs",
                          "no strip barrier"),
                   "K6": ("base", "no window loads", "no im2col build", "no MMAs", "no pool"),
                   "K1": ("base", "no A loads", "no weight staging", "no prologue", "no K1 MMAs",
                          "no stores")}
# K4, K5: (kernel, block, batch, h, w, c0, layers), growth 32 and K 128; K6:
# (kernel, stem, batch, h, w, channels, features); K1: (kernel, shape, batch,
# h, w, Ca + Cb, Cout) with Ca = Cb
CASES = (("K4", "block1", 256, 32, 48, 64, 6), ("K4", "block2", 256, 16, 24, 128, 12),
         ("K4", "block3", 256, 8, 12, 256, 24), ("K4", "block4", 256, 4, 6, 512, 16),
         ("K5", "block1", 1, 320, 480, 64, 6), ("K5", "block2", 1, 160, 240, 128, 12),
         ("K6", "RGB stem", 1, 1280, 1920, 3, 64), ("K6", "LiDAR stem", 1, 1280, 1920, 1, 64),
         ("K1", "b256", 256, 16, 24, 256, 128), ("K1", "1280x1920", 1, 80, 120, 512, 256))
ENTRIES = {"K1": (K1_SOURCE, "dmm_concat_bn_relu_conv1x1"),
           "K4": ("dense_block.cu", "dmm_dense_block"),
           "K5": (K5_SOURCE, "dmm_dense_block_recompute"),
           "K6": (K6_SOURCE, "dmm_stem_pool")}
ITERS = 10


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _build_variants(kernels):
    """{(variant, kernel): ctypes library} for every variant of each of
    ``kernels``' sources; raises if a build fails."""
    nvcc = _build._nvcc()
    procs = {}
    for variant, edits in VARIANTS.items():
        if not any(variant in KERNEL_VARIANTS[k] for k in kernels):
            continue
        src_dir = _build.BUILD_DIR / "parts" / variant.replace(" ", "_")
        if src_dir.exists():
            shutil.rmtree(src_dir)
        shutil.copytree(_build.CSRC_DIR, src_dir)
        for name, text, repl in edits:
            source = (src_dir / name).read_text()
            if source.count(text) != 1:
                raise RuntimeError(f"{variant}: the part to remove is not in {name} once")
            (src_dir / name).write_text(source.replace(text, repl))
        for kernel, (source, _) in ENTRIES.items():
            if kernel not in kernels or variant not in KERNEL_VARIANTS[kernel]:
                continue
            lib = src_dir / f"{kernel}.so"
            procs[(variant, kernel)] = (lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src_dir / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


class _Entry:
    """A library holding one kernel's entry, as ``_build.load()`` is used."""

    def __init__(self, lib, kernel):
        name = ENTRIES[kernel][1]
        fn = getattr(lib, name)
        p = ctypes.c_void_p
        if kernel == "K1":
            fn.argtypes = [p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [p]
        elif kernel == "K6":
            fn.argtypes = [p] * 5 + [ctypes.c_int] * 6 + [p]
        else:
            fn.argtypes = [p] * 8 + [ctypes.c_int] * 8 + [p] + (
                [p, p, ctypes.c_int, ctypes.c_int] if kernel == "K5" else [])
        fn.restype = ctypes.c_int
        setattr(self, name, fn)


def _stem_inputs(gen, batch, h, w, c, f, device):
    """A random bf16 frame, conv0 weight, folded norm0 and the packed weight
    (values do not matter: only times are read)."""
    x = torch.rand(batch, h, w, c, generator=gen).to(device, torch.bfloat16)
    w7 = (torch.randn(7, 7, c, f, generator=gen) * (2 / (49 * c)) ** 0.5).to(device)
    gamma = (torch.rand(f, generator=gen) + 0.5).to(device)
    beta = (torch.randn(f, generator=gen) * 0.5).to(device)
    return x, w7, gamma, beta, stem_pool.pack_stem_weights(w7)


def _fuse_inputs(gen, batch, h, w, k, cout, device):
    """Random bf16 streams of ``k / 2`` channels each, BN stats, a 1x1
    weight and K1's operands folded from them (values do not matter: only
    times are read)."""
    a = torch.randn(batch, h, w, k // 2, generator=gen).to(device, torch.bfloat16)
    b = torch.randn(batch, h, w, k // 2, generator=gen).to(device, torch.bfloat16)
    params = {"scale": torch.rand(k, generator=gen) + 0.5, "bias": torch.randn(k, generator=gen),
              "mean": torch.randn(k, generator=gen), "var": torch.rand(k, generator=gen) + 0.5,
              "weight": torch.randn(cout, k, generator=gen) * k ** -0.5}
    params = {name: t.to(device) for name, t in params.items()}
    operands = fused.fuse_operands(*params.values(), 1e-5, torch.bfloat16)
    return a, b, params, operands


def _inputs(gen, batch, h, w, c0, layers, device):
    """A random bf16 block input, its folded stacks and their packed
    weights (values do not matter: only times are read)."""
    k, growth = 128, 32
    c_max = c0 + layers * growth
    folded = {"g1": torch.rand(layers, c_max, generator=gen) + 0.5,
              "b1": torch.randn(layers, c_max, generator=gen) * 0.5,
              "w1": torch.randn(layers, c_max, k, generator=gen) * (2 / c_max) ** 0.5,
              "g2": torch.rand(layers, k, generator=gen) + 0.5,
              "b2": torch.randn(layers, k, generator=gen) * 0.5,
              "w3": torch.randn(layers, 3, 3, k, growth, generator=gen) * (2 / (9 * k)) ** 0.5}
    folded = {name: t.to(device) for name, t in folded.items()}
    x = torch.randn(batch, h, w, c0, generator=gen).to(device, torch.bfloat16)
    return x, folded, dense_block_strip.pack_layer_weights(folded)


def _times_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    times = []
    for _ in range(ITERS):
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("layer_body_parts: no CUDA device; this tool runs only on the GPU",
              file=sys.stderr)
        return 1
    kernels = sys.argv[1:] or list(ENTRIES)
    if any(k not in ENTRIES for k in kernels):
        print(f"layer_body_parts: kernels are {list(ENTRIES)}, got {kernels}", file=sys.stderr)
        return 2
    card = _card()
    libs = _build_variants(kernels)
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    run = {"K4": dense_block.dense_block,
           "K5": dense_block_strip.dense_block_strip_recompute,
           "K6": stem_pool.stem_pool,
           "K1": lambda a, b, params, operands: fused.concat_bn_relu_conv1x1(
               a, b, **params, operands=operands)}
    make_inputs = {"K4": _inputs, "K5": _inputs, "K6": _stem_inputs, "K1": _fuse_inputs}
    kept = _build._lib
    try:
        for kernel, block, batch, h, w, c0, layers in CASES:
            if kernel not in kernels:
                continue
            make = make_inputs[kernel]
            args = make(gen, batch, h, w, c0, layers, device)
            variants = KERNEL_VARIANTS[kernel]

            def call(variant):
                _build._lib = _Entry(libs[(variant, kernel)], kernel)
                return run[kernel](*args)

            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                times[v] += _times_ms(lambda: call(v))
            shape = {"K6": f"F={layers}", "K1": f"Cout={layers}"}.get(kernel, f"L={layers}")
            print(f"[{card}] {kernel} {block} ({batch}, {h}, {w}, {c0}) {shape} bf16: "
                  + "; ".join(f"{v} {sorted(t)[len(t) // 2]:.4f} ms" for v, t in times.items())
                  + f" (median of {2 * ITERS} iterations each, in turns)")
    finally:
        _build._lib = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
