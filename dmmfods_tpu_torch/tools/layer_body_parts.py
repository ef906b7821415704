"""What holds the tensor-core kernels back: K4 (b256, the DenseNet-121
blocks at 128x192) and K5 (the two 1280x1920 blocks) in bf16, timed in turns
against copies of their sources with one part of the tensor-core layer body
(``csrc/dense_layer_mma.cuh``) or of K5's schedule removed; and K6 (the
fused stem + pool0 at 1280x1920, 3 and 1 channels) against copies of
``csrc/stem_pool.cu`` with one part of its bf16 body removed. A copy
computes wrong numbers; only its time is read.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 -m dmmfods_tpu_torch.tools.layer_body_parts

It builds every copy with nvcc, all at once, each source into its own
library under ``dmmfods_tpu_torch/_build/parts/``, then prints for each
shape each variant's median ms by CUDA events (10 iterations in order, then
10 in reverse), with the card's name and power limit. Without CUDA it exits
1.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from ..ops import _build, dense_block, dense_block_strip, stem_pool

MMA = "dense_layer_mma.cuh"
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
}
# the variants that apply to each kernel
KERNEL_VARIANTS = {"K4": ("base", "no BN1 pass", "no 1x1 MMAs", "no 3x3 MMAs"),
                   "K5": ("base", "no BN1 pass", "no 1x1 MMAs", "no 3x3 MMAs",
                          "no strip barrier"),
                   "K6": ("base", "no window loads", "no im2col build", "no MMAs", "no pool")}
# K4, K5: (kernel, block, batch, h, w, c0, layers), growth 32 and K 128; K6:
# (kernel, stem, batch, h, w, channels, features)
CASES = (("K4", "block1", 256, 32, 48, 64, 6), ("K4", "block2", 256, 16, 24, 128, 12),
         ("K4", "block3", 256, 8, 12, 256, 24), ("K4", "block4", 256, 4, 6, 512, 16),
         ("K5", "block1", 1, 320, 480, 64, 6), ("K5", "block2", 1, 160, 240, 128, 12),
         ("K6", "RGB stem", 1, 1280, 1920, 3, 64), ("K6", "LiDAR stem", 1, 1280, 1920, 1, 64))
ENTRIES = {"K4": ("dense_block.cu", "dmm_dense_block"),
           "K5": (K5_SOURCE, "dmm_dense_block_recompute"),
           "K6": (K6_SOURCE, "dmm_stem_pool")}
ITERS = 10


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _build_variants():
    """{(variant, kernel): ctypes library} for every variant of every
    kernel's source; raises if a build fails."""
    nvcc = _build._nvcc()
    procs = {}
    for variant, edits in VARIANTS.items():
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
            if variant not in KERNEL_VARIANTS[kernel]:
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
        if kernel == "K6":
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
    card = _card()
    libs = _build_variants()
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    run = {"K4": dense_block.dense_block,
           "K5": dense_block_strip.dense_block_strip_recompute,
           "K6": stem_pool.stem_pool}
    kept = _build._lib
    try:
        for kernel, block, batch, h, w, c0, layers in CASES:
            make = _stem_inputs if kernel == "K6" else _inputs
            args = make(gen, batch, h, w, c0, layers, device)
            variants = KERNEL_VARIANTS[kernel]

            def call(variant):
                _build._lib = _Entry(libs[(variant, kernel)], kernel)
                return run[kernel](*args)

            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                times[v] += _times_ms(lambda: call(v))
            shape = f"L={layers}" if kernel != "K6" else f"F={layers}"
            print(f"[{card}] {kernel} {block} ({batch}, {h}, {w}, {c0}) {shape} bf16: "
                  + "; ".join(f"{v} {sorted(t)[len(t) // 2]:.4f} ms" for v, t in times.items())
                  + f" (median of {2 * ITERS} iterations each, in turns)")
    finally:
        _build._lib = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
