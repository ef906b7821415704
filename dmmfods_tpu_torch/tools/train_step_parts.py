"""Where a train step's host time goes: the parts of the DenseNet-121
mid-fusion train step at 128x192 (bf16, b32 by default) timed apart on the
host and on the device, with the port's optimizer beside
``torch.optim.Adam(foreach=True)`` on the same parameters and gradients.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 -m dmmfods_tpu_torch.tools.train_step_parts [batch]

For each part (the train forward, forward + backward, the optimizer step,
torch's Adam step, the eval forward) it prints the host's median time to
enqueue it (wall clock from a synchronized start to the return of the call,
10 calls) and, from one call under ``torch.profiler``, its device
operations and device time, with the card's name and power limit. Without
CUDA it exits 1.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import trainer
from ..config import get_config
from ..models.dense_unet_lidar import densenet121_u_lidar

HEIGHT, WIDTH = 128, 192


def _host_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def _device(fn):
    """(device operations, device ms) of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("train_step_parts: no CUDA device", file=sys.stderr)
        return 1
    batch = int(argv[0]) if argv else 32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as host:
        config = get_config(host)
    bundle = densenet121_u_lidar(config=config, seed=0)
    module = bundle.module
    gen = torch.Generator().manual_seed(0)
    rgb = torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen).cuda()
    lidar = torch.rand(batch, HEIGHT, WIDTH, 1, generator=gen).cuda()
    heat = (torch.rand(batch, HEIGHT, WIDTH, 3, generator=gen) ** 4).cuda()
    optimizer = trainer.make_optimizer(config, module.parameters())
    state = trainer.create_train_state(bundle, optimizer)
    step = trainer.make_train_step(module, optimizer, config)
    for _ in range(3):
        step(state, rgb, lidar, heat)             # gradients and moments exist
    torch.cuda.synchronize()
    reference = torch.optim.Adam(module.parameters(), lr=config.optimizer.learning_rate,
                                 foreach=True)

    def forward():
        module.train()
        return module(rgb, lidar).float().sum()

    def forward_backward():
        forward().backward()

    def eval_forward():
        module.eval()
        with torch.no_grad():
            return module(rgb, lidar)

    print(f"[{card}] b{batch} bf16 {HEIGHT}x{WIDTH}, "
          f"{len(list(module.parameters()))} parameter tensors")
    for name, fn in (("train forward", forward), ("train forward + backward", forward_backward),
                     ("the port's optimizer step", optimizer.step),
                     ("torch.optim.Adam(foreach=True) step", reference.step),
                     ("eval forward", eval_forward),
                     ("the whole train step", lambda: step(state, rgb, lidar, heat))):
        host = _host_ms(fn)
        operations, device_ms = _device(fn)
        print(f"[{card}] {name}: host {host:.4f} ms (median of 10), {operations} device "
              f"operations, {device_ms:.4f} ms of device time")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
