"""Everything a run feeds both sides, made from ``--seed``: the weights as
one ``state_dict``, the frames, and the requests. Weights and frames are
made on the run's device by a ``torch.Generator`` there, in a few large
calls; the requests on the host by numpy. The same seed gives the same
inputs on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import ReferenceNet, kaiming_std

# sub-streams of one seed
WEIGHTS, FRAMES, REQUESTS, SAMPLE = 0, 1, 3, 4


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of ``seed``; any whole number is taken."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def make_state_dict(arch, seed, device):
    """Seeded weights under the network's module names, on ``device``, f32:
    every conv kaiming-normal over its fan-in, and every BN with a weight in
    [0.75, 1.25], a bias and a running mean in [-0.1, 0.1], a running
    variance in [0.75, 1.25] (so that folding them is work the comparison
    sees). Two random calls: one normal draw for all conv weights, one
    uniform draw for all BN entries."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in
              ReferenceNet(arch).to("meta").state_dict().items()}
    conv_keys = [k for k, (s, _) in shapes.items() if len(s) == 4]
    bn_names = sorted({k.rsplit(".", 1)[0] for k, (s, _) in shapes.items()
                       if k.endswith("running_var")})
    gen = generator(seed, WEIGHTS, device)
    sizes = [math.prod(shapes[k][0]) for k in conv_keys]
    stds = torch.tensor([kaiming_std(shapes[k][0], ".Transposed_Convolution_" in k)
                         for k in conv_keys], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(stds, torch.tensor(sizes, device=device))
    out = {k: t.view(shapes[k][0]) for k, t in zip(conv_keys, flat.split(sizes))}
    widths = [shapes[f"{n}.weight"][0][0] for n in bn_names]
    u = torch.rand(4, sum(widths), generator=gen, device=device)
    u[0].mul_(0.5).add_(0.75)      # weight
    u[1].sub_(0.5).mul_(0.2)       # bias
    u[2].sub_(0.5).mul_(0.2)       # running mean
    u[3].mul_(0.5).add_(0.75)      # running var
    for n, parts in zip(bn_names, u.split(widths, dim=1)):
        for j, field in enumerate(("weight", "bias", "running_mean", "running_var")):
            out[f"{n}.{field}"] = parts[j]
        out[f"{n}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise RuntimeError(f"weights left unmade: {sorted(missing)[:5]}")
    return out


def make_frames(seed, n, h, w, device, stream=FRAMES):
    """``n`` frames ``(rgb (n, h, w, 3), lidar (n, h, w, 1))``, f32 on
    ``device``: RGB in [0, 1]; LiDAR a sparse depth image (8% of pixels hit,
    depth in (0, 1], the rest 0)."""
    gen = generator(seed, stream, device)
    rgb = torch.rand(n, h, w, 3, generator=gen, device=device)
    hits = torch.rand(n, h, w, 2, generator=gen, device=device)
    lidar = torch.where(hits[..., :1] < 0.08, 1.0 - hits[..., 1:], 0.0)
    return rgb, lidar


class Requests:
    """A closed loop's requests, drawn from the seed as they are sent:
    request ``i``'s size takes the sizes in turn, each round of them in an
    order of its own (so every seed sends the same sizes in equal shares),
    and its frames start at a seeded offset in a pool of ``pool`` frames.
    The check keeps the first request of the largest size and ``keep`` of
    the others, each equally likely (a reservoir sample, drawn from the
    seed): :meth:`held`."""

    def __init__(self, seed, sizes, pool, keep):
        self.sizes, self.pool, self.keep = [int(k) for k in sizes], int(pool), int(keep)
        self.rng = np.random.default_rng(sub_seed(seed, REQUESTS))
        self.sample_rng = np.random.default_rng(sub_seed(seed, SAMPLE))
        self.round, self.n, self.seen = [], 0, 0
        self.longest, self.slots = None, []

    def next(self):
        """``(index, offset, size, dropped)``: the next request, and the
        request it put out of the sample (``None`` if none)."""
        if not self.round:
            self.round = [int(k) for k in self.rng.permutation(self.sizes)]
        k = self.round.pop()
        o = int(self.rng.integers(0, self.pool - k + 1))
        i, dropped = self.n, None
        self.n += 1
        if self.longest is None and k == max(self.sizes):
            self.longest = i
        elif len(self.slots) < self.keep:
            self.seen += 1
            self.slots.append(i)
        else:
            self.seen += 1
            j = int(self.sample_rng.integers(0, self.seen))
            if j < self.keep:
                dropped, self.slots[j] = self.slots[j], i
        return i, o, k, dropped

    def held(self):
        return set(self.slots) | ({self.longest} if self.longest is not None else set())


def pick(seed, n, k, must=()):
    """``k`` distinct indices of ``range(n)`` drawn from the seed, sorted,
    with ``must`` among them."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE))
    must = sorted(set(int(i) for i in must))
    rest = np.setdiff1d(np.arange(n), must)
    k_rest = max(0, min(k - len(must), rest.size))
    return sorted(must + [int(i) for i in rng.choice(rest, k_rest, replace=False)])
