"""Everything a run feeds both sides, made from ``--seed``: the frames and
the requests here, and the streams of the seed that the model family's
``make_state_dict`` draws the weights from. Frames (and weights) are made
on the run's device by a ``torch.Generator`` there, in a few large calls;
the requests on the host by numpy. The same seed gives the same inputs on
the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

# sub-streams of one seed
WEIGHTS, FRAMES, REQUESTS, SAMPLE = 0, 1, 3, 4


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of ``seed``; any whole number is taken."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


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
