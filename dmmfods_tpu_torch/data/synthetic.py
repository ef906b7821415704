"""Synthetic Waymo-like data for tests and benchmarks: the port of
``dmmfods_tpu/data/synthetic.py``.

Random boxes rasterized into heat maps, random LiDAR points splatted and
pooled, and noise images, so that the train, eval and bench paths run the
real preprocessing and model code without the Waymo Open Dataset. The numpy
draws are JAX's, in the same order, so one seed gives the same arrays in
both packages; the preprocessing runs through the port's
``ops/preprocess.py`` on the CPU. Everything is returned as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import preprocess as pp


def random_boxes(rng, max_boxes=16, height=1280, width=1920):
    """Padded int32 ``(max_boxes, 5)`` box buffer ``[type, x, y, w, h]``."""
    n = int(rng.integers(1, max_boxes + 1))
    boxes = np.zeros((max_boxes, 5), np.int32)
    for i in range(n):
        btype = int(rng.choice([1, 1, 1, 2, 4]))  # vehicle-heavy like Waymo
        w = int(rng.integers(20, width // 4))
        h = int(rng.integers(20, height // 4))
        boxes[i] = [btype, int(rng.integers(0, width - w)), int(rng.integers(0, height - h)),
                    w, h]
    return boxes


def random_points(rng, num_points=4096, height=1280, width=1920):
    """Padded float32 ``(num_points, 3)`` ``[x, y, d]`` buffer and its valid
    count."""
    n = int(rng.integers(num_points // 2, num_points))
    pts = np.zeros((num_points, 3), np.float32)
    pts[:n, 0] = rng.uniform(0, width, n)
    pts[:n, 1] = rng.uniform(0, height, n)
    pts[:n, 2] = rng.uniform(0.5, 80.0, n)
    return pts, n


def make_batch(batch_size=4, h=128, w=192, seed=0, *, full_res=False):
    """A model-input batch ``(image, lidar, ht_map)``, NHWC float32: boxes
    and points drawn at 10x the resolution and run through the pooled
    rasterizer and the ``nearest`` LiDAR path to ``(h, w)``."""
    rng = np.random.default_rng(seed)
    full_h, full_w = h * 10, w * 10
    images = rng.normal(0.45, 0.25, (batch_size, h, w, 3)).astype(np.float32)

    lidars, ht_maps = [], []
    for _ in range(batch_size):
        boxes = random_boxes(rng, height=full_h, width=full_w)
        ht_maps.append(pp.rasterize_heatmaps_pooled(boxes, full_h, full_w, 10).numpy())
        pts, n = random_points(rng, height=full_h, width=full_w)
        lidars.append(pp.lidar_points_to_model_input(
            torch.from_numpy(pts), n, full_h, full_w, mode="nearest").numpy())
    return images, np.stack(lidars), np.stack(ht_maps)


def make_raw_batch(batch_size=4, h=128, w=192, seed=0, *, splat="host",
                   max_points=4096, max_boxes=16, splat_threads=1):
    """A raw-record batch. ``splat='host'`` returns ``(image, lidar, boxes)``
    with the LiDAR splat done on the host (``data/host_preprocess.py``), for
    ``trainer.make_train_step_ht``; ``splat='device'`` returns ``(image,
    points, num_valid, boxes)``, for ``trainer.make_train_step_raw``."""
    rng = np.random.default_rng(seed)
    full_h, full_w = h * 10, w * 10
    images = rng.normal(0.45, 0.25, (batch_size, h, w, 3)).astype(np.float32)
    boxes = np.stack([random_boxes(rng, max_boxes, height=full_h, width=full_w)
                      for _ in range(batch_size)])
    pts_list, counts = [], []
    for _ in range(batch_size):
        pts, n = random_points(rng, max_points, height=full_h, width=full_w)
        pts_list.append(pts)
        counts.append(n)
    if splat == "device":
        return images, np.stack(pts_list), np.asarray(counts, np.int32), boxes
    from . import host_preprocess

    concat = np.concatenate([p[:n] for p, n in zip(pts_list, counts)], axis=0)
    offsets = np.cumsum([0] + counts)
    lidar = host_preprocess.splat_pooled_batch(concat, offsets, full_h, full_w,
                                               splat_threads)
    return images, lidar, boxes


class SyntheticRawDataset:
    """Batched raw-record dataset (the ``WaymoDataset`` raw-mode interface)."""

    data_is_batched = True

    def __init__(self, num_batches=2, batch_size=2, h=128, w=192, seed=0,
                 splat="host", max_points=4096):
        self._batches = [
            make_raw_batch(batch_size, h, w, seed + i, splat=splat, max_points=max_points)
            for i in range(num_batches)
        ]

    def __len__(self):
        return len(self._batches)

    def __getitem__(self, idx):
        return self._batches[idx]


class SyntheticDataset:
    """Dataset with the ``WaymoDataset`` batched interface."""

    data_is_batched = True

    def __init__(self, num_batches=4, batch_size=8, h=128, w=192, seed=0):
        self._batches = [make_batch(batch_size, h, w, seed + i) for i in range(num_batches)]

    def __len__(self):
        return len(self._batches)

    def __getitem__(self, idx):
        return self._batches[idx]
