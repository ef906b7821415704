"""The port's synthetic data (``dmmfods_tpu_torch/data/synthetic.py``)
against the JAX package's for the same seed, on the CPU at b2, 32x48 (320x480
full resolution) with 1,024 points a frame: the same numpy draws give equal
images, boxes, points and counts, the rasterized heat maps are equal, and the
binned LiDAR maps agree within atol 1e-4 (the binning's ``x * -6.2 + 255``
may be one FMA on one side)."""

import numpy as np
import pytest

from dmmfods_tpu.data import synthetic as jax_synthetic
from dmmfods_tpu_torch.data import synthetic

BATCH, H, W, POINTS = 2, 32, 48, 1024
ATOL_BINNED = 1e-4


def _assert_batches_equal(got, want, lidar_at):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, i
        if i == lidar_at:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_BINNED)
        else:
            np.testing.assert_array_equal(g, w)


def test_random_boxes_and_points():
    for fn, kwargs in ((synthetic.random_boxes, dict(max_boxes=8, height=320, width=480)),
                       (synthetic.random_points, dict(num_points=POINTS, height=320, width=480))):
        got = fn(np.random.default_rng(3), **kwargs)
        want = getattr(jax_synthetic, fn.__name__)(np.random.default_rng(3), **kwargs)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


def test_make_batch():
    got = synthetic.make_batch(BATCH, H, W, seed=4)
    _assert_batches_equal(got, jax_synthetic.make_batch(BATCH, H, W, seed=4), lidar_at=1)
    assert got[1].shape == (BATCH, H, W, 1) and got[2].shape == (BATCH, H, W, 3)


@pytest.mark.parametrize("splat", ["host", "device"])
def test_make_raw_batch(splat):
    kwargs = dict(seed=5, splat=splat, max_points=POINTS, max_boxes=8)
    got = synthetic.make_raw_batch(BATCH, H, W, **kwargs)
    want = jax_synthetic.make_raw_batch(BATCH, H, W, **kwargs)
    _assert_batches_equal(got, want, lidar_at=1 if splat == "host" else None)
    assert len(got) == (3 if splat == "host" else 4)


@pytest.mark.parametrize("splat", ["host", "device"])
def test_raw_dataset(splat):
    got = synthetic.SyntheticRawDataset(2, BATCH, H, W, seed=6, splat=splat, max_points=POINTS)
    want = jax_synthetic.SyntheticRawDataset(2, BATCH, H, W, seed=6, splat=splat,
                                             max_points=POINTS)
    assert got.data_is_batched and len(got) == len(want) == 2
    for i in range(2):
        _assert_batches_equal(got[i], want[i], lidar_at=1 if splat == "host" else None)


def test_dataset():
    got = synthetic.SyntheticDataset(2, BATCH, H, W, seed=7)
    want = jax_synthetic.SyntheticDataset(2, BATCH, H, W, seed=7)
    assert got.data_is_batched and len(got) == len(want) == 2
    for i in range(2):
        _assert_batches_equal(got[i], want[i], lidar_at=1)
