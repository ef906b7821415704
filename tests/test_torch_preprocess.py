"""The port's preprocessing (``dmmfods_tpu_torch/ops/preprocess.py``) and its
host splat (``data/host_preprocess.py``, ``data/native_io.py``) against the
JAX package's, on the same seeded numpy inputs on the CPU, at 320x480 full
resolution (32x48 pooled).

Tolerances: equality for the rasterizers, the range images, the splat's
index path and the point heat maps; atol 1e-4 for binned and pooled LiDAR
values (``x * -6.2 + 255`` may be contracted to one FMA on one side);
rtol 1e-6 for ``downsize_image`` (the pool's sum may run in another order).
Cases: boxes of one class that overlap (the overwrite order), pedestrians of
odd sizes, padding rows, boxes and points past every edge, ``num_valid <
N``, and negative indices for the point heat maps; the batched forms at
B = 3."""

import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from dmmfods_tpu.data import host_preprocess as jax_host
from dmmfods_tpu.ops import preprocess as jp
from dmmfods_tpu_torch.data import host_preprocess, native_io
from dmmfods_tpu_torch.ops import preprocess as pp

H, W = 320, 480
POOL = 10
ATOL_BINNED = 1e-4

BOX_CASES = {
    "apart": [[1, 10, 10, 80, 60], [2, 200, 40, 45, 95], [4, 320, 150, 60, 70],
              [0, 0, 0, 0, 0], [2, 120, 200, 37, 83]],
    # one class overlapping: the later box wins inside its rectangle
    "overlap": [[2, 100, 100, 60, 120], [2, 130, 150, 41, 97], [1, 90, 95, 50, 50],
                [1, 110, 105, 70, 40], [4, 300, 200, 80, 80], [4, 305, 205, 23, 17],
                [2, 95, 90, 33, 51]],
    # odd pedestrian sizes, below 5 and 4 too, and padding between boxes
    "odd": [[2, 11, 13, 7, 9], [0, 5, 5, 50, 50], [2, 40, 60, 3, 4], [2, 201, 77, 29, 131],
            [3, 20, 20, 40, 40], [2, 77, 150, 1, 1], [0, 0, 0, 0, 0]],
    # past every edge, empty and negative sizes
    "edges": [[1, -30, -20, 60, 50], [2, 450, 290, 60, 70], [4, -5, 300, 40, 40],
              [2, 470, -9, 31, 43], [1, 200, 100, 0, 30], [2, 250, 150, -3, 12],
              [4, 600, 400, 20, 20]],
}


def _boxes(case):
    return np.asarray(BOX_CASES[case], np.int32)


def _points(rng, n, h=H, w=W, margin=20):
    """Points over the frame and ``margin`` past every edge, distances past
    the 75 m clip."""
    return np.stack([rng.uniform(-margin, w + margin, n), rng.uniform(-margin, h + margin, n),
                     rng.uniform(0.5, 90.0, n)], axis=-1).astype(np.float32)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# rasterizers
# ---------------------------------------------------------------------------


def test_pedestrian_template_and_window_max():
    rng = np.random.default_rng(0)
    n = 4000
    h, w = rng.integers(1, 60, n), rng.integers(1, 60, n)
    r, c = rng.integers(-3, 64, n), rng.integers(-3, 64, n)
    want = _np(jp._pedestrian_template_value(r, c, h, w))
    got = pp._pedestrian_template_value(*(torch.from_numpy(a) for a in (r, c, h, w)))
    np.testing.assert_array_equal(got.numpy(), want)
    r0, c0 = rng.integers(0, 40, n), rng.integers(0, 40, n)
    r1, c1 = r0 + rng.integers(0, 20, n), c0 + rng.integers(0, 20, n)
    want = _np(jp._pedestrian_window_max(r0, r1, c0, c1, h, w))
    got = pp._pedestrian_window_max(*(torch.from_numpy(a) for a in (r0, r1, c0, c1, h, w)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_rasterize_heatmaps(case):
    boxes = _boxes(case)
    want = _np(jp.rasterize_heatmaps(boxes, H, W))
    got = pp.rasterize_heatmaps(boxes, H, W)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_rasterize_heatmaps_pooled_and_direct(case):
    boxes = _boxes(case)
    np.testing.assert_array_equal(pp.rasterize_heatmaps_pooled(boxes, H, W, POOL).numpy(),
                                  _np(jp.rasterize_heatmaps_pooled(boxes, H, W, POOL)))
    np.testing.assert_array_equal(
        pp.rasterize_heatmaps_direct(boxes, H // POOL, W // POOL, POOL).numpy(),
        _np(jp.rasterize_heatmaps_direct(boxes, H // POOL, W // POOL, POOL)))


def test_rasterizers_with_other_class_counts_and_no_boxes():
    boxes = _boxes("overlap")
    for num_classes in (2, 4):
        np.testing.assert_array_equal(
            pp.rasterize_heatmaps(boxes, 64, 96, num_classes=num_classes).numpy(),
            _np(jp.rasterize_heatmaps(boxes, 64, 96, num_classes=num_classes)))
        np.testing.assert_array_equal(
            pp.rasterize_heatmaps_direct(boxes, 16, 24, 10, num_classes=num_classes).numpy(),
            _np(jp.rasterize_heatmaps_direct(boxes, 16, 24, 10, num_classes=num_classes)))
    empty = np.zeros((0, 5), np.int32)
    assert not pp.rasterize_heatmaps_direct(empty, 8, 12, 10).any()


@pytest.mark.parametrize("window,stride", [(10, None), ((20, 10), (10, 10)), (3, 2)])
def test_pools(window, stride):
    x = np.random.default_rng(1).normal(size=(2, 41, 67, 3)).astype(np.float32)
    want_max = np.stack([_np(jp.maxpool2d(s, window, stride)) for s in x])
    want_avg = np.stack([_np(jp.avgpool2d(s, window, stride)) for s in x])
    np.testing.assert_array_equal(pp.maxpool2d(torch.from_numpy(x), window, stride).numpy(),
                                  want_max)
    np.testing.assert_allclose(pp.avgpool2d(torch.from_numpy(x), window, stride).numpy(),
                               want_avg, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pp.maxpool2d(x[0], window, stride).numpy(), want_max[0])


def test_downsize_image():
    img = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    got = pp.downsize_image(torch.from_numpy(img))
    assert got.shape == (H // 10, W // 10, 3)
    np.testing.assert_allclose(got.numpy(), _np(jp.downsize_image(img)), rtol=1e-6)


def test_boxes_to_point_heatmaps_negative_and_dropped_indices():
    """JAX wraps a negative index once and drops what is still out of range:
    ``[0, -1, 2]`` sets column 5 of row 2 on a 4x6 map; rows 7 and 9 drop."""
    bbs = np.array([[0, -1, 2], [1, 3, 7], [2, 1, 9], [0, 2, -5], [1, -7, 1], [5, 1, 1],
                    [-1, 0, 0], [-4, 0, 0], [1, 2, 3], [1, 2, 3], [2, -6, -4]], np.int32)
    want = _np(jp.boxes_to_point_heatmaps(bbs, (4, 6, 3)))
    got = pp.boxes_to_point_heatmaps(bbs, (4, 6, 3))
    assert got[2, 5, 0] == 1
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(4)
    bbs = np.stack([rng.integers(-4, 5, 200), rng.integers(-40, 60, 200),
                    rng.integers(-30, 45, 200)], axis=-1)
    np.testing.assert_array_equal(pp.boxes_to_point_heatmaps(bbs, (32, 48, 3)).numpy(),
                                  _np(jp.boxes_to_point_heatmaps(bbs, (32, 48, 3))))


# ---------------------------------------------------------------------------
# LiDAR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["last", "nearest"])
def test_range_image(mode):
    """Points past every edge, repeated pixels (the overwrite order) and a
    padding tail (``num_valid < N``)."""
    rng = np.random.default_rng(5)
    pts = _points(rng, 3000)
    pts[2000:2100, :2] = pts[:100, :2]          # the same pixels, later rows
    got = pp.lidar_points_to_range_image(torch.from_numpy(pts), 2500, H, W, mode=mode)
    want = _np(jp.lidar_points_to_range_image(pts, 2500, H, W, mode=mode))
    assert got.shape == (H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[-1] == -1).all() and (got[:, -1] == -1).all()


def test_bin_lidar_range():
    x = np.array([0.0, 0.5, 24.99, 25.0, 25.01, 50.0, 74.9, 75.0, 76.5, 100.0, -1.0],
                 np.float32)
    x = np.concatenate([x, np.random.default_rng(6).uniform(-1, 90, 1000).astype(np.float32)])
    np.testing.assert_allclose(pp.bin_lidar_range(torch.from_numpy(x)).numpy(),
                               _np(jp.bin_lidar_range(x)), rtol=0, atol=ATOL_BINNED)


def test_pool_lidar_image():
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 80, (H, W)).astype(np.float32)
    img[rng.random((H, W)) < 0.6] = -1.0
    want = _np(jp.pool_lidar_image(img))
    for x in (img, img[:, :, None]):
        got = pp.pool_lidar_image(torch.from_numpy(x))
        assert got.shape == (H // 10, W // 10, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_BINNED)


@pytest.mark.parametrize("mode", ["last", "nearest", "nearest_pooled"])
def test_lidar_points_to_model_input(mode):
    rng = np.random.default_rng(8)
    pts = _points(rng, 2000)
    got = pp.lidar_points_to_model_input(torch.from_numpy(pts), 1700, H, W, mode=mode)
    want = _np(jp.lidar_points_to_model_input(pts, 1700, H, W, mode=mode))
    assert got.shape == (H // 10, W // 10, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_BINNED)


def test_nearest_pooled_equals_the_nearest_pipeline():
    """The direct-to-pooled path equals pool(bin(splat(mode='nearest')))."""
    pts = _points(np.random.default_rng(9), 3000, margin=3)
    ref = pp.pool_lidar_image(pp.lidar_points_to_range_image(pts, 2500, H, W, mode="nearest"))
    np.testing.assert_array_equal(
        pp.lidar_points_to_model_input_pooled(pts, 2500, H, W).numpy(), ref.numpy())


# ---------------------------------------------------------------------------
# batched forms
# ---------------------------------------------------------------------------


def _ragged_points(rng, batch=3, n=1500):
    pts = np.stack([_points(rng, n) for _ in range(batch)])
    return pts, np.array([n, 700, 0][:batch], np.int32)


@pytest.mark.parametrize("form", ["rasterize_heatmaps_batch", "rasterize_heatmaps_direct",
                                  "last", "nearest", "nearest_pooled", "range_image_last",
                                  "range_image_nearest"])
def test_batched_forms_match_jax_vmap(form):
    rng = np.random.default_rng(10)
    boxes = np.stack([_boxes(c)[:5] for c in ("apart", "overlap", "edges")])
    pts, num_valid = _ragged_points(rng)
    if form == "rasterize_heatmaps_batch":
        want = jax.vmap(lambda b: jp.rasterize_heatmaps_pooled(b, H, W, POOL))(boxes)
        got = pp.rasterize_heatmaps_batch(boxes, H, W, POOL)
    elif form == "rasterize_heatmaps_direct":
        want = jax.vmap(lambda b: jp.rasterize_heatmaps_direct(b, H // POOL, W // POOL, POOL))(
            boxes)
        got = pp.rasterize_heatmaps_direct(torch.from_numpy(boxes), H // POOL, W // POOL, POOL)
    elif form.startswith("range_image_"):
        mode = form[len("range_image_"):]
        want = jax.vmap(lambda p, n: jp.lidar_points_to_range_image(p, n, H, W, mode=mode))(
            pts, num_valid)
        got = pp.lidar_points_to_range_image(pts, num_valid, H, W, mode=mode)
    else:
        want = jax.vmap(lambda p, n: jp.lidar_points_to_model_input(p, n, H, W, mode=form))(
            pts, num_valid)
        got = pp.lidar_batch_to_model_input(torch.from_numpy(pts), torch.from_numpy(num_valid),
                                            H, W, mode=form)
        assert got.shape == (3, H // 10, W // 10, 1)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL_BINNED)
        return
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got.numpy(), _np(want))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fn", ["rasterize", "splat"])
def test_batched_step_preprocessing_has_a_fixed_op_count(fn):
    """The two functions the raw-record steps run enqueue the same number of
    operations at (B 2, 4 boxes, 100 points) as at (B 5, 64 boxes, 3000)."""
    rng = np.random.default_rng(11)
    counts = []
    for batch, m, n in ((2, 4, 100), (5, 64, 3000)):
        boxes = torch.from_numpy(np.stack([
            np.concatenate([_boxes("overlap")] * 10)[:m] for _ in range(batch)]))
        pts = torch.from_numpy(np.stack([_points(rng, n) for _ in range(batch)]))
        num_valid = torch.full((batch,), n // 2)
        with _CountOps() as mode:
            if fn == "rasterize":
                pp.rasterize_heatmaps_direct(boxes, H // POOL, W // POOL, POOL)
            else:
                pp.lidar_points_to_model_input_pooled(pts, num_valid, H, W)
        counts.append(mode.ops)
    assert counts[0] == counts[1] and counts[0] < 200, counts


@pytest.mark.slow
def test_full_resolution_rasterizer():
    """At 1280x1920: the full-resolution rasterizer and its pooled form."""
    rng = np.random.default_rng(12)
    boxes = np.zeros((16, 5), np.int32)
    for i in range(12):
        w, h = int(rng.integers(20, 480)), int(rng.integers(20, 320))
        boxes[i] = [rng.choice([1, 2, 4]), rng.integers(0, 1920 - w), rng.integers(0, 1280 - h),
                    w, h]
    np.testing.assert_array_equal(pp.rasterize_heatmaps(boxes).numpy(),
                                  _np(jp.rasterize_heatmaps(boxes)))
    np.testing.assert_array_equal(pp.rasterize_heatmaps_direct(boxes).numpy(),
                                  _np(jp.rasterize_heatmaps_direct(boxes)))


# ---------------------------------------------------------------------------
# the host splat
# ---------------------------------------------------------------------------


def _ragged_batch():
    """Three samples of 500, 0 and 37 points over a 160x120 frame and past
    its edges (the JAX test's batch), concatenated, with their offsets and
    each padded to 600 rows."""
    h, w = 160, 120
    rng = np.random.default_rng(7)
    counts = [500, 0, 37]
    pts = [_points(rng, n, h, w, margin=15) for n in counts]
    padded = np.zeros((3, 600, 3), np.float32)
    for i, p in enumerate(pts):
        padded[i, :len(p)] = p
    return (h, w), np.concatenate(pts), np.cumsum([0] + counts), padded, counts


def test_host_splat_numpy_matches_device_path_and_jax():
    (h, w), concat, offsets, padded, counts = _ragged_batch()
    got = host_preprocess._splat_pooled_batch_numpy(concat, offsets, h, w)
    device = pp.lidar_points_to_model_input_pooled(torch.from_numpy(padded),
                                                   torch.tensor(counts), h, w)
    np.testing.assert_allclose(got, device.numpy(), rtol=0, atol=ATOL_BINNED)
    np.testing.assert_array_equal(
        got, jax_host._splat_pooled_batch_numpy(concat, offsets, h, w))
    np.testing.assert_array_equal(got, jax_host.splat_pooled_batch(concat, offsets, h, w))


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent")
def test_host_splat_native_matches_numpy_and_jax():
    (h, w), concat, offsets, padded, counts = _ragged_batch()
    assert native_io.available(), native_io.build_error
    assert native_io.library_path().is_file()
    assert native_io.library_path().parent.parent == native_io.BUILD_DIR
    got = host_preprocess.splat_pooled_batch(concat, offsets, h, w, num_threads=2)
    np.testing.assert_array_equal(
        got, host_preprocess._splat_pooled_batch_numpy(concat, offsets, h, w))
    np.testing.assert_array_equal(got, jax_host.splat_pooled_batch(concat, offsets, h, w))
    device = pp.lidar_points_to_model_input_pooled(torch.from_numpy(padded),
                                                   torch.tensor(counts), h, w)
    np.testing.assert_allclose(got, device.numpy(), rtol=0, atol=ATOL_BINNED)
    np.testing.assert_array_equal(native_io.splat_pooled(concat[:500], h, w), got[0])


def test_host_splat_takes_numpy_without_the_library(monkeypatch):
    (h, w), concat, offsets, _, _ = _ragged_batch()
    monkeypatch.setattr(native_io, "available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("the native splat ran without the library")

    monkeypatch.setattr(native_io, "splat_pooled_batch", refuse)
    got = host_preprocess.splat_pooled_batch(concat, offsets, h, w)
    np.testing.assert_array_equal(
        got, host_preprocess._splat_pooled_batch_numpy(concat, offsets, h, w))


@pytest.mark.parametrize("points,offsets", [
    (np.zeros((4, 2), np.float32), [0, 4]),            # not (n, 3)
    (np.zeros((4, 3), np.float32), [0, 5]),            # past the points
    (np.zeros((4, 3), np.float32), [0, 3, 2]),         # falling
    (np.zeros((4, 3), np.float32), [-1, 4]),
])
def test_native_splat_rejects_malformed_buffers(points, offsets):
    """Checked before any pointer reaches the C++ runtime."""
    with pytest.raises(ValueError):
        native_io.splat_pooled_batch(points, offsets, 160, 120)
