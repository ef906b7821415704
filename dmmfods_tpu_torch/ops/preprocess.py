"""Raw-record preprocessing on the device: the port of
``dmmfods_tpu/ops/preprocess.py``.

The reference's offline ETL loops over samples in Python; the JAX package
writes each step as a fixed-shape array program, and so does this module,
in stock PyTorch (none of it is a TPU kernel: XLA ran all of it):

* boxes -> class heat maps (:func:`rasterize_heatmaps`, with the pedestrian
  silhouette prior; pooled, :func:`rasterize_heatmaps_pooled`; straight onto
  the pooled grid, :func:`rasterize_heatmaps_direct`),
* LiDAR points -> a range image (:func:`lidar_points_to_range_image`), binned
  and pooled to the model's input (:func:`pool_lidar_image`), or straight to
  the pooled grid (:func:`lidar_points_to_model_input_pooled`),
* the 10x pools (:func:`downsize_image`) and point heat maps
  (:func:`boxes_to_point_heatmaps`).

Layout is channel-last, ``(H, W, C)``, as in JAX. Boxes are int32 ``(M, 5)``
rows ``[type, x, y, w, h]`` (type 0 pads); points are f32 ``(N, 3)`` rows
``[x, y, distance]`` with ``num_valid`` valid rows. Every box and point
function also takes a leading batch axis (``(B, M, 5)``; ``(B, N, 3)`` with
``num_valid`` of shape ``(B,)``) and returns the batched result: what JAX
gets from ``jax.vmap``. The work is vectorized over boxes and points, so a
call enqueues a fixed number of device operations whatever the batch, box
or point count: the raw-record train steps run these inside the step.

Inputs may be numpy arrays (taken as CPU tensors) or tensors; results are
tensors on the input's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Waymo label types (reference helper.py:162-168)
TYPE_VEHICLE = 1
TYPE_PEDESTRIAN = 2
TYPE_CYCLIST = 4

# class -> heat-map channel remap {1, 2, 4} -> {0, 1, 2} (reference helper.py:301)
_CLASS_TO_CHANNEL = {TYPE_VEHICLE: 0, TYPE_PEDESTRIAN: 1, TYPE_CYCLIST: 2}
_CHANNEL_TO_CLASS = {c: t for t, c in _CLASS_TO_CHANNEL.items()}

LIDAR_MAX_RANGE = 75.0


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------------
# Ground-truth heat-map rasterization
# ---------------------------------------------------------------------------


def _pedestrian_template_value(row_rel, col_rel, height, width):
    """Silhouette-prior value at box-relative integer coords: a box of ones
    with

      rows [0, h//5)  x cols [0, w//4) and [3*w//4, w): 0.3   (head corners)
      rows [3*h//5,h) x cols [0, w//4) and [3*w//4, w): 0.5   (leg corners)
      rows [3*h//5,h) x cols [w//4, 3*w//4):            0.75  (legs)

    (reference helper.py:233-252). Tensors broadcast."""
    hf = _floordiv(height, 5)
    wf = _floordiv(width, 4)
    top = row_rel < hf
    bottom = row_rel >= 3 * hf
    side = (col_rel < wf) | (col_rel >= 3 * wf)
    value = torch.ones(top.shape, dtype=torch.float32, device=top.device)
    value = torch.where(top & side, 0.3, value)
    value = torch.where(bottom & side, 0.5, value)
    return torch.where(bottom & ~side, 0.75, value)


def _pedestrian_window_max(r0, r1, c0, c1, h, w):
    """Max of the pedestrian template over the box-relative region
    ``[r0, r1) x [c0, c1)``, in closed form (no full-resolution raster)."""
    hf = _floordiv(h, 5)
    wf = _floordiv(w, 4)
    top = r0 < hf
    mid = (r1 > hf) & (r0 < 3 * hf)
    bot = r1 > 3 * hf
    center = (c1 > wf) & (c0 < 3 * wf)
    side = (c0 < wf) | (c1 > 3 * wf)
    # products with Python numbers, not torch.where with them: on the card
    # each such where makes a device tensor of its number, one launch more
    val = torch.maximum((top & side) * 0.3, (bot & side) * 0.5)
    val = torch.maximum(val, (bot & center) * 0.75)
    return torch.maximum(val, (mid | (top & center)).float())


def _as_boxes(boxes):
    boxes = torch.as_tensor(boxes, dtype=torch.int32)
    if boxes.dim() < 2 or boxes.shape[-1] != 5:
        raise ValueError(f"boxes must be (..., M, 5), got {tuple(boxes.shape)}")
    return boxes


def _rasterize(boxes, height, width, pool, num_classes, fill):
    """The heat maps of ``boxes`` ``(..., M, 5)`` on a ``height`` x ``width``
    grid of ``pool`` x ``pool`` windows, with the reference's overwrite
    order: in each channel a window takes the fill of the valid box of that
    channel with the highest index that meets it (the last one written in
    array order), else 0. ``fill(x, y, w, h, r0, r1, c0, c1)`` is a
    pedestrian's value, from the winning box's fields gathered to ``(...,
    height, width)`` and the windows' row and column spans ``[r0, r1)``,
    ``[c0, c1)`` (``(height, 1)``, ``(1, width)``) in pixels."""
    boxes = _as_boxes(boxes)
    device = boxes.device
    lead, m = boxes.shape[:-2], boxes.shape[-2]
    if m == 0 or num_classes == 0:
        return torch.zeros(lead + (height, width, num_classes), device=device)
    btype, x, y, w, h = boxes.long().unbind(-1)
    r0 = torch.arange(height, device=device) * pool
    c0 = torch.arange(width, device=device) * pool
    r1, c1 = r0 + pool, c0 + pool
    ys, xs = y[..., None], x[..., None]
    cover = (((r1 > ys) & (r0 < ys + h[..., None])).unsqueeze(-1)
             & ((c1 > xs) & (c0 < xs + w[..., None])).unsqueeze(-2))    # (..., M, H, W)
    key_type = torch.int16 if m < 2 ** 15 else torch.int32
    key = torch.arange(1, m + 1, device=device, dtype=key_type)   # box index + 1
    planes = []
    for c in range(num_classes):
        if c not in _CHANNEL_TO_CLASS:
            planes.append(torch.zeros(lead + (height, width), device=device))
            continue
        # per window, the highest box index + 1 of the channel's boxes that
        # meet it; 0 where none does (types other than 1, 2, 4 pad)
        k = key * (btype == _CHANNEL_TO_CLASS[c])
        last = (cover * k[..., None, None]).amax(dim=-3)
        if c != _CLASS_TO_CHANNEL[TYPE_PEDESTRIAN]:
            planes.append((last > 0).float())
            continue
        at = (last.long() - 1).clamp(min=0).flatten(-2)            # (..., H * W)
        fields = [f.gather(-1, at).view(last.shape) for f in (x, y, w, h)]
        planes.append(fill(*fields, r0[:, None], r1[:, None], c0[None, :], c1[None, :])
                      * (last > 0))
    return torch.stack(planes, dim=-1)


def rasterize_heatmaps(boxes, height=1280, width=1920, *, num_classes=3):
    """Rasterize padded boxes into ``(height, width, num_classes)`` heat maps
    (reference ``create_ground_truth_maps``, helper.py:276-305), a later box
    overwriting earlier values of its channel inside its rectangle."""
    return _rasterize(
        boxes, height, width, 1, num_classes,
        lambda x, y, w, h, r0, r1, c0, c1: _pedestrian_template_value(r0 - y, c0 - x, h, w))


def _channel_last_pool(x, window, stride, pool):
    if isinstance(window, int):
        window = (window, window)
    stride = stride or window
    if isinstance(stride, int):
        stride = (stride, stride)
    x = torch.as_tensor(x)
    lead = x.shape[:-3]
    nchw = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    out = pool(nchw, window, stride).permute(0, 2, 3, 1)
    return out.reshape(lead + out.shape[1:])


def maxpool2d(x, window, stride=None):
    """Channel-last ``(..., H, W, C)`` max pool, VALID padding."""
    return _channel_last_pool(x, window, stride, F.max_pool2d)


def avgpool2d(x, window, stride=None):
    """Channel-last ``(..., H, W, C)`` average pool, VALID padding."""
    return _channel_last_pool(x, window, stride, F.avg_pool2d)


def rasterize_heatmaps_pooled(boxes, height=1280, width=1920, pool=10):
    """Full-resolution rasterization then a ``pool`` x max pool, as the
    reference ETL stores the maps (helper.py:643-646): ``(height // pool,
    width // pool, 3)``."""
    return maxpool2d(rasterize_heatmaps(boxes, height, width), pool)


def rasterize_heatmaps_direct(boxes, out_height=128, out_width=192, pool=10,
                              *, num_classes=3):
    """Rasterize straight onto the pooled grid: a ``pool`` x ``pool`` window
    holds a box's fill iff it meets the box, a pedestrian's value there being
    the template's max over the intersection. Overwrite order as JAX's: the
    valid box of the channel with the highest index that meets the window
    wins. Equal to :func:`rasterize_heatmaps_pooled` where boxes of one class
    do not overlap."""
    def fill(x, y, w, h, r0, r1, c0, c1):
        return _pedestrian_window_max(torch.clamp(r0 - y, min=0), torch.minimum(r1 - y, h),
                                      torch.clamp(c0 - x, min=0), torch.minimum(c1 - x, w),
                                      h, w)

    return _rasterize(boxes, out_height, out_width, pool, num_classes, fill)


# ---------------------------------------------------------------------------
# LiDAR range image
# ---------------------------------------------------------------------------


def _as_points(points, num_valid):
    """``(points (B, N, 3) f32, num_valid (B,) int64, lead)`` with ``lead``
    the leading shape to restore: ``()`` for one sample, ``(B,)`` batched."""
    points = torch.as_tensor(points, dtype=torch.float32)
    if points.dim() not in (2, 3) or points.shape[-1] != 3:
        raise ValueError(f"points must be (N, 3) or (B, N, 3), got {tuple(points.shape)}")
    lead = points.shape[:-2]
    num_valid = torch.as_tensor(num_valid, device=points.device).long().reshape(lead)
    return points.reshape((-1,) + points.shape[-2:]), num_valid.reshape(-1), lead


def _points_fields(points, num_valid):
    """Per point: ``px``, ``py`` (truncated toward zero, as ``int()`` in the
    reference), the distance and whether the row is valid."""
    px = points[..., 0].trunc().long()
    py = points[..., 1].trunc().long()
    valid = torch.arange(points.shape[1], device=points.device) < num_valid[:, None]
    return px, py, points[..., 2], valid


def _scatter(size, index, value, ok, reduce, fill):
    """A ``(size,)`` buffer of ``fill`` with each ``ok`` entry of ``value``
    reduced (``"amin"`` / ``"amax"``) into it at ``index``. The other entries
    each go to a slot of their own past ``size``, which is dropped: sent to
    one shared slot, millions of them would queue on a single address (the
    card's float min and max are compare-and-swap loops)."""
    spare = torch.arange(size, size + index.numel(), device=index.device).view(index.shape)
    out = torch.full((size + index.numel(),), fill, dtype=value.dtype, device=value.device)
    out.scatter_reduce_(0, torch.where(ok, index, spare).reshape(-1), value.reshape(-1),
                        reduce, include_self=True)
    return out[:size]


def lidar_points_to_range_image(points, num_valid, height=1280, width=1920, kernel_size=5,
                                *, mode="last"):
    """Splat projected LiDAR points into a ``(height, width)`` range image:
    each point's ``kernel_size`` square footprint. ``mode='last'`` keeps the
    last point in array order on overlap (the reference's sequential
    overwrite, helper.py:503-513), ``'nearest'`` the closest. Empty pixels
    are -1; the last row and column are never written (the reference's slice
    clamps)."""
    if mode not in ("last", "nearest"):
        raise ValueError(f"unknown splat mode {mode!r}")
    points, num_valid, lead = _as_points(points, num_valid)
    device = points.device
    batch, n = points.shape[:2]
    px, py, d, valid = _points_fields(points, num_valid)
    shift = (kernel_size - 1) // 2
    offsets = torch.arange(-shift, shift + 1, device=device)
    ty = py[..., None] + offsets.repeat_interleave(kernel_size)   # (B, N, k*k)
    tx = px[..., None] + offsets.repeat(kernel_size)
    ok = (valid[..., None] & (ty >= 0) & (ty <= height - 2)
          & (tx >= 0) & (tx <= width - 2))
    base = torch.arange(batch, device=device)[:, None, None] * (height * width)
    index = base + ty * width + tx
    size = batch * height * width
    if mode == "nearest":
        img = _scatter(size, index, d[..., None].expand(ok.shape), ok, "amin", torch.inf)
        return img.masked_fill(torch.isinf(img), -1.0).reshape(lead + (height, width))
    # 'last': scatter-max of the point index, then gather the winner's
    # distance; later points have larger indices
    order = torch.arange(n, device=device)[None, :, None].expand(ok.shape)
    winner = _scatter(size, index, order, ok, "amax", -1).reshape(batch, height * width)
    img = d.gather(1, winner.clamp(0, n - 1)).masked_fill(winner < 0, -1.0)
    return img.reshape(lead + (height, width))


def bin_lidar_range(x):
    """Invert and bin raw distances (reference helper.py:446-478):

      d > 75       -> 75          (clip)
      d == -1      -> 76          (empty marker)
      d <= 25      -> d * -6.2 + 255
      25 < d <= 76 -> d * -2 + 150
    """
    x = x.clamp(max=LIDAR_MAX_RANGE)
    x = x.masked_fill(x == -1.0, LIDAR_MAX_RANGE + 1.0)
    close = x * -6.2 + 255.0
    far = x * -2.0 + 150.0
    return torch.where(x <= 25.0, close, far)


def pool_lidar_image(range_image):
    """Bin, (20, 10)/s(10, 10) max pool, replicate the last row, clamp
    negatives to 0 (reference ``pool_lidar_tensor``, helper.py:446-491):
    ``(..., H, W)`` (or with a trailing singleton channel) -> ``(..., H // 10,
    W // 10, 1)``."""
    range_image = torch.as_tensor(range_image)
    if range_image.shape[-1] == 1:
        range_image = range_image[..., 0]
    lead, (h, w) = range_image.shape[:-2], range_image.shape[-2:]
    x = bin_lidar_range(range_image).reshape(-1, 1, h, w)
    x = F.max_pool2d(x, (20, 10), (10, 10))[:, 0]
    x = torch.cat([x, x[:, -1:]], dim=1).clamp(min=0.0)[..., None]
    return x.reshape(lead + x.shape[1:])


def lidar_points_to_model_input(points, num_valid, height=1280, width=1920, *,
                                mode="last"):
    """Splat, bin and pool: ``(height // 10, width // 10, 1)``.
    ``mode='nearest_pooled'`` skips the full-resolution range image
    (:func:`lidar_points_to_model_input_pooled`)."""
    if mode == "nearest_pooled":
        return lidar_points_to_model_input_pooled(points, num_valid, height, width)
    return pool_lidar_image(
        lidar_points_to_range_image(points, num_valid, height, width, mode=mode))


def lidar_points_to_model_input_pooled(points, num_valid, height=1280, width=1920):
    """``pool_lidar_image(lidar_points_to_range_image(..., mode='nearest'))``
    without the full-resolution image. The binning decreases with distance,
    so a pooled window's value is the bin of the least distance splatted into
    it: each point's clipped 5x5 footprint (rows ``[max(p-2, 0), min(p+2,
    H-2)]``, columns likewise) meets at most 3 of the 20-row windows (stride
    10) and 2 of the 10-column ones, and one scatter-min over those 6
    candidates of every point writes the pooled grid."""
    points, num_valid, lead = _as_points(points, num_valid)
    device = points.device
    batch = points.shape[0]
    out_h = height // 10 - 1                  # before the replicated row
    out_w = width // 10
    px, py, d, valid = _points_fields(points, num_valid)
    ylo = torch.clamp(py - 2, min=0)
    yhi = torch.clamp(py + 2, max=height - 2)
    xlo = torch.clamp(px - 2, min=0)
    xhi = torch.clamp(px + 2, max=width - 2)
    fp_valid = valid & (ylo <= yhi) & (xlo <= xhi)
    # the last window whose start is <= yhi and the 2 above it, by the last
    # column window whose start is <= xhi and the one left of it: (B, N, 3, 2)
    r = _floordiv(yhi, 10)[..., None, None] - torch.arange(3, device=device)[:, None]
    c = _floordiv(xhi, 10)[..., None, None] - torch.arange(2, device=device)
    ok = (fp_valid[..., None, None] & (r >= 0) & (r < out_h) & (c >= 0) & (c < out_w)
          & (10 * r + 20 > ylo[..., None, None]) & (10 * c + 10 > xlo[..., None, None]))
    base = torch.arange(batch, device=device)[:, None, None, None] * (out_h * out_w)
    img = _scatter(batch * out_h * out_w, base + r * out_w + c,
                   d[..., None, None].expand(ok.shape), ok, "amin",
                   torch.inf).reshape(batch, out_h, out_w)
    # an empty window: every pixel -1 -> 76 -> binned -2 -> clamped to 0
    binned = bin_lidar_range(img).masked_fill(torch.isinf(img), -2.0)
    out = torch.cat([binned, binned[:, -1:]], dim=1).clamp(min=0.0)[..., None]
    return out.reshape(lead + out.shape[1:])


def downsize_image(img):
    """10x average pool (reference helper.py:430-436): ``(H, W, C)`` ->
    ``(H // 10, W // 10, C)``."""
    return avgpool2d(img, 10)


def boxes_to_point_heatmaps(bbs, size_maps=(1080, 1920, 3)):
    """One hot pixel per box at its ``(x, y)`` in its class channel
    (reference ``bbs_To_Heatmaps``, helper.py:734-746): ``bbs`` int ``(N, 3)``
    rows ``[class_idx, x, y]`` -> ``(H, W, C)``. Indices as JAX's
    ``.at[...].set(mode="drop")`` takes them: a negative index counts from
    the end, and a pixel out of range on any axis is dropped."""
    bbs = torch.as_tensor(bbs).long()
    h, w, c = size_maps
    ok = torch.ones(bbs.shape[:-1], dtype=torch.bool, device=bbs.device)
    idx = []
    for column, size in ((2, h), (1, w), (0, c)):
        i = bbs[..., column]
        i = torch.where(i < 0, i + size, i)
        ok &= (i >= 0) & (i < size)
        idx.append(i)
    flat = torch.where(ok, (idx[0] * w + idx[1]) * c + idx[2], h * w * c)
    heat = torch.zeros(h * w * c + 1, dtype=torch.float32, device=bbs.device)
    heat.index_fill_(0, flat.reshape(-1), 1.0)       # the last slot takes the dropped
    return heat[:-1].reshape(h, w, c)


# Batched forms (JAX's vmap wrappers) ------------------------------------------


def rasterize_heatmaps_batch(boxes, height=1280, width=1920, pool=10):
    """:func:`rasterize_heatmaps_pooled` over a leading batch axis:
    ``(B, M, 5)`` -> ``(B, height // pool, width // pool, 3)``."""
    return rasterize_heatmaps_pooled(boxes, height, width, pool)


def lidar_batch_to_model_input(points, num_valid, height=1280, width=1920, *, mode="last"):
    """:func:`lidar_points_to_model_input` over a leading batch axis:
    ``(B, N, 3)`` and ``(B,)`` -> ``(B, height // 10, width // 10, 1)``."""
    return lidar_points_to_model_input(points, num_valid, height, width, mode=mode)
