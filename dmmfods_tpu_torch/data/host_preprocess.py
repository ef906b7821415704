"""The LiDAR splat on the host, for raw-record training: the port of
``dmmfods_tpu/data/host_preprocess.py``.

A raw-record batch holds points and boxes, not dense maps. The heat maps are
rasterized in the step (``trainer.make_train_step_ht``); the LiDAR splat can
run here on the host instead, in the C++ runtime (:mod:`.native_io`) where it
built, else in numpy. Both compute
``ops/preprocess.py::lidar_points_to_model_input_pooled``: the nearest point
per pooled window of each point's clipped 5x5 footprint, binned, the last row
replicated, negatives clamped. Which of the two serves is decided by
:func:`.native_io.available` alone.
"""

from __future__ import annotations

import numpy as np

from . import native_io

def _splat_pooled_batch_numpy(points_concat, offsets, height, width):
    """The numpy form: the minimum distance per 10x10 cell over each point's
    clipped 5x5 footprint, the (20, 10) window's minimum from two adjacent
    cell rows, binned, the last row replicated, negatives clamped."""
    ch, cw = height // 10, width // 10
    batch = len(offsets) - 1
    out = np.empty((batch, ch, cw), np.float32)
    for i in range(batch):
        pts = points_concat[offsets[i]:offsets[i + 1]]
        cells = np.full(ch * cw, np.inf, np.float32)
        if len(pts):
            px = np.trunc(pts[:, 0]).astype(np.int64)
            py = np.trunc(pts[:, 1]).astype(np.int64)
            d = pts[:, 2].astype(np.float32)
            ylo = np.maximum(py - 2, 0)
            yhi = np.minimum(py + 2, height - 2)
            xlo = np.maximum(px - 2, 0)
            xhi = np.minimum(px + 2, width - 2)
            ok = (ylo <= yhi) & (xlo <= xhi)
            r0, r1 = ylo // 10, yhi // 10
            c0, c1 = xlo // 10, xhi // 10
            for dr in (0, 1):
                for dc in (0, 1):
                    r = np.minimum(r0 + dr, r1)
                    c = np.minimum(c0 + dc, c1)
                    m = ok & (dr <= r1 - r0) & (dc <= c1 - c0)
                    np.minimum.at(cells, (r[m] * cw + c[m]), d[m])
        cells = cells.reshape(ch, cw)
        m = np.minimum(cells[:-1], cells[1:])
        binned = np.where(m > 75.0, 75.0, m).astype(np.float32)
        binned = np.where(
            binned <= 25.0, binned * np.float32(-6.2) + np.float32(255.0),
            binned * np.float32(-2.0) + np.float32(150.0),
        )
        binned = np.where(np.isinf(m), np.float32(-2.0), binned)
        sample = np.concatenate([binned, binned[-1:]], axis=0)
        out[i] = np.where(sample < 0.0, 0.0, sample)
    return out[:, :, :, None]


def splat_pooled_batch(points_concat, offsets, height=1280, width=1920, num_threads=2):
    """Ragged batch splat -> ``(batch, height // 10, width // 10, 1)``
    float32: sample ``i`` owns ``points_concat[offsets[i]:offsets[i + 1]]``.
    The C++ runtime where it built, numpy otherwise."""
    points_concat = np.ascontiguousarray(points_concat, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if native_io.available():
        return native_io.splat_pooled_batch(points_concat, offsets, height, width,
                                            num_threads)
    return _splat_pooled_batch_numpy(points_concat, offsets, height, width)
