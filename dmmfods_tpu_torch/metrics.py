"""Heat-map detection metrics: the port of ``dmmfods_tpu/metrics.py``.

Whole-image per-class IoU with 0/0 -> NaN, its batch aggregation by a
NaN-ignoring mean with NaN counts, class-wise pixel accuracy, the exact
per-class average precision, and the streamed (binned) AP of a whole
dataset. Every function takes channel-last tensors, ``(H, W, C)`` or
``(B, H, W, C)``, and returns tensors on their device without a host sync;
only :func:`ap_from_binned_counts` and :class:`StreamingAP` work in numpy on
the host, once per epoch.

The reference's quirk is kept: the train and eval steps threshold *raw
logits* at the IoU threshold (0.7) for IoU and accuracy; ``sigmoid=True``
gives the probability-domain variant.
"""

from __future__ import annotations

import numpy as np
import torch

# score bins of the streamed AP: bin width 2**-15 in probability
NUM_AP_BINS = 1 << 15


def compute_iou_per_class(ground_truth_map, estimated_heat_map, threshold=0.7, *,
                          sigmoid=False):
    """Whole-image per-class IoU of one sample, ``(H, W, C)`` -> ``(C,)``:
    both maps thresholded, intersection over union, NaN where the union is
    empty."""
    return compute_iou_batch(ground_truth_map[None], estimated_heat_map[None], threshold,
                             sigmoid=sigmoid)[0]


def compute_iou_batch(ground_truth_map_batch, estimated_heat_map_batch, threshold=0.7, *,
                      sigmoid=False):
    """Per-sample per-class IoU, ``(B, H, W, C)`` -> ``(B, C)`` (may hold NaN)."""
    est = estimated_heat_map_batch
    if sigmoid:
        est = torch.sigmoid(est)
    est = est >= threshold
    gt = ground_truth_map_batch >= threshold
    intersection = (est & gt).sum(dim=(1, 2)).float()
    union = (est | gt).sum(dim=(1, 2)).float()
    return intersection / union


def aggregate_iou(iou_per_instance_per_class):
    """NaN-ignoring per-class mean over the batch (0 for a class that is NaN
    in every sample) and the NaN count per class:
    ``(B, C)`` -> ``((C,), (C,))``."""
    x = iou_per_instance_per_class
    isnan = torch.isnan(x)
    valid = torch.where(isnan, torch.zeros_like(x), x)
    count = (~isnan).sum(dim=0)
    mean = valid.sum(dim=0) / count.clamp(min=1)
    mean = torch.where(count == 0, torch.zeros_like(mean), mean)
    return mean, isnan.sum(dim=0).float()


def compute_accuracy(ground_truth, prediction, threshold=0.7, *, sigmoid=False):
    """Class-wise pixel accuracy, (TP + TN) / all, of ``(H, W, C)`` or
    ``(B, H, W, C)`` maps, both thresholded: ``(C,)``."""
    if sigmoid:
        prediction = torch.sigmoid(prediction)
    if ground_truth.ndim == 3:
        dims = (0, 1)
    elif ground_truth.ndim == 4:
        dims = (0, 1, 2)
    else:
        raise ValueError(
            "Number of dimensions must be either 3 or 4, you gave " + str(ground_truth.ndim))
    per_class_elems = ground_truth.numel() / ground_truth.shape[-1]
    agree = (prediction >= threshold) == (ground_truth >= threshold)
    return agree.sum(dim=dims) / per_class_elems


def _class_major(ground_truth, logits, gt_threshold):
    """``(C, N)`` positives and f32 scores of ``(..., C)`` maps."""
    num_classes = ground_truth.shape[-1]
    gt = (ground_truth >= gt_threshold).reshape(-1, num_classes).t()
    scores = logits.float().reshape(-1, num_classes).t()
    return gt, scores


def heatmap_average_precision(ground_truth, logits, gt_threshold=0.7):
    """Exact pixel-wise per-class average precision, ``(B, H, W, C)`` x2 ->
    ``(C,)`` f32: every pixel scored by its logit, positives where the heat
    map is at least ``gt_threshold``, ``AP = (1/P) * sum over positives of
    the precision at that positive`` in descending score order; 0 for a
    class without positives. Ties keep their index order (a stable sort of
    the negated scores, as ``jnp.argsort``), so the AP of tied bf16 logits
    is JAX's."""
    gt, scores = _class_major(ground_truth, logits, gt_threshold)
    n = scores.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    g_sorted = torch.gather(gt, 1, order).float()
    tp = torch.cumsum(g_sorted, dim=-1)
    precision = tp / torch.arange(1, n + 1, dtype=torch.float32, device=tp.device)
    positives = tp[:, -1]
    ap = (precision * g_sorted).sum(dim=-1) / positives.clamp(min=1.0)
    return torch.where(positives > 0, ap, torch.zeros_like(ap))


def binned_ap_counts(ground_truth, logits, gt_threshold=0.7, num_bins=NUM_AP_BINS):
    """One batch's share of the streamed AP: ``(2, C, num_bins)`` int32, the
    positives (``[0]``) and all pixels (``[1]``) per score bin, the bin
    ``floor(sigmoid(logit) * num_bins)`` clipped to the range."""
    gt, scores = _class_major(ground_truth, logits, gt_threshold)
    num_classes = gt.shape[0]
    bins = (torch.sigmoid(scores) * num_bins).to(torch.int32).clamp(0, num_bins - 1)
    offset = torch.arange(num_classes, dtype=torch.int32, device=bins.device)[:, None]
    flat_ids = (bins + offset * num_bins).reshape(-1).long()
    counts = torch.zeros(2, num_classes * num_bins, dtype=torch.int32, device=bins.device)
    counts[0].scatter_add_(0, flat_ids, gt.reshape(-1).to(torch.int32))
    counts[1].scatter_add_(0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32))
    return counts.reshape(2, num_classes, num_bins)


def ap_from_binned_counts(counts):
    """Finish a streamed AP: summed ``(2, C, num_bins)`` counts -> ``(C,)``
    AP, in numpy on the host."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    pos = np.asarray(counts[0], np.float64)
    tot = np.asarray(counts[1], np.float64)
    pos_desc = pos[:, ::-1]                       # descending score = descending bin
    tp_cum = np.cumsum(pos_desc, axis=1)
    n_cum = np.cumsum(tot[:, ::-1], axis=1)
    precision = tp_cum / np.maximum(n_cum, 1.0)
    positives = tp_cum[:, -1]
    ap = np.sum(pos_desc * precision, axis=1) / np.maximum(positives, 1.0)
    return np.where(positives > 0, ap, 0.0).astype(np.float32)


class StreamingAP:
    """The pooled heat-map AP of an epoch, accumulated on the host: feed each
    batch's :func:`binned_ap_counts` to :meth:`update`, read :meth:`result`.
    Its memory is a fixed ``(2, C, num_bins)`` int64 array."""

    def __init__(self, num_classes=3, num_bins=NUM_AP_BINS):
        self.counts = np.zeros((2, num_classes, num_bins), np.int64)

    def update(self, batch_counts):
        if isinstance(batch_counts, torch.Tensor):
            batch_counts = batch_counts.cpu().numpy()
        self.counts += np.asarray(batch_counts, np.int64)

    def result(self):
        return ap_from_binned_counts(self.counts)
