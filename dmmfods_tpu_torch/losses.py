"""Pixel-wise heat-map losses: the port of ``dmmfods_tpu/losses.py``.

The training objective is the sum-reduced sigmoid BCE of the reference
agent; the focal variants carry their hyperparams in ``config.loss``. Every
function takes channel-last ``(B, H, W, C)`` tensors (the class axis last)
and computes in the dtype it is given; the train and eval steps hand it f32
logits. ``bce_with_logits`` writes out JAX's expression rather than calling
``F.binary_cross_entropy_with_logits``, so that both packages round alike.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits, targets):
    """Element-wise sigmoid binary cross entropy,
    ``max(x, 0) - x*t + log(1 + exp(-|x|))``."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits_sum(logits, targets):
    """Sum-reduced BCE: the reference agent's training objective."""
    return bce_with_logits(logits, targets).sum()


def per_class_loss(elementwise_loss):
    """Per-class loss sums for logging: ``(B, H, W, C)`` -> ``(C,)``."""
    return elementwise_loss.sum(dim=(0, 1, 2))


def _bce(logits, targets, from_logits):
    if from_logits:
        return bce_with_logits(logits, targets)
    probs = logits.clamp(1e-7, 1.0 - 1e-7)
    return -(targets * torch.log(probs) + (1.0 - targets) * torch.log(1.0 - probs))


def focal_loss(logits, targets, alpha=1.0, gamma=2.0, *, from_logits=True, reduce=True):
    """Pixel-wise focal loss (Lin et al., arXiv:1708.02002):
    ``alpha * (1 - pt)**gamma * BCE`` with ``pt = exp(-BCE)``; the mean if
    ``reduce``, else element-wise."""
    bce = _bce(logits, targets, from_logits)
    pt = torch.exp(-bce)
    loss = alpha * (1.0 - pt) ** gamma * bce
    return loss.mean() if reduce else loss


def class_wise_focal_loss(logits, targets, alpha=(1.0, 1.0, 1.0), gamma=(2.0, 2.0, 2.0), *,
                          from_logits=True, reduce=False):
    """Focal loss with per-class ``alpha`` and ``gamma`` over the last axis."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=logits.device)
    bce = _bce(logits, targets, from_logits)
    pt = torch.exp(-bce)
    loss = alpha * (1.0 - pt) ** gamma * bce
    return loss.mean() if reduce else loss


def make_elementwise_loss_fn(config):
    """The element-wise form of the configured loss, ``(B, H, W, C) ->
    (B, H, W, C)``: the scalar objective is its sum, the per-class logging
    breakdown its sum over (0, 1, 2)."""
    loss_type = config.loss.get("type", "bce")
    if loss_type == "bce":
        return bce_with_logits
    alpha, gamma, from_logits = config.loss.alpha, config.loss.gamma, config.loss.logits
    if loss_type == "focal":
        return lambda logits, targets: focal_loss(
            logits, targets, alpha, gamma, from_logits=from_logits, reduce=False)
    if loss_type == "class_wise_focal":
        on_device = {}          # alpha and gamma as tensors, copied once a device

        def class_wise(logits, targets):
            if logits.device not in on_device:
                on_device[logits.device] = tuple(
                    torch.as_tensor(v, dtype=torch.float32, device=logits.device)
                    for v in (alpha, gamma))
            return class_wise_focal_loss(logits, targets, *on_device[logits.device],
                                         from_logits=from_logits, reduce=False)

        return class_wise
    raise ValueError(f"unknown loss type {loss_type!r}")


def make_loss_fn(config):
    """The configured scalar training loss: the sum of
    :func:`make_elementwise_loss_fn`'s loss (BCE by default)."""
    loss_type = config.loss.get("type", "bce")
    if loss_type == "bce":
        return bce_with_logits_sum
    elementwise = make_elementwise_loss_fn(config)
    return lambda logits, targets: elementwise(logits, targets).sum()
