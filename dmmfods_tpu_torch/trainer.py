"""Train and eval steps: the port of ``dmmfods_tpu/trainer.py``.

A train step is the model's train-mode forward (batch-stat BN, the running
stats updated, no kernel: every kernel gate refuses train mode, as JAX's
do), the configured loss on f32 logits, autograd's backward and one
optimizer step; an eval step is the eval forward (K1 on the mid-fusion
concat) and the loss. Both return the JAX steps' metric dicts, under the
same keys, as tensors on the module's device: no step waits for the device.

The JAX ``TrainState`` holds ``params``, ``batch_stats`` and ``opt_state``;
here the module holds the first two and the optimizer the third, and
:class:`TrainState` holds both. A step updates them in place and returns the
state it was given. Inputs are NHWC tensors on the module's device: RGB,
LiDAR (ignored when ``model.stream_2_in_channels`` is 0) and f32 heat maps.

Each phase of a train step runs under a ``torch.profiler.record_function``
range (``train_step/forward``, ``/loss``, ``/backward``, ``/metrics``; the
optimizer's own is ``Optimizer.step#Adam.step``), so that a profile can
attribute device time to it.

Not ported yet: the raw-record steps (``make_train_step_raw`` / ``_ht``,
``make_eval_step_ht`` / ``_raw``), which need the device-side
preprocessing, and the mesh, which has no meaning on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.profiler import record_function

from . import losses, metrics
from .optim import Adam


def make_optimizer(config, params) -> Adam:
    """Adam (or AMSGrad, with ``optimizer.amsgrad``) with the config's
    hyperparameters and optax's semantics, ``optimizer.weight_decay`` added
    to the gradient first (:class:`~dmmfods_tpu_torch.optim.Adam`)."""
    opt = config.optimizer
    return Adam(params, lr=opt.learning_rate, betas=(opt.beta1, opt.beta2), eps=opt.eps,
                weight_decay=opt.get("weight_decay", 0) or 0.0,
                amsgrad=bool(opt.get("amsgrad", False)))


def set_learning_rate(optimizer, lr):
    """Set every param group's learning rate (StepLR semantics, from the
    host, without rebuilding the optimizer)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


@dataclasses.dataclass
class TrainState:
    """The training state: the module (parameters and BN running stats) and
    its optimizer (the moments and the count)."""

    module: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(bundle, optimizer) -> TrainState:
    return TrainState(module=bundle.module, optimizer=optimizer)


def _step_metrics(logits, ht_map, elementwise_loss, iou_threshold):
    """The reference's per-iteration metrics, each ``(C,)``: IoU and accuracy
    threshold the raw logits (the reference's quirk)."""
    iou_per_class, iou_nans = metrics.aggregate_iou(
        metrics.compute_iou_batch(logits, ht_map, iou_threshold))
    return {
        "loss_per_class": losses.per_class_loss(elementwise_loss),
        "iou_per_class": iou_per_class,
        "iou_nans": iou_nans,
        "acc_per_class": metrics.compute_accuracy(ht_map, logits, iou_threshold),
    }


def _loss(logits, ht_map, elementwise_fn, loss_fn):
    """``(loss, elementwise)``: the configured loss, or a custom ``loss_fn``
    with BCE as the logged element-wise loss."""
    if elementwise_fn is not None:
        elementwise = elementwise_fn(logits, ht_map)
        return elementwise.sum(), elementwise
    return loss_fn(logits, ht_map), losses.bce_with_logits(logits, ht_map)


def _check_state(state, module, optimizer=None):
    if state.module is not module or (optimizer is not None
                                      and state.optimizer is not optimizer):
        raise ValueError("the state holds another module or optimizer than the "
                         "step was built for")


def make_train_step(module, optimizer, config, *, loss_fn: Optional[Callable] = None):
    """The train step: ``step(state, rgb, lidar, ht_map) -> (state,
    metrics)``, with ``metrics`` the tensors ``loss``, ``loss_per_class``,
    ``iou_per_class``, ``iou_nans`` and ``acc_per_class``. The loss is that
    of ``config.loss`` unless ``loss_fn(logits, ht_map)`` is given."""
    elementwise_fn = losses.make_elementwise_loss_fn(config) if loss_fn is None else None
    iou_threshold = config.agent.iou_threshold
    single_stream = config.model.stream_2_in_channels == 0

    def step(state, rgb, lidar, ht_map):
        _check_state(state, module, optimizer)
        module.train()
        with record_function("train_step/forward"):
            logits = module(rgb, None if single_stream else lidar).float()
        with record_function("train_step/loss"):
            loss, elementwise = _loss(logits, ht_map, elementwise_fn, loss_fn)
        optimizer.zero_grad(set_to_none=True)
        with record_function("train_step/backward"):
            loss.backward()
        optimizer.step()
        with torch.no_grad(), record_function("train_step/metrics"):
            step_metrics = _step_metrics(logits.detach(), ht_map, elementwise.detach(),
                                         iou_threshold)
        step_metrics["loss"] = loss.detach()
        return state, step_metrics

    return step


def make_eval_step(module, config, *, loss_fn: Optional[Callable] = None):
    """The eval step: ``step(state, rgb, lidar, ht_map) -> metrics``, the
    eval forward (running stats frozen) under ``torch.no_grad``, with the
    train step's metrics plus ``ap_per_class`` (the exact AP) and
    ``ap_bin_counts`` (this batch's share of the streamed AP,
    :class:`~dmmfods_tpu_torch.metrics.StreamingAP`)."""
    elementwise_fn = losses.make_elementwise_loss_fn(config) if loss_fn is None else None
    iou_threshold = config.agent.iou_threshold
    single_stream = config.model.stream_2_in_channels == 0

    def step(state, rgb, lidar, ht_map):
        _check_state(state, module)
        module.eval()
        with torch.no_grad():
            logits = module(rgb, None if single_stream else lidar).float()
            loss, elementwise = _loss(logits, ht_map, elementwise_fn, loss_fn)
            step_metrics = _step_metrics(logits, ht_map, elementwise, iou_threshold)
            step_metrics["loss"] = loss
            step_metrics["ap_per_class"] = metrics.heatmap_average_precision(ht_map, logits)
            step_metrics["ap_bin_counts"] = metrics.binned_ap_counts(ht_map, logits)
        return step_metrics

    return step


def make_forward(module, config):
    """The eval forward: ``forward(rgb, lidar=None) -> logits`` (NHWC, in
    the model's compute dtype). The JAX forward's ``variables`` argument is
    the module's own state here."""
    single_stream = config.model.stream_2_in_channels == 0

    def forward(rgb, lidar=None):
        module.eval()
        with torch.no_grad():
            return module(rgb, None if single_stream else lidar)

    return forward
