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

Each phase of a train step runs under a span (``train_step/forward``,
``/loss``, ``/backward``, ``/metrics``; :mod:`.tracing`), which a
``torch.profiler`` on the calling thread sees as a ``record_function`` range
of the same name (the optimizer's own is ``Optimizer.step#Adam.step``), so
that a profile can attribute device time to it.

The raw-record steps take label boxes, and LiDAR points or a LiDAR image
splatted on the host, in place of dense maps, and preprocess on the device
inside the step (``ops/preprocess.py``, under ``train_step/preprocess``):
``make_train_step_raw`` / ``make_eval_step_raw`` splat the points and
rasterize the boxes, ``make_train_step_ht`` / ``make_eval_step_ht``
rasterize the boxes only. Not ported: the mesh, which has no meaning on one
card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from . import losses, metrics, tracing
from .ops import preprocess as pp
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
        with tracing.span("train_step/forward"):
            logits = module(rgb, None if single_stream else lidar).float()
        with tracing.span("train_step/loss"):
            loss, elementwise = _loss(logits, ht_map, elementwise_fn, loss_fn)
        optimizer.zero_grad(set_to_none=True)
        with tracing.span("train_step/backward"):
            loss.backward()
        optimizer.step()
        with torch.no_grad(), tracing.span("train_step/metrics"):
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


def _make_heatmap_rasterizer(full_height, full_width):
    """``rasterize(image, boxes) -> heat maps``: the boxes ``(B, M, 5)``,
    in ``full_height`` x ``full_width`` pixels, rasterized straight onto the
    image's ``(h, w)`` grid (``rasterize_heatmaps_direct``, pool
    ``full_height // h``), ``(B, h, w, 3)`` f32."""
    def rasterize(image, boxes):
        out_h, out_w = image.shape[1], image.shape[2]
        return pp.rasterize_heatmaps_direct(boxes, out_h, out_w, full_height // out_h)

    return rasterize


def _points_step(base_step, full_height, full_width, splat_mode):
    """``base_step`` on raw records: ``step(state, image, points, num_valid,
    boxes)``, the points splatted (``lidar_points_to_model_input`` in
    ``splat_mode``) and the boxes rasterized on the device in the step."""
    rasterize = _make_heatmap_rasterizer(full_height, full_width)

    def step(state, image, points, num_valid, boxes):
        with tracing.span("train_step/preprocess"):
            lidar = pp.lidar_points_to_model_input(points, num_valid, full_height, full_width,
                                                   mode=splat_mode)
            ht_map = rasterize(image, boxes)
        return base_step(state, image, lidar, ht_map)

    return step


def _boxes_step(base_step, full_height, full_width):
    """``base_step`` on raw records splatted on the host: ``step(state,
    image, lidar, boxes)``, the boxes rasterized on the device in the step."""
    rasterize = _make_heatmap_rasterizer(full_height, full_width)

    def step(state, image, lidar, boxes):
        with tracing.span("train_step/preprocess"):
            ht_map = rasterize(image, boxes)
        return base_step(state, image, lidar, ht_map)

    return step


def make_train_step_raw(module, optimizer, config, *, full_height=1280, full_width=1920,
                        splat_mode="nearest_pooled"):
    """The train step on raw records: ``step(state, image, points, num_valid,
    boxes) -> (state, metrics)``. The LiDAR splat (``splat_mode`` of
    ``lidar_points_to_model_input``) and the heat-map rasterization run on
    the device inside the step, then :func:`make_train_step`'s step."""
    return _points_step(make_train_step(module, optimizer, config), full_height, full_width,
                        splat_mode)


def make_train_step_ht(module, optimizer, config, *, full_height=1280, full_width=1920):
    """The train step on raw records whose LiDAR was splatted on the host
    (``data/host_preprocess.py``): ``step(state, image, lidar, boxes) ->
    (state, metrics)``, the heat maps rasterized on the device in the step."""
    return _boxes_step(make_train_step(module, optimizer, config), full_height, full_width)


def make_eval_step_ht(module, config, *, full_height=1280, full_width=1920):
    """Eval twin of :func:`make_train_step_ht`: ``step(state, image, lidar,
    boxes) -> metrics``."""
    return _boxes_step(make_eval_step(module, config), full_height, full_width)


def make_eval_step_raw(module, config, *, full_height=1280, full_width=1920,
                       splat_mode="nearest_pooled"):
    """Eval twin of :func:`make_train_step_raw`: ``step(state, image, points,
    num_valid, boxes) -> metrics``."""
    return _points_step(make_eval_step(module, config), full_height, full_width, splat_mode)


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
