"""Dense U-Net LiDAR in PyTorch: the port of
``dmmfods_tpu/models/dense_unet_lidar.py``.

A DenseNet encoder with an optional parallel LiDAR stream (no / early / mid
fusion, chosen by the same config fields), a U-Net transposed-conv decoder
fed by the encoder's skip stack, and a refinement head that emits per-pixel
class heat-map LOGITS. The channel arithmetic, the skip and shape stacks and
the module names are the JAX model's; the module names are also the
reference torch network's, so ``dmmfods_tpu.models.torch_port`` maps this
model's ``state_dict`` onto the JAX variables key for key.

Only the math is ported, plus the kernels of the eval path and the
phase-space head. The JAX model's TPU lowering options (rows-as-batch
forms, dense-block buffers, the ``rows`` and ``single`` eval forms of the
phase-space head) have no counterpart here: each one computes the form
below. In eval mode four modules hand their work to a hand-written CUDA
kernel (the plain version on a CPU tensor):

* ``ConcatFuse``: K1, :func:`..ops.fused.concat_bn_relu_conv1x1`, with
  ``gpu.use_fused_kernels`` (JAX's ``tpu.use_fused_kernels``);
* ``DenseBlock``: at batch 1 on planes of at least ``STRIP_MIN_PIXELS``
  pixels that JAX's strip gate takes (``ops.dense_block_strip.eligible``),
  K2, :func:`..ops.dense_block_strip.dense_block_strip`, or with
  ``gpu.dense_block_strip = "on"`` K5,
  :func:`..ops.dense_block_strip.dense_block_strip_recompute`; else, where
  ``gpu.dense_block_impl`` names ``pallas`` for the block, K4,
  :func:`..ops.dense_block.dense_block`, on the shapes JAX's sample-group
  rule takes (``ops.dense_block.eligible``);
* ``Encoder``: K6, :func:`..ops.stem_pool.stem_pool`, for conv0 + norm0 +
  ReLU + pool0 at batch 1, where ``gpu.stem_pool_strip`` is ``on`` and
  JAX's regime takes the shape (:func:`_stem_pool_ok`);
* ``Head``: K3, :func:`..ops.phase_head.phase_head`, with
  ``gpu.use_fused_kernels``, at batch 1 on output planes of more than
  ``HEAD_KERNEL_MIN_PIXELS`` pixels (and of at most
  ``gpu.fused_head_max_pixels``); other eval calls run the phase-space head
  in stock PyTorch (:func:`..ops.phase_head.phase_space_head`), with the
  switch, and the plain head without it.

The strip, K4 and K6 gates are JAX's own decisions, its TPU cost models
included, kept so that both packages run those kernels on the same shapes;
a kernel with no JAX gate to match needs no such model. The strip, K4 and
head gates also require their CUDA kernels' own limits (growth <= 48 and K
<= 192 for the blocks; c_mid <= 96, classes <= 8 and, in bf16, a source
c_up + 4 rc <= 256 for the head), which every DenseNet of the repo meets,
so the port's decisions are JAX's; an architecture past them runs the plain
loop or the phase-space head, chosen by shape. Each gate takes
``kernel_limits=False`` to give JAX's decision alone.

With the default config, at the 128x192 working resolution K1 engages and
the head runs in phase space; at 1280x1920 batch 1 the blocks 1 and 2 of
both streams (K2) and the head (K3) do too, DenseNet-161's included. The
opt-ins add K4 on the 128x192 blocks (DenseNet-121: three block calls at
b1, four at b8, five from b32; DenseNet-161: three at every batch), K6 on
both stems at b1, and K5 in place of K2 at 1280x1920. Train mode runs no
kernel, as in JAX, and the plain head where JAX runs its phase-space train
head (``Head``).

Layout: :meth:`DenseUNetLidar.forward` takes and returns NHWC tensors, like
the JAX model. Inside, tensors are NCHW in shape and ``channels_last`` in
memory; permuting a contiguous NHWC tensor gives exactly that, at no cost.

Dtypes, by explicit casts (no autocast): params and BN running stats are
float32. The model casts its inputs to ``spec.dtype`` (``gpu.compute_dtype``,
bfloat16 by default) and every conv runs on its weight cast to the
activation dtype. In eval mode every BN folds its running stats into a
per-channel ``(scale, shift)`` in float32, and every BN-ReLU of the plain
path is the f32 arithmetic rounded once to the activation dtype
(``ops/bn_relu.py``). Every module's eval operands, in every form its paths
take (the plain path's folds and cast weights, a kernel's folded and packed
weights, the phase-space head's), come from one cache,
:func:`eval_operands`: with autograd off they are made once per fold and
kept, and the BN-ReLU is one pass, :func:`..ops.bn_relu.bn_relu` (the
hand-written kernel on the card); a forward that records gradients makes
them at every call and runs the pass's plain version, so both give the same
values. In train mode a BN is ``nn.BatchNorm2d``'s own batch-stat forward.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops.bn_relu import BN_FOLDS, bn_relu, bn_relu_operands, bn_relu_reference
from ..ops.dense_block import dense_block, fold_block_params
from ..ops.dense_block import eligible as dense_block_eligible
from ..ops.dense_block_strip import dense_block_strip, dense_block_strip_recompute
from ..ops.dense_block_strip import eligible as strip_eligible
from ..ops.dense_block_strip import pack_layer_weights
from ..ops.fused import concat_bn_relu_conv1x1, fuse_operands
from ..ops.phase_head import kernel_weights as phase_head_weights
from ..ops.phase_head import phase_head, phase_space_head, phase_space_weights
from ..ops.phase_head import within_limits as phase_head_within_limits
from ..ops.stem_pool import eligible as stem_pool_eligible
from ..ops.stem_pool import pack_stem_weights, stem_pool

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the JAX model's dense-block lowerings: 'pallas' selects K4, the XLA forms
# the plain loop
_BLOCK_IMPLS = ("concat", "buffer", "vjp", "pallas")
# the JAX model's dense_block_strip values: 'auto' and 'carry' select K2,
# 'on' K5, 'off' neither
_STRIP_MODES = ("auto", "carry", "on", "off")
# the JAX model's stem_pool_strip values: 'on' selects K6; 'force', JAX's
# override of its TPU quarantine, means 'on' here; 'auto' and 'off' do not
_STEM_POOL_MODES = ("auto", "off", "on", "force")

# The kernels' gates, read at each call. A dense block of a batch-1 plane of
# at least this many pixels runs as K2 or K5 where JAX's strip gate takes it
# (``ModelSpec.rows_min_pixels`` of the JAX model: blocks 1 and 2 at
# 1280x1920, not block 3 at 80x120).
STRIP_MIN_PIXELS = 16384
# The head of a batch-1 output plane of more than this many pixels runs as K3
# (``dense_unet_lidar.py`` ``Head``'s "big" plane of the JAX model).
HEAD_KERNEL_MIN_PIXELS = 98304


# ---------------------------------------------------------------------------
# Model spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description, derived from ``config.model``.

    Field defaults equal the config defaults (DenseNet-121, mid fusion).
    ``num_layers_before_blocks`` and ``memory_efficient`` of the config
    change nothing in the math and are not read. ``dense_block_impl``,
    ``dense_block_strip`` and ``stem_pool_strip`` select K4, K2 or K5, and
    K6; ``use_fused_kernels`` and ``fused_head_max_pixels`` K1 and the
    head's phase-space forms and K3 (``config.py``)."""

    growth_rate: int = 32
    block_config: Tuple[int, ...] = (6, 12, 24, 16)
    num_init_features: int = 64
    stream_1_in_channels: int = 3
    stream_2_in_channels: int = 1
    concat_before_block_num: int = 2
    bn_size: int = 4
    drop_rate: float = 0.0
    num_classes: int = 3
    dtype: Any = torch.float32
    dense_block_impl: str = "concat,concat,buffer,buffer"
    dense_block_strip: str = "auto"
    stem_pool_strip: str = "auto"
    use_fused_kernels: bool = True
    fused_head_max_pixels: int = 1 << 62

    def __post_init__(self):
        for i in range(len(self.block_config)):
            if self.impl_for_block(i) not in _BLOCK_IMPLS:
                raise ValueError(f"dense_block_impl entries must be one of "
                                 f"{_BLOCK_IMPLS}, got {self.dense_block_impl!r}")
        if self.dense_block_strip not in _STRIP_MODES:
            raise ValueError(f"dense_block_strip must be one of {_STRIP_MODES}, "
                             f"got {self.dense_block_strip!r}")
        if self.stem_pool_strip not in _STEM_POOL_MODES:
            raise ValueError(f"stem_pool_strip must be one of {_STEM_POOL_MODES}, "
                             f"got {self.stem_pool_strip!r}")

    def impl_for_block(self, i: int) -> str:
        """The lowering of 0-based block ``i``: its entry of the
        comma-separated ``dense_block_impl``, the last one repeated."""
        impls = self.dense_block_impl.split(",")
        return impls[i].strip() if i < len(impls) else impls[-1].strip()

    @classmethod
    def from_config(cls, config, **overrides):
        m = config.model
        kwargs = dict(
            growth_rate=m.growth_rate,
            block_config=tuple(m.block_config),
            num_init_features=m.num_init_features,
            stream_1_in_channels=m.stream_1_in_channels,
            stream_2_in_channels=m.stream_2_in_channels,
            concat_before_block_num=m.concat_before_block_num,
            bn_size=m.bn_size,
            drop_rate=float(m.drop_rate),
            num_classes=m.num_classes,
        )
        gpu = config.get("gpu", {})
        if gpu:
            name = gpu.get("compute_dtype", "bfloat16")
            if name not in _COMPUTE_DTYPES:
                raise ValueError(f"gpu.compute_dtype must be one of "
                                 f"{sorted(_COMPUTE_DTYPES)}, got {name!r}")
            kwargs["dtype"] = _COMPUTE_DTYPES[name]
            kwargs["dense_block_impl"] = str(gpu.get(
                "dense_block_impl", cls.dense_block_impl))
            kwargs["dense_block_strip"] = str(gpu.get(
                "dense_block_strip", cls.dense_block_strip))
            kwargs["stem_pool_strip"] = str(gpu.get(
                "stem_pool_strip", cls.stem_pool_strip))
            kwargs["use_fused_kernels"] = bool(gpu.get(
                "use_fused_kernels", cls.use_fused_kernels))
            kwargs["fused_head_max_pixels"] = int(gpu.get(
                "fused_head_max_pixels", cls.fused_head_max_pixels))
        kwargs.update(overrides)
        return cls(**kwargs)

    @property
    def fusion(self) -> str:
        """Fusion mode, by the reference network's rules."""
        if self.concat_before_block_num == 1 and self.stream_2_in_channels == 0:
            return "no"
        if self.concat_before_block_num == 1 and self.stream_2_in_channels > 0:
            return "early"
        if 1 < self.concat_before_block_num <= len(self.block_config):
            return "mid"
        raise AttributeError(
            f"invalid fusion config: concat_before_block_num="
            f"{self.concat_before_block_num}, stream_2_in_channels={self.stream_2_in_channels}"
        )

    @property
    def network_input_channels(self) -> int:
        if self.fusion == "early":
            return self.stream_1_in_channels + self.stream_2_in_channels
        return self.stream_1_in_channels

    def encoder_feature_sizes(self):
        """Skip-stack channel widths + bottleneck width: ``(stack,
        bottleneck)``. ``stack[0]`` (``num_init_features + 2*growth_rate``)
        is consumed by the last decoder stage."""
        sizes = [self.num_init_features + 2 * self.growth_rate]
        num_features = self.num_init_features
        for i, num_layers in enumerate(self.block_config):
            num_features += num_layers * self.growth_rate
            sizes.append(num_features)
            if i != len(self.block_config) - 1:
                num_features //= 2
        bottleneck = sizes.pop()
        return sizes, bottleneck

    def decoder_stage_features(self):
        """Per-stage reduce-conv output widths, in application order
        (DenseNet-121: [1024, 512, 256, 128])."""
        sizes, _ = self.encoder_feature_sizes()
        return list(reversed(sizes))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv(x, conv: nn.Conv2d, weight):
    """``conv`` on ``weight``, its weight cast to the activation dtype
    (:func:`_plain_form`)."""
    return F.conv2d(x, weight, None, conv.stride, conv.padding)


def _bn_relu(x, norm, operands):
    """BN then ReLU. Train: ``nn.BatchNorm2d``'s batch statistics and
    running-stat update, then a ReLU. Eval: one pass of the f32 arithmetic
    rounded once to ``x``'s dtype, on ``operands``, the norm's ``(scale,
    shift)`` (:func:`_plain_form`), through :func:`..ops.bn_relu.bn_relu`
    (the kernel on the card); or, where the forward records gradients,
    through its plain version, which autograd differentiates."""
    if norm.training:
        return F.relu(norm(x))
    return (bn_relu_reference if torch.is_grad_enabled() else bn_relu)(x, *operands)


_data_ptr = torch.Tensor.data_ptr
_version = operator.attrgetter("_version")


def _fold_key(tensors):
    """What a fold cache keys on: the tensors, an alias of the storage each
    had (held, so no new tensor can take that address while the key lives),
    their addresses and the sum of their version counters."""
    tensors = tuple(tensors)
    return (tensors, [t.detach() for t in tensors], list(map(_data_ptr, tensors)),
            sum(map(_version, tensors)))


def _same_tensors(key, tensors):
    """Whether ``tensors`` are the very tensors of ``key`` (by identity), on
    the storage they had and at the version they had: a parameter replaced,
    moved, or edited in place fails it. A version counter only grows, so
    for the same tensors an equal sum means every version is the same."""
    kept, _, ptrs, versions = key
    return (len(tensors) == len(kept) and all(map(operator.is_, tensors, kept))
            and list(map(_data_ptr, tensors)) == ptrs
            and sum(map(_version, tensors)) == versions)


def _fold_tensors(parts):
    """What a fold of ``parts`` (BNs and convs) reads: each BN's weight,
    bias and running stats, each conv's weight, from the modules' own dicts
    (walked at every eval call, so kept cheap); and each BN's
    ``num_batches_tracked``, the one buffer whose version a train-mode
    forward bumps (its running-stat update leaves theirs as they were)."""
    tensors = []
    for part in parts:
        params = part._parameters
        if isinstance(part, nn.BatchNorm2d):
            stats = part._buffers
            tensors += (params["weight"], params["bias"], stats["running_mean"],
                        stats["running_var"], stats["num_batches_tracked"])
        else:
            tensors.append(params["weight"])
    return tensors


def eval_operands(module, form, dtype, make):
    """The operands ``make()`` builds from ``module``'s parameters for the
    path named ``form``, at activation ``dtype``: the one cache of every
    module's eval operands. In eval with autograd off (``torch.no_grad`` or
    ``torch.inference_mode``) they are made once per fold (each fold adds
    one to ``BN_FOLDS``) and kept in ``module._operands``, keyed by ``(form,
    dtype)``, while every parameter and buffer of ``module._parts()`` is the
    very tensor it was, on the same storage, at the same version
    (:func:`_same_tensors`): a replaced, moved, cast, reloaded or in-place
    edited one folds anew.

    In train mode, or where autograd records, ``make`` runs at the call and
    nothing is kept: the gradients flow through it (no kernel has a
    backward, and kept operands no graph)."""
    if module.training or torch.is_grad_enabled():
        return make()
    tensors = _fold_tensors(module._parts())
    kept = vars(module).setdefault("_operands", {})
    entry = kept.get((form, dtype))
    if entry is None or not _same_tensors(entry[0], tensors):
        entry = kept[form, dtype] = (_fold_key(tensors), make())
        BN_FOLDS.add()
    return entry[1]


def _plain_form(parts, dtype):
    """The plain path's operands for activations of ``dtype``, one for each
    module of ``parts`` in order: a BN folded to the f32 ``(scale, shift)``
    of :func:`..ops.bn_relu.bn_relu_operands` (None in train mode, where it
    takes batch statistics), a conv's weight cast to ``dtype``."""
    return tuple(p.weight.to(dtype) if not isinstance(p, nn.BatchNorm2d)
                 else None if p.training else bn_relu_operands(p) for p in parts)


def _plain_operands(module, dtype):
    """``module``'s plain form, :func:`_plain_form` of its ``_parts()``,
    from :func:`eval_operands`."""
    return eval_operands(module, "plain", dtype, lambda: _plain_form(module._parts(), dtype))


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1-BN-ReLU-Conv3x3 bottleneck emitting ``growth_rate``
    new channels (torchvision ``_DenseLayer``)."""

    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate):
        super().__init__()
        mid = bn_size * growth_rate
        # registered in the order the layer applies them: DenseBlock._parts
        self.norm1 = _batch_norm(num_input_features)
        self.conv1 = nn.Conv2d(num_input_features, mid, 1, bias=False)
        self.norm2 = _batch_norm(mid)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)
        self.drop_rate = float(drop_rate)

    def forward(self, x, ops=None):
        """``ops``: the layer's plain operands (norm1, conv1, norm2, conv2),
        kept by its block (:func:`eval_operands`); made at the call where
        not given."""
        n1, w1, n2, w2 = _plain_form(self._modules.values(), x.dtype) if ops is None else ops
        y = _conv(_bn_relu(x, self.norm1, n1), self.conv1, w1)
        y = _conv(_bn_relu(y, self.norm2, n2), self.conv2, w2)
        if self.drop_rate > 0:
            y = F.dropout(y, p=self.drop_rate, training=self.training)
        return y


class DenseBlock(nn.Module):
    """Concatenating dense block (torchvision ``_DenseBlock``): each layer
    reads the concat of the block input and every earlier layer's output.
    ``impl`` is the block's entry of ``ModelSpec.dense_block_impl``,
    ``strip`` is ``ModelSpec.dense_block_strip``. Its eval operands
    (:func:`eval_operands`) are the plain loop's and the kernels': the
    folded stacks with the bf16 kernels' packed w1 and w3
    (:func:`_block_kernel_form`)."""

    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 drop_rate, impl="concat", strip="auto"):
        super().__init__()
        self.impl = impl
        self.strip = strip
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                num_input_features + i * growth_rate, growth_rate, bn_size,
                drop_rate))

    def forward(self, x):
        """The JAX block's order: the strip gate (K5 for ``on``, else K2),
        then K4, else the loop."""
        if self._strip_eligible(x):
            run = dense_block_strip_recompute if self.strip == "on" else dense_block_strip
        elif self._k4_eligible(x):
            run = dense_block
        else:
            ops = _plain_operands(self, x.dtype)
            features = x
            for i, layer in enumerate(self.children()):
                features = torch.cat([features, layer(features, ops[4 * i:4 * i + 4])], dim=1)
            return features
        operands = eval_operands(self, "kernels", x.dtype, lambda: _block_kernel_form(self))
        return run(x.permute(0, 2, 3, 1).contiguous(), *operands).permute(0, 3, 1, 2)

    def _parts(self):
        """Each layer's norm1, conv1, norm2 and conv2, layer by layer: every
        module that holds a parameter or buffer of the block."""
        return [m for layer in self._modules.values() for m in layer._modules.values()]

    def _strip_eligible(self, x, kernel_limits=True) -> bool:
        """JAX's ``DenseBlock._strip_eligible`` with the card in the TPU's
        place: eval, ``strip`` not ``off``, no dropout, a plane of at least
        ``STRIP_MIN_PIXELS`` pixels, and JAX's strip gate for the kernel
        ``strip`` picks (the recompute kernel's for ``on``, else the
        carry kernel's); with ``kernel_limits``, the kernels' own too."""
        layers = list(self.children())
        if (self.strip == "off" or self.training
                or any(layer.drop_rate > 0 for layer in layers)
                or x.shape[2] * x.shape[3] < STRIP_MIN_PIXELS):
            return False
        growth = layers[0].conv2.out_channels
        return strip_eligible(
            x.shape[0], x.shape[2], x.shape[3], x.shape[1], growth, len(layers),
            layers[0].conv1.out_channels // growth, x.element_size(),
            carry=self.strip != "on", kernel_limits=kernel_limits)

    def _k4_eligible(self, x, kernel_limits=True) -> bool:
        """Eval, impl ``pallas``, no dropout, and JAX's sample-group rule:
        the whole block as K4 (never in train mode); with ``kernel_limits``,
        the kernel's own too."""
        layers = list(self.children())
        if (self.impl != "pallas" or self.training
                or any(layer.drop_rate > 0 for layer in layers)):
            return False
        growth = layers[0].conv2.out_channels
        return dense_block_eligible(
            len(layers), x.shape[1], growth, layers[0].conv1.out_channels // growth,
            x.shape[2], x.shape[3], dtype_bytes=x.element_size(), batch=x.shape[0],
            kernel_limits=kernel_limits)


def _block_kernel_form(block):
    """K2's, K4's and K5's operands: ``fold_block_params(block)`` and its
    ``pack_layer_weights``."""
    folded = fold_block_params(block)
    return folded, pack_layer_weights(folded)


class Transition(nn.Module):
    """BN-ReLU-Conv1x1-AvgPool2 (torchvision ``_Transition``)."""

    def __init__(self, num_input_features, num_output_features):
        super().__init__()
        self.norm = _batch_norm(num_input_features)
        self.conv = nn.Conv2d(num_input_features, num_output_features, 1, bias=False)

    def forward(self, x):
        n, w = _plain_operands(self, x.dtype)
        return F.avg_pool2d(_conv(_bn_relu(x, self.norm, n), self.conv, w), 2, 2)

    def _parts(self):
        return self.norm, self.conv


class Encoder(nn.Module):
    """DenseNet feature extractor without norm5 / classifier.

    ``up_to_block`` limits the depth to blocks and transitions
    ``1 .. up_to_block - 1`` (the mid-fusion LiDAR stream). ``forward``
    returns ``(features, skips, shapes)``: the dense-block outputs except the
    last (full depth only), and the spatial sizes the decoder restores, the
    pre-pool0 stem size first.
    """

    def __init__(self, spec: ModelSpec, in_channels: int, up_to_block=None):
        super().__init__()
        init = spec.num_init_features
        self.spec = spec
        self.conv0 = nn.Conv2d(in_channels, init, 7, stride=2, padding=3, bias=False)
        self.norm0 = _batch_norm(init)
        self.full_depth = up_to_block is None
        self.num_blocks = len(spec.block_config) if self.full_depth else up_to_block - 1
        self.last_block = len(spec.block_config) - 1
        num_features = init
        for i in range(self.num_blocks):
            num_layers = spec.block_config[i]
            self.add_module(f"denseblock{i + 1}", DenseBlock(
                num_layers, num_features, spec.bn_size, spec.growth_rate,
                spec.drop_rate, impl=spec.impl_for_block(i),
                strip=spec.dense_block_strip))
            num_features += num_layers * spec.growth_rate
            if i != self.last_block:
                self.add_module(f"transition{i + 1}",
                                Transition(num_features, num_features // 2))
                num_features //= 2
        self.num_features = num_features
        # the image encoder's stages are spans under model/forward; the
        # mid-fusion LiDAR stream is one span, model/stream_2
        self._block_spans = tuple(f"model/encoder.block{i + 1}" for i in range(self.num_blocks))
        self._transition_spans = tuple(f"model/encoder.transition{i + 1}"
                                       for i in range(self.num_blocks))

    def forward(self, x, after_transition=None):
        """``after_transition(i, x)``, if given, runs on the output of
        transition ``i`` (1-based) and replaces it: the mid-fusion hook.
        Where :func:`_stem_pool_ok` holds, the stem and pool0 run as K6 on
        its operands (:func:`_stem_pool_form`); the pre-pool stem size still
        goes onto ``shapes`` for the decoder."""
        b, c, h, w = x.shape
        span = tracing.span if self.full_depth else tracing.no_span
        with span("model/encoder.stem"):
            if _stem_pool_ok(self.spec, b, h, w, c, self.training):
                shapes = [(h // 2, w // 2)]
                x = stem_pool(x.permute(0, 2, 3, 1).contiguous(), *eval_operands(
                    self, "stem_pool", x.dtype, lambda: _stem_pool_form(self, x.dtype)))
                x = x.permute(0, 3, 1, 2)
            else:
                w, n = _plain_operands(self, x.dtype)
                x = _bn_relu(_conv(x, self.conv0, w), self.norm0, n)
                shapes = [tuple(x.shape[-2:])]
                x = F.max_pool2d(x, 3, 2, 1)
        skips = []
        for i in range(self.num_blocks):
            with span(self._block_spans[i]):
                x = getattr(self, f"denseblock{i + 1}")(x)
            if i != self.last_block:
                if self.full_depth:
                    skips.append(x)
                    shapes.append(tuple(x.shape[-2:]))
                with span(self._transition_spans[i]):
                    x = getattr(self, f"transition{i + 1}")(x)
                if after_transition is not None:
                    x = after_transition(i + 1, x)
        return x, skips, shapes

    def _parts(self):
        """The stem's conv0 and norm0: its folds read nothing of the blocks,
        which keep their own."""
        return self.conv0, self.norm0


def _stem_pool_form(encoder, dtype):
    """K6's ``(w7, gamma, beta, packed)`` for inputs of ``dtype``: conv0's
    weight as ``(7, 7, C, F)``, norm0 folded, and for bfloat16 the packed
    weight (None for float32)."""
    w7 = encoder.conv0.weight.permute(2, 3, 1, 0).contiguous()
    packed = pack_stem_weights(w7) if dtype == torch.bfloat16 else None
    return (w7, *bn_relu_operands(encoder.norm0), packed)


def _stem_pool_ok(spec, b: int, h: int, w: int, c: int, train: bool) -> bool:
    """Whether an encoder's stem + pool0 runs as K6: JAX's
    ``_stem_pool_ok`` without its TPU quarantine, as ``on`` engages in JAX
    off the TPU. ``on`` (or ``force``), eval, batch 1, and the shape in
    JAX's regime (``ops.stem_pool.eligible``)."""
    if spec.stem_pool_strip not in ("on", "force") or train or b != 1:
        return False
    return stem_pool_eligible(b, h, w, c, spec.num_init_features, spec.dtype.itemsize)


class ConcatFuse(nn.Module):
    """Mid-fusion block: BN(2C)-ReLU-Conv1x1(2C -> C) over the channel concat
    of the two streams (the reference's ``concat_module``).

    Eval with ``use_fused`` (``gpu.use_fused_kernels``) runs the fused kernel
    K1 (:func:`..ops.fused.concat_bn_relu_conv1x1`) on NHWC views of the two
    streams, so the concat never exists, on its operands
    (:func:`..ops.fused.fuse_operands`: norm folded, and for bfloat16 the
    packed conv weight); without it, and in train mode (batch statistics),
    the plain cat-BN-ReLU-conv runs.
    """

    def __init__(self, num_features, *, use_fused=True):
        super().__init__()
        self.use_fused = use_fused
        self.norm = _batch_norm(2 * num_features)
        self.conv = nn.Conv2d(2 * num_features, num_features, 1, bias=False)

    def forward(self, a, b):
        norm, conv = self.norm, self.conv
        if self.training or not self.use_fused:
            n, w = _plain_operands(self, a.dtype)
            return _conv(_bn_relu(torch.cat([a, b], dim=1), norm, n), conv, w)
        out = concat_bn_relu_conv1x1(
            a.permute(0, 2, 3, 1).contiguous(), b.permute(0, 2, 3, 1).contiguous(),
            scale=norm.weight, bias=norm.bias, mean=norm.running_mean, var=norm.running_var,
            weight=conv.weight, eps=norm.eps,
            operands=eval_operands(self, "fused", a.dtype, lambda: fuse_operands(
                norm.weight, norm.bias, norm.running_mean, norm.running_var, conv.weight,
                norm.eps, a.dtype)),
        )
        return out.permute(0, 3, 1, 2)

    def _parts(self):
        return self.norm, self.conv


class ConvTransposeToShape(nn.ConvTranspose2d):
    """Transposed conv (k=3, s=2, p=1) to a requested spatial size: the
    output padding is ``target - (2 * in - 1)`` per axis and must be 0 or 1
    (the reference's ``output_size=`` call). It runs on its weight cast to
    the activation dtype (:func:`eval_operands`)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=1,
                         bias=False)

    def forward(self, x, target_hw):
        pad = tuple(t - (2 * s - 1) for t, s in zip(target_hw, x.shape[-2:]))
        if not all(p in (0, 1) for p in pad):
            raise ValueError(
                f"requested output size {tuple(target_hw)} unreachable from "
                f"input {tuple(x.shape[-2:])} with stride 2 (output_padding {pad})")
        (weight,) = _plain_operands(self, x.dtype)
        return F.conv_transpose2d(x, weight, None, 2, 1, pad)

    def _parts(self):
        return (self,)


class DecoderStage(nn.Module):
    """One U-Net decoder stage before its transposed conv: concat with the
    encoder skip (all stages but the first), then BN-ReLU-Conv1x1(reduce)-
    BN-ReLU. The reference's ``Transposed_Convolution_Sequence_N``."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.norm0 = _batch_norm(in_channels)
        self.conv_reduce = nn.Conv2d(in_channels, features, 1, bias=False)
        self.norm1 = _batch_norm(features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        n0, w, n1 = _plain_operands(self, x.dtype)
        return _bn_relu(_conv(_bn_relu(x, self.norm0, n0), self.conv_reduce, w), self.norm1, n1)

    def _parts(self):
        return self.norm0, self.conv_reduce, self.norm1


class Decoder(nn.Module):
    """The decoder stages in application order: stage N is
    ``Transposed_Convolution_Sequence_N`` then ``Transposed_Convolution_N``.
    Stage 1 runs on the bottleneck; each later stage concatenates the skip
    popped from the encoder's stack, which is as wide as the previous
    stage's output."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        stage_features = spec.decoder_stage_features()
        _, in_channels = spec.encoder_feature_sizes()
        for n, features in enumerate(stage_features, start=1):
            self.add_module(f"Transposed_Convolution_Sequence_{n}",
                            DecoderStage(in_channels, features))
            self.add_module(f"Transposed_Convolution_{n}",
                            ConvTransposeToShape(features, features))
            in_channels = 2 * features
        self.num_stages = len(stage_features)

    def forward(self, x, skips, shapes):
        skips, shapes = list(skips), list(shapes)
        for n in range(1, self.num_stages + 1):
            skip = skips.pop() if n > 1 else None
            x = getattr(self, f"Transposed_Convolution_Sequence_{n}")(x, skip)
            x = getattr(self, f"Transposed_Convolution_{n}")(x, shapes.pop())
        if skips or shapes:
            raise ValueError(f"{len(skips)} skips and {len(shapes)} shapes left "
                             "over after the decoder")
        return x


class Head(nn.Module):
    """Heat-map logits: nearest 2x upsample, concat with the raw network
    input, then BN-ReLU-Conv3x3-BN-ReLU-Conv5x5 (``dec_out_to_heat_maps``).

    Dispatched as JAX's ``Head``. With ``use_fused`` (``gpu.use_fused_kernels``)
    and at most ``fused_max_pixels`` output pixels:

    * eval at batch 1 on a plane of more than ``HEAD_KERNEL_MIN_PIXELS``
      pixels, within K3's limits: K3 (:func:`..ops.phase_head.phase_head`) on
      NHWC views, so the upsample, the concat and the mid tensor never exist
      in memory;
    * other eval calls: the phase-space head
      (:func:`..ops.phase_head.phase_space_head`), BN folded from the
      running stats.

    Otherwise, and in train mode, the plain head runs (JAX trains with its
    phase-space train head, ``Head._phase_head_train``, the same function:
    not ported, ``ROADMAP.md``). Its eval operands (:func:`eval_operands`)
    are the plain head's, and the norms folded beside K3's weights
    (:func:`..ops.phase_head.kernel_weights`) or the phase-space head's
    (:func:`..ops.phase_head.phase_space_weights`, folded in f32, cast to
    the activation dtype)."""

    def __init__(self, up_channels, raw_channels, mid_features, num_classes, *,
                 use_fused=True, fused_max_pixels=1 << 62):
        super().__init__()
        self.up_channels = up_channels
        self.use_fused = use_fused
        self.fused_max_pixels = fused_max_pixels
        self.norm0 = _batch_norm(up_channels + raw_channels)
        self.refine0 = nn.Conv2d(up_channels + raw_channels, mid_features, 3,
                                 padding=1, bias=False)
        self.norm1 = _batch_norm(mid_features)
        self.refine1 = nn.Conv2d(mid_features, num_classes, 5, padding=2, bias=False)

    def forward(self, x_lo, raw):
        dt = x_lo.dtype
        if not self.training and self._fused_eligible(x_lo, raw):
            w0, w1 = self.refine0.weight, self.refine1.weight
            if self._kernel_eligible(x_lo, raw):
                g0, b0, g1, b1, *weights = eval_operands(self, "phase_head", dt, lambda: (
                    *self._norm_folds(), *phase_head_weights(w0, w1, self.up_channels, dt)))
                out = phase_head(x_lo.permute(0, 2, 3, 1).contiguous(),
                                 raw.permute(0, 2, 3, 1).contiguous(),
                                 g0=g0, b0=b0, w0=w0, g1=g1, b1=b1, w1=w1, weights=weights)
                return out.permute(0, 3, 1, 2)
            g0, b0, g1, b1, w0t, w4t = eval_operands(self, "phase_space", dt, lambda: (
                *self._norm_folds(),
                *(w.to(dt) for w in phase_space_weights(w0, w1, self.up_channels))))
            return phase_space_head(x_lo, raw, g0=g0, b0=b0, g1=g1, b1=b1, w0t=w0t, w4t=w4t)
        n0, w0, n1, w1 = _plain_operands(self, dt)
        x = torch.cat([F.interpolate(x_lo, scale_factor=2, mode="nearest"), raw], dim=1)
        x = _conv(_bn_relu(x, self.norm0, n0), self.refine0, w0)
        return _conv(_bn_relu(x, self.norm1, n1), self.refine1, w1)

    def _parts(self):
        return self.norm0, self.refine0, self.norm1, self.refine1

    def _norm_folds(self):
        """``(g0, b0, g1, b1)``: norm0 and norm1 folded in f32."""
        return (*bn_relu_operands(self.norm0), *bn_relu_operands(self.norm1))

    def _fused_eligible(self, x_lo, raw) -> bool:
        """JAX's ``Head._fused_eligible``: ``use_fused``, the raw plane twice
        ``x_lo``'s and at most ``fused_max_pixels`` pixels."""
        h, w = raw.shape[-2:]
        return (self.use_fused and (h, w) == (2 * x_lo.shape[-2], 2 * x_lo.shape[-1])
                and h * w <= self.fused_max_pixels)

    def _kernel_eligible(self, x_lo, raw, kernel_limits=True) -> bool:
        """JAX's K3 gate (the fused head, eval, batch 1, a plane of more than
        ``HEAD_KERNEL_MIN_PIXELS``) and, with ``kernel_limits``, the kernel's
        own limits (:func:`..ops.phase_head.within_limits`: c_mid, classes
        and, in bf16, the source's width). A head past them runs the
        phase-space head where JAX runs its kernel; every DenseNet's head of
        the repo is within them."""
        h, w = raw.shape[-2:]
        within = not kernel_limits or phase_head_within_limits(
            self.up_channels + 4 * raw.shape[1], self.refine0.out_channels,
            self.refine1.out_channels, x_lo.dtype)
        return (within and self._fused_eligible(x_lo, raw) and not self.training
                and raw.shape[0] == 1 and h * w > HEAD_KERNEL_MIN_PIXELS)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX model's init: every conv kernel kaiming-normal over its fan-in
    (``variance_scaling(2, "fan_in", "normal")``; for a transposed conv the
    fan-in is its input channels times the taps), BN weight 1, bias 0,
    running mean 0 and variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _to_internal(x, dtype):
    """NHWC -> an NCHW view that is channels_last in memory, in ``dtype``."""
    return x.contiguous().to(dtype).permute(0, 3, 1, 2)


class DenseUNetLidar(nn.Module):
    """The full dual-stream Dense U-Net.

    ``forward(stream_1_data, stream_2_data=None)`` takes NHWC inputs —
    ``(B, H, W, stream_1_in_channels)`` and ``(B, H, W,
    stream_2_in_channels)`` (unused for 'no' fusion) — and returns ``(B, H,
    W, num_classes)`` logits in ``spec.dtype``. H and W must reduce cleanly
    through 5 stride-2 stages (e.g. multiples of 32). Weights are initialised
    from ``generator`` (seed 0 if none is given). The forward's stages are
    spans (``model/stream_2``, ``model/encoder.*``, ``model/fuse``,
    ``model/decoder``, ``model/head``; :mod:`..tracing`), recorded only
    while the recorder is on or a profiler runs.
    """

    def __init__(self, spec: ModelSpec, *, generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        fusion = spec.fusion
        self.features = Encoder(spec, spec.network_input_channels)
        if fusion == "mid":
            self.stream_2_features = Encoder(
                spec, spec.stream_2_in_channels,
                up_to_block=spec.concat_before_block_num)
            self.concat_module = ConcatFuse(self.stream_2_features.num_features,
                                            use_fused=spec.use_fused_kernels)
        self.decoder = Decoder(spec)
        raw_channels = spec.stream_1_in_channels + (
            spec.stream_2_in_channels if fusion != "no" else 0)
        up = spec.decoder_stage_features()[-1]
        self.dec_out_to_heat_maps = Head(
            up, raw_channels, up // 2, spec.num_classes, use_fused=spec.use_fused_kernels,
            fused_max_pixels=spec.fused_head_max_pixels)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, stream_1_data, stream_2_data=None):
        spec = self.spec
        fusion = spec.fusion
        s1 = _to_internal(stream_1_data, spec.dtype)
        if fusion == "no":
            raw = enc_in = s1
        else:
            if stream_2_data is None:
                raise ValueError(f"{fusion} fusion needs stream_2_data")
            s2 = _to_internal(stream_2_data, spec.dtype)
            raw = torch.cat([s1, s2], dim=1)
            enc_in = raw if fusion == "early" else s1

        if fusion == "mid":
            with tracing.span("model/stream_2"):
                s2_features, _, _ = self.stream_2_features(s2)
            fuse_at = spec.concat_before_block_num - 1

            def fuse(i, x):
                if i != fuse_at:
                    return x
                if x.shape != s2_features.shape:
                    raise ValueError(f"streams disagree at the fusion point: "
                                     f"{tuple(x.shape)} vs {tuple(s2_features.shape)}")
                with tracing.span("model/fuse"):
                    return self.concat_module(x, s2_features)

            x, skips, shapes = self.features(enc_in, after_transition=fuse)
        else:
            x, skips, shapes = self.features(enc_in)

        with tracing.span("model/decoder"):
            x = self.decoder(x, skips, shapes)
        with tracing.span("model/head"):
            return self.dec_out_to_heat_maps(x, raw).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Public constructors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelBundle:
    """Module + config + spec, as the JAX package's ``ModelBundle`` (whose
    variables here live inside the module)."""

    module: DenseUNetLidar
    config: Any
    spec: ModelSpec

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device


def _dense_u_net_lidar(arch, growth_rate, block_config, num_init_features,
                       pretrained, progress, config, *, device="cuda", seed=None):
    """Build a bundle whose module is on ``device`` (the card unless the
    caller names another), in eval mode, with channels_last weights. Like
    the JAX constructor it overwrites the architecture fields of
    ``config.model``; ``seed`` defaults to ``config.agent.seed``."""
    from ..config import get_config

    if pretrained:
        raise NotImplementedError(
            f"pretrained=True needs the torchvision {arch} import, which the "
            "port does not have yet (ROADMAP.md, module queue)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{arch}_u_lidar builds on the GPU (device={str(device)!r}) and this "
            "machine has no CUDA device; pass device='cpu' to build on the CPU")
    if config is None:
        config = get_config()
    config.model.growth_rate = growth_rate
    config.model.block_config = block_config
    config.model.num_init_features = num_init_features

    spec = ModelSpec.from_config(config)
    seed = config.agent.seed if seed is None else seed
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(seed))
    module = module.to(device=device, memory_format=torch.channels_last).eval()
    return ModelBundle(module=module, config=config, spec=spec)


def densenet121_u_lidar(pretrained=False, progress=True, config=None, **kwargs):
    """DenseNet-121 backbone variant."""
    return _dense_u_net_lidar("densenet121", 32, (6, 12, 24, 16), 64,
                              pretrained, progress, config, **kwargs)


def densenet161_u_lidar(pretrained=False, progress=True, config=None, **kwargs):
    """DenseNet-161 backbone variant."""
    return _dense_u_net_lidar("densenet161", 48, (6, 12, 36, 24), 96,
                              pretrained, progress, config, **kwargs)


def densenet169_u_lidar(pretrained=False, progress=True, config=None, **kwargs):
    """DenseNet-169 backbone variant."""
    return _dense_u_net_lidar("densenet169", 32, (6, 12, 32, 32), 64,
                              pretrained, progress, config, **kwargs)


def densenet201_u_lidar(pretrained=False, progress=True, config=None, **kwargs):
    """DenseNet-201 backbone variant."""
    return _dense_u_net_lidar("densenet201", 32, (6, 12, 48, 32), 64,
                              pretrained, progress, config, **kwargs)
