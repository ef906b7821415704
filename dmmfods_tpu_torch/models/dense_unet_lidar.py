"""Dense U-Net LiDAR in PyTorch: the port of
``dmmfods_tpu/models/dense_unet_lidar.py``.

A DenseNet encoder with an optional parallel LiDAR stream (no / early / mid
fusion, chosen by the same config fields), a U-Net transposed-conv decoder
fed by the encoder's skip stack, and a refinement head that emits per-pixel
class heat-map LOGITS. The channel arithmetic, the skip and shape stacks and
the module names are the JAX model's; the module names are also the
reference torch network's, so ``dmmfods_tpu.models.torch_port`` maps this
model's ``state_dict`` onto the JAX variables key for key.

Only the math is ported. The JAX model's TPU lowering options (rows-as-batch
forms, dense-block buffers, strip kernels, the phase-space head rewrite)
have no counterpart here: each one computes the plain form below.

Layout: :meth:`DenseUNetLidar.forward` takes and returns NHWC tensors, like
the JAX model. Inside, tensors are NCHW in shape and ``channels_last`` in
memory; permuting a contiguous NHWC tensor gives exactly that, at no cost.

Dtypes, by explicit casts (no autocast): params and BN running stats are
float32. The model casts its inputs to ``spec.dtype`` (``gpu.compute_dtype``,
bfloat16 by default) and every conv casts its weight to the activation dtype
at the call. In eval mode every BN folds its running stats into a
per-channel ``(gamma, beta)`` in float32 and applies them in the activation
dtype, as ``dmmfods_tpu/ops/normalization.py`` does; in train mode it is
``nn.BatchNorm2d``'s own batch-stat forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused import concat_bn_relu_conv1x1

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Model spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description, derived from ``config.model``.

    Field defaults equal the config defaults (DenseNet-121, mid fusion).
    ``num_layers_before_blocks`` and ``memory_efficient`` of the config
    change nothing in the math and are not read."""

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


def _conv(x, conv: nn.Conv2d):
    """``conv`` in the activation dtype (its f32 weight cast at the call)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


def _bn(x, norm: nn.BatchNorm2d):
    """Eval: the f32-folded running stats applied in ``x``'s dtype. Train:
    ``nn.BatchNorm2d``'s batch statistics and running-stat update."""
    if norm.training:
        return norm(x)
    gamma = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
    beta = norm.bias - norm.running_mean * gamma
    dt = x.dtype
    return x * gamma.to(dt)[:, None, None] + beta.to(dt)[:, None, None]


def _bn_relu(x, norm):
    return F.relu(_bn(x, norm))


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1-BN-ReLU-Conv3x3 bottleneck emitting ``growth_rate``
    new channels (torchvision ``_DenseLayer``)."""

    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = _batch_norm(num_input_features)
        self.conv1 = nn.Conv2d(num_input_features, mid, 1, bias=False)
        self.norm2 = _batch_norm(mid)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)
        self.drop_rate = float(drop_rate)

    def forward(self, x):
        y = _conv(_bn_relu(x, self.norm1), self.conv1)
        y = _conv(_bn_relu(y, self.norm2), self.conv2)
        if self.drop_rate > 0:
            y = F.dropout(y, p=self.drop_rate, training=self.training)
        return y


class DenseBlock(nn.Module):
    """Concatenating dense block (torchvision ``_DenseBlock``): each layer
    reads the concat of the block input and every earlier layer's output."""

    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 drop_rate):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                num_input_features + i * growth_rate, growth_rate, bn_size,
                drop_rate))

    def forward(self, x):
        features = x
        for layer in self.children():
            features = torch.cat([features, layer(features)], dim=1)
        return features


class Transition(nn.Module):
    """BN-ReLU-Conv1x1-AvgPool2 (torchvision ``_Transition``)."""

    def __init__(self, num_input_features, num_output_features):
        super().__init__()
        self.norm = _batch_norm(num_input_features)
        self.conv = nn.Conv2d(num_input_features, num_output_features, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(_conv(_bn_relu(x, self.norm), self.conv), 2, 2)


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
                spec.drop_rate))
            num_features += num_layers * spec.growth_rate
            if i != self.last_block:
                self.add_module(f"transition{i + 1}",
                                Transition(num_features, num_features // 2))
                num_features //= 2
        self.num_features = num_features

    def forward(self, x, after_transition=None):
        """``after_transition(i, x)``, if given, runs on the output of
        transition ``i`` (1-based) and replaces it: the mid-fusion hook."""
        x = _bn_relu(_conv(x, self.conv0), self.norm0)
        shapes = [tuple(x.shape[-2:])]
        x = F.max_pool2d(x, 3, 2, 1)
        skips = []
        for i in range(self.num_blocks):
            x = getattr(self, f"denseblock{i + 1}")(x)
            if i != self.last_block:
                if self.full_depth:
                    skips.append(x)
                    shapes.append(tuple(x.shape[-2:]))
                x = getattr(self, f"transition{i + 1}")(x)
                if after_transition is not None:
                    x = after_transition(i + 1, x)
        return x, skips, shapes


class ConcatFuse(nn.Module):
    """Mid-fusion block: BN(2C)-ReLU-Conv1x1(2C -> C) over the channel concat
    of the two streams (the reference's ``concat_module``).

    Eval runs the fused kernel K1 (:func:`..ops.fused.concat_bn_relu_conv1x1`)
    on NHWC views of the two streams, so the concat never exists; train runs
    the plain cat-BN-ReLU-conv with batch statistics.
    """

    def __init__(self, num_features):
        super().__init__()
        self.norm = _batch_norm(2 * num_features)
        self.conv = nn.Conv2d(2 * num_features, num_features, 1, bias=False)

    def forward(self, a, b):
        if self.training:
            return _conv(_bn_relu(torch.cat([a, b], dim=1), self.norm), self.conv)
        out = concat_bn_relu_conv1x1(
            a.permute(0, 2, 3, 1).contiguous(), b.permute(0, 2, 3, 1).contiguous(),
            scale=self.norm.weight, bias=self.norm.bias,
            mean=self.norm.running_mean, var=self.norm.running_var,
            weight=self.conv.weight, eps=self.norm.eps,
        )
        return out.permute(0, 3, 1, 2)


class ConvTransposeToShape(nn.ConvTranspose2d):
    """Transposed conv (k=3, s=2, p=1) to a requested spatial size: the
    output padding is ``target - (2 * in - 1)`` per axis and must be 0 or 1
    (the reference's ``output_size=`` call)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=1,
                         bias=False)

    def forward(self, x, target_hw):
        pad = tuple(t - (2 * s - 1) for t, s in zip(target_hw, x.shape[-2:]))
        if not all(p in (0, 1) for p in pad):
            raise ValueError(
                f"requested output size {tuple(target_hw)} unreachable from "
                f"input {tuple(x.shape[-2:])} with stride 2 (output_padding {pad})")
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, 2, 1, pad)


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
        return _bn_relu(_conv(_bn_relu(x, self.norm0), self.conv_reduce), self.norm1)


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
    input, then BN-ReLU-Conv3x3-BN-ReLU-Conv5x5 (``dec_out_to_heat_maps``)."""

    def __init__(self, up_channels, raw_channels, mid_features, num_classes):
        super().__init__()
        self.norm0 = _batch_norm(up_channels + raw_channels)
        self.refine0 = nn.Conv2d(up_channels + raw_channels, mid_features, 3,
                                 padding=1, bias=False)
        self.norm1 = _batch_norm(mid_features)
        self.refine1 = nn.Conv2d(mid_features, num_classes, 5, padding=2, bias=False)

    def forward(self, x_lo, raw):
        x = torch.cat([F.interpolate(x_lo, scale_factor=2, mode="nearest"), raw], dim=1)
        x = _conv(_bn_relu(x, self.norm0), self.refine0)
        return _conv(_bn_relu(x, self.norm1), self.refine1)


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
    from ``generator`` (seed 0 if none is given).
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
            self.concat_module = ConcatFuse(self.stream_2_features.num_features)
        self.decoder = Decoder(spec)
        raw_channels = spec.stream_1_in_channels + (
            spec.stream_2_in_channels if fusion != "no" else 0)
        up = spec.decoder_stage_features()[-1]
        self.dec_out_to_heat_maps = Head(up, raw_channels, up // 2, spec.num_classes)
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
            s2_features, _, _ = self.stream_2_features(s2)
            fuse_at = spec.concat_before_block_num - 1

            def fuse(i, x):
                if i != fuse_at:
                    return x
                if x.shape != s2_features.shape:
                    raise ValueError(f"streams disagree at the fusion point: "
                                     f"{tuple(x.shape)} vs {tuple(s2_features.shape)}")
                return self.concat_module(x, s2_features)

            x, skips, shapes = self.features(enc_in, after_transition=fuse)
        else:
            x, skips, shapes = self.features(enc_in)

        x = self.decoder(x, skips, shapes)
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
                       pretrained, progress, config, *, device="cpu", seed=None):
    """Build a bundle whose module is on ``device``, in eval mode, with
    channels_last weights. Like the JAX constructor it overwrites the
    architecture fields of ``config.model``; ``seed`` defaults to
    ``config.agent.seed``."""
    from ..config import get_config

    if pretrained:
        raise NotImplementedError(
            f"pretrained=True needs the torchvision {arch} import, which the "
            "port does not have yet (ROADMAP.md, module queue)")
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
