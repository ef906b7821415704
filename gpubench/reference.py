"""The plain reference: the Dense U-Net LiDAR network in stock PyTorch.

A frozen copy of the architecture the benchmark holds the program to,
written from its description and not from the program: a DenseNet encoder
(torchvision's ``_DenseLayer``, ``_DenseBlock`` and ``_Transition``), a
second encoder over the LiDAR stream up to the fusion point joined by a
concat + BN + ReLU + 1x1 (mid fusion), a U-Net decoder of 1x1 reductions and
stride-2 transposed convs fed by the encoder's skips, and the head: nearest
2x upsample, concat with the raw input, BN-ReLU-3x3, BN-ReLU-5x5. Module
names are the DMMFODS network's, so one ``state_dict`` loads here and into
the program. Plain ``nn.BatchNorm2d`` (eval: running stats; train: batch
stats), plain convs, no fold, no packing, no kernel.

It imports nothing of the program. Run it in float32 with TF32 off
(:func:`strict_fp32`). ``quant="fp8"`` is the control: every conv's input
and weight rounded to float8 e4m3 with a per-tensor scale (amax to 448), as
an fp8 GEMM takes them, and in training the gradients flowing back through
the activations to float8 e5m2 (fp8 training's usual pair); the rest in
float32.

Also here: the sum-BCE loss, which the training operation count's test
backs through the network.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def strict_fp32():
    """A context with TF32 off for matmuls and cuDNN convs; restores the
    previous settings on exit."""
    @contextlib.contextmanager
    def ctx():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return ctx()


def _round(x, dtype, top):
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundWeight(torch.autograd.Function):
    """A weight rounded to float8 e4m3 with a per-tensor scale; its gradient
    (a GEMM's output, accumulated in float32) passes through."""

    @staticmethod
    def forward(ctx, w):
        return _round(w, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundActivation(torch.autograd.Function):
    """An activation rounded to float8 e4m3 with a per-tensor scale, and the
    gradient that flows back through it, the operand of the next backward
    GEMMs, to float8 e5m2 with its own: fp8 training's usual pair."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, FP8_E5M2_MAX)


def _q(x, quant):
    return _RoundActivation.apply(x) if quant == "fp8" else x


def _qw(w, quant):
    return _RoundWeight.apply(w) if quant == "fp8" else w


class Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        return F.conv2d(_q(x, self.quant), _qw(self.weight, self.quant), None, self.stride,
                        self.padding)


class ConvT(nn.ConvTranspose2d):
    """3x3 stride-2 transposed conv to a requested output size."""
    quant = None

    def forward(self, x, size):
        pad = tuple(t - (2 * s - 1) for t, s in zip(size, x.shape[-2:]))
        return F.conv_transpose2d(_q(x, self.quant), _qw(self.weight, self.quant), None, 2, 1,
                                  pad)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class DenseLayer(nn.Module):
    def __init__(self, c_in, growth, bn_size):
        super().__init__()
        self.norm1 = _bn(c_in)
        self.conv1 = Conv(c_in, bn_size * growth, 1, bias=False)
        self.norm2 = _bn(bn_size * growth)
        self.conv2 = Conv(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x):
        return self.conv2(F.relu(self.norm2(self.conv1(F.relu(self.norm1(x))))))


class Transition(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm = _bn(c_in)
        self.conv = Conv(c_in, c_out, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class Encoder(nn.Module):
    """Stem, pool0 and ``num_blocks`` dense blocks, each but the network's
    last followed by its transition."""

    def __init__(self, arch, c_in, num_blocks):
        super().__init__()
        growth, blocks, init, bn_size = (arch["growth_rate"], arch["block_config"],
                                         arch["num_init_features"], arch["bn_size"])
        self.conv0 = Conv(c_in, init, 7, stride=2, padding=3, bias=False)
        self.norm0 = _bn(init)
        self.num_blocks = num_blocks
        self.last = len(blocks) - 1
        c = init
        for i in range(num_blocks):
            block = nn.Module()
            for l in range(blocks[i]):
                block.add_module(f"denselayer{l + 1}", DenseLayer(c + l * growth, growth,
                                                                  bn_size))
            self.add_module(f"denseblock{i + 1}", block)
            c += blocks[i] * growth
            if i != self.last:
                self.add_module(f"transition{i + 1}", Transition(c, c // 2))
                c //= 2

    def forward(self, x, fuse=None):
        """``(features, skips, sizes)``; ``fuse(i, x)`` replaces the output
        of transition ``i``."""
        x = F.relu(self.norm0(self.conv0(x)))
        sizes, skips = [tuple(x.shape[-2:])], []
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_blocks):
            for layer in getattr(self, f"denseblock{i + 1}").children():
                x = torch.cat([x, layer(x)], 1)
            if i != self.last:
                skips.append(x)
                sizes.append(tuple(x.shape[-2:]))
                x = getattr(self, f"transition{i + 1}")(x)
                if fuse is not None:
                    x = fuse(i + 1, x)
        return x, skips, sizes


def stage_widths(arch):
    """The decoder's stage widths in order of application and the
    bottleneck's width, from the DenseNet's channel arithmetic."""
    growth, blocks, init = arch["growth_rate"], arch["block_config"], arch["num_init_features"]
    widths, c = [init + 2 * growth], init
    for i, n in enumerate(blocks):
        c += n * growth
        widths.append(c)
        if i != len(blocks) - 1:
            c //= 2
    bottleneck = widths.pop()
    return widths[::-1], bottleneck


class Head(nn.Module):
    def __init__(self, c_up, c_raw, c_mid, n_cls):
        super().__init__()
        self.norm0 = _bn(c_up + c_raw)
        self.refine0 = Conv(c_up + c_raw, c_mid, 3, padding=1, bias=False)
        self.norm1 = _bn(c_mid)
        self.refine1 = Conv(c_mid, n_cls, 5, padding=2, bias=False)

    def forward(self, x, raw):
        x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), raw], 1)
        return self.refine1(F.relu(self.norm1(self.refine0(F.relu(self.norm0(x))))))


class ReferenceNet(nn.Module):
    """Mid fusion only: the RGB stream through the whole encoder, the LiDAR
    stream through blocks ``1 .. concat_before_block_num - 1``, joined after
    that transition. NHWC float inputs, NHWC logits."""

    def __init__(self, arch):
        super().__init__()
        fuse_before = arch["concat_before_block_num"]
        if not 1 < fuse_before <= len(arch["block_config"]):
            raise ValueError("the reference covers mid fusion only")
        self.fuse_at = fuse_before - 1
        c_rgb, c_lidar = arch["stream_1_in_channels"], arch["stream_2_in_channels"]
        self.features = Encoder(arch, c_rgb, len(arch["block_config"]))
        self.stream_2_features = Encoder(arch, c_lidar, self.fuse_at)
        c_fuse = arch["num_init_features"]
        for n in arch["block_config"][:self.fuse_at]:
            c_fuse = (c_fuse + n * arch["growth_rate"]) // 2
        self.concat_module = nn.Module()
        self.concat_module.norm = _bn(2 * c_fuse)
        self.concat_module.conv = Conv(2 * c_fuse, c_fuse, 1, bias=False)
        widths, c_in = stage_widths(arch)
        self.decoder = nn.Module()
        for n, f in enumerate(widths, start=1):
            stage = nn.Module()
            stage.norm0 = _bn(c_in)
            stage.conv_reduce = Conv(c_in, f, 1, bias=False)
            stage.norm1 = _bn(f)
            self.decoder.add_module(f"Transposed_Convolution_Sequence_{n}", stage)
            self.decoder.add_module(f"Transposed_Convolution_{n}", ConvT(f, f, 3, bias=False))
            c_in = 2 * f
        self.num_stages = len(widths)
        self.dec_out_to_heat_maps = Head(widths[-1], c_rgb + c_lidar, widths[-1] // 2,
                                         arch["num_classes"])

    def set_quant(self, quant):
        """``None`` for float32, ``"fp8"`` for the control."""
        for m in self.modules():
            if isinstance(m, (Conv, ConvT)):
                m.quant = quant
        return self

    def forward(self, rgb, lidar):
        dtype = self.features.conv0.weight.dtype
        s1 = rgb.permute(0, 3, 1, 2).to(dtype)
        s2 = lidar.permute(0, 3, 1, 2).to(dtype)
        s2_features, _, _ = self.stream_2_features(s2)
        cm = self.concat_module

        def fuse(i, x):
            if i != self.fuse_at:
                return x
            return cm.conv(F.relu(cm.norm(torch.cat([x, s2_features], 1))))

        x, skips, sizes = self.features(s1, fuse)
        for n in range(1, self.num_stages + 1):
            stage = getattr(self.decoder, f"Transposed_Convolution_Sequence_{n}")
            if n > 1:
                x = torch.cat([x, skips.pop()], 1)
            x = F.relu(stage.norm1(stage.conv_reduce(F.relu(stage.norm0(x)))))
            x = getattr(self.decoder, f"Transposed_Convolution_{n}")(x, sizes.pop())
        out = self.dec_out_to_heat_maps(x, torch.cat([s1, s2], 1))
        return out.permute(0, 2, 3, 1)


def bce_sum(logits, targets):
    """Sum of the element-wise sigmoid BCE on logits."""
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="sum")


def forward_in_chunks(net, rgb, lidar, chunk):
    """Eval logits of ``net`` over frames in chunks of ``chunk`` (so that a
    large batch fits), each chunk copied to the net's device."""
    device = next(net.parameters()).device
    outs = []
    with torch.no_grad():
        for s in range(0, rgb.shape[0], chunk):
            r = torch.as_tensor(rgb[s:s + chunk]).to(device)
            l = torch.as_tensor(lidar[s:s + chunk]).to(device)
            outs.append(net(r, l).float().cpu())
    return torch.cat(outs)


def param_count(arch):
    return sum(p.numel() for p in ReferenceNet(arch).to("meta").parameters())


def kaiming_std(shape, transposed):
    """The DMMFODS init's kaiming-normal std over a conv's fan-in (a
    transposed conv's fan-in is its input channels times its taps)."""
    fan_in = (shape[0] if transposed else shape[1]) * math.prod(shape[2:])
    return math.sqrt(2.0 / fan_in)
