"""The yardstick's arithmetic: the card's peaks, the network's operations
counted from shapes, and the bounds of the kernels whose roofline share the
benchmark reports.

Operations are multiply-adds times two. :func:`conv_ops` lists every conv of
the network at a frame size, as ``torch.utils.flop_counter.FlopCounterMode``
counts it over the plain reference (a transposed conv's nine taps at each
*input* pixel). :func:`frame_flops` sums them for a frame, forward (serving)
or forward + backward (training: twice the forward for each conv whose
input needs a gradient, once for the stems, whose input does not), with one
rule of its own: the head's refine0 counts its upsampled input as the 2x2
collapse that the nearest upsample allows (16 c_up c_mid + 36 rc c_mid
multiply-adds a low-res pixel in place of 36 (c_up + rc) c_mid), the work
the architecture needs, so the count does not depend on what implements
the head.
"""

from __future__ import annotations

from .reference import stage_widths

# NVIDIA's data sheet for the H100 SXM at its full 700 W, dense rates
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# where the port's strip gate puts K2 (the program's STRIP_MIN_PIXELS): a
# batch-1 dense block of at least this plane; k2_roofline reads nothing
# where the program's launches disagree
K2_MIN_PIXELS = 16384


def _planes(h, w, n):
    """The plane after each of ``n`` halvings (ceil, as a stride-2 conv or a
    padded pool gives), starting from ``(h, w)``."""
    out = [(h, w)]
    for _ in range(n):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def _encoder(arch, c_in, num_blocks, h, w, tag):
    """The convs of one encoder and its blocks as ``(name, plane, c0,
    layers)``."""
    growth, blocks, init, k = (arch["growth_rate"], arch["block_config"],
                               arch["num_init_features"], arch["bn_size"] * arch["growth_rate"])
    planes = _planes(h, w, 2 + len(blocks))
    ops = [(f"{tag}.conv0", planes[1], c_in, init, 49, False)]
    block_list, c = [], init
    for i in range(num_blocks):
        p = planes[2 + i]
        block_list.append((f"{tag}.denseblock{i + 1}", p, c, blocks[i]))
        for l in range(blocks[i]):
            ops.append((f"{tag}.denseblock{i + 1}.denselayer{l + 1}.conv1", p,
                        c + l * growth, k, 1, True))
            ops.append((f"{tag}.denseblock{i + 1}.denselayer{l + 1}.conv2", p, k, growth, 9,
                        True))
        c += blocks[i] * growth
        if i != len(blocks) - 1:
            ops.append((f"{tag}.transition{i + 1}.conv", p, c, c // 2, 1, True))
            c //= 2
    return ops, block_list, c


def conv_ops(arch, h, w):
    """Every conv of the mid-fusion network on an ``h`` x ``w`` frame:
    ``(name, (plane h, plane w), c_in, c_out, taps, input needs grad)``; a
    transposed conv's plane is its input's."""
    fuse_at = arch["concat_before_block_num"] - 1
    planes = _planes(h, w, 2 + len(arch["block_config"]))
    ops, _, _ = _encoder(arch, arch["stream_1_in_channels"], len(arch["block_config"]), h, w,
                         "features")
    s2, _, c_fuse = _encoder(arch, arch["stream_2_in_channels"], fuse_at, h, w,
                             "stream_2_features")
    ops += s2
    ops.append(("concat_module.conv", planes[2 + fuse_at], 2 * c_fuse, c_fuse, 1, True))
    widths, c_in = stage_widths(arch)
    n = len(widths)
    for s, f in enumerate(widths, start=1):
        p = planes[1 + n + 1 - s]        # stage 1 on the bottleneck's plane
        ops.append((f"decoder.Transposed_Convolution_Sequence_{s}.conv_reduce", p, c_in, f, 1,
                    True))
        ops.append((f"decoder.Transposed_Convolution_{s}", p, f, f, 9, True))
        c_in = 2 * f
    c_up, c_raw = widths[-1], arch["stream_1_in_channels"] + arch["stream_2_in_channels"]
    ops.append(("dec_out_to_heat_maps.refine0", (h, w), c_up + c_raw, c_up // 2, 9, True))
    ops.append(("dec_out_to_heat_maps.refine1", (h, w), c_up // 2, arch["num_classes"], 25,
                True))
    return ops


def _op_flops(op):
    _, (ph, pw), c_in, c_out, taps, _ = op
    return 2 * ph * pw * c_in * c_out * taps


def frame_flops(arch, h, w, train=False, collapse=True):
    """Operations of one frame: the forward, or with ``train`` forward and
    backward; ``collapse`` applies the head's refine0 rule above."""
    total = 0
    for op in conv_ops(arch, h, w):
        f = _op_flops(op)
        if collapse and op[0] == "dec_out_to_heat_maps.refine0":
            c_up = stage_widths(arch)[0][-1]
            c_raw = op[2] - c_up
            f = 2 * (h // 2) * (w // 2) * (16 * c_up + 36 * c_raw) * op[3]
        total += f * (1 + (2 if op[5] else 1)) if train else f
    return total


def bound_s(flops, nbytes, dtype="bfloat16"):
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def block_bound_s(h, w, c0, layers, growth, k, dtype_bytes=2):
    """A batch-1 dense block's bound as K2 runs it: each layer's 1x1 over its
    width and 3x3 over K at every pixel (a recomputed halo is not work);
    bytes: the input, the folded f32 stacks (g1, b1, w1 over the block's
    widest input, g2, b2, w3), and the output, each once."""
    c_max = c0 + layers * growth
    flops = 2 * h * w * sum((c0 + l * growth) * k + 9 * k * growth for l in range(layers))
    stacks = 4 * layers * (2 * c_max + c_max * k + 2 * k + 9 * k * growth)
    nbytes = h * w * c0 * dtype_bytes + stacks + h * w * c_max * dtype_bytes
    return bound_s(flops, nbytes)


def k2_blocks(arch, h, w, batch):
    """The dense blocks on which the port's strip gate runs K2 at this frame
    size and batch: ``(name, (h, w), c0, layers)`` of both encoders at batch 1
    on planes of at least ``K2_MIN_PIXELS``."""
    if batch != 1:
        return []
    fuse_at = arch["concat_before_block_num"] - 1
    _, b1, _ = _encoder(arch, arch["stream_1_in_channels"], len(arch["block_config"]), h, w,
                        "features")
    _, b2, _ = _encoder(arch, arch["stream_2_in_channels"], fuse_at, h, w, "stream_2_features")
    return [b for b in b1 + b2 if b[1][0] * b[1][1] >= K2_MIN_PIXELS]


def k2_bound_s(arch, h, w, batch):
    """The bound of one forward's K2 calls, summed."""
    g, k = arch["growth_rate"], arch["bn_size"] * arch["growth_rate"]
    return sum(block_bound_s(p[0], p[1], c0, n, g, k) for _, p, c0, n in k2_blocks(arch, h, w,
                                                                                   batch))


def k3_bound_s(arch, h, w, dtype_bytes=2):
    """K3's bound on one batch-1 frame: the head's needed work per low-res
    pixel (refine0 over the 2x2 collapse of the upsampled part, 16 c_up
    c_mid, and 36 rc c_mid; refine1 100 c_mid n_cls multiply-adds); bytes:
    x_lo and raw, the f32 BN and conv weights, and the logits, once."""
    widths, _ = stage_widths(arch)
    c_up, c_mid, n_cls = widths[-1], widths[-1] // 2, arch["num_classes"]
    rc = arch["stream_1_in_channels"] + arch["stream_2_in_channels"]
    hh, hw = h // 2, w // 2
    flops = 2 * hh * hw * (16 * c_up * c_mid + 36 * rc * c_mid + 100 * c_mid * n_cls)
    weights = 4 * (2 * (c_up + rc) + c_mid * (c_up + rc) * 9 + 2 * c_mid + n_cls * c_mid * 25)
    nbytes = (hh * hw * c_up + h * w * rc + h * w * n_cls) * dtype_bytes + weights
    return bound_s(flops, nbytes)

