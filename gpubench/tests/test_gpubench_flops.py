"""The operation counts and bounds: against hand counts of one dense block
and of the head, against ``FlopCounterMode`` over the plain reference of
each Dense U-Net configuration (forward, and forward + backward) at a small
size, and the counts the cells use, through their model family."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _bench import configs, family, tiny_config
from gpubench import flops
from gpubench.reference import ReferenceNet, bce_sum

CONFIGS = configs()
D121, D161 = CONFIGS["densenet121-mid2"]["model"], CONFIGS["densenet161-mid3"]["model"]
UNET = sorted(n for n, c in CONFIGS.items() if c["family"] == "dense_unet_lidar")


def test_dense_block_by_hand():
    # DenseNet-121 block 1 at 128x192: a 32x48 plane, 64 channels in, six
    # layers of growth 32 with a 128-wide bottleneck
    ops = [op for op in flops.conv_ops(D121, 128, 192)
           if op[0].startswith("features.denseblock1.")]
    got = sum(flops._op_flops(op) for op in ops)
    want = 2 * 32 * 48 * sum((64 + 32 * l) * 128 + 9 * 128 * 32 for l in range(6))
    assert got == want == 1_019_215_872


def test_head_by_hand():
    # DenseNet-121's head at 128x192: x_lo 64x96 of 128 channels, raw 4,
    # c_mid 64, 3 classes; refine0 over the 2x2 collapse, refine1 5x5
    plain = flops.frame_flops(D121, 128, 192, collapse=False)
    collapsed = flops.frame_flops(D121, 128, 192)
    refine0_plain = 2 * 128 * 192 * 132 * 64 * 9
    refine0_needed = 2 * 64 * 96 * (16 * 128 * 64 + 36 * 4 * 64)
    assert plain - collapsed == refine0_plain - refine0_needed
    refine1 = [op for op in flops.conv_ops(D121, 128, 192)
               if op[0] == "dec_out_to_heat_maps.refine1"][0]
    assert flops._op_flops(refine1) == 2 * 128 * 192 * 25 * 64 * 3


@pytest.mark.parametrize("config", UNET)
@pytest.mark.parametrize("train", [False, True])
def test_counts_equal_flop_counter_over_the_reference(config, train):
    arch = tiny_config(CONFIGS[config])["model"]
    net = ReferenceNet(arch).train(train)
    rgb, lidar = torch.rand(2, 64, 96, 3), torch.rand(2, 64, 96, 1)
    with FlopCounterMode(display=False) as counter:
        out = net(rgb, lidar)
        if train:
            bce_sum(out, torch.rand_like(out)).backward()
    assert counter.get_total_flops() == 2 * flops.frame_flops(arch, 64, 96, train=train,
                                                              collapse=False)


def test_full_size_counts():
    """The counts the cells' mfu metrics use (PERF.md gives them), as the
    family gives them to the run."""
    unet = family(CONFIGS["densenet121-mid2"])
    assert unet.flops_per_frame(D121, 128, 192) == flops.frame_flops(D121, 128, 192)
    assert unet.flops_per_frame(D121, 128, 192) == 8_384_937_984
    assert unet.flops_per_frame(D121, 128, 192, train=True) == 25_000_673_280
    assert unet.flops_per_frame(D161, 1280, 1920) == 2_288_487_628_800


def test_kernel_bounds_are_operation_bound_at_densenet161s_full_resolution():
    blocks = flops.k2_blocks(D161, 1280, 1920, 1)
    assert [b[0] for b in blocks] == ["features.denseblock1", "features.denseblock2",
                                      "stream_2_features.denseblock1",
                                      "stream_2_features.denseblock2"]
    assert flops.k2_blocks(D161, 1280, 1920, 2) == []
    # chip_smoke.py's bounds of the same calls: 0.2319 / 0.1589 ms (K2), 0.4194 ms (K3)
    b1 = flops.block_bound_s(320, 480, 96, 6, 48, 192)
    b2 = flops.block_bound_s(160, 240, 192, 12, 48, 192)
    assert b1 * 1e3 == pytest.approx(0.2319, abs=1e-4)
    assert b2 * 1e3 == pytest.approx(0.1589, abs=1e-4)
    assert flops.k2_bound_s(D161, 1280, 1920, 1) == pytest.approx(2 * (b1 + b2))
    assert flops.k3_bound_s(D161, 1280, 1920) * 1e3 == pytest.approx(0.4194, abs=1e-4)
