"""The plain references against the program, on the CPU in float32 at a
small size, from one seeded ``state_dict``. For every configuration on
disk, through its model family: the parameter count, the weights' keys
against the program's module, and weights that repeat for a seed. For the
Dense U-Net's configurations: the eval forward (with and without the fused
paths, whose CPU forms are the kernels' plain versions, at batches and at a
batch-1 frame large enough for the strip and head gates), the train-mode
forward, loss and gradients, and the fp8 control's departure."""

from __future__ import annotations

import copy

import pytest
import torch

from _bench import configs, family, tiny_config
from gpubench import inputs
from gpubench.reference import bce_sum

CONFIGS = configs()
UNET = sorted(n for n, c in CONFIGS.items() if c["family"] == "dense_unet_lidar")


def _tiny(config):
    c = tiny_config(CONFIGS[config])
    return family(c), c


def _program(config, sd, use_fused=True):
    fam, c = _tiny(config)
    c["gpu"]["use_fused_kernels"] = use_fused
    module = fam.build(c, "cpu").module
    module.load_state_dict(sd)
    return module


def _reference(config, sd):
    fam, c = _tiny(config)
    net = fam.reference(c["model"])
    net.load_state_dict(sd)
    return net


def _weights(config, seed):
    fam, c = _tiny(config)
    return fam.make_state_dict(c["model"], seed, "cpu")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_parameter_counts_match_the_configs(config):
    c = CONFIGS[config]
    assert family(c).param_count(c["model"]) == c["num_params"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_state_dict_keys_are_the_programs(config):
    sd = _weights(config, 3)
    assert set(sd) == set(_program(config, sd).state_dict())


@pytest.mark.parametrize("config,batch,hw,use_fused", [
    ("densenet121-mid2", 3, (64, 96), True),
    ("densenet121-mid2", 3, (64, 96), False),
    ("densenet161-mid3", 2, (64, 96), True),
    # batch 1 on a 640x640 frame: the strip gate (K2's plain version on
    # blocks 1 and 2) and the head gate (K3's plain version) both take it
    ("densenet161-mid3", 1, (640, 640), True),
])
def test_eval_forward_matches_the_program(config, batch, hw, use_fused):
    arch = _tiny(config)[1]["model"]
    sd = _weights(config, 5)
    rgb, lidar = inputs.make_frames(5, batch, *hw, "cpu")
    with torch.no_grad():
        got = _program(config, sd, use_fused).eval()(rgb, lidar).float()
        ref = _reference(config, sd).eval()(rgb, lidar)
    assert got.shape == ref.shape == (batch, *hw, arch["num_classes"])
    err = (got - ref).abs().max() / ref.abs().max()
    assert err < 1e-4, err


def test_train_forward_loss_and_gradients_match_the_program():
    config = "densenet121-mid2"
    arch = _tiny(config)[1]["model"]
    sd = _weights(config, 7)
    rgb, lidar = inputs.make_frames(7, 4, 64, 96, "cpu")
    ht = torch.rand(4, 64, 96, arch["num_classes"], generator=torch.Generator().manual_seed(7))
    prog = _program(config, sd).train()
    ref = _reference(config, copy.deepcopy(sd)).train()
    from dmmfods_tpu_torch import losses

    loss_p = losses.bce_with_logits_sum(prog(rgb, lidar).float(), ht)
    loss_r = bce_sum(ref(rgb, lidar), ht)
    loss_p.backward()
    loss_r.backward()
    assert abs(loss_p.item() - loss_r.item()) / loss_r.item() < 1e-5
    grads_r = dict(ref.named_parameters())
    for name, p in prog.named_parameters():
        g_r = grads_r[name].grad
        assert (p.grad - g_r).norm() <= 1e-3 * g_r.norm() + 1e-6, name


@pytest.mark.parametrize("config", UNET)
def test_the_fp8_control_departs_from_float32(config):
    fam, c = _tiny(config)
    sd = _weights(config, 9)
    rgb, lidar = inputs.make_frames(9, 2, 64, 96, "cpu")
    net, ctl_net = fam.reference(c["model"]).eval(), fam.reference(c["model"], "fp8").eval()
    net.load_state_dict(sd)
    ctl_net.load_state_dict(sd)
    with torch.no_grad():
        ref = net(rgb, lidar)
        ctl = ctl_net(rgb, lidar)
    err = (ctl - ref).abs().max() / ref.abs().max()
    assert 1e-3 < err < 1.0, err


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_weights_repeat_for_a_seed_and_differ_between_seeds(config):
    a, b = (_weights(config, s) for s in (2**31 + 5, 2**31 + 5))
    c = _weights(config, 2**31 + 6)
    assert set(a) == set(b) == set(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point())
