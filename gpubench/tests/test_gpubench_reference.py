"""The plain reference against the program's module, on the CPU in float32 at
a small size, from one seeded ``state_dict``: the eval forward (with and
without the fused paths, whose CPU forms are the kernels' plain versions, at
batches and at a batch-1 frame large enough for the strip and head gates),
and the train-mode forward, loss and gradients."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from conftest import ROOT, TINY_ARCH
from gpubench import inputs
from gpubench.reference import ReferenceNet, bce_sum, param_count


def _arch(config="densenet121-mid2", **over):
    arch = json.loads((ROOT / "gpubench" / "configs" / f"{config}.json").read_text())["model"]
    return dict(arch, **TINY_ARCH, **over)


def _program(arch, sd, use_fused=True):
    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelSpec

    config = get_config()
    for k, v in arch.items():
        config.model[k] = v
    config.gpu.compute_dtype = "float32"
    config.gpu.use_fused_kernels = use_fused
    module = DenseUNetLidar(ModelSpec.from_config(config))
    module.load_state_dict(sd)
    return module


def _reference(arch, sd):
    net = ReferenceNet(arch)
    net.load_state_dict(sd)
    return net


@pytest.mark.parametrize("config", ["densenet121-mid2", "densenet161-mid3"])
def test_parameter_counts_match_the_configs(config):
    c = json.loads((ROOT / "gpubench" / "configs" / f"{config}.json").read_text())
    assert param_count(c["model"]) == c["num_params"]


def test_state_dict_keys_are_the_programs():
    arch = _arch()
    sd = inputs.make_state_dict(arch, 3, "cpu")
    assert set(sd) == set(_program(arch, sd).state_dict())


@pytest.mark.parametrize("config,batch,hw,use_fused", [
    ("densenet121-mid2", 3, (64, 96), True),
    ("densenet121-mid2", 3, (64, 96), False),
    ("densenet161-mid3", 2, (64, 96), True),
    # batch 1 on a 640x640 frame: the strip gate (K2's plain version on
    # blocks 1 and 2) and the head gate (K3's plain version) both take it
    ("densenet161-mid3", 1, (640, 640), True),
])
def test_eval_forward_matches_the_program(config, batch, hw, use_fused):
    arch = _arch(config)
    sd = inputs.make_state_dict(arch, 5, "cpu")
    rgb, lidar = inputs.make_frames(5, batch, *hw, "cpu")
    with torch.no_grad():
        got = _program(arch, sd, use_fused).eval()(rgb, lidar).float()
        ref = _reference(arch, sd).eval()(rgb, lidar)
    assert got.shape == ref.shape == (batch, *hw, arch["num_classes"])
    err = (got - ref).abs().max() / ref.abs().max()
    assert err < 1e-4, err


def test_train_forward_loss_and_gradients_match_the_program():
    arch = _arch()
    sd = inputs.make_state_dict(arch, 7, "cpu")
    rgb, lidar = inputs.make_frames(7, 4, 64, 96, "cpu")
    ht = torch.rand(4, 64, 96, arch["num_classes"], generator=torch.Generator().manual_seed(7))
    prog, ref = _program(arch, sd).train(), _reference(arch, copy.deepcopy(sd)).train()
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


def test_the_fp8_control_departs_from_float32():
    arch = _arch()
    sd = inputs.make_state_dict(arch, 9, "cpu")
    rgb, lidar = inputs.make_frames(9, 2, 64, 96, "cpu")
    net = _reference(arch, sd).eval()
    with torch.no_grad():
        ref = net(rgb, lidar)
        ctl = net.set_quant("fp8")(rgb, lidar)
    err = (ctl - ref).abs().max() / ref.abs().max()
    assert 1e-3 < err < 1.0, err


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    arch = _arch()
    a, b = (inputs.make_state_dict(arch, s, "cpu") for s in (2**31 + 5, 2**31 + 5))
    c = inputs.make_state_dict(arch, 2**31 + 6, "cpu")
    key = "features.conv0.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
