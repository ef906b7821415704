"""The Dense U-Net LiDAR family: the program's ``DenseUNetLidar`` (DenseNet
encoders over RGB and LiDAR, mid fusion, the U-Net decoder and the heat-map
head) against the plain reference of ``gpubench/reference.py``.

An answer is one array of heat maps, ``(frames, h, w, classes)``: the
engine's sigmoid of the logits on the host, held to the reference's sigmoid
of its float32 logits by ``check.serving_numbers``. The operations of a
frame are ``flops.frame_flops``'s; the counters are the launches of the
program's six kernels, K1-K6. The module-level names are the family
interface that ``gpubench/spec.py`` lists.
"""

from __future__ import annotations

import importlib
import math

import torch

from gpubench import check, flops, inputs
from gpubench.reference import (ReferenceNet, forward_in_chunks, kaiming_std, param_count,
                                strict_fp32)

# the program's kernel launch counters: (name, module under ops, attribute)
COUNTERS = (("K1", "fused", "K1_LAUNCHES"), ("K2", "dense_block_strip", "K2_LAUNCHES"),
            ("K3", "phase_head", "K3_LAUNCHES"), ("K4", "dense_block", "K4_LAUNCHES"),
            ("K5", "dense_block_strip", "K5_LAUNCHES"), ("K6", "stem_pool", "K6_LAUNCHES"))

# the CPU tests' cut: DenseNet widths to growth 8, blocks (2, 2, 2, 2), 16
# initial features
TINY_ARCH = dict(growth_rate=8, block_config=[2, 2, 2, 2], num_init_features=16)


def build(config, device):
    """The program's model as its constructor builds it, from the
    configuration's ``model``, ``gpu`` and ``optimizer`` sections over the
    program's defaults, channels-last on ``device``, in eval mode."""
    from dmmfods_tpu_torch.config import get_config
    from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelBundle, ModelSpec

    program_config = get_config()
    for section in ("model", "gpu", "optimizer"):
        for k, v in config[section].items():
            program_config[section][k] = v
    spec = ModelSpec.from_config(program_config)
    module = DenseUNetLidar(spec).to(device=device, memory_format=torch.channels_last).eval()
    return ModelBundle(module=module, config=program_config, spec=spec)


def reference(arch, quant=None):
    """The plain reference, float32 (``quant="fp8"``: the control, fp8
    convs)."""
    return ReferenceNet(arch).set_quant(quant)


def make_state_dict(arch, seed, device):
    """Seeded weights under the network's module names, on ``device``, f32:
    every conv kaiming-normal over its fan-in, and every BN with a weight in
    [0.75, 1.25], a bias and a running mean in [-0.1, 0.1], a running
    variance in [0.75, 1.25] (so that folding them is work the comparison
    sees). Two random calls: one normal draw for all conv weights, one
    uniform draw for all BN entries."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in
              ReferenceNet(arch).to("meta").state_dict().items()}
    conv_keys = [k for k, (s, _) in shapes.items() if len(s) == 4]
    bn_names = sorted({k.rsplit(".", 1)[0] for k, (s, _) in shapes.items()
                       if k.endswith("running_var")})
    gen = inputs.generator(seed, inputs.WEIGHTS, device)
    sizes = [math.prod(shapes[k][0]) for k in conv_keys]
    stds = torch.tensor([kaiming_std(shapes[k][0], ".Transposed_Convolution_" in k)
                         for k in conv_keys], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(stds, torch.tensor(sizes, device=device))
    out = {k: t.view(shapes[k][0]) for k, t in zip(conv_keys, flat.split(sizes))}
    widths = [shapes[f"{n}.weight"][0][0] for n in bn_names]
    u = torch.rand(4, sum(widths), generator=gen, device=device)
    u[0].mul_(0.5).add_(0.75)      # weight
    u[1].sub_(0.5).mul_(0.2)       # bias
    u[2].sub_(0.5).mul_(0.2)       # running mean
    u[3].mul_(0.5).add_(0.75)      # running var
    for n, parts in zip(bn_names, u.split(widths, dim=1)):
        for j, field in enumerate(("weight", "bias", "running_mean", "running_var")):
            out[f"{n}.{field}"] = parts[j]
        out[f"{n}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise RuntimeError(f"weights left unmade: {sorted(missing)[:5]}")
    return out


def reference_answers(net, rgb, lidar, chunk):
    """The reference's heat maps of host frames, ``(frames, h, w,
    classes)``: the sigmoid of its logits, run in float32 with TF32 off in
    chunks of ``chunk`` frames."""
    with strict_fp32():
        logits = forward_in_chunks(net, rgb, lidar, chunk)
    return torch.sigmoid(logits).numpy()


def frames(answer):
    return answer.shape[0]


def take(answer, idx):
    return answer[list(idx)].copy()


numbers = check.serving_numbers


def flops_per_frame(arch, h, w, train=False):
    return flops.frame_flops(arch, h, w, train=train)


def counters():
    """``{name: the program's launch counter}``; each has a ``value``."""
    return {name: getattr(importlib.import_module(f"dmmfods_tpu_torch.ops.{mod}"), attr)
            for name, mod, attr in COUNTERS}


def tiny(config):
    return dict(config, model=dict(config["model"], **TINY_ARCH))
