"""The eval BN-ReLU pass of the port (``dmmfods_tpu_torch/ops/bn_relu.py``)
and the model's eval operands kept per fold (``eval_operands`` in
``models/dense_unet_lidar.py``).

On the CPU: the plain version against the model's per-call fold (bit for bit
in f32, one rounding in bf16), the wrapper's checks and its CPU path, and the
fold cache: eval forwards on kept operands equal the per-call fold; a repeated
forward folds nothing; an in-place edit, a loaded state dict, a cast and a
new activation dtype fold anew; train mode still takes batch statistics and
updates the running stats; an eval forward that records gradients runs the
per-call fold. Every plain-path BN-ReLU site calls the pass once, as many as
:func:`_site_shapes` derives from the architecture.

The kernel itself runs only on the card: the tests marked ``cuda`` skip
without one, and ``chip_smoke.py`` checks it at the serving shapes."""

import copy

import numpy as np
import pytest
import torch

from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import bn_relu as br

BF16 = torch.bfloat16


def _norm(c, seed):
    """An eval BN of ``c`` channels with drawn parameters and running stats."""
    rng = np.random.default_rng(seed)
    norm = pm._batch_norm(c).eval()
    with torch.no_grad():
        for t, lo, hi in ((norm.weight, 0.5, 1.5), (norm.bias, -0.3, 0.3),
                          (norm.running_mean, -0.3, 0.3), (norm.running_var, 0.5, 1.5)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)))
    return norm


def _x(b, c, h, w, seed, dtype=torch.float32, channels_last=True):
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 2, (b, h, w, c)).astype(
        np.float32)).to(dtype).permute(0, 3, 1, 2)
    return x if channels_last else x.contiguous()


@pytest.mark.parametrize("shape", [(2, 64, 16, 24), (2, 132, 5, 7), (1, 3, 4, 4)])
@pytest.mark.parametrize("channels_last", [True, False])
def test_plain_version_is_the_per_call_fold_in_f32(shape, channels_last):
    """f32: the plain version is the eval BN of ``dmmfods_tpu/ops/
    normalization.py`` (running stats folded to a multiply and an add) and a
    ReLU, bit for bit, and so is the model's BN-ReLU."""
    norm = _norm(shape[1], 1)
    x = _x(*shape, 2, channels_last=channels_last)
    got = br.bn_relu_reference(x, *br.bn_relu_operands(norm))
    gamma = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
    beta = norm.bias - norm.running_mean * gamma
    want = torch.relu(x * gamma[:, None, None] + beta[:, None, None])
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(pm._bn_relu(x, norm, br.bn_relu_operands(norm)).detach(), want,
                               atol=0, rtol=0)
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last


def test_plain_version_rounds_once_in_bf16():
    """bf16: f32 arithmetic from the bf16 values, one rounding: within one
    bf16 ulp of the exact value rounded (a tie moved by the f32 multiply)."""
    norm = _norm(96, 3)
    x = _x(2, 96, 8, 12, 4, BF16)
    scale, shift = br.bn_relu_operands(norm)
    got = br.bn_relu_reference(x, scale, shift)
    assert got.dtype == BF16
    exact = torch.relu(x.double() * scale.double()[:, None, None]
                       + shift.double()[:, None, None]).to(BF16).double()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 7)
    assert ((got.double() - exact).abs() <= ulp).all()


@pytest.mark.parametrize("channels_last", [True, False])
def test_cpu_tensor_takes_the_plain_version(channels_last):
    norm = _norm(40, 5)
    x = _x(2, 40, 6, 9, 6, channels_last=channels_last)
    before = br.BN_RELU_LAUNCHES.value
    got = br.bn_relu(x, *br.bn_relu_operands(norm))
    assert br.BN_RELU_LAUNCHES.value == before
    torch.testing.assert_close(got, br.bn_relu_reference(x, *br.bn_relu_operands(norm)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("dtype", TypeError), ("scale_shape", ValueError),
    ("scale_dtype", ValueError), ("shift_strided", ValueError), ("devices", ValueError),
    ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    x = _x(1, 16, 4, 4, 7)
    scale, shift = br.bn_relu_operands(_norm(16, 8))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "scale_shape":
        scale = scale[:15]
    elif case == "scale_dtype":
        scale = scale.double()
    elif case == "shift_strided":
        shift = torch.stack([shift, shift], 1)[:, 0]
    elif case == "devices":
        scale = scale.to("meta")
    elif case == "no_kernel":
        x, scale, shift = x.to("meta"), scale.to("meta"), shift.to("meta")
    with pytest.raises(error):
        br.bn_relu(x, scale, shift)


# --- the plain path's sites and the fold cache -------------------------------

TINY = dict(growth_rate=8, block_config=(2, 3, 2, 2), num_init_features=16)
H, W = 64, 96


def _tiny_model(use_fused=True, cbn=2, s2=1, seed=0, dtype="float32"):
    cfg = get_config()
    cfg.gpu.compute_dtype = dtype
    cfg.gpu.use_fused_kernels = use_fused
    for k, v in dict(TINY, concat_before_block_num=cbn, stream_2_in_channels=s2).items():
        cfg.model[k] = v
    model = pm.DenseUNetLidar(pm.ModelSpec.from_config(cfg))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2),
                                  (m.running_mean, -0.2, 0.2), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32)))
    return model.to(memory_format=torch.channels_last).eval()


def _inputs(batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (batch, H, W, 1)).astype(np.float32)))


def _per_call(model, *inputs):
    """The per-call fold: an eval forward that records gradients."""
    with torch.enable_grad():
        return model(*inputs).detach()


def _kept(model, *inputs):
    with torch.no_grad():
        return model(*inputs)


# the forms the tiny model keeps, one fold each: the plain forms of 2 stems,
# 5 plain blocks, 4 transitions, 4 decoder stages and 4 transposed convs, and
# the fuse's and the head's (K1 and phase space, or both plain)
FORMS = 21


def _entries(model):
    """Every kept entry of ``model``, by module name, form and dtype."""
    return {(name, *key): entry for name, m in model.named_modules()
            for key, entry in vars(m).get("_operands", {}).items()}


def _site_shapes(spec, batch, h, w, kernel_blocks=()):
    """``(B, C, H, W)`` of every BN-ReLU site of the plain path, in the
    order an eval forward meets them, from the architecture alone:
    ``kernel_blocks`` names the ``(stream, block)`` pairs (1-based) a kernel
    takes whole (K2, K4, K5); K6 is not on (``stem_pool_strip`` off); with
    ``use_fused_kernels`` the fuse (K1) and the head (K3 or the phase-space
    head) have no site, without it they run plain."""
    g, k = spec.growth_rate, spec.bn_size * spec.growth_rate
    fuse_at = spec.concat_before_block_num if spec.fusion == "mid" else None
    sites = []

    def encoder(stream, blocks):
        hh, ww = h // 2, w // 2
        sites.append((batch, spec.num_init_features, hh, ww))
        hh, ww, c = hh // 2, ww // 2, spec.num_init_features
        for i in range(blocks):
            layers = spec.block_config[i]
            if (stream, i + 1) not in kernel_blocks:
                for layer in range(layers):
                    sites.extend([(batch, c + layer * g, hh, ww), (batch, k, hh, ww)])
            c += layers * g
            if i == len(spec.block_config) - 1:
                break
            sites.append((batch, c, hh, ww))
            c, hh, ww = c // 2, hh // 2, ww // 2
            if stream == 1 and i + 2 == fuse_at and not spec.use_fused_kernels:
                sites.append((batch, 2 * c, hh, ww))
        return hh, ww

    if fuse_at:
        encoder(2, fuse_at - 1)
    hh, ww = encoder(1, len(spec.block_config))
    _, in_channels = spec.encoder_feature_sizes()
    for features in spec.decoder_stage_features():
        sites.extend([(batch, in_channels, hh, ww), (batch, features, hh, ww)])
        in_channels, hh, ww = 2 * features, 2 * hh, 2 * ww
    if not spec.use_fused_kernels:
        up = spec.decoder_stage_features()[-1]
        raw = spec.stream_1_in_channels + (spec.stream_2_in_channels
                                           if spec.fusion != "no" else 0)
        sites.extend([(batch, up + raw, h, w), (batch, up // 2, h, w)])
    return sites


def _spy_sites(monkeypatch):
    shapes = []

    def spy(x, scale, shift):
        shapes.append(tuple(x.shape))
        return br.bn_relu(x, scale, shift)

    monkeypatch.setattr(pm, "bn_relu", spy)
    return shapes


@pytest.mark.parametrize("use_fused,cbn,s2", [(True, 2, 1), (False, 2, 1), (True, 3, 1),
                                              (False, 1, 1), (True, 1, 0)],
                         ids=["mid2", "mid2-plain", "mid3", "early-plain", "no"])
def test_every_site_calls_the_pass_once(monkeypatch, use_fused, cbn, s2):
    """An eval forward calls the one-pass BN-ReLU once at each site the
    architecture has, at the site's shape, and a train-mode forward none."""
    model = _tiny_model(use_fused, cbn, s2)
    rgb, lidar = _inputs()
    shapes = _spy_sites(monkeypatch)
    _kept(model, rgb, lidar if s2 else None)
    assert shapes == _site_shapes(model.spec, 2, H, W)
    shapes.clear()
    with torch.no_grad():
        model.train()(rgb, lidar if s2 else None)
    assert shapes == []


@pytest.mark.parametrize("use_fused", [True, False])
def test_kept_operands_equal_the_per_call_fold(use_fused):
    """f32: the eval forward on operands kept per fold is the per-call
    fold's bit for bit (the same multiply and add), the first time and the
    second, which folds nothing."""
    model = _tiny_model(use_fused)
    rgb, lidar = _inputs()
    want = _per_call(model, rgb, lidar)
    folds = br.BN_FOLDS.value
    first = _kept(model, rgb, lidar)
    made = br.BN_FOLDS.value - folds
    kept = _entries(model)
    assert made == len(kept) == FORMS
    second = _kept(model, rgb, lidar)
    assert br.BN_FOLDS.value - folds == made
    again = _entries(model)
    assert again.keys() == kept.keys() and all(again[k] is kept[k] for k in kept)
    torch.testing.assert_close(first, want, atol=0, rtol=0)
    torch.testing.assert_close(second, want, atol=0, rtol=0)


def _edit(model, change):
    block = model.features.denseblock2
    layer = block.denselayer2
    with torch.no_grad():
        if change == "running_var":
            layer.norm1.running_var.mul_(1.5)
        elif change == "bn_weight":
            layer.norm2.weight.add_(0.25)
        elif change == "conv_weight":
            layer.conv1.weight.mul_(-1)
        elif change == "replaced":
            layer.norm1.bias = torch.nn.Parameter(layer.norm1.bias + 0.5)
        elif change == "load_state_dict":
            state = {k: v * 1.25 if v.is_floating_point() else v
                     for k, v in model.state_dict().items()}
            model.load_state_dict(state)
        elif change == "to_dtype":
            # a cast there and back: new storage, the values rounded to bf16
            model.to(BF16).to(torch.float32)
    return 1 if change not in ("load_state_dict", "to_dtype") else FORMS


@pytest.mark.parametrize("change", ["running_var", "bn_weight", "conv_weight", "replaced",
                                    "load_state_dict", "to_dtype"])
def test_a_change_folds_anew(change):
    """An in-place edit of a running stat, a BN weight or a conv weight, a
    replaced parameter, a loaded state dict and a cast each fold the modules
    they touch anew (``BN_FOLDS``), and the output follows the new values."""
    model = _tiny_model()
    rgb, lidar = _inputs()
    before = _kept(model, rgb, lidar)
    folds = br.BN_FOLDS.value
    refolded = _edit(model, change)
    got = _kept(model, rgb, lidar)
    assert br.BN_FOLDS.value - folds == refolded
    assert not torch.equal(got, before)
    torch.testing.assert_close(got, _per_call(model, rgb, lidar), atol=0, rtol=0)
    assert br.BN_FOLDS.value - folds == refolded       # the per-call fold keeps nothing


def test_a_new_activation_dtype_folds_anew():
    """The kept operands are per activation dtype: a bf16 input folds again,
    with the conv weight cast to bf16 and the BN operands still f32."""
    tr = pm.Transition(24, 12).eval()
    tr.load_state_dict({**tr.state_dict(), **{
        f"norm.{k}": getattr(_norm(24, 9), k) for k in
        ("weight", "bias", "running_mean", "running_var")}})
    x = _x(2, 24, 8, 8, 10)
    folds = br.BN_FOLDS.value
    with torch.no_grad():
        want = tr(x)
        (scale, _), w = tr._operands["plain", torch.float32][1]
        assert w.dtype == torch.float32 and scale.dtype == torch.float32
        got = tr(x.to(BF16))
        (scale, _), w = tr._operands["plain", BF16][1]
        assert w.dtype == BF16 and scale.dtype == torch.float32
        tr(x.to(BF16))
    assert br.BN_FOLDS.value - folds == 2
    torch.testing.assert_close(got.float(), want, atol=0.05, rtol=0.02)


def test_train_mode_updates_the_running_stats():
    """Train mode is ``nn.BatchNorm2d``'s: batch statistics, the running
    stats updated, no fold; the next eval forward folds the new stats."""
    model = _tiny_model()
    rgb, lidar = _inputs()
    _kept(model, rgb, lidar)
    norm = model.features.denseblock1.denselayer1.norm1
    mean = norm.running_mean.clone()
    folds = br.BN_FOLDS.value
    with torch.no_grad():
        model.train()(rgb, lidar)
    assert not torch.equal(norm.running_mean, mean)
    assert br.BN_FOLDS.value == folds
    model.eval()
    got = _kept(model, rgb, lidar)
    assert br.BN_FOLDS.value > folds
    torch.testing.assert_close(got, _per_call(model, rgb, lidar), atol=0, rtol=0)


def test_eval_forward_with_gradients_runs_the_per_call_fold():
    """With autograd on, the eval forward makes its operands per call and no
    module keeps anything in any form, so gradients reach the BN parameters
    and the conv weights, the phase-space head's refine weights included."""
    model = _tiny_model()
    rgb, lidar = _inputs()
    folds = br.BN_FOLDS.value
    model(rgb, lidar).float().square().sum().backward()
    assert br.BN_FOLDS.value == folds
    layer = model.features.denseblock3.denselayer1
    assert layer.norm1.weight.grad is not None and layer.conv2.weight.grad is not None
    head = model.dec_out_to_heat_maps
    assert head.refine0.weight.grad is not None and head.norm1.weight.grad is not None
    assert _entries(model) == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_is_the_same_with_and_without_gradients(dtype):
    """Eval has one BN-ReLU arithmetic whatever the grad mode: the forward
    that records gradients (the per-call fold) gives the kept operands'
    values bit for bit, in bf16 too (one rounding both ways)."""
    model = _tiny_model(dtype=dtype)
    rgb, lidar = _inputs()
    kept = _kept(model, rgb, lidar)
    assert kept.dtype == getattr(torch, dtype)
    torch.testing.assert_close(_per_call(model, rgb, lidar), kept, atol=0, rtol=0)


def test_a_deep_copy_serves_its_own_weights():
    """A copy of a model with kept operands folds its own tensors: editing the
    copy changes only the copy's output."""
    model = _tiny_model()
    rgb, lidar = _inputs()
    before = _kept(model, rgb, lidar)
    twin = copy.deepcopy(model)
    with torch.no_grad():
        twin.features.norm0.running_var.mul_(2)
    torch.testing.assert_close(_kept(model, rgb, lidar), before, atol=0, rtol=0)
    torch.testing.assert_close(_kept(twin, rgb, lidar), _per_call(twin, rgb, lidar),
                               atol=0, rtol=0)
    assert not torch.equal(_kept(twin, rgb, lidar), before)


# --- the card -----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# the two benchmarked configurations: (constructor, mid fusion before block,
# batch, h, w, the (stream, block) pairs a kernel takes)
CONFIGS = {
    "densenet121-mid2": ("densenet121_u_lidar", 2, 256, 128, 192, ()),
    "densenet161-mid3": ("densenet161_u_lidar", 3, 1, 1280, 1920,
                         ((1, 1), (1, 2), (2, 1), (2, 2))),
}


def _card_model(name):
    constructor, fuse, batch, h, w, kernel_blocks = CONFIGS[name]
    cfg = get_config()
    cfg.model.concat_before_block_num = fuse
    bundle = getattr(pm, constructor)(config=cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rgb = torch.rand(batch, h, w, 3, generator=gen, device="cuda")
    lidar = torch.rand(batch, h, w, 1, generator=gen, device="cuda")
    return bundle.module, (rgb, lidar), _site_shapes(bundle.spec, batch, h, w, kernel_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_matches_plain_on_cuda(name, dtype):
    """At every site shape of both configurations, and at channel counts
    that are not multiples of 8: bf16 within one ulp of the exact value
    rounded once, f32 within 1e-6 of the plain version."""
    _cuda()
    *_, batch, h, w, kernel_blocks = CONFIGS[name]
    spec = pm.ModelSpec.from_config(get_config(), **(
        dict(growth_rate=48, block_config=(6, 12, 36, 24), num_init_features=96,
             concat_before_block_num=3) if "161" in name else {}))
    shapes = sorted(set(_site_shapes(spec, batch, h, w, kernel_blocks)))
    shapes += [(2, 132, 16, 24), (3, 3, 5, 7), (1, 44, 1, 1), (5, 2212, 3, 3)]
    for i, shape in enumerate(shapes):
        norm = _norm(shape[1], i)
        x = _x(*shape, i, dtype).cuda()
        scale, shift = (t.cuda() for t in br.bn_relu_operands(norm))
        before = br.BN_RELU_LAUNCHES.value
        got = br.bn_relu(x, scale, shift)
        torch.cuda.synchronize()
        assert br.BN_RELU_LAUNCHES.value == before + 1
        assert got.dtype == dtype and got.stride() == x.stride()
        if dtype == BF16:
            exact = torch.relu(x.double() * scale.double()[:, None, None]
                               + shift.double()[:, None, None]).to(BF16).double()
            ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 7)
            assert ((got.double() - exact).abs() <= ulp).all(), shape
        else:
            torch.testing.assert_close(got, br.bn_relu_reference(x, scale, shift),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_kernel_rejects_layouts_and_dtypes_on_cuda():
    _cuda()
    scale, shift = (t.cuda() for t in br.bn_relu_operands(_norm(16, 0)))
    x = _x(2, 16, 4, 4, 0).cuda()
    with pytest.raises(ValueError):           # NCHW-contiguous
        br.bn_relu(x.contiguous(), scale, shift)
    with pytest.raises(TypeError):
        br.bn_relu(x.half(), scale, shift)
    flat = torch.zeros(2 * 16 * 4 * 4 + 3, dtype=BF16, device="cuda")
    with pytest.raises(ValueError):           # off a 16-byte boundary
        br.bn_relu(flat[3:].view(2, 4, 4, 16).permute(0, 3, 1, 2), scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_launches_one_pass_per_site_on_cuda(name):
    """One eval forward launches the kernel once per plain-path site, which
    the architecture gives, and folds once per module the first time only; a
    train-mode forward launches none."""
    _cuda()
    model, inputs, sites = _card_model(name)
    with torch.inference_mode():
        for fresh in (True, False):
            launches, folds = br.BN_RELU_LAUNCHES.value, br.BN_FOLDS.value
            model(*inputs)
            torch.cuda.synchronize()
            assert br.BN_RELU_LAUNCHES.value - launches == len(sites)
            assert (br.BN_FOLDS.value > folds) == fresh
    launches = br.BN_RELU_LAUNCHES.value
    with torch.no_grad():
        model.train()(*inputs)
    assert br.BN_RELU_LAUNCHES.value == launches
