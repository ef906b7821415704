"""K4, the port's whole-dense-block kernel (``dmmfods_tpu_torch/ops/dense_block.py``):
the plain version against JAX's ``dense_block_pallas`` in interpret mode (the
same code path the TPU runs) on one-image and packed sample groups; the
port's eligibility against JAX's ``pick_group``/``eligible``, including the
DenseNet-121 blocks at 128x192; the bf16 kernel's packed weights at K4's
shapes and its tile and warp-split plan (``block_plan``); the eval
``DenseBlock``'s dispatch with impl ``pallas`` and the packed pair it passes;
the wrapper's argument checks; and that a CPU tensor takes the plain
version. All in f32. The folded BN2 biases are drawn with both
signs, so a pixel outside an image that is not masked after BN2 would add
ReLU(b2) and show. Tolerance: atol 5e-4, the JAX kernel test's own
(``tests/test_pallas_dense_block.py``), for f32 summation-order noise. The
kernel itself runs only on the card: ``test_kernel_matches_plain_on_cuda``
skips without one, and ``chip_smoke.py`` checks it at the DenseNet-121
block shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.ops.pallas import dense_block as jax_k4
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import dense_block as k4
from dmmfods_tpu_torch.ops.dense_block_strip import pack_layer_weights

ATOL = 5e-4

# DenseNet-121 at 128x192 (growth 32, bn_size 4): the dense blocks' planes,
# input widths and depths; stream 2 (mid fusion before block 2) has block 1
DENSENET121_BLOCKS = [(32, 48, 64, 6), (16, 24, 128, 12), (8, 12, 256, 24),
                      (4, 6, 512, 16)]


def _folded(rng, L, c0, growth, k):
    """numpy folded stacks as ``fold_block_params`` lays them out: zero beyond
    each layer's width, BN scales around 1, biases of both signs."""
    c_max = c0 + L * growth
    g1 = np.zeros((L, c_max), np.float32)
    b1 = np.zeros((L, c_max), np.float32)
    w1 = np.zeros((L, c_max, k), np.float32)
    for l in range(L):
        width = c0 + l * growth
        g1[l, :width] = rng.uniform(0.5, 1.5, width)
        b1[l, :width] = rng.normal(0, 0.5, width)
        w1[l, :width] = rng.normal(0, np.sqrt(2 / width), (width, k))
    return dict(
        g1=g1, b1=b1, w1=w1,
        g2=rng.uniform(0.5, 1.5, (L, k)).astype(np.float32),
        b2=rng.normal(0, 0.5, (L, k)).astype(np.float32),
        w3=rng.normal(0, np.sqrt(2 / (9 * k)), (L, 3, 3, k, growth)).astype(np.float32))


def _torch(folded):
    return {name: torch.from_numpy(value) for name, value in folded.items()}


@pytest.mark.parametrize("batch,h,w,L,c0,growth,group", [
    (2, 8, 16, 3, 16, 8, 1),    # one image per program
    (4, 4, 8, 3, 16, 8, 4),     # four images packed into one program
    (8, 8, 12, 2, 8, 16, 4),    # two programs of four packed images
    (1, 8, 16, 2, 48, 48, 1),   # DenseNet-161's growth 48 (K 192): the wide layout
])
def test_plain_version_matches_jax_pallas_kernel(batch, h, w, L, c0, growth, group):
    rng = np.random.default_rng(batch * 10 + h)
    folded = _folded(rng, L, c0, growth, 4 * growth)
    x = rng.normal(size=(batch, h, w, c0)).astype(np.float32)
    assert jax_k4.pick_group(batch, h, w, 4, num_layers=L, c0=c0, growth=growth,
                             bn_size=4) == group
    want = np.asarray(jax_k4.dense_block_pallas(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in folded.items()},
        num_layers=L, c0=c0, growth=growth, h=h, w=w, interpret=True))
    got = k4.dense_block_reference(torch.from_numpy(x), _torch(folded))
    assert got.shape == want.shape == (batch, h, w, c0 + L * growth)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_eligibility_matches_jax(dtype_bytes):
    shapes = DENSENET121_BLOCKS + [(8, 16, 16, 3), (4, 8, 16, 3), (10, 10, 64, 6),
                                   (16, 24, 12, 4), (320, 480, 64, 6)]
    for h, w, c0, L in shapes:
        for batch, growth in ((b, g) for b in (1, 2, 4, 8, 16, 32, 256) for g in (32, 48)):
            kwargs = dict(num_layers=L, c0=c0, growth=growth, bn_size=4)
            assert k4.pick_group(batch, h, w, dtype_bytes, **kwargs) == \
                jax_k4.pick_group(batch, h, w, dtype_bytes, **kwargs), (h, w, c0, L, batch)
            assert k4.eligible(L, c0, growth, 4, h, w, dtype_bytes, batch=batch) == \
                jax_k4.eligible(L, c0, growth, 4, h, w, dtype_bytes, batch=batch)


def test_densenet121_blocks_that_run_k4_at_128x192():
    """Stream 1's four blocks and stream 2's block 1, in bf16: 3/4/5/5 block
    calls per forward at b1/b8/b32/b256, the same on both sides."""
    blocks = DENSENET121_BLOCKS + DENSENET121_BLOCKS[:1]
    for batch, calls in ((1, 3), (8, 4), (32, 5), (256, 5)):
        for module in (k4, jax_k4):
            assert sum(module.eligible(L, c0, 32, 4, h, w, 2, batch=batch)
                       for h, w, c0, L in blocks) == calls, (module.__name__, batch)


@pytest.mark.parametrize("L,c0,growth", [
    (3, 24, 8),        # ragged C_max (48 -> 64 packed rows), K 32, G 8
    (24, 256, 32),     # DenseNet-121 block 3 (C_max 1024)
    (16, 512, 32),     # DenseNet-121 block 4 (C_max 1024)
    (1, 40, 12),       # one layer, K 48, G 12
    (6, 96, 48),       # DenseNet-161 block 1 (C_max 384): the wide layout
])
def test_pack_layer_weights_at_k4_shapes(L, c0, growth):
    """The bf16 kernels' packed w1 and w3 at K4's shapes unpack to the fold
    rounded to bf16, with zeros in every padding: K and G to 128 and 32
    (DenseNet-121's layout) up to growth 32, else to 192 and 48."""
    rng = np.random.default_rng(L * 1000 + c0)
    k, c_max = 4 * growth, c0 + L * growth
    kp, gp = (128, 32) if growth <= 32 else (192, 48)
    folded = _torch(_folded(rng, L, c0, growth, k))
    w1p, w3p = pack_layer_weights(folded)
    assert tuple(w1p.shape) == (L, -(-c_max // 32) * 32, kp)
    assert tuple(w3p.shape) == (L, 9, kp, gp)
    assert w1p.dtype == w3p.dtype == torch.bfloat16
    torch.testing.assert_close(w1p[:, :c_max, :k].float(),
                               folded["w1"].to(torch.bfloat16).float(), atol=0, rtol=0)
    torch.testing.assert_close(w3p[:, :, :k, :growth].float().reshape(L, 3, 3, k, growth),
                               folded["w3"].to(torch.bfloat16).float(), atol=0, rtol=0)
    assert not w1p[:, c_max:].any() and not w1p[..., k:].any()
    assert not w3p[..., k:, :].any() and not w3p[..., growth:].any()


# K4's plan on a 132-SM H100 for the four DenseNet-121 planes at 128x192:
# (tile, tiles an image, 1x1 m16 tiles, 3x3 m16 tiles, units, most a warp
# runs, the bf16 kernel's shared memory) and the cluster at b1, b8, b32, b256
DENSENET121_PLANS = {
    (32, 48): ((8, 16), 12, 12, 8, 16, 2, 97088, (6, 6, 4, 1)),
    (16, 24): ((8, 12), 4, 9, 6, 12, 2, 79040, (4, 4, 4, 1)),
    (8, 12): ((8, 12), 1, 9, 6, 12, 2, 79040, (1, 1, 1, 1)),
    (4, 6): ((4, 6), 1, 3, 2, 4, 1, 54016, (1, 1, 1, 1)),
}


@pytest.mark.parametrize("hw", list(DENSENET121_PLANS))
def test_block_plan_at_densenet121_planes(hw):
    """K4's tile and warp split (``block_plan``, the mirror of
    ``csrc/dense_block.cu``): 8x16 on 32x48, 8x12 on 16x24 and 8x12, 4x6 on
    4x6; the warps' units cover every (m16 tile, n8 pair) once, each warp's
    at most ``warp_units``, all of one m16 tile; 8x16 runs K2's split, each
    warp both n8 pairs of one m16 tile; two blocks of any tile fit an SM's
    228 KB."""
    tile, tiles, m1, m3, units, per_warp, smem, clusters = DENSENET121_PLANS[hw]
    for batch, cluster in zip((1, 8, 32, 256), clusters):
        plan = k4.block_plan(batch, *hw, 132)
        assert plan.c_fields() == (*tile, tiles, cluster, m1, m3, units, per_warp, smem)
        assert tiles % plan.cluster == 0 and plan.cluster <= k4.MAX_CLUSTER
    assert 2 * (smem + 1024) <= 228 * 1024
    dealt = [u for warp in plan.warps for u in warp]
    assert sorted(dealt) == [(m, n) for m in range(m3) for n in range(2)]
    assert max(len(warp) for warp in plan.warps) == per_warp
    assert all(len({m for m, _ in warp}) <= 1 for warp in plan.warps)   # one A fragment
    assert (m1 - 1) * 16 < (tile[0] + 2) * (tile[1] + 2) <= m1 * 16
    if tile == (8, 16):
        assert plan.warps == tuple(((w, 0), (w, 1)) for w in range(8))


# K4's plan for DenseNet-161's blocks 1 and 2 at 128x192 (growth 48, the
# wide layout): the same tiles and clusters as DenseNet-121's planes, three
# n8 pairs of G a tile, and one block an SM at 8x16 and 8x12
DENSENET161_PLANS = {
    (32, 48): ((8, 16), 12, 12, 8, 24, 3, 158016, (6, 6, 4, 1)),
    (16, 24): ((8, 12), 4, 9, 6, 18, 3, 142016, (4, 4, 4, 1)),
}


@pytest.mark.parametrize("hw", list(DENSENET161_PLANS))
def test_block_plan_at_densenet161_planes(hw):
    """At growth 48 each warp runs the three n8 pairs of one m16 tile (8x16:
    24 units on 8 warps; 8x12: 18 on warps 0-5), the units cover every (m16
    tile, n8 pair) once, and the wide body's shared memory fits one block
    an SM; a 4x6 tile deals its 6 units one a warp."""
    tile, tiles, m1, m3, units, per_warp, smem, clusters = DENSENET161_PLANS[hw]
    for batch, cluster in zip((1, 8, 32, 256), clusters):
        plan = k4.block_plan(batch, *hw, 132, growth=48, k=192)
        assert plan.c_fields() == (*tile, tiles, cluster, m1, m3, units, per_warp, smem)
    assert smem + 1024 <= 228 * 1024 < 2 * (smem + 1024)
    dealt = [u for warp in plan.warps for u in warp]
    assert sorted(dealt) == [(m, n) for m in range(m3) for n in range(3)]
    assert all(len({m for m, _ in warp}) <= 1 for warp in plan.warps)
    small = k4.block_plan(32, 4, 6, 132, growth=48, k=192)
    assert (small.units, small.warp_units) == (6, 1)
    assert small.warps == (((0, 0),), ((0, 1),), ((0, 2),), ((1, 0),), ((1, 1),), ((1, 2),),
                           (), ())
    assert k4.block_plan(32, 4, 6, 132).c_fields() == k4.block_plan(
        32, 4, 6, 132, growth=32, k=128).c_fields()


def test_block_plan_picks_the_least_padded_halo_work():
    """On any plane the plan's tile has the least tiles x padded halo rows of
    the three, the larger tile on a tie (32x48: 8x16 and 8x12 tie)."""
    for h in range(1, 41, 3):
        for w in range(1, 61, 7):
            plan = k4.block_plan(4, h, w, 132)
            costs = {t: -(-h // t[0]) * -(-w // t[1]) * 16 * -(-(t[0] + 2) * (t[1] + 2) // 16)
                     for t in k4.BLOCK_TILES}
            assert costs[plan.tile] == min(costs.values())
            assert plan.tile == next(t for t in k4.BLOCK_TILES if costs[t] == min(costs.values()))


def _port_block(rng, L, c0, growth, impl):
    """An eval port DenseBlock with random weights and BN running stats."""
    block = pm.DenseBlock(L, c0, 4, growth, 0.0, impl=impl)
    with torch.no_grad():
        for name, t in block.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_var", "weight")) and t.dim() == 1:
                value = rng.uniform(0.5, 1.5, t.shape)
            elif t.dim() == 1:
                value = rng.normal(0, 0.5, t.shape)
            else:
                value = rng.normal(0, np.sqrt(2 / np.prod(t.shape[1:])), t.shape)
            t.copy_(torch.from_numpy(value.astype(np.float32)))
    return block.eval()


def test_eval_block_dispatch(monkeypatch):
    """impl ``pallas`` in eval runs K4's wrapper (its plain version on the
    CPU) where JAX's rule holds and equals the plain loop; train mode, an
    ineligible shape and the default impl run the loop; at batch 1 on a big
    plane the K2 strip gate wins."""
    L, c0, growth, h, w = 3, 16, 8, 8, 16
    rng = np.random.default_rng(5)
    block = _port_block(rng, L, c0, growth, "pallas")
    plain = pm.DenseBlock(L, c0, 4, growth, 0.0)
    plain.load_state_dict(block.state_dict())
    plain.eval()
    calls = {"k4": [], "k2": []}

    def spy(name, fn):
        def wrapped(*args):
            calls[name].append(tuple(args[0].shape))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(pm, "dense_block", spy("k4", pm.dense_block))
    monkeypatch.setattr(pm, "dense_block_strip", spy("k2", pm.dense_block_strip))
    x = torch.from_numpy(rng.normal(size=(2, c0, h, w)).astype(np.float32))
    with torch.no_grad():
        got = block(x)
        assert calls == {"k4": [(2, h, w, c0)], "k2": []}
        want = plain(x)                          # default impl: the loop
        block(x[..., :7])                        # 8x7 = 56 px: no sample group
        assert calls["k4"] == [(2, h, w, c0)]
        monkeypatch.setattr(pm, "STRIP_MIN_PIXELS", h * w)
        block(x[:1])                             # batch 1, big plane: K2
        assert calls == {"k4": [(2, h, w, c0)], "k2": [(1, h, w, c0)]}
        block.train()(x)                         # train: the loop
    assert calls == {"k4": [(2, h, w, c0)], "k2": [(1, h, w, c0)]}
    assert got.shape == (2, c0 + L * growth, h, w)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_model_spec_reads_the_gpu_keys(tmp_path):
    from dmmfods_tpu_torch.config import GPU_DEFAULTS, get_config

    cfg = get_config(str(tmp_path))
    spec = pm.ModelSpec.from_config(cfg)
    assert spec.dense_block_impl == GPU_DEFAULTS["dense_block_impl"] == \
        "concat,concat,buffer,buffer"
    assert [spec.impl_for_block(i) for i in range(5)] == ["concat"] * 2 + ["buffer"] * 3
    assert spec.stem_pool_strip == "auto"
    cfg.gpu.dense_block_impl = "concat, pallas"
    cfg.gpu.stem_pool_strip = "on"
    spec = pm.ModelSpec.from_config(cfg)
    assert [spec.impl_for_block(i) for i in range(4)] == ["concat"] + ["pallas"] * 3
    assert spec.stem_pool_strip == "on"
    encoder = pm.Encoder(spec, 3)
    assert [encoder.get_submodule(f"denseblock{i}").impl for i in range(1, 5)] == \
        ["concat"] + ["pallas"] * 3
    with pytest.raises(ValueError):
        pm.ModelSpec(dense_block_impl="concat,palas")


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(6)
    folded = _torch(_folded(rng, 2, 8, 8, 16))
    x = torch.from_numpy(rng.normal(size=(3, 5, 7, 8)).astype(np.float32))
    before = k4.K4_LAUNCHES.value
    got = k4.dense_block(x, folded)
    assert k4.K4_LAUNCHES.value == before
    torch.testing.assert_close(got, k4.dense_block_reference(x, folded), atol=0, rtol=0)
    assert got.shape == (3, 5, 7, 24)
    torch.testing.assert_close(got[..., :8], x, atol=0, rtol=0)


def test_eval_block_passes_its_packed_pair(monkeypatch):
    """The eval block hands K4's wrapper its cached packed pair, the one made
    with its fold, and the wrapper on the CPU runs the plain version with
    it, in f32 and bf16."""
    L, c0, growth, h, w = 3, 16, 8, 8, 16
    rng = np.random.default_rng(15)
    block = _port_block(rng, L, c0, growth, "pallas")
    seen = []

    def spy(*args):
        seen.append(args)
        return k4.dense_block(*args)

    monkeypatch.setattr(pm, "dense_block", spy)
    x = torch.from_numpy(rng.normal(size=(2, c0, h, w)).astype(np.float32))
    with torch.no_grad():
        block(x)
        block(x)
    folded, packed = block._operands["kernels", torch.float32][1]
    assert len(seen) == 2 and all(args[1] is folded and args[2] is packed for args in seen)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    before = k4.K4_LAUNCHES.value
    for dtype in (torch.float32, torch.bfloat16):
        got = k4.dense_block(x_nhwc.to(dtype), folded, packed)
        torch.testing.assert_close(got, k4.dense_block_reference(x_nhwc.to(dtype), folded),
                                   atol=0, rtol=0)
    assert k4.K4_LAUNCHES.value == before


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("dtype", TypeError), ("missing", ValueError),
    ("w3_taps", ValueError), ("c0", ValueError), ("g2", ValueError),
    ("folded_dtype", TypeError), ("devices", ValueError), ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    rng = np.random.default_rng(7)
    folded = _torch(_folded(rng, 2, 8, 8, 16))
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, 8)).astype(np.float32))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "missing":
        del folded["w1"]
    elif case == "w3_taps":
        folded["w3"] = folded["w3"][:, :, :2]
    elif case == "c0":
        x = x[..., :6]
    elif case == "g2":
        folded["g2"] = folded["g2"][:, :8]
    elif case == "folded_dtype":
        folded["b1"] = folded["b1"].double()
    elif case == "devices":
        folded["w3"] = folded["w3"].to("meta")
    elif case == "no_kernel":
        x = x.to("meta")
        folded = {k: v.to("meta") for k, v in folded.items()}
    with pytest.raises(error):
        k4.dense_block(x, folded)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    for (batch, h, w, L, c0, growth), dtype, bound in [
            ((3, 37, 53, 3, 24, 8), torch.float32, 1e-4),
            ((4, 8, 12, 3, 64, 32), torch.float32, 1e-4),
            ((2, 32, 48, 2, 64, 32), torch.bfloat16, 1e-2)]:
        folded = {n: t.cuda() for n, t in _torch(_folded(rng, L, c0, growth, 4 * growth)).items()}
        for name in ("w1", "w3"):
            folded[name] = folded[name].to(dtype).float()
        x = torch.from_numpy(rng.normal(size=(batch, h, w, c0)).astype(np.float32)).cuda()
        before = k4.K4_LAUNCHES.value
        got = k4.dense_block(x.to(dtype), folded)
        torch.cuda.synchronize()
        assert k4.K4_LAUNCHES.value == before + 1
        want = k4.dense_block_reference(x.to(dtype).float(), folded)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            k4.dense_block(x.transpose(1, 2), folded)
