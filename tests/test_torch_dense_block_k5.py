"""K5, the port's halo-recompute strip kernel
(``dmmfods_tpu_torch/ops/dense_block_strip.py``): JAX's strip gates (``pick_rs``, ``pick_rs_carry``, ``eligible``) against the
port's copies; the plain version against JAX's recompute strip kernel
(``dense_block_strip`` in interpret mode, the same code path the TPU runs) at
the shapes of ``tests/test_pallas_dense_block_strip.py``; K5's strip plan
for each layer body's blocks an SM; that a pre-packed bf16 pair still takes
the plain version on the CPU;
the eval ``DenseBlock``'s dispatch for each ``dense_block_strip`` value; the
wrapper's argument checks; and that a CPU tensor takes the plain version.
All in f32. The folded BN2 biases are drawn with both signs, so a pixel
outside the image that is not masked after BN2 would add ReLU(b2) and show.
Tolerance: atol 5e-4, the JAX kernel test's own, for f32 summation-order
noise. The kernel itself runs only on the card:
``test_kernel_matches_plain_on_cuda`` skips without one, and
``chip_smoke.py`` checks it at the full-resolution block shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.ops.pallas import dense_block_strip as jax_strip
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import dense_block_strip as k5

ATOL = 5e-4


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


# (h, w, c0, L): the 1280x1920 blocks 1-3, the 640x960 ones, a plane whose w
# is no multiple of 16, small and deep planes
GATE_SHAPES = [(320, 480, 64, 6), (160, 240, 128, 12), (80, 120, 256, 24),
               (160, 240, 64, 6), (80, 120, 128, 12), (40, 60, 256, 24),
               (320, 472, 64, 6), (320, 488, 64, 6), (64, 128, 16, 2), (32, 64, 16, 2),
               (16, 32, 16, 2), (8, 16, 16, 2), (12, 240, 128, 12), (10, 10, 64, 6),
               (48, 48, 24, 8), (24, 8, 16, 6)]


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_strip_gate_matches_jax(dtype_bytes, carry):
    for h, w, c0, L in GATE_SHAPES:
        for growth in (48, 32, 8):
            args = (h, L, w, c0, growth, 4 * growth, dtype_bytes)
            assert k5.pick_rs(*args) == jax_strip.pick_rs(*args), (h, w, c0, L)
            assert k5.pick_rs_carry(*args) == jax_strip.pick_rs_carry(*args), (h, w, c0, L)
            for batch in (1, 2):
                gate = (batch, h, w, c0, growth, L, 4, dtype_bytes)
                assert k5.eligible(*gate, carry=carry) == \
                    jax_strip.eligible(*gate, carry=carry), (gate, carry)


def test_full_resolution_blocks_take_both_strip_kernels():
    """Blocks 1 and 2 at 1280x1920 pass both gates in bf16 (rs 32 for K5,
    40 for K2); block 3 at 80x120 is below ``STRIP_MIN_PIXELS``."""
    for h, w, c0, L in GATE_SHAPES[:2]:
        assert k5.pick_rs(h, L, w, c0, 32, 128) == 32
        assert k5.pick_rs_carry(h, L, w, c0, 32, 128) == 40
        for carry in (False, True):
            assert k5.eligible(1, h, w, c0, 32, L, 4, 2, carry=carry)
    assert 80 * 120 < pm.STRIP_MIN_PIXELS


@pytest.mark.parametrize("L,c0,growth,h,w,rs", [
    (3, 16, 8, 32, 16, 8),     # several strips, halo = 3
    (3, 16, 8, 8, 16, 8),      # a single strip (clamped halo both sides)
    (6, 16, 16, 24, 8, 8),     # L close to rs
    (2, 48, 48, 16, 16, 8),    # DenseNet-161's growth 48 (K 192): the wide layout
])
def test_plain_version_matches_jax_strip_kernel(L, c0, growth, h, w, rs):
    rng = np.random.default_rng(L * 100 + h)
    folded = _folded(rng, L, c0, growth, 4 * growth)
    x = rng.normal(size=(1, h, w, c0)).astype(np.float32)
    want = np.asarray(jax_strip.dense_block_strip(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in folded.items()}, num_layers=L,
        c0=c0, growth=growth, h=h, w=w, rs=rs, interpret=True))
    got = k5.dense_block_strip_reference(torch.from_numpy(x), _torch(folded))
    assert got.shape == want.shape == (1, h, w, c0 + L * growth)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("h,w,L", [
    (320, 480, 6), (160, 240, 12), (37, 53, 3), (16, 40, 12), (8, 16, 3), (3, 5, 2),
    (9, 16, 4), (1000, 16, 2),
])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_strip_plan(h, w, L, sms):
    """For each layer body's blocks an SM (the bf16 body two in the narrow
    layout and one in the wide, the f32 body one): heights are multiples of
    the tile's 8 rows and cover the plane; a plane of more than one tile row
    gets at least two strips; every strip has a block and no SM more than
    its body holds; the rows and strips do not depend on the body; at the
    1280x1920 blocks every slot has a block."""
    plans = {}
    for layout, per_dtype in k5.BLOCKS_PER_SM.items():
        for dtype, per_sm in per_dtype.items():
            rows, strips, blocks = plans[layout, dtype] = k5.plan_strips(h, w, L, sms,
                                                                         per_sm)
            assert rows % k5.TILE_ROWS == 0 and strips == -(-h // rows)
            assert (strips >= 2) == (h > k5.TILE_ROWS)
            assert strips <= blocks <= sms * per_sm
            if (h, w) in ((320, 480), (160, 240)):
                assert blocks == sms * per_sm
    assert len({plan[:2] for plan in plans.values()}) == 1
    narrow, wide = k5.LAYOUTS
    assert plans[narrow, torch.bfloat16][2] >= plans[narrow, torch.float32][2]
    assert plans[wide, torch.bfloat16][2] == plans[wide, torch.float32][2]


def test_strip_plan_at_the_full_resolution_blocks():
    """On a 132-SM H100: two strips of 160 rows at block 1 and of 80 at
    block 2, 132 blocks each in bf16 in the narrow layout (two an SM), 66 in
    f32 and in the wide layout (DenseNet-161: the bf16 body's 154 KB of
    shared memory fit one block an SM), which the cooperative launch must
    hold at once."""
    assert k5.BLOCKS_PER_SM == {(128, 32): {torch.bfloat16: 2, torch.float32: 1},
                                (192, 48): {torch.bfloat16: 1, torch.float32: 1}}
    assert k5.plan_strips(320, 480, 6, 132, 2) == (160, 2, 264)
    assert k5.plan_strips(160, 240, 12, 132, 2) == (80, 2, 264)
    assert k5.plan_strips(320, 480, 6, 132, 1) == (160, 2, 132)
    assert k5.plan_strips(160, 240, 12, 132, 1) == (80, 2, 132)


def _port_block(rng, L, c0, growth, strip):
    """An eval port DenseBlock with random weights and BN running stats."""
    block = pm.DenseBlock(L, c0, 4, growth, 0.0, strip=strip)
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


@pytest.mark.parametrize("strip,kernel", [
    ("on", "k5"), ("auto", "k2"), ("carry", "k2"), ("off", None),
])
def test_eval_block_dispatch(monkeypatch, strip, kernel):
    """At batch 1 on a plane at the gate, ``on`` runs K5's wrapper, ``auto``
    and ``carry`` K2's, ``off`` neither; each equals the plain loop. A batch
    of 2, train mode, a small plane and a shape JAX's gate refuses run the
    loop."""
    L, c0, growth, h, w = 3, 16, 8, 16, 16
    rng = np.random.default_rng(9)
    block = _port_block(rng, L, c0, growth, strip)
    plain = pm.DenseBlock(L, c0, 4, growth, 0.0, strip="off")
    plain.load_state_dict(block.state_dict())
    plain.eval()
    calls = {"k2": [], "k5": []}

    def spy(name, fn):
        def wrapped(*args):
            calls[name].append(tuple(args[0].shape))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(pm, "dense_block_strip", spy("k2", pm.dense_block_strip))
    monkeypatch.setattr(pm, "dense_block_strip_recompute",
                        spy("k5", pm.dense_block_strip_recompute))
    x = torch.from_numpy(rng.normal(size=(2, c0, h, w)).astype(np.float32))
    # 18 rows: no strip height of JAX's divides them
    refused = torch.from_numpy(rng.normal(size=(1, c0, 18, w)).astype(np.float32))
    with torch.no_grad():
        block(x[:1])                             # 256 px < STRIP_MIN_PIXELS
        assert calls == {"k2": [], "k5": []}
        monkeypatch.setattr(pm, "STRIP_MIN_PIXELS", h * w)
        got = block(x[:1])
        want = plain(x[:1])
        block(x)                                 # batch 2
        block(refused)                           # JAX's gate refuses
        block.train()(x[:1])                     # train
    expected = {"k2": [], "k5": []}
    if kernel:
        expected[kernel] = [(1, h, w, c0)]
    assert calls == expected
    assert got.shape == (1, c0 + L * growth, h, w)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("value", ["recompute", "ON", ""])
def test_invalid_strip_value_raises(tmp_path, value):
    from dmmfods_tpu_torch.config import get_config

    with pytest.raises(ValueError):
        pm.ModelSpec(dense_block_strip=value)
    cfg = get_config(str(tmp_path))
    assert pm.ModelSpec.from_config(cfg).dense_block_strip == "auto"
    cfg.gpu.dense_block_strip = value
    with pytest.raises(ValueError):
        pm.ModelSpec.from_config(cfg)


def test_model_spec_reads_the_strip_key(tmp_path):
    from dmmfods_tpu_torch.config import GPU_DEFAULTS, get_config

    cfg = get_config(str(tmp_path))
    assert GPU_DEFAULTS["dense_block_strip"] == cfg.gpu.dense_block_strip == "auto"
    cfg.gpu.dense_block_strip = "on"
    cfg.tpu.dense_block_strip = "off"          # the JAX key: never read
    spec = pm.ModelSpec.from_config(cfg)
    assert spec.dense_block_strip == "on"
    encoder = pm.Encoder(spec, 3)
    strips = [encoder.get_submodule(f"denseblock{i}").strip for i in range(1, 5)]
    assert strips == ["on"] * 4


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(6)
    folded = _torch(_folded(rng, 2, 8, 8, 16))
    x = torch.from_numpy(rng.normal(size=(1, 5, 7, 8)).astype(np.float32))
    before = (k5.K5_LAUNCHES.value, k5.K2_LAUNCHES.value)
    got = k5.dense_block_strip_recompute(x, folded)
    assert (k5.K5_LAUNCHES.value, k5.K2_LAUNCHES.value) == before
    want = k5.dense_block_strip_reference(x, folded)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.shape == (1, 5, 7, 24)
    torch.testing.assert_close(got[..., :8], x, atol=0, rtol=0)


@pytest.mark.parametrize("kernel", ["k2", "k5"])
def test_cpu_tensor_with_packed_weights_takes_the_plain_version(kernel):
    """Given the packed pair (as the eval block passes it), K2's and K5's
    wrappers on a CPU tensor still run the plain version, in f32 and bf16,
    and launch nothing; a pair of the wrong layout raises."""
    rng = np.random.default_rng(16)
    folded = _torch(_folded(rng, 2, 8, 8, 32))
    packed = k5.pack_layer_weights(folded)
    run = k5.dense_block_strip if kernel == "k2" else k5.dense_block_strip_recompute
    before = (k5.K5_LAUNCHES.value, k5.K2_LAUNCHES.value)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(1, 5, 7, 8)).astype(np.float32)).to(dtype)
        got = run(x, folded, packed)
        torch.testing.assert_close(got, k5.dense_block_strip_reference(x, folded),
                                   atol=0, rtol=0)
        assert got.dtype == dtype and got.shape == (1, 5, 7, 24)
    assert (k5.K5_LAUNCHES.value, k5.K2_LAUNCHES.value) == before
    for bad in ((packed[0].float(), packed[1]), (packed[0], packed[1][:, :8]),
                (packed[0][:, :16], packed[1])):
        with pytest.raises(ValueError):
            run(x, folded, bad)


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("dtype", TypeError), ("missing", ValueError),
    ("w3_taps", ValueError), ("c0", ValueError), ("w1", ValueError),
    ("folded_dtype", TypeError), ("devices", ValueError), ("no_kernel", ValueError),
    ("batch", ValueError),
])
def test_wrapper_rejects(case, error):
    rng = np.random.default_rng(7)
    folded = _torch(_folded(rng, 2, 8, 8, 16))
    x = torch.from_numpy(rng.normal(size=(1, 5, 7, 8)).astype(np.float32))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "missing":
        del folded["g1"]
    elif case == "w3_taps":
        folded["w3"] = folded["w3"][:, :, :2]
    elif case == "c0":
        x = x[..., :6]
    elif case == "w1":
        folded["w1"] = folded["w1"][:, :, :8]
    elif case == "folded_dtype":
        folded["w3"] = folded["w3"].double()
    elif case == "devices":
        folded["b2"] = folded["b2"].to("meta")
    elif case == "no_kernel":
        x = x.to("meta")
        folded = {k: v.to("meta") for k, v in folded.items()}
    elif case == "batch":
        x = x.expand(2, -1, -1, -1)
    with pytest.raises(error):
        k5.dense_block_strip_recompute(x, folded)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    for (h, w, L, c0, growth), dtype, bound in [
            ((37, 53, 3, 24, 8), torch.float32, 1e-4),      # ragged last strip
            ((8, 24, 3, 16, 8), torch.float32, 1e-4),       # a single strip
            ((16, 40, 12, 16, 8), torch.float32, 1e-4),     # L deeper than a strip
            ((64, 96, 2, 64, 32), torch.bfloat16, 1e-2)]:
        folded = _torch(_folded(rng, L, c0, growth, 4 * growth))
        folded = {n: t.cuda() for n, t in folded.items()}
        for name in ("w1", "w3"):
            folded[name] = folded[name].to(dtype).float()
        x = torch.from_numpy(rng.normal(size=(1, h, w, c0)).astype(np.float32)).cuda()
        before = k5.K5_LAUNCHES.value
        got = k5.dense_block_strip_recompute(x.to(dtype), folded)
        torch.cuda.synchronize()
        assert k5.K5_LAUNCHES.value == before + 1
        want = k5.dense_block_strip_reference(x.to(dtype).float(), folded)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            k5.dense_block_strip_recompute(x.transpose(1, 2), folded)
