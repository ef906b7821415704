"""K4, the port's whole-dense-block kernel (``dmmfods_tpu_torch/ops/dense_block.py``):
the plain version against JAX's ``dense_block_pallas`` in interpret mode (the
same code path the TPU runs) on one-image and packed sample groups; the
port's eligibility against JAX's ``pick_group``/``eligible``, including the
DenseNet-121 blocks at 128x192; the eval ``DenseBlock``'s dispatch with
impl ``pallas``; the wrapper's argument checks; and that a CPU tensor takes
the plain version. All in f32. The folded BN2 biases are drawn with both
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
        for batch in (1, 2, 4, 8, 16, 32, 256):
            kwargs = dict(num_layers=L, c0=c0, growth=32, bn_size=4)
            assert k4.pick_group(batch, h, w, dtype_bytes, **kwargs) == \
                jax_k4.pick_group(batch, h, w, dtype_bytes, **kwargs), (h, w, c0, L, batch)
            assert k4.eligible(L, c0, 32, 4, h, w, dtype_bytes, batch=batch) == \
                jax_k4.eligible(L, c0, 32, 4, h, w, dtype_bytes, batch=batch)


def test_densenet121_blocks_that_run_k4_at_128x192():
    """Stream 1's four blocks and stream 2's block 1, in bf16: 3/4/5/5 block
    calls per forward at b1/b8/b32/b256, the same on both sides."""
    blocks = DENSENET121_BLOCKS + DENSENET121_BLOCKS[:1]
    for batch, calls in ((1, 3), (8, 4), (32, 5), (256, 5)):
        for module in (k4, jax_k4):
            assert sum(module.eligible(L, c0, 32, 4, h, w, 2, batch=batch)
                       for h, w, c0, L in blocks) == calls, (module.__name__, batch)


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
