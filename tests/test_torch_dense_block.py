"""K2, the dense block of the port (``dmmfods_tpu_torch/ops/dense_block*.py``):
``fold_block_params`` against the JAX one, the plain version against the JAX
carry kernel (``dense_block_strip_carry`` in interpret mode, the same code
path the TPU runs), the bf16 kernel's weight layout (``pack_layer_weights``)
against the fold and its wave plan, the eval ``DenseBlock``'s dispatch
against its plain loop, the wrapper's argument checks, and that a CPU tensor
takes the plain version (the block's kept operands:
``tests/test_torch_eval_operands.py``). All in f32; the BN vectors are
randomised so that some folded BN2 bias is positive and a border bug shows
(see ``tests/test_pallas_dense_block_strip.py``). Tolerance: atol 5e-4, the JAX
kernel test's own, for f32 summation-order noise over up to six layers.
The kernel itself runs only on the card: ``test_kernel_matches_plain_on_cuda``
skips without one, and ``chip_smoke.py`` checks it at the full-resolution
block shapes."""

from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmmfods_tpu.models.dense_unet_lidar import DenseBlock as JaxDenseBlock
from dmmfods_tpu.ops.pallas.dense_block import fold_block_params as jax_fold
from dmmfods_tpu.ops.pallas.dense_block_strip import dense_block_strip_carry
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import dense_block_strip as k2
from dmmfods_tpu_torch.ops.dense_block import fold_block_params

ATOL = 5e-4


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _jax_block(num_layers, c0, growth, h, w, seed, batch=1):
    """A JAX DenseBlock with randomised BN vectors, its input and variables."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, h, w, c0)).astype(np.float32)
    block = JaxDenseBlock(num_layers=num_layers, growth_rate=growth, bn_size=4,
                          drop_rate=0.0, dtype=jnp.float32)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) if a.ndim == 1
        else np.asarray(a, np.float32), variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=a.shape)) * 0.3 + 0.7).astype(np.float32),
        variables["batch_stats"])
    return block, {"params": params, "batch_stats": stats}, x


def _port_block(variables, num_layers, c0, growth):
    """The port's DenseBlock holding the same variables, in eval mode."""
    block = pm.DenseBlock(num_layers, c0, 4, growth, 0.0)
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables[collection]):
            value = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                value = np.transpose(value, (3, 2, 0, 1))
            sd[".".join(path[:-1] + (names[path[-1]],))] = torch.from_numpy(
                np.ascontiguousarray(value))
    missing, unexpected = block.load_state_dict(sd, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    return block.eval()


def test_fold_block_params_matches_jax():
    num_layers, c0, growth = 3, 12, 8
    _, variables, _ = _jax_block(num_layers, c0, growth, 4, 4, seed=1)
    want = jax_fold(variables["params"], variables["batch_stats"], num_layers, c0,
                    growth, 4)
    got = fold_block_params(_port_block(variables, num_layers, c0, growth))
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


def _unpack_layer_weights(w1p, w3p, c_max, k, growth):
    """pack_layer_weights undone, in f32: (w1, w3) in folded's layouts."""
    n = w1p.shape[0]
    return (w1p.float()[:, :c_max, :k],
            w3p.float()[:, :, :k, :growth].reshape(n, 3, 3, k, growth))


@pytest.mark.parametrize("L,c0,growth", [(3, 12, 8), (4, 40, 12), (6, 64, 32), (2, 48, 48)])
def test_pack_layer_weights_unpacks_to_fold(L, c0, growth):
    """K2's bf16 layouts hold fold_block_params's w1 and w3 rounded to bf16,
    with zeros in every padding (rows to 32; K and G to 128 and 32 up to
    growth 32, as DenseNet-121's blocks pack, else to 192 and 48, as
    DenseNet-161's growth 48 does)."""
    _, variables, _ = _jax_block(L, c0, growth, 4, 4, seed=11)
    folded = fold_block_params(_port_block(variables, L, c0, growth))
    k, c_max = 4 * growth, c0 + L * growth
    kp, gp = (128, 32) if growth <= 32 else (192, 48)
    assert k2.layout(growth, k) == (kp, gp)
    w1p, w3p = k2.pack_layer_weights(folded)
    assert w1p.dtype == w3p.dtype == torch.bfloat16
    assert tuple(w1p.shape) == (L, -(-c_max // 32) * 32, kp)
    assert tuple(w3p.shape) == (L, 9, kp, gp)
    w1, w3 = _unpack_layer_weights(w1p, w3p, c_max, k, growth)
    for name, got in (("w1", w1), ("w3", w3)):
        want = folded[name].to(torch.bfloat16).float()
        torch.testing.assert_close(got, want, atol=0, rtol=0, msg=name)
        assert got.abs().sum() > 0
    assert (w1p != 0).sum() == (w1 != 0).sum()
    assert (w3p != 0).sum() == (w3 != 0).sum()
    # one element by hand: tap 3 ky + kx
    assert w3p[L - 1, 3 * 2 + 1, k - 1, growth - 1] == (
        folded["w3"][L - 1, 2, 1, k - 1, growth - 1].to(torch.bfloat16))


def test_layer_plan():
    """K2's bf16 wave plan on 132 SMs: 8x16 tiles, 1200 a layer at block 1
    of the 1280x1920 frame, 300 at block 2, the ragged edge counted; two
    blocks an SM in the narrow layout (300 tiles are 1.14 waves), one in
    the wide (DenseNet-161's growth 48: 2.27 waves)."""
    assert k2.layer_plan(320, 480, 132) == (1200, 1200 / 264)
    assert k2.layer_plan(160, 240, 132) == (300, 300 / 264)
    assert k2.layer_plan(37, 53, 132) == (20, 20 / 264)
    assert k2.layer_plan(320, 480, 132, growth=48, k=192) == (1200, 1200 / 132)
    assert k2.layer_plan(160, 240, 132, growth=48, k=192) == (300, 300 / 132)


@pytest.mark.parametrize("L,c0,growth,h,w,rs", [
    (3, 16, 8, 32, 16, 8),     # several strips: the carry crosses 4 steps
    (3, 16, 8, 8, 16, 8),      # one strip and the trailing flush step
    (6, 16, 16, 24, 8, 8),     # rs == L + 2
    (3, 16, 8, 32, 16, None),  # rs picked by pick_rs_carry
    (2, 48, 48, 16, 16, 8),    # DenseNet-161's growth 48 (K 192): the wide layout
])
def test_plain_version_matches_jax_carry_kernel(L, c0, growth, h, w, rs):
    _, variables, x = _jax_block(L, c0, growth, h, w, seed=3)
    folded = jax_fold(variables["params"], variables["batch_stats"], L, c0, growth, 4)
    want = np.asarray(dense_block_strip_carry(
        jnp.asarray(x), folded, num_layers=L, c0=c0, growth=growth, h=h, w=w, rs=rs,
        interpret=True))
    got = k2.dense_block_strip_reference(
        torch.from_numpy(x), {k: torch.tensor(np.asarray(v)) for k, v in folded.items()})
    assert got.shape == want.shape == (1, h, w, c0 + L * growth)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_eval_block_dispatch_matches_plain_loop(monkeypatch):
    """Above the gate the eval block runs K2's wrapper (its plain version
    on the CPU); below it, in train mode or at batch 2, the concat loop.
    The shape is one JAX's carry gate takes (c0 and w multiples of 8); a
    ragged plane (c0 10, 9x13), which that gate refuses, runs the loop at
    any size and still matches the JAX block."""
    L, c0, growth, h, w = 3, 16, 8, 8, 16
    _, variables, x = _jax_block(L, c0, growth, h, w, seed=5, batch=2)
    block = _port_block(variables, L, c0, growth)
    jax_ragged, ragged_vars, x_ragged = _jax_block(L, 10, growth, 9, 13, seed=5)
    ragged = _port_block(ragged_vars, L, 10, growth)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return k2.dense_block_strip(*args)

    monkeypatch.setattr(pm, "dense_block_strip", spy)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = block(xt[:1])
        assert calls == []                       # 128 px < STRIP_MIN_PIXELS
        monkeypatch.setattr(pm, "STRIP_MIN_PIXELS", h * w)
        got = block(xt[:1])
        assert calls == [(1, h, w, c0)]
        block(xt)                                # batch 2: the loop
        block.train()(xt[:1])                    # train: the loop
        monkeypatch.setattr(pm, "STRIP_MIN_PIXELS", 9 * 13)
        got_ragged = ragged(torch.from_numpy(x_ragged).permute(0, 3, 1, 2))
    assert len(calls) == 1
    assert got.shape == (1, c0 + L * growth, h, w)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    want_ragged = np.asarray(jax_ragged.apply(ragged_vars, jnp.asarray(x_ragged), False))
    np.testing.assert_allclose(got_ragged.permute(0, 2, 3, 1).numpy(), want_ragged,
                               atol=ATOL)


def _folded(rng, L=2, c0=6, growth=4, k=16):
    c_max = c0 + L * growth
    return {name: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for name, shape in (("g1", (L, c_max)), ("b1", (L, c_max)),
                                ("w1", (L, c_max, k)), ("g2", (L, k)), ("b2", (L, k)),
                                ("w3", (L, 3, 3, k, growth)))}


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(6)
    folded = _folded(rng)
    x = torch.from_numpy(rng.normal(size=(1, 5, 7, 6)).astype(np.float32))
    before = k2.K2_LAUNCHES.value
    got = k2.dense_block_strip(x, folded)
    assert k2.K2_LAUNCHES.value == before
    torch.testing.assert_close(got, k2.dense_block_strip_reference(x, folded),
                               atol=0, rtol=0)
    assert got.shape == (1, 5, 7, 14)
    torch.testing.assert_close(got[..., :6], x, atol=0, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("dtype", TypeError), ("missing", ValueError),
    ("w3_taps", ValueError), ("c0", ValueError), ("w1", ValueError),
    ("folded_dtype", TypeError), ("devices", ValueError), ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    rng = np.random.default_rng(7)
    folded = _folded(rng)
    x = torch.from_numpy(rng.normal(size=(1, 5, 7, 6)).astype(np.float32))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "missing":
        del folded["b2"]
    elif case == "w3_taps":
        folded["w3"] = folded["w3"][:, :2]
    elif case == "c0":
        x = x[..., :5]
    elif case == "w1":
        folded["w1"] = folded["w1"][:, :, :8]
    elif case == "folded_dtype":
        folded["g1"] = folded["g1"].double()
    elif case == "devices":
        folded["g2"] = folded["g2"].to("meta")
    elif case == "no_kernel":
        x = x.to("meta")
        folded = {k: v.to("meta") for k, v in folded.items()}
    with pytest.raises(error):
        k2.dense_block_strip(x, folded)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    for (L, c0, growth, k, h, w), dtype, bound in [
            ((3, 24, 8, 32, 37, 53), torch.float32, 1e-4),
            ((2, 64, 32, 128, 40, 48), torch.bfloat16, 1e-2),
            ((3, 24, 8, 32, 37, 53), torch.bfloat16, 1e-2),
            ((4, 40, 12, 48, 21, 35), torch.bfloat16, 1e-2)]:
        folded = {n: t.cuda() for n, t in _folded(rng, L, c0, growth, k).items()}
        folded["w1"] = folded["w1"].to(dtype).float() * 0.1
        folded["w3"] = folded["w3"].to(dtype).float() * 0.1
        x = torch.from_numpy(rng.normal(size=(1, h, w, c0)).astype(np.float32)).cuda()
        before = k2.K2_LAUNCHES.value
        got = k2.dense_block_strip(x.to(dtype), folded)
        torch.cuda.synchronize()
        assert k2.K2_LAUNCHES.value == before + 1
        want = k2.dense_block_strip_reference(x.to(dtype).float(), folded)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            k2.dense_block_strip(x.transpose(1, 2), folded)
