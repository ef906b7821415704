"""The model's one cache of eval operands (:func:`eval_operands` in
``dmmfods_tpu_torch/models/dense_unet_lidar.py``), over every ``(module,
form, dtype)`` the model keeps: the plain path's folds and cast weights of
each module, the dense block's folded stacks with their packed weights (K2,
K4, K5), the stem's (K6), the fuse's (K1) and the head's phase-space and K3
folds, in float32 and bfloat16.

Each case drives the module's own forward on the CPU, where each kernel's
wrapper runs its plain version, and reads what the module keeps. The kept
operands are the form's make, computed here from the ``ops`` functions, bit
for bit: the first time, after an in-place edit, after a replaced parameter
and after two assigned state dicts (the second one's tensors new tensors on
the first's memory, at version 0), each of which folds anew. A second call
hands over the very same tensors and folds nothing; another dtype folds its
own entry beside the first; a forward that records gradients, or one in
train mode, keeps nothing."""

import numpy as np
import pytest
import torch

from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import bn_relu as br
from dmmfods_tpu_torch.ops import phase_head as k3
from dmmfods_tpu_torch.ops.dense_block import fold_block_params
from dmmfods_tpu_torch.ops.dense_block_strip import pack_layer_weights
from dmmfods_tpu_torch.ops.fused import fold_bn, fuse_operands
from dmmfods_tpu_torch.ops.stem_pool import pack_stem_weights

BF16 = torch.bfloat16
ENCODER = pm.ModelSpec(growth_rate=8, block_config=(2, 2), num_init_features=16)


def _randomise(module, seed):
    """New random values in every parameter and running stat, in place (BN
    vectors positive, so a variance stays one)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                value = (rng.uniform(0.5, 1.5, t.shape) if t.dim() == 1
                         else rng.normal(0, 0.2, t.shape))
                t.copy_(torch.from_numpy(value.astype(np.float32)))
    return module.eval()


def _x(seed, *shape, dtype=torch.float32):
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(seed))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _fold(norm):
    return fold_bn(norm.weight, norm.bias, norm.running_mean, norm.running_var, norm.eps)


def _plain(*parts):
    """The plain form: each BN folded, each conv's weight cast."""
    def make(dtype):
        return tuple(_fold(p) if isinstance(p, torch.nn.BatchNorm2d) else p.weight.to(dtype)
                     for p in parts)
    return make


def _block(impl="concat"):
    return _randomise(pm.DenseBlock(2, 16, 4, 8, 0.0, impl=impl), 1)


def _block_kernels(block, dtype):
    folded = fold_block_params(block)
    return folded, pack_layer_weights(folded)


def _stem_pool(enc, dtype):
    w7 = enc.conv0.weight.permute(2, 3, 1, 0).contiguous()
    return (w7, *_fold(enc.norm0), pack_stem_weights(w7) if dtype == BF16 else None)


def _fuse(fuse, dtype):
    n = fuse.norm
    return fuse_operands(n.weight, n.bias, n.running_mean, n.running_var, fuse.conv.weight,
                         n.eps, dtype)


def _phase_space(head, dtype):
    weights = k3.phase_space_weights(head.refine0.weight, head.refine1.weight, 12)
    return (*_fold(head.norm0), *_fold(head.norm1), *(w.to(dtype) for w in weights))


def _phase_head(head, dtype):
    return (*_fold(head.norm0), *_fold(head.norm1),
            *k3.kernel_weights(head.refine0.weight, head.refine1.weight, 12, dtype))


def _head(use_fused):
    return _randomise(pm.Head(12, 4, 8, 3, use_fused=use_fused), 7)


def _run_head(batch):
    def run(head, dtype):
        return head(_x(8, batch, 12, 6, 9, dtype=dtype), _x(9, batch, 4, 12, 18, dtype=dtype))
    return run


# name: (build, form, run(module, dtype), make(module, dtype), a BN or conv
# of the module to edit in place, a conv whose weight to replace)
CASES = {
    "block-plain": (
        _block, "plain", lambda m, dt: m(_x(2, 2, 16, 8, 16, dtype=dt)),
        lambda m, dt: _plain(*m._parts())(dt),
        lambda m: m.denselayer2.norm1, lambda m: m.denselayer1.conv2),
    "block-kernels": (
        lambda: _block("pallas"), "kernels", lambda m, dt: m(_x(2, 2, 16, 8, 16, dtype=dt)),
        _block_kernels, lambda m: m.denselayer2.norm1, lambda m: m.denselayer1.conv2),
    "transition-plain": (
        lambda: _randomise(pm.Transition(24, 12), 3), "plain",
        lambda m, dt: m(_x(4, 2, 24, 8, 8, dtype=dt)),
        lambda m, dt: _plain(m.norm, m.conv)(dt), lambda m: m.norm, lambda m: m.conv),
    "decoder_stage-plain": (
        lambda: _randomise(pm.DecoderStage(24, 12), 5), "plain",
        lambda m, dt: m(_x(6, 2, 24, 8, 8, dtype=dt)),
        lambda m, dt: _plain(m.norm0, m.conv_reduce, m.norm1)(dt), lambda m: m.norm1,
        lambda m: m.conv_reduce),
    "encoder-plain": (
        lambda: _randomise(pm.Encoder(ENCODER, 3), 10), "plain",
        lambda m, dt: m(_x(11, 1, 3, 64, 128, dtype=dt)),
        lambda m, dt: _plain(m.conv0, m.norm0)(dt), lambda m: m.norm0, lambda m: m.conv0),
    "encoder-stem_pool": (
        lambda: _randomise(pm.Encoder(pm.ModelSpec(
            growth_rate=8, block_config=(2, 2), num_init_features=16,
            stem_pool_strip="on"), 3), 10), "stem_pool",
        lambda m, dt: m(_x(11, 1, 3, 64, 128, dtype=dt)),
        _stem_pool, lambda m: m.norm0, lambda m: m.conv0),
    "concat_fuse-plain": (
        lambda: _randomise(pm.ConcatFuse(16, use_fused=False), 12), "plain",
        lambda m, dt: m(_x(13, 2, 16, 4, 6, dtype=dt), _x(14, 2, 16, 4, 6, dtype=dt)),
        lambda m, dt: _plain(m.norm, m.conv)(dt), lambda m: m.norm, lambda m: m.conv),
    "concat_fuse-fused": (
        lambda: _randomise(pm.ConcatFuse(16), 12), "fused",
        lambda m, dt: m(_x(13, 2, 16, 4, 6, dtype=dt), _x(14, 2, 16, 4, 6, dtype=dt)),
        _fuse, lambda m: m.norm, lambda m: m.conv),
    "head-plain": (
        lambda: _head(False), "plain", _run_head(2),
        lambda m, dt: _plain(m.norm0, m.refine0, m.norm1, m.refine1)(dt),
        lambda m: m.norm0, lambda m: m.refine1),
    "head-phase_space": (
        lambda: _head(True), "phase_space", _run_head(2), _phase_space,
        lambda m: m.norm1, lambda m: m.refine1),
    "head-phase_head": (
        lambda: _head(True), "phase_head", _run_head(1), _phase_head,
        lambda m: m.norm0, lambda m: m.refine0),
    "conv_transpose-plain": (
        lambda: _randomise(pm.ConvTransposeToShape(8, 8), 15), "plain",
        lambda m, dt: m(_x(16, 2, 8, 5, 7, dtype=dt), (10, 14)),
        lambda m, dt: (m.weight.to(dt),), lambda m: m, lambda m: m),
}


def _leaves(ops):
    if isinstance(ops, dict):
        ops = list(ops.values())
    if isinstance(ops, (tuple, list)):
        return [leaf for op in ops for leaf in _leaves(op)]
    return [ops]


def _assert_is_make(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def _refill(arrays, rng):
    """New random values in each float array, in place (vectors positive)."""
    for a in arrays.values():
        if a.dtype == np.float32:
            a[...] = (rng.uniform(0.5, 1.5, a.shape) if a.ndim == 1
                      else rng.normal(0, 0.2, a.shape))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_cache_keeps_each_form(monkeypatch, case, dtype):
    """Kept per fold, equal to the form's make bit for bit, made anew after
    an in-place edit, a replaced parameter and an assigned state dict, per
    dtype, and never under autograd or in train mode."""
    build, form, run, make, edited, replaced = CASES[case]
    monkeypatch.setattr(pm, "HEAD_KERNEL_MIN_PIXELS", 1)     # K3 at batch 1 on a small plane
    module = build()

    def kept(dt=dtype):
        """The module's entry for ``(form, dt)`` after a forward: (key, operands)."""
        with torch.no_grad():
            run(module, dt)
            want = make(module, dt)
        entry = module._operands[form, dt]
        _assert_is_make(entry[1], want)
        return entry

    first = kept()
    folds = br.BN_FOLDS.value
    again = kept()
    assert again is first and all(a is b for a, b in zip(_leaves(again[1]), _leaves(first[1])))
    assert br.BN_FOLDS.value == folds                      # a warm forward folds nothing

    seen = [first]
    target = edited(module)
    with torch.no_grad():
        (target.running_var if isinstance(target, torch.nn.BatchNorm2d)
         else target.weight).mul_(1.5)
    seen.append(kept())
    part = replaced(module)
    part.weight = torch.nn.Parameter(part.weight.detach() * 2)
    seen.append(kept())
    rng = np.random.default_rng(17)
    arrays = {k: t.numpy().copy() for k, t in module.state_dict().items()}
    for _ in range(2):
        _refill(arrays, rng)
        module.load_state_dict({k: torch.from_numpy(a) for k, a in arrays.items()},
                               assign=True)
        seen.append(kept())
    assert len({id(entry) for entry in seen}) == len(seen)   # each change folded anew

    other_dtype = BF16 if dtype == torch.float32 else torch.float32
    mine = module._operands[form, dtype]
    kept(other_dtype)
    assert module._operands[form, dtype] is mine

    fresh = build()
    with torch.enable_grad():
        run(fresh, dtype)
    fresh.train()
    with torch.no_grad():
        run(fresh, dtype)
    assert not vars(fresh).get("_operands")
