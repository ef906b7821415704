"""The port's losses and metrics (``dmmfods_tpu_torch/losses.py``,
``metrics.py``) against the JAX package's on the same numpy arrays, in f32
on the CPU.

Tolerances: the losses at rtol 1e-6 / atol 1e-6 (the same expressions; exp
and log1p differ between the two libraries by an ulp, and sums by their
order). Equal exactly: IoU (NaN where JAX has NaN), the NaN counts,
accuracy, the AP bin counts and ``ap_from_binned_counts`` (counts and ratios
of counts). The exact AP at rtol 1e-6: its positives' precisions are sums
taken in another order, while a tie broken the other way moves it by ~1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu import losses as jax_losses
from dmmfods_tpu import metrics as jax_metrics
from dmmfods_tpu.config import get_config as jax_get_config
from dmmfods_tpu_torch import losses, metrics
from dmmfods_tpu_torch.config import get_config

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (2, 16, 24, 3)


def _arrays(seed, shape=SHAPE):
    """Logits N(0, 2) and heat maps in [0, 1] with about a third of the
    pixels at or above 0.7."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, shape).astype(np.float32)
    heat = rng.uniform(0, 1, shape).astype(np.float32) ** 0.7
    return logits, heat


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_rounded(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("fn", ["bce_with_logits", "bce_with_logits_sum"])
def test_bce_matches_jax(fn):
    logits, heat = _arrays(0)
    want = np.asarray(getattr(jax_losses, fn)(jnp.asarray(logits), jnp.asarray(heat)))
    got = getattr(losses, fn)(_t(logits), _t(heat)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_per_class_loss_matches_jax():
    logits, heat = _arrays(1)
    elementwise = jax_losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(heat))
    want = np.asarray(jax_losses.per_class_loss(elementwise))
    got = losses.per_class_loss(_t(np.asarray(elementwise))).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("fn,alpha,gamma", [
    ("focal_loss", 0.25, 2.0),
    ("focal_loss", 1, 2),
    ("class_wise_focal_loss", (0.5, 1.0, 2.0), (1.0, 2.0, 3.0)),
])
def test_focal_losses_match_jax(fn, alpha, gamma, from_logits, reduce):
    logits, heat = _arrays(2)
    if not from_logits:                      # probabilities, some at the clip bounds
        logits = 1 / (1 + np.exp(-logits))
        logits[0, 0, :3] = (0.0, 1.0, 0.5)
    want = np.asarray(getattr(jax_losses, fn)(
        jnp.asarray(logits), jnp.asarray(heat), alpha, gamma, from_logits=from_logits,
        reduce=reduce))
    got = getattr(losses, fn)(_t(logits), _t(heat), alpha, gamma, from_logits=from_logits,
                              reduce=reduce).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("loss_type", ["bce", "focal", "class_wise_focal"])
@pytest.mark.parametrize("logits_flag", [True, False])
def test_loss_factories_match_jax(tmp_path, loss_type, logits_flag):
    logits, heat = _arrays(3)
    if not logits_flag:
        logits = 1 / (1 + np.exp(-logits))
    jcfg, pcfg = jax_get_config(str(tmp_path)), get_config(str(tmp_path))
    for cfg in (jcfg, pcfg):
        cfg.loss.type = loss_type
        cfg.loss.logits = logits_flag
        cfg.loss.alpha, cfg.loss.gamma = (0.5, 1.0, 2.0), (1.0, 2.0, 3.0)
        if loss_type == "focal":
            cfg.loss.alpha, cfg.loss.gamma = 0.25, 2
    ja, jh = jnp.asarray(logits), jnp.asarray(heat)
    want = np.asarray(jax_losses.make_loss_fn(jcfg)(ja, jh))
    np.testing.assert_allclose(losses.make_loss_fn(pcfg)(_t(logits), _t(heat)).numpy(), want,
                               **LOSS_TOL)
    want = np.asarray(jax_losses.make_elementwise_loss_fn(jcfg)(ja, jh))
    got = losses.make_elementwise_loss_fn(pcfg)(_t(logits), _t(heat)).numpy()
    assert got.shape == want.shape == SHAPE
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_unknown_loss_type_raises(tmp_path):
    cfg = get_config(str(tmp_path))
    cfg.loss.type = "hinge"
    with pytest.raises(ValueError, match="hinge"):
        losses.make_loss_fn(cfg)
    with pytest.raises(ValueError, match="hinge"):
        losses.make_elementwise_loss_fn(cfg)


def _iou_arrays():
    """Heat maps where class 1 of sample 0 is empty in both maps (0/0 ->
    NaN) and class 2 is empty in every sample (aggregated to 0)."""
    logits, heat = _arrays(4, (3, 8, 12, 3))
    heat[0, ..., 1] = 0.0
    logits[0, ..., 1] = -5.0
    heat[..., 2] = 0.1
    logits[..., 2] = 0.0
    return logits, heat


@pytest.mark.parametrize("sigmoid", [False, True])
def test_iou_matches_jax_exactly(sigmoid):
    logits, heat = _iou_arrays()
    want = np.asarray(jax_metrics.compute_iou_batch(
        jnp.asarray(heat), jnp.asarray(logits), 0.7, sigmoid=sigmoid))
    got = metrics.compute_iou_batch(_t(heat), _t(logits), 0.7, sigmoid=sigmoid).numpy()
    assert got.shape == (3, 3)
    assert np.isnan(got[:, 2]).all() and (np.isnan(got[0, 1]) or sigmoid)
    np.testing.assert_array_equal(got, want)         # NaN where JAX has NaN
    want = np.asarray(jax_metrics.compute_iou_per_class(
        jnp.asarray(heat[1]), jnp.asarray(logits[1]), 0.6, sigmoid=sigmoid))
    got = metrics.compute_iou_per_class(_t(heat[1]), _t(logits[1]), 0.6, sigmoid=sigmoid)
    np.testing.assert_array_equal(got.numpy(), want)


def test_aggregate_iou_matches_jax_exactly():
    logits, heat = _iou_arrays()
    iou = np.asarray(jax_metrics.compute_iou_batch(jnp.asarray(heat), jnp.asarray(logits)))
    want_mean, want_nans = (np.asarray(x) for x in jax_metrics.aggregate_iou(jnp.asarray(iou)))
    got_mean, got_nans = (x.numpy() for x in metrics.aggregate_iou(_t(iou)))
    assert got_mean[2] == 0.0 and got_nans.tolist() == [0.0, 1.0, 3.0]
    assert got_mean.dtype == got_nans.dtype == np.float32
    np.testing.assert_array_equal(got_mean, want_mean)
    np.testing.assert_array_equal(got_nans, want_nans)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("sigmoid", [False, True])
def test_accuracy_matches_jax_exactly(ndim, sigmoid):
    logits, heat = _arrays(5)
    if ndim == 3:
        logits, heat = logits[0], heat[0]
    want = np.asarray(jax_metrics.compute_accuracy(
        jnp.asarray(heat), jnp.asarray(logits), 0.7, sigmoid=sigmoid))
    got = metrics.compute_accuracy(_t(heat), _t(logits), 0.7, sigmoid=sigmoid).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_accuracy_rejects_other_ranks():
    with pytest.raises(ValueError, match="3 or 4"):
        metrics.compute_accuracy(torch.zeros(4, 3), torch.zeros(4, 3))


def _tied_case():
    """bf16-rounded logits of a 2x16x24x3 batch: fewer than half of the
    2,304 values are distinct, so the AP depends on how ties are ordered."""
    logits, heat = _arrays(6)
    return _bf16_rounded(logits), heat


def test_average_precision_matches_jax_with_ties():
    logits, heat = _tied_case()
    assert np.unique(logits).size < logits.size / 2
    want = np.asarray(jax_metrics.heatmap_average_precision(jnp.asarray(heat),
                                                            jnp.asarray(logits)))
    got = metrics.heatmap_average_precision(_t(heat), _t(logits)).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_average_precision_needs_the_stable_sort(monkeypatch):
    """With ties broken in the opposite index order (a sort that is not
    stable may do that), the AP leaves the tolerance: the test above would
    fail."""
    logits, heat = _tied_case()
    want = np.asarray(jax_metrics.heatmap_average_precision(jnp.asarray(heat),
                                                            jnp.asarray(logits)))
    argsort = torch.argsort

    def reversed_ties(x, dim=-1, stable=False):
        n = x.shape[dim]
        flipped = argsort(x.flip(dim), dim=dim, stable=True)
        return (n - 1) - flipped                # descending index order among ties

    monkeypatch.setattr(torch, "argsort", reversed_ties)
    got = metrics.heatmap_average_precision(_t(heat), _t(logits)).numpy()
    assert np.abs(got - want).max() > 1e-5


def test_average_precision_of_a_class_without_positives():
    logits, heat = _arrays(7)
    heat[..., 1] = 0.5
    want = np.asarray(jax_metrics.heatmap_average_precision(jnp.asarray(heat),
                                                            jnp.asarray(logits)))
    got = metrics.heatmap_average_precision(_t(heat), _t(logits)).numpy()
    assert got[1] == 0.0 and want[1] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("num_bins", [metrics.NUM_AP_BINS, 64])
def test_binned_ap_counts_match_jax_exactly(num_bins):
    logits, heat = _arrays(8)
    logits[0, 0, 0] = (-100.0, 100.0, 0.0)          # the end bins and the middle
    want = np.asarray(jax_metrics.binned_ap_counts(jnp.asarray(heat), jnp.asarray(logits),
                                                   num_bins=num_bins))
    got = metrics.binned_ap_counts(_t(heat), _t(logits), num_bins=num_bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3, num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1].sum()) == logits.size
    assert metrics.NUM_AP_BINS == jax_metrics.NUM_AP_BINS


def test_ap_from_binned_counts_matches_jax_exactly():
    logits, heat = _arrays(9)
    heat[..., 2] = 0.0                                # a class without positives
    counts = np.asarray(jax_metrics.binned_ap_counts(jnp.asarray(heat), jnp.asarray(logits)))
    want = jax_metrics.ap_from_binned_counts(counts)
    got = metrics.ap_from_binned_counts(_t(counts))
    assert got[2] == 0.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(metrics.ap_from_binned_counts(counts), want)


def test_streaming_ap_over_two_batches_matches_jax():
    """Two batches streamed: the port's accumulator against JAX's, exactly,
    and against the exact AP of the pooled pixels within the bin width."""
    batches = [_arrays(10), _arrays(11)]
    got, want = metrics.StreamingAP(), jax_metrics.StreamingAP()
    for logits, heat in batches:
        got.update(metrics.binned_ap_counts(_t(heat), _t(logits)))
        want.update(jax_metrics.binned_ap_counts(jnp.asarray(heat), jnp.asarray(logits)))
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.result(), want.result())
    pooled = metrics.heatmap_average_precision(
        torch.cat([_t(h) for _, h in batches]), torch.cat([_t(x) for x, _ in batches]))
    np.testing.assert_allclose(got.result(), pooled.numpy(), atol=1e-3)
