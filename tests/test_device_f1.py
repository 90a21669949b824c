"""On-device F1 counters must reproduce sklearn's calc_f1 exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from stochastic_gcn_tpu.utils.metrics import (calc_f1, device_f1_counts,
                                              f1_from_counts)


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_f1_matches_sklearn(multitask, seed, rng=None):
    rng = np.random.default_rng(seed)
    n, c = 200, 7
    logits = rng.normal(size=(n, c)).astype(np.float32)
    if multitask:
        labels = (rng.random((n, c)) < 0.3).astype(np.float32)
        pred_for_sklearn = 1.0 / (1.0 + np.exp(-logits))   # sigmoid
    else:
        labels = np.zeros((n, c), np.float32)
        labels[np.arange(n), rng.integers(0, c, n)] = 1
        pred_for_sklearn = logits
    valid = np.ones(n, np.float32)
    valid[-17:] = 0.0   # sentinel-padded tail

    tp, fp, fn = device_f1_counts(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(valid), multitask)
    micro, macro = f1_from_counts(tp, fp, fn, multitask)
    ref_micro, ref_macro = calc_f1(pred_for_sklearn[:-17].copy(),
                                   labels[:-17], multitask)
    np.testing.assert_allclose(micro, ref_micro, atol=1e-9)
    np.testing.assert_allclose(macro, ref_macro, atol=1e-9)


def test_device_f1_batched_accumulation():
    """Summing counters over batches == computing on the concatenation."""
    rng = np.random.default_rng(0)
    c = 5
    tot = np.zeros((3, c), np.int64)
    all_logits, all_labels = [], []
    for b in range(4):
        logits = rng.normal(size=(50, c)).astype(np.float32)
        labels = np.zeros((50, c), np.float32)
        labels[np.arange(50), rng.integers(0, c, 50)] = 1
        valid = np.ones(50, np.float32)
        tp, fp, fn = device_f1_counts(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(valid), False)
        tot += np.stack([np.asarray(tp), np.asarray(fp), np.asarray(fn)])
        all_logits.append(logits)
        all_labels.append(labels)
    micro, macro = f1_from_counts(*tot, False)
    ref_micro, ref_macro = calc_f1(np.vstack(all_logits),
                                   np.vstack(all_labels), False)
    np.testing.assert_allclose(micro, ref_micro, atol=1e-9)
    np.testing.assert_allclose(macro, ref_macro, atol=1e-9)


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_calc_f1_matches_sklearn(multitask, seed):
    """The NumPy calc_f1 reproduces sklearn's f1_score (what the
    reference calls), including classes absent from both sides."""
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(seed)
    n, c = 150, 9
    if multitask:
        labels = (rng.random((n, c)) < 0.3).astype(np.float32)
        labels[:, -1] = 0.0                    # a never-positive column
        probs = rng.random((n, c)).astype(np.float32)
        y_true, y_pred = labels, (probs > 0.5).astype(np.float32)
    else:
        labels = np.zeros((n, c), np.float32)
        labels[np.arange(n), rng.integers(0, c - 2, n)] = 1  # 2 absent
        probs = rng.normal(size=(n, c)).astype(np.float32)
        probs[:, -1] = -10.0                   # never predicted either
        y_true, y_pred = labels.argmax(1), probs.argmax(1)
    micro, macro = calc_f1(probs, labels, multitask)
    np.testing.assert_allclose(
        micro, metrics.f1_score(y_true, y_pred, average="micro"),
        atol=1e-12)
    np.testing.assert_allclose(
        macro, metrics.f1_score(y_true, y_pred, average="macro",
                                zero_division=0), atol=1e-12)
