"""Metrics and small stat helpers.

Mirrors gcn/utils.py:507-529 (Averager, calc_f1) and gcn/stats.py:3-14 (Stat).
"""

from __future__ import annotations

import numpy as np


def calc_f1(y_pred: np.ndarray, y_true: np.ndarray,
            multitask: bool) -> tuple[float, float]:
    """Micro/macro F1 with sklearn's ``f1_score`` conventions (what the
    reference calls, gcn/utils.py:521-529).  Multitask thresholds sigmoid
    outputs at 0.5; single-label argmaxes."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    if multitask:
        p = y_pred > 0.5
        t = y_true > 0.5
    else:
        c = y_true.shape[1]
        p = np.argmax(y_pred, axis=1)[:, None] == np.arange(c)
        t = np.argmax(y_true, axis=1)[:, None] == np.arange(c)
    tp = np.sum(p & t, axis=0)
    fp = np.sum(p & ~t, axis=0)
    fn = np.sum(~p & t, axis=0)
    return f1_from_counts(tp, fp, fn, multitask)


def device_f1_counts(logits, labels, valid, multitask: bool):
    """Per-class TP/FP/FN counters computed on device (jnp), so evaluation
    fetches C-length vectors instead of the [N, C] predictions.

    Semantics match :func:`calc_f1`: multitask thresholds sigmoid at 0.5
    (== logits > 0); single-label argmaxes.
    """
    import jax.numpy as jnp
    c = logits.shape[1]
    if multitask:
        p = logits > 0
        t = labels > 0.5
        m = valid[:, None] > 0
        tp = jnp.sum(p & t & m, axis=0)
        fp = jnp.sum(p & ~t & m, axis=0)
        fn = jnp.sum(~p & t & m, axis=0)
    else:
        pred = jnp.argmax(logits, axis=1)
        true = jnp.argmax(labels, axis=1)
        cls = jnp.arange(c)
        m = valid > 0
        p1 = (pred[:, None] == cls[None, :]) & m[:, None]
        t1 = (true[:, None] == cls[None, :]) & m[:, None]
        tp = jnp.sum(p1 & t1, axis=0)
        fp = jnp.sum(p1 & ~t1, axis=0)
        fn = jnp.sum(~p1 & t1, axis=0)
    return tp.astype(jnp.int32), fp.astype(jnp.int32), fn.astype(jnp.int32)


def f1_from_counts(tp, fp, fn, multitask: bool) -> tuple[float, float]:
    """micro/macro F1 from summed per-class counters; matches sklearn's
    conventions (multilabel macro averages ALL columns; multiclass macro
    averages classes present in y_true or y_pred)."""
    tp = np.asarray(tp, np.float64)
    fp = np.asarray(fp, np.float64)
    fn = np.asarray(fn, np.float64)
    denom = 2 * tp.sum() + fp.sum() + fn.sum()
    micro = 2 * tp.sum() / denom if denom else 0.0
    per_denom = 2 * tp + fp + fn
    per_f1 = np.divide(2 * tp, per_denom,
                       out=np.zeros_like(tp), where=per_denom > 0)
    if multitask:
        macro = per_f1.mean() if len(per_f1) else 0.0
    else:
        present = per_denom > 0
        macro = per_f1[present].mean() if present.any() else 0.0
    return float(micro), float(macro)


class Averager:
    """Trailing-window mean (gcn/utils.py:507-518)."""

    def __init__(self, window_size: int):
        self.window_size = window_size
        self.window: list[float] = []

    def add(self, n) -> None:
        self.window.append(float(n))
        if len(self.window) > self.window_size:
            self.window = self.window[1:]

    def mean(self) -> float:
        return float(np.mean(self.window)) if self.window else float("nan")


class Stat:
    """Accumulates arrays across runs; mean/std elementwise
    (gcn/stats.py:3-14)."""

    def __init__(self):
        self.vals: list[np.ndarray] = []

    def add(self, v) -> None:
        self.vals.append(np.asarray(v))

    def mean(self) -> np.ndarray:
        return np.mean(np.stack(self.vals), axis=0)

    def std(self) -> np.ndarray:
        return np.std(np.stack(self.vals), axis=0)
