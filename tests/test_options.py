"""Option flags without a reference counterpart: history_dtype (bf16
history storage), sched_prepass, profile_dir and friends."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=150, feature_dim=16, num_classes=4,
                             avg_degree=5, seed=0)


def test_bf16_history_trains(ds):
    """bf16 history halves storage; the CV estimator stays well-behaved
    (history is a control variate — any stored h̄ keeps it unbiased)."""
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 dropout=0.2, seed=1, history_dtype="bfloat16")
    tr = Trainer(cfg, ds)
    h0 = jax.tree_util.tree_leaves(tr.state.histories)[0]
    assert h0.dtype == jnp.bfloat16
    losses = []
    for _ in range(10):
        loss, *_ = tr.train_epoch()
        losses.append(loss)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    ev = tr.evaluate(ds.val_d)
    assert np.isfinite(ev[0])


def test_bf16_cv_inference_close_to_exact(ds):
    """The CV->exact inference property (train.py:339-341) holds under bf16
    history to bf16 tolerance."""
    from tests.test_estimators import dense_forward_gcn_pp, eval_logits
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 dropout=0.0, seed=1, history_dtype="bfloat16",
                 test_batch_size=75)
    tr = Trainer(cfg, ds)
    ids = np.arange(ds.num_data, dtype=np.int32)
    with jax.default_matmul_precision("float32"):
        for _ in range(cfg.num_layers + 1):
            preds = eval_logits(tr, ids)
    logits = dense_forward_gcn_pp(ds, tr.state.params, ds.full_adj)
    expect = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(preds, expect, atol=0.03)


def test_scan_unroll_matches_default(ds):
    """scan_unroll>1 is a pure scheduling change: identical RNG stream and
    math, so the training trajectory matches unroll=1 exactly."""
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, dropout=0.3, seed=1)
    tr_a = Trainer(Config(**base), ds)
    tr_b = Trainer(Config(**base, scan_unroll=4), ds)
    for _ in range(3):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    ev_a = tr_a.evaluate(ds.val_d)
    ev_b = tr_b.evaluate(ds.val_d)
    np.testing.assert_allclose(ev_a[0], ev_b[0], rtol=1e-5)


def test_sched_prepass_trajectory_identical(ds):
    """The chunked vmapped scheduler pre-pass derives each step's key
    exactly as the in-step path does, so training is BIT-identical with
    it on or off (the dispatch structure is the only difference)."""
    base = dict(dataset="synthetic", batch_size=32, degree=2, test_degree=2,
                cv=True, test_cv=True, hidden1=16, dropout=0.3, seed=1,
                sched_prepass_chunk=2)   # exercise the step-axis padding
    tr_a = Trainer(Config(**base, sched_prepass="off"), ds)
    tr_b = Trainer(Config(**base, sched_prepass="on"), ds)
    for _ in range(3):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    assert la == lb    # bit-identical, not merely close
    pa = jax.tree_util.tree_leaves(tr_a.state.params)
    pb = jax.tree_util.tree_leaves(tr_b.state.params)
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sched_prepass_auto_budget_gate(ds):
    """auto mode falls back to in-step scheduling when the per-epoch pack
    exceeds the byte budget — trajectory must still be identical."""
    base = dict(dataset="synthetic", batch_size=32, degree=2, test_degree=2,
                cv=True, test_cv=True, hidden1=16, dropout=0.3, seed=1)
    tr_a = Trainer(Config(**base, sched_prepass="auto",
                          sched_prepass_budget_mb=0), ds)   # always gated off
    tr_b = Trainer(Config(**base, sched_prepass="on"), ds)
    la = lb = None
    for _ in range(2):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    assert la == lb


def test_sched_prepass_importance(ds):
    """Pre-pass composes with the IS scheduler (union membership tables
    vmapped over steps)."""
    base = dict(dataset="synthetic", batch_size=32, degree=2, test_degree=2,
                importance=True, hidden1=16, dropout=0.2, seed=1)
    tr_a = Trainer(Config(**base, sched_prepass="off"), ds)
    tr_b = Trainer(Config(**base, sched_prepass="on"), ds)
    for _ in range(2):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    assert la == lb


def test_profile_dir_writes_trace(tmp_path, ds):
    """--profile_dir: the selected epoch runs under jax.profiler.trace and
    leaves an XProf/TensorBoard trace under plugins/profile (the §5.1
    profiling surface; reference analogue is the per-epoch TF-time log,
    gcn/train.py:203-207)."""
    import glob
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.training.loop import Trainer

    cfg = Config(dataset="synthetic", batch_size=32, hidden1=8,
                 dropout=0.0, seed=1, cv=True, test_cv=True, degree=1,
                 test_degree=1, epochs=2, early_stopping=100,
                 profile_dir=str(tmp_path / "prof"), profile_epochs="2")
    tr = Trainer(cfg, ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=3)
    found = glob.glob(str(tmp_path / "prof" / "plugins" / "profile" /
                          "*" / "*"))
    assert found, "no profiler trace files written"


def test_features_dtype_bfloat16_trains_close_to_f32():
    """--features_dtype bfloat16 halves the biggest device tables; the
    mixed bf16xf32 first-layer contraction must track the f32 run
    closely (dense and padded-sparse feature paths)."""
    import numpy as np
    import scipy.sparse as sp
    import jax.numpy as jnp

    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data.loaders import synthetic_dataset
    from stochastic_gcn_tpu.training.loop import Trainer

    ds = synthetic_dataset(num_nodes=200, feature_dim=24, num_classes=4,
                           avg_degree=6, seed=0)
    base = Config(dataset="synthetic", batch_size=64, degree=1,
                  test_degree=10000, cv=True, test_cv=True, hidden1=16,
                  seed=1)

    losses = {}
    for dt in ("float32", "bfloat16"):
        tr = Trainer(base.replace(features_dtype=dt), ds)
        assert tr.train_features.dtype == jnp.dtype(dt)
        for _ in range(3):
            loss, _, _, _ = tr.train_epoch()
        vloss, _, micro, _, _ = tr.evaluate(ds.val_d)
        losses[dt] = (loss, vloss, micro)
    f32, b16 = losses["float32"], losses["bfloat16"]
    assert abs(f32[0] - b16[0]) < 0.08, losses
    assert abs(f32[2] - b16[2]) < 0.15, losses

    # padded-sparse value path
    import dataclasses
    sp_feats = sp.csr_matrix(np.where(
        np.random.default_rng(0).random(ds.feats.shape) < 0.1,
        ds.feats, 0.0))
    ds_sp = dataclasses.replace(ds, feats=sp_feats,
                                train_feats=ds.train_feats,
                                test_feats=ds.test_feats)
    tr = Trainer(base.replace(features_dtype="bfloat16",
                              preprocess=False, test_preprocess=False),
                 ds_sp)
    assert tr.train_features.val.dtype == jnp.bfloat16
    loss, _, _, _ = tr.train_epoch()
    assert np.isfinite(loss)
