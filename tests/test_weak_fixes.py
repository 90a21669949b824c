"""Hardening tests.

1. eval metrics are invariant to test_batch_size (partial-batch masking).
2. CV gradient variance is STRICTLY below NS after history convergence —
   the paper's core claim at the gradient level (reference gradvar
   protocol, train.py:241-277).
3. flat_csr warns when edge_cap_per_row truncates rows.
4. cap_adj_degree preserves row mass (reference --max_degree subsamples
   BEFORE normalization, gcn/utils.py:532-543).
5. field_capacities rounds to the mesh multiple (halo lowering eligibility).
6. checkpoints are data-only (no pickle anywhere in the npz).
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import preprocess as P
from stochastic_gcn_tpu.data.graph import flat_csr
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.sampler.scheduler import field_capacities
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=80, feature_dim=16, num_classes=4,
                             avg_degree=5, seed=0)


@pytest.mark.parametrize("cv", [False, True])
def test_eval_invariant_to_test_batch_size(ds, cv):
    """evaluate() must give identical metrics at any test_batch_size,
    including when the last batch is partial and sentinel-padded.  Exact
    sampling (degree > max deg) removes sampling noise; CV with exact
    sampling is history-independent (delta + full term cancel), so the
    only way results could differ is broken partial-batch masking."""
    max_deg = int(np.diff(ds.full_adj.indptr).max())
    out = []
    val = ds.val_d[:19]  # not divisible by either batch size
    for tbs in (7, 16):
        cfg = Config(dataset="synthetic", batch_size=32, hidden1=16,
                     dropout=0.0, seed=1, degree=max_deg + 1,
                     test_degree=max_deg + 1, cv=cv, test_cv=cv,
                     test_batch_size=tbs)
        tr = Trainer(cfg, ds)
        with jax.default_matmul_precision("float32"):
            loss, acc, micro, macro, _ = tr.evaluate(val)
        out.append((loss, acc, micro, macro))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-6)


def test_cv_grad_variance_strictly_below_ns_after_convergence(ds):
    """After the CV history has converged to the activations of a FIXED
    set of weights, CV first-layer gradient stdev must be STRICTLY below
    NS's at those same weights (reference protocol train.py:241-277; the
    round-1 test only bounded it at 1.5x).  Measuring both estimators at
    identical params is what the reference's --gradvar --load flow does —
    independent trainings end at different weights, making stdevs
    incomparable."""
    import dataclasses
    kw = dict(dataset="synthetic", batch_size=32, hidden1=16, dropout=0.0,
              seed=1, degree=1, test_degree=20)
    tr_cv = Trainer(Config(cv=True, learning_rate=1e-3, **kw), ds)
    for _ in range(5):
        tr_cv.train_epoch()
    # freeze the weights (lr=0) and let the history converge to them:
    # train_epoch still refreshes history after the (no-op) update
    tr_frozen = Trainer(Config(cv=True, learning_rate=0.0, **kw), ds)
    tr_frozen.state = tr_cv.state
    for _ in range(3):
        tr_frozen.train_epoch()
    tr_ns = Trainer(Config(learning_rate=0.0, **kw), ds)
    tr_ns.state = dataclasses.replace(tr_ns.state,
                                      params=tr_frozen.state.params)
    r_cv = tr_frozen.gradient_variance(times=80, log=lambda *a: None)
    r_ns = tr_ns.gradient_variance(times=80, log=lambda *a: None)
    assert r_cv["grad_stdev"] < r_ns["grad_stdev"], (r_cv, r_ns)
    assert r_cv["pred_stdev"] < r_ns["pred_stdev"], (r_cv, r_ns)


def test_flat_csr_truncation_warning():
    import scipy.sparse as sp
    # star graph: hub row degree 40, everyone else degree 1
    n = 41
    rows = np.concatenate([np.zeros(40, np.int32), np.arange(1, 41)])
    cols = np.concatenate([np.arange(1, 41), np.zeros(40, np.int32)])
    adj = sp.csr_matrix((np.ones(80, np.float32), (rows, cols)),
                        shape=(n, n))
    with pytest.warns(UserWarning, match="truncates"):
        g = flat_csr(adj, edge_mult=2.0)
    assert g.edge_cap_per_row < 40
    # no warning when the budget covers every row
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        flat_csr(adj, edge_mult=100.0)


def test_cap_adj_degree_preserves_row_mass():
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    a = (sp.random(30, 30, density=0.4, format="csr",
                   dtype=np.float32, random_state=1) > 0).astype(np.float32)
    norm = P.graphsage_normalize_adj(a)
    capped = P.cap_adj_degree(norm, 3, seed=0)
    sums = np.asarray(capped.sum(1)).ravel()
    orig = np.asarray(norm.sum(1)).ravel()
    np.testing.assert_allclose(sums, orig, rtol=1e-5)
    # rescale=False keeps the raw subsampled weights (round-1 behaviour)
    raw = P.cap_adj_degree(norm, 3, seed=0, rescale=False)
    deg = np.diff(norm.indptr)
    assert (np.asarray(raw.sum(1)).ravel()[deg > 3]
            < orig[deg > 3] - 1e-6).all()


def test_field_capacities_round_multiple():
    caps = field_capacities(96, [2, 2], num_nodes=1000, pad_degree=30,
                            round_multiple=8)
    assert all(c % 8 == 0 for c in caps)
    # monotone growth and batch preserved
    assert caps[-1] == 96
    plain = field_capacities(96, [2, 2], num_nodes=1000, pad_degree=30)
    assert all(r >= p for r, p in zip(caps, plain))


def test_checkpoint_is_pickle_free(tmp_path, ds):
    cfg = Config(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                 cv=True, test_cv=True, hidden1=16, seed=1,
                 ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, ds)
    tr.train_epoch()
    tr.save()
    tr.finish_checkpoints()      # saves are async: join before reading
    path = tmp_path / "model.ckpt.npz"
    z = np.load(path, allow_pickle=False)   # raises if any pickled entry
    for k in z.files:
        assert z[k].dtype != object
    # polyak reconciliation: a non-polyak checkpoint resumes a polyak run
    cfg2 = cfg.replace(polyak_decay=0.99)
    tr2 = Trainer(cfg2, ds)
    tr2.load(load_history=True)
    a = jax.tree_util.tree_leaves(tr2.state.avg_params)
    b = jax.tree_util.tree_leaves(tr2.state.params)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))
    tr2.train_epoch()


def test_activation_stats_taps():
    """Per-layer activation taps (reference layers.py:111-137 role): one
    label per layer plus the input, finite moments, dropout visible only
    on the train-side model."""
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data.loaders import synthetic_dataset
    from stochastic_gcn_tpu.training.loop import Trainer

    ds = synthetic_dataset(num_nodes=80, feature_dim=16, num_classes=4,
                           avg_degree=5, seed=0)
    cfg = Config(dataset="synthetic", batch_size=32, test_batch_size=32,
                 hidden1=16, dropout=0.3, seed=3, degree=1, test_degree=1,
                 cv=True, test_cv=True)
    tr = Trainer(cfg, ds)
    tr.train_epoch()
    for train in (True, False):
        stats = tr.activation_stats(train=train)
        spec = tr.train_spec if train else tr.test_spec
        assert len(stats) == len(spec.specs) + 1       # + "input"
        assert "input" in stats
        import numpy as np
        for v in stats.values():
            assert np.isfinite([v["mean"], v["std"], v["absmax"]]).all()
        # the last (logits) layer must have nonzero spread
        last = list(stats.values())[-1]
        assert last["std"] > 0


def test_nan_edge_weights_fail_loudly(tmp_path):
    """The reference's one runtime data guard (scheduler.cpp:114-115
    throws on NaN IS weight): corrupt edge weights must raise at Trainer
    build instead of sampling garbage silently."""
    import numpy as np
    import pytest
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data.loaders import load_data
    from stochastic_gcn_tpu.training.loop import Trainer

    # DEFAULT config (no --importance): the guard must still fire on the
    # edge-weight tables themselves
    cfg = Config(dataset="synthetic:100:8:3", batch_size=32, degree=1,
                 hidden1=8, seed=1, ckpt_dir=str(tmp_path))
    ds = load_data(cfg)
    ds.train_adj.data[0] = np.nan
    with pytest.raises(ValueError, match="edge weights"):
        Trainer(cfg, ds)
    # and with --importance + an Inf in the FULL graph (test side)
    cfg2 = cfg.replace(importance=True, test_importance=True)
    ds2 = load_data(cfg2)
    ds2.full_adj.data[0] = np.inf
    with pytest.raises(ValueError, match="edge weights"):
        Trainer(cfg2, ds2)


def test_det_dropout_fc_finite_on_zero_rows():
    """Regression: det_dropout_fc's
    normed variance path divided by raw row variance, so an all-zero
    (sentinel padding) row produced 0 * inf = NaN — surfaced by the
    owner-aligned field layout, whose per-chip chunk padding feeds zero
    rows through the moment chain.  The reference divides by raw variance
    too (layers.py:185) but its dynamic shapes never see zero rows."""
    from stochastic_gcn_tpu.ops import layers as L

    key = jax.random.PRNGKey(0)
    params = L.init_det_dropout_fc(key, 8, 8, norm=True)
    x = jnp.zeros((4, 8), jnp.float32).at[0].set(
        jnp.arange(8, dtype=jnp.float32))
    mu, var = L.det_dropout_fc(params, x, keep_prob=0.8, norm=True)
    assert np.isfinite(np.asarray(mu)).all()
    assert np.isfinite(np.asarray(var)).all()
    # tuple-input branch too (deeper layers see (mu, var) pairs)
    mu2, var2 = L.det_dropout_fc(params, (mu, var), keep_prob=0.8, norm=True)
    assert np.isfinite(np.asarray(mu2)).all()
    assert np.isfinite(np.asarray(var2)).all()


def test_is_slot_cap_auto_resolution():
    """--is_slot_cap -1 (auto, the default) resolves per batch shape:
    8 at >= 2048 scheduled rows, 0 below."""
    from stochastic_gcn_tpu.data.graph import pad_csr
    from stochastic_gcn_tpu.sampler.scheduler import compute_importance, \
        schedule

    assert Config().is_slot_cap == -1
    dsl = synthetic_dataset(num_nodes=4096, feature_dim=4, num_classes=3,
                            avg_degree=4, seed=0)
    g = pad_csr(dsl.train_adj)
    imp = compute_importance(g)
    small = jnp.arange(16, dtype=jnp.int32)
    pack = schedule(jax.random.PRNGKey(0), g, small, [2], cv=False,
                    importance=imp, is_slot_cap=-1)
    # cap off below the threshold: slot tables keep the full Dcap width
    assert pack.layers[0].slot_pos.shape[1] == g.pad_degree
    big = jnp.arange(2048, dtype=jnp.int32)
    pack_big = schedule(jax.random.PRNGKey(0), g, big, [2], cv=False,
                        importance=imp, is_slot_cap=-1)
    assert pack_big.layers[0].slot_pos.shape[1] == 8


def test_flat_csr_auto_budget_and_renorm():
    """--fadj_edge_mult 0 (default) auto-sizes
    the edgelist full-term budget to cover >= 99.9% of edges, and truncated
    rows are renormalized so the full term preserves row mass (the
    reference's --max_degree semantics, gcn/utils.py:532-543)."""
    import scipy.sparse as sp
    from stochastic_gcn_tpu.data.graph import AUTO_EDGE_COVERAGE
    from stochastic_gcn_tpu.models.aggregators import \
        full_neighborhood_mean_edgelist

    rng = np.random.default_rng(0)
    n = 400
    # Zipf-ish degrees: a few hubs, mostly small rows
    deg = np.minimum(rng.zipf(1.6, n).astype(np.int64), n - 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=deg.sum())
    keep = rows != cols
    adj = sp.csr_matrix(
        (rng.uniform(0.1, 1.0, keep.sum()).astype(np.float32),
         (rows[keep], cols[keep])), shape=(n, n))
    adj.sum_duplicates()

    g = flat_csr(adj)            # default: auto budget
    true_deg = np.diff(adj.indptr)
    covered = np.minimum(true_deg, g.edge_cap_per_row).sum()
    assert covered >= AUTO_EDGE_COVERAGE * true_deg.sum()
    assert g.edge_cap_per_row < int(true_deg.max())   # actually truncating

    # mass preservation: with a CONSTANT history h-bar, the full term is
    # row_mass * h for every row — renorm makes the truncated windows
    # reproduce it exactly (up to f32)
    hist = jnp.ones((n + 1, 3), jnp.float32) * jnp.asarray([1.0, -2.0, 0.5])
    hist = hist.at[n].set(0.0)
    field = jnp.asarray(np.argsort(-true_deg)[:64].astype(np.int32))
    got = np.asarray(full_neighborhood_mean_edgelist(hist, g, field))
    row_mass = np.asarray(adj.sum(1)).ravel()[np.asarray(field)]
    want = row_mass[:, None] * np.asarray([1.0, -2.0, 0.5])
    np.testing.assert_allclose(got, want, rtol=2e-4)

    # a generous explicit budget leaves renorm at 1 everywhere
    g_full = flat_csr(adj, edge_mult=1000.0)
    np.testing.assert_array_equal(np.asarray(g_full.renorm),
                                  np.ones(n + 1, np.float32))


def test_is_slot_cap_auto_resolves_to_exact_on_eval_paths(monkeypatch):
    """is_slot_cap=-1 (auto) engages the lossy cap only on the TRAIN step;
    eval/inference builders must resolve it to 0 (the reference's exact
    keep-every-edge union semantics, scheduler.cpp:118-121) — the 2048/8
    calibration was measured on the training step's fanout-gather bound,
    not on inference."""
    import numpy as np
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data.loaders import synthetic_dataset
    from stochastic_gcn_tpu.training import step as S
    from stochastic_gcn_tpu.training.loop import Trainer

    real = S.schedule
    caps = []

    def spy(*a, **kw):
        caps.append(kw.get("is_slot_cap"))
        return real(*a, **kw)

    monkeypatch.setattr(S, "schedule", spy)
    ds = synthetic_dataset(num_nodes=96, feature_dim=8, num_classes=3,
                           avg_degree=4, seed=0)
    cfg = Config(dataset="synthetic", batch_size=2048, test_batch_size=2048,
                 importance=True, test_importance=True, degree=1,
                 test_degree=1, hidden1=8, dropout=0.0)
    assert cfg.is_slot_cap == -1   # auto is the default under test
    tr = Trainer(cfg, ds)

    caps.clear()
    tr.train_epoch()
    assert caps and all(c == -1 for c in caps), caps   # auto -> schedule

    caps.clear()
    tr.evaluate(ds.val_d)
    assert caps and all(c == 0 for c in caps), caps    # eval: exact
