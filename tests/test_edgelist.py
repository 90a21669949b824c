"""Edge-list (flat-CSR) graph format: --graph_format=edgelist.

The padded [N, Dcap] layout pays O(N * max_degree) HBM and gathers
F * max_degree history rows per CV full-neighborhood term; the flat-CSR
layout stores O(E) and enumerates only the batch's actual edges — the
power-law answer to SURVEY.md §7.3 hard part #1 (fadj row lengths).
Semantics must be identical when the edge budget is sufficient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import graph as G
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=150, feature_dim=16, num_classes=4,
                             avg_degree=5, seed=0)


def test_graph_rows_equivalence(ds):
    pg = G.pad_csr(ds.full_adj)
    fg = G.flat_csr(ds.full_adj)
    assert fg.pad_degree == pg.pad_degree
    field = jnp.asarray(
        np.r_[np.arange(0, 150, 7), [150, 150]].astype(np.int32))
    pn, pw, pd = G.graph_rows(pg, field)
    fn, fw, fd = G.graph_rows(fg, field)
    np.testing.assert_array_equal(np.asarray(pn), np.asarray(fn))
    np.testing.assert_allclose(np.asarray(pw), np.asarray(fw))
    np.testing.assert_array_equal(np.asarray(pd), np.asarray(fd))


def test_full_neighborhood_edgelist_matches_padded(ds):
    from stochastic_gcn_tpu.models.aggregators import full_neighborhood_mean
    pg = G.pad_csr(ds.full_adj)
    fg = G.flat_csr(ds.full_adj, edge_mult=1e9)
    rng = np.random.default_rng(0)
    hist = jnp.asarray(rng.normal(size=(151, 8)).astype(np.float32))
    hist = hist.at[150].set(0.0)
    field = jnp.asarray(
        np.r_[rng.permutation(150)[:40], [150, 150]].astype(np.int32))
    for square in (False, True):
        a = full_neighborhood_mean(hist, pg, field, square=square)
        b = full_neighborhood_mean(hist, fg, field, square=square)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5)


def test_compute_importance_equivalence(ds):
    from stochastic_gcn_tpu.sampler.scheduler import compute_importance
    pg = G.pad_csr(ds.full_adj)
    fg = G.flat_csr(ds.full_adj)
    np.testing.assert_allclose(np.asarray(compute_importance(pg)),
                               np.asarray(compute_importance(fg)),
                               rtol=1e-6)


def test_edgelist_cv_trajectory_matches_padded(ds):
    """Same RNG stream + same math -> identical training trajectory when
    the edge budget covers every batch."""
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, dropout=0.2, seed=1)
    tr_a = Trainer(Config(**base), ds)
    tr_b = Trainer(Config(**base, graph_format="edgelist",
                          fadj_edge_mult=1e9), ds)
    for _ in range(3):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    ev_a = tr_a.evaluate(ds.val_d)
    ev_b = tr_b.evaluate(ds.val_d)
    np.testing.assert_allclose(ev_a[0], ev_b[0], rtol=1e-4)


def test_edgelist_importance_trajectory_matches_padded(ds):
    base = dict(dataset="synthetic", batch_size=64, degree=2, test_degree=2,
                importance=True, hidden1=16, dropout=0.0, seed=3)
    tr_a = Trainer(Config(**base), ds)
    tr_b = Trainer(Config(**base, graph_format="edgelist",
                          fadj_edge_mult=1e9), ds)
    for _ in range(2):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    np.testing.assert_allclose(la, lb, rtol=1e-5)


def test_edgelist_cv_exact_inference(ds):
    """The CV -> exact property (train.py:339-341) holds on the edgelist
    path."""
    from tests.test_estimators import dense_forward_gcn_pp, eval_logits
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 dropout=0.0, seed=1, test_batch_size=75,
                 graph_format="edgelist", fadj_edge_mult=1e9)
    tr = Trainer(cfg, ds)
    ids = np.arange(ds.num_data, dtype=np.int32)
    with jax.default_matmul_precision("float32"):
        for _ in range(cfg.num_layers + 1):
            preds = eval_logits(tr, ids)
    logits = dense_forward_gcn_pp(ds, tr.state.params, ds.full_adj)
    expect = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(preds, expect, atol=2e-3)


def test_edgelist_truncation_still_runs(ds):
    """An undersized edge budget drops trailing edges but must stay finite
    and trainable."""
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 dropout=0.2, seed=1, graph_format="edgelist",
                 fadj_edge_mult=0.25)
    tr = Trainer(cfg, ds)
    assert tr.graph_train.edge_cap_per_row < tr.graph_train.max_degree
    for _ in range(3):
        loss, *_ = tr.train_epoch()
    assert np.isfinite(loss)


def test_edgelist_sharded_history_matches_single_device(ds):
    """dp>1 with sharded history + edgelist graphs goes through the halo
    lowering and matches single-device training."""
    import jax as _jax
    n_dev = len(_jax.devices())
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, dropout=0.2, seed=1,
                graph_format="edgelist", fadj_edge_mult=1e9,
                test_batch_size=64, field_dedup=True)   # mesh arm forces it
    tr1 = Trainer(Config(**base), ds)
    trN = Trainer(Config(**base, dp=n_dev), ds)
    for _ in range(2):
        l1, *_ = tr1.train_epoch()
        lN, *_ = trN.train_epoch()
    np.testing.assert_allclose(l1, lN, rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(tr1.state.histories),
                    jax.tree_util.tree_leaves(trN.state.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_flat_csr_block_alignment_invariants():
    """Block-aligned layout: every row starts on a BLOCK boundary, gaps and
    tail hold sentinel/0, windows recover exact rows incl. hub truncation
    and zero-degree rows."""
    rng = np.random.default_rng(7)
    n = 37
    # adversarial degree sequence: zeros, a hub, odd sizes around BLOCK
    deg = rng.integers(0, 13, size=n)
    deg[5] = 0
    deg[11] = 29          # hub > any window width we'll use below
    rows, cols, vals = [], [], []
    for i in range(n):
        nbrs = rng.choice(n, size=deg[i], replace=False)
        rows += [i] * deg[i]
        cols += list(nbrs)
        vals += list(rng.uniform(0.5, 1.5, deg[i]))
    import scipy.sparse as sp
    adj = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    fg = G.flat_csr(adj, edge_mult=1e9)
    B = G.FlatGraph.BLOCK

    bstart = np.asarray(fg.bstart)
    idx = np.asarray(fg.idx)
    w = np.asarray(fg.w)
    assert idx.shape[1] == B and w.shape[1] == B
    d = np.diff(adj.indptr)
    # row block ranges are exactly ceil(deg/B) and contiguous
    np.testing.assert_array_equal(np.diff(bstart[:n + 1]), -(-d // B))
    assert bstart[n + 1] == bstart[n]
    flat_i, flat_w = idx.reshape(-1), w.reshape(-1)
    for i in range(n):
        s = bstart[i] * B
        np.testing.assert_array_equal(flat_i[s:s + d[i]],
                                      adj.indices[adj.indptr[i]:
                                                  adj.indptr[i + 1]])
        np.testing.assert_allclose(flat_w[s:s + d[i]],
                                   adj.data[adj.indptr[i]:
                                            adj.indptr[i + 1]])
        # alignment gap up to the next block boundary: sentinel / 0
        gap = bstart[i + 1] * B
        assert (flat_i[s + d[i]:gap] == n).all()
        assert (flat_w[s + d[i]:gap] == 0).all()
    # tail blocks past the last row: all sentinel
    assert (flat_i[bstart[n] * B:] == n).all()

    # window materialization: exact rows, sentinel-masked, hub truncated
    field = jnp.asarray(np.r_[np.arange(n), [n]].astype(np.int32))
    for width in (1, 7, 8, 9, 16):
        fn, fw, fd = G.flat_row_windows(fg, field, width)
        fn, fw = np.asarray(fn), np.asarray(fw)
        assert fn.shape == (n + 1, width)
        for i in range(n):
            k = min(d[i], width)      # hub rows truncate to first `width`
            np.testing.assert_array_equal(
                fn[i, :k], adj.indices[adj.indptr[i]:adj.indptr[i] + k])
            assert (fn[i, k:] == n).all() and (fw[i, k:] == 0).all()
        assert (fn[n] == n).all()     # sentinel row: empty


def test_flat_csr_truncated_frac_recorded():
    """The edge fraction dropped by the per-row budget is a static field
    on the graph (surfaced as truncated_edges_frac in bench artifacts),
    0.0 when the budget covers every row."""
    import numpy as np
    import scipy.sparse as sp
    from stochastic_gcn_tpu.data.graph import flat_csr

    rng = np.random.default_rng(0)
    n = 64
    dense = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(dense, 0)
    adj = sp.csr_matrix(dense)
    deg = np.diff(adj.indptr)

    g_exact = flat_csr(adj, edge_mult=0.0)
    assert g_exact.truncated_frac == 0.0 or g_exact.truncated_frac < 1e-3

    # force a tiny budget: mean degree ~12, cap at ~1 entry per row
    g_lossy = flat_csr(adj, edge_mult=1.0 / max(float(deg.mean()), 1.0))
    lost = int(np.maximum(deg - g_lossy.edge_cap_per_row, 0).sum())
    expect = lost / max(int(deg.sum()), 1)
    assert abs(g_lossy.truncated_frac - expect) < 1e-5
    assert g_lossy.truncated_frac > 0.5
