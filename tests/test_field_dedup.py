"""No-dedup field layout (--nofield_dedup, cfg.field_dedup): append-only
receptive fields whose slot positions are a trace-time iota, removing the
scheduler's O(N) compaction passes (the dominant non-gather cost of the
scheduler at large batch).  Duplicate field positions expand independent
neighbor samples — iid estimates of the same activation — so every
estimator property survives; these tests pin the layout contract, the
equal-first-expansion guarantee, the forced-dedup fallbacks, and the
CV->exact-at-convergence property end-to-end."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.graph import pad_csr
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.sampler.scheduler import (
    append_field, compute_importance, field_capacities, schedule)
from stochastic_gcn_tpu.training.loop import Trainer

from tests.test_scheduler import sampled_adj_dense


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=150, feature_dim=16, num_classes=4,
                             avg_degree=5, seed=0)


@pytest.fixture(scope="module")
def graph(ds):
    return pad_csr(ds.full_adj)


def test_capacities_match_when_unclamped():
    """With F*k <= N the no-dedup capacity is exactly the dedup one, so
    the append layout changes no tensor shape on large graphs."""
    a = field_capacities(64, [5, 5], num_nodes=10 ** 6, pad_degree=10)
    b = field_capacities(64, [5, 5], num_nodes=10 ** 6, pad_degree=10,
                         dedup=False)
    assert a == b
    # small N: dedup clamps at F + N, no-dedup keeps F + F*k
    a = field_capacities(64, [5, 5], num_nodes=50, pad_degree=10)
    b = field_capacities(64, [5, 5], num_nodes=50, pad_degree=10,
                         dedup=False)
    assert b[0] == (64 + 64 * 5) + (64 + 64 * 5) * 5
    assert a[0] < b[0]


def test_append_field_layout():
    n = 20
    field_out = jnp.asarray([3, 7, 11, n], jnp.int32)
    new_ids = jnp.asarray([[7, 2], [11, 2], [5, n], [n, n]], jnp.int32)
    cap = 4 + 8 + 3                                   # extra sentinel pad
    field_in, slot_pos = append_field(field_out, new_ids, n, cap)
    field_in, slot_pos = np.asarray(field_in), np.asarray(slot_pos)
    # prefix invariant: out field occupies positions 0..F-1 verbatim
    np.testing.assert_array_equal(field_in[:4], [3, 7, 11, n])
    # samples appended in row-major order WITHOUT dedup (7, 11, 2 repeat)
    np.testing.assert_array_equal(field_in[4:12],
                                  [7, 2, 11, 2, 5, n, n, n])
    assert (field_in[12:] == n).all()
    # slot positions are the iota F + f*k + j
    np.testing.assert_array_equal(slot_pos,
                                  4 + np.arange(8).reshape(4, 2))


def test_first_expansion_identical_to_dedup(graph):
    """The first expansion samples from the SAME field content in both
    layouts, so with one shared key the sampled weighted adjacency is
    identical — the layouts only diverge at deeper layers, where dedup
    shares one neighbor sample per node and append draws one per
    position."""
    n = graph.num_nodes
    batch = jnp.asarray(np.arange(24, dtype=np.int32))
    key = jax.random.PRNGKey(3)
    pk_a = schedule(key, graph, batch, [2], cv=True)
    pk_b = schedule(key, graph, batch, [2], cv=True, dedup=False)
    dense_a = sampled_adj_dense(graph, pk_a, 0, n)
    dense_b = sampled_adj_dense(graph, pk_b, 0, n)
    np.testing.assert_allclose(dense_a, dense_b, rtol=1e-6)


def test_two_layer_fields_prefix_and_duplicates(graph):
    n = graph.num_nodes
    batch = jnp.asarray(np.arange(16, dtype=np.int32))
    pack = schedule(jax.random.PRNGKey(0), graph, batch, [3, 3], cv=True,
                    dedup=False)
    # input-side-first: fields[-1] is the batch, fields[0] the innermost
    np.testing.assert_array_equal(np.asarray(pack.fields[-1]), batch)
    for l in range(len(pack.fields) - 1):
        outer = np.asarray(pack.fields[l + 1])
        inner = np.asarray(pack.fields[l])
        np.testing.assert_array_equal(inner[:outer.shape[0]], outer)
        # slot positions are the pure iota after the prefix
        pos = np.asarray(pack.layers[l].slot_pos)
        f, k = pos.shape
        np.testing.assert_array_equal(
            pos, outer.shape[0] + np.arange(f * k).reshape(f, k))
    # the innermost field of a 2-layer expansion on a 150-node graph
    # essentially always repeats ids — that's the point of the layout
    inner = np.asarray(pack.fields[0])
    real = inner[inner < n]
    assert len(real) > len(np.unique(real))


def test_importance_forces_dedup(graph):
    """IS slots address the selected union by id, so schedule() forces the
    compacted layout back on: fields stay unique under dedup=False."""
    n = graph.num_nodes
    batch = jnp.asarray(np.arange(16, dtype=np.int32))
    imp = compute_importance(graph)
    pack = schedule(jax.random.PRNGKey(1), graph, batch, [3, 3], cv=False,
                    importance=imp, dedup=False)
    for fld in pack.fields:
        real = np.asarray(fld)[np.asarray(fld) < n]
        assert len(real) == len(np.unique(real))


def test_nodedup_cv_trains_and_matches_dedup_quality(ds):
    """End-to-end CV+PP training with the append layout: converges, and
    final validation accuracy is on par with the dedup run (same
    estimator expectation, different sample stream)."""
    base = dict(dataset="synthetic", batch_size=64, degree=2, test_degree=2,
                cv=True, test_cv=True, hidden1=16, dropout=0.2, seed=1)
    tr_a = Trainer(Config(**base, field_dedup=True), ds)
    tr_b = Trainer(Config(**base, field_dedup=False), ds)
    la = lb = None
    for _ in range(12):
        la, *_ = tr_a.train_epoch()
        lb, *_ = tr_b.train_epoch()
    assert np.isfinite(lb)
    _, acc_a, *_ = tr_a.evaluate(ds.val_d)
    _, acc_b, *_ = tr_b.evaluate(ds.val_d)
    assert acc_b > 0.5
    assert acc_b > acc_a - 0.15


def test_nodedup_cv_inference_reaches_exact(ds):
    """CV->exact after L+1 eval passes holds under the append layout:
    once lower histories converge the delta term vanishes, so every
    duplicate position computes the SAME exact activation and the racing
    history writes are harmless (train.py:339-341 semantics)."""
    from tests.test_estimators import dense_forward_gcn_pp, eval_logits
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 dropout=0.0, seed=1, field_dedup=False, test_batch_size=75)
    tr = Trainer(cfg, ds)
    ids = np.arange(ds.num_data, dtype=np.int32)
    with jax.default_matmul_precision("float32"):
        for _ in range(cfg.num_layers + 1):
            preds = eval_logits(tr, ids)
    logits = dense_forward_gcn_pp(ds, tr.state.params, ds.full_adj)
    expect = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(preds, expect, atol=2e-3)


def test_effective_dedup_forcing():
    """No-dedup is forced back to dedup exactly where compaction matters:
    importance, meshes/owner blocks, or a layer with f*k > 2N (Exact mode
    would explode append-only capacities)."""
    from stochastic_gcn_tpu.sampler.scheduler import effective_dedup
    # headline regime: deg-1, huge graph -> append layout active
    assert not effective_dedup(False, 512, [1], 233_000, 64)
    # explicit dedup request wins
    assert effective_dedup(True, 512, [1], 233_000, 64)
    # importance / owner blocks force dedup
    assert effective_dedup(False, 512, [1], 233_000, 64, importance=True)
    assert effective_dedup(False, 512, [1], 233_000, 64, owner_blocks=4)
    # Exact mode (k = pad degree): f*k blows past 2N at the second layer
    assert effective_dedup(False, 512, [10000, 10000], 233_000, 64)
    # small graphs below the 2x-waste threshold stay append-only
    assert not effective_dedup(False, 16, [3, 3], 150, 8)
