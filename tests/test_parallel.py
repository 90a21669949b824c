"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the sharded
train step compiles, runs, and produces bit-consistent state vs single
device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.parallel.mesh import (make_mesh,
                                              make_sharded_train_step)
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(num_nodes=128, feature_dim=16, num_classes=4,
                           avg_degree=4, seed=0,
                           normalization="graphsage")
    cfg = Config(dataset="synthetic", batch_size=32, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 normalization="graphsage", layer_norm=True, dropout=0.2,
                 weight_decay=0.0, seed=1)
    return cfg, ds


def _run_step(cfg, ds, mesh_devices, shard_history=False):
    from stochastic_gcn_tpu.parallel.mesh import state_shardings
    tr = Trainer(cfg, ds)
    mesh = make_mesh(mesh_devices)
    step = make_sharded_train_step(cfg, tr.train_spec, tr.train_degrees,
                                   ds.num_data, mesh,
                                   state_template=tr.state,
                                   shard_history=shard_history)
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("data"))
    state = jax.device_put(tr.state,
                           state_shardings(mesh, tr.state, shard_history))
    args = [jax.device_put(x, repl) for x in
            (tr.graph_train, tr.train_features, tr.labels,
             tr.importance_train)]
    batch = jax.device_put(
        jnp.asarray(np.asarray(ds.train_d[:cfg.batch_size], np.int32)),
        shard)
    new_state, metrics = step(state, *args, batch, jax.random.PRNGKey(7))
    return new_state, metrics


def test_dryrun_multichip_entrypoint():
    import sys
    sys.path.insert(0, ".")
    import __graft_entry__ as ge
    ge.dryrun_multichip(len(jax.devices()))


def test_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    logits, loss, acc = jax.jit(fn)(*args)
    assert np.isfinite(float(loss))
    assert logits.shape[0] == args[5].shape[0]


def test_sharded_step_matches_single_device(setup):
    cfg, ds = setup
    n_dev = len(jax.devices())
    assert n_dev >= 2, "conftest should provide 8 virtual CPU devices"
    s1, m1 = _run_step(cfg, ds, 1)
    s8, m8 = _run_step(cfg, ds, n_dev)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m8["loss"]))
    np.testing.assert_allclose(float(m1["loss"]), float(m8["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s8.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # history replicas updated identically
    for a, b in zip(jax.tree_util.tree_leaves(s1.histories),
                    jax.tree_util.tree_leaves(s8.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_sharded_history_matches_replicated(setup):
    """Node-sharded history layout (each chip owns N/P rows) produces the
    same training step results as the replicated layout."""
    cfg, ds = setup
    # pin the dedup layout: the sharded arm forces it (owner-routed
    # transports), and the parity property needs both arms on one layout
    cfg = cfg.replace(field_dedup=True)
    n_dev = len(jax.devices())
    s_rep, m_rep = _run_step(cfg, ds, n_dev, shard_history=False)
    s_sh, m_sh = _run_step(cfg, ds, n_dev, shard_history=True)
    np.testing.assert_allclose(float(m_rep["loss"]), float(m_sh["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.histories),
                    jax.tree_util.tree_leaves(s_sh.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # the sharded layout actually shards: per-device shard rows < N+1
    h0 = jax.tree_util.tree_leaves(s_sh.histories)[0]
    shard_rows = [s.data.shape[0] for s in h0.addressable_shards]
    assert max(shard_rows) < h0.shape[0]


@pytest.mark.parametrize("variant", ["cvd", "det_dropout"])
def test_sharded_estimator_variants_match_replicated(setup, variant):
    """CVD's dual-stream (h, mu) gathers and det-dropout's (mu, var)
    moment gathers ride the fetch-routed activation transport when the
    history is sharded — both must reproduce the replicated layout."""
    cfg, ds = setup
    cfg = cfg.replace(field_dedup=True)   # both arms on one field layout
    cfgv = cfg.replace(cvd=True) if variant == "cvd" \
        else cfg.replace(det_dropout=True, dropout=0.2)
    n_dev = len(jax.devices())
    s_rep, m_rep = _run_step(cfgv, ds, n_dev, shard_history=False)
    s_sh, m_sh = _run_step(cfgv, ds, n_dev, shard_history=True)
    np.testing.assert_allclose(float(m_rep["loss"]), float(m_sh["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.histories),
                    jax.tree_util.tree_leaves(s_sh.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.params),
                    jax.tree_util.tree_leaves(s_sh.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_trainer_dp_mode(setup):
    """Trainer with --dp N runs sharded epoch/eval end-to-end and matches
    the learning behavior of single-device mode."""
    cfg, ds = setup
    cfg8 = cfg.replace(dp=len(jax.devices()), batch_size=32,
                       test_batch_size=64)
    tr = Trainer(cfg8, ds)
    loss0, acc0, _, _ = tr.train_epoch()
    assert np.isfinite(loss0)
    ev = tr.evaluate(ds.val_d)
    assert np.isfinite(ev[0])
    # history sharded across devices
    h0 = jax.tree_util.tree_leaves(tr.state.histories)[0]
    assert max(s.data.shape[0] for s in h0.addressable_shards) < h0.shape[0]
    # a few epochs reduce the loss
    for _ in range(5):
        loss, *_ = tr.train_epoch()
    assert loss < loss0 * 1.5


def test_sharded_multiple_steps(setup):
    cfg, ds = setup
    tr = Trainer(cfg, ds)
    mesh = make_mesh(len(jax.devices()))
    step = make_sharded_train_step(cfg, tr.train_spec, tr.train_degrees,
                                   ds.num_data, mesh)
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("data"))
    state = jax.device_put(tr.state, repl)
    args = [jax.device_put(x, repl) for x in
            (tr.graph_train, tr.train_features, tr.labels,
             tr.importance_train)]
    rng = np.random.default_rng(0)
    for i in range(4):
        ids = np.sort(rng.choice(ds.train_d, cfg.batch_size,
                                 replace=False)).astype(np.int32)
        batch = jax.device_put(jnp.asarray(ids), shard)
        state, metrics = step(state, *args, batch, jax.random.PRNGKey(i))
        assert np.isfinite(float(metrics["loss"]))


def test_halo_row_primitives():
    """Unit semantics of the owner-routed row primitives on the 8-device
    mesh: gathers match jnp.take, the scatter matches .at[].set and counts
    capacity drops."""
    from stochastic_gcn_tpu.parallel.halo import (row_gather, row_gather2,
                                                  row_scatter)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(3)
    r, d, c = 128 * n_dev, 5, 16 * n_dev
    table_f = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    table_i = jnp.asarray(rng.integers(0, 1000, size=(r, d)),
                          dtype=jnp.int32)
    ids = jnp.asarray(rng.integers(0, r, size=c), dtype=jnp.int32)

    got = jax.jit(lambda t, i: row_gather(t, i, mesh))(table_f, ids)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(jnp.take(table_f, ids, axis=0)),
                               rtol=1e-6)
    gi, gf = jax.jit(lambda a, b, i: row_gather2(a, b, i, mesh))(
        table_i, table_f, ids)
    np.testing.assert_array_equal(np.asarray(gi),
                                  np.asarray(jnp.take(table_i, ids,
                                                      axis=0)))
    np.testing.assert_allclose(np.asarray(gf),
                               np.asarray(jnp.take(table_f, ids, axis=0)),
                               rtol=1e-6)

    # scatter with unique ids and generous capacity: exact, zero drops
    uids = jnp.asarray(rng.permutation(r)[:c], dtype=jnp.int32)
    rows = jnp.asarray(rng.normal(size=(c, d)).astype(np.float32))
    out, dropped = jax.jit(
        lambda t, i, x: row_scatter(t, i, x, mesh, cap_mult=float(n_dev))
    )(table_f, uids, rows)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(table_f.at[uids].set(rows)),
                               rtol=1e-6)
    assert int(dropped) == 0

    # maximally skewed scatter (all rows owned by chip 0) with tight
    # capacity: drops are counted, surviving rows are correctly placed
    skew = jnp.asarray(rng.permutation(r // n_dev)[:c], dtype=jnp.int32)
    out2, dropped2 = jax.jit(
        lambda t, i, x: row_scatter(t, i, x, mesh, cap_mult=1.0)
    )(table_f, skew, rows)
    expect = table_f.at[skew].set(rows)
    diff_rows = np.any(np.abs(np.asarray(out2) - np.asarray(expect)) > 1e-6,
                       axis=1).sum()
    assert int(dropped2) == diff_rows  # every drop = one stale row
    assert int(dropped2) > 0  # capacity 1.0x genuinely binds under skew


def test_fetch_gather_overflow_and_dtypes():
    """The fetch-routed gather (halo.py::_fetch_or_psum_gather) must stay
    EXACT in all three regimes: fully owner-aligned requests (zero spill),
    maximally skewed requests that overflow the static spill capacity (the
    lax.cond psum fallback), and bf16 tables (native-dtype transport)."""
    from stochastic_gcn_tpu.parallel.halo import row_gather, row_gather2
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(11)
    r, d, c = 64 * n_dev, 6, 8 * n_dev
    n_loc = r // n_dev
    table = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))

    # fully owner-aligned: chip i's chunk requests only rows chip i owns
    aligned = np.concatenate([
        rng.integers(i * n_loc, (i + 1) * n_loc, size=c // n_dev)
        for i in range(n_dev)]).astype(np.int32)
    got = jax.jit(lambda t, i: row_gather(t, i, mesh))(
        table, jnp.asarray(aligned))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(table)[aligned])

    # maximal skew: every request targets chip 0's rows -> per-dest count
    # c/n_dev exceeds any sub-full capacity -> in-graph psum fallback
    skew = rng.integers(0, n_loc, size=c).astype(np.int32)
    got2 = jax.jit(lambda t, i: row_gather(t, i, mesh))(
        table, jnp.asarray(skew))
    np.testing.assert_array_equal(np.asarray(got2),
                                  np.asarray(table)[skew])

    # bf16 table rides the wire at bf16 — result bit-equal to a local take
    t16 = table.astype(jnp.bfloat16)
    mixed = rng.integers(0, r, size=c).astype(np.int32)
    got3 = jax.jit(lambda t, i: row_gather(t, i, mesh))(
        t16, jnp.asarray(mixed))
    np.testing.assert_array_equal(
        np.asarray(got3.astype(jnp.float32)),
        np.asarray(jnp.take(t16, jnp.asarray(mixed), axis=0)
                   .astype(jnp.float32)))

    # pair gather under skew (fallback) keeps int side exact
    ti = jnp.asarray(rng.integers(0, r, size=(r, d)), dtype=jnp.int32)
    gi, gf = jax.jit(lambda a, b, i: row_gather2(a, b, i, mesh))(
        ti, table, jnp.asarray(skew))
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(ti)[skew])
    np.testing.assert_allclose(np.asarray(gf), np.asarray(table)[skew],
                               rtol=1e-6)


def test_halo_spec_gather_cap_exact():
    """A HaloSpec with a tiny gather_cap_mult must stay EXACT for any
    request pattern: aligned requests fit the shrunken buffers, shuffled
    requests overflow them and take the in-graph psum fallback."""
    from stochastic_gcn_tpu.parallel.halo import HaloSpec, row_gather
    n_dev = len(jax.devices())
    spec = HaloSpec(make_mesh(n_dev), gather_cap_mult=0.25)
    rng = np.random.default_rng(3)
    r, d, c = 64 * n_dev, 5, 16 * n_dev
    n_loc = r // n_dev
    table = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    aligned = np.concatenate([
        rng.integers(i * n_loc, (i + 1) * n_loc, size=c // n_dev)
        for i in range(n_dev)]).astype(np.int32)
    shuffled = rng.integers(0, r, size=c).astype(np.int32)
    for ids in (aligned, shuffled):
        got = jax.jit(lambda t, i: row_gather(t, i, spec))(
            table, jnp.asarray(ids))
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(table)[ids])
    # and gradients flow through the capacity-bounded transport exactly
    def f(t):
        return jnp.sum(row_gather(t, jnp.asarray(shuffled), spec) ** 2)
    g = jax.jit(jax.grad(f))(table)
    g_ref = jax.grad(
        lambda t: jnp.sum(jnp.take(t, jnp.asarray(shuffled), 0) ** 2))(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-6)


def _run_step_sharded_graph(cfg, ds, mesh_devices):
    """Step with graph/features/labels node-sharded (data_template path)."""
    from stochastic_gcn_tpu.data.graph import (pad_features_rows,
                                               pad_graph_rows,
                                               pad_table_rows)
    from stochastic_gcn_tpu.parallel.mesh import (data_shardings,
                                                  state_shardings)
    tr = Trainer(cfg, ds)
    mesh = make_mesh(mesh_devices)
    graph = pad_graph_rows(tr.graph_train, mesh_devices)
    feats = pad_features_rows(tr.train_features, mesh_devices)
    labels = pad_table_rows(tr.labels, mesh_devices)
    data = (graph, feats, labels)
    step = make_sharded_train_step(cfg, tr.train_spec, tr.train_degrees,
                                   ds.num_data, mesh,
                                   state_template=tr.state,
                                   shard_history=True,
                                   data_template=data, shard_graph=True)
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("data"))
    state = jax.device_put(tr.state, state_shardings(mesh, tr.state, True))
    data = jax.device_put(data, data_shardings(mesh, data, True))
    imp = jax.device_put(tr.importance_train, repl)
    batch = jax.device_put(
        jnp.asarray(np.asarray(ds.train_d[:cfg.batch_size], np.int32)),
        shard)
    new_state, metrics = step(state, *data, imp, batch,
                              jax.random.PRNGKey(7))
    return new_state, metrics, data


def test_sharded_graph_matches_replicated(setup):
    """Node-sharding the graph rows + features + labels (owner-routed
    accesses) reproduces the replicated-data step bit-for-bit-ish, and the
    tables are genuinely distributed (per-chip rows == R/P)."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    s_rep, m_rep = _run_step(cfg, ds, n_dev, shard_history=True)
    s_sh, m_sh, data = _run_step_sharded_graph(cfg, ds, n_dev)
    np.testing.assert_allclose(float(m_rep["loss"]), float(m_sh["loss"]),
                               rtol=1e-5)
    assert int(m_sh["hist_dropped"]) == 0
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.params),
                    jax.tree_util.tree_leaves(s_sh.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    rep_hist = jax.tree_util.tree_leaves(s_rep.histories)
    sh_hist = jax.tree_util.tree_leaves(s_sh.histories)
    for a, b in zip(rep_hist, sh_hist):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # per-chip graph/feature/label rows are R/P, not R (HBM scales as N/P)
    graph, feats, labels = data
    for tab in (graph.nbr, graph.w, labels):
        rows = [s.data.shape[0] for s in tab.addressable_shards]
        assert max(rows) == tab.shape[0] // n_dev


def test_trainer_dp_shards_graph(setup):
    """Trainer --dp with shard_graph (default) distributes every O(N)
    table and still trains/evaluates end-to-end."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    cfg8 = cfg.replace(dp=n_dev, batch_size=32, test_batch_size=64)
    tr = Trainer(cfg8, ds)
    assert cfg8.shard_graph
    for tab in (tr.graph_train.nbr, tr.graph_full.nbr, tr.labels):
        rows = [s.data.shape[0] for s in tab.addressable_shards]
        assert max(rows) == tab.shape[0] // n_dev, "table not node-sharded"
    loss0, acc0, _, _ = tr.train_epoch()
    assert np.isfinite(loss0)
    ev = tr.evaluate(ds.val_d)
    assert np.isfinite(ev[0])


def test_multihost_mesh_shape_parity(setup):
    """A host-major (2, P/2)-shaped 'data' mesh (--dp_hosts 2) is
    numerically identical to the flat mesh and trains end-to-end."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    assert n_dev % 2 == 0
    from stochastic_gcn_tpu.parallel.mesh import mesh_host_shape
    mesh = make_mesh(n_dev, hosts=2)
    assert mesh_host_shape(mesh, 2) == (2, n_dev // 2)
    cfg_h = cfg.replace(dp=n_dev, dp_hosts=2, batch_size=32,
                        test_batch_size=64)
    tr = Trainer(cfg_h, ds)
    loss_h, acc_h, _, _ = tr.train_epoch()
    cfg_f = cfg.replace(dp=n_dev, batch_size=32, test_batch_size=64)
    tr_f = Trainer(cfg_f, ds)
    loss_f, acc_f, _, _ = tr_f.train_epoch()
    # single-process virtual devices: host-major order == flat order, so
    # results are bit-identical; on real multi-host hardware only the
    # device->host assignment changes, not the math
    np.testing.assert_allclose(loss_h, loss_f, rtol=1e-5)
    np.testing.assert_allclose(acc_h, acc_f, rtol=1e-5)


def test_halo_exchange_matches_gspmd(setup):
    """The explicit halo-exchange lowering of the CV full-neighborhood term
    (local contraction + psum_scatter) matches GSPMD's default lowering
    and the single-device result."""
    cfg, ds = setup
    cfg = cfg.replace(field_dedup=True)   # all arms on one field layout
    n_dev = len(jax.devices())
    s_halo, m_halo = _run_step(cfg, ds, n_dev, shard_history=True)
    s_gspmd, m_gspmd = _run_step(cfg.replace(halo_exchange=False), ds,
                                 n_dev, shard_history=True)
    s_one, m_one = _run_step(cfg, ds, 1)
    np.testing.assert_allclose(float(m_halo["loss"]),
                               float(m_gspmd["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_halo["loss"]), float(m_one["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_halo.params),
                    jax.tree_util.tree_leaves(s_gspmd.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(s_halo.histories),
                    jax.tree_util.tree_leaves(s_one.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_owner_grouped_batch_matrix():
    """Partition-aware batch assignment (cfg.owner_batching): every id
    appears exactly once per epoch, and ids land in their owner chip's
    column block whenever their owner has free slots."""
    from stochastic_gcn_tpu.parallel.mesh import (owner_grouped_batch_matrix,
                                                  shard_rows)
    n, p, bs = 1000, 8, 64
    rng = np.random.default_rng(0)
    ids = rng.permutation(n)[:600].astype(np.int32)
    bm = owner_grouped_batch_matrix(ids, bs, n, p)
    s = -(-len(ids) // bs)
    assert bm.shape == (s, bs)
    real = bm[bm < n]
    assert sorted(real.tolist()) == sorted(ids.tolist())  # exactly once
    # locality: ids in their owner's columns unless the owner overflowed
    n_loc = shard_rows(n, p) // p
    b_loc = bs // p
    blocks = bm.reshape(s, p, b_loc)
    local = spilled = 0
    for q in range(p):
        blk = blocks[:, q, :]
        blk = blk[blk < n]
        owners = np.minimum(blk // n_loc, p - 1)
        local += int((owners == q).sum())
        spilled += int((owners != q).sum())
    counts = np.bincount(np.minimum(ids // n_loc, p - 1), minlength=p)
    expected_spill = int(np.maximum(counts - s * b_loc, 0).sum())
    assert spilled == expected_spill
    assert local == len(ids) - expected_spill


def test_row_scatter_all_local_zero_drops():
    """Updates whose rows the holding chip owns bypass the all_to_all
    capacity entirely: a fully chip-local scatter never drops even at a
    capacity multiplier that would drop most rows if they rode the
    collective."""
    from stochastic_gcn_tpu.parallel.halo import row_scatter
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(5)
    r, d, c = 64 * n_dev, 4, 32 * n_dev
    n_loc, c_loc = r // n_dev, c // n_dev
    table = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    # chip q's id slice [q*c_loc:(q+1)*c_loc] targets rows chip q owns
    ids = np.concatenate([
        q * n_loc + rng.permutation(n_loc)[:c_loc] for q in range(n_dev)])
    ids = jnp.asarray(ids, dtype=jnp.int32)
    rows = jnp.asarray(rng.normal(size=(c, d)).astype(np.float32))
    out, dropped = jax.jit(
        lambda t, i, x: row_scatter(t, i, x, mesh, cap_mult=0.01)
    )(table, ids, rows)
    assert int(dropped) == 0
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(table.at[ids].set(rows)),
                               rtol=1e-6)


def test_partition_nodes_relabel_preserves_eval(setup):
    """--partition_nodes rcm is a pure relabeling: with identical params
    (same init key, shape-only dependence) the exact-mode forward metrics
    match the unrelabeled run."""
    cfg, ds = setup
    exact = cfg.replace(degree=128, test_degree=128, cv=False,
                        test_cv=False, dropout=0.0)
    t0 = Trainer(exact, ds)
    t1 = Trainer(exact.replace(partition_nodes="rcm"), ds)
    l0, a0, mi0, ma0, _ = t0.evaluate(ds.val_d)
    # the public id surface speaks ORIGINAL ids regardless of the internal
    # relabeling (regression: external callers used to silently evaluate
    # the wrong nodes under --partition_nodes)
    l1, a1, mi1, ma1, _ = t1.evaluate(ds.val_d)
    assert a0 == pytest.approx(a1, abs=1e-6)
    assert l0 == pytest.approx(l1, rel=1e-5)
    assert mi0 == pytest.approx(mi1, abs=1e-6)
    # trainer-internal splits are original-space too (callers may mix)
    l2, a2, *_ = t1.evaluate(t1.ds.val_d)
    assert a2 == pytest.approx(a0, abs=1e-6)
    # partial batch + owner batching + rcm: the combination that broke
    val19 = ds.val_d[:19]
    l3, a3, mi3, _, _ = t0.evaluate(val19)
    t2 = Trainer(exact.replace(partition_nodes="rcm", dp=8,
                               owner_batching=True, test_batch_size=32),
                 ds)
    l4, a4, mi4, _, _ = t2.evaluate(val19)
    assert a4 == pytest.approx(a3, abs=1e-6)
    assert l4 == pytest.approx(l3, rel=1e-4)


def test_importance_dp_and_row_table_parity(setup):
    """IS (--importance) trajectories are identical across dp=1, dp=8
    (sharded tables, halo gathers over the [N+1, Dcap] row table) and the
    --is_row_table hoist."""
    _, ds = setup
    res = {}
    for name, kw in (("dp1", dict()), ("dp8", dict(dp=8)),
                     ("dp8_rt", dict(dp=8, is_row_table=True))):
        cfg = Config(dataset="synthetic", batch_size=32, degree=2,
                     test_degree=2, importance=True, test_importance=True,
                     hidden1=16, normalization="graphsage", layer_norm=True,
                     dropout=0.0, weight_decay=0.0, seed=1, **kw)
        tr = Trainer(cfg, ds)
        res[name] = [tr.train_epoch()[0] for _ in range(2)]
    np.testing.assert_allclose(res["dp1"], res["dp8"], rtol=1e-4)
    np.testing.assert_allclose(res["dp1"], res["dp8_rt"], rtol=1e-4)


def test_trainer_owner_batching_end_to_end(setup):
    """dp=8 + owner_batching + partition_nodes trains and evaluates; the
    epoch matrix covers every train id exactly once."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    cfg = cfg.replace(dp=n_dev, owner_batching=True, partition_nodes="rcm",
                      batch_size=32, test_batch_size=32)
    tr = Trainer(cfg, ds)
    bm = tr._epoch_matrix(tr.train_iter.data, cfg.batch_size)
    real = bm[bm < ds.num_data]
    assert sorted(real.tolist()) == sorted(tr.train_iter.data.tolist())
    loss, acc, _, _ = tr.train_epoch()
    assert np.isfinite(loss)
    vloss, vacc, _, _, _ = tr.evaluate(tr.ds.val_d)
    assert np.isfinite(vloss) and 0.0 <= vacc <= 1.0


def test_tensor_parallel_matches_dp_only(setup):
    """--tp shards dense weights/norm params/history columns over a 2-D
    ('data','model') mesh; pure layout change — the (dp=4, tp=2) trainer
    reproduces the (dp=4) trainer's trajectory to float tolerance, and the
    weights are genuinely column-sharded."""
    cfg, ds = setup
    cfg = cfg.replace(batch_size=32, test_batch_size=32, dp=4)
    t_dp = Trainer(cfg, ds)
    t_tp = Trainer(cfg.replace(tp=2), ds)
    assert dict(t_tp.mesh.shape) == {"data": 4, "model": 2}
    # hidden-dim params really sharded over 'model'
    sharded = [
        k for k, v in t_tp.state.params.items()
        if any(getattr(a, "sharding", None) is not None
               and "model" in (a.sharding.spec or ())
               for a in v.values() if hasattr(a, "sharding"))]
    for epoch in range(2):
        l_dp, a_dp, _, _ = t_dp.train_epoch()
        l_tp, a_tp, _, _ = t_tp.train_epoch()
        assert l_tp == pytest.approx(l_dp, rel=2e-3), (epoch, l_dp, l_tp)
    v_dp = t_dp.evaluate(ds.val_d)
    v_tp = t_tp.evaluate(ds.val_d)
    assert v_tp[0] == pytest.approx(v_dp[0], rel=2e-3)
    assert v_tp[1] == pytest.approx(v_dp[1], abs=0.05)


def test_trainer_dp_edgelist_sharded_matches_padded(setup):
    """Node-sharded FlatGraph (block tables built with parts=P, window
    block reads owner-routed): per-chip tiles are NB/P rows, and the dp=8
    edgelist trajectory matches the dp=8 PADDED run (the single-device
    edgelist == padded identity is tests/test_edgelist.py; dp-vs-single
    differences are a dp-level property shared by both layouts)."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    base = cfg.replace(batch_size=32, test_batch_size=64, dp=n_dev)
    tr_p = Trainer(base, ds)
    tr_e = Trainer(base.replace(graph_format="edgelist",
                                fadj_edge_mult=1e9), ds)
    assert tr_e.graph_train.parts == n_dev
    for tab in (tr_e.graph_train.idx, tr_e.graph_train.w,
                tr_e.graph_full.idx):
        rows = [s.data.shape[0] for s in tab.addressable_shards]
        assert max(rows) == tab.shape[0] // n_dev, "block table not sharded"
    for _ in range(2):
        lp, ap, *_ = tr_p.train_epoch()
        le, ae, *_ = tr_e.train_epoch()
    np.testing.assert_allclose(lp, le, rtol=1e-5)
    ev_p = tr_p.evaluate(ds.val_d)
    ev_e = tr_e.evaluate(ds.val_d)
    np.testing.assert_allclose(ev_p[0], ev_e[0], rtol=1e-4)
    np.testing.assert_allclose(ev_p[2], ev_e[2], rtol=1e-4)


def test_flat_csr_parts_layout_equivalence():
    """parts>1 re-lays blocks out per chip but windows recover identical
    rows to the parts=1 build."""
    from stochastic_gcn_tpu.data import graph as G
    ds = synthetic_dataset(num_nodes=70, feature_dim=8, num_classes=3,
                           avg_degree=5, seed=2)
    f1 = G.flat_csr(ds.full_adj, edge_mult=1e9)
    f8 = G.flat_csr(ds.full_adj, edge_mult=1e9, parts=8)
    assert np.asarray(f8.idx).shape[0] % 8 == 0
    field = jnp.asarray(np.r_[np.arange(70), [70, 70]].astype(np.int32))
    for width in (3, 8, 11):
        a = G.flat_row_windows(f1, field, width)
        b = G.flat_row_windows(f8, field, width)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_trainer_dp_edgelist_importance_matches_padded(setup):
    """IS scheduler over a parts-sharded FlatGraph (union membership +
    inv-weight lookups against sharded block windows) matches the dp=8
    padded IS run."""
    cfg, ds = setup
    n_dev = len(jax.devices())
    base = cfg.replace(batch_size=32, test_batch_size=64, dp=n_dev,
                       cv=False, test_cv=False, importance=True, degree=2,
                       test_degree=2, dropout=0.0)
    tr_p = Trainer(base, ds)
    tr_e = Trainer(base.replace(graph_format="edgelist",
                                fadj_edge_mult=1e9), ds)
    assert tr_e.graph_train.parts == n_dev
    for _ in range(2):
        lp, *_ = tr_p.train_epoch()
        le, *_ = tr_e.train_epoch()
    np.testing.assert_allclose(lp, le, rtol=1e-5)
    np.testing.assert_allclose(tr_p.evaluate(ds.val_d)[0],
                               tr_e.evaluate(ds.val_d)[0], rtol=1e-4)


def test_sharded_nodedup_matches_replicated(setup):
    """A plain mesh no longer forces field
    dedup — the no-dedup (append-only) layout rides the owner-routed
    transports, with duplicate rows racing to the documented last-write
    scatter semantics.  Same-key sharded vs replicated steps must agree
    (duplicate sets are identical, so even the races resolve to the same
    values: every duplicate writes the same iid sample per position)."""
    from stochastic_gcn_tpu.sampler.scheduler import effective_dedup
    cfg, ds = setup
    cfg = cfg.replace(field_dedup=False)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    # the lifted restriction: a plain mesh keeps no-dedup active
    assert not effective_dedup(False, cfg.batch_size, [1], ds.num_data,
                               8, mesh=mesh)
    s_rep, m_rep = _run_step(cfg, ds, n_dev, shard_history=False)
    s_sh, m_sh = _run_step(cfg, ds, n_dev, shard_history=True)
    np.testing.assert_allclose(float(m_rep["loss"]), float(m_sh["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.histories),
                    jax.tree_util.tree_leaves(s_sh.histories)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(s_rep.params),
                    jax.tree_util.tree_leaves(s_sh.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # history actually sharded
    h0 = jax.tree_util.tree_leaves(s_sh.histories)[0]
    assert max(s.data.shape[0] for s in h0.addressable_shards) < h0.shape[0]


def test_trainer_dp_nodedup_trains(setup):
    """Trainer --dp N at the default (no-dedup) field layout trains
    end-to-end with finite metrics and a learning trajectory."""
    cfg, ds = setup
    cfg8 = cfg.replace(dp=len(jax.devices()), batch_size=32,
                       test_batch_size=64, field_dedup=False)
    tr = Trainer(cfg8, ds)
    loss0, *_ = tr.train_epoch()
    assert np.isfinite(loss0)
    for _ in range(5):
        loss, *_ = tr.train_epoch()
    assert np.isfinite(loss) and loss < loss0 * 1.5
    ev = tr.evaluate(ds.val_d)
    assert np.isfinite(ev[0])


def test_sentinel_rows_bypass_transport_capacity():
    """Sentinel-padded ids (id == N) must not be routed to the chip that
    owns row N: without the sentinel bypass every chip's padding slots
    all target ONE destination, blow its static per-destination capacity,
    and evict REAL history updates into the dropped count (scatter) or
    force the psum fallback (gather).  With sentinel= passed, a
    sentinel-heavy batch scatters with zero drops and gathers real rows
    exactly (sentinel positions come back zero — their true sharded-path
    value, since sentinel writes are skipped)."""
    from stochastic_gcn_tpu.parallel.halo import row_gather, row_scatter
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(7)
    n = 64 * n_dev - 1                      # real nodes; row N = sentinel
    r, d = n + 1, 4
    c = 32 * n_dev
    c_loc = c // n_dev
    table = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))

    # every chip: 75% sentinel ids, 25% rows it owns itself
    n_loc = r // n_dev
    ids = np.concatenate([
        np.concatenate([q * n_loc + rng.permutation(n_loc)[:c_loc // 4],
                        np.full(c_loc - c_loc // 4, n, np.int64)])
        for q in range(n_dev)])
    ids = jnp.asarray(ids, dtype=jnp.int32)
    rows = jnp.asarray(rng.normal(size=(c, d)).astype(np.float32))

    # scatter: tiny capacity would drop the sentinel flood if routed
    out, dropped = jax.jit(
        lambda t, i, x: row_scatter(t, i, x, mesh, cap_mult=0.01,
                                    sentinel=n))(table, ids, rows)
    assert int(dropped) == 0
    real = np.asarray(ids) < n
    np.testing.assert_allclose(
        np.asarray(out)[np.asarray(ids)[real]],
        np.asarray(rows)[real], rtol=1e-6)
    # row N untouched (sentinel writes skipped on the sharded path)
    np.testing.assert_allclose(np.asarray(out)[n], np.asarray(table)[n],
                               rtol=1e-6)

    # gather: real rows exact, sentinel rows zero, no capacity pressure
    got = jax.jit(
        lambda t, i: row_gather(t, i, mesh, sentinel=n))(table, ids)
    np.testing.assert_allclose(np.asarray(got)[real],
                               np.asarray(table)[np.asarray(ids)[real]],
                               rtol=1e-6)
    assert np.abs(np.asarray(got)[~real]).max() == 0.0


def test_sentinel_gather_exact_under_psum_fallback():
    """When REAL skewed requests overflow the fetch capacity, the psum
    fallback must also serve sentinel ids as zero rows (they are excluded
    from every chip's contribution) while keeping real rows exact."""
    from stochastic_gcn_tpu.parallel.halo import row_gather
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(11)
    n = 32 * n_dev - 1
    r, d = n + 1, 4
    c = 64 * n_dev
    c_loc = c // n_dev
    table = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    # every chip asks mostly for chip 0's rows (guaranteed remote skew ->
    # capacity overflow -> psum fallback), plus some sentinels
    n_loc = r // n_dev
    ids = np.concatenate([
        np.concatenate([rng.integers(0, n_loc, c_loc - 8),
                        np.full(8, n, np.int64)])
        for _ in range(n_dev)])
    ids = jnp.asarray(ids, dtype=jnp.int32)
    got = jax.jit(lambda t, i: row_gather(t, i, mesh, sentinel=n))(table,
                                                                   ids)
    real = np.asarray(ids) < n
    np.testing.assert_allclose(np.asarray(got)[real],
                               np.asarray(table)[np.asarray(ids)[real]],
                               rtol=1e-6)
    assert np.abs(np.asarray(got)[~real]).max() == 0.0


def test_sharded_pred_and_grad_exact_parity(setup):
    """The gradvar instrument's sharded lowering: with
    exact eval (covering degree) and dropout off, predictions AND the
    first-layer gradient from the dp8 sharded pred_and_grad equal the
    single-device ones — the sampled layout may differ, but the exact
    forward/backward cannot."""
    from stochastic_gcn_tpu.training import step as S

    cfg, ds = setup
    base = cfg.replace(dropout=0.0, degree=10000, test_degree=10000,
                       cv=False, test_cv=False, gradvar=True)
    tr1 = Trainer(base, ds)
    tr8 = Trainer(base.replace(dp=8, owner_batching=True,
                               partition_nodes="rcm"), ds)
    n = ds.num_data
    key = jax.random.PRNGKey(3)
    ids = np.asarray(ds.train_d[:cfg.batch_size], np.int32)

    fn1 = S.make_pred_and_grad(base, tr1.test_spec, tr1.test_degrees, n,
                               False)
    p1, g1 = fn1(tr1.state.params, tr1.eval_histories, tr1.graph_full,
                 tr1.test_features, tr1.labels, tr1.importance_test,
                 jnp.asarray(tr1._to_internal(ids)), key)

    from stochastic_gcn_tpu.parallel.mesh import (
        make_sharded_pred_and_grad, owner_grouped_batch_matrix)
    eval_data = (tr8.graph_full, tr8.test_features, tr8.labels)
    fn8 = make_sharded_pred_and_grad(
        tr8.cfg, tr8.test_spec, tr8.test_degrees, n, tr8.mesh,
        train_mode=False, hist_template=tr8.eval_histories,
        shard_history=True, data_template=eval_data,
        shard_graph=tr8.cfg.shard_graph,
        params_template=tr8.state.params)
    batch8 = owner_grouped_batch_matrix(
        np.asarray(tr8._to_internal(ids), np.int32), cfg.batch_size, n,
        8)[0]
    p8, g8 = fn8(tr8.state.params, tr8.eval_histories, tr8.graph_full,
                 tr8.test_features, tr8.labels, tr8.importance_test,
                 jnp.asarray(batch8), key)

    # same init seed -> same params; exact forward -> batch-order
    # invariant per-node predictions.  Align dp8's owner-grouped slots
    # back to tr1's order via the batch fields (sentinels dropped).
    p1, p8 = np.asarray(p1), np.asarray(p8)
    id8 = batch8[batch8 < n]
    rows8 = {int(v): p8[np.flatnonzero(batch8 == v)[0]] for v in id8}
    ids8_of_1 = np.asarray(tr8._to_internal(ids))
    for r1, i8 in zip(p1, ids8_of_1):
        np.testing.assert_allclose(r1, rows8[int(i8)], atol=2e-4)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g8), atol=2e-3)


def test_gradient_variance_through_dp8(setup):
    """Trainer.gradient_variance dispatches through the sharded lowering
    under --dp and returns finite statistics."""
    import math

    cfg, ds = setup
    tr = Trainer(cfg.replace(dp=8, owner_batching=True,
                             partition_nodes="rcm", gradvar=True), ds)
    r = tr.gradient_variance(times=8, log=lambda *a, **k: None)
    assert all(math.isfinite(float(v)) for v in r.values()), r
