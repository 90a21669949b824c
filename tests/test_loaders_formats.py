"""Loader tests against synthesized on-disk fixtures in the reference's
three dataset formats (Planetoid pickles, GraphSAGE JSON, YouTube CSV)."""

import json
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import (load_gcn_data,
                                             load_graphsage_data,
                                             load_youtube_data)


def write_planetoid_fixture(d, name="cora", n_train=5, n_rest=520,
                            n_test=8, dim=12, ncls=3, seed=0,
                            isolated=0):
    """Minimal ind.* files.  allx covers train+rest, tx the test nodes;
    test.index is shuffled to exercise the reorder logic.  ``isolated``
    drops that many ids from test.index (and rows from tx/ty) while the
    graph still spans the full range — the citeseer isolated-node case."""
    rng = np.random.default_rng(seed)
    n_allx = n_train + n_rest
    n = n_allx + n_test

    def feats(k):
        return sp.csr_matrix(rng.random((k, dim)).astype(np.float32)
                             * (rng.random((k, dim)) < 0.3))

    def labels(k):
        y = np.zeros((k, ncls), np.float32)
        y[np.arange(k), rng.integers(0, ncls, k)] = 1
        return y

    allx = feats(n_allx)
    x = allx[:n_train]
    ally = labels(n_allx)
    y = ally[:n_train]
    graph = {i: [] for i in range(n)}
    for _ in range(3 * n):
        a, b = rng.integers(0, n, 2)
        if a != b:
            graph[int(a)].append(int(b))
            graph[int(b)].append(int(a))
    test_idx = list(range(n_allx, n))
    if isolated:
        # keep the extremes so the contiguous range is preserved; drop
        # interior ids (their tx/ty rows are absent too)
        drop = set(test_idx[1:1 + isolated])
        test_idx = [t for t in test_idx if t not in drop]
    tx = feats(len(test_idx))
    ty = labels(len(test_idx))
    rng.shuffle(test_idx)

    for nm, obj in [("x", x), ("y", y), ("tx", tx), ("ty", ty),
                    ("allx", allx), ("ally", ally), ("graph", graph)]:
        with open(os.path.join(d, f"ind.{name}.{nm}"), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    with open(os.path.join(d, f"ind.{name}.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in test_idx) + "\n")
    return n, dim, ncls


def test_planetoid_loader(tmp_path):
    d = str(tmp_path)
    n, dim, ncls = write_planetoid_fixture(d)
    cfg = Config(dataset="cora", data_dir=d)
    ds = load_gcn_data("cora", cfg)
    assert ds.num_data == n
    assert ds.feats.shape == (n, dim)
    assert ds.labels.shape == (n, ncls)
    # citation format: train graph == full graph (utils.py:151)
    assert (ds.train_adj != ds.full_adj).nnz == 0
    # gcn normalization is symmetric with self loops
    a = ds.full_adj.toarray()
    np.testing.assert_allclose(a, a.T, atol=1e-6)
    assert (np.diag(a) > 0).all()
    # splits: train prefix, 500-wide val, shuffled-test reordered
    assert len(ds.train_d) == 5 and len(ds.val_d) == 500
    assert len(ds.test_d) == 8
    # PP features = Â·X
    np.testing.assert_allclose(
        np.asarray(ds.train_feats.todense()),
        np.asarray(ds.train_adj.dot(ds.feats).todense()), rtol=1e-5)
    # cache round trip
    ds2 = load_gcn_data("cora", cfg)
    np.testing.assert_allclose(np.asarray(ds2.feats.todense()),
                               np.asarray(ds.feats.todense()))


def test_planetoid_citeseer_isolated_nodes(tmp_path):
    """citeseer branch (gcn/utils.py:67-76): ids missing from test.index get
    zero feature/label rows inserted at the right positions."""
    d = str(tmp_path)
    n, dim, ncls = write_planetoid_fixture(d, name="citeseer", isolated=3)
    cfg = Config(dataset="citeseer", data_dir=d)
    ds = load_gcn_data("citeseer", cfg)
    assert ds.num_data == n
    # the three dropped ids (right after the first test id) have zero labels
    first_test = n - 8
    missing = [first_test + 1, first_test + 2, first_test + 3]
    assert np.all(ds.labels[missing] == 0)
    # present test ids keep nonzero labels
    assert ds.labels[first_test].sum() == 1
    assert len(ds.test_d) == 5


def test_planetoid_trains_end_to_end(tmp_path):
    d = str(tmp_path)
    write_planetoid_fixture(d)
    cfg = Config(dataset="cora", data_dir=d, batch_size=64, degree=2,
                 test_degree=2, hidden1=8, epochs=1)
    ds = load_gcn_data("cora", cfg)
    from stochastic_gcn_tpu.training.loop import Trainer
    tr = Trainer(cfg, ds)   # sparse features -> PaddedSparseFeatures path
    loss, acc, _, _ = tr.train_epoch()
    assert np.isfinite(loss)
    ev = tr.evaluate(ds.val_d[:100])
    assert np.isfinite(ev[0])


def write_graphsage_fixture(d, prefix="toy", n=40, dim=6, ncls=4,
                            multilabel=False, seed=0):
    rng = np.random.default_rng(seed)
    ids = [f"n{i}" for i in range(n)]
    val = rng.random(n) < 0.2
    test = (~val) & (rng.random(n) < 0.2)
    nodes = [dict(id=ids[i], val=bool(val[i]), test=bool(test[i]))
             for i in range(n)]
    links = []
    for _ in range(n * 3):
        a, b = rng.integers(0, n, 2)
        if a != b:
            links.append(dict(source=int(a), target=int(b)))
    G = dict(directed=False, multigraph=False, graph={}, nodes=nodes,
             links=links)
    id_map = {ids[i]: i for i in range(n)}
    if multilabel:
        class_map = {ids[i]: rng.integers(0, 2, ncls).tolist()
                     for i in range(n)}
    else:
        class_map = {ids[i]: int(rng.integers(0, ncls)) for i in range(n)}
    feats = rng.normal(size=(n, dim)).astype(np.float32)

    p = os.path.join(d, prefix)
    json.dump(G, open(p + "-G.json", "w"))
    json.dump(id_map, open(p + "-id_map.json", "w"))
    json.dump(class_map, open(p + "-class_map.json", "w"))
    np.save(p + "-feats.npy", feats)
    return p, n, dim, ncls, val, test


def test_graphsage_loader(tmp_path):
    d = str(tmp_path)
    p, n, dim, ncls, val, test = write_graphsage_fixture(d)
    cfg = Config(dataset="toy", normalization="graphsage", data_dir=d)
    ds = load_graphsage_data(p, cfg)
    assert ds.num_data == n
    assert ds.labels.shape == (n, ncls)
    assert set(ds.val_d) == set(np.nonzero(val)[0])
    assert set(ds.test_d) == set(np.nonzero(test)[0])
    # train adjacency only contains train-train edges
    tr_set = set(ds.train_d.tolist())
    coo = ds.train_adj.tocoo()
    assert all(r in tr_set and c in tr_set
               for r, c in zip(coo.row, coo.col))
    # graphsage row normalization
    rowsum = np.asarray(ds.full_adj.sum(1)).flatten()
    nz = rowsum > 0
    np.testing.assert_allclose(rowsum[nz], 1.0, rtol=1e-5)
    # features standardized over train nodes
    mu = ds.feats[ds.train_d].mean(0)
    np.testing.assert_allclose(mu, 0.0, atol=1e-5)


def test_graphsage_multilabel(tmp_path):
    d = str(tmp_path)
    p, n, dim, ncls, *_ = write_graphsage_fixture(d, multilabel=True)
    cfg = Config(dataset="toy", normalization="graphsage", data_dir=d)
    ds = load_graphsage_data(p, cfg)
    assert ds.labels.shape == (n, ncls)
    assert ds.labels.max() <= 1


def test_graphsage_max_degree(tmp_path):
    d = str(tmp_path)
    p, n, *_ = write_graphsage_fixture(d, n=30)
    cfg = Config(dataset="toy", normalization="graphsage", data_dir=d,
                 max_degree=3)
    ds = load_graphsage_data(p, cfg)
    deg = np.diff(ds.full_adj.indptr)
    assert deg.max() <= 2 * 3  # symmetrization can double capped counts


def test_youtube_loader(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "yt"))
    rng = np.random.default_rng(0)
    n = 30
    edges = [(int(a) + 1, int(b) + 1)
             for a, b in rng.integers(0, n, (120, 2)) if a != b]
    with open(os.path.join(d, "yt", "edges.csv"), "w") as f:
        f.writelines(f"{a},{b}\n" for a, b in edges)
    with open(os.path.join(d, "yt", "group-edges.csv"), "w") as f:
        for i in range(1, n + 1):
            f.writelines(f"{i},{int(rng.integers(1, 48))}\n")
    cfg = Config(dataset="youtube", data_dir=d)
    ds = load_youtube_data("yt", 0.8, cfg)
    # data_augmentation doubles the graph block-diagonally
    assert ds.num_data == 2 * n
    assert ds.labels.shape == (2 * n, 47)
    assert (ds.val_d >= n).all() and (ds.train_d < n).all()


def write_nell_fixture(d, n=1000, n_train=6, n_test=20, dim=8, ncls=4,
                       seed=0):
    """NELL-branch fixture (gcn/utils.py:99-115): features come from allx
    ALONE (no tx appended), test.index is an UNSORTED raw id list consumed
    as-is, and the val split is the hardcoded 969-wide range after train."""
    rng = np.random.default_rng(seed)
    allx = sp.csr_matrix(rng.random((n, dim)).astype(np.float32)
                         * (rng.random((n, dim)) < 0.3))
    ally = np.zeros((n, ncls), np.float32)
    ally[np.arange(n), rng.integers(0, ncls, n)] = 1
    x, y = allx[:n_train], ally[:n_train]
    # tx/ty are pickled but unused by the nell branch
    tx, ty = allx[:2], ally[:2]
    graph = {i: [] for i in range(n)}
    for _ in range(3 * n):
        a, b = rng.integers(0, n, 2)
        if a != b:
            graph[int(a)].append(int(b))
            graph[int(b)].append(int(a))
    test_idx = rng.choice(np.arange(n_train + 969, n), size=n_test,
                          replace=False).tolist()   # deliberately unsorted

    for nm, obj in [("x", x), ("y", y), ("tx", tx), ("ty", ty),
                    ("allx", allx), ("ally", ally), ("graph", graph)]:
        with open(os.path.join(d, f"ind.nell.{nm}"), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    with open(os.path.join(d, "ind.nell.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in test_idx) + "\n")
    return n, dim, ncls, n_train, test_idx


def test_nell_loader(tmp_path):
    d = str(tmp_path)
    n, dim, ncls, n_train, test_idx = write_nell_fixture(d)
    cfg = Config(dataset="nell", data_dir=d)
    ds = load_gcn_data("nell", cfg)
    assert ds.num_data == n
    assert ds.feats.shape == (n, dim)
    # splits: train prefix, 969-wide val (gcn/utils.py:108), raw test.index
    np.testing.assert_array_equal(ds.train_d, np.arange(n_train))
    np.testing.assert_array_equal(ds.val_d,
                                  np.arange(n_train, n_train + 969))
    np.testing.assert_array_equal(ds.test_d, np.asarray(test_idx))
    # citation format: train graph == full graph
    assert (ds.train_adj != ds.full_adj).nnz == 0
    # labels zeroed outside the three splits
    in_split = np.zeros(n, bool)
    in_split[ds.train_d] = in_split[ds.val_d] = True
    in_split[ds.test_d] = True
    assert ds.labels[~in_split].sum() == 0
    assert ds.labels[ds.test_d].sum() == len(test_idx)
    # cache round trip preserves the unsorted test split
    ds2 = load_gcn_data("nell", cfg)
    np.testing.assert_array_equal(ds2.test_d, ds.test_d)


def _rand_csr(rng, shape, density=0.3):
    return sp.csr_matrix(rng.random(shape).astype(np.float32)
                         * (rng.random(shape) < density))


def test_reference_npz_cache_planetoid(tmp_path):
    """Ingest an npz written in the reference's exact Planetoid cache schema
    (gcn/utils.py:172-181): all-sparse CSR triplets, no sparse_feats flag."""
    d = str(tmp_path)
    rng = np.random.default_rng(3)
    n, dim, ncls = 25, 6, 3
    adj = _rand_csr(rng, (n, n))
    feats = _rand_csr(rng, (n, dim))
    train_feats = adj.dot(feats)
    labels = np.zeros((n, ncls), np.float32)
    labels[np.arange(n), rng.integers(0, ncls, n)] = 1
    keys = dict(num_data=n, labels=labels,
                train_data=np.arange(5, dtype=np.int32),
                val_data=np.arange(5, 15, dtype=np.int32),
                test_data=np.arange(15, 25, dtype=np.int32))
    for nm, m in [("train_adj", adj), ("full_adj", adj), ("feats", feats),
                  ("train_feats", train_feats), ("test_feats", train_feats)]:
        keys.update({f"{nm}_data": m.data, f"{nm}_indices": m.indices,
                     f"{nm}_indptr": m.indptr,
                     f"{nm}_shape": np.asarray(m.shape)})
    with open(os.path.join(d, "cora_gcn.npz"), "wb") as f:
        np.savez(f, **keys)

    ds = load_gcn_data("cora", Config(dataset="cora", data_dir=d))
    assert ds.num_data == n
    assert sp.issparse(ds.feats)    # schema sniff chose the sparse path
    np.testing.assert_allclose(ds.feats.toarray(), feats.toarray())
    np.testing.assert_allclose(ds.train_adj.toarray(), adj.toarray())
    np.testing.assert_array_equal(ds.val_d, keys["val_data"])


def test_reference_npz_cache_graphsage(tmp_path):
    """Ingest an npz in the reference's GraphSAGE cache schema
    (gcn/utils.py:325-333): sparse adjacencies, DENSE feats, no flag."""
    d = str(tmp_path)
    rng = np.random.default_rng(4)
    n, dim, ncls = 30, 5, 4
    adj = _rand_csr(rng, (n, n))
    feats = rng.normal(size=(n, dim)).astype(np.float32)
    train_feats = adj.dot(feats)
    labels = (rng.random((n, ncls)) < 0.4).astype(np.float32)
    keys = dict(num_data=n, feats=feats, train_feats=train_feats,
                test_feats=train_feats, labels=labels,
                train_data=np.arange(20, dtype=np.int32),
                val_data=np.arange(20, 25, dtype=np.int32),
                test_data=np.arange(25, 30, dtype=np.int32))
    for nm, m in [("train_adj", adj), ("full_adj", adj)]:
        keys.update({f"{nm}_data": m.data, f"{nm}_indices": m.indices,
                     f"{nm}_indptr": m.indptr,
                     f"{nm}_shape": np.asarray(m.shape)})
    prefix = os.path.join(d, "reddit")
    with open(prefix + ".npz", "wb") as f:
        np.savez(f, **keys)

    cfg = Config(dataset="reddit", normalization="graphsage", data_dir=d)
    ds = load_graphsage_data(prefix, cfg)
    assert ds.num_data == n
    assert not sp.issparse(ds.feats)
    np.testing.assert_allclose(ds.feats, feats)
    np.testing.assert_allclose(ds.full_adj.toarray(), adj.toarray())
    np.testing.assert_array_equal(ds.test_d, keys["test_data"])


def test_nell_trains_end_to_end(tmp_path):
    """The NELL branch feeds the Trainer (sparse-feature path) cleanly."""
    d = str(tmp_path)
    write_nell_fixture(d, n=1000, dim=6, ncls=3)
    cfg = Config(dataset="nell", data_dir=d, batch_size=64, degree=2,
                 test_degree=2, hidden1=8, epochs=1)
    ds = load_gcn_data("nell", cfg)
    from stochastic_gcn_tpu.training.loop import Trainer
    tr = Trainer(cfg, ds)
    loss, *_ = tr.train_epoch()
    assert np.isfinite(loss)


def test_mlp_baseline(tmp_path):
    """NeighbourMLP (reference gcn/mlp.py, repaired) trains."""
    from stochastic_gcn_tpu.data.loaders import synthetic_dataset
    from stochastic_gcn_tpu.models.mlp import MLPTrainer, multihop_features
    ds = synthetic_dataset(num_nodes=120, feature_dim=10, num_classes=3,
                           avg_degree=5, seed=0)
    cfg = Config(dataset="synthetic", model="mlp", batch_size=32,
                 num_layers=2, num_fc_layers=2, hidden1=16, epochs=2)
    mh = multihop_features(ds.feats, ds.full_adj, 2)
    assert mh.shape == (120, 30)
    tr = MLPTrainer(cfg, ds)
    accs = []
    for _ in range(10):
        tr.train_epoch()
        accs.append(tr.evaluate(ds.val_d)[1])
    assert max(accs) > 0.4  # learns above chance (1/3)


@pytest.mark.parametrize("constant_col", [False, True])
def test_standardize_matches_sklearn_standard_scaler(constant_col):
    """preprocess.standardize reproduces scikit-learn's StandardScaler
    fit on the training rows (the reference's GraphSAGE normalisation),
    including a column that is constant over those rows."""
    preprocessing = pytest.importorskip("sklearn.preprocessing")
    from stochastic_gcn_tpu.data.preprocess import standardize
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(60, 7)) * rng.random(7) * 5 + 2).astype(
        np.float32)
    rows = np.sort(rng.choice(60, 40, replace=False))
    if constant_col:
        x[rows, 2] = 3.25
    ref = preprocessing.StandardScaler().fit(x[rows]).transform(x)
    got = standardize(x, rows)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
