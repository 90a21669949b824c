"""Dataset loaders.

Reproduces the three reference data formats with identical preprocessing and
npz caching, plus synthetic generators used for tests and benchmarks when the
original datasets are not on disk:

* Planetoid/GCN pickles (cora/citeseer/pubmed/nell) — gcn/utils.py:33-183
* GraphSAGE JSON (ppi/reddit)                       — gcn/utils.py:186-335
* YouTube CSV                                       — gcn/utils.py:338-413

Differences from the reference (documented, deliberate):
* The GraphSAGE JSON loader parses the node-link JSON directly instead of via
  networkx 1.11 (removed dependency); the resulting arrays are identical.
* ``load_data`` takes an explicit :class:`~stochastic_gcn_tpu.config.Config`
  instead of reading global flags.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..config import Config
from .graph import Dataset
from .preprocess import (adj_from_edges, compute_pp_features,
                         data_augmentation, graphsage_normalize_adj,
                         normalize_adj, row_normalize_features,
                         standardize, subsample_edges)

GCN_DATASETS = {"cora", "citeseer", "pubmed", "nell"}


# --------------------------------------------------------------------------
# npz cache helpers (gcn/utils.py:34-49, 172-181)
# --------------------------------------------------------------------------

def _save_csr(d: dict, name: str, m: sp.csr_matrix) -> None:
    d[f"{name}_data"] = m.data
    d[f"{name}_indices"] = m.indices
    d[f"{name}_indptr"] = m.indptr
    d[f"{name}_shape"] = np.asarray(m.shape)


def _load_csr(z, name: str) -> sp.csr_matrix:
    return sp.csr_matrix(
        (z[f"{name}_data"], z[f"{name}_indices"], z[f"{name}_indptr"]),
        shape=z[f"{name}_shape"])


def _cache_dataset(npz_file: str, ds: Dataset, sparse_feats: bool) -> None:
    os.makedirs(os.path.dirname(npz_file) or ".", exist_ok=True)
    d = dict(num_data=ds.num_data, labels=ds.labels, train_data=ds.train_d,
             val_data=ds.val_d, test_data=ds.test_d,
             sparse_feats=np.asarray(sparse_feats))
    _save_csr(d, "train_adj", ds.train_adj.tocsr())
    _save_csr(d, "full_adj", ds.full_adj.tocsr())
    if sparse_feats:
        _save_csr(d, "feats", ds.feats.tocsr())
        _save_csr(d, "train_feats", ds.train_feats.tocsr())
        _save_csr(d, "test_feats", ds.test_feats.tocsr())
    else:
        d["feats"] = np.asarray(ds.feats)
        d["train_feats"] = np.asarray(ds.train_feats)
        d["test_feats"] = np.asarray(ds.test_feats)
    with open(npz_file, "wb") as f:
        # uncompressed on purpose: np.load of multi-GB compressed archives
        # is single-threaded zlib and would dominate startup
        np.savez(f, **d)


def _load_cached(npz_file: str) -> Dataset:
    z = np.load(npz_file)
    if "sparse_feats" in z:
        sparse_feats = bool(z["sparse_feats"])
    else:
        # reference-produced GraphSAGE caches (same filenames) store dense
        # 'feats' arrays and no flag — infer the schema from the keys
        sparse_feats = "feats_data" in z
    if sparse_feats:
        feats = _load_csr(z, "feats")
        train_feats = _load_csr(z, "train_feats")
        test_feats = _load_csr(z, "test_feats")
    else:
        feats, train_feats, test_feats = (z["feats"], z["train_feats"],
                                          z["test_feats"])
    return Dataset(
        num_data=int(z["num_data"]),
        train_adj=_load_csr(z, "train_adj"), full_adj=_load_csr(z, "full_adj"),
        feats=feats, train_feats=train_feats, test_feats=test_feats,
        labels=z["labels"], train_d=z["train_data"], val_d=z["val_data"],
        test_d=z["test_data"])


# --------------------------------------------------------------------------
# Planetoid / GCN pickle format (gcn/utils.py:33-183)
# --------------------------------------------------------------------------

def _parse_index_file(filename: str):
    return [int(line.strip()) for line in open(filename)]


def _adj_from_graph_dict(graph: dict, n: int) -> sp.csr_matrix:
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, n))
    # symmetrize as an unweighted 0/1 adjacency (networkx semantics)
    a = ((a + a.T) > 0).astype(np.float32)
    return a


def load_gcn_data(dataset_str: str, cfg: Config) -> Dataset:
    npz_file = os.path.join(cfg.data_dir,
                            f"{dataset_str}_{cfg.normalization}.npz")
    if os.path.exists(npz_file):
        return _load_cached(npz_file)

    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    objects = []
    for name in names:
        with open(os.path.join(cfg.data_dir,
                               f"ind.{dataset_str}.{name}"), "rb") as f:
            objects.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objects

    test_idx_reorder = _parse_index_file(
        os.path.join(cfg.data_dir, f"ind.{dataset_str}.test.index"))

    if dataset_str != "nell":
        test_idx_range = np.sort(test_idx_reorder)
        if dataset_str == "citeseer":
            # Fix isolated test nodes (gcn/utils.py:67-76): extend tx/ty over
            # the full contiguous test index range with zero rows.
            full_range = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
            tx_ext = sp.lil_matrix((len(full_range), x.shape[1]))
            tx_ext[test_idx_range - min(test_idx_range), :] = tx
            tx = tx_ext
            ty_ext = np.zeros((len(full_range), y.shape[1]))
            ty_ext[test_idx_range - min(test_idx_range), :] = ty
            ty = ty_ext

        features = sp.vstack((allx, tx)).tolil()
        features[test_idx_reorder, :] = features[test_idx_range, :]
        labels_all = np.vstack((ally, ty))
        labels_all[test_idx_reorder, :] = labels_all[test_idx_range, :]

        idx_test = test_idx_range.tolist()
        idx_train = np.arange(len(y))
        idx_val = np.arange(len(y), len(y) + 500)
    else:
        features = allx.tocsr()
        labels_all = ally
        idx_test = test_idx_reorder
        idx_train = np.arange(len(y))
        idx_val = np.arange(len(y), len(y) + 969)

    num_data = features.shape[0]
    adj = _adj_from_graph_dict(graph, num_data)

    features = row_normalize_features(features.tocsr())
    full_adj = normalize_adj(adj, cfg.normalization)
    train_adj = full_adj          # train graph == full graph for this format
                                  # (gcn/utils.py:151)
    labels = np.zeros_like(labels_all, dtype=np.float32)
    for idx in (idx_train, idx_val, idx_test):
        labels[idx] = labels_all[idx]

    train_feats = compute_pp_features(train_adj, features)
    test_feats = compute_pp_features(full_adj, features)

    ds = Dataset(num_data=num_data, train_adj=train_adj, full_adj=full_adj,
                 feats=features.tocsr().astype(np.float32),
                 train_feats=train_feats.tocsr().astype(np.float32),
                 test_feats=test_feats.tocsr().astype(np.float32),
                 labels=labels.astype(np.float32),
                 train_d=np.asarray(idx_train, np.int32),
                 val_d=np.asarray(idx_val, np.int32),
                 test_d=np.asarray(idx_test, np.int32))
    _cache_dataset(npz_file, ds, sparse_feats=True)
    return ds


# --------------------------------------------------------------------------
# GraphSAGE JSON format (gcn/utils.py:186-335), parsed without networkx
# --------------------------------------------------------------------------

def load_graphsage_data(prefix: str, cfg: Config,
                        normalize: bool = True) -> Dataset:
    if cfg.max_degree == -1:
        npz_file = prefix + ".npz"
    else:
        npz_file = f"{prefix}_deg{cfg.max_degree}.npz"
    if os.path.exists(npz_file):
        return _load_cached(npz_file)

    with open(prefix + "-G.json") as f:
        G = json.load(f)
    feats = np.load(prefix + "-feats.npy").astype(np.float32)
    with open(prefix + "-id_map.json") as f:
        id_map = json.load(f)
    conv = (lambda k: int(k)) if next(iter(id_map)).isdigit() else (lambda k: k)
    id_map = {conv(k): int(v) for k, v in id_map.items()}
    with open(prefix + "-class_map.json") as f:
        class_map = json.load(f)
    multilabel = isinstance(next(iter(class_map.values())), list)
    lab_conv = (lambda v: v) if multilabel else (lambda v: int(v))
    class_map = {conv(k): lab_conv(v) for k, v in class_map.items()}

    nodes = G["nodes"]
    links = G["links"]
    node_ids = [nd["id"] for nd in nodes]
    # drop nodes without id_map entries (gcn/utils.py:237-248)
    keep = [nd for nd in nodes if nd["id"] in id_map]
    removed = len(nodes) - len(keep)
    if removed:
        print(f"Removed {removed} nodes that lacked proper annotations")
    num_data = len(id_map)

    # node-link JSON encodes link endpoints as indices into the node list
    def _endpoint(v):
        return node_ids[v] if isinstance(v, int) else v

    edges = []
    for lk in links:
        a, b = _endpoint(lk["source"]), _endpoint(lk["target"])
        if a in id_map and b in id_map:
            edges.append((id_map[a], id_map[b]))
    print(f"{len(edges)} edges")

    if cfg.max_degree != -1:
        print("Subsampling edges...")
        edges = subsample_edges(np.asarray(edges, np.int32), num_data,
                                cfg.max_degree)
    edges = np.asarray(edges, dtype=np.int32)

    val_data = np.array(sorted(id_map[nd["id"]] for nd in keep if nd["val"]),
                        dtype=np.int32)
    test_data = np.array(sorted(id_map[nd["id"]] for nd in keep if nd["test"]),
                         dtype=np.int32)
    is_train = np.ones(num_data, dtype=bool)
    is_train[val_data] = False
    is_train[test_data] = False
    train_data = np.nonzero(is_train)[0].astype(np.int32)

    train_mask = is_train[edges[:, 0]] & is_train[edges[:, 1]]
    train_edges = edges[train_mask]

    if multilabel:
        num_classes = len(next(iter(class_map.values())))
        labels = np.zeros((num_data, num_classes), dtype=np.float32)
        for k, v in class_map.items():
            labels[id_map[k], :] = np.asarray(v)
    else:
        num_classes = len(set(class_map.values()))
        labels = np.zeros((num_data, num_classes), dtype=np.float32)
        for k, v in class_map.items():
            labels[id_map[k], v] = 1

    if normalize:
        feats = standardize(feats, train_data)

    train_adj = graphsage_normalize_adj(
        adj_from_edges(train_edges, num_data))
    full_adj = graphsage_normalize_adj(adj_from_edges(edges, num_data))
    train_feats = compute_pp_features(train_adj, feats)
    test_feats = compute_pp_features(full_adj, feats)

    ds = Dataset(num_data=num_data, train_adj=train_adj, full_adj=full_adj,
                 feats=feats, train_feats=np.asarray(train_feats, np.float32),
                 test_feats=np.asarray(test_feats, np.float32),
                 labels=labels, train_d=train_data, val_d=val_data,
                 test_d=test_data)
    _cache_dataset(npz_file, ds, sparse_feats=False)
    return ds


# --------------------------------------------------------------------------
# YouTube CSV format (gcn/utils.py:338-413)
# --------------------------------------------------------------------------

def load_youtube_data(prefix: str, ptrain: float, cfg: Config) -> Dataset:
    npz_file = os.path.join(cfg.data_dir, f"{prefix}_{ptrain}.npz")
    if os.path.exists(npz_file):
        return _load_cached(npz_file)

    with open(os.path.join(cfg.data_dir, prefix, "edges.csv")) as f:
        links = np.asarray(
            [[int(t) - 1 for t in line.split(",")[:2]] for line in f],
            dtype=np.int32)
    num_data = int(links.max()) + 1
    adj = graphsage_normalize_adj(adj_from_edges(links, num_data))

    feats = sp.eye(num_data, dtype=np.float32, format="csr")
    feats1 = adj.dot(feats)

    num_classes = 47
    labels = np.zeros((num_data, num_classes), dtype=np.float32)
    with open(os.path.join(cfg.data_dir, prefix, "group-edges.csv")) as f:
        for line in f:
            a, b = line.split(",")[:2]
            labels[int(a) - 1, int(b) - 1] = 1

    labeled = np.nonzero(labels.sum(1))[0].astype(np.int32)
    rng = np.random.default_rng(cfg.seed)
    rng.shuffle(labeled)
    n_train = int(len(labeled) * ptrain)
    train_d = labeled[:n_train].copy()
    val_d = labeled[n_train:].copy()
    test_d = labeled[n_train:].copy()

    (num_data, adj, feats, feats1, labels, train_d, val_d, test_d) = \
        data_augmentation(num_data, adj, adj, feats, labels,
                          train_d, val_d, test_d)

    ds = Dataset(num_data=num_data, train_adj=adj, full_adj=adj,
                 feats=feats.tocsr(), train_feats=feats1.tocsr(),
                 test_feats=feats1.tocsr(), labels=labels,
                 train_d=train_d, val_d=val_d, test_d=test_d)
    _cache_dataset(npz_file, ds, sparse_feats=True)
    return ds


# --------------------------------------------------------------------------
# Synthetic generators (no reference counterpart; used for tests/benchmarks
# since the original datasets ship separately from the code)
# --------------------------------------------------------------------------

def synthetic_dataset(num_nodes: int = 512, feature_dim: int = 64,
                      num_classes: int = 7, avg_degree: int = 8,
                      normalization: str = "gcn", multitask: bool = False,
                      seed: int = 0, powerlaw: bool = False,
                      max_degree: int = -1) -> Dataset:
    """Random graph + planted-signal labels, shaped like a citation dataset.

    Labels are generated from a smoothed random feature projection so a GCN
    can actually learn them (accuracy well above chance), giving the
    convergence tests a meaningful target.
    """
    rng = np.random.default_rng(seed)
    if powerlaw:
        # preferential-attachment-ish: each new node links to m targets with
        # probability proportional to (degree + 1)
        m = max(1, avg_degree // 2)
        rows, cols = [], []
        deg = np.ones(num_nodes)
        for v in range(1, num_nodes):
            p = deg[:v] / deg[:v].sum()
            tgt = rng.choice(v, size=min(m, v), replace=False, p=p)
            for t in tgt:
                rows.append(v); cols.append(t)
                deg[v] += 1; deg[t] += 1
        edges = np.stack([rows, cols], axis=1).astype(np.int32)
    else:
        n_edges = num_nodes * avg_degree // 2
        edges = rng.integers(0, num_nodes, size=(n_edges, 2)).astype(np.int32)
        edges = edges[edges[:, 0] != edges[:, 1]]
    if max_degree != -1:
        edges = subsample_edges(edges, num_nodes, max_degree, rng)

    adj01 = (adj_from_edges(edges, num_nodes) > 0).astype(np.float32)
    full_adj = normalize_adj(adj01, normalization)

    feats = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    # planted signal: labels from a 2-hop smoothed projection of the features
    proj = rng.normal(size=(feature_dim, num_classes)).astype(np.float32)
    smooth = full_adj.dot(full_adj.dot(feats)) if normalization == "gcn" \
        else full_adj.dot(feats)
    logits = smooth.dot(proj)
    if multitask:
        labels = (logits > np.median(logits, axis=0)).astype(np.float32)
    else:
        labels = np.zeros((num_nodes, num_classes), dtype=np.float32)
        labels[np.arange(num_nodes), logits.argmax(1)] = 1

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * 0.5)
    n_val = int(num_nodes * 0.25)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    # train graph: edges among train nodes only for graphsage-style splits;
    # for gcn-style (citation) splits train_adj == full_adj (utils.py:151)
    if normalization == "graphsage":
        is_train = np.zeros(num_nodes, dtype=bool)
        is_train[train_d] = True
        tr_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]
        train_adj = graphsage_normalize_adj(
            adj_from_edges(tr_edges, num_nodes))
    else:
        train_adj = full_adj

    train_feats = compute_pp_features(train_adj, feats)
    test_feats = compute_pp_features(full_adj, feats)
    return Dataset(num_data=num_nodes, train_adj=train_adj,
                   full_adj=full_adj, feats=feats,
                   train_feats=np.asarray(train_feats, np.float32),
                   test_feats=np.asarray(test_feats, np.float32),
                   labels=labels, train_d=train_d, val_d=val_d, test_d=test_d)


def community_sbm_dataset(num_nodes: int = 65536, num_classes: int = 41,
                          feature_dim: int = 602, mean_degree: int = 25,
                          p_in: float = 0.85, snr: float = 0.18,
                          pareto_a: float = 2.5, max_degree: int = -1,
                          train_frac: float = 0.66, val_frac: float = 0.10,
                          seed: int = 0) -> Dataset:
    """Degree-corrected stochastic block model with power-law degrees —
    the community-structured Reddit stand-in for the estimator
    time-to-accuracy benchmark (the stand-in for the reference's
    Reddit protocol, scripts/analyze-time.py:12-14: time to 0.94 val
    accuracy).

    Labels are the planted communities.  Per-node features are a WEAK
    class signal (``snr`` standard deviations of class-mean separation
    under unit noise), calibrated so raw per-node features are far from
    sufficient while one neighborhood aggregation (mostly same-community
    neighbors, ``p_in``) denoises into the >=0.9 micro-F1 band — i.e. the
    graph is what carries the signal, exactly the regime where estimator
    variance matters.  Degrees are power-law (Pareto ``pareto_a``
    propensities), capped at load time via ``max_degree`` like the
    reference's GraphSAGE --max_degree (gcn/utils.py:261-263).
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    theta = rng.pareto(pareto_a, num_nodes) + 1.0
    p_global = theta / theta.sum()

    m = num_nodes * mean_degree // 2
    src = rng.choice(num_nodes, size=m, p=p_global).astype(np.int32)
    inside = rng.random(m) < p_in
    dst = rng.choice(num_nodes, size=m, p=p_global).astype(np.int32)
    # redraw in-community targets per community, ∝ theta within the block
    for c in range(num_classes):
        members = np.nonzero(comm == c)[0]
        need = np.nonzero(inside & (comm[src] == c))[0]
        if len(need) and len(members):
            pc = theta[members] / theta[members].sum()
            dst[need] = rng.choice(members, size=len(need), p=pc)
    edges = np.stack([src, dst], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if max_degree != -1:
        edges = subsample_edges(edges, num_nodes, max_degree, rng)

    adj01 = (adj_from_edges(edges, num_nodes) > 0).astype(np.float32)
    full_adj = graphsage_normalize_adj(adj01)

    mu = rng.normal(size=(num_classes, feature_dim)).astype(np.float32)
    feats = (snr * mu[comm]
             + rng.normal(size=(num_nodes, feature_dim))).astype(np.float32)
    labels = np.zeros((num_nodes, num_classes), dtype=np.float32)
    labels[np.arange(num_nodes), comm] = 1

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    n_val = int(num_nodes * val_frac)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    is_train = np.zeros(num_nodes, dtype=bool)
    is_train[train_d] = True
    tr_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]
    train_adj = graphsage_normalize_adj(
        (adj_from_edges(tr_edges, num_nodes) > 0).astype(np.float32))

    train_feats = compute_pp_features(train_adj, feats)
    test_feats = compute_pp_features(full_adj, feats)
    return Dataset(num_data=num_nodes, train_adj=train_adj,
                   full_adj=full_adj, feats=feats,
                   train_feats=np.asarray(train_feats, np.float32),
                   test_feats=np.asarray(test_feats, np.float32),
                   labels=labels, train_d=train_d, val_d=val_d,
                   test_d=test_d)


# --------------------------------------------------------------------------
# dispatch (gcn/utils.py:466-473)
# --------------------------------------------------------------------------

def load_data(cfg: Config) -> Dataset:
    name = cfg.dataset
    if name in GCN_DATASETS:
        return load_gcn_data(name, cfg)
    if name == "youtube":
        return load_youtube_data(name, 0.9, cfg)
    if name.startswith("synthetic"):
        # synthetic[:nodes[:dim[:classes]]]
        parts = name.split(":")[1:]
        kw = {}
        for key, p in zip(("num_nodes", "feature_dim", "num_classes"), parts):
            kw[key] = int(p)
        return synthetic_dataset(normalization=cfg.normalization,
                                 seed=cfg.seed, max_degree=cfg.max_degree,
                                 **kw)
    return load_graphsage_data(os.path.join(cfg.data_dir, name), cfg)
