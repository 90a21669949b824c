"""Host-side graph/feature preprocessing (pure numpy/scipy).

Reproduces the reference's normalization semantics exactly
(reference: gcn/utils.py:119-143 for citation graphs, utils.py:299-309 for
GraphSAGE graphs) so accuracy bands carry over, but lives in its own module
with no global flag coupling.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def row_normalize_features(features: sp.spmatrix) -> sp.spmatrix:
    """Row-normalize a feature matrix: X <- D^-1 X.

    Matches gcn/utils.py:138-143 (rowsum + 1e-9, inf -> 0).
    """
    rowsum = np.asarray(features.sum(1)).flatten() + 1e-9
    r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return sp.diags(r_inv, 0).dot(features)


def standardize(feats: np.ndarray, rows) -> np.ndarray:
    """Zero-mean, unit-variance feature columns with the statistics of
    ``rows`` (the training nodes): scikit-learn's ``StandardScaler``
    fit-then-transform, which the reference applies to GraphSAGE features.
    Columns constant over ``rows`` (variance within rounding of zero, by
    the same bound) are centred only.  Returns float32."""
    x = np.asarray(feats, np.float64)
    fit = x[rows]
    n = fit.shape[0]
    mean = fit.mean(axis=0)
    var = fit.var(axis=0)
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.where(constant, 1.0, np.sqrt(var))
    return ((x - mean) / scale).astype(np.float32)


def gcn_normalize_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Symmetric GCN normalization: D^-1/2 (A + I) D^-1/2.

    Matches gcn/utils.py:127-136 (rowsum computed AFTER adding self loops,
    +1e-20 before the -1/2 power, inf -> 0).
    """
    adj = adj + sp.eye(adj.shape[0])
    rowsum = np.asarray(adj.sum(1)).flatten() + 1e-20
    d_inv_sqrt = np.power(rowsum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt, 0)
    out = adj.dot(d).transpose().dot(d).tocsr()
    out.data = out.data.astype(np.float32)
    return out


def graphsage_normalize_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Row normalization without self loops: D^-1 A.

    Matches gcn/utils.py:119-125 / 299-309 (rowsum + 1e-20).
    """
    rowsum = np.asarray(adj.sum(1)).flatten()
    d_inv = 1.0 / (rowsum + 1e-20)
    out = sp.diags(d_inv, 0).dot(adj).tocsr()
    out.data = out.data.astype(np.float32)
    return out


def normalize_adj(adj: sp.spmatrix, normalization: str) -> sp.csr_matrix:
    if normalization == "gcn":
        return gcn_normalize_adj(adj)
    elif normalization == "graphsage":
        return graphsage_normalize_adj(adj)
    raise ValueError(f"unknown normalization {normalization!r}")


def adj_from_edges(edges: np.ndarray, num_data: int,
                   symmetrize: bool = True) -> sp.csr_matrix:
    """Build a 0/1 adjacency from an [E, 2] edge array (utils.py:299-302)."""
    adj = sp.csr_matrix(
        (np.ones(edges.shape[0], dtype=np.float32),
         (edges[:, 0], edges[:, 1])),
        shape=(num_data, num_data))
    if symmetrize:
        adj = adj + adj.transpose()
    return adj.tocsr()


def subsample_edges(edges: np.ndarray, num_data: int, max_degree: int,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Greedy degree-capped edge subsample (utils.py:532-543).

    Edges are shuffled and kept only while both endpoints are below
    ``max_degree``.
    """
    rng = rng or np.random.default_rng(0)
    edges = np.asarray(edges, dtype=np.int32).copy()
    rng.shuffle(edges)
    degree = np.zeros(num_data, dtype=np.int32)
    keep = np.zeros(edges.shape[0], dtype=bool)
    for i, (a, b) in enumerate(edges):
        if degree[a] < max_degree and degree[b] < max_degree:
            keep[i] = True
            degree[a] += 1
            degree[b] += 1
    return edges[keep]


def cap_adj_degree(adj: sp.csr_matrix, max_degree: int, seed: int = 0,
                   rescale: bool = True) -> sp.csr_matrix:
    """Cap each row of a CSR adjacency to at most ``max_degree`` entries.

    Per-row uniform subsample without replacement.  This is the load-time
    analogue of the reference's ``--max_degree``, which subsamples edges
    BEFORE normalization so rows stay normalized (gcn/utils.py:261-263,
    532-543).  Since this runs on an already-normalized adjacency, kept
    entries of capped rows are rescaled by ``deg/max_degree`` so the row
    mass is preserved in expectation-exact form (for ``graphsage`` D^-1 A
    this is bit-equivalent to subsample-then-normalize; for ``gcn`` it
    preserves row mass).  ``rescale=False`` keeps the raw subsampled
    weights (the round-1 behaviour).
    """
    rng = np.random.default_rng(seed)
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    n = adj.shape[0]
    new_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    rows_i, rows_d = [], []
    for r in range(n):
        lo, hi = indptr[r], indptr[r + 1]
        deg = hi - lo
        if deg <= max_degree:
            sel = slice(lo, hi)
            rows_i.append(indices[sel])
            rows_d.append(data[sel])
            new_indptr[r + 1] = new_indptr[r] + deg
        else:
            pick = rng.choice(deg, size=max_degree, replace=False)
            rows_i.append(indices[lo + pick])
            d = data[lo + pick]
            if rescale:
                d = d * (deg / float(max_degree))
            rows_d.append(d)
            new_indptr[r + 1] = new_indptr[r] + max_degree
    return sp.csr_matrix(
        (np.concatenate(rows_d), np.concatenate(rows_i), new_indptr),
        shape=adj.shape)


def compute_pp_features(adj: sp.csr_matrix, feats):
    """PP features: one application of the normalized adjacency, Â·X.

    Matches gcn/utils.py:169-170 / 321-322 — computed once at load time, on
    the host, so the first aggregation layer can be dropped from the model.
    """
    return adj.dot(feats)


def data_augmentation(num_data, train_adj, full_adj, feats, labels,
                      train_data, val_data, test_data, n_rep: int = 1):
    """Block-diagonal graph replication (utils.py:416-449).

    Replicates the training graph ``n_rep`` times followed by one copy of the
    full graph; train ids index the train copies, val/test ids the full copy.
    """
    if isinstance(feats, np.ndarray):
        feats = np.tile(feats, [n_rep + 1, 1])
    else:
        feats = sp.vstack([feats] * (n_rep + 1)).tocsr()
    labels = np.tile(labels, [n_rep + 1, 1])

    train_coo = train_adj.tocoo()
    full_coo = full_adj.tocoo()
    rows, cols, vals = [], [], []
    for t in range(n_rep):
        rows.append(train_coo.row + t * num_data)
        cols.append(train_coo.col + t * num_data)
        vals.append(train_coo.data)
    rows.append(full_coo.row + n_rep * num_data)
    cols.append(full_coo.col + n_rep * num_data)
    vals.append(full_coo.data)

    big_n = num_data * (n_rep + 1)
    adj = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(big_n, big_n), dtype=train_adj.dtype)

    train_data = np.concatenate(
        [train_data + t * num_data for t in range(n_rep)])
    val_data = val_data + n_rep * num_data
    test_data = test_data + n_rep * num_data
    return (big_n, adj, feats, adj.dot(feats), labels,
            train_data, val_data, test_data)


def locality_permutation(adj: sp.spmatrix, method: str = "rcm") -> np.ndarray:
    """Node permutation improving edge locality for contiguous-block
    row-sharding (cfg.partition_nodes): position i of the returned array
    holds the OLD id placed at NEW id i.

    'rcm' = reverse Cuthill-McKee over the symmetrized STRUCTURE of
    ``adj`` (bandwidth minimization): after relabeling, a node's graph
    neighbors have nearby ids, so cutting the id range into P contiguous
    ownership blocks leaves most edges (and hence most sampled
    receptive-field rows) within their batch node's owner chip.  This is
    the framework's lightweight stand-in for a METIS-style partitioner —
    pure scipy, deterministic, O(E).  The reference has no multi-device
    layout at all (SURVEY.md §2.3); relabeling is semantically a no-op.
    """
    if method != "rcm":
        raise ValueError(f"unknown partition_nodes method: {method!r}")
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    sym = (adj + adj.T).astype(bool).astype(np.int8).tocsr()
    return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                      dtype=np.int64)


def relabel_dataset(ds, perm: np.ndarray):
    """Apply a node permutation to every per-node table of a Dataset
    (adjacency rows+cols, features, PP features, labels, id splits).
    Training is permutation-invariant: losses/metrics are per-node and the
    estimators depend only on graph structure, so trajectories match the
    unrelabeled run up to floating-point reduction order."""
    from .graph import Dataset

    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    def remap_adj(a):
        return a.tocsr()[perm][:, perm].tocsr()

    def remap_rows(x):
        return x.tocsr()[perm] if sp.issparse(x) else np.asarray(x)[perm]

    return Dataset(
        num_data=ds.num_data,
        train_adj=remap_adj(ds.train_adj),
        full_adj=remap_adj(ds.full_adj),
        feats=remap_rows(ds.feats),
        train_feats=remap_rows(ds.train_feats),
        test_feats=remap_rows(ds.test_feats),
        labels=np.asarray(ds.labels)[perm],
        train_d=inv[np.asarray(ds.train_d)].astype(np.int32),
        val_d=inv[np.asarray(ds.val_d)].astype(np.int32),
        test_d=inv[np.asarray(ds.test_d)].astype(np.int32),
    )
