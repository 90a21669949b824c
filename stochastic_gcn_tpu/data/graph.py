"""Device-resident graph containers.

The reference streams sampled sub-adjacencies host->GPU every step via TF1
feed_dicts (gcn/_scheduler.pyx:137-148).  This design instead keeps the
WHOLE graph resident in device memory in a static-shape padded form so the
entire training step (sampling included) compiles into one XLA program:

* ``PaddedGraph``: neighbor ids/weights as dense ``[N, Dcap]`` arrays with a
  sentinel id ``N`` for empty slots.  Row order is the CSR order.  This is the
  device analogue of the CSR arrays the reference C++ scheduler walks
  (gcn/scheduler.h:17-27): random per-row access with static shapes, ideal for
  vectorized fanout sampling and for the CV full-neighborhood term.
* ``DenseRows``: node-indexed dense data (features/labels/history) stored as
  ``[N+1, d]`` with a zero sentinel row so padded gathers are harmless.
* ``PaddedSparseFeatures``: row-padded (idx, val) form of a sparse feature
  matrix; the first dense layer treats X @ W as an embedding gather-sum, the
  static-shape equivalent of the reference's sparse_tensor_dense_matmul on
  sparse inputs (gcn/layers.py:31-37).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PaddedGraph:
    """Static-shape padded adjacency, device-resident.

    Stored with ``N+1`` rows: row ``N`` is an empty sentinel row so that
    gathers indexed by sentinel-padded node ids stay in bounds and contribute
    zero weight.

    Attributes:
      nbr:  [N+1, Dcap] int32 neighbor ids; empty slots hold N (sentinel).
      w:    [N+1, Dcap] float32 normalized edge weights; empty slots hold 0.
      deg:  [N+1] int32 true (possibly capped) out-degree per row; deg[N]=0.
      n_real: static node count when the row tables carry extra zero
        padding rows (so they tile over a device mesh); -1 = rows are
        exactly N+1 and N is derived from the shape.
    """
    nbr: jax.Array
    w: jax.Array
    deg: jax.Array
    n_real: int = dataclasses.field(default=-1, metadata=dict(static=True))
    # Two-tier CV full-neighborhood term (aggregators.full_neighborhood_mean):
    # tier_w > 0 splits the [F, Dcap] history gather into a [F, tier_w] main
    # pass (exact for every row with degree <= tier_w) plus a
    # capacity-bounded [big_cap, Dcap - tier_w] tail pass over the few
    # higher-degree rows, recovering the row-issue cost of padding to the
    # graph MAX degree when the mean is far below it.  tier_frac sizes the
    # tail capacity as a fraction of the field; exact semantics are kept by
    # a lax.cond fallback to the full-width tail on capacity overflow.
    # Chosen host-side by choose_tier(); -1 disables.
    tier_w: int = dataclasses.field(default=-1, metadata=dict(static=True))
    tier_frac: float = dataclasses.field(default=0.0,
                                         metadata=dict(static=True))

    @property
    def num_nodes(self) -> int:
        return self.n_real if self.n_real >= 0 else self.nbr.shape[0] - 1

    @property
    def pad_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def num_edges(self) -> jax.Array:
        return jnp.sum(self.deg)


def choose_tier(deg: np.ndarray, dcap: int, safety: float = 4.0,
                force_w: int = 0):
    """Pick the two-tier split (tier_w, tier_frac) for a degree sequence.

    Minimizes the expected full-term row-issue cost per field row,
    ``w1 + safety * p_big(w1) * (dcap - w1)``, over w1 in multiples of 8.
    ``p_big`` is the worse of the node-uniform and edge-biased (a sampled
    neighbour is degree-biased) probabilities that a field row's degree
    exceeds w1.  Returns (-1, 0.0) when the predicted saving is below 10%
    (tiering then only adds dispatches).

    ``force_w > 0`` (the --fadj_tier_w override) skips the cost model and
    only sizes the tail capacity for that width.
    """
    deg = np.asarray(deg, np.int64)
    total_e = float(deg.sum())
    if deg.size == 0 or total_e == 0 or (not force_w and dcap <= 16):
        return -1, 0.0

    def p_big(w1):
        big = deg > w1
        return max(float(big.mean()), float(deg[big].sum()) / total_e)

    if force_w > 0:
        return int(force_w), min(1.0, safety * p_big(force_w))
    best = (float(dcap), -1, 0.0)
    for w1 in range(8, dcap, 8):
        p = p_big(w1)
        cost = w1 + safety * p * (dcap - w1)
        if cost < best[0]:
            best = (cost, w1, p)
    cost, w1, p = best
    if w1 <= 0 or cost > 0.9 * dcap:
        return -1, 0.0
    return w1, min(1.0, safety * p)


def pad_csr(adj: sp.csr_matrix, pad_degree: int = -1,
            tier: bool = False, tier_w: int = 0) -> PaddedGraph:
    """Convert a scipy CSR adjacency to a PaddedGraph.

    ``pad_degree = -1`` pads to the true maximum degree (exact semantics).
    A smaller cap keeps the first ``pad_degree`` CSR entries per row — for
    capped-degree graphs apply :func:`preprocess.cap_adj_degree` first to get
    a *random* (rather than positional) subsample.
    """
    adj = adj.tocsr()
    n = adj.shape[0]

    def _tier(deg_capped, dcap_):
        if not tier:
            return -1, 0.0
        return choose_tier(deg_capped, dcap_, force_w=tier_w)

    # native fast path (csrc/graphlib.cpp) — vectorized numpy fallback below
    try:
        from ..sampler.host import build_padded_arrays
        out, dcap = build_padded_arrays(adj, pad_degree, cap_random=False)
        if out is not None:
            nbr, w, deg_out = out
            tw, tf = _tier(deg_out[:n], int(nbr.shape[1]))
            return PaddedGraph(nbr=jnp.asarray(nbr), w=jnp.asarray(w),
                               deg=jnp.asarray(deg_out),
                               tier_w=tw, tier_frac=tf)
    except Exception:
        pass

    deg = np.diff(adj.indptr).astype(np.int32)
    dcap = int(deg.max()) if n and deg.size else 1
    if pad_degree != -1:
        dcap = int(pad_degree)
    dcap = max(dcap, 1)

    capped = np.minimum(deg, dcap)
    # vectorized fill: entry (r, s) takes CSR slot indptr[r]+s when s<deg[r]
    slot = np.arange(dcap, dtype=np.int64)[None, :]
    src = adj.indptr[:-1, None] + slot                 # [n, dcap]
    valid = slot < capped[:, None]
    src = np.where(valid, src, 0)
    nbr = np.full((n + 1, dcap), n, dtype=np.int32)
    w = np.zeros((n + 1, dcap), dtype=np.float32)
    if adj.indices.size:
        nbr[:n] = np.where(valid, adj.indices[src], n)
        w[:n] = np.where(valid, adj.data[src], 0.0)
    deg_out = np.zeros(n + 1, dtype=np.int32)
    deg_out[:n] = capped
    tw, tf = _tier(capped, dcap)
    return PaddedGraph(
        nbr=jnp.asarray(nbr),
        w=jnp.asarray(w),
        deg=jnp.asarray(deg_out),
        tier_w=tw, tier_frac=tf,
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FlatGraph:
    """Flat-CSR adjacency, device-resident — the edge-list counterpart of
    :class:`PaddedGraph` for power-law degree distributions.

    Storage is O(E) instead of O(N * max_degree): hub-heavy graphs (NELL
    without --max_degree caps) keep exact neighborhoods without padding the
    whole graph to the hub degree.  Row windows for the fanout sampler and
    the CV full-neighborhood term are materialized per-field on the fly
    (see :func:`flat_row_windows`).

    Storage is BLOCK-ALIGNED: every CSR row starts on a ``BLOCK``-element
    boundary of the flat arrays, which are kept as 2-D ``[NB, BLOCK]``
    tables.  A width-W row window is then ``ceil(W / BLOCK)`` whole-block
    row gathers plus a static slice, where ``vmap(dynamic_slice)`` over a
    1-D array lowers to one gather per element (W per row).
    Alignment costs < (BLOCK-1) pad slots per row (~BLOCK/2 expected).

    Attributes:
      bstart: [N+2] int32 BLOCK index of each row's aligned start; row N
              is the empty sentinel row (tail blocks, all padding).
      idx:    [NB, BLOCK] int32 neighbor ids; alignment gaps and the tail
              hold the sentinel id N so row windows never read junk.
      w:      [NB, BLOCK] float32 edge weights; gaps/tail hold 0.
      deg:    [N+1] int32 row lengths; deg[N] = 0.
      max_degree:       static — true max row length (sampler row window).
      edge_cap_per_row: static — per-ROW edge budget for the CV
        full-neighborhood term: each output row reads a contiguous
        ``edge_cap_per_row``-wide window of its CSR range (ONE gather
        issue per block instead of one per edge slot).  Rows with degree
        above the budget lose their trailing CSR edges — the gather-time
        analogue of the reference's --max_degree load-time subsampling
        (gcn/utils.py:261-263, but without renormalization); size it via
        ``--fadj_edge_mult`` or cap degrees properly with --pad_degree.
      parts: static — node-sharding partitions the block tables were BUILT
        for: chip ``p`` owns the blocks of nodes ``[p*ceil(N/parts), ...)``,
        every chip is padded to the same block count (so ``idx``/``w``
        row-shard into ``parts`` equal tiles, block owner =
        ``bid // (NB/parts)``), and each chip carries its own
        ceil(max_degree/B)-block sentinel tail so row windows never cross
        into the next chip's tile.  ``parts=1`` is the replicated layout.
    """
    bstart: jax.Array
    idx: jax.Array
    w: jax.Array
    deg: jax.Array
    max_degree: int = dataclasses.field(metadata=dict(static=True))
    edge_cap_per_row: int = dataclasses.field(metadata=dict(static=True))
    parts: int = dataclasses.field(default=1, metadata=dict(static=True))
    # Two-tier full term split (see PaddedGraph.tier_w): main windows of
    # tier_w slots + a capacity-bounded full-budget tail for big rows.
    tier_w: int = dataclasses.field(default=-1, metadata=dict(static=True))
    tier_frac: float = dataclasses.field(default=0.0,
                                         metadata=dict(static=True))
    # [N+1] f32 per-row renormalization for the CV full-neighborhood term:
    # full_row_mass / mass(first edge_cap_per_row entries) for rows the
    # edge budget truncates, 1 elsewhere — the same mass-preserving
    # semantics the reference's --max_degree load-time subsample keeps by
    # renormalizing AFTER capping (gcn/utils.py:532-543).  Replicated on a
    # mesh (small, like ``deg``).  None on pre-round-4 pickles.
    renorm: Optional[jax.Array] = None
    # Static record of the edge fraction the per-row budget drops from the
    # CV full-neighborhood term (0.0 = lossless).  Surfaced as
    # ``truncated_edges_frac`` in bench / replica-validation artifacts so
    # a lossy full term can never pass silently (the
    # UserWarning alone is easy to miss in logs).  Rounded at
    # construction so equal-budget graphs share a treedef.
    truncated_frac: float = dataclasses.field(
        default=0.0, metadata=dict(static=True))

    BLOCK = 8          # f32/int32 sublane width: minimal pad, whole-block
                       # gathers already ride the row-issue path

    @property
    def num_nodes(self) -> int:
        return self.bstart.shape[0] - 2

    @property
    def pad_degree(self) -> int:
        # row-window width: a field row materializes at most this many slots
        return self.max_degree

    @property
    def num_edges(self) -> jax.Array:
        return jnp.sum(self.deg)


AUTO_EDGE_COVERAGE = 0.999   # auto edge budget covers >= this edge fraction


def flat_csr(adj: sp.csr_matrix, edge_mult: float = 0.0,
             parts: int = 1, tier: bool = False,
             tier_w: int = 0) -> FlatGraph:
    """Convert a scipy CSR adjacency to a FlatGraph.

    ``edge_mult > 0`` sets ``edge_cap_per_row = ceil(edge_mult *
    mean_degree)`` (at least 1, at most the max degree).  ``edge_mult <= 0``
    (the default, --fadj_edge_mult 0) AUTO-sizes the budget from the degree
    distribution: the smallest BLOCK multiple whose windows cover >=
    ``AUTO_EDGE_COVERAGE`` (99.9%) of all full-term edge slots — so skewed
    graphs get the budget they need instead of a silently lossy default
    (the fixed 4x default missed the PPI replica band).

    Rows longer than the budget are truncated to their first
    ``edge_cap_per_row`` CSR entries in the CV full-neighborhood term and
    RENORMALIZED there (``FlatGraph.renorm`` scales kept weights so row
    mass is preserved — the reference's --max_degree semantics,
    gcn/utils.py:532-543); sampling fanout windows are never truncated.

    ``parts > 1`` lays the block tables out for node-sharding over that
    many chips (see :class:`FlatGraph.parts`): per-chip memory becomes
    ~O(E/parts), window block reads are owner-routed through the halo
    fetch transport (parallel/halo.py) when a mesh is passed to
    :func:`flat_row_windows`.
    """
    adj = adj.tocsr()
    n = adj.shape[0]
    deg = np.diff(adj.indptr).astype(np.int32)
    max_deg = int(deg.max()) if deg.size else 1
    max_deg = max(max_deg, 1)
    mean_deg = float(deg.mean()) if deg.size else 1.0
    B = FlatGraph.BLOCK
    if edge_mult > 0:
        cap_row = int(min(max_deg,
                          max(1, int(np.ceil(edge_mult * mean_deg)))))
    else:
        # auto: smallest BLOCK-multiple cap c with
        # sum(min(deg, c)) >= coverage * sum(deg)
        total_e = int(deg.sum())
        if total_e == 0:
            cap_row = 1
        else:
            ds_sorted = np.sort(deg.astype(np.int64))
            csum = np.concatenate([[0], np.cumsum(ds_sorted)])
            cands = np.arange(B, max_deg + B, B, dtype=np.int64)
            pos = np.searchsorted(ds_sorted, cands, side="right")
            kept = csum[pos] + cands * (n - pos)
            ok = kept >= AUTO_EDGE_COVERAGE * total_e
            cap_row = int(min(max_deg, cands[np.argmax(ok)] if ok.any()
                              else max_deg))

    # Truncated rows are renormalized in the full term (mass-preserving,
    # like the reference's --max_degree subsample); still surface heavy
    # truncation — an explicit small budget costs full-term fidelity.
    over = deg > cap_row
    trunc_frac = 0.0
    if over.any():
        lost = int((deg[over] - cap_row).sum())
        total = int(deg.sum())
        trunc_frac = round(lost / max(total, 1), 6)
        if lost > 0.01 * total:
            import warnings
            warnings.warn(
                f"flat_csr: edge_cap_per_row={cap_row} truncates "
                f"{int(over.sum())} rows (degree > cap), dropping "
                f"{lost}/{total} edges ({100.0 * lost / max(total, 1):.2f}%)"
                " from the CV full-neighborhood term (kept edges are "
                "renormalized to preserve row mass); raise "
                "--fadj_edge_mult (or 0 = auto) for exact neighborhoods.",
                stacklevel=2)

    # block-aligned layout: row i owns blocks [bstart[i], bstart[i+1]).
    # Each partition carries a ceil(max_degree/B)-block sentinel tail so a
    # window from ANY of its rows (incl. the global sentinel row N, placed
    # at the last partition's used end) stays inside the partition's tile;
    # with parts=1 this is just the global tail pad.
    nb_row = -(-deg // B)                       # ceil(deg / B), 0 for deg 0
    wpad = max(-(-max_deg // B), 1)
    cum = np.zeros(n + 1, np.int64)
    cum[1:] = np.cumsum(nb_row, dtype=np.int64)
    nl = -(-n // parts)                         # nodes per partition
    owner = np.arange(n, dtype=np.int64) // nl
    part_lo = np.minimum(np.arange(parts, dtype=np.int64) * nl, n)
    part_hi = np.minimum(part_lo + nl, n)
    used = cum[part_hi] - cum[part_lo]          # blocks used per partition
    nb_chip = int(used.max()) + wpad if n else wpad
    bstart = np.zeros(n + 2, np.int64)
    bstart[:n] = owner * nb_chip + (cum[:n] - cum[part_lo[owner]])
    bstart[n] = (parts - 1) * nb_chip + int(used[-1]) if n else 0
    bstart[n + 1] = bstart[n]                   # sentinel row N: empty
    total_blocks = parts * nb_chip
    deg_out = np.zeros(n + 1, np.int32)
    deg_out[:n] = deg
    idx = np.full(total_blocks * B, n, np.int32)
    w = np.zeros(total_blocks * B, np.float32)
    # scatter each row's CSR entries to its aligned start; ``off`` is each
    # entry's position within its CSR row (reused by the renorm below)
    off = (np.arange(len(adj.indices), dtype=np.int64)
           - np.repeat(adj.indptr[:n].astype(np.int64), deg))
    dst = np.repeat(bstart[:n] * B, deg) + off
    idx[dst] = adj.indices.astype(np.int32)
    w[dst] = adj.data.astype(np.float32)
    # mass-preserving renorm for budget-truncated rows (see docstring)
    renorm = np.ones(n + 1, np.float32)
    if over.any():
        row_ids = np.repeat(np.arange(n, dtype=np.int64), deg)
        wdat = adj.data.astype(np.float64)
        full_mass = np.bincount(row_ids, weights=wdat, minlength=n)
        keep = off < cap_row
        kept_mass = np.bincount(row_ids[keep], weights=wdat[keep],
                                minlength=n)
        tr_rows = over & (kept_mass[:n] > 0)
        renorm[:n][tr_rows] = (full_mass[tr_rows]
                               / kept_mass[tr_rows]).astype(np.float32)
    tw, tf = (-1, 0.0)
    if tier:
        width = min(cap_row, max_deg)
        tw, tf = choose_tier(np.minimum(deg, width), width,
                             force_w=tier_w)
        # tier boundaries must be block-aligned (they are: choose_tier
        # scans multiples of 8 == BLOCK, and a manual --fadj_tier_w off
        # the grid is rejected here) and leave a real tail window
        if tw > 0 and (tw % B != 0 or tw > width - B):
            tw, tf = -1, 0.0
    return FlatGraph(bstart=jnp.asarray(bstart.astype(np.int32)),
                     idx=jnp.asarray(idx.reshape(-1, B)),
                     w=jnp.asarray(w.reshape(-1, B)),
                     deg=jnp.asarray(deg_out),
                     max_degree=max_deg, edge_cap_per_row=cap_row,
                     parts=parts, tier_w=tw, tier_frac=tf,
                     renorm=jnp.asarray(renorm),
                     truncated_frac=trunc_frac)


def flat_row_windows(graph: "FlatGraph", field: jax.Array, width: int,
                     mesh=None, start: int = 0):
    """[F, width] neighbor/weight windows from a FlatGraph.

    ``start`` (block-aligned) offsets the window into each row's CSR range
    — slots [start, start+width) — used by the two-tier full term's tail
    pass; slots at or past the row's degree are masked to sentinel/0 as
    usual (reads stay inside the partition's sentinel tail by the
    ``start + width <= max_degree`` budget contract).

    Rows are block-aligned (see :class:`FlatGraph`), so a window is
    ``ceil(width / BLOCK)`` whole-block row gathers from the ``[NB, B]``
    tables plus a STATIC ``[:, :width]`` slice — block-row gathers
    instead of per-element ones (``vmap(dynamic_slice)`` on a 1-D array
    lowers to one gather per ELEMENT).  A window may read past its row's
    blocks into the next row's — those slots are masked by ``deg`` below,
    and per-partition tail padding keeps every window inside its owner's
    tile.  Rows longer
    than ``width`` are truncated to their first ``width`` CSR entries;
    shorter rows are masked to sentinel/0.

    With a mesh and a ``parts``-sharded graph the block reads are
    owner-routed: the [F*nb] block ids ride the same fetch-routed halo
    transport as node-row gathers (block owner = block // (NB/parts)),
    one fused idx+w exchange."""
    n = graph.num_nodes
    B = graph.idx.shape[1]
    assert start % B == 0, "window start must be block-aligned"
    nb = -(-width // B)
    b0 = jnp.take(graph.bstart, field, axis=0) + start // B  # [F]
    deg = jnp.take(graph.deg, field, axis=0)
    bids = (b0[:, None]
            + jnp.arange(nb, dtype=b0.dtype)[None, :]).reshape(-1)
    from ..parallel.halo import halo_tiles, row_gather2
    if graph.parts > 1 and halo_tiles(graph.idx, bids, mesh):
        blk_i, blk_w = row_gather2(graph.idx, graph.w, bids, mesh)
    else:
        blk_i = jnp.take(graph.idx, bids, axis=0)
        blk_w = jnp.take(graph.w, bids, axis=0)
    nbr = blk_i.reshape(-1, nb * B)[:, :width]
    w = blk_w.reshape(-1, nb * B)[:, :width]
    valid = (start + jnp.arange(width, dtype=jnp.int32))[None, :] \
        < deg[:, None]
    rows_nbr = jnp.where(valid, nbr, n)
    rows_w = jnp.where(valid, w, 0.0)
    return rows_nbr, rows_w, deg


def graph_rows(graph, field: jax.Array, mesh=None):
    """Materialize the [F, Dcap] neighbor/weight row windows for a field —
    the single dispatch point between the two graph formats.  Empty slots
    hold the sentinel id N / weight 0 in both.

    With a mesh and a node-sharded :class:`PaddedGraph` (nbr/w rows
    distributed over chips, parallel/halo.py), the nbr+w rows are fetched
    from their owner chips in one fused exchange; ``deg`` is a small [N]
    int vector kept replicated by design, so its gather stays local.
    A :class:`FlatGraph` routes its window BLOCK reads the same way when
    built with ``parts > 1`` (otherwise it is replicated)."""
    if isinstance(graph, FlatGraph):
        return flat_row_windows(graph, field, graph.pad_degree, mesh)
    from ..parallel.halo import halo_tiles, row_gather2
    if halo_tiles(graph.nbr, field, mesh):
        rows_nbr, rows_w = row_gather2(graph.nbr, graph.w, field, mesh,
                                       sentinel=graph.num_nodes)
    else:
        rows_nbr = jnp.take(graph.nbr, field, axis=0)
        rows_w = jnp.take(graph.w, field, axis=0)
    return rows_nbr, rows_w, jnp.take(graph.deg, field, axis=0)


def pad_table_rows(x: jax.Array, multiple: int) -> jax.Array:
    """Zero-pad a node-row table ([R, ...] or [R]) so R divides
    ``multiple`` — required for row-sharding over a mesh.  Padding rows are
    all-zero and never addressed (node ids <= N < R)."""
    r = x.shape[0]
    target = -(-r // multiple) * multiple
    if target == r:
        return x
    pad = [(0, target - r)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def pad_features_rows(features, multiple: int):
    """Row-pad a feature table (dense array or PaddedSparseFeatures) for
    mesh sharding.  Sparse padding rows get sentinel column ids (= dim)
    with zero values; no padding row is ever addressed (node ids <= N)."""
    if isinstance(features, PaddedSparseFeatures):
        idx = pad_table_rows(features.idx, multiple)
        extra = idx.shape[0] - features.idx.shape[0]
        if extra:
            idx = idx.at[-extra:].set(features.dim)
        return PaddedSparseFeatures(idx=idx,
                                    val=pad_table_rows(features.val,
                                                       multiple),
                                    dim=features.dim)
    return pad_table_rows(features, multiple)


def pad_graph_rows(graph: PaddedGraph, multiple: int) -> PaddedGraph:
    """Row-pad a PaddedGraph's node tables for mesh sharding, pinning the
    true node count in the static ``n_real`` field."""
    n = graph.num_nodes
    return PaddedGraph(nbr=pad_table_rows(graph.nbr, multiple),
                       w=pad_table_rows(graph.w, multiple),
                       deg=pad_table_rows(graph.deg, multiple),
                       n_real=n, tier_w=graph.tier_w,
                       tier_frac=graph.tier_frac)


def dense_rows(x, num_nodes: Optional[int] = None,
               dtype=jnp.float32) -> jax.Array:
    """Densify node-indexed data to [N+1, d] with a zero sentinel row."""
    if sp.issparse(x):
        x = np.asarray(x.todense())
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0] if num_nodes is None else num_nodes
    out = np.zeros((n + 1, x.shape[1]), dtype=np.dtype(dtype.dtype if
                   hasattr(dtype, "dtype") else dtype))
    out[:x.shape[0]] = x
    return jnp.asarray(out)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PaddedSparseFeatures:
    """Row-padded sparse features: X[i] = sum_j val[i,j] * e_{idx[i,j]}.

    idx: [N+1, nnz_cap] int32 column ids (sentinel = dim for empty slots).
    val: [N+1, nnz_cap] float32 values (0 for empty slots).
    ``X @ W`` becomes ``sum_j val[:, j, None] * W_ext[idx[:, j]]`` where
    ``W_ext`` is W with one zero row appended — a pure gather + reduction.
    """
    idx: jax.Array
    val: jax.Array
    dim: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.idx.shape[0] - 1, self.dim)


def pad_sparse_features(x: sp.spmatrix, nnz_cap: int = 1024,
                        num_nodes: Optional[int] = None
                        ) -> PaddedSparseFeatures:
    """Pad a sparse feature matrix row-wise, truncating rows with more than
    ``nnz_cap`` entries to the largest-|value| entries (documented deviation
    from the reference, which keeps full sparse rows host-side)."""
    x = x.tocsr()
    n = x.shape[0] if num_nodes is None else num_nodes
    dim = x.shape[1]
    nnz = np.diff(x.indptr)
    cap = int(min(nnz_cap, max(1, nnz.max() if len(nnz) else 1)))

    idx = np.full((n + 1, cap), dim, dtype=np.int32)
    val = np.zeros((n + 1, cap), dtype=np.float32)
    for r in range(x.shape[0]):
        lo, hi = x.indptr[r], x.indptr[r + 1]
        cols = x.indices[lo:hi]
        vals = x.data[lo:hi]
        if hi - lo > cap:
            keep = np.argsort(-np.abs(vals))[:cap]
            cols, vals = cols[keep], vals[keep]
        idx[r, :len(cols)] = cols
        val[r, :len(cols)] = vals
    return PaddedSparseFeatures(idx=jnp.asarray(idx), val=jnp.asarray(val),
                                dim=dim)


@dataclass
class Dataset:
    """Host-side dataset bundle; mirrors the reference ``load_data`` 10-tuple
    (gcn/utils.py:466-473)."""
    num_data: int
    train_adj: sp.csr_matrix
    full_adj: sp.csr_matrix
    feats: object            # np.ndarray or scipy sparse
    train_feats: object      # PP features over train_adj (Â_train · X)
    test_feats: object       # PP features over full_adj  (Â_full · X)
    labels: np.ndarray
    train_d: np.ndarray
    val_d: np.ndarray
    test_d: np.ndarray

    @property
    def num_classes(self) -> int:
        return self.labels.shape[1]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[1]

    def as_tuple(self):
        return (self.num_data, self.train_adj, self.full_adj, self.feats,
                self.train_feats, self.test_feats, self.labels,
                self.train_d, self.val_d, self.test_d)
