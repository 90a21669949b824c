"""Functional aggregation ops — the estimator family.

Re-implements the reference aggregators (gcn/layers.py:214-362) over the
static-shape fanout-slot representation produced by the on-device scheduler:

* sampled SpMM  ``Â_samp · X``  -> dense fanout contraction
  ``einsum('fk,fkd->fd', w, X[slot_pos])``
* full-neighborhood SpMM ``Â_full · h̄`` -> padded-row contraction over the
  device-resident graph, gathering history rows directly by node id (the
  reference's ffield/ifield indirection disappears because history lives in
  device memory at [N+1, d]).

All math matches §2.4 of SURVEY.md / gcn/layers.py:282-362 term by term.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..data.graph import FlatGraph, PaddedGraph, graph_rows
from ..parallel.halo import halo_tiles as _halo_tiles
from ..parallel.halo import owner_routed as _owner_routed
from ..parallel.halo import row_gather
from ..sampler.scheduler import LayerSample

# The two-tier full-neighborhood term engages only at fields this large:
# its compaction/cond machinery adds serial kernel latency, which the
# saved gather rows repay only once the step is gather-WORK bound (the
# same size-dependence as SORTED_SCATTER_MIN_ROWS).  Env-overridable so
# the replica acceptance-band validator can force the tiered path at
# small-graph field sizes (validate_replica.py --fadj_tier) — a perf
# gate, never a semantics switch.
TIER_MIN_ROWS = int(os.environ.get("SGT_TIER_MIN_ROWS", 4096))


def fanout_gather(x: jax.Array, slot_pos: jax.Array,
                  slot_w: jax.Array, mesh=None) -> jax.Array:
    """[C_in, d], [F, k], [F, k] -> [F, d]: out[f] = sum_s w[f,s]*x[pos[f,s]].

    The sampled-adjacency SpMM (reference: tf.sparse_tensor_dense_matmul at
    gcn/layers.py:34) in gather+contract form — static shapes, no scatter.

    With a mesh the activations are row-sharded (every field tensor comes
    out of a halo gather P('data')-sharded), and GSPMD lowers this gather
    to a masked-partials all-reduce of [F, k, d] plus an all-gather in the
    backward scatter-add — the largest wire item of the sharded step.
    Routing it through the fetch transport (parallel/halo.py::row_gather,
    which differentiates exactly: gather/scatter transpose locally,
    all_to_all is its own transpose) moves only the spill rows.
    """
    # sentinel=C: weight-masked slots are PARKED at positions >= C
    # (scheduler.PARKED_POS) and served locally as zero rows instead of
    # flooding one chip's request capacity
    g = row_gather(x, slot_pos.reshape(-1), mesh,
                   sentinel=x.shape[0])                 # [F*k, d]
    return jnp.einsum("fk,fkd->fd", slot_w,
                      g.reshape(slot_pos.shape + x.shape[1:]))


def full_neighborhood_mean_halo(hist: jax.Array, fnbr: jax.Array,
                                fw: jax.Array, mesh) -> jax.Array:
    """``Â_full · h̄`` with the history row-sharded along the node axis:
    owner-side contraction, then psum_scatter of the [F, d] partials —
    Dcap x fewer interconnect bytes than all-reducing the [F, Dcap, d]
    gather."""
    def contract(rows, mine, w_all):
        return jnp.einsum("pfk,pfkd->pfd",
                          jnp.where(mine, w_all, 0.0).astype(jnp.float32),
                          rows.astype(jnp.float32))
    return _owner_routed(hist, fnbr, (fw,), contract, mesh)


def history_gather(hist: jax.Array, ids: jax.Array, mesh=None,
                   sentinel: int = -1) -> jax.Array:
    """``h̄[ids]`` ([C, d]) from a possibly row-sharded history: routed from
    owner chips when sharded (parallel/halo.py), plain gather otherwise.
    ``sentinel``: pass the node count so sentinel-padded field ids are
    served locally as zero rows instead of flooding row N's owner chip
    (halo.py)."""
    return row_gather(hist, ids, mesh, sentinel=sentinel)


def full_neighborhood_mean(hist: jax.Array, graph: PaddedGraph,
                           field_out: jax.Array, square: bool = False,
                           mesh=None) -> jax.Array:
    """``(Â_full · h̄)[field_out]``: padded full-row contraction.

    hist: [N+1, d] device-resident history (zero sentinel row).
    Equivalent to reference ``dot(fadj, gather(hist, ffield))``
    (gcn/layers.py:355).  ``square=True`` uses squared edge weights (the
    det-dropout variance term, gcn/layers.py:338).

    On a :class:`FlatGraph` this dispatches to the edge-list enumeration
    path instead (power-law rows without max-degree padding).
    """
    if isinstance(graph, FlatGraph):
        return full_neighborhood_mean_edgelist(hist, graph, field_out,
                                               square=square, mesh=mesh)
    # mesh-aware: with a node-sharded graph the [F, Dcap] rows come from
    # their owner chips (one fused exchange); replicated graphs gather
    # locally as before
    fnbr, fw, fdeg = graph_rows(graph, field_out, mesh)
    if square:
        fw = jnp.square(fw)
    if _halo_tiles(hist, field_out, mesh):
        return full_neighborhood_mean_halo(hist, fnbr, fw, mesh)
    if (graph.tier_w > 0 and graph.tier_w <= fnbr.shape[1] - 8
            and fnbr.shape[0] >= TIER_MIN_ROWS):
        return tiered_full_contract(hist, fnbr, fw, fdeg, graph.tier_w,
                                    graph.tier_frac)
    rows = jnp.take(hist, fnbr, axis=0)               # [F, Dcap, d]
    return jnp.einsum("fk,fkd->fd", fw, rows)


def tiered_full_contract(hist: jax.Array, fnbr: jax.Array, fw: jax.Array,
                         fdeg: jax.Array, w1: int,
                         frac: float) -> jax.Array:
    """Two-tier exact contraction ``out[f] = sum_k fw[f,k] * hist[fnbr[f,k]]``.

    The history row gather is the CV step's largest gather, so padding
    every row window to the graph MAX degree is pure cost when the mean
    degree is far below it.  Split:

    * main pass — the first ``w1`` slots of every row ([F, w1] gather),
      exact for every row with degree <= w1 (CSR packs real edges first);
    * tail pass — rows with degree > w1 are compacted into a static
      ``big_cap``-row buffer and only THEY gather the remaining
      [big_cap, Dcap - w1] window, scattered back to their positions.

    If more than ``big_cap`` big rows land in one field (static capacity
    set from the degree distribution by data.graph.choose_tier, 4x safety)
    a ``lax.cond`` falls back to the full-width tail for every row — same
    result, original cost — so the value is EXACT for any batch, matching
    the untiered contraction up to sum-splitting fp reassociation.
    """
    F, dcap = fnbr.shape
    big_cap = _tier_cap(F, frac)
    main = jnp.einsum("fk,fkd->fd", fw[:, :w1],
                      jnp.take(hist, fnbr[:, :w1], axis=0))

    pos, n_big = _big_row_positions(fdeg > w1, big_cap)

    sentinel = hist.shape[0] - 1
    fnbr_p = jnp.concatenate(
        [fnbr[:, w1:], jnp.full((1, dcap - w1), sentinel, fnbr.dtype)])
    fw_p = jnp.concatenate(
        [fw[:, w1:], jnp.zeros((1, dcap - w1), fw.dtype)])

    def tail_tiered(_):
        nbr_b = jnp.take(fnbr_p, pos, axis=0)         # [big_cap, Dcap-w1]
        w_b = jnp.take(fw_p, pos, axis=0)
        tail = jnp.einsum("fk,fkd->fd", w_b,
                          jnp.take(hist, nbr_b, axis=0))
        return jnp.zeros_like(main).at[pos].add(tail, mode="drop")

    def tail_full(_):
        return jnp.einsum("fk,fkd->fd", fw[:, w1:],
                          jnp.take(hist, fnbr[:, w1:], axis=0))

    tail = jax.lax.cond(n_big <= big_cap, tail_tiered, tail_full, None)
    return main + tail


def full_neighborhood_mean_edgelist(hist: jax.Array, graph: FlatGraph,
                                    field_out: jax.Array,
                                    square: bool = False,
                                    mesh=None) -> jax.Array:
    """``(Â_full · h̄)[field_out]`` over a flat-CSR graph.

    Same contraction as the padded path, but over [F, edge_cap_per_row]
    row windows slice-gathered from the flat CSR arrays — one gather issue
    per row (see data/graph.py::flat_row_windows) with window width set by
    the edge budget (~a few x mean degree) instead of the graph's MAX
    degree.  On power-law graphs (max >> mean) this cuts both device
    memory (O(E) storage) and the history-row gathers, the CV step's
    largest — SURVEY.md §7.3 hard part #1.

    Rows with degree above the budget keep their first
    ``edge_cap_per_row`` CSR edges, RENORMALIZED to preserve row mass
    (FlatGraph.renorm — the reference's --max_degree semantics,
    gcn/utils.py:532-543; size via --fadj_edge_mult, 0 = auto-cover
    99.9% of edges).
    """
    from ..data.graph import flat_row_windows
    width = min(graph.edge_cap_per_row, graph.max_degree)
    if (graph.tier_w > 0 and graph.tier_w <= width - 8
            and field_out.shape[0] >= TIER_MIN_ROWS
            and not _halo_tiles(hist, field_out, mesh)
            and (graph.parts == 1 or mesh is None)):
        return _tiered_full_edgelist(hist, graph, field_out, width,
                                     square, mesh)
    fnbr, fw, _ = flat_row_windows(graph, field_out, width, mesh)
    fw = _apply_renorm(fw, graph, field_out)
    if square:
        fw = jnp.square(fw)
    if _halo_tiles(hist, field_out, mesh):
        # row-sharded history: same owner-routed exchange as the padded
        # layout (the window form is shape-identical)
        return full_neighborhood_mean_halo(hist, fnbr, fw, mesh)
    rows = jnp.take(hist, fnbr, axis=0)                   # [F, width, d]
    return jnp.einsum("fk,fkd->fd", fw, rows)


def _apply_renorm(fw: jax.Array, graph: FlatGraph, field: jax.Array):
    """Scale full-term window weights of budget-truncated rows so row mass
    is preserved (FlatGraph.renorm; 1.0 for untruncated rows).  Applied
    BEFORE any squaring so the squared-adjacency variants see the
    renormalized adjacency, as the reference's --max_degree subsample
    would."""
    if graph.renorm is None:
        return fw
    return fw * jnp.take(graph.renorm, field, axis=0)[:, None]


# Position-compaction lowering for the tier's big-row buffer: "topk"
# (default) = one stable lax.top_k over the flags; "cumsum" = the round-3
# cumsum+scatter chain (4 kernels).  Both pick the FIRST big_cap flagged
# positions (top_k breaks ties by ascending index), so the selected set —
# including the overflow drop set — is identical; only the kernel count
# differs.  Env-switchable for an A/B of the two lowerings.
TIER_POS_IMPL = os.environ.get("SGT_TIER_POS", "topk")


def _big_row_positions(is_big: jax.Array, big_cap: int):
    """Compact the field positions of flagged rows into a static
    [big_cap] buffer (sentinel F for unused slots); returns (pos, n_big).
    Rows past the capacity are dropped — callers guard with a lax.cond
    full-width fallback on ``n_big > big_cap``."""
    F = is_big.shape[0]
    n_big = jnp.sum(is_big.astype(jnp.int32))
    if TIER_POS_IMPL == "topk" and big_cap <= F:
        # stable top_k over the flags: flagged positions first, ties (all
        # the 1s, all the 0s) in ascending index order
        _, pos = jax.lax.top_k(is_big.astype(jnp.int32), big_cap)
        keep = jnp.arange(big_cap, dtype=jnp.int32) \
            < jnp.minimum(n_big, big_cap)
        return jnp.where(keep, pos.astype(jnp.int32), F), n_big
    rank = jnp.cumsum(is_big.astype(jnp.int32)) - 1
    slot = jnp.where(is_big, jnp.minimum(rank, big_cap), big_cap)
    pos = jnp.full((big_cap + 1,), F, jnp.int32) \
        .at[slot].set(jnp.arange(F, dtype=jnp.int32))[:big_cap]
    return pos, n_big


def _tier_cap(F: int, frac: float) -> int:
    # smallest multiple of 8 covering F*frac rows (frac already carries
    # choose_tier's safety margin), clamped to [8, F]
    return max(8, min(F, (int(F * frac) + 7) // 8 * 8))


def _tiered_full_edgelist(hist: jax.Array, graph: FlatGraph,
                          field_out: jax.Array, width: int, square: bool,
                          mesh) -> jax.Array:
    """Two-tier exact window contraction over a FlatGraph — the edgelist
    counterpart of :func:`tiered_full_contract`: [F, tier_w] main windows
    for every row, a [big_cap, width - tier_w] offset tail window
    (flat_row_windows ``start=tier_w``) for the few rows with degree >
    tier_w, lax.cond full-width tail on capacity overflow."""
    from ..data.graph import flat_row_windows
    w1 = graph.tier_w

    def contract(w, nbr, rows):
        w = _apply_renorm(w, graph, rows)
        if square:
            w = jnp.square(w)
        return jnp.einsum("fk,fkd->fd", w, jnp.take(hist, nbr, axis=0))

    fnbr1, fw1, fdeg = flat_row_windows(graph, field_out, w1, mesh)
    main = contract(fw1, fnbr1, field_out)

    F = field_out.shape[0]
    big_cap = _tier_cap(F, graph.tier_frac)
    is_big = jnp.minimum(fdeg, width) > w1
    pos, n_big = _big_row_positions(is_big, big_cap)
    field_p = jnp.concatenate(
        [field_out.astype(jnp.int32),
         jnp.array([graph.num_nodes], jnp.int32)])     # sentinel: empty row

    def tail_tiered(_):
        ids_b = jnp.take(field_p, pos, axis=0)
        nbr_b, w_b, _ = flat_row_windows(graph, ids_b, width - w1, mesh,
                                         start=w1)
        return jnp.zeros_like(main).at[pos].add(
            contract(w_b, nbr_b, ids_b), mode="drop")

    def tail_full(_):
        nbr2, w2, _ = flat_row_windows(graph, field_out, width - w1, mesh,
                                       start=w1)
        return contract(w2, nbr2, field_out)

    tail = jax.lax.cond(n_big <= big_cap, tail_tiered, tail_full, None)
    return main + tail


"""Chunk size (node rows per lax.map step) for the bulk a-bar recompute:
bounds the [chunk, Dcap, d] gather transient (~128 MB at Dcap=d=128 bf16)
while keeping each chunk large enough to be gather-WORK bound."""
ABAR_CHUNK = int(os.environ.get("SGT_ABAR_CHUNK", 4096))


def full_abar(hist: jax.Array, graph, num_nodes: int,
              square: bool = False, chunk: int = 0) -> jax.Array:
    """``A_full · h̄`` for EVERY node — the epoch-frozen aggregate table of
    ``--lazy_fullterm`` (cfg.lazy_fullterm).

    One bulk SpMM over all N rows, chunked with ``lax.map`` so the
    [chunk, Dcap, d] row-gather transient stays bounded; each chunk reuses
    :func:`full_neighborhood_mean` (padded / edgelist / tiered dispatch
    identical to the per-step term, so the table is exactly what the
    per-step contraction would produce for those rows).  Returns
    [R, d] float32 (R = hist rows incl. sentinel padding); rows >= N hold
    the sentinel row's zeros.  ``square=True`` builds the squared-adjacency
    table for the det-dropout variance term (gcn/layers.py:338)."""
    chunk = chunk or ABAR_CHUNK
    r = hist.shape[0]
    rp = -(-r // chunk) * chunk
    ids = jnp.arange(rp, dtype=jnp.int32)
    ids = jnp.where(ids < num_nodes, ids, num_nodes)
    out = jax.lax.map(
        lambda c: full_neighborhood_mean(hist, graph, c, square=square),
        ids.reshape(rp // chunk, chunk))
    return out.reshape(rp, -1)[:r]


def _anchor(history, lazy_l, j: int):
    """The CV anchor table for history array ``j`` of this layer: the live
    table, or the epoch-start snapshot under --lazy_fullterm (both CV
    terms must read the SAME h̄ or the estimator picks up a staleness
    bias — see Config.lazy_fullterm)."""
    return history[j] if lazy_l is None else lazy_l[0][j]


def _full_term(history, lazy_l, j: int, graph, field_out, square=False,
               mesh=None):
    """``(A_full · h̄)[field_out]``: the per-step contraction, or one row
    gather of the precomputed a-bar table under --lazy_fullterm."""
    if lazy_l is None:
        return full_neighborhood_mean(history[j], graph, field_out,
                                      square=square, mesh=mesh)
    return jnp.take(lazy_l[1][j], field_out, axis=0)


def ema_aggregate(inputs, ls: LayerSample, field_in: jax.Array,
                  history: Tuple[jax.Array, ...], alpha: float,
                  normalization: str):
    """EMAAggregator (gcn/layers.py:260-279): exponential-moving-average
    blend of the sampled aggregation with history.  Unused by the reference
    drivers but part of its op surface; provided for completeness.

    Z = alpha * Â_samp·H + (1-alpha) * h̄[field_out];  new history = Z.

    The returned history follows the scatter contract of
    ``scatter_histories`` (training/step.py): rows for the INPUT field
    ([C_in, d], scattered at ``field_in``) — output-field nodes take the
    new EMA value Z at their input-field positions, the rest rewrite
    their current history value unchanged.  (The reference's own
    EMAAggregator never reaches a session run, so this contract is ours.)
    """
    a_hat = fanout_gather(inputs, ls.slot_pos, ls.slot_w)
    hist_rows = jnp.take(history[0], _self_rows(field_in, ls), axis=0)
    a_nbr = a_hat * alpha + hist_rows * (1.0 - alpha)
    base = jnp.take(history[0], field_in, axis=0).astype(a_nbr.dtype)
    if ls.self_pos is None:
        new_hist = jnp.concatenate(
            [a_nbr, base[a_nbr.shape[0]:]], axis=0)
    else:
        new_hist = base.at[ls.self_pos].set(a_nbr)
    return (_self_concat(normalization, _self_rows(inputs, ls), a_nbr),
            (new_hist,))


def _self_concat(normalization: str, self_part, nbr_part):
    if normalization == "gcn":
        return nbr_part
    return jnp.concatenate((self_part, nbr_part), axis=1)


def _self_rows(x: jax.Array, ls: LayerSample, mesh=None) -> jax.Array:
    """The OUTPUT field's rows of an input-field tensor: the ``[:F_out]``
    prefix under the classic field layout (scheduler.cpp:48-52 invariant),
    a position gather under the owner-aligned layout
    (scheduler.py::compact_field_aligned, LayerSample.self_pos).

    Under the owner-aligned layout every id sits in its owner chip's
    positional block of BOTH fields, so the position gather is ~100%
    self-local — the fetch-routed transport keeps it off the interconnect,
    where the GSPMD lowering all-reduces the full [F, d] result."""
    if ls.self_pos is None:
        return x[:ls.slot_pos.shape[0]]
    return row_gather(x, ls.self_pos, mesh, sentinel=x.shape[0])


def plain_aggregate(inputs, ls: LayerSample, normalization: str, mesh=None):
    """PlainAggregator (gcn/layers.py:214-257): Z = Â_samp·H, with self
    concat under graphsage normalization and a (mu, var) moment branch that
    squares the adjacency for the variance."""
    if isinstance(inputs, tuple):
        mu, var = inputs
        mu_n = fanout_gather(mu, ls.slot_pos, ls.slot_w, mesh)
        var_n = fanout_gather(var, ls.slot_pos, jnp.square(ls.slot_w), mesh)
        if normalization == "gcn":
            return mu_n, var_n
        return (jnp.concatenate((_self_rows(mu, ls, mesh), mu_n), axis=1),
                jnp.concatenate((_self_rows(var, ls, mesh), var_n), axis=1))
    nbr = fanout_gather(inputs, ls.slot_pos, ls.slot_w, mesh)
    return _self_concat(normalization, _self_rows(inputs, ls, mesh), nbr)


def vr_aggregate(inputs, ls: LayerSample, field_in: jax.Array,
                 field_out: jax.Array, graph: PaddedGraph,
                 history: Tuple[jax.Array, ...], cvd: bool,
                 normalization: str, mesh=None, lazy_l=None):
    """VRAggregator (gcn/layers.py:282-362).

    Returns (outputs, new_history) where new_history is a tuple of arrays
    defined on the INPUT field rows ([C_in, d]) to be scattered back at
    ``field_in`` after the optimizer step (gcn/models.py:160-166,186-191).

    Three branches, dispatched exactly like the reference:
      cvd         — dual-stream (h, mu) with per-node 1/sqrt scale
      (mu, var)   — det_dropout moment propagation with squared/cross adj
      plain       — CV: Â_samp·(H - h̄) + Â_full·h̄

    ``lazy_l``: epoch-frozen anchor for this layer under --lazy_fullterm —
    ``(snapshot history tuple, a-bar table tuple)``; both CV terms read
    the snapshot and the full term becomes a row gather of a-bar
    (see Config.lazy_fullterm).
    """
    if cvd:
        h, mu = inputs
        mu_small = history_gather(_anchor(history, lazy_l, 0), field_in,
                                  mesh, graph.num_nodes)  # h̄ on in-field
        z = h - mu
        delta_mu = mu - mu_small
        mu_mean = _full_term(history, lazy_l, 0, graph, field_out,
                             mesh=mesh)
        mu_neighbour = fanout_gather(delta_mu, ls.slot_pos, ls.slot_w,
                                     mesh) + mu_mean
        h_neighbour = fanout_gather(z, ls.slot_pos, ls.slot_w, mesh) \
            * ls.scales[:, None] + mu_neighbour
        new_history = (mu,)
        if normalization == "gcn":
            return (h_neighbour, mu_neighbour), new_history
        return ((jnp.concatenate((_self_rows(h, ls, mesh), h_neighbour),
                                 axis=1),
                 jnp.concatenate((_self_rows(mu, ls, mesh), mu_neighbour),
                                 axis=1)),
                new_history)

    if isinstance(inputs, tuple):
        # det_dropout: (mu, var) moments (gcn/layers.py:320-349)
        mu, var = inputs

        delta_mu = mu - history_gather(_anchor(history, lazy_l, 0),
                                       field_in, mesh, graph.num_nodes)
        sigma = jnp.sqrt(var)
        sigma_bar = jnp.sqrt(history_gather(_anchor(history, lazy_l, 1),
                                            field_in, mesh,
                                            graph.num_nodes))
        delta_sigma = sigma - sigma_bar
        msigma = delta_sigma * sigma_bar

        mu_neighbour = fanout_gather(delta_mu, ls.slot_pos, ls.slot_w,
                                     mesh) \
            + _full_term(history, lazy_l, 0, graph, field_out, mesh=mesh)
        var_neighbour = (
            fanout_gather(jnp.square(delta_sigma), ls.slot_pos,
                          jnp.square(ls.slot_w), mesh)
            + _full_term(history, lazy_l, 1, graph, field_out,
                         square=True, mesh=mesh)
            + 2.0 * fanout_gather(msigma, ls.slot_pos, ls.slot_aw, mesh))
        var_neighbour = jax.nn.relu(var_neighbour) + 1e-10

        new_history = (mu, var)
        if normalization == "gcn":
            return (mu_neighbour, var_neighbour), new_history
        return ((jnp.concatenate((_self_rows(mu, ls, mesh), mu_neighbour),
                                 axis=1),
                 jnp.concatenate((_self_rows(var, ls, mesh), var_neighbour),
                                 axis=1)),
                new_history)

    # plain CV (gcn/layers.py:350-362):
    #   Z = Â_samp·(H - h̄[field_in]) + Â_full·h̄
    # (the reference computes Â·H - Â·h̄ as two SpMMs; fused here — same
    # linear algebra, half the gather traffic)
    delta = inputs - history_gather(_anchor(history, lazy_l, 0),
                                    field_in, mesh, graph.num_nodes)
    a_neighbour = fanout_gather(delta, ls.slot_pos, ls.slot_w, mesh) \
        + _full_term(history, lazy_l, 0, graph, field_out, mesh=mesh)
    new_history = (inputs,)
    return (_self_concat(normalization, _self_rows(inputs, ls, mesh),
                         a_neighbour),
            new_history)
