"""On-device receptive-field scheduler.

Device-side re-design of the reference's host-side C++ scheduler
(gcn/scheduler.cpp, driven by gcn/_scheduler.pyx).  Instead of walking CSR
rows on the CPU and feed-dict'ing variable-size COO adjacencies to the device
every step, the whole layer-by-layer receptive-field expansion runs inside the
jitted training step over the device-resident :class:`PaddedGraph`:

* **Uniform fanout sampling without replacement** — top-k of iid uniforms over
  each padded row selects a uniformly random k-subset, matching the partial
  Fisher-Yates semantics of scheduler.cpp:140-147.  Edge weights are rescaled
  by ``deg/|sampled|`` (scheduler.cpp:130-134) so the estimator is unbiased,
  and per-node CVD scales are ``1/sqrt(deg/|sampled|)``.
* **Importance sampling** — Gumbel top-k over the neighbor union, which draws
  from the same successive-sampling-without-replacement distribution as the
  reference's Fenwick-tree ``Mult`` (gcn/mult.cpp); weights follow
  scheduler.cpp:103-117.
* **Field compaction** — static-capacity dedup replacing the reference's
  ``visited`` hash maps (scheduler.cpp:48-52,148-151).  The output field is a
  *prefix* of the input field (self nodes first) — the same prefix invariant
  the reference's aggregators rely on — with newly-discovered nodes appended
  in node-id order.  Shapes are fully static: a layer with out-capacity F and
  fanout k has in-capacity ``F + min(F*k, N)``.
* **Sentinel padding** — absent slots/nodes use id ``N``; features, labels
  and history all carry a zero row ``N`` so padded gathers are free, and all
  padded edges carry weight 0.

Unlike the reference there is no ``ffield``/``ifield`` indirection: history is
addressed directly by node id ([N+1, d] resident on the device), so the CV
full-neighborhood term reads graph rows + history rows with plain gathers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..data.graph import FlatGraph, PaddedGraph, graph_rows


# Parked position for weight-masked slots (sentinel-neighbor pads,
# unselected IS slots): any value >= the field capacity.  The halo fetch
# transport serves positions >= its sentinel locally as zero rows
# (parallel/halo.py) — without parking, every chip's masked slots would
# all point at ONE real position (0, or pos_table[N]) and flood that
# position's owner chip's static request capacity.  Single-chip gathers
# clamp it to the last row, which the zero slot weight masks exactly as
# before.
PARKED_POS = 1 << 30


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LayerSample:
    """Sampled adjacency from field l (input) to field l+1 (output).

    Equivalent of one (adj, madj, scales) triple in the reference feed dict
    (gcn/_scheduler.pyx:81-119), in dense fanout-slot form:

      slot_pos: [F_out, k] int32 — position of each sampled neighbor in the
                INPUT field (compacted), i.e. local column index of the edge.
      slot_w:   [F_out, k] f32   — rescaled edge weight (0 = masked slot).
      slot_aw:  [F_out, k] f32   — a_uv * w_uv cross-term weights (madj,
                scheduler.cpp:163-164); zeros-shaped only when requested.
      scales:   [F_out] f32      — 1/sqrt(deg/k_eff) (scheduler.cpp:132-134).
      self_pos: [F_out] int32    — position of each OUTPUT-field node inside
                the input field.  None under the classic prefix layout
                (where it is trivially arange(F_out)); set by the
                owner-aligned layout (compact_field_aligned), where the
                output field is NOT a prefix of the input field.
    """
    slot_pos: jax.Array
    slot_w: jax.Array
    slot_aw: Optional[jax.Array]
    scales: jax.Array
    self_pos: Optional[jax.Array] = None


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BatchFields:
    """All per-minibatch sampling artifacts.

    fields[0] is the input side, fields[-1] the batch (reference ordering
    after the reversal in _scheduler.pyx:121-126).  layers[l] maps
    fields[l] -> fields[l+1].

    ``is_dropped`` counts IS slot-cap drops (is_slot_compact) summed over
    layers; always a scalar (0 when the cap is off / non-IS)."""
    fields: Tuple[jax.Array, ...]
    layers: Tuple[LayerSample, ...]
    is_dropped: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))


def field_capacities(batch_size: int, degrees: Sequence[int], num_nodes: int,
                     pad_degree: int, importance: bool = False,
                     round_multiple: int = 1, dedup: bool = True) -> list[int]:
    """Static field capacities, input side first (index 0 = layer-0 field).

    ``round_multiple`` rounds every capacity up to a multiple (sentinel
    padding makes this free) so field tensors tile evenly over a
    ``round_multiple``-way mesh — otherwise the halo-exchange lowering in
    models/aggregators.py silently falls back to GSPMD's all-gather path
    whenever the ``min(f*k, num_nodes)`` clamp produces a non-dividing
    capacity.

    ``dedup=False`` (cfg.field_dedup off) sizes fields for the append-only
    no-dedup layout: every sampled slot keeps its own position, so the
    capacity is exactly ``f + f*k`` without the ``num_nodes`` clamp —
    identical to the dedup capacity whenever ``f*k <= num_nodes``."""
    m = max(1, int(round_multiple))
    caps = [batch_size]
    # walk top-down (reference expands degrees[L-1], ..., degrees[0])
    for degree in reversed(list(degrees)):
        k = degree if importance else min(degree, pad_degree)
        f = caps[-1]
        new = f * k if not dedup else min(f * k, num_nodes)
        caps.append(-(-(f + new) // m) * m)
    caps.reverse()
    return caps


def effective_dedup(dedup: bool, batch_size: int, degrees: Sequence[int],
                    num_nodes: int, pad_degree: int,
                    importance: bool = False, mesh=None,
                    owner_blocks: int = 0) -> bool:
    """Whether fields are dedup-compacted this run (trace-time decision).

    The no-dedup (append-only) layout is only active when nothing forces
    compaction: importance sampling (slots address selected union members
    by id), owner-ALIGNED layouts (positional ownership blocks are
    compaction by construction), or any layer whose candidate count
    ``f*k`` exceeds ``2*num_nodes`` — past that point the dedup capacity
    clamp ``min(f*k, N)`` saves >2x field rows (and the dense-layer FLOPs
    that ride them), and append-only capacities grow combinatorially
    instead (Exact mode at Reddit scale would need millions of field
    rows, where the clamp caps them at N).  Below the threshold the
    layouts' capacity difference is at most 2x and the append layout's
    skipped compaction passes win.

    A plain (non-owner-aligned) mesh no longer forces dedup the
    owner-routed transports handle duplicate
    field rows mechanically — fetch gathers repeat the row per request
    slot, the history scatter races duplicates to the documented
    last-write semantics (training/step.py), and AD accumulates duplicate
    contributions through the all_to_all transpose exactly as a local
    scatter-add would — so the sharded step sheds the same O(N)
    compaction passes the single-chip step shed in round 3
    (tests/test_parallel.py::test_sharded_nodedup_matches_replicated).

    Used by both :func:`schedule` and the history-scatter uniqueness
    contract (training/step.py) so they can never disagree."""
    if dedup or importance or owner_blocks > 1:
        return True
    f = batch_size
    for degree in reversed(list(degrees)):
        k = min(degree, pad_degree)
        if f * k > 2 * num_nodes:
            return True
        f = f + f * k
    return False


def compute_importance(graph) -> jax.Array:
    """Per-node importance = 1e-6 + sum of squared in-edge weights
    (scheduler.cpp:21-26)."""
    n1 = graph.num_nodes + 1
    if isinstance(graph, FlatGraph):
        imp = jnp.zeros(n1, jnp.float32).at[graph.idx].add(
            jnp.square(graph.w))
    else:
        imp = jnp.zeros(n1, jnp.float32).at[graph.nbr.reshape(-1)].add(
            jnp.square(graph.w).reshape(-1))
    imp = imp + 1e-6
    return imp.at[n1 - 1].set(1e-6)


def expand_uniform(key: jax.Array, graph: PaddedGraph, field_out: jax.Array,
                   degree: int, need_aw: bool, mesh=None):
    """Sample <= ``degree`` neighbors/node uniformly without replacement.

    Returns (nbr_id [F,k], slot_w [F,k], slot_aw, scales [F]).
    """
    dcap = graph.pad_degree
    rows_nbr, rows_w, deg = graph_rows(graph, field_out, mesh)  # [F, Dcap]
    f = field_out.shape[0]
    k = min(degree, dcap)

    if k >= dcap:
        nbr_id, base_w = rows_nbr, rows_w
    else:
        if k == 1:
            # degree-1 fast path: a single without-replacement draw IS a
            # uniform pick over the deg valid slots, so ONE uniform per
            # row suffices — no [F, Dcap] uniform tensor, no argmax
            # (262k threefry evals -> 4k at batch 4096)
            u = jax.random.uniform(key, (f,))
            sel = jnp.minimum(
                (u * deg.astype(jnp.float32)).astype(jnp.int32),
                jnp.maximum(deg - 1, 0))[:, None]
        else:
            u = jax.random.uniform(key, (f, dcap))
            valid = (jnp.arange(dcap, dtype=jnp.int32)[None, :]
                     < deg[:, None])
            u = jnp.where(valid, u, -1.0)
            _, sel = jax.lax.top_k(u, k)       # [F, k] distinct slots
        nbr_id = jnp.take_along_axis(rows_nbr, sel, axis=1)
        base_w = jnp.take_along_axis(rows_w, sel, axis=1)

    adj_size = jnp.minimum(deg, k)
    scale = jnp.where(deg == 0, 1.0,
                      deg.astype(jnp.float32)
                      / jnp.maximum(adj_size, 1).astype(jnp.float32))
    slot_w = base_w * scale[:, None]
    slot_aw = base_w * slot_w if need_aw else None
    scales = jax.lax.rsqrt(scale)
    return nbr_id, slot_w, slot_aw, scales


def importance_row_table(graph, importance: jax.Array):
    """[N+1, Dcap] table of ``importance[graph.nbr]`` — the per-epoch hoist
    of the IS path's per-slot importance lookup.  Inside the step the
    lookup is then F row-window gathers instead of F·Dcap scalar-issue
    element gathers.  Superseded by the fused is_slots packed gather (the
    default path), so --is_row_table survives as the legacy comparison
    arm.  Costs one transient [N, Dcap] f32 for the epoch (+50% of the
    padded graph's memory).
    Padded-graph layout only (the edgelist path has no slot table)."""
    if not isinstance(graph, PaddedGraph):
        return None
    return jnp.take(importance, graph.nbr, axis=0)


class ISSelection(NamedTuple):
    """Intermediate state of one IS expansion: the gathered neighbor rows
    and the Gumbel-top-k selection over their union (see is_select)."""
    rows_nbr: jax.Array   # [F, Dcap] neighbor ids (sentinel-padded)
    rows_w: jax.Array     # [F, Dcap] edge weights
    valid: jax.Array      # [F, Dcap] bool in-degree mask
    sel_ids: jax.Array    # [n_cap] selected union members (sentinel-padded)
    selected: jax.Array   # [N+1] bool membership table
    total_imp: jax.Array  # scalar, sum of importance over the union
    n_samples: jax.Array  # scalar f32, actual sample count


def is_select(key: jax.Array, graph: PaddedGraph, field_out: jax.Array,
              degree: int, importance: jax.Array,
              mesh=None) -> ISSelection:
    """Selection half of importance sampling (scheduler.cpp:63-122): gather
    the field's neighbor rows, form the union, draw ``n = min(|field|*degree,
    |union|)`` members without replacement via Gumbel top-k.  Slot weights /
    positions are derived afterwards by :func:`is_slots` (fused) or
    :func:`expand_importance` (legacy per-slot gathers)."""
    n = graph.num_nodes
    dcap = graph.pad_degree
    rows_nbr, rows_w, deg = graph_rows(graph, field_out, mesh)
    valid = (jnp.arange(dcap, dtype=jnp.int32)[None, :] < deg[:, None])

    union = jnp.zeros(n + 1, bool).at[
        jnp.where(valid, rows_nbr, n)].set(True).at[n].set(False)
    total_imp = jnp.sum(jnp.where(union, importance, 0.0))

    f_true = jnp.sum(field_out < n)
    union_size = jnp.sum(union)
    n_samples = jnp.minimum(f_true * degree, union_size).astype(jnp.float32)
    n_cap = min(field_out.shape[0] * degree, n)

    g = jax.random.gumbel(key, (n + 1,))
    score = jnp.where(union, jnp.log(importance) + g, -jnp.inf)
    _, top_ids = jax.lax.top_k(score, n_cap)
    rank_ok = jnp.arange(n_cap) < n_samples
    sel_ids = jnp.where(rank_ok & union[top_ids], top_ids, n)
    selected = jnp.zeros(n + 1, bool).at[sel_ids].set(True).at[n].set(False)
    return ISSelection(rows_nbr, rows_w, valid, sel_ids, selected,
                       total_imp, n_samples)


def is_slots(sel: ISSelection, importance: jax.Array,
             pos_table: jax.Array):
    """Fused IS slot computation: ONE [F, Dcap] row gather of a packed
    [N+1, 2] table replaces THREE element gathers of the legacy path
    (``selected[rows_nbr]`` membership test, ``importance[rows_nbr]``
    inverse weights, ``pos_table[nbr_id]`` positions): one gather issued
    per slot instead of three.

    Column 0 holds the full slot-weight multiplier
    ``total_imp / (importance_v * n_samples)`` for selected nodes (0
    otherwise — doubling as the membership test; selected nodes always have
    finite positive weight since score ``log(imp) + g`` is finite).  Column
    1 holds the node's field position as raw int32 bits (bitcast, exact for
    any N).  Weight arithmetic is bit-identical to the legacy path: the
    same operands divide per NODE here instead of per slot."""
    inv_col = jnp.where(
        sel.selected,
        sel.total_imp / (importance * jnp.maximum(sel.n_samples, 1.0)),
        0.0)
    pos_col = jax.lax.bitcast_convert_type(pos_table.astype(jnp.int32),
                                           jnp.float32)
    packed = jnp.stack([inv_col, pos_col], axis=-1)          # [N+1, 2]
    got = packed[sel.rows_nbr]                               # [F, Dcap, 2]
    inv = got[..., 0]
    pos = jax.lax.bitcast_convert_type(got[..., 1], jnp.int32)
    tgt_sel = (inv > 0.0) & sel.valid
    slot_w = jnp.where(tgt_sel, sel.rows_w * inv, 0.0)
    # weight-masked slots' positions are only ever dereferenced under the
    # weight-0 mask; PARKED_POS keeps them off the halo fetch transport
    # (criterion slot_w == 0, matching the legacy expand_importance path
    # bit-for-bit — test_importance_row_table_equivalent)
    slot_pos = jnp.where(slot_w != 0.0, pos, PARKED_POS)
    return slot_pos, slot_w


def expand_importance(key: jax.Array, graph: PaddedGraph,
                      field_out: jax.Array, degree: int,
                      importance: jax.Array, mesh=None,
                      importance_rows: Optional[jax.Array] = None):
    """Importance sampling over the neighbor union (scheduler.cpp:63-122).

    Samples ``n = min(|field|*degree, |union|)`` nodes from the union of
    neighbors with probability proportional to importance, without
    replacement (Gumbel top-k == successive sampling).  Every graph edge into
    a selected node is kept with weight ``a_uv * total_imp / (imp_v * n)``.
    Returns slots in [F, Dcap] masked form plus the selected-id list used for
    field compaction.

    This is the LEGACY per-slot-gather slot computation; production
    ``schedule()`` uses :func:`is_select` + :func:`is_slots` (one fused
    gather) unless an ``importance_rows`` table is supplied."""
    n = graph.num_nodes
    f = field_out.shape[0]
    sel = is_select(key, graph, field_out, degree, importance, mesh=mesh)

    tgt_sel = sel.selected[sel.rows_nbr] & sel.valid
    if importance_rows is not None:
        # per-epoch [N+1, Dcap] row table (importance_row_table): one
        # row-window gather instead of F*Dcap element gathers
        from ..parallel.halo import row_gather
        imp_nbr = row_gather(importance_rows, field_out, mesh,
                             sentinel=graph.num_nodes)
    else:
        imp_nbr = importance[sel.rows_nbr]
    inv = sel.total_imp / (imp_nbr * jnp.maximum(sel.n_samples, 1.0))
    slot_w = jnp.where(tgt_sel, sel.rows_w * inv, 0.0)
    nbr_id = jnp.where(tgt_sel, sel.rows_nbr, n)
    scales = jnp.ones((f,), jnp.float32)
    return nbr_id, slot_w, scales, sel.sel_ids


def is_slot_compact(slot_pos: jax.Array, slot_w: jax.Array, cap: int):
    """Compact IS slots [F, Dcap] -> [F, cap], keeping each row's ``cap``
    highest-weight selected slots (cfg.is_slot_cap).

    The reference keeps EVERY graph edge into a selected union member
    (scheduler.cpp:118-121), which in slot form means the whole [F, Dcap]
    row participates in the downstream fanout gather — [F·Dcap] activation
    rows where uniform degree-1 sampling gathers [F·1] (the dominant IS
    cost at scale).  With n ≈ F·degree selected
    nodes out of a much larger union, the EXPECTED selected slots per row
    is ~Dcap·n/|union| (< 2 at the Reddit recipe), so a small static cap
    covers almost every row; rows with more selected slots than ``cap``
    drop their lowest-weight edges (counted in the returned scalar and
    surfaced as the ``is_dropped`` metric) — a bounded, observable
    deviation from reference semantics, off by default (cap 0).

    Weights are nonnegative (normalized adjacency x positive IS weights),
    so top_k picks selected slots before masked zeros; masked slots keep
    in-range positions for the downstream gather."""
    dcap = slot_w.shape[1]
    if cap <= 0 or cap >= dcap:
        return slot_pos, slot_w, jnp.zeros((), jnp.int32)
    w_top, idx = jax.lax.top_k(slot_w, cap)
    pos = jnp.take_along_axis(slot_pos, idx, axis=1)
    n_sel = jnp.sum((slot_w > 0).astype(jnp.int32))
    n_kept = jnp.sum((w_top > 0).astype(jnp.int32))
    return pos, w_top, n_sel - n_kept


def compact_field(field_out: jax.Array, new_ids: jax.Array, num_nodes: int,
                  capacity: int):
    """Dedup-compact ``field_out ++ new_ids`` into a static-capacity field.

    The output field occupies positions [0, F) (prefix invariant,
    scheduler.cpp:48-52); new unique ids get positions F + rank in node-id
    order.  Returns (field_in [capacity], pos_table [N+1]) where
    ``pos_table[id]`` is the position of ``id`` in field_in (0 for ids not in
    the field — only ever dereferenced under weight-0 masks).

    Design note: the O(N) tables here (cumsum + masks over 233k nodes on
    the bench graph) are DELIBERATE, chosen over a candidate-sized
    sort/searchsorted rewrite: wide elementwise/cumsum passes are
    bandwidth-trivial single kernels, while a chain of small sorts +
    binary searches is latency-bound, one dependent op after another
    inside a scan.
    """
    n = num_nodes
    f = field_out.shape[0]
    cand = new_ids.reshape(-1)
    arange_f = jnp.arange(f, dtype=jnp.int32)
    # ONE mask buffer: set candidates, then clear already-seen (field_out)
    # and sentinel rows — equivalent to occurs & ~seen with one fewer O(N)
    # scatter + AND pass
    new_mask = (jnp.zeros(n + 1, bool).at[cand].set(True)
                .at[field_out].set(False).at[n].set(False))
    cum = jnp.cumsum(new_mask.astype(jnp.int32))
    pos_table = jnp.zeros(n + 1, jnp.int32).at[field_out].set(arange_f)
    pos_table = jnp.where(new_mask, f + cum - 1, pos_table)

    # Invert rank -> node id with a CANDIDATE-sized scatter: new candidate
    # v has rank cum[v]-1 among new ids, so scatter each new candidate to
    # its rank slot (duplicates carry identical values; min is a safe
    # dedup).  ~3 candidate-sized ops instead of a binary search whose
    # log2(N) ≈ 18 dependent element gathers PER RANK (~18·F lookups).
    is_new = jnp.take(new_mask, cand)
    rank = jnp.take(cum, cand) - 1
    tgt = jnp.where(is_new, rank, capacity - f)          # OOB -> dropped
    new_by_rank = jnp.full((capacity - f,), n, jnp.int32).at[tgt].min(
        cand.astype(jnp.int32), mode="drop")
    field_in = jnp.concatenate([field_out, new_by_rank])
    return field_in, pos_table


def append_field(field_out: jax.Array, new_ids: jax.Array, num_nodes: int,
                 capacity: int):
    """No-dedup field layout (cfg.field_dedup off): the input field is
    literally ``field_out ++ new_ids.ravel()`` (sentinel-padded to
    ``capacity``), every sampled slot owning its own position —
    ``slot_pos[f, j] = F + f*k + j`` is a trace-time iota, so the O(N)
    cumsum/mask compaction passes of :func:`compact_field` (the
    scheduler's dominant cost) vanish from the step.

    Duplicate node ids occupy multiple positions, each expanding its OWN
    neighbor sample (and dropout mask) in the layers below — independent
    iid estimates of the same activation, where dedup (the reference's
    `visited` map, scheduler.cpp:48-52) shares one sample per node.  Same
    estimator expectation, a documented variance-structure deviation; the
    values coincide exactly only when expansion is exhaustive (Exact
    mode / degree >= max_degree, dropout off).  Compute cost is unchanged
    at static capacities whenever ``F*k <= N`` (the dedup capacity's
    clamp never bound, so the dense layers run over the same row count
    either way).  The prefix invariant holds by construction.

    Returns (field_in [capacity], slot_pos [F, k])."""
    n = num_nodes
    f, k = new_ids.shape
    flat = new_ids.reshape(-1).astype(jnp.int32)
    pad = capacity - field_out.shape[0] - flat.shape[0]
    parts = [field_out, flat]
    if pad:
        parts.append(jnp.full((pad,), n, jnp.int32))
    field_in = jnp.concatenate(parts)
    slot_pos = (field_out.shape[0]
                + jnp.arange(f * k, dtype=jnp.int32).reshape(f, k))
    return field_in, slot_pos


def compact_field_aligned(field_out: jax.Array, new_ids: jax.Array,
                          num_nodes: int, capacity: int, owner_blocks: int):
    """Owner-ALIGNED variant of :func:`compact_field` (cfg.owner_batching).

    Positions are divided into ``owner_blocks`` equal blocks of
    ``capacity/P``; block q holds the field ids OWNED by chip q's history
    shard (contiguous-id row-sharding, parallel/mesh.py::shard_rows), in
    ascending id order, sentinel-padded.  Because sharded tensors split
    into positional chunks of F/P per chip, this makes every chip's chunk
    of the field (and of everything laid out on field positions: history
    update rows, delta-gather requests) consist of rows that chip OWNS —
    the halo scatter's self-bypass then applies them locally and the
    cross-chip history traffic collapses to the spill.

    Ids overflowing their owner's block spill into other blocks' free
    slots (remote but correct — never dropped), so the field content is
    the same id SET as the classic layout; only positions differ.  The
    output field is NOT a prefix of the input field here — consumers use
    ``LayerSample.self_pos`` instead of ``[:F_out]``.

    Cost: 3 O(N) cumsum/elementwise passes vs the classic 1 — wide O(N)
    passes are bandwidth-trivial (see compact_field's design note).
    """
    n = num_nodes
    p = owner_blocks
    cap_b = capacity // p
    from ..parallel.mesh import shard_rows
    n_loc = shard_rows(n, p) // p

    cand = jnp.concatenate(
        [field_out, new_ids.reshape(-1)]).astype(jnp.int32)     # [C]
    present = (jnp.zeros(n + 1, bool)
               .at[cand].set(True)
               .at[n].set(False))
    cum = jnp.cumsum(present.astype(jnp.int32))      # inclusive id ranks
    # present-id count before each ownership block (last block runs to n)
    edges = jnp.minimum(jnp.arange(1, p) * n_loc - 1, n)
    cnt_before = jnp.concatenate(
        [jnp.zeros(1, cum.dtype), cum[edges], cum[-1:]])        # [p+1]
    count_q = cnt_before[1:] - cnt_before[:-1]
    used_q = jnp.minimum(count_q, cap_b)

    s = jnp.arange(capacity, dtype=jnp.int32)
    qs = s // cap_b
    r = s % cap_b
    main_ok = r < used_q[qs]

    # Rank -> slot inversion by CANDIDATE-sized scatters (same design as
    # compact_field: the old per-slot searchsorted did log2(N) dependent
    # element gathers for each of `capacity` slots, twice).  A present
    # candidate with within-block rank rw (1-based) lands at slot
    # own*cap_b + rw-1 when rw <= cap_b; duplicates carry identical
    # values, so .min dedups.
    is_p = jnp.take(present, cand)
    own_c = jnp.minimum(cand // n_loc, p - 1)
    g = jnp.take(cum, cand)                          # global rank, 1-based
    rw = g - jnp.take(cnt_before, own_c)
    main_tgt = jnp.where(is_p & (rw <= cap_b),
                         own_c * cap_b + rw - 1, capacity)
    field_in = jnp.full((capacity,), n, jnp.int32).at[main_tgt].min(
        cand, mode="drop")

    # overflow ids (within-block rank past the block cap) -> free slots,
    # ascending ov rank into ascending free-slot order
    own = jnp.minimum(jnp.arange(n + 1, dtype=jnp.int32) // n_loc, p - 1)
    rank_within = cum - cnt_before[own]
    ov = present & (rank_within > cap_b)
    cum_ov = jnp.cumsum(ov.astype(jnp.int32))
    free = ~main_ok
    freerank = jnp.cumsum(free.astype(jnp.int32))    # 1-based among frees
    # inv_free[o-1] = slot index of the o-th free slot (capacity-sized)
    inv_free = jnp.full((capacity,), capacity, jnp.int32).at[
        jnp.where(free, freerank - 1, capacity)].min(s, mode="drop")
    ov_rank = jnp.take(cum_ov, cand)                 # 1-based among ov ids
    is_ov = is_p & (rw > cap_b)
    ov_tgt = jnp.where(
        is_ov, jnp.take(inv_free, jnp.minimum(ov_rank - 1, capacity - 1)),
        capacity)
    field_in = field_in.at[ov_tgt].min(cand, mode="drop")
    pos_table = jnp.zeros(n + 1, jnp.int32).at[field_in].set(s)
    return field_in, pos_table


def schedule(key: jax.Array, graph: PaddedGraph, batch_ids: jax.Array,
             degrees: Sequence[int], cv: bool, need_aw: bool = False,
             importance: Optional[jax.Array] = None,
             round_multiple: int = 1, mesh=None,
             owner_blocks: int = 0,
             importance_rows: Optional[jax.Array] = None,
             dedup: bool = True, is_slot_cap: int = 0) -> BatchFields:
    """Build the full receptive field for one minibatch.

    Equivalent of ``PyScheduler.batch`` (gcn/_scheduler.pyx:55-127): expands
    top-down with ``degrees[L-1], ..., degrees[0]`` then returns everything
    input-side-first.  ``batch_ids`` must be [batch_size] int32, sentinel
    (``N``)-padded, with unique real ids.

    ``owner_blocks > 1`` selects the owner-aligned field layout
    (compact_field_aligned + LayerSample.self_pos) used with
    ``cfg.owner_batching`` on a mesh; the sampled-edge SET is identical to
    the classic layout, only field positions differ.

    ``dedup=False`` (cfg.field_dedup off) selects the append-only
    :func:`append_field` layout — forced back to dedup under importance
    sampling (slots address selected union members by id) and
    owner-aligned layouts (positional ownership blocks ARE compaction);
    plain meshes ride no-dedup since round 4 (see
    :func:`effective_dedup`).

    Runs entirely on device; intended to be called inside jit.
    """
    n = graph.num_nodes
    degrees = list(degrees)
    num_layers = len(degrees)
    if is_slot_cap < 0:
        # auto (cfg.is_slot_cap = -1): engage the cap only where it pays —
        # large batches, where the [F, Dcap] fanout gather dominates
        # (0.004% slots dropped at batch 4096, replica bands green); small
        # batches are latency-bound and the compaction would only add
        # kernels.
        is_slot_cap = 8 if batch_ids.shape[0] >= 2048 else 0
    dedup = effective_dedup(dedup, batch_ids.shape[0], degrees, n,
                            graph.pad_degree,
                            importance=importance is not None,
                            mesh=mesh, owner_blocks=owner_blocks)
    caps = field_capacities(batch_ids.shape[0], degrees, n, graph.pad_degree,
                            importance=importance is not None,
                            round_multiple=round_multiple, dedup=dedup)

    fields = [batch_ids.astype(jnp.int32)]
    layer_samples = []
    field = fields[0]
    is_dropped = jnp.zeros((), jnp.int32)
    for l in range(num_layers):
        degree = degrees[num_layers - l - 1]
        key, sub = jax.random.split(key)
        cap = caps[num_layers - l - 1]
        sel = None
        if importance is not None:
            if importance_rows is not None:
                # legacy per-slot gathers (only reachable with the
                # --is_row_table hoist, which supplies its own row table)
                nbr_id, slot_w, scales, sel_ids = expand_importance(
                    sub, graph, field, degree, importance, mesh=mesh,
                    importance_rows=importance_rows)
                cand = sel_ids
            else:
                # fused path: selection now, slots via ONE packed gather
                # once the field position table exists (is_slots)
                sel = is_select(sub, graph, field, degree, importance,
                                mesh=mesh)
                cand = sel.sel_ids
                scales = jnp.ones((field.shape[0],), jnp.float32)
            slot_aw = None
        else:
            nbr_id, slot_w, slot_aw, scales = expand_uniform(
                sub, graph, field, degree, need_aw, mesh=mesh)
            cand = nbr_id
        if owner_blocks > 1:
            field_in, pos_table = compact_field_aligned(field, cand, n, cap,
                                                        owner_blocks)
            # sentinel field entries park off the transport (their output
            # rows are masked downstream) instead of pointing at
            # pos_table[N]
            self_pos = jnp.where(field < n, pos_table[field], PARKED_POS)
            slot_pos = None if sel is not None else jnp.where(
                slot_w != 0.0, pos_table[nbr_id], PARKED_POS)
        elif not dedup:
            field_in, slot_pos = append_field(field, cand, n, cap)
            self_pos = None
        else:
            field_in, pos_table = compact_field(field, cand, n, cap)
            self_pos = None
            # weight-masked slots (sentinel-neighbor pads) park off the
            # transport instead of all pointing at pos_table[N]
            slot_pos = None if sel is not None else jnp.where(
                slot_w != 0.0, pos_table[nbr_id], PARKED_POS)
        if sel is not None:
            slot_pos, slot_w = is_slots(sel, importance, pos_table)
        if importance is not None and is_slot_cap:
            slot_pos, slot_w, drop = is_slot_compact(slot_pos, slot_w,
                                                     is_slot_cap)
            is_dropped = is_dropped + drop
        layer_samples.append(LayerSample(
            slot_pos=slot_pos, slot_w=slot_w, slot_aw=slot_aw,
            scales=scales, self_pos=self_pos))
        fields.append(field_in)
        field = field_in

    fields.reverse()
    layer_samples.reverse()
    return BatchFields(fields=tuple(fields), layers=tuple(layer_samples),
                       is_dropped=is_dropped)


class MinibatchIterator:
    """Host-side epoch cursor over shuffled training ids
    (gcn/_scheduler.pyx:50-53,129-135).  Yields sentinel-padded fixed-size
    batches; scheduling itself happens on device inside the train step."""

    def __init__(self, data_ids, batch_size: int, num_nodes: int, seed: int):
        import numpy as np
        self._np = np
        self.data = np.asarray(data_ids, np.int32).copy()
        self.batch_size = batch_size
        self.num_nodes = num_nodes
        self.rng = np.random.default_rng(seed)
        self.start = 0

    def shuffle(self) -> None:
        self.rng.shuffle(self.data)
        self.start = 0

    def next_batch(self):
        np = self._np
        if self.start >= len(self.data):
            return None
        end = min(len(self.data), self.start + self.batch_size)
        batch = self.data[self.start:end]
        self.start = end
        if len(batch) < self.batch_size:
            pad = np.full(self.batch_size - len(batch), self.num_nodes,
                          np.int32)
            batch = np.concatenate([batch, pad])
        return batch

    @staticmethod
    def pad_batch(ids, batch_size: int, num_nodes: int):
        import numpy as np
        ids = np.asarray(ids, np.int32)
        if len(ids) < batch_size:
            ids = np.concatenate(
                [ids, np.full(batch_size - len(ids), num_nodes, np.int32)])
        return ids
