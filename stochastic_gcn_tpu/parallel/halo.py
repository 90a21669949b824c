"""Owner-routed (halo-exchange) access to row-sharded node tables.

The multi-chip layout shards every O(N)-row table — history buffers, the
padded adjacency's [N, Dcap] neighbor/weight arrays, features, labels —
along the node dimension over the ``('data',)`` mesh axis, so per-chip HBM
scales as N/P (SURVEY.md §2.3 "partition nodes/edges across hosts"; the
reference is single-GPU with everything replicated in one process,
gcn/utils.py:164-165).

Row accesses by global node id then need communication.  GSPMD's default
lowering ALL-GATHERS the whole table per access (O(N·d) interconnect
bytes per step); every helper here instead routes rows explicitly from
their owner chips so interconnect traffic scales with the *request* count
(the receptive-field size), never with N:

* gathers — FETCH-routed by default (:func:`row_gather`): each chip reads
  the rows it owns locally (no interconnect traffic) and requests only the
  spill rows from their owners over a capacity-bounded ``all_to_all``
  round trip (ids out, rows back, native dtype).  Per-chip interconnect
  bytes ≈ 2·spill·d — under
  owner-aligned batching (``cfg.owner_batching``, ~97-100% self-locality)
  that is near zero, and even for fully shuffled requests it is
  ~4·F/P·d, a further ~P/4× below the previous psum lowering.  If the
  static spill capacity ever overflows (skewed requests without owner
  alignment), a ``lax.cond`` falls back IN-GRAPH to the exact psum path —
  gathers are never approximated.
* psum gathers (fallback + true reductions) — all chips all-gather the
  (small, integer) request ids, each chip serves the rows it owns via a
  masked local gather, and one ``psum_scatter`` returns each chip its
  shard of the result (per-chip bytes ≈ (P-1)/P·F·d, locality-blind).
  This stays the primary lowering for the CV full-neighborhood
  CONTRACTION (:func:`owner_routed` with a reducing ``partial_fn``),
  where the sum over owner chips is the semantics, not transport.
* scatters — each chip sorts its update rows by owner chip and sends them
  point-to-point over the interconnect (``all_to_all``), ~P× fewer bytes
  than the all-gather-then-mask lowering.  The per-destination capacity
  is bounded statically; overflowing rows are counted and *dropped*, which for the CV
  history buffers is principled: a dropped update leaves a one-step-staler
  history row, and staleness tolerance is the control-variate estimator's
  defining property (the paper's whole point).  The drop count is surfaced
  in the step metrics; capacity defaults leave it at zero for shuffled
  batches (see ``row_scatter``).

All helpers fall back to plain gathers/scatters (GSPMD handles layout)
when no mesh is given or the shapes do not tile evenly over it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


# Trace-time switch for the gather transport: True = fetch-routed
# all_to_all round trip with in-graph psum fallback (default), False =
# always the all-gather+psum_scatter lowering.  Read when the step is
# TRACED, so flip it before building a trainer (used by
# scripts/measure_halo_payload.py for A/B payload accounting).
FETCH_GATHER = True

# Default per-destination fetch-gather capacity multiplier (see
# scatter_capacity): 2.0 leaves many std-devs of slack for fully shuffled
# requests.  Owner-aligned batching (cfg.owner_batching, ~97-100%
# self-locality) needs far less — cfg.gather_cap_mult plumbs a smaller
# budget through a HaloSpec; overflow always falls back in-graph to the
# exact psum path, so any capacity is safe.
GATHER_CAP_MULT = 2.0


class HaloSpec(NamedTuple):
    """A mesh plus halo-transport knobs.  Accepted anywhere halo helpers
    accept a ``mesh`` — intermediate layers (forward, aggregators,
    scheduler) thread it opaquely."""
    mesh: object
    gather_cap_mult: float = GATHER_CAP_MULT


def _unwrap(mesh) -> tuple:
    """(raw Mesh or None, gather_cap_mult) from a Mesh/HaloSpec/None."""
    if isinstance(mesh, HaloSpec):
        return mesh.mesh, mesh.gather_cap_mult
    return mesh, GATHER_CAP_MULT


def data_axis_size(mesh) -> int:
    """Chips along the node-sharding ('data') axis — the FIRST mesh axis.
    Distinct from mesh.devices.size on 2-D (data, model) meshes (--tp)."""
    mesh, _ = _unwrap(mesh)
    return mesh.shape[mesh.axis_names[0]]


def halo_tiles(table: jax.Array, ids: jax.Array, mesh) -> bool:
    """True when the owner-routed lowering applies: >1 chip along the data
    axis and both the table rows and the request count tile evenly over
    it."""
    mesh, _ = _unwrap(mesh)
    if mesh is None:
        return False
    p = data_axis_size(mesh)
    return (p > 1 and ids.shape[0] % p == 0 and table.shape[0] % p == 0)


def owner_routed(table: jax.Array, ids: jax.Array, extras, partial_fn, mesh):
    """Shared gather-side halo skeleton over a row-sharded ``table``.

    All chips all-gather the request tensors, each chip computes
    ``partial_fn(rows, mine, *extras) -> [P, F/P, ...]`` over the rows it
    owns (non-owned rows are garbage and must be masked via ``mine``), and
    one ``psum_scatter`` sums the partials while handing every chip its own
    shard — interconnect payload ≈ the result size, independent of N.
    """
    mesh, _ = _unwrap(mesh)
    axis = mesh.axis_names[0]
    p = mesh.shape[axis]
    n_loc = table.shape[0] // p

    def body(t_loc, ids_loc, *ex_loc):
        ids_all = jax.lax.all_gather(ids_loc, axis)      # [P, F/P, ...]
        ex_all = [jax.lax.all_gather(e, axis) for e in ex_loc]
        lo = jax.lax.axis_index(axis) * n_loc
        loc = ids_all - lo
        mine = (loc >= 0) & (loc < n_loc)
        rows = jnp.take(t_loc, jnp.clip(loc, 0, n_loc - 1), axis=0)
        part = partial_fn(rows, mine, *ex_all)
        return jax.lax.psum_scatter(part, axis, scatter_dimension=0,
                                    tiled=False)

    id_spec = P(axis) if ids.ndim == 1 else P(axis, None)
    specs = (P(axis, None), id_spec) + tuple(P(axis, None) for _ in extras)
    # axis_names={axis}: only the data axis is manual — on a 2-D
    # (data, model) mesh (--tp) the model axis stays auto/GSPMD-managed
    return shard_map(body, mesh=mesh, in_specs=specs,
                     out_specs=P(axis, None),
                     axis_names={axis})(table, ids, *extras)


def _fetch_or_psum_gather(table: jax.Array, ids: jax.Array,
                          mesh, sentinel: int = -1) -> jax.Array:
    """``table[ids]`` over a row-sharded table: fetch-routed transport with
    an in-graph exact psum fallback.

    Each chip serves its OWN rows with a plain local gather (no
    interconnect traffic); spill rows are sorted by owner, bucketed into a static ``[P, cap]``
    request, and fetched over two ``all_to_all`` hops (int32 ids out,
    native-dtype rows back).  The capacity follows
    :func:`scatter_capacity`; a replicated overflow count (one scalar
    psum) selects — via ``lax.cond``, so only one branch runs — between
    the fetched result and the locality-blind all-gather+psum_scatter
    path, keeping the gather EXACT for arbitrarily skewed requests.
    ``ids`` may contain duplicates and sentinel rows; 1-D ids only.

    ``sentinel >= 0``: ids >= sentinel (the node-id space's parked/empty
    marker, id N of an [N+1]-row table) are satisfied LOCALLY with zero
    rows instead of being routed to the chip that owns row N — without
    this, every chip's sentinel-padded request slots all target ONE
    destination and can blow the static per-destination capacity,
    forcing the psum fallback on perfectly local batches.  Zero is the
    row's true value on the sharded path (row_scatter skips sentinel
    writes), and every downstream read of sentinel rows is weight-masked
    by construction (training/step.py::scatter_histories docstring).
    """
    mesh, gcap = _unwrap(mesh)
    axis = mesh.axis_names[0]
    p = mesh.shape[axis]
    r_tot = table.shape[0]
    n_loc = r_tot // p
    c_loc = ids.shape[0] // p
    cap = scatter_capacity(ids.shape[0], p, gcap)
    dt = table.dtype
    d = int(np.prod(table.shape[1:], dtype=np.int64)) if table.ndim > 1 else 1
    t2 = table.reshape(r_tot, d)

    def body(t_loc, ids_loc):
        me = jax.lax.axis_index(axis)
        ids32 = ids_loc.astype(jnp.int32)
        safe = jnp.minimum(ids32, r_tot - 1)
        sent = (ids32 >= sentinel) if sentinel >= 0 \
            else jnp.zeros(ids32.shape, bool)
        owner = safe // n_loc
        mine = (owner == me) & ~sent
        # bucket remote requests by owner (self + sentinel rows parked
        # past every destination, exactly like row_scatter)
        owner_r = jnp.where(mine | sent, p, owner)
        order = jnp.argsort(owner_r)
        so = jnp.take(owner_r, order)
        dests = jnp.arange(p, dtype=so.dtype)
        starts = jnp.searchsorted(so, dests, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(so, dests, side="right").astype(jnp.int32)
        slot = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = slot < ends[:, None]                         # [p, cap]
        gidx = jnp.minimum(slot, c_loc - 1).reshape(-1)
        send_ids = jnp.where(
            valid, jnp.take(jnp.take(safe, order), gidx).reshape(p, cap),
            r_tot - 1)
        pos = jnp.where(valid, jnp.take(order, gidx).reshape(p, cap), c_loc)
        overflow = jax.lax.psum(
            jnp.sum(jnp.maximum(ends - starts - cap, 0)), axis)

        # fetch transport runs UNCONDITIONALLY: the overflow-flag psum has
        # no data dependence on the two all_to_alls, so XLA can overlap
        # them (serial collective depth 2, not 3); only the exact psum
        # CORRECTION is cond-gated, and overflow is a never-event at the
        # default capacity for shuffled or owner-aligned batches.
        req = jax.lax.all_to_all(send_ids, axis, 0, 0, tiled=True)
        loc = req.reshape(-1) - me * n_loc
        ok = (loc >= 0) & (loc < n_loc)
        rows = jnp.take(t_loc, jnp.clip(loc, 0, n_loc - 1), axis=0)
        rows = jnp.where(ok[:, None], rows, 0)
        rep = jax.lax.all_to_all(rows.reshape(p, cap, d), axis, 0, 0,
                                 tiled=True)
        # self rows locally, sentinel rows zero, remote rows into their
        # recorded positions
        self_loc = jnp.where(mine, safe - me * n_loc, 0)
        fetched = jnp.where(mine[:, None],
                            jnp.take(t_loc, self_loc, axis=0), 0)
        fetched = fetched.at[pos.reshape(-1)].set(rep.reshape(-1, d),
                                                  mode="drop")

        def psum_path(_):
            ids_all = jax.lax.all_gather(
                jnp.where(sent, r_tot, safe), axis)          # [P, F/P]
            loc_a = ids_all - me * n_loc
            ok_a = (loc_a >= 0) & (loc_a < n_loc)
            rows_a = jnp.take(t_loc, jnp.clip(loc_a, 0, n_loc - 1), axis=0)
            part = jnp.where(ok_a[..., None], rows_a, 0).astype(jnp.float32)
            return jax.lax.psum_scatter(
                part, axis, scatter_dimension=0, tiled=False).astype(dt)

        return jax.lax.cond(overflow > 0, psum_path, lambda _: fetched,
                            None)

    out = shard_map(body, mesh=mesh, in_specs=(P(axis, None), P(axis)),
                    out_specs=P(axis, None), axis_names={axis})(t2, ids)
    return out.reshape(ids.shape[:1] + table.shape[1:])


def row_gather(table: jax.Array, ids: jax.Array, mesh=None,
               sentinel: int = -1) -> jax.Array:
    """``table[ids]`` from a row-sharded table, dtype preserved.

    Fetch-routed (see :func:`_fetch_or_psum_gather`): self rows are local,
    spill rows ride a bounded all_to_all in the table's NATIVE dtype, and
    an in-graph psum fallback keeps the result exact under overflow.
    Multi-dim requests take the psum path directly (float32 transport —
    node counts < 2^24 keep int32 ids exactly representable; exactly one
    chip contributes each row, so the sum is the row itself)."""
    if not halo_tiles(table, ids, mesh):
        out = jnp.take(table, ids, axis=0)
        if sentinel >= 0:
            # parked ids (>= sentinel, e.g. scheduler.PARKED_POS slots)
            # must come back ZERO, not a clamped read of the last row:
            # weight-0 masking of the contraction only works when the
            # gathered value is finite, and the last row can be e.g. a
            # layer-normed all-zero sentinel activation (0 * inf = NaN)
            m = (ids >= sentinel).reshape(
                ids.shape + (1,) * (out.ndim - ids.ndim))
            out = jnp.where(m, 0, out)
        return out

    if FETCH_GATHER and ids.ndim == 1 \
            and ids.shape[0] >= data_axis_size(mesh):
        return _fetch_or_psum_gather(table, ids, mesh, sentinel=sentinel)

    dt = table.dtype

    def mask_rows(rows, mine, *_):
        m = mine.reshape(mine.shape + (1,) * (rows.ndim - mine.ndim))
        return jnp.where(m, rows, 0).astype(jnp.float32)

    out = owner_routed(table, ids, (), mask_rows, mesh)
    return out.astype(dt) if dt != jnp.float32 else out


def row_gather2(table_i: jax.Array, table_f: jax.Array, ids: jax.Array,
                mesh=None, sentinel: int = -1):
    """Gather the same rows from an int32 table and a float32 table of
    identical shape (e.g. a PaddedGraph's ``nbr``/``w``, or sparse-feature
    ``idx``/``val``) in ONE exchange: the int table is value-cast to
    float32 (exact — node ids < 2^24; a BITCAST would be wrong here, as
    ids < 2^23 bitcast to f32 denormals that the psum fallback's additions
    may flush to zero), stacked with the float table, and the pair
    rides a single fetch-routed gather."""
    if not halo_tiles(table_i, ids, mesh):
        out_i = jnp.take(table_i, ids, axis=0)
        out_f = jnp.take(table_f, ids, axis=0)
        if sentinel >= 0:
            m = (ids >= sentinel).reshape(
                ids.shape + (1,) * (out_i.ndim - ids.ndim))
            out_i = jnp.where(m, 0, out_i)
            out_f = jnp.where(m, 0, out_f)
        return out_i, out_f

    if FETCH_GATHER and ids.ndim == 1 \
            and ids.shape[0] >= data_axis_size(mesh):
        stacked = jnp.stack(
            [table_i.astype(jnp.float32),
             table_f.astype(jnp.float32)], axis=1)
        out = _fetch_or_psum_gather(stacked, ids, mesh,
                                    sentinel=sentinel)       # [F, 2, k]
        return out[:, 0].astype(table_i.dtype), out[:, 1]

    stacked = jnp.stack(
        [table_i.astype(jnp.float32), table_f.astype(jnp.float32)], axis=1)

    def mask_rows(rows, mine, *_):
        # rows [P, F/P, 2, k]
        m = mine.reshape(mine.shape + (1,) * (rows.ndim - mine.ndim))
        return jnp.where(m, rows, 0.0)

    out = owner_routed(stacked, ids, (), mask_rows, mesh)  # [F, 2, k]
    return out[:, 0].astype(table_i.dtype), out[:, 1]


def scatter_capacity(c: int, p: int, cap_mult: float) -> int:
    """Static per-destination row budget for :func:`row_scatter`.

    Each chip holds C/P update rows whose owners are ~uniform over P chips
    for shuffled batches (expected C/P² per destination, binomial std
    sqrt(C/P²)); ``cap_mult`` ≥ 2 leaves many standard deviations of slack.
    ``cap_mult >= p`` (or the C/P clamp) guarantees zero drops for any
    skew."""
    c_loc = c // p
    return int(min(c_loc, max(8, -(-int(cap_mult * c_loc) // p))))


def row_scatter(table: jax.Array, ids: jax.Array, rows: jax.Array,
                mesh=None, cap_mult: float = 2.0, sentinel: int = -1):
    """``table.at[ids].set(rows)`` onto a row-sharded table, owner-routed.

    Returns ``(table', dropped)`` where ``dropped`` counts update rows that
    exceeded the static per-destination capacity (see
    :func:`scatter_capacity`) and were not applied — those history rows
    simply stay one step staler, which the CV estimator tolerates by
    construction.  Duplicate real ids (the no-dedup field layout,
    cfg.field_dedup off) race to last-write exactly like a local
    ``.at[].set`` — the documented no-dedup scatter semantics
    (training/step.py); compacted fields keep the scatter deterministic.

    Fast path: updates whose target row is OWNED BY THIS CHIP are applied
    with a plain local scatter (no interconnect traffic, no capacity) —
    under owner-grouped batching (``cfg.owner_batching``) that is most of them.  The remainder
    are sorted by owner chip and sent point-to-point (``all_to_all`` of
    [P, cap, d] buckets) — per-chip interconnect bytes ≈ C·d·cap_mult/P
    vs the C·d of GSPMD's all-gather lowering, and the capacity budget is spent on
    remote rows only.
    """
    if not halo_tiles(table, ids, mesh) \
            or ids.shape[0] < data_axis_size(mesh):
        return (table.at[ids].set(rows.astype(table.dtype)),
                jnp.zeros((), jnp.int32))

    mesh, _ = _unwrap(mesh)
    axis = mesh.axis_names[0]
    p = mesh.shape[axis]
    r_tot = table.shape[0]
    n_loc = r_tot // p
    c_loc = ids.shape[0] // p
    cap = scatter_capacity(ids.shape[0], p, cap_mult)
    d = rows.shape[-1]

    def body(t_loc, ids_loc, rows_loc):
        me = jax.lax.axis_index(axis)
        ids32 = ids_loc.astype(jnp.int32)
        safe = jnp.minimum(ids32, r_tot - 1)
        # sentinel >= 0: updates at ids >= sentinel (the parked/empty
        # marker, id N) are SKIPPED outright instead of being routed to
        # row N's owner chip — the single-chip path writes garbage into
        # row N because that is cheaper than masking (see
        # scatter_histories), but on the mesh those rows would all
        # target ONE destination chip and its static capacity, evicting
        # REAL updates into the dropped count.  Row N's content is
        # garbage-tolerated either way.
        sent = (ids32 >= sentinel) if sentinel >= 0 \
            else jnp.zeros(ids32.shape, bool)
        owner = safe // n_loc
        mine = (owner == me) & ~sent
        # self rows: local scatter, never capacity-bounded or dropped
        tgt_self = jnp.where(mine, safe - me * n_loc, n_loc)
        t_loc = t_loc.at[tgt_self].set(rows_loc.astype(t_loc.dtype),
                                       mode="drop")
        # remote rows ride the all_to_all; push self + sentinel rows past
        # every destination so the owner-sort parks them outside
        # [starts, ends)
        owner = jnp.where(mine | sent, p, owner)
        order = jnp.argsort(owner)
        sids = jnp.take(safe, order)
        srows = jnp.take(rows_loc, order, axis=0)
        so = jnp.take(owner, order)
        dests = jnp.arange(p, dtype=so.dtype)
        starts = jnp.searchsorted(so, dests, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(so, dests, side="right").astype(jnp.int32)
        slot = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = slot < ends[:, None]                       # [p, cap]
        gidx = jnp.minimum(slot, c_loc - 1).reshape(-1)
        send_rows = jnp.take(srows, gidx, axis=0).reshape(p, cap, d)
        send_ids = jnp.where(valid,
                             jnp.take(sids, gidx).reshape(p, cap), r_tot)
        dropped = jax.lax.psum(
            jnp.sum(jnp.maximum(ends - starts - cap, 0)), axis)

        recv_rows = jax.lax.all_to_all(send_rows, axis, 0, 0, tiled=True)
        recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0, tiled=True)
        loc = recv_ids.reshape(-1) - jax.lax.axis_index(axis) * n_loc
        tgt = jnp.where((loc >= 0) & (loc < n_loc), loc, n_loc)
        t_loc = t_loc.at[tgt].set(
            recv_rows.reshape(-1, d).astype(t_loc.dtype), mode="drop")
        return t_loc, dropped

    out, dropped = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None)),
        out_specs=(P(axis, None), P()),
        axis_names={axis})(table, ids, rows)
    return out, dropped
