"""Jitted train/eval steps.

The reference's per-step pipeline (host sampling -> feed_dict copy ->
sess.run of forward/backward/Adam/history-scatter, gcn/vrgcn.py:71-84) becomes
ONE compiled XLA program: on-device scheduling, forward, loss, grad, Adam
update and functional history scatter, with buffer donation so history/params
update in place in device memory.

Ordering contract (gcn/models.py:186-191): history is updated with the
activations that produced this step's gradient, applied after the optimizer
update — reproduced here by computing new history rows inside the forward and
scattering them after ``optax`` applies the Adam step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import Config
from ..data.graph import PaddedGraph
from ..models import gcn as M
from ..sampler.scheduler import BatchFields, schedule


@jax.tree_util.register_dataclass
@dataclass
class TrainState:
    params: dict
    opt_state: tuple
    histories: tuple      # per agg layer: tuple of [N+1, d] arrays
    step: jax.Array
    # Polyak/EMA parameter average (gcn/models.py:104-121 — dormant in the
    # reference, a working feature here): None unless polyak_decay > 0.
    avg_params: Optional[dict] = None


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    """Adam with the reference's hyperparameters (train.py:50-51 via
    tf.train.AdamOptimizer: eps=1e-8 outside the sqrt)."""
    return optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=cfg.beta2,
                      eps=1e-8)


def init_train_state(key: jax.Array, cfg: Config, spec: M.ModelSpec,
                     num_nodes: int) -> TrainState:
    params = M.init_params(key, spec)
    tx = make_optimizer(cfg)
    row_multiple = max(8, cfg.dp)
    hist_dtype = jnp.dtype(cfg.history_dtype)
    avg = jax.tree_util.tree_map(jnp.copy, params) \
        if cfg.polyak_decay > 0 else None
    return TrainState(params=params, opt_state=tx.init(params),
                      histories=M.init_histories(spec, num_nodes,
                                                 row_multiple, hist_dtype),
                      step=jnp.zeros((), jnp.int32), avg_params=avg)


def scatter_histories(histories, new_histories, fields, num_nodes: int,
                      mesh=None, scatter_cap_mult: float = 2.0,
                      unique: bool = True):
    """history[field_l] <- new rows for the input-side fields
    ``fields[:-1]`` (``fields`` is the FULL pack.fields tuple — the final
    batch field is not scattered but its size anchors the sorted-segment
    boundaries); functional tf.scatter_update
    (gcn/models.py:160-166).  Fields are unique per layer (compaction), so
    the scatter is deterministic.

    Sentinel-padded field entries write garbage into row N on the
    single-chip path, which is safe: every read of row N downstream is
    either masked by a zero edge weight (full-neighborhood term) or feeds
    rows whose contributions are masked (delta term), so no reset scatter
    is spent on it.  On a mesh the sentinel writes are SKIPPED instead
    (row_scatter ``sentinel=``): routed, they would all target row N's
    owner chip and evict real updates from its static capacity
    (parallel/halo.py).

    With a mesh and row-sharded histories the update rows are routed to
    their owner chips point-to-point (parallel/halo.py::row_scatter)
    instead of GSPMD's [C, d] all-gather; rows beyond the static
    per-destination capacity are dropped (history stays one step staler —
    CV tolerates staleness by construction) and counted in the returned
    ``dropped`` scalar, which the step surfaces as a metric.

    Single-chip fast path: each field is by construction the concatenation
    ``[batch, new_L-1, ..., new_l]`` at STATIC boundaries (the capacity
    ladder), where every ``new`` segment is ascending (compact_field emits
    ids in node-id order with trailing-N sentinel padding).  The scatter
    is issued per segment with ``indices_are_sorted`` after sorting the
    small batch prefix (one argsort + row permute of B rows).  Repeated
    sentinel entries all target row N, whose content is garbage-tolerated
    by design, so the ``unique_indices`` contract is violated only for
    that masked row.
    Fields below SORTED_SCATTER_MIN_ROWS take one plain scatter instead —
    the per-segment dispatches cost more than they save at small
    capacities.

    ``unique=False`` (the no-dedup field layout, cfg.field_dedup off):
    fields may repeat ids, so the scatter runs without the
    ``unique_indices`` contract — duplicate writes race like the
    reference's tf.scatter_update last-write (SURVEY §7.3 hard part 2);
    every duplicate carries an independent, equally valid iid sample of
    the same activation (identical values only under exhaustive
    expansion with dropout off), so whichever write wins leaves a valid
    history row."""
    from ..parallel.halo import row_scatter
    out = []
    dropped = jnp.zeros((), jnp.int32)
    bounds = sorted(f.shape[0] for f in fields)
    for hist_l, new_l, field_l in zip(histories, new_histories,
                                      fields[:-1]):
        if new_l is None:
            out.append(hist_l)
            continue
        updated = []
        for h, nh in zip(hist_l, new_l):
            if mesh is not None:
                h, drop = row_scatter(h, field_l, nh, mesh,
                                      scatter_cap_mult,
                                      sentinel=num_nodes)
                dropped = dropped + drop
            elif unique and field_l.shape[0] >= SORTED_SCATTER_MIN_ROWS:
                h = _segment_sorted_scatter(h, field_l, nh, bounds)
            else:
                h = h.at[field_l].set(nh.astype(h.dtype),
                                      unique_indices=unique)
            updated.append(h)
        out.append(tuple(updated))
    return tuple(out), dropped


# Below this static field capacity the per-segment dispatch overhead +
# batch-prefix argsort of the sorted-segment scatter exceed its savings
# (small fields are latency-bound).  The capacity is static, so the
# choice is trace-time.
SORTED_SCATTER_MIN_ROWS = 4096

# Largest batch size at which sched_prepass="auto" engages — above it the
# schedule is work-bound and the pre-pass only adds cost (see
# build_train_epoch).
PREPASS_MAX_BATCH = 2048


def _segment_sorted_scatter(h, ids, rows, bounds):
    """Scatter ``rows`` at ``ids`` into ``h`` exploiting the field's
    sorted-segment structure (see scatter_histories).  ``bounds`` is the
    ascending capacity ladder of ALL fields; segments of this field are
    the bounds <= its own length plus the final full length."""
    c = ids.shape[0]
    cuts = [b for b in bounds if b < c] + [c]
    lo = 0
    for hi in cuts:
        if hi <= lo:
            continue
        seg_ids = jax.lax.slice_in_dim(ids, lo, hi)
        seg_rows = jax.lax.slice_in_dim(rows, lo, hi)
        if lo == 0:
            # batch prefix: caller-ordered — sort it (B is the smallest
            # segment; the argsort+permute is cheap)
            order = jnp.argsort(seg_ids)
            seg_ids = jnp.take(seg_ids, order)
            seg_rows = jnp.take(seg_rows, order, axis=0)
        h = h.at[seg_ids].set(seg_rows.astype(h.dtype),
                              unique_indices=True,
                              indices_are_sorted=True)
        lo = hi
    return h


def _labels_gather(labels, batch_field, mesh=None, num_nodes: int = -1):
    """labels[batch_field] — owner-routed when labels are node-sharded;
    sentinel-padded batch slots are served locally as zero rows (their
    loss/accuracy contributions are masked by ``valid``)."""
    from ..parallel.halo import row_gather
    return row_gather(labels, batch_field, mesh, sentinel=num_nodes)


def _batch_stats(pack: BatchFields, graph, num_nodes: int, cv: bool):
    """amt_data / field / adjacency-size accounting (gcn/vrgcn.py:50-69):
    adj_sizes[l] = sampled edges of layer l, fadj_sizes[l] = full-
    neighborhood edges (CV only), field_sizes[l] = real nodes in field l."""
    if not pack.layers:
        z = jnp.zeros((0,), jnp.int32)
        return jnp.zeros((), jnp.int32), z, z, z
    adj_sizes = jnp.stack([jnp.sum((ls.slot_w != 0).astype(jnp.int32))
                           for ls in pack.layers])
    amt = jnp.sum(adj_sizes)
    field_sizes = jnp.stack(
        [jnp.sum((f < num_nodes).astype(jnp.int32)) for f in pack.fields])
    if cv:
        from ..data.graph import FlatGraph
        deg = graph.deg
        if isinstance(graph, FlatGraph):
            # the edgelist full-neighborhood term reads at most
            # edge_cap_per_row edges per row — account what is gathered,
            # not the full row length
            deg = jnp.minimum(deg, graph.edge_cap_per_row)
        fadj_sizes = jnp.stack(
            [jnp.sum(jnp.take(deg, f, axis=0))
             for f in pack.fields[1:]])
    else:
        fadj_sizes = jnp.zeros((len(pack.layers),), jnp.int32)
    return amt, field_sizes, adj_sizes, fadj_sizes


def build_train_step(cfg: Config, spec: M.ModelSpec,
                     degrees: Tuple[int, ...], num_nodes: int, mesh=None):
    """Raw (unjitted) ``step(state, graph, features, labels, importance,
    batch_ids, key) -> (state', metrics)`` — for custom jit wrapping
    (sharded variants live in parallel/mesh.py)."""
    tx = make_optimizer(cfg)
    use_importance = cfg.importance
    # owner-aligned field layout: every chip's positional chunk of each
    # field holds the node rows that chip owns (see compact_field_aligned)
    owner_blocks = cfg.dp if (cfg.owner_batching and mesh is not None) else 0

    def _step(state: TrainState, graph: PaddedGraph, features, labels,
              importance, batch_ids, key, importance_rows=None, pack=None,
              lazy=None):
        # fields carry unique ids unless the no-dedup layout is ACTIVE —
        # the SAME trace-time decision schedule() makes (effective_dedup),
        # so the scatter's uniqueness contract can never disagree with the
        # field layout
        from ..sampler.scheduler import effective_dedup
        unique_fields = effective_dedup(
            cfg.field_dedup, batch_ids.shape[0], degrees, num_nodes,
            graph.pad_degree, importance=use_importance, mesh=mesh,
            owner_blocks=owner_blocks)
        k_sched, k_drop = jax.random.split(jax.random.fold_in(key,
                                                              state.step))
        if pack is None:
            pack = schedule(k_sched, graph, batch_ids, degrees, spec.cv,
                            need_aw=spec.det_dropout,
                            importance=importance if use_importance else None,
                            round_multiple=cfg.dp, mesh=mesh,
                            owner_blocks=owner_blocks,
                            importance_rows=importance_rows,
                            dedup=cfg.field_dedup,
                            is_slot_cap=cfg.is_slot_cap)
        batch_field = pack.fields[-1]
        valid = (batch_field < num_nodes).astype(jnp.float32)
        y = _labels_gather(labels, batch_field, mesh, num_nodes)

        def loss_fn(params):
            logits, new_h = M.forward(
                params, spec, pack, graph, state.histories, features,
                k_drop, cfg.keep_prob, train=True, mesh=mesh, lazy=lazy)
            loss, acc = M.loss_and_metrics(params, spec, logits, y, valid,
                                           cfg.weight_decay)
            return loss, (acc, new_h)

        (loss, (acc, new_h)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        if cfg.polyak_decay > 0:
            # average_model (gcn/models.py:104-108): EMA over post-update
            # weights, maintained on device every step
            d = cfg.polyak_decay
            avg_params = jax.tree_util.tree_map(
                lambda a, p: a * d + p * (1 - d), state.avg_params, params)
        else:
            avg_params = state.avg_params
        histories, dropped = scatter_histories(
            state.histories, new_h, pack.fields, num_nodes, mesh=mesh,
            scatter_cap_mult=cfg.scatter_cap_mult, unique=unique_fields)
        amt, field_sizes, adj_sizes, fadj_sizes = _batch_stats(
            pack, graph, num_nodes, spec.cv)
        new_state = TrainState(params=params, opt_state=opt_state,
                               histories=histories, step=state.step + 1,
                               avg_params=avg_params)
        return new_state, {"loss": loss, "accuracy": acc, "amt_data": amt,
                           "field_sizes": field_sizes,
                           "adj_sizes": adj_sizes,
                           "fadj_sizes": fadj_sizes,
                           "hist_dropped": dropped,
                           "is_dropped": pack.is_dropped}

    return _step


def make_train_step(cfg: Config, spec: M.ModelSpec, degrees: Tuple[int, ...],
                    num_nodes: int, donate: bool = True):
    """Jitted single-chip train step with state donation."""
    _step = build_train_step(cfg, spec, degrees, num_nodes)
    return jax.jit(_step, donate_argnums=(0,) if donate else ())


def _prepass_schedule(cfg: Config, sched_one, batch_matrix, step0,
                      num_nodes: int):
    """Chunked-vmap scheduler pre-pass: compute every step's
    :class:`BatchFields` pack in ``ceil(S/chunk)`` batched dispatches
    instead of S latency-bound kernel chains inside the scan body (the
    schedule is ~15 sequential small kernels).  Chunking caps the expand's
    [C, F, Dcap] row-gather transients; the per-step keys are derived exactly as the
    in-step path derives them, so the sampled trajectory is BIT-IDENTICAL
    (tests/test_options.py::test_sched_prepass_trajectory_identical).

    Returns packs stacked on a leading [S] axis, or None when the
    estimated pack bytes exceed cfg.sched_prepass_budget_mb (Exact-mode
    packs are ~17 MB/step — those stay in-step)."""
    s = batch_matrix.shape[0]
    chunk = max(1, min(s, cfg.sched_prepass_chunk))
    s_pad = -(-s // chunk) * chunk
    step_idx = step0 + jnp.arange(s_pad, dtype=jnp.int32)

    if cfg.sched_prepass != "on":
        pack_shape = jax.eval_shape(sched_one, batch_matrix[0], step_idx[0])
        per_step = sum(x.size * x.dtype.itemsize
                       for x in jax.tree_util.tree_leaves(pack_shape))
        if per_step * s_pad > cfg.sched_prepass_budget_mb * 1024 * 1024:
            return None

    bm = batch_matrix
    if s_pad != s:
        pad = jnp.full((s_pad - s, bm.shape[1]), num_nodes, bm.dtype)
        bm = jnp.concatenate([bm, pad])

    def sched_chunk(_, xs):
        b, si = xs
        return None, jax.vmap(sched_one)(b, si)

    _, packs = jax.lax.scan(
        sched_chunk, None,
        (bm.reshape(s_pad // chunk, chunk, bm.shape[1]),
         step_idx.reshape(s_pad // chunk, chunk)))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((s_pad,) + x.shape[2:])[:s], packs)


def build_train_epoch(cfg: Config, spec: M.ModelSpec,
                      degrees: Tuple[int, ...], num_nodes: int, mesh=None):
    """Whole-epoch runner: ``lax.scan`` of the train step over a [S, B]
    batch-id matrix.

    This replaces the reference's per-minibatch host loop
    (train.py:187-209): ONE dispatch and ONE device->host sync per epoch
    instead of per step, so no host round trip sits between steps.
    Returns (state', {loss, accuracy (last step, matching the reference's
    window-1 Averager), amt_data (summed)}).

    With ``cfg.sched_prepass`` (default auto, single-chip only) the
    scheduler runs as a chunked vmapped PRE-PASS over all S steps before
    the scan — see :func:`_prepass_schedule`.
    """
    _step = build_train_step(cfg, spec, degrees, num_nodes, mesh=mesh)
    use_importance = cfg.importance

    def _epoch(state: TrainState, graph, features, labels, importance,
               batch_matrix, key):
        # per-epoch hoist of the IS importance row table (the scan body
        # then does F row gathers instead of F*Dcap element gathers)
        imp_rows = None
        if cfg.importance and cfg.is_row_table:
            from ..sampler.scheduler import importance_row_table
            imp_rows = importance_row_table(graph, importance)

        # --lazy_fullterm: snapshot h-bar and precompute the a-bar tables
        # ONCE per epoch, inside this same dispatch (the epoch timing —
        # and the bench — therefore always pays for the recompute).  The
        # scan below reads ONLY the snapshot/a-bar (scan constants); the
        # per-step scatters keep updating the carried live histories,
        # which the NEXT epoch's snapshot picks up.  Single-chip only —
        # meshes keep the per-step owner-routed term.
        lazy = None
        if cfg.lazy_fullterm and spec.cv and mesh is None:
            from ..models.aggregators import full_abar
            snap = state.histories
            abar = tuple(
                tuple(full_abar(h, graph, num_nodes,
                                square=(spec.det_dropout and j == 1))
                      for j, h in enumerate(hl))
                for hl in snap)
            lazy = (snap, abar)

        # auto: only the regime where batching the schedule can win:
        # dedup-compacted schedules at small batch are kernel-LATENCY
        # bound; no-dedup schedules have no latency chain left (slot
        # positions are a trace-time iota) and at large batch the
        # schedule is WORK-bound, so the pack materialization + per-step
        # slicing only add cost.  The dedup test uses the EFFECTIVE layout
        # (schedule may force dedup back on), decided from the graph's
        # static pad_degree.
        from ..sampler.scheduler import effective_dedup
        auto_ok = (effective_dedup(cfg.field_dedup, batch_matrix.shape[1],
                                   degrees, num_nodes, graph.pad_degree,
                                   importance=use_importance)
                   and not use_importance
                   and batch_matrix.shape[1] <= PREPASS_MAX_BATCH)
        prepass = (mesh is None
                   and (cfg.sched_prepass == "on"
                        or (cfg.sched_prepass == "auto" and auto_ok)))
        packs = None
        if prepass:
            def sched_one(bids, si):
                # same key derivation as _step (fold_in by step counter)
                k_sched, _ = jax.random.split(jax.random.fold_in(key, si))
                return schedule(
                    k_sched, graph, bids, degrees, spec.cv,
                    need_aw=spec.det_dropout,
                    importance=importance if use_importance else None,
                    round_multiple=cfg.dp, mesh=None,
                    owner_blocks=0, importance_rows=imp_rows,
                    dedup=cfg.field_dedup,
                    is_slot_cap=cfg.is_slot_cap)
            packs = _prepass_schedule(cfg, sched_one, batch_matrix,
                                      state.step, num_nodes)

        def body(st, xs):
            batch_ids, pack = xs
            st, m = _step(st, graph, features, labels, importance,
                          batch_ids, key, importance_rows=imp_rows,
                          pack=pack, lazy=lazy)
            return st, (m["loss"], m["accuracy"], m["amt_data"],
                        m["field_sizes"], m["adj_sizes"], m["fadj_sizes"],
                        m["hist_dropped"], m["is_dropped"])

        state, (losses, accs, amts, fs, adjs, fadjs, drops,
                isdrops) = jax.lax.scan(
            body, state, (batch_matrix, packs), unroll=cfg.scan_unroll)
        return state, {"loss": losses[-1], "accuracy": accs[-1],
                       # amt_data: device-summed int32 (kept for the
                       # profile scripts' value-fetch sync).  At Reddit+
                       # scale an epoch's edge count can exceed 2^31, so
                       # amt_steps carries the per-step vector and the
                       # Trainer accumulates it host-side in int64 (the
                       # reference accumulates in Python ints,
                       # vrgcn.py:62) — the --data budget and the `data =`
                       # log column never wrap.
                       "amt_steps": amts,
                       "amt_data": jnp.sum(amts),
                       "field_sizes": jnp.sum(fs, axis=0),
                       "adj_sizes": jnp.sum(adjs, axis=0),
                       "fadj_sizes": jnp.sum(fadjs, axis=0),
                       "hist_dropped": jnp.sum(drops),
                       "is_dropped": jnp.sum(isdrops)}

    return _epoch


def make_train_epoch(cfg: Config, spec: M.ModelSpec,
                     degrees: Tuple[int, ...], num_nodes: int):
    return jax.jit(build_train_epoch(cfg, spec, degrees, num_nodes),
                   donate_argnums=(0,))


def _eval_schedule(cfg: Config, spec, degrees, num_nodes: int, graph,
                   importance, batch_ids, key, use_importance: bool,
                   mesh=None, owner_blocks: int = 0, importance_rows=None):
    """Shared schedule + field-layout contract for every EVAL-side builder
    (epoch eval, step eval, activation taps, pred-and-grad) — one place
    for the eval sampling semantics, so the builders cannot drift.

    Notably: is_slot_cap auto (-1) resolves to 0 here — the lossy IS slot
    cap is calibrated on the training step; inference keeps the
    reference's exact keep-every-edge union semantics by default
    (scheduler.cpp:118-121).  Returns (pack, unique_fields, dropout key).
    """
    from ..sampler.scheduler import effective_dedup
    unique_fields = effective_dedup(
        cfg.field_dedup, batch_ids.shape[0], degrees, num_nodes,
        graph.pad_degree, importance=use_importance, mesh=mesh,
        owner_blocks=owner_blocks)
    k_sched, k_drop = jax.random.split(key)
    pack = schedule(k_sched, graph, batch_ids, degrees, spec.cv,
                    need_aw=spec.det_dropout,
                    importance=importance if use_importance else None,
                    round_multiple=cfg.dp, mesh=mesh,
                    owner_blocks=owner_blocks,
                    importance_rows=importance_rows,
                    dedup=cfg.field_dedup,
                    is_slot_cap=max(cfg.is_slot_cap, 0))
    return pack, unique_fields, k_drop


def build_eval_epoch(cfg: Config, spec: M.ModelSpec,
                     degrees: Tuple[int, ...], num_nodes: int, mesh=None,
                     with_preds: bool = False):
    """Whole-evaluation runner: scan of the eval step over [S, B] batch ids;
    returns per-batch losses/accuracies and stacked predictions with ONE
    host sync (train.py:133-160 equivalent).

    ``with_preds=True`` additionally stacks the per-node class
    probabilities ([S, B, C]) and their batch fields ([S, B]) in the
    output — the inference surface (reference get_pred, gcn/vrgcn.py:86;
    used by cli/infer.py).  Off by default: evaluation proper fetches only
    C-length counters, never multi-MB prediction matrices."""
    use_importance = cfg.test_importance
    owner_blocks = cfg.dp if (cfg.owner_batching and mesh is not None) else 0

    def _eval_one(params, histories, graph, features, labels, importance,
                  batch_ids, key, importance_rows=None):
        pack, unique_fields, k_drop = _eval_schedule(
            cfg, spec, degrees, num_nodes, graph, importance, batch_ids,
            key, use_importance, mesh=mesh, owner_blocks=owner_blocks,
            importance_rows=importance_rows)
        batch_field = pack.fields[-1]
        valid = (batch_field < num_nodes).astype(jnp.float32)
        y = _labels_gather(labels, batch_field, mesh, num_nodes)
        logits, new_h = M.forward(params, spec, pack, graph, histories,
                                  features, k_drop, cfg.keep_prob,
                                  train=False, mesh=mesh)
        loss, acc = M.loss_and_metrics(params, spec, logits, y, valid,
                                       cfg.weight_decay)
        from ..utils.metrics import device_f1_counts
        tp, fp, fn = device_f1_counts(logits, y, valid, spec.multitask)
        histories, _ = scatter_histories(
            histories, new_h, pack.fields, num_nodes, mesh=mesh,
            scatter_cap_mult=cfg.scatter_cap_mult, unique=unique_fields)
        out = (loss, acc, tp, fp, fn, jnp.sum(valid))
        if with_preds:
            out = out + (M.predict(spec, logits), batch_field)
        return histories, out

    def _epoch(params, histories, graph, features, labels, importance,
               batch_matrix, key):
        imp_rows = None
        if use_importance and cfg.is_row_table:
            from ..sampler.scheduler import importance_row_table
            imp_rows = importance_row_table(graph, importance)

        def body(hist, xs):
            batch_ids, k = xs
            hist, out = _eval_one(params, hist, graph, features, labels,
                                  importance, batch_ids, k,
                                  importance_rows=imp_rows)
            return hist, out

        keys = jax.random.split(key, batch_matrix.shape[0])
        histories, ys = jax.lax.scan(
            body, histories, (batch_matrix, keys), unroll=cfg.scan_unroll)
        losses, accs, tps, fps, fns, nvalid = ys[:6]
        # per-class counters summed over batches: evaluation fetches only
        # C-length vectors, never the [N, C] prediction matrix
        out = {"losses": losses, "accs": accs,
               "tp": jnp.sum(tps, axis=0),
               "fp": jnp.sum(fps, axis=0),
               "fn": jnp.sum(fns, axis=0),
               "nvalid": nvalid}
        if with_preds:
            out["preds"], out["fields"] = ys[6], ys[7]
        return histories, out

    return _epoch


def make_eval_epoch(cfg: Config, spec: M.ModelSpec,
                    degrees: Tuple[int, ...], num_nodes: int,
                    with_preds: bool = False):
    return jax.jit(build_eval_epoch(cfg, spec, degrees, num_nodes,
                                    with_preds=with_preds),
                   donate_argnums=(1,))


def make_eval_step(cfg: Config, spec: M.ModelSpec, degrees: Tuple[int, ...],
                   num_nodes: int):
    """Evaluation step (gcn/vrgcn.py:81-84): no dropout, no weight update,
    but WITH history refresh (test_op) when the eval model uses CV.

    Returns jitted ``(params, eval_histories, graph, features, labels,
    importance, batch_ids, key) -> (metrics, eval_histories')``.
    """
    use_importance = cfg.test_importance

    def _eval(params, histories, graph: PaddedGraph, features, labels,
              importance, batch_ids, key):
        pack, unique_fields, k_drop = _eval_schedule(
            cfg, spec, degrees, num_nodes, graph, importance, batch_ids,
            key, use_importance)
        batch_field = pack.fields[-1]
        valid = (batch_field < num_nodes).astype(jnp.float32)
        y = jnp.take(labels, batch_field, axis=0)

        logits, new_h = M.forward(params, spec, pack, graph, histories,
                                  features, k_drop, cfg.keep_prob,
                                  train=False)
        loss, acc = M.loss_and_metrics(params, spec, logits, y, valid,
                                       cfg.weight_decay)
        pred = M.predict(spec, logits)
        histories, _ = scatter_histories(histories, new_h,
                                         pack.fields, num_nodes,
                                         unique=unique_fields)
        return {"loss": loss, "accuracy": acc, "pred": pred,
                "valid": valid}, histories

    return jax.jit(_eval, donate_argnums=(1,))


def make_activation_taps(cfg: Config, spec: M.ModelSpec,
                         degrees: Tuple[int, ...], num_nodes: int,
                         train_mode: bool):
    """Per-layer activation moments for ONE batch — the reference's layer
    activation-logging surface (gcn/layers.py:111-137 histogram summaries,
    models.py:148-157 self.activations), exposed as a standalone debug
    probe instead of TF summaries.  Returns jitted ``(...) ->
    {label: (mean, std, absmax)}`` over the same inputs as an eval step."""
    use_importance = cfg.importance if train_mode else cfg.test_importance

    def _run(params, histories, graph, features, labels, importance,
             batch_ids, key):
        k_sched, k_drop = jax.random.split(key)
        pack = schedule(k_sched, graph, batch_ids, degrees, spec.cv,
                        need_aw=spec.det_dropout,
                        importance=importance if use_importance else None,
                        round_multiple=cfg.dp,
                        dedup=cfg.field_dedup,
                        is_slot_cap=cfg.is_slot_cap if train_mode
                        else max(cfg.is_slot_cap, 0))
        taps = []
        M.forward(params, spec, pack, graph, histories, features, k_drop,
                  cfg.keep_prob, train=train_mode, taps=taps)
        return {label: stats for label, *stats in taps}

    return jax.jit(_run)


def build_pred_and_grad(cfg: Config, spec: M.ModelSpec,
                        degrees: Tuple[int, ...], num_nodes: int,
                        train_mode: bool, mesh=None):
    """Raw get_pred_and_grad (gcn/vrgcn.py:86-93): prediction + d loss /
    d first layer weights, used by the gradient-variance harness
    (train.py:241-277).  Dropout IS applied (the reference feeds the
    dropout placeholder here).  ``mesh`` selects the sharded lowering
    (halo-exchange gathers, owner-aligned fields) exactly as in
    build_train_step — the estimator-bias instrument can then run through
    the SAME sharded code path the dp training step uses."""
    use_importance = cfg.importance if train_mode else cfg.test_importance
    owner_blocks = cfg.dp if (cfg.owner_batching and mesh is not None) else 0

    def _run(params, histories, graph, features, labels, importance,
             batch_ids, key):
        k_sched, k_drop = jax.random.split(key)
        pack = schedule(k_sched, graph, batch_ids, degrees, spec.cv,
                        need_aw=spec.det_dropout,
                        importance=importance if use_importance else None,
                        round_multiple=cfg.dp, mesh=mesh,
                        owner_blocks=owner_blocks,
                        dedup=cfg.field_dedup,
                        is_slot_cap=cfg.is_slot_cap if train_mode
                        else max(cfg.is_slot_cap, 0))
        batch_field = pack.fields[-1]
        valid = (batch_field < num_nodes).astype(jnp.float32)
        y = _labels_gather(labels, batch_field, mesh, num_nodes)

        def loss_fn(params):
            logits, _ = M.forward(params, spec, pack, graph, histories,
                                  features, k_drop, cfg.keep_prob,
                                  train=True, mesh=mesh)
            loss, _ = M.loss_and_metrics(params, spec, logits, y, valid,
                                         cfg.weight_decay)
            return loss, logits

        grads, logits = jax.grad(loss_fn, has_aux=True)(params)
        first = M.first_param_layer(spec)
        return M.predict(spec, logits), grads[first]["weights"]

    return _run


def make_pred_and_grad(cfg: Config, spec: M.ModelSpec,
                       degrees: Tuple[int, ...], num_nodes: int,
                       train_mode: bool):
    """Jitted single-chip pred_and_grad (sharded variant:
    parallel/mesh.py::make_sharded_pred_and_grad)."""
    return jax.jit(build_pred_and_grad(cfg, spec, degrees, num_nodes,
                                       train_mode))
