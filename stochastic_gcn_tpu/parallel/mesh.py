"""Device-mesh utilities and sharded training-step construction.

The reference has NO multi-device support of any kind (single tf.Session,
single GPU — SURVEY.md §2.3).  This module is the scale-out layer this
design adds: a 1-D ``('data',)`` mesh where the minibatch (and hence each
layer's receptive field work) is sharded across devices, parameters/graph/
history are replicated, and XLA's SPMD partitioner inserts the gradient
all-reduce and the history-update all-gathers (NCCL collectives on GPUs).

With ``shard_history`` the [N, d] history buffers are sharded along the
node dimension (each chip owns N/P rows), and ``cfg.halo_exchange`` routes
the history gathers through an explicit halo exchange (owner-side
contraction + psum_scatter, models/aggregators.py) instead of GSPMD's
default whole-history all-gather — per SURVEY.md §5.8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data",
              hosts: int = 1,
              tp: int = 1) -> Mesh:
    """('data',) mesh over the first ``n_devices`` devices, or a 2-D
    ('data', 'model') mesh when ``tp > 1`` (``n_devices`` then counts the
    data axis; total chips = n_devices * tp).  The model axis is innermost;
    every halo helper keys off the FIRST axis and leaves 'model' auto
    (parallel/halo.py::data_axis_size).  The cards of one host reach each
    other all to all, so device order within a host does not matter.

    ``hosts`` declares a (hosts, n_devices/hosts) grid flattened
    HOST-MAJOR: all chips of host 0 first, then host 1, ... — the order
    ``jax.devices()`` already yields under ``jax.distributed.initialize``
    (devices sorted by process index).  Everything downstream keeps the
    single logical 'data' axis, but because row-sharding assigns
    contiguous node blocks along the axis, host-major order means each
    host owns a contiguous N/H slice and the halo exchanges
    (parallel/halo.py) cross the host network only for rows owned by
    other hosts.  On a single process this validates the
    shape and documents the layout; under multi-controller JAX the same
    code runs unchanged.
    """
    devices = jax.devices()
    total = None if n_devices is None else n_devices * tp
    if total is not None:
        if len(devices) < total:
            raise ValueError(
                f"requested {total} devices, have {len(devices)}")
        devices = devices[:total]
    if hosts > 1:
        if len(devices) % hosts:
            raise ValueError(
                f"{len(devices)} devices do not tile over {hosts} hosts")
        # verify host-major process grouping when real process info exists
        per = len(devices) // hosts
        procs = [getattr(d, "process_index", 0) for d in devices]
        if procs != sorted(procs):
            # re-sort into process-major order (stable within a process)
            devices = [d for _, d in sorted(
                enumerate(devices), key=lambda t: (procs[t[0]], t[0]))]
        del per
    if tp > 1:
        if len(devices) % tp:
            raise ValueError(f"{len(devices)} devices do not tile over "
                             f"tp={tp}")
        grid = np.asarray(devices).reshape(len(devices) // tp, tp)
        return Mesh(grid, (axis_name, "model"))
    return Mesh(np.asarray(devices), (axis_name,))


def mesh_host_shape(mesh: Mesh, hosts: int) -> tuple:
    """(hosts, chips_per_host) view of a host-major 1-D mesh."""
    return (hosts, mesh.devices.size // hosts)


def _halo_spec(cfg, mesh: Mesh):
    """Mesh + halo-transport knobs threaded to the step (parallel/halo.py).
    gather_cap_mult 0 = auto: 2.0 for shuffled batches, 0.5 under
    owner-aligned batching (requests are ~97-100% chip-local, so the
    fetch spill buffers shrink 4x; overflow falls back in-graph to the
    exact psum path, so any capacity is safe)."""
    from .halo import GATHER_CAP_MULT, HaloSpec
    gcap = cfg.gather_cap_mult or (0.5 if cfg.owner_batching
                                   else GATHER_CAP_MULT)
    return HaloSpec(mesh, gcap)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def row_sharded(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """[N, d] arrays sharded along the node dimension."""
    return NamedSharding(mesh, P(axis_name, None))


def data_shardings(mesh: Mesh, data, shard_graph: bool):
    """Sharding pytree for the per-call data arguments (graph, features,
    labels).  With ``shard_graph`` every table whose row count tiles over
    the mesh is sharded along the node dimension — [N, Dcap] graph rows,
    [N, d] features (dense or PaddedSparseFeatures idx/val), [N, C] labels
    — so per-device memory scales as N/P for every O(N) table; row
    accesses are owner-routed (parallel/halo.py).  Small [N] vectors (degrees, block
    starts) stay replicated by design.  :class:`FlatGraph` block tables
    shard into their per-chip tiles when built with ``parts == P``
    (flat_csr(..., parts)); otherwise they replicate — their [NB, B] rows
    index BLOCKS, not nodes, so the generic node-row rule must not touch
    them."""
    import jax.tree_util as jtu

    from ..data.graph import FlatGraph

    repl = replicated(mesh)
    if not shard_graph:
        return jtu.tree_map(lambda _: repl, data)
    p = dict(mesh.shape)["data"]   # rows shard over the data axis only
    rs = row_sharded(mesh)

    def rule(x):
        return rs if (getattr(x, "ndim", 0) >= 2
                      and x.shape[0] % p == 0) else repl

    def outer(x):
        if isinstance(x, FlatGraph):
            if x.parts == p:
                # block tables built for this partition count: shard them
                # into their per-chip tiles; bstart/deg stay replicated
                return jtu.tree_map(
                    lambda l: rs if (l.ndim >= 2 and l.shape[0] % p == 0)
                    else repl, x)
            return jtu.tree_map(lambda _: repl, x)
        return rule(x)
    return jtu.tree_map(outer, data,
                        is_leaf=lambda x: isinstance(x, FlatGraph))


def param_sharding_rule(mesh: Mesh):
    """Per-leaf tensor-parallel sharding rule (SURVEY.md §2.3 'optional
    (model) axis for very wide hidden dims').

    On a ('data', 'model') mesh: matrices shard their OUTPUT (hidden)
    dimension over 'model' — Megatron-style column parallelism for Dense
    weights [in, out]; 1-D offset/scale vectors shard likewise so each
    chip holds the norm params of its own hidden columns.  Leaves whose
    dims don't tile over the model axis (e.g. the [H, num_classes] output
    head with a small class count) stay replicated; GSPMD inserts the
    boundary collectives.  On a 1-D mesh everything is replicated."""
    repl = replicated(mesh)
    tp = dict(mesh.shape).get("model", 1)

    def rule(x):
        nd = getattr(x, "ndim", 0)
        if tp > 1 and nd == 2 and x.shape[1] % tp == 0:
            return NamedSharding(mesh, P(None, "model"))
        if tp > 1 and nd == 1 and x.shape[0] % tp == 0:
            return NamedSharding(mesh, P("model"))
        return repl
    return rule


def state_shardings(mesh: Mesh, state, shard_history: bool):
    """Sharding pytree matching a TrainState: params/opt replicated over
    'data' (tp-sharded over 'model' when present — see
    :func:`param_sharding_rule`), histories row-sharded along the node
    dimension (column-sharded over 'model' too when it tiles)."""
    import jax.tree_util as jtu
    from ..training.step import TrainState

    repl = replicated(mesh)
    prule = param_sharding_rule(mesh)
    return TrainState(
        params=jtu.tree_map(prule, state.params),
        opt_state=jtu.tree_map(prule, state.opt_state),
        histories=history_shardings(mesh, state.histories, shard_history),
        step=repl,
        avg_params=jtu.tree_map(prule, state.avg_params),
    )


def history_shardings(mesh: Mesh, hist_template, shard_history: bool = True):
    """Sharding tree for a bare histories tuple (e.g. eval-side buffers):
    rows over 'data', columns over 'model' when they tile."""
    import jax.tree_util as jtu
    repl = replicated(mesh)
    tp = dict(mesh.shape).get("model", 1)

    def hrule(x):
        if not shard_history:
            return repl
        if tp > 1 and x.ndim == 2 and x.shape[1] % tp == 0:
            return NamedSharding(mesh, P("data", "model"))
        return row_sharded(mesh)
    return jtu.tree_map(hrule, hist_template)


def global_put(tree, shardings):
    """Commit a host-value pytree to its shardings; works under
    multi-controller launches where every process holds the same full
    host value (checkpoint restore path).  Leaves that are ALREADY
    committed global device arrays (e.g. the live sharded histories kept
    by ``load(load_history=False)``) pass through untouched — they cannot
    be np.asarray'd from one controller and need no re-commit."""
    import jax.tree_util as jtu
    import numpy as np

    def put(x, s):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return x
        if jax.process_count() > 1:
            arr = np.asarray(x)
            return jax.make_array_from_callback(
                arr.shape, s, lambda idx: arr[idx])
        return jax.device_put(x, s)
    return jtu.tree_map(put, tree, shardings)


def make_sharded_train_step(cfg, spec, degrees: Tuple[int, ...],
                            num_nodes: int, mesh: Mesh,
                            state_template=None,
                            shard_history: bool = False,
                            data_template=None,
                            shard_graph: bool = False):
    """Data-parallel version of :func:`training.step.make_train_step`.

    Sharding layout:
      params/opt — replicated (gradient all-reduce inserted by GSPMD).
      histories — replicated by default; with ``shard_history`` the
        per-layer [N+1, d] buffers are sharded along the NODE dimension
        (each chip owns N/P history rows — the memory-scaling layout from
        SURVEY.md §5.8); ``cfg.halo_exchange`` selects the explicit
        halo-exchange lowering for the history gathers.
      graph/features/labels — replicated by default; with ``shard_graph``
        (and ``data_template=(graph, features, labels)`` row-padded via
        data/graph.py::pad_graph_rows) their node-row tables are sharded
        along N too (see :func:`data_shardings`).
      batch_ids — sharded along the 'data' axis.
    """
    from ..training.step import build_train_step

    repl = replicated(mesh)
    shard = batch_sharded(mesh)
    halo = _halo_spec(cfg, mesh) \
        if (cfg.halo_exchange and (shard_history or shard_graph)) else None
    inner = build_train_step(cfg, spec, degrees, num_nodes, mesh=halo)

    if state_template is not None:
        st_sh = state_shardings(mesh, state_template, shard_history)
    else:
        st_sh = repl
    if data_template is not None:
        g_sh, f_sh, l_sh = data_shardings(mesh, data_template, shard_graph)
    else:
        g_sh = f_sh = l_sh = repl
    return jax.jit(
        inner,
        in_shardings=(st_sh, g_sh, f_sh, l_sh, repl, shard, repl),
        out_shardings=(st_sh, repl),
        donate_argnums=(0,),
    )


def make_sharded_train_epoch(cfg, spec, degrees: Tuple[int, ...],
                             num_nodes: int, mesh: Mesh, state_template,
                             shard_history: bool = False,
                             data_template=None,
                             shard_graph: bool = False):
    """Sharded whole-epoch scan (see training/step.py::make_train_epoch):
    the [S, B] batch matrix is sharded along B over the 'data' axis."""
    from ..training.step import build_train_epoch

    repl = replicated(mesh)
    bm_sh = NamedSharding(mesh, P(None, "data"))
    st_sh = state_shardings(mesh, state_template, shard_history)
    halo = _halo_spec(cfg, mesh) \
        if (cfg.halo_exchange and (shard_history or shard_graph)) else None
    inner = build_train_epoch(cfg, spec, degrees, num_nodes, mesh=halo)

    if data_template is not None:
        g_sh, f_sh, l_sh = data_shardings(mesh, data_template, shard_graph)
    else:
        g_sh = f_sh = l_sh = repl
    return jax.jit(
        inner,
        in_shardings=(st_sh, g_sh, f_sh, l_sh, repl, bm_sh, repl),
        out_shardings=(st_sh, repl),
        donate_argnums=(0,),
    )


def make_sharded_eval_epoch(cfg, spec, degrees: Tuple[int, ...],
                            num_nodes: int, mesh: Mesh, hist_template,
                            shard_history: bool = False,
                            data_template=None,
                            shard_graph: bool = False,
                            params_template=None,
                            with_preds: bool = False):
    import jax.tree_util as jtu
    from ..training.step import build_eval_epoch

    repl = replicated(mesh)
    # eval consumes the train-side params in their training layout
    # (tp-sharded over 'model' when present)
    p_sh = jtu.tree_map(param_sharding_rule(mesh), params_template) \
        if params_template is not None else repl
    bm_sh = NamedSharding(mesh, P(None, "data"))
    hist_sh = history_shardings(mesh, hist_template, shard_history)
    halo = _halo_spec(cfg, mesh) \
        if (cfg.halo_exchange and (shard_history or shard_graph)) else None
    inner = build_eval_epoch(cfg, spec, degrees, num_nodes, mesh=halo,
                             with_preds=with_preds)

    if data_template is not None:
        g_sh, f_sh, l_sh = data_shardings(mesh, data_template, shard_graph)
    else:
        g_sh = f_sh = l_sh = repl
    return jax.jit(
        inner,
        in_shardings=(p_sh, hist_sh, g_sh, f_sh, l_sh, repl, bm_sh, repl),
        out_shardings=(hist_sh, repl),
        donate_argnums=(1,),
    )


def make_sharded_pred_and_grad(cfg, spec, degrees: Tuple[int, ...],
                               num_nodes: int, mesh: Mesh,
                               train_mode: bool, hist_template,
                               shard_history: bool = False,
                               data_template=None,
                               shard_graph: bool = False,
                               params_template=None):
    """Sharded get_pred_and_grad for the gradient-variance harness:
    the estimator-bias instrument runs through the SAME
    dp lowering as training (node-sharded tables, halo gathers,
    owner-aligned fields) instead of the single-device step.  Histories
    are read-only here (no scatter, no donation); predictions and the
    first-layer gradient come back replicated."""
    import jax.tree_util as jtu

    from ..training.step import build_pred_and_grad

    repl = replicated(mesh)
    shard = batch_sharded(mesh)
    p_sh = jtu.tree_map(param_sharding_rule(mesh), params_template) \
        if params_template is not None else repl
    hist_sh = history_shardings(mesh, hist_template, shard_history)
    halo = _halo_spec(cfg, mesh) \
        if (cfg.halo_exchange and (shard_history or shard_graph)) else None
    inner = build_pred_and_grad(cfg, spec, degrees, num_nodes, train_mode,
                                mesh=halo)
    if data_template is not None:
        g_sh, f_sh, l_sh = data_shardings(mesh, data_template, shard_graph)
    else:
        g_sh = f_sh = l_sh = repl
    return jax.jit(
        inner,
        in_shardings=(p_sh, hist_sh, g_sh, f_sh, l_sh, repl, shard, repl),
        out_shardings=repl,
    )


def shard_rows(num_nodes: int, dp: int) -> int:
    """Rows of the row-sharded history tables ([N+1] padded to a multiple
    of max(8, dp) — models/gcn.py::init_histories) — the layout that
    defines node ownership: node v is owned by chip v // (rows/dp)."""
    m = max(8, dp)
    return -(-(num_nodes + 1) // m) * m


def owner_grouped_batch_matrix(ids, batch_size: int, num_nodes: int,
                               dp: int) -> np.ndarray:
    """[S, B] epoch batch matrix with partition-aware slot assignment
    (cfg.owner_batching).

    The matrix is sharded P(None, 'data') along B, so chip q executes
    columns [q·B/P, (q+1)·B/P) of every step.  Those slots are filled
    with ids whose history/graph rows chip q owns (contiguous-block
    row-sharding), making the batch field's history reads and writes
    chip-local; ids overflowing their owner's slot budget spill into
    other chips' free slots so each id still appears EXACTLY once per
    epoch (the reference's epoch-coverage contract, train.py:181-190).
    Remaining free slots hold the sentinel ``num_nodes``.  ``ids`` should
    arrive epoch-shuffled; grouping makes batches owner-stratified
    samples rather than uniform draws (documented deviation).
    """
    ids = np.asarray(ids, np.int32)
    n_loc = shard_rows(num_nodes, dp) // dp
    b_loc = batch_size // dp
    s = max(1, -(-len(ids) // batch_size))
    out = np.full((s, dp, b_loc), num_nodes, np.int32)
    owner = np.minimum(ids // n_loc, dp - 1)
    spill = []
    for q in range(dp):
        mine = ids[owner == q]
        take = mine[:s * b_loc]
        spill.append(mine[s * b_loc:])
        out[:, q, :].flat[:len(take)] = take
    spill = np.concatenate(spill)
    flat = out.reshape(s * batch_size)
    free = np.flatnonzero(flat == num_nodes)
    flat[free[:len(spill)]] = spill
    return out.reshape(s, batch_size)


def pad_batch_for_mesh(batch: np.ndarray, n_devices: int,
                       num_nodes: int) -> np.ndarray:
    """Pad a batch so its length divides the mesh size (sentinel padding)."""
    rem = len(batch) % n_devices
    if rem == 0:
        return batch
    pad = np.full(n_devices - rem, num_nodes, np.int32)
    return np.concatenate([np.asarray(batch, np.int32), pad])
