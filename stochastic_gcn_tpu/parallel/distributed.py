"""Multi-controller (multi-process / multi-host) launch support.

The reference is strictly single-process (SURVEY.md §2.3: one tf.Session,
no distribution of any kind).  This framework's sharded step already runs
unchanged under multi-controller JAX — `make_mesh` builds the host-major
('data'[, 'model']) mesh from the globally-enumerated device list, every
O(N) table is row-sharded so each host owns a contiguous node block, and
the halo exchanges cross the host network only for remote-host rows.
This module adds the process bootstrap:

* :func:`maybe_initialize` — call `jax.distributed.initialize` from the
  CLI flags (`--coordinator host:port --num_processes P --process_id i`),
  before any backend use.  Each process then sees its local chips plus
  the global device list.
* :func:`is_main` / :func:`process_count` — gating helpers (logging and
  checkpoint writes happen on process 0).

Every process feeds the SAME host data: dataset loading, epoch shuffles
and batch matrices are seeded identically, so all controllers trace and
dispatch identical programs (the multi-controller contract).  Validated
end-to-end by tests/test_multiprocess.py, which runs a real 2-process
dp=8 training epoch over localhost.
"""

from __future__ import annotations

import jax


def local_device_ids(process_id: int, num_processes: int, hosts: int):
    """The GPU ids this process opens: with several processes on one host
    (``num_processes / hosts`` of them, host-major process ids), process
    ``i`` takes card ``i`` modulo that count; with one process per host,
    None (every local card).  A JAX process reserves most of a card's
    memory when it first opens it, so two processes that both opened
    every card would fail for want of memory."""
    per_host = max(1, num_processes // max(1, hosts))
    if per_host == 1:
        return None
    return [process_id % per_host]


def maybe_initialize(cfg) -> int:
    """Initialize multi-controller JAX when --coordinator is set; returns
    this process's index (0 when single-process).  ``--dp_hosts`` says
    how many hosts the processes span (see :func:`local_device_ids`)."""
    if not getattr(cfg, "coordinator", ""):
        return 0
    jax.distributed.initialize(
        coordinator_address=cfg.coordinator,
        num_processes=cfg.num_processes,
        process_id=cfg.process_id,
        local_device_ids=local_device_ids(cfg.process_id, cfg.num_processes,
                                          cfg.dp_hosts))
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def allreduce_flag(flag: bool) -> bool:
    """Max-reduce a host-side boolean across processes so every controller
    takes the same branch at a synchronization point (e.g. the preemption
    stop check at an epoch boundary — SIGTERM delivery can race the check,
    and a split decision would mismatch the final save's collective shard
    gathers against another process's gradient all-reduce).  Single
    process: returns the flag unchanged without touching the device."""
    if jax.process_count() == 1:
        return bool(flag)
    import numpy as np
    from jax.experimental import multihost_utils
    gathered = multihost_utils.process_allgather(
        np.asarray([1 if flag else 0], np.int32))
    return bool(np.max(gathered))


def is_main() -> bool:
    return jax.process_index() == 0
