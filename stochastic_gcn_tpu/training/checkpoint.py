"""Checkpoint / resume.

The reference saves trainable vars + history Variables once at the end of
training via tf.train.Saver (gcn/models.py:204-220, train.py:238) to
``tmp/model.ckpt``.  Here the whole train state (params, Adam state,
per-layer histories, RNG key) round-trips through a single compressed npz —
covering the reference's save/load plus optimizer state and sampler RNG,
which the reference loses on resume.

Format: one npz entry per pytree leaf, keyed by the leaf's keypath string
(``jax.tree_util.keystr``).  The tree STRUCTURE is never serialized — it is
rebuilt from the caller's state template on load — so loading a corrupted or
untrusted checkpoint can never execute code (no pickle anywhere).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

import jax

_LEAF_PREFIX = "leaf:"
_BF16_PREFIX = "bf16leaf:"   # bfloat16 stored as a uint16 bit view (npz has
                             # no native bfloat16; pickle stays banned)
_EXTRA_PREFIX = "extra:"     # loop counters for --resume (epoch, amt_data,
                             # early-stop window) — plain numeric arrays
                             # OUTSIDE the state pytree, so checkpoints
                             # stay loadable by templates that predate them
_AVG_PATH_PREFIX = "['state'].avg_params"


def _path_leaves(payload):
    """[(keypath string, leaf)] in deterministic tree order."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(payload)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat], \
        treedef


def _leaf_to_numpy(leaf):
    """Host value of a leaf.  Under a multi-controller launch, row-sharded
    leaves (histories) are not fully addressable from one process — gather
    the global value over the host network first (every process must
    participate)."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(leaf,
                                                            tiled=True))
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, state, eval_histories, key,
                    name: str = "model", extra: dict = None,
                    compress: bool = True) -> str:
    """Write the full train state.  Multi-controller: all processes join
    the shard gathers, process 0 writes the file (assumed on a shared
    filesystem for later --load), and a barrier keeps save/load ordered.

    ``extra``: optional {str: numeric scalar/array} of loop counters for
    --resume, stored outside the state pytree (ignored by plain --load)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.ckpt.npz")
    payload = {"state": state, "eval_histories": eval_histories, "key": key}
    flat, _ = _path_leaves(payload)
    arrays = {}
    for k, leaf in flat:
        a = _leaf_to_numpy(leaf)
        if a.dtype == jax.numpy.bfloat16:
            arrays[_BF16_PREFIX + k] = a.view(np.uint16)
        else:
            arrays[_LEAF_PREFIX + k] = a
    for k, v in (extra or {}).items():
        arrays[_EXTRA_PREFIX + k] = np.asarray(v)
    from ..parallel.distributed import is_main, process_count
    if is_main():
        # compression is the dominant save cost at scale (zlib on the
        # host); --nockpt_compress trades disk for preemption-snapshot
        # speed.  np.load reads both transparently.
        writer = np.savez_compressed if compress else np.savez
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            writer(f, **arrays)
        os.replace(tmp, path)     # atomic: a crash mid-write leaves the
        print(f"Model saved in file: {path}")   # previous snapshot intact
    if process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("checkpoint_saved")
    return path


class AsyncCheckpointer:
    """Double-buffered checkpoint writer: the synchronous fetch + write
    sits on the epoch loop's critical path, seconds per --ckpt_every at
    Reddit scale.

    ``save()`` snapshots every device leaf into FRESH device buffers (one
    on-device copy — this decouples the snapshot from the next train
    step's buffer donation of the live state), starts the device→host
    transfers asynchronously, and hands the materialize + npz write to a
    background thread.  The next epoch's scan overlaps the transfer and
    the write; only the on-chip copy remains on the critical path.
    (Opt-in via --ckpt_async: the overlap requires a device->host path
    that runs concurrently with compute; not yet measured on a GPU.)

    Crash consistency: the thread writes ``<name>.ckpt.npz.tmp`` and
    atomically renames over the real file, so a crash or kill mid-write
    leaves the previous complete snapshot loadable.  ``wait()`` joins the
    pending write and re-raises any writer error; callers must wait
    before reading the file back (load/resume) and before process exit
    (the final save).  Single-controller only — multi-controller saves
    need collective shard gathers that cannot overlap the next epoch's
    collectives (Trainer.save falls back to the sync path there).
    """

    def __init__(self):
        self._thread = None
        self._error = None

    @property
    def pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, ckpt_dir: str, state, eval_histories, key,
             name: str = "model", extra: dict = None,
             compress: bool = True) -> str:
        import threading

        import jax.numpy as jnp

        self.wait()                   # serialize with any pending write
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"{name}.ckpt.npz")
        payload = {"state": state, "eval_histories": eval_histories,
                   "key": key}
        flat, _ = _path_leaves(payload)
        snap = []
        for k, leaf in flat:
            if isinstance(leaf, jax.Array):
                # fresh buffer, on device; the device->host transfer
                # happens on the WRITER THREAD (np.asarray below), so the
                # caller never waits for it
                snap.append((k, jnp.copy(leaf)))
            else:
                snap.append((k, np.asarray(leaf)))
        extra_np = {k: np.asarray(v) for k, v in (extra or {}).items()}

        def _write():
            try:
                arrays = {}
                for k, leaf in snap:
                    a = np.asarray(leaf)      # completes the async D2H
                    if a.dtype == jnp.bfloat16:
                        arrays[_BF16_PREFIX + k] = a.view(np.uint16)
                    else:
                        arrays[_LEAF_PREFIX + k] = a
                for k, v in extra_np.items():
                    arrays[_EXTRA_PREFIX + k] = v
                writer = np.savez_compressed if compress else np.savez
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    writer(f, **arrays)
                os.replace(tmp, path)         # atomic publish
                print(f"Model saved in file: {path}")
            except BaseException as e:        # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()
        return path


def load_loop_extras(ckpt_dir: str, name: str = "model") -> dict:
    """The --resume loop counters stored alongside the state (empty dict
    for checkpoints written before resume support, or by bare save())."""
    path = os.path.join(ckpt_dir, f"{name}.ckpt.npz")
    with np.load(path, allow_pickle=False) as z:
        return {k[len(_EXTRA_PREFIX):]: z[k] for k in z.files
                if k.startswith(_EXTRA_PREFIX)}


def load_checkpoint(ckpt_dir: str, state_template, eval_hist_template,
                    key_template, load_history: bool = True,
                    name: str = "model"):
    path = os.path.join(ckpt_dir, f"{name}.ckpt.npz")
    with np.load(path, allow_pickle=False) as z:
        stored = {}
        for k in z.files:
            if k.startswith(_LEAF_PREFIX):
                stored[k[len(_LEAF_PREFIX):]] = k
            elif k.startswith(_BF16_PREFIX):
                stored[k[len(_BF16_PREFIX):]] = k
        return _rebuild_from_arrays(
            path, z, stored, state_template, eval_hist_template,
            key_template, load_history)


def _rebuild_from_arrays(path, z, stored, state_template,
                         eval_hist_template, key_template, load_history):

    # Reconcile the Polyak average with the CURRENT run's polyak_decay
    # BEFORE rebuilding the tree: a checkpoint saved without it must not
    # clobber a resuming polyak run (re-seed the average from the restored
    # weights below); conversely a saved average is dropped when the new
    # run has polyak off (its leaves are simply never read).
    ckpt_has_avg = any(k.startswith(_AVG_PATH_PREFIX) for k in stored)
    tmpl_has_avg = getattr(state_template, "avg_params", None) is not None
    seed_avg_from_params = tmpl_has_avg and not ckpt_has_avg
    tmpl_state = state_template
    if seed_avg_from_params:
        tmpl_state = dataclasses.replace(tmpl_state, avg_params=None)

    tmpl_payload = {"state": tmpl_state, "eval_histories": eval_hist_template,
                    "key": key_template}
    flat, treedef = _path_leaves(tmpl_payload)
    leaves = []
    for k, tmpl_leaf in flat:
        if k not in stored:
            raise KeyError(f"checkpoint {path} is missing leaf {k!r} "
                           "(saved under different model settings?)")
        arr = z[stored[k]]
        if stored[k].startswith(_BF16_PREFIX):
            arr = arr.view(jax.numpy.bfloat16)
        tshape = tuple(np.shape(tmpl_leaf))
        if tuple(arr.shape) != tshape:
            raise ValueError(
                f"checkpoint leaf {k!r} has shape {tuple(arr.shape)}, "
                f"expected {tshape}")
        leaves.append(arr)
    payload = jax.tree_util.tree_unflatten(treedef, leaves)
    state, eval_hist, key = (payload["state"], payload["eval_histories"],
                             payload["key"])
    if seed_avg_from_params:
        state = dataclasses.replace(
            state, avg_params=jax.tree_util.tree_map(np.array, state.params))
    if not load_history:
        # keep the caller's (zero) histories, restore weights/opt only
        state = dataclasses.replace(
            state, histories=state_template.histories)
        eval_hist = eval_hist_template
    print(f"Model restored from file: {path}")
    return state, eval_hist, key
