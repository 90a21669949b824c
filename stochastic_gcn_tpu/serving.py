"""Portable serving artifacts via ``jax.export`` (StableHLO).

The reference has no deployment story at all — its predictions only exist
inside the live TF1 training session (train.py:320-341).  Here the whole
jitted CV inference epoch (on-device receptive-field sampling + forward +
history refresh) is exported as a versioned StableHLO module plus a plain
npz of the serving state, so a server can run predictions with ANY jax
runtime — no model-building code, no Trainer, no scipy graph pipeline:

    art = export_predictor(trainer, "model.export")      # after training
    ...
    pred = load_predictor("model.export")                 # serving side
    probs = pred.predict([3, 17, 42])                     # [3, C] float32

Contract notes:

* Export AFTER the CV histories have converged under the final weights
  (``export_predictor`` runs ``Trainer.predict``'s incremental refresh
  automatically).  At the CV fixed point the prediction is exact inference
  and independent of the sampling key (the Â_samp·(H - h̄) delta term
  vanishes), so serving is deterministic.
* The exported module's signature is a flat dict of arrays — no custom
  pytrees to register on the loader side; the model structure is baked
  into the traced module at export time.
* Single-host, single-chip artifact (the serving shape).  Mesh-sharded
  trainers must export from an unsharded twin.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

_MODULE = "module.shlo"
_STATE = "state.npz"
_MANIFEST = "manifest.json"
_BF16 = "bf16:"          # npz has no native bfloat16: store the bit view


def export_predictor(trainer, path: str, refresh: bool = True,
                     platforms: Sequence[str] = (),
                     scan_batches: int = 1) -> str:
    """Serialize ``trainer``'s inference surface to ``path`` (a directory).

    Writes the StableHLO module (one eval-epoch call over
    ``scan_batches`` x ``cfg.test_batch_size`` ids — the scan runs
    on-device, so larger ``scan_batches`` amortizes per-call dispatch
    exactly like the live trainer's scanned predict), the
    serving state (eval params — Polyak-averaged when enabled —
    converged eval histories, device graph, features, labels, importance
    table, and the relabeling map), and a manifest.

    ``platforms`` selects the lowering targets (e.g. ``("cpu", "cuda")``
    for an artifact that serves on either fleet); empty = the current
    backend only.
    """
    from jax import export as jexport

    if trainer.mesh is not None:
        raise ValueError("export_predictor serves the single-chip shape; "
                         "export from an unsharded trainer (dp=1)")
    cfg = trainer.cfg
    n = trainer.ds.num_data

    # the artifact bakes ONE sampling key, so serving is only faithful
    # when the eval config is deterministic: CV at the converged fixed
    # point (the delta term vanishes), or full-neighborhood sampling
    if not cfg.test_cv and cfg.test_degree < trainer.graph_full.pad_degree:
        import warnings
        warnings.warn(
            "exporting a SAMPLED eval config (test_cv off, test_degree "
            f"{cfg.test_degree} < max degree): the artifact freezes one "
            "neighbor sample per node forever and will diverge from live "
            "Trainer.predict; use --test_cv or a covering --test_degree "
            "for deterministic serving.", stacklevel=2)

    if refresh and cfg.test_cv:
        # converge the eval histories under the current weights (the Test
        # protocol, reference train.py:339-341) — predict() refreshes
        # incrementally and only when the weights changed
        trainer.predict(np.zeros((1,), np.int64), refresh=True)

    fn = trainer._get_predict_epoch()
    state_tree = (trainer._eval_params(), trainer.eval_histories,
                  trainer.graph_full, trainer.test_features,
                  trainer.labels, trainer.importance_test)
    leaves, treedef = jax.tree_util.tree_flatten(state_tree)
    names = [f"a{i}" for i in range(len(leaves))]

    def flat_predict(state, batch_matrix, key):
        args = jax.tree_util.tree_unflatten(
            treedef, [state[k] for k in names])
        _, out = fn(*args, batch_matrix, key)
        return out["preds"], out["fields"]

    b = cfg.test_batch_size
    spec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in zip(names, leaves)}
    bm_spec = jax.ShapeDtypeStruct((max(1, scan_batches), b), jnp.int32)
    key0 = jax.random.PRNGKey(cfg.seed)
    key_spec = jax.ShapeDtypeStruct(key0.shape, key0.dtype)
    kw = {"platforms": tuple(platforms)} if platforms else {}
    exported = jexport.export(jax.jit(flat_predict), **kw)(spec, bm_spec,
                                                           key_spec)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _MODULE), "wb") as f:
        f.write(exported.serialize())
    arrays = {}
    for k, leaf in zip(names, leaves):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            arrays[_BF16 + k] = a.view(np.uint16)
        else:
            arrays[k] = a
    if trainer._id_to_internal is not None:
        arrays["id_map"] = np.asarray(trainer._id_to_internal, np.int32)
    arrays["key"] = np.asarray(key0)
    with open(os.path.join(path, _STATE), "wb") as f:
        np.savez_compressed(f, **arrays)
    manifest = {"num_nodes": int(n),
                "num_classes": int(trainer.ds.num_classes),
                "batch_size": int(b),
                "scan_batches": int(max(1, scan_batches)),
                "multitask": bool(cfg.multitask),
                "names": names,
                "jax_version": jax.__version__}
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class Predictor:
    """Serving-side handle over an exported artifact (no model code)."""

    def __init__(self, path: str):
        from jax import export as jexport
        with open(os.path.join(path, _MODULE), "rb") as f:
            self._exported = jexport.deserialize(f.read())
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        self.num_nodes = m["num_nodes"]
        self.num_classes = m["num_classes"]
        self.batch_size = m["batch_size"]
        self.scan_batches = m.get("scan_batches", 1)  # pre-r5 artifacts
        self.multitask = m["multitask"]
        raw = dict(np.load(os.path.join(path, _STATE)))
        self._id_map = raw.pop("id_map", None)
        self._key = jnp.asarray(raw.pop("key"))
        self._state = {}
        for k, v in raw.items():
            if k.startswith(_BF16):
                self._state[k[len(_BF16):]] = jnp.asarray(
                    v.view(jnp.bfloat16))
            else:
                self._state[k] = jnp.asarray(v)

    def predict(self, data_ids: Sequence[int]) -> np.ndarray:
        """[len(ids), C] float32 class probabilities, caller id order."""
        ids = np.asarray(data_ids, np.int64)
        internal = (self._id_map[ids].astype(np.int32)
                    if self._id_map is not None
                    else ids.astype(np.int32))
        n, b = self.num_nodes, self.batch_size
        span = self.scan_batches * b          # ids served per device call
        by_id = np.zeros((n + 1, self.num_classes), np.float32)
        for lo in range(0, len(internal), span):
            chunk = internal[lo:lo + span]
            bm = np.full((self.scan_batches * b,), n, np.int32)
            bm[:len(chunk)] = chunk
            bm = bm.reshape(self.scan_batches, b)
            preds, fields = self._exported.call(self._state,
                                                jnp.asarray(bm), self._key)
            preds = np.asarray(preds).reshape(-1, self.num_classes)
            fields = np.asarray(fields).reshape(-1)
            valid = fields < n
            by_id[fields[valid]] = preds[valid]
        return by_id[internal]


def load_predictor(path: str) -> Predictor:
    return Predictor(path)
