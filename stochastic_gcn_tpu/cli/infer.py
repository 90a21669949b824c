"""Inference/serving driver — batched prediction from a saved checkpoint.

The reference has no standalone inference entry point: its predictions are
only reachable through train.py's Test() path (train.py:320-341), which
re-runs the whole training driver.  This surface loads a checkpoint
(params + optimizer + histories + RNG — training/checkpoint.py) and emits
per-node class probabilities through the same jitted eval pipeline, with
the CV history-convergence protocol applied automatically (num_layers
refresh passes, train.py:339-341).

Usage::

    python -m stochastic_gcn_tpu.cli.infer --dataset cora --cv --test_cv \
        --nodes test --out preds.npz [any training flags]

``--nodes`` selects the id set: ``test`` / ``val`` / ``train`` / ``all``,
or an explicit comma-separated id list.  ``--out`` writes an npz with
``ids`` (original id space), ``probs`` ([n, C] float32 class
probabilities) and ``pred`` (argmax class, or the 0.5-thresholded
multi-label matrix for multitask datasets).  All model/dataset flags are
the training CLI's (config.py) and must match the checkpointed run.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _select_ids(spec: str, ds):
    named = {"test": ds.test_d, "val": ds.val_d, "train": ds.train_d,
             "all": np.arange(ds.num_data, dtype=np.int32)}
    if spec in named:
        return np.asarray(named[spec], np.int64)
    return np.asarray([int(s) for s in spec.split(",") if s], np.int64)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--nodes", default="test",
                   help="test|val|train|all or comma-separated node ids")
    p.add_argument("--out", default="",
                   help="npz output path (ids, probs, pred)")
    p.add_argument("--norefresh", action="store_true",
                   help="skip the CV history-convergence passes")
    own, rest = p.parse_known_args(argv)

    from ..config import parse_flags
    cfg = parse_flags(rest)
    np.random.seed(cfg.seed)
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ..parallel.distributed import maybe_initialize
    if maybe_initialize(cfg):
        import os
        sys.stdout = open(os.devnull, "w")

    from ..data.loaders import load_data
    from ..training.loop import Trainer
    ds = load_data(cfg)
    trainer = Trainer(cfg, ds)
    trainer.load(load_history=True)

    ids = _select_ids(own.nodes, ds)
    t0 = time.time()
    probs = trainer.predict(ids, refresh=not own.norefresh)
    dur = time.time() - t0
    if cfg.multitask:
        pred = (probs > 0.5).astype(np.int32)
    else:
        pred = np.argmax(probs, axis=1).astype(np.int32)

    # summary in the reference's Test-line shape, where labels exist
    labels = np.asarray(ds.labels)[ids]
    if labels.size and labels.sum() > 0:
        from ..utils.metrics import calc_f1
        micro, macro = calc_f1(probs, labels, cfg.multitask)
        if cfg.multitask:
            acc = float((pred == labels).mean())
        else:
            acc = float((pred == np.argmax(labels, axis=1)).mean())
        print(f"Inference results: nodes= {len(ids)} accuracy= {acc:.5f} "
              f"mi F1={micro:.5f} ma F1={macro:.5f}  time= {dur:.5f}")
    else:
        print(f"Inference results: nodes= {len(ids)}  time= {dur:.5f}")

    if own.out:
        np.savez(own.out, ids=ids.astype(np.int64), probs=probs, pred=pred)
        print(f"Predictions saved in file: {own.out}")
    return probs


if __name__ == "__main__":
    main(sys.argv[1:])
