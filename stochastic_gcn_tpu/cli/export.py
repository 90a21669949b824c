"""Export a trained model as a portable serving artifact (jax.export).

Loads a checkpoint (same flags as training — cli/train.py), converges the
CV eval histories under the final weights, and writes a StableHLO module +
serving-state npz that any jax runtime can serve WITHOUT this package's
model code (see serving.py):

    python -m stochastic_gcn_tpu.cli.export --dataset cora --cv --test_cv \
        --out model.export [any training flags]

Serving side::

    from stochastic_gcn_tpu.serving import load_predictor
    probs = load_predictor("model.export").predict([3, 17, 42])
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out", default="model.export",
                   help="artifact directory (module.shlo + state.npz + "
                        "manifest.json)")
    p.add_argument("--platforms", default="",
                   help="comma-separated lowering targets, e.g. cpu,cuda "
                        "for an artifact that serves on either fleet "
                        "(default: current backend only)")
    p.add_argument("--scan_batches", type=int, default=1,
                   help="batches per exported device call (the scan runs "
                        "on-device; larger values amortize per-call "
                        "dispatch for bulk serving)")
    own, rest = p.parse_known_args(argv)

    from ..config import parse_flags
    cfg = parse_flags(rest)

    from ..data.loaders import load_data
    from ..serving import export_predictor
    from ..training.loop import Trainer
    ds = load_data(cfg)
    trainer = Trainer(cfg, ds)
    trainer.load(load_history=True)

    plats = tuple(s.strip() for s in own.platforms.split(",")
                  if s.strip())
    t0 = time.time()
    path = export_predictor(trainer, own.out, platforms=plats,
                            scan_batches=own.scan_batches)
    print(f"Serving artifact written to: {path}  "
          f"time= {time.time() - t0:.5f}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
