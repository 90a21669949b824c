"""CLI training driver — the gcn/train.py equivalent.

Usage::

    python -m stochastic_gcn_tpu.cli.train --dataset cora --cv --degree=1 ...

Flag names/semantics match the reference (train.py:25-67); dataset recipes
live in configs/*.sh.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import parse_flags
from ..data.loaders import load_data
from ..training.loop import Trainer


def main(argv=None):
    cfg = parse_flags(argv)
    np.random.seed(cfg.seed)
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    # multi-controller launch (--coordinator host:port): initialize before
    # any backend use; non-main processes run silently (identical compute,
    # process-0 owns the log stream the parsers consume)
    from ..parallel.distributed import maybe_initialize
    if maybe_initialize(cfg):
        import os
        sys.stdout = open(os.devnull, "w")

    ds = load_data(cfg)
    print("Features shape = {}, training edges = {}, testing edges = {}"
          .format(ds.feats.shape, ds.train_adj.nnz, ds.full_adj.nnz))
    print("{} training data, {} validation data, {} testing data.".format(
        len(ds.train_d), len(ds.val_d), len(ds.test_d)))

    if cfg.model == "mlp":
        # NeighbourMLP baseline (reference --model mlp, gcn/mlp.py)
        from ..models.mlp import MLPTrainer
        trainer = MLPTrainer(cfg, ds)
        for epoch in range(cfg.epochs):
            loss, acc = trainer.train_epoch()
            vloss, vacc, micro, macro = trainer.evaluate(ds.val_d)
            print(f"Epoch: {epoch + 1:04d} train_loss= {loss:.5f} "
                  f"train_acc= {acc:.5f} val_loss= {vloss:.5f} "
                  f"val_acc= {vacc:.5f} mi F1={micro:.5f} ma F1={macro:.5f}")
        tloss, tacc, micro, macro = trainer.evaluate(ds.test_d)
        print(f"Test set results: cost= {tloss:.5f} accuracy= {tacc:.5f} "
              f"mi F1={micro:.5f} ma F1={macro:.5f}  time= 0.00000")
        return trainer

    trainer = Trainer(cfg, ds)
    # preemption (SIGTERM) → finish the epoch, checkpoint, exit cleanly;
    # relaunching the same command with --resume continues from there
    trainer.install_preemption_handler()
    trainer.sgd_train()

    if trainer.stop_requested:
        # preempted: the checkpoint is already written.  Exit now instead
        # of burning the eviction grace window on gradvar / the
        # (num_layers+1)-pass test_cv evaluation — a --resume relaunch
        # finishes training and runs them.
        return trainer

    if cfg.gradvar:
        trainer.gradient_variance()

    trainer.run_tests()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
