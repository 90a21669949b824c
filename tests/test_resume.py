"""--resume: continue a preempted run from the periodic checkpoint with
the loop counters (epoch, amt_data, early-stop window) restored — the
elastic-recovery surface the reference lacks (SURVEY §5.3/5.4; --load
keeps the reference's restore-weights-and-skip-training semantics,
train.py:171-175)."""

import numpy as np
import pytest

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.training.checkpoint import load_loop_extras
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=200, feature_dim=16, num_classes=4,
                             avg_degree=6, seed=0)


def _cfg(tmp_path, **kw):
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, seed=1,
                early_stopping=100, ckpt_dir=str(tmp_path))
    base.update(kw)
    return Config(**base)


def test_resume_continues_epoch_count_and_counters(tmp_path, ds):
    """Interrupt after 2 epochs; a relaunched --resume trainer continues at
    epoch 3 with amt_data / cost_val carried over, and the final
    checkpoint records the combined run."""
    logs_a = []
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=logs_a.append, max_epochs=2)   # saves at the end
    amt_a, cost_a = tr.amt_data, list(tr.cost_val)
    assert tr.completed_epochs == 2 and len(cost_a) == 2 and amt_a > 0

    logs_b = []
    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    tr2.sgd_train(log=logs_b.append, max_epochs=4)
    joined = "\n".join(map(str, logs_b))
    assert "resume: continuing from epoch 3" in joined
    # exactly epochs 3 and 4 run — no repeat of 1/2
    assert "Epoch: 0003" in joined and "Epoch: 0004" in joined
    assert "Epoch: 0001" not in joined and "Epoch: 0002" not in joined
    # counters continued, not reset
    assert tr2.completed_epochs == 4
    assert tr2.amt_data > amt_a
    assert len(tr2.cost_val) == 4
    assert tr2.cost_val[:2] == pytest.approx(cost_a)
    # the final checkpoint carries the combined counters for the NEXT resume
    ex = load_loop_extras(str(tmp_path))
    assert int(ex["completed_epochs"]) == 4
    assert int(ex["amt_data"]) == tr2.amt_data
    assert len(ex["cost_val"]) == 4


def test_resume_starts_fresh_without_checkpoint(tmp_path, ds):
    """The same --resume command line works for the FIRST launch."""
    logs = []
    tr = Trainer(_cfg(tmp_path, resume=True), ds)
    tr.sgd_train(log=logs.append, max_epochs=1)
    joined = "\n".join(map(str, logs))
    assert "starting fresh" in joined and "Epoch: 0001" in joined
    assert tr.completed_epochs == 1


def test_resume_restores_weights_not_just_counters(tmp_path, ds):
    """The resumed trainer picks up the checkpointed state, not a fresh
    init: its evaluation is bit-identical to a plain --load of the same
    checkpoint (which shares the train.py:174 train→eval history copy),
    and differs from an untrained trainer's."""
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=3)

    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    tr2._try_resume(log=lambda *a, **k: None)
    tr3 = Trainer(_cfg(tmp_path), ds)
    tr3.load(load_history=True)
    cost_resumed, _, _, _, _ = tr2.evaluate(ds.val_d)
    cost_loaded, _, _, _, _ = tr3.evaluate(ds.val_d)
    assert cost_resumed == pytest.approx(cost_loaded, rel=1e-6)

    fresh_cost, _, _, _, _ = Trainer(_cfg(tmp_path), ds).evaluate(ds.val_d)
    assert abs(fresh_cost - cost_resumed) > 1e-3


def test_preemption_stop_checkpoints_for_resume(tmp_path, ds):
    """stop_requested (the SIGTERM path) exits at the epoch boundary with
    a checkpoint whose counters a --resume relaunch continues from."""
    tr = Trainer(_cfg(tmp_path), ds)

    logs = []

    def log(msg, *a, **k):
        logs.append(str(msg))
        if "Epoch: 0002" in str(msg):
            tr.stop_requested = True    # what the signal handler does

    tr.sgd_train(log=log, max_epochs=10)
    joined = "\n".join(logs)
    assert "Preemption stop after epoch 2" in joined
    assert "Epoch: 0003" not in joined
    assert int(load_loop_extras(str(tmp_path))["completed_epochs"]) == 2

    logs_b = []
    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    tr2.sgd_train(log=logs_b.append, max_epochs=3)
    assert "resume: continuing from epoch 3" in "\n".join(map(str, logs_b))


def test_sigterm_handler_sets_stop_and_chains(tmp_path, ds):
    """A real SIGTERM delivered to the process flips stop_requested via
    install_preemption_handler and chains to the previous handler."""
    import os
    import signal

    chained = []
    prev = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
        tr = Trainer(_cfg(tmp_path), ds)
        tr.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert tr.stop_requested
        assert chained == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_resume_from_pre_resume_checkpoint(tmp_path, ds):
    """A checkpoint written WITHOUT loop extras (pre-resume format, or a
    bare save_checkpoint call) still resumes: weights restored, counters
    default to zero."""
    from stochastic_gcn_tpu.training.checkpoint import save_checkpoint

    tr = Trainer(_cfg(tmp_path), ds)
    tr.train_epoch()
    save_checkpoint(str(tmp_path), tr.state, tr.eval_histories, tr.key)
    assert load_loop_extras(str(tmp_path)) == {}

    logs = []
    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    start = tr2._try_resume(log=logs.append)
    assert start == 0 and tr2.amt_data == 0 and tr2.cost_val == []
    assert "resume: continuing from epoch 1" in "\n".join(map(str, logs))


def test_uncompressed_checkpoint_roundtrips(tmp_path, ds):
    """--nockpt_compress writes a plain npz that load/resume read
    identically (np.load handles both formats transparently)."""
    import jax

    tr = Trainer(_cfg(tmp_path, ckpt_compress=False), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)

    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    assert tr2._try_resume(log=lambda *a, **k: None) == 1
    for a, b in zip(jax.tree_util.tree_leaves(tr.state.params),
                    jax.tree_util.tree_leaves(tr2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plain_load_ignores_extras(tmp_path, ds):
    """--load keeps reference semantics: weights restored, training
    skipped, loop counters untouched."""
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=2)

    logs = []
    tr2 = Trainer(_cfg(tmp_path, load=True), ds)
    tr2.sgd_train(log=logs.append)
    assert tr2.completed_epochs == 0 and tr2.amt_data == 0
    assert not any("Epoch:" in str(l) for l in logs)


def test_sigterm_handler_restored_after_sgd_train(tmp_path, ds):
    """sgd_train restores the pre-install signal disposition on exit
    (a forever-installed flag-setter would swallow post-training
    SIGTERMs), including on the preemption-stop path."""
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    try:
        tr = Trainer(_cfg(tmp_path), ds)
        tr.install_preemption_handler()
        installed = signal.getsignal(signal.SIGTERM)
        assert installed is not prev

        def log(msg, *a, **k):
            if "Epoch: 0001" in str(msg):
                tr.stop_requested = True

        tr.sgd_train(log=log, max_epochs=3)
        assert signal.getsignal(signal.SIGTERM) is prev
        assert tr._prev_sig_handlers == []
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_cli_skips_tests_after_preemption_stop(tmp_path, ds, monkeypatch):
    """After a preemption stop the CLI exits without gradvar/run_tests —
    the eviction grace window is for checkpointing, not the
    (num_layers+1)-pass test_cv evaluation."""
    from stochastic_gcn_tpu.cli import train as cli_train

    calls = []

    class FakeTrainer:
        stop_requested = False

        def __init__(self, cfg, ds_):
            pass

        def install_preemption_handler(self):
            calls.append("install")

        def sgd_train(self):
            calls.append("sgd_train")
            self.stop_requested = True   # preempted mid-run

        def run_tests(self):
            calls.append("run_tests")

        def gradient_variance(self):
            calls.append("gradvar")

    monkeypatch.setattr(cli_train, "Trainer", FakeTrainer)
    monkeypatch.setattr(cli_train, "load_data", lambda cfg: ds)
    cli_train.main(["--dataset", "synthetic:200:16:4", "--gradvar",
                    "--ckpt_dir", str(tmp_path)])
    assert calls == ["install", "sgd_train"]


def test_load_loop_extras_closes_file(tmp_path, ds):
    """load_loop_extras must not leak the npz file handle."""
    import warnings

    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        for _ in range(8):
            load_loop_extras(str(tmp_path))
