"""Async (double-buffered) checkpointing: save() snapshots on device and
writes in the background; writes are atomic; the final save is durable
before sgd_train returns (the reference has only an
end-of-training tf.train.Saver, gcn/models.py:204-220)."""

import os
import time

import numpy as np
import pytest

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.training.checkpoint import (AsyncCheckpointer,
                                                    load_loop_extras)
from stochastic_gcn_tpu.training.loop import Trainer


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=200, feature_dim=16, num_classes=4,
                             avg_degree=6, seed=0)


def _cfg(tmp_path, **kw):
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, seed=1,
                early_stopping=100, ckpt_dir=str(tmp_path),
                ckpt_async=True)     # the opt-in path under test
    base.update(kw)
    return Config(**base)


def test_async_save_roundtrips_like_sync(tmp_path, ds):
    """A resume from an async checkpoint restores bit-identical weights
    and counters (same format, same loader)."""
    import jax

    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=2)
    assert os.path.exists(tmp_path / "model.ckpt.npz")
    assert not os.path.exists(tmp_path / "model.ckpt.npz.tmp")

    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    assert tr2._try_resume(log=lambda *a, **k: None) == 2
    for a, b in zip(jax.tree_util.tree_leaves(tr.state.params),
                    jax.tree_util.tree_leaves(tr2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(load_loop_extras(str(tmp_path))["completed_epochs"]) == 2


def test_async_save_overlaps_and_finish_waits(tmp_path, ds):
    """save() returns before the file is published; finish_checkpoints
    joins the writer and the complete file appears."""
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)
    path = tmp_path / "model.ckpt.npz"
    st0 = os.stat(path).st_mtime_ns

    # slow the writer down so the overlap window is observable
    ck = tr._async_ckpt
    orig = np.savez_compressed

    def slow_writer(f, **arrays):
        time.sleep(0.5)
        return orig(f, **arrays)

    import stochastic_gcn_tpu.training.checkpoint as C
    old = C.np.savez_compressed
    C.np.savez_compressed = slow_writer
    try:
        t0 = time.time()
        tr.save()
        returned_in = time.time() - t0
        assert ck.pending or os.stat(path).st_mtime_ns != st0
        assert returned_in < 0.45      # returned before the 0.5 s write
        tr.finish_checkpoints()
        assert not ck.pending
        assert os.stat(path).st_mtime_ns != st0     # new snapshot published
        assert not os.path.exists(str(path) + ".tmp")
    finally:
        C.np.savez_compressed = old


def test_crashed_write_keeps_previous_snapshot(tmp_path, ds):
    """A writer that dies mid-write must leave the previous complete
    checkpoint loadable (atomic tmp+rename), and the error surfaces on
    the next wait()."""
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)
    path = tmp_path / "model.ckpt.npz"
    good = open(path, "rb").read()

    import stochastic_gcn_tpu.training.checkpoint as C
    old = C.np.savez_compressed

    def dying_writer(f, **arrays):
        f.write(b"partial garbage")       # simulate a kill mid-write
        raise RuntimeError("writer died")

    C.np.savez_compressed = dying_writer
    try:
        tr.save()
        with pytest.raises(RuntimeError, match="writer died"):
            tr.finish_checkpoints()
    finally:
        C.np.savez_compressed = old
    # previous snapshot intact and loadable
    assert open(path, "rb").read() == good
    tr2 = Trainer(_cfg(tmp_path, resume=True), ds)
    assert tr2._try_resume(log=lambda *a, **k: None) == 1


def test_nockpt_async_uses_sync_path(tmp_path, ds):
    """ckpt_async off (the default) keeps the blocking save (no writer
    thread)."""
    tr = Trainer(_cfg(tmp_path, ckpt_async=False), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)
    assert tr._async_ckpt is None
    assert os.path.exists(tmp_path / "model.ckpt.npz")


def test_back_to_back_saves_serialize(tmp_path, ds):
    """A save while a write is pending joins the previous write first —
    snapshots are published in order."""
    tr = Trainer(_cfg(tmp_path), ds)
    tr.sgd_train(log=lambda *a, **k: None, max_epochs=1)
    for _ in range(3):
        tr.completed_epochs += 1
        tr.save()
    tr.finish_checkpoints()
    assert int(load_loop_extras(str(tmp_path))["completed_epochs"]) == 4
