"""jax.export serving artifacts (stochastic_gcn_tpu/serving.py).

The exported StableHLO module + state npz must reproduce the live
``Trainer.predict`` output without any model-building code on the loader
side, across all estimator eval configurations and the bf16-history
default.
"""
import numpy as np
import pytest

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import load_data
from stochastic_gcn_tpu.serving import export_predictor, load_predictor
from stochastic_gcn_tpu.training.loop import Trainer


def _trained(tmp_path, **over):
    cfg = Config(dataset="synthetic:220:12:4", batch_size=64,
                 test_batch_size=48, hidden1=16, dropout=0.2, seed=3,
                 ckpt_dir=str(tmp_path), **over)
    tr = Trainer(cfg, load_data(cfg))
    for _ in range(2):
        tr.train_epoch()
    return tr


@pytest.mark.parametrize("over", [
    dict(degree=1, test_degree=1, cv=True, test_cv=True),
    dict(degree=1, test_degree=1, cv=True, cvd=True, test_cv=True,
         test_cvd=True),
    dict(degree=2, test_degree=10000),                  # NS-style eval
])
def test_export_matches_live_predict(tmp_path, over):
    tr = _trained(tmp_path, **over)
    ids = np.asarray([0, 5, 17, 219, 3], np.int64)
    live = tr.predict(ids)                        # refresh + exact CV

    art = export_predictor(tr, str(tmp_path / "art"))
    pred = load_predictor(art)
    got = pred.predict(ids)
    assert got.shape == (len(ids), tr.ds.num_classes)
    np.testing.assert_allclose(got, live, rtol=1e-4, atol=1e-5)


def test_export_artifact_is_self_contained(tmp_path):
    """The loader touches only the artifact files (module bytes + npz +
    manifest) — drive it on a fresh Predictor with the trainer deleted,
    over multiple serving calls (history fixed point must hold)."""
    tr = _trained(tmp_path, degree=1, test_degree=1, cv=True, test_cv=True)
    all_ids = np.arange(tr.ds.num_data, dtype=np.int64)
    live = tr.predict(all_ids)
    art = export_predictor(tr, str(tmp_path / "art"))
    del tr

    pred = load_predictor(art)
    first = pred.predict(all_ids)                  # > one batch: chunking
    second = pred.predict(all_ids[::-1])           # order-preserving
    np.testing.assert_allclose(first, live, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(second, first[::-1], rtol=1e-4, atol=1e-5)


def test_export_serves_polyak_average(tmp_path):
    """With --polyak_decay the artifact must bake the EMA weights (the
    eval surface), not the raw ones."""
    tr = _trained(tmp_path, degree=1, test_degree=1, cv=True, test_cv=True,
                  polyak_decay=0.9)
    assert tr.state.avg_params is not None
    ids = np.asarray([0, 7, 100], np.int64)
    live = tr.predict(ids)
    art = export_predictor(tr, str(tmp_path / "art3"))
    got = load_predictor(art).predict(ids)
    np.testing.assert_allclose(got, live, rtol=1e-4, atol=1e-5)


def test_multi_platform_export_serves_locally(tmp_path):
    """platforms=("cpu","cuda") lowers for both fleets; the artifact must
    still deserialize and serve on the current (cpu) backend."""
    tr = _trained(tmp_path, degree=1, test_degree=1, cv=True, test_cv=True)
    ids = np.asarray([1, 2, 3], np.int64)
    live = tr.predict(ids)
    art = export_predictor(tr, str(tmp_path / "art2"),
                           platforms=("cpu", "cuda"))
    got = load_predictor(art).predict(ids)
    np.testing.assert_allclose(got, live, rtol=1e-4, atol=1e-5)


def test_export_warns_on_sampled_eval(tmp_path):
    """A sampled eval config (no CV, small test_degree) freezes one
    neighbor sample into the artifact — the export must say so."""
    tr = _trained(tmp_path, degree=1, test_degree=1)
    with pytest.warns(UserWarning, match="SAMPLED eval"):
        export_predictor(tr, str(tmp_path / "art4"))


def test_export_rejects_meshed_trainer(tmp_path):
    cfg = Config(dataset="synthetic:220:12:4", batch_size=64, dp=8,
                 degree=1, test_degree=1, cv=True, test_cv=True,
                 hidden1=16, seed=3)
    tr = Trainer(cfg, load_data(cfg))
    with pytest.raises(ValueError, match="single-chip"):
        export_predictor(tr, str(tmp_path / "art"))


def test_scanned_export_matches_single_batch(tmp_path):
    """--scan_batches N exports a module serving N x test_batch_size ids
    per device call (on-device scan, amortizing per-call dispatch); its
    predictions equal the single-batch artifact's and live predict's,
    including on a ragged tail shorter than one span."""
    tr = _trained(tmp_path, degree=1, test_degree=1, cv=True, test_cv=True)
    all_ids = np.arange(tr.ds.num_data, dtype=np.int64)
    live = tr.predict(all_ids)

    art = export_predictor(tr, str(tmp_path / "art_scan"), scan_batches=3)
    pred = load_predictor(art)
    assert pred.scan_batches == 3
    np.testing.assert_allclose(pred.predict(all_ids), live,
                               rtol=1e-4, atol=1e-5)
    # ragged tail: fewer ids than one scan span (3 x 48)
    few = np.asarray([7, 0, 219], np.int64)
    np.testing.assert_allclose(pred.predict(few), live[few],
                               rtol=1e-4, atol=1e-5)
