"""Golden-parity: our loaders vs the reference's OWN loader code.

The replica fixtures (stochastic_gcn_tpu/data/fixtures.py) are written in
the exact on-disk formats of the real datasets; the reference's utils.py is
exec'd (see reference_oracle.py) and both pipelines consume the SAME files.
Every output tensor — normalized adjacencies, normalized/scaled features,
PP features, labels, splits — must agree.  This is the bit-faithful
replica-oracle path that stands in for the real dataset files.
"""

import os

import numpy as np
import pytest

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import loaders as L
from stochastic_gcn_tpu.data.fixtures import (PlanetoidSpec,
                                              write_graphsage_fixture,
                                              write_planetoid_fixture)

from reference_oracle import REFERENCE_UTILS, as_dense, load_reference_utils

needs_reference = pytest.mark.skipif(
    not os.path.exists(REFERENCE_UTILS),
    reason="reference checkout not available")


def _compare(ref_tuple, ds, feat_tol=1e-6):
    (num_data, train_adj, full_adj, feats, train_feats, test_feats,
     labels, train_d, val_d, test_d) = ref_tuple
    assert int(num_data) == ds.num_data
    np.testing.assert_allclose(as_dense(ds.train_adj), as_dense(train_adj),
                               rtol=1e-6, atol=1e-12, err_msg="train_adj")
    np.testing.assert_allclose(as_dense(ds.full_adj), as_dense(full_adj),
                               rtol=1e-6, atol=1e-12, err_msg="full_adj")
    np.testing.assert_allclose(as_dense(ds.feats), as_dense(feats),
                               rtol=feat_tol, atol=1e-7, err_msg="feats")
    np.testing.assert_allclose(as_dense(ds.train_feats),
                               as_dense(train_feats),
                               rtol=feat_tol, atol=1e-6,
                               err_msg="train_feats (PP)")
    np.testing.assert_allclose(as_dense(ds.test_feats), as_dense(test_feats),
                               rtol=feat_tol, atol=1e-6,
                               err_msg="test_feats (PP)")
    np.testing.assert_array_equal(np.asarray(ds.labels),
                                  np.asarray(labels, np.float32))
    # split IDENTITY must match; order is loader-internal (the reference
    # emits GraphSAGE val/test in networkx node order)
    np.testing.assert_array_equal(np.sort(ds.train_d), np.sort(train_d))
    np.testing.assert_array_equal(np.sort(ds.val_d), np.sort(val_d))
    np.testing.assert_array_equal(np.sort(ds.test_d), np.sort(test_d))


def _planetoid_case(tmp_path, monkeypatch, spec, normalization):
    # two identical copies of the fixture: the loaders each write npz
    # caches next to the data, which must not cross-contaminate
    ours_dir = tmp_path / "ours"
    ref_dir = tmp_path / "ref" / "data"
    write_planetoid_fixture(str(ours_dir), spec)
    write_planetoid_fixture(str(ref_dir), spec)

    cfg = Config(dataset=spec.name, data_dir=str(ours_dir),
                 normalization=normalization)
    ds = L.load_gcn_data(spec.name, cfg)

    ref = load_reference_utils(normalization=normalization)
    monkeypatch.chdir(tmp_path / "ref")
    ref_tuple = ref.load_gcn_data(spec.name)
    _compare(ref_tuple, ds)
    # round-trip through BOTH npz caches as well (utils.py:34-48)
    ds2 = L.load_gcn_data(spec.name, cfg)
    ref_tuple2 = ref.load_gcn_data(spec.name)
    _compare(ref_tuple2, ds2)


@needs_reference
@pytest.mark.parametrize("normalization", ["gcn", "graphsage"])
def test_planetoid_cora_style(tmp_path, monkeypatch, normalization):
    _planetoid_case(tmp_path, monkeypatch,
                    PlanetoidSpec(name="cora", seed=3), normalization)


@needs_reference
def test_planetoid_citeseer_isolated_nodes(tmp_path, monkeypatch):
    """The citeseer quirk: isolated test-range nodes get zero-row features
    (gcn/utils.py:67-76)."""
    _planetoid_case(
        tmp_path, monkeypatch,
        PlanetoidSpec(name="citeseer", num_isolated=7, seed=4), "gcn")


@needs_reference
def test_planetoid_nell_layout(tmp_path, monkeypatch):
    """NELL branch: features = allx only, 969 hardcoded val rows, test ids
    inside allx (gcn/utils.py:99-115)."""
    _planetoid_case(
        tmp_path, monkeypatch,
        PlanetoidSpec(name="nell", num_train=40, num_extra=1160,
                      num_val=969, num_test=80, nell_style=True, seed=5),
        "gcn")


@needs_reference
@pytest.mark.parametrize("multilabel", [False, True])
def test_graphsage_json(tmp_path, monkeypatch, multilabel):
    ours_dir = tmp_path / "ours"
    ref_dir = tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    kw = dict(num_nodes=250, feature_dim=24, num_classes=5, avg_degree=6,
              multilabel=multilabel, num_broken=4, seed=6)
    write_graphsage_fixture(str(ours_dir / "toy"), **kw)
    write_graphsage_fixture(str(ref_dir / "toy"), **kw)

    cfg = Config(dataset="ppi", normalization="graphsage")
    ds = L.load_graphsage_data(str(ours_dir / "toy"), cfg)

    ref = load_reference_utils(normalization="graphsage")
    monkeypatch.chdir(ref_dir)
    ref_tuple = ref.load_graphsage_data("toy")
    # GraphSAGE feats go through StandardScaler in float64 in the
    # reference but are stored float32 by us
    _compare(ref_tuple, ds, feat_tol=1e-5)
    # cached round-trip
    ds2 = L.load_graphsage_data(str(ours_dir / "toy"), cfg)
    ref_tuple2 = ref.load_graphsage_data("toy")
    _compare(ref_tuple2, ds2, feat_tol=1e-5)
