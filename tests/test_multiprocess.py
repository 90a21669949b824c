"""REAL multi-controller validation: two OS processes, each owning 4
virtual CPU devices, form one dp=8 / dp_hosts=2 mesh over localhost
(jax.distributed) and train the sharded CV+PP model — the exact code path
a 2-host launch would run (SURVEY.md §2.3 scale-out; the reference
is single-process only).  Asserts both controllers agree and that the
2-process trajectory matches the single-process 8-device mesh run."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_training_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)   # worker sets its own device count
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_mp_worker.py"),
         str(port), str(i), str(outs[i])],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=720)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-4000:]}"

    res = [json.loads(outs[i].read_text()) for i in range(2)]
    # both controllers computed the SAME global values
    np.testing.assert_allclose(res[0]["losses"], res[1]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(res[0]["val_loss"], res[1]["val_loss"],
                               rtol=1e-5)
    # checkpoint round-trip (gathered shards, process-0 write, both
    # controllers reload) kept training consistent
    np.testing.assert_allclose(res[0]["loss_resumed"],
                               res[1]["loss_resumed"], rtol=1e-5)
    assert np.isfinite(res[0]["loss_resumed"])
    # default --load path (live sharded histories kept) also works
    np.testing.assert_allclose(res[0]["loss_resumed_nohist"],
                               res[1]["loss_resumed_nohist"], rtol=1e-5)
    assert np.isfinite(res[0]["loss_resumed_nohist"])

    # and the 2-process mesh reproduces the single-process 8-device run
    # (same seeds -> same batches -> same math, collectives aside)
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data.loaders import synthetic_dataset
    from stochastic_gcn_tpu.training.loop import Trainer
    cfg = Config(dataset="synthetic", batch_size=32, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=16,
                 normalization="graphsage", layer_norm=True, dropout=0.2,
                 weight_decay=0.0, seed=1, dp=8, dp_hosts=2,
                 test_batch_size=64)
    ds = synthetic_dataset(num_nodes=128, feature_dim=16, num_classes=4,
                           avg_degree=4, seed=0, normalization="graphsage")
    tr = Trainer(cfg, ds)
    ref_losses = [tr.train_epoch()[0] for _ in range(2)]
    np.testing.assert_allclose(res[0]["losses"], ref_losses, rtol=1e-4)
