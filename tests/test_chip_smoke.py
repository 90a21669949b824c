"""chip_smoke.py's contract and helpers, on the CPU: it refuses a machine
without a GPU and prints no result there, it parses ``nvidia-smi``, it
formats the last line, and its step comparison catches a real difference.
Also the compile-cache helper and the per-process card choice that the
entry points share."""
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke as C  # noqa: E402
from stochastic_gcn_tpu.parallel.distributed import local_device_ids  # noqa
from stochastic_gcn_tpu.utils import compile_cache as CC  # noqa: E402
from stochastic_gcn_tpu.utils.device import parse_smi, require_gpu  # noqa


def _dev(platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("devices", [None, [], "cpu"])
def test_require_gpu_refuses_other_platforms(devices):
    devices = jax.devices() if devices == "cpu" else (devices or [])
    with pytest.raises(SystemExit) as e:
        require_gpu(devices)
    assert e.value.code == 2


def test_require_gpu_passes_gpu_devices_through():
    devs = [_dev(), _dev()]
    assert require_gpu(devs) is devs


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n" * 4 + "\n",
     [("NVIDIA H100 80GB HBM3", "400.00 W")] * 4),
    ("Some, Card, With Commas, [N/A]", [("Some, Card, With Commas",
                                        "[N/A]")]),
])
def test_parse_smi(text, want):
    assert parse_smi(text) == want


def test_parse_smi_rejects_malformed():
    with pytest.raises(ValueError):
        parse_smi("no comma here\n")


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_the_exact_contract(count):
    line = C.result_line([_dev()] * count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(line)["device"]["count"] == count


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_fails_without_gpu_and_prints_no_result():
    r = _run(_ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_script_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_dir_honours_env_and_falls_back():
    path, from_env = CC.compile_cache_dir({CC.ENV_VAR: "/x/cache"})
    assert (path, from_env) == ("/x/cache", True)
    path, from_env = CC.compile_cache_dir({})
    assert not from_env
    assert path == os.path.join(_ROOT, "tmp", "jax_cache")


def test_enable_compile_cache_leaves_env_setting_alone(monkeypatch,
                                                      tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path / "env_cache"))
    assert CC.enable_compile_cache() == str(tmp_path / "env_cache")
    assert calls == []
    monkeypatch.delenv(CC.ENV_VAR)
    monkeypatch.setattr(CC, "DEFAULT_DIR", str(tmp_path / "fixed"))
    assert CC.enable_compile_cache() == str(tmp_path / "fixed")
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / "fixed"))]
    assert os.path.isdir(tmp_path / "fixed")


@pytest.mark.parametrize("pid,nproc,hosts,want", [
    (0, 1, 1, None),        # single process: every local card
    (1, 2, 2, None),        # one process per host
    (3, 4, 1, [3]),         # four processes on one host: one card each
    (5, 8, 2, [1]),         # two hosts of four processes
])
def test_local_device_ids(pid, nproc, hosts, want):
    assert local_device_ids(pid, nproc, hosts) == want


def _state(params, hist):
    return types.SimpleNamespace(params=params, histories=((hist,),))


def test_compare_steps_tolerances():
    p = {"w": jnp.ones((4, 3))}
    h = jnp.arange(40, dtype=jnp.float32).reshape(10, 4).astype(jnp.bfloat16)
    m = {"loss": 2.0, "amt_data": 7}
    skip = [np.asarray([9])]
    out = C.compare_steps(_state(p, h), m, _state(p, h), m, 0.01, skip)
    assert out["loss_rel"] == 0.0 and out["hist_err_over_bound"] == 0.0
    # a differing history row fails unless it is a racy row
    h2 = h.at[3].set(-1.0)
    with pytest.raises(AssertionError):
        C.compare_steps(_state(p, h2), m, _state(p, h), m, 0.01, skip)
    C.compare_steps(_state(p, h2), m, _state(p, h), m, 0.01,
                    [np.asarray([3, 9])])
    # a param moved by more than 2 * lr fails
    with pytest.raises(AssertionError):
        C.compare_steps(_state({"w": p["w"].at[0, 0].add(0.05)}, h), m,
                        _state(p, h), m, 0.01, skip)
    # so does a loss that differs beyond LOSS_RTOL
    with pytest.raises(AssertionError):
        C.compare_steps(_state(p, h), {"loss": 2.001, "amt_data": 7},
                        _state(p, h), m, 0.01, skip)


def test_racy_rows_are_duplicates_plus_sentinel():
    fields = (jnp.asarray([4, 2, 4, 7, 10, 10]), jnp.asarray([4, 2]))
    got = C.racy_rows(fields, num_nodes=10)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], [4, 10])
