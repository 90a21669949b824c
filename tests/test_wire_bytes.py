"""CI regression budget on the sharded train step's collective payload.

Lowers the node-sharded data-parallel train step on the 8-device virtual
mesh and asserts the modeled per-chip wire bytes (parallel/payload.py ring
model over the optimized HLO) stay inside the measured budget (PERF.md
"Fetch-routed gathers": 0.34 MB/step at N=4096, batch 256, d=64; 0.29
owner-aligned).  A silent fallback to GSPMD's all-gather lowering (2.58
MB/step) or to the psum-routed gathers (0.71 MB/step) trips these budgets
immediately.
"""

import importlib.util
import os

import jax
import pytest

from stochastic_gcn_tpu.parallel.payload import collective_bytes

BUDGET_MB = 0.40        # measured 0.34 + headroom (psum path is 0.71)
BUDGET_OWNER_MB = 0.33  # measured 0.29 + headroom

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "measure_halo_payload.py")


def _lower(owner: bool):
    spec = importlib.util.spec_from_file_location("measure_halo_payload",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lower_step(4096, 256, 8, shard_graph=True, halo=True,
                          fetch=True, owner=owner)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_edgelist_wire_bytes_budget():
    """The node-sharded FlatGraph step (owner-routed window BLOCK reads)
    must stay at the padded step's budget — measured 0.341 vs 0.338
    MB/chip/step (the [*, 8] block transport adds ~2 KB)."""
    spec = importlib.util.spec_from_file_location("measure_halo_payload",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hlo = mod.lower_step(4096, 256, 8, shard_graph=True, halo=True,
                         fetch=True, owner=False, graph_format="edgelist")
    per = collective_bytes(hlo, 8)
    total_mb = sum(per.values()) / 1e6
    detail = {k: round(v / 1e6, 3) for k, v in sorted(per.items())}
    assert per.get("all-to-all", 0) > 0, detail
    assert total_mb <= BUDGET_MB, (
        f"sharded edgelist step lowered to {total_mb:.3f} MB/chip/step "
        f"(budget {BUDGET_MB}); by kind: {detail}")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("owner,budget_mb", [(False, BUDGET_MB),
                                             (True, BUDGET_OWNER_MB)])
def test_sharded_step_wire_bytes_budget(owner, budget_mb):
    hlo = _lower(owner)
    per = collective_bytes(hlo, 8)
    total_mb = sum(per.values()) / 1e6
    detail = {k: round(v / 1e6, 3) for k, v in sorted(per.items())}
    # the fetch transport must actually be on the executed path
    assert per.get("all-to-all", 0) > 0, detail
    assert total_mb <= budget_mb, (
        f"sharded step lowered to {total_mb:.3f} MB/chip/step "
        f"(budget {budget_mb}); by kind: {detail} — a halo/GSPMD lowering "
        "regression (see PERF.md 'Fetch-routed gathers')")
