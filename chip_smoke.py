"""Smoke test of the training path on NVIDIA GPUs.

Drives the Reddit-shaped CV+PP recipe of ``bench.py`` and
``configs/reddit.sh`` (233,000 nodes, mean degree 64 padded to 64, 602
features, 41 classes, hidden 128, batch 512, ``--degree 1 --cv
--test_cv`` with PP, graphsage normalisation, layer norm, 2 FC layers,
dropout 0.2, bfloat16 history) through ``training.loop.Trainer`` and
checks what comes out.  Graph, features and labels are generated from a
seed; nothing is downloaded.

Run from the repository root on a machine with NVIDIA GPUs::

    python3 chip_smoke.py           # one card: phases a, b, c
    python3 chip_smoke.py --four    # four cards: phases a and d only

Phases:

a. Device.  The first JAX device must be a GPU, else exit 2.  Prints the
   device, the JAX version, the compile-cache directory and the card's
   name and power limit (``nvidia-smi``, run in a child process).
b. Contraction.  The CV full-neighbourhood term
   (``aggregators.full_neighborhood_mean``: the plain gather + einsum and
   ``tiered_full_contract``) and the sampled ``fanout_gather``, on the
   layer-1 field of a batch-512 schedule, Dcap 64, d 128, history in
   bfloat16 and float32, against a float64 NumPy oracle at XLA's default
   precision and at HIGHEST, with the device time of each.
c. Training.  One step on the GPU against the same step on the host CPU
   (both at HIGHEST), whole-epoch dispatches (301 steps) with a falling
   loss,
   and the CV test protocol (num_layers + 1 passes).
d. ``--four``: the node-sharded data-parallel step (``shard_history``,
   ``shard_graph``, ``halo_exchange``) on four cards against the
   single-card step on the same batch and key, then dp=4 Trainer epochs.

Every measurement line carries the card's name and power limit.  The
last stdout line is the JSON result; a failed check raises, so the exit
code is then non-zero and no result is printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from stochastic_gcn_tpu.utils.device import query_cards, require_gpu

# Contraction error is measured componentwise against
# sum_k |w_fk| |h_nk|, the scale a rounding-error bound is stated in.
# HIGHEST: float32 products and sums over Dcap = 64 terms, bound
# gamma_64 = 64 * 2^-24 = 3.8e-6.  Default precision: float32 dots may
# run in TF32 (10 explicit mantissa bits), which puts each operand within
# 2^-10 of its value when it truncates; two operands give 2.0e-3, and the
# float32 sum adds gamma_64.
CONTRACT_TOL = {"highest": 1e-5, "default": 4e-3}

# One train step on the GPU against the same step on the host CPU, both at
# HIGHEST precision: they differ only in the order of float32 sums.
LOSS_RTOL = 1e-5
# Adam's first step moves a weight by lr * g / (|g| + eps), about
# lr * sign(g).  A gradient entry within rounding of zero can take the
# other sign on the other device and move by up to 2 * lr, so: all but
# PARAM_FLIP_FRAC of the entries agree within PARAM_ATOL, none differ by
# more than 2 * lr.
PARAM_ATOL = 1e-5
PARAM_FLIP_FRAC = 1e-4
# Histories are stored in bfloat16 (8 significant bits): float32
# activations that differ in their last bits can round to neighbouring
# bfloat16 values, one ulp apart, at most 2^-7 of the value.  Rows the
# step's scatter writes more than once (a node id twice in the no-dedup
# field, each copy with its own dropout mask) keep whichever write lands
# last, which two devices need not agree on; they and the sentinel row
# (garbage by design) are left out of the comparison.
HIST_RTOL = 2.0 ** -7
HIST_ATOL = 1e-6

BIG_FIELD = 4096
# phase b times each op on this many fields inside one dispatch, so the
# per-field time is the device's and not the host's dispatch cost
TIMED_FIELDS = 64


# --------------------------------------------------------------- helpers

class CheckFailed(AssertionError):
    """A smoke-test check did not hold."""


def check(ok, detail) -> None:
    """Raise :class:`CheckFailed` unless ``ok`` (unlike ``assert``, this
    also runs under ``python -O``)."""
    if not ok:
        raise CheckFailed(detail)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run the four-card sharded phase (d) only")
    return p.parse_args(argv)


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def recipe_config(**over):
    """The Reddit-shaped CV+PP recipe (bench.py's headline)."""
    import bench
    from stochastic_gcn_tpu.config import Config
    base = dict(dataset="reddit_like", batch_size=bench.BATCH, degree=1,
                test_degree=1, cv=True, test_cv=True, hidden1=bench.HIDDEN,
                normalization="graphsage", layer_norm=True,
                num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                pad_degree=bench.PAD_DEG, seed=1, test_batch_size=2048)
    base.update(over)
    return Config(**base)


def time_call(fn, *args, reps: int = 20) -> float:
    """Mean seconds per call after one warm-up, closed by
    ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def contraction_oracle(hist, nbr, w, field, square=False):
    """float64 ``out[f] = sum_k w[field_f, k] * hist[nbr[field_f, k]]`` and
    its error scale ``sum_k |w| |hist|``."""
    h = np.asarray(hist, np.float64)
    rows = np.asarray(nbr)[np.asarray(field)]
    ww = np.asarray(w, np.float64)[np.asarray(field)]
    if square:
        ww = ww * ww
    g = h[rows]                                       # [F, Dcap, d]
    return (np.einsum("fk,fkd->fd", ww, g),
            np.einsum("fk,fkd->fd", np.abs(ww), np.abs(g)))


def fanout_oracle(x, pos, w):
    """float64 ``out[f] = sum_s w[f, s] * x[pos[f, s]]``; positions past the
    table (parked slots) read zero rows."""
    x = np.asarray(x, np.float64)
    pos = np.asarray(pos)
    xp = np.concatenate([x, np.zeros((1, x.shape[1]))])
    g = xp[np.minimum(pos, x.shape[0])]
    ww = np.asarray(w, np.float64)
    return (np.einsum("fk,fkd->fd", ww, g),
            np.einsum("fk,fkd->fd", np.abs(ww), np.abs(g)))


def rel_error(got, ref, scale) -> tuple[float, float]:
    """(max abs error, max componentwise error relative to ``scale``)."""
    err = np.abs(np.asarray(got, np.float64) - ref)
    rel = np.where(scale > 0, err / np.where(scale > 0, scale, 1.0),
                   np.where(err > 0, np.inf, 0.0))
    return float(err.max(initial=0.0)), float(rel.max(initial=0.0))


def racy_rows(fields, num_nodes: int) -> list[np.ndarray]:
    """Per history layer: the node rows the step's history scatter writes
    more than once (duplicate ids of ``fields[l]``), plus the sentinel row
    ``num_nodes``."""
    out = []
    for f in fields[:-1]:
        ids, cnt = np.unique(np.asarray(f), return_counts=True)
        out.append(np.union1d(ids[cnt > 1], [num_nodes]))
    return out


def step_fields(tr, state, batch, key):
    """The receptive fields the train step schedules for (state, batch,
    key), with the key derived as ``training.step.build_train_step``
    derives it."""
    import jax
    from stochastic_gcn_tpu.sampler.scheduler import schedule
    cfg, spec = tr.cfg, tr.train_spec

    def fields(graph, batch, key, step):
        k_sched, _ = jax.random.split(jax.random.fold_in(key, step))
        return schedule(k_sched, graph, batch, tr.train_degrees, spec.cv,
                        need_aw=spec.det_dropout, round_multiple=cfg.dp,
                        dedup=cfg.field_dedup,
                        is_slot_cap=cfg.is_slot_cap).fields
    return jax.jit(fields)(tr.graph_train, batch, key, state.step)


def compare_steps(a_state, a_metrics, b_state, b_metrics, lr: float,
                  skip_rows):
    """Check two results of one train step against the tolerances above;
    ``skip_rows[l]`` are history rows of layer l left out (see
    :func:`racy_rows`).  Returns a dict of the measured differences."""
    import jax
    la, lb = float(a_metrics["loss"]), float(b_metrics["loss"])
    out = {"loss_a": la, "loss_b": lb,
           "loss_rel": abs(la - lb) / max(abs(lb), 1e-30)}
    check(np.isfinite(la) and np.isfinite(lb), out)
    check(out["loss_rel"] <= LOSS_RTOL, out)
    check(int(a_metrics["amt_data"]) == int(b_metrics["amt_data"]), out)

    diffs = [np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
             .ravel() for x, y in zip(
                 jax.tree_util.tree_leaves(a_state.params),
                 jax.tree_util.tree_leaves(b_state.params))]
    d = np.concatenate(diffs)
    out["param_max_abs"] = float(d.max())
    out["param_n_beyond_atol"] = int((d > PARAM_ATOL).sum())
    out["param_size"] = int(d.size)
    check(out["param_max_abs"] <= 2 * lr, out)
    check(out["param_n_beyond_atol"] <= PARAM_FLIP_FRAC * d.size, out)

    worst = 0.0
    for ha, hb, skip in zip(a_state.histories, b_state.histories,
                            skip_rows):
        for x, y in zip(ha, hb):
            x = np.asarray(x, np.float64)
            y = np.asarray(y, np.float64)
            x[skip] = y[skip] = 0.0
            bound = HIST_RTOL * np.maximum(np.abs(x), np.abs(y)) + HIST_ATOL
            worst = max(worst,
                        float((np.abs(x - y) / bound).max(initial=0.0)))
    out["hist_err_over_bound"] = worst
    out["hist_rows_skipped"] = int(sum(len(r) for r in skip_rows))
    check(worst <= 1.0, out)
    return out


# ---------------------------------------------------------------- phases

def phase_device(devices, cards, cache_dir):
    import jax
    d = devices[0]
    print(f"[a] platform={d.platform} device_kind={d.device_kind} "
          f"count={len(devices)} jax={jax.__version__} "
          f"compile_cache={cache_dir}", flush=True)
    for i, (name, limit) in enumerate(cards):
        print(f"[a] card {i}: {name}, {limit}", flush=True)


def phase_contraction(tr, card: str, rng, reps: int = 20):
    """Phase b: full-neighbourhood contraction and fanout gather against
    the float64 oracle.  Each op reports ``call_ms``, one dispatch on the
    host clock, and ``device_ms``, the mean over TIMED_FIELDS fields of
    the same size contracted in one dispatch.  Returns the rows printed."""
    import jax
    import jax.numpy as jnp
    from stochastic_gcn_tpu.models.aggregators import (
        fanout_gather, full_neighborhood_mean, tiered_full_contract)
    from stochastic_gcn_tpu.sampler.scheduler import schedule

    cfg = tr.cfg
    graph = tr.graph_train
    nbr_np, w_np = np.asarray(graph.nbr), np.asarray(graph.w)
    deg_np = np.asarray(graph.deg)
    d = cfg.hidden1
    rows = tr.state.histories[0][0].shape[0]
    train = np.asarray(tr.ds.train_d, np.int32)

    sched = jax.jit(lambda k, g, b: schedule(
        k, g, b, tr.train_degrees, True, dedup=cfg.field_dedup))
    pack = sched(jax.random.PRNGKey(11), graph,
                 jnp.asarray(rng.permutation(train)[:cfg.batch_size]))
    fields = {
        f"layer-1 field F={pack.fields[1].shape[0]}": pack.fields[1],
        f"batch-{BIG_FIELD} field F={BIG_FIELD}":
            jnp.asarray(rng.permutation(train)[:BIG_FIELD]),
    }
    w1 = graph.tier_w if graph.tier_w > 0 else graph.pad_degree // 2

    def stack_of(size):
        return jnp.asarray(np.stack([rng.permutation(train)[:size]
                                     for _ in range(TIMED_FIELDS)]))

    def tiered_fn(h, g, f):
        return tiered_full_contract(
            h, jnp.take(g.nbr, f, axis=0), jnp.take(g.w, f, axis=0),
            jnp.take(g.deg, f, axis=0), w1, 1.0)

    def timed(fn, h, g, field):
        one = jax.jit(fn)
        many = jax.jit(lambda h, g, fs: jax.lax.map(
            lambda f: fn(h, g, f), fs))
        fs = stack_of(field.shape[0])
        return (one(h, g, field), time_call(one, h, g, field, reps=reps),
                time_call(many, h, g, fs, reps=3) / TIMED_FIELDS)

    hist32 = rng.normal(size=(rows, d)).astype(np.float32)
    report = []
    for dt_name, dt in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        hist = jnp.asarray(hist32).astype(dt)
        hist_host = np.asarray(hist.astype(jnp.float32))
        for fname, field in fields.items():
            ref, scale = contraction_oracle(hist_host, nbr_np, w_np, field)
            for kname, fn in (("plain", full_neighborhood_mean),
                              (f"tiered w1={w1}", tiered_fn)):
                for prec in ("default", "highest"):
                    with jax.default_matmul_precision(prec):
                        got, t1, tn = timed(fn, hist, graph, field)
                    ea, er = rel_error(got, ref, scale)
                    line = (f"[b] [{card}] full_neighborhood {kname} "
                            f"{fname} Dcap={graph.pad_degree} d={d} "
                            f"hist={dt_name} precision={prec} "
                            f"max_abs_err={ea:.3e} max_rel_err={er:.3e} "
                            f"tol={CONTRACT_TOL[prec]:.0e} "
                            f"call_ms={t1 * 1e3:.4f} "
                            f"device_ms={tn * 1e3:.4f}")
                    print(line, flush=True)
                    report.append(line)
                    check(er <= CONTRACT_TOL[prec], line)

    ls = pack.layers[0]
    x = jnp.asarray(rng.normal(size=(pack.fields[0].shape[0], d))
                    .astype(np.float32))
    ref, scale = fanout_oracle(np.asarray(x), np.asarray(ls.slot_pos),
                               np.asarray(ls.slot_w))
    fan = jax.jit(fanout_gather)
    fan_many = jax.jit(lambda xs, p, w: jax.lax.map(
        lambda x1: fanout_gather(x1, p, w), xs))
    xs = jnp.asarray(rng.normal(size=(TIMED_FIELDS,) + x.shape)
                     .astype(np.float32))
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = fan(x, ls.slot_pos, ls.slot_w)
            t1 = time_call(fan, x, ls.slot_pos, ls.slot_w, reps=reps)
            tn = time_call(fan_many, xs, ls.slot_pos, ls.slot_w,
                           reps=3) / TIMED_FIELDS
        ea, er = rel_error(got, ref, scale)
        line = (f"[b] [{card}] fanout_gather F={ls.slot_pos.shape[0]} "
                f"k={ls.slot_pos.shape[1]} C_in={x.shape[0]} d={d} "
                f"precision={prec} max_abs_err={ea:.3e} "
                f"max_rel_err={er:.3e} tol={CONTRACT_TOL[prec]:.0e} "
                f"call_ms={t1 * 1e3:.4f} device_ms={tn * 1e3:.4f}")
        print(line, flush=True)
        report.append(line)
        check(er <= CONTRACT_TOL[prec], line)
    print(f"[b] train graph: mean degree {deg_np[:-1].mean():.2f}, "
          f"tier_w {graph.tier_w}", flush=True)
    return report


def train_step_vs_cpu(tr, batch, key):
    """One train step on the trainer's device and on the host CPU, both at
    HIGHEST precision; returns the compared differences and the GPU loss."""
    import jax
    from stochastic_gcn_tpu.training.step import build_train_step
    step = jax.jit(build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                                    tr.ds.num_data))
    cpu = jax.devices("cpu")[0]
    fields = step_fields(tr, tr.state, batch, key)
    cpu_fields = step_fields(tr, jax.device_put(tr.state, cpu),
                             jax.device_put(batch, cpu),
                             jax.device_put(key, cpu))
    for f, g in zip(fields, cpu_fields):
        check(np.array_equal(np.asarray(f), np.asarray(g)),
              "the scheduler drew different fields on the two devices")
    args = (tr.state, tr.graph_train, tr.train_features, tr.labels,
            tr.importance_train, batch, key)
    cpu_args = jax.device_put(args, cpu)
    with jax.default_matmul_precision("highest"):
        s_dev, m_dev = step(*args)
        s_cpu, m_cpu = step(*cpu_args)
    return compare_steps(s_dev, m_dev, s_cpu, m_cpu, tr.cfg.learning_rate,
                         racy_rows(fields, tr.ds.num_data))


def phase_training(tr, card: str, rng, dispatches: int = 3):
    """Phase c: GPU-vs-CPU step, epoch dispatches, CV test passes."""
    import jax
    import jax.numpy as jnp

    cfg = tr.cfg
    train = np.asarray(tr.ds.train_d, np.int32)
    batch = jnp.asarray(rng.permutation(train)[:cfg.batch_size])
    cmp = train_step_vs_cpu(tr, batch, jax.random.PRNGKey(3))
    print(f"[c] [{card}] one step GPU vs host CPU at HIGHEST: "
          f"loss {cmp['loss_a']:.7f} vs {cmp['loss_b']:.7f} "
          f"(rel {cmp['loss_rel']:.2e}, tol {LOSS_RTOL:.0e}); params max "
          f"abs diff {cmp['param_max_abs']:.3e}, "
          f"{cmp['param_n_beyond_atol']}/{cmp['param_size']} beyond "
          f"{PARAM_ATOL:.0e}; histories max diff "
          f"{cmp['hist_err_over_bound']:.3f} of the 1-ulp bound "
          f"({cmp['hist_rows_skipped']} racy rows left out)", flush=True)
    loss0 = cmp["loss_a"]

    times, losses = [], []
    for i in range(dispatches):
        t0 = time.perf_counter()
        loss, _, _, steps = tr.train_epoch()      # ends in a value fetch
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[c] [{card}] epoch dispatch {i + 1}: {steps} steps in "
              f"{times[-1]:.3f} s, last-step loss {loss:.5f}", flush=True)
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    step_ms = steady / steps * 1e3
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    print(f"[c] [{card}] step_ms={step_ms:.4f} (median of dispatches "
          f"2..{dispatches}, {steps} steps each) "
          f"compile_s={times[0] - steady:.2f} (first dispatch less a "
          f"steady one) peak_bytes_in_use={peak}", flush=True)
    check(all(np.isfinite(losses)), losses)
    check(losses[-1] < loss0, (loss0, losses))

    accs = []
    for p in range(cfg.num_layers + 1):
        acc, micro, macro = tr.test(log=lambda s: print(
            f"[c] [{card}] CV test pass {p + 1}: {s}", flush=True))
        accs.append(acc)
    check(all(np.isfinite(accs)), accs)
    # with one sampled layer under PP the eval history is exact after one
    # refresh pass, so the last two passes agree
    check(abs(accs[-1] - accs[-2]) <= 1e-3, accs)
    return dict(step_ms=step_ms, losses=losses, loss0=loss0, peak=peak)


def phase_four(ds, card: str, rng, dispatches: int = 2):
    """Phase d: sharded dp=4 step against the single-card step, then
    dp=4 Trainer epochs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from stochastic_gcn_tpu.parallel.mesh import make_sharded_train_step
    from stochastic_gcn_tpu.training.loop import Trainer
    from stochastic_gcn_tpu.training.step import build_train_step

    # parity runs on the dedup field layout: the no-dedup layout lets
    # duplicate field rows race in the history scatter (last write wins),
    # which two lowerings need not resolve the same way
    cfg1 = recipe_config(field_dedup=True)
    tr1 = Trainer(cfg1, ds)
    tr4 = Trainer(cfg1.replace(dp=4), ds)
    train = np.asarray(ds.train_d, np.int32)
    batch = rng.permutation(train)[:cfg1.batch_size]
    key = jax.random.PRNGKey(7)

    step1 = jax.jit(build_train_step(cfg1, tr1.train_spec, tr1.train_degrees,
                                     ds.num_data))
    step4 = make_sharded_train_step(
        tr4.cfg, tr4.train_spec, tr4.train_degrees, ds.num_data, tr4.mesh,
        state_template=tr4.state, shard_history=True,
        data_template=(tr4.graph_train, tr4.train_features, tr4.labels),
        shard_graph=True)
    b4 = jax.device_put(jnp.asarray(batch), NamedSharding(tr4.mesh,
                                                          P("data")))
    with jax.default_matmul_precision("highest"):
        s1, m1 = step1(tr1.state, tr1.graph_train, tr1.train_features,
                       tr1.labels, tr1.importance_train, jnp.asarray(batch),
                       key)
        s4, m4 = step4(tr4.state, tr4.graph_train, tr4.train_features,
                       tr4.labels, tr4.importance_train, b4, key)
    h0 = jax.tree_util.tree_leaves(s4.histories)[0]
    shard_rows = max(s.data.shape[0] for s in h0.addressable_shards)
    check(shard_rows < h0.shape[0], "history is not node-sharded")
    fields = step_fields(tr1, tr1.state, jnp.asarray(batch), key)
    cmp = compare_steps(s4, m4, s1, m1, cfg1.learning_rate,
                        racy_rows(fields, ds.num_data))
    print(f"[d] [{card}] sharded dp=4 step vs single card at HIGHEST: "
          f"loss {cmp['loss_a']:.7f} vs {cmp['loss_b']:.7f} "
          f"(rel {cmp['loss_rel']:.2e}); params max abs diff "
          f"{cmp['param_max_abs']:.3e}, {cmp['param_n_beyond_atol']}/"
          f"{cmp['param_size']} beyond {PARAM_ATOL:.0e}; histories "
          f"{cmp['hist_err_over_bound']:.3f} of the 1-ulp bound; history "
          f"shard rows {shard_rows} of {h0.shape[0]}", flush=True)
    del tr1, tr4, s1, s4

    trd = Trainer(recipe_config(dp=4), ds)
    times, losses = [], []
    for i in range(dispatches):
        t0 = time.perf_counter()
        loss, _, _, steps = trd.train_epoch()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[d] [{card}] dp=4 epoch dispatch {i + 1}: {steps} steps "
              f"in {times[-1]:.3f} s, last-step loss {loss:.5f}",
              flush=True)
    check(all(np.isfinite(losses)), losses)
    check(losses[-1] < cmp["loss_b"], (cmp["loss_b"], losses))
    return dict(times=times, losses=losses)


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    args = parse_args(argv)
    import jax
    devices = require_gpu(jax.devices())
    from stochastic_gcn_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    cards = query_cards()
    card = ", ".join(cards[0])
    phase_device(devices, cards, cache_dir)

    import bench
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ds = bench.build_reddit_like(cache=None)
    print(f"[setup] graph built in {time.perf_counter() - t0:.1f} s: "
          f"{ds.num_data} nodes, {ds.full_adj.nnz} edges, "
          f"{ds.feats.shape[1]} features, {ds.labels.shape[1]} classes",
          flush=True)
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        phase_four(ds, card, rng)
    else:
        from stochastic_gcn_tpu.training.loop import Trainer
        t0 = time.perf_counter()
        tr = Trainer(recipe_config(), ds)
        print(f"[c] [{card}] Trainer built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        phase_contraction(tr, card, rng)
        phase_training(tr, card, rng)
    print(f"card: {card}", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
