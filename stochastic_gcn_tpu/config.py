"""Configuration system for stochastic_gcn_tpu.

Replacement for the reference's global ``tf.app.flags`` singleton
(reference: gcn/train.py:25-67, consumed at import time by gcn/layers.py:6-7,
gcn/models.py:9-10, gcn/utils.py:14-15).  We keep the exact flag names and
default values so every recipe in the reference README / scripts/run-experiments.py
translates 1:1, but expose them as an explicit, immutable dataclass that is
passed down the call stack instead of a process-global.

The dataclass is hashable so it can be used as a static argument to ``jax.jit``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class Config:
    """All training/eval options.

    Field names and defaults mirror gcn/train.py:25-67 of the reference.
    Additions without a reference counterpart are grouped at the bottom.
    """

    # -- core experiment flags (reference gcn/train.py:25-34) --
    dataset: str = "cora"
    model: str = "graphsage"  # 'graphsage' | 'mlp'
    learning_rate: float = 0.01
    epochs: int = 200                 # min number of epochs to train
    data: int = 0                     # max amount of visited data (edge budget)
    hidden1: int = 32
    dropout: float = 0.5              # dropout RATE (keep_prob = 1 - dropout)
    dense_input: bool = False
    weight_decay: float = 5e-4
    early_stopping: int = 10

    # -- sampling (train.py:36-44) --
    degree: int = 20                  # per-layer neighbour fanout
    batch_size: int = 1000
    cv: bool = False                  # control variate
    preprocess: bool = True           # PP: precompute first aggregation
    test_batch_size: int = 1000
    test_degree: int = 20
    test_cv: bool = False
    test_preprocess: bool = True

    # -- architecture (train.py:46-52) --
    num_layers: int = 2
    num_fc_layers: int = 1
    beta1: float = 0.9
    beta2: float = 0.999
    normalization: str = "gcn"        # 'gcn' | 'graphsage'
    layer_norm: bool = False
    polyak_decay: float = 0.0

    # -- estimator variants (train.py:53-59) --
    load: bool = False
    det_dropout: bool = False
    cvd: bool = False
    test_cvd: bool = False
    importance: bool = False
    test_importance: bool = False

    # -- misc (train.py:61-67) --
    seed: int = 1
    max_degree: int = -1              # cap graph degree at load (GraphSAGE data)
    gradvar: bool = False
    reverse: bool = False             # dropout after dense instead of before
    pp_nbr: bool = True               # PP uses neighbour features

    # ---- additions (no reference counterpart) ----
    # Degree cap for the device-resident padded adjacency.  -1 = use the true
    # max degree of the graph (exact semantics).  For power-law graphs set to
    # e.g. 128; equivalent to the reference's --max_degree load-time subsample.
    pad_degree: int = -1
    # Directory holding dataset files (the reference's data/ convention).
    data_dir: str = "data"
    # Storage dtype for the CV history buffers: 'bfloat16' (default —
    # halves device memory and gather bytes of the full-neighborhood term,
    # the largest gather of the CV step; the CV estimator stays unbiased
    # for any stored h-bar, and CV/CVD accuracy at bf16 was validated
    # inside the replica acceptance bands, REPLICA_VALIDATION_BF16.json)
    # or 'float32' (reference semantics; the estimator-math test oracles
    # pin this).
    history_dtype: str = "bfloat16"
    # Dtype of the EVAL-side history buffers.  Kept float32 by default so
    # CV test-time inference converges to EXACTLY the deterministic exact
    # prediction after num_layers+1 passes (the reference's Test protocol,
    # train.py:320-329); bf16 eval histories reach only a bf16 fixed point
    # (last two passes wobble by ~1e-4 in loss).  Training throughput is
    # unaffected.
    test_history_dtype: str = "float32"
    # Dtype of the device-resident input-feature tables (dense rows or
    # padded-sparse values) — the LARGEST tables for feature-heavy graphs
    # (the graphsage PP input is [N, 2*feat_dim] f32 = 1.1 GB at Reddit
    # shape).  bfloat16 halves their device footprint and host->device
    # transfer; the first-layer contraction promotes to f32 (mixed
    # bf16 x f32 matmul), matching the bf16-history precision story.
    # float32 (default) is the bit-level reference semantics.
    features_dtype: str = "float32"
    # IS: hoist importance[graph.nbr] into a per-epoch [N, Dcap] row table
    # and route scheduling through the pre-fusion expand_importance flow.
    # SUPERSEDED: the default fused is_slots path (one packed [N+1, 2]
    # per-slot gather, scheduler.schedule) is the default; this flag
    # remains as the legacy comparison arm and costs a transient
    # [N, Dcap] f32 (+50% of the padded graph's memory) when on.
    is_row_table: bool = False
    # IS: compact each [F, Dcap] slot row to its is_slot_cap highest-weight
    # SELECTED slots (scheduler.is_slot_compact) so the downstream fanout
    # gather issues F*cap activation rows instead of F*Dcap — the dominant
    # IS cost at scale.  Rows with more
    # selected slots than the cap drop their lowest-weight edges (counted
    # in the is_dropped metric) — a bounded deviation from the reference's
    # keep-every-edge semantics (scheduler.cpp:118-121).  0 = off (exact
    # reference semantics).  The expected selected slots/row at the Reddit
    # recipe is < 2, so 8 is a comfortable cap (drop rate 0.004% of slots
    # at batch 4096; replica bands green).  -1 = auto (default): 8 when
    # the scheduled batch has >= 2048 rows (where the F*Dcap fanout gather
    # dominates the step), 0 below (small batches are latency-bound;
    # compaction would only add kernels).  Resolved per batch shape in
    # scheduler.schedule.
    is_slot_cap: int = -1
    # Dedup-compact each receptive field (the reference's `visited` map,
    # scheduler.cpp:48-52).  The DEFAULT is the no-dedup (append-only)
    # layout: sampled neighbor ids append to the field without dedup,
    # duplicate ids occupy separate positions and recompute identical
    # values (static capacities make this free whenever F*degree <= N —
    # the capacity clamp never bound), while the scheduler's O(N)
    # cumsum/mask compaction passes disappear entirely; slot positions
    # become a trace-time iota.  The full replica acceptance bands hold
    # under it
    # (REPLICA_VALIDATION_NODEDUP.json) — the same validate-then-default
    # path bf16 history took.  --field_dedup restores the
    # reference-faithful compacted layout.  Estimator deviation vs dedup:
    # each duplicate position expands its OWN neighbor sample (and dropout
    # mask) below it where the reference's `visited` map shares one sample
    # per node — every position remains an iid unbiased estimate of the
    # same activation, so unbiasedness and CV->exact-at-full-degree are
    # preserved (tests/test_field_dedup.py); the trajectory is a different
    # (equally distributed) sample stream than dedup's.  Dedup is forced
    # back ON (scheduler.effective_dedup) under --importance (slots
    # address the selected union by id), under --owner_batching's
    # owner-ALIGNED layout (positional ownership blocks are compaction by
    # construction), and whenever a layer's candidate count F*k reaches N
    # (Exact mode — append-only capacities would grow combinatorially
    # where the dedup clamp caps them).  Plain meshes ride no-dedup since
    # round 4: the owner-routed transports handle duplicate rows
    # (last-write scatter races are the documented semantics).
    field_dedup: bool = False
    # Hoist the on-device scheduler OUT of the per-step scan body into a
    # chunked vmapped per-epoch pre-pass (one batched dispatch schedules
    # every step of the epoch).  At small batch the schedule is
    # kernel-LATENCY bound (~15 sequential small kernels at batch 512) —
    # batching over steps amortizes the launch chain S-fold while keeping
    # the sampled trajectory
    # BIT-IDENTICAL (same per-step fold_in keys).  "auto" enables it on
    # single-chip epochs whenever the precomputed packs fit the byte
    # budget below (Exact-mode packs are ~17 MB/step and stay in-step);
    # "on"/"off" force it.  Mesh epochs always schedule in-step (pack
    # tensors would need their own shardings).
    sched_prepass: str = "auto"
    sched_prepass_budget_mb: int = 256
    sched_prepass_chunk: int = 32
    # Number of devices along the data-parallel mesh axis (1 = single chip).
    dp: int = 1
    # Devices along a tensor-parallel 'model' mesh axis (total chips =
    # dp * tp).  Dense weights/norm params shard their hidden dimension
    # Megatron-style, histories shard [node, hidden] over (data, model) —
    # for very wide hidden dims (SURVEY.md §2.3); the reference is
    # single-GPU.  1 = off.
    tp: int = 1
    # Host count of the dp mesh: the 'data' axis is built host-major over a
    # (dp_hosts, dp/dp_hosts) grid (jax.distributed device order), so each
    # host owns a contiguous block of sharded node rows and halo exchanges
    # cross hosts only for remote-host rows.  1 = single-host.  Under
    # --coordinator, num_processes / dp_hosts processes share each host
    # and each then opens one card (parallel/distributed.py).
    dp_hosts: int = 1
    # Multi-controller (multi-process / multi-host) launch: coordinator
    # address "host:port" for jax.distributed.initialize.  Every process
    # runs the same CLI with the same flags plus its own --process_id;
    # --dp then counts GLOBAL chips along the data axis.  Empty = single
    # process.  (SURVEY §2.3 scale-out; the reference is single-process.)
    coordinator: str = ""
    # Total process count / this process's id for jax.distributed
    # (ignored unless --coordinator is set).
    num_processes: int = 1
    process_id: int = 0
    # With row-sharded history (--dp > 1): route the CV full-neighborhood
    # term through an explicit halo exchange (local contraction +
    # psum_scatter of [F, d] partials) instead of GSPMD's default
    # all-reduce of the [F, Dcap, d] gather result — Dcap x less
    # interconnect traffic.  Disable to fall back to pure GSPMD lowering.
    halo_exchange: bool = True
    # With --dp > 1 (and the padded graph format): shard the [N, Dcap]
    # graph rows, node features and labels along the node dimension too —
    # per-device memory then scales as N/P for EVERY O(N) table, with row
    # accesses routed from owner chips (parallel/halo.py).  Small [N]
    # vectors (degrees, block starts, importance) stay replicated by
    # design; edgelist-format block tables node-shard too (per-device
    # memory ~O(E/P), window block reads owner-routed).
    shard_graph: bool = True
    # Per-destination capacity multiplier for the owner-routed history
    # scatter: capacity = max(8, ceil(scatter_cap_mult * C/P / P)) rows per
    # (source, destination) chip pair (clamped to C/P, which guarantees
    # zero drops).  Updates beyond capacity are dropped — the affected
    # history rows stay one step staler, which the CV estimator tolerates
    # by construction — and counted in the hist_dropped metric.  >= dp
    # forces exactness for any skew.
    scatter_cap_mult: float = 2.0
    # Per-destination capacity multiplier for the FETCH-routed halo
    # gathers (history/graph/feature/label/activation row reads): same
    # formula as scatter_cap_mult.  Unlike the scatter, gather overflow is
    # NEVER lossy — an in-graph lax.cond falls back to the exact psum
    # lowering — so small capacities only risk occasional slower steps.
    # 0 = auto: 2.0 (shuffled batches), 0.5 under --owner_batching
    # (~97-100% of requests are chip-local there, so spill buffers can be
    # 4x smaller).
    gather_cap_mult: float = 0.0
    # Partition-aware batch assignment (--dp > 1): fill each chip's batch
    # columns with train/eval ids whose history/graph rows that chip OWNS
    # (row-sharding assigns contiguous node blocks), so the batch field's
    # history reads/writes are chip-local; ids overflowing their owner's
    # slots spill to other chips' free slots, so each id still appears
    # exactly once per epoch (reference epoch semantics, train.py:181-190).
    # Batches become owner-stratified samples instead of uniform draws —
    # per-epoch coverage is identical, batch composition is not.
    owner_batching: bool = False
    # Relabel nodes at load time by a locality-improving permutation so
    # that graph neighbors land in the same contiguous ownership block:
    # 'rcm' = reverse Cuthill-McKee over the symmetrized full adjacency
    # (bandwidth-minimizing).  Together with --owner_batching this makes
    # the sampled receptive field mostly chip-local.  Pure relabeling —
    # training semantics are permutation-invariant.  'none' = keep ids.
    partition_nodes: str = "none"
    # Cap on padded nnz/row for sparse feature matrices (NELL-style).
    feat_nnz_cap: int = 1024
    # Device graph layout: 'padded' ([N, Dcap] rows — fastest when degrees
    # are capped/uniform) or 'edgelist' (flat CSR, O(E) storage + per-batch
    # edge enumeration for the CV full-neighborhood term — for power-law
    # graphs whose max degree makes padding prohibitive).
    graph_format: str = "padded"
    # Edge budget multiplier for the edgelist full-neighborhood term:
    # capacity per output row = ceil(fadj_edge_mult * mean_degree).
    # 0 (default) = auto-size from the degree distribution: the smallest
    # budget covering >= 99.9% of full-term edges (graph.AUTO_EDGE_COVERAGE)
    # — a fixed multiplier silently degrades skewed graphs.
    # Budget-truncated rows are renormalized to preserve row
    # mass either way (FlatGraph.renorm, the reference's --max_degree
    # semantics, gcn/utils.py:532-543).
    fadj_edge_mult: float = 0.0
    # Two-tier CV full-neighborhood contraction on padded graphs: a narrow
    # [F, tier_w] main gather (exact for ~all rows) + a capacity-bounded
    # tail pass for the few rows with degree > tier_w, with an exact
    # lax.cond fallback on overflow.  Recovers the row-issue cost of
    # padding to the graph max degree (the CV step's dominant cost) when
    # the mean degree is well below it.  Split chosen per graph by
    # data.graph.choose_tier; fadj_tier_w > 0 overrides the width.
    # Engages only at fields >= aggregators.TIER_MIN_ROWS rows: at small
    # fields the extra compaction/cond kernels cost more latency than the
    # saved gather rows.
    fadj_tier: bool = True
    fadj_tier_w: int = 0
    # Epoch-frozen CV anchor ("lazy full term"): snapshot h-bar at epoch
    # start, precompute a-bar = A_full . h-bar ONCE per epoch as a chunked
    # bulk SpMM (models/aggregators.py::full_abar, inside the same epoch
    # dispatch), and anchor BOTH CV terms at the snapshot — the per-step
    # full-neighborhood term (reference gcn/layers.py:355, the largest
    # gather of the step) becomes ONE [F, d] row gather of a-bar
    # instead of an [F, Dcap] history-row gather.  The estimator stays
    # exactly unbiased (E[Z] = A.H around the common anchor; delta and
    # full terms read the SAME snapshot) and exact at convergence; the
    # one semantics change vs the reference is anchor staleness: all
    # anchors are epoch-start instead of last-visit (both <= 1 epoch
    # stale).  Worth it only where the saved per-step gather rows exceed
    # the per-epoch N x Dcap recompute (large batches); default off.
    # Single-chip train path; meshes and eval keep the per-step term.
    lazy_fullterm: bool = False
    # Unroll factor for the whole-epoch lax.scan (steps per scan body).
    # >1 amortizes per-iteration scan bookkeeping when the step itself is
    # dispatch-overhead-bound (small batches); costs compile time.
    scan_unroll: int = 1
    # Directory for checkpoints.
    ckpt_dir: str = "tmp"
    # Save a checkpoint every N epochs (0 = only at the end, reference
    # behavior). Adds preemption safety the reference lacks (SURVEY §5.4).
    ckpt_every: int = 0
    # zlib-compress checkpoints (default).  At Reddit scale the state is
    # ~173 MiB and compression is the dominant (host-side) save cost;
    # frequent --ckpt_every preemption snapshots want --nockpt_compress.
    ckpt_compress: bool = True
    # Double-buffered checkpointing (opt-in): save() snapshots the device
    # state into fresh buffers (an on-device copy), then the device->host
    # fetch and the file write run on a background thread while the next
    # epoch's scan trains — an overlap the reference's end-of-training
    # tf.train.Saver never needed (models.py:204-220).  Writes are atomic
    # (tmp + rename), so a crash mid-write leaves the previous complete
    # snapshot; the final save and any load/resume wait for pending
    # writes.  Multi-controller launches fall back to the synchronous
    # collective save (shard gathers cannot overlap the next epoch's
    # collectives).  Default off until a GPU measurement shows the
    # overlap wins.
    ckpt_async: bool = False
    # Continue a preempted/interrupted run from ckpt_dir's checkpoint:
    # restores the full train state (params, Adam, histories, RNG) PLUS
    # the loop counters (completed epochs, cumulative sampled-edge count
    # for the --data budget, the early-stopping validation-loss window),
    # then keeps training.  Starts fresh when no checkpoint exists, so
    # the SAME command line works for the first launch and every
    # relaunch.  Contrast --load, which restores weights and skips
    # training entirely (reference train.py:171-175 semantics).
    resume: bool = False
    # Profiling surface (§5.1): write a jax.profiler trace (XProf /
    # TensorBoard `plugins/profile` format — device timeline, HLO op
    # breakdown, memory viewer) of selected train epochs to this
    # directory.  The functional analogue of the reference's per-epoch
    # "TF time" accounting (gcn/train.py:203-207) with full op-level
    # visibility.  Empty = off.
    profile_dir: str = ""
    # 1-based epoch numbers to trace (comma-separated).  Default traces
    # epoch 2 only: epoch 1 is compile-dominated, and each traced epoch
    # costs a trace file + host processing.
    profile_epochs: str = "2"

    # -------- derived properties (mirror train.py:85-87) --------
    @property
    def multitask(self) -> bool:
        return self.dataset == "ppi"

    @property
    def train_L(self) -> int:
        """Number of sampled aggregation layers at train time."""
        return self.num_layers - 1 if self.preprocess else self.num_layers

    @property
    def test_L(self) -> int:
        return self.num_layers - 1 if self.test_preprocess else self.num_layers

    @property
    def keep_prob(self) -> float:
        return 1.0 - self.dropout

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
                   help_: str = "") -> None:
    """TF1-style bool flags: --flag / --noflag / --flag=True|False."""
    dest = name

    class _BoolAction(argparse.Action):
        def __call__(self, p, ns, values, option_string=None):
            if option_string.startswith("--no"):
                setattr(ns, dest, False)
            elif values is None:
                setattr(ns, dest, True)
            else:
                setattr(ns, dest, str(values).lower() in ("true", "1", "yes"))

    parser.add_argument(f"--{name}", nargs="?", action=_BoolAction,
                        default=default, metavar="BOOL", help=help_)
    parser.add_argument(f"--no{name}", nargs=0, action=_BoolAction,
                        dest=dest, help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="stochastic_gcn_tpu trainer",
        fromfile_prefix_chars="@",
    )
    for f in dataclasses.fields(Config):
        if f.type == "bool" or isinstance(f.default, bool):
            _add_bool_flag(parser, f.name, f.default)
        else:
            ty = {"int": int, "float": float, "str": str}.get(
                f.type, type(f.default))
            parser.add_argument(f"--{f.name}", type=ty, default=f.default)
    return parser


def parse_flags(argv: Optional[Sequence[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**{f.name: getattr(ns, f.name)
                     for f in dataclasses.fields(Config)})
