"""Typed, immutable experiment configuration (the PyTorch port's copy).

A copy of ``fedtorch_tpu/config.py``: the port imports nothing
of the JAX package, so it carries its own copy, and flag names and
:meth:`ExperimentConfig.finalize` stay identical between the two
(tests/test_torch_models.py builds both configs from the same kwargs).
The notes below describe the JAX package the flags were designed for.

Capability parity with the reference flag system
(the reference's ``fedtorch/parameters.py:12-260``), redesigned for a
TPU/JAX build:

* Static configuration is a frozen, hashable dataclass tree, so it can be
  passed as a ``static_argnum`` through ``jax.jit`` boundaries. The
  reference instead threads a mutable ``argparse.Namespace`` everywhere and
  writes runtime values back into it (``SURVEY.md`` §5.6); here runtime
  state lives in explicit pytrees (see ``fedtorch_tpu.core.state``).
* Post-parse derivations/validations from ``parameters.py:245-259``
  (federated epoch count, AFL coercion, qsparse->compressed, quantize xor
  compress, personalization->fed_personal) are reproduced in
  :meth:`ExperimentConfig.finalize`.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

# Algorithms that keep a second, personalized model per client
# (ref: parameters.py:257-259).
PERSONALIZED_ALGORITHMS = ("apfl", "perfedme", "perfedavg")

# Robust aggregation rules at the round/commit aggregation seam
# (robustness/aggregators.py; 'mean' = the pre-robustness weighted sum)
# and the in-jit byzantine adversary models that test them
# (robustness/chaos.py). Declared here so config validation stays
# stdlib-only — the jax implementations import THESE tuples.
ROBUST_AGGREGATORS = ("mean", "median", "trimmed_mean", "krum",
                      "multikrum", "norm_bound")
BYZANTINE_MODES = ("sign_flip", "scale", "zero", "gauss", "collude")
# norm_bound carries a params-shaped server momentum in server.aux;
# algorithms with structured payload trees (SCAFFOLD's control deltas,
# qFFL's fairness scalar, DRFA's nested wrapper) have no single tree
# the momentum can live against, so they raise at construction.
NORM_BOUND_ALGORITHMS = ("fedavg", "fedprox", "fedadam")
# The DP stage (robustness/privacy.py) clips each client's single
# params-shaped update payload radially; the same structured-payload
# algorithms that can't host norm_bound's momentum have no single
# tree a fixed-radius clip is meaningful against, so DP refuses them
# by name at finalize too.
DP_ALGORITHMS = ("fedavg", "fedprox", "fedadam")

# Named host-plane fault seams (robustness/host_chaos.py;
# docs/robustness.md "Host plane"). Each names one host-side I/O or
# thread boundary where the seeded injector can fire — and where the
# matching self-healing policy (robustness/host_recovery.py) must
# absorb the fault. Declared here so config validation stays
# stdlib-only; the injector imports THIS tuple.
HOST_FAULT_SEAMS = (
    "stream.gather",    # producer row gather raises (transient)
    "stream.delay",     # producer gather stalls host_fault_delay_s
    "stream.h2d",       # device_put dispatch of the packed feed raises
    "ckpt.write",       # checkpoint atomic write raises ENOSPC
    "ckpt.torn",        # checkpoint write lands TRUNCATED (torn frame)
    "telemetry.write",  # metrics/events/health file write raises
    "native.load",      # native library load fails -> numpy fallback
)

# Client-availability models (robustness/availability.py;
# docs/robustness.md "Deployment realism"). 'default' reproduces the
# legacy AsyncSchedule draws bitwise (straggler-knob aliasing — the
# tail-delay Bernoulli off the _DELAY_SALT fold chain, no dropouts);
# 'trace' is the in-tree synthetic deployment trace: FedScale-style
# device-class speed multipliers + a diurnal on/off availability curve
# + mid-round dropout, all threefry draws off the experiment key.
# Declared here so config validation stays stdlib-only — the jax
# implementation imports THIS tuple.
AVAILABILITY_MODELS = ("default", "trace")

# Client-store implementations behind the stream plane's feed packer
# (data/streaming.py ClientStore; docs/performance.md "The
# million-client store"): 'ram' keeps the [C, n_max, ...] population
# arrays host-resident (the seed behavior — population capped by host
# RAM); 'mmap' memory-maps a manifest-described sharded file layout
# from data.store_dir, so host residency is O(feed) and population is
# capped by disk. Declared here so config validation stays stdlib-only.
CLIENT_STORES = ("ram", "mmap")

# Participation-sampling modes (parallel/federated.py
# participation_indices): 'perm' is the legacy full-permutation draw
# (bitwise-pinned by every parity test — O(C log C) per round); 'sparse'
# is the O(k)-memory sparse Fisher-Yates draw that never materializes a
# [C] array (million-client populations). Both are replayed bit-exactly
# by the host RoundSchedule and the async scheduler.
PARTICIPATION_MODES = ("perm", "sparse")

FEDERATED_ALGORITHMS = (
    "fedavg", "scaffold", "fedprox", "fedgate", "fedadam", "apfl", "afl",
    "perfedavg", "qsparse", "perfedme", "qffl",
)

DATASETS = (
    "cifar10", "cifar100", "mnist", "fashion_mnist", "emnist", "emnist_full",
    "synthetic", "shakespeare", "adult", "epsilon", "MSD", "higgs", "rcv1",
    "stl10",
)


@dataclass(frozen=True)
class DataConfig:
    """Dataset & partitioning knobs (ref: parameters.py:23-37, 41-66)."""
    dataset: str = "cifar10"
    data_dir: str = "./data/"
    partition_data: bool = True
    # Non-IID partitioning scheme (ref: partition.py:106-220).
    iid: bool = True
    num_class_per_client: int = 1
    unbalanced: bool = False
    dirichlet: bool = False
    dirichlet_alpha: float = 0.1  # hard-coded in the reference partitioner
    # Synthetic dataset heterogeneity (ref: parameters.py:33-36).
    synthetic_alpha: float = 0.0
    synthetic_beta: float = 0.0
    synthetic_dim: int = 60
    # default matches the reference GENERATOR (federated_datasets.py:205
    # num_classes=2). Note the reference's own quirk, reproduced by the
    # model zoo for parity: synthetic model HEADS are sized 10-way
    # (logistic_regression.py:65-67) while labels only span this many.
    synthetic_num_classes: int = 2
    # lower edge of the per-client lognormal size window (upper = 2x);
    # the default reproduces the reference's 500/1000 generator window
    synthetic_samples_per_client: int = 500
    synthetic_regression: bool = False
    # Adult sensitive-feature split (ref: parameters.py:37).
    sensitive_feature: int = 9
    # Federated data plane — the data-source axis of the JAX package's
    # round-program composer (docs/performance.md): 'device'
    # shards every client's rows into HBM at trainer construction and
    # hands the full [C, n_max, ...] pytree to each jitted round (the
    # reference-faithful seed behavior — population capped by device
    # memory); 'stream' keeps the client store host-resident and feeds
    # each dispatch the K online clients' packed rows — one feed per
    # round, or an [R, ...] feed window under the scanned dispatch
    # (run_rounds) — built and transferred one dispatch ahead of
    # device compute (population capped by host RAM;
    # bitwise-identical trajectories). Both values compose with every
    # dispatch (per-round | scan | async commit) and execution
    # (vmap | fused) the cell validator allows
    # (parallel/round_program.py).
    data_plane: str = "device"
    # Host client-store implementation behind the stream plane's feed
    # packer (CLIENT_STORES; docs/performance.md "The million-client
    # store"): 'ram' holds the population in host memory, 'mmap' maps
    # the sharded on-disk layout at ``store_dir`` (built by
    # data/streaming.py save_client_store / MmapStoreWriter) so host
    # residency stays O(feed) while the population scales to disk.
    # 'mmap' requires data_plane='stream' — the device plane uploads
    # the whole store to HBM, which is exactly what mmap exists to
    # avoid.
    store: str = "ram"
    store_dir: str = ""
    # Batching (ref: parameters.py:131-141).
    batch_size: int = 50
    growing_batch_size: bool = False
    base_batch_size: Optional[int] = None
    max_batch_size: int = 0
    reshuffle_per_epoch: bool = False
    # Personalization val split sizes mirror dataset.py:168-211.
    val_fraction: float = 0.2
    # train-time flip+crop augmentation (prepare_data.py:29-35 applies it
    # for the cifar family); None = on for cifar/stl10, off otherwise
    augment: Optional[bool] = None
    # EMNIST ships train-only in some mirrors; slicing train rows in as
    # a fake test set silently reports train accuracy as test accuracy,
    # so the fallback is opt-in (data/datasets.py raises without it)
    allow_train_as_test: bool = False


@dataclass(frozen=True)
class FederatedConfig:
    """Federated-mode knobs (ref: parameters.py:40-110)."""
    federated: bool = False
    num_clients: int = 10  # world size in the reference's MPI mode
    num_comms: int = 100
    online_client_rate: float = 0.1
    sync_type: str = "epoch"  # 'epoch' | 'local_step'
    num_epochs_per_comm: int = 1
    algorithm: str = "fedavg"  # --federated_type
    # How the k online clients are drawn each round
    # (PARTICIPATION_MODES): 'perm' = the legacy full-permutation
    # sample (misc.py:10-19 — trajectories bitwise-pinned); 'sparse' =
    # the O(k)-memory draw for million-client populations (same
    # uniform without-replacement law, different stream). Replayed
    # bit-exactly by the host schedule and the async scheduler.
    participation_mode: str = "perm"
    # Server execution plane (docs/robustness.md "Asynchronous
    # federation"): 'sync' (default, the reference-faithful seed
    # behavior) blocks each round on all k online clients; 'async' is
    # the FedBuff-style buffered server (arXiv:2106.06639) — clients
    # train against a possibly-stale snapshot from a commit-versioned
    # ring, the server folds arrivals into a buffer of
    # ``async_buffer_size`` staleness-weighted updates and commits
    # through the guard/renormalization path when it fills. In async
    # mode ``num_comms`` counts COMMITS and ``fault.straggler_rate``
    # draws arrival DELAYS (long-tail wall-clock), not step cuts.
    sync_mode: str = "sync"  # 'sync' | 'async'
    # updates buffered per commit (FedBuff's m). 0 = auto:
    # max(1, k_online // 2) — commits gate on the fastest half of the
    # in-flight cohort, never on the slowest client.
    async_buffer_size: int = 0
    # concurrently-training clients (FedBuff's M_c). 0 = auto: k_online
    # (the sync round's compute budget).
    async_concurrency: int = 0
    # staleness weight s(tau) applied to a buffered update that trained
    # against a snapshot tau commits old: 'poly' = (1+tau)^-exponent
    # (the FedBuff default), 'inv' = 1/(1+tau), 'const' = 1. Weights
    # are normalized to mean 1 per commit, so tau=0 reproduces the sync
    # aggregation weighting exactly (async_plane/staleness.py).
    staleness_weight: str = "poly"
    staleness_exponent: float = 0.5
    # server snapshot ring depth: how many past commit versions stay
    # resident for in-flight clients (memory cost: ring x (params +
    # server aux)). Updates older than the ring are clamped to the
    # oldest retained snapshot (counted in the scheduler stats).
    snapshot_ring: int = 8
    # Personalization.
    personal: bool = False          # --fed_personal
    personal_alpha: float = 0.5     # APFL mixing alpha
    adaptive_alpha: bool = False    # optimize APFL alpha on the fly
    personal_test: bool = False
    # Server adaptivity (FedAdam, arXiv:2003.00295).
    fedadam_beta: float = 0.9
    fedadam_tau: float = 0.1
    # Wire compression (ref: parameters.py:81-89).
    quantized: bool = False
    quantized_bits: int = 8
    compressed: bool = False
    compressed_ratio: float = 1.0
    # DRFA wrapper (ref: parameters.py:90-97).
    drfa: bool = False
    drfa_gamma: float = 0.1
    # paper-faithful lambda-distributed client sampling; the reference's
    # loop samples uniformly (drfa.py:71,216) despite misc.py:30-37
    drfa_lambda_sampling: bool = False
    # Per-algorithm scalars.
    perfedavg_beta: float = 0.001
    fedprox_mu: float = 0.002
    perfedme_lambda: float = 15.0
    qffl_q: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (ref: parameters.py:113-115, 180-194)."""
    arch: str = "mlp"
    drop_rate: float = 0.0
    # Normalization: 'bn' matches the reference; 'gn' is the TPU-friendly
    # stateless default (no running stats to carry through collectives).
    norm: str = "bn"
    densenet_growth_rate: int = 12
    densenet_bc_mode: bool = False
    densenet_compression: float = 0.5
    wideresnet_widen_factor: int = 4
    mlp_num_layers: int = 2
    mlp_hidden_size: int = 500
    rnn_seq_len: int = 50
    rnn_hidden_size: int = 50
    vocab_size: int = 86
    # transformer arch only: >0 swaps each block's MLP for a Switch-MoE
    # with this many experts (expert-parallel over the mesh when sharded)
    moe_experts: int = 0
    # MoE dispatch: 0 = exact dense one-hot dispatch (no drops, costs E×
    # the dense MLP FLOPs — oracle/testing mode); >0 = sparse Switch
    # dispatch with per-expert capacity ceil(cf·tokens/E) (costs cf× the
    # dense MLP FLOPs; over-capacity tokens drop to the residual)
    moe_capacity_factor: float = 0.0
    # Switch load-balancing auxiliary loss weight (arXiv:2101.03961
    # §2.2; paper default 0.01). 0 disables; without it the top-1 gate
    # can collapse onto one expert.
    moe_aux_weight: float = 0.0
    # resnet-family convolution lowering: 'conv' = XLA's native
    # convolution; 'matmul' = im2col + one batched matmul per layer
    # (identical params/math; fills the MXU differently under the
    # federated engine's per-client weight axis — docs/performance.md
    # "MFU roofline", measured by vmap_penalty_bench's conv_lowering).
    # 'auto' (default) resolves per (arch, dataset) in define_model:
    # matmul for the conv families on small-image datasets, where the
    # round-5 XLA A/B measured 7.0-8.2x (CONV_AB_CPU.json) and the
    # N-lane roofline predicts a larger MXU win; conv elsewhere (the
    # kh*kw x patch-memory trade is prohibitive at 96px+ inputs).
    conv_impl: str = "auto"
    # transformer attention backend: 'dense' (materialized scores),
    # 'flash' (fused online-softmax pallas kernel on TPU, O(block^2)
    # score memory; exact, dense fallback off-TPU), or 'auto'
    # (default): per-sequence-length dispatch that picks flash only
    # where the on-chip training A/B measured it winning outside the
    # noise band (T >= 4096; FLASH_TRAIN.json read 0.68x at T=2048 —
    # ops/attention_dispatch.py:resolve_attention)
    attention: str = "auto"
    pretrained: bool = False
    # 'robust_*' archs learn an adversarial input-noise parameter.
    robust_noise_ascent_lr: float = 0.1


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer & momentum scheme (ref: parameters.py:168-183)."""
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr: float = 0.01
    in_momentum: bool = False
    in_momentum_factor: float = 0.9
    out_momentum: bool = False
    # Default derived as 1 - 1/n in the reference (optimizer.py:6-31).
    out_momentum_factor: Optional[float] = None
    use_nesterov: bool = False
    dampening: float = 0.0
    weight_decay: float = 5e-4
    correct_wd: bool = False  # AdamW decoupled weight decay switch
    # True excludes normalization scale/shift and bias parameters from
    # weight decay (the standard deep-learning practice). Default False
    # = the reference's uniform decay over every parameter
    # (sgd.py:96-101 applies wd to the whole param group, BN included)
    # — parity runs against the reference need the biased-but-faithful
    # behavior, so the exclusion is opt-in (core/optim.py).
    wd_skip_norm_bias: bool = False
    lr_scale_at_sync: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8


@dataclass(frozen=True)
class LRConfig:
    """LR schedule compiler inputs (ref: parameters.py:144-166)."""
    # strict|custom_one_cycle|custom_multistep|custom_convex_decay
    schedule_scheme: Optional[str] = None
    lr_change_epochs: Optional[str] = None
    lr_fields: Optional[str] = None
    lr_scale_indicators: Optional[str] = None
    scaleup: bool = False
    scaleup_type: str = "linear"
    scaleup_factor: Optional[float] = None
    warmup: bool = False
    warmup_epochs: int = 5
    decay: float = 10.0
    onecycle_low: float = 0.15
    onecycle_high: float = 3.0
    onecycle_extra_low: float = 0.0015
    onecycle_num_epoch: int = 46
    gamma: Optional[float] = None
    mu: Optional[float] = None
    alpha: Optional[float] = None


@dataclass(frozen=True)
class TrainConfig:
    """Stop criteria & local-step schedule (ref: parameters.py:118-130)."""
    stop_criteria: str = "epoch"  # 'epoch' | 'iteration'
    num_epochs: Optional[int] = None
    num_iterations: Optional[int] = None
    local_step: int = 1
    local_step_warmup_per_interval: bool = False
    local_step_warmup_type: Optional[str] = None  # 'exp' | 'linear' | constant
    local_step_warmup_period: Optional[int] = None
    turn_on_local_step_from: Optional[int] = None
    turn_off_local_step_from: Optional[int] = None
    avg_model: bool = True
    manual_seed: int = 6
    evaluate: bool = False
    eval_freq: int = 1
    summary_freq: int = 10
    # report per-class validation accuracy (--per_class_acc,
    # parameters.py:98-99)
    per_class_acc: bool = False


@dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint/resume (ref: parameters.py:204-222)."""
    checkpoint_dir: str = "./checkpoint/"
    # exact run directory (no hyperparam/timestamp subfolders). A
    # restarted process must FIND the previous attempt's checkpoint, so
    # elastic runs (robustness/harness.py) pin this to a stable path
    # and pass the same path as the harness's --ckpt_dir.
    run_dir: Optional[str] = None
    resume: Optional[str] = None
    checkpoint_index: Optional[str] = None
    save_all_models: bool = False
    save_some_models: str = "1,29,59"
    # bounded retention for the per-round checkpoint_r{N}.ckpt keeps:
    # > 0 garbage-collects all but the newest N after each write; 0
    # (default) keeps everything — save_all_models' historical
    # semantics. model_best.* and checkpoint.ckpt are never collected.
    keep_last_n: int = 0
    # write checkpoints from a background thread (atomic tmp+rename)
    # so training dispatch never blocks on serialization/disk
    async_save: bool = False
    log_dir: str = "./logdir/"
    track_model_aggregation: bool = False
    check_model_at_sync: bool = False
    debug: bool = False


@dataclass(frozen=True)
class FaultConfig:
    """Fault injection, update guards, and round-supervisor knobs.

    The reference has NO fault handling: its MPI mode is fail-stop (one
    dead client kills the ``mpirun`` job) and a NaN client update
    poisons the server silently. These knobs drive the robustness
    subsystem (``fedtorch_tpu.robustness``, docs/robustness.md):

    * Chaos injection runs INSIDE the jitted round program and is
      deterministic under the threaded PRNG — a seeded run replays the
      exact same crash/straggler/poison schedule.
    * Update guards screen client deltas server-side before aggregation.
    * The supervisor wraps the host round loop with rollback + retry.
    """
    # -- chaos injection (parallel/federated.py) -----------------------
    # per-round probability each ONLINE client crashes mid-round: its
    # update is masked out of aggregation, surviving weights are
    # renormalized, and its local state rolls back (fail-stop semantics)
    client_drop_rate: float = 0.0
    # per-round probability an online client is a straggler: it only
    # completes ceil(straggler_step_frac * budget) of its local steps
    # (reuses the epoch-sync freeze mask, so frozen steps cost lockstep
    # FLOPs but change nothing)
    straggler_rate: float = 0.0
    straggler_step_frac: float = 0.5
    # per-round probability an online client uploads a non-finite
    # (NaN-poisoned) delta — exercises the update guards end to end
    nan_inject_rate: float = 0.0
    # fold constant separating the chaos stream from the round's
    # sampling/training streams (fixed; exposed for reproducibility
    # experiments that want distinct chaos schedules on one data seed)
    chaos_salt: int = 0x7FFFFFFD
    # -- byzantine adversary model (robustness/chaos.py) ----------------
    # fraction of the population that is a FIXED adversarial cohort
    # (floor(rate * num_clients) clients, chosen once per run from the
    # run key — persistent adversaries, not per-round coin flips).
    # Whenever a cohort member is online its upload is replaced at the
    # wire by a crafted vector per byzantine_mode. Unlike nan poison,
    # the crafted upload is FINITE and (for sign_flip/collude at scale
    # 1) carries an honest-sized norm — it passes the update guards by
    # design; the defense is the robust aggregation layer (robust_agg).
    byzantine_rate: float = 0.0
    # sign_flip: -scale*delta | scale: scale*delta | zero: free-rider |
    # gauss: scale*N(0,I) noise | collude: all byzantine clients submit
    # the identical -scale*(honest weighted-mean update)
    byzantine_mode: str = "sign_flip"
    # attack magnitude multiplier (see byzantine_mode semantics)
    byzantine_scale: float = 1.0
    # -- robust aggregation (robustness/aggregators.py) -----------------
    # aggregation rule at the round/commit seam: 'mean' (default; the
    # pre-robustness weighted sum, bitwise-identical), coordinate-wise
    # 'median', 'trimmed_mean' (robust_trim_frac off each end),
    # 'krum'/'multikrum' (pairwise-distance selection as a weight
    # mask), 'norm_bound' (centered clipping toward a server momentum
    # carried in server.aux). Composes AFTER the chaos/guard accept
    # mask and the async staleness weights.
    robust_agg: str = "mean"
    # trimmed_mean's per-end trim fraction AND krum's assumed byzantine
    # fraction f/k (the rules tolerate strictly fewer adversaries than
    # this fraction of the accepted updates)
    robust_trim_frac: float = 0.1
    # norm_bound clip radius as a multiple of the round's median
    # distance-to-momentum (scale-free, like guard_norm_multiplier).
    # Default 1.5: honest updates cluster near the momentum so mild
    # clipping is benign, while a permissive radius lets an adversary
    # ride exactly at the boundary — the attack matrix measured tau=3
    # failing against scale-3 sign flips that tau<=2 fully stops.
    robust_norm_tau: float = 1.5
    # -- server-side update guards -------------------------------------
    # screen client deltas before aggregation: non-finite deltas are
    # always rejected; finite deltas whose global l2 norm exceeds
    # guard_norm_multiplier x the median surviving norm are rejected
    # (guard_mode='reject') or scaled down to the threshold
    # (guard_mode='clip'). Rejected weight is renormalized over the
    # accepted clients.
    guard_updates: bool = False
    guard_norm_multiplier: float = 10.0
    guard_mode: str = "reject"  # 'reject' | 'clip'
    # -- host-side round supervisor ------------------------------------
    supervisor: bool = False
    # non-finite server params always trigger rollback; >0 additionally
    # treats mean online loss > factor x the running loss EMA as
    # divergence
    loss_blowup_factor: float = 0.0
    max_retries: int = 2
    backoff_base_s: float = 0.5
    # fold the attempt number into the server PRNG on retry so the
    # retried round draws a fresh participation/chaos schedule (an
    # unchanged deterministic program would reproduce the failure)
    reseed_on_retry: bool = True
    # -- host-plane fault injection (robustness/host_chaos.py) ---------
    # comma-separated seam names from HOST_FAULT_SEAMS arming the
    # deterministic host-fault injector ("" = off). Unlike the in-jit
    # chaos above, these faults fire on HOST threads and I/O paths —
    # the stream-feed producer, checkpoint writes, telemetry files,
    # the native-library loader — and the self-healing layer
    # (robustness/host_recovery.py) must absorb them: a drill proves
    # the run completes with a bitwise-identical trajectory, not that
    # training routes around lost updates.
    host_fault_seams: str = ""
    # per-check fire probability at each armed seam. The draw is a
    # pure hash of (seed, seam, check index), so a drill replays the
    # exact fault schedule on every run.
    host_fault_rate: float = 0.25
    host_fault_seed: int = 0
    # stall injected at the 'stream.delay' seam (seconds per fire)
    host_fault_delay_s: float = 0.02
    # >0 caps the TOTAL fires per seam — e.g. rate=1.0 with a cap of
    # host_retry_max+1 kills the producer exactly once and lets the
    # rebuilt producer succeed (the producer-rebuild drill)
    host_fault_max: int = 0
    # -- host-plane self-healing (robustness/host_recovery.py) ---------
    # bounded retry-with-backoff at every host seam (stream gather/H2D,
    # checkpoint atomic writes) and the producer-rebuild budget: a
    # failed producer is torn down and rebuilt through the existing
    # invalidate_stream() resync at most this many times per pop
    host_retry_max: int = 3
    host_retry_backoff_s: float = 0.05
    # -- process lifecycle (robustness/preemption.py, watchdog.py) -----
    # > 0 arms the stall watchdog: when no round completes within this
    # many seconds (the signature of a dead peer blocking a DCN
    # collective), thread stacks are dumped to the run log and the
    # process hard-exits with the restartable code 75 so the restart
    # harness cycles it. 0 (default) = off: no monitor thread, and the
    # traced round program is byte-identical (host-only feature).
    watchdog_timeout_s: float = 0.0
    # -- deployment realism (robustness/availability.py) ---------------
    # client-availability model behind AsyncSchedule arrivals and the
    # sync round lifecycle. 'default' reproduces the legacy scheduler
    # draws bitwise (straggler-knob aliasing, no dropouts); 'trace'
    # arms the in-tree synthetic deployment trace: FedScale-style
    # device-class speed multipliers + a diurnal on/off curve, all
    # threefry draws off the experiment key so completion order stays a
    # pure function of (seed, round/commit).
    avail_model: str = "default"
    # mid-round dropout probability per dispatched client: a dropped
    # client never reports (async: its arrival is discarded and its
    # slot re-dispatched; sync: it is masked out through the accept
    # seam and surviving weight renormalized)
    avail_dropout_rate: float = 0.0
    # rounds per diurnal cycle for the trace model's on/off availability
    # curve (0 = flat fleet, no diurnal modulation)
    avail_diurnal_period: int = 0
    # sync round lifecycle: dispatch ceil(over_select_frac * k_online)
    # clients and close the round on the first k_online arrivals; the
    # late tail is masked out through the accept-mask ->
    # guards.renormalize_accepted seam (1.0 = no over-selection)
    over_select_frac: float = 1.0
    # round quorum as a fraction of k_online (0 = no quorum). When
    # fewer clients report by the deadline, the round either commits
    # the renormalized partial cohort and is counted+evented as
    # degraded ('degrade', default — the run never wedges) or is
    # treated as unhealthy and aborted into the supervisor's
    # rollback/retry path ('abort'; requires fault.supervisor)
    avail_quorum_frac: float = 0.0
    avail_quorum_action: str = "degrade"  # 'degrade' | 'abort'
    # -- privacy plane (robustness/privacy.py) --------------------------
    # > 0 arms server-side DP-FedAvg aggregation: per-client L2 clip to
    # dp_clip_norm, then Gaussian noise at stddev
    # dp_noise_multiplier * dp_clip_norm / cohort_k on the weighted
    # estimate, drawn from fold_in(rng_round, DP_SALT). 0 (default) =
    # off: zero extra pytree leaves, round program HLO byte-identical.
    dp_noise_multiplier: float = 0.0
    dp_clip_norm: float = 1.0
    # > 0 arms the epsilon-budget lifecycle: the host-side RDP
    # accountant pre-checks affordability every round and, at
    # exhaustion, either ends the run cleanly at the last affordable
    # round ('stop' -> privacy.budget_exhausted event + 'complete'
    # intent) or continues noise-free ('degrade' -> 'degraded' intent,
    # counted + evented, never wedging). 0 = unlimited budget (the
    # accountant still streams epsilon_spent).
    dp_epsilon_budget: float = 0.0
    dp_delta: float = 1e-5
    dp_budget_action: str = "stop"  # 'stop' | 'degrade'

    @property
    def dp_armed(self) -> bool:
        """True when the DP aggregation stage is traced into the round
        program; disarmed programs stay byte-identical."""
        return self.dp_noise_multiplier > 0.0

    @property
    def avail_armed(self) -> bool:
        """True when any deployment-realism knob changes the traced
        round program; disarmed programs stay byte-identical."""
        return (self.avail_model != "default"
                or self.avail_dropout_rate > 0.0
                or self.over_select_frac > 1.0
                or self.avail_quorum_frac > 0.0)

    @property
    def chaos_enabled(self) -> bool:
        return (self.client_drop_rate > 0.0 or self.straggler_rate > 0.0
                or self.nan_inject_rate > 0.0
                or self.byzantine_rate > 0.0)

    @property
    def host_fault_seam_tuple(self) -> tuple:
        """The armed host seams as a tuple (CLI string split/stripped;
        empty when host chaos is off)."""
        return tuple(s.strip() for s in self.host_fault_seams.split(",")
                     if s.strip())

    @property
    def host_chaos_enabled(self) -> bool:
        return bool(self.host_fault_seam_tuple) \
            and self.host_fault_rate > 0.0


@dataclass(frozen=True)
class TelemetryConfig:
    """Run-telemetry knobs (``fedtorch_tpu.telemetry``,
    docs/observability.md). The subsystem is host-only: no level
    touches a traced program (HLO byte-identical on/off, pinned in
    tests/test_telemetry.py) and every level keeps the per-round
    device-sync count at the loop's one batched fetch."""
    # 'off' = no files, every hook a no-op; 'default' = metrics.jsonl
    # + events.jsonl + health.json + host spans (trace.json exported at
    # run end; measured <= 1% round overhead, TELEMETRY_AB.json);
    # 'debug' additionally re-exports trace.json every 25 rounds so a
    # live Perfetto session can follow a long run.
    level: str = "default"
    # span-buffer bound: past this, new spans are counted as dropped
    # instead of growing host memory on month-long runs
    max_span_events: int = 200_000
    # > 0: the one-shot cost capture additionally AOT-lowers the
    # scan-of-R round-program twin for the active data source
    # (rounds_scan[R] on the device plane, rounds_stream_scan[R] — the
    # scanned streamed program — on the stream plane) into
    # program_costs.json, so the composed scan dispatch is
    # cost-attributed alongside the per-round primary
    # (parallel/round_program.py; telemetry/costs.py). 0 = per-round
    # programs only (the default; the scan twin is a second XLA
    # compile at capture time).
    cost_capture_scan_rounds: int = 0
    # Federation-plane cohort statistics (docs/observability.md
    # "Federation plane"). UNLIKE every other telemetry knob this one
    # changes the traced round/commit program: it adds per-client
    # outputs at the _round_core aggregation seam — online ids, accept
    # /selection masks, per-client suspicion from the robust rule,
    # per-job staleness, update-norm quantiles and the cosine-
    # dispersion heterogeneity gauge — all riding the loop's ONE
    # batched fetch and feeding the per-client ledger
    # (telemetry/ledger.py). Off (default) the program is byte-
    # identical to the pre-cohort engine (the new RoundMetrics fields
    # are None — zero extra outputs); on, it traces once and the
    # trajectory stays bitwise-identical (tests/test_cohort_stats.py).
    cohort_stats: bool = False
    # population threshold/budget of the per-client ledger: at
    # num_clients <= budget the ledger keeps dense per-client numpy
    # counters; above it, count-min participation sketches plus a
    # bounded suspicion top-K — memory stays O(min(C, budget)) at
    # C >= 10^6 (measured in TELEMETRY_AB.json's ledger_memory row).
    ledger_sketch_budget: int = 65536
    # EWMA z-score threshold of the host-side anomaly detector
    # (telemetry/anomaly.py) over the metrics rows (loss, cohort
    # dispersion, guard-reject rate, staleness). Observe-only: it
    # emits `anomaly.detected` events and feeds the report's
    # Federation section, never control flow. 0 disables.
    anomaly_zscore: float = 6.0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout — replaces the reference's process topology
    (``FCGraph``, utils/topology.py:57-114) with a JAX mesh.

    ``num_devices=None`` means "all visible devices". Clients are laid out
    ``[num_devices, clients_per_device]``; the per-device axis is vmapped,
    the device axis is sharded (SURVEY.md §7 phase 1 / hard part "100+
    clients on a fixed mesh").
    """
    backend: Optional[str] = None  # None = default platform
    num_devices: Optional[int] = None
    axis_name: str = "clients"
    # Multi-host (DCN) initialization; mirrors run_mpi.py's hostfile role.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # Multi-host bring-up resilience (init_multihost retries transient
    # connect failures): total budget for reaching the coordinator, and
    # the first retry delay (doubles per attempt).
    init_timeout_s: float = 300.0
    init_backoff_s: float = 1.0
    compute_dtype: str = "float32"  # 'bfloat16' for MXU-friendly matmuls
    # Unroll factor for the local-step scan: >1 lets XLA software-
    # pipeline consecutive local steps (more instruction-level overlap,
    # bigger program). The data-dependent step order is preserved;
    # results match the rolled scan to float tolerance (re-fusion of the
    # unrolled body may shift last-ulp rounding).
    scan_unroll: int = 1
    # Per-block rematerialization (jax.checkpoint) for resnet/transformer
    # archs: trade ~1.33x FLOPs for activation memory that scales with
    # one block instead of the depth — the standard TPU HBM lever for
    # deep models / long sequences. Same values, same gradients.
    remat: bool = False
    # Client-axis execution strategy for the per-client model compute
    # inside the jitted round program (docs/performance.md
    # "Client-fused MXU execution"):
    #   'vmap'  — vmap model.apply over the k online clients (each
    #             client's 16-64-channel conv tiles the MXU separately;
    #             the certified round-5 program identity);
    #   'fused' — pack the k clients into the channel axis and run ONE
    #             feature_group_count=k grouped conv per layer (k x the
    #             MXU lanes per pass; numerics-equivalent, pinned by
    #             tests/test_client_fusion.py). Supported for the
    #             resnet-cifar family + cnn with norm='bn' on a
    #             single-device mesh and base-local-step algorithms;
    #             requesting it elsewhere raises with the reason;
    #   'auto'  — currently resolves to 'vmap': the fused lowering is
    #             built and CPU-proven but its on-chip win is still
    #             unmeasured (scripts/mfu_sweep.py fused configs are
    #             armed for the next relay window), and this repo does
    #             not flip defaults ahead of chip data — the conv_impl
    #             lesson (docs/performance.md "Conv-lowering decision").
    client_fusion: str = "auto"
    # Pod-scale client-axis sharding (docs/performance.md "Pod-scale
    # round programs"): shard the k online clients of a round over
    # `client_shards` contiguous device groups — per-shard vmap
    # execution, on-chip partial sums, exactly ONE cross-shard
    # all-reduce at the `_round_core` aggregation seam. 0 (default)
    # keeps the legacy single-shard program byte-identical; 1 arms the
    # hierarchical aggregation seam on an unsharded cohort (the
    # bitwise twin every sharded run is pinned against); S > 1 builds
    # an (S x devices/S) mesh and cuts per-host feed bytes/RAM by S.
    # Must be a power of two <= 64 that divides both the device count
    # and the cohort width; illegal compositions (fused execution,
    # robust rules, cohort stats, ...) are refused by name in
    # `round_program.validate_cell`.
    client_shards: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    lr_schedule: LRConfig = field(default_factory=LRConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    experiment: Optional[str] = None

    def finalize(self) -> "ExperimentConfig":
        """Apply the reference's post-parse derivations & validations
        (parameters.py:245-259)."""
        data, fed = self.data, self.federated
        train, optim = self.train, self.optim

        if data.growing_batch_size and data.base_batch_size is None:
            data = dataclasses.replace(data, base_batch_size=1)

        if data.augment is None:
            # reference default: augmentation ONLY for the cifar family
            # (_get_cifar, prepare_data.py:29-35; _get_stl10 passes the
            # transform through untouched)
            data = dataclasses.replace(
                data, augment=data.dataset in ("cifar10", "cifar100"))

        if fed.federated:
            if data.reshuffle_per_epoch:
                raise ValueError(
                    "Federated mode cannot reshuffle data across clients "
                    "mid-training; set reshuffle_per_epoch=False "
                    "(ref: parameters.py:246-247).")
            # num_epochs = epochs/comm * comms * online rate
            # (parameters.py:248)
            train = dataclasses.replace(
                train,
                num_epochs=int(fed.num_epochs_per_comm * fed.num_comms
                               * fed.online_client_rate))
            if fed.algorithm == "afl":
                # AFL runs exactly one local step per round
                # (parameters.py:249-251).
                fed = dataclasses.replace(fed, sync_type="local_step")
                train = dataclasses.replace(train, local_step=1)
            if fed.algorithm == "qsparse" and not fed.compressed:
                # The reference *intends* this coercion (parameters.py:252
                # has a bug: `args.compressed == True` comparison); we apply
                # the intended semantics.
                fed = dataclasses.replace(fed, compressed=True)
            if fed.quantized and fed.compressed:
                raise ValueError(
                    "Quantization is mutually exclusive with compression "
                    "(ref: parameters.py:254-255).")
            if fed.algorithm in PERSONALIZED_ALGORITHMS and not fed.personal:
                fed = dataclasses.replace(fed, personal=True)
        else:
            if train.num_epochs is None and train.num_iterations is None:
                train = dataclasses.replace(train, num_epochs=10)

        if optim.out_momentum and optim.out_momentum_factor is None:
            # Default out-momentum 1 - 1/n
            # (ref: components/optimizer.py:24-26).
            n = max(fed.num_clients, 1)
            optim = dataclasses.replace(
                optim, out_momentum_factor=1.0 - 1.0 / n)

        if data.data_plane not in ("device", "stream"):
            raise ValueError(
                f"data.data_plane must be 'device' or 'stream', got "
                f"{data.data_plane!r}")
        if data.store not in CLIENT_STORES:
            raise ValueError(
                f"data.store must be one of {CLIENT_STORES}, got "
                f"{data.store!r}")
        if data.store == "mmap":
            if data.data_plane != "stream":
                raise ValueError(
                    "data.store='mmap' is a stream-plane client store "
                    "(the device plane would upload the whole mapped "
                    "population to HBM); set data.data_plane='stream'")
            if not data.store_dir:
                raise ValueError(
                    "data.store='mmap' needs data.store_dir — the "
                    "directory holding the manifest-described shard "
                    "layout (data/streaming.py save_client_store)")
        if fed.participation_mode not in PARTICIPATION_MODES:
            raise ValueError(
                f"federated.participation_mode must be one of "
                f"{PARTICIPATION_MODES}, got {fed.participation_mode!r}")
        if fed.sync_mode not in ("sync", "async"):
            raise ValueError(
                f"federated.sync_mode must be 'sync' or 'async', got "
                f"{fed.sync_mode!r}")
        if fed.sync_mode == "async":
            if not fed.federated:
                raise ValueError(
                    "sync_mode='async' is a federated-server execution "
                    "plane; it requires federated=True")
            if fed.staleness_weight not in ("const", "poly", "inv"):
                raise ValueError(
                    "federated.staleness_weight must be 'const', 'poly' "
                    f"or 'inv', got {fed.staleness_weight!r}")
            if fed.staleness_exponent <= 0.0:
                raise ValueError(
                    "federated.staleness_exponent must be > 0, got "
                    f"{fed.staleness_exponent}")
            if fed.async_buffer_size < 0 or fed.async_concurrency < 0:
                raise ValueError(
                    "federated.async_buffer_size/async_concurrency must "
                    "be >= 0 (0 = auto)")
            if fed.snapshot_ring < 2:
                raise ValueError(
                    "federated.snapshot_ring must be >= 2 (the ring "
                    "holds at least the current and previous commit), "
                    f"got {fed.snapshot_ring}")
        if fed.algorithm not in FEDERATED_ALGORITHMS:
            raise ValueError(f"Unknown federated algorithm {fed.algorithm!r}; "
                             f"expected one of {FEDERATED_ALGORITHMS}")
        if data.dataset not in DATASETS:
            raise ValueError(f"Unknown dataset {data.dataset!r}")
        if self.mesh.scan_unroll < 1:
            raise ValueError(
                f"mesh.scan_unroll must be >= 1, got "
                f"{self.mesh.scan_unroll}")
        if self.model.conv_impl not in ("auto", "conv", "matmul"):
            raise ValueError(
                f"model.conv_impl must be 'auto', 'conv' or 'matmul', "
                f"got {self.model.conv_impl!r}")
        if self.model.attention not in ("auto", "dense", "flash"):
            raise ValueError(
                f"model.attention must be 'auto', 'dense' or 'flash', "
                f"got {self.model.attention!r}")
        if self.mesh.client_fusion not in ("auto", "vmap", "fused"):
            raise ValueError(
                f"mesh.client_fusion must be 'auto', 'vmap' or 'fused', "
                f"got {self.mesh.client_fusion!r}")
        cs = self.mesh.client_shards
        if cs < 0 or cs > 64 or (cs > 0 and cs & (cs - 1)):
            raise ValueError(
                "mesh.client_shards must be 0 (off) or a power of two "
                f"<= 64 (the deterministic aggregation group cap), got "
                f"{cs}")
        flt = self.fault
        for name in ("client_drop_rate", "straggler_rate",
                     "nan_inject_rate", "byzantine_rate"):
            v = getattr(flt, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault.{name} must be in [0, 1], got {v}")
        if flt.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(
                f"fault.byzantine_mode must be one of {BYZANTINE_MODES}, "
                f"got {flt.byzantine_mode!r}")
        if flt.byzantine_scale <= 0.0:
            raise ValueError(
                "fault.byzantine_scale must be > 0, got "
                f"{flt.byzantine_scale}")
        if flt.robust_agg not in ROBUST_AGGREGATORS:
            raise ValueError(
                f"fault.robust_agg must be one of {ROBUST_AGGREGATORS}, "
                f"got {flt.robust_agg!r}")
        if not 0.0 <= flt.robust_trim_frac < 0.5:
            raise ValueError(
                "fault.robust_trim_frac must be in [0, 0.5) (trimming "
                "half or more from each end leaves nothing), got "
                f"{flt.robust_trim_frac}")
        if flt.robust_norm_tau <= 0.0:
            raise ValueError(
                "fault.robust_norm_tau must be > 0, got "
                f"{flt.robust_norm_tau}")
        if flt.robust_agg == "norm_bound" and fed.federated \
                and self.effective_algorithm not in NORM_BOUND_ALGORITHMS:
            raise ValueError(
                "fault.robust_agg='norm_bound' carries a params-shaped "
                "server momentum; algorithm "
                f"{self.effective_algorithm!r} uses a structured payload "
                "tree the momentum cannot live against (supported: "
                f"{', '.join(NORM_BOUND_ALGORITHMS)})")
        if not 0.0 < flt.straggler_step_frac <= 1.0:
            raise ValueError(
                "fault.straggler_step_frac must be in (0, 1], got "
                f"{flt.straggler_step_frac}")
        if flt.guard_mode not in ("reject", "clip"):
            raise ValueError(
                f"fault.guard_mode must be 'reject' or 'clip', got "
                f"{flt.guard_mode!r}")
        if flt.guard_norm_multiplier <= 0.0:
            raise ValueError(
                "fault.guard_norm_multiplier must be > 0, got "
                f"{flt.guard_norm_multiplier}")
        if flt.max_retries < 0:
            raise ValueError(
                f"fault.max_retries must be >= 0, got {flt.max_retries}")
        for seam in flt.host_fault_seam_tuple:
            if seam not in HOST_FAULT_SEAMS:
                raise ValueError(
                    f"fault.host_fault_seams names unknown seam "
                    f"{seam!r}; expected a comma-separated subset of "
                    f"{HOST_FAULT_SEAMS}")
        if not 0.0 <= flt.host_fault_rate <= 1.0:
            raise ValueError(
                "fault.host_fault_rate must be in [0, 1], got "
                f"{flt.host_fault_rate}")
        if flt.host_fault_delay_s < 0.0:
            raise ValueError(
                "fault.host_fault_delay_s must be >= 0, got "
                f"{flt.host_fault_delay_s}")
        if flt.host_fault_max < 0:
            raise ValueError(
                "fault.host_fault_max must be >= 0 (0 = uncapped), got "
                f"{flt.host_fault_max}")
        if flt.host_retry_max < 0:
            raise ValueError(
                f"fault.host_retry_max must be >= 0, got "
                f"{flt.host_retry_max}")
        if flt.host_retry_backoff_s < 0.0:
            raise ValueError(
                "fault.host_retry_backoff_s must be >= 0, got "
                f"{flt.host_retry_backoff_s}")
        if flt.watchdog_timeout_s < 0.0:
            raise ValueError(
                "fault.watchdog_timeout_s must be >= 0 (0 = off), got "
                f"{flt.watchdog_timeout_s}")
        if flt.avail_model not in AVAILABILITY_MODELS:
            raise ValueError(
                f"fault.avail_model must be one of {AVAILABILITY_MODELS}, "
                f"got {flt.avail_model!r}")
        if not 0.0 <= flt.avail_dropout_rate <= 1.0:
            raise ValueError(
                "fault.avail_dropout_rate must be in [0, 1], got "
                f"{flt.avail_dropout_rate}")
        if flt.avail_diurnal_period < 0:
            raise ValueError(
                "fault.avail_diurnal_period must be >= 0 (0 = flat "
                f"fleet), got {flt.avail_diurnal_period}")
        if not 1.0 <= flt.over_select_frac <= 4.0:
            raise ValueError(
                "fault.over_select_frac must be in [1, 4] (dispatching "
                "more than 4x the target cohort pays vmap width for "
                f"nothing), got {flt.over_select_frac}")
        if not 0.0 <= flt.avail_quorum_frac <= 1.0:
            raise ValueError(
                "fault.avail_quorum_frac must be in [0, 1], got "
                f"{flt.avail_quorum_frac}")
        if flt.avail_quorum_action not in ("degrade", "abort"):
            raise ValueError(
                "fault.avail_quorum_action must be 'degrade' or "
                f"'abort', got {flt.avail_quorum_action!r}")
        if flt.avail_quorum_action == "abort" \
                and flt.avail_quorum_frac > 0.0 and not flt.supervisor:
            raise ValueError(
                "fault.avail_quorum_action='abort' routes sub-quorum "
                "rounds into the round supervisor's rollback/retry "
                "path — arm fault.supervisor (or use 'degrade', which "
                "commits the renormalized partial cohort)")
        if flt.dp_noise_multiplier < 0.0:
            raise ValueError(
                "fault.dp_noise_multiplier must be >= 0 (0 = DP off), "
                f"got {flt.dp_noise_multiplier}")
        if flt.dp_armed and flt.dp_clip_norm <= 0.0:
            raise ValueError(
                "fault.dp_clip_norm must be > 0 when DP is armed, got "
                f"{flt.dp_clip_norm}")
        if flt.dp_armed and not 0.0 < flt.dp_delta < 1.0:
            raise ValueError(
                "fault.dp_delta must be in (0, 1) when DP is armed, "
                f"got {flt.dp_delta}")
        if flt.dp_budget_action not in ("stop", "degrade"):
            raise ValueError(
                "fault.dp_budget_action must be 'stop' or 'degrade', "
                f"got {flt.dp_budget_action!r}")
        if flt.dp_epsilon_budget < 0.0:
            raise ValueError(
                "fault.dp_epsilon_budget must be >= 0 (0 = unlimited), "
                f"got {flt.dp_epsilon_budget}")
        if flt.dp_epsilon_budget > 0.0 and not flt.dp_armed:
            raise ValueError(
                "fault.dp_epsilon_budget > 0 without "
                "fault.dp_noise_multiplier > 0: there is no DP "
                "mechanism to budget — arm DP or drop the budget")
        if flt.dp_armed and flt.robust_agg == "norm_bound":
            raise ValueError(
                "fault.dp_noise_multiplier with "
                "fault.robust_agg='norm_bound' double-clips: norm_bound "
                "already radially clips every client toward the server "
                "momentum at a data-dependent radius, which breaks the "
                "fixed-sensitivity bound the DP clip certifies — use a "
                "non-clipping robust rule (trimmed_mean, median, krum) "
                "under DP")
        if flt.dp_armed and fed.federated \
                and self.effective_algorithm not in DP_ALGORITHMS:
            raise ValueError(
                "fault.dp_noise_multiplier clips and noises a single "
                "params-shaped payload tree; algorithm "
                f"{self.effective_algorithm!r} ships a structured "
                "payload the fixed-radius clip is not meaningful "
                f"against (supported: {', '.join(DP_ALGORITHMS)})")
        if fed.sync_mode == "async" and flt.straggler_rate > 0.0 \
                and flt.avail_model == "default" and not flt.avail_armed:
            warnings.warn(
                "async arrivals driven by the legacy straggler-knob "
                "aliasing (fault.straggler_rate reinterpreted as an "
                "arrival tail-delay rate). This spelling is deprecated: "
                "set fault.avail_model='trace' for the deployment-trace "
                "arrival model (docs/robustness.md 'Deployment "
                "realism'). The default model reproduces the legacy "
                "draws bitwise, so existing A/Bs and resumes stay "
                "valid.", FutureWarning, stacklevel=2)
        if self.checkpoint.keep_last_n < 0:
            raise ValueError(
                "checkpoint.keep_last_n must be >= 0 (0 = unlimited), "
                f"got {self.checkpoint.keep_last_n}")
        if self.telemetry.level not in ("off", "default", "debug"):
            raise ValueError(
                "telemetry.level must be 'off', 'default' or 'debug', "
                f"got {self.telemetry.level!r}")
        if self.telemetry.max_span_events < 1:
            raise ValueError(
                "telemetry.max_span_events must be >= 1, got "
                f"{self.telemetry.max_span_events}")
        if self.telemetry.cost_capture_scan_rounds < 0:
            raise ValueError(
                "telemetry.cost_capture_scan_rounds must be >= 0 "
                "(0 = per-round programs only), got "
                f"{self.telemetry.cost_capture_scan_rounds}")
        if self.telemetry.ledger_sketch_budget < 64:
            raise ValueError(
                "telemetry.ledger_sketch_budget must be >= 64 (the "
                "sketch needs a few rows of width to say anything), "
                f"got {self.telemetry.ledger_sketch_budget}")
        if self.telemetry.anomaly_zscore < 0.0:
            raise ValueError(
                "telemetry.anomaly_zscore must be >= 0 (0 = detector "
                f"off), got {self.telemetry.anomaly_zscore}")

        return dataclasses.replace(
            self, data=data, federated=fed, train=train, optim=optim)

    # -- Derived quantities -------------------------------------------------
    @property
    def effective_algorithm(self) -> str:
        """DRFA wraps an inner aggregation algorithm (parameters.py:90-93)."""
        return "drfa" if self.federated.drfa else self.federated.algorithm

    def batches_per_epoch(self, samples_per_client: int) -> int:
        return max(samples_per_client // self.data.batch_size, 1)

    def local_steps_per_round(self, samples_per_client: int) -> int:
        """Fixed trace-time local-step count for one communication round.

        The reference's `while not is_sync_fed` (federated/main.py:83-155)
        has data-dependent bounds; on TPU the loop is a `lax.scan` with a
        static length (SURVEY.md §7 'hard parts'). Epoch-sync mode converts
        to steps exactly like the centered code (nodes_centered.py:47-50).
        """
        if self.federated.sync_type == "epoch":
            return self.batches_per_epoch(samples_per_client) * \
                self.federated.num_epochs_per_comm
        return max(self.train.local_step, 1)
