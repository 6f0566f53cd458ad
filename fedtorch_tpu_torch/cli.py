"""Command-line entry point of the port (port of ``fedtorch_tpu/cli.py``).

The JAX package's flag surface, flag for flag (the same option strings,
defaults, types and choices, so one command line runs either package),
mapped onto the port's :class:`ExperimentConfig` by the same
``args_to_config``, and the synchronous federated driver loop: build the
data (load, partition, stack), ``define_model``, ``make_algorithm``,
``FederatedTrainer``, ``init_state`` from ``--manual_seed``, then the
rounds. Each round logs the JAX package's train line; every
``--eval_freq`` rounds the server model is evaluated on the test set
and the val line (with the best top-1 so far) and, with
``--per_class_acc``, the per-class line are logged. The result is the
JAX package's dict: ``test_top1``, ``best_top1``, ``rounds`` and the
phase ``timer``, and the ``data_plane`` the run's telemetry records in
the JAX package. ``--data_plane stream`` keeps the population on the
host (``--data_store ram``) or reads it from a store written by
``data/streaming.py``'s ``save_client_store`` (``--data_store mmap
--data_store_dir DIR``) and streams each round's rows to the device;
``--participation_mode sparse`` draws the cohort in O(k) memory.

It runs on CUDA unless ``--backend cpu`` asks for the CPU; without a
card and without that flag it raises. A flag that names a feature the
port has not ported is refused by name when set to anything but its
default (:data:`UNPORTED_FLAGS`), as are the JAX package's subcommands
and ``--download``. Every ``--federated_type`` runs (fedavg, fedprox,
fedadam, scaffold, fedgate, qsparse, qffl, afl, apfl, perfedme,
perfedavg), with the top-k (``--compressed``) or quantized wire format
and ``--federated_drfa`` over fedavg, fedgate or scaffold. The
personalized algorithms (and ``--fed_personal true``) split each
client's rows into train and val (``--val_fraction`` of the JAX
package's config), and after each evaluation the three algorithms log a
``validation_personal`` line: ``evaluate_personal``'s mean loss and
accuracy over the clients' val rows. ``--federated false`` runs
local-SGD mode (``parallel/local_sgd.py``): the training set pooled and
re-partitioned IID over ``--num_workers``, ``LocalSGDTrainer.fit`` to
the epoch or iteration count, one test evaluation at the end, and the
JAX package's ``{"test_top1", "rounds"}``. Every dataset of the JAX
package is read from ``--data_dir`` (EMNIST and Shakespeare from their
TFF HDF5 files with ``--allow_train_as_test``, adult with
``--sensitive_feature``), and every architecture of the JAX package
runs: ``-a densenet*`` (``--densenet_bc_mode``, ``--densenet_growth_rate``,
``--densenet_compression``), ``--norm gn``, ``--drop_rate``, ``--conv_impl
matmul`` and the ``robust_*`` models beside ``resnet*``, ``wideresnet*``,
``cnn``, ``rnn``, the transformer and the flat models;
``--client_fusion fused`` trains the online clients of the resnet-cifar
family and the ``cnn`` as one grouped-convolution step
(``parallel/fusion.py``), and ``--remat`` recomputes each block in the
backward. The update guards
(``--guard_updates``, ``--guard_norm_multiplier``, ``--guard_mode``),
the robust rules (``--robust_agg``, ``--robust_trim_frac``,
``--robust_norm_tau``), chaos injection (``--fault_client_drop_rate``,
``--fault_straggler_rate``, ``--fault_straggler_step_frac``,
``--fault_nan_inject_rate``, ``--fault_byzantine_rate``,
``--fault_byzantine_mode``, ``--fault_byzantine_scale``), the
availability lifecycle (``--avail_model``, ``--avail_dropout_rate``,
``--avail_diurnal_period``, ``--over_select_frac``,
``--avail_quorum_frac``, ``--avail_quorum_action``, whose ``abort``
needs ``--supervisor``) and DP-FedAvg (``--dp_noise_multiplier``,
``--dp_clip_norm``, ``--dp_delta``) run in the round. A round with a
fault logs the JAX CLI's ``faults`` line, and a round that aggregated
nothing its all-rejected line. With DP armed an in-memory RDP
accountant charges each round at ``q = min(1, k_online / C)``, and
``--dp_epsilon_budget`` with ``--dp_budget_action`` stops the run at
the last affordable round or degrades it to noise-free rounds;
``results["dp"]`` reports the spend.

The run lifecycle is the JAX package's (its ``cli.py:700-1000,
1180-1200``). The run directory (``--run_dir`` exactly, else a
hyperparam-encoding directory under ``-c``) holds the log (``record0``),
``metrics.jsonl`` (one schema-versioned row a round, from the round's
one batched fetch: telemetry adds no device-to-host sync),
``events.jsonl``, ``health.json``, ``trace.json`` (``--telemetry
off|default|debug``), the accountant's ``privacy_accountant.json`` (DP
armed, saved before each checkpoint) and, at every evaluation, a
checkpoint (``checkpoint.ckpt`` + ``checkpoint.json``, ``model_best.*``,
per-round keeps with ``--save_all_models`` / ``--save_some_models`` and
``--checkpoint_keep_last_n``; ``--async_checkpoint`` writes them on a
thread). ``--resume DIR`` (``--checkpoint_index N``) continues a run
bitwise. ``--supervisor`` rolls a diverged round back and retries it;
``--host_fault_*`` arm the seeded host-plane chaos and ``--host_retry_*``
its recovery; ``--watchdog_timeout_s`` exits 75 when no round completes;
``--check_model_at_sync`` and ``--track_model_aggregation`` log the
server model's norms and the aggregation's cosine. SIGTERM, SIGINT or
SIGUSR1 drain the run at the next round boundary: a final checkpoint,
``results["preempted"]``, and :func:`main` exits with 75, which the
``supervise`` subcommand (``robustness/harness.py``) relaunches with
``--resume``. The federation plane's observers run as the JAX CLI's:
with ``--cohort_stats true`` each round's cohort vectors ride the
round's one fetch into ``client_ledger.json`` (``--ledger_sketch_budget``)
and the rows carry the dispersion and the norm quantiles; with telemetry
on, the EWMA anomaly detector (``--anomaly_zscore``, 0 turns it off)
watches every row and the stream plane's rows carry
``overlap_efficiency``. ``--sync_mode async`` runs the FedBuff commit
loop (``async_plane/``: ``--async_concurrency``, ``--async_buffer_size``,
``--snapshot_ring``, ``--staleness_weight``, ``--staleness_exponent``):
each loop iteration is one commit, and the rows carry the async gauges
and the events the staleness histogram. With telemetry on, the writing
process counts the round's FLOPs once after its first round
(``telemetry/costs.py``) into ``program_costs.json`` (``rounds_scan[R]``
too with ``--cost_capture_scan_rounds R``; a resumed run adopts it) and
every row after carries ``model_flops_utilization``,
``round_device_min_s``, ``round_host_frac`` and, on a card,
``hbm_program_peak_bytes`` and ``hbm_live_bytes``; a failed count is
logged and turns them off. ``lint`` and ``audit`` run the port's static
analysis (``fedtorch_tpu_torch/lint``).

Usage:
    python -m fedtorch_tpu_torch.cli --backend cpu -f true -d synthetic \
        -a mlp --num_workers 10 --num_comms 5 --federated_type fedavg
    python -m fedtorch_tpu_torch.cli --backend cpu -f true -d synthetic \
        -a mlp --num_workers 10 --num_comms 5 --federated_type fedgate \
        --federated_drfa true
    python -m fedtorch_tpu_torch.cli --backend cpu -f true -d synthetic \
        -a mlp --num_workers 10 --num_comms 5 --federated_type apfl \
        --fed_adaptive_alpha true
    python -m fedtorch_tpu_torch.cli --backend cpu -f false -d synthetic \
        -a mlp --num_workers 4 --num_epochs 2 --local_step 4
    python -m fedtorch_tpu_torch.cli -f true -d cifar10 -p DATA -a resnet20 \
        --num_workers 100 --online_client_rate 0.1 --data_plane stream \
        --data_store mmap --data_store_dir STORE
    python -m fedtorch_tpu_torch.cli -f true -d cifar10 -p DATA \
        -a densenet100 --densenet_bc_mode true --densenet_growth_rate 12 \
        --densenet_compression 0.5 --num_workers 100 \
        --online_client_rate 0.1 --quantized true --robust_agg median \
        --guard_updates true
"""
from __future__ import annotations

import argparse
import time

import torch

from fedtorch_tpu_torch.config import (
    CLIENT_STORES, PARTICIPATION_MODES, PERSONALIZED_ALGORITHMS,
    CheckpointConfig, DataConfig, ExperimentConfig, FaultConfig,
    FederatedConfig, LRConfig, MeshConfig, ModelConfig, OptimConfig,
    TelemetryConfig, TrainConfig,
)
from fedtorch_tpu_torch.robustness.preemption import RESTART_EXIT_CODE

# the JAX package's subcommands that the port does not run: they read run
# directories as separate programs, and the JAX package's read the port's
# (``python -m fedtorch_tpu.cli report DIR``). ``supervise``
# (robustness/harness.py), ``lint`` and ``audit`` (fedtorch_tpu_torch/lint)
# run
SUBCOMMANDS = ("report", "watch", "compare", "runs")


def str2bool(v) -> bool:
    """parameters.py:263-280."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fedtorch_tpu_torch: federated learning on an NVIDIA "
                    "GPU (the PyTorch port of fedtorch_tpu)")
    # dataset (parameters.py:23-37)
    p.add_argument("-d", "--data", default="cifar10")
    p.add_argument("-p", "--data_dir", default="./data/")
    p.add_argument("--download", type=str2bool, default=False)
    p.add_argument("--partition_data", type=str2bool, default=True)
    p.add_argument("--augment", type=str2bool, default=None)
    p.add_argument("--synthetic_alpha", type=float, default=0.0)
    p.add_argument("--synthetic_beta", type=float, default=0.0)
    p.add_argument("--sensitive_feature", type=int, default=9)
    # federated (parameters.py:40-110)
    p.add_argument("-f", "--federated", type=str2bool, default=False)
    p.add_argument("--num_class_per_client", type=int, default=1)
    p.add_argument("--num_comms", type=int, default=100)
    p.add_argument("--online_client_rate", type=float, default=0.1)
    p.add_argument("--federated_sync_type", default="epoch",
                   choices=["epoch", "local_step"])
    p.add_argument("--num_epochs_per_comm", type=int, default=1)
    p.add_argument("--iid_data", type=str2bool, default=True)
    p.add_argument("--federated_type", default="fedavg")
    p.add_argument("--unbalanced", type=str2bool, default=False)
    p.add_argument("--dirichlet", type=str2bool, default=False)
    p.add_argument("--fed_personal", type=str2bool, default=False)
    p.add_argument("--fed_personal_alpha", type=float, default=0.5)
    p.add_argument("--fed_adaptive_alpha", type=str2bool, default=False)
    p.add_argument("--fed_personal_test", type=str2bool, default=False)
    p.add_argument("--fedadam_beta", type=float, default=0.9)
    p.add_argument("--fedadam_tau", type=float, default=0.1)
    p.add_argument("--quantized", type=str2bool, default=False)
    p.add_argument("--quantized_bits", type=int, default=8)
    p.add_argument("--compressed", type=str2bool, default=False)
    p.add_argument("--compressed_ratio", type=float, default=1.0)
    p.add_argument("--sync_mode", default="sync", choices=("sync", "async"))
    p.add_argument("--async_buffer_size", type=int, default=0)
    p.add_argument("--async_concurrency", type=int, default=0)
    p.add_argument("--staleness_weight", default="poly",
                   choices=("const", "poly", "inv"))
    p.add_argument("--staleness_exponent", type=float, default=0.5)
    p.add_argument("--snapshot_ring", type=int, default=8)
    p.add_argument("--federated_drfa", type=str2bool, default=False)
    p.add_argument("--drfa_gamma", type=float, default=0.1)
    p.add_argument("--perfedavg_beta", type=float, default=0.001)
    p.add_argument("--fedprox_mu", type=float, default=0.002)
    p.add_argument("--perfedme_lambda", type=float, default=15.0)
    p.add_argument("--qffl_q", type=float, default=0.0)
    # model (parameters.py:113-115, 180-194)
    p.add_argument("-a", "--arch", default="mlp")
    p.add_argument("--norm", default="bn", choices=["bn", "gn"])
    p.add_argument("--drop_rate", type=float, default=0.0)
    p.add_argument("--densenet_growth_rate", type=int, default=12)
    p.add_argument("--densenet_bc_mode", type=str2bool, default=False)
    p.add_argument("--densenet_compression", type=float, default=0.5)
    p.add_argument("--wideresnet_widen_factor", type=int, default=4)
    p.add_argument("--mlp_num_layers", type=int, default=2)
    p.add_argument("--mlp_hidden_size", type=int, default=500)
    p.add_argument("--rnn_seq_len", type=int, default=50)
    p.add_argument("--rnn_hidden_size", type=int, default=50)
    p.add_argument("--vocab_size", type=int, default=86)
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--moe_capacity_factor", type=float, default=0.0)
    p.add_argument("--moe_aux_weight", type=float, default=0.0)
    p.add_argument("--attention", default="auto",
                   choices=("auto", "dense", "flash"))
    p.add_argument("--conv_impl", default="auto",
                   choices=("auto", "conv", "matmul"))
    # training scheme (parameters.py:118-141)
    p.add_argument("--stop_criteria", default="epoch")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--num_iterations", type=int, default=None)
    p.add_argument("--local_step", type=int, default=1)
    p.add_argument("--local_step_warmup_type", default=None)
    p.add_argument("--local_step_warmup_period", type=int, default=None)
    p.add_argument("--local_step_warmup_per_interval", type=str2bool,
                   default=False)
    p.add_argument("--turn_on_local_step_from", type=int, default=None)
    p.add_argument("--turn_off_local_step_from", type=int, default=None)
    p.add_argument("--avg_model", type=str2bool, default=True)
    p.add_argument("--reshuffle_per_epoch", type=str2bool, default=False)
    p.add_argument("-b", "--batch_size", type=int, default=50)
    p.add_argument("--data_plane", default="device",
                   choices=("device", "stream"))
    p.add_argument("--data_store", default="ram", choices=CLIENT_STORES)
    p.add_argument("--data_store_dir", default="")
    p.add_argument("--participation_mode", default="perm",
                   choices=PARTICIPATION_MODES)
    p.add_argument("--growing_batch_size", type=str2bool, default=False)
    p.add_argument("--base_batch_size", type=int, default=None)
    p.add_argument("--max_batch_size", type=int, default=0)
    # learning rate (parameters.py:144-166)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_schedule_scheme", default=None)
    p.add_argument("--lr_change_epochs", default=None)
    p.add_argument("--lr_fields", default=None)
    p.add_argument("--lr_scale_indicators", default=None)
    p.add_argument("--lr_scaleup", type=str2bool, default=False)
    p.add_argument("--lr_scaleup_type", default="linear")
    p.add_argument("--lr_scale_at_sync", type=float, default=1.0)
    p.add_argument("--lr_warmup", type=str2bool, default=False)
    p.add_argument("--lr_warmup_epochs", type=int, default=5)
    p.add_argument("--lr_decay", type=float, default=10.0)
    p.add_argument("--lr_onecycle_low", type=float, default=0.15)
    p.add_argument("--lr_onecycle_high", type=float, default=3.0)
    p.add_argument("--lr_onecycle_extra_low", type=float, default=0.0015)
    p.add_argument("--lr_onecycle_num_epoch", type=int, default=46)
    p.add_argument("--lr_gamma", type=float, default=None)
    p.add_argument("--lr_mu", type=float, default=None)
    p.add_argument("--lr_alpha", type=float, default=None)
    # optimizer (parameters.py:168-183)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--in_momentum", type=str2bool, default=False)
    p.add_argument("--in_momentum_factor", type=float, default=0.9)
    p.add_argument("--out_momentum", type=str2bool, default=False)
    p.add_argument("--out_momentum_factor", type=float, default=None)
    p.add_argument("--use_nesterov", type=str2bool, default=False)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--correct_wd", type=str2bool, default=False)
    p.add_argument("--wd_skip_norm_bias", type=str2bool, default=False)
    # misc / checkpoint (parameters.py:196-222)
    p.add_argument("--manual_seed", type=int, default=6)
    p.add_argument("--per_class_acc", type=str2bool, default=False)
    p.add_argument("--evaluate", "-e", type=str2bool, default=False)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=10)
    p.add_argument("--debug", type=str2bool, default=True)
    p.add_argument("--resume", default=None)
    p.add_argument("--checkpoint_index", default=None)
    p.add_argument("-c", "--checkpoint", default="./checkpoint/")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--save_all_models", type=str2bool, default=False)
    p.add_argument("--save_some_models", default="1,29,59")
    p.add_argument("--checkpoint_keep_last_n", type=int, default=0)
    p.add_argument("--async_checkpoint", action="store_true")
    p.add_argument("--check_model_at_sync", type=str2bool, default=False)
    p.add_argument("--track_model_aggregation", type=str2bool, default=False)
    p.add_argument("--log_dir", default="./logdir/")
    p.add_argument("--experiment", default=None)
    # robustness: chaos injection / update guards / round supervisor
    # (docs/robustness.md; no reference analog — it is fail-stop)
    p.add_argument("--fault_client_drop_rate", type=float, default=0.0)
    p.add_argument("--fault_straggler_rate", type=float, default=0.0)
    p.add_argument("--fault_straggler_step_frac", type=float, default=0.5)
    p.add_argument("--fault_nan_inject_rate", type=float, default=0.0)
    p.add_argument("--fault_byzantine_rate", type=float, default=0.0)
    p.add_argument("--fault_byzantine_mode", default="sign_flip",
                   choices=("sign_flip", "scale", "zero", "gauss",
                            "collude"))
    p.add_argument("--fault_byzantine_scale", type=float, default=1.0)
    p.add_argument("--robust_agg", default="mean",
                   choices=("mean", "median", "trimmed_mean", "krum",
                            "multikrum", "norm_bound"))
    p.add_argument("--robust_trim_frac", type=float, default=0.1)
    p.add_argument("--robust_norm_tau", type=float, default=1.5)
    p.add_argument("--guard_updates", type=str2bool, default=False)
    p.add_argument("--guard_norm_multiplier", type=float, default=10.0)
    p.add_argument("--guard_mode", default="reject",
                   choices=("reject", "clip"))
    p.add_argument("--supervisor", type=str2bool, default=False)
    p.add_argument("--supervisor_loss_blowup", type=float, default=0.0)
    p.add_argument("--supervisor_max_retries", type=int, default=2)
    p.add_argument("--supervisor_backoff_base", type=float, default=0.5)
    p.add_argument("--host_fault_seams", default="")
    p.add_argument("--host_fault_rate", type=float, default=0.25)
    p.add_argument("--host_fault_seed", type=int, default=0)
    p.add_argument("--host_fault_delay_s", type=float, default=0.02)
    p.add_argument("--host_fault_max", type=int, default=0)
    p.add_argument("--host_retry_max", type=int, default=3)
    p.add_argument("--host_retry_backoff_s", type=float, default=0.05)
    p.add_argument("--watchdog_timeout_s", type=float, default=0.0)
    # deployment-realism availability plane + round lifecycle
    # (robustness/availability.py; docs/robustness.md "Deployment
    # realism")
    p.add_argument("--avail_model", default="default",
                   choices=("default", "trace"))
    p.add_argument("--avail_dropout_rate", type=float, default=0.0)
    p.add_argument("--avail_diurnal_period", type=int, default=0)
    p.add_argument("--over_select_frac", type=float, default=1.0)
    p.add_argument("--avail_quorum_frac", type=float, default=0.0)
    p.add_argument("--avail_quorum_action", default="degrade",
                   choices=("degrade", "abort"))
    p.add_argument("--dp_noise_multiplier", type=float, default=0.0)
    p.add_argument("--dp_clip_norm", type=float, default=1.0)
    p.add_argument("--dp_epsilon_budget", type=float, default=0.0)
    p.add_argument("--dp_delta", type=float, default=1e-5)
    p.add_argument("--dp_budget_action", default="stop",
                   choices=("stop", "degrade"))
    # device / mesh (replaces parameters.py:225-236 MPI block)
    p.add_argument("--backend", default=None)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--num_workers", "-j", "--world_size", type=int, default=10,
                   dest="num_workers")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--scan_unroll", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--client_fusion", default="auto",
                   choices=("auto", "vmap", "fused"))
    p.add_argument("--client_shards", type=int, default=0)
    p.add_argument("--allow_train_as_test", type=str2bool, default=False)
    # observability (docs/observability.md)
    p.add_argument("--telemetry", default="default",
                   choices=("off", "default", "debug"))
    p.add_argument("--cost_capture_scan_rounds", type=int, default=0)
    p.add_argument("--cohort_stats", type=str2bool, default=False)
    p.add_argument("--ledger_sketch_budget", type=int, default=65536)
    p.add_argument("--anomaly_zscore", type=float, default=6.0)

    return p


def args_to_config(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        data=DataConfig(
            dataset=args.data, data_dir=args.data_dir,
            partition_data=args.partition_data, iid=args.iid_data,
            num_class_per_client=args.num_class_per_client,
            unbalanced=args.unbalanced, dirichlet=args.dirichlet,
            synthetic_alpha=args.synthetic_alpha,
            synthetic_beta=args.synthetic_beta,
            sensitive_feature=args.sensitive_feature,
            data_plane=args.data_plane,
            store=args.data_store,
            store_dir=args.data_store_dir,
            batch_size=args.batch_size,
            growing_batch_size=args.growing_batch_size,
            base_batch_size=args.base_batch_size,
            max_batch_size=args.max_batch_size,
            reshuffle_per_epoch=args.reshuffle_per_epoch,
            augment=args.augment,
            allow_train_as_test=args.allow_train_as_test),
        federated=FederatedConfig(
            federated=args.federated, num_clients=args.num_workers,
            num_comms=args.num_comms,
            online_client_rate=args.online_client_rate,
            sync_type=args.federated_sync_type,
            num_epochs_per_comm=args.num_epochs_per_comm,
            sync_mode=args.sync_mode,
            participation_mode=args.participation_mode,
            async_buffer_size=args.async_buffer_size,
            async_concurrency=args.async_concurrency,
            staleness_weight=args.staleness_weight,
            staleness_exponent=args.staleness_exponent,
            snapshot_ring=args.snapshot_ring,
            algorithm=args.federated_type, personal=args.fed_personal,
            personal_alpha=args.fed_personal_alpha,
            adaptive_alpha=args.fed_adaptive_alpha,
            personal_test=args.fed_personal_test,
            fedadam_beta=args.fedadam_beta, fedadam_tau=args.fedadam_tau,
            quantized=args.quantized, quantized_bits=args.quantized_bits,
            compressed=args.compressed,
            compressed_ratio=args.compressed_ratio,
            drfa=args.federated_drfa, drfa_gamma=args.drfa_gamma,
            perfedavg_beta=args.perfedavg_beta,
            fedprox_mu=args.fedprox_mu,
            perfedme_lambda=args.perfedme_lambda, qffl_q=args.qffl_q),
        model=ModelConfig(
            arch=args.arch, norm=args.norm, drop_rate=args.drop_rate,
            densenet_growth_rate=args.densenet_growth_rate,
            densenet_bc_mode=args.densenet_bc_mode,
            densenet_compression=args.densenet_compression,
            wideresnet_widen_factor=args.wideresnet_widen_factor,
            mlp_num_layers=args.mlp_num_layers,
            mlp_hidden_size=args.mlp_hidden_size,
            rnn_seq_len=args.rnn_seq_len,
            rnn_hidden_size=args.rnn_hidden_size,
            vocab_size=args.vocab_size,
            moe_experts=args.moe_experts,
            moe_capacity_factor=args.moe_capacity_factor,
            moe_aux_weight=args.moe_aux_weight,
            attention=args.attention,
            conv_impl=args.conv_impl),
        optim=OptimConfig(
            optimizer=args.optimizer, lr=args.lr,
            in_momentum=args.in_momentum,
            in_momentum_factor=args.in_momentum_factor,
            out_momentum=args.out_momentum,
            out_momentum_factor=args.out_momentum_factor,
            use_nesterov=args.use_nesterov,
            weight_decay=args.weight_decay, correct_wd=args.correct_wd,
            wd_skip_norm_bias=args.wd_skip_norm_bias,
            lr_scale_at_sync=args.lr_scale_at_sync),
        lr_schedule=LRConfig(
            schedule_scheme=args.lr_schedule_scheme,
            lr_change_epochs=args.lr_change_epochs,
            lr_fields=args.lr_fields,
            lr_scale_indicators=args.lr_scale_indicators,
            scaleup=args.lr_scaleup, scaleup_type=args.lr_scaleup_type,
            warmup=args.lr_warmup, warmup_epochs=args.lr_warmup_epochs,
            decay=args.lr_decay, onecycle_low=args.lr_onecycle_low,
            onecycle_high=args.lr_onecycle_high,
            onecycle_extra_low=args.lr_onecycle_extra_low,
            onecycle_num_epoch=args.lr_onecycle_num_epoch,
            gamma=args.lr_gamma, mu=args.lr_mu, alpha=args.lr_alpha),
        train=TrainConfig(
            stop_criteria=args.stop_criteria, num_epochs=args.num_epochs,
            num_iterations=args.num_iterations,
            local_step=args.local_step,
            local_step_warmup_type=args.local_step_warmup_type,
            local_step_warmup_period=args.local_step_warmup_period,
            local_step_warmup_per_interval=(
                args.local_step_warmup_per_interval),
            turn_on_local_step_from=args.turn_on_local_step_from,
            turn_off_local_step_from=args.turn_off_local_step_from,
            avg_model=args.avg_model, manual_seed=args.manual_seed,
            evaluate=args.evaluate, eval_freq=args.eval_freq,
            summary_freq=args.summary_freq,
            per_class_acc=args.per_class_acc),
        checkpoint=CheckpointConfig(
            checkpoint_dir=args.checkpoint, run_dir=args.run_dir,
            resume=args.resume,
            checkpoint_index=args.checkpoint_index,
            save_all_models=args.save_all_models,
            save_some_models=args.save_some_models,
            keep_last_n=args.checkpoint_keep_last_n,
            async_save=args.async_checkpoint,
            log_dir=args.log_dir, debug=args.debug,
            check_model_at_sync=args.check_model_at_sync,
            track_model_aggregation=args.track_model_aggregation),
        mesh=MeshConfig(
            backend=args.backend, num_devices=args.num_devices,
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes, process_id=args.process_id,
            compute_dtype=args.compute_dtype,
            scan_unroll=args.scan_unroll, remat=args.remat,
            client_fusion=args.client_fusion,
            client_shards=args.client_shards),
        telemetry=TelemetryConfig(
            level=args.telemetry,
            cost_capture_scan_rounds=args.cost_capture_scan_rounds,
            cohort_stats=args.cohort_stats,
            ledger_sketch_budget=args.ledger_sketch_budget,
            anomaly_zscore=args.anomaly_zscore),
        fault=FaultConfig(
            client_drop_rate=args.fault_client_drop_rate,
            straggler_rate=args.fault_straggler_rate,
            straggler_step_frac=args.fault_straggler_step_frac,
            nan_inject_rate=args.fault_nan_inject_rate,
            byzantine_rate=args.fault_byzantine_rate,
            byzantine_mode=args.fault_byzantine_mode,
            byzantine_scale=args.fault_byzantine_scale,
            robust_agg=args.robust_agg,
            robust_trim_frac=args.robust_trim_frac,
            robust_norm_tau=args.robust_norm_tau,
            guard_updates=args.guard_updates,
            guard_norm_multiplier=args.guard_norm_multiplier,
            guard_mode=args.guard_mode,
            supervisor=args.supervisor,
            loss_blowup_factor=args.supervisor_loss_blowup,
            max_retries=args.supervisor_max_retries,
            backoff_base_s=args.supervisor_backoff_base,
            host_fault_seams=args.host_fault_seams,
            host_fault_rate=args.host_fault_rate,
            host_fault_seed=args.host_fault_seed,
            host_fault_delay_s=args.host_fault_delay_s,
            host_fault_max=args.host_fault_max,
            host_retry_max=args.host_retry_max,
            host_retry_backoff_s=args.host_retry_backoff_s,
            watchdog_timeout_s=args.watchdog_timeout_s,
            avail_model=args.avail_model,
            avail_dropout_rate=args.avail_dropout_rate,
            avail_diurnal_period=args.avail_diurnal_period,
            over_select_frac=args.over_select_frac,
            avail_quorum_frac=args.avail_quorum_frac,
            avail_quorum_action=args.avail_quorum_action,
            dp_noise_multiplier=args.dp_noise_multiplier,
            dp_clip_norm=args.dp_clip_norm,
            dp_epsilon_budget=args.dp_epsilon_budget,
            dp_delta=args.dp_delta,
            dp_budget_action=args.dp_budget_action),
        experiment=args.experiment,
    )
    return cfg.finalize()


# Flags whose feature the port has not ported, refused when the config
# holds anything but the default: flag -> (config section, field, what
# it names)
UNPORTED_FLAGS = {}


def _unported(section: str, what: str, fields: dict) -> None:
    for flag, field in fields.items():
        UNPORTED_FLAGS[flag] = (section, field, what)


_unported("mesh", "XLA's scan unrolling, which has no eager-torch "
          "counterpart", {"scan_unroll": "scan_unroll"})


def refused_flags(cfg: ExperimentConfig) -> list:
    """``--flag value: what is not yet ported`` for every flag of ``cfg``
    the port cannot honour."""
    default = ExperimentConfig()
    out = []
    for flag, (section, field, what) in UNPORTED_FLAGS.items():
        value = getattr(getattr(cfg, section), field)
        if value != getattr(getattr(default, section), field):
            out.append(f"--{flag} {value!r}: {what}")
    from fedtorch_tpu_torch.robustness.host_chaos import UNPORTED_SEAMS
    for seam in cfg.fault.host_fault_seam_tuple:
        if seam in UNPORTED_SEAMS:
            out.append(f"--host_fault_seams {seam!r}: "
                       f"{UNPORTED_SEAMS[seam]}")
    if cfg.mesh.backend not in (None, "cpu", "cuda", "gpu"):
        out.append(f"--backend {cfg.mesh.backend!r}: the port runs on "
                   "CUDA or, asked with --backend cpu, on the CPU")
    return out


def _launch_counts() -> dict:
    """The hand kernels' launch counters (host ints the wrappers keep)."""
    from fedtorch_tpu_torch.ops.cuda import flash_attention as fa
    from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk
    return dict(ragged_stats=qk.ragged_stats_launches,
                ragged_apply=qk.ragged_apply_launches,
                tiled_stats=qk.stats_launches,
                tiled_apply=qk.apply_launches,
                flash_tc=fa.flash_tc_launches,
                flash_tf32=fa.flash_tf32_launches)


def _staleness_event(tel, trainer, **fields) -> None:
    """The async plane's staleness histogram as an event (nothing on the
    sync planes)."""
    hist = trainer.staleness_histogram()
    if hist:
        tel.event("async.staleness_hist",
                  hist={str(k): v for k, v in sorted(hist.items())},
                  **fields)


def run_experiment(cfg: ExperimentConfig, download: bool = False,
                   round_callback=None) -> dict:
    """:func:`_run_experiment` inside the run's process group: with
    ``--coordinator_address`` each process joins it first
    (``parallel/mesh.py`` :func:`init_multihost`, before the data are
    built) and leaves it at the end. Every rank runs the same loop and
    logs the same metric lines (``record<rank>``); only rank 0 writes
    checkpoints and telemetry files, and every rank resumes from them."""
    from fedtorch_tpu_torch.parallel.mesh import init_multihost
    refused = refused_flags(cfg)
    if refused:
        raise ValueError("not yet ported: " + "; ".join(refused))
    started = init_multihost(cfg.mesh) is not None
    try:
        return _run_experiment(cfg, download, round_callback)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run_experiment(cfg: ExperimentConfig, download: bool = False,
                    round_callback=None) -> dict:
    """The synchronous federated driver loop (federated/main.py:56-211;
    the JAX package's ``run_experiment``), or local-SGD mode without
    ``--federated``. ``round_callback(r, trainer, server, clients,
    metrics)`` (optional) fires after every completed federated round.

    Process lifecycle: SIGTERM/SIGINT/SIGUSR1 request a drain — the loop
    finishes the round in flight (its CUDA work synchronized), writes a
    final checkpoint after any in-flight async write, and the result
    carries ``preempted=True`` (:func:`main` turns that into exit code
    75). ``fault.watchdog_timeout_s > 0`` arms a stall watchdog that
    exits 75 from its own thread when no round completes in time."""
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.models.common import num_classes_of
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    from fedtorch_tpu_torch.parallel.evaluate import (
        evaluate, evaluate_per_class, evaluate_personal,
    )
    from fedtorch_tpu_torch.parallel.local_sgd import build_local_sgd
    from fedtorch_tpu_torch.parallel.mesh import rank
    from fedtorch_tpu_torch.robustness import host_chaos, host_recovery
    from fedtorch_tpu_torch.robustness.guards import all_rejected_scalars
    from fedtorch_tpu_torch.robustness.preemption import PreemptionHandler
    from fedtorch_tpu_torch.robustness.privacy import (
        ACCOUNTANT_FILE, PrivacyAccountant,
    )
    from fedtorch_tpu_torch.robustness.supervisor import RoundSupervisor
    from fedtorch_tpu_torch.robustness.watchdog import StallWatchdog
    from fedtorch_tpu_torch.telemetry import Telemetry
    from fedtorch_tpu_torch.telemetry.anomaly import EwmaAnomalyDetector
    from fedtorch_tpu_torch.telemetry.critical_path import (
        StreamOverlapTracker,
    )
    from fedtorch_tpu_torch.telemetry.ledger import ClientLedger
    from fedtorch_tpu_torch.utils import resolve_device
    from fedtorch_tpu_torch.utils.checkpoint import (
        AsyncCheckpointer, init_checkpoint_dir, maybe_resume,
        save_checkpoint,
    )
    from fedtorch_tpu_torch.utils.diagnostics import (
        aggregation_tracking, model_norms,
    )
    from fedtorch_tpu_torch.utils.logging import RunLogger
    from fedtorch_tpu_torch.utils.meters import PhaseTimer

    if download:
        raise ValueError(
            "not yet ported: --download True: fetching a dataset (no "
            "machine the port runs on has a network to test it)")
    # the CPU only when --backend cpu asks; else CUDA, which raises
    # without a card
    device = resolve_device("cpu" if cfg.mesh.backend == "cpu" else None)
    run_dir = init_checkpoint_dir(cfg)
    logger = RunLogger(run_dir, debug=cfg.checkpoint.debug, rank=rank())
    logger.log_args(cfg)
    logger.log(f"device: {device}"
               + (f" ({torch.cuda.get_device_name(device)})"
                  if device.type == "cuda" else ""))
    timer = PhaseTimer()
    flt = cfg.fault

    # run telemetry: metrics/events/health/trace in the run dir, every
    # value a host counter or from the round's one batched fetch
    tel = Telemetry(
        run_dir, level=cfg.telemetry.level, process_index=rank(),
        run_meta={"algorithm": cfg.effective_algorithm,
                  "dataset": cfg.data.dataset, "arch": cfg.model.arch,
                  "sync_mode": cfg.federated.sync_mode,
                  "data_plane": cfg.data.data_plane,
                  "num_clients": cfg.federated.num_clients,
                  "num_comms": cfg.federated.num_comms,
                  "experiment": cfg.experiment},
        max_span_events=cfg.telemetry.max_span_events)
    tel.install()
    tel.health_update("starting")
    # host-plane recovery is always installed (real host faults retry
    # and count); the seeded injector only when seams are armed
    recovery = host_recovery.HostRecovery(
        policy=host_recovery.RetryPolicy(
            max_retries=flt.host_retry_max,
            backoff_base_s=flt.host_retry_backoff_s)).install()
    injector = host_chaos.HostFaultInjector.from_config(flt)
    if injector is not None:
        injector.install()
        logger.log("host chaos armed: seams="
                   f"{','.join(sorted(injector.seams))} "
                   f"rate={injector.rate} seed={injector.seed}")

    def _uninstall_host_plane():
        if injector is not None:
            injector.uninstall()
        recovery.uninstall()

    launches_at_start = _launch_counts()
    try:
        timer.start("data")
        with tel.span("data.build"):
            fed_data = build_federated_data(cfg)
            model = define_model(cfg, batch_size=cfg.data.batch_size,
                                 device=device)
        timer.stop("data")

        if not cfg.federated.federated:
            # local-SGD mode: the workers' shards pooled back into one
            # training set (padding rows included, as the JAX package
            # pools them) and re-partitioned IID across the workers; a
            # sequence model's [T] label rows stay rows
            try:
                x, y = (t.numpy() for t in fed_data.train[:2])
                trainer = build_local_sgd(cfg, model,
                                          x.reshape((-1,) + x.shape[2:]),
                                          y.reshape((-1,) + y.shape[2:]),
                                          device=device)
                server, _, history = trainer.fit(cfg.train.manual_seed)
                loss, top1, top5 = (float(v) for v in evaluate(
                    model, server.params, fed_data.test_x,
                    fed_data.test_y))
                logger.log_val(len(history), "test", loss, top1, top5)
                tel.health_update("complete", round_idx=len(history))
            finally:
                _uninstall_host_plane()
                tel.close()
            return {"test_top1": top1, "rounds": len(history)}

        personal = cfg.federated.personal and fed_data.val is not None \
            and cfg.effective_algorithm in PERSONALIZED_ALGORITHMS
        if cfg.federated.sync_mode == "async":
            # the commit plane: run_round is one commit and server.round
            # counts commit versions, so the loop runs unchanged
            from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
            trainer_cls = AsyncFederatedTrainer
        else:
            trainer_cls = FederatedTrainer
        trainer = trainer_cls(cfg, model, make_algorithm(cfg),
                              fed_data.train, val_data=fed_data.val,
                              device=device)
        logger.log(f"data plane: {cfg.data.data_plane}"
                   + (f" ({cfg.data.store} store)"
                      if cfg.data.data_plane == "stream" else ""))
        server, clients = trainer.init_state(cfg.train.manual_seed)
        timer.start("resume")
        server, clients, best_prec1, resumed = maybe_resume(
            cfg.checkpoint.resume, server, clients, cfg,
            cfg.checkpoint.checkpoint_index)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timer.stop("resume")
        if resumed:
            # a producer must start from the restored generator and round
            trainer.invalidate_stream()
            logger.log(f"resumed from round {server.round}")
        save_rounds = tuple(
            int(x) for x in cfg.checkpoint.save_some_models.split(","))
        async_ckpt = AsyncCheckpointer() if cfg.checkpoint.async_save \
            else None
        saver = async_ckpt.save if async_ckpt is not None \
            else save_checkpoint
        supervisor = None
        run_round = trainer.run_round
        if flt.supervisor:
            supervisor = RoundSupervisor(trainer, checkpoint_dir=run_dir,
                                         logger=logger)
            run_round = supervisor.run_round
        # the federation plane's observers: the per-client ledger of
        # the cohort vectors the round's fetch carries (cohort stats on)
        # and the observe-only anomaly detector over the rows; an
        # elastic restart adopts the run dir's ledger
        ledger = anomaly = None
        if tel.enabled and tel.is_writer and cfg.telemetry.cohort_stats:
            ledger = ClientLedger(
                run_dir, num_clients=cfg.federated.num_clients,
                sketch_budget=cfg.telemetry.ledger_sketch_budget,
                seed=cfg.train.manual_seed,
                run_meta={"algorithm": cfg.effective_algorithm,
                          "robust_agg": flt.robust_agg,
                          "sync_mode": cfg.federated.sync_mode},
                log=logger.log)
            if ledger.load_existing():
                logger.log("client ledger: adopted existing "
                           f"client_ledger.json ({ledger.rounds} rounds)")
        if tel.enabled and cfg.telemetry.anomaly_zscore > 0.0:
            anomaly = EwmaAnomalyDetector(
                zscore=cfg.telemetry.anomaly_zscore)
        # the privacy plane's accountant, charged each committed round
        # at the run's participation probability (the commit buffer m on
        # the async plane, else k_online, of C); an elastic restart
        # adopts the run dir's spend
        accountant, dp_q = None, 0.0
        if flt.dp_armed:
            accountant = PrivacyAccountant(flt.dp_noise_multiplier,
                                           flt.dp_delta)
            width = getattr(trainer, "buffer_size", None) \
                or trainer.k_online
            dp_q = min(1.0, width / float(cfg.federated.num_clients))
            if accountant.load_existing(run_dir):
                logger.log(
                    "privacy accountant: adopted existing "
                    f"{ACCOUNTANT_FILE} (eps_spent="
                    f"{accountant.epsilon():.4f} over "
                    f"{accountant.charged_rounds} rounds)")
        start_round = server.round
        tel.event("run.start", start_round=start_round, resumed=resumed,
                  num_comms=cfg.federated.num_comms)
        # process lifecycle: the signal-driven drain and the watchdog
        # (the timeout must exceed the first round's warm-up + eval +
        # checkpoint)
        preempt = PreemptionHandler(logger=logger)
        preempt.install()
        watchdog = StallWatchdog(flt.watchdog_timeout_s, logger=logger)
        watchdog.start()
        # the round's cost, captured once after the first round by the
        # writing process (telemetry/costs.py): program_costs.json, and
        # the MFU and memory gauges on every row after it
        cost_capture = None
        if tel.enabled and tel.is_writer:
            from fedtorch_tpu_torch.parallel.mesh import world_size
            from fedtorch_tpu_torch.telemetry.costs import ProgramCostCapture
            async_mode = cfg.federated.sync_mode == "async"
            if async_mode and cfg.telemetry.cost_capture_scan_rounds > 0:
                logger.log(
                    "cost capture: --cost_capture_scan_rounds is ignored "
                    "under sync_mode='async' (the commit plane refuses "
                    "the scan dispatch; capturing the commit only)")
            cost_capture = ProgramCostCapture(
                run_dir, compute_dtype=cfg.mesh.compute_dtype,
                arch=cfg.model.arch, batch_size=cfg.data.batch_size,
                local_steps=trainer.local_steps, k_online=trainer.k_online,
                num_devices=world_size(), backend=device.type,
                device_name=torch.cuda.get_device_name(device)
                if device.type == "cuda" else None,
                primary=("commit" if async_mode else "round")
                + ("_stream" if cfg.data.data_plane == "stream" else ""),
                scan_rounds=0 if async_mode
                else cfg.telemetry.cost_capture_scan_rounds,
                run_meta={"algorithm": cfg.effective_algorithm,
                          "dataset": cfg.data.dataset,
                          "k_online": trainer.k_online,
                          "local_steps": trainer.local_steps},
                log=logger.log)
            if device.type == "cuda":
                # the first round's peak is the hbm_program_peak_bytes
                torch.cuda.reset_peak_memory_stats(device)
    except BaseException:
        tel.health_update("error")
        _uninstall_host_plane()
        tel.close()
        raise

    results = {"data_plane": cfg.data.data_plane}
    loop_raised = False
    byz_attack_seen = False
    host_retries_seen = 0
    quorum_streak = 0
    dp_degraded = False
    last_saved_round = None
    lost_at_save = 0
    rounds_run = 0
    # the stream plane's overlap efficiency, from the deltas of the
    # producer's cumulative gauges the rows carry
    overlap_tracker = StreamOverlapTracker()
    try:
        for r in range(start_round, cfg.federated.num_comms):
            if accountant is not None and not dp_degraded \
                    and flt.dp_epsilon_budget > 0.0 \
                    and accountant.preview_epsilon(dp_q) \
                    > flt.dp_epsilon_budget:
                # round r is not affordable: 'stop' ends the run at the
                # last affordable round, 'degrade' goes on noise-free
                spent = accountant.epsilon()
                tel.event("privacy.budget_exhausted", round=r,
                          action=flt.dp_budget_action,
                          epsilon_spent=spent,
                          epsilon_budget=flt.dp_epsilon_budget,
                          delta=flt.dp_delta,
                          charged_rounds=accountant.charged_rounds)
                logger.log(
                    f"privacy budget exhausted before round {r}: "
                    f"eps_spent={spent:.4f} of "
                    f"{flt.dp_epsilon_budget} (action="
                    f"{flt.dp_budget_action})")
                results["dp_exhausted"] = True
                results["dp_exhausted_at_round"] = r
                if flt.dp_budget_action == "stop":
                    break
                server = trainer.dp_set_noise_scale(server, 0.0)
                dp_degraded = True
            timer.new_round()
            prev_params = {n: v.detach().clone()
                           for n, v in server.params.items()} \
                if cfg.checkpoint.track_model_aggregation else None
            timer.start("round")
            with tel.span("round", round=r):
                server, clients, metrics = run_round(server, clients)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            round_time = timer.stop("round")
            rounds_run += 1
            round0_peak = torch.cuda.max_memory_allocated(device) \
                if rounds_run == 1 and device.type == "cuda" else None
            # the diagnostics ride the round's one batched fetch
            extra = {}
            if cfg.checkpoint.check_model_at_sync:
                norms = model_norms(server.params)
                extra.update(norm_l2=norms["l2"],
                             norm_max_abs=norms["max_abs"])
            if prev_params is not None:
                tr = aggregation_tracking(prev_params, server.params)
                extra.update(agg_cosine=tr["cosine"],
                             agg_distance=tr["distance"])
            fetch_t0 = time.perf_counter()
            led = None
            if supervisor is not None \
                    and supervisor.last_scalars is not None:
                # the supervisor's health check fetched the scalars
                sc = dict(supervisor.last_scalars)
                if extra:
                    sc.update(zip(extra, torch.stack(
                        [v.float() for v in extra.values()]).tolist()))
                if ledger is not None:
                    # the cohort vectors alone: a second transfer
                    _, led = trainer.round_host_scalars(
                        clients, metrics, ledger=True)
            else:
                with tel.span("scalar_fetch", round=r):
                    if ledger is None:
                        sc = trainer.round_host_scalars(clients, metrics,
                                                        extra=extra)
                    else:
                        # the ledger's vectors ride the same transfer
                        sc, led = trainer.round_host_scalars(
                            clients, metrics, extra=extra, ledger=True)
            fetch_s = time.perf_counter() - fetch_t0
            timer.add_comm(num_bytes=sc["comm_bytes"])
            # the fetch waited for the round: it completed
            watchdog.heartbeat(r)
            if accountant is not None and not dp_degraded:
                # noise-free rounds after a 'degrade' spend nothing;
                # charge_round dedups by round index
                accountant.charge_round(r, dp_q)
            if flt.chaos_enabled or flt.guard_updates:
                if sc["dropped"] or sc["rejected"] or sc["clipped"] \
                        or sc["stragglers"] or sc["byzantine"]:
                    logger.log(f"Round {r}: faults — "
                               f"dropped={sc['dropped']:.0f} "
                               f"stragglers={sc['stragglers']:.0f} "
                               f"rejected={sc['rejected']:.0f} "
                               f"clipped={sc['clipped']:.0f} "
                               f"byzantine={sc['byzantine']:.0f}")
                if sc["byzantine"] and not byz_attack_seen:
                    byz_attack_seen = True
                    tel.event("chaos.byzantine_attack", round=r,
                              mode=flt.byzantine_mode,
                              rate=flt.byzantine_rate,
                              scale=flt.byzantine_scale,
                              robust_agg=flt.robust_agg)
                if supervisor is None and all_rejected_scalars(sc):
                    logger.log(f"Round {r}: guards rejected EVERY "
                               "update — server held (renorm scale 0)")
                    tel.event("guards.all_rejected", round=r,
                              n_online=sc["n_online"],
                              rejected=sc["rejected"],
                              dropped=sc["dropped"])
            if cfg.checkpoint.check_model_at_sync:
                logger.log(f"Round {r}: server model l2="
                           f"{sc['norm_l2']:.4f} "
                           f"max|w|={sc['norm_max_abs']:.4f}")
            if prev_params is not None:
                logger.log(f"Round {r}: aggregation cosine="
                           f"{sc['agg_cosine']:.6f} "
                           f"distance={sc['agg_distance']:.6f}")
            n_online = max(sc["n_online"], 1.0)
            logger.log_train(r, sc["mean_epoch"], sc["loss_sum"] / n_online,
                             sc["acc_sum"] / n_online, sc["lr"],
                             comm_bytes=sc["comm_bytes"],
                             round_time=round_time)

            eval_s = checkpoint_s = None
            if (r + 1) % cfg.train.eval_freq == 0:
                timer.start("eval")
                with tel.span("eval", round=r):
                    loss, top1, top5 = (float(v) for v in evaluate(
                        model, server.params, fed_data.test_x,
                        fed_data.test_y))
                eval_s = timer.stop("eval")
                is_best = top1 > best_prec1
                best_prec1 = max(best_prec1, top1)
                logger.log_val(r, "test", loss, top1, top5, best=best_prec1)
                if cfg.train.per_class_acc:
                    accs, _ = evaluate_per_class(
                        model, server.params, fed_data.test_x,
                        fed_data.test_y, num_classes_of(cfg.data.dataset))
                    logger.log("Round: {}. Per-class acc: {}".format(
                        r, [round(a, 4) for a in accs.tolist()]))
                if accountant is not None:
                    # spend through any resume point is durable first
                    if tel.is_writer:
                        accountant.save(run_dir)
                timer.start("checkpoint")
                with tel.span("checkpoint", round=r):
                    saver(run_dir, server, clients, cfg, best_prec1,
                          is_best, save_all=cfg.checkpoint.save_all_models,
                          save_some_rounds=save_rounds)
                last_saved_round = r
                # the drain compares against it to see THIS round's
                # async write lost behind its back
                lost_at_save = async_ckpt.lost_writes \
                    if async_ckpt is not None else 0
                checkpoint_s = timer.stop("checkpoint")
                if personal:
                    # the personalized models on the clients' val rows
                    _, _, summary = evaluate_personal(
                        model, clients.aux, clients.params,
                        trainer.val_data, cfg.effective_algorithm)
                    logger.log_val(r, "validation_personal",
                                   summary["loss_mean"], summary["acc_mean"])
                results["test_top1"] = top1
            results["rounds"] = r + 1

            if cost_capture is not None and not cost_capture.captured \
                    and not cost_capture.load_existing():
                # once, at this process's first completed round (a
                # resumed run adopts the run dir's capture); a failure
                # turns the gauges off, never the run
                with tel.span("cost_capture", round=r):
                    try:
                        from fedtorch_tpu_torch.telemetry.costs import (
                            round_flops,
                        )
                        B = cfg.data.batch_size
                        counted = round_flops(
                            trainer, server.params,
                            fed_data.train.x[0, :B].to(device),
                            fed_data.train.y[0, :B].to(device))
                        cost_capture.capture(counted, round0_peak)
                    except Exception as e:
                        cost_capture.captured = True
                        logger.log(f"cost capture: counting failed ({e}); "
                                   "device gauges off")
                tel.event("cost.capture", round=r,
                          ok=cost_capture.doc is not None)

            # one schema-versioned metrics row a round, from the fetched
            # scalars and host counters only
            row = {
                "round": r, "round_s": round_time,
                "loss": sc["loss_sum"] / n_online,
                "acc": sc["acc_sum"] / n_online, "lr": sc["lr"],
                "n_online": sc["n_online"],
                "comm_bytes": sc["comm_bytes"],
                "mean_epoch": sc["mean_epoch"], "fetch_s": fetch_s,
                "dropped": sc["dropped"], "stragglers": sc["stragglers"],
                "rejected": sc["rejected"], "clipped": sc["clipped"],
                "staleness": sc["staleness"], "byzantine": sc["byzantine"],
                "robust_selected": sc["robust_selected"],
                "robust_trimmed": sc["robust_trimmed"],
                "avail_dropped": sc["avail_dropped"],
                "deadline_missed": sc["deadline_missed"],
                "quorum_degraded": sc["quorum_degraded"],
            }
            if eval_s is not None:
                row.update(eval_s=eval_s, test_top1=top1,
                           best_top1=best_prec1)
            if checkpoint_s is not None:
                row["checkpoint_s"] = checkpoint_s
            if "cohort_dispersion" in sc:
                row["cohort_dispersion"] = sc["cohort_dispersion"]
            if "dp_clipped_frac" in sc:
                row["dp_clipped_frac"] = sc["dp_clipped_frac"]
                row["dp_noise_sigma"] = sc["dp_noise_sigma"]
            if accountant is not None:
                row["dp_epsilon_spent"] = accountant.epsilon()
            if led is not None:
                # the norm quantiles and the ledger's O(k) fold, from
                # the same fetch
                nq = [float(v) for v in led["norm_q"]]
                row.update(cohort_norm_min=nq[0], cohort_norm_q25=nq[1],
                           cohort_norm_med=nq[2], cohort_norm_q75=nq[3],
                           cohort_norm_max=nq[4])
                ledger.update(r, led)
                row.update(ledger.stats())
            row.update(trainer.telemetry_gauges())
            if cost_capture is not None:
                # MFU and the memory pair, host-side; empty until the
                # capture above succeeded
                row.update(cost_capture.round_gauges(round_time))
            overlap_eff = overlap_tracker.observe(row)
            if overlap_eff is not None:
                row["overlap_efficiency"] = overlap_eff
            if async_ckpt is not None:
                row.update(async_ckpt.stats())
            if supervisor is not None:
                st = supervisor.stats
                row.update(sup_rollbacks=float(st.rollbacks),
                           sup_retries=float(st.retries),
                           sup_skipped=float(st.skipped_rounds),
                           sup_skipped_fault=float(st.skipped_fault),
                           sup_skipped_quorum=float(st.skipped_quorum))
            row.update(recovery.stats())
            if injector is not None:
                row.update(injector.stats())
            tel.round_row(row)
            if sc["quorum_degraded"] > 0:
                tel.event("lifecycle.quorum_degraded", round=r,
                          n_online=sc["n_online"],
                          avail_dropped=sc["avail_dropped"],
                          deadline_missed=sc["deadline_missed"])
            if anomaly is not None:
                # observe-only: events, no control flow
                for a in anomaly.observe(row):
                    tel.event("anomaly.detected", round=r, **a)
            if cfg.telemetry.level == "debug" and (r + 1) % 25 == 0:
                _staleness_event(tel, trainer, round=r, snapshot="debug")
            # health: r + 1 rounds complete (checkpoint.json's "round"
            # convention); the intent reflects the host plane's state
            host_retries_now = recovery.total_retries()
            quorum_streak = quorum_streak + 1 \
                if sc["quorum_degraded"] > 0 else 0
            if recovery.degraded or quorum_streak >= 3 or dp_degraded:
                intent = "degraded"
            elif host_retries_now > host_retries_seen:
                intent = "recovering"
            else:
                intent = "running"
            host_retries_seen = host_retries_now
            tel.health_update(intent, round_idx=r + 1,
                              staleness=sc["staleness"])

            if round_callback is not None:
                round_callback(r, trainer, server, clients, metrics)
            if preempt.stop_requested:
                # drain at the round boundary (the round's CUDA work has
                # finished above): a final checkpoint, then the
                # restartable exit. The watchdog disarms first: a slow
                # final write must not read as a stall.
                watchdog.stop()
                reason = preempt.reason or "request_stop"
                logger.log(f"preemption: stop requested ({reason}); "
                           f"draining after round {r}")
                tel.event("preempt.drain", round=r, reason=reason)
                # the preempted run's histogram, durable even if the
                # drain's own write raises
                _staleness_event(tel, trainer, round=r, snapshot="drain")
                tel.health_update("drain", round_idx=r + 1)
                # the resume point must be DURABLE before exit 75: when
                # this round's eval already saved, drain the async queue
                # and redo the write only if that queued write was lost
                final_ckpt_needed = last_saved_round != r
                if not final_ckpt_needed and async_ckpt is not None:
                    async_ckpt.wait()
                    final_ckpt_needed = \
                        async_ckpt.lost_writes > lost_at_save
                    if final_ckpt_needed:
                        logger.log("preemption: this round's async "
                                   "checkpoint was lost — rewriting "
                                   "synchronously before exit")
                if final_ckpt_needed:
                    timer.start("checkpoint")
                    with tel.span("checkpoint", round=r, drain=True):
                        if async_ckpt is not None:
                            # an older queued write must not land after
                            # the final one
                            async_ckpt.wait()
                        save_checkpoint(
                            run_dir, server, clients, cfg, best_prec1,
                            False, save_all=cfg.checkpoint.save_all_models,
                            save_some_rounds=save_rounds)
                    timer.stop("checkpoint")
                results["preempted"] = True
                results["preempted_at_round"] = r
                break
    except BaseException:
        loop_raised = True
        raise
    finally:
        watchdog.stop()
        preempt.restore()
        # read before the teardown drops the async schedule (the trainer
        # also keeps it across the teardown)
        final_hist = trainer.staleness_histogram()
        # the stream plane's producer thread ends with the run
        trainer.close()
        flush_raised = False
        try:
            if async_ckpt is not None:
                # flush pending writes even when the loop raised; a
                # flush error must not mask the loop's own exception
                timer.start("checkpoint")
                try:
                    async_ckpt.close()
                except Exception as e:
                    flush_raised = True
                    if loop_raised:
                        logger.log("WARNING: async checkpoint flush "
                                   "failed while handling another "
                                   f"error: {e}")
                    else:
                        raise
                finally:
                    timer.stop("checkpoint")
        finally:
            if final_hist:
                tel.event("async.staleness_hist", snapshot="final",
                          hist={str(k): v
                                for k, v in sorted(final_hist.items())})
            if ledger is not None:
                ledger.flush()
            if accountant is not None and tel.is_writer:
                accountant.save(run_dir)
            if anomaly is not None:
                tel.event("anomaly.summary", fields=anomaly.summary())
            done = _launch_counts()
            tel.event("kernels.launches", rounds=rounds_run,
                      **{k: done[k] - launches_at_start[k] for k in done})
            tel.event("run.end", preempted=bool(results.get("preempted")),
                      raised=loop_raised or flush_raised)
            if loop_raised or flush_raised:
                tel.health_update("error")
            elif results.get("preempted"):
                tel.health_update("preempted")
            elif quorum_streak >= 3 or dp_degraded:
                tel.health_update("degraded")
            else:
                tel.health_update("complete")
            _uninstall_host_plane()
            tel.close()
    results["best_top1"] = best_prec1
    if accountant is not None:
        results["dp"] = {
            "epsilon_spent": accountant.epsilon(),
            "delta": flt.dp_delta,
            "charged_rounds": accountant.charged_rounds,
            "exhausted": bool(results.get("dp_exhausted")),
            "degraded": dp_degraded,
        }
    if supervisor is not None:
        st = supervisor.stats
        results["supervisor"] = {
            "rounds": st.rounds, "retries": st.retries,
            "rollbacks": st.rollbacks,
            "skipped_rounds": st.skipped_rounds,
            "skipped_fault": st.skipped_fault,
            "skipped_quorum": st.skipped_quorum,
            "disk_restores": st.disk_restores,
            "all_rejected_rounds": st.all_rejected_rounds,
            "last_good_round": st.last_good_round}
        if st.rollbacks:
            logger.log(f"supervisor: {st.rollbacks} rollback(s), "
                       f"{st.retries} retrie(s), {st.skipped_rounds} "
                       "skipped round(s)")
    rec_stats = recovery.stats()
    if injector is not None:
        rec_stats.update(injector.stats())
        rec_stats["host_fault_fires"] = injector.fire_counts()
    if any(bool(v) for v in rec_stats.values()):
        results["host_recovery"] = rec_stats
        logger.log(f"host plane: {rec_stats}")
    results["timer"] = timer.summary()
    logger.log(f"phase timers: {timer.summary()}")
    if results.get("preempted"):
        logger.log("preemption: final checkpoint drained and flushed; "
                   f"restartable exit (code {RESTART_EXIT_CODE}) — "
                   "supervise relaunches with --resume")
    return results


def main(argv=None, round_callback=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), build the config and
    run it; returns the results dict, and raises ``SystemExit(75)`` when
    the run drained on a stop signal. ``supervise [options] -- <command>``
    runs the restart harness (``robustness/harness.py``), ``lint
    [options]`` the port's lint and ``audit [--registry-only]`` its
    registry and concurrency audit (``fedtorch_tpu_torch/lint``); each
    returns its exit code. ``round_callback`` as for :func:`run_experiment`."""
    if argv is None:
        import sys
        argv = sys.argv[1:]
    if argv and argv[0] == "supervise":
        from fedtorch_tpu_torch.robustness.harness import main as harness
        return harness(argv[1:])
    if argv and argv[0] in ("lint", "audit"):
        # the port's static analysis and registry audit
        # (fedtorch_tpu_torch/lint); ``audit`` has no program half
        from fedtorch_tpu_torch.lint.cli import main as lint_main
        return lint_main((["--audit"] if argv[0] == "audit" else [])
                         + list(argv[1:]))
    if argv and argv[0] in SUBCOMMANDS:
        raise ValueError(f"the {argv[0]!r} subcommand is not yet ported "
                         "(the JAX package's tools read the port's run "
                         "directories: python -m fedtorch_tpu.cli "
                         f"{argv[0]} ...)")
    args = build_parser().parse_args(argv)
    results = run_experiment(args_to_config(args), download=args.download,
                             round_callback=round_callback)
    if results.get("preempted"):
        # EX_TEMPFAIL: the restart harness's contract
        raise SystemExit(RESTART_EXIT_CODE)
    return results


if __name__ == "__main__":
    _result = main()
    if isinstance(_result, int):  # the supervise exit code
        raise SystemExit(_result)
