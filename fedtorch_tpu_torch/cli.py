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
``cnn``, ``rnn``, the transformer and the flat models. The update guards
(``--guard_updates``, ``--guard_norm_multiplier``, ``--guard_mode``),
the robust rules (``--robust_agg``, ``--robust_trim_frac``,
``--robust_norm_tau``), chaos injection (``--fault_client_drop_rate``,
``--fault_straggler_rate``, ``--fault_straggler_step_frac``,
``--fault_nan_inject_rate``, ``--fault_byzantine_rate``,
``--fault_byzantine_mode``, ``--fault_byzantine_scale``), the
availability lifecycle (``--avail_model``, ``--avail_dropout_rate``,
``--avail_diurnal_period``, ``--over_select_frac``,
``--avail_quorum_frac``; ``--avail_quorum_action abort`` needs the
supervisor, ROADMAP A7) and DP-FedAvg (``--dp_noise_multiplier``,
``--dp_clip_norm``, ``--dp_delta``) run in the round. A round with a
fault logs the JAX CLI's ``faults`` line, and a round that aggregated
nothing its all-rejected line. With DP armed an in-memory RDP
accountant charges each round at ``q = min(1, k_online / C)``, and
``--dp_epsilon_budget`` with ``--dp_budget_action`` stops the run at
the last affordable round or degrades it to noise-free rounds;
``results["dp"]`` reports the spend. The JAX run writes checkpoints,
telemetry rows and the accountant's file; the port writes none of them
yet, and logs one line saying so.

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
import os
import time

import torch

from fedtorch_tpu_torch.config import (
    CLIENT_STORES, PARTICIPATION_MODES, PERSONALIZED_ALGORITHMS,
    CheckpointConfig, DataConfig, ExperimentConfig, FaultConfig,
    FederatedConfig, LRConfig, MeshConfig, ModelConfig, OptimConfig,
    TelemetryConfig, TrainConfig,
)

# the JAX package's subcommands (``fedtorch-tpu lint ...``)
SUBCOMMANDS = ("lint", "audit", "report", "watch", "compare", "runs",
               "supervise")


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


_unported("federated", "the async plane (ROADMAP A8)", {
    "sync_mode": "sync_mode", "async_buffer_size": "async_buffer_size",
    "async_concurrency": "async_concurrency",
    "staleness_weight": "staleness_weight",
    "staleness_exponent": "staleness_exponent",
    "snapshot_ring": "snapshot_ring"})
_unported("checkpoint", "checkpoints and resuming (ROADMAP A7)", {
    "resume": "resume", "checkpoint_index": "checkpoint_index",
    "save_all_models": "save_all_models",
    "save_some_models": "save_some_models",
    "checkpoint_keep_last_n": "keep_last_n",
    "async_checkpoint": "async_save"})
_unported("checkpoint", "the model diagnostics of utils/diagnostics.py "
          "(ROADMAP A7)", {"check_model_at_sync": "check_model_at_sync",
                           "track_model_aggregation":
                               "track_model_aggregation"})
_unported("fault", "the round supervisor (ROADMAP A7)", {
    "supervisor": "supervisor", "supervisor_loss_blowup": "loss_blowup_factor",
    "supervisor_max_retries": "max_retries",
    "supervisor_backoff_base": "backoff_base_s"})
_unported("fault", "host-plane chaos and recovery (ROADMAP A7)", {
    "host_fault_seams": "host_fault_seams",
    "host_fault_rate": "host_fault_rate",
    "host_fault_seed": "host_fault_seed",
    "host_fault_delay_s": "host_fault_delay_s",
    "host_fault_max": "host_fault_max", "host_retry_max": "host_retry_max",
    "host_retry_backoff_s": "host_retry_backoff_s"})
_unported("fault", "the stall watchdog (ROADMAP A7)",
          {"watchdog_timeout_s": "watchdog_timeout_s"})
_unported("mesh", "multi-device and multi-host runs (ROADMAP A10)", {
    "num_devices": "num_devices",
    "coordinator_address": "coordinator_address",
    "num_processes": "num_processes", "process_id": "process_id",
    "client_shards": "client_shards"})
_unported("mesh", "XLA's scan unrolling, which has no eager-torch "
          "counterpart", {"scan_unroll": "scan_unroll"})
_unported("telemetry", "run telemetry (ROADMAP A7)", {
    "telemetry": "level",
    "cost_capture_scan_rounds": "cost_capture_scan_rounds",
    "cohort_stats": "cohort_stats",
    "ledger_sketch_budget": "ledger_sketch_budget",
    "anomaly_zscore": "anomaly_zscore"})


def refused_flags(cfg: ExperimentConfig) -> list:
    """``--flag value: what is not yet ported`` for every flag of ``cfg``
    the port cannot honour."""
    default = ExperimentConfig()
    out = []
    for flag, (section, field, what) in UNPORTED_FLAGS.items():
        value = getattr(getattr(cfg, section), field)
        if value != getattr(getattr(default, section), field):
            out.append(f"--{flag} {value!r}: {what}")
    if cfg.mesh.client_fusion == "fused":
        out.append("--client_fusion 'fused': client fusion (ROADMAP A9)")
    if cfg.mesh.backend not in (None, "cpu", "cuda", "gpu"):
        out.append(f"--backend {cfg.mesh.backend!r}: the port runs on "
                   "CUDA or, asked with --backend cpu, on the CPU")
    return out


def init_run_dir(cfg: ExperimentConfig) -> str:
    """The run directory the JAX package's ``init_checkpoint_dir`` makes
    (checkpoint.py:12-45's hyperparam-encoding name), which holds the
    run's log (``record0``): ``--run_dir`` exactly, else
    ``<checkpoint>/<dataset>/<arch>/<time>_l2-..._lr-..._...``."""
    if cfg.checkpoint.run_dir:
        os.makedirs(cfg.checkpoint.run_dir, exist_ok=True)
        return cfg.checkpoint.run_dir
    fed = cfg.federated
    parts = [time.strftime("%Y-%m-%d_%H-%M-%S"),
             f"l2-{cfg.optim.weight_decay}", f"lr-{cfg.optim.lr}",
             f"momentum-{cfg.optim.in_momentum_factor}",
             f"batchsize-{cfg.data.batch_size}",
             f"arch-{cfg.model.arch}", f"data-{cfg.data.dataset}"]
    if fed.federated:
        parts += [f"alg-{cfg.effective_algorithm}",
                  f"clients-{fed.num_clients}",
                  f"rate-{fed.online_client_rate}"]
    root = os.path.join(cfg.checkpoint.checkpoint_dir, cfg.data.dataset,
                        cfg.model.arch, "_".join(parts))
    os.makedirs(root, exist_ok=True)
    return root


def run_experiment(cfg: ExperimentConfig, download: bool = False,
                   round_callback=None) -> dict:
    """The synchronous federated driver loop (federated/main.py:56-211;
    the JAX package's ``run_experiment``), or local-SGD mode without
    ``--federated``. ``round_callback(r, trainer, server, clients,
    metrics)`` (optional) fires after every federated round."""
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.models.common import num_classes_of
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    from fedtorch_tpu_torch.parallel.evaluate import (
        evaluate, evaluate_per_class, evaluate_personal,
    )
    from fedtorch_tpu_torch.parallel.local_sgd import build_local_sgd
    from fedtorch_tpu_torch.robustness.guards import all_rejected_scalars
    from fedtorch_tpu_torch.robustness.privacy import PrivacyAccountant
    from fedtorch_tpu_torch.utils import resolve_device
    from fedtorch_tpu_torch.utils.logging import RunLogger
    from fedtorch_tpu_torch.utils.meters import PhaseTimer

    refused = refused_flags(cfg)
    if download:
        refused.append("--download True: fetching a dataset (no machine "
                       "the port runs on has a network to test it)")
    if refused:
        raise ValueError("not yet ported: " + "; ".join(refused))
    # the CPU only when --backend cpu asks; else CUDA, which raises
    # without a card
    device = resolve_device("cpu" if cfg.mesh.backend == "cpu" else None)
    run_dir = init_run_dir(cfg)
    logger = RunLogger(run_dir, debug=cfg.checkpoint.debug)
    logger.log_args(cfg)
    logger.log(f"device: {device}"
               + (f" ({torch.cuda.get_device_name(device)})"
                  if device.type == "cuda" else ""))
    logger.log("the port writes no checkpoints and no telemetry rows yet, "
               "nor the privacy accountant's file (ROADMAP A7): this "
               "run's record is this log")
    timer = PhaseTimer()

    timer.start("data")
    fed_data = build_federated_data(cfg)
    model = define_model(cfg, batch_size=cfg.data.batch_size, device=device)
    timer.stop("data")

    if not cfg.federated.federated:
        # local-SGD mode: the workers' shards pooled back into one
        # training set (padding rows included, as the JAX package pools
        # them) and re-partitioned IID across the workers; a sequence
        # model's [T] label rows stay rows (the JAX CLI flattens them
        # into single labels and fails on them)
        x, y = (t.numpy() for t in fed_data.train[:2])
        trainer = build_local_sgd(cfg, model,
                                  x.reshape((-1,) + x.shape[2:]),
                                  y.reshape((-1,) + y.shape[2:]),
                                  device=device)
        server, _, history = trainer.fit(cfg.train.manual_seed)
        loss, top1, top5 = (float(v) for v in evaluate(
            model, server.params, fed_data.test_x, fed_data.test_y))
        logger.log_val(len(history), "test", loss, top1, top5)
        return {"test_top1": top1, "rounds": len(history)}

    personal = cfg.federated.personal and fed_data.val is not None \
        and cfg.effective_algorithm in PERSONALIZED_ALGORITHMS
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg),
                               fed_data.train, val_data=fed_data.val,
                               device=device)
    logger.log(f"data plane: {cfg.data.data_plane}"
               + (f" ({cfg.data.store} store)"
                  if cfg.data.data_plane == "stream" else ""))
    server, clients = trainer.init_state(cfg.train.manual_seed)
    results, best_prec1 = {"data_plane": cfg.data.data_plane}, 0.0
    flt = cfg.fault
    # the privacy plane's accountant, charged each committed round at
    # the run's participation probability (k_online of C)
    accountant, dp_q, dp_degraded = None, 0.0, False
    if flt.dp_armed:
        accountant = PrivacyAccountant(flt.dp_noise_multiplier,
                                       flt.dp_delta)
        dp_q = min(1.0, trainer.k_online
                   / float(cfg.federated.num_clients))
    try:
        for r in range(cfg.federated.num_comms):
            if accountant is not None and not dp_degraded \
                    and flt.dp_epsilon_budget > 0.0 \
                    and accountant.preview_epsilon(dp_q) \
                    > flt.dp_epsilon_budget:
                # round r is not affordable: 'stop' ends the run at the
                # last affordable round, 'degrade' goes on noise-free
                logger.log(
                    f"privacy budget exhausted before round {r}: "
                    f"eps_spent={accountant.epsilon():.4f} of "
                    f"{flt.dp_epsilon_budget} (action="
                    f"{flt.dp_budget_action})")
                results["dp_exhausted"] = True
                results["dp_exhausted_at_round"] = r
                if flt.dp_budget_action == "stop":
                    break
                server = trainer.dp_set_noise_scale(server, 0.0)
                dp_degraded = True
            timer.new_round()
            timer.start("round")
            server, clients, metrics = trainer.run_round(server, clients)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            round_time = timer.stop("round")
            sc = trainer.round_host_scalars(clients, metrics)
            timer.add_comm(num_bytes=sc["comm_bytes"])
            if accountant is not None and not dp_degraded:
                # noise-free rounds after a 'degrade' spend nothing
                accountant.charge_round(r, dp_q)
            n_online = max(sc["n_online"], 1.0)
            logger.log_train(r, sc["mean_epoch"], sc["loss_sum"] / n_online,
                             sc["acc_sum"] / n_online, sc["lr"],
                             comm_bytes=sc["comm_bytes"],
                             round_time=round_time)
            if flt.chaos_enabled or flt.guard_updates:
                if sc["dropped"] or sc["rejected"] or sc["clipped"] \
                        or sc["stragglers"] or sc["byzantine"]:
                    logger.log(f"Round {r}: faults — "
                               f"dropped={sc['dropped']:.0f} "
                               f"stragglers={sc['stragglers']:.0f} "
                               f"rejected={sc['rejected']:.0f} "
                               f"clipped={sc['clipped']:.0f} "
                               f"byzantine={sc['byzantine']:.0f}")
                if all_rejected_scalars(sc):
                    logger.log(f"Round {r}: guards rejected EVERY "
                               "update — server held (renorm scale 0)")
            if (r + 1) % cfg.train.eval_freq == 0:
                timer.start("eval")
                res = [float(v) for v in evaluate(model, server.params,
                                                  fed_data.test_x,
                                                  fed_data.test_y)]
                timer.stop("eval")
                loss, top1, top5 = res
                best_prec1 = max(best_prec1, top1)
                logger.log_val(r, "test", loss, top1, top5, best=best_prec1)
                if cfg.train.per_class_acc:
                    accs, _ = evaluate_per_class(
                        model, server.params, fed_data.test_x,
                        fed_data.test_y, num_classes_of(cfg.data.dataset))
                    logger.log("Round: {}. Per-class acc: {}".format(
                        r, [round(a, 4) for a in accs.tolist()]))
                if personal:
                    # the personalized models on the clients' val rows
                    _, _, summary = evaluate_personal(
                        model, clients.aux, clients.params,
                        trainer.val_data, cfg.effective_algorithm)
                    logger.log_val(r, "validation_personal",
                                   summary["loss_mean"], summary["acc_mean"])
                results["test_top1"] = top1
            results["rounds"] = r + 1
            if round_callback is not None:
                round_callback(r, trainer, server, clients, metrics)
    finally:
        # the stream plane's producer thread ends with the run
        trainer.close()
    results["best_top1"] = best_prec1
    if accountant is not None:
        results["dp"] = {
            "epsilon_spent": accountant.epsilon(),
            "delta": flt.dp_delta,
            "charged_rounds": accountant.charged_rounds,
            "exhausted": bool(results.get("dp_exhausted")),
            "degraded": dp_degraded,
        }
    results["timer"] = timer.summary()
    logger.log(f"phase timers: {timer.summary()}")
    return results


def main(argv=None, round_callback=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), build the config and
    run it; returns the results dict. ``round_callback`` as for
    :func:`run_experiment`."""
    if argv is None:
        import sys
        argv = sys.argv[1:]
    if argv and argv[0] in SUBCOMMANDS:
        raise ValueError(f"the {argv[0]!r} subcommand is not yet ported "
                         "(the JAX package's tools read run directories; "
                         "ROADMAP A7, A12)")
    args = build_parser().parse_args(argv)
    return run_experiment(args_to_config(args), download=args.download,
                          round_callback=round_callback)


if __name__ == "__main__":
    main()
