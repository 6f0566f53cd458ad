"""Robustness (port of ``fedtorch_tpu/robustness``). In the round: the
server's update guards (``guards.py``), the byzantine-robust aggregation
rules (``aggregators.py``), chaos injection (``chaos.py``), the
availability models and the sync round lifecycle (``availability.py``)
and DP-FedAvg with its RDP accountant (``privacy.py``). Around it, the
run lifecycle: the round supervisor (``supervisor.py``), host-plane
chaos and recovery (``host_chaos.py``, ``host_recovery.py``), the
preemption drain (``preemption.py``), the stall watchdog
(``watchdog.py``) and the restart harness (``harness.py``)."""
from fedtorch_tpu_torch.robustness.availability import (
    DefaultAvailability, TraceAvailability, make_availability_model,
    sync_lifecycle, synthesize_trace,
)
from fedtorch_tpu_torch.robustness.chaos import (
    ChaosPlan, apply_byzantine, byzantine_cohort_mask, draw_chaos_plan,
    no_chaos_plan, poison_tree,
)
from fedtorch_tpu_torch.robustness.guards import (
    GuardReport, renormalize_accepted, screen_payloads,
)
from fedtorch_tpu_torch.robustness.harness import (
    ElasticRunner, read_checkpoint_round,
)
from fedtorch_tpu_torch.robustness.host_chaos import HostFaultInjector
from fedtorch_tpu_torch.robustness.host_recovery import (
    HostRecovery, HostSeamError, RetryPolicy,
)
from fedtorch_tpu_torch.robustness.preemption import (
    RESTART_EXIT_CODE, PreemptionHandler,
)
from fedtorch_tpu_torch.robustness.privacy import (
    PrivacyAccountant, calibrate_noise_multiplier, dp_add_noise,
    dp_clip_payloads, dp_noise_stddev,
)

from fedtorch_tpu_torch.robustness.supervisor import (
    RoundSupervisor, SupervisorStats,
)
from fedtorch_tpu_torch.robustness.watchdog import (
    StallWatchdog, format_thread_stacks,
)

__all__ = [
    "RESTART_EXIT_CODE", "ChaosPlan", "DefaultAvailability",
    "ElasticRunner", "GuardReport", "HostFaultInjector", "HostRecovery",
    "HostSeamError", "PreemptionHandler", "PrivacyAccountant",
    "RetryPolicy", "RoundSupervisor", "StallWatchdog", "SupervisorStats",
    "TraceAvailability", "format_thread_stacks", "read_checkpoint_round", "apply_byzantine", "byzantine_cohort_mask",
    "calibrate_noise_multiplier", "dp_add_noise", "dp_clip_payloads",
    "dp_noise_stddev", "draw_chaos_plan", "make_availability_model",
    "no_chaos_plan", "poison_tree", "renormalize_accepted",
    "screen_payloads", "sync_lifecycle", "synthesize_trace",
]
