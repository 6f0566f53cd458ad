"""In-round robustness (port of ``fedtorch_tpu/robustness``): the server's
update guards (``guards.py``), the byzantine-robust aggregation rules
(``aggregators.py``), chaos injection (``chaos.py``), the availability
models and the sync round lifecycle (``availability.py``) and DP-FedAvg
with its RDP accountant (``privacy.py``). The supervisor, the host-plane
chaos and recovery, preemption and the watchdog are ROADMAP A7."""
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
from fedtorch_tpu_torch.robustness.privacy import (
    PrivacyAccountant, calibrate_noise_multiplier, dp_add_noise,
    dp_clip_payloads, dp_noise_stddev,
)

__all__ = [
    "ChaosPlan", "DefaultAvailability", "GuardReport", "PrivacyAccountant",
    "TraceAvailability", "apply_byzantine", "byzantine_cohort_mask",
    "calibrate_noise_multiplier", "dp_add_noise", "dp_clip_payloads",
    "dp_noise_stddev", "draw_chaos_plan", "make_availability_model",
    "no_chaos_plan", "poison_tree", "renormalize_accepted",
    "screen_payloads", "sync_lifecycle", "synthesize_trace",
]
