from fedtorch_tpu_torch.parallel.evaluate import (
    EvalResult, evaluate, evaluate_clients, evaluate_per_class,
    evaluate_personal,
)
from fedtorch_tpu_torch.parallel.federated import (
    FederatedTrainer, RoundPlan, participation_indices,
)
from fedtorch_tpu_torch.parallel.sequence import (
    reference_attention, ring_attention, ulysses_attention,
)
from fedtorch_tpu_torch.parallel.tensor import tp_apply, transformer_tp_specs
from fedtorch_tpu_torch.parallel.pipeline import pipeline_apply
from fedtorch_tpu_torch.parallel.expert import ep_moe_apply

__all__ = ["EvalResult", "FederatedTrainer", "RoundPlan", "ep_moe_apply",
           "evaluate", "evaluate_clients", "evaluate_per_class",
           "evaluate_personal", "participation_indices", "pipeline_apply",
           "reference_attention", "ring_attention", "tp_apply",
           "transformer_tp_specs", "ulysses_attention"]
