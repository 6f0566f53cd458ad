from fedtorch_tpu_torch.parallel.evaluate import (
    EvalResult, evaluate, evaluate_clients, evaluate_per_class,
    evaluate_personal,
)
from fedtorch_tpu_torch.parallel.federated import (
    FederatedTrainer, RoundPlan, participation_indices,
)

__all__ = ["EvalResult", "FederatedTrainer", "RoundPlan", "evaluate",
           "evaluate_clients", "evaluate_per_class", "evaluate_personal",
           "participation_indices"]
