from fedtorch_tpu_torch.parallel.federated import (
    FederatedTrainer, RoundPlan, participation_indices,
)

__all__ = ["FederatedTrainer", "RoundPlan", "participation_indices"]
