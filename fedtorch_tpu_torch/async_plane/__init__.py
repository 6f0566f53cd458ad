"""The asynchronous buffered federation plane, a FedBuff-style server
(port of ``fedtorch_tpu/async_plane``).

Selected with ``cfg.federated.sync_mode='async'`` (``--sync_mode
async``); ``sync``, the default, is the round-synchronous engine.
"""
from fedtorch_tpu_torch.async_plane.commit import (  # noqa: F401
    ASYNC_ALGORITHMS, AsyncFederatedTrainer, CommitJobs,
)
from fedtorch_tpu_torch.async_plane.scheduler import (  # noqa: F401
    AsyncSchedule, HostCommitPlan, simulate_sync_round_times,
)
from fedtorch_tpu_torch.async_plane.staleness import (  # noqa: F401
    STALENESS_MODES, normalized_staleness_weights, staleness_weight,
)
