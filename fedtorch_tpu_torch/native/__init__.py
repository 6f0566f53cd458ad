"""Host-side helpers of the streaming data plane (port of
``fedtorch_tpu/native``; the port builds no C++ library)."""
from fedtorch_tpu_torch.native.host_pipeline import (
    HostPrefetcher, cyclic_pad_indices, gather_rows,
)

__all__ = ["HostPrefetcher", "cyclic_pad_indices", "gather_rows"]
