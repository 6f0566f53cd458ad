"""Hand-written Hopper kernels (sources in ``fedtorch_tpu_torch/csrc``)
with their plain PyTorch versions and launch counters."""
