"""Two intra-op threads for torch in each test process.

The suite runs under pytest-xdist, a process per worker, and torch's
OpenMP pool takes a thread per core in each of them: six workers on
eight cores keep 48 spinning threads. Six copies of one local-SGD test
side by side took 421 s each at torch's default thread count and 30 s
each at two threads, about as long as one takes alone. At one thread
the CPU convolutions sum in another order, in which some comparisons
with the JAX package fall outside bars measured at several threads; at
two they all hold. Every worker collects every test file, so a port
test file that imports this module pins the whole run; tests that
measure another thread count set it themselves and restore it.
"""
import contextlib

import torch

torch.set_num_threads(2)


@contextlib.contextmanager
def threads(n: int):
    """Torch at ``n`` threads inside the block, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
