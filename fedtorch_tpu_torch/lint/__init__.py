"""fedtorch_tpu_torch.lint — static analysis of the PyTorch/CUDA port
(port of ``fedtorch_tpu/lint``; README, "Static analysis and
observability").

* ``analyzer`` (FTL rules): host syncs, branches on tensors and draws
  from torch's global generator in the round's hot functions, the
  port's worst silent failure class: the round is host-bound, and a
  sync in it idles the card. Its runtime half is
  ``fedtorch_tpu_torch.utils.tracing.SyncSentinel``.
* ``concurrency_audit`` (FTH rules): lock-order cycles and thread
  hazards of the host plane; its runtime half is
  ``fedtorch_tpu_torch.utils.lock_sentinel.LockOrderSentinel``.
* ``registry_audit`` (FTC rules): drift between the port's hand-kept
  registries and their sources.

The JAX package's program audit (FTP rules) lowers XLA programs and has
no port; ``rules.PROGRAM_RULES`` names the runtime check that stands for
each rule. Stdlib-only: importing this package pulls in no torch.
"""
from fedtorch_tpu_torch.lint.analyzer import (  # noqa: F401
    ModuleAnalysis, analyze_paths, analyze_source,
)
from fedtorch_tpu_torch.lint.concurrency_audit import (  # noqa: F401
    analyze_concurrency_source, audit_concurrency_paths,
    concurrency_gate, split_hard_findings,
)
from fedtorch_tpu_torch.lint.findings import (  # noqa: F401
    Finding, diff_against_baseline, load_baseline, save_baseline,
)
from fedtorch_tpu_torch.lint.registry_audit import (  # noqa: F401
    audit_registries,
)
from fedtorch_tpu_torch.lint.rules import (  # noqa: F401
    ALL_RULES, CONCURRENCY_RULES, NO_TORCH_MEANING, PROGRAM_RULES,
    REGISTRY_RULES, RULES,
)
