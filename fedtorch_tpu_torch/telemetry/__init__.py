"""Run telemetry (port of ``fedtorch_tpu/telemetry``): the writer half.

Three pillars, one subsystem, as in the JAX package:

* **Structured metrics/events** — schema-versioned ``metrics.jsonl`` /
  ``events.jsonl`` per run dir, populated exclusively from host-side
  values (the round loop's ONE batched scalar fetch plus host
  counters): zero added device syncs.
* **Host-span tracing** — ``telemetry.span("stream.gather", round=r)``
  records host phases into a Chrome trace-event ``trace.json``
  (Perfetto), with lanes for the CLI loop, the stream-feed producer,
  and the async checkpoint writer.
* **Machine-readable health** — the atomically-replaced
  ``health.json`` (round, intent, monotonic last-progress) consumed by
  the watchdog, the restart harness, and external monitors.

The files carry the JAX package's schema names, so its offline readers
(``python -m fedtorch_tpu.cli report <run dir>``, ``compare``,
``watch``) take a port run directory; the port does not import them.
The federation plane's observers sit beside the writer: the client
ledger (``ledger.py``), the anomaly detector (``anomaly.py``) and the
critical path's overlap gauge (``critical_path.py``).

The package is stdlib-only (no torch import): importing the hooks into
hot modules costs nothing.

Library-code usage (no Telemetry object in scope)::

    from fedtorch_tpu_torch import telemetry

    with telemetry.span("stream.gather", round=r):
        ...                      # no-op unless a run installed one
    telemetry.event("supervisor.rollback", round=r, attempt=a)
"""
from __future__ import annotations

from fedtorch_tpu_torch.telemetry.health import (  # noqa: F401
    HealthFile, health_path, read_health,
)
from fedtorch_tpu_torch.telemetry.metrics import JsonlWriter  # noqa: F401
from fedtorch_tpu_torch.telemetry.runtime import (  # noqa: F401
    LEVELS, Telemetry, get_active,
)
from fedtorch_tpu_torch.telemetry.schema import (  # noqa: F401
    EVENTS_SCHEMA, HEALTH_INTENTS, HEALTH_SCHEMA, METRICS_OPTIONAL,
    METRICS_REQUIRED, METRICS_SCHEMA, count_restarts, iter_jsonl,
    load_jsonl, read_header, stitch_rows, validate_health,
    validate_metrics_row,
)
from fedtorch_tpu_torch.telemetry.spans import (  # noqa: F401
    NULL_SPAN, SpanRecorder,
)


def span(name: str, **args):
    """Module-level span hook: records on the active run's recorder,
    or returns the shared no-op context when telemetry is off."""
    t = get_active()
    if t is None:
        return NULL_SPAN
    return t.span(name, **args)


def event(name: str, **fields) -> None:
    t = get_active()
    if t is not None:
        t.event(name, **fields)


def instant(name: str, **args) -> None:
    t = get_active()
    if t is not None:
        t.instant(name, **args)
