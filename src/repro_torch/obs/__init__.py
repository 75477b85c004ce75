"""repro_torch.obs — overlap-proving trace and telemetry subsystem, a
copy of the JAX package's `repro/obs` (none of which imports jax), with
the same span names, event layout, trace schema and analysis, so traces
of the two packages compare one to one.

Always-compiled-in instrumentation for the activation-offload path:
a lock-light per-thread ring tracer (`repro_torch.obs.tracer`), a
Chrome/Perfetto exporter + validator (`repro_torch.obs.export`), and the
overlap analyzer that turns a trace window into I/O-hidden fraction and
stall attribution (`repro_torch.obs.overlap`).

Call sites use the module-level helpers (`span`/`instant`/`count`/
`gauge`), which are a None-check no-op until `enable()` installs a
tracer — usually via `TrainSession(trace=...)` or `--trace` of
`python -m repro_torch.launch.train` / `repro_torch.launch.serve`.
"""
from repro_torch.obs.tracer import (
    DEFAULT_RING_SIZE,
    Tracer,
    count,
    disable,
    enable,
    gauge,
    get_tracer,
    instant,
    is_enabled,
    span,
)
from repro_torch.obs.export import (trace_events, validate_trace,
                                    write_chrome_trace)
from repro_torch.obs.overlap import analyze, predicted_vs_measured

__all__ = [
    "DEFAULT_RING_SIZE",
    "Tracer",
    "analyze",
    "count",
    "disable",
    "enable",
    "gauge",
    "get_tracer",
    "instant",
    "is_enabled",
    "predicted_vs_measured",
    "span",
    "trace_events",
    "validate_trace",
    "write_chrome_trace",
]
