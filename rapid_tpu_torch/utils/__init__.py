"""Host-side helpers of the port (copies of what it needs from
``rapid_tpu/utils``), with the engine observability tier's names exported
here: health, clock, flight recorder, exposition, build and memory capture,
and the profiler hooks. They load on first use: the engine's own modules
import ``utils`` submodules while the engine is still being imported."""

import importlib

_EXPORTS = {
    "NodeHealth": "health",
    "aggregate_health": "health",
    "parse_health": "health",
    "CancelHandle": "clock",
    "Clock": "clock",
    "ManualClock": "clock",
    "AsyncioClock": "clock",
    "NodeClock": "clock",
    "EventName": "flight_recorder",
    "FlightEvent": "flight_recorder",
    "FlightRecorder": "flight_recorder",
    "mint_trace_id": "flight_recorder",
    "metric_names": "exposition",
    "prometheus_text": "exposition",
    "snapshot_json": "exposition",
    "CompileDelta": "engine_telemetry",
    "compile_snapshot": "engine_telemetry",
    "compiled_memory_analysis": "engine_telemetry",
    "device_memory_snapshot": "engine_telemetry",
    "trace_recorder_snapshot": "engine_telemetry",
    "annotate": "profiling",
    "trace": "profiling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'rapid_tpu_torch.utils' has no attribute {name!r}")
    return getattr(importlib.import_module(f"rapid_tpu_torch.utils.{module}"), name)
