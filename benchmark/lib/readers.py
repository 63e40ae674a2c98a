"""What the per-layer metrics read, and the reading each does.

A driver's traced run hands ``benchmark/metrics/<metric>.py``'s ``read`` a
dict ``data``:
- ``spans_ms``: device milliseconds per iteration by phase ('d', 'd_reg',
  'g', 'g_reg', 'ema'), from CUDA events at the phase boundaries of the
  timed window (training);
- ``trace``: the profiled cadence's ``trace.Trace`` and ``units``, the
  iterations or batches in it;
- ``rate``: the window's iterations or images per second, ``flop_per_unit``
  the model FLOPs of one, ``peak_tflops`` and ``chips`` the peak they are
  held to, ``peak_bytes`` the run's largest device-memory peak over the
  ranks, ``unit_images`` the images one batch holds (inference).
A reading that finds nothing to read returns None and the metric is left
out of the line; a share is never returned as 0 for want of data.
"""

from __future__ import annotations

from . import trace as trace_lib
from .flops import HBM_BYTES_PER_S

CONV = ("cuDNN convolution",)
ELTWISE = ("elementwise", "copies", "reductions")


def from_trace(trace, units: int) -> dict:
    """The profiled window's figures every reader shares: the device's busy
    seconds (the union over streams) and the traced window, from its first
    device event's start to its last one's end."""
    busy_s = trace_lib.busy_union(trace.device) * 1e-6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in trace.device]
    window_s = (max(b for _, b in spans) - min(a for a, _ in spans)) * 1e-6 if spans else 0.0
    return {"trace": trace, "units": units, "busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": trace_lib.top_device_ops(trace),
                          "idle_gaps": trace_lib.idle_gaps(trace)}}


def phase_ms(data, phases) -> float | None:
    spans = data.get("spans_ms")
    if not spans or not any(p in spans for p in phases):
        return None
    return sum(spans.get(p, 0.0) for p in phases)


def category_ms(data, categories) -> float | None:
    """Device ms per unit of the trace's events of ``categories``."""
    trace = data.get("trace")
    if trace is None or not trace.device:
        return None
    return trace_lib.category_us(trace, categories) / 1e3 / data["units"]


def roofline(data, categories) -> float | None:
    trace = data.get("trace")
    if trace is None:
        return None
    return trace_lib.roofline_percent(trace, categories, HBM_BYTES_PER_S)


def idle_percent(data) -> float | None:
    """100 x (1 - device busy seconds per unit x the window's units per
    second)."""
    if data.get("trace") is None or not data["busy_s"]:
        return None
    return 100.0 * (1.0 - data["busy_s"] / data["units"] * data["rate"])


def mfu_percent(data) -> float | None:
    """100 x model FLOPs per second over the chips' dense peak."""
    if not data.get("rate"):
        return None
    return 100.0 * data["flop_per_unit"] * data["rate"] / (
        data["peak_tflops"] * 1e12 * data["chips"])


def peak_gb(data) -> float | None:
    return data["peak_bytes"] / 1e9 if data.get("peak_bytes") else None
