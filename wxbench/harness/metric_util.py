"""Arithmetic that several metric readers share."""

from __future__ import annotations

from wxbench.harness.counts import bound_s


def roof_pct(run, labels) -> float | None:
    """Σ bound of the calls spanned as ``labels`` over the device time of the
    kernels launched under those spans, in %; None where nothing ran."""
    if run.profile is None:
        return None
    calls = [c for label in labels for c in run.calls.get(label, ()) if c is not None]
    device_s = sum(run.profile.kernel_s.get(label, 0.0) for label in labels)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in calls) / device_s


def idle_pct(run, kind: str) -> float | None:
    if run.profile is None or run.traffic["kind"] != kind or run.device == "cpu":
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
