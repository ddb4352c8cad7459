"""100 × (1 − the union of the device events' intervals over the traced
window's wall time), from the profiler's device events."""

from wxbench.harness.metric_util import idle_pct


def read(run):
    return idle_pct(run, "forecast")
