"""Host ms per forecast step inside the port's ``skyrim.model.advance``
span (``rollout.stream_rollout``, around ``model.advance``): the host's
time to enqueue one step."""

from wxbench.harness.program_spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "forecast", "skyrim.model.advance")
