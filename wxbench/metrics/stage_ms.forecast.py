"""Host ms per forecast step inside the port's ``skyrim.rollout.stage``
span (``rollout.stream_rollout``): the pinned host buffer allocated and
the output's side-stream copy issued."""

from wxbench.harness.program_spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "forecast", "skyrim.rollout.stage")
