"""Device-timeline ms per forecast step inside the port's kernel spans,
``skyrim.K1`` to ``skyrim.K14`` (``ops/cost.py`` ``kernel``, outermost
calls only): each span's CUDA events at entry and exit."""

from wxbench.harness.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "forecast", "skyrim.K", prefix=True)
