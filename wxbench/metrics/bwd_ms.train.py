"""Device-timeline ms per optimizer step inside the port's
``skyrim.train.backward`` span (``loss.backward()``, remat's recompute in
it)."""

from wxbench.harness.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "finetune", "skyrim.train.backward")
