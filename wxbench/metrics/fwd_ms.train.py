"""Device-timeline ms per optimizer step inside the port's
``skyrim.train.forward`` span (``Trainer.loss``)."""

from wxbench.harness.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "finetune", "skyrim.train.forward")
