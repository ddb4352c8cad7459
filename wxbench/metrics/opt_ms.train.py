"""Device-timeline ms per optimizer step inside the port's
``skyrim.train.update`` span (``Trainer.update``: the clip, AdamW and
``zero_grad``); gaps between its launches count."""

from wxbench.harness.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "finetune", "skyrim.train.update")
