"""Host ms per optimizer step inside the port's ``skyrim.train.upload``
span (``Trainer.train_step``: the (IC, target) pair's copies to the
device; a pageable copy holds the host until it is done)."""

from wxbench.harness.program_spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "finetune", "skyrim.train.upload")
