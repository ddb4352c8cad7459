"""The pairs' bytes over the host seconds of the port's
``skyrim.train.upload`` span, summed over the window's steps, in GB/s."""

from wxbench.harness.program_spans import gbps


def read(run):
    return gbps(run, "finetune", "skyrim.train.upload")
