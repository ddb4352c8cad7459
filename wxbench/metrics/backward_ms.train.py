"""Device ms per optimizer step of the kernels launched neither under the
span around ``Trainer.loss`` (the forward) nor under the span around
``Trainer.update`` (clip and AdamW): the backward, remat's recompute in it."""

TRAINER = "skyrim_tpu_torch.finetune.trainer"
SPANS = [(TRAINER, "Trainer.loss", "loss"), (TRAINER, "Trainer.update", "update", "timed")]


def read(run):
    if run.profile is None or not run.steps or run.traffic["kind"] != "finetune":
        return None
    back = sum(s for label, s in run.profile.kernel_s.items() if label not in ("loss", "update"))
    return 1e3 * back / run.steps
