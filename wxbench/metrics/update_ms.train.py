"""Host-clock ms per optimizer step of ``Trainer.update`` (the global-norm
clip and AdamW), the device synchronised before and after."""

TRAINER = "skyrim_tpu_torch.finetune.trainer"
SPANS = [(TRAINER, "Trainer.loss", "loss"), (TRAINER, "Trainer.update", "update", "timed")]


def read(run):
    t = run.counters.get("update_s")
    return 1e3 * sum(t) / len(t) if t else None
