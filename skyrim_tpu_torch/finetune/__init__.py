"""Finetuning (port of skyrim_tpu/finetune): ``FineTuneDataset`` over the
CDS dataset-factory layout and ``Trainer``/``TrainConfig``."""

from skyrim_tpu_torch.finetune.dataset import FineTuneDataset  # noqa: F401
from skyrim_tpu_torch.finetune.trainer import TrainConfig, Trainer  # noqa: F401
