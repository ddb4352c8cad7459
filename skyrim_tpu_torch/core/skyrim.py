"""Skyrim facade (port of skyrim_tpu/core/skyrim.py).

``Skyrim("pangu")`` builds a ``GlobalModel``; ``Skyrim("pangu", "dlwp")``
a ``GlobalEnsemble``, the members run in turn and averaged over the
channels they share.  ``predict`` parses YYYYMMDD/HHMM, floors the lead
time to the model step, and returns a GlobalPrediction plus the saved
paths.
"""

from __future__ import annotations

import datetime

from skyrim_tpu_torch.core.ensemble import GlobalEnsemble
from skyrim_tpu_torch.core.model import GlobalModel, adjust_lead_time
from skyrim_tpu_torch.core.prediction import GlobalPrediction
from skyrim_tpu_torch.io.save import SaveConfig
from skyrim_tpu_torch.models import MODELS
from skyrim_tpu_torch.utils.logging import logger


class Skyrim:
    """``kwargs`` go to ``GlobalModel`` (``model_kwargs``, ``params``,
    ``seed``, ``device``: the card unless the caller asks for the CPU), or
    for several names to ``GlobalEnsemble`` (there ``params`` a dict keyed
    by member name)."""

    def __init__(self, *model_names: str, ic_source: str = "gfs", **kwargs):
        if not model_names:
            raise ValueError("at least one model name is required")
        bad = [m for m in model_names if m not in MODELS]
        if bad:
            raise ValueError(f"invalid model(s) {bad}; available: {self.list_available_models()}")
        if len(model_names) > 1:
            self.model = GlobalEnsemble(list(model_names), ic_source=ic_source, **kwargs)
        else:
            self.model = GlobalModel(model_names[0], ic_source=ic_source, **kwargs)
        self.model_names = list(model_names)
        self.ic_source = ic_source

    @classmethod
    def list_available_models(cls) -> list[str]:
        return list(MODELS)

    def forecast(self, start_time: datetime.datetime, n_steps: int = 4, channels: list[str] | None = None):
        return self.model.forecast(start_time, n_steps, channels=channels)

    def predict(
        self,
        date: str,  # YYYYMMDD
        time: str = "0000",  # HHMM
        lead_time: int = 6,  # hours
        save: bool = False,
        save_config: SaveConfig | dict | None = None,
    ) -> tuple[GlobalPrediction, list[str]]:
        start_time = datetime.datetime(int(date[:4]), int(date[4:6]), int(date[6:8]), int(time[:2]), int(time[2:4]))
        step_h = int(self.model.time_step.total_seconds() // 3600)
        adjusted = adjust_lead_time(lead_time, step_h)
        if adjusted != lead_time:
            logger.warning("lead_time %dh floored to %dh (step %dh)", lead_time, adjusted, step_h)
        n_steps = max(adjusted // step_h, 1)
        logger.info("predict %s start=%s lead=%dh (%d steps)", self.model_names, start_time, adjusted, n_steps)
        final, paths = self.model.rollout(start_time, n_steps=n_steps, save=save, save_config=save_config)
        return GlobalPrediction(final), paths
