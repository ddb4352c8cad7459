"""GlobalModel — the user-facing model adapter (port of skyrim_tpu/core/model.py).

Builds the model, its parameters (``weights.load_params``: a saved
checkpoint, a staged torch file, or a seeded random init) and its IC
source, then ``predict_one_step`` / ``forecast`` / ``rollout`` with
per-step persistence; the IC-source label switches to "file" after the
first step.  The compute runs through the rollout engine on the model's
device (the card by default): state stays there and only per-step
outputs stream to the host.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from skyrim_tpu_torch.core.prediction import GlobalPrediction
from skyrim_tpu_torch.data import get_data_source
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.save import SaveConfig, save_forecast
from skyrim_tpu_torch.models import MODELS
from skyrim_tpu_torch.rollout import (
    initial_condition_from_field,
    outputs_to_field,
    stream_rollout,
)
from skyrim_tpu_torch.utils.logging import logger
from skyrim_tpu_torch.weights import load_params


def adjust_lead_time(lead_time: int, time_step_hours: int = 6) -> int:
    """Floor to a multiple of the model step."""
    return (lead_time // time_step_hours) * time_step_hours


class GlobalModel:
    """``params``: the port's parameters (``model.init_params`` or
    ``params.from_jax``); without them ``weights.load_params`` takes the
    saved checkpoint, then a staged torch file, then a random init drawn
    from ``seed`` and logged."""

    def __init__(
        self,
        model_name: str,
        ic_source: str = "gfs",
        model_kwargs: dict | None = None,
        params=None,
        seed: int = 0,
        device="cuda",
    ):
        if model_name not in MODELS:
            raise KeyError(f"unknown model {model_name!r}; ported: {sorted(MODELS)}")
        self.model_name = model_name
        self.ic_source = ic_source
        self.model = MODELS[model_name](**(model_kwargs or {}), device=device)
        self.params = params if params is not None else load_params(self.model, seed)
        self.data_source = get_data_source(
            self.model.in_channel_names, ic_source, grid=self.model.grid
        )

    def release_model(self):
        """Drop the parameters and give their device memory back to the
        card (PyTorch's caching allocator keeps freed blocks otherwise)."""
        self.params = None
        if self.model.device.type == "cuda":
            torch.cuda.empty_cache()

    @property
    def time_step(self) -> datetime.timedelta:
        return self.model.time_step

    @property
    def in_channel_names(self) -> list[str]:
        return self.model.in_channel_names

    @property
    def out_channel_names(self) -> list[str]:
        return self.model.out_channel_names

    def _initial_state(self, start_time, initial_condition=None):
        if initial_condition is None:
            ic_field = self.data_source.fetch(
                start_time, self.model.n_history, self.model.time_step
            )
        elif isinstance(initial_condition, Field):
            ic_field = initial_condition
        elif isinstance(initial_condition, str):
            ic_field = GlobalPrediction(initial_condition).prediction
        else:
            ic_field = None
        if ic_field is not None:
            x0 = initial_condition_from_field(self.model, ic_field)
        else:
            x0 = np.asarray(initial_condition, np.float32)
        state = self.model.init_state(self.params, x0, start_time=start_time)
        return state, x0

    def predict_one_step(self, start_time: datetime.datetime, initial_condition=None) -> Field:
        """One model step → Field with [IC, prediction] frames."""
        state, x0 = self._initial_state(start_time, initial_condition)
        frames = list(stream_rollout(self.model, self.params, state, self.model.frames_out))
        return outputs_to_field(self.model, np.stack(frames), start_time, include_ic=x0[-1])

    def forecast(
        self,
        start_time: datetime.datetime,
        n_steps: int = 4,
        channels: list[str] | None = None,
    ) -> Field:
        """n_steps autoregressive steps, all frames incl. the IC."""
        state, x0 = self._initial_state(start_time)
        frames = list(stream_rollout(self.model, self.params, state, n_steps))
        out = outputs_to_field(self.model, np.stack(frames), start_time, include_ic=x0[-1])
        if channels:
            out = out.sel(channel=channels)
        return out

    def rollout(
        self,
        start_time: datetime.datetime,
        n_steps: int = 3,
        save: bool = True,
        save_config: SaveConfig | dict | None = None,
    ) -> tuple[Field, list[str]]:
        """Step-at-a-time rollout persisting every step.  Returns (final
        prediction Field, saved paths)."""
        if isinstance(save_config, dict):
            save_config = SaveConfig(**save_config)
        save_config = save_config or SaveConfig()

        state, _ = self._initial_state(start_time)
        source = self.ic_source
        output_paths: list[str] = []
        pred_field: Field | None = None
        t = start_time
        for frame in stream_rollout(self.model, self.params, state, n_steps):
            pred_time = t + self.model.time_step
            pred_field = Field.from_canonical(
                frame[None], [pred_time], self.model.channels,
                self.model.grid.lat, self.model.grid.lon,
                attrs={"model": self.model_name},
            )
            if save:
                output_paths.append(
                    save_forecast(pred_field, self.model_name, t, pred_time, source, save_config)
                )
            t, source = pred_time, "file"
            logger.success("rollout step %s → %s", t - self.model.time_step, pred_time)
        return pred_field, output_paths
