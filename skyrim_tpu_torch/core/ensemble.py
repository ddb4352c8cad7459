"""Multi-model ensemble (port of skyrim_tpu/core/ensemble.py).

Runs each member's rollout and averages over the intersection of their
output channels.  ``rollout`` has ``GlobalModel.rollout``'s signature,
saves each member under ``<forecast_id>/<member>`` and the mean under
``<forecast_id>/mean``, and its path bookkeeping holds with
``save=False``; ``time_step`` comes from the members, and members of
different cadences are refused.

Members run in turn on the one device.  After each member its parameters
are dropped and their memory given back to the card
(``GlobalModel.release_model``), so the ensemble's peak is its largest
member's, not the sum of them; parameters the caller hands over in
``params`` stay alive in the caller's dict.  IC-perturbation ensembles
are in ``core/ic_ensemble.py``.
"""

from __future__ import annotations

import datetime

from skyrim_tpu_torch.core.model import GlobalModel
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.save import SaveConfig, save_forecast
from skyrim_tpu_torch.utils.logging import logger


class GlobalEnsemble:
    """``params``: the port's parameters of some members, a dict keyed by
    member name (a member not in it takes ``weights.load_params``);
    ``kwargs`` go to every member's ``GlobalModel`` (``model_kwargs``,
    ``seed``, ``device``: the card unless the caller asks for the CPU)."""

    def __init__(self, model_names: list[str], ic_source: str = "gfs", params: dict | None = None, **kwargs):
        self.model_names = list(model_names)
        self.ic_source = ic_source
        self._params = dict(params or {})
        unknown = set(self._params) - set(self.model_names)
        if unknown:
            raise ValueError(f"params given for {sorted(unknown)}, which are not members {self.model_names}")
        self._model_kwargs = kwargs
        self.model_name = "ensemble[" + ",".join(sorted(self.model_names)) + "]"
        self._common_channels: list[str] | None = None
        self._time_step: datetime.timedelta | None = None

    @property
    def time_step(self) -> datetime.timedelta:
        """The members' common cadence; mixed-cadence ensembles are refused."""
        if self._time_step is None:
            from skyrim_tpu_torch.models import MODELS

            # the class attribute: building a member would build its tables
            steps = {n: MODELS[n].time_step for n in self.model_names}
            if len(set(steps.values())) > 1:
                raise ValueError(
                    f"ensemble members disagree on time_step: { {k: str(v) for k, v in steps.items()} }"
                )
            self._time_step = next(iter(steps.values()))
        return self._time_step

    def _run_member(self, name: str, fn):
        """Instantiate a member, run fn(member), release its parameters."""
        member = GlobalModel(name, ic_source=self.ic_source, params=self._params.get(name), **self._model_kwargs)
        if self._time_step is None:
            self._time_step = member.time_step
        elif member.time_step != self._time_step:
            raise ValueError(f"ensemble member {name} steps {member.time_step}, earlier members step {self._time_step}")
        chans = set(member.out_channel_names)
        self._common_channels = (
            sorted(chans) if self._common_channels is None else sorted(set(self._common_channels) & chans)
        )
        try:
            return fn(member)
        finally:
            member.release_model()

    def _ensemble_mean(self, fields: list[Field]) -> Field:
        common = self._common_channels or []
        aligned = [f.sel(channel=common) for f in fields]
        return Field.concat(aligned, "model").mean("model")

    def forecast(
        self,
        start_time: datetime.datetime,
        n_steps: int = 4,
        channels: list[str] | None = None,
    ) -> Field:
        preds = [self._run_member(n, lambda m: m.forecast(start_time, n_steps)) for n in self.model_names]
        out = self._ensemble_mean(preds)
        return out.sel(channel=channels) if channels else out

    def rollout(
        self,
        start_time: datetime.datetime,
        n_steps: int = 3,
        save: bool = True,
        save_config: SaveConfig | dict | None = None,
    ) -> tuple[Field, list[str]]:
        """Each member's ``GlobalModel.rollout``, then the mean of their
        finals.  Returns (the mean Field, the members' saved paths then the
        mean's)."""
        if isinstance(save_config, dict):
            save_config = SaveConfig(**save_config)
        save_config = save_config or SaveConfig()

        member_finals: list[Field] = []
        output_paths: list[str] = []
        for name in self.model_names:
            cfg = SaveConfig(**{**save_config.__dict__, "forecast_id": f"{save_config.forecast_id}/{name}"})
            final, paths = self._run_member(name, lambda m: m.rollout(start_time, n_steps, save, cfg))
            member_finals.append(final)
            output_paths += paths
            logger.success("ensemble member %s done (%d steps)", name, n_steps)

        ens_final = self._ensemble_mean(member_finals)
        if save:
            pred_time = start_time + n_steps * self.time_step
            mean_cfg = SaveConfig(**{**save_config.__dict__, "forecast_id": f"{save_config.forecast_id}/mean"})
            output_paths.append(
                save_forecast(ens_final, self.model_name, start_time, pred_time, self.ic_source, mean_cfg)
            )
        return ens_final, output_paths
