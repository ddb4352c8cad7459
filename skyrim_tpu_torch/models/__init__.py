"""Model registry of the port: only ported models are listed."""

from skyrim_tpu_torch.models.base import ModelState, PrognosticModel  # noqa: F401
from skyrim_tpu_torch.models.graphcast import GraphCastModel
from skyrim_tpu_torch.models.pangu import PanguModel

MODELS = {"pangu": PanguModel, "graphcast": GraphCastModel}
