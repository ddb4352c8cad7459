"""Model registry of the port: the seven models of the JAX package."""

from skyrim_tpu_torch.models.afno import FourCastNetModel
from skyrim_tpu_torch.models.base import ModelState, PrognosticModel  # noqa: F401
from skyrim_tpu_torch.models.dlwp import DLWPModel
from skyrim_tpu_torch.models.fengwu import FengWuModel
from skyrim_tpu_torch.models.fuxi import FuXiModel
from skyrim_tpu_torch.models.graphcast import GraphCastModel
from skyrim_tpu_torch.models.pangu import PanguModel
from skyrim_tpu_torch.models.sfno import FourCastNetV2Model

MODELS = {"pangu": PanguModel, "graphcast": GraphCastModel, "fourcastnet_v2": FourCastNetV2Model, "fengwu": FengWuModel,
          "fuxi": FuXiModel, "fourcastnet": FourCastNetModel, "dlwp": DLWPModel}

# the JAX package's list, in its order
AVAILABLE_MODELS = ["pangu", "fourcastnet", "fourcastnet_v2", "dlwp", "graphcast", "fuxi", "fengwu"]
