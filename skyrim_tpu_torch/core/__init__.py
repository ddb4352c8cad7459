from skyrim_tpu_torch.core.model import GlobalModel, adjust_lead_time  # noqa: F401
from skyrim_tpu_torch.core.ensemble import GlobalEnsemble  # noqa: F401
from skyrim_tpu_torch.core.prediction import GlobalPrediction, GlobalPredictionRollout  # noqa: F401
from skyrim_tpu_torch.core.skyrim import Skyrim  # noqa: F401
