from skyrim_tpu_torch.utils.logging import logger  # noqa: F401
from skyrim_tpu_torch.utils.timing import Timer, timeit  # noqa: F401
