from skyrim_tpu_torch.core.model import GlobalModel  # noqa: F401
