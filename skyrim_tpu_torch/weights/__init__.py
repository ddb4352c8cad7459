from skyrim_tpu_torch.weights.registry import (  # noqa: F401
    checkpoint_dir,
    load_checkpoint,
    load_params,
    save_checkpoint,
)
