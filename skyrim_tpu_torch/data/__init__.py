from skyrim_tpu_torch.data.ic import (  # noqa: F401
    FileSource,
    ICSource,
    SyntheticSource,
    get_data_source,
    get_ic,
)
