from skyrim_tpu_torch.io.netcdf import read_netcdf, write_netcdf  # noqa: F401
from skyrim_tpu_torch.io.save import (  # noqa: F401
    SaveConfig,
    generate_filename,
    generate_forecast_id,
    load_forecast,
    read_forecast,
    save_forecast,
    stream_save_forecast,
)
from skyrim_tpu_torch.io.zarrlite import ZarrStore, read_zarr, write_zarr  # noqa: F401
