from skyrim_tpu_torch.io.netcdf import read_netcdf, write_netcdf  # noqa: F401
from skyrim_tpu_torch.io.save import (  # noqa: F401
    SaveConfig,
    generate_filename,
    generate_forecast_id,
    load_forecast,
    save_forecast,
)
