"""The IC's bytes over the host seconds of the port's
``skyrim.init_state.upload`` span (``models/base.py`` ``init_state``, the
pageable copy to the device), summed over the window's forecasts, in
GB/s."""

from wxbench.harness.program_spans import gbps


def read(run):
    return gbps(run, "forecast", "skyrim.init_state.upload")
