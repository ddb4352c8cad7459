"""Visualization: rollout GIFs and point time series.

Parity with reference skyrim/libs/plotting/: ``generate_rollout_gif``
(generate_rollout_gif.py:16-105) renders per-step frames with a global
color scale (mean ± 3σ across the rollout) into an animated GIF;
``plot_wind_speed`` (plot_wind_speed.py:9-68) plots a point wind-speed
series from a rollout.  Without cartopy, projections are plain
equirectangular (the 0.25° grid's native projection); coastline
overlays are skipped.

The port's copy of skyrim_tpu/plotting.py; matplotlib and imageio are
imported inside the functions that draw, so the module imports without
them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from skyrim_tpu_torch.core.prediction import GlobalPredictionRollout
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.save import load_forecast
from skyrim_tpu_torch.utils.logging import logger


def _pyplot():
    """matplotlib's pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _load_steps(paths_or_fields: Sequence) -> list[Field]:
    return [
        f if isinstance(f, Field) else load_forecast(f) for f in paths_or_fields
    ]


def generate_rollout_gif(
    paths_or_fields: Sequence,
    channel: str = "t2m",
    output_path: str = "rollout.gif",
    fps: int = 2,
    cmap: str = "RdBu_r",
) -> str:
    """Per-step snapshots → animated GIF with a rollout-global color scale."""
    import imageio.v2 as imageio

    plt = _pyplot()
    steps = _load_steps(paths_or_fields)
    frames_data = [s.sel(channel=channel).isel(time=-1).data for s in steps]
    stack = np.stack(frames_data)
    vmid, vstd = float(np.nanmean(stack)), float(np.nanstd(stack))
    vmin, vmax = vmid - 3 * vstd, vmid + 3 * vstd

    images = []
    for i, (step, data) in enumerate(zip(steps, frames_data)):
        fig, ax = plt.subplots(figsize=(8, 4), dpi=90)
        lat = step.coords["lat"]
        lon = step.coords["lon"]
        im = ax.pcolormesh(lon, lat, data, vmin=vmin, vmax=vmax, cmap=cmap,
                           shading="auto")
        t = np.asarray(step.coords["time"])[-1]
        ax.set_title(f"{channel} @ {np.datetime_as_string(t, unit='h')}")
        fig.colorbar(im, ax=ax, shrink=0.8)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        images.append(buf)
        plt.close(fig)

    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    imageio.mimsave(output_path, images, fps=fps, loop=0)
    logger.success("wrote %s (%d frames)", output_path, len(images))
    return output_path


def visualize_rollout(
    paths_or_fields: Sequence,
    channels: Sequence[str] = ("t2m", "u10m"),
    output_dir: str = "plots",
) -> list[str]:
    """One GIF per channel (reference generate_rollout_gif.py:108-157)."""
    out = []
    for ch in channels:
        out.append(
            generate_rollout_gif(
                paths_or_fields, ch, str(Path(output_dir) / f"rollout_{ch}.gif")
            )
        )
    return out


def plot_wind_speed(
    rollout: GlobalPredictionRollout | Sequence,
    lat: float,
    lon: float,
    pressure_level: int | None = None,
    output_path: str | None = None,
):
    """Point wind-speed series across a rollout (reference
    plot_wind_speed.py:9-68)."""
    if not isinstance(rollout, GlobalPredictionRollout):
        rollout = GlobalPredictionRollout(list(rollout))
    speeds = rollout.wind_speed(lat, lon, pressure_level)
    times = rollout.time_points
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(8, 3), dpi=100)
    ax.plot(range(len(speeds)), speeds, marker="o")
    ax.set_xticks(range(len(times)))
    ax.set_xticklabels(
        [np.datetime_as_string(t, unit="h") for t in times], rotation=45, fontsize=7
    )
    level = f"{pressure_level} hPa" if pressure_level else "10 m"
    ax.set_ylabel("wind speed (m/s)")
    ax.set_title(f"{level} wind at ({lat:.2f}, {lon:.2f})")
    fig.tight_layout()
    if output_path:
        fig.savefig(output_path)
        plt.close(fig)
        return output_path
    return fig
