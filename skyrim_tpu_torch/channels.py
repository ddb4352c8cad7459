"""Canonical channel vocabulary (the port's own copy of skyrim_tpu/channels.py).

Every forecast and initial condition flows as a
``(time, channel, lat, lon)`` array with channels named by the compact
vocabulary the reference established (``u10m``, ``t2m``, ``z500``, ...);
see SURVEY.md §1 "canonical data contract" and the per-model channel
lists in reference skyrim/core/models/{pangu,fourcastnet,...}.py.

A channel name is either a surface variable (``u10m``, ``msl``, ``tp06``)
or ``{var}{pressure_level_hPa}`` for the atmospheric variables
z/q/t/u/v/w/r.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# The canonical 13 pressure levels (hPa), descending pressure = ascending
# altitude (reference skyrim/core/consts.py:24-27).
LEVELS_13 = (1000, 925, 850, 700, 600, 500, 400, 300, 250, 200, 150, 100, 50)
# Reduced 9-level set used by the ENS product (reference skyrim/libs/nwp/ens.py:64-97).
LEVELS_9 = (1000, 925, 850, 700, 500, 300, 250, 200, 50)

#: Atmospheric (pressure-level) variable codes.
LEVEL_VARS = {
    "z": "geopotential",
    "q": "specific_humidity",
    "t": "temperature",
    "u": "u_component_of_wind",
    "v": "v_component_of_wind",
    "w": "vertical_velocity",
    "r": "relative_humidity",
}

#: Surface / single-level variable codes.
SURFACE_VARS = {
    "u10m": "10m_u_component_of_wind",
    "v10m": "10m_v_component_of_wind",
    "u100m": "100m_u_component_of_wind",
    "v100m": "100m_v_component_of_wind",
    "t2m": "2m_temperature",
    "d2m": "2m_dewpoint_temperature",
    "sp": "surface_pressure",
    "msl": "mean_sea_level_pressure",
    "tcwv": "total_column_water_vapour",
    "tp": "total_precipitation",
    "tp06": "total_precipitation_6hr",
    "ssrd": "surface_solar_radiation_downwards",
    "tisr": "toa_incident_solar_radiation",
    "lsm": "land_sea_mask",
    "zs": "surface_geopotential",
}


@dataclass(frozen=True)
class Channel:
    """Parsed channel: a variable code plus an optional pressure level."""

    var: str
    level: int | None = None

    @property
    def name(self) -> str:
        return self.var if self.level is None else f"{self.var}{self.level}"

    @property
    def is_surface(self) -> bool:
        return self.level is None


def parse_channel(name: str) -> Channel:
    """Parse ``"z500"`` → Channel("z", 500); ``"u10m"`` → Channel("u10m")."""
    if name in SURFACE_VARS:
        return Channel(name)
    for var in LEVEL_VARS:
        if name.startswith(var) and name[len(var) :].isdigit():
            level = int(name[len(var) :])
            return Channel(var, level)
    raise ValueError(f"unknown channel name: {name!r}")


def level_channels(variables: Sequence[str], levels: Sequence[int]) -> list[str]:
    """Names for the cross product var × level, var-major."""
    return [f"{v}{l}" for v in variables for l in levels]


def validate_channels(names: Sequence[str]) -> list[Channel]:
    return [parse_channel(n) for n in names]


# ---------------------------------------------------------------------------
# Per-model channel sets (parity with the reference's adapter docstrings).
# ---------------------------------------------------------------------------

#: Pangu-Weather: z,q,t,u,v × 13 levels (descending pressure) + 4 surface.
#: 69 channels (reference skyrim/core/models/pangu.py:6-13).
PANGU = tuple(level_channels(["z", "q", "t", "u", "v"], LEVELS_13)) + (
    "msl",
    "u10m",
    "v10m",
    "t2m",
)

#: FourCastNet v1 (AFNO): 26 channels in modulus ordering
#: (reference skyrim/core/models/fourcastnet.py:8-10).
FCN = (
    "u10m", "v10m", "t2m", "sp", "msl", "t850", "u1000", "v1000", "z1000",
    "u850", "v850", "z850", "u500", "v500", "z500", "t500", "z50", "r500",
    "r850", "tcwv", "u100m", "v100m", "u250", "v250", "z250", "t250",
)  # fmt: skip

_LEVELS_ASC = tuple(sorted(LEVELS_13))  # 50 → 1000

#: FourCastNet v2 small (SFNO): 8 surface + u,v,z,t,r × 13 ascending levels.
#: 73 channels (reference skyrim/core/models/fourcastnet_v2.py:12-20).
FCNV2 = (
    "u10m", "v10m", "u100m", "v100m", "t2m", "sp", "msl", "tcwv",
) + tuple(level_channels(["u", "v", "z", "t", "r"], _LEVELS_ASC))  # fmt: skip

#: DLWP: 7 channels (reference skyrim/core/models/dlwp.py:17).
DLWP = ("t850", "z1000", "z700", "z500", "z300", "tcwv", "t2m")

#: GraphCast operational: z,q,t,u,v,w × 13 ascending levels + 5 surface.
#: 83 channels (reference skyrim/core/models/graphcast.py:17-26).
GRAPHCAST = tuple(level_channels(["z", "q", "t", "u", "v", "w"], _LEVELS_ASC)) + (
    "u10m",
    "v10m",
    "t2m",
    "msl",
    "tp06",
)

#: FuXi: z,t,u,v,r × 13 ascending levels + 5 surface. 70 channels
#: (reference skyrim/core/models/fuxi.py:14-21).
FUXI = tuple(level_channels(["z", "t", "u", "v", "r"], _LEVELS_ASC)) + (
    "t2m",
    "u10m",
    "v10m",
    "msl",
    "tp",
)

#: FengWu: 4 surface + z,q,u,v,t × 13 ascending levels. 69 channels
#: (reference skyrim/core/models/fengwu.py:14-22).
FENGWU = ("u10m", "v10m", "t2m", "msl") + tuple(
    level_channels(["z", "q", "u", "v", "t"], _LEVELS_ASC)
)

CHANNEL_SETS: dict[str, tuple[str, ...]] = {
    "pangu": PANGU,
    "fourcastnet": FCN,
    "fourcastnet_v2": FCNV2,
    "dlwp": DLWP,
    "graphcast": GRAPHCAST,
    "fuxi": FUXI,
    "fengwu": FENGWU,
}


def channel_index(all_channels: Sequence[str], wanted: Sequence[str]) -> list[int]:
    """Positions of ``wanted`` channels within ``all_channels`` (strict)."""
    pos = {name: i for i, name in enumerate(all_channels)}
    missing = [w for w in wanted if w not in pos]
    if missing:
        raise KeyError(f"channels not present: {missing}")
    return [pos[w] for w in wanted]
