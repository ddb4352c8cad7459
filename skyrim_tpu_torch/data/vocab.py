"""Provider vocabularies: canonical channel → provider-native GRIB keys.

Every provider names fields differently; these tables coerce provider
naming into the canonical channel vocabulary, exactly mirroring the
reference's Vocabulary classes:

- GFS:  ``PARAM::level`` NOAA keys, HGT×9.81 → geopotential
  (reference skyrim/libs/nwp/gfs.py:38-149)
- IFS:  ``param::levtype::level`` ECMWF open-data keys, gh×9.81 → z
  (reference skyrim/libs/nwp/ifs.py:27-106)
- ENS:  same keys, reduced 9-level set (reference ens.py:64-97)
- CDS:  ``dataset::variable::level`` ERA5 keys (reference
  skyrim/libs/benchmark/cds.py:41-149, core/consts.py)

The port's copy of skyrim_tpu/data/vocab.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from skyrim_tpu_torch.channels import LEVELS_13, LEVELS_9

GRAVITY = 9.81  # the reference uses 9.81 for gh→z (gfs.py:147, ifs.py:104)


@dataclass(frozen=True)
class VocabEntry:
    channel: str
    provider_id: str
    levtype: str  # "sfc" | "pl" | provider-specific level string
    level: str  # "" for surface
    scale: float = 1.0  # multiplier applied after decode (e.g. gh→z)

    @property
    def modifier(self) -> Callable:
        s = self.scale
        return (lambda x: x * s) if s != 1.0 else (lambda x: x)


class Vocabulary:
    """channel → VocabEntry mapping with dict-like access."""

    def __init__(self, entries: dict[str, VocabEntry]):
        self.VOCAB = entries

    def __getitem__(self, channel: str) -> VocabEntry:
        return self.VOCAB[channel]

    def __contains__(self, channel: str) -> bool:
        return channel in self.VOCAB

    def __len__(self) -> int:
        return len(self.VOCAB)

    def get(self, channel: str) -> VocabEntry:
        return self.VOCAB[channel]

    @property
    def channels(self) -> list[str]:
        return list(self.VOCAB)


# ---------------------------------------------------------------------------
# GFS (NOAA) — keys "PARAM::level-description"
# ---------------------------------------------------------------------------

_GFS_SURFACE = {
    "u10m": ("UGRD", "10 m above ground"),
    "v10m": ("VGRD", "10 m above ground"),
    "u100m": ("UGRD", "100 m above ground"),
    "v100m": ("VGRD", "100 m above ground"),
    "t2m": ("TMP", "2 m above ground"),
    "sp": ("PRES", "surface"),
    "msl": ("PRMSL", "mean sea level"),
    "tcwv": ("PWAT", "entire atmosphere (considered as a single layer)"),
}
_GFS_LEVEL_IDS = {"u": "UGRD", "v": "VGRD", "z": "HGT", "t": "TMP", "r": "RH", "q": "SPFH"}


def _build_gfs() -> Vocabulary:
    entries = {
        ch: VocabEntry(ch, pid, lvl, "")
        for ch, (pid, lvl) in _GFS_SURFACE.items()
    }
    for var, pid in _GFS_LEVEL_IDS.items():
        for level in LEVELS_13:
            ch = f"{var}{level}"
            entries[ch] = VocabEntry(
                ch, pid, f"{level} mb", str(level),
                scale=GRAVITY if var == "z" else 1.0,
            )
    return Vocabulary(entries)


# ---------------------------------------------------------------------------
# IFS / ENS (ECMWF open data) — keys "param::levtype::level"
# ---------------------------------------------------------------------------

_ECMWF_SURFACE = {
    "u10m": "10u", "v10m": "10v", "u100m": "100u", "v100m": "100v",
    "t2m": "2t", "sp": "sp", "msl": "msl", "tcwv": "tcwv", "tp": "tp",
}  # fmt: skip
_ECMWF_LEVEL_IDS = {"u": "u", "v": "v", "z": "gh", "t": "t", "r": "r", "q": "q"}


def _build_ecmwf(levels) -> Vocabulary:
    entries = {
        ch: VocabEntry(ch, pid, "sfc", "") for ch, pid in _ECMWF_SURFACE.items()
    }
    for var, pid in _ECMWF_LEVEL_IDS.items():
        for level in levels:
            ch = f"{var}{level}"
            entries[ch] = VocabEntry(
                ch, pid, "pl", str(level),
                scale=GRAVITY if var == "z" else 1.0,
            )
    return Vocabulary(entries)


# ---------------------------------------------------------------------------
# CDS / ERA5 — keys "dataset::variable::level"
# ---------------------------------------------------------------------------

_CDS_SINGLE = {
    "u10m": "10m_u_component_of_wind",
    "v10m": "10m_v_component_of_wind",
    "u100m": "100m_u_component_of_wind",
    "v100m": "100m_v_component_of_wind",
    "t2m": "2m_temperature",
    "sp": "surface_pressure",
    "msl": "mean_sea_level_pressure",
    "tcwv": "total_column_water_vapour",
    "tp": "total_precipitation",
    "fg10m": "10m_wind_gust_since_previous_post_processing",
    "lsm": "land_sea_mask",
}
_CDS_PRESSURE = {
    "z": "geopotential",
    "t": "temperature",
    "u": "u_component_of_wind",
    "v": "v_component_of_wind",
    "q": "specific_humidity",
    "r": "relative_humidity",
}
CDS_SINGLE_DATASET = "reanalysis-era5-single-levels"
CDS_PRESSURE_DATASET = "reanalysis-era5-pressure-levels"


def _build_cds() -> Vocabulary:
    entries = {
        ch: VocabEntry(ch, name, CDS_SINGLE_DATASET, "")
        for ch, name in _CDS_SINGLE.items()
    }
    for var, name in _CDS_PRESSURE.items():
        for level in LEVELS_13:
            ch = f"{var}{level}"
            entries[ch] = VocabEntry(ch, name, CDS_PRESSURE_DATASET, str(level))
    return Vocabulary(entries)


GFS_VOCAB = _build_gfs()
IFS_VOCAB = _build_ecmwf(LEVELS_13)
ENS_VOCAB = _build_ecmwf(LEVELS_9)
CDS_VOCAB = _build_cds()
