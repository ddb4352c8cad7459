"""GRIB ``.idx`` sidecar parsing for byte-range fetches.

NOAA publishes an index per GRIB file:
``msg:offset:d=YYYYMMDDHH:PARAM:level:forecast:``.  Parsing it lets a
client fetch single messages by HTTP/S3 byte range instead of the
multi-GB file (reference skyrim/libs/nwp/gfs.py:501-567).

The port's copy of skyrim_tpu/data/idx.py.
"""

from __future__ import annotations

from dataclasses import dataclass

#: safety cap on a single byte-range request (reference gfs.py:175)
MAX_BYTE_SIZE = 5_000_000


@dataclass(frozen=True)
class IdxEntry:
    param: str
    level: str
    offset: int
    length: int | None  # None = last message (read to EOF)
    forecast: str = ""


def parse_idx(text: str) -> dict[tuple[str, str], IdxEntry]:
    """Parse idx text into {(PARAM, level): IdxEntry}.

    Duplicate (param, level) keys keep the first occurrence, matching
    NOAA ordering semantics (reference gfs.py:539-547).
    """
    rows = []
    for line in text.strip().splitlines():
        parts = line.split(":")
        if len(parts) < 6:
            continue
        try:
            offset = int(parts[1])
        except ValueError:
            continue
        rows.append((parts[3], parts[4], offset, parts[5]))

    out: dict[tuple[str, str], IdxEntry] = {}
    for i, (param, level, offset, fcst) in enumerate(rows):
        length = None
        if i + 1 < len(rows):
            length = rows[i + 1][2] - offset
            if length > MAX_BYTE_SIZE:
                length = MAX_BYTE_SIZE
        key = (param, level)
        if key not in out:
            out[key] = IdxEntry(param, level, offset, length, fcst)
    return out


def parse_ecmwf_index(text: str) -> list[dict]:
    """Parse ECMWF open-data ``.index`` (JSON-lines) files.

    Each line carries ``param``/``levtype``/``levelist``/``number`` plus
    ``_offset``/``_length`` for byte-range access (the ENS member field
    is ``number``).
    """
    import json

    out = []
    for line in text.strip().splitlines():
        line = line.strip().rstrip(",")
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


def ecmwf_lookup(
    entries: list[dict],
    param: str,
    levtype: str,
    levelist: str | None = None,
    number: int | None = None,
) -> dict:
    for e in entries:
        if e.get("param") != param or e.get("levtype") != levtype:
            continue
        if levelist is not None and str(e.get("levelist", "")) != str(levelist):
            continue
        if number is not None and str(e.get("number", "")) != str(number):
            continue
        return e
    raise KeyError(f"no index entry for {param}/{levtype}/{levelist}/{number}")


def lookup(index: dict, param: str, level: str) -> IdxEntry:
    try:
        return index[(param, level)]
    except KeyError:
        raise KeyError(
            f"({param!r}, {level!r}) not in index; sample keys: "
            f"{list(index)[:5]}"
        ) from None
