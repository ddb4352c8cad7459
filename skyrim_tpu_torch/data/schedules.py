"""Forecast product schedules + lead-time validation.

Encodes each provider's published availability exactly as the reference
validates it:

- GFS: hourly steps to 120 h, then 3-hourly to 384 h; cycles 00/06/12/18z
  (reference skyrim/libs/nwp/gfs.py:159-166,391-398)
- IFS HRES: 00/12z → 0–144 by 3 h then 150–240 by 6 h; 06/18z → 0–90 by
  3 h (reference ifs.py:113-117,445-520)
- ENS: 00/12z → 0–144 by 3 h then 150–360 by 6 h; 06/18z → 0–144 by 3 h
  (reference ens.py:122-128,471-519)

The port's copy of skyrim_tpu/data/schedules.py.
"""

from __future__ import annotations

import datetime


class ScheduleError(ValueError):
    pass


def gfs_steps(cycle: int) -> list[int]:
    if cycle not in (0, 6, 12, 18):
        raise ScheduleError(f"GFS cycle must be 00/06/12/18z, got {cycle:02d}z")
    return list(range(0, 121)) + list(range(123, 385, 3))


def ifs_steps(cycle: int) -> list[int]:
    if cycle in (0, 12):
        return list(range(0, 145, 3)) + list(range(150, 241, 6))
    if cycle in (6, 18):
        return list(range(0, 91, 3))
    raise ScheduleError(f"IFS cycle must be 00/06/12/18z, got {cycle:02d}z")


def ens_steps(cycle: int) -> list[int]:
    if cycle in (0, 12):
        return list(range(0, 145, 3)) + list(range(150, 361, 6))
    if cycle in (6, 18):
        return list(range(0, 145, 3))
    raise ScheduleError(f"ENS cycle must be 00/06/12/18z, got {cycle:02d}z")


_PRODUCT_STEPS = {"gfs": gfs_steps, "ifs": ifs_steps, "ens": ens_steps}


def validate_lead_time(product: str, cycle: int, lead_time: int) -> None:
    steps = _PRODUCT_STEPS[product](cycle)
    if lead_time not in steps:
        raise ScheduleError(
            f"{product.upper()} {cycle:02d}z has no step {lead_time}h "
            f"(max {steps[-1]}h)"
        )


def forecast_steps(
    product: str, cycle: int, lead_time: int, time_step: int | None = None
) -> list[int]:
    """All available steps up to lead_time (optionally re-sampled).

    Mirrors the reference's slicing (ifs.py:445-520): raises if the lead
    time or requested cadence isn't served by the product schedule.
    """
    all_steps = _PRODUCT_STEPS[product](cycle)
    validate_lead_time(product, cycle, lead_time)
    steps = [s for s in all_steps if s <= lead_time]
    if time_step is not None:
        wanted = list(range(0, lead_time + 1, time_step))
        missing = [s for s in wanted if s not in all_steps]
        if missing:
            raise ScheduleError(
                f"{product.upper()} {cycle:02d}z cannot serve steps {missing} "
                f"at cadence {time_step}h"
            )
        steps = wanted
    return steps


def available_start_times(
    product: str,
    target: datetime.datetime,
    max_hours_back: int = 24,
) -> list[tuple[datetime.datetime, int]]:
    """(init_time, lead) pairs whose valid time hits ``target``, newest
    first — the reference's ``snipe`` walk (gfs.py:342-387)."""
    out = []
    base = target.replace(minute=0, second=0, microsecond=0)
    for back in range(0, max_hours_back + 1):
        init = base - datetime.timedelta(hours=back)
        if init.hour % 6 != 0:
            continue
        lead = int((target - init).total_seconds() // 3600)
        try:
            validate_lead_time(product, init.hour, lead)
        except ScheduleError:
            continue
        out.append((init, lead))
    return out
