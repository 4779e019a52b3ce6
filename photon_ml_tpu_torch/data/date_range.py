"""Date-range input-path resolution
(a copy of photon_ml_tpu/data/date_range.py; host code).

Rebuild of the reference's date-partitioned input discovery:
  - DateRange.fromDates / fromDaysAgo ("yyyyMMdd-yyyyMMdd" and
    "START-END" days-ago specs, photon-lib/.../util/DateRange.scala:50-126)
  - IOUtils.getInputPathsWithinDateRange: <baseDir>/daily/YYYY/MM/DD per
    day in the range, skipping missing days, erroring when NONE exist
    (photon-client/.../util/IOUtils.scala:82-119)
  - GameDriver.pathsForDateRange: range and days-ago are mutually
    exclusive; neither means "use the base dirs as-is"
    (photon-client/.../cli/game/GameDriver.scala:103-126).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence


def parse_date_range(spec: str) -> tuple[datetime.date, datetime.date]:
    """'yyyyMMdd-yyyyMMdd' -> (start, end) inclusive."""
    try:
        start_s, end_s = spec.split("-")
        start = datetime.datetime.strptime(start_s, "%Y%m%d").date()
        end = datetime.datetime.strptime(end_s, "%Y%m%d").date()
    except ValueError as e:
        raise ValueError(
            f"date range {spec!r} is not 'yyyyMMdd-yyyyMMdd'") from e
    if end < start:
        raise ValueError(f"date range {spec!r} ends before it starts")
    return start, end


def parse_days_ago(spec: str,
                   today: Optional[datetime.date] = None
                   ) -> tuple[datetime.date, datetime.date]:
    """'START-END' days ago (e.g. '90-1') -> (start, end) dates."""
    today = today or datetime.date.today()
    try:
        start_ago, end_ago = (int(v) for v in spec.split("-"))
    except ValueError as e:
        raise ValueError(f"days-ago range {spec!r} is not 'START-END'") from e
    start = today - datetime.timedelta(days=start_ago)
    end = today - datetime.timedelta(days=end_ago)
    if end < start:
        raise ValueError(f"days-ago range {spec!r} ends before it starts")
    return start, end


def paths_for_date_range(
    base_dirs: str | Sequence[str],
    date_range: Optional[str] = None,
    days_ago: Optional[str] = None,
    today: Optional[datetime.date] = None,
) -> List[str]:
    """Expand base dirs to <base>/daily/YYYY/MM/DD day directories.

    Exactly the reference contract: both specs given is an error; neither
    returns the base dirs unchanged; missing day directories are skipped,
    but a range matching NO directory under a base dir raises."""
    if isinstance(base_dirs, (str, os.PathLike)):
        base_dirs = [str(base_dirs)]
    if date_range is not None and days_ago is not None:
        raise ValueError(
            "Both date range and days ago given. You must specify date "
            "ranges using only one format.")
    if date_range is None and days_ago is None:
        return list(base_dirs)
    start, end = (parse_date_range(date_range) if date_range is not None
                  else parse_days_ago(days_ago, today))
    out: List[str] = []
    for base in base_dirs:
        daily = os.path.join(base, "daily")
        found = []
        day = start
        while day <= end:
            p = os.path.join(daily, f"{day.year:04d}", f"{day.month:02d}",
                             f"{day.day:02d}")
            if os.path.isdir(p):
                found.append(p)
            day += datetime.timedelta(days=1)
        if not found:
            raise FileNotFoundError(
                f"No data folder found between {start} and {end} in {daily}")
        out.extend(found)
    return out
