"""DATETIME/DATE/DURATION representations.

The reference stores datetimes as a bit-packed uint64 (ref: pkg/types/time.go
`Time.ToPackedUint` / `FromPackedUint`, the MySQL packed layout):

    ymd    = (year*13 + month) << 5 | day
    hms    = hour << 12 | minute << 6 | second
    packed = ((ymd << 17) | hms) << 24 | microsecond

The packing is order-preserving, so the packed uint64 *is* the device
representation: comparisons, group-by keys and min/max work directly on it;
EXTRACT-style functions unpack with shifts/masks inside kernels.

DURATION is int64 nanoseconds (ref: pkg/types/time.go Duration).
"""

from __future__ import annotations

from dataclasses import dataclass


def pack_datetime(year: int, month: int, day: int, hour: int = 0, minute: int = 0,
                  second: int = 0, microsecond: int = 0) -> int:
    ymd = (year * 13 + month) << 5 | day
    hms = hour << 12 | minute << 6 | second
    return ((ymd << 17) | hms) << 24 | microsecond


def days_from_civil(y, m, d):
    """Days since 1970-01-01 (proleptic Gregorian; Hinnant's algorithm with
    floor division — ref: types/time.go calcDaynr semantics).

    Branchless on purpose: works identically for Python ints, numpy arrays
    and int64 tensors (the device date ops call this with int64 lanes), so
    the calendar math exists exactly once. Each comparison is multiplied by
    1 before it meets an integer: torch refuses `-` with a bool tensor."""
    y = y - (m <= 2) * 1
    era = y // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z):
    z = z + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 - 12 * (mp >= 10)
    return y + (m <= 2) * 1, m, d


def days_in_month(y, m):
    """Branchless (scalar or array): 31 minus the 30-day months minus the
    February adjustment (28/29)."""
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    is30 = (m == 4) | (m == 6) | (m == 9) | (m == 11)
    return 31 - is30 * 1 - (m == 2) * (3 - leap * 1)


def add_months(y, m, d, months):
    """Month arithmetic with month-end clamping, branchless (scalar or
    array) — the one copy both the oracle and the device kernel use."""
    t = y * 12 + (m - 1) + months
    y2, m2 = t // 12, t % 12 + 1
    dim = days_in_month(y2, m2)
    d2 = d - (d - dim) * (d > dim)  # min(d, dim)
    return y2, m2, d2


_UNIT_SECONDS = {"second": 1, "minute": 60, "hour": 3600, "day": 86400, "week": 7 * 86400}


def datetime_add(packed: int, n: int, unit: str) -> int:
    """packed datetime + INTERVAL n unit (ref: types/time.go AddDate /
    builtin_time date_add). Month/quarter/year clamp the day to the target
    month's length (MySQL: '2020-01-31' + 1 month = '2020-02-29')."""
    y, m, d, hh, mm, ss, micro = unpack_datetime(packed)
    if unit in _UNIT_SECONDS:
        total = days_from_civil(y, m, d) * 86400 + hh * 3600 + mm * 60 + ss + n * _UNIT_SECONDS[unit]
        days, secs = total // 86400, total % 86400
        y, m, d = civil_from_days(days)
        hh, mm, ss = secs // 3600, (secs // 60) % 60, secs % 60
    else:
        months = {"month": 1, "quarter": 3, "year": 12}[unit] * n
        y, m, d = add_months(y, m, d, months)
    return pack_datetime(y, m, d, hh, mm, ss, micro)


def unpack_datetime(packed: int) -> tuple[int, int, int, int, int, int, int]:
    microsecond = packed & ((1 << 24) - 1)
    rest = packed >> 24
    hms = rest & ((1 << 17) - 1)
    ymd = rest >> 17
    day = ymd & 31
    ym = ymd >> 5
    year, month = divmod(ym, 13)
    second = hms & 63
    minute = (hms >> 6) & 63
    hour = hms >> 12
    return year, month, day, hour, minute, second, microsecond


@dataclass(frozen=True)
class MyTime:
    """A host-side datetime value; `tp` distinguishes DATE/DATETIME/TIMESTAMP."""

    packed: int
    fsp: int = 0

    @classmethod
    def from_ymd(cls, year: int, month: int, day: int, hour: int = 0, minute: int = 0,
                 second: int = 0, microsecond: int = 0, fsp: int = 0) -> "MyTime":
        return cls(pack_datetime(year, month, day, hour, minute, second, microsecond), fsp)

    @classmethod
    def parse(cls, s: str, fsp: int = 0) -> "MyTime":
        s = s.strip()
        date_part, _, time_part = s.partition(" ")
        y, m, d = (int(x) for x in date_part.split("-"))
        hh = mm = ss = us = 0
        if time_part:
            hms, _, frac = time_part.partition(".")
            hh, mm, ss = (int(x) for x in hms.split(":"))
            if frac:
                us = int(frac[:6].ljust(6, "0"))
        return cls.from_ymd(y, m, d, hh, mm, ss, us, fsp)

    def parts(self):
        return unpack_datetime(self.packed)

    def is_date_only(self) -> bool:
        _, _, _, h, mi, s, us = self.parts()
        return h == 0 and mi == 0 and s == 0 and us == 0

    def __str__(self) -> str:
        y, m, d, h, mi, s, us = self.parts()
        base = f"{y:04d}-{m:02d}-{d:02d}"
        if self.fsp > 0:
            frac = f"{us:06d}"[: self.fsp]
            return f"{base} {h:02d}:{mi:02d}:{s:02d}.{frac}"
        if h or mi or s or us:
            return f"{base} {h:02d}:{mi:02d}:{s:02d}"
        return base

    def str_full(self) -> str:
        y, m, d, h, mi, s, us = self.parts()
        base = f"{y:04d}-{m:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d}"
        if self.fsp > 0:
            return base + "." + f"{us:06d}"[: self.fsp]
        return base

    def __lt__(self, other: "MyTime") -> bool:
        return self.packed < other.packed
