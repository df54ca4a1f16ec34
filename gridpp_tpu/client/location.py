"""Location and Parameters value classes (reference src/client/Location.h,
src/client/Parameters.h).

The client stores fields and coordinates as numpy arrays, but
the parameter-file machinery still speaks in terms of single locations
(nearest-location lookup, std::set<Location> ordering) and bounds-checked
parameter vectors; these small classes carry that behaviour. Out-of-range
parameter access raises ValueError where the reference calls
Util::error() (a death in the gtest batteries, Testing/Parameters.cpp).
"""
from __future__ import annotations

import math

__all__ = ["Location", "Parameters"]


class Location:
    """A (lat, lon, elev) triple with combined getter/setter accessors and
    the strict weak ordering used by std::set<Location>
    (Location.h / Location.cpp: ordered by lat, then lon, then elev)."""

    __slots__ = ("_lat", "_lon", "_elev")
    _UNSET = object()

    def __init__(self, lat, lon, elev=0.0):
        self._lat = float(lat)
        self._lon = float(lon)
        self._elev = float(elev)

    def lat(self, value=_UNSET):
        if value is not Location._UNSET:
            self._lat = float(value)
            return None
        return self._lat

    def lon(self, value=_UNSET):
        if value is not Location._UNSET:
            self._lon = float(value)
            return None
        return self._lon

    def elev(self, value=_UNSET):
        if value is not Location._UNSET:
            self._elev = float(value)
            return None
        return self._elev

    def _key(self):
        return (self._lat, self._lon, self._elev)

    def __lt__(self, other):
        return self._key() < other._key()

    def __eq__(self, other):
        return isinstance(other, Location) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Location({self._lat}, {self._lon}, {self._elev})"


class Parameters:
    """Bounds-checked parameter vector (Parameters.h).

    Access outside [0, size) — including negative, past-the-end and
    non-finite (Util::MV) indices — raises ValueError, mirroring the
    EXPECT_DEATH batteries in Testing/Parameters.cpp."""

    def __init__(self, values=None):
        self._values = [float(v) for v in values] if values is not None \
            else []

    def size(self) -> int:
        return len(self._values)

    def get_values(self):
        return list(self._values)

    # SWIG-style alias matching the reference method name
    getValues = get_values

    def _check(self, i):
        if isinstance(i, float) and not math.isfinite(i):
            raise ValueError("Invalid parameter index (missing value)")
        i = int(i)
        if i < 0 or i >= len(self._values):
            raise ValueError(
                f"Parameter index {i} out of range [0, {len(self._values)})")
        return i

    def __getitem__(self, i):
        return self._values[self._check(i)]

    def __setitem__(self, i, value):
        self._values[self._check(i)] = float(value)

    def is_valid(self) -> bool:
        return all(math.isfinite(v) for v in self._values)

    def __len__(self):
        return len(self._values)

    def __repr__(self):
        return f"Parameters({self._values})"
