"""Structure-of-arrays device state for the N-body system.

The reference keeps per-body Python ``Object``s and a dict of uuid-keyed
accelerations (reference: core/physics.py:161-191, 125-159). Here that
becomes one immutable pytree of device-resident arrays — positions, velocities,
masses, radii, an alive mask (masks replace Python-list removal on merges),
the cached accelerations of the last force evaluation, and scalar clock /
bookkeeping — so a simulation step is a pure function ``state -> state``
that XLA fuses into a single program under ``jax.jit`` / ``lax.scan``.

Precision policy (see ``dsfloat``):
  * ``f32``  — plain float32 state; fastest, fine for short rollouts.
  * ``ds32`` — float32 state with compensation arrays ``pos_lo/vel_lo``
               (double-single, ~1e-15 effective resolution); the default
               without x64: meets the 1e-6 energy-drift budget at
               solar-system scales while all force math stays in f32.
  * ``f64``  — float64 state (requires ``jax_enable_x64``); the CPU golden
               path against the reference.

Scenes are defined in physical units (SI or ASTRO) but the device state is
kept in *internal units* chosen so positions/velocities are O(1) and G = 1
(``Rescale``): an exact change of units that preserves the dynamics while
keeping float32 well-conditioned.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NBodyState", "Rescale", "Precision", "make_state", "pad_count", "far_positions"]

Precision = str  # "f32" | "ds32" | "f64"

_VALID_PRECISIONS = ("f32", "ds32", "f64")


@partial(jax.tree_util.register_dataclass,
         data_fields=["pos", "vel", "mass", "radius", "alive", "acc",
                      "potential", "time", "step", "pos_lo", "vel_lo",
                      "jerk"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class NBodyState:
    """Immutable SoA simulation state. Leading batch axes are allowed on all
    fields (vmapped ensembles); N is the trailing body axis."""

    pos: jax.Array              # [..., N, 3] positions (internal units)
    vel: jax.Array              # [..., N, 3] velocities
    mass: jax.Array             # [..., N] masses; 0 for dead/padding bodies
    radius: jax.Array           # [..., N] collision radii
    alive: jax.Array            # [..., N] bool; False for merged-away/padding
    acc: jax.Array              # [..., N, 3] accelerations of last force eval
    potential: jax.Array        # [...] softened potential of last force eval
    time: jax.Array             # [...] elapsed simulation time
    step: jax.Array             # [...] int32 step counter
    pos_lo: Optional[jax.Array] = None  # ds32 compensation terms, else None
    vel_lo: Optional[jax.Array] = None
    jerk: Optional[jax.Array] = None    # [..., N, 3] da/dt cache (Hermite)

    @property
    def n_bodies(self) -> int:
        return self.pos.shape[-2]

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def is_ds(self) -> bool:
        return self.pos_lo is not None

    def replace(self, **kwargs) -> "NBodyState":
        return dataclasses.replace(self, **kwargs)

    def pos_full(self) -> jax.Array:
        """Best-precision positions (hi+lo collapsed for ds32)."""
        return self.pos if self.pos_lo is None else self.pos + self.pos_lo

    def vel_full(self) -> jax.Array:
        return self.vel if self.vel_lo is None else self.vel + self.vel_lo


@dataclasses.dataclass(frozen=True)
class Rescale:
    """Exact change of units between scene (physical) and internal state.

    Internal quantities: pos_i = pos_phys / length, vel_i = vel_phys *
    time / length, mass_i = mass_phys / mass, with the time scale chosen so
    G_internal = G_phys * mass * time^2 / length^3 (1.0 when derived via
    :meth:`natural`).
    """

    length: float = 1.0
    mass: float = 1.0
    time: float = 1.0

    @classmethod
    def natural(cls, pos: np.ndarray, mass: np.ndarray, G: float) -> "Rescale":
        """Scales making positions O(1) and G = 1: L0 = RMS radius,
        M0 = total mass, T0 = sqrt(L0^3 / (G M0))."""
        r = np.linalg.norm(np.asarray(pos, dtype=np.float64), axis=-1)
        L0 = float(np.sqrt(np.mean(r**2))) or 1.0
        M0 = float(np.sum(mass)) or 1.0
        T0 = math.sqrt(L0**3 / (G * M0))
        return cls(length=L0, mass=M0, time=T0)

    @classmethod
    def identity(cls) -> "Rescale":
        return cls()

    def g_internal(self, G_phys: float) -> float:
        return G_phys * self.mass * self.time**2 / self.length**3

    @property
    def velocity(self) -> float:
        return self.length / self.time

    @property
    def energy(self) -> float:
        return self.mass * self.velocity**2

    @property
    def angular_momentum(self) -> float:
        return self.mass * self.velocity * self.length


def pad_count(n: int, multiple: int) -> int:
    """Bodies are padded to a tile multiple so Pallas grids stay static."""
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple


def far_positions(k: int, scale: float, dtype=np.float64, start: int = 0) -> np.ndarray:
    """Spread-out parking positions for dead/padding bodies.

    Far enough that no live body's radius can reach them, and mutually
    non-coincident (index-proportional spacing that stays representable in
    f32) so dead pairs never register as touching in the fused contact
    detection (``ops.pallas_forces.pairwise_acc_detect_pallas``). ``scale``
    is the live-scene magnitude (max |pos|); ``start`` is the global row
    index of the first parked body — merge parking
    (``ops.collisions.merge_groups``) uses the same global-index spread, so
    padding and merged-dead rows can never land on each other."""
    far = 1e8 * (1.0 + abs(scale))
    if np.dtype(dtype) == np.float32:
        far = min(far, 1e17)  # keep far^2 finite in f32
    out = np.full((k, 3), far, dtype=np.float64)
    out[:, 0] *= 1.0 + 1e-3 * (start + np.arange(k))
    return out


def make_state(
    pos: np.ndarray,
    vel: np.ndarray,
    mass: np.ndarray,
    radius: Optional[np.ndarray] = None,
    *,
    precision: Precision = "f32",
    rescale: Optional[Rescale] = None,
    pad_to: int = 1,
    spare: int = 0,
    time: float = 0.0,
) -> NBodyState:
    """Build device state from host f64 arrays (already in *physical* units;
    pass ``rescale`` to convert to internal units on the way in).

    ``spare`` allocates that many extra DEAD slots (beyond ``pad_to``
    alignment) for bodies created at runtime — debris fragments from
    ``collisions="resolve"`` with ``debris_k > 0`` spawn into them.

    ``acc``/``potential`` are zero-initialized; the engine performs the
    initial force evaluation (reference seeds accelerations in the
    constructor, core/engine.py:41).
    """
    if precision not in _VALID_PRECISIONS:
        raise ValueError(f"precision must be one of {_VALID_PRECISIONS}, got {precision!r}")
    rs = rescale if rescale is not None else Rescale.identity()

    pos = np.asarray(pos, dtype=np.float64) / rs.length
    vel = np.asarray(vel, dtype=np.float64) / rs.velocity
    mass = np.asarray(mass, dtype=np.float64) / rs.mass
    n = pos.shape[0]
    radius = (
        np.asarray(radius, dtype=np.float64) / rs.length
        if radius is not None
        else np.zeros(n)
    )

    if spare < 0:
        raise ValueError(f"spare must be >= 0, got {spare}")
    n_pad = pad_count(n + int(spare), pad_to)
    alive = np.zeros(n_pad, dtype=bool)
    alive[:n] = True
    if n_pad != n:
        pad = n_pad - n
        # padding parks at spread-out far positions (not the origin):
        # mass 0 keeps them force-inert either way, but the fused contact
        # detection needs them geometrically out of reach of live radii
        scale = float(np.max(np.abs(pos))) if n else 1.0
        dt_pad = np.float32 if precision in ("f32", "ds32") else np.float64
        pos = np.concatenate([pos, far_positions(pad, scale, dt_pad, start=n)])
        vel = np.concatenate([vel, np.zeros((pad, 3))])
        mass = np.concatenate([mass, np.zeros(pad)])
        radius = np.concatenate([radius, np.zeros(pad)])

    if precision == "f64":
        if not jax.config.read("jax_enable_x64"):
            raise ValueError("precision='f64' requires jax_enable_x64")
        dt_ = jnp.float64
    else:
        dt_ = jnp.float32

    pos_lo = vel_lo = None
    if precision == "ds32":
        pos32 = pos.astype(np.float32)
        vel32 = vel.astype(np.float32)
        pos_lo = jnp.asarray((pos - pos32).astype(np.float32))
        vel_lo = jnp.asarray((vel - vel32).astype(np.float32))
        pos_dev, vel_dev = jnp.asarray(pos32), jnp.asarray(vel32)
    else:
        pos_dev = jnp.asarray(pos.astype(dt_))
        vel_dev = jnp.asarray(vel.astype(dt_))

    return NBodyState(
        pos=pos_dev,
        vel=vel_dev,
        mass=jnp.asarray(mass.astype(dt_)),
        radius=jnp.asarray(radius.astype(dt_)),
        alive=jnp.asarray(alive),
        acc=jnp.zeros((n_pad, 3), dtype=dt_),
        potential=jnp.zeros((), dtype=dt_),
        time=jnp.asarray(time, dtype=dt_),
        step=jnp.zeros((), dtype=jnp.int32),
        pos_lo=pos_lo,
        vel_lo=vel_lo,
    )
