"""Monte-Carlo ensembles: vmapped rollouts of perturbed systems.

The whole stepper is a pure function of the state pytree, so an ensemble of
E perturbed systems is one ``jax.vmap`` over a leading axis — E systems
integrate in lockstep on one chip with zero Python overhead (BASELINE
config 5: 1024 perturbed solar systems). Combine with a mesh by sharding
the ensemble axis (pure data parallelism, no collectives in the step).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.rollout import resolve_force_fn, rollout
from ..engine.state import NBodyState
from ..utils.config import SimConfig

__all__ = ["make_ensemble", "ensemble_rollout", "energy_drift"]


def make_ensemble(
    state: NBodyState,
    n_ensemble: int,
    key: jax.Array,
    pos_sigma: float = 0.0,
    vel_sigma: float = 0.0,
    perturb: Optional[Callable[[jax.Array, NBodyState], NBodyState]] = None,
) -> NBodyState:
    """Tile a base state E times with Gaussian perturbations (or a custom
    ``perturb(key, state) -> state``). Returns a state with leading axis E.
    Member 0 is always the unperturbed base (a control)."""
    def one(k, i):
        if perturb is not None:
            s = perturb(k, state)
        else:
            k1, k2 = jax.random.split(k)
            dpos = pos_sigma * jax.random.normal(k1, state.pos.shape, state.pos.dtype)
            dvel = vel_sigma * jax.random.normal(k2, state.vel.shape, state.vel.dtype)
            s = state.replace(pos=state.pos + dpos, vel=state.vel + dvel)
        # member 0 stays unperturbed
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(i == 0, a, b), state, s
        )

    keys = jax.random.split(key, n_ensemble)
    return jax.vmap(one)(keys, jnp.arange(n_ensemble))


@partial(jax.jit, static_argnames=("cfg", "steps", "record_every"))
def ensemble_rollout(
    states: NBodyState, cfg: SimConfig, steps: int, record_every: int = 0
):
    """vmapped rollout over the leading ensemble axis. Forces are
    re-initialized per member; returns (final_states, trajectories)."""
    n = states.pos.shape[-2]
    force = resolve_force_fn(cfg, n)

    def one(s: NBodyState):
        acc, U = force(s.pos, s.mass, s.alive)
        s = s.replace(acc=acc, potential=U)
        return rollout(s, cfg, steps, record_every, force_fn=force)

    return jax.vmap(one)(states)


def energy_drift(traj) -> np.ndarray:
    """Per-member relative energy drift |E_t - E_0| / |E_0| -> [E] max over
    the recording window (stability metric for ensembles)."""
    E = np.asarray(traj.energy, np.float64)  # [e, R]
    E0 = E[..., :1]
    return np.max(np.abs(E - E0) / np.abs(E0), axis=-1)
