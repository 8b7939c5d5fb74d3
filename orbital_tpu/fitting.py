"""Gradient-based orbit determination through the compiled rollout.

The reference can only *propagate* a scene; because this framework's
stepper is a pure jittable function, the whole trajectory is
differentiable, and fitting initial conditions to observations becomes a
first-class operation (orbit determination, maneuver reconstruction,
mass estimation). ``fit_initial_conditions`` wraps the standard recipe:

    params -> NBodyState -> lax.scan rollout -> recorded positions
           -> masked MSE against observations -> optax optimizer

Design notes:
  * The loss rolls out under ``jax.checkpoint``-free scan — at fitting
    problem sizes (tens of bodies, thousands of steps) the O(steps)
    residual storage of reverse-mode AD fits easily; pass
    ``remat=True`` for long horizons to trade recompute for memory
    (verified value-identical in tests/test_engine_core.py).
  * One jitted ``value_and_grad`` + ``optax.update`` program per
    iteration; the python loop only carries small parameter pytrees, so
    host<->device traffic is a few KB per step.
  * Free parameters are any subset of {"pos", "vel", "mass"}; fixed
    fields come from the initial guess state. Mass positivity is
    enforced through a softplus reparameterization.

No reference counterpart (closest is manual IC construction,
/root/reference/core/examples.py); this is a new capability the
functional architecture gives for free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .engine.rollout import init_forces, resolve_force_fn, rollout
from .engine.state import make_state
from .utils.config import SimConfig

__all__ = ["FitResult", "fit_initial_conditions", "fit_orbital_elements"]


@dataclass
class FitResult:
    """Outcome of :func:`fit_initial_conditions` (device-free numpy)."""

    pos: np.ndarray          # fitted initial positions [N, 3]
    vel: np.ndarray          # fitted initial velocities [N, 3]
    mass: np.ndarray         # fitted (or pass-through) masses [N]
    loss_history: np.ndarray  # [iters] masked-MSE per iteration
    iterations: int

    @property
    def final_loss(self) -> float:
        return float(self.loss_history[-1])


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def _softplus_inv(y):
    y = jnp.maximum(y, 1e-30)
    return y + jnp.log(-jnp.expm1(-y))


def _check_x64(precision: str) -> None:
    """precision='f64' with x64 disabled silently downcasts to f32 — warn
    so the fit doesn't quietly run below its documented precision."""
    if precision == "f64" and not jax.config.read("jax_enable_x64"):
        import warnings

        warnings.warn(
            "precision='f64' requested but jax_enable_x64 is OFF — JAX will "
            "silently downcast and the fit will run in float32. Enable x64 "
            "(jax.config.update('jax_enable_x64', True)) before calling, or "
            "pass precision='f32' to acknowledge the lower precision.",
            RuntimeWarning, stacklevel=3)


def fit_initial_conditions(
    observations,
    record_every: int,
    cfg: SimConfig,
    *,
    pos0,
    vel0,
    mass,
    free: Sequence[str] = ("vel",),
    obs_mask=None,
    iterations: int = 200,
    learning_rate: float = 1e-2,
    optimizer=None,
    precision: str = "f64",
) -> FitResult:
    """Fit initial conditions so the rollout reproduces ``observations``.

    Args:
        observations: [R, N, 3] observed positions; record ``r`` is
            compared against the state after ``(r+1) * record_every``
            steps (the rollout's recording convention — the initial
            state is not a record).
        record_every: steps between observation epochs.
        cfg: simulation config used for the rollout (dt, G, eps2,
            integrator, force_impl...). Collisions are disallowed —
            merge/bounce events are not usefully differentiable.
        pos0 / vel0 / mass: initial guess arrays [N, 3] / [N, 3] / [N].
        free: subset of {"pos", "vel", "mass"} to optimize; everything
            else stays at its guess.
        obs_mask: optional broadcastable-to-[R, N] weight/mask (e.g.
            observe only some bodies or epochs).
        iterations: optimizer steps.
        learning_rate: DIMENSIONLESS Adam learning rate (parameters are
            optimized in units of their initial-guess RMS scale, so 0.02
            means ~2% of the natural scale per step); cosine-decayed to 0
            over ``iterations``. Used when ``optimizer`` is None.
        optimizer: any optax GradientTransformation to use instead
            (applied to the scale-normalized parameters).
        precision: state precision for the fit ("f64" recommended —
            CPU fitting of real-unit scenes needs the range).

    Returns a :class:`FitResult` with the fitted ICs and loss history.
    """
    import optax

    if cfg.collisions != "none":
        raise ValueError("fitting requires cfg.collisions='none' "
                         "(contact events are not usefully differentiable)")
    bad = set(free) - {"pos", "vel", "mass"}
    if bad:
        raise ValueError(f"free must be a subset of pos/vel/mass, got {bad}")
    obs = jnp.asarray(observations)
    if obs.ndim != 3 or obs.shape[-1] != 3:
        raise ValueError(f"observations must be [R, N, 3], got {obs.shape}")
    n_rec = obs.shape[0]
    n = obs.shape[1]
    steps = n_rec * record_every
    weights = (jnp.ones(obs.shape[:2])
               if obs_mask is None else jnp.broadcast_to(
                   jnp.asarray(obs_mask), obs.shape[:2]))
    w3 = weights[..., None]

    _check_x64(precision)
    pos0 = jnp.asarray(pos0, jnp.float64 if precision == "f64" else jnp.float32)
    vel0 = jnp.asarray(vel0, pos0.dtype)
    mass0 = jnp.asarray(mass, pos0.dtype)

    # optimize in scale-normalized units: SI magnitudes (1e8 m, 1e3 m/s,
    # 1e24 kg) would otherwise make any single learning rate nonsense
    pscale = float(jnp.sqrt(jnp.mean(pos0 * pos0))) or 1.0
    vscale = float(jnp.sqrt(jnp.mean(vel0 * vel0))) or 1.0
    mscale = float(jnp.mean(mass0)) or 1.0

    params = {}
    if "pos" in free:
        params["pos_n"] = pos0 / pscale
    if "vel" in free:
        params["vel_n"] = vel0 / vscale
    if "mass" in free:
        params["mass_raw"] = _softplus_inv(mass0 / mscale)

    force_fn = resolve_force_fn(cfg, n)
    # make_state is host-side (numpy); build one template and swap the
    # traced fields in with .replace() inside the differentiated loss
    if precision not in ("f32", "f64"):
        raise ValueError("fitting supports precision 'f32' or 'f64' "
                         "(ds32's hi/lo split is not a trainable layout)")
    template = make_state(np.asarray(pos0), np.asarray(vel0),
                          np.asarray(mass0), precision=precision)

    def loss_fn(p):
        dt_ = template.pos.dtype
        pos = p["pos_n"] * pscale if "pos_n" in p else pos0
        vel = p["vel_n"] * vscale if "vel_n" in p else vel0
        st = template.replace(
            pos=jnp.asarray(pos, dt_),
            vel=jnp.asarray(vel, dt_),
            mass=((_softplus(p["mass_raw"]) * mscale).astype(dt_)
                  if "mass_raw" in p else template.mass),
        )
        st = init_forces(st, cfg, force_fn)
        _, traj = rollout(st, cfg, steps, record_every=record_every,
                          force_fn=force_fn)
        resid = (traj.pos - obs) * w3
        return jnp.sum(resid * resid) / jnp.maximum(jnp.sum(weights), 1.0)

    opt = (optimizer if optimizer is not None else optax.adam(
        optax.cosine_decay_schedule(learning_rate, max(iterations, 1))))
    opt_state = opt.init(params)

    @jax.jit
    def fit_step(p, s):
        val, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, val

    history = np.empty(iterations, np.float64)
    for it in range(iterations):
        params, opt_state, val = fit_step(params, opt_state)
        history[it] = float(val)

    pos_f = np.asarray(params["pos_n"] * pscale if "pos_n" in params
                       else pos0)
    vel_f = np.asarray(params["vel_n"] * vscale if "vel_n" in params
                       else vel0)
    mass_f = np.asarray(_softplus(params["mass_raw"]) * mscale
                        if "mass_raw" in params else mass0)
    return FitResult(pos=pos_f, vel=vel_f, mass=mass_f,
                     loss_history=history, iterations=iterations)


_ELEMENT_NAMES = ("a", "e", "inc", "long_node", "arg_peri", "mean_anom")


def fit_orbital_elements(
    observations,
    record_every: int,
    cfg: SimConfig,
    *,
    central_mass: float,
    sat_masses,
    elements0: dict,
    free: Sequence[str] = ("a", "e", "mean_anom"),
    obs_mask=None,
    iterations: int = 300,
    learning_rate: float = 2e-2,
    optimizer=None,
    precision: str = "f64",
):
    """Fit Keplerian orbital elements to observed satellite positions.

    The astronomer-facing orbit-determination loop: satellites are
    parameterized by osculating elements about a central body at the
    origin; the differentiable chain is

        elements -> (fixed-iteration Kepler solve, ops/kepler.py)
                 -> state vectors -> N-body rollout -> masked MSE.

    Because the element -> state conversion is itself on-device and
    differentiable, gradients account for the FULL N-body dynamics
    (satellite-satellite perturbations included), not just two-body
    motion — fitting resonant or strongly-interacting systems works.

    Args:
        observations: [R, S, 3] observed central-relative satellite
            positions (S satellites; the central body is not observed).
        record_every / cfg / obs_mask / iterations / learning_rate /
            optimizer / precision: as in :func:`fit_initial_conditions`
            (the learning rate is dimensionless; elements are optimized
            in natural units — a in units of its initial guess, e via a
            logit, angles raw radians).
        central_mass: mass of the central body (pinned at the origin
            with the system's momentum-zeroing velocity).
        sat_masses: [S] satellite masses.
        elements0: dict with "a", "e", "inc", "long_node", "arg_peri",
            "mean_anom" arrays [S] (radians; semi-major axis in the same
            length units as the observations).
        free: subset of element names to optimize.

    Returns (elements dict, FitResult) — the FitResult's pos/vel are the
    fitted initial state vectors.
    """
    import optax

    from .ops.kepler import elements_to_state

    if cfg.collisions != "none":
        raise ValueError("fitting requires cfg.collisions='none'")
    bad = set(free) - set(_ELEMENT_NAMES)
    if bad:
        raise ValueError(f"free must be element names, got {bad}")
    missing = set(_ELEMENT_NAMES) - set(elements0)
    if missing:
        raise ValueError(f"elements0 missing {missing}")
    obs = jnp.asarray(observations)
    n_rec, n_sat = obs.shape[0], obs.shape[1]
    steps = n_rec * record_every
    weights = (jnp.ones(obs.shape[:2])
               if obs_mask is None else jnp.broadcast_to(
                   jnp.asarray(obs_mask), obs.shape[:2]))
    w3 = weights[..., None]

    _check_x64(precision)
    fdt = jnp.float64 if precision == "f64" else jnp.float32
    el0 = {k: jnp.asarray(elements0[k], fdt) for k in _ELEMENT_NAMES}
    m_sat = jnp.asarray(sat_masses, fdt)
    mu = cfg.G * (central_mass + np.asarray(sat_masses))
    a_scale = jnp.maximum(jnp.abs(el0["a"]), 1e-30)

    def enc(name):
        v = el0[name]
        if name == "a":
            return v / a_scale
        if name == "e":
            v = jnp.clip(v, 1e-9, 1.0 - 1e-9)
            return jnp.log(v / (1.0 - v))        # logit: e stays in (0,1)
        return v                                  # angles: raw radians

    def dec(name, v):
        if name == "a":
            return v * a_scale
        if name == "e":
            return jax.nn.sigmoid(v)
        return v

    params = {k: enc(k) for k in free}

    n = n_sat + 1
    force_fn = resolve_force_fn(cfg, n)
    mass_all = np.concatenate([[central_mass], np.asarray(sat_masses)])
    template = make_state(np.zeros((n, 3)), np.zeros((n, 3)), mass_all,
                          precision=precision)

    def build_state(p):
        el = {k: dec(k, p[k]) if k in p else el0[k] for k in _ELEMENT_NAMES}
        ps, vs = elements_to_state(el["a"], el["e"], el["inc"],
                                   el["long_node"], el["arg_peri"],
                                   el["mean_anom"], jnp.asarray(mu, fdt))
        # central body takes the momentum-zeroing counter-velocity
        v_c = -(m_sat[:, None] * vs).sum(0) / central_mass
        pos = jnp.concatenate([jnp.zeros((1, 3), fdt), ps.astype(fdt)])
        vel = jnp.concatenate([v_c[None].astype(fdt), vs.astype(fdt)])
        return template.replace(pos=pos, vel=vel)

    def loss_fn(p):
        st = init_forces(build_state(p), cfg, force_fn)
        _, traj = rollout(st, cfg, steps, record_every=record_every,
                          force_fn=force_fn)
        # observations are central-relative
        rel = traj.pos[:, 1:] - traj.pos[:, :1]
        resid = (rel - obs) * w3
        return jnp.sum(resid * resid) / jnp.maximum(jnp.sum(weights), 1.0)

    opt = (optimizer if optimizer is not None else optax.adam(
        optax.cosine_decay_schedule(learning_rate, max(iterations, 1))))
    opt_state = opt.init(params)

    @jax.jit
    def fit_step(p, s):
        val, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, val

    history = np.empty(iterations, np.float64)
    for it in range(iterations):
        params, opt_state, val = fit_step(params, opt_state)
        history[it] = float(val)

    el_fit = {k: np.asarray(dec(k, params[k]) if k in params else el0[k])
              for k in _ELEMENT_NAMES}
    final = build_state({k: jnp.asarray(v) for k, v in params.items()})
    res = FitResult(pos=np.asarray(final.pos), vel=np.asarray(final.vel),
                    mass=mass_all, loss_history=history,
                    iterations=iterations)
    return el_fit, res
