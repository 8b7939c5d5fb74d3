"""One-call convenience API: scene in, trajectory out.

Wraps the full pipeline — scene compilation, natural-unit rescaling,
precision policy, force-path selection, compiled rollout, unit conversion
back to physical — behind a single function, for the common "just simulate
this" case. Everything it does is available piecemeal through the
lower-level APIs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import numpy as np

from .engine.rollout import Trajectory, init_forces, rollout_jit
from .engine.state import NBodyState, Rescale, make_state
from .models.body import System
from .models.constants import STANDARD, UnitProfile
from .models.objects import Object, ObjectCollection
from .models.scene import SceneArrays, compile_objects, compile_system
from .utils.config import SimConfig

__all__ = ["simulate", "SimResult"]

# tree rollouts at and past this shape route to the host-driven staged
# loop (engine.rollout.rollout_staged): the far and near phases run as two
# programs, and the near-field overflow is checked every step
_STAGED_MIN_LEVELS = 8
_STAGED_MIN_N = 524288


@dataclasses.dataclass
class SimResult:
    """Physical-unit outputs of :func:`simulate`."""

    pos: np.ndarray        # [R, N, 3] recorded positions (physical units)
    vel: np.ndarray        # [R, N, 3]
    time: np.ndarray       # [R]
    energy: np.ndarray     # [R]
    ang_mom: np.ndarray    # [R, 3]
    names: list[str]
    final_state: NBodyState
    rescale: Rescale
    config: SimConfig

    @property
    def energy_drift(self) -> float:
        """max |E_t - E_0| / |E_0| over the recording."""
        return float(np.max(np.abs(self.energy - self.energy[0])
                            / abs(self.energy[0])))


def _tree_budget_cfg(cfg: SimConfig, state: NBodyState, *, tree_near,
                     tree_levels, tree_capacity) -> SimConfig:
    """Probe-size every static tree budget from the initial distribution
    in one cheap pass (1.5x headroom; the compiled hot loop drops the
    overflow counter, so budgets must be sized here — re-probe mid-run
    with ``ops.tree.tree_occupancy_probe`` if the system contracts)."""
    from .ops.tree import (tree_class_probe, tree_column_probe,
                           tree_occupancy_probe)

    if tree_levels == "auto":
        # smallest pyramid whose densest cell stays near-field-cheap
        for tree_levels in (5, 6, 7, 8):
            occ, _ = tree_occupancy_probe(state.pos, state.alive,
                                          levels=tree_levels,
                                          box=cfg.pm_box_arrays())
            if int(occ) <= 64 or tree_levels == 8:
                break
    tree_levels = int(tree_levels)
    cfg = cfg.replace(tree_levels=tree_levels)
    if tree_near == "auto":
        # the z-trimmed octave-padded pairs sweep at 65k and up (levels
        # >= 7, chunk 64); columns below that scale, where its probe is
        # cheaper. Not yet re-measured on the GPU (ROADMAP A2).
        tree_near = ("pairs" if (state.n_bodies >= 65536
                                 and tree_levels >= 7) else "columns")
        if tree_near == "pairs" and cfg.tree_chunk == 32:
            cfg = cfg.replace(tree_chunk=64)
        cfg = cfg.replace(tree_near=tree_near)
    tree_ws = cfg.tree_ws
    # budgets are per-CELL under near="cells", per-COLUMN under
    # near="columns", per-CHUNK-OCTAVE under near="pairs" — probe at
    # the matching granularity
    if tree_near == "pairs":
        from .ops.tree import tree_pairs_budgets

        kch, entries = tree_pairs_budgets(
            state.pos, state.alive, levels=tree_levels, ws=tree_ws,
            chunk=cfg.tree_chunk, box=cfg.pm_box_arrays())
        cfg = cfg.replace(tree_max_chunks=kch,
                          tree_pair_entries=entries)
    elif tree_near == "columns":
        occ, ncells, nbig, nfront, nchunks = tree_column_probe(
            state.pos, state.alive, levels=tree_levels, ws=tree_ws,
            box=cfg.pm_box_arrays(), with_chunks=True)
        unit_cap = 4 ** tree_levels
    else:
        occ, ncells, nbig, nfront = tree_class_probe(
            state.pos, state.alive, levels=tree_levels, ws=tree_ws,
            box=cfg.pm_box_arrays())
        unit_cap = 8 ** tree_levels
    if tree_near != "pairs":
        kcells = min(state.n_bodies, unit_cap,
                     -(-int(int(ncells) * 1.5) // 1024) * 1024)
        # probe-sized class-list budgets (1.5x headroom, /256-aligned):
        # the K//8 / K//4 heuristics are heavily sentinel-padded on
        # concentrated systems and the padded rows dominate sweep cost
        kbig = min(kcells,
                   max(256, -(-int(int(nbig) * 1.5) // 256) * 256))
        kfront = min(kcells,
                     max(256, -(-int(int(nfront) * 1.5) // 256) * 256))
        cfg = cfg.replace(tree_max_cells=kcells, tree_max_big=kbig,
                          tree_max_frontier=kfront)
    if tree_near == "columns":
        # i-side chunk list for the big sweep, same 1.5x headroom
        cfg = cfg.replace(tree_max_chunks=max(
            256, -(-int(int(nchunks) * 1.5) // 256) * 256))
    if tree_capacity == "auto" and tree_near != "pairs":
        cap = max(16, -(-int(int(occ) * 1.5) // 8) * 8)
        cap_bound = 16384 if tree_near == "columns" else 4096
        if cap > cap_bound:
            unit = "column" if tree_near == "columns" else "cell"
            raise ValueError(
                f"tree_capacity='auto': densest {unit} holds {int(occ)} "
                "bodies — raise tree_levels (finer cells) for this "
                "concentration")
        cfg = cfg.replace(tree_capacity=cap)
    return cfg


# (order, ws) escalation ladder for tree_accuracy=, cheapest first by
# far-field work (o1ws1 < o2ws1 < o1ws2 <= o2ws2); each rung buys ~5x
# force error
_TREE_ACCURACY_LADDER = ((1, 1), (2, 1), (1, 2), (2, 2))


def _tree_accuracy_probe(cfg: SimConfig, state: NBodyState, *,
                         target: float, tree_near, tree_levels,
                         tree_capacity) -> SimConfig:
    """Map one accuracy target to the five coupled tree budgets.

    Walks the (order, ws) ladder cheapest-first, measuring each
    candidate's ACTUAL force error on the initial state — global relative
    RMS, ``rms(|a_tree - a_exact|) / rms(|a_exact|)`` over live bodies,
    against one exact O(N^2) evaluation — and returns the first budgeted
    config at or under ``target``. The probe evaluations compile the same
    programs the rollout uses, so their compile cost is reused, and
    levels/capacity/near-field budgets come from :func:`_tree_budget_cfg`
    at each rung (they are cost knobs, not accuracy knobs).

    Energy drift tracks force error roughly linearly in the
    fluctuation-dominated regime (the (order, ws) series buys ~5x drift
    per ~5x force error), so a drift budget of X over 10k steps
    is well served by ``tree_accuracy ~ X`` — but drift is IC- and
    horizon-dependent; measure with ``SimResult.energy_drift``.

    Raises ``ValueError`` with the best measured error if no ladder rung
    meets the target (the exact sweep is the 1e-6-grade path at
    collisional N).
    """
    from .engine.rollout import resolve_force_fn

    exact_fn = resolve_force_fn(cfg.replace(force_impl="auto"),
                                state.n_bodies)
    acc_x = np.asarray(exact_fn(state.pos, state.mass, state.alive)[0],
                       np.float64)
    alive = np.asarray(state.alive)
    ax = acc_x[alive]
    rms_x = float(np.sqrt(np.mean(np.sum(ax * ax, axis=1))))
    if rms_x == 0.0:
        return _tree_budget_cfg(cfg, state, tree_near=tree_near,
                                tree_levels=tree_levels,
                                tree_capacity=tree_capacity)
    errs = []
    for order, ws in _TREE_ACCURACY_LADDER:
        cand = _tree_budget_cfg(
            cfg.replace(tree_order=order, tree_ws=ws), state,
            tree_near=tree_near, tree_levels=tree_levels,
            tree_capacity=tree_capacity)
        fn = resolve_force_fn(cand, state.n_bodies)
        acc_t = np.asarray(fn(state.pos, state.mass, state.alive)[0],
                           np.float64)[alive]
        d = acc_t - ax
        err = float(np.sqrt(np.mean(np.sum(d * d, axis=1)))) / rms_x
        errs.append((order, ws, err))
        if err <= target:
            return cand
    detail = ", ".join(f"order={o} ws={w}: {e:.2e}" for o, w, e in errs)
    raise ValueError(
        f"tree_accuracy={target:g}: no tree configuration meets the "
        f"target on this scene (measured relative RMS force errors: "
        f"{detail}). Use the exact sweep (force_impl='auto'), the "
        "1e-6-grade path at collisional N.")


def simulate(
    scene: Union[System, ObjectCollection, list[Object], SceneArrays],
    *,
    steps: int,
    dt: float,
    softening: float = 0.0,
    record_every: Optional[int] = None,
    precision: Optional[str] = None,
    integrator: str = "kdk",
    collisions: str = "none",
    restitution: float = 1.0,
    frag_seed: int = 0,
    debris_k: int = 0,
    debris_max_pairs: int = 4,
    debris_energy_frac: float = 0.3,
    debris_sep: float = 1.0,
    spare: int = 0,
    force_impl: str = "auto",
    pm_grid: int = 64,
    p3m_capacity: Union[int, str] = "auto",
    pm_box: Optional[tuple] = None,
    tree_levels: Union[int, str] = 6,
    tree_capacity: Union[int, str] = "auto",
    tree_ws: int = 1,
    tree_order: int = 1,
    tree_accuracy: Optional[float] = None,
    tree_near: str = "auto",
    tree_chunk: int = 32,
    respa_k: int = 8,
    respa_rc: float = 0.0,
    respa_r1: float = 0.0,
    respa_cell: float = 0.0,
    respa_refresh: int = 1,
    adaptive_eta: Optional[float] = None,
    dt_min: float = 0.0,
    hermite_fast_cap: int = 0,
    hermite_max_substeps: int = 64,
    hermite_rungs: int = 1,
    unit_profile: UnitProfile = STANDARD,
    rescale: Optional[Rescale] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
    shard_axis: str = "body",
) -> SimResult:
    """Simulate a scene and return its recorded trajectory in physical units.

    ``scene`` may be a Keplerian :class:`System`, an ``ObjectCollection`` /
    list of ``Object``, or prebuilt :class:`SceneArrays`. ``record_every``
    defaults to ~100 evenly spaced records.

    ``collisions="resolve"`` with ``debris_k > 0`` enables the debris
    model (fragmenting pairs spawn ``debris_k`` conserving fragments
    instead of vanishing); pass ``spare`` dead slots for them to occupy
    (see ``ops.collisions.resolve_outcomes``).

    ``integrator="respa"`` runs the multirate stepper (one exact force
    evaluation per ``respa_k`` leapfrog substeps + a switched short-range
    force every substep; engine/multirate.py). ``steps`` counts SUBSTEPS
    and must divide by ``respa_k``. ``respa_rc`` (switch radius) and
    ``respa_cell`` (neighbor-grid cell) are in scene units; both default
    from the softening / initial velocities, and the static search
    budgets are probe-sized from the initial distribution
    (``ops.neighbor.neighbor_budgets`` — overflow is counted and warned,
    never silent). The held-far energy error grows superquadratically in
    ``respa_k`` (roughly K^2 to K^3.7 at the 65k headline config, rc =
    5 eps; to re-measure on the GPU, ROADMAP A3) — keep K <= 4-5 for
    1e-6-grade conservation at the default rc, larger K when the drift
    budget is looser. ``respa_refresh`` amortizes the geometry rebuild
    across macro windows; refresh*K <= ~16 keeps the default cell's skin
    valid (violations are counted).

    ``mesh`` runs the rollout MULTI-CHIP over a ``jax.sharding.Mesh`` with
    a ``shard_axis`` body axis (N must divide across its devices): exact
    forces become the ppermute ring, pm/p3m/tree keep their mesh solvers
    (``parallel.sharded.make_sharded_rollout``), and the large-N staged
    tree path dispatches each phase as one shard_map program
    (``engine.rollout.rollout_staged(mesh=...)``).

    ``tree_accuracy=`` (``force_impl="tree"`` only) replaces hand-tuning
    the coupled (order, ws, levels, capacity, near-field) budgets with
    ONE knob: a relative RMS force-error target. simulate() measures each
    (order, ws) ladder rung's actual error on the initial state against
    one exact evaluation and takes the cheapest rung that meets the
    target, raising (with the measured errors) if none does. Explicit
    ``tree_order`` / ``tree_ws`` are ignored when it is set.

    Approximate-force budgets (``force_impl="tree"`` / ``"p3m"``): static
    capacities are sized from the INITIAL distribution (1.5x headroom) and
    the compiled hot loop drops the per-eval overflow counter. A system
    that contracts mid-run can exceed them and silently lose near-field
    pairs; :func:`simulate` therefore re-probes the occupancy of the FINAL
    state and warns if the budgets were outgrown. For long production
    rollouts, split the run into segments (~the timescale on which the
    density profile changes) and let each ``simulate`` call re-size, or
    drive :func:`orbital_tpu.ops.tree.tree_acc_potential` directly and
    check its overflow return.
    """
    if isinstance(scene, System):
        arrays = compile_system(scene)
    elif isinstance(scene, SceneArrays):
        arrays = scene
    else:
        arrays = compile_objects(scene)

    if precision is None:
        precision = "f64" if jax.config.read("jax_enable_x64") else "ds32"
    if rescale is None:
        rescale = (Rescale.identity() if precision == "f64"
                   else Rescale.natural(arrays.pos, arrays.mass, unit_profile.G))

    if record_every is None:
        record_every = max(1, steps // 100)
        while steps % record_every:
            record_every -= 1
        if integrator == "respa":
            # snapshots exist at macro boundaries only
            record_every = (record_every // respa_k) * respa_k
            while record_every and steps % record_every:
                record_every -= respa_k
            record_every = record_every or respa_k

    if isinstance(p3m_capacity, str) and p3m_capacity != "auto":
        raise ValueError(
            f"p3m_capacity must be an int or 'auto', got {p3m_capacity!r}")
    if isinstance(tree_capacity, str) and tree_capacity != "auto":
        raise ValueError(
            f"tree_capacity must be an int or 'auto', got {tree_capacity!r}")
    if pm_box is not None:
        # pm_box arrives in scene (physical) units like softening/dt;
        # internal state is rescaled, so the pinned cube must be too
        pm_box = tuple(float(v) / rescale.length for v in pm_box)
    elif force_impl in ("pm", "p3m"):
        # AUTO-PIN the mesh cube from the initial extent (2x margin): a
        # per-step box refit makes the mesh force a time-dependent
        # Hamiltonian that leapfrog does NOT conserve (DESIGN.md,
        # "particle-mesh solver"). Escapers are clipped
        # into edge cells — simulate() warns at end-of-run if any body
        # left the pinned cube (re-run with an explicit larger pm_box or
        # in segments). Internal units here, deliberately: the auto
        # cube derives from the already-rescaled state.
        p0 = np.asarray(arrays.pos, np.float64) / rescale.length
        c0 = (p0.max(0) + p0.min(0)) / 2.0
        half0 = float(np.max(np.abs(p0 - c0))) * 2.0 or 1.0
        pm_box = (float(c0[0]), float(c0[1]), float(c0[2]), half0)
    respa_fields = {}
    if integrator == "respa":
        if steps % respa_k:
            raise ValueError(
                f"steps={steps} must divide by respa_k={respa_k}")
        eps2_i = (softening / rescale.length) ** 2
        if eps2_i <= 0:
            raise ValueError("integrator='respa' requires softening > 0")
        rc_i = (respa_rc / rescale.length if respa_rc
                else 5.0 * eps2_i ** 0.5)
        pos_i = np.asarray(arrays.pos, np.float64) / rescale.length
        dt_i = dt / rescale.time
        if respa_cell:
            cell_i = respa_cell / rescale.length
        else:
            vel_i = np.asarray(arrays.vel, np.float64) / rescale.velocity
            vmag = np.linalg.norm(vel_i, axis=1)
            v99 = float(np.quantile(vmag, 0.99)) if vmag.size else 0.0
            # skin must cover 2 * (per-body motion over one frozen-
            # geometry window: respa_refresh macro windows of K substeps)
            cell_i = max(2.0 * rc_i,
                         rc_i + 4.0 * respa_refresh * respa_k * dt_i * v99)
        from .ops.neighbor import neighbor_budgets

        m_grid, k_ch, w_blk = neighbor_budgets(
            pos_i, cell=cell_i, chunk=32, rj=4)
        if mesh is not None:
            # sharded macro: each device sweeps K_ch / D i-chunks, so the
            # chunk budget must divide across the mesh (and stay a
            # multiple of rj for the block table)
            d_sh = int(mesh.shape[shard_axis])
            mult = int(np.lcm(8, d_sh))
            k_ch = -(-k_ch // mult) * mult
        respa_fields = dict(
            respa_k=respa_k, respa_rc=rc_i,
            respa_r1=(respa_r1 / rescale.length if respa_r1 else 0.0),
            respa_cell=cell_i, respa_m=m_grid, respa_max_chunks=k_ch,
            respa_w_blk=w_blk, respa_chunk=32, respa_rj=4,
            respa_refresh=respa_refresh)
    cfg = SimConfig(
        **respa_fields,
        dt=dt / rescale.time,
        G=rescale.g_internal(unit_profile.G),
        eps2=(softening / rescale.length) ** 2,
        integrator=integrator,
        collisions=collisions,
        restitution=restitution,
        frag_seed=frag_seed,
        debris_k=debris_k,
        debris_max_pairs=debris_max_pairs,
        debris_energy_frac=debris_energy_frac,
        debris_sep=debris_sep,
        force_impl=force_impl,
        pm_grid=pm_grid,
        p3m_capacity=64 if p3m_capacity == "auto" else int(p3m_capacity),
        pm_box=pm_box,
        tree_levels=6 if tree_levels == "auto" else int(tree_levels),
        tree_order=tree_order,
        tree_capacity=48 if tree_capacity == "auto" else int(tree_capacity),
        tree_ws=tree_ws,
        tree_near=tree_near,
        tree_chunk=tree_chunk,
        adaptive_eta=adaptive_eta,
        dt_min=dt_min / rescale.time if dt_min else 0.0,
        hermite_fast_cap=hermite_fast_cap,
        hermite_max_substeps=hermite_max_substeps,
        hermite_rungs=hermite_rungs,
    )
    state = make_state(arrays.pos, arrays.vel, arrays.mass, arrays.radius,
                       precision=precision, rescale=rescale, spare=spare)
    if force_impl == "p3m" and p3m_capacity == "auto":
        # size the per-cell capacity from the actual initial density in ONE
        # cheap pass (the short-range sum silently loses overflowed pairs;
        # re-probe mid-run with ops.p3m.p3m_overflow_probe if the system
        # contracts)
        from .ops.p3m import p3m_max_occupancy

        occ = int(p3m_max_occupancy(state.pos, state.alive, grid=pm_grid,
                                    box=cfg.pm_box_arrays()))
        cap = max(32, -(-int(occ * 1.5) // 8) * 8)  # 1.5x headroom, /8 align
        if cap > 4096:
            raise ValueError(
                f"p3m_capacity='auto': densest cell holds {occ} bodies "
                "(needs > 4096 with headroom) — the scene is too "
                "concentrated for P3M; use exact kernels or PM")
        cfg = cfg.replace(p3m_capacity=cap)
    if force_impl == "pm" and cfg.pm_box is not None and cfg.eps2 > 0:
        # PM's collisionless contract: the mesh smooths pair forces below
        # ~one cell spacing h, so the *effective* softening is max(eps, ~h)
        # (ops/pm.py accuracy contract). When the user's eps is well below
        # h, the run is in the measured out-of-contract regime — the
        # drift is then fluctuation-dominated, far above the exact sweep's
        # 1e-6 budget. Warn at setup, pointing at the solvers whose
        # contract covers collisional softening.
        h_cell = 2.0 * float(cfg.pm_box[3]) / float(pm_grid)
        eps_i = float(cfg.eps2) ** 0.5
        if eps_i < 0.5 * h_cell:
            import warnings

            warnings.warn(
                f"force_impl='pm': softening ({eps_i:.3g} internal) is "
                f"below half the mesh cell spacing (h = {h_cell:.3g}) — "
                "the mesh smooths forces at ~h, so dynamics below the "
                "grid scale are not resolved and energy drift is "
                "fluctuation-dominated. Use a finer pm_grid, the "
                "P3M solver (force_impl='p3m'), or the exact sweep.",
                stacklevel=2)
    if force_impl == "tree":
        if tree_accuracy is not None:
            cfg = _tree_accuracy_probe(
                cfg, state, target=float(tree_accuracy),
                tree_near=tree_near, tree_levels=tree_levels,
                tree_capacity=tree_capacity)
        else:
            cfg = _tree_budget_cfg(cfg, state, tree_near=tree_near,
                                   tree_levels=tree_levels,
                                   tree_capacity=tree_capacity)
    staged = (force_impl == "tree" and cfg.integrator == "kdk"
              and cfg.collisions == "none"
              and cfg.tree_levels >= _STAGED_MIN_LEVELS
              and state.n_bodies >= _STAGED_MIN_N)
    if mesh is not None and state.n_bodies % mesh.shape[shard_axis]:
        raise ValueError(
            f"N={state.n_bodies} must divide across the mesh's "
            f"{mesh.shape[shard_axis]} '{shard_axis}' shards")
    if staged:
        # the host-driven two-program loop CHECKS the near-field
        # overflow every step, which the compiled hot loop cannot
        from .engine.rollout import init_forces_staged, rollout_staged

        state = init_forces_staged(state, cfg, mesh=mesh,
                                   shard_axis=shard_axis)
        final, traj, ovf = rollout_staged(state, cfg, steps, record_every,
                                          mesh=mesh, shard_axis=shard_axis)
        if ovf:
            import warnings

            warnings.warn(
                f"tree near-field overflow {ovf} during the staged "
                "rollout: budgets sized from the initial distribution "
                "were outgrown mid-run; re-run in shorter segments.",
                RuntimeWarning, stacklevel=2)
    elif cfg.integrator == "respa":
        state = init_forces(state, cfg)
        if mesh is not None:
            # multi-chip multirate: ring-sharded closing evaluation +
            # chunk-sharded near sweeps (parallel/sharded.py)
            from .parallel.sharded import (make_sharded_respa_rollout,
                                           shard_state)

            roll = make_sharded_respa_rollout(cfg, mesh, state, steps,
                                              record_every,
                                              axis=shard_axis)
            final, traj, rdiag = roll(shard_state(mesh, state, shard_axis))
        else:
            from .engine.multirate import respa_rollout_jit

            final, traj, rdiag = respa_rollout_jit(state, cfg, steps,
                                                   record_every)
        if int(rdiag["overflow"]) or int(rdiag["skin_violation"]):
            import warnings

            warnings.warn(
                f"respa window diagnostics nonzero (overflow="
                f"{int(rdiag['overflow'])}, skin_violation="
                f"{int(rdiag['skin_violation'])}): near pairs may have "
                "been missed — enlarge respa_cell (skin) or re-run in "
                "segments so budgets re-size.",
                RuntimeWarning, stacklevel=2)
    elif mesh is not None:
        # compiled multi-chip rollout: one shard_map(scan(step)) program —
        # ring forces for exact kernels, mesh solvers for pm/p3m/tree
        from .parallel.sharded import make_sharded_rollout, shard_state

        state = init_forces(state, cfg)
        roll = make_sharded_rollout(cfg, mesh, state, steps, record_every,
                                    axis=shard_axis)
        final, traj = roll(shard_state(mesh, state, shard_axis))
    else:
        state = init_forces(state, cfg)
        final, traj = rollout_jit(state, cfg, steps, record_every)
    assert isinstance(traj, Trajectory)

    if force_impl == "tree":
        # the hot loop drops the overflow counter (rollout.py); one cheap
        # end-of-run probe catches a system that contracted past the
        # budgets sized from the initial distribution
        if cfg.tree_near == "pairs":
            from .ops.tree import tree_pairs_probe as _fin_pairs

            total_f, per_f = _fin_pairs(
                final.pos, final.alive, levels=cfg.tree_levels,
                ws=cfg.tree_ws, chunk=cfg.tree_chunk,
                box=cfg.pm_box_arrays())
            per_f = [int(v) for v in np.asarray(per_f)]
            ent = cfg.tree_pair_entries
            grown = (int(total_f) > cfg.tree_max_chunks or any(
                v and (o >= len(ent) or v > ent[o])
                for o, v in enumerate(per_f)))
        else:
            if cfg.tree_near == "columns":
                from .ops.tree import tree_column_probe as _fin_probe

                occ_f, ncells_f = _fin_probe(
                    final.pos, final.alive, levels=cfg.tree_levels,
                    ws=cfg.tree_ws, box=cfg.pm_box_arrays())[:2]
            else:
                from .ops.tree import tree_occupancy_probe

                occ_f, ncells_f = tree_occupancy_probe(
                    final.pos, final.alive, levels=cfg.tree_levels,
                    box=cfg.pm_box_arrays())
            grown = (int(occ_f) > cfg.tree_capacity
                     or int(ncells_f) > cfg.tree_max_cells)
        if grown:
            import warnings

            warnings.warn(
                "tree budgets outgrown during the run: the final "
                "distribution exceeds the near-field budgets sized from "
                "the initial one; near-field pairs were dropped near the "
                "end of the rollout. Re-run in shorter segments so the "
                "budgets re-size, or pass explicit budgets/levels.",
                RuntimeWarning, stacklevel=2)

    if force_impl in ("pm", "p3m") and cfg.pm_box is not None:
        # escape check for the (auto-)pinned mesh cube: escapers get
        # clipped into edge cells (wrong local density) — surface it
        center, half = cfg.pm_box_arrays()
        fp = np.asarray(final.pos, np.float64)
        esc = int(np.sum(np.any(np.abs(fp - np.asarray(center, np.float64))
                                > float(half), axis=-1)
                         & np.asarray(final.alive)))
        if esc:
            import warnings

            warnings.warn(
                f"{esc} bodies left the pinned pm/p3m mesh cube during the "
                "run (deposits clipped to edge cells). Pass a larger "
                "pm_box, or re-run in segments so the auto-pinned cube "
                "re-fits.", RuntimeWarning, stacklevel=2)

    return SimResult(
        pos=np.asarray(traj.pos, np.float64) * rescale.length,
        vel=np.asarray(traj.vel, np.float64) * rescale.velocity,
        time=np.asarray(traj.time, np.float64) * rescale.time,
        energy=np.asarray(traj.energy, np.float64) * rescale.energy,
        ang_mom=np.asarray(traj.ang_mom, np.float64) * rescale.angular_momentum,
        names=list(arrays.names),
        final_state=final,
        rescale=rescale,
        config=cfg,
    )
