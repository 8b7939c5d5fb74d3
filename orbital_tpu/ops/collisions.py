"""Sphere-collision handling as masked, jit-compatible array ops.

The reference resolves collisions with a sequential O(N^2) Python sweep per
step (reference: core/physics.py:510-535): for each overlapping pair either
an impulse bounce with restitution + positional de-overlap
(core/physics.py:391-422) or a momentum-conserving merge
(core/physics.py:519-531). Here both become masked pair matrices:

  * bounce: all pair impulses are computed simultaneously from the
    *pre-collision* velocities and accumulated per body. For isolated
    contacts (the overwhelmingly common case) this matches the sequential
    sweep exactly; simultaneous multi-contacts differ by impulse ordering.
  * merge: overlapping bodies are grouped by pointer-jumping to the
    lowest-index root of each contact chain and reduced with segment sums.
    Mass, momentum, and the mass-weighted center are conserved; the merged
    radius is volume-additive. Merged-away bodies become mass-0 "dead"
    bodies (alive=False) instead of being removed, keeping shapes static.

The dense forms run in O(N^2) memory over per-coordinate [N, N] buffers;
above 4096 bodies the row-chunked forms take over (``bounce_deltas_
chunked``, ``count_contacts_chunked``), and on the GPU contact detection
rides the force kernel's own sweep (``ops.pallas_forces``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["bounce_deltas", "bounce_deltas_chunked", "merge_groups",
           "resolve_outcomes",
           "resolve_outcomes_subset", "collision_roots",
           "collision_roots_chunked", "count_contacts_dense",
           "count_contacts_chunked"]


def _pair_geometry(pos, radius, alive):
    """Shared pair quantities. Returns (n_hat components, dist, touching)."""
    dx = pos[:, None, 0] - pos[None, :, 0]  # r_i - r_j (normal points at i)
    dy = pos[:, None, 1] - pos[None, :, 1]
    dz = pos[:, None, 2] - pos[None, :, 2]
    r2 = dx * dx + dy * dy + dz * dz
    dist = jnp.sqrt(r2)
    n = pos.shape[0]
    valid = ~jnp.eye(n, dtype=bool) & alive[:, None] & alive[None, :]
    touching = valid & (dist <= radius[:, None] + radius[None, :]) & (dist > 0.0)
    inv_d = jnp.where(dist > 0.0, 1.0 / jnp.where(dist > 0.0, dist, 1.0), 0.0)
    return (dx * inv_d, dy * inv_d, dz * inv_d), dist, touching


def _bounce_block(pos_i, vel_i, mass_i, radius_i, alive_i, ids_i,
                  pos, vel, mass, radius, alive, ids, *, restitution: float):
    """Restitution corrections on a row block from all columns; the pair
    math of :func:`bounce_deltas`. Returns (dpos [I,3], dvel [I,3])."""
    dx = pos_i[:, None, 0] - pos[None, :, 0]  # r_i - r_j (normal points at i)
    dy = pos_i[:, None, 1] - pos[None, :, 1]
    dz = pos_i[:, None, 2] - pos[None, :, 2]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    valid = ((ids_i[:, None] != ids[None, :])
             & alive_i[:, None] & alive[None, :])
    touching = (valid & (dist <= radius_i[:, None] + radius[None, :])
                & (dist > 0.0))
    inv_d = jnp.where(dist > 0.0, 1.0 / jnp.where(dist > 0.0, dist, 1.0), 0.0)
    nx, ny, nz = dx * inv_d, dy * inv_d, dz * inv_d

    v_rel_n = ((vel_i[:, None, 0] - vel[None, :, 0]) * nx
               + (vel_i[:, None, 1] - vel[None, :, 1]) * ny
               + (vel_i[:, None, 2] - vel[None, :, 2]) * nz)  # [I, N]
    active = touching & (v_rel_n < 0.0)

    def inv(m):
        return jnp.where(m > 0.0, 1.0 / jnp.where(m > 0.0, m, 1.0), 0.0)

    inv_mi = inv(mass_i)
    inv_m_sum = inv_mi[:, None] + inv(mass)[None, :]
    e = min(max(float(restitution), 0.0), 1.0)
    j_mag = jnp.where(active, -(1.0 + e) * v_rel_n / inv_m_sum, 0.0)

    # dv_i = sum_j (j_ij / m_i) n_ij; the (j, i) entry carries the equal and
    # opposite impulse automatically since n and v_rel both flip sign.
    scale_v = j_mag * inv_mi[:, None]
    dvel = jnp.stack(
        [jnp.sum(scale_v * nx, axis=1),
         jnp.sum(scale_v * ny, axis=1),
         jnp.sum(scale_v * nz, axis=1)],
        axis=-1,
    )

    overlap = radius_i[:, None] + radius[None, :] - dist
    corr = jnp.where(active & (overlap > 0.0), overlap / inv_m_sum, 0.0)
    scale_r = corr * inv_mi[:, None]
    dpos = jnp.stack(
        [jnp.sum(scale_r * nx, axis=1),
         jnp.sum(scale_r * ny, axis=1),
         jnp.sum(scale_r * nz, axis=1)],
        axis=-1,
    )
    return dpos, dvel


@partial(jax.jit, static_argnames=("restitution",))
def bounce_deltas(pos, vel, mass, radius, alive, *, restitution: float = 1.0):
    """Velocity and position corrections from restitution impulses.

    For each approaching overlapping pair (i, j): impulse magnitude
    j = -(1+e) * v_rel.n / (1/m_i + 1/m_j) along n = (r_i - r_j)/|.|,
    applied +j n / m_i to i and -j n / m_j to j, plus a mass-weighted
    positional de-overlap (reference: core/physics.py:391-422).

    Returns (dpos [N,3], dvel [N,3]) to be *added* to the state.
    """
    ids = jnp.arange(pos.shape[0])
    return _bounce_block(pos, vel, mass, radius, alive, ids,
                         pos, vel, mass, radius, alive, ids,
                         restitution=restitution)


@partial(jax.jit, static_argnames=("restitution", "chunk"))
def bounce_deltas_chunked(pos, vel, mass, radius, alive, *,
                          restitution: float = 1.0, chunk: int = 1024):
    """Row-blocked :func:`bounce_deltas` (O(chunk*N) memory): the bounce
    sweep above the dense [N, N] ceiling. N must divide by ``chunk``."""
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")
    ids = jnp.arange(n)

    def row_block(start):
        def sl(a):
            return lax.dynamic_slice_in_dim(a, start, chunk, axis=0)

        return _bounce_block(sl(pos), sl(vel), sl(mass), sl(radius),
                             sl(alive), sl(ids), pos, vel, mass, radius,
                             alive, ids, restitution=restitution)

    dpos, dvel = lax.map(row_block, jnp.arange(0, n, chunk))
    return dpos.reshape(n, 3), dvel.reshape(n, 3)


def _contacts_block(pos_i, radius_i, alive_i, ids_i, pos, radius, alive, ids):
    """Directed touching-pair count of all columns on a row block — the
    sqrt-free geometric test (r^2 <= (R_i+R_j)^2) the resolution sweeps
    share (reference detection: core/physics.py:513-518)."""
    dx = pos_i[:, None, 0] - pos[None, :, 0]
    dy = pos_i[:, None, 1] - pos[None, :, 1]
    dz = pos_i[:, None, 2] - pos[None, :, 2]
    r2 = dx * dx + dy * dy + dz * dz
    # slightly inflated threshold: strictly conservative vs the resolution
    # sweeps' sqrt-based test (a grazing pair may cost a redundant sweep
    # but can never skip a real one)
    rsum = (radius_i[:, None] + radius[None, :]) * 1.00001
    touch = ((r2 <= rsum * rsum)
             & (ids_i[:, None] != ids[None, :])
             & alive_i[:, None] & alive[None, :])
    # explicit dtype: x64 mode would otherwise promote the sum to int64
    return jnp.sum(touch, dtype=jnp.int32)


@jax.jit
def count_contacts_dense(pos, radius, alive):
    """Directed touching-pair count between live bodies (int32 scalar);
    0 exactly when no resolution sweep is needed this step."""
    ids = jnp.arange(pos.shape[0])
    return _contacts_block(pos, radius, alive, ids, pos, radius, alive, ids)


@partial(jax.jit, static_argnames=("chunk",))
def count_contacts_chunked(pos, radius, alive, *, chunk: int = 1024):
    """Row-blocked :func:`count_contacts_dense` (O(chunk*N) memory)."""
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")
    ids = jnp.arange(n)

    def row_block(start):
        pos_i = lax.dynamic_slice_in_dim(pos, start, chunk, axis=0)
        rad_i = lax.dynamic_slice_in_dim(radius, start, chunk, axis=0)
        alive_i = lax.dynamic_slice_in_dim(alive, start, chunk, axis=0)
        ids_i = lax.dynamic_slice_in_dim(ids, start, chunk, axis=0)
        return _contacts_block(pos_i, rad_i, alive_i, ids_i,
                               pos, radius, alive, ids)

    return jnp.sum(lax.map(row_block, jnp.arange(0, n, chunk)),
                   dtype=jnp.int32)


def collision_roots(pos, radius, alive):
    """Lowest-index root of each overlap chain, via pointer jumping.

    parent[j] = min{ i < j : touching(i, j) } (else j), then log2(N) rounds
    of root = parent[root]. Monotone parents guarantee convergence.
    """
    n = pos.shape[0]
    _, _, touching = _pair_geometry(pos, radius, alive)
    idx = jnp.arange(n)
    lower = touching & (idx[:, None] < idx[None, :])  # i < j touching pairs
    # For each column j, the smallest touching row i (or j itself).
    parent = jnp.min(jnp.where(lower, idx[:, None], n), axis=0)
    parent = jnp.minimum(parent, idx)

    n_rounds = max(1, int(n - 1).bit_length())
    root = parent
    for _ in range(n_rounds):
        root = root[root]
    return root


def collision_roots_chunked(pos, radius, alive, *, chunk: int = 512):
    """Column-blocked :func:`collision_roots`: O(N * chunk) live memory,
    lifting the dense [N, N] ceiling so merge mode runs at large N.
    Geometry matches ``_pair_geometry`` exactly (sqrt distances)."""
    n = pos.shape[0]
    chunk = min(chunk, n)
    while chunk > 1 and n % chunk != 0:
        chunk //= 2
    ids = jnp.arange(n)

    def col_block(start):
        pos_j = lax.dynamic_slice_in_dim(pos, start, chunk, axis=0)
        rad_j = lax.dynamic_slice_in_dim(radius, start, chunk, axis=0)
        alive_j = lax.dynamic_slice_in_dim(alive, start, chunk, axis=0)
        col_ids = start + jnp.arange(chunk)
        dx = pos[:, None, 0] - pos_j[None, :, 0]   # [N, C]
        dy = pos[:, None, 1] - pos_j[None, :, 1]
        dz = pos[:, None, 2] - pos_j[None, :, 2]
        dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        touching = (alive[:, None] & alive_j[None, :]
                    & (dist <= radius[:, None] + rad_j[None, :])
                    & (dist > 0.0)
                    & (ids[:, None] < col_ids[None, :]))
        parent = jnp.min(jnp.where(touching, ids[:, None], n), axis=0)
        return jnp.minimum(parent, col_ids)

    parent = lax.map(col_block, jnp.arange(0, n, chunk)).reshape(n)
    n_rounds = max(1, int(n - 1).bit_length())
    root = parent
    for _ in range(n_rounds):
        root = root[root]
    return root


@partial(jax.jit, static_argnames=("restitution", "debris_k",
                                   "debris_max_pairs", "debris_energy_frac",
                                   "debris_sep"))
def resolve_outcomes(pos, vel, mass, radius, alive, key, *,
                     restitution: float = 1.0,
                     debris_k: int = 0,
                     debris_max_pairs: int = 4,
                     debris_energy_frac: float = 0.3,
                     debris_sep: float = 1.0):
    """Collision *outcome model* as one simultaneous masked round.

    Device-native version of the reference's ``resolve_collision``
    (core/physics.py:361-388; host parity in ``models.objects``): for each
    touching pair of live bodies

      * mass ratio > 10 -> **absorption**: the smaller body is removed and
        the larger gains its mass and volume-additive radius. Matching the
        reference exactly, the absorber's position/velocity do NOT change
        (the reference's absorb branch transfers mass only — momentum is
        deliberately not conserved there).
      * else, with the logistic fragmentation probability
        p = sigmoid(5 (E_coll/E_thresh - 1)), E_coll = mu v_rel^2 / 2,
        E_thresh = (m1+m2) 1e3 / 2 -> **fragmentation**: both bodies are
        removed (by default debris generation is not modeled, as in the
        reference — its fragment branch at core/physics.py:378-383 removes
        both bodies with a "fragment generation not implemented" note).
      * else -> **elastic bounce** with ``restitution`` (the reference
        falls through to ``collide_spheres``).

    **Debris generation** (``debris_k > 0``) goes beyond the reference:
    each fragmenting pair spawns ``debris_k`` fragments into slots that
    were DEAD at entry (allocate spare capacity with
    ``make_state(..., spare=...)``). Per pair the fragments share the
    pair's total mass equally (mass exactly conserved), carry the pair's
    total momentum exactly (zero-sum spread velocities), keep the pair's
    total volume (radius = ((r1^3+r2^3)/K)^(1/3)), and receive
    ``debris_energy_frac`` of the collision kinetic energy as spread KE
    about the center of mass (the rest is dissipated — fragmentation is
    inelastic). They are placed ``debris_sep * (r1+r2)`` from the pair's
    center of mass along their spread directions. Static budgets: at most
    ``debris_max_pairs`` pairs spawn per round (fragmenting bodies are
    matched mutually-first; unmatched chain members and pairs beyond the
    budget or beyond the free-slot supply die WITHOUT debris, i.e. fall
    back to reference semantics). The spread directions derive from
    ``key``, independent of the fragmentation roll.

    Sequential-sweep differences (documented, same spirit as ``merge``):
    outcomes classify from the PRE-round state in one round with priority
    fragmentation > absorption > bounce per body; a small body touching
    several >10x absorbers donates its mass to the single largest one.

    ``key`` is a JAX PRNG key; the fragmentation draw is one uniform per
    unordered pair (symmetrized), so outcomes are reproducible per key.

    Returns ``(pos, vel, mass, radius, alive)`` updated. Dense [N, N]
    memory — this is a small-scene parity model (the engine rejects it
    above the dense ceiling).
    """
    n = pos.shape[0]
    (nx, ny, nz), dist, touching = _pair_geometry(pos, radius, alive)
    idx = jnp.arange(n)

    m_i, m_j = mass[:, None], mass[None, :]
    m_big = jnp.maximum(m_i, m_j)
    m_small = jnp.minimum(m_i, m_j)
    m_small_safe = jnp.where(m_small > 0.0, m_small, 1.0)
    absorb = touching & (m_small > 0.0) & (m_big > 10.0 * m_small_safe)

    # symmetric per-pair uniform draw for the fragmentation roll
    u_raw = jax.random.uniform(key, (n, n), dtype=pos.dtype)
    upper = idx[:, None] < idx[None, :]
    u = jnp.where(upper, u_raw, u_raw.T)

    dv = vel[:, None, :] - vel[None, :, :]
    v_rel2 = jnp.sum(dv * dv, axis=-1)
    m_sum = m_i + m_j
    m_sum_safe = jnp.where(m_sum > 0.0, m_sum, 1.0)
    mu_red = m_i * m_j / m_sum_safe
    e_coll = 0.5 * mu_red * v_rel2
    e_thresh = 0.5 * m_sum * 1e3
    p_frag = jax.nn.sigmoid(
        5.0 * (e_coll / jnp.where(e_thresh > 0.0, e_thresh, 1.0) - 1.0))
    frag = touching & ~absorb & (u < p_frag)

    # --- fragmentation: both endpoints of any frag pair die -------------
    frag_dead = jnp.any(frag, axis=1)

    # --- absorption: smaller side dies into its LARGEST live absorber ---
    # (ratio > 10 is strict, so the pair's smaller body is unique)
    is_smaller = absorb & (m_i < m_j) & ~frag_dead[:, None] & ~frag_dead[None, :]
    absorbed_dead = jnp.any(is_smaller, axis=1)
    # one-hot choice of absorber by mass (ties broken by lowest index)
    absorber = jnp.argmax(jnp.where(is_smaller, m_j, -1.0), axis=1)
    donate = jnp.where(absorbed_dead, mass, 0.0)
    donate_r3 = jnp.where(absorbed_dead, radius**3, 0.0)
    gained_m = jax.ops.segment_sum(donate, absorber, num_segments=n)
    gained_r3 = jax.ops.segment_sum(donate_r3, absorber, num_segments=n)

    dead = frag_dead | absorbed_dead
    new_mass = jnp.where(dead, 0.0, mass + gained_m)
    # bodies that absorbed nothing keep radius bit-exactly (the cbrt(r^3)
    # round-trip is ~1 ulp off identity)
    new_radius = jnp.where(dead, 0.0,
                           jnp.where(gained_r3 > 0.0,
                                     jnp.cbrt(radius**3 + gained_r3),
                                     radius))
    new_alive = alive & ~dead

    # --- elastic bounce for the remaining touching pairs ----------------
    survive_pair = ~dead[:, None] & ~dead[None, :]
    dv_n = dv[..., 0] * nx + dv[..., 1] * ny + dv[..., 2] * nz
    active = touching & ~absorb & ~frag & survive_pair & (dv_n < 0.0)
    inv_m = jnp.where(mass > 0.0, 1.0 / jnp.where(mass > 0.0, mass, 1.0), 0.0)
    inv_m_sum = inv_m[:, None] + inv_m[None, :]
    e = min(max(float(restitution), 0.0), 1.0)
    j_mag = jnp.where(active, -(1.0 + e) * dv_n / inv_m_sum, 0.0)
    scale_v = j_mag * inv_m[:, None]
    dvel = jnp.stack([jnp.sum(scale_v * nx, axis=1),
                      jnp.sum(scale_v * ny, axis=1),
                      jnp.sum(scale_v * nz, axis=1)], axis=-1)
    overlap = radius[:, None] + radius[None, :] - dist
    corr = jnp.where(active & (overlap > 0.0), overlap / inv_m_sum, 0.0)
    scale_r = corr * inv_m[:, None]
    dpos = jnp.stack([jnp.sum(scale_r * nx, axis=1),
                      jnp.sum(scale_r * ny, axis=1),
                      jnp.sum(scale_r * nz, axis=1)], axis=-1)

    # park dead bodies far away (same spread-out scheme as merge_groups)
    fidx = idx.astype(pos.dtype)
    live_mag = jnp.max(jnp.abs(pos) * new_alive[:, None].astype(pos.dtype))
    far = 1e8 * (1.0 + live_mag)
    if pos.dtype == jnp.float32:
        far = jnp.minimum(far, 1e17)
    far_pos = jnp.stack(
        [far * (1.0 + 1e-3 * fidx), jnp.full(n, 1.0, pos.dtype) * far,
         jnp.full(n, 1.0, pos.dtype) * far], axis=-1)
    new_pos = jnp.where(dead[:, None], far_pos, pos + dpos)
    new_vel = jnp.where(dead[:, None], 0.0, vel + dvel)
    if debris_k <= 0:
        return new_pos, new_vel, new_mass, new_radius, new_alive

    # --- debris spawn into entry-dead slots (static budgets) ------------
    K = int(debris_k)
    B = min(int(debris_max_pairs), n // K)
    if B <= 0:
        return new_pos, new_vel, new_mass, new_radius, new_alive
    # mutually-first matching of fragmenting bodies into unordered pairs
    # (frag is symmetric; chain members that aren't each other's first
    # partner die without debris — reference fallback)
    partner = jnp.argmax(frag, axis=1)
    mutual = frag_dead & (partner[partner] == idx) & (idx < partner)
    order = jnp.argsort(~mutual)          # stable: matched rows first
    pi = order[:B]
    pj = partner[pi]
    pair_ok = mutual[pi]
    # slot allocation: first B*K entry-dead slots, K consecutive per pair;
    # a pair spawns only if ALL its K slots are genuinely free (partial
    # spawns would break conservation)
    free = ~alive
    slots = jnp.argsort(~free)[:B * K].reshape(B, K)
    spawn = pair_ok & jnp.all(free[slots], axis=1)

    m1, m2 = mass[pi], mass[pj]
    mt = m1 + m2
    mt_safe = jnp.where(mt > 0.0, mt, 1.0)
    x_com = (m1[:, None] * pos[pi] + m2[:, None] * pos[pj]) / mt_safe[:, None]
    v_com = (m1[:, None] * vel[pi] + m2[:, None] * vel[pj]) / mt_safe[:, None]
    # zero-sum spread directions: momentum is conserved exactly
    d = jax.random.normal(jax.random.fold_in(key, 1), (B, K, 3),
                          dtype=pos.dtype)
    e_vec = d - jnp.mean(d, axis=1, keepdims=True)
    m_f = mt / K
    e2sum = jnp.sum(e_vec * e_vec, axis=(1, 2))
    ke = debris_energy_frac * e_coll[pi, pj]
    s = jnp.sqrt(2.0 * ke / (jnp.where(e2sum > 0.0, e2sum, 1.0)
                             * jnp.where(m_f > 0.0, m_f, 1.0)))
    s = jnp.where(e2sum > 0.0, s, 0.0)
    v_frag = v_com[:, None, :] + s[:, None, None] * e_vec
    e_norm = jnp.sqrt(jnp.sum(e_vec * e_vec, axis=-1, keepdims=True))
    u_vec = e_vec / jnp.where(e_norm > 0.0, e_norm, 1.0)
    sep = debris_sep * (radius[pi] + radius[pj])
    x_frag = x_com[:, None, :] + sep[:, None, None] * u_vec
    r_f = jnp.cbrt((radius[pi] ** 3 + radius[pj] ** 3) / K)

    flat = slots.reshape(-1)
    okf = jnp.repeat(spawn, K)
    mKf = jnp.broadcast_to(m_f[:, None], (B, K)).reshape(-1)
    rKf = jnp.broadcast_to(r_f[:, None], (B, K)).reshape(-1)
    new_mass = new_mass.at[flat].set(jnp.where(okf, mKf, new_mass[flat]))
    new_radius = new_radius.at[flat].set(
        jnp.where(okf, rKf, new_radius[flat]))
    new_alive = new_alive.at[flat].set(okf | new_alive[flat])
    new_pos = new_pos.at[flat].set(
        jnp.where(okf[:, None], x_frag.reshape(-1, 3), new_pos[flat]))
    new_vel = new_vel.at[flat].set(
        jnp.where(okf[:, None], v_frag.reshape(-1, 3), new_vel[flat]))
    return new_pos, new_vel, new_mass, new_radius, new_alive


@partial(jax.jit, static_argnames=("subset", "chunk", "restitution",
                                   "debris_k", "debris_max_pairs",
                                   "debris_energy_frac", "debris_sep"))
def resolve_outcomes_subset(pos, vel, mass, radius, alive, key, *,
                            subset: int = 512,
                            chunk: int = 1024,
                            restitution: float = 1.0,
                            debris_k: int = 0,
                            debris_max_pairs: int = 4,
                            debris_energy_frac: float = 0.3,
                            debris_sep: float = 1.0):
    """Contact-subset wrapper scaling :func:`resolve_outcomes` past the
    dense [N, N] ceiling (the reference's outcome model at the N where
    collisions actually matter — planetesimal scales).

    A column-blocked O(N^2 / chunk)-memory sweep marks every body in
    contact (same criterion as ``_pair_geometry``); a single stable
    priority sort (touching bodies first, then dead slots for debris
    spawn, then the rest) picks ``subset + debris capacity`` rows; the
    UNCHANGED dense outcome model runs on that small gathered scene and
    the results scatter back through the (unique) gathered indices.
    Bodies not in contact pass through the dense model bit-unchanged, so
    parity with the full dense evaluation holds whenever the contact
    count fits ``subset``.

    Returns ``(pos, vel, mass, radius, alive, deferred)`` where
    ``deferred`` counts touching bodies beyond the budget this round.
    Deferral is not loss: an unresolved overlap is still overlapping
    next step and re-detected then (the caller's contact gate re-fires),
    so chains drain at >= ``subset`` bodies per step; the counter makes
    the deferral observable, per the counted-never-silent contract.

    The fragmentation roll draws its per-pair uniforms on the SUBSET's
    pair matrix, so individual rolls differ from the full dense path
    (documented; the model and its probabilities are identical). Dead
    bodies' park positions likewise derive from the subset scene's
    extent and local indices — they honor the "far from every live
    body" contract, not bit-parity with the dense path.
    """
    n = pos.shape[0]
    S = int(subset)
    D = int(debris_max_pairs) * int(debris_k) if debris_k > 0 else 0
    T = min(n, S + D)
    B = int(chunk)
    nb = -(-n // B)
    npad = nb * B

    def pad(a, fill):
        return jnp.pad(a, ((0, npad - n),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    pos_p = pad(pos, 1.0e17 if pos.dtype == jnp.float32 else 1.0e30)
    rad_p, alive_p = pad(radius, 0.0), pad(alive, False)

    def i_block(i0):
        pi = lax.dynamic_slice(pos_p, (i0, 0), (B, 3))
        ri = lax.dynamic_slice(rad_p, (i0,), (B,))
        ai = lax.dynamic_slice(alive_p, (i0,), (B,))
        dx = pi[:, None, 0] - pos_p[None, :, 0]
        dy = pi[:, None, 1] - pos_p[None, :, 1]
        dz = pi[:, None, 2] - pos_p[None, :, 2]
        dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        touch = (ai[:, None] & alive_p[None, :]
                 & (dist <= ri[:, None] + rad_p[None, :]) & (dist > 0.0))
        return jnp.any(touch, axis=1)

    touch_any = lax.map(i_block, jnp.arange(0, npad, B)).reshape(npad)[:n]
    n_touch = jnp.sum(touch_any, dtype=jnp.int32)
    deferred = jnp.maximum(n_touch - S, 0)

    # one stable priority sort -> unique gathered indices: contacts first
    # (by index, matching the dense model's low-index tie-breaks), then
    # dead slots (debris capacity), then inert live bodies as padding
    prio = jnp.where(touch_any, 0, jnp.where(~alive, 1, 2)).astype(jnp.int32)
    idx_sub = jnp.argsort(prio, stable=True)[:T]

    out = resolve_outcomes(
        pos[idx_sub], vel[idx_sub], mass[idx_sub], radius[idx_sub],
        alive[idx_sub], key, restitution=restitution, debris_k=debris_k,
        debris_max_pairs=debris_max_pairs,
        debris_energy_frac=debris_energy_frac, debris_sep=debris_sep)
    s_pos, s_vel, s_mass, s_rad, s_alive = out
    return (pos.at[idx_sub].set(s_pos), vel.at[idx_sub].set(s_vel),
            mass.at[idx_sub].set(s_mass), radius.at[idx_sub].set(s_rad),
            alive.at[idx_sub].set(s_alive), deferred)


@partial(jax.jit, static_argnames=("chunk",))
def merge_groups(pos, vel, mass, radius, alive, *, chunk=None):
    """Merge every overlap chain into its lowest-index member.

    Conserves mass and momentum; the merged position is the mass-weighted
    center and the merged radius is volume-additive, matching the
    reference's merge-on-capture semantics (core/physics.py:519-531).
    Non-root members become dead: alive=False, mass=0, velocity=0, parked
    at a spread-out far position (out of reach of any live radius, mutually
    non-coincident) so the fused contact detection never re-triggers on
    them.

    Returns (pos, vel, mass, radius, alive) updated. ``chunk`` switches the
    contact-chain root finding to the column-blocked path (required above
    the dense [N, N] memory ceiling, ~8k bodies).
    """
    n = pos.shape[0]
    if chunk:
        root = collision_roots_chunked(pos, radius, alive,
                                       chunk=min(int(chunk), n))
    else:
        root = collision_roots(pos, radius, alive)
    is_root = root == jnp.arange(n)

    m_seg = jax.ops.segment_sum(mass, root, num_segments=n)
    p_seg = jax.ops.segment_sum(mass[:, None] * vel, root, num_segments=n)
    mr_seg = jax.ops.segment_sum(mass[:, None] * pos, root, num_segments=n)
    r3_seg = jax.ops.segment_sum(radius**3, root, num_segments=n)
    size_seg = jax.ops.segment_sum(alive.astype(jnp.int32), root, num_segments=n)

    # Only bodies in a multi-member contact chain change at all; everything
    # else (including massless tracers) passes through untouched.
    changed = size_seg[root] > 1
    absorbed = changed & ~is_root
    merged_root = changed & is_root

    safe_m = jnp.where(m_seg > 0.0, m_seg, 1.0)
    new_mass = jnp.where(merged_root, m_seg, jnp.where(absorbed, 0.0, mass))
    new_vel = jnp.where(
        merged_root[:, None], p_seg / safe_m[:, None],
        jnp.where(absorbed[:, None], 0.0, vel),
    )
    # absorbed bodies park far away (scaled off the live scene so the scale
    # never escalates as more bodies die); index-proportional spacing keeps
    # dead pairs non-coincident even in f32
    idx = jnp.arange(n, dtype=pos.dtype)
    live_mag = jnp.max(jnp.abs(pos) * alive[:, None].astype(pos.dtype))
    far = 1e8 * (1.0 + live_mag)
    if pos.dtype == jnp.float32:
        far = jnp.minimum(far, 1e17)  # keep far^2 finite in f32
    far_pos = jnp.stack(
        [far * (1.0 + 1e-3 * idx), jnp.full(n, 1.0, pos.dtype) * far,
         jnp.full(n, 1.0, pos.dtype) * far], axis=-1)
    new_pos = jnp.where(
        merged_root[:, None], mr_seg / safe_m[:, None],
        jnp.where(absorbed[:, None], far_pos, pos))
    new_radius = jnp.where(merged_root, jnp.cbrt(r3_seg), jnp.where(absorbed, 0.0, radius))
    new_alive = alive & ~absorbed
    return new_pos, new_vel, new_mass, new_radius, new_alive
