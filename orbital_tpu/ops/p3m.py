r"""P3M gravity: particle-mesh far field + exact short-range correction.

PM alone smooths forces below the mesh scale (ops/pm.py contract); P3M
restores near-exact pair forces at large N by Ewald-splitting the softened
kernel (Hockney & Eastwood):

    1/sqrt(r^2+eps^2) = erf(r/2s)/r  +  [1/sqrt(r^2+eps^2) - erf(r/2s)/r]
                        \__ mesh __/     \__ short range, ~0 past ~4.5s __/

The mesh solves the smooth erf kernel (same deconvolved-CIC pipeline as
``ops.pm``, split scale s = ``sigma_cells`` mesh cells); the short-range
remainder is summed exactly over neighbor cells of an r_cut-sized cell
grid, built with static shapes:

  * bodies are binned by argsort(cell_id); rank-in-cell comes from a
    searchsorted against the sorted ids (all static shapes);
  * a [cells+1, capacity] index table holds up to ``capacity`` bodies per
    cell (the +1 row is an all-sentinel pad for out-of-range neighbors and
    dead bodies); bodies beyond capacity are *dropped from the short-range
    sum* and counted — the returned ``overflow`` must be 0 for exact
    results (raise capacity or cut_sigma otherwise);
  * a lax.map over cell blocks computes each cell's bodies against its 27
    neighbors' ([M] x [27 M] masked pair tiles) and segment-sums back.

When to use: large-N systems with bounded density contrast (uniform /
cosmological-style media) that need better-than-mesh force accuracy —
measured 2.9e-3 RMS force error vs the exact sweep (grid 64, defaults)
at softenings far below the mesh scale (time per eval on the GPU: not
measured yet).
Strongly concentrated clusters overflow any fixed per-cell capacity
(centrally ~1000s of bodies per r_cut cell); use the exact kernels or PM
there. The reference has no analog (exact O(N^2) only); this extends the
framework past the exact path's single-chip ceiling with near-exact
forces.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .pm import _pm_core
from .tree import _segment_bounds

__all__ = ["p3m_acc_potential", "p3m_ring_force", "p3m_overflow_probe",
           "p3m_max_occupancy"]

_OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]


def _short_factors(r2, sigma, eps2):
    """Short-range acceleration factor g(r) (acc = G m_j g(r) (r_j - r_i))
    and potential kernel K_short(r), both finite at r = 0 (self-pairs are
    index-masked anyway; the guard keeps the math NaN-free)."""
    alpha = 1.0 / (2.0 * sigma)
    safe = r2 > 0.0
    r2s = jnp.where(safe, r2, 1.0)
    r = jnp.sqrt(r2s)
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    erf_t = jax.scipy.special.erf(alpha * r)
    gauss = (2.0 * alpha / math.sqrt(math.pi)) * jnp.exp(-(alpha * r) ** 2)
    g_exact = jax.lax.rsqrt(r2 + eps2) / (r2 + eps2)
    g_long = (erf_t - gauss * r) * inv_r3
    g = jnp.where(safe, g_exact - g_long, 0.0)
    # at r = 0 between DISTINCT bodies (degenerate ICs; self-pairs are
    # index-masked by the caller) the pair potential is finite:
    # K_short(0) = 1/eps - lim erf(ar)/r = 1/eps - 2a/sqrt(pi)
    k0 = eps2 ** -0.5 - 2.0 * alpha / math.sqrt(math.pi)
    k_short = jnp.where(safe,
                        jax.lax.rsqrt(r2s + eps2) - erf_t * inv_r, k0)
    return g, k_short


@partial(jax.jit,
         static_argnames=("G_grav", "eps2", "grid", "sigma_cells",
                          "cut_sigma", "capacity", "cell_block",
                          "with_potential", "deconvolve"))
def p3m_acc_potential(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G_grav: float,
    eps2: float,
    grid: int = 64,
    sigma_cells: float = 1.5,
    cut_sigma: float = 4.5,
    capacity: int = 64,
    cell_block: int = 32,
    with_potential: bool = True,
    deconvolve: bool = True,
    box=None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """P3M accelerations, potential, and the short-range overflow count.

    ``box = (center [3], half)`` pins the mesh AND the short-range cell
    grid (recommended for long rollouts — a fixed split makes the total
    force conservative; see ops.pm._pm_core).

    Returns (acc [N,3], U, overflow int32). ``overflow`` counts live
    bodies that did not fit their cell's ``capacity`` and were excluded
    from the short-range sum (0 = exact within the split's ~erfc(cut/2)
    truncation). Requires eps2 > 0 and eps <~ the split scale
    (sigma_cells mesh cells) — P3M exists to resolve *below* the mesh.
    """
    if eps2 <= 0.0:
        raise ValueError("the P3M solver requires eps2 > 0")
    n = pos.shape[0]
    g = int(grid)
    f32 = jnp.float32

    pos32 = pos.astype(f32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    alive_f = alive_b.astype(f32)
    m_eff = mass.astype(f32) * alive_f

    # ---- far field: mesh solve of the smooth erf kernel -------------------
    def kern_long(r2_grid, h):
        sigma = sigma_cells * h
        rg = jnp.sqrt(r2_grid)
        safe = rg > 0.0
        return jnp.where(
            safe,
            jax.scipy.special.erf(rg / (2.0 * sigma)) / jnp.where(safe, rg, 1.0),
            1.0 / (sigma * math.sqrt(math.pi)))

    acc_mesh, phi_at, h, center, half = _pm_core(
        pos32, m_eff, alive_f, g=g, G_grav=G_grav, kern_builder=kern_long,
        with_potential=with_potential, axis_name=None, deconvolve=deconvolve,
        box=box)
    sigma = sigma_cells * h
    rcut2 = (cut_sigma * sigma) ** 2

    # ---- short range: static-capacity cell lists --------------------------
    # cell size >= r_cut by construction: gc cells span the same cube as
    # the g-cell mesh (center/half come FROM the mesh solve, so the split
    # and the cell grid can never desynchronize), gc <= g / (sigma_cells
    # * cut_sigma)
    gc = max(1, int(g / (sigma_cells * cut_sigma)))
    gc3 = gc * gc * gc
    origin = center - half
    s_cell = 2.0 * half / gc

    cc = jnp.clip(jnp.floor((pos32 - origin) / s_cell).astype(jnp.int32),
                  0, gc - 1)
    cell_id = (cc[:, 0] * gc + cc[:, 1]) * gc + cc[:, 2]
    cell_id = jnp.where(alive_b, cell_id, gc3)  # dead bodies -> pad row

    order = jnp.argsort(cell_id)
    sc = cell_id[order]
    # scan-based segment bounds instead of 2n binary searches
    # (ops/tree.py)
    first, _ = _segment_bounds(sc)
    rank = jnp.arange(n, dtype=jnp.int32) - first
    keep = (rank < capacity) & (sc < gc3)
    overflow = jnp.sum((rank >= capacity) & (sc < gc3), dtype=jnp.int32)

    s_row = jnp.where(keep, sc, gc3)
    r_col = jnp.clip(rank, 0, capacity - 1)
    table = jnp.full((gc3 + 1, capacity), n, jnp.int32)
    table = table.at[s_row, r_col].set(
        jnp.where(keep, order.astype(jnp.int32), n))

    # per-cell body data built by SCATTERING the cell-id-sorted bodies
    # (5n elements) instead of gathering gc3 x M table elements — every
    # table row is a prefix of the sorted body array, the same inversion
    # the tree's pack uses (ops/tree.py). Unfilled
    # slots keep the sentinel (far away, massless), matching the old
    # pos_pad[table] semantics.
    cell_pos = jnp.broadcast_to(
        jnp.full((3,), 1e30, f32), (gc3 + 1, capacity, 3))
    cell_pos = cell_pos.at[s_row, r_col].set(
        jnp.where(keep[:, None], pos32[order], 1e30),
        mode="drop")                                     # [gc3+1, M, 3]
    cell_m = jnp.zeros((gc3 + 1, capacity), f32).at[s_row, r_col].set(
        jnp.where(keep, m_eff[order], 0.0),
        mode="drop")                                     # [gc3+1, M]

    n_blocks = -(-gc3 // cell_block)

    def block(c0):
        cells = c0 + jnp.arange(cell_block)
        valid_cell = cells < gc3
        cells_c = jnp.where(valid_cell, cells, gc3)
        cz = cells % gc
        cy = (cells // gc) % gc
        cx = cells // (gc * gc)

        nb_ids = []
        for a, b, c in _OFFSETS:
            nx, ny, nz = cx + a, cy + b, cz + c
            ok = ((0 <= nx) & (nx < gc) & (0 <= ny) & (ny < gc)
                  & (0 <= nz) & (nz < gc) & valid_cell)
            nb_ids.append(jnp.where(ok, (nx * gc + ny) * gc + nz, gc3))
        nb = jnp.stack(nb_ids, axis=1)                   # [B, 27]

        idx_my = table[cells_c]                          # [B, M]
        idx_nb = table[nb].reshape(cell_block, -1)       # [B, 27M]

        pi = cell_pos[cells_c]                           # [B, M, 3]
        pj = cell_pos[nb].reshape(cell_block, -1, 3)     # [B, 27M, 3]
        mj = cell_m[nb].reshape(cell_block, -1)          # [B, 27M]

        dx = pj[:, None, :, 0] - pi[:, :, None, 0]       # [B, M, 27M]
        dy = pj[:, None, :, 1] - pi[:, :, None, 1]
        dz = pj[:, None, :, 2] - pi[:, :, None, 2]
        r2 = dx * dx + dy * dy + dz * dz
        pair_ok = ((idx_my[:, :, None] != idx_nb[:, None, :])
                   & (r2 < rcut2))
        gsh, ksh = _short_factors(r2, sigma, eps2)
        w = jnp.where(pair_ok, mj[:, None, :] * gsh, 0.0)
        acc_b = G_grav * jnp.stack(
            [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1), jnp.sum(w * dz, -1)],
            axis=-1)                                     # [B, M, 3]
        pe_b = jnp.sum(jnp.where(pair_ok, mj[:, None, :] * ksh, 0.0), -1)
        return idx_my, acc_b, pe_b

    starts = jnp.arange(0, n_blocks * cell_block, cell_block)
    idx_all, acc_all, pe_all = jax.lax.map(block, starts)
    idx_flat = idx_all.reshape(-1)
    acc_short = jax.ops.segment_sum(
        acc_all.reshape(-1, 3), idx_flat, num_segments=n + 1)[:n]
    pe_short = jax.ops.segment_sum(
        pe_all.reshape(-1), idx_flat, num_segments=n + 1)[:n]

    acc = (acc_mesh + acc_short) * alive_f[:, None]

    if with_potential:
        # mesh self-interaction under the erf kernel: -G m K_long(0)
        self_phi = -G_grav * m_eff * (1.0 / (sigma * math.sqrt(math.pi)))
        U_mesh = 0.5 * jnp.sum(m_eff * (phi_at - self_phi))
        U = U_mesh + (-0.5 * G_grav) * jnp.sum(m_eff * pe_short)
    else:
        U = jnp.zeros((), f32)
    return acc.astype(pos.dtype), U.astype(pos.dtype), overflow


def p3m_ring_force(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G_grav: float,
    eps2: float,
    grid: int = 64,
    sigma_cells: float = 1.5,
    cut_sigma: float = 4.5,
    capacity: int = 64,
    cell_block: int = 32,
    with_potential: bool = True,
    deconvolve: bool = True,
    box=None,
    axis_name: str,
    n_shards: int,
) -> tuple[jax.Array, jax.Array]:
    """Body-sharded P3M for use *inside* ``shard_map``: per-device body
    shards in, per-device acc shard + replicated total potential out.

    Composition: the mesh part is the standard sharded PM pipeline (local
    CIC deposit, ONE psum of the mass grid, replicated FFT — the box is
    agreed collectively or pinned via ``box``). The short-range cell-list
    correction rides a ``lax.ppermute`` ring like the exact force: every
    round the visiting (positions, masses, global-ids) block is re-binned
    into the SAME global cell grid and each local cell sums its bodies
    against the visitors in its 27-neighborhood; global ids make self-pair
    exclusion exact in the diagonal round.

    Scaling contract (be honest about it): this removes the single-device
    *memory* ceiling (each chip holds N/D bodies and the mesh deposit/
    gather scale with N/D), but the short-range sweep is ring-replicated —
    each chip still does ~N x 27 x capacity pair work per force call, so
    short-range wall time matches a single chip at the same total N rather
    than dividing by D (domain decomposition, not done here, would be the
    next step). Capacity overflow is NOT returned on this path (a ForceFn
    returns (acc, U)); size ``capacity`` with :func:`p3m_max_occupancy`
    on the full body set before sharding.
    """
    if eps2 <= 0.0:
        raise ValueError("the P3M solver requires eps2 > 0")
    nloc = pos.shape[0]
    g = int(grid)
    f32 = jnp.float32

    pos32 = pos.astype(f32)
    alive_b = (jnp.ones((nloc,), bool) if alive is None
               else alive.astype(bool))
    alive_f = alive_b.astype(f32)
    m_eff = mass.astype(f32) * alive_f

    def kern_long(r2_grid, h):
        sigma = sigma_cells * h
        rg = jnp.sqrt(r2_grid)
        safe = rg > 0.0
        return jnp.where(
            safe,
            jax.scipy.special.erf(rg / (2.0 * sigma)) / jnp.where(safe, rg, 1.0),
            1.0 / (sigma * math.sqrt(math.pi)))

    acc_mesh, phi_at, h, center, half = _pm_core(
        pos32, m_eff, alive_f, g=g, G_grav=G_grav, kern_builder=kern_long,
        with_potential=with_potential, axis_name=axis_name,
        deconvolve=deconvolve, box=box)
    sigma = sigma_cells * h
    rcut2 = (cut_sigma * sigma) ** 2
    gc = max(1, int(g / (sigma_cells * cut_sigma)))
    gc3 = gc * gc * gc
    origin = center - half
    s_cell = 2.0 * half / gc

    def bin_pack(p32, a_b, channels, sentinels):
        """Scatter-packed per-cell channel tables [gc3+1, M(, C)] on the
        agreed global grid — every table row is a prefix of the
        cell-id-sorted body array, so the bodies are scattered into the
        tables instead of gathering gc3 x M elements (the inversion from
        ops/tree.py; sentinel row gc3 stays all-sentinel)."""
        nb = p32.shape[0]
        cc = jnp.clip(jnp.floor((p32 - origin) / s_cell).astype(jnp.int32),
                      0, gc - 1)
        cid = (cc[:, 0] * gc + cc[:, 1]) * gc + cc[:, 2]
        cid = jnp.where(a_b, cid, gc3)
        order = jnp.argsort(cid)
        sct = cid[order]
        first, _ = _segment_bounds(sct)
        rk = jnp.arange(nb, dtype=jnp.int32) - first
        keep = (rk < capacity) & (sct < gc3)
        s_row = jnp.where(keep, sct, gc3)
        r_col = jnp.clip(rk, 0, capacity - 1)
        out = []
        for ch, sent in zip(channels, sentinels):
            sent = jnp.asarray(sent, ch.dtype)
            chs = ch[order]
            if ch.ndim == 2:
                base = jnp.broadcast_to(
                    sent, (gc3 + 1, capacity, ch.shape[1]))
                val = jnp.where(keep[:, None], chs, sent)
            else:
                base = jnp.full((gc3 + 1, capacity), sent, ch.dtype)
                val = jnp.where(keep, chs, sent)
            out.append(base.at[s_row, r_col].set(val, mode="drop"))
        return out

    gid0 = (lax.axis_index(axis_name).astype(jnp.int32) * nloc
            + jnp.arange(nloc, dtype=jnp.int32))
    my_tbl, gid_tbl_i, cell_pos_i = bin_pack(
        pos32, alive_b,
        [jnp.arange(nloc, dtype=jnp.int32), gid0, pos32],
        [nloc, -2, 1e30])

    n_blocks = -(-gc3 // cell_block)
    starts = jnp.arange(0, n_blocks * cell_block, cell_block)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def sweep(visit):
        pos_j, m_j, alive_j, gid_j = visit
        cell_pos_j, cell_m_j, cell_g_j = bin_pack(
            pos_j, alive_j, [pos_j, m_j, gid_j], [1e30, 0.0, -1])

        def block(c0):
            cells = c0 + jnp.arange(cell_block)
            valid_cell = cells < gc3
            cells_c = jnp.where(valid_cell, cells, gc3)
            cz = cells % gc
            cy = (cells // gc) % gc
            cx = cells // (gc * gc)
            nb_ids = []
            for a, b, c in _OFFSETS:
                nx, ny, nz = cx + a, cy + b, cz + c
                ok = ((0 <= nx) & (nx < gc) & (0 <= ny) & (ny < gc)
                      & (0 <= nz) & (nz < gc) & valid_cell)
                nb_ids.append(jnp.where(ok, (nx * gc + ny) * gc + nz, gc3))
            nb = jnp.stack(nb_ids, axis=1)             # [B, 27]

            idx_my = my_tbl[cells_c]                   # [B, M] local indices
            gid_my = gid_tbl_i[cells_c]
            pi = cell_pos_i[cells_c]                   # [B, M, 3]
            pj = cell_pos_j[nb].reshape(cell_block, -1, 3)
            mj = cell_m_j[nb].reshape(cell_block, -1)
            gj = cell_g_j[nb].reshape(cell_block, -1)

            dx = pj[:, None, :, 0] - pi[:, :, None, 0]
            dy = pj[:, None, :, 1] - pi[:, :, None, 1]
            dz = pj[:, None, :, 2] - pi[:, :, None, 2]
            r2 = dx * dx + dy * dy + dz * dz
            pair_ok = (gid_my[:, :, None] != gj[:, None, :]) & (r2 < rcut2)
            gsh, ksh = _short_factors(r2, sigma, eps2)
            w = jnp.where(pair_ok, mj[:, None, :] * gsh, 0.0)
            acc_b = G_grav * jnp.stack(
                [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1),
                 jnp.sum(w * dz, -1)], axis=-1)
            pe_b = jnp.sum(jnp.where(pair_ok, mj[:, None, :] * ksh, 0.0), -1)
            return idx_my, acc_b, pe_b

        idx_all, acc_all, pe_all = jax.lax.map(block, starts)
        idx_flat = idx_all.reshape(-1)
        a = jax.ops.segment_sum(acc_all.reshape(-1, 3), idx_flat,
                                num_segments=nloc + 1)[:nloc]
        p = jax.ops.segment_sum(pe_all.reshape(-1), idx_flat,
                                num_segments=nloc + 1)[:nloc]
        return a, p

    def round_k(k, carry):
        acc_s, pe_s, visit = carry
        a_r, p_r = sweep(visit)
        visit = tuple(lax.ppermute(x, axis_name, perm=fwd) for x in visit)
        return acc_s + a_r, pe_s + p_r, visit

    visit0 = (pos32, m_eff, alive_b, gid0)
    # zeros derive from shard-varying values so the carry's varying manual
    # axes match the loop body's outputs (shard_map vma checking)
    acc_s, pe_s, _ = lax.fori_loop(
        0, n_shards, round_k,
        (jnp.zeros_like(pos32), jnp.zeros_like(m_eff), visit0))

    acc = (acc_mesh + acc_s) * alive_f[:, None]
    if with_potential:
        self_phi = -G_grav * m_eff * (1.0 / (sigma * math.sqrt(math.pi)))
        u_local = (0.5 * jnp.sum(m_eff * (phi_at - self_phi))
                   + (-0.5 * G_grav) * jnp.sum(m_eff * pe_s))
        U = lax.psum(u_local, axis_name)
    else:
        U = jnp.zeros((), f32)
    return acc.astype(pos.dtype), U.astype(pos.dtype)


@partial(jax.jit,
         static_argnames=("grid", "sigma_cells", "cut_sigma"))
def p3m_max_occupancy(
    pos: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    grid: int = 64,
    sigma_cells: float = 1.5,
    cut_sigma: float = 4.5,
    box=None,
) -> jax.Array:
    """Max live bodies in any short-range cell — the capacity sizer.

    Bins exactly like :func:`p3m_acc_potential` (same box, cell grid, and
    dead-body handling) but costs one cheap segment-sum with NO capacity
    dependence, so auto-sizing needs a single compile instead of probing
    capacities through full force evaluations."""
    from .pm import _bounding_cube

    n = pos.shape[0]
    g = int(grid)
    f32 = jnp.float32
    pos32 = pos.astype(f32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    gc = max(1, int(g / (sigma_cells * cut_sigma)))
    gc3 = gc * gc * gc
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.astype(f32), g, None)
    else:
        center = jnp.asarray(box[0], f32)
        half = jnp.asarray(box[1], f32)
    s_cell = 2.0 * half / gc
    cc = jnp.clip(jnp.floor((pos32 - (center - half)) / s_cell)
                  .astype(jnp.int32), 0, gc - 1)
    cell_id = (cc[:, 0] * gc + cc[:, 1]) * gc + cc[:, 2]
    cell_id = jnp.where(alive_b, cell_id, gc3)
    counts = jax.ops.segment_sum(alive_b.astype(jnp.int32), cell_id,
                                 num_segments=gc3 + 1)
    return jnp.max(counts[:gc3])


def p3m_overflow_probe(state, cfg) -> int:
    """Short-range capacity check for a live simulation state.

    The stepper's force path drops the overflow counter (a ForceFn returns
    only (acc, U)), so a system whose density grows mid-rollout can start
    silently losing short-range pairs. Call this between rollout chunks —
    a nonzero return means cfg.p3m_capacity must grow (or the box/grid
    change) before the results can be trusted.
    """
    _, _, ov = p3m_acc_potential(
        state.pos, state.mass, state.alive, G_grav=cfg.G, eps2=cfg.eps2,
        grid=cfg.pm_grid, capacity=cfg.p3m_capacity, with_potential=False,
        box=cfg.pm_box_arrays())
    return int(ov)
