"""Switched short-range neighbor force for the multirate (RESPA) stepper.

The multirate integrator (``engine/multirate.py``) splits the softened
pairwise potential (reference semantics: core/physics.py:125-159) into a
SMOOTH near/far pair by a quintic switch S(r) on the true pair distance:

    V(r)      = -G m m' / sqrt(r^2 + eps^2)
    V_near(r) = V(r) * S(r)          S = 1 for r <= r1, 0 for r >= rc
    V_far(r)  = V(r) * (1 - S(r))

Both parts are exact gradients of fixed smooth Hamiltonians (the switch
lives on r, NOT on any cell structure), so the impulse-MTS composition
    V_far(K dt/2) [V_near(dt/2) D(dt) V_near(dt/2)]^K V_far(K dt/2)
is symplectic: the cell geometry below is only a SEARCH structure for the
pairs where S > 0 — it never enters the dynamics, so rebuilding or
clipping it cannot break energy conservation (unlike PM's mesh refit,
DESIGN.md "particle-mesh solver").

This module provides that search structure and the per-substep sweep:

  * ``neighbor_geometry`` bins bodies on an M^3 grid of cell size
    ``cell = rc + skin``, cell-id-sorts them, chunks each (x, y) column
    into C-body rows (reusing the tree's ``_pairs_geometry``), and
    flattens each i-chunk's z-trimmed 9-neighbor-column runs into a fixed
    table of RJ-row j-BLOCKS (``_block_runs`` dedup). Frozen for a whole
    K-substep macro window: a pair within rc at any substep was within
    rc + skin at the sync point (each body moves <= skin/2 — checked), so
    it is covered by the frozen geometry; pairs outside are killed
    exactly by S(r) = 0. Boundary clipping is coverage-safe (clipping is
    monotone per axis, so it can only move pairs CLOSER in cell units).
  * ``pack_slots`` / ``unpack_slots`` scatter body channels into the
    chunk-slot table once per macro window; the inner loop integrates in
    slot space so no per-substep gather/scatter of body data is needed.
  * ``near_acc_slots`` evaluates the switched short-range acceleration
    over the frozen j-block table (gather-based XLA, on every platform;
    ``near_acc_dense`` is its brute-force test oracle).

Budget contract (same as every sparse solver in this tree, DESIGN.md):
static budgets (``max_chunks``, ``w_blk``) are probe-sized from the
distribution with headroom; bodies or blocks past them are DROPPED and
counted, never silently lost — the multirate stepper integrates dropped
bodies ballistically on the held total force for that window and reports
the count.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .tree import _pairs_geometry

__all__ = [
    "neighbor_geometry", "neighbor_budgets", "pack_slots", "unpack_slots",
    "pack_rows", "unpack_rows",
    "near_acc_slots", "near_acc_dense", "switch_terms", "SENTINEL_POS",
]

f32 = jnp.float32
i32 = jnp.int32

# parked position for sentinel (padding) chunk slots: far from any live
# body, squared-distance still finite in f32 ((2e15)^2 = 4e30 < 3.4e38)
SENTINEL_POS = 1.0e15


def _block_runs(g, rj: int, k_ch: int, kpad: int):
    """RJ-aligned, deduplicated j-block runs per (i-chunk, neighbor).

    ``_pairs_geometry`` emits the 9 (at ws=1) neighbor runs in increasing
    table order (its ``nb2`` loop walks column ids ascending and distinct
    columns occupy disjoint, ascending chunk-row ranges), so a running
    coverage watermark dedups the overlap that RJ-rounding introduces
    between adjacent runs — without it a table row shared by two rounded
    blocks of the SAME i-chunk would be double-counted (the sweep's cell
    band passes it both times).

    Returns ``(start_blk, n_blk)`` of shape [K_ch, n_nb], in j-block units.
    """
    j_lo, cnt = g["j_lo"], g["cnt"]  # [K_ch, n_nb], chunk-row units
    max_blk = kpad // rj
    has = cnt > 0
    lo_blk = jnp.where(has, j_lo // rj, 0)
    hi_blk = jnp.where(has, jnp.minimum(-(-(j_lo + cnt) // rj), max_blk), 0)
    watermark = jnp.zeros((k_ch,), i32)
    starts, counts = [], []
    for t in range(j_lo.shape[1]):
        s = jnp.maximum(lo_blk[:, t], watermark)
        c = jnp.where(has[:, t], jnp.maximum(hi_blk[:, t] - s, 0), 0)
        starts.append(jnp.where(c > 0, s, 0))
        counts.append(c)
        watermark = jnp.where(has[:, t],
                              jnp.maximum(watermark, hi_blk[:, t]),
                              watermark)
    return jnp.stack(starts, axis=1), jnp.stack(counts, axis=1)


def switch_terms(r2t, r1: float, rc: float):
    """Quintic-smoothstep switch on the TRUE squared distance r2t.

    s = clip((rc^2 - r2t) / (rc^2 - r1^2), 0, 1);  S = s^3 (10 - 15 s + 6 s^2)
    (C^2 — the switched force is C^1, enough for leapfrog's error theory).
    Returns ``(S, sp_over_D)`` where ``sp_over_D = (dS/ds) / (rc^2 - r1^2)``
    — the factor in the conservative shell-force correction:

        a_near(i<-j) = G dx [ m_j (S * invr^3 + 2 * sp_over_D * invr) ]

    (from -grad_i [Phi(r) S(r^2)] with Phi = -G m_j invr and
    grad_i r^2 = -2 dx; both terms vanish with dx, so self-pairs
    contribute exactly zero when eps2 > 0 keeps invr finite).
    """
    inv_d = 1.0 / (rc * rc - r1 * r1)
    s = jnp.clip((rc * rc - r2t) * inv_d, 0.0, 1.0)
    s2 = s * s
    S = s * s2 * (10.0 + s * (-15.0 + 6.0 * s))
    sp = 30.0 * s2 * (1.0 - s) * (1.0 - s)
    return S, sp * inv_d


def neighbor_geometry(
    pos: jax.Array,
    alive: jax.Array,
    *,
    cell: float,
    m_grid: int,
    chunk: int = 32,
    max_chunks: int = 512,
    w_blk: int = 8,
    rj: int = 4,
    origin: Optional[jax.Array] = None,
) -> dict:
    """Frozen neighbor-search geometry for one macro window (jittable).

    Bins live bodies on an ``m_grid``^3 grid of size ``cell`` anchored at
    ``origin`` (default: refit to the live minimum each call — safe, see
    module docstring), sorts by cell id, chunks columns into ``chunk``-body
    rows via the tree's ``_pairs_geometry`` (ws=1), and flattens each
    i-chunk's z-trimmed neighbor runs into ``jbl [max_chunks, w_blk]`` of
    RJ-row j-block indices (sentinel ``max_chunks // rj`` = the all-dead
    block past the table).

    Returns a dict of device arrays:
      ``slot``          [n] i32 — body -> chunk-slot (``n_slots`` for
                        dropped bodies, out of range for ``pack_slots``'s
                        drop mode); ``n_slots = (max_chunks + rj) * chunk``.
      ``jbl``           [max_chunks, w_blk] i32 j-block table.
      ``cap_overflow``  () i32 — live bodies past the chunk budget.
      ``w_overflow``    () i32 — chunks whose j-blocks overflow ``w_blk``
                        (their farthest blocks are dropped).
    """
    n = pos.shape[0]
    C, K_ch, RJ = int(chunk), int(max_chunks), int(rj)
    if K_ch % RJ:
        raise ValueError(f"max_chunks={K_ch} must be a multiple of rj={RJ}")
    M = int(m_grid)
    M3 = M * M * M
    pos32 = pos.astype(f32)
    alive_b = alive.astype(bool)
    if origin is None:
        big = jnp.float32(3.0e38)
        pmin = jnp.min(jnp.where(alive_b[:, None], pos32, big), axis=0)
        origin = pmin - 0.5 * cell
    cc = jnp.clip(jnp.floor((pos32 - origin) * (1.0 / cell)).astype(i32),
                  0, M - 1)
    cid = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    sc_unsorted = jnp.where(alive_b, cid, M3)
    sort_idx = jnp.argsort(sc_unsorted)
    sc = sc_unsorted[sort_idx]
    g = _pairs_geometry(sc, n, M, 1, C, K_ch)

    n_slots = (K_ch + RJ) * C
    slot_sorted = jnp.where(g["keep"],
                            g["chunk_ord"] * C + g["rank_c"] % C,
                            n_slots).astype(i32)
    slot = jnp.zeros((n,), i32).at[sort_idx].set(slot_sorted)
    cap_overflow = jnp.sum(g["valid_b"] & (g["chunk_ord"] >= K_ch),
                           dtype=i32)

    start_blk, n_blk = _block_runs(g, RJ, K_ch, K_ch)      # [K_ch, 9]
    cum = jnp.cumsum(n_blk, axis=1)
    cum0 = jnp.concatenate(
        [jnp.zeros((K_ch, 1), i32), cum[:, :-1]], axis=1)
    total = cum[:, -1]
    w_overflow = jnp.sum((total > w_blk) & g["chunk_valid"], dtype=i32)

    W = int(w_blk)
    p = jnp.arange(W, dtype=i32)[None, :]               # [1, W]
    seg = jnp.sum((p[:, :, None] >= cum[:, None, :]).astype(i32), axis=-1)
    segc = jnp.minimum(seg, n_blk.shape[1] - 1)
    jbl = (jnp.take_along_axis(start_blk, segc, axis=1)
           + p - jnp.take_along_axis(cum0, segc, axis=1))
    live = (p < jnp.minimum(total, W)[:, None]) & g["chunk_valid"][:, None]
    jbl = jnp.where(live, jbl, K_ch // RJ).astype(i32)

    return dict(slot=slot, jbl=jbl, cap_overflow=cap_overflow,
                w_overflow=w_overflow, origin=origin)


def pack_slots(slot: jax.Array, vals: jax.Array, n_slots: int,
               fill: float) -> jax.Array:
    """Scatter per-body values into the chunk-slot table (f32).

    Dropped bodies carry ``slot == n_slots`` (out of range) and vanish via
    scatter drop mode; untouched slots keep ``fill`` (position channels use
    ``SENTINEL_POS``, mass/velocity channels 0 — sentinel slots are then
    force-inert by value, no masking anywhere downstream). Slot dtype
    follows ``vals`` (f32 on the device path; f64 on the CPU golden
    path)."""
    out = jnp.full((n_slots,), fill, vals.dtype)
    return out.at[slot].set(vals, mode="drop")


def unpack_slots(slot: jax.Array, table: jax.Array, fallback: jax.Array,
                 valid_below: int) -> jax.Array:
    """Gather per-body values back from the slot table; bodies whose slot
    is at/past ``valid_below`` (dropped) take ``fallback`` instead."""
    safe = jnp.minimum(slot, table.shape[0] - 1)
    cond = (slot < valid_below).reshape(
        slot.shape + (1,) * (table.ndim - 1))
    return jnp.where(cond, table[safe], fallback.astype(table.dtype))


def near_acc_slots(
    xs: jax.Array, ys: jax.Array, zs: jax.Array, ms: jax.Array,
    jbl: jax.Array,
    *,
    r1: float, rc: float, G: float, eps2: float,
    chunk: int = 32, rj: int = 4, block: int = 64,
    i0: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Switched near-field sweep over the frozen j-block table (XLA,
    gather-based; the RESPA near sweep on every platform).

    Inputs are slot-space channels [n_slots] (``pack_slots``). Returns
    ``(acc [max_chunks*chunk, 3], pe [max_chunks*chunk])`` in slot order
    (the sentinel tail rows are excluded); ``pe[i] = sum_j m_j invr S`` —
    multiply by -G/2 and sum for the near potential energy.

    ``i0`` (dynamic chunk offset) sweeps only i-chunks
    ``[i0, i0 + jbl.shape[0])`` of the slot table — the j side stays
    global. This is the mesh-sharding hook: each device passes its slice
    of the jbl table plus its chunk offset and gets back its slice of
    acc/pe rows (``parallel.sharded.make_sharded_respa_rollout``).
    """
    K_ch, W = jbl.shape
    C, RJ = int(chunk), int(rj)
    n_slots = xs.shape[0]
    blkw = RJ * C
    n_blocks = n_slots // blkw
    base = jnp.asarray(0 if i0 is None else i0, i32)
    P = jnp.stack([xs, ys, zs, ms], axis=0).reshape(4, n_blocks, blkw)
    B = max(1, min(int(block), K_ch))
    nb = -(-K_ch // B)
    jbl_pad = jnp.concatenate(
        [jbl, jnp.full((nb * B - K_ch, W), (n_slots - blkw) // blkw, i32)])
    # i-side channels padded so the LAST B-block's slice can never run
    # past the array: dynamic_slice CLAMPS an out-of-range start, which
    # silently shifts the whole block's i positions — wrong forces for
    # the tail chunks with every overflow counter still zero whenever
    # occupancy fills the budget (and, sharded, for the last shard
    # whenever kd % B leaves padding > rj). Worst-case read end is
    # base*C + nb*B*C with base <= n_slots/C - K_ch - RJ.
    ipad = max(0, (nb * B - K_ch - RJ) * C)
    if ipad:
        ext = jnp.zeros((ipad,), xs.dtype)
        xs_i = jnp.concatenate([xs, ext])
        ys_i = jnp.concatenate([ys, ext])
        zs_i = jnp.concatenate([zs, ext])
    else:
        xs_i, ys_i, zs_i = xs, ys, zs

    def do_block(k0):
        xi = lax.dynamic_slice(xs_i, ((base + k0) * C,),
                               (B * C,)).reshape(B, C)
        yi = lax.dynamic_slice(ys_i, ((base + k0) * C,),
                               (B * C,)).reshape(B, C)
        zi = lax.dynamic_slice(zs_i, ((base + k0) * C,),
                               (B * C,)).reshape(B, C)
        jb = lax.dynamic_slice(jbl_pad, (k0, 0), (B, W))    # [B, W]
        xj = P[0][jb].reshape(B, 1, W * blkw)
        yj = P[1][jb].reshape(B, 1, W * blkw)
        zj = P[2][jb].reshape(B, 1, W * blkw)
        mj = P[3][jb].reshape(B, 1, W * blkw)
        dx = xj - xi[:, :, None]
        dy = yj - yi[:, :, None]
        dz = zj - zi[:, :, None]
        r2t = dx * dx + dy * dy + dz * dz
        S, spd = switch_terms(r2t, r1, rc)
        inv_r = lax.rsqrt(r2t + eps2)
        w = mj * (S * (inv_r * inv_r * inv_r) + (2.0 * spd) * inv_r)
        acc = G * jnp.stack(
            [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1),
             jnp.sum(w * dz, -1)], axis=-1)                 # [B, C, 3]
        pe = jnp.sum(mj * inv_r * S, -1)                    # [B, C]
        return acc, pe

    accs, pes = lax.map(do_block, jnp.arange(0, nb * B, B))
    acc = accs.reshape(nb * B * C, 3)[:K_ch * C]
    pe = pes.reshape(nb * B * C)[:K_ch * C]
    # the sweep's self-pair contributes zero acceleration through dx = 0
    # but a finite m_i * rsqrt(eps2) * S(0) to the PE sum — subtract it
    # analytically (S(0) = 1 since r1 > 0)
    ms_i = (lax.dynamic_slice(ms, (base * C,), (K_ch * C,))
            if i0 is not None else ms[:K_ch * C])
    pe = pe - ms_i * (float(eps2) ** -0.5)
    return acc, pe


def near_acc_dense(pos, mass, alive, *, r1, rc, G, eps2):
    """O(N^2) switched near force — brute-force oracle for tests."""
    alive_f = alive.astype(f32)
    m = (mass * alive_f).astype(f32)
    p = pos.astype(f32)
    d = p[None, :, :] - p[:, None, :]                       # [N, N, 3]
    r2t = jnp.sum(d * d, axis=-1)
    S, spd = switch_terms(r2t, r1, rc)
    inv_r = lax.rsqrt(r2t + eps2)
    w = m[None, :] * (S * inv_r ** 3 + (2.0 * spd) * inv_r)
    w = w * (1.0 - jnp.eye(pos.shape[0], dtype=f32))        # exact self-zero
    # HIGHEST: an oracle must not drop to TF32 on a GPU's tensor cores
    acc = G * jnp.einsum("ij,ijk->ik", w, d,
                         precision=lax.Precision.HIGHEST) * alive_f[:, None]
    pe = jnp.sum(m[None, :] * inv_r * S
                 * (1.0 - jnp.eye(pos.shape[0], dtype=f32)), axis=-1)
    return acc, pe


@partial(jax.jit, static_argnames=("m_grid", "chunk", "rj"))
def _budget_probe(pos, alive, origin, cell, m_grid: int, chunk: int,
                  rj: int):
    n = pos.shape[0]
    M = int(m_grid)
    M3 = M * M * M
    pos32 = pos.astype(f32)
    alive_b = alive.astype(bool)
    cc = jnp.clip(jnp.floor((pos32 - origin) * (1.0 / cell)).astype(i32),
                  0, M - 1)
    cid = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    sc = jnp.sort(jnp.where(alive_b, cid, M3))
    C = int(chunk)
    K_safe = -(-n // C) + min(n, M * M)
    K_safe = -(-K_safe // rj) * rj
    g = _pairs_geometry(sc, n, M, 1, C, K_safe)
    _, n_blk = _block_runs(g, rj, K_safe, K_safe)
    total_chunks = jnp.sum(g["chunk_valid"].astype(i32))
    per_chunk = jnp.where(g["chunk_valid"], jnp.sum(n_blk, axis=1), 0)
    return total_chunks, jnp.max(per_chunk)


def neighbor_budgets(
    pos: np.ndarray,
    alive=None,
    *,
    cell: float,
    chunk: int = 32,
    rj: int = 4,
    headroom: float = 1.5,
    span_margin: float = 1.5,
    w_headroom: Optional[float] = None,
) -> tuple[int, int, int]:
    """Host-side ``(m_grid, max_chunks, w_blk)`` sizing from the initial
    distribution — shares ``_pairs_geometry``/``_block_runs`` with the sweep
    so the accounting cannot drift (the tree budget-sizing pattern,
    ops/tree.py:tree_pairs_budgets). ``m_grid`` covers ``span_margin`` x
    the live extent so the per-window origin refit keeps every body
    binned un-clipped as the system breathes. ``w_headroom`` (default = ``headroom``) sizes ``w_blk`` separately —
    the superblock sweep's COMPUTE scales with ``w_blk`` (padded), so it
    wants a tight per-chunk bound while the table budgets keep their
    evolution margin (w-overflow is counted, never silent)."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    alive_np = (np.ones(n, bool) if alive is None
                else np.asarray(alive, bool))
    live = pos[alive_np]
    span = float(np.max(live.max(0) - live.min(0))) if live.size else 1.0
    m_grid = max(4, int(np.ceil(span * span_margin / cell)) + 2)
    center = (live.max(0) + live.min(0)) / 2.0 if live.size else np.zeros(3)
    origin = jnp.asarray(center - 0.5 * m_grid * cell, f32)
    # host-side sizing whose answer is needed on the host: run it on the
    # CPU backend, off the device's memory and compile queue
    with jax.default_device(jax.devices("cpu")[0]):
        total, max_w = _budget_probe(
            jnp.asarray(np.asarray(pos), f32), jnp.asarray(alive_np),
            jax.device_put(origin), float(cell), m_grid, int(chunk),
            int(rj))
    lcm = int(np.lcm(rj, 8))
    max_chunks = max(lcm, -(-int(int(total) * headroom) // lcm) * lcm)
    wh = headroom if w_headroom is None else w_headroom
    w_blk = max(4, int(np.ceil(int(max_w) * wh)) + 1)
    return m_grid, max_chunks, w_blk


def pack_rows(slot: jax.Array, vals: jax.Array, n_slots: int,
              fill) -> jax.Array:
    """Row-packed variant of :func:`pack_slots`: scatter [n, CH] rows
    into a [n_slots, CH] table in ONE op: one row scatter instead of one
    scatter per channel. ``fill`` may be a
    scalar or a [CH] vector (e.g. SENTINEL_POS for positions, 0 for
    mass/velocity)."""
    ch = vals.shape[1]
    out = jnp.broadcast_to(jnp.asarray(fill, vals.dtype),
                           (n_slots, ch)).astype(vals.dtype)
    return out.at[slot].set(vals, mode="drop")


def unpack_rows(slot: jax.Array, table: jax.Array, fallback: jax.Array,
                valid_below: int) -> jax.Array:
    """Row-packed variant of :func:`unpack_slots`: gather [n, CH] rows
    back from the slot table; dropped bodies take ``fallback`` rows."""
    safe = jnp.minimum(slot, table.shape[0] - 1)
    cond = (slot < valid_below)[:, None]
    return jnp.where(cond, table[safe], fallback.astype(table.dtype))
