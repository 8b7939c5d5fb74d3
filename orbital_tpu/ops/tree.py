r"""Multilevel tree gravity: hierarchical multipole far field + exact near field.

The third member of the force family (exact kernels -> P3M -> PM), built for
**strongly concentrated** systems — the regime the docstring of ops/p3m.py
excludes: a single flat cell grid must size its per-cell capacity for the
densest core cell, so centrally-concentrated clusters overflow any fixed
capacity. Here the near field runs on cells 2^levels per side (far finer
than P3M's ~r_cut grid), and everything farther is absorbed by a multipole
pyramid — the classic tree-code trade (Barnes & Hut), reshaped into dense
array programs.

How pairs are partitioned (exactly once) across levels
------------------------------------------------------
Level ``l`` has ``2^l`` cells per side. A pair of bodies is *claimed* by
level ``l`` iff their level-``l`` cells are separated by more than ``ws``
cells (max-norm) while their parent cells at level ``l-1`` are within
``ws``. Since per-axis offsets shrink monotonically under floor-halving,
the claim indicator crosses exactly once: **every pair is handled by
exactly one level**, or — if the finest-level offset is still <= ws — by
the exact near-field sweep.

The far field is a convolution
------------------------------
Per-cell sweeps over COM-anchored monopoles (the classic GPU tree design)
are gather-bound: every cell reads a data-dependent neighbor list. This
implementation anchors source moments (monopole + dipole) and target
expansions (acceleration A, Jacobian J, potential phi) at **cell
centers**, which makes every tap weight a *static* function of the
center-to-center offset — i.e. the level sweep is a literal convolution:

* Enumerate claims by PARENT offset ``D in [-ws, ws]^3`` and the 8x8
  child-octant pairs ``(o_t, o_s)``; the claim condition
  ``max|2D + o_s - o_t| > ws`` is offset-only, so there are no parity
  masks and no data-dependent structure at all.
* Pack octants into channels: input = 4 moments x 8 source octants = 32
  channels on the (2^(l-1))^3 parent grid; output = 10 fields
  (A 3, J 6, phi 1) x 8 target octants = 80 channels; the kernel is
  spatially ``(2ws+1)^3``. XLA lowers this to convolutions (run as
  2ws+1 batched 2-D convs with shifted x-plane accumulation), at
  ``Precision.HIGHEST`` so no float32 contraction drops to TF32.
* Zero-padding at the grid boundary is exactly correct (out-of-range
  cells are empty), so no validity masks exist anywhere in the far field.
* Expansions are pushed down the pyramid with *static* octant deltas
  (``A_child = A + J delta_o``, ``phi_child = phi - A . delta_o``), and
  each body applies a final Taylor step about its finest cell center.

Tap antisymmetry: ``W_A(-r) = -W_A(r)`` and ``J(-r) = J(r)``, so the
aggregate momentum exchange of any cell pair — including the dipole and
Taylor terms — cancels exactly: **total momentum is conserved to
rounding** (same guarantee the COM-monopole scheme had).

Near field: only occupied finest-level cells are swept (occupied-cell
lists come from the N sorted bodies, never from grid-sized scans), each
cell against its ``(2ws+1)^3`` neighborhood through static-capacity body
tables with per-cell pre-gather, i-side split by occupancy class
(concentrated systems put most cells far below the densest cell's
capacity). Bodies beyond ``capacity`` or occupied cells beyond
``max_cells`` are *counted* in the returned overflow (0 => every near
pair was summed exactly). Deep ``levels`` is how concentration is tamed:
each extra level cuts the densest cell's occupancy ~8x while the conv
far field grows only 8x in cheap convolution work.

Accuracy: at ``order=1`` (monopole+dipole sources, first-order target
Taylor) the force error is O((h/R)^2) — ~1e-2 RMS on concentrated
clusters at ws=1, ~1e-3 at ws=2. ``order=2`` adds quadrupole sources AND
a second-order target Taylor (Hessian output channels) — BOTH sides,
because either alone leaves a same-order term from the other — for one
more factor of h/(2R): measured ~3x lower force error and ~10x lower
potential error at ws=1 for ~2.5x far-field conv cost (the near field is
untouched, which is why order=2 at ws=1 dominates order=1 at ws=2: the
latter pays a 125-cell near field). Softening
``eps2`` applies in *both* ranges, so the computed force is a consistent
(if cell-assignment-discontinuous) approximation of the softened
Hamiltonian. The reference has no analog (exact O(N^2) Python only,
core/physics.py:125-159); this extends the framework to concentrated
large-N systems past both the exact kernels' O(N^2) ceiling and P3M's
density-contrast bound.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .pm import _bounding_cube

# debug-only phase isolation for performance attribution (unset in prod).
# Loudly non-silent: zeroing a field phase produces WRONG PHYSICS, so any
# process that imports this module with TREE_SKIP set gets a warning.
import os as _os
import warnings as _warnings
_SKIP = _os.environ.get("TREE_SKIP", "")
if _SKIP:
    _warnings.warn(
        f"TREE_SKIP={_SKIP!r} is set: the tree force will OMIT its "
        f"'{_SKIP}'-field contribution. This is a perf-attribution debug "
        "mode; results are not physical.",
        RuntimeWarning, stacklevel=2)

__all__ = ["tree_acc_potential", "tree_acc_potential_staged",
           "tree_sharded_force", "tree_occupancy_probe", "tree_class_probe",
           "tree_column_probe", "tree_pairs_probe", "tree_pairs_budgets",
           "tree_stencil"]


def tree_stencil(ws: int) -> list[tuple[int, int, int]]:
    """Static claim stencil: all offsets with ``ws < max|d| <= 2 ws + 1``.
    (The far field realizes this set through the parent-offset x octant
    enumeration; exported for tests and documentation.)"""
    p = 2 * ws + 1
    return [
        (a, b, c)
        for a in range(-p, p + 1)
        for b in range(-p, p + 1)
        for c in range(-p, p + 1)
        if max(abs(a), abs(b), abs(c)) > ws
    ]


def _apply_sym(j6, v):
    """Apply a symmetric 3x3 (packed xx,yy,zz,xy,xz,yz) to vectors [..., 3]."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    ax = j6[..., 0] * vx + j6[..., 3] * vy + j6[..., 4] * vz
    ay = j6[..., 3] * vx + j6[..., 1] * vy + j6[..., 5] * vz
    az = j6[..., 4] * vx + j6[..., 5] * vy + j6[..., 2] * vz
    return jnp.stack([ax, ay, az], axis=-1)


# ---------------------------------------------------------------------------
# far field: octant-channel convolution
# ---------------------------------------------------------------------------

# channel layouts (octant index o = ox*4 + oy*2 + oz).
# order 1: moments (m, px, py, pz); fields (A 3, J 6, phi 1).
# order 2: + quadrupole Q (6, packed xx yy zz xy xz yz) in, + Hessian H
# (18, H[i,(jk)] i-major) out — source-quadrupole AND target-second-order
# together lift the error O((h/R)^2) -> O((h/R)^3); either alone leaves a
# same-order term from the other side.
_N_MOM = {1: 4, 2: 10}
_N_FLD = {1: 10, 2: 28}
# symmetric 6-pack contraction weights (off-diagonals appear twice)
_C6 = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
_Q6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _conv_taps(ws: int):
    """Static tap geometry: list of (Dx, [k, 3] child offsets, [k] o_t,
    [k] o_s) grouped by parent x-offset. Claim: max|2D + o_s - o_t| > ws."""
    octs = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    groups = {}
    for Dx in range(-ws, ws + 1):
        for Dy in range(-ws, ws + 1):
            for Dz in range(-ws, ws + 1):
                for ot in octs:
                    for os_ in octs:
                        d = (2 * Dx + os_[0] - ot[0],
                             2 * Dy + os_[1] - ot[1],
                             2 * Dz + os_[2] - ot[2])
                        if max(abs(c) for c in d) <= ws:
                            continue
                        groups.setdefault(Dx, []).append(
                            ((Dy, Dz), d, ot, os_))
    return groups


def _conv_weights(ws: int, h, G: float, eps2: float, order: int):
    """Per-x-slab conv weight tensors [8*F, 8*Mo, 2ws+1, 2ws+1] (traced —
    they depend on the level's cell width ``h``). Tap weight blocks follow
    the source-shift Taylor expansion about cell centers with
    r = c_target - c_source = -d*h, R^2 = |r|^2 + eps2:
      A   +=  m W_A       - J p       + 1/2 T : Q      (W_A = -G r / R^3)
      J   +=  m J         - T p                  (J_ij = 3G r_i r_j/R^5
                                                        - G delta_ij/R^3)
      H   +=  m T                     (T_ijk = d J_ij / d r_k, order 2)
      phi +=  m g         + W_A . p   - 1/2 J : Q         (g = -G / R)
    """
    p = 2 * ws + 1
    F, Mo = _N_FLD[order], _N_MOM[order]
    groups = _conv_taps(ws)
    h = jnp.asarray(h, jnp.float32)
    slabs = {}
    for Dx, taps in groups.items():
        # static per-tap geometry -> numpy; scale by traced h afterwards
        dvec = np.array([t[1] for t in taps], np.float32)       # [T, 3]
        ky = np.array([t[0][0] + ws for t in taps], np.int32)
        kz = np.array([t[0][1] + ws for t in taps], np.int32)
        o_t = np.array([t[2][0] * 4 + t[2][1] * 2 + t[2][2] for t in taps])
        o_s = np.array([t[3][0] * 4 + t[3][1] * 2 + t[3][2] for t in taps])

        r = -jnp.asarray(dvec) * h                              # [T, 3]
        R2 = jnp.sum(r * r, axis=1) + eps2
        inv = lax.rsqrt(R2)
        inv3 = inv * inv * inv
        inv5 = inv3 * inv * inv
        inv7 = inv5 * inv * inv
        W_A = -G * r * inv3[:, None]                            # [T, 3]
        rc = [r[:, 0], r[:, 1], r[:, 2]]

        def Jel(i, j):
            base = 3.0 * G * rc[i] * rc[j] * inv5
            return base - G * inv3 if i == j else base

        Jt = jnp.stack([Jel(*q) for q in _Q6], axis=1)          # [T, 6]
        g = -G * inv                                            # [T]

        blk = jnp.zeros((len(taps), F, Mo), jnp.float32)
        phi_row = F - 1
        # m -> A, J, phi
        blk = blk.at[:, 0:3, 0].set(W_A)
        blk = blk.at[:, 3:9, 0].set(Jt)
        blk = blk.at[:, phi_row, 0].set(g)
        # p -> A: -J p  (symmetric 3x3 from packed 6)
        Jm = jnp.stack([
            jnp.stack([Jt[:, 0], Jt[:, 3], Jt[:, 4]], 1),
            jnp.stack([Jt[:, 3], Jt[:, 1], Jt[:, 5]], 1),
            jnp.stack([Jt[:, 4], Jt[:, 5], Jt[:, 2]], 1)], 1)  # [T, 3, 3]
        blk = blk.at[:, 0:3, 1:4].set(-Jm)
        # p -> phi: W_A . p
        blk = blk.at[:, phi_row, 1:4].set(W_A)

        if order == 2:
            def Tel(i, j, k):
                t = -5.0 * G * rc[i] * rc[j] * rc[k] * inv7 * 3.0
                if i == j:
                    t = t + 3.0 * G * rc[k] * inv5
                if i == k:
                    t = t + 3.0 * G * rc[j] * inv5
                if j == k:
                    t = t + 3.0 * G * rc[i] * inv5
                return t

            # Tp[i][q] = T_i(jk), fully symmetric
            Tp = [[Tel(i, q[0], q[1]) for q in _Q6] for i in range(3)]
            # m -> H (18 rows, i-major)
            for i in range(3):
                for q in range(6):
                    blk = blk.at[:, 9 + i * 6 + q, 0].set(Tp[i][q])
            # p -> J: J_(ij) += -T_(ij)k p_k
            for qi, (i, j) in enumerate(_Q6):
                for k in range(3):
                    blk = blk.at[:, 3 + qi, 1 + k].set(-Tel(i, j, k))
            # Q -> A: A_i += 1/2 c_q T_i(q) Q_q
            for i in range(3):
                for q in range(6):
                    blk = blk.at[:, i, 4 + q].set(0.5 * _C6[q] * Tp[i][q])
            # Q -> phi: phi += -1/2 c_q J_q Q_q
            for q in range(6):
                blk = blk.at[:, phi_row, 4 + q].set(-0.5 * _C6[q] * Jt[:, q])

        # scatter tap blocks into the conv weight tensor
        w = jnp.zeros((8 * F, 8 * Mo, p, p), jnp.float32)
        oc = (o_t[:, None] * F + np.arange(F)[None, :])         # [T, F]
        ic = (np.arange(Mo)[None, :] * 8 + o_s[:, None])        # [T, Mo]
        w = w.at[oc[:, :, None], ic[:, None, :],
                 ky[:, None, None], kz[:, None, None]].add(blk)
        slabs[Dx] = w
    return slabs


# conv data layout: channels-last (NHWC) lets _octant_pack/_unpack_fields
# skip their grid-sized transposes (the packed [s, s, s, 8 Mo] form is the
# natural intermediate of both). Not yet measured on the GPU.
_FAR_NHWC = False


def _level_conv(moments, ws: int, h, G: float, eps2: float, order: int):
    """One level's far-field sweep as batched 2-D convolutions.

    ``moments``: octant-packed parent grid — [s, 8 Mo, s, s] (NCHW, x as
    batch) or [s, s, s, 8 Mo] when ``_FAR_NHWC``. Returns the matching
    [s, 8 F, s, s] / [s, s, s, 8 F] per target octant. f32/HIGHEST — bf16
    tap products would sit above the method's own error floor.
    """
    s = moments.shape[0]
    in_ch = 8 * _N_MOM[order]
    out_ch = 8 * _N_FLD[order]
    slabs = _conv_weights(ws, h, G, eps2, order)
    if _FAR_NHWC:
        pad = jnp.zeros((ws, s, s, in_ch), jnp.float32)
        xp = jnp.concatenate([pad, moments, pad], axis=0)
        out = jnp.zeros((s, s, s, out_ch), jnp.float32)
        for Dx, w in slabs.items():
            c2 = lax.conv_general_dilated(
                xp, jnp.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
                window_strides=(1, 1), padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=lax.Precision.HIGHEST)
            out = out + lax.dynamic_slice_in_dim(c2, ws + Dx, s, axis=0)
        return out
    pad = jnp.zeros((ws, in_ch, s, s), jnp.float32)
    xp = jnp.concatenate([pad, moments, pad], axis=0)
    out = jnp.zeros((s, out_ch, s, s), jnp.float32)
    for Dx, w in slabs.items():
        c2 = lax.conv_general_dilated(
            xp, w, window_strides=(1, 1), padding="SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=lax.Precision.HIGHEST)
        # target plane x reads source plane x + Dx (zero-padded, no wrap)
        out = out + lax.dynamic_slice_in_dim(c2, ws + Dx, s, axis=0)
    return out


def _coarsen2(c, mm):
    """2x2x2-coarsen a flat x-major ``[(2 mm)^3]`` grid to ``[mm^3]``,
    one axis at a time with stride-2 slices of 3-d views. The obvious
    ``reshape(mm, 2, mm, 2, mm, 2).sum(axis=(1, 3, 5))`` is arithmetic-
    identical but lets XLA materialize the 6-d intermediate with tiny
    trailing (..., 2, 2) dims. Strided 3-d slices keep every
    materialized shape's minor dims large."""
    M = 2 * mm
    g = c.reshape(M, M, M)
    g = g[:, :, 0::2] + g[:, :, 1::2]        # z: [M, M, mm]
    g = g[:, 0::2, :] + g[:, 1::2, :]        # y: [M, mm, mm]
    g = g[0::2, :, :] + g[1::2, :, :]        # x: [mm, mm, mm]
    return g.reshape(-1)


def _octant_pack(flat_chans, m):
    """Mo flat [m^3] moment grids -> octant-packed parent grid, [s, 8 Mo,
    s, s] NCHW or [s, s, s, 8 Mo] NHWC (s = m/2; channel = moment*8 +
    octant, octant = ox*4+oy*2+oz)."""
    s = m // 2
    parts = []
    for c in flat_chans:
        g = c.reshape(s, 2, s, 2, s, 2)
        g = g.transpose(0, 2, 4, 1, 3, 5).reshape(s, s, s, 8)
        parts.append(g)
    g = jnp.stack(parts, axis=3)                 # [s, s, s, Mo, 8]
    g = g.reshape(s, s, s, 8 * len(parts))
    if _FAR_NHWC:
        return g                                 # [s(x), s, s, 8 Mo]
    return g.transpose(0, 3, 1, 2)               # [s(x), 8 Mo, s, s]


def _unpack_fields(out, n_fields):
    """Conv output ([s, 8 F, s, s] NCHW / [s, s, s, 8 F] NHWC) -> F flat
    child-grid channels [m^3] (m = 2s, x-major child linear ids). Channels
    stay SEPARATE 1-D arrays for the same T(8,128) lane-padding reason as
    the moment pyramid."""
    s = out.shape[0]
    if _FAR_NHWC:
        g = out.reshape(s, s, s, 2, 2, 2, n_fields)
    else:
        g = out.transpose(0, 2, 3, 1).reshape(s, s, s, 2, 2, 2, n_fields)
    g = g.transpose(0, 3, 1, 4, 2, 5, 6)         # [s,2, s,2, s,2, F]
    return tuple(g[..., ch].reshape(-1) for ch in range(n_fields))


# How per-level conv outputs are combined into finest-grid expansions:
#   "push" — level-by-level pushdown: the running expansion is Taylor-
#            shifted one level at a time (parent centers -> child centers,
#            static +-h/2 octant deltas) and each level's conv output is
#            added at its own grid. Traffic-optimal: total writes are
#            ~(8/7) nf M^3 because every level below the finest is grid-
#            size m^3 << M^3.
#   "lazy" — every level's conv output is shifted straight to the FINEST
#            cell centers and accumulated there. One truncation order
#            more accurate per hop chain (no compounding of dropped
#            terms), but each of the `levels-2` accumulations is an
#            M^3-sized elementwise pass, so it moves more bytes.
# Both paths share _taylor_shift, which keeps the FULL available Taylor
# terms at each hop (the round-4 pushdown dropped phi's J:delta^2/2 term
# at order 1 — the main accuracy delta the lazy landing measured).
# Module flag (not a jit cache key — clear_cache() between flips).
_FAR_COMBINE = "push"


def _taylor_shift(up, d, dx, dy, dz, order):
    """Shift field expansions by delta = (dx, dy, dz) (target center -
    source center): returns the same channel tuple re-expanded about the
    shifted centers, keeping every term available at this order.

    ``up`` maps a flat channel to its broadcast-ready view; ``dx/dy/dz``
    are broadcast-ready per-axis delta arrays. Channel layout: A (3),
    J (6: xx yy zz xy xz yz), [order 2: H (18)], phi."""
    A = [up(d[k]) for k in range(3)]
    J = [up(d[3 + q]) for q in range(6)]
    phi = up(d[-1])
    Ax_c = A[0] + J[0] * dx + J[3] * dy + J[4] * dz
    Ay_c = A[1] + J[3] * dx + J[1] * dy + J[5] * dz
    Az_c = A[2] + J[4] * dx + J[5] * dy + J[2] * dz
    phi_c = phi - (A[0] * dx + A[1] * dy + A[2] * dz) - 0.5 * (
        J[0] * dx * dx + J[1] * dy * dy + J[2] * dz * dz
        + 2.0 * (J[3] * dx * dy + J[4] * dx * dz + J[5] * dy * dz))
    if order == 1:
        return (Ax_c, Ay_c, Az_c) + tuple(J) + (phi_c,)
    H = [up(d[9 + t]) for t in range(18)]

    def hquad(i):
        b = i * 6
        return (H[b + 0] * dx * dx + H[b + 1] * dy * dy
                + H[b + 2] * dz * dz
                + 2.0 * (H[b + 3] * dx * dy + H[b + 4] * dx * dz
                         + H[b + 5] * dy * dz))

    Ax_c = Ax_c + 0.5 * hquad(0)
    Ay_c = Ay_c + 0.5 * hquad(1)
    Az_c = Az_c + 0.5 * hquad(2)
    # J_(ij) += H_i(jk) delta_k (fully symmetric H)
    Jxx_c = J[0] + H[0] * dx + H[3] * dy + H[4] * dz
    Jyy_c = J[1] + H[9] * dx + H[7] * dy + H[11] * dz
    Jzz_c = J[2] + H[16] * dx + H[17] * dy + H[14] * dz
    Jxy_c = J[3] + H[3] * dx + H[1] * dy + H[5] * dz
    Jxz_c = J[4] + H[4] * dx + H[5] * dy + H[2] * dz
    Jyz_c = J[5] + H[10] * dx + H[11] * dy + H[8] * dz
    return ((Ax_c, Ay_c, Az_c, Jxx_c, Jyy_c, Jzz_c, Jxy_c, Jxz_c,
             Jyz_c) + tuple(H) + (phi_c,))


def _far_field(chans, levels, ws, half, origin, G, eps2, order,
               finest_octant: bool = False):
    """Conv far field over all levels. Returns F flat finest-grid field
    channels [M^3] (order 1: Ax..Az, Jxx..Jyz, phi; order 2 inserts the
    18 Hessian channels before phi) — expansions about FINEST cell
    centers. Level combination strategy: see ``_FAR_COMBINE``.

    ``finest_octant``: ``chans[levels]`` is octant-major (see the
    ``far_id`` construction in :func:`tree_acc_potential`) and the
    returned finest channels are octant-major too — every finest-level
    materialization becomes contiguous block slices/concats instead of
    T(8,128)-hostile interleaves. Only meaningful under the push
    combine."""
    f32 = jnp.float32
    M = 2 ** levels
    nf = _N_FLD[order]
    h_fin = 2.0 * half / M
    acc = None           # lazy: finest-grid accumulator; push: running F
    for lev in range(2, levels + 1):
        m = 2 ** lev
        h_lev = 2.0 * half / m
        mflat = chans[lev][0]
        oct_lev = finest_octant and lev == levels
        if oct_lev:
            # octant-major cell-center coordinates: coord_k = 2*i_k + o_k
            # decoded from the (octant, parent) index structure
            s_ = m // 2
            o_i = lax.broadcasted_iota(jnp.int32, (8, s_, s_, s_), 0)

            def _coord(k, _s=s_, _o=o_i):
                i_k = lax.broadcasted_iota(jnp.int32, (8, _s, _s, _s),
                                           k + 1)
                return ((i_k << 1) | ((_o >> (2 - k)) & 1)).astype(
                    f32).reshape(-1)

            ctr = [_coord(k) for k in range(3)]
        else:
            # per-axis cell-center coordinates via 3-D iota (no
            # 16.7M-element integer div/mod chains at the finest level)
            ctr = [lax.broadcasted_iota(f32, (m, m, m), k).reshape(-1)
                   for k in range(3)]
        cc = [origin[k] + (ctr[k] + 0.5) * h_lev for k in range(3)]
        # dipole about centers: p = sum(m x) - m c
        pvec = [chans[lev][1 + k] - mflat * cc[k] for k in range(3)]
        moms = [mflat] + pvec
        if order == 2:
            # quadrupole about centers:
            # Q_(ij) = sum(m x_i x_j) - c_i Mx_j - c_j Mx_i + m c_i c_j
            for q, (i, j) in enumerate(_Q6):
                moms.append(chans[lev][4 + q]
                            - cc[i] * chans[lev][1 + j]
                            - cc[j] * chans[lev][1 + i]
                            + mflat * cc[i] * cc[j])
        if oct_lev:
            # pack from octant-major flats: channel (mo, o) = contiguous
            # block o of moment mo, already x-major over parents
            s_ = m // 2
            parts = [mo_c.reshape(8, s_, s_, s_)[o]
                     for mo_c in moms for o in range(8)]
            packed = jnp.stack(parts, axis=3 if _FAR_NHWC else 1)
            out = _level_conv(packed, ws, h_lev, G, eps2, order)

            def _fslice(o, f, _out=out, _s=s_):
                ch = o * nf + f
                blk = (_out[..., ch] if _FAR_NHWC else _out[:, ch])
                return blk.reshape(-1)

            if acc is None:
                return tuple(
                    jnp.concatenate([_fslice(o, f) for o in range(8)])
                    for f in range(nf))
            # push the running expansion (about level lev-1 centers,
            # x-major [s^3] — the same order as the conv's parent axis)
            # to each child octant with its static +-h/2 delta, add that
            # octant's conv block, and concatenate: the output is
            # octant-major by construction, no interleave ever exists
            F_parts = []
            for o in range(8):
                d_o = [jnp.float32(
                    (0.5 * h_lev) if (o >> (2 - k)) & 1
                    else (-0.5 * h_lev)) for k in range(3)]
                sh = _taylor_shift(lambda c: c, acc, d_o[0], d_o[1],
                                   d_o[2], order)
                F_parts.append(tuple(sh[f] + _fslice(o, f)
                                     for f in range(nf)))
            return tuple(
                jnp.concatenate([F_parts[o][f] for o in range(8)])
                for f in range(nf))
        packed = _octant_pack(moms, m)
        out = _level_conv(packed, ws, h_lev, G, eps2, order)
        dF = _unpack_fields(out, nf)

        if _FAR_COMBINE == "push":
            if acc is None:
                acc = dF
                continue
            # acc holds levels < lev about level lev-1 centers ([s^3]
            # flats, s = m/2): shift to this level's child centers
            # (delta = +-h_lev/2 per axis) and add this level's term.
            s = m // 2

            def up(c, _s=s):
                return c.reshape(_s, 1, _s, 1, _s, 1)

            sides = jnp.asarray([-1.0, 1.0], f32) * (0.5 * h_lev)
            dx = sides.reshape(1, 2, 1, 1, 1, 1)
            dy = sides.reshape(1, 1, 1, 2, 1, 1)
            dz = sides.reshape(1, 1, 1, 1, 1, 2)
            shifted = _taylor_shift(up, acc, dx, dy, dz, order)
            tgt = (s, 2, s, 2, s, 2)
            acc = tuple(jnp.broadcast_to(p, tgt).reshape(-1) + c
                        for p, c in zip(shifted, dF))
            continue

        # lazy: shift this level's term straight to the finest centers.
        # The 6-d view (m, r, m, r, m, r) of a flat [M^3] x-major grid is
        # a free reshape, and delta is constant within each r-block.
        if acc is None:
            acc = [jnp.zeros((M * M * M,), f32) for _ in range(nf)]
        if lev == levels:
            acc = [a + c for a, c in zip(acc, dF)]
            continue
        r = M // m

        def up(c, _m=m):
            return c.reshape(_m, 1, _m, 1, _m, 1)

        def dl(axis, _r=r):
            dv = (jnp.arange(_r, dtype=f32) + 0.5 - 0.5 * _r) * h_fin
            shape = [1, 1, 1, 1, 1, 1]
            shape[2 * axis + 1] = _r
            return dv.reshape(shape)

        shifted = _taylor_shift(up, dF, dl(0), dl(1), dl(2), order)
        tgt = (m, r, m, r, m, r)
        acc = [a + jnp.broadcast_to(s_, tgt).reshape(-1)
               for a, s_ in zip(acc, shifted)]
    return tuple(acc)


def _compact_sorted(flags, values, K, sentinel):
    """Values at flagged positions, order-preserved, padded with
    ``sentinel`` to static length K (flags/values aligned, values
    ascending => result ascending). Runs over O(N)-length arrays only —
    never over the 8^levels grid (16.7M cells at level 8)."""
    n = values.shape[0]
    pos = jnp.nonzero(flags, size=K, fill_value=n)[0]
    return jnp.where(pos < n, values[jnp.minimum(pos, n - 1)], sentinel)


def _dense_slot_map(ids_list, K, id_max):
    """Dense ``[id_max + 1]`` map: id -> its slot in ``ids_list`` (a
    K-long padded id list with sentinel ``id_max``), K for absent ids.
    One scatter + gathers replace per-query binary searches."""
    return jnp.full((id_max + 1,), K, jnp.int32).at[
        jnp.minimum(ids_list, id_max)].set(
        jnp.where(ids_list < id_max, jnp.arange(K, dtype=jnp.int32), K),
        mode="drop")


def _segment_bounds(sorted_keys):
    """(first, last) occurrence index per element of a SORTED int key
    array — semantically ``searchsorted(keys, keys, 'left'/'right')``,
    but via two associative scans instead of 2n binary searches."""
    n = sorted_keys.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    boundary = sorted_keys[1:] != sorted_keys[:-1]
    is_start = jnp.concatenate([jnp.ones((1,), bool), boundary])
    is_end = jnp.concatenate([boundary, jnp.ones((1,), bool)])
    first = lax.associative_scan(jnp.maximum,
                                 jnp.where(is_start, idx, 0))
    last = lax.associative_scan(jnp.minimum,
                                jnp.where(is_end, idx + 1, n),
                                reverse=True)
    return first, last


def _lookup_slot(sorted_ids, query):
    """Row index of ``query`` in the sorted (sentinel-padded) id list, or
    K (one-past-end) when absent."""
    K = sorted_ids.shape[0]
    slot = jnp.searchsorted(sorted_ids, query)
    hit = sorted_ids[jnp.minimum(slot, K - 1)] == query
    return jnp.where(hit, jnp.minimum(slot, K - 1), K)


@partial(jax.jit,
         static_argnames=("G_grav", "eps2", "levels", "capacity", "ws",
                          "max_cells", "cell_block", "with_potential",
                          "order", "max_big", "max_frontier", "max_chunks",
                          "near", "chunk", "pair_entries", "_phase",
                          "_n_parts", "_psum_axis"))
def tree_acc_potential(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G_grav: float,
    eps2: float,
    levels: int = 6,
    capacity: int = 48,
    ws: int = 1,
    max_cells: int = 0,
    cell_block: int = 0,
    with_potential: bool = True,
    order: int = 1,
    max_big: int = 0,
    max_frontier: int = 0,
    max_chunks: int = 0,
    near: str = "cells",
    chunk: int = 32,
    pair_entries: tuple = (),
    box=None,
    _phase: str = "both",
    _n_parts: int = 1,
    _part_index=None,
    _psum_axis: Optional[str] = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Tree accelerations, potential, and the near-field overflow count.

    Args:
        levels: pyramid depth; the near field runs on ``2^levels`` cells
            per side. Deeper = ~8x lower per-cell occupancy (tames
            concentration) at ~8x more (cheap) far-field conv work.
        capacity: max bodies per finest-level cell in the near-field
            tables. Size from :func:`tree_occupancy_probe`.
        ws: well-separation in cells. 1 = fast (3^3 parent conv, 27-cell
            near field), 2 = accurate (5^3 parent conv, 125-cell near
            field).
        max_cells: static occupied-cell budget for the near-field sweep
            (0 = ``min(N, 8^levels)``, always safe). Occupied cells
            beyond it are *dropped and counted* in the overflow.
        near: near-field sweep granularity. ``"cells"`` sweeps each
            occupied finest cell against its (2ws+1)^3 neighbor cells
            (27 row-gathers per cell at ws=1). ``"columns"`` sweeps each
            occupied (x, y) COLUMN against its (2ws+1)^2 neighbor
            columns with an in-kernel |dz| <= ws cell-band mask — the
            sorted body order is already column-grouped, so this costs
            ~9 row-gathers per COLUMN instead of 27 per cell (~25x
            fewer of the row gathers that dominate the near field, for
            a modest amount of extra masked pair arithmetic). Under
            ``"columns"`` the ``capacity`` / ``max_cells`` / ``max_big``
            / ``max_frontier`` budgets are PER-COLUMN (size them with
            :func:`tree_column_probe`); the occupancy-class split uses
            c_small=32. ``"pairs"`` sweeps 32-body CHUNK pairs with
            octave-padded j widths (see :func:`_near_pairs`) — it
            replaces the per-column capacity padding (up to ~100x true
            pairs on concentrated cores) with < 2x octave rounding;
            budgets are ``max_chunks`` + ``pair_entries`` from
            :func:`tree_pairs_probe` (capacity / max_cells / max_big /
            max_frontier are ignored).
        chunk: ``near="pairs"`` chunk row size (bodies per
            packed row on both sweep sides).
        pair_entries: ``near="pairs"`` static per-octave i-chunk budgets
            (octave o holds chunks whose 9-neighborhood j-chunk total is
            at most (2ws+1)^2 * 2**o). Size with
            :func:`tree_pairs_probe`.
        max_chunks: static budget for the column big sweep's i-side
            CHUNK list (``near="columns"`` only): big columns are swept
            in 32-row i-chunks, so the big sweep costs
            O(big-bodies x 9 x capacity) instead of
            O(big-columns x capacity x 9 x capacity) — on a 1M Plummer
            core the padded full-capacity i side was ~85% of the whole
            near phase. 0 = ``min(K_big x ceil(capacity/32),
            max(512, 4 K_big))``; size exactly (plus margin) with
            :func:`tree_column_probe` ``with_chunks=True``. Chunks past
            the budget are dropped and counted in the overflow.
        box: optional (center [3], half) pinning the grid (recommended for
            long rollouts, same rationale as ``SimConfig.pm_box``); default
            refits the live bounding cube every call. Bodies outside a
            pinned box clip into the boundary cells.

    Returns (acc [N,3], U, overflow int32). ``overflow`` counts live bodies
    excluded from the near-field sum (cell past ``capacity`` or occupied
    cell past ``max_cells``); results are only trustworthy at 0. Requires
    ``eps2 > 0`` (shared-cell coincident pairs would otherwise divide by
    zero, exactly like the reference's unsoftened path).
    """
    if eps2 <= 0.0:
        raise ValueError("the tree solver requires eps2 > 0")
    if ws not in (1, 2):
        raise ValueError("ws must be 1 or 2")
    if order not in (1, 2):
        raise ValueError("order must be 1 (monopole+dipole) or 2 (+quad)")
    if near not in ("cells", "columns", "pairs"):
        raise ValueError("near must be 'cells', 'columns', or 'pairs'")
    if near == "pairs" and not pair_entries:
        raise ValueError(
            "near='pairs' needs per-octave i-chunk budgets: pass "
            "pair_entries sized with tree_pairs_probe")
    if levels < 2 or levels > 8:
        raise ValueError("levels must be in [2, 8]")
    n = pos.shape[0]
    M = 2 ** levels
    M3 = M * M * M
    f32 = jnp.float32
    G = float(G_grav)
    eps2 = float(eps2)

    pos32 = pos.astype(f32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    alive_f = alive_b.astype(f32)
    m_eff = mass.astype(f32) * alive_f

    if box is None:
        center, half = _bounding_cube(pos32, alive_f, M, None)
    else:
        center = jnp.asarray(box[0], f32)
        half = jnp.asarray(box[1], f32)
    h = 2.0 * half / M
    origin = center - half

    cc = jnp.clip(jnp.floor((pos32 - origin) / h).astype(jnp.int32),
                  0, M - 1)
    cell_id = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    cell_id = jnp.where(alive_b, cell_id, M3)  # dead bodies -> sentinel

    # Finest-level OCTANT-MAJOR linear index: octant-of-parent major,
    # x-major parent cell minor (octant o = ox*4 + oy*2 + oz). Under the
    # default push combine the finest-grid field channels are produced,
    # deposited, and gathered in THIS order — every finest-level
    # materialization is then a contiguous block slice/concat instead of
    # the x-major interleave with its (s,2,s,2,s,2)-shaped relayouts.
    # The lazy combine accumulates at the finest grid in x-major order
    # level by level; it keeps the legacy layout end-to-end. The near
    # phase never reads the far grids and traces NO octant machinery.
    oct_layout = (_FAR_COMBINE == "push" and _phase != "near")
    if oct_layout:
        s_fin = M // 2
        oct_b = ((cc[:, 0] & 1) * 2 + (cc[:, 1] & 1)) * 2 + (cc[:, 2] & 1)
        par_b = ((cc[:, 0] >> 1) * s_fin + (cc[:, 1] >> 1)) * s_fin \
            + (cc[:, 2] >> 1)
        far_id = jnp.where(alive_b, oct_b * (s_fin ** 3) + par_b, M3)
        dep_id = far_id
    else:
        far_id = None
        dep_id = cell_id

    # ---- multipole pyramid: NGP deposit of (m, m x) + coarsening ----------
    # Channels live as SEPARATE flat [m^3] arrays, so every segment_sum
    # and pyramid coarsening is a plain 1-D pass at every level.
    raw = [m_eff, m_eff * pos32[:, 0], m_eff * pos32[:, 1],
           m_eff * pos32[:, 2]]
    if order == 2:
        raw += [m_eff * pos32[:, i] * pos32[:, j] for i, j in _Q6]
    chans = {levels: tuple(
        jax.ops.segment_sum(c, dep_id, num_segments=M3 + 1)[:M3]
        for c in raw)}
    for lev in range(levels - 1, 1, -1):
        if lev == levels - 1 and oct_layout:
            # octant-major finest: the parent sum is a contiguous
            # axis-0 reduction (children of parent p are the 8 octant
            # blocks at minor index p) — no strided slicing at all
            chans[lev] = tuple(
                c.reshape(8, -1).sum(axis=0) for c in chans[lev + 1])
            continue
        mm = 2 ** lev
        chans[lev] = tuple(_coarsen2(c, mm) for c in chans[lev + 1])

    # ---- far field: per-level octant convolutions + body Taylor step ------
    if _phase == "near":
        F_ch = tuple(jnp.zeros((M3,), f32) for _ in range(_N_FLD[order]))
    else:
        F_ch = _far_field(chans, levels, ws, half, origin, G, eps2, order,
                          finest_octant=oct_layout)
    idx_b = jnp.minimum(far_id if oct_layout else cell_id, M3)
    zpad = jnp.zeros((1,), f32)
    Fb = [jnp.concatenate([c, zpad])[idx_b] for c in F_ch]  # F x [N]
    A_b = jnp.stack(Fb[0:3], axis=-1)
    J_b = jnp.stack(Fb[3:9], axis=-1)
    phi_b = Fb[-1]
    centers_b = origin + (cc.astype(f32) + 0.5) * h
    dx = pos32 - centers_b
    a_far = A_b + _apply_sym(J_b, dx)
    phi_far = phi_b - jnp.sum(A_b * dx, axis=-1)

    def far_potential_cellwise():
        """sum_b m_b phi(x_b) aggregated PER CELL from the deposited
        moments: sum_cells [m phi_c - A.p (- J:Q/2 at order 2)] — exactly
        the per-body Taylor sum, but with no per-body gathers."""
        m = 2 ** levels
        h_l = 2.0 * half / m
        if oct_layout:
            # chans[levels] and F_ch are both octant-major: centers must
            # be generated in the same order (same decode as _far_field)
            s_ = m // 2
            o_i = lax.broadcasted_iota(jnp.int32, (8, s_, s_, s_), 0)
            ctr = []
            for k in range(3):
                i_k = lax.broadcasted_iota(jnp.int32, (8, s_, s_, s_),
                                           k + 1)
                ctr.append(((i_k << 1) | ((o_i >> (2 - k)) & 1)).astype(
                    f32).reshape(-1))
        else:
            ctr = [lax.broadcasted_iota(f32, (m, m, m), k).reshape(-1)
                   for k in range(3)]
        ccell = [origin[k] + (ctr[k] + 0.5) * h_l for k in range(3)]
        mflat = chans[levels][0]
        p = [chans[levels][1 + k] - mflat * ccell[k] for k in range(3)]
        tot = mflat * F_ch[-1]
        for k in range(3):
            tot = tot - F_ch[k] * p[k]
        if order == 2:
            for q, (i, j) in enumerate(_Q6):
                Qq = (chans[levels][4 + q] - ccell[i] * chans[levels][1 + j]
                      - ccell[j] * chans[levels][1 + i]
                      + mflat * ccell[i] * ccell[j])
                tot = tot - 0.5 * _C6[q] * F_ch[3 + q] * Qq
        return 0.5 * jnp.sum(tot)
    if order == 2:
        H = Fb[9:27]
        dxc = [dx[:, 0], dx[:, 1], dx[:, 2]]

        def hquad_b(i):
            b = i * 6
            acc = jnp.zeros_like(H[0])
            for q, (j, k) in enumerate(_Q6):
                acc = acc + _C6[q] * H[b + q] * dxc[j] * dxc[k]
            return acc

        a_far = a_far + 0.5 * jnp.stack(
            [hquad_b(0), hquad_b(1), hquad_b(2)], axis=-1)
        jq = jnp.zeros_like(phi_b)
        for q, (j, k) in enumerate(_Q6):
            jq = jq + _C6[q] * Fb[3 + q] * dxc[j] * dxc[k]
        phi_far = phi_far - 0.5 * jq

    if _phase == "far":
        # staged evaluation (see tree_acc_potential_staged): the sorted-
        # body machinery below is never even traced here, so the far
        # program cannot carry a dead argsort/bounds chain
        acc = a_far * alive_f[:, None]
        U = (far_potential_cellwise() if with_potential
             else jnp.zeros((), f32))
        return (acc.astype(pos.dtype), U.astype(pos.dtype),
                jnp.zeros((), jnp.int32))

    # sorted-body machinery (near field): occupied-cell lists come from
    # the N sorted bodies, never from grid-sized scans. ONE multi-payload
    # stable sort carries the packed-row source channels along with the
    # keys instead of an argsort followed by row gathers of
    # pos32[sort_idx]; payloads ride the sort almost for free.
    iota_n = jnp.arange(n, dtype=jnp.int32)
    sc, px_s, py_s, pz_s, m_srt, sort_idx = lax.sort(
        (cell_id, pos32[:, 0], pos32[:, 1], pos32[:, 2], m_eff, iota_n),
        dimension=0, num_keys=1, is_stable=True)
    if near == "cells":
        # cell-granularity lists; the columns sweep builds its own at
        # column granularity, so none of this is traced there
        K = min(n, M3) if max_cells <= 0 else int(max_cells)
        first, last = _segment_bounds(sc)
        rank = jnp.arange(n, dtype=jnp.int32) - first
        cell_count = last - first                       # per sorted body
        is_first = (rank == 0) & (sc < M3)
        occ_idx = _compact_sorted(is_first, sc, K, M3)  # sorted occ cells
        # dense cell -> slot inverse map: neighbor lookups are then single
        # gathers instead of searchsorted binary searches (the near field
        # issues 27 lookups per cell)
        slot_of = jnp.full((M3 + 1,), K, jnp.int32).at[
            jnp.minimum(occ_idx, M3)].set(
            jnp.where(occ_idx < M3, jnp.arange(K, dtype=jnp.int32), K))

    # packed-row sources in sorted-body order (sort payloads from above)
    idx_srt = sort_idx.astype(f32)

    def _pack_rows(slot_b, rank_b, keep_b, Kcap, Wd):
        """[Kcap+1, 5 Wd] packed rows: px | py | pz | m | idx (as f32;
        exact for n < 2^24 — far above tree HBM limits).

        Built by SCATTERING the n sorted bodies (5n elements) instead of
        gathering Kcap x Wd x 5 table elements: every row is a prefix of
        the cell-id-sorted body array, and the element-gather pack was
        the near field's dominant cost.
        Dropped bodies scatter their channel's sentinel into the dump
        row Kcap, which therefore stays all-sentinel."""
        s = jnp.where(keep_b, slot_b, Kcap)
        r = jnp.clip(rank_b, 0, Wd - 1)
        sent = jnp.concatenate([jnp.full((3 * Wd,), 1e30, f32),
                                jnp.zeros((Wd,), f32),
                                jnp.full((Wd,), float(n), f32)])
        P = jnp.broadcast_to(sent, (Kcap + 1, 5 * Wd))
        cols = (px_s, py_s, pz_s, m_srt, idx_srt)
        sentv = (1e30, 1e30, 1e30, 0.0, float(n))
        for c, (v, sv) in enumerate(zip(cols, sentv)):
            P = P.at[s, c * Wd + r].set(jnp.where(keep_b, v, sv),
                                        mode="drop")
        return P

    if near == "pairs":
        idx_flat, acc_flat, pe_flat, cap_overflow, cell_overflow = \
            _near_pairs(
                sc, _pack_rows, n, M, ws, eps2, G,
                origin, h, max_chunks, chunk, pair_entries, cell_block,
                _n_parts, _part_index)
    elif near == "columns":
        idx_flat, acc_flat, pe_flat, cap_overflow, cell_overflow = \
            _near_columns(
                pos32, sc, sort_idx, _pack_rows, n, M, ws, eps2, G,
                origin, h, capacity, max_cells, max_big, max_frontier,
                max_chunks, cell_block, _n_parts, _part_index)
    else:
        (idx_flat, acc_flat, pe_flat, cap_overflow,
         cell_overflow) = _near_cells_body(
            sc, sort_idx, rank, cell_count, occ_idx, slot_of, _pack_rows,
            n, M, M3, K, ws, eps2, G, capacity, max_big, max_frontier,
            cell_block, _n_parts, _part_index)
    acc_near = jax.ops.segment_sum(acc_flat, idx_flat,
                                   num_segments=n + 1)[:n]
    pe_near = jax.ops.segment_sum(pe_flat, idx_flat,
                                  num_segments=n + 1)[:n]
    if _psum_axis is not None:
        # sharded sweep: each device covered a disjoint slice of the
        # occupied-cell lists; combine the per-body partials mesh-wide
        acc_near = lax.psum(acc_near, _psum_axis)
        pe_near = lax.psum(pe_near, _psum_axis)

    if "near" in _SKIP:
        acc_near = jnp.zeros_like(acc_near)
        pe_near = jnp.zeros_like(pe_near)
    if "far" in _SKIP:
        a_far = jnp.zeros_like(a_far)
        phi_far = jnp.zeros_like(phi_far)
    acc = (a_far + acc_near) * alive_f[:, None]
    overflow = cap_overflow + cell_overflow

    if with_potential:
        U = far_potential_cellwise() - 0.5 * G * jnp.sum(m_eff * pe_near)
    else:
        U = jnp.zeros((), f32)
    return acc.astype(pos.dtype), U.astype(pos.dtype), overflow


def _near_cells_body(sc, sort_idx, rank, cell_count, occ_idx, slot_of,
                     _pack_rows, n, M, M3, K, ws, eps2, G, capacity,
                     max_big, max_frontier, cell_block,
                     _n_parts, _part_index):
    """Near field at CELL granularity: each occupied finest cell sweeps
    its (2ws+1)^3 neighbor cells (one packed-row gather each)."""
    slot = slot_of[jnp.minimum(sc, M3)]
    keep = (rank < capacity) & (sc < M3) & (slot < K)
    cap_overflow = jnp.sum((rank >= capacity) & (sc < M3) & (slot < K),
                           dtype=jnp.int32)
    cell_overflow = jnp.sum((slot >= K) & (sc < M3), dtype=jnp.int32)

    # Occupancy classes, three-list design. Concentrated systems put ~all
    # mass skew in a few cells: at 65k Plummer the densest cell holds ~100
    # bodies while the MEAN is ~3 — one full-capacity table makes every
    # neighbor row pay the densest cell's width. Occupied cells split into:
    #   * BIG (> 16 bodies): sweep their neighborhoods at full capacity.
    #   * FRONTIER (small cells with >= 1 big neighbor — the thin shell
    #     around the core): i-width 16, full-capacity j rows.
    #   * CLEAN small (everything else, the vast majority): both sides
    #     width 16 through a small-cells-only table.
    # Every (target cell, neighbor) pair lands in exactly one sweep at
    # the minimal width that holds its bodies, so no pairs are lost and
    # no width is wasted.
    #
    # Row-gather economy: the tables pack all five channels (px py pz m
    # idx) into ONE row, so each neighbor costs one packed-row gather
    # instead of five channel-row gathers.
    nb9 = [(a, b) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)]
    n_nb = len(nb9) * (2 * ws + 1)

    split = capacity > 16
    c_small = 16 if split else capacity
    occ_valid = occ_idx < M3
    if split:
        left = jnp.searchsorted(sc, occ_idx, side="left")
        right = jnp.searchsorted(sc, occ_idx, side="right")
        occ_counts = jnp.where(occ_valid, (right - left).astype(jnp.int32), 0)
        big = occ_valid & (occ_counts > c_small)
        # static list budgets: default heuristic (K//8 big, K//4 frontier)
        # is heavily sentinel-padded on concentrated systems — probe the
        # real class sizes with tree_class_probe and pass max_big /
        # max_frontier to cut the padded sweep work
        K_big = min(K, max(256, K // 8)) if max_big <= 0 \
            else min(K, int(max_big))
        K_f = min(K, max(512, K // 4)) if max_frontier <= 0 \
            else min(K, int(max_frontier))
        ids_big = _compact_sorted(big, occ_idx, K_big, M3)
        big_flag = jnp.zeros((M3 + 1,), bool).at[
            jnp.minimum(ids_big, M3)].set(ids_big < M3)
        # frontier classification: neighbor flag gathers over occupied ids
        ocz = jnp.where(occ_valid, occ_idx, 0) % M
        ocy = (jnp.where(occ_valid, occ_idx, 0) // M) % M
        ocx = jnp.where(occ_valid, occ_idx, 0) // (M * M)
        any_big = jnp.zeros((K,), bool)
        for a in range(-ws, ws + 1):
            for b in range(-ws, ws + 1):
                for c in range(-ws, ws + 1):
                    nx, ny, nz = ocx + a, ocy + b, ocz + c
                    okn = ((0 <= nx) & (nx < M) & (0 <= ny) & (ny < M)
                           & (0 <= nz) & (nz < M))
                    nid = jnp.where(okn, (nx * M + ny) * M + nz, M3)
                    any_big = any_big | big_flag[nid]
        small = occ_valid & ~big
        frontier = small & any_big
        ids_small = _compact_sorted(small & ~any_big, occ_idx, K, M3)
        ids_front = _compact_sorted(frontier, occ_idx, K_f, M3)

        # budget overflows: bodies whose cell fell past its list budget
        # lose their target sweep — counted (their source role via the
        # tables is unaffected)
        body_big_sorted = cell_count > c_small
        # dense id -> list-slot maps: per-body membership tests are then
        # single gathers instead of n binary searches
        slot_big = _dense_slot_map(ids_big, K_big, M3)[jnp.minimum(sc, M3)]
        big_drop = jnp.sum(body_big_sorted & (sc < M3) & (slot < K)
                           & (slot_big >= K_big), dtype=jnp.int32)
        front_dense = jnp.zeros((M3 + 1,), bool).at[
            jnp.where(frontier, occ_idx, M3)].set(frontier)
        slot_f = _dense_slot_map(ids_front, K_f, M3)[jnp.minimum(sc, M3)]
        front_drop = jnp.sum(front_dense[jnp.minimum(sc, M3)] & (sc < M3)
                             & (slot < K) & (slot_f >= K_f),
                             dtype=jnp.int32)
        cell_overflow = cell_overflow + big_drop + front_drop

        # width-16 rows holding only small cells' bodies (small-cell rank
        # is < 16 by definition, so it can never overflow)
        keep_s = keep & ~body_big_sorted
        P_s = _pack_rows(slot, rank, keep_s, K, c_small)
        P_full = _pack_rows(slot, rank, keep, K, capacity)
    else:
        ids_small = occ_idx
        P_s = _pack_rows(slot, rank, keep, K, capacity)
        P_full = P_s

    def sweep(ids_list, i_cap, blk, P, width):
        """Exact pair sweep of the listed cells (i-side width ``i_cap``
        from packed table ``P``; j-side = one packed row per neighbor
        cell, width ``width``). Under sharding (``_n_parts > 1``) each
        device sweeps a contiguous 1/``_n_parts`` slice of the list; the
        caller psums the per-body results."""
        Ki = ids_list.shape[0]
        if blk <= 0:
            # ~128 MB pair-tile budget: fewer, bigger lax.map iterations
            budget = (32 * 1024 * 1024) // max(1, i_cap * width * n_nb)
            blk = max(8, min(4096, 1 << (max(3, budget).bit_length() - 1)))
        Ki_part = -(-Ki // max(1, _n_parts))
        nblk = -(-Ki_part // blk)
        W = width
        base = (jnp.int32(0) if _part_index is None
                else _part_index * Ki_part)
        # each partition sweeps [base, end) ONLY — a block overrunning the
        # partition boundary would double-count the next device's cells
        end = jnp.minimum(Ki, base + Ki_part)

        def block(s0):
            slots_l = s0 + jnp.arange(blk)
            ids = ids_list[jnp.minimum(slots_l, Ki - 1)]
            valid = (slots_l < end) & (ids < M3)
            cz = ids % M
            cy = (ids // M) % M
            cx = ids // (M * M)
            nb_slots = []
            for a, b in nb9:
                for c in range(-ws, ws + 1):
                    nx, ny, nz = cx + a, cy + b, cz + c
                    ok = ((0 <= nx) & (nx < M) & (0 <= ny) & (ny < M)
                          & (0 <= nz) & (nz < M) & valid)
                    nid = jnp.where(ok, (nx * M + ny) * M + nz, M3)
                    nb_slots.append(slot_of[nid])
            nb = jnp.stack(nb_slots, axis=1)                 # [B, n_nb]

            own = slot_of[jnp.where(valid, ids, M3)]
            my = P[own]                                      # [B, 5W]
            rows = P[nb].reshape(blk, n_nb, 5, W)
            rows = rows.transpose(0, 2, 1, 3).reshape(blk, 5, -1)

            pi = tuple(my[:, k * W:k * W + i_cap] for k in range(3))
            idx_my = my[:, 4 * W:4 * W + i_cap]
            pj = tuple(rows[:, k] for k in range(3))         # [B, n_nb W]
            mj = rows[:, 3]
            idx_nb = rows[:, 4]

            dx = pj[0][:, None, :] - pi[0][:, :, None]       # [B, Ci, n_nb W]
            dy = pj[1][:, None, :] - pi[1][:, :, None]
            dz = pj[2][:, None, :] - pi[2][:, :, None]
            r2 = dx * dx + dy * dy + dz * dz + eps2
            inv_r = lax.rsqrt(r2)
            not_self = idx_my[:, :, None] != idx_nb[:, None, :]
            w = jnp.where(not_self,
                          mj[:, None, :] * (inv_r * inv_r * inv_r), 0.0)
            acc_b = G * jnp.stack(
                [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1),
                 jnp.sum(w * dz, -1)], axis=-1)
            pe_b = jnp.sum(jnp.where(not_self, mj[:, None, :] * inv_r, 0.0),
                           -1)
            return idx_my.astype(jnp.int32), acc_b, pe_b

        starts = base + jnp.arange(0, nblk * blk, blk)
        idx_all, acc_all, pe_all = lax.map(block, starts)
        return (idx_all.reshape(-1), acc_all.reshape(-1, 3),
                pe_all.reshape(-1))

    i_s, a_s, p_s = sweep(ids_small, c_small, cell_block, P_s, c_small)
    if split:
        i_f, a_f, p_f = sweep(ids_front, c_small, cell_block,
                              P_full, capacity)
        i_b, a_b, p_b = sweep(ids_big, capacity, cell_block,
                              P_full, capacity)
        idx_flat = jnp.concatenate([i_s, i_f, i_b])
        acc_flat = jnp.concatenate([a_s, a_f, a_b])
        pe_flat = jnp.concatenate([p_s, p_f, p_b])
    else:
        idx_flat, acc_flat, pe_flat = i_s, a_s, p_s
    return idx_flat, acc_flat, pe_flat, cap_overflow, cell_overflow


def _near_columns(pos32, sc, sort_idx, _pack_rows, n, M, ws, eps2, G,
                  origin, h, capacity, max_cells, max_big, max_frontier,
                  max_chunks, cell_block, _n_parts, _part_index):
    """Near field at COLUMN granularity: each occupied (x, y) column
    sweeps its (2ws+1)^2 neighbor COLUMNS, with the |dz| <= ws cell-band
    claim enforced in-kernel from the packed z coordinates.

    Why: the cell sweep is bound by its neighbor row gathers —
    (2ws+1)^3 rows per occupied CELL. Bodies
    sorted by cell id are already grouped by column (column id =
    cell_id // M), so the same argsort yields per-column tables, and the
    row count drops to (2ws+1)^2 per occupied COLUMN — ~25x fewer rows
    on concentrated systems (occupied columns are ~10x fewer than
    occupied cells, 9 rows vs 27). The price is masked pair arithmetic
    against whole neighbor columns, and pair arithmetic is ~1000x
    cheaper per unit than random access. ``capacity`` / ``max_cells`` /
    ``max_big`` / ``max_frontier`` are per-column budgets here
    (c_small = 32); size them with :func:`tree_column_probe`."""
    M2 = M * M
    col_s = jnp.minimum(sc // M, M2)  # sorted ascending; dead -> M2
    first_c, last_c = _segment_bounds(col_s)
    rank_c = jnp.arange(n, dtype=jnp.int32) - first_c
    col_count = last_c - first_c                      # per sorted body
    is_first_c = (rank_c == 0) & (col_s < M2)
    Kc = min(n, M2) if max_cells <= 0 else int(max_cells)
    occ_c = _compact_sorted(is_first_c, col_s, Kc, M2)
    occ_c_valid = occ_c < M2
    slot_c = jnp.full((M2 + 1,), Kc, jnp.int32).at[
        jnp.minimum(occ_c, M2)].set(
        jnp.where(occ_c_valid, jnp.arange(Kc, dtype=jnp.int32), Kc))

    slot_b = slot_c[col_s]  # per sorted body
    keep = (rank_c < capacity) & (col_s < M2) & (slot_b < Kc)
    cap_overflow = jnp.sum(
        (rank_c >= capacity) & (col_s < M2) & (slot_b < Kc),
        dtype=jnp.int32)
    cell_overflow = jnp.sum((slot_b >= Kc) & (col_s < M2), dtype=jnp.int32)

    # same three-class split as the cell sweep, at column granularity
    c_small = 32 if capacity > 32 else capacity
    split = capacity > c_small
    if split:
        left = jnp.searchsorted(col_s, occ_c, side="left")
        right = jnp.searchsorted(col_s, occ_c, side="right")
        occ_counts = jnp.where(occ_c_valid,
                               (right - left).astype(jnp.int32), 0)
        big = occ_c_valid & (occ_counts > c_small)
        K_big = min(Kc, max(256, Kc // 8)) if max_big <= 0 \
            else min(Kc, int(max_big))
        K_f = min(Kc, max(512, Kc // 4)) if max_frontier <= 0 \
            else min(Kc, int(max_frontier))
        ids_big = _compact_sorted(big, occ_c, K_big, M2)
        big_flag = jnp.zeros((M2 + 1,), bool).at[
            jnp.minimum(ids_big, M2)].set(ids_big < M2)
        ocy = jnp.where(occ_c_valid, occ_c, 0) % M
        ocx = jnp.where(occ_c_valid, occ_c, 0) // M
        any_big = jnp.zeros((Kc,), bool)
        for a in range(-ws, ws + 1):
            for b in range(-ws, ws + 1):
                nx, ny = ocx + a, ocy + b
                okn = (0 <= nx) & (nx < M) & (0 <= ny) & (ny < M)
                nid = jnp.where(okn, nx * M + ny, M2)
                any_big = any_big | big_flag[nid]
        small = occ_c_valid & ~big
        frontier = small & any_big
        ids_small = _compact_sorted(small & ~any_big, occ_c, Kc, M2)
        ids_front = _compact_sorted(frontier, occ_c, K_f, M2)

        body_big_sorted = col_count > c_small
        # dense id -> list-slot maps (single gathers, not binary searches)
        slot_big = _dense_slot_map(ids_big, K_big, M2)[col_s]
        big_drop = jnp.sum(body_big_sorted & (col_s < M2) & (slot_b < Kc)
                           & (slot_big >= K_big), dtype=jnp.int32)
        front_dense = jnp.zeros((M2 + 1,), bool).at[
            jnp.where(frontier, occ_c, M2)].set(frontier)
        slot_f = _dense_slot_map(ids_front, K_f, M2)[col_s]
        front_drop = jnp.sum(front_dense[col_s] & (col_s < M2)
                             & (slot_b < Kc) & (slot_f >= K_f),
                             dtype=jnp.int32)
        cell_overflow = cell_overflow + big_drop + front_drop

        keep_s = keep & ~body_big_sorted
        P_s = _pack_rows(slot_b, rank_c, keep_s, Kc, c_small)
        P_full = _pack_rows(slot_b, rank_c, keep, Kc, capacity)

        # ---- big sweep i-side CHUNKING -------------------------------
        # Sweeping each big column padded to full ``capacity`` on the i
        # side makes the big sweep cost n_big x capacity x 9 x capacity;
        # on concentrated cores (1M Plummer) that was ~85% of the whole
        # near phase while the MEDIAN big column holds a small fraction
        # of capacity. Instead the kept big-column bodies are re-packed
        # into consecutive 32-row chunks (one more scatter pack), and
        # the big sweep runs chunk-vs-neighbor-columns: cost becomes
        # big-BODIES x 9 x capacity. The chunk ordinal is a prefix
        # cumsum over the same sorted body order the packs use.
        CPC = -(-capacity // c_small)  # max chunks per column
        keep_big = keep & body_big_sorted & (slot_big < K_big)
        chunk_start = keep_big & (rank_c % c_small == 0)
        K_ch = (min(K_big * CPC, max(512, 4 * K_big))
                if max_chunks <= 0 else min(int(max_chunks), K_big * CPC))
        # per body: ordinal of its chunk among all chunk starts
        chunk_ord = jnp.cumsum(chunk_start.astype(jnp.int32)) - 1
        keep_ch = keep_big & (chunk_ord < K_ch)
        chunk_drop = jnp.sum(keep_big & ~keep_ch, dtype=jnp.int32)
        cell_overflow = cell_overflow + chunk_drop
        # i-side pack: row = chunk ordinal, lane = rank within chunk
        P_ch = _pack_rows(jnp.clip(chunk_ord, 0, K_ch), rank_c % c_small,
                          keep_ch, K_ch, c_small)
        # per chunk: its column id (for the neighbor lookups), compacted
        # in the same order the ordinals were assigned
        ids_chunk = _compact_sorted(chunk_start & (chunk_ord < K_ch),
                                    col_s, K_ch, M2)
    else:
        ids_small = occ_c
        P_s = _pack_rows(slot_b, rank_c, keep, Kc, capacity)
        P_full = P_s

    nb2 = [(a, b) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)]
    n_nb = len(nb2)
    oz = origin[2]

    def sweep(ids_list, i_cap, blk, P, width, Pi=None):
        """Masked pair sweep of the listed COLUMNS (i-side width
        ``i_cap``; j-side = one packed row per neighbor column, width
        ``width``). With ``Pi`` the i side reads row ``list position``
        of that table (width ``i_cap``) instead of the column's row in
        ``P`` — the chunked big sweep's contract. Under sharding each
        device sweeps a contiguous 1/``_n_parts`` slice; the caller
        psums the per-body results."""
        Ki = ids_list.shape[0]
        if blk <= 0:
            budget = (32 * 1024 * 1024) // max(1, i_cap * width * n_nb)
            blk = max(8, min(4096, 1 << (max(3, budget).bit_length() - 1)))
        Ki_part = -(-Ki // max(1, _n_parts))
        nblk = -(-Ki_part // blk)
        W = width
        base = (jnp.int32(0) if _part_index is None
                else _part_index * Ki_part)
        end = jnp.minimum(Ki, base + Ki_part)

        def block(s0):
            slots_l = s0 + jnp.arange(blk)
            ids = ids_list[jnp.minimum(slots_l, Ki - 1)]
            valid = (slots_l < end) & (ids < M2)
            cy = ids % M
            cx = ids // M
            nb_slots = []
            for a, b in nb2:
                nx, ny = cx + a, cy + b
                ok = ((0 <= nx) & (nx < M) & (0 <= ny) & (ny < M)
                      & valid)
                nid = jnp.where(ok, nx * M + ny, M2)
                nb_slots.append(slot_c[nid])
            nb = jnp.stack(nb_slots, axis=1)                 # [B, n_nb]

            if Pi is None:
                own = slot_c[jnp.where(valid, ids, M2)]
                my = P[own]                                  # [B, 5W]
                Wi = W
            else:
                my = Pi[jnp.minimum(slots_l, Ki - 1)]        # [B, 5 i_cap]
                Wi = i_cap
            rows = P[nb].reshape(blk, n_nb, 5, W)
            rows = rows.transpose(0, 2, 1, 3).reshape(blk, 5, -1)

            pi = tuple(my[:, k * Wi:k * Wi + i_cap] for k in range(3))
            idx_my = my[:, 4 * Wi:4 * Wi + i_cap]
            pj = tuple(rows[:, k] for k in range(3))         # [B, n_nb W]
            mj = rows[:, 3]
            idx_nb = rows[:, 4]

            # z cell-band claim: identical binning arithmetic to the
            # deposit (same f32 ops on the same values -> same cell),
            # so the level partition stays exact. Sentinel rows float
            # to zc = M-1 but carry mass 0 / idx n, contributing 0.
            zci = jnp.clip(jnp.floor((pi[2] - oz) / h), 0, M - 1)
            zcj = jnp.clip(jnp.floor((pj[2] - oz) / h), 0, M - 1)
            band = jnp.abs(zci[:, :, None] - zcj[:, None, :]) <= ws

            dx = pj[0][:, None, :] - pi[0][:, :, None]       # [B, Ci, n_nb W]
            dy = pj[1][:, None, :] - pi[1][:, :, None]
            dz = pj[2][:, None, :] - pi[2][:, :, None]
            r2 = dx * dx + dy * dy + dz * dz + eps2
            inv_r = lax.rsqrt(r2)
            take = band & (idx_my[:, :, None] != idx_nb[:, None, :])
            w = jnp.where(take,
                          mj[:, None, :] * (inv_r * inv_r * inv_r), 0.0)
            acc_b = G * jnp.stack(
                [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1),
                 jnp.sum(w * dz, -1)], axis=-1)
            pe_b = jnp.sum(jnp.where(take, mj[:, None, :] * inv_r, 0.0),
                           -1)
            return idx_my.astype(jnp.int32), acc_b, pe_b

        starts = base + jnp.arange(0, nblk * blk, blk)
        idx_all, acc_all, pe_all = lax.map(block, starts)
        return (idx_all.reshape(-1), acc_all.reshape(-1, 3),
                pe_all.reshape(-1))

    i_s, a_s, p_s = sweep(ids_small, c_small, cell_block, P_s, c_small)
    if split:
        i_f, a_f, p_f = sweep(ids_front, c_small, cell_block,
                              P_full, capacity)
        i_b, a_b, p_b = sweep(ids_chunk, c_small, cell_block,
                              P_full, capacity, Pi=P_ch)
        idx_flat = jnp.concatenate([i_s, i_f, i_b])
        acc_flat = jnp.concatenate([a_s, a_f, a_b])
        pe_flat = jnp.concatenate([p_s, p_f, p_b])
    else:
        idx_flat, acc_flat, pe_flat = i_s, a_s, p_s
    return idx_flat, acc_flat, pe_flat, cap_overflow, cell_overflow


# How the pairs sweep locates the z-trimmed j-chunk run of a neighbor
# column: "table" = per-column (column, z-cell) rank table with a
# length-(M+1) suffix scan; "scan" = global cell-id suffix scan over the
# full M3-sized grid. Identical semantics (parity-tested); the table's
# scan is three orders of magnitude shorter. Module flag, not a jit key —
# clear_cache() between flips.
_PAIRS_CF = "table"


def _pairs_geometry(sc, n, M, ws, C, K_ch):
    """Shared chunk/run geometry of the ``near="pairs"`` sweep (used by
    the sweep and, with a safe K_ch bound, by :func:`tree_pairs_probe`
    so the budgets can never drift from the sweep's own accounting).

    Chunks every column into consecutive C-body chunks of the cell-id-
    sorted body order, and computes for every (chunk, neighbor column)
    the Z-TRIMMED run of j-chunks: bodies are z-cell-sorted within a
    column, so the j-chunks whose z-cell range can overlap the i-chunk's
    |dz| <= ws band form one consecutive run — located with two element
    gathers into a (column, z-cell) -> first-sorted-position table (see
    ``_PAIRS_CF``). Trimming is EXACT (a skipped chunk pair
    contains no in-band pair by monotonicity); on concentrated cores it
    drops ~60-70% of the chunk pairs the untrimmed sweep would pad over
    (measured census: keep-fraction 0.43 at 65k/l7, 0.34 at 262k/l8,
    lower still at 1M where core columns are tallest).

    Returns a dict: per-body ``col_s / rank_c / valid_b / chunk_ord /
    keep``; per-chunk ``ids_chunk_col / chunk_valid / j_lo [K_ch, 9] /
    cnt [K_ch, 9] / S_ch`` (trimmed 9-neighborhood j-chunk totals)."""
    M2, M3 = M * M, M * M * M
    col_s = jnp.minimum(sc // M, M2)  # sorted ascending; dead -> M2
    first_c, last_c = _segment_bounds(col_s)
    rank_c = jnp.arange(n, dtype=jnp.int32) - first_c
    valid_b = col_s < M2
    is_first_c = (rank_c == 0) & valid_b

    chunk_start = valid_b & (rank_c % C == 0)
    chunk_ord = jnp.cumsum(chunk_start.astype(jnp.int32)) - 1
    keep = valid_b & (chunk_ord < K_ch)
    in_budget = chunk_start & (chunk_ord < K_ch)
    ids_chunk_col = _compact_sorted(in_budget, col_s, K_ch, M2)
    chunk_valid = ids_chunk_col < M2

    # dense maps: column -> first chunk row / first sorted position
    first_chunk_map = jnp.full((M2 + 1,), K_ch, jnp.int32).at[
        jnp.where(is_first_c, col_s, M2)].set(
        jnp.where(is_first_c, chunk_ord, K_ch))
    colfirst = jnp.full((M2 + 1,), n, jnp.int32).at[
        jnp.where(is_first_c, col_s, M2)].set(
        jnp.where(is_first_c, first_c, n))

    pos_i = jnp.arange(n, dtype=jnp.int32)
    if _PAIRS_CF == "table":
        # (column, z-cell) -> first sorted position with that column and
        # z-cell >= z, as a [M2+1, M+1] TABLE: scatter-min of global
        # positions + a LENGTH-(M+1) suffix min-scan along the z axis.
        # Semantically equal to the global cellfirst below (columns are
        # contiguous in the sort, and queries are clamped to the column
        # end via colend) but the scan is 3 orders of magnitude shorter
        # than the M3-sized one.
        zrow = jnp.where(valid_b, sc % M, M)
        rt = jnp.full((M2 + 1, M + 1), n, jnp.int32).at[
            jnp.where(valid_b, col_s, M2), zrow].min(pos_i)
        rt = lax.associative_scan(jnp.minimum, rt, reverse=True, axis=1)
        rt_flat = rt.reshape(-1)
        colend = jnp.full((M2 + 1,), n, jnp.int32).at[
            jnp.where(is_first_c, col_s, M2)].set(
            jnp.where(is_first_c, last_c, n))
        cellfirst = None
    else:
        # cell id -> first sorted position with cell >= id (dead bodies
        # sort last at M3, so cellfirst[M3] is exactly the live count)
        cf = jnp.full((M3 + 2,), n, jnp.int32).at[
            jnp.minimum(sc, M3)].min(pos_i)
        cellfirst = lax.associative_scan(jnp.minimum, cf, reverse=True)

    # per-chunk z-cell bounds (z-cells are monotone within a column)
    z_s = jnp.where(valid_b, sc % M, 0)
    ord_c = jnp.where(keep, chunk_ord, K_ch)
    zlo_ch = jnp.zeros((K_ch + 1,), jnp.int32).at[
        jnp.where(in_budget, chunk_ord, K_ch)].set(
        jnp.where(in_budget, z_s, 0))[:K_ch]
    zhi_ch = jax.ops.segment_max(
        jnp.where(keep, z_s, 0), ord_c, num_segments=K_ch + 1)[:K_ch]

    nb2 = [(a, b) for a in range(-ws, ws + 1) for b in range(-ws, ws + 1)]
    cy = jnp.where(chunk_valid, ids_chunk_col, 0) % M
    cx = jnp.where(chunk_valid, ids_chunk_col, 0) // M
    zb_lo = jnp.clip(zlo_ch - ws, 0, M)
    zb_hi = jnp.minimum(zhi_ch + ws + 1, M)
    j_lo_l, cnt_l = [], []
    for a, b in nb2:
        nx, ny = cx + a, cy + b
        ok = ((0 <= nx) & (nx < M) & (0 <= ny) & (ny < M) & chunk_valid)
        nc = jnp.where(ok, nx * M + ny, M2)
        if _PAIRS_CF == "table":
            ce = colend[nc]
            p_lo = jnp.minimum(rt_flat[nc * (M + 1) + zb_lo], ce)
            p_hi = jnp.minimum(rt_flat[nc * (M + 1) + zb_hi], ce)
        else:
            p_lo = cellfirst[jnp.minimum(nc * M + zb_lo, M3 + 1)]
            p_hi = cellfirst[jnp.minimum(nc * M + zb_hi, M3 + 1)]
        base_p = colfirst[nc]
        lo_q = jnp.where(ok, (p_lo - base_p) // C, 0)
        hi_q = jnp.where(ok, -(-(p_hi - base_p) // C), 0)
        c_ = jnp.where(ok & (p_hi > p_lo), hi_q - lo_q, 0)
        j_lo_l.append(jnp.minimum(first_chunk_map[nc] + lo_q, K_ch))
        cnt_l.append(c_)
    j_lo = jnp.stack(j_lo_l, axis=1)                     # [K_ch, 9]
    cnt = jnp.stack(cnt_l, axis=1)                       # [K_ch, 9]
    return dict(col_s=col_s, rank_c=rank_c, valid_b=valid_b,
                chunk_ord=chunk_ord, keep=keep,
                ids_chunk_col=ids_chunk_col, chunk_valid=chunk_valid,
                j_lo=j_lo, cnt=cnt, S_ch=jnp.sum(cnt, axis=-1))


def _near_pairs(sc, _pack_rows, n, M, ws, eps2, G,
                origin, h, max_chunks, chunk, pair_entries, cell_block,
                _n_parts, _part_index):
    """Near field at CHUNK-PAIR granularity: every column is cut into
    consecutive ``chunk``-body i-chunks, and each i-chunk sweeps exactly
    the j-chunks of its (2ws+1)^2 neighbor columns — padded only to the
    next OCTAVE of its true j-chunk total.

    Why: the column sweep's big/frontier classes pad every neighbor
    column's j side to the DENSEST column's ``capacity``; on a 1M Plummer
    core the padded pair count is ~50-100x the true near-pair count, and
    the big sweep is ~85% of the near phase. Here the j side of i-chunk k
    is the concatenation of its 9 neighbor columns' chunk-row runs —
    consecutive rows of ONE packed table (columns are contiguous in the
    cell-sorted body order), located by two dense maps (column -> first
    chunk row, column -> chunk count). Padding is bounded by the octave
    rounding (< 2x) plus the per-chunk lane rounding, for the SAME
    packed-row gathers. The occupancy classes, per-column
    ``capacity``, and the big/frontier/chunk budgets all disappear; the
    only budgets are ``max_chunks`` (total chunk rows; pass 0 to derive
    ceil(n/chunk) + a column-fragmentation margin — always safe but
    padded) and ``pair_entries`` (per-octave i-chunk counts, octave o
    holding chunks whose 9-neighborhood totals at most 9 * 2**o j-chunks;
    size both with :func:`tree_pairs_probe`)."""
    C = int(chunk)
    K_ch = int(max_chunks) if max_chunks > 0 else (
        -(-n // C) + min(n, M * M))
    g = _pairs_geometry(sc, n, M, ws, C, K_ch)
    cap_overflow = jnp.sum(g["valid_b"] & (g["chunk_ord"] >= K_ch),
                           dtype=jnp.int32)
    P = _pack_rows(g["chunk_ord"], g["rank_c"] % C, g["keep"], K_ch, C)
    chunk_valid = g["chunk_valid"]
    chunk_ord = g["chunk_ord"]
    keep = g["keep"]
    j_lo, cnt, S_ch = g["j_lo"], g["cnt"], g["S_ch"]
    n_nb = (2 * ws + 1) ** 2
    n_oct = len(pair_entries)
    base_w = n_nb
    oct_of = jnp.zeros((K_ch,), jnp.int32)
    for k in range(n_oct):
        oct_of = oct_of + (S_ch > base_w * (1 << k)).astype(jnp.int32)
    chunk_rows = jnp.arange(K_ch, dtype=jnp.int32)

    oz = origin[2]
    results = []
    # chunks past the last compiled octave lose their target sweep too
    drop_flag = chunk_valid & (oct_of >= n_oct)
    for o, E_o in enumerate(pair_entries):
        in_o = chunk_valid & (oct_of == o)
        if E_o <= 0:
            drop_flag = drop_flag | in_o
            continue
        E_o = int(E_o)
        W = base_w * (1 << o)  # j width in chunk rows
        ord_o = jnp.cumsum(in_o.astype(jnp.int32)) - 1
        drop_flag = drop_flag | (in_o & (ord_o >= E_o))
        ids_o = _compact_sorted(in_o & (ord_o < E_o), chunk_rows, E_o,
                                K_ch)

        blk = cell_block
        if blk <= 0:
            budget = (32 * 1024 * 1024) // max(1, C * W * C)
            blk = max(1, min(4096, 1 << (max(1, budget).bit_length() - 1)))
        Ki_part = -(-E_o // max(1, _n_parts))
        nblk = -(-Ki_part // blk)
        base = (jnp.int32(0) if _part_index is None
                else _part_index * Ki_part)
        end = jnp.minimum(E_o, base + Ki_part)

        def block(s0, _W=W, _blk=blk, _ids=ids_o, _end=end):
            slots_l = s0 + jnp.arange(_blk)
            ci = _ids[jnp.minimum(slots_l, _ids.shape[0] - 1)]
            valid = (slots_l < _end) & (ci < K_ch)
            cic = jnp.where(valid, jnp.minimum(ci, K_ch - 1), K_ch - 1)
            # trimmed per-(chunk, neighbor) j runs, precomputed dense
            cj = jnp.where(valid[:, None], cnt[cic], 0)    # [B, 9]
            j0 = j_lo[cic]                                 # [B, 9]
            ci = jnp.where(valid, ci, K_ch)
            cum = jnp.cumsum(cj, axis=1)                   # inclusive
            cum0 = jnp.concatenate(
                [jnp.zeros((_blk, 1), jnp.int32), cum[:, :-1]], axis=1)
            p = jnp.arange(_W, dtype=jnp.int32)[None, :]   # [1, W]
            # segment of slot p: number of neighbors fully before it
            seg = jnp.sum((p[:, :, None] >= cum[:, None, :]).astype(
                jnp.int32), axis=-1)                       # [B, W] in 0..9
            in_range = p < cum[:, -1:]
            segc = jnp.minimum(seg, n_nb - 1)
            j_row = (jnp.take_along_axis(j0, segc, axis=1)
                     + p - jnp.take_along_axis(cum0, segc, axis=1))
            j_row = jnp.where(in_range, jnp.minimum(j_row, K_ch), K_ch)

            my = P[ci]                                     # [B, 5C]
            rows = P[j_row].reshape(_blk, _W, 5, C)
            rows = rows.transpose(0, 2, 1, 3).reshape(_blk, 5, -1)

            pi = tuple(my[:, k * C:(k + 1) * C] for k in range(3))
            idx_my = my[:, 4 * C:5 * C]
            pj = tuple(rows[:, k] for k in range(3))       # [B, W C]
            mj = rows[:, 3]
            idx_nb = rows[:, 4]

            # z cell-band claim: identical binning arithmetic to the
            # deposit (same f32 ops on the same values -> same cell), so
            # the level partition stays exact; sentinel rows carry mass 0
            zci = jnp.clip(jnp.floor((pi[2] - oz) / h), 0, M - 1)
            zcj = jnp.clip(jnp.floor((pj[2] - oz) / h), 0, M - 1)
            band = jnp.abs(zci[:, :, None] - zcj[:, None, :]) <= ws

            dx = pj[0][:, None, :] - pi[0][:, :, None]     # [B, C, W C]
            dy = pj[1][:, None, :] - pi[1][:, :, None]
            dz = pj[2][:, None, :] - pi[2][:, :, None]
            r2 = dx * dx + dy * dy + dz * dz + eps2
            inv_r = lax.rsqrt(r2)
            take = band & (idx_my[:, :, None] != idx_nb[:, None, :])
            w = jnp.where(take,
                          mj[:, None, :] * (inv_r * inv_r * inv_r), 0.0)
            acc_b = G * jnp.stack(
                [jnp.sum(w * dx, -1), jnp.sum(w * dy, -1),
                 jnp.sum(w * dz, -1)], axis=-1)
            pe_b = jnp.sum(jnp.where(take, mj[:, None, :] * inv_r, 0.0),
                           -1)
            return idx_my.astype(jnp.int32), acc_b, pe_b

        starts = base + jnp.arange(0, nblk * blk, blk)
        idx_all, acc_all, pe_all = lax.map(block, starts)
        results.append((idx_all.reshape(-1), acc_all.reshape(-1, 3),
                        pe_all.reshape(-1)))

    # dropped i-chunks (octave budget exhausted or past the last octave)
    # lose their TARGET sweep; count their kept bodies
    dropped_b = jnp.concatenate([drop_flag, jnp.zeros((1,), bool)])[
        jnp.minimum(chunk_ord, K_ch)]
    cell_overflow = jnp.sum(keep & dropped_b, dtype=jnp.int32)

    if not results:
        z = jnp.zeros((1,), jnp.int32) + n
        return (z, jnp.zeros((1, 3), jnp.float32),
                jnp.zeros((1,), jnp.float32), cap_overflow, cell_overflow)
    idx_flat = jnp.concatenate([r[0] for r in results])
    acc_flat = jnp.concatenate([r[1] for r in results])
    pe_flat = jnp.concatenate([r[2] for r in results])
    return idx_flat, acc_flat, pe_flat, cap_overflow, cell_overflow


def tree_sharded_force(
    pos, mass, alive, *,
    axis_name: str,
    n_shards: int,
    G_grav: float,
    eps2: float,
    levels: int = 6,
    capacity: int = 48,
    ws: int = 1,
    max_cells: int = 0,
    order: int = 1,
    max_big: int = 0,
    max_frontier: int = 0,
    max_chunks: int = 0,
    near: str = "cells",
    chunk: int = 32,
    pair_entries: tuple = (),
    with_potential: bool = True,
    box=None,
    _phase: str = "both",
    with_overflow: bool = False,
) -> tuple:
    """Tree force for use INSIDE ``shard_map`` over a body-sharded mesh:
    local (pos, mass, alive) shards in, local acc shard + replicated total
    potential out (the ForceFn contract of ``parallel.sharded``).
    ``_phase`` stages the evaluation exactly like
    :func:`tree_acc_potential_staged` (the sharded large-N rollout runs
    "far" and "near" as separate programs); ``with_overflow=True`` appends
    the replicated near-field overflow count to the return tuple (the
    staged host loop checks it every step).

    Scaling contract: the body arrays are all_gathered over ``axis_name``
    (a few MB/array at tree-regime N), so the deposit/pyramid/far-
    field conv run replicated — the far field is the cheap conv phase and
    needs no halo machinery. The NEAR FIELD — the dominant, gather-bound cost — is
    split: each device sweeps a disjoint 1/``n_shards`` slice of every
    occupied-cell list and one psum combines the per-body partials. Net:
    near-field compute scales ~1/D, far-field compute and table memory are
    replicated. Overflow counters are computed from replicated machinery
    (identical on every device) and dropped here, matching the hot-path
    contract of ``rollout.resolve_force_fn``; probe budgets with
    :func:`tree_occupancy_probe` before building the step."""
    block = pos.shape[0]

    def g(x):
        return lax.all_gather(x, axis_name, tiled=True)

    pos_g, mass_g = g(pos), g(mass)
    alive_g = g(alive) if alive is not None else None
    part = lax.axis_index(axis_name)
    acc, U, ovf = tree_acc_potential(
        pos_g, mass_g, alive_g, G_grav=G_grav, eps2=eps2, levels=levels,
        capacity=capacity, ws=ws, max_cells=max_cells, order=order,
        max_big=max_big, max_frontier=max_frontier, max_chunks=max_chunks,
        near=near, chunk=chunk, pair_entries=tuple(pair_entries),
        with_potential=with_potential, box=box, _phase=_phase,
        _n_parts=n_shards, _part_index=part, _psum_axis=axis_name)
    # U is numerically identical on every device (replicated far phase +
    # psum'd near phase) but built from all_gathered values, so shard_map's
    # varying-manual-axes checker can't see the replication — one scalar
    # mean-psum states it explicitly
    U = lax.psum(U, axis_name) / float(n_shards)
    off = part * block
    acc_local = lax.dynamic_slice_in_dim(acc, off, block, axis=0)
    if not with_overflow:
        return acc_local, U
    # the overflow counters come from replicated machinery (budgets are
    # censused over the full gathered worklist/cell lists, not the local
    # slice), so they are identical on every device — pmax states it
    return acc_local, U, lax.pmax(ovf, axis_name)


def tree_acc_potential_staged(
    pos, mass, alive=None, **kwargs,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Two-call tree evaluation: the conv far field and the near-field
    sweep compile and run as SEPARATE XLA programs.

    Same arguments and return contract as :func:`tree_acc_potential`.
    Each phase compiles as a smaller program, and the near phase's
    overflow count reaches the host every call. Host-driven use only: the
    two dispatches cannot live inside an enclosing jit/scan, so pair it
    with a host step loop (engine facade style), not ``rollout``. Whether
    the single program is as fast at N >= 512k on the GPU is ROADMAP
    item A2."""
    a_f, U_f, _ = tree_acc_potential(pos, mass, alive, _phase="far",
                                     **kwargs)
    a_n, U_n, overflow = tree_acc_potential(pos, mass, alive,
                                            _phase="near", **kwargs)
    return a_f + a_n, U_f + U_n, overflow


def _host_probe(jit_fn):
    """Run a budget probe on the in-process CPU backend regardless of the
    default platform. Probe results are consumed on host (static budget
    sizing), so they stay off the device's memory and compile queue, as
    ``ops/neighbor.neighbor_budgets`` does. Falls back to the
    default backend when inputs are tracers (probe used inside a traced
    context) or no CPU backend exists.

    The wrapper intentionally hides the jit-function API (``.lower()``,
    ``.clear_cache()``, static-argnum introspection); the unwrapped
    jitted probe is exposed as ``<probe>._jit_fn`` — tests and tooling
    that need those attributes must go through it."""
    import functools

    @functools.wraps(jit_fn)
    def run(pos, alive=None, **kw):
        box = kw.get("box")
        traced = (isinstance(pos, jax.core.Tracer)
                  or isinstance(alive, jax.core.Tracer)
                  or (box is not None
                      and any(isinstance(b, jax.core.Tracer) for b in box)))
        if traced:
            # probe called inside a traced context (any operand): the
            # np.asarray host transfers below would raise
            # TracerArrayConversionError — run on the default backend
            return jit_fn(pos, alive, **kw)
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            return jit_fn(pos, alive, **kw)
        with jax.default_device(cpu):
            pos_c = jnp.asarray(np.asarray(pos))
            alive_c = (None if alive is None
                       else jnp.asarray(np.asarray(alive)))
            if box is not None:
                kw["box"] = (jnp.asarray(np.asarray(box[0])),
                             jnp.asarray(np.asarray(box[1])))
            return jit_fn(pos_c, alive_c, **kw)

    run._jit_fn = jit_fn  # the unwrapped jitted probe, for tests
    return run


@_host_probe
@partial(jax.jit, static_argnames=("levels", "ws", "c_small"))
def tree_class_probe(
    pos: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    levels: int = 6,
    ws: int = 1,
    c_small: int = 16,
    box=None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Occupancy-class census for sizing ALL of the tree's static budgets:
    returns (max bodies per finest cell, occupied cells, BIG cells
    [> c_small bodies], FRONTIER cells [small with a big (2ws+1)^3
    neighbor]) — the sizers for ``capacity`` / ``max_cells`` /
    ``max_big`` / ``max_frontier``, binned exactly like
    :func:`tree_acc_potential` (same box fit, dead-body handling, and
    class definitions). One segment-sum plus (2ws+1)^3 dense boolean
    shifts of the finest grid — no gathers."""
    n = pos.shape[0]
    M = 2 ** levels
    M3 = M * M * M
    pos32 = pos.astype(jnp.float32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.astype(jnp.float32),
                                      M, None)
    else:
        center = jnp.asarray(box[0], jnp.float32)
        half = jnp.asarray(box[1], jnp.float32)
    h = 2.0 * half / M
    cc = jnp.clip(jnp.floor((pos32 - (center - half)) / h).astype(jnp.int32),
                  0, M - 1)
    cell_id = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    cell_id = jnp.where(alive_b, cell_id, M3)
    counts = jax.ops.segment_sum(alive_b.astype(jnp.int32), cell_id,
                                 num_segments=M3 + 1)[:M3]
    occupied = counts > 0
    big3 = (counts > c_small).reshape(M, M, M)
    # any-big within the (2ws+1)^3 neighborhood: padded shifts, no gathers
    p = jnp.pad(big3, ws)
    any_big = jnp.zeros_like(big3)
    for a in range(2 * ws + 1):
        for b in range(2 * ws + 1):
            for c in range(2 * ws + 1):
                any_big = any_big | lax.dynamic_slice(p, (a, b, c),
                                                      (M, M, M))
    any_big = any_big.reshape(-1)
    big = counts > c_small
    frontier = occupied & ~big & any_big
    i32 = jnp.int32
    return (jnp.max(counts), jnp.sum(occupied.astype(i32)),
            jnp.sum(big.astype(i32)), jnp.sum(frontier.astype(i32)))


@_host_probe
@partial(jax.jit, static_argnames=("levels", "ws", "c_small",
                                   "with_chunks"))
def tree_column_probe(
    pos: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    levels: int = 6,
    ws: int = 1,
    c_small: int = 32,
    box=None,
    with_chunks: bool = False,
):
    """Column-occupancy census for sizing the ``near="columns"`` sweep's
    static budgets: returns (max bodies per (x, y) COLUMN, occupied
    columns, BIG columns [> c_small bodies], FRONTIER columns [small
    with a big (2ws+1)^2 column neighbor]) — the sizers for ``capacity``
    / ``max_cells`` / ``max_big`` / ``max_frontier`` under the column
    near field, binned exactly like :func:`tree_acc_potential` (same box
    fit and dead-body handling). With ``with_chunks=True`` a fifth value
    is appended: the total 32-row i-chunk count over big columns
    (sum of ceil(count / c_small)) — the ``max_chunks`` sizer. One
    segment-sum over the M^2 column grid plus (2ws+1)^2 dense boolean
    shifts — no gathers."""
    n = pos.shape[0]
    M = 2 ** levels
    M2 = M * M
    pos32 = pos.astype(jnp.float32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.astype(jnp.float32),
                                      M, None)
    else:
        center = jnp.asarray(box[0], jnp.float32)
        half = jnp.asarray(box[1], jnp.float32)
    h = 2.0 * half / M
    cc = jnp.clip(jnp.floor((pos32 - (center - half)) / h).astype(jnp.int32),
                  0, M - 1)
    col_id = cc[:, 0] * M + cc[:, 1]
    col_id = jnp.where(alive_b, col_id, M2)
    counts = jax.ops.segment_sum(alive_b.astype(jnp.int32), col_id,
                                 num_segments=M2 + 1)[:M2]
    occupied = counts > 0
    big2 = (counts > c_small).reshape(M, M)
    p = jnp.pad(big2, ws)
    any_big = jnp.zeros_like(big2)
    for a in range(2 * ws + 1):
        for b in range(2 * ws + 1):
            any_big = any_big | lax.dynamic_slice(p, (a, b), (M, M))
    any_big = any_big.reshape(-1)
    big = counts > c_small
    frontier = occupied & ~big & any_big
    i32 = jnp.int32
    out = (jnp.max(counts), jnp.sum(occupied.astype(i32)),
           jnp.sum(big.astype(i32)), jnp.sum(frontier.astype(i32)))
    if with_chunks:
        nchunks = jnp.sum(jnp.where(big, -(-counts // c_small), 0))
        out = out + (nchunks.astype(i32),)
    return out


def _probe_sorted_cells(pos, alive, levels: int, box):
    """Shared probe preamble (pairs budget sizers): alive-masked
    finest-level binning with the dead-body sentinel sort — the SAME box
    fit and boundary clipping as the sweeps, so budget accounting cannot
    drift from the sweep's own geometry. Returns ``(sc, n, M)``."""
    n = pos.shape[0]
    M = 2 ** levels
    M3 = M * M * M
    pos32 = pos.astype(jnp.float32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.astype(jnp.float32),
                                      M, None)
    else:
        center = jnp.asarray(box[0], jnp.float32)
        half = jnp.asarray(box[1], jnp.float32)
    h = 2.0 * half / M
    cc = jnp.clip(jnp.floor((pos32 - (center - half)) / h).astype(jnp.int32),
                  0, M - 1)
    cell_id = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    return jnp.sort(jnp.where(alive_b, cell_id, M3)), n, M


@_host_probe
@partial(jax.jit, static_argnames=("levels", "ws", "chunk", "n_octaves"))
def tree_pairs_probe(
    pos: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    levels: int = 6,
    ws: int = 1,
    chunk: int = 32,
    n_octaves: int = 16,
    box=None,
) -> tuple[jax.Array, jax.Array]:
    """Chunk census for sizing the ``near="pairs"`` sweep's static
    budgets: returns (total chunk count, [n_octaves] per-octave i-chunk
    counts) — the ``max_chunks`` / ``pair_entries`` sizers. Shares
    :func:`_pairs_geometry` with the kernel (same box fit, dead-body
    handling, chunking, z-trimmed runs, and octave rule: a chunk sits in
    the smallest octave o with its trimmed (2ws+1)^2-neighborhood
    j-chunk total <= (2ws+1)^2 * 2**o), so budgets can never drift from
    the sweep's own accounting. Costs one argsort. Trim trailing zero
    octaves on the host before passing ``pair_entries``."""
    sc, n, M = _probe_sorted_cells(pos, alive, levels, box)
    C = int(chunk)
    K_safe = -(-n // C) + min(n, M * M)  # every column adds <= 1 partial
    g = _pairs_geometry(sc, n, M, ws, C, K_safe)
    base_w = (2 * ws + 1) ** 2
    oct_of = jnp.zeros((K_safe,), jnp.int32)
    for k in range(n_octaves):
        oct_of = oct_of + (g["S_ch"] > base_w * (1 << k)).astype(jnp.int32)
    # out-of-range octaves are DROPPED (segment_sum ignores them) — the
    # kernel drops such chunks too, so the budgets stay consistent
    per_oct = jax.ops.segment_sum(
        g["chunk_valid"].astype(jnp.int32), oct_of, num_segments=n_octaves)
    total = jnp.sum(g["chunk_valid"].astype(jnp.int32))
    return total, per_oct


def tree_pairs_budgets(
    pos,
    alive=None,
    *,
    levels: int,
    ws: int = 1,
    chunk: int = 32,
    box=None,
    headroom: float = 1.5,
) -> tuple[int, tuple]:
    """Host-side ``(max_chunks, pair_entries)`` sizing for
    ``near="pairs"``: one :func:`tree_pairs_probe` call, trailing zero
    octaves trimmed, ``headroom``-scaled and alignment-rounded. The ONE
    place the probe counts become static budgets — simulate(), bench,
    and the viewer service all call it, so the margin policy cannot
    drift between entry points."""
    total, per_oct = tree_pairs_probe(pos, alive, levels=levels, ws=ws,
                                      chunk=chunk, box=box)
    per = [int(v) for v in np.asarray(per_oct)]
    while per and per[-1] == 0:
        per.pop()
    entries = tuple(
        (max(32, -(-int(v * headroom) // 32) * 32) if v else 0)
        for v in per)
    max_chunks = max(256, -(-int(int(total) * headroom) // 256) * 256)
    return max_chunks, entries


@_host_probe
@partial(jax.jit, static_argnames=("levels",))
def tree_occupancy_probe(
    pos: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    levels: int = 6,
    box=None,
) -> tuple[jax.Array, jax.Array]:
    """(max bodies per finest cell, occupied finest-cell count) — the
    ``capacity`` / ``max_cells`` sizers, binned exactly like
    :func:`tree_acc_potential` (same box fit and dead-body handling), at
    the cost of one segment-sum."""
    n = pos.shape[0]
    M = 2 ** levels
    M3 = M * M * M
    f32 = jnp.float32
    pos32 = pos.astype(f32)
    alive_b = (jnp.ones((n,), bool) if alive is None else alive.astype(bool))
    if box is None:
        center, half = _bounding_cube(pos32, alive_b.astype(f32), M, None)
    else:
        center = jnp.asarray(box[0], f32)
        half = jnp.asarray(box[1], f32)
    h = 2.0 * half / M
    cc = jnp.clip(jnp.floor((pos32 - (center - half)) / h).astype(jnp.int32),
                  0, M - 1)
    cell_id = (cc[:, 0] * M + cc[:, 1]) * M + cc[:, 2]
    cell_id = jnp.where(alive_b, cell_id, M3)
    counts = jax.ops.segment_sum(alive_b.astype(jnp.int32), cell_id,
                                 num_segments=M3 + 1)[:M3]
    return jnp.max(counts), jnp.sum((counts > 0).astype(jnp.int32))
