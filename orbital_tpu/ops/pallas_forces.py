"""Exact O(N^2) softened pair sweep as a Pallas kernel on the Triton route.

The reference's per-pair Python loop (core/physics.py:125-159) becomes the
classic GPU N-body kernel (Nyland, Harris & Prins, GPU Gems 3 ch. 31;
arXiv:0706.3060): one program per i-block of ``TI`` bodies keeps its
bodies in registers and loops over the whole system in j-tiles of ``TJ``,
accumulating

    acc_i  += G * sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
    pe_i   += sum_j m_j / sqrt(|r_j - r_i|^2 + eps^2)              (pe)
    jerk_i += G * sum_j m_j [v_ij / s^3 - 3 (r_ij . v_ij) r_ij / s^5] (jerk)
    cnt_i  += #{j : |r_j - r_i| <= (R_i + R_j)(1 + 1e-5)}           (detect)

in [TI, TJ] register tiles that are reduced once, after the j loop. Nothing
of the sum leaves the program until its single store, so the sweep is
bound by arithmetic (about 20 flops and one ``rsqrt`` per pair), not by
memory. The force, potential, Hermite jerk, contact-count and ring-block
variants are one kernel body selected by static flags.

Layout: structure of arrays. Bodies travel as rows of a [K, N_pad] float32
array (x, y, z, m, then vx, vy, vz for jerk, then R for detect), so every
load is one contiguous power-of-two vector. The wrappers pad N up to a
multiple of the tiles with massless bodies parked far outside the system,
so any N is accepted.

Masking strategy:
  * eps2 > 0 (every practical config): self-pairs have dx=dy=dz=0 so their
    acceleration (and jerk) contribution is exactly zero with no mask, and
    the softened inverse radius stays finite. The self-term does enter the
    potential (m_i/eps per body), so the wrappers subtract it analytically.
  * eps2 == 0: a single ``r2 > 0`` select removes self-pairs and exact
    coincidences.
  * dead and padding bodies carry mass 0: no force, no potential.

The kernel is compiled for the GPU. ``interpret=True`` runs the same body
in the Pallas interpreter on the CPU; only tests pass it (see
``ops.backend``).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import backend

__all__ = ["pairwise_acc_pallas", "pairwise_acc_detect_pallas",
           "accel_jerk_pallas", "accel_jerk_detect_pallas",
           "block_acc_pallas", "pick_tiles", "DEFAULT_TILES"]

# (TI, TJ, num_warps) by variant, chosen on the card (PERF.md, "Where the
# time goes"). TI shrinks at small N so that there are enough programs to
# fill the card's SMs.
DEFAULT_TILES = {"acc": (32, 32, 4), "jerk": (32, 16, 4)}
_MIN_PROGRAMS = 264  # two waves over an H100's 132 SMs
_DETECT_INFLATE = 1.00001

# output rows of the kernel
_AX, _AY, _AZ, _PE, _JX, _JY, _JZ, _CNT = range(8)


def _sweep_kernel(pi_ref, pj_ref, out_ref, *, ti: int, tj: int, n_j: int,
                  G: float, eps2: float, pe: bool, jerk: bool, detect: bool):
    """One i-block of TI bodies against all n_j j-bodies."""
    i0 = pl.multiple_of(pl.program_id(0) * ti, ti)

    def row_i(r):
        return pi_ref[r, pl.ds(i0, ti)][:, None]          # [TI, 1]

    xi, yi, zi = row_i(0), row_i(1), row_i(2)
    if jerk:
        vxi, vyi, vzi = row_i(4), row_i(5), row_i(6)
    if detect:
        ri = row_i(7 if jerk else 4)

    n_acc = 3 + int(pe) + 3 * int(jerk) + int(detect)

    def body(t, accs):
        j0 = pl.multiple_of(t * tj, tj)

        def row_j(r):
            return pj_ref[r, pl.ds(j0, tj)][None, :]      # [1, TJ]

        dx = row_j(0) - xi                                # [TI, TJ]
        dy = row_j(1) - yi
        dz = row_j(2) - zi
        mj = row_j(3)
        r2 = dx * dx + dy * dy + dz * dz
        if eps2 > 0.0:
            inv = lax.rsqrt(r2 + eps2)
        else:
            safe = r2 > 0.0
            inv = jnp.where(safe, lax.rsqrt(jnp.where(safe, r2, 1.0)), 0.0)
        inv2 = inv * inv
        w = mj * (inv2 * inv)                             # m_j / s^3
        terms = [w * dx, w * dy, w * dz]
        if pe:
            terms.append(mj * inv)
        if jerk:
            dvx = row_j(4) - vxi
            dvy = row_j(5) - vyi
            dvz = row_j(6) - vzi
            c = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv2
            terms += [w * (dvx - c * dx), w * (dvy - c * dy),
                      w * (dvz - c * dz)]
        if detect:
            # unsoftened r2: every self-pair counts once (r2 = 0), an exact
            # excess of N that the wrapper removes; the inflation keeps the
            # gate conservative against the resolution sweeps' own test
            rsum = (ri + row_j(7 if jerk else 4)) * _DETECT_INFLATE
            terms.append(jnp.where(r2 <= rsum * rsum, 1.0, 0.0))
        return tuple(a + t_ for a, t_ in zip(accs, terms))

    zero = jnp.zeros((ti, tj), jnp.float32)
    accs = lax.fori_loop(0, n_j // tj, body, (zero,) * n_acc)
    sums = [jnp.sum(a, axis=1) for a in accs]
    k = 0
    for row in (_AX, _AY, _AZ):
        out_ref[row, :] = G * sums[k]
        k += 1
    if pe:
        out_ref[_PE, :] = sums[k]
        k += 1
    if jerk:
        for row in (_JX, _JY, _JZ):
            out_ref[row, :] = G * sums[k]
            k += 1
    if detect:
        out_ref[_CNT, :] = sums[k]


@functools.lru_cache(maxsize=None)
def _build_call(n_i: int, n_j: int, k_i: int, k_j: int, ti: int, tj: int,
                warps: int, G: float, eps2: float, pe: bool, jerk: bool,
                detect: bool, interpret: bool, vma: frozenset = frozenset()):
    """``vma`` names the shard_map mesh axes the output varies over (the
    ring block runs inside shard_map)."""
    kernel = functools.partial(_sweep_kernel, ti=ti, tj=tj, n_j=n_j, G=G,
                               eps2=eps2, pe=pe, jerk=jerk, detect=detect)
    flops_per_pair = 20 + 2 * pe + 20 * jerk + 4 * detect
    return pl.pallas_call(
        kernel,
        grid=(n_i // ti,),
        in_specs=[pl.BlockSpec((k_i, n_i), lambda i: (0, 0)),
                  pl.BlockSpec((k_j, n_j), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, ti), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((8, n_i), jnp.float32, vma=vma),
        compiler_params=pltriton.CompilerParams(num_warps=warps,
                                                num_stages=1),
        cost_estimate=pl.CostEstimate(
            flops=flops_per_pair * n_i * n_j,
            bytes_accessed=4 * (k_i * n_i + k_j * n_j + 8 * n_i),
            transcendentals=n_i * n_j),
        interpret=interpret,
        name="pair_sweep" + "_pe" * pe + "_jerk" * jerk + "_detect" * detect,
    )


def pick_tiles(n: int, variant: str = "acc") -> tuple[int, int, int]:
    """(TI, TJ, num_warps) for an N-body sweep: the variant's tuned tiles,
    with TI halved (down to 16) until N/TI gives at least two programs per
    SM, so small systems still fill the card."""
    ti, tj, warps = DEFAULT_TILES[variant]
    while ti > 16 and -(-n // ti) < _MIN_PROGRAMS:
        ti //= 2
    return ti, tj, warps


def _padded(n: int, ti: int, tj: int) -> int:
    step = max(ti, tj)
    return -(-n // step) * step


def _far_point(pos32: jax.Array, radius32: Optional[jax.Array]) -> jax.Array:
    """A point farther from every body than any contact radius reaches:
    padding bodies sit there, massless and radius 0, so they exert nothing
    and touch nothing."""
    reach = jnp.max(jnp.abs(pos32))
    if radius32 is not None:
        reach = reach + 2.0 * jnp.max(radius32)
    return 4.0 * reach + 1.0


def _pack(rows: list, n_pad: int, far) -> jax.Array:
    """Stack [N] rows into [K, n_pad]; positions (rows 0-2) pad at ``far``,
    everything else at 0."""
    n = rows[0].shape[0]
    packed = jnp.stack(rows).astype(jnp.float32)
    if n_pad == n:
        return packed
    fill = jnp.zeros((len(rows), n_pad - n), jnp.float32)
    fill = fill.at[0:3].set(far)
    return jnp.concatenate([packed, fill], axis=1)


def _potential(pe_row, mass32, G: float, eps2: float):
    if eps2 > 0.0:
        # remove the analytic self-term m_i/eps of the mask-free sweep
        pe_row = pe_row - mass32 * (1.0 / float(eps2) ** 0.5)
    return -0.5 * G * jnp.sum(mass32 * pe_row)


def _sweep(pos, mass, *, G, eps2, pe, vel=None, radius=None,
           interpret=False):
    """Square sweep of all bodies on all bodies; returns the [8, N] output
    rows (padding stripped)."""
    backend.check_kernel_platform(interpret)
    jerk = vel is not None
    detect = radius is not None
    n = pos.shape[0]
    ti, tj, warps = pick_tiles(n, "jerk" if jerk else "acc")
    n_pad = _padded(n, ti, tj)
    pos32 = pos.astype(jnp.float32)
    radius32 = None if radius is None else radius.astype(jnp.float32)
    rows = [pos32[:, 0], pos32[:, 1], pos32[:, 2], mass.astype(jnp.float32)]
    if jerk:
        vel32 = vel.astype(jnp.float32)
        rows += [vel32[:, 0], vel32[:, 1], vel32[:, 2]]
    if detect:
        rows.append(radius32)
    pts = _pack(rows, n_pad, _far_point(pos32, radius32))
    k = len(rows)
    out = _build_call(n_pad, n_pad, k, k, ti, tj, warps, float(G),
                      float(eps2), pe, jerk, detect, interpret)(pts, pts)
    return out[:, :n]


@functools.partial(jax.jit,
                   static_argnames=("G", "eps2", "with_potential",
                                    "interpret"))
def pairwise_acc_pallas(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Softened pairwise accelerations + total potential.

    Same contract as ``forces.pairwise_acc_dense``: (acc [N, 3], scalar U),
    dead bodies inert, float32 arithmetic. With ``with_potential=False``
    the PE sum is skipped in-kernel and U returns as 0.
    """
    mass32 = (mass if alive is None
              else mass * alive.astype(mass.dtype)).astype(jnp.float32)
    out = _sweep(pos, mass32, G=G, eps2=eps2, pe=with_potential,
                 interpret=interpret)
    acc = out[_AX:_AZ + 1].T
    if alive is not None:
        acc = acc * alive[:, None].astype(acc.dtype)
    U = (_potential(out[_PE], mass32, G, eps2) if with_potential
         else jnp.zeros((), jnp.float32))
    return acc.astype(pos.dtype), U.astype(pos.dtype)


@functools.partial(jax.jit,
                   static_argnames=("G", "eps2", "with_potential",
                                    "interpret"))
def pairwise_acc_detect_pallas(
    pos: jax.Array,
    mass: jax.Array,
    radius: jax.Array,
    alive: jax.Array,
    *,
    G: float,
    eps2: float,
    with_potential: bool = True,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Force sweep with contact detection fused into the same r^2 tiles.

    Returns (acc [N,3], U, contacts) where ``contacts`` is an int32 count
    of directed touching pairs (``|r_ij| <= R_i + R_j``, unsoftened, dead
    pairs excluded): 0 exactly when no live bodies overlap, so the stepper
    can ``lax.cond``-skip the collision resolution sweep.

    Requirement: dead bodies must sit at spread-out far positions
    (``make_state`` padding and ``merge_groups`` do this), so the only
    detection excess is the exact +N of the self-pairs, removed here.
    Coincident live point bodies (r = 0, radius 0) still count, a cost-only
    false positive: the resolution sweep treats them as non-touching.
    """
    alive_f = alive.astype(jnp.float32)
    mass32 = (mass * alive.astype(mass.dtype)).astype(jnp.float32)
    out = _sweep(pos, mass32, G=G, eps2=eps2, pe=with_potential,
                 radius=radius.astype(jnp.float32) * alive_f,
                 interpret=interpret)
    acc = out[_AX:_AZ + 1].T * alive_f[:, None]
    U = (_potential(out[_PE], mass32, G, eps2) if with_potential
         else jnp.zeros((), jnp.float32))
    contacts = (jnp.sum(out[_CNT].astype(jnp.int32), dtype=jnp.int32)
                - pos.shape[0])
    return acc.astype(pos.dtype), U.astype(pos.dtype), contacts


@functools.partial(jax.jit, static_argnames=("G", "eps2", "interpret"))
def accel_jerk_pallas(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Acc + jerk + potential for Hermite; same contract as
    ``forces.accel_jerk_dense``."""
    mass32 = (mass if alive is None
              else mass * alive.astype(mass.dtype)).astype(jnp.float32)
    out = _sweep(pos, mass32, G=G, eps2=eps2, pe=True, vel=vel,
                 interpret=interpret)
    acc = out[_AX:_AZ + 1].T
    jerk = out[_JX:_JZ + 1].T
    if alive is not None:
        keep = alive[:, None].astype(acc.dtype)
        acc = acc * keep
        jerk = jerk * keep
    U = _potential(out[_PE], mass32, G, eps2)
    return (acc.astype(pos.dtype), jerk.astype(pos.dtype),
            U.astype(pos.dtype))


@functools.partial(jax.jit, static_argnames=("G", "eps2", "interpret"))
def accel_jerk_detect_pallas(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    radius: jax.Array,
    alive: jax.Array,
    *,
    G: float,
    eps2: float,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Acc + jerk + potential + fused contact count.

    Hermite evaluates forces at predicted positions, so the gate tests
    predicted separations; a contact that only forms in the
    predictor-corrector gap is caught on the next step, and the resolution
    sweep itself always uses the corrected positions. Requires dead bodies
    parked at spread far positions, as :func:`pairwise_acc_detect_pallas`.
    """
    alive_f = alive.astype(jnp.float32)
    mass32 = (mass * alive.astype(mass.dtype)).astype(jnp.float32)
    out = _sweep(pos, mass32, G=G, eps2=eps2, pe=True, vel=vel,
                 radius=radius.astype(jnp.float32) * alive_f,
                 interpret=interpret)
    keep = alive_f[:, None]
    acc = out[_AX:_AZ + 1].T * keep
    jerk = out[_JX:_JZ + 1].T * keep
    U = _potential(out[_PE], mass32, G, eps2)
    contacts = (jnp.sum(out[_CNT].astype(jnp.int32), dtype=jnp.int32)
                - pos.shape[0])
    return (acc.astype(pos.dtype), jerk.astype(pos.dtype),
            U.astype(pos.dtype), contacts)


@functools.partial(jax.jit,
                   static_argnames=("G", "eps2", "vma", "interpret"))
def block_acc_pallas(
    pos_i: jax.Array,
    pos_j: jax.Array,
    mass_j: jax.Array,
    *,
    G: float,
    eps2: float,
    vma: tuple = (),
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Partial forces of body block j on body block i: the per-round
    compute of the shard_map ppermute ring (``parallel/sharded.py``).

    Mask-free: requires eps2 > 0 (self-pairs in the diagonal round cancel
    through dd == 0; the ring wrapper strips the analytic PE self-term
    once). Dead bodies carry mass 0. Returns (acc [Bi, 3], pe_row [Bi])
    with pe_row_i = sum_j m_j / sqrt(r^2 + eps^2) including the i == j
    term when the blocks coincide.
    """
    backend.check_kernel_platform(interpret)
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    ti, tj, warps = pick_tiles(n_i, "acc")
    ni_pad, nj_pad = _padded(n_i, ti, tj), _padded(n_j, ti, tj)
    pi32 = pos_i.astype(jnp.float32)
    pj32 = pos_j.astype(jnp.float32)
    far = jnp.maximum(_far_point(pi32, None), _far_point(pj32, None))
    pts_i = _pack([pi32[:, 0], pi32[:, 1], pi32[:, 2],
                   jnp.zeros((n_i,), jnp.float32)], ni_pad, far)
    pts_j = _pack([pj32[:, 0], pj32[:, 1], pj32[:, 2],
                   mass_j.astype(jnp.float32)], nj_pad, far)
    out = _build_call(ni_pad, nj_pad, 4, 4, ti, tj, warps, float(G),
                      float(eps2), True, False, False, interpret,
                      frozenset(vma))(pts_i, pts_j)
    acc = out[_AX:_AZ + 1, :n_i].T
    return acc.astype(pos_i.dtype), out[_PE, :n_i].astype(pos_i.dtype)
