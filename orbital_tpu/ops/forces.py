"""Softened O(N^2) pairwise gravity as dense XLA array ops.

This is the jnp reference implementation of the hot kernel (the reference's
scalar pair loop, core/physics.py:125-159, becomes a broadcasted matrix of
interactions): for every pair,

    a_i += G m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
    U   += -G m_i m_j / sqrt(|r_j - r_i|^2 + eps^2)   (each pair once)

Dead/padding bodies participate with mass 0, so they exert no force and
contribute no potential; their own acceleration rows are zeroed by the
alive mask. Everything here is jit/vmap/grad-safe with static shapes.

Three flavors:
  * :func:`pairwise_acc_dense`   — materializes [N, N] per-coordinate
    difference matrices; the path up to N = 4096 (``ops.backend``).
  * :func:`pairwise_acc_chunked` — `lax.map` over row-blocks; O(C*N)
    memory, any N that divides by the chunk; the CPU's large-N path.
  * ``orbital_tpu.ops.pallas_forces`` — the GPU kernel for large N (same
    contract, same math).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["pairwise_acc_dense", "pairwise_acc_chunked",
           "block_acc_dense", "block_acc_chunked", "soften_potential_pairs"]


def _masked_inverse_r(r2, mask, eps2):
    """1/sqrt(r2 + eps2) with masked entries (self-pairs, dead bodies)
    forced to exactly zero, avoiding inf/NaN when eps = 0."""
    r2s = r2 + eps2
    safe = r2s > 0.0
    inv_r = jnp.where(safe, lax.rsqrt(jnp.where(safe, r2s, 1.0)), 0.0)
    return jnp.where(mask, inv_r, 0.0)


def _block_acc_potential(pos_i, pos_j, mass_j, mask, eps2, G):
    """Accelerations on a row-block of bodies from a column-block.

    pos_i: [I, 3], pos_j: [J, 3], mass_j: [J], mask: [I, J] valid-pair mask.
    Returns (acc [I, 3], pe_row [I]) where pe_row_i = sum_j m_j * inv_r_ij
    (caller multiplies by -G m_i and halves for double counting).
    """
    # Per-coordinate difference matrices keep peak memory at 3 [I, J]
    # buffers (not one [I, J, 3]).
    dx = pos_j[None, :, 0] - pos_i[:, None, 0]
    dy = pos_j[None, :, 1] - pos_i[:, None, 1]
    dz = pos_j[None, :, 2] - pos_i[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz
    inv_r = _masked_inverse_r(r2, mask, eps2)
    inv_r3 = inv_r * inv_r * inv_r
    w = mass_j[None, :] * inv_r3  # [I, J]
    ax = jnp.sum(w * dx, axis=1)
    ay = jnp.sum(w * dy, axis=1)
    az = jnp.sum(w * dz, axis=1)
    pe_row = jnp.sum(mass_j[None, :] * inv_r, axis=1)
    return G * jnp.stack([ax, ay, az], axis=-1), pe_row


@partial(jax.jit, static_argnames=("G", "eps2"))
def pairwise_acc_dense(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[jax.Array, jax.Array]:
    """Dense softened pairwise accelerations and total potential.

    Args:
        pos: [N, 3] positions. mass: [N]. alive: optional [N] bool mask.
        G: gravitational constant (static). eps2: softening squared (static).

    Returns:
        acc [N, 3] and the scalar softened potential U (pairs counted once),
        matching the reference contract (core/physics.py:125-159).
    """
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)
    eye = jnp.eye(n, dtype=bool)
    mask = ~eye
    acc, pe_row = _block_acc_potential(pos, pos, mass_eff, mask, eps2, G)
    if alive is not None:
        acc = acc * alive[:, None].astype(acc.dtype)
    U = -0.5 * G * jnp.sum(mass_eff * pe_row)
    return acc, U


@partial(jax.jit, static_argnames=("G", "eps2", "chunk"))
def pairwise_acc_chunked(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Row-blocked pairwise accelerations: O(chunk * N) live memory.

    N must be divisible by ``chunk`` (pad the state; see
    ``engine.state.make_state(pad_to=...)``).
    """
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)

    col_ids = jnp.arange(n)

    def row_block(start):
        pos_i = lax.dynamic_slice_in_dim(pos, start, chunk, axis=0)
        row_ids = start + jnp.arange(chunk)
        mask = row_ids[:, None] != col_ids[None, :]
        return _block_acc_potential(pos_i, pos, mass_eff, mask, eps2, G)

    starts = jnp.arange(0, n, chunk)
    acc_blocks, pe_blocks = lax.map(row_block, starts)
    acc = acc_blocks.reshape(n, 3)
    pe_row = pe_blocks.reshape(n)
    if alive is not None:
        acc = acc * alive[:, None].astype(acc.dtype)
    U = -0.5 * G * jnp.sum(mass_eff * pe_row)
    return acc, U


def block_acc_dense(pos_i, pos_j, mass_j, *, G: float, eps2: float):
    """Mask-free partial forces of body block j on body block i (the
    ring's per-round block; self-pairs cancel through dx == 0 and, at
    eps2 == 0, through the r2 > 0 select). Returns (acc [I, 3], pe_row
    [I]) with pe_row_i = sum_j m_j / sqrt(r^2 + eps^2), including the
    i == j term when the blocks coincide."""
    dx = pos_j[None, :, 0] - pos_i[:, None, 0]
    dy = pos_j[None, :, 1] - pos_i[:, None, 1]
    dz = pos_j[None, :, 2] - pos_i[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz
    if eps2 > 0.0:
        inv_r = lax.rsqrt(r2 + eps2)
    else:
        safe = r2 > 0.0
        inv_r = jnp.where(safe, lax.rsqrt(jnp.where(safe, r2, 1.0)), 0.0)
    inv_r3 = inv_r * inv_r * inv_r
    w = mass_j[None, :] * inv_r3
    acc = G * jnp.stack(
        [jnp.sum(w * dx, axis=1), jnp.sum(w * dy, axis=1),
         jnp.sum(w * dz, axis=1)], axis=-1)
    pe_row = jnp.sum(mass_j[None, :] * inv_r, axis=1)
    return acc, pe_row


def block_acc_chunked(pos_i, pos_j, mass_j, *, G: float, eps2: float,
                      chunk: int = 1024):
    """:func:`block_acc_dense` over row-blocks of ``pos_i``: O(chunk * J)
    live memory instead of the dense [I, J] temporaries. The row count
    must divide by ``chunk``."""
    n_i = pos_i.shape[0]
    if n_i % chunk != 0:
        raise ValueError(f"block of {n_i} rows must be a multiple of "
                         f"chunk={chunk}")

    def row_block(start):
        p = lax.dynamic_slice_in_dim(pos_i, start, chunk, axis=0)
        return block_acc_dense(p, pos_j, mass_j, G=G, eps2=eps2)

    acc, pe = lax.map(row_block, jnp.arange(0, n_i, chunk))
    return acc.reshape(n_i, 3), pe.reshape(n_i)


def soften_potential_pairs(pos, mass, *, G, eps2):
    """Total softened potential only (diagnostics helper)."""
    _, U = pairwise_acc_dense(pos, mass, G=G, eps2=eps2)
    return U


def _block_accel_jerk(pos_i, vel_i, pos_j, vel_j, mass_j, mask, eps2, G):
    """Acc + jerk of a column-block on a row-block (shared by the dense and
    chunked paths). Returns (acc [I,3], jerk [I,3], pe_row [I])."""
    dx = pos_j[None, :, 0] - pos_i[:, None, 0]
    dy = pos_j[None, :, 1] - pos_i[:, None, 1]
    dz = pos_j[None, :, 2] - pos_i[:, None, 2]
    dvx = vel_j[None, :, 0] - vel_i[:, None, 0]
    dvy = vel_j[None, :, 1] - vel_i[:, None, 1]
    dvz = vel_j[None, :, 2] - vel_i[:, None, 2]

    r2 = dx * dx + dy * dy + dz * dz
    inv_r = _masked_inverse_r(r2, mask, eps2)
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    w = mass_j[None, :] * inv_r3                         # m_j / s^3
    rv = dx * dvx + dy * dvy + dz * dvz                  # r_ij . v_ij
    c = 3.0 * rv * inv_r2                                # 3 (r.v) / s^2

    acc = G * jnp.stack(
        [jnp.sum(w * dx, 1), jnp.sum(w * dy, 1), jnp.sum(w * dz, 1)], axis=-1)
    jerk = G * jnp.stack(
        [jnp.sum(w * (dvx - c * dx), 1),
         jnp.sum(w * (dvy - c * dy), 1),
         jnp.sum(w * (dvz - c * dz), 1)], axis=-1)
    pe_row = jnp.sum(mass_j[None, :] * inv_r, axis=1)
    return acc, jerk, pe_row


@partial(jax.jit, static_argnames=("G", "eps2"))
def accel_jerk_dense(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Softened accelerations AND jerks (da/dt) for Hermite integration.

    jerk_i = G sum_j m_j [ v_ij / s^3 - 3 (r_ij . v_ij) r_ij / s^5 ],
    with s^2 = |r_ij|^2 + eps^2, r_ij = r_j - r_i, v_ij = v_j - v_i.
    Returns (acc [N,3], jerk [N,3], U).
    """
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)
    mask = ~jnp.eye(n, dtype=bool)
    acc, jerk, pe_row = _block_accel_jerk(pos, vel, pos, vel, mass_eff,
                                          mask, eps2, G)
    U = -0.5 * G * jnp.sum(mass_eff * pe_row)
    if alive is not None:
        keep = alive[:, None].astype(acc.dtype)
        acc = acc * keep
        jerk = jerk * keep
    return acc, jerk, U


@partial(jax.jit, static_argnames=("G", "eps2", "chunk"))
def accel_jerk_chunked(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 1024,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-blocked acc + jerk: O(chunk * N) live memory, lifting the dense
    path's N ~ 8k ceiling so Hermite runs at the flagship N. N must divide by ``chunk``."""
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)
    col_ids = jnp.arange(n)

    def row_block(start):
        pos_i = lax.dynamic_slice_in_dim(pos, start, chunk, axis=0)
        vel_i = lax.dynamic_slice_in_dim(vel, start, chunk, axis=0)
        mask = (start + jnp.arange(chunk))[:, None] != col_ids[None, :]
        return _block_accel_jerk(pos_i, vel_i, pos, vel, mass_eff,
                                 mask, eps2, G)

    acc_b, jerk_b, pe_b = lax.map(row_block, jnp.arange(0, n, chunk))
    acc = acc_b.reshape(n, 3)
    jerk = jerk_b.reshape(n, 3)
    pe_row = pe_b.reshape(n)
    U = -0.5 * G * jnp.sum(mass_eff * pe_row)
    if alive is not None:
        keep = alive[:, None].astype(acc.dtype)
        acc = acc * keep
        jerk = jerk * keep
    return acc, jerk, U


@partial(jax.jit, static_argnames=("G", "eps2", "chunk"))
def accel_jerk_subset(
    idx_i: jax.Array,
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Acc + jerk ON the ``idx_i`` rows from ALL bodies (the block-timestep
    Hermite inner evaluation: F fast targets x N sources). Self-pairs are
    excluded by global index. ``chunk > 0`` streams sources in column
    blocks (live memory O(F * chunk)); N must then divide by ``chunk``.
    Returns (acc [F, 3], jerk [F, 3])."""
    n = pos.shape[0]
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)
    pos_i = pos[idx_i]
    vel_i = vel[idx_i]
    if chunk <= 0:
        mask = idx_i[:, None] != jnp.arange(n)[None, :]
        acc, jerk, _ = _block_accel_jerk(pos_i, vel_i, pos, vel, mass_eff,
                                         mask, eps2, G)
        return acc, jerk
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")

    def col_block(start):
        pj = lax.dynamic_slice_in_dim(pos, start, chunk, axis=0)
        vj = lax.dynamic_slice_in_dim(vel, start, chunk, axis=0)
        mj = lax.dynamic_slice_in_dim(mass_eff, start, chunk, axis=0)
        mask = idx_i[:, None] != (start + jnp.arange(chunk))[None, :]
        a, j, _ = _block_accel_jerk(pos_i, vel_i, pj, vj, mj, mask, eps2, G)
        return a, j

    accs, jerks = lax.map(col_block, jnp.arange(0, n, chunk))
    return accs.sum(0), jerks.sum(0)
