"""Matrix-unit formulation of pairwise gravity: the Gram-matrix variant.

The O(N^2) force sweep (reference hot loop: core/physics.py:125-159)
written as matrix contractions:

    r2_ij = |r_i|^2 + |r_j|^2 - 2 (pos @ pos^T)_ij        [Gram matmul]
    W_ij  = m_j (r2_ij + eps^2)^(-3/2)                     [elementwise]
    acc   = G (W @ [pos, 1] -> (S, row))                   [matmul]
          = G (S - pos * row)

leaving only the reciprocal-sqrt chain elementwise. Implemented
row-blocked (lax.map over [C, N] panels) so it runs at any N. The
contraction depths are 3 (Gram) and 4 (accumulation), far below what a
matrix unit needs to run near its rate; on the GPU the contractions must
also stay out of TF32 (see below), so this path is a correctness-checked
alternative formulation, not the fast one (ROADMAP C2 decides its fate).

Numerics: the Gram identity cancels catastrophically for close pairs
(|r_i|^2 + |r_j|^2 - 2 r_i.r_j loses ~log2(|r|^2/r2) bits), so r2 is
clamped at >= 0 before softening; with natural-unit scenes (positions
O(1)) and typical eps2 >= 1e-6 the acc error stays ~1e-4 relative —
NOT production-grade. Self-pairs are removed exactly by a diagonal mask
on W.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["pairwise_acc_mxu"]


@partial(jax.jit, static_argnames=("G", "eps2", "chunk", "with_potential"))
def pairwise_acc_mxu(
    pos: jax.Array,
    mass: jax.Array,
    alive: Optional[jax.Array] = None,
    *,
    G: float,
    eps2: float,
    chunk: int = 2048,
    with_potential: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Gram/accumulation-matmul force evaluation; same contract as
    ``forces.pairwise_acc_dense``. Requires eps2 > 0 and N % chunk == 0."""
    if eps2 <= 0.0:
        raise ValueError("the Gram formulation requires eps2 > 0")
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} must be a multiple of chunk={chunk}")

    pos32 = pos.astype(jnp.float32)
    mass_eff = mass if alive is None else mass * alive.astype(mass.dtype)
    mass32 = mass_eff.astype(jnp.float32)

    sq = jnp.sum(pos32 * pos32, axis=-1)                       # [N]
    posT = pos32.T                                             # [3, N]
    # accumulation RHS: [N, 4] = (x, y, z, 1) -> W @ rhs yields the weighted
    # position sums AND the row sum in one contraction
    rhs = jnp.concatenate([pos32, jnp.ones((n, 1), jnp.float32)], axis=1)
    col_ids = jnp.arange(n)

    def row_block(start):
        pos_i = lax.dynamic_slice_in_dim(pos32, start, chunk, axis=0)
        sq_i = lax.dynamic_slice_in_dim(sq, start, chunk, axis=0)
        row_ids = start + jnp.arange(chunk)
        # HIGHEST is load-bearing: a default float32 matmul may run in
        # TF32 or bf16 inputs, which destroys the Gram cancellation
        gram = jnp.dot(pos_i, posT, preferred_element_type=jnp.float32,
                       precision=lax.Precision.HIGHEST)
        r2 = jnp.maximum(sq_i[:, None] + sq[None, :] - 2.0 * gram, 0.0)
        inv = lax.rsqrt(r2 + eps2)
        w = mass32[None, :] * (inv * inv * inv)                # [C, N]
        w = jnp.where(row_ids[:, None] == col_ids[None, :], 0.0, w)
        out = jnp.dot(w, rhs, preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST)  # [C, 4]
        acc_i = G * (out[:, 0:3] - pos_i * out[:, 3:4])
        if with_potential:
            pe_i = jnp.sum(mass32[None, :] * jnp.where(
                row_ids[:, None] == col_ids[None, :], 0.0, inv), axis=1)
        else:
            pe_i = jnp.zeros((chunk,), jnp.float32)
        return acc_i, pe_i

    acc_b, pe_b = lax.map(row_block, jnp.arange(0, n, chunk))
    acc = acc_b.reshape(n, 3)
    pe_row = pe_b.reshape(n)
    if alive is not None:
        acc = acc * alive[:, None].astype(acc.dtype)
    U = (-0.5 * G * jnp.sum(mass32 * pe_row) if with_potential
         else jnp.zeros((), jnp.float32))
    return acc.astype(pos.dtype), U.astype(pos.dtype)
