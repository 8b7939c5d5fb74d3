"""Double-single ("ds") compensated float32 arithmetic.

Accelerator compute is fastest in float32, but a leapfrog
integration accumulates millions of tiny position/velocity increments whose
round-off random-walks the energy. The classic fix (used by GPU N-body
codes) is to keep the *accumulated state* as an unevaluated sum of two
float32s ``hi + lo`` (~49 bits of effective mantissa) while computing the
*per-step increments* (forces) in plain f32:

    pos_new(hi, lo) = two_sum(pos_hi, dv) + pos_lo   (renormalized)

Forces see only ``hi`` — a force error is a bounded perturbation of the
Hamiltonian that leapfrog tolerates, whereas accumulation round-off is a
secular drift, which this eliminates.

The error-free transformations below (Knuth two-sum, Dekker fast-two-sum)
rely on IEEE round-to-nearest and on XLA *not* reassociating float ops —
which it does not do by default. All helpers are shape-polymorphic and jit/
vmap/shard_map-safe.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["two_sum", "fast_two_sum", "ds_add", "ds_add_ds", "ds_to_f32", "ds_from_f64"]


def two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b = s + err, assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def ds_add(hi, lo, x):
    """Add a plain float ``x`` to the double-single value (hi, lo).

    Returns a renormalized (hi, lo) pair. This is the integrator's
    workhorse: state += increment with O(eps^2) accumulated error.
    """
    s, e = two_sum(hi, x)
    e = e + lo
    return fast_two_sum(s, e)


def ds_add_ds(a_hi, a_lo, b_hi, b_lo):
    """Add two double-single values (renormalized)."""
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    return fast_two_sum(s, e)


def ds_to_f32(hi, lo):
    """Collapse to the nearest single float (hi already is, by invariant)."""
    return hi + lo


def ds_from_f64(x64):
    """Split a float64 array into a double-single float32 pair."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(x64.dtype)).astype(jnp.float32)
    return hi, lo
