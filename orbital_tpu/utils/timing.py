"""Chained-slope benchmarking harness.

A timed call pays dispatch and a device->host fetch besides its compute,
which swamps small kernels. The fix: chain iterations through a data
dependency inside one jitted ``fori_loop``, fetch a scalar once at the
end, time two different iteration counts, and report the *slope*
(d wall / d iters) — the dispatch and fetch constants cancel exactly.

Robustness (tiny workloads): when per-iteration compute is smaller than
timing noise the raw slope can come out ~0 or even negative. The estimator
therefore (a) uses the min over repeats at each trip count (min is the
standard robust wall-clock statistic — noise is strictly additive),
(b) grows the trip counts until the timing gap clears a noise floor, and
(c) falls back to direct per-iteration time (an upper bound, but always
positive) if the gap never clears. The result is guaranteed > 0.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["bench_chained"]

# Minimum believable wall-clock gap between the two trip counts: 20 ms of
# separation keeps host-clock jitter out of the slope.
_NOISE_FLOOR_S = 0.020
_MAX_GROWTH_ROUNDS = 6  # trip counts grow 4x per round: up to 4096x


def _run_and_sync(run, carry0, iters):
    t0 = time.perf_counter()
    carry = run(iters, carry0)
    leaves = jax.tree_util.tree_leaves(carry)
    jnp.sum(leaves[0]).item()  # real device->host sync
    return time.perf_counter() - t0


def bench_chained(
    step: Callable,
    carry0,
    iters: int = 10,
    repeats: int = 3,
    iters_hi: int | None = None,
) -> float:
    """Min-based robust seconds per iteration of ``carry = step(carry)``.

    ``step`` must be jit-compatible and return a pytree of the same
    structure as ``carry0``. The result is the slope between runs of
    ``iters`` and ``iters_hi`` (default 3x) iterations, cancelling the
    fetch round trip; trip counts auto-scale up until the wall-clock gap
    exceeds the noise floor. Always returns a value > 0.
    """
    if iters_hi is not None and iters_hi <= iters:
        raise ValueError(f"iters_hi={iters_hi} must exceed iters={iters}")
    iters_hi = iters_hi or 3 * iters
    repeats = max(2, repeats)

    @jax.jit
    def run(n, carry):
        # dynamic trip count: one compile covers every (iters, iters_hi)
        return jax.lax.fori_loop(0, n, lambda _, c: step(c), carry)

    # compile + device warm-up (first dispatch pays compilation)
    _run_and_sync(run, carry0, iters)

    # every repeat perturbs the trip count by +r, so no two timed calls
    # are identical, and the slope uses the exact trip counts of the
    # min-time samples
    def min_timed(base):
        samples = [(_run_and_sync(run, carry0, base + r), base + r)
                   for r in range(repeats)]
        return min(samples)

    t_hi_best = None
    for _ in range(_MAX_GROWTH_ROUNDS):
        t_lo, n_lo = min_timed(iters)
        t_hi, n_hi = min_timed(iters_hi)
        t_hi_best = (t_hi, n_hi)
        if t_hi - t_lo > _NOISE_FLOOR_S and n_hi > n_lo:
            return (t_hi - t_lo) / (n_hi - n_lo)
        # gap within noise: per-iteration compute is tiny — scale the work
        iters *= 4
        iters_hi *= 4

    # Noise never cleared even at the largest trip count (sub-microsecond
    # steps): report the direct per-iteration time of the longest run — an
    # upper bound (includes RTT/iters_hi), but strictly positive.
    t_hi, n_hi = t_hi_best
    return max(t_hi, 1e-9) / n_hi
