"""Shared SQP-iteration logic: the single source of truth for the barrier
schedule, Armijo noise floor, regularization ladder, and convergence
predicates used by every solver driver (sqp.py single-instance,
batched.py lanes-dynamics, fixed.py latency-shaped).

Keeping one copy stops the drivers' constants from drifting apart.  Every
function here is elementwise and shape-polymorphic: scalars for the
single-instance driver, (B,) arrays for the batched ones, so one definition
serves all.

The *drivers* stay separate on purpose — their tensor layouts (batch-first
vs lanes) and control-flow shapes (while_loop vs unrolled) are the whole
point of their existence — but every numerical policy lives here.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Array = jnp.ndarray

# Numerical policy constants (previously triplicated inline).
ARMIJO_SLOPE = 1e-4          # Armijo sufficient-decrease coefficient
NOISE_FLOOR_MULT = 10.0      # eps multiplier in the fp32 merit noise floor
REG_GROW = 10.0              # Levenberg ladder on line-search failure
REG_GROW_ABS = 1e-6
REG_SHRINK = 0.25
REG_MIN = 1e-8
REG_DIVERGED = 1e8           # reg at/above this => instance diverged
INNER_MU_MULT = 10.0         # inner-Newton resolution: step < 10*mu
FTB_TAU = 0.995              # fraction-to-boundary


def mu_floor(opts) -> Array:
    """Barrier stop tied to the KKT tolerance (the IPOPT coupling): the
    barrier solution differs from the NLP solution by O(mu), so mu never
    needs to go below 0.1*tol (clamped by the hard mu_min)."""
    return jnp.maximum(opts.mu_min, 0.1 * opts.tol)


def mu_start(has_bounds: Array, mu0: Array, floor: Array,
             mu_min_opt: float, dtype) -> Array:
    """Initial barrier value: requested mu0 clamped above the floor for
    bounded instances; unbounded instances sit at mu_min (barrier inert)."""
    return jnp.where(has_bounds,
                     jnp.maximum(jnp.asarray(mu0, dtype), floor),
                     jnp.asarray(mu_min_opt, dtype))


def armijo_eps(m0: Array, dtype) -> Array:
    """fp32 noise floor: near convergence the predicted decrease drops below
    merit roundoff (eps*|m0|), and the exact Armijo test becomes a coin flip
    that rejects good Newton steps (IPOPT's acceptable-point relaxation)."""
    return NOISE_FLOOR_MULT * jnp.finfo(dtype).eps * (1.0 + jnp.abs(m0))


def armijo_pass(m_new: Array, m0: Array, alpha: Array, ddir: Array,
                eps_m: Array) -> Array:
    return jnp.isfinite(m_new) & (
        m_new <= m0 + ARMIJO_SLOPE * alpha * ddir + eps_m)


def reg_update(reg: Array, no_move: Array) -> Array:
    """Levenberg ladder: grow on a failed line search, decay otherwise."""
    return jnp.where(no_move,
                     jnp.minimum(reg * REG_GROW + REG_GROW_ABS, REG_DIVERGED),
                     jnp.maximum(reg * REG_SHRINK, REG_MIN))


def mu_update(mu: Array, step_norm: Array, feas: Array, tol: Array,
              mu_min: Array, kappa_mu: float) -> Array:
    """Monotone Fiacco-McCormick: shrink mu once the inner Newton is past
    its mu-resolution."""
    inner_done = ((step_norm < jnp.maximum(INNER_MU_MULT * mu, tol))
                  & (feas < INNER_MU_MULT * tol))
    return jnp.where(inner_done, jnp.maximum(mu_min, kappa_mu * mu), mu)


def convergence(step_norm: Array, feas: Array, mu: Array, reg_new: Array,
                tol: Array, mu_min: Array) -> Tuple[Array, Array]:
    """(converged, diverged) predicates per instance."""
    converged = (step_norm < tol) & (feas < tol) & (mu <= 2.0 * mu_min)
    diverged = reg_new >= REG_DIVERGED
    return converged, diverged
