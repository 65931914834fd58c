"""Batched scenario MPC service (BASELINE.json config #5).

The reference serves exactly one MPC instance per process; the batched
deployment shape is one *service* owning thousands of instances — randomized
initial states, goals, weights — advanced together on a device mesh.  Each
`step()` is one warm-started batched solve: per-instance references and
measured states in, per-instance first controls out, warm-start buffers and
the barrier schedule staying resident on device (donated) between steps.

Instances carry independent status; a failed instance keeps serving its
previous plan (SURVEY.md §5 failure detection) and re-solves next step.
Checkpoint/resume: `state_dict`/`load_state` snapshot the (params, plan)
pair, the framework analog of the reference's JSON + warm-start persistence.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..params import ModelParameters, SolverOptions
from ..models.base import Dynamics, make_dynamics
from ..ops.precision import highest_precision
from ..parallel.mesh import batch_spec, make_mesh, shard_params
from ..solver.sqp import DIVERGED, solve
from ..transcribe.shooting import MPCParams, default_params, make_problem


class BatchModelControl:
    """Receding-horizon MPC for a batch of B instances of one model."""

    def __init__(self, params: ModelParameters, batch: int,
                 dynamics: Optional[Dynamics] = None,
                 opts: SolverOptions = SolverOptions(),
                 mesh=None, Q=None, R=None, Rm=None):
        if dynamics is None:
            dynamics = make_dynamics(params.dynamics_name,
                                     **params.dynamics_kwargs)
        self.params = params
        self.dynamics = dynamics
        self.opts = opts
        self.batch = batch
        self.problem = make_problem(params, dynamics)
        self.mesh = mesh if mesh is not None else make_mesh(
            n_batch=min(batch, len(jax.devices())))
        nx, nu, N = params.num_x, params.num_u, params.num_shooting_nodes
        dtype = jnp.dtype(opts.dtype)
        self._dtype = dtype

        p = default_params(params, dtype=dtype)
        if Q is not None:
            p = p._replace(q=jnp.asarray(Q, dtype))
        if R is not None:
            p = p._replace(r=jnp.asarray(R, dtype))
        if Rm is not None:
            p = p._replace(rm=jnp.asarray(Rm, dtype))
        self._p = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (batch,) + a.shape).copy(), p)
        self._p = shard_params(self._p, self.mesh)

        self._spec = batch_spec(self.mesh)
        self._X = self._place(jnp.zeros((batch, N + 1, nx), dtype))
        self._U = self._place(jnp.zeros((batch, N, nu), dtype))

        prob = self.problem
        self._mu_cold = jnp.asarray(opts.mu_init, dtype)
        self._mu_warm = jnp.asarray(
            max(opts.warm_mu_factor * opts.tol, opts.mu_min), dtype)
        self._warm = False

        use_lanes = params.is_linear or dynamics.supports_lanes

        def step_fn(p_b: MPCParams, X, U, mu0):
            if use_lanes:
                from ..solver.batched import solve_batch_lanes
                res = solve_batch_lanes(prob, p_b, X, U, opts, mu0=mu0)
            else:
                res = jax.vmap(lambda pp, xx, uu: solve(
                    prob, pp, xx, uu, opts, mu0=mu0))(p_b, X, U)
            # Failed instances keep serving their previous plan's first
            # control (zero here) and re-solve from a zero warm start.
            ok = ((res.status != DIVERGED)
                  & jnp.all(jnp.isfinite(res.X), axis=(1, 2))
                  & jnp.all(jnp.isfinite(res.U), axis=(1, 2)))
            X = jnp.where(ok[:, None, None], res.X, 0.0)
            U = jnp.where(ok[:, None, None], res.U, 0.0)
            return res, X, U, jnp.where(ok[:, None], res.U[:, 0], 0.0)

        # Every step, cold or warm, runs this one program (mu0 decides): the
        # fleet has no straight-line warm program.
        from ..solver.select import resolve_warm_solver
        if resolve_warm_solver(opts) != "adaptive":
            raise ValueError(
                f"BatchModelControl serves the adaptive program only; "
                f"warm_solver={opts.warm_solver!r} with fixed_warm_iters="
                f"{opts.fixed_warm_iters} asks for the fixed one (a "
                f"ModelControl option)")
        self.warm_solver = "adaptive"
        # The new warm starts come back batch-sharded like the inputs, so
        # every step sees the same input shardings (one program, no
        # retrace); the old ones are donated.
        self._step = jax.jit(step_fn, donate_argnums=(1, 2),
                             out_shardings=(None, self._spec, self._spec,
                                            self._spec))
        # LTV relinearization: one jitted program per step, at full float32
        # matmul precision like the solve.
        self._relin = jax.jit(highest_precision(
            jax.vmap(dynamics.linearize))) if params.is_linear else None
        self.last = None          # last SolveResult
        self.solve_time_s = 0.0

    def _place(self, a) -> jax.Array:
        """Every per-instance input is batch-sharded over the mesh, like the
        warm-start buffers: no array lands on one device alone, and every
        step sees the same input shardings (no recompiles)."""
        return jax.device_put(jnp.asarray(a, self._dtype), self._spec)

    # -- per-instance mutation (vectorized set_state / update_weights) -------

    def set_states(self, x0: np.ndarray, u_prev: Optional[np.ndarray] = None):
        """Measured states for all instances: (B, nx)."""
        self._p = self._p._replace(x0=self._place(x0))
        if u_prev is not None:
            self._p = self._p._replace(u_prev=self._place(u_prev))

    def set_references(self, x_des: np.ndarray):
        """Per-instance reference trajectories: (B, N, nx)."""
        self._p = self._p._replace(x_des=self._place(x_des))

    def relinearize(self):
        """LTV mode (C8): refreeze each instance's (A, B, x_dot0) at its
        current measured state — the batched analog of the reference's
        per-cycle ``get_A/get_B/get_x_dot`` evaluation
        (``ModelControl.cpp:125-135``).  No-op for nonlinear models."""
        if not self.params.is_linear:
            return
        from ..transcribe.shooting import LinPoint
        p = self._p
        A, B, xd0 = self._relin(p.x0, p.u_prev)
        self._p = p._replace(lin=LinPoint(A, B, xd0, p.x0, p.u_prev))

    def update_weights(self, Q=None, R=None, Rm=None):
        """Per-instance (B, nx)/(B, nu) or broadcastable weight updates."""
        p = self._p
        B = self.batch
        cast = lambda v, n: self._place(jnp.broadcast_to(
            jnp.asarray(v, self._dtype), (B, n)))
        if Q is not None:
            p = p._replace(q=cast(Q, self.params.num_x))
        if R is not None:
            p = p._replace(r=cast(R, self.params.num_u))
        if Rm is not None:
            p = p._replace(rm=cast(Rm, self.params.num_u))
        self._p = p

    # -- the service step -----------------------------------------------------

    def step(self) -> np.ndarray:
        """One batched warm-started solve; returns first controls (B, nu)."""
        self.relinearize()   # LTV: refreeze at current states (no-op else)
        mu0 = self._mu_warm if self._warm else self._mu_cold
        t0 = time.perf_counter()
        res, self._X, self._U, u0 = jax.block_until_ready(
            self._step(self._p, self._X, self._U, mu0))
        self.solve_time_s = time.perf_counter() - t0
        self._warm = True
        self.last = res
        return np.asarray(u0)

    def metrics(self) -> dict:
        res = self.last
        if res is None:
            return {}
        return {
            "batch": self.batch,
            "solve_s": self.solve_time_s,
            "solves_per_s": self.batch / max(self.solve_time_s, 1e-12),
            "mean_iters": float(jnp.mean(res.iters)),
            "converged_frac": float(jnp.mean(
                (res.status == 0).astype(jnp.float32))),
            "max_feas": float(jnp.max(res.feas)),
        }

    # -- checkpoint / resume --------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "params": jax.tree.map(np.asarray, self._p),
            "X": np.asarray(self._X),
            "U": np.asarray(self._U),
            "warm": self._warm,
        }

    def load_state(self, st: dict) -> None:
        self._p = jax.tree.map(self._place, MPCParams(*st["params"]))
        self._X = self._place(st["X"])
        self._U = self._place(st["U"])
        self._warm = bool(st["warm"])
