"""Direct multiple-shooting transcription.

Reproduces the reference NLP exactly (``src/Mahi/Mpc/ModelGenerator.cpp``):

- decision vector ``V = [x_0, u_0, x_1, u_1, ..., x_N]`` of size
  ``nx*(N+1) + nu*N`` (``ModelGenerator.cpp:61,86-112``),
- continuity equality constraints ``c_k = F(x_k, u_k) - x_{k+1} = 0``
  (``ModelGenerator.cpp:206``) with ``F`` the forward-Euler step
  (``:33-34``) or, in linear mode, the frozen LTV step (``:47-48,58``),
- cost ``J = sum_k e_k' Q e_k + du_k' R du_k + u_k' Rm u_k`` where
  ``e_k = F(x_k, u_k) - x_des_k`` (note: the *propagated* state, ``:210-214``)
  and ``du_0 = u_0 - u_init`` (``:217-218``),
- runtime parameters (trajectory, weight diagonals, linearization point,
  previous control) packed per ``ModelGenerator.cpp:129-187``.

Unlike the reference's flat ``traj`` vector, parameters live in a pytree
(`MPCParams`); `pack_ref_params` / `unpack_ref_params` provide the exact
flat-vector adapter for oracle comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import Dynamics
from ..models.integrators import make_step
from ..params import ModelParameters

Array = jnp.ndarray


class LinPoint(NamedTuple):
    """Per-solve linearization point for successive-linearization (LTV) mode
    (``ModelControl.cpp:125-135``): one (A, B, x_dot0, x0, u0) per solve,
    constant across the horizon."""

    A: Array      # (nx, nx)
    B: Array      # (nx, nu)
    x_dot0: Array  # (nx,)
    x0: Array     # (nx,)
    u0: Array     # (nu,)


class MPCParams(NamedTuple):
    """Everything that can change between solves without recompilation —
    the pytree analog of the reference's NLP parameter vector plus the
    runtime-mutable bounds (``ModelControl.cpp:144-154,199-209``)."""

    x_des: Array   # (N, nx) desired trajectory
    q: Array       # (nx,)  tracking weight diagonal
    r: Array       # (nu,)  input-rate weight diagonal
    rm: Array      # (nu,)  input-magnitude weight diagonal
    u_prev: Array  # (nu,)  previous control (du_0 anchor)
    x0: Array      # (nx,)  measured state, pinned at node 0
    u_min: Array   # (nu,)
    u_max: Array   # (nu,)
    x_min: Array   # (nx,)
    x_max: Array   # (nx,)
    lin: LinPoint  # linearization point (used only when is_linear)
    # Extension over the reference parameter vector: a separate terminal
    # cost  (x_N - xf_des)' diag(qf) (x_N - xf_des).  qf = 0 reproduces the
    # reference exactly; trajgen's augmented-Lagrangian endpoint constraint
    # and terminal-set MPC variants use it.
    qf: Array      # (nx,)
    xf_des: Array  # (nx,)


# Needed so AOT artifacts (runtime/generate.py) can serialize programs whose
# signatures carry these pytrees.
jax.export.register_namedtuple_serialization(
    LinPoint, serialized_name="mahi_mpc.LinPoint")
jax.export.register_namedtuple_serialization(
    MPCParams, serialized_name="mahi_mpc.MPCParams")


def default_params(mp: ModelParameters, dtype=jnp.float32) -> MPCParams:
    nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
    f32 = lambda v: jnp.asarray(np.asarray(v, dtype=np.float64), dtype=dtype)
    return MPCParams(
        x_des=jnp.zeros((N, nx), dtype),
        q=jnp.ones(nx, dtype), r=jnp.ones(nu, dtype), rm=jnp.ones(nu, dtype),
        u_prev=jnp.zeros(nu, dtype), x0=jnp.zeros(nx, dtype),
        u_min=f32(mp.u_min), u_max=f32(mp.u_max),
        x_min=f32(mp.x_min), x_max=f32(mp.x_max),
        lin=LinPoint(jnp.zeros((nx, nx), dtype), jnp.zeros((nx, nu), dtype),
                     jnp.zeros(nx, dtype), jnp.zeros(nx, dtype),
                     jnp.zeros(nu, dtype)),
        qf=jnp.zeros(nx, dtype), xf_des=jnp.zeros(nx, dtype),
    )


@dataclasses.dataclass(frozen=True)
class ShootingProblem:
    """Static problem description: shapes + discretized dynamics.

    The trajectory iterate is ``(X, U)`` with ``X: (N+1, nx)``,
    ``U: (N, nu)`` — the unpacked view of the reference's flat ``V``.
    """

    dynamics: Dynamics
    N: int
    dt: float
    is_linear: bool = False
    integrator: str = "euler"

    @property
    def nx(self) -> int:
        return self.dynamics.nx

    @property
    def nu(self) -> int:
        return self.dynamics.nu

    @property
    def nv(self) -> int:
        return self.nx * (self.N + 1) + self.nu * self.N

    # -- discrete dynamics ----------------------------------------------------

    def step(self, x: Array, u: Array, p: MPCParams) -> Array:
        """One shooting step ``F(x_k, u_k)`` (``ModelGenerator.cpp:33-34`` /
        linear ``:47-48``)."""
        if self.is_linear:
            lp = p.lin
            f = lambda x_, u_: self.dynamics.linear_f(
                x_, u_, lp.A, lp.B, lp.x_dot0, lp.x0, lp.u0)
        else:
            f = self.dynamics.f
        return make_step(f, self.dt, self.integrator)(x, u)

    def rollout(self, x0: Array, U: Array, p: MPCParams) -> Array:
        """Propagate the discrete dynamics open-loop: returns X (N+1, nx)."""
        def body(x, u):
            xn = self.step(x, u, p)
            return xn, xn
        _, xs = jax.lax.scan(body, x0, U)
        return jnp.concatenate([x0[None], xs], axis=0)

    # -- NLP functions ---------------------------------------------------------

    def defects(self, X: Array, U: Array, p: MPCParams) -> Array:
        """Continuity residuals ``c_k = F(x_k,u_k) - x_{k+1}``, shape (N, nx)
        (``ModelGenerator.cpp:206``)."""
        xn = jax.vmap(lambda x, u: self.step(x, u, p))(X[:-1], U)
        return xn - X[1:]

    def cost(self, X: Array, U: Array, p: MPCParams) -> Array:
        """The exact reference objective (``ModelGenerator.cpp:210-221``):
        tracking error measured on the *propagated* state F(x_k, u_k)."""
        xn = jax.vmap(lambda x, u: self.step(x, u, p))(X[:-1], U)
        e = xn - p.x_des
        j_track = jnp.sum((e * e) @ p.q)
        du = jnp.diff(U, axis=0, prepend=p.u_prev[None])
        j_rate = jnp.sum((du * du) @ p.r)
        j_mag = jnp.sum((U * U) @ p.rm)
        ef = X[-1] - p.xf_des
        return j_track + j_rate + j_mag + (ef * ef) @ p.qf

    def cost_separable(self, X: Array, U: Array, p: MPCParams) -> Array:
        """Equivalent cost with tracking measured on ``x_{k+1}`` instead of
        ``F(x_k,u_k)``.  Identical on the constraint manifold (and therefore
        at every KKT point); quadratic in (X, U), which is what the Riccati
        solver exploits."""
        e = X[1:] - p.x_des
        j_track = jnp.sum((e * e) @ p.q)
        du = jnp.diff(U, axis=0, prepend=p.u_prev[None])
        j_rate = jnp.sum((du * du) @ p.r)
        j_mag = jnp.sum((U * U) @ p.rm)
        ef = X[-1] - p.xf_des
        return j_track + j_rate + j_mag + (ef * ef) @ p.qf

    def linearize_stages(self, X: Array, U: Array,
                         p: MPCParams) -> Tuple[Array, Array, Array]:
        """Stagewise discrete Jacobians and defects for the SQP:
        ``A_k = dF/dx``, ``B_k = dF/du`` at each ``(x_k, u_k)``, plus the
        defect ``c_k``.  Replaces CasADi's NLP Jacobian codegen — one
        vmapped jacfwd over the horizon."""
        step = lambda x, u: self.step(x, u, p)
        def one(x, u, xn_target):
            xn, (A, B) = _value_and_jacs(step, x, u)
            return A, B, xn - xn_target
        A, B, c = jax.vmap(one)(X[:-1], U, X[1:])
        return A, B, c

    # -- flat-vector adapters (oracle comparison) ------------------------------

    def pack_v(self, X: Array, U: Array) -> Array:
        """Interleave to the reference layout [x_0,u_0,...,x_N]
        (``ModelGenerator.cpp:86-112``)."""
        head = jnp.concatenate([X[:-1], U], axis=1).reshape(-1)
        return jnp.concatenate([head, X[-1]])

    def unpack_v(self, v: Array) -> Tuple[Array, Array]:
        nx, nu, N = self.nx, self.nu, self.N
        body = v[: N * (nx + nu)].reshape(N, nx + nu)
        X = jnp.concatenate([body[:, :nx], v[None, N * (nx + nu):]], axis=0)
        return X, body[:, nx:]

    def pack_ref_params(self, p: MPCParams) -> Array:
        """Flatten to the reference runtime parameter vector layout
        (``ModelGenerator.cpp:129-187`` + ``ModelControl.cpp:120-136``):
        [x_des (N*nx) | Qdiag | Rdiag | Rmdiag |
         (linear: A col-major | B col-major | x_dot0 | x0) | u_prev]."""
        parts = [p.x_des.reshape(-1), p.q, p.r, p.rm]
        if self.is_linear:
            # CasADi reshape() is column-major (Fortran order).
            parts += [p.lin.A.T.reshape(-1), p.lin.B.T.reshape(-1),
                      p.lin.x_dot0, p.lin.x0]
        parts.append(p.u_prev)
        return jnp.concatenate(parts)

    def unpack_ref_params(self, traj: Array, base: MPCParams) -> MPCParams:
        nx, nu, N = self.nx, self.nu, self.N
        i = N * nx
        x_des = traj[:i].reshape(N, nx)
        q, r, rm = traj[i:i + nx], traj[i + nx:i + nx + nu], traj[i + nx + nu:i + nx + 2 * nu]
        i += nx + 2 * nu
        lin = base.lin
        if self.is_linear:
            A = traj[i:i + nx * nx].reshape(nx, nx).T
            i += nx * nx
            B = traj[i:i + nx * nu].reshape(nu, nx).T
            i += nx * nu
            x_dot0 = traj[i:i + nx]
            x0l = traj[i + nx:i + 2 * nx]
            i += 2 * nx
            lin = LinPoint(A, B, x_dot0, x0l, traj[i:i + nu])
        u_prev = traj[i:i + nu]
        return base._replace(x_des=x_des, q=q, r=r, rm=rm, u_prev=u_prev,
                             lin=lin._replace(u0=u_prev) if self.is_linear else lin)

    def bounds_v(self, p: MPCParams) -> Tuple[Array, Array]:
        """Runtime decision-vector bounds in the flat layout: node-0 state
        pinched to the measurement (``ModelControl.cpp:144-145``), controls at
        the (mutable) limits each node (``:148-154``), all other states at
        the state bounds incl. the terminal node (``ModelControl.cpp:37-50``)."""
        N = self.N
        xs_min = jnp.concatenate([p.x0[None], jnp.tile(p.x_min, (N, 1))])
        xs_max = jnp.concatenate([p.x0[None], jnp.tile(p.x_max, (N, 1))])
        us_min = jnp.tile(p.u_min, (N, 1))
        us_max = jnp.tile(p.u_max, (N, 1))
        return self.pack_v(xs_min, us_min), self.pack_v(xs_max, us_max)


def _value_and_jacs(step: Callable, x: Array, u: Array):
    """F(x,u) and its Jacobians in one pass via jacfwd over the joint input."""
    nx, nu = x.shape[0], u.shape[0]
    joint = lambda w: step(w[:nx], w[nx:])
    w = jnp.concatenate([x, u])
    J = jax.jacfwd(joint)(w)
    return joint(w), (J[:, :nx], J[:, nx:])


def make_problem(mp: ModelParameters, dynamics: Dynamics) -> ShootingProblem:
    """Build a ShootingProblem from a ModelParameters config."""
    assert mp.num_x == dynamics.nx and mp.num_u == dynamics.nu, (
        f"model '{dynamics.name}' has nx={dynamics.nx}, nu={dynamics.nu}; "
        f"params say {mp.num_x}, {mp.num_u}")
    return ShootingProblem(dynamics=dynamics, N=mp.num_shooting_nodes,
                           dt=mp.step_size, is_linear=mp.is_linear,
                           integrator=mp.integrator)
