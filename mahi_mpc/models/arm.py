"""Serial-manipulator dynamics via an autodiff Lagrangian formulation.

The reference's 4-DOF MAHI exoskeleton model exists only as a 15 kB flattened
symbolic mass matrix (``src/inverseTest.cpp:59-83``, ``util/Equations/``).
Instead of transcribing expressions, we build rigid-body dynamics the JAX way:
forward kinematics is a pure function, kinetic energy is assembled from
`jax.jvp` body velocities, the mass matrix is the (exact) Hessian of kinetic
energy in the joint rates, and Coriolis/gravity bias terms come from the
Euler-Lagrange equations via autodiff.  This yields ``qdd = M(q)^{-1} (tau -
h(q, qd))`` for *any* serial chain spec — the same machinery serves the 2-DOF
planar arm (benchmark config #3) and the 4-DOF MAHI-class arm (config #4), and
is itself differentiable, so `jax.jacfwd` linearization (the reference's
``get_A``/``get_B``, ``ModelGenerator.cpp:45-53``) works through it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.linalg import spd_solve_lanes
from .base import Dynamics, register

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One revolute joint + rigid link.

    axis: joint rotation axis, unit 3-vector in the parent frame.
    offset: translation from the parent joint to this joint, in the parent
        link frame (applied before the joint rotation).
    com: center-of-mass position in this link's frame.
    mass: link mass (kg).
    inertia: principal rotational inertia about the COM, in the link frame
        (3-vector diagonal).
    """

    axis: Tuple[float, float, float]
    offset: Tuple[float, float, float]
    com: Tuple[float, float, float]
    mass: float
    inertia: Tuple[float, float, float]


def _rodrigues(axis, angle: Array) -> Array:
    """Rotation matrix about a unit axis; shape-polymorphic: angle (...)
    gives R of shape (3, 3, ...) — component indices lead, batch trails.

    ``axis`` is a *static* numpy 3-vector, so K and K@K fold to numpy
    constants at trace time — no tiny matmul ops enter the graph."""
    kx, ky, kz = float(axis[0]), float(axis[1]), float(axis[2])
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]],
                 dtype=angle.dtype)
    KK = K @ K
    s, c = jnp.sin(angle), jnp.cos(angle)
    ext = (3, 3) + (1,) * jnp.ndim(angle)
    return (np.eye(3, dtype=angle.dtype).reshape(ext) + s * K.reshape(ext)
            + (1.0 - c) * KK.reshape(ext))


def _mm3(A: Array, B: Array) -> Array:
    """(3,3,...) @ (3,3,...) as broadcast-multiply-reduce.

    Equivalent to einsum("ij...,jk...->ik...") but lowers to elementwise
    mul + a reduction over a *leading* axis — elementwise work over the
    trailing batch, with no dot_general on tiny contracting dims."""
    return jnp.sum(A[:, :, None] * B[None, :, :], axis=1)


def _mv3(A: Array, b) -> Array:
    """(3,3,...) @ (3[,...]) as broadcast-multiply-reduce."""
    if isinstance(b, (np.ndarray, list, tuple)):
        # Static 3-vector: reshape for broadcast against A's trailing dims.
        bb = np.asarray(b).reshape((1, 3) + (1,) * (jnp.ndim(A) - 2))
        return jnp.sum(A * bb, axis=1)
    return jnp.sum(A * b[None], axis=1)


def _cross3(a: Array, b: Array) -> Array:
    """Cross product of (3, ...) vectors along axis 0."""
    return jnp.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]], axis=0)


def make_serial_arm(name: str, links: List[LinkSpec],
                    g: float = 9.81, gravity_dir=( 0.0, 0.0, -1.0),
                    joint_damping: float = 0.0) -> Dynamics:
    n = len(links)
    # Static chain constants stay numpy: they fold at trace time (no traced
    # 3-vector constants / tiny matmuls in the graph), which shrinks the XLA
    # program.
    axes = np.array([l.axis for l in links], dtype=np.float64)
    offsets = np.array([l.offset for l in links], dtype=np.float64)
    coms = np.array([l.com for l in links], dtype=np.float64)
    masses = np.array([l.mass for l in links], dtype=np.float64)
    inertias = np.array([l.inertia for l in links], dtype=np.float64)
    gvec = g * np.array(gravity_dir, dtype=np.float64)

    def fk_full(q: Array):
        """World-frame chain quantities (python loop unrolled at trace time):
        joint origins o_i, joint axes z_i, COM positions c_i, rotations R_i.
        Shape-polymorphic: q (n, ...) gives lists of (3, ...) / (3, 3, ...)
        — component indices lead, any batch trails."""
        offsets_ = offsets.astype(q.dtype)
        axes_ = axes.astype(q.dtype)
        coms_ = coms.astype(q.dtype)
        S = q.shape[1:]
        R = jnp.broadcast_to(
            jnp.eye(3, dtype=q.dtype).reshape((3, 3) + (1,) * len(S)),
            (3, 3) + S)
        p = jnp.zeros((3,) + S, q.dtype)
        os_, zs, cs, Rs = [], [], [], []
        for i in range(n):
            p = p + _mv3(R, offsets_[i])
            z = _mv3(R, axes_[i])     # joint axis is fixed in the parent frame
            R = _mm3(R, _rodrigues(axes_[i], q[i]))
            os_.append(p)
            zs.append(z)
            cs.append(p + _mv3(R, coms_[i]))
            Rs.append(R)
        return os_, zs, cs, Rs

    def fk(q: Array) -> Tuple[Array, Array]:
        """COM world positions (n,3[,...]) and link rotations (n,3,3[,...])."""
        _, _, cs, Rs = fk_full(q)
        return jnp.stack(cs), jnp.stack(Rs)

    def _mass_and_gravity(q: Array, with_g: bool = True
                          ) -> Tuple[Array, Array]:
        """Explicit geometric-Jacobian assembly:
        M = sum_i m_i Jv_i' Jv_i + Jw_i' (R_i I_i R_i') Jw_i,
        G_j = -sum_i m_i gvec . Jv_i[:, j]   (gravity torque, no autodiff).
        Cheaper to trace/evaluate than Hessian-of-kinetic-energy (which is
        third-order autodiff once the SQP linearizes through it), and
        shape-polymorphic in trailing lanes."""
        o, z, c, R = fk_full(q)
        S = q.shape[1:]
        inertias_ = inertias.astype(q.dtype)
        masses_ = masses.astype(q.dtype)
        gvec_ = gvec.astype(q.dtype)
        zero3 = jnp.zeros((3,) + S, q.dtype)
        Mrows = [[None] * n for _ in range(n)]
        G = [jnp.zeros(S, q.dtype) for _ in range(n)]
        # Jv columns per link i: (3, ...) each
        for i in range(n):
            Jv = [(_cross3(z[j], c[i] - o[j]) if j <= i else zero3)
                  for j in range(n)]
            Jw = [(z[j] if j <= i else zero3) for j in range(n)]
            # Iw = R diag(I) R'
            Iw = _mm3(R[i] * inertias_[i].reshape((1, 3) + (1,) * len(S)),
                      jnp.swapaxes(R[i], 0, 1))
            IwJw = [_mv3(Iw, Jw[k]) for k in range(n)]
            for a in range(n):
                if with_g:
                    gv = np.asarray(gvec_).reshape((3,) + (1,) * len(S))
                    G[a] = G[a] - masses_[i] * jnp.sum(Jv[a] * gv, axis=0)
                for b in range(a, n):
                    contrib = (masses_[i] * jnp.sum(Jv[a] * Jv[b], axis=0)
                               + jnp.sum(Jw[a] * IwJw[b], axis=0))
                    Mrows[a][b] = contrib if Mrows[a][b] is None \
                        else Mrows[a][b] + contrib
        for a in range(n):
            for b in range(a):
                Mrows[a][b] = Mrows[b][a]
        M = jnp.stack([jnp.stack(row, axis=0) for row in Mrows], axis=0)
        return M, jnp.stack(G, axis=0)

    def mass_matrix(q: Array) -> Array:
        return _mass_and_gravity(q)[0]

    def kinetic(q: Array, qd: Array) -> Array:
        return 0.5 * jnp.einsum("i...,ij...,j...->...",
                                qd, mass_matrix(q), qd)

    def potential(q: Array) -> Array:
        cs, _ = fk(q)   # (n, 3, ...)
        heights = jnp.einsum("li...,i->l...", cs, gvec.astype(q.dtype))
        return -jnp.einsum("l...,l->...", heights, masses.astype(q.dtype))

    def _coriolis_qd(q: Array, qd: Array) -> Array:
        """C(q, qd) qd = Mdot qd - 1/2 d(qd' M qd)/dq with exactly two AD
        sweeps over the mass-matrix graph (instead of n basis-vector passes,
        which made the SQP's linearization third-order AD over an n-times
        duplicated graph — the round-1 compile bomb):
          Mdot      = sum_j qd_j dM/dq_j = jvp(M, q; qd)       (one jvp)
          dKE/dq    = vjp(M, q)(1/2 qd qd')                     (one vjp)
        using KE = 1/2 tr(M qd qd') so the cotangent of M is 1/2 qd qd'."""
        Mdot = jax.jvp(mass_matrix, (q,), (qd,))[1]
        _, pullback = jax.vjp(mass_matrix, q)
        half_outer = 0.5 * qd[:, None] * qd[None, :]
        dKE = pullback(half_outer)[0]                  # (n, ...)
        return jnp.einsum("ij...,j...->i...", Mdot, qd) - dKE

    def bias_lagrangian(q: Array, qd: Array) -> Array:
        """h(q, qd) = C(q, qd) qd + grav(q), via two AD sweeps over the
        mass-matrix graph.  Kept as the cross-validation oracle for the RNEA
        bias below (tests pin the two to roundoff)."""
        _, G = _mass_and_gravity(q)
        return _coriolis_qd(q, qd) + G

    def bias(q: Array, qd: Array) -> Array:
        """h(q, qd) = C(q, qd) qd + grav(q) via recursive Newton-Euler with
        qdd = 0 in the world frame — an explicit O(n) graph with NO autodiff.

        The Lagrangian form above traces the whole mass-matrix assembly
        three times (primal + jvp + vjp), which made the 4-DOF arm's f graph
        5.4k StableHLO lines and the SQP linearization (jvp over f) 18.8k —
        the dominant term of a 43k-line solve program that took the
        compiler minutes.  RNEA keeps the f graph a single fk pass plus two
        O(n) sweeps.

        Gravity enters by the standard base-acceleration trick: the base
        frame "accelerates" at -gvec, so every link feels the gravito-
        inertial force without a separate potential-gradient pass."""
        o, z, c, R = fk_full(q)
        S = q.shape[1:]
        inertias_ = inertias.astype(q.dtype)
        masses_ = masses.astype(q.dtype)
        mg = (-gvec).astype(q.dtype)       # base acceleration = -g
        zero3 = jnp.zeros((3,) + S, q.dtype)

        # Forward sweep: angular velocity/acceleration of each link, linear
        # acceleration of each joint origin and COM (qdd = 0).
        w_prev, al_prev = zero3, zero3
        a_prev = jnp.broadcast_to(mg.reshape((3,) + (1,) * len(S)),
                                  (3,) + S)                      # a_{o_{-1}}
        o_prev = zero3
        ws, als, acs = [], [], []
        for i in range(n):
            d = o[i] - o_prev                  # segment rigid in link i-1
            a_oi = (a_prev + _cross3(al_prev, d)
                    + _cross3(w_prev, _cross3(w_prev, d)))
            w_i = w_prev + z[i] * qd[i]
            al_i = al_prev + _cross3(w_prev, z[i] * qd[i])
            rc = c[i] - o[i]                   # COM offset rigid in link i
            a_ci = (a_oi + _cross3(al_i, rc)
                    + _cross3(w_i, _cross3(w_i, rc)))
            ws.append(w_i); als.append(al_i); acs.append(a_ci)
            w_prev, al_prev, a_prev, o_prev = w_i, al_i, a_oi, o[i]

        # Backward sweep: accumulate forces/moments toward the base.
        taus: list = [None] * n
        f_child = zero3
        n_child = zero3
        o_child = o[n - 1]                     # placeholder, f_child = 0
        for i in reversed(range(n)):
            Iw = _mm3(R[i] * inertias_[i].reshape((1, 3) + (1,) * len(S)),
                      jnp.swapaxes(R[i], 0, 1))
            F_i = masses_[i] * acs[i]
            N_i = _mv3(Iw, als[i]) + _cross3(ws[i], _mv3(Iw, ws[i]))
            n_i = (N_i + _cross3(c[i] - o[i], F_i)
                   + n_child + _cross3(o_child - o[i], f_child))
            f_i = F_i + f_child
            taus[i] = jnp.sum(z[i] * n_i, axis=0)
            f_child, n_child, o_child = f_i, n_i, o[i]
        return jnp.stack(taus, axis=0)

    def f(x: Array, u: Array) -> Array:
        q, qd = x[:n], x[n:]
        M, _ = _mass_and_gravity(q, with_g=False)
        h = bias(q, qd)
        # SPD mass matrix: unrolled Cholesky solve in lanes layout
        # (ops/linalg.py) — no LAPACK custom calls, it fuses, and the
        # trailing batch stays contiguous.
        qdd = spd_solve_lanes(M, u - h - joint_damping * qd)
        return jnp.concatenate([qd, qdd], axis=0)

    dyn = Dynamics(name, nx=2 * n, nu=n, f=f, supports_lanes=True, nq=n)
    # Expose internals for tests and tooling (frozen dataclass -> object.__setattr__).
    object.__setattr__(dyn, "mass_matrix", mass_matrix)
    object.__setattr__(dyn, "bias", bias)
    object.__setattr__(dyn, "bias_lagrangian", bias_lagrangian)
    object.__setattr__(dyn, "fk", fk)
    return dyn


@register("two_link_arm")
def make_two_link_arm(l1: float = 1.0, l2: float = 1.0, m1: float = 1.0,
                      m2: float = 1.0, g: float = 9.81) -> Dynamics:
    """Planar 2-DOF arm in the x-z plane, rotating about y, with distributed
    link mass (uniform rods).  Benchmark config #3 (2-DOF planar arm reaching
    with torque cost, cf. the reference's mpc_withTorqueCost setup)."""
    rod = lambda m, l: (m * l * l / 12.0,) * 3
    links = [
        LinkSpec(axis=(0, 1, 0), offset=(0, 0, 0), com=(l1 / 2, 0, 0),
                 mass=m1, inertia=rod(m1, l1)),
        LinkSpec(axis=(0, 1, 0), offset=(l1, 0, 0), com=(l2 / 2, 0, 0),
                 mass=m2, inertia=rod(m2, l2)),
    ]
    return make_serial_arm("two_link_arm", links, g=g)


@register("mahi_arm")
def make_mahi_arm(g: float = 9.81) -> Dynamics:
    """4-DOF MAHI-exoskeleton arm: elbow flexion, forearm
    pronation/supination, wrist flexion/extension, wrist radial/ulnar
    deviation (nx=8, nu=4).

    The kinematic structure is the reference's real exo chain, decoded from
    its full symbolic mass matrix (``src/inverseTest.cpp:59-83``) and pinned
    to roundoff in
    ``tests/test_dynamics.py::test_mahi_exo_mass_matrix_matches_reference``:
    joint axes (world frame, zero posture) x, y, z, -y, with joints 1-3
    co-located 0.15 m from the elbow axis along z (the forearm segment; the
    3/20 literals in the reference expressions).  Inertial PARAMETER values
    are representative human-forearm magnitudes — the reference keeps its
    parameters symbolic (``Icxx_i``/``Pcx_i``/``m_i``), so there are no
    reference numbers to transcribe; the oracle test binds them to random
    values instead."""
    links = [
        # elbow flexion about x; upper arm is the fixed base.  The forearm
        # COM sits along the offset axis toward the wrist cluster.
        LinkSpec(axis=(1, 0, 0), offset=(0, 0, 0), com=(0, 0, 0.10),
                 mass=1.5, inertia=(0.010, 0.010, 0.002)),
        # forearm pronation/supination about y, 0.15 m down the forearm
        LinkSpec(axis=(0, 1, 0), offset=(0, 0, 0.15), com=(0, 0.05, 0),
                 mass=0.5, inertia=(0.002, 0.001, 0.002)),
        # wrist flexion/extension about z (co-located)
        LinkSpec(axis=(0, 0, 1), offset=(0, 0, 0), com=(0, 0.03, 0),
                 mass=0.4, inertia=(0.0012, 0.0012, 0.0008)),
        # wrist radial/ulnar deviation about -y (co-located)
        LinkSpec(axis=(0, -1, 0), offset=(0, 0, 0), com=(0, -0.05, 0),
                 mass=0.45, inertia=(0.0012, 0.0006, 0.0012)),
    ]
    return make_serial_arm("mahi_arm", links, g=g, joint_damping=0.05)
