"""Offline trajectory-library generation.

Completes what the reference's WIP (non-compiling) ``TrajectoryGenerator``
started (``src/Mahi/Mpc/TrajectoryGenerator.cpp:23-220``, SURVEY.md C16):
read a waypoint list (CSV), solve a point-to-point trajectory optimization
for every consecutive waypoint pair — minimum-effort ``sum u'u`` cost with
endpoint equality (the reference pinned both endpoints through
``lbx = ubx``, ``TrajectoryGenerator.cpp:72-82``) — and write the resulting
(t, x, u) library back to CSV.

Batched formulation: all segments are one *batch* — each segment is an
instance of the same multiple-shooting problem, vmapped and shardable over
the scenario mesh.  The terminal equality constraint is enforced by an
augmented-Lagrangian outer loop on the terminal-cost extension (qf/xf_des in
`MPCParams`): quadratic penalty rho plus multiplier shift, warm-started
between outer iterations, which drives ``|x_N - goal|`` to tolerance in a
handful of outer rounds while keeping every inner solve the standard
fixed-shape SQP.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import Dynamics
from ..params import ModelParameters, SolverOptions, TrajectoryParameters
from ..solver.sqp import solve
from ..transcribe.shooting import default_params, make_problem


@dataclasses.dataclass
class TrajectorySegment:
    """One waypoint-to-waypoint solve result."""
    times: np.ndarray   # (N+1,)
    X: np.ndarray       # (N+1, nx)
    U: np.ndarray       # (N, nu)
    endpoint_err: float
    status: int


class TrajectoryGenerator:
    """Batched point-to-point trajectory library generator.

    waypoints: (W, nx) array of states (typically [q, 0] rest-to-rest).
    Each consecutive pair becomes a segment of ``num_shooting_nodes`` steps
    of ``step_size``.
    """

    def __init__(self, params: TrajectoryParameters | ModelParameters,
                 dynamics: Dynamics,
                 opts: SolverOptions = SolverOptions(),
                 u_min: Optional[Sequence[float]] = None,
                 u_max: Optional[Sequence[float]] = None,
                 effort_weight: float = 1.0,
                 rate_weight: float = 0.01,
                 al_rounds: int = 6,
                 rho: float = 1e3):
        self.tp = params
        mp = ModelParameters(
            name=getattr(params, "name", "trajgen"),
            num_x=params.num_x, num_u=params.num_u,
            step_size=params.step_size,
            num_shooting_nodes=params.num_shooting_nodes,
            u_min=list(u_min) if u_min is not None else [],
            u_max=list(u_max) if u_max is not None else [],
            integrator=getattr(params, "integrator", "rk4"))
        self.mp = mp
        self.dynamics = dynamics
        self.opts = opts
        self.effort_weight = effort_weight
        self.rate_weight = rate_weight
        self.al_rounds = al_rounds
        self.rho = rho
        self.problem = make_problem(mp, dynamics)
        self._batched = None  # compiled lazily per batch size

    def _solver(self, batch: int):
        if self._batched is None or self._batched[0] != batch:
            prob, opts = self.problem, self.opts
            fn = jax.jit(jax.vmap(
                lambda p, X0, U0: solve(prob, p, X0, U0, opts)))
            self._batched = (batch, fn)
        return self._batched[1]

    def generate(self, waypoints: np.ndarray) -> list[TrajectorySegment]:
        """Solve all segments as one batch with an augmented-Lagrangian
        outer loop on the endpoint constraint."""
        wps = np.asarray(waypoints, float)
        assert wps.ndim == 2 and wps.shape[1] == self.mp.num_x, (
            f"waypoints must be (W, {self.mp.num_x}), got {wps.shape}")
        S = wps.shape[0] - 1
        assert S >= 1, "need at least two waypoints"
        prob, mp = self.problem, self.mp
        nx, nu, N = prob.nx, prob.nu, prob.N
        dtype = jnp.dtype(self.opts.dtype)

        starts = jnp.asarray(wps[:-1], dtype)
        goals = jnp.asarray(wps[1:], dtype)

        p = default_params(mp, dtype=dtype)
        p = p._replace(
            q=jnp.zeros(nx, dtype),                       # no tracking cost
            r=jnp.full((nu,), self.rate_weight, dtype),   # smoothness
            rm=jnp.full((nu,), self.effort_weight, dtype))  # min effort
        pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape), p)
        pb = pb._replace(
            x0=starts,
            xf_des=goals,
            qf=jnp.full((S, nx), self.rho, dtype),
            # x_des only matters through q=0: keep goals for readability
            x_des=jnp.broadcast_to(goals[:, None, :], (S, N, nx)))

        # Warm start: straight-line interpolation between endpoints.
        alpha = jnp.linspace(0.0, 1.0, N + 1, dtype=dtype)[None, :, None]
        X = (1 - alpha) * starts[:, None, :] + alpha * goals[:, None, :]
        U = jnp.zeros((S, N, nu), dtype)

        lam = jnp.zeros((S, nx), dtype)
        fn = self._solver(S)
        res = None
        for _ in range(self.al_rounds):
            # AL shift: qf ||x_N - (goal - lam/(2 qf))||^2 == lam' c + qf||c||^2
            pb_i = pb._replace(xf_des=goals - lam / (2.0 * self.rho))
            res = fn(pb_i, X, U)
            X, U = res.X, res.U
            c = X[:, -1, :] - goals
            lam = lam + 2.0 * self.rho * c
            if float(jnp.max(jnp.abs(c))) < 10.0 * self.opts.tol:
                break

        times = np.arange(N + 1) * mp.step_size
        out = []
        for s in range(S):
            out.append(TrajectorySegment(
                times=times.copy(),
                X=np.asarray(res.X[s]), U=np.asarray(res.U[s]),
                endpoint_err=float(jnp.max(jnp.abs(res.X[s, -1] - goals[s]))),
                status=int(res.status[s])))
        return out

    # -- CSV round trip (reference csv_read_rows/csv_write_row,
    #    TrajectoryGenerator.cpp:198-205) -----------------------------------

    def generate_from_csv(self, waypoint_csv: str | Path,
                          out_csv: str | Path) -> list[TrajectorySegment]:
        wps = load_waypoints_csv(waypoint_csv, self.mp.num_x)
        segs = self.generate(wps)
        write_library_csv(out_csv, segs, self.mp)
        return segs


def load_waypoints_csv(path: str | Path, nx: int) -> np.ndarray:
    """Waypoint CSV: one row per waypoint, nx columns (header optional)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            try:
                rows.append([float(v) for v in parts[:nx]])
            except ValueError:
                continue  # header
    return np.asarray(rows, float)


def write_library_csv(path: str | Path, segs: Sequence[TrajectorySegment],
                      mp: ModelParameters) -> None:
    """Library CSV: segment, t, x..., u... (u blank on the terminal node)."""
    nx, nu = mp.num_x, mp.num_u
    with open(path, "w") as f:
        hdr = (["segment", "t"] + [f"x{i}" for i in range(nx)]
               + [f"u{i}" for i in range(nu)])
        f.write(",".join(hdr) + "\n")
        for s, seg in enumerate(segs):
            for k in range(seg.X.shape[0]):
                u = seg.U[k] if k < seg.U.shape[0] else [""] * nu
                row = ([str(s), f"{seg.times[k]:.9g}"]
                       + [f"{v:.9g}" for v in seg.X[k]]
                       + [f"{v:.9g}" if v != "" else "" for v in u])
                f.write(",".join(row) + "\n")


def read_library_csv(path: str | Path, nx: int, nu: int
                     ) -> list[TrajectorySegment]:
    """Inverse of `write_library_csv`."""
    import collections
    per_seg = collections.defaultdict(lambda: ([], [], []))
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.rstrip("\n").split(",")
            s = int(parts[0])
            t = float(parts[1])
            x = [float(v) for v in parts[2:2 + nx]]
            u_raw = parts[2 + nx:2 + nx + nu]
            ts, xs, us = per_seg[s]
            ts.append(t)
            xs.append(x)
            if u_raw and u_raw[0] != "":
                us.append([float(v) for v in u_raw])
    out = []
    for s in sorted(per_seg):
        ts, xs, us = per_seg[s]
        out.append(TrajectorySegment(
            times=np.asarray(ts), X=np.asarray(xs), U=np.asarray(us),
            endpoint_err=float("nan"), status=0))
    return out
