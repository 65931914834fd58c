"""Online receding-horizon control runtime.

Equivalent of the reference's ``ModelControl``
(``src/Mahi/Mpc/ModelControl.cpp``): loads the JSON + AOT artifact written by
`ModelGenerator` (the analog of nlpsol-from-dll, ``ModelControl.cpp:62``),
runs warm-started solves (`calc_u`, ``:116-172``), and serves a 1 kHz control
thread from a free-running background solver thread (``start_calc``,
``:83-112``) through an immutable-`Plan` atomic swap instead of the
reference's three mutexes (SURVEY.md §5: no races by construction).

Runtime mutation parity (C10): ``set_state`` (``:75-81``),
``update_weights`` (``:199-203``), ``update_control_limits`` (``:205-209``)
— all are *solver inputs*, not compiled constants, exactly as the reference
passes them through the NLP parameter vector, so none trigger recompilation.

Failure handling (the reference uses ``solver_result.at("x")`` unconditionally,
``:159-160``): a solve that diverges or returns non-finite values keeps the
previous plan being served — the stale-plan fallback the threaded design
already implies — and increments a failure counter.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import Dynamics, make_dynamics
from ..ops.precision import highest_precision
from ..params import ModelParameters, SolverOptions
from ..solver.sqp import CONVERGED, DIVERGED, SolveResult, solve
from ..transcribe.shooting import (LinPoint, MPCParams, ShootingProblem,
                                   default_params, make_problem)
from .generate import (ARTIFACT_SUFFIX, LINEAR_SUFFIX, WARM_SUFFIX,
                       load_exported)
from .plan import Plan, empty_plan


class SolveStats:
    """Per-solve metrics (SURVEY.md §5 observability): the reference prints a
    rolling average at shutdown (``ModelControl.cpp:93-108``); we keep full
    latency quantiles + iteration/status counters."""

    def __init__(self, capacity: int = 4096):
        self._times: list[float] = []
        self._iters: list[int] = []
        self._fails = 0
        self._count = 0
        self._cap = capacity
        # Fallback-serve observability: the reference's equivalent was UB
        # (``ModelControl.cpp:195-196`` indexes an empty result vector before
        # the first solve); here the fallback is well-defined *and counted*,
        # so a hard-RT consumer can detect "I was served a placeholder /
        # stale plan" from metrics instead of polling
        # ``control_results().status``.
        self.served_placeholder = 0   # control_at_time before any solve
        self.served_stale = 0         # control_at_time while last solve failed

    def record(self, dt_s: float, iters: int, ok: bool) -> None:
        self._count += 1
        if not ok:
            self._fails += 1
        if len(self._times) < self._cap:
            self._times.append(dt_s)
            self._iters.append(iters)
        else:  # reservoir-ish: overwrite cyclically
            i = self._count % self._cap
            self._times[i] = dt_s
            self._iters[i] = iters

    def summary(self) -> dict:
        if not self._times:
            return {"solves": 0,
                    "served_placeholder": self.served_placeholder,
                    "served_stale": self.served_stale}
        t = np.asarray(self._times)
        return {
            "solves": self._count,
            "failures": self._fails,
            "served_placeholder": self.served_placeholder,
            "served_stale": self.served_stale,
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "mean_iters": float(np.mean(self._iters)),
        }


class ModelControl:
    """Warm-started receding-horizon MPC runtime for one model.

    Construction mirrors ``ModelControl(model_name, Q, R, Rm, opts)``
    (``ModelControl.hpp:26-33``): give it the model name + directory written
    by `ModelGenerator`, or a `ModelParameters` + `Dynamics` directly.
    """

    def __init__(self, model_name: str | ModelParameters,
                 Q: Optional[Sequence[float]] = None,
                 R: Optional[Sequence[float]] = None,
                 Rm: Optional[Sequence[float]] = None,
                 opts: SolverOptions = SolverOptions(),
                 directory: str | Path = ".",
                 dynamics: Optional[Dynamics] = None,
                 use_native_server: bool = False):
        if isinstance(model_name, ModelParameters):
            self.params = model_name
        else:
            self.params = ModelParameters.load(model_name, directory)
        mp = self.params
        self.opts = opts
        self._dtype = jnp.dtype(opts.dtype)

        self._load_model(Path(directory), dynamics)

        nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
        p = default_params(mp, dtype=self._dtype)
        if Q is not None:
            p = p._replace(q=jnp.asarray(Q, self._dtype))
        if R is not None:
            p = p._replace(r=jnp.asarray(R, self._dtype))
        if Rm is not None:
            p = p._replace(rm=jnp.asarray(Rm, self._dtype))
        self._p = p

        # Warm-start buffers (C7: previous optimum seeds the next solve,
        # ModelControl.cpp:161; zero init on load, :29-45).
        self._X0 = jnp.zeros((N + 1, nx), self._dtype)
        self._U0 = jnp.zeros((N, nu), self._dtype)
        # Barrier schedule: cold solves descend from mu_init; once warm, the
        # barrier restarts at warm_mu_factor*tol (see solver.sqp mu0).
        self._mu_cold = jnp.asarray(opts.mu_init, self._dtype)
        self._mu_warm = jnp.asarray(
            max(opts.warm_mu_factor * opts.tol, opts.mu_min), self._dtype)
        self._is_warm = False

        # Latest measured inputs (set_state, ModelControl.cpp:75-81).
        self._state_lock = threading.Lock()
        self._t = 0.0
        self._x = np.zeros(nx)
        self._u = np.zeros(nu)
        self._traj = np.zeros((N, nx))

        # The served plan: immutable, swapped atomically (GIL reference
        # assignment) — replaces m_output_mutex (ModelControl.cpp:186-189).
        self._plan: Plan = empty_plan(nx, nu)

        # Optional native (C++) plan server: wait-free seqlock handoff for
        # hard-real-time consumers (runtime/native/plan_server.cpp).
        self._native = None
        if use_native_server:
            from .native import NativePlanServer
            self._native = NativePlanServer(nx, nu, N)

        self._calc_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stale = False
        self.stats = SolveStats()

    # -- loading (reference load_model, ModelControl.cpp:21-73) --------------

    def _load_model(self, directory: Path, dynamics: Optional[Dynamics]):
        mp = self.params
        art = Path(mp.dll_filepath) if mp.dll_filepath else (
            directory / f"{mp.name}{ARTIFACT_SUFFIX}")
        self.problem: Optional[ShootingProblem] = None
        self.dynamics = dynamics

        if art.is_file():
            # Load the AOT artifact — no Python re-trace, the analog of
            # nlpsol-from-dll (ModelControl.cpp:62).  Register LAPACK FFI
            # targets first: on CPU they are registered lazily at lowering
            # time, and a fresh process executing a deserialized artifact
            # that contains them would segfault (ops/linalg.py).
            from ..ops.linalg import register_lapack_ffi_targets
            register_lapack_ffi_targets()
            self._solve_fn = jax.jit(load_exported(art).call)  # (p,X0,U0,mu0)
            warm_path = art.with_name(
                art.name[: -len(ARTIFACT_SUFFIX)] + WARM_SUFFIX)
            self._warm_fn = (jax.jit(load_exported(warm_path).call)
                             if warm_path.is_file() else None)
            self.warm_solver = ("fixed" if self._warm_fn is not None
                                else "adaptive")
            lin_path = art.with_name(
                art.name[: -len(ARTIFACT_SUFFIX)] + LINEAR_SUFFIX)
            if lin_path.is_file():
                self._lin_fn = jax.jit(load_exported(lin_path).call)
            else:
                self._lin_fn = None
            if dynamics is None and mp.dynamics_name:
                self.dynamics = make_dynamics(mp.dynamics_name,
                                              **mp.dynamics_kwargs)
            if self.dynamics is not None:
                self.problem = make_problem(mp, self.dynamics)
        else:
            # No artifact: rebuild from the dynamics registry (extension —
            # the reference requires the .so).
            if dynamics is None:
                if not mp.dynamics_name:
                    raise FileNotFoundError(
                        f"no artifact at {art} and no dynamics to rebuild from")
                dynamics = make_dynamics(mp.dynamics_name, **mp.dynamics_kwargs)
            self.dynamics = dynamics
            self.problem = make_problem(mp, dynamics)
            prob, opts = self.problem, self.opts

            self._solve_fn = jax.jit(
                lambda p, X0, U0, mu0: solve(prob, p, X0, U0, opts, mu0=mu0))
            from ..solver.select import resolve_warm_solver
            self.warm_solver = resolve_warm_solver(opts)
            if self.warm_solver == "fixed":
                from ..solver.fixed import solve_fixed
                k = opts.fixed_warm_iters
                self._warm_fn = jax.jit(
                    lambda p, X0, U0, mu0: solve_fixed(
                        prob, p, X0, U0, opts, mu0=mu0, n_iter=k))
            else:
                self._warm_fn = None
            dyn = dynamics
            self._lin_fn = jax.jit(highest_precision(
                lambda x, u: dyn.linearize(x, u)))

    def warmup(self) -> None:
        """Force compilation now (the reference's first cold solve hides in a
        100 ms sleep, ``thread_model_control_example.cpp:66-68``)."""
        res = self._solve_fn(self._p, self._X0, self._U0, self._mu_cold)
        jax.block_until_ready(res)
        if self._lin_fn is not None:
            jax.block_until_ready(self._lin_fn(
                jnp.zeros(self.params.num_x, self._dtype),
                jnp.zeros(self.params.num_u, self._dtype)))

    # -- runtime mutation (C10) ----------------------------------------------

    def set_state(self, t: float, x: Sequence[float], u: Sequence[float],
                  traj: np.ndarray) -> None:
        """Latest measurement + reference trajectory for the solver thread
        (``ModelControl.cpp:75-81``).  traj: (N, nx)."""
        with self._state_lock:
            self._t = float(t)
            self._x = np.asarray(x, float).copy()
            self._u = np.asarray(u, float).copy()
            self._traj = np.asarray(traj, float).reshape(
                self.params.num_shooting_nodes, self.params.num_x).copy()

    def update_weights(self, Q: Optional[Sequence[float]] = None,
                       R: Optional[Sequence[float]] = None,
                       Rm: Optional[Sequence[float]] = None) -> None:
        """(``ModelControl.cpp:199-203``) — weights are solver inputs."""
        with self._state_lock:
            p = self._p
            if Q is not None:
                p = p._replace(q=jnp.asarray(Q, self._dtype))
            if R is not None:
                p = p._replace(r=jnp.asarray(R, self._dtype))
            if Rm is not None:
                p = p._replace(rm=jnp.asarray(Rm, self._dtype))
            self._p = p
            # The cached warm start was optimal for the OLD weights; restart
            # the barrier continuation so the next solve re-centers.
            self._is_warm = False

    def update_control_limits(self, u_min: Sequence[float],
                              u_max: Sequence[float]) -> None:
        """(``ModelControl.cpp:205-209``).

        Resets the barrier to a cold start: warm-starting an interior-point
        solve across a feasible-set change is the classic IPM failure mode —
        the previous plan can sit outside (or hug) the new bounds, and a
        floor-level barrier gives Newton no centering, so the solve creeps
        or diverges and the runtime would serve the stale old-bounds plan."""
        with self._state_lock:
            self._p = self._p._replace(u_min=jnp.asarray(u_min, self._dtype),
                                       u_max=jnp.asarray(u_max, self._dtype))
            self._is_warm = False

    # -- the hot path (calc_u, ModelControl.cpp:116-172) ---------------------

    def calc_u(self, t: float, state: Sequence[float], control: Sequence[float],
               traj: np.ndarray) -> Plan:
        """One warm-started solve; returns (and installs) the new plan."""
        mp = self.params
        x0 = jnp.asarray(state, self._dtype)
        u0 = jnp.asarray(control, self._dtype)
        with self._state_lock:
            p = self._p
        p = p._replace(
            x_des=jnp.asarray(traj, self._dtype).reshape(
                mp.num_shooting_nodes, mp.num_x),
            x0=x0, u_prev=u0)
        if mp.is_linear:
            # Successive linearization (C8): freeze A, B, x_dot at the
            # measured point (ModelControl.cpp:125-135).
            A, B, xd0 = self._lin_fn(x0, u0)
            p = p._replace(lin=LinPoint(A, B, xd0, x0, u0))

        mu0 = self._mu_warm if self._is_warm else self._mu_cold
        # Latency-shaped warm hot path (opts.fixed_warm_iters): straight-line
        # fixed-iteration program once warm; adaptive solver when cold.
        fn = (self._warm_fn if (self._is_warm and self._warm_fn is not None)
              else self._solve_fn)
        t0 = time.perf_counter()
        res: SolveResult = fn(p, self._X0, self._U0, mu0)
        # One blocking device->host transfer for the whole result pytree
        # (round 1 did 5+ separate scalar pulls on this 1 kHz hot path).
        host = jax.device_get(res)
        dt = time.perf_counter() - t0

        ok = (int(host.status) != DIVERGED and
              bool(np.all(np.isfinite(host.X))) and
              bool(np.all(np.isfinite(host.U))))
        self.stats.record(dt, int(host.iters), ok)
        if not ok:
            # Stale-plan fallback (SURVEY.md §5 failure detection); serves
            # from here on are counted as stale until a solve succeeds.
            self._stale = True
            return self._plan
        self._stale = False

        self._X0, self._U0 = res.X, res.U  # warm start next solve (on device)
        self._is_warm = True
        times = t + np.arange(mp.num_shooting_nodes + 1) * mp.step_size
        plan = Plan(times=times, X=host.X, U=host.U,
                    iters=int(host.iters), status=int(host.status),
                    kkt=float(host.kkt), feas=float(host.feas),
                    obj=float(host.obj), solve_time_s=dt)
        self._plan = plan  # atomic swap
        if self._native is not None:
            self._native.publish(plan.times, plan.X, plan.U)
        return plan

    # -- async solver thread (C9, ModelControl.cpp:83-112) -------------------

    def start_calc(self) -> None:
        """Spawn the free-running solver thread: snapshot latest inputs,
        solve, swap the plan, repeat."""
        if self._calc_thread is not None and self._calc_thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                with self._state_lock:
                    t, x, u = self._t, self._x, self._u
                    traj = self._traj
                self.calc_u(t, x, u, traj)

        self._calc_thread = threading.Thread(target=loop, daemon=True,
                                             name=f"mpc-solver-{self.params.name}")
        self._calc_thread.start()

    def stop_calc(self, timeout: float = 5.0) -> None:
        """Join the solver thread (the reference destructor spin-waits,
        ``ModelControl.cpp:16-19``; we join with a timeout)."""
        self._stop.set()
        if self._calc_thread is not None:
            self._calc_thread.join(timeout)
            self._calc_thread = None

    # -- plan access (control thread side) -----------------------------------

    def control_at_time(self, t: float) -> np.ndarray:
        """(``ModelControl.cpp:192-197``) — safe before the first solve, and
        fallback serves are counted (stats.served_placeholder/_stale)."""
        plan = self._plan
        if plan.status == -1:
            self.stats.served_placeholder += 1
        elif self._stale:
            self.stats.served_stale += 1
        if self._native is not None:
            u = self._native.sample(t)
            if u is not None:
                return u
        return plan.control_at_time(t)

    def control_results(self) -> Plan:
        """The latest plan (``ModelControl.hpp:40``)."""
        return self._plan

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_calc()
        return False
