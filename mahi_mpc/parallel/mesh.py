"""Device-mesh scenario-batch parallelism.

The reference runs exactly one MPC instance per process with zero distributed
execution (SURVEY.md §2.b); this framework's data-parallel axis is
the *scenario batch*: thousands of independent MPC instances (randomized
initial states / goals / weights) solved simultaneously, sharded over a
``jax.sharding.Mesh``.

Mesh layout (BASELINE.json north star):

- ``batch``: scenario instances — pure data parallelism, no collectives in
  the solve itself (each instance's Riccati recursion is independent); the
  interconnect only carries metrics reductions and initial scatter/final
  gather.
- ``time``: reserved for horizon (sequence-parallel) sharding of the
  parallel-scan Riccati backend for very long horizons (SURVEY.md §5
  long-context analog).

Everything is jit + NamedSharding: XLA inserts any needed collectives, and
the same program runs on 1 chip, 1 host, or a multi-host pod slice
unchanged.  The cards of one GPU host are joined all to all, so the mesh
follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import SolverOptions
from ..solver.sqp import SolveResult, solve
from ..transcribe.shooting import MPCParams, ShootingProblem

Array = jnp.ndarray


def make_mesh(n_batch: Optional[int] = None, n_time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(batch, time)`` mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_batch is None:
        n_batch = len(devices) // n_time
    assert n_batch * n_time <= len(devices), (
        f"mesh {n_batch}x{n_time} needs more than {len(devices)} devices")
    dev_array = np.asarray(devices[: n_batch * n_time]).reshape(n_batch, n_time)
    return Mesh(dev_array, axis_names=("batch", "time"))


def batch_spec(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays with a leading scenario-batch axis."""
    return NamedSharding(mesh, P("batch"))


def _pad_to_multiple(a: Array, m: int) -> Array:
    b = a.shape[0]
    pad = (-b) % m
    if pad == 0:
        return a
    # Repeat the last instance into the padding (keeps every padded instance
    # a well-posed problem, so no NaN pollution from zero-size boxes).
    fill = jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])
    return jnp.concatenate([a, fill], axis=0)


def shard_params(p_batch: MPCParams, mesh: Mesh) -> MPCParams:
    """Place a batched MPCParams pytree with the batch axis sharded.
    Batches not divisible by the mesh's batch axis are padded by repeating
    the last instance (callers slice results back with the original size).
    Multi-process safe: under a multi-host launch each process contributes
    the shards it owns (``jax.device_put`` only handles addressable
    devices)."""
    spec = batch_spec(mesh)
    nb = mesh.shape["batch"]
    if jax.process_count() > 1:
        def place(a):
            v = np.asarray(_pad_to_multiple(jnp.asarray(a), nb))
            return jax.make_array_from_callback(
                v.shape, spec, lambda idx: v[idx])
        return jax.tree.map(place, p_batch)
    return jax.tree.map(
        lambda a: jax.device_put(_pad_to_multiple(a, nb), spec), p_batch)


def make_sharded_solver(prob: ShootingProblem, mesh: Mesh,
                        opts: SolverOptions = SolverOptions(),
                        donate_warm_start: bool = True):
    """Compile the batched solve with scenario-batch sharding.

    Returns ``fn(p_batch, X0, U0) -> SolveResult`` where every leaf of the
    inputs/outputs carries a leading batch axis sharded over the mesh's
    ``batch`` axis.  Warm-start buffers are donated so the receding-horizon
    loop updates plans in place on-device (SURVEY.md §5 checkpoint/resume:
    warm-start buffers are device arrays donated between solves).

    Every solve, cold or warm (the mu0 argument decides), runs the lanes
    (or vmap) program below.
    """
    spec = batch_spec(mesh)

    # LTV mode is lanes-capable (batched affine einsums, solver/batched.py
    # _linearize_ltv); nonlinear mode needs lanes-polymorphic dynamics.
    use_lanes = prob.is_linear or prob.dynamics.supports_lanes

    def step(p_batch: MPCParams, X0: Array, U0: Array,
             mu0: Array = None) -> SolveResult:
        if use_lanes:
            from ..solver.batched import solve_batch_lanes
            return solve_batch_lanes(prob, p_batch, X0, U0, opts, mu0=mu0)
        return jax.vmap(lambda p, x, u: solve(prob, p, x, u, opts, mu0=mu0))(
            p_batch, X0, U0)

    in_shardings = (jax.tree.map(lambda _: spec, _params_struct(prob)),
                    spec, spec, None)
    out_shardings = jax.tree.map(lambda _: spec, _result_struct())
    jitted = jax.jit(step,
                     in_shardings=in_shardings,
                     out_shardings=out_shardings,
                     donate_argnums=(1, 2) if donate_warm_start else ())
    nb = mesh.shape["batch"]

    def run(p_batch: MPCParams, X0: Array, U0: Array,
            mu0: Array = None) -> SolveResult:
        if mu0 is None:
            import jax.numpy as jnp
            mu0 = jnp.asarray(opts.mu_init, jnp.dtype(opts.dtype))
        b = X0.shape[0]
        if b % nb:
            # Under a multi-process launch the inputs are global arrays with
            # non-addressable shards; eager padding cannot touch them.  Pad
            # on the host before building global arrays (shard_params does)
            # or keep the batch divisible by the mesh's batch axis.
            assert jax.process_count() == 1, (
                f"multi-process batch {b} must be divisible by the mesh "
                f"batch axis {nb}; pad on the host before sharding")
            p_batch = jax.tree.map(lambda a: _pad_to_multiple(a, nb), p_batch)
            X0 = _pad_to_multiple(X0, nb)
            U0 = _pad_to_multiple(U0, nb)
            res = jitted(p_batch, X0, U0, mu0)
            return jax.tree.map(lambda a: a[:b], res)
        return jitted(p_batch, X0, U0, mu0)

    return run


def _params_struct(prob):
    # Placeholder pytree with the same structure as MPCParams for tree_map
    # (field-agnostic so schema extensions don't break it).
    from ..transcribe.shooting import LinPoint
    fields = {f: 0 for f in MPCParams._fields}
    fields["lin"] = LinPoint(*([0] * len(LinPoint._fields)))
    return MPCParams(**fields)


def _result_struct():
    return SolveResult(X=0, U=0, iters=0, status=0, kkt=0, feas=0, obj=0)


def scaling_report(prob: ShootingProblem, p_batch: MPCParams,
                   mesh: Mesh, opts: SolverOptions = SolverOptions(),
                   iters: int = 3) -> dict:
    """Measure batched solves/s on this mesh (the BASELINE.json metric).

    Times ``make_sharded_solver``'s program under the *bench.py warm
    regime* (per-instance state perturbations + a phase-shifting sinusoid
    reference), not an unperturbed re-solve whose mean_iters collapses to
    1."""
    import time

    n = jax.tree.leaves(p_batch)[0].shape[0]
    dtype = jnp.dtype(opts.dtype)
    X0 = jnp.zeros((n, prob.N + 1, prob.nx), dtype)
    U0 = jnp.zeros((n, prob.N, prob.nu), dtype)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    spec = batch_spec(mesh)

    def place(a):
        a = np.asarray(a, dtype)
        if jax.process_count() > 1:
            return jax.make_array_from_callback(
                a.shape, spec, lambda idx: a[idx])
        return jax.device_put(jnp.asarray(a), spec)

    p_batch = shard_params(p_batch, mesh)
    n_p = p_batch.x0.shape[0]   # shard_params may have padded the batch

    # Warm-regime schedule (same definition as bench.py): pregenerated
    # per-instance/per-coordinate x0 noise and a shifting sinusoid
    # reference, placed with the batch sharding.
    rng = np.random.default_rng(0)
    n_sched = max(iters, 3) + 3
    perts = [place(0.01 * rng.standard_normal((n_p, prob.nx)))
             for _ in range(n_sched)]
    tgrid = np.arange(1, prob.N + 1) * prob.dt
    ph = rng.uniform(0, 2 * np.pi, (n_p, 1, 1))
    amp = 0.2 * rng.standard_normal((n_p, 1, prob.nx))
    refs = [place(amp * np.sin(
        2 * np.pi * (tgrid[None, :, None] + r * prob.dt) + ph))
            for r in range(n_sched)]
    if jax.process_count() > 1:
        Zx = np.zeros(X0.shape, dtype)
        Zu = np.zeros(U0.shape, dtype)
        X0 = jax.make_array_from_callback(Zx.shape, spec, lambda idx: Zx[idx])
        U0 = jax.make_array_from_callback(Zu.shape, spec, lambda idx: Zu[idx])
    res = fn(p_batch, X0, U0)
    jax.block_until_ready(res)  # compile + cold seed
    mu_warm = jnp.asarray(
        max(opts.warm_mu_factor * opts.tol, opts.mu_min), dtype)

    def step_i(i, r):
        pp = p_batch._replace(x0=p_batch.x0 + perts[i % n_sched],
                              x_des=refs[i % n_sched])
        return fn(pp, r.X, r.U, mu_warm)

    # Warm the warm-mu path: the first call after the cold seed can
    # re-trace (the warm-start operands change committed layout/sharding
    # from the zero-filled seeds to solver outputs), and a recompile inside
    # the timed region would swamp the solve.
    for i in range(3):
        res = jax.block_until_ready(step_i(i, res))
    t0 = time.perf_counter()
    for i in range(iters):
        res = step_i(i, res)
    jax.block_until_ready(res)
    dt = (time.perf_counter() - t0) / iters
    # Replicated reductions so the scalars are addressable from every
    # process under a multi-host launch.
    rep = NamedSharding(mesh, P())
    reduce = jax.jit(
        lambda it, st: (jnp.mean(it.astype(jnp.float32)),
                        jnp.mean((st == 0).astype(jnp.float32))),
        out_shardings=(rep, rep))
    mean_iters, conv = reduce(res.iters, res.status)
    return {
        "batch": n,
        "devices": mesh.devices.size,
        "wall_s_per_solve_batch": dt,
        "solves_per_s": n / dt,
        "solves_per_s_per_device": n / dt / mesh.devices.size,
        "mean_iters": float(mean_iters),
        "converged_frac": float(conv),
    }
