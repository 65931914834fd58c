"""Runtime layer tests: generate→persist→load→control (C9-C15 parity).

Covers the reference's two-process contract (SURVEY.md §3.1-3.4): offline
``ModelGenerator`` writes ``<name>.json`` + compiled artifact; online
``ModelControl`` loads them by name, runs warm-started solves, serves
``control_at_time`` from a background solver thread.
"""

import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.models.integrators import rk4_step
from mahi_mpc.runtime import ModelControl, ModelGenerator, generate_model
from mahi_mpc.runtime.plan import Plan, empty_plan


def _pendulum_params(name, tmpdir=None, **kw):
    return ModelParameters(
        name, num_x=2, num_u=1, step_size=0.02, num_shooting_nodes=20,
        u_min=[-8.0], u_max=[8.0], dynamics_name="pendulum", **kw)


def _sin_traj(mp, t):
    tt = t + (1 + np.arange(mp.num_shooting_nodes)) * mp.step_size
    return np.stack([0.3 * np.sin(tt), 0.3 * np.cos(tt)], axis=1)


def test_generate_persist_load_roundtrip(tmp_path):
    """model_generate flow (SURVEY §3.1): artifact + JSON on disk, then
    ModelControl loads by name with NO dynamics object in scope."""
    mp = _pendulum_params("gen_rt")
    art = generate_model(mp, directory=tmp_path,
                         opts=SolverOptions(tol=1e-5, max_iter=40))
    assert art.is_file()
    assert (tmp_path / "gen_rt.json").is_file()
    assert (tmp_path / "gen_rt_linear.mpcx").is_file()

    mc = ModelControl("gen_rt", directory=tmp_path,
                      Q=[20.0, 1.0], R=[0.5], Rm=[0.0])
    mc.warmup()
    plan = mc.calc_u(0.0, [0.4, 0.0], [0.0], _sin_traj(mp, 0.0))
    assert plan.status == 0, (plan.status, plan.kkt, plan.feas)
    assert plan.U.shape == (20, 1)
    assert np.all(np.abs(plan.U) <= 8.0 + 1e-6)


def test_warm_start_speeds_up_and_plan_is_tracked(tmp_path):
    mp = _pendulum_params("warm_rt")
    dyn = make_dynamics("pendulum")
    mc = ModelControl(mp, dynamics=dyn, Q=[20.0, 1.0], R=[0.5], Rm=[0.0],
                      opts=SolverOptions(tol=1e-5, max_iter=60))
    mc.warmup()
    plant = rk4_step(dyn.f, mp.step_size)
    x = jnp.array([0.5, 0.0])
    u = np.zeros(1)
    it0 = None
    for k in range(40):
        t = k * mp.step_size
        plan = mc.calc_u(t, np.asarray(x), u, _sin_traj(mp, t))
        if it0 is None:
            it0 = plan.iters
        u = plan.control_at_time(t)
        x = plant(x, jnp.asarray(u))
    assert plan.iters <= it0  # warm starts don't get worse
    # closed loop converged onto the reference
    assert abs(float(x[0]) - 0.3 * np.sin(t)) < 0.1
    s = mc.stats.summary()
    assert s["solves"] == 40 and s["failures"] == 0


def test_control_at_time_zoh_and_empty_plan():
    plan = Plan(times=np.array([0.0, 0.1, 0.2]),
                X=np.zeros((3, 2)),
                U=np.array([[1.0], [2.0]]))
    assert plan.control_at_time(-5.0) == 1.0   # clamped low
    assert plan.control_at_time(0.05) == 1.0
    assert plan.control_at_time(0.15) == 2.0
    assert plan.control_at_time(9.0) == 2.0    # clamped high
    # pre-first-solve lookup is safe (the reference UB, ModelControl.cpp:195)
    ep = empty_plan(2, 1, u_fallback=np.array([0.7]))
    assert ep.control_at_time(0.0) == 0.7


def test_async_solver_thread(tmp_path):
    """C9: solver thread free-runs while the 'control thread' (this test)
    reads control_at_time."""
    mp = _pendulum_params("async_rt")
    dyn = make_dynamics("pendulum")
    mc = ModelControl(mp, dynamics=dyn, Q=[20.0, 1.0], R=[0.5], Rm=[0.0],
                      opts=SolverOptions(tol=1e-5, max_iter=40))
    mc.warmup()
    plant = rk4_step(dyn.f, mp.step_size)
    x = jnp.array([0.5, 0.0])
    u = np.zeros(1)
    mc.set_state(0.0, np.asarray(x), u, _sin_traj(mp, 0.0))
    mc.start_calc()
    try:
        deadline = time.time() + 5.0
        while mc.control_results().status == -1 and time.time() < deadline:
            time.sleep(0.01)
        assert mc.control_results().status != -1, "no solve completed in 5s"
        for k in range(50):
            t = k * mp.step_size
            u = mc.control_at_time(t)
            x = plant(x, jnp.asarray(u))
            mc.set_state(t + mp.step_size, np.asarray(x), u, _sin_traj(mp, t))
            time.sleep(0.002)
    finally:
        mc.stop_calc()
    summ = mc.stats.summary()
    assert summ["solves"] > 5
    assert abs(float(x[0]) - 0.3 * np.sin(t)) < 0.25
    # Steady state never serves a placeholder or stale plan (fallback serves
    # are observable and zero here — all 50 control_at_time calls above came
    # after the first successful solve).
    assert summ["served_placeholder"] == 0, summ
    assert summ["served_stale"] == 0, summ


def test_fallback_serves_are_counted():
    """Pre-first-solve lookups increment served_placeholder (the observable
    replacement for the reference's UB at ModelControl.cpp:195-196)."""
    mp = _pendulum_params("fb_rt")
    mc = ModelControl(mp, dynamics=make_dynamics("pendulum"),
                      opts=SolverOptions(tol=1e-5, max_iter=40))
    u = mc.control_at_time(0.0)
    assert u.shape == (1,)
    mc.control_at_time(0.001)
    assert mc.stats.summary()["served_placeholder"] == 2
    assert mc.stats.summary()["served_stale"] == 0


def test_update_weights_and_limits_no_recompile(tmp_path):
    """C10: weight/limit updates are inputs — same compiled program."""
    mp = _pendulum_params("upd_rt")
    dyn = make_dynamics("pendulum")
    mc = ModelControl(mp, dynamics=dyn, Q=[20.0, 1.0], R=[0.5], Rm=[0.0],
                      opts=SolverOptions(tol=1e-5, max_iter=40))
    mc.warmup()
    traj = _sin_traj(mp, 0.0)
    p1 = mc.calc_u(0.0, [0.5, 0.0], [0.0], traj)
    mc.update_weights(Q=[200.0, 1.0])
    mc.update_control_limits([-2.0], [2.0])
    p2 = mc.calc_u(0.0, [0.5, 0.0], [0.0], traj)
    assert np.all(np.abs(p2.U) <= 2.0 + 1e-6)
    # tighter tracking weight changes the plan
    assert not np.allclose(p1.U, p2.U)


def test_linear_mode_runtime(tmp_path):
    """C8 through the runtime: LTV model generated, persisted, controlled."""
    mp = ModelParameters(
        "lin_rt", num_x=2, num_u=1, step_size=0.02, num_shooting_nodes=15,
        is_linear=True, dynamics_name="pendulum")
    generate_model(mp, directory=tmp_path,
                   opts=SolverOptions(tol=1e-5, max_iter=30))
    mc = ModelControl("lin_rt", directory=tmp_path, Q=[20.0, 1.0], R=[0.5],
                      Rm=[0.0])
    mc.warmup()
    tt = (1 + np.arange(15)) * mp.step_size
    traj = np.stack([0.1 * np.sin(tt), 0.1 * np.cos(tt)], axis=1)
    plan = mc.calc_u(0.0, [0.05, 0.0], [0.1], traj)
    assert plan.status == 0
    assert plan.iters <= 5  # LTV + quadratic cost ≈ one Newton step


def test_fixed_warm_runtime_roundtrip(tmp_path):
    """fixed_warm_iters: the generator exports a straight-line warm program
    (<name>_warm.mpcx), the runtime loads it and uses it for warm re-solves."""
    from mahi_mpc.runtime.generate import WARM_SUFFIX, generate_model

    mp = _pendulum_params("fixed_rt")
    opts = SolverOptions(tol=1e-5, max_iter=40, fixed_warm_iters=3)
    art = generate_model(mp, make_dynamics("pendulum"), tmp_path, opts)
    assert (tmp_path / f"{mp.name}{WARM_SUFFIX}").is_file()

    mc = ModelControl("fixed_rt", directory=tmp_path, opts=opts)
    assert mc._warm_fn is not None
    traj = _sin_traj(mp, 0.0)
    p1 = mc.calc_u(0.0, [0.5, 0.0], [0.0], traj)      # cold: adaptive
    p2 = mc.calc_u(0.002, [0.5, 0.01], [0.0], traj)   # warm: fixed program
    assert p2.iters == 3
    assert p1.status in (0, 1) and p2.status in (0, 1)
    # warm plan continues the cold plan smoothly
    assert np.max(np.abs(p2.U - p1.U)) < 1.0
