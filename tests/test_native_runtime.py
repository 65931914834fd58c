"""Native (C++) plan server tests: seqlock handoff correctness under
concurrent publishing, ZOH parity with the Python Plan, pacer behavior."""

import threading
import time

import numpy as np
import pytest

from mahi_mpc.runtime.native import (NativePacer, NativePlanServer,
                                         native_available)
from mahi_mpc.runtime.plan import Plan

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="g++ unavailable")


def test_zoh_parity_with_python_plan():
    nx, nu, N = 3, 2, 8
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.01, 0.1, N + 1))
    X = rng.standard_normal((N + 1, nx))
    U = rng.standard_normal((N, nu))
    plan = Plan(times=times, X=X, U=U)
    ps = NativePlanServer(nx, nu, N)
    ps.publish(times, X, U)
    for t in [times[0] - 1, times[0], (times[2] + times[3]) / 2,
              times[-1], times[-1] + 5]:
        np.testing.assert_allclose(ps.sample(t), plan.control_at_time(t))


def test_sample_before_publish_returns_none():
    ps = NativePlanServer(2, 1, 4)
    assert ps.sample(0.0) is None


def test_no_torn_reads_under_concurrent_publish():
    nx, nu, N = 2, 1, 5
    ps = NativePlanServer(nx, nu, N)
    times = np.arange(N + 1) * 0.1
    X = np.zeros((N + 1, nx))
    stop = threading.Event()

    def publisher():
        k = 0
        while not stop.is_set():
            # all-U-equal plans: a torn read would mix two values
            U = np.full((N, nu), float(k))
            ps.publish(times, X, U)
            k += 1

    th = threading.Thread(target=publisher)
    th.start()
    try:
        deadline = time.time() + 1.0
        while time.time() < deadline:
            u = ps.sample(0.25)
            if u is not None:
                assert u[0] == int(u[0]), f"torn read: {u}"
    finally:
        stop.set()
        th.join()
    assert ps.published_count > 100


def test_pacer_rate_and_stats():
    pc = NativePacer(0.002)  # 500 Hz
    t0 = time.perf_counter()
    for _ in range(100):
        pc.wait()
    el = time.perf_counter() - t0
    assert 0.18 <= el <= 0.4, el  # ~200 ms nominal, sandbox jitter allowed
    assert pc.misses <= 100


def test_model_control_with_native_server(tmp_path):
    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.runtime import ModelControl

    mp = ModelParameters("nat", num_x=2, num_u=1, step_size=0.02,
                         num_shooting_nodes=10, u_min=[-8.0], u_max=[8.0],
                         dynamics_name="pendulum")
    mc = ModelControl(mp, dynamics=make_dynamics("pendulum"),
                      Q=[20.0, 1.0], R=[0.5], Rm=[0.0],
                      opts=SolverOptions(tol=1e-4, max_iter=30),
                      use_native_server=True)
    mc.warmup()
    traj = np.tile([0.2, 0.0], (10, 1))
    plan = mc.calc_u(0.0, [0.5, 0.0], [0.0], traj)
    u_native = mc.control_at_time(0.01)
    np.testing.assert_allclose(u_native, plan.control_at_time(0.01))
