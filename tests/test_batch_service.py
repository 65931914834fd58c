"""Batched scenario MPC service tests (config #5): closed-loop batch of
randomized instances on the virtual mesh, failure isolation, checkpoint."""

import numpy as np
import jax
import jax.numpy as jnp

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.models.integrators import rk4_step
from mahi_mpc.runtime import BatchModelControl


def _service(B=16, N=20):
    mp = ModelParameters("bsvc", num_x=2, num_u=1, step_size=0.05,
                         num_shooting_nodes=N, u_min=[-8.0], u_max=[8.0],
                         dynamics_name="pendulum")
    svc = BatchModelControl(mp, batch=B,
                            opts=SolverOptions(tol=1e-4, max_iter=40),
                            Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    return mp, svc


def test_batch_closed_loop_converges():
    B = 16
    mp, svc = _service(B)
    dyn = make_dynamics("pendulum")
    plant = jax.jit(jax.vmap(rk4_step(dyn.f, mp.step_size)))
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (B, 2))
    goals = rng.uniform(-0.6, 0.6, B)
    x_des = np.zeros((B, mp.num_shooting_nodes, 2))
    x_des[:, :, 0] = goals[:, None]
    svc.set_references(x_des)
    for k in range(200):
        svc.set_states(x)
        u = svc.step()
        x = np.asarray(plant(jnp.asarray(x), jnp.asarray(u)))
    m = svc.metrics()
    assert m["converged_frac"] > 0.9, m
    # every instance regulated to its own goal
    err = np.abs(x[:, 0] - goals)
    assert np.max(err) < 0.15, (err.max(), err)


def test_failure_isolation_nan_instance():
    """A poisoned instance (NaN state) must not corrupt the others."""
    B = 8
    mp, svc = _service(B)
    x = np.zeros((B, 2))
    x[3] = np.nan  # poison instance 3
    x_des = np.zeros((B, mp.num_shooting_nodes, 2))
    x_des[:, :, 0] = 0.3
    svc.set_references(x_des)
    svc.set_states(x)
    u = svc.step()
    assert np.all(np.isfinite(u)), u
    # healthy instances still solve
    ok = np.asarray(svc.last.status) == 0
    assert ok[[0, 1, 2, 4, 5, 6, 7]].all()
    # next step with healthy states recovers instance 3
    x[3] = 0.0
    svc.set_states(x)
    u = svc.step()
    assert np.all(np.isfinite(u))


def test_checkpoint_roundtrip():
    B = 4
    mp, svc = _service(B)
    x = np.full((B, 2), 0.2)
    x_des = np.zeros((B, mp.num_shooting_nodes, 2))
    svc.set_references(x_des)
    svc.set_states(x)
    svc.step()
    st = svc.state_dict()

    mp2, svc2 = _service(B)
    svc2.load_state(st)
    u_a = svc.step()
    u_b = svc2.step()
    np.testing.assert_allclose(u_a, u_b, atol=1e-6)
