"""The lanes-batched solver against the plain single-instance ``solve`` on
every registered model family (the batched service's program on each)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.solver import CONVERGED, solve
from mahi_mpc.solver.batched import solve_batch_lanes
from mahi_mpc.transcribe.shooting import default_params, make_problem

# (model, symmetric torque bound, step size)
MODELS = [("pendulum", 6.0, 0.02), ("cartpole", 10.0, 0.02),
          ("double_pendulum", 40.0, 0.01), ("two_link_arm", 40.0, 0.01),
          ("mahi_arm", 20.0, 0.002)]


def model_batch(model, ulim, dt, B=3, N=8, seed=0):
    dyn = make_dynamics(model)
    mp = ModelParameters("t", num_x=dyn.nx, num_u=dyn.nu, step_size=dt,
                         num_shooting_nodes=N, u_min=[-ulim] * dyn.nu,
                         u_max=[ulim] * dyn.nu, dynamics_name=model)
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(seed)
    p = default_params(mp, dtype=jnp.float32)
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, dyn.nx)), jnp.float32),
        x_des=jnp.asarray(0.1 * rng.standard_normal((B, N, dyn.nx)),
                          jnp.float32))
    return prob, pb


@pytest.mark.parametrize("model,ulim,dt", MODELS,
                         ids=[m[0] for m in MODELS])
def test_lanes_matches_plain_solve(model, ulim, dt):
    prob, pb = model_batch(model, ulim, dt)
    opts = SolverOptions(tol=1e-4, max_iter=40, dtype="float32")
    got = jax.jit(lambda p: solve_batch_lanes(prob, p, None, None, opts))(pb)
    ref = jax.jit(jax.vmap(lambda p: solve(prob, p, None, None, opts)))(pb)
    assert np.all(np.asarray(ref.status) == CONVERGED), ref.status
    assert np.all(np.asarray(got.status) == CONVERGED), got.status
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(ref.iters))
