"""Head-control pinning (working version of the reference's
``m_num_control_inputs_saved``, a no-op there: ``ModelControl.cpp:165-171``,
``ModelControl.hpp:79``).  With ``num_control_inputs_saved=k`` the first k
controls must stay exactly at their warm-start values while the rest
re-optimize."""

import numpy as np
import jax.numpy as jnp

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_double_pendulum
from mahi_mpc.solver import CONVERGED, solve
from mahi_mpc.solver.batched import solve_batch_lanes
from mahi_mpc.transcribe.shooting import default_params, make_problem


def _setup():
    mp = ModelParameters("pin", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=12,
                         u_min=[-8.0, -8.0], u_max=[8.0, 8.0])
    prob = make_problem(mp, make_double_pendulum())
    p = default_params(mp, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0]),
                   r=jnp.array([5.0, 5.0]), rm=jnp.array([0.1, 0.1]),
                   x_des=jnp.asarray(0.3 * rng.standard_normal((12, 4))),
                   x0=jnp.array([0.2, -0.1, 0.0, 0.0]))
    return prob, p


def test_pinned_head_controls_stay_fixed():
    prob, p = _setup()
    U0 = jnp.asarray(np.full((12, 2), 0.7))
    opts_pin = SolverOptions(tol=1e-8, max_iter=60,
                             num_control_inputs_saved=3)
    res = solve(prob, p, U0=U0, opts=opts_pin)
    assert int(res.status) == CONVERGED, (res.status, res.kkt)
    # First 3 controls exactly at the warm-start values; the rest moved.
    np.testing.assert_allclose(np.asarray(res.U[:3]), 0.7, atol=1e-12)
    assert np.all(np.abs(np.asarray(res.U[3:]) - 0.7) > 1e-6)

    # And the unpinned solve disagrees on the head controls.
    free = solve(prob, p, U0=U0, opts=SolverOptions(tol=1e-8, max_iter=60))
    assert np.max(np.abs(np.asarray(free.U[:3]) - 0.7)) > 1e-3


def test_pinned_lanes_batch_matches_single():
    prob, p = _setup()
    B = 4
    rng = np.random.default_rng(5)
    p_b = jnp.broadcast_to  # noqa: E731 (readability below)
    import jax
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(x0=jnp.asarray(0.2 * rng.standard_normal((B, 4))))
    U0 = jnp.asarray(0.3 * rng.standard_normal((B, 12, 2)))
    X0 = jnp.zeros((B, 13, 4))
    opts = SolverOptions(tol=1e-7, max_iter=50, num_control_inputs_saved=2)
    res = solve_batch_lanes(prob, pb, X0, U0, opts)
    single = jax.vmap(lambda p_, x_, u_: solve(prob, p_, x_, u_, opts))(
        pb, X0, U0)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(single.U),
                               atol=1e-6, rtol=1e-6)
    # Pinned values survive the interior clip (they are interior here).
    np.testing.assert_allclose(np.asarray(res.U[:, :2]),
                               np.asarray(U0[:, :2]), atol=1e-12)
