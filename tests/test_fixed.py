"""solve_fixed (latency-shaped, no data-dependent control flow) vs solve."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.solver import CONVERGED, solve, solve_fixed
from mahi_mpc.transcribe.shooting import default_params, make_problem


def _setup():
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("fx", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
                         num_shooting_nodes=25,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    p = default_params(mp, dtype=jnp.float32)
    p = p._replace(
        q=jnp.asarray([10.0] * 4 + [1.0] * 4, jnp.float32),
        r=jnp.full((4,), 0.5, jnp.float32),
        rm=jnp.full((4,), 0.01, jnp.float32),
        x0=jnp.asarray(0.2 * rng.standard_normal(8), jnp.float32),
        x_des=jnp.asarray(0.2 * rng.standard_normal((25, 8)), jnp.float32))
    return prob, p


@pytest.mark.slow
def test_fixed_warm_matches_adaptive():
    """Warm-started solve_fixed(n_iter=3) reproduces the steady-state warm
    solve of the adaptive path on the flagship problem."""
    prob, p = _setup()
    opts = SolverOptions(tol=1e-4, max_iter=12)
    cold = solve(prob, p, opts=opts)
    assert int(cold.status) == CONVERGED

    # Perturb the measured state (receding-horizon regime), warm re-solve.
    p2 = p._replace(x0=p.x0 + jnp.float32(0.01))
    mu_w = jnp.float32(opts.warm_mu_factor * opts.tol)
    ref = solve(prob, p2, cold.X, cold.U, opts, mu0=mu_w)
    got = solve_fixed(prob, p2, cold.X, cold.U, opts, mu0=mu_w, n_iter=3)

    assert int(ref.status) == CONVERGED
    assert int(got.status) == CONVERGED, (got.kkt, got.feas)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.slow
def test_fixed_program_has_no_while_loops():
    """The whole point: the lowered program is straight-line (no While ops),
    so dispatch latency is one round, not iters x linesearch rounds."""
    prob, p = _setup()
    opts = SolverOptions(tol=1e-4, max_iter=12)
    fn = jax.jit(lambda pp, X, U: solve_fixed(
        prob, pp, X, U, opts, n_iter=3))
    X0 = jnp.zeros((prob.N + 1, prob.nx), jnp.float32)
    U0 = jnp.zeros((prob.N, prob.nu), jnp.float32)
    hlo = fn.lower(p, X0, U0).as_text()
    assert "while" not in hlo.lower(), "solve_fixed lowered with a While op"
