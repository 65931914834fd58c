"""``solve_fixed`` (the runtime's straight-line warm program) against the
adaptive warm re-solve on every registered model family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mahi_mpc import SolverOptions
from mahi_mpc.solver import CONVERGED, solve, solve_fixed

from test_model_lanes_parity import MODELS, model_batch


@pytest.mark.parametrize("model,ulim,dt", MODELS,
                         ids=[m[0] for m in MODELS])
def test_fixed_matches_adaptive_warm(model, ulim, dt):
    prob, pb = model_batch(model, ulim, dt, B=1)
    p = jax.tree.map(lambda a: a[0], pb)
    opts = SolverOptions(tol=1e-4, max_iter=40, dtype="float32")
    cold = jax.jit(lambda pp: solve(prob, pp, None, None, opts))(p)
    assert int(cold.status) == CONVERGED
    p2 = p._replace(x0=p.x0 + jnp.float32(0.01))
    mu_w = jnp.float32(opts.warm_mu_factor * opts.tol)
    ref = jax.jit(lambda pp, X, U: solve(prob, pp, X, U, opts, mu0=mu_w))(
        p2, cold.X, cold.U)
    got = jax.jit(lambda pp, X, U: solve_fixed(
        prob, pp, X, U, opts, mu0=mu_w, n_iter=3))(p2, cold.X, cold.U)
    assert int(ref.status) == CONVERGED
    assert int(got.status) == CONVERGED, (got.kkt, got.feas)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               atol=1e-3, rtol=1e-3)
