"""Trajectory-library generation tests (C16: the capability the reference's
WIP TrajectoryGenerator never finished)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mahi_mpc import SolverOptions, TrajectoryParameters
from mahi_mpc.models import make_dynamics
from mahi_mpc.models.integrators import make_step
from mahi_mpc.trajgen import (TrajectoryGenerator, load_waypoints_csv,
                                  read_library_csv, write_library_csv)


@pytest.fixture(scope="module")
def pend_gen():
    tp = TrajectoryParameters("lib", num_x=2, num_u=1, step_size=0.05,
                              num_shooting_nodes=30)
    dyn = make_dynamics("pendulum")
    return TrajectoryGenerator(tp, dyn, opts=SolverOptions(tol=1e-6, max_iter=80),
                               u_min=[-10.0], u_max=[10.0]), dyn


def test_point_to_point_endpoints_and_dynamics(pend_gen):
    gen, dyn = pend_gen
    wps = np.array([[0.0, 0.0], [0.8, 0.0], [-0.5, 0.0]])
    segs = gen.generate(wps)
    assert len(segs) == 2
    for i, seg in enumerate(segs):
        # endpoint equality to AL tolerance
        np.testing.assert_allclose(seg.X[0], wps[i], atol=1e-6)
        assert seg.endpoint_err < 1e-3, seg.endpoint_err
        # trajectory satisfies the discretized dynamics
        step = make_step(dyn.f, gen.mp.step_size, gen.mp.integrator)
        for k in range(0, seg.U.shape[0], 7):
            xn = np.asarray(step(jnp.asarray(seg.X[k]), jnp.asarray(seg.U[k])))
            np.testing.assert_allclose(xn, seg.X[k + 1], atol=1e-4)
        assert np.all(np.abs(seg.U) <= 10.0 + 1e-6)


def test_csv_roundtrip(tmp_path, pend_gen):
    gen, _ = pend_gen
    wp_csv = tmp_path / "wps.csv"
    wp_csv.write_text("q,qd\n0.0,0.0\n0.6,0.0\n")
    out_csv = tmp_path / "lib.csv"
    segs = gen.generate_from_csv(wp_csv, out_csv)
    assert out_csv.is_file()
    back = read_library_csv(out_csv, 2, 1)
    assert len(back) == len(segs) == 1
    np.testing.assert_allclose(back[0].X, segs[0].X, atol=1e-7)
    np.testing.assert_allclose(back[0].U, segs[0].U, atol=1e-7)


def test_min_effort_beats_naive(pend_gen):
    """The optimized segment should use less effort than bang-bang-ish
    alternatives; sanity: total |u| is finite and endpoints are at rest."""
    gen, _ = pend_gen
    segs = gen.generate(np.array([[0.0, 0.0], [0.4, 0.0]]))
    seg = segs[0]
    assert abs(seg.X[-1, 1]) < 1e-3  # arrives at rest
    assert np.abs(seg.U).mean() < 5.0
