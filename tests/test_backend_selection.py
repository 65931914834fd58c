"""Solver and KKT backend resolution, the compile-cache helper, and the AOT
export platforms: the decisions that used to depend on the device."""

import os

import jax
import numpy as np
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.runtime import ModelControl
from mahi_mpc.runtime.generate import (EXPORT_PLATFORMS, generate_model,
                                       load_exported)
from mahi_mpc.solver.riccati import resolve_kkt_backend
from mahi_mpc.solver.select import resolve_warm_solver
from mahi_mpc.utils import cache


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("warm_solver,iters,expected", [
    ("auto", 0, "adaptive"), ("auto", 3, "fixed"),
    ("fixed", 3, "fixed"), ("adaptive", 3, "adaptive"),
])
def test_warm_solver_resolution(monkeypatch, backend, warm_solver, iters,
                                expected):
    """One decision, the same on every device."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    opts = SolverOptions(warm_solver=warm_solver, fixed_warm_iters=iters)
    assert resolve_warm_solver(opts) == expected


@pytest.mark.parametrize("resolve,value", [
    (lambda v: resolve_warm_solver(SolverOptions(warm_solver=v)), "fused"),
    (resolve_kkt_backend, "pallas"),
], ids=["warm_solver-fused", "kkt-pallas"])
def test_removed_backends_raise(resolve, value):
    with pytest.raises(ValueError, match=value):
        resolve(value)


def test_kkt_backend_resolution():
    assert resolve_kkt_backend("auto") == "riccati"
    for b in ("riccati", "dense", "pariccati", "time_shard"):
        assert resolve_kkt_backend(b) == b


def test_cache_helper_yields_to_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env"))
    assert cache.enable_compile_cache(tmp_path / "mine") == str(
        tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_helper_default_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    before_min = jax.config.jax_persistent_cache_min_compile_time_secs
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    try:
        assert cache.enable_compile_cache(tmp_path) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before_min)
    assert cache.DEFAULT_DIR.parent == cache.Path(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_export_platforms_name_cuda():
    assert EXPORT_PLATFORMS == ("cpu", "cuda")


def test_artifact_carries_both_lowerings_and_reloads(tmp_path, monkeypatch):
    """An artifact generated here carries a CUDA lowering beside the CPU
    one, and reloads and solves on the CPU — without JAX's flatbuffers
    serializer, which GPU hosts need not have."""
    import sys
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    dyn = make_dynamics("pendulum")
    mp = ModelParameters("art", num_x=2, num_u=1, step_size=0.02,
                         num_shooting_nodes=6, u_min=[-6.0], u_max=[6.0],
                         dynamics_name="pendulum")
    opts = SolverOptions(tol=1e-4, max_iter=30, fixed_warm_iters=3)
    art = generate_model(mp, dyn, tmp_path, opts)
    for path in (art, tmp_path / "art_linear.mpcx",
                 tmp_path / "art_warm.mpcx"):
        exp = load_exported(path)
        assert tuple(exp.platforms) == ("cpu", "cuda"), path
    mc = ModelControl("art", directory=tmp_path, opts=opts)
    traj = np.zeros((6, 2))
    traj[:, 0] = 0.3
    p1 = mc.calc_u(0.0, [0.0, 0.0], [0.0], traj)
    p2 = mc.calc_u(0.02, [0.01, 0.0], [0.0], traj)
    assert p1.status == 0 and p2.status in (0, 1)
    assert mc.warm_solver == "fixed" and p2.iters == 3
    assert np.all(np.abs(p2.U) <= 6.0 + 1e-5)


@pytest.mark.parametrize("header", [
    b"mahi_mpc artifact; jax 0.0.0\n", b""], ids=["other-jax", "no-header"])
def test_load_exported_checks_header_before_unpickling(tmp_path, header):
    """An artifact from another JAX version (or no artifact at all) is
    refused from its header; the body is never unpickled."""
    path = tmp_path / "m.mpcx"
    path.write_bytes(header + b"not a pickle")
    with pytest.raises(ValueError, match="generate the model again"):
        load_exported(path)


@pytest.mark.parametrize("warm_solver", ["fixed", "auto"])
def test_batch_service_refuses_fixed_warm_solver(warm_solver):
    """The fleet serves the adaptive program only; asking it for the fixed
    warm program is an error, not a silent substitution."""
    from mahi_mpc.runtime import BatchModelControl
    mp = ModelParameters("bfix", num_x=2, num_u=1, step_size=0.02,
                         num_shooting_nodes=6, u_min=[-6.0], u_max=[6.0],
                         dynamics_name="pendulum")
    opts = SolverOptions(warm_solver=warm_solver, fixed_warm_iters=3)
    with pytest.raises(ValueError, match="adaptive program only"):
        BatchModelControl(mp, 4, opts=opts)
    assert BatchModelControl(mp, 4).warm_solver == "adaptive"
