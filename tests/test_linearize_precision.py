"""The runtime's jitted ``linearize`` programs trace at full float32 matmul
precision, like the solver: on a GPU a default-precision float32 product may
run in TF32."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models.base import Dynamics
from mahi_mpc.runtime import BatchModelControl, ModelControl, ModelGenerator

NX, NU = 4, 2
_rng = np.random.default_rng(0)
_M = _rng.standard_normal((NX, NX)).astype(np.float32)
_B = _rng.standard_normal((NX, NU)).astype(np.float32)


def _dyn():
    """Dynamics with real matrix products, so its Jacobians lower to
    dot_general (the built-in models are elementwise)."""
    return Dynamics("matmul_test", nx=NX, nu=NU,
                    f=lambda x, u: jnp.tanh(_M @ x) + _B @ u)


def _params(is_linear):
    return ModelParameters("lin_prec", num_x=NX, num_u=NU, step_size=0.01,
                           num_shooting_nodes=4, is_linear=is_linear)


def _lin_generate():
    gen = ModelGenerator(_params(False), _dyn(), SolverOptions())
    return gen.lin_fn


def _lin_control():
    return ModelControl(_params(False), dynamics=_dyn())._lin_fn


def _lin_batch_service():
    svc = BatchModelControl(_params(True), batch=2, dynamics=_dyn())
    return svc._relin


def _assert_highest(text):
    dots = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    assert dots, "expected matrix products in the lowered program"
    for line in dots:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", line), line


@pytest.mark.parametrize("make,batched", [
    (_lin_generate, False), (_lin_control, False),
    (_lin_batch_service, True)],
    ids=["generate", "control", "batch_service"])
def test_linearize_jit_traces_at_highest(make, batched):
    fn = make()
    shape = (2,) if batched else ()
    x = jax.ShapeDtypeStruct(shape + (NX,), jnp.float32)
    u = jax.ShapeDtypeStruct(shape + (NU,), jnp.float32)
    _assert_highest(fn.lower(x, u).as_text())
    if make is _lin_generate:
        # ...and the exported artifact keeps it.
        exp = jax.export.export(fn, platforms=("cpu", "cuda"))(x, u)
        _assert_highest(exp.mlir_module())
