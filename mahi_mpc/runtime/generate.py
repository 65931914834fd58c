"""Offline model generation: build → AOT-compile → persist.

Equivalent of the reference's ``ModelGenerator`` pipeline
(``src/Mahi/Mpc/ModelGenerator.cpp:23-270``): where the reference builds a
CasADi NLP, generates C for all solver callbacks, shells out to
``gcc -fPIC -shared`` and writes ``<name>.so`` + ``<name>.json``
(``:235-270``), we trace the whole warm-started SQP solve with JAX, AOT-export
it to a StableHLO artifact (``<name>.mpcx``), export the linearization
functions (the reference's ``<name>_linear_functions.so``, ``:241-251``) to
``<name>_linear.mpcx``, and write the same JSON schema.

An artifact is the pickled ``jax.export.Exported`` (StableHLO plus its
calling signature) behind a header line naming the JAX version that made
it: JAX's own ``Exported.serialize`` needs the ``flatbuffers`` package,
which GPU hosts need not have.  Like the reference's ``.so``, an artifact
is trusted code for one JAX version; loading reads the header and refuses
another version before it unpickles anything.

``ModelControl`` then loads the artifact without re-tracing any Python —
the analog of nlpsol-from-dll (``ModelControl.cpp:62``).
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp

from ..models.base import Dynamics, make_dynamics
from ..ops.precision import highest_precision
from ..params import ModelParameters, SolverOptions
from ..solver.sqp import solve
from ..transcribe.shooting import MPCParams, ShootingProblem, default_params, make_problem

ARTIFACT_SUFFIX = ".mpcx"
LINEAR_SUFFIX = "_linear.mpcx"
WARM_SUFFIX = "_warm.mpcx"
# Every artifact carries a CPU and a CUDA lowering, wherever it is generated,
# so it moves between a dev box and a GPU host.  (``jax.export`` names the GPU
# lowering "cuda", not the backend name "gpu".)
EXPORT_PLATFORMS = ("cpu", "cuda")


# An artifact is one header line naming the JAX version, then the pickle.
_HEADER = b"mahi_mpc artifact; jax "


def save_exported(exp: jax.export.Exported, path: Path) -> None:
    """Write one artifact (see the module docstring for the format)."""
    exp = dataclasses.replace(exp, _get_vjp=None)   # a closure; unused
    Path(path).write_bytes(_HEADER + jax.__version__.encode() + b"\n"
                           + pickle.dumps(exp))


def load_exported(path: Path) -> jax.export.Exported:
    """Read an artifact written by ``save_exported``.  The version in the
    header is checked before anything is unpickled."""
    head, _, body = Path(path).read_bytes().partition(b"\n")
    if not head.startswith(_HEADER):
        raise ValueError(f"{path} is not a mahi_mpc artifact; generate the "
                         f"model again")
    made_by = head[len(_HEADER):].decode(errors="replace")
    if made_by != jax.__version__:
        raise ValueError(
            f"{path} was exported by JAX {made_by}, this is "
            f"{jax.__version__}; generate the model again")
    return pickle.loads(body)


class ModelGenerator:
    """Builds the solve program for one problem configuration and persists it.

    Mirrors the reference API surface (``ModelGenerator.hpp:23-29``):
    ``create_model`` → ``generate_c_code``+``compile_model`` becomes
    ``create_model`` → ``compile_model`` (AOT export), plus
    ``save_param_file``.
    """

    def __init__(self, params: ModelParameters, dynamics: Optional[Dynamics] = None,
                 opts: SolverOptions = SolverOptions()):
        if dynamics is None:
            if not params.dynamics_name:
                raise ValueError(
                    "either pass a Dynamics or set params.dynamics_name")
            dynamics = make_dynamics(params.dynamics_name,
                                     **params.dynamics_kwargs)
        self.params = params
        self.dynamics = dynamics
        self.opts = opts
        self.problem: Optional[ShootingProblem] = None
        self._solve_fn = None
        self._lin_fn = None

    # -- step 1: build the traced solve (reference create_model, :23-232) ----

    def create_model(self) -> ShootingProblem:
        self.problem = make_problem(self.params, self.dynamics)
        prob, opts = self.problem, self.opts

        def solve_fn(p: MPCParams, X0: jnp.ndarray, U0: jnp.ndarray,
                     mu0: jnp.ndarray):
            return solve(prob, p, X0, U0, opts, mu0=mu0)

        self._solve_fn = jax.jit(solve_fn)

        # The linearization triple get_A/get_B/get_x_dot (reference
        # generate_linear_functions, :241-251) — one jitted function, at
        # full float32 matmul precision like the solve.
        dyn = self.dynamics
        self._lin_fn = jax.jit(highest_precision(
            lambda x, u: dyn.linearize(x, u)))
        return self.problem

    # -- step 2: AOT export (reference generate_c_code + compile_model) ------

    def compile_model(self, directory: str | Path = ".") -> Path:
        """AOT-export the solve + linearization programs and write the JSON
        param file.  Returns the artifact path (recorded as ``dll_filepath``
        in the JSON, the same contract as ``ModelGenerator.cpp:253-270``)."""
        if self._solve_fn is None:
            self.create_model()
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        mp = self.params
        nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
        dtype = jnp.dtype(self.opts.dtype)

        p0 = default_params(mp, dtype=dtype)
        p_spec = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p0)
        X_spec = jax.ShapeDtypeStruct((N + 1, nx), dtype)
        U_spec = jax.ShapeDtypeStruct((N, nu), dtype)

        plats = EXPORT_PLATFORMS
        mu_spec = jax.ShapeDtypeStruct((), dtype)
        exp = jax.export.export(self._solve_fn, platforms=plats)(
            p_spec, X_spec, U_spec, mu_spec)
        art = directory / f"{mp.name}{ARTIFACT_SUFFIX}"
        save_exported(exp, art)

        lin_exp = jax.export.export(self._lin_fn, platforms=plats)(
            jax.ShapeDtypeStruct((nx,), dtype), jax.ShapeDtypeStruct((nu,), dtype))
        save_exported(lin_exp, directory / f"{mp.name}{LINEAR_SUFFIX}")

        if self.opts.fixed_warm_iters > 0:
            # Latency-shaped warm-resolve program (no While ops): a second
            # artifact the runtime uses for warm re-solves only.
            from ..solver.fixed import solve_fixed
            prob, opts = self.problem, self.opts
            warm_fn = jax.jit(lambda p, X0, U0, mu0: solve_fixed(
                prob, p, X0, U0, opts, mu0=mu0,
                n_iter=opts.fixed_warm_iters))
            warm_exp = jax.export.export(warm_fn, platforms=plats)(
                p_spec, X_spec, U_spec, mu_spec)
            save_exported(warm_exp, directory / f"{mp.name}{WARM_SUFFIX}")

        self.params = dataclasses.replace(mp, dll_filepath=str(art))
        self.save_param_file(directory)
        return art

    def save_param_file(self, directory: str | Path = ".") -> Path:
        """``<name>.json`` (``ModelGenerator.cpp:261-270``)."""
        return self.params.save(directory)

    # -- direct use without persistence --------------------------------------

    @property
    def solve_fn(self):
        if self._solve_fn is None:
            self.create_model()
        return self._solve_fn

    @property
    def lin_fn(self):
        if self._lin_fn is None:
            self.create_model()
        return self._lin_fn


def generate_model(params: ModelParameters, dynamics: Optional[Dynamics] = None,
                   directory: str | Path = ".",
                   opts: SolverOptions = SolverOptions()) -> Path:
    """One-call generate→compile→save (the ``model_generate`` example flow,
    ``examples/ex_model_generate.cpp:8-73``)."""
    gen = ModelGenerator(params, dynamics, opts)
    gen.create_model()
    return gen.compile_model(directory)
