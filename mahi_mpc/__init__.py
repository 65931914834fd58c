"""mahi_mpc — a batched nonlinear MPC / trajectory-optimization engine.

JAX/XLA implementation of the capabilities of mahilab/mahi-mpc (see
SURVEY.md): user dynamics as pure JAX functions, direct multiple-shooting
transcription, a batched structured SQP whose stage-banded KKT systems are
solved by Riccati recursion (lax.scan or parallel-in-time associative scan),
and a warm-started receding-horizon runtime with an asynchronous plan
service.
"""

# NOTE on matmul precision: a float32 matrix product on a GPU may run in TF32
# unless asked otherwise, which stalls Newton/Riccati directions far from
# tolerance.  Rather than mutating global config at import time, every
# solver entry point scopes jax.default_matmul_precision("highest") around
# its own trace (ops/precision.py) — user programs keep their own precision
# policy.

from .params import ModelParameters, SolverOptions, TrajectoryParameters
from . import models

__version__ = "0.1.0"

__all__ = [
    "ModelParameters",
    "SolverOptions",
    "TrajectoryParameters",
    "models",
]
