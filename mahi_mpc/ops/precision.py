"""Matmul-precision scoping for the solver's programs.

A float32 matrix product on a GPU may run in TF32 (about three decimal
digits) unless asked otherwise, and Newton/Riccati directions computed at
reduced precision stall the SQP far from tolerance.  An optimization library
needs true fp32 contractions — but that is a property of *our* programs, not
of the user's process, so instead of mutating
``jax_default_matmul_precision`` globally at import, every solver entry point
(and every jitted ``linearize`` of the runtime) traces its body under
``jax.default_matmul_precision("highest")``.  The flops cost is irrelevant at
our matrix sizes (bandwidth-bound); user code outside the solver keeps
whatever precision policy it had.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Decorator: trace ``fn`` under full-fp32 matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
