"""Warm-solver resolution: which program serves warm re-solves.

``SolverOptions.warm_solver`` values:

- ``"auto"`` — ``"fixed"`` when ``fixed_warm_iters > 0``, else
  ``"adaptive"``.  The same on every device.
- ``"fixed"`` — ``solve_fixed``: exactly ``fixed_warm_iters`` straight-line
  SQP iterations (the latency shape of the single-robot runtime).
- ``"adaptive"`` — the adaptive SQP to tolerance (``solve``, or
  ``solve_batch_lanes`` for batches).

Cold solves always use the adaptive program.  Reference semantics:
``ModelControl.cpp:159-161``.
"""

from __future__ import annotations

from ..params import SolverOptions

VALID = ("auto", "fixed", "adaptive")


def resolve_warm_solver(opts: SolverOptions) -> str:
    """Resolve ``opts.warm_solver`` to ``"fixed"`` or ``"adaptive"``."""
    w = opts.warm_solver
    if w not in VALID:
        raise ValueError(
            f"unknown warm_solver {w!r}; choose one of {VALID}")
    if w == "auto":
        return "fixed" if opts.fixed_warm_iters > 0 else "adaptive"
    return w
