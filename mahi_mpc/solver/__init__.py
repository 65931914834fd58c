from .stage_qp import StageQP, build_stage_qp
from .riccati import (LQRSolution, register_backend, resolve_kkt_backend,
                      solve_lqr)
from .sqp import CONVERGED, DIVERGED, MAX_ITER, SolveResult, solve, solve_batch
from .fixed import solve_fixed
from .batched import solve_batch_lanes
from .select import resolve_warm_solver

__all__ = [
    "StageQP", "build_stage_qp",
    "LQRSolution", "solve_lqr", "register_backend", "resolve_kkt_backend",
    "SolveResult", "solve", "solve_batch", "solve_fixed",
    "solve_batch_lanes",
    "resolve_warm_solver",
    "CONVERGED", "MAX_ITER", "DIVERGED",
]
