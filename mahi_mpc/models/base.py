"""Dynamics model protocol.

In the reference a "model" is a CasADi symbolic triple ``(x, x_dot, u)`` handed
to ``ModelGenerator`` (``include/Mahi/Mpc/ModelGenerator.hpp:23-29``), whose
Jacobians ``A = jacobian(x_dot, x)``, ``B = jacobian(x_dot, u)`` are codegen'd
to C (``ModelGenerator.cpp:45-53``).  Here a model is a pure JAX function
``f(x, u) -> x_dot`` and the linearization is `jax.jacfwd` — traced once and
compiled, no codegen round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Dynamics:
    """A continuous-time control system ``x_dot = f(x, u)``.

    ``supports_lanes``: True when ``f`` is shape-polymorphic in a *trailing*
    batch — ``f((nx, ...), (nu, ...)) -> (nx, ...)`` with component indices
    leading.  Scalar-expression models get this for free; it lets the
    batched solver evaluate dynamics with the scenario/node/tangent product
    as one trailing axis (solver/batched.py) instead of vmapping tiny
    graphs.

    ``nq``: set (with ``nx == 2 * nq``) when the model is a second-order
    mechanical system with state ``x = [q, qd]`` and ``f = [qd, acc(x, u)]``.
    The batched linearizer then differentiates only the ``nq`` acceleration
    rows in reverse mode (the ``qd`` rows of A/B are analytic), replacing
    the ``nx + nu`` forward-tangent fan.
    """

    name: str
    nx: int
    nu: int
    f: Callable[[Array, Array], Array]
    supports_lanes: bool = False
    nq: int | None = None

    def __call__(self, x: Array, u: Array) -> Array:
        return self.f(x, u)

    def linearize(self, x: Array, u: Array) -> Tuple[Array, Array, Array]:
        """Return ``(A, B, x_dot)`` at ``(x, u)`` — the runtime equivalent of the
        reference's codegen'd ``get_A / get_B / get_x_dot_init`` functions
        (``ModelGenerator.cpp:51-53``, ``ModelControl.cpp:70-72,125-135``)."""
        A = jax.jacfwd(self.f, argnums=0)(x, u)
        B = jax.jacfwd(self.f, argnums=1)(x, u)
        return A, B, self.f(x, u)

    def linear_f(self, x: Array, u: Array, A: Array, B: Array,
                 x_dot0: Array, x0: Array, u0: Array) -> Array:
        """Frozen LTV right-hand side
        ``x_dot = A (x - x0) + B (u - u0) + x_dot0``
        (successive-linearization mode, ``ModelGenerator.cpp:47``)."""
        return A @ (x - x0) + B @ (u - u0) + x_dot0


_REGISTRY: Dict[str, Callable[..., Dynamics]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_dynamics(name: str, **kwargs) -> Dynamics:
    """Instantiate a registered model family by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dynamics {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def registered_models():
    return sorted(_REGISTRY)
