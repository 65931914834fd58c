"""Multi-host execution: jax.distributed init + global-mesh helpers.

The reference has zero networking code — inter-"node" communication is a
mutex (``ModelControl.cpp:75-81``; SURVEY.md §2.b).  This framework's
multi-host story is standard JAX SPMD: every process calls
``initialize_distributed()``, builds one global ``Mesh`` over
``jax.devices()`` (all processes' devices), and runs the *same* jitted
solve; XLA routes scenario-batch shards over the interconnect.  Nothing in
the solver changes — the batch axis just gets bigger.

Multi-host is exercised in CI without a pod by the multi-process CPU
simulation in ``tests/test_distributed.py`` (two processes x four virtual
CPU devices each -> one 8-device global mesh), per SURVEY.md §4's
"test multi-node without a cluster".
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np

from .mesh import make_mesh, make_sharded_solver, scaling_report

__all__ = ["initialize_distributed", "global_batch_mesh",
           "make_global_array", "shard_params_global", "scaling_table"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None
                           ) -> bool:
    """Initialize the JAX distributed runtime for a multi-host job.

    With no arguments, resolves everything from the standard environment
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` as set by a launcher).  Returns True if the
    distributed client was (already) initialized, False when running
    single-process with no coordinator configured (the common 1-host case —
    callers need no branch: ``jax.devices()`` is correct either way).
    """
    if jax.distributed.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes is None:
        # Single process, nothing to coordinate.
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    return True


def global_batch_mesh(n_time: int = 1):
    """A ``(batch, time)`` mesh over ALL global devices (every process must
    call this with the same arguments)."""
    return make_mesh(n_time=n_time, devices=jax.devices())


def make_global_array(value: np.ndarray, sharding) -> jax.Array:
    """Build a globally-sharded jax.Array from a host-replicated numpy value
    (every process holds the full value; each contributes its addressable
    shards).  The multi-process-safe replacement for ``jax.device_put``."""
    return jax.make_array_from_callback(
        value.shape, sharding, lambda idx: value[idx])


def shard_params_global(p_batch, mesh) -> object:
    """Multi-process-safe version of ``mesh.shard_params``: every leaf is a
    host-replicated numpy/jax array of the full global batch; each process
    contributes the shards it owns."""
    from .mesh import batch_spec
    spec = batch_spec(mesh)
    return jax.tree.map(
        lambda a: make_global_array(np.asarray(a), spec), p_batch)


def scaling_table(prob, p_batch, opts, n_time: int = 1) -> dict:
    """The BASELINE.md scaling-efficiency report: solves/s at 1 device, at
    all local devices, and (when run under a multi-process launch) at the
    full global mesh.  Keys: ``one_chip``, ``one_host``, ``global`` (the
    last only when jax.process_count() > 1)."""
    out = {"process_count": jax.process_count(),
           "local_devices": jax.local_device_count(),
           "global_devices": jax.device_count()}
    if jax.process_count() == 1:
        one = make_mesh(n_batch=1, n_time=1, devices=jax.devices()[:1])
        out["one_chip"] = scaling_report(prob, p_batch, one, opts)
        if jax.local_device_count() > 1:
            host = make_mesh(n_time=n_time)
            out["one_host"] = scaling_report(prob, p_batch, host, opts)
    else:
        # Multi-process: only the global mesh is legal (every process must
        # participate in every collective program).
        mesh = global_batch_mesh(n_time=n_time)
        out["global"] = scaling_report(prob, p_batch, mesh, opts)
    if "one_host" in out and "one_chip" in out:
        n = out["one_host"]["devices"]
        out["one_host_efficiency"] = (
            out["one_host"]["solves_per_s"]
            / (n * out["one_chip"]["solves_per_s"]))
    return out
