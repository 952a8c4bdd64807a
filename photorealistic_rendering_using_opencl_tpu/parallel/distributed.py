"""Multi-host bootstrap: jax.distributed init + global mesh construction.

The reference is single-device with no communication backend (SURVEY §2.4);
this is the cross-host story added here: every host runs the same SPMD
program, the scene/BVH/env-map pytree is replicated per device (broadcast
once at load), pixels shard over the global ``rays`` axis, and the only
recurring cross-device traffic is the training step's gradient ``psum``
(parallel/render.py:make_train_step).
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from photorealistic_rendering_using_opencl_tpu.parallel.render import RAYS_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host slice.

    The arguments come from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or the
    explicit parameters; a cluster without them must pass all three.  Idempotent: a second call is a no-op.
    """
    if getattr(initialize, "_done", False):
        return
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    if num_processes is not None or "JAX_NUM_PROCESSES" in os.environ:
        kwargs["num_processes"] = (num_processes if num_processes is not None
                                   else int(os.environ["JAX_NUM_PROCESSES"]))
    if process_id is not None or "JAX_PROCESS_ID" in os.environ:
        kwargs["process_id"] = (process_id if process_id is not None
                                else int(os.environ["JAX_PROCESS_ID"]))
    if "coordinator_address" in kwargs:
        jax.distributed.initialize(**kwargs)
    initialize._done = True


def global_mesh(axis: str = RAYS_AXIS) -> Mesh:
    """1-D mesh over every addressable device across all hosts.

    A single flat ``rays`` axis is the right shape for a path tracer: data
    parallelism over pixels needs no second axis, so all collectives are
    single-axis psums that XLA hands to the collective library (NCCL on
    GPUs) within and between hosts.
    """
    return Mesh(np.asarray(jax.devices()), (axis,))


def local_shard_bounds(n: int) -> tuple[int, int]:
    """[start, end) of this process's slice of a length-n pixel batch."""
    p = jax.process_index()
    k = jax.process_count()
    per = (n + k - 1) // k
    return p * per, min((p + 1) * per, n)
