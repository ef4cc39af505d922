"""Scale-out: shard the ray batch over a device mesh.

The reference's only parallelism is an OpenMP `parallel do` over rays
(reference RAYS_project/RAYS_lib/ray_tracing.f90:62-67).  Here rays are
the leading axis of every batch array, sharded over a 1-D
`jax.sharding.Mesh` axis named 'rays'; params are replicated.  Tracing is
embarrassingly parallel so XLA compiles it collective-free; reductions
(deposition profiles, adjoint gradients w.r.t. replicated params) turn into
psum/all-reduce under `jit`, which XLA hands to NCCL over NVLink on a
multi-GPU host.
"""

from __future__ import annotations

import re

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rays_tpu.tracing import trace as trace_mod
from rays_tpu.tracing.stop import StopCode


def make_ray_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("rays",))


def pad_rays(v0, status0, pwr, n_shards: int):
    """Pad the ray batch to a multiple of the mesh size.  Padding rays are
    born with a DID_NOT_START status and zero power so they freeze
    immediately and contribute nothing to reductions."""
    import jax.numpy as jnp

    B = v0.shape[0]
    pad = (-B) % n_shards
    if pad == 0:
        return v0, status0, pwr, B
    v0 = jnp.concatenate([v0, jnp.zeros((pad, v0.shape[1]), v0.dtype)])
    status0 = jnp.concatenate(
        [status0, jnp.full((pad,), int(StopCode.DID_NOT_START), jnp.int32)]
    )
    pwr = jnp.concatenate([pwr, jnp.zeros((pad,), pwr.dtype)])
    return v0, status0, pwr, B


def make_sharded_tracer(cfg, mesh: Mesh):
    """Jitted tracer with rays sharded over the mesh and params replicated."""
    ray_sharding = NamedSharding(mesh, P("rays"))
    repl = NamedSharding(mesh, P())

    def trace(params, v0, status0, pwr):
        v0 = jax.lax.with_sharding_constraint(v0, ray_sharding)
        return trace_mod.trace_batch(cfg, params, v0, status0, pwr)

    return jax.jit(
        trace,
        in_shardings=(repl, ray_sharding, ray_sharding, ray_sharding),
    )


COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
               "reduce-scatter", "collective-broadcast")


def collective_ops(hlo_text: str) -> set:
    """The collective operations instantiated in compiled HLO text (op
    instances ``%x = ... all-reduce(...)``, not metadata mentions)."""
    found = set()
    for line in hlo_text.splitlines():
        for c in COLLECTIVES:
            if re.search(rf"= [^=]*\b{c}\b", line.strip()):
                found.add(c)
    return found
