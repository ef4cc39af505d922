"""Multi-host scale-out: ray batches sharded across processes.

The reference tops out at shared-memory OpenMP on one node
(reference RAYS_project/RAYS_lib/ray_tracing.f90:62-67, openmp_m.f90) — the
multi-host path is new capability (SURVEY.md §2.8).  Design:

  * every host runs the same program; ``initialize()`` wires the JAX
    distributed runtime so all hosts' devices form one global mesh;
  * the ray axis shards over ALL devices (NVLink within a host, the
    network across hosts);
    equilibrium/species params replicate;
  * per-host ray initialization builds only the local shard via
    ``jax.make_array_from_process_local_data`` — no host ever materializes
    the global batch;
  * reductions (deposition psum, adjoint all-reduce) are inserted by XLA
    from the sharding specs; nothing here is MPI-shaped.

On a single process every function degrades to the single-host mesh, so
library code can call these unconditionally.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bring up the JAX distributed runtime (no-op on a single process).

    With no arguments, jax.distributed.initialize auto-detects the cluster
    from the environment (SLURM / Open MPI).  Explicit arguments cover
    bare-metal launches:

        rays_tpu.parallel.multihost.initialize(
            coordinator_address="10.0.0.1:8476",
            num_processes=4, process_id=int(os.environ["RANK"]))

    Returns (process_index, process_count).
    """
    if num_processes is not None and int(num_processes) > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=int(num_processes),
            process_id=int(process_id),
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    # else: single process, nothing to wire
    return jax.process_index(), jax.process_count()


def global_ray_mesh(devices=None) -> Mesh:
    """1-D 'rays' mesh over every device of every process (or an explicit
    device subset, e.g. for dry runs on a virtual CPU mesh)."""
    return Mesh(np.asarray(devices if devices is not None else jax.devices()),
                ("rays",))


def distribute_rays(mesh: Mesh, v0_local, status0_local, pwr_local):
    """Assemble global sharded batch arrays from per-process local shards.

    Each process passes only the rays it initialized (e.g. its slice of the
    launch grid); the returned jax.Arrays are globally sharded over the
    mesh without any host gathering the full batch.
    """
    sh = NamedSharding(mesh, P("rays"))
    make = jax.make_array_from_process_local_data
    return (make(sh, np.asarray(v0_local)),
            make(sh, np.asarray(status0_local)),
            make(sh, np.asarray(pwr_local)))


def local_ray_slice(n_global: int, process_count: int | None = None,
                    process_index: int | None = None):
    """(start, stop) of one process's contiguous share of a global ray
    batch, balanced like the sharded leading axis.  Defaults to THIS
    process's position in the live runtime; explicit (process_count,
    process_index) make the partition arithmetic directly testable."""
    pc = jax.process_count() if process_count is None else int(process_count)
    pi = jax.process_index() if process_index is None else int(process_index)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    per = -(-n_global // pc)
    return min(pi * per, n_global), min((pi + 1) * per, n_global)


def make_multihost_tracer(cfg, mesh: Mesh):
    """Jitted tracer over the global mesh; identical to the single-host
    sharded tracer — XLA places the ray axis from the specs."""
    from rays_tpu.parallel.sharded import make_sharded_tracer

    return make_sharded_tracer(cfg, mesh)
