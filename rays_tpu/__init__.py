"""rays_tpu — differentiable plasma ray-tracing framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of ORNL-Fusion/RAYS
(cold-plasma RF geometrical-optics ray tracing; reference layout surveyed in
SURVEY.md).  Not a port: the dispersion relation D(x, k, omega) is a pure
scalar JAX function and the Hamiltonian ray equations are obtained by
autodiff; rays are a vmapped batch integrated by `lax.scan` steppers and
sharded over a `jax.sharding.Mesh`.

Ray trajectories demand float64 (the reference integrates with tolerances
down to 1e-9, cf. reference RAYS_project/RAYS_lib/SG_ode_m.f90); we enable
x64 globally at import.  Benchmarks may still trace in f32 by building f32
params.  One precision policy for matrix products: float32 dots run at full
float32 precision (a GPU would otherwise be free to use TF32, which keeps
about three decimal digits).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the scan tracer graphs take tens of seconds
# to compile.  JAX itself honours JAX_COMPILATION_CACHE_DIR; without it the
# cache lives at a fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache"))

from rays_tpu import constants  # noqa: E402
from rays_tpu.version import __version__  # noqa: E402,F401
