"""End-to-end tracing tests: invariants, stop taxonomy, adjoint gradients.

Kept deliberately small (few steps, one compile per tracer config): the
scan tracer graphs are slow to compile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rays_tpu  # noqa: F401
from rays_tpu import examples
from rays_tpu.tracing import trace as trace_mod
from rays_tpu.tracing.stop import StopCode


@pytest.fixture(scope="module")
def slab():
    return examples.setup_example()


@pytest.fixture(scope="module")
def slab_results(slab):
    cfg, params, v0, status0, pwr = slab
    cfg = dataclasses.replace(cfg, nstep_max=50)
    tracer = jax.jit(lambda p, v, s, w: trace_mod.trace_batch(cfg, p, v, s, w))
    return cfg, params, tracer(params, v0, status0, pwr)


def test_rays_propagate_and_residual_invariant(slab_results):
    """The production-path physics invariant (check_save.f90): along a valid
    trajectory the dispersion residual stays tiny."""
    cfg, params, res = slab_results
    npoints = np.asarray(res.npoints)
    assert (npoints == cfg.nstep_max + 1).all()
    assert (np.asarray(res.stop_flag) == int(StopCode.NSTEP_MAX)).all()
    assert np.asarray(res.max_residuals).max() < 1e-7
    # rays actually moved
    dx = np.asarray(res.end_ray_vec[:, 0:3]) - np.asarray(res.start_ray_vec[:, 0:3])
    assert (np.linalg.norm(dx, axis=1) > 1e-4).all()
    # arclength v[6] increases monotonically along each ray
    s_arc = np.asarray(res.ray_vec)[:, :, 6]
    assert (np.diff(s_arc, axis=1) > 0).all()


def test_trajectory_prefix_then_frozen(slab_results):
    """Stored points beyond npoints are zero (mask-freeze semantics matching
    the reference's untouched tail of ray_vec)."""
    cfg, params, res = slab_results
    rv = np.asarray(res.ray_vec)
    np0 = np.asarray(res.npoints)[0]
    assert rv.shape[1] == cfg.nstep_max + 1
    assert (rv[:, : np0 - 1, :] != 0).any(axis=(1, 2)).all()


def test_out_of_bounds_stops_ray(slab):
    """A ray launched so it exits the slab box must stop with the
    out-of-bounds taxonomy, and the run must survive (other rays go on)."""
    cfg, params, v0, status0, pwr = slab
    cfg2 = dataclasses.replace(cfg, nstep_max=400)
    # shrink the box so rays exit in z quickly: zmax close to launch z
    params2 = params._replace(eq=params.eq._replace(zmin=-0.605, zmax=-0.55))
    tracer = jax.jit(lambda p, v, s, w: trace_mod.trace_batch(cfg2, p, v, s, w))
    res = tracer(params2, v0, status0, pwr)
    flags = np.asarray(res.stop_flag)
    assert (flags == int(StopCode.Z_OUT_OF_BOUNDS)).any()
    npts = np.asarray(res.npoints)
    assert (npts < cfg2.nstep_max + 1).any()


def test_adjoint_gradients_match_fd(slab):
    """Differentiate the endpoint through the whole scan w.r.t. a physics
    parameter (Ln_scale, the density gradient length) and check against
    central finite differences — the capability the reference lacks
    entirely (SURVEY.md §7.1)."""
    cfg, params, v0, status0, pwr = slab
    cfg2 = dataclasses.replace(cfg, nstep_max=20, save_trajectory=False)

    def loss(ln_scale):
        p = params._replace(eq=params.eq._replace(ln_scale=ln_scale))
        res = trace_mod.trace_batch(cfg2, p, v0, status0, pwr)
        return jnp.sum(res.end_ray_vec[:, 0] ** 2)

    val_and_grad = jax.jit(jax.value_and_grad(loss))
    l0 = float(params.eq.ln_scale)
    _, g = val_and_grad(jnp.float64(l0))

    eps = 1e-5
    loss_j = jax.jit(loss)
    fd = (float(loss_j(jnp.float64(l0 + eps)))
          - float(loss_j(jnp.float64(l0 - eps)))) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=2e-4, atol=1e-12)


def test_netcdf_roundtrip(slab_results, tmp_path):
    """Results write/read in the reference's netCDF schema."""
    cfg, params, res = slab_results
    from rays_tpu.results.netcdf import read_results_nc, write_results_nc

    path = str(tmp_path / "run_results.test.nc")
    write_results_nc(cfg, res, total_trace_time=1.23, path=path)
    data = read_results_nc(path)
    assert data["ray_vec"].shape[0] == res.ray_vec.shape[0]
    assert data["ray_vec"].shape[2] == cfg.nv
    np.testing.assert_allclose(
        data["ray_vec"][:, : data["ray_vec"].shape[1], :],
        np.asarray(res.ray_vec)[:, : data["ray_vec"].shape[1], :],
    )
    np.testing.assert_array_equal(data["npoints"], np.asarray(res.npoints))
    flag0 = b"".join(data["ray_stop_flag"][0]).decode().strip()
    assert flag0 == " nstep > nstep_max".strip()

    # write -> read -> flags equal: the file-based post-processing path must
    # see the same stop taxonomy as in-process (ray_results_m.f90:253-363)
    from rays_tpu.post.process import load_results_nc

    loaded = load_results_nc(path)
    np.testing.assert_array_equal(np.asarray(loaded.stop_flag),
                                  np.asarray(res.stop_flag))


def test_sharded_trace_multidevice(slab):
    """Rays sharded over the device mesh produce identical results."""
    if len(jax.devices()) < 2:
        pytest.skip("single device — sharding validated via dryrun_multichip")
    cfg, params, v0, status0, pwr = slab
    from rays_tpu.parallel import sharded

    mesh = sharded.make_ray_mesh()
    v0p, st, w, B = sharded.pad_rays(v0, status0, pwr, len(jax.devices()))
    tracer = sharded.make_sharded_tracer(
        dataclasses.replace(cfg, nstep_max=10), mesh)
    res = tracer(params, v0p, st, w)
    assert np.asarray(res.npoints)[:B].min() >= 1
