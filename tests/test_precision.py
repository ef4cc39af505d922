"""Precision strategy: f32 (production) vs f64 (parity/adjoint) tracing.

f32 runs at a multiple of the f64 rate on accelerators.  These tests pin
the accuracy contract that makes f32 the production default: trajectories across the example classes
stay within ~1e-3 relative of the f64 reference over the full step budget
(measured: 3.5e-4 worst-case on the slab case, which pivots through a
turning point; ~3e-5 on the damped case), stop behavior is identical, and
integrated absorption matches to ~2e-4.  Parity-vs-oracle and adjoint
validation remain f64 (tests/test_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rays_tpu  # noqa: F401
from rays_tpu import examples
from rays_tpu.tracing import trace as trace_mod


def _cast(tree, dt):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dt)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        tree,
    )


def _trace(cfg, params, v0, st, pwr, dt):
    p, v, w = _cast(params, dt), _cast(v0, dt), _cast(pwr, dt)
    tracer = jax.jit(lambda p, v, s, w: trace_mod.trace_batch(cfg, p, v, s, w))
    res = tracer(p, v, st, w)
    jax.block_until_ready(res)
    return res


def _compare(res64, res32, rtol_x=2e-4, rtol_k=2e-4):
    np64 = np.asarray(res64.npoints)
    np32 = np.asarray(res32.npoints)
    np.testing.assert_array_equal(np32, np64)
    np.testing.assert_array_equal(np.asarray(res32.stop_flag),
                                  np.asarray(res64.stop_flag))
    v64 = np.asarray(res64.ray_vec, np.float64)
    v32 = np.asarray(res32.ray_vec, np.float64)
    for ir in range(v64.shape[0]):
        n = np64[ir]
        sx = max(np.abs(v64[ir, :n, 0:3]).max(), 1e-12)
        sk = max(np.abs(v64[ir, :n, 3:6]).max(), 1e-12)
        np.testing.assert_allclose(v32[ir, :n, 0:3], v64[ir, :n, 0:3],
                                   atol=rtol_x * sx, rtol=0,
                                   err_msg=f"ray {ir} positions (f32 vs f64)")
        np.testing.assert_allclose(v32[ir, :n, 3:6], v64[ir, :n, 3:6],
                                   atol=rtol_k * sk, rtol=0,
                                   err_msg=f"ray {ir} k (f32 vs f64)")


def test_compensated_sum_mode():
    """cfg.compensated_sum (tracing/compensated.py): the carried state is
    bit-identical to the plain f32 path (TwoSum's primary sum IS v + dv),
    the compensation vector is finite, nonzero, and ulp-scale, and it
    round-trips through both steppers.  The accuracy finding is recorded
    in BASELINE.md: on these cases the compensation does NOT shrink the
    f32-vs-f64 end error, because the dominant error is stage-state
    quantization (measured by the f64-RHS bisection probe), not
    accumulation rounding — this test pins the mode's mechanics, not an
    accuracy win."""
    for solver_text in (examples.SLAB_ECH_90GHZ,
                        examples.SLAB_ECH_90GHZ.replace(
                            "ode_solver_name='RK4_ODE'",
                            "ode_solver_name='SG_ODE'")):
        cfg, params, v0, st, pwr = examples.setup_example(solver_text)
        cfg = dataclasses.replace(cfg, nstep_max=100, save_trajectory=False)
        res_plain = _trace(cfg, params, v0, st, pwr, jnp.float32)
        cfg_c = dataclasses.replace(cfg, compensated_sum=True)
        res_comp = _trace(cfg_c, params, v0, st, pwr, jnp.float32)
        np.testing.assert_array_equal(np.asarray(res_comp.end_ray_vec),
                                      np.asarray(res_plain.end_ray_vec))
        np.testing.assert_array_equal(np.asarray(res_comp.npoints),
                                      np.asarray(res_plain.npoints))
        assert res_plain.end_ray_comp is None
        c = np.asarray(res_comp.end_ray_comp, np.float64)
        v = np.asarray(res_comp.end_ray_vec, np.float64)
        assert np.isfinite(c).all()
        # the compensation accumulated something ...
        assert np.abs(c).max() > 0
        # ... but stays ulp-scale: |c| << |v| (each step contributes at
        # most ~ulp(|v|); 100 steps x 1.2e-7 with slop)
        scale = np.abs(v).max(axis=0) + 1e-300
        assert (np.abs(c).max(axis=0) / scale).max() < 100 * 1.2e-7


def test_f32_matches_f64_slab():
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ)
    _compare(_trace(cfg, params, v0, st, pwr, jnp.float64),
             _trace(cfg, params, v0, st, pwr, jnp.float32),
             rtol_x=1e-3, rtol_k=5e-4)


def test_f32_matches_f64_slab_damped_absorption():
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED)
    r64 = _trace(cfg, params, v0, st, pwr, jnp.float64)
    r32 = _trace(cfg, params, v0, st, pwr, jnp.float32)
    _compare(r64, r32, rtol_x=5e-4, rtol_k=5e-4)
    a64 = np.asarray(r64.end_ray_vec, np.float64)[:, 7]
    a32 = np.asarray(r32.end_ray_vec, np.float64)[:, 7]
    np.testing.assert_allclose(a32, a64, atol=2e-4, rtol=0,
                               err_msg="integrated absorption f32 vs f64")


def test_f32_matches_f64_solovev_rk4():
    """Measured: positions <= 5e-4 relative on every ray; k stays ~1e-6
    except on rays that pivot through a cutoff/coalescence layer, where the
    trajectory is genuinely chaotic-sensitive and f32 noise amplifies to
    ~1e-2 in k while positions remain accurate (ray 0 of this fan).  That
    is the f32 contract: positions/deposition-grade accuracy everywhere;
    use f64 for k-spectrum studies near mode-conversion layers."""
    cfg, params, v0, st, pwr = examples.setup_example(
        examples.SOLOVEV_ECH_90GHZ)
    cfg = dataclasses.replace(cfg, ode_solver_name="RK4_ODE")
    _compare(_trace(cfg, params, v0, st, pwr, jnp.float64),
             _trace(cfg, params, v0, st, pwr, jnp.float32),
             rtol_x=1e-3, rtol_k=2e-2)


def test_adjoint_runs_under_remat_and_matches_fd():
    """Adjoint through the rematerialized scan: gradient of an endpoint loss
    w.r.t. a physics parameter matches central finite differences."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ)
    cfg = dataclasses.replace(cfg, nstep_max=60, save_trajectory=False)
    assert cfg.remat_steps  # the production default

    def loss(bz0):
        p = params._replace(eq=params.eq._replace(bz0=bz0))
        res = trace_mod.trace_batch(cfg, p, v0, st, pwr)
        return jnp.sum(res.end_ray_vec[:, 0] ** 2)

    loss_j = jax.jit(loss)
    grad_j = jax.jit(jax.grad(loss))
    bz0 = params.eq.bz0
    g = float(grad_j(bz0))
    eps = 1e-6
    fd = float((loss_j(bz0 + eps) - loss_j(bz0 - eps)) / (2 * eps))
    assert g == pytest.approx(fd, rel=5e-5), (g, fd)
