"""The ray right-hand side: Hamiltonian geometrical-optics equations.

Functional re-design of reference RAYS_project/RAYS_lib/eqn_ray.f90.
State layout in the ODE vector v (ode_m.f90:158-175):

    v[0:3] = x,  v[3:6] = k,  v[6] = integrated arclength,
    [v[7] = total absorption]  [v[8:8+S] = per-species absorption]
    [5 gradient-diagnostic integrals]

The equilibrium (values + all spatial gradients, by forward-mode AD of the
model fields) is evaluated EXACTLY ONCE per RHS call; everything else is
cheap per-species algebra.  Two interchangeable derivative paths reproduce
the reference's ray_deriv_name A/B (eqn_ray.f90:106-123):

  * 'cold' (default): the closed-form chain rule of the pole-free scalar D
    through (alpha, gamma, n_par, n_perp^2) — deriv_cold.py, itself fully
    differentiable so parameter adjoints flow through the whole scan;
  * 'autodiff': dD/dx, dD/dk, dD/domega by one jax.grad of
    dispersion.dispersion_D (re-evaluates the equilibrium inside the AD
    trace — bigger compile, kept as the independent-path verification,
    playing the role of the reference's deriv_num FD check).

Returns (dvds, status): status is the first-triggered StopCode in the
reference's order (equilibrium error -> infinite Vg -> ray stalled,
eqn_ray.f90:89-169).  dvds is NaN-free even in error states (safe
denominators), so reverse-mode AD through masked updates stays clean.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rays_tpu import constants
from rays_tpu.models import base
from rays_tpu.tracing.stop import StopCode
from rays_tpu.wave import damping as damping_mod
from rays_tpu.wave import deriv_cold as deriv_cold_mod
from rays_tpu.wave import dispersion


def eqn_ray(cfg, params, s, v):
    """RHS for a single ray at parameter value s.  Pure; vmap over rays."""
    eq = base.equilibrium(cfg, params, v[0:3])
    return _eqn_ray_from_eq(cfg, params, s, v, eq)


def _eqn_ray_from_eq(cfg, params, s, v, eq):
    """Everything in eqn_ray after the equilibrium evaluation (eq is the
    EqPoint at v[0:3]), split out so eqn_ray_and_check can reuse one eval."""
    dt = v.dtype
    kvec = v[3:6]
    omgrf, k0 = params.rf.omgrf, params.rf.k0
    tiny = constants.SAFE_TINY
    err = eq.err

    if getattr(cfg, "ray_deriv_name", "cold") == "autodiff":
        D = lambda x, k, w: dispersion.dispersion_D(cfg, params, x, k, w)
        dddx, dddk, dddw = jax.grad(D, argnums=(0, 1, 2))(rvec, kvec, omgrf)
    else:
        inv_k0 = 1.0 / k0
        dddx, dddk, dddw = deriv_cold_mod.deriv_cold(
            eq, kvec * inv_k0, omgrf, k0)

    # group velocity (eqn_ray.f90:131-144).  Reciprocal-multiply forms:
    # each div fan-out below used to issue 3 divides per eval
    safe_dddw = jnp.where(dddw == 0.0, jnp.asarray(1.0, dt), dddw)
    inv_dddw = 1.0 / safe_dddw
    vg = -dddk * inv_dddw
    vg0 = jnp.sqrt(jnp.sum(vg**2))
    vg_unit = vg * (1.0 / jnp.maximum(vg0, tiny))

    dddk_mag = jnp.sqrt(jnp.sum(dddk**2))
    inv_dddk_mag = 1.0 / jnp.maximum(dddk_mag, tiny)

    if cfg.ray_param == "arcl":
        # integrate w.r.t. arclength (eqn_ray.f90:150-170).
        # Fortran sign(1., dddw) is +1 at dddw == 0.
        sgn = jnp.where(dddw >= 0.0, 1.0, -1.0).astype(dt)
        dxds = -sgn * dddk * inv_dddk_mag
        dkds = sgn * dddx * inv_dddk_mag
        dsd_ray_param = jnp.asarray(1.0, dt)
    elif cfg.ray_param == "time":
        # integrate w.r.t. time (eqn_ray.f90:172-181)
        dxds = -dddk * inv_dddw
        dkds = dddx * inv_dddw
        dsd_ray_param = vg0
    else:
        raise ValueError(f"eqn_ray: invalid ray_param {cfg.ray_param}")

    parts = [dxds, dkds, dsd_ray_param[None]]

    if cfg.damping_model != "no_damp":
        ksi, ki = damping_mod.damping(cfg, params, eq, v[0:6], vg)
        # dP/ds = dsd * 2 ki (1 - P_total), P_total = v[7] (eqn_ray.f90:196-213)
        p_tot = v[7]
        parts.append((dsd_ray_param * 2.0 * ki * (1.0 - p_tot))[None])
        if cfg.multi_spec_damping:
            parts.append(dsd_ray_param * 2.0 * ksi * (1.0 - p_tot))

    if cfg.integrate_eq_gradients:
        # d/ds of (B, ne, Te) along the ray (eqn_ray.f90:217-229)
        db = dsd_ray_param * (vg_unit @ eq.gradb)          # (3,)
        dne = dsd_ray_param * jnp.dot(vg_unit, eq.gradns[0])
        dte = dsd_ray_param * jnp.dot(vg_unit, eq.gradts[0])
        parts.extend([db, dne[None], dte[None]])

    dvds = jnp.concatenate(parts)

    # first-triggered status, reference order
    status = jnp.int32(StopCode.OK)
    if cfg.ray_param == "arcl":
        status = jnp.where(dddk_mag == 0.0, jnp.int32(StopCode.RAY_STALLED), status)
    status = jnp.where(dddw == 0.0, jnp.int32(StopCode.INFINITE_VG), status)
    status = jnp.where(err != 0, err, status)

    return dvds, status


def check_save(cfg, params, v):
    """Per-step validity checks on the state v (reference check_save.f90).

    Returns (resid, status).  The dispersion residual is the production-path
    physics invariant: |det(eps_h + nn - n^2 I)| relative to the term-norm,
    with a hard stop at dispersion_resid_limit (check_save.f90:64-71).
    Divergence from the reference: we do not recompute dD/domega here just
    to re-test for infinite group velocity — the RHS of the next step
    performs that check (eqn_ray.f90:133-144).
    """
    alpha, gamma, bunit, _, _, err = base.eq_point_light(cfg, params, v[0:3])
    return _check_from_point(cfg, params, alpha, gamma, bunit, err, v)


def _check_from_point(cfg, params, alpha, gamma, bunit, err, v):
    """check_save given the already-evaluated plasma state at v[0:3]."""
    kvec = v[3:6]
    inv_k0 = 1.0 / params.rf.k0
    k3 = jnp.sum(kvec * bunit)
    k1 = jnp.sqrt(jnp.sum((kvec - k3 * bunit) ** 2))
    resid = dispersion.residual(alpha, gamma, k1 * inv_k0, k3 * inv_k0)

    status = jnp.int32(StopCode.OK)
    if cfg.damping_model != "no_damp":
        status = jnp.where(
            v[7] > params.limits.total_damping_limit,
            jnp.int32(StopCode.TOTAL_ABSORPTION), status,
        )
    status = jnp.where(
        resid > params.limits.dispersion_resid_limit,
        jnp.int32(StopCode.DISPERSION_RESIDUAL), status,
    )
    status = jnp.where(err != 0, err, status)
    return resid, status


def eqn_ray_and_check(cfg, params, s, v):
    """The RHS AND the check_save monitor at the same point, from ONE
    equilibrium evaluation.  Returns (dvds, rhs_status, resid, check_status).

    This is the production tracer's endpoint evaluation: the reference pays
    a full equilibrium eval in check_save after each step and another in
    eqn_ray's first stage of the NEXT step at the same point
    (check_save.f90:163-235 + eqn_ray.f90:86-102); here the two consumers
    share the eval and the RHS result is carried into the next step's k1.
    """
    eq = base.equilibrium(cfg, params, v[0:3])
    dvds, rhs_status = _eqn_ray_from_eq(cfg, params, s, v, eq)
    resid, check_status = _check_from_point(
        cfg, params, eq.alpha, eq.gamma, eq.bunit, eq.err, v)
    return dvds, rhs_status, resid, check_status
