"""Adaptive embedded Runge-Kutta (Dormand-Prince 5(4)) over one outer step.

The reference's adaptive path is the Shampine-Gordon Adams PECE suite
(reference RAYS_project/RAYS_lib/ode_RAYS.f90, SG_ode_m.f90): variable
order/step with per-ray tolerance state, advancing from s to sout = s + ds
each outer step.  Variable-order multistep state is hostile to lockstep
batching, so the batched equivalent is an embedded one-step pair with PI
step-size control: same contract (advance exactly ds to tolerance; results
agree with SG at the tolerance level, which is how the examples are
validated — SURVEY.md §7.1), but O(1) state per ray and identical control
flow across the vmapped batch.

The inner adaptive loop is a ``lax.while_loop`` bounded by
cfg.max_substeps; under vmap it runs lockstep with masked per-ray updates.
Error control follows the SG convention: mixed test
err_i / (abs_err + rel_err*|v_i|), aborting with ODE_TOTAL_ERROR when the
step size underflows or the substep budget is exhausted
(SG_ode_m.f90:89-159 behavior analog).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rays_tpu import constants

from rays_tpu.tracing import rhs as rhs_mod
from rays_tpu.tracing.stop import StopCode

# Dormand-Prince 5(4) tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 5.0


def _dopri_step(f, f_check, t, v, h, k1, k1_st):
    """One trial DOPRI5 step with the first stage supplied (FSAL: DP5's
    7th stage is evaluated at (t+h, v5), so an accepted step's k7 IS the
    next step's k1 — 6 fresh RHS evals per substep instead of 7).  The
    7th stage uses ``f_check`` (the RHS + check_save from one equilibrium
    eval) so the step's endpoint check rides the same evaluation.
    Returns (v5, dv5, err_vec, status, k7, k7_status, resid, check_status)
    with v5 = v + dv5 (the raw increment feeds the compensated-summation
    carry, trace.py cfg.compensated_sum)."""
    ks = [k1]
    status = k1_st
    for i in range(1, 6):
        vi = v
        for j, aij in enumerate(_A[i]):
            if aij != 0.0:
                vi = vi + h * aij * ks[j]
        ki, sti = f(t + _C[i] * h, vi)
        status = jnp.where(status != 0, status, sti)
        ks.append(ki)
    # stage 7: A[6] == B5, so v7 IS the 5th-order solution v5
    dv5 = jnp.zeros_like(v)
    for j, aij in enumerate(_A[6]):
        if aij != 0.0:
            dv5 = dv5 + h * aij * ks[j]
    v5 = v + dv5
    k7, st7, resid, chk = f_check(t + _C[6] * h, v5)
    status = jnp.where(status != 0, status, st7)
    ks.append(k7)
    err = jnp.zeros_like(v)
    for bi5, bi4, ki in zip(_B5, _B4, ks):
        err = err + h * (bi5 - bi4) * ki
    return v5, dv5, err, status, k7, status, resid, chk


def rk45_step(cfg, params, s, v, h0):
    """Advance one outer step ds adaptively.  Returns (v_new, status, h_next)."""
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    v_f, status, h_f, _, _, _, _ = rk45_step_carried_full(
        cfg, params, s, v, h0, f1, st1)
    return v_f, status, h_f


def rk45_step_carried(cfg, params, s, v, h0, f1, st1):
    """Carried-stage form returning (v_new, status, h_next) — see
    rk45_step_carried_full for the endpoint-sharing variant."""
    v_f, status, h_f, _, _, _, _ = rk45_step_carried_full(
        cfg, params, s, v, h0, f1, st1)
    return v_f, status, h_f


def rk45_step_carried_full(cfg, params, s, v, h0, f1, st1, c0=None):
    """Advance one outer step ds adaptively, with (f1, st1) = eqn_ray(s, v)
    supplied by the caller (the production tracer carries it from the
    previous step's endpoint stage).  Returns
    (v_new, status, h_next, f_end, f_end_status, resid, check_status):
    f_end is the RHS at (sout, v_new) — the FSAL 7th stage of the final
    accepted substep — and (resid, check_status) are check_save's values
    at the same point from the SAME equilibrium evaluation, so the
    production tracer pays no separate endpoint eval at all.

    ``c0`` (optional) is the compensated-summation carry: when given,
    accepted substep increments are TwoSummed into (v, c) and the return
    tuple gains a trailing c_new (trace.py cfg.compensated_sum).

    ``h0`` is the converged step size carried over from the previous outer
    step (the SG suite likewise keeps its step/order state across outer
    steps, SG_ode_m.f90:73-85 resets only at ray start) — re-seeding h = ds
    every outer step would waste rejected substeps on stiff stretches.
    Within the substep loop the first stage rides FSAL: an accepted
    substep's k7 becomes the next substep's k1; a rejected substep reuses
    its k1 unchanged.
    """
    dt = v.dtype
    ds = params.ode.ds
    sout = s + ds
    rel, ab = params.ode.rel_err, params.ode.abs_err
    f = lambda ss, vv: rhs_mod.eqn_ray(cfg, params, ss, vv)
    f_check = lambda ss, vv: rhs_mod.eqn_ray_and_check(cfg, params, ss, vv)
    h_min = jnp.abs(ds) * 1e-12
    # "reached sout" tolerance: below ~eps*|sout| the update t += h would
    # round away and the loop could spin until the substep budget dies
    done_tol = jnp.abs(ds) * 1e-10

    comp = c0 is not None

    def cond(carry):
        t, status, n_sub = carry[0], carry[-2], carry[-1]
        return (sout - t > done_tol) & (status == 0) & (n_sub < cfg.max_substeps)

    def body(carry):
        if comp:
            t, vv, h, k1, k1_st, resid, chk, cc, status, n_sub = carry
        else:
            t, vv, h, k1, k1_st, resid, chk, status, n_sub = carry
        # Step sizes are non-differentiated control state: the adjoint of
        # an adaptive integrator is the discrete adjoint of the FROZEN
        # accepted-substep sequence (differentiating the error controller
        # adds only O(local-error) terms and couples every step to every
        # earlier one through the h carry).  stop_gradient here cuts the
        # entire controller chain (err -> err_ratio -> factor -> h) out of
        # the backward pass; primal values are unchanged.
        h_try = jax.lax.stop_gradient(jnp.minimum(h, sout - t))
        v5, dv5, err, rhs_status, k7, k7_st, resid5, chk5 = _dopri_step(
            f, f_check, t, vv, h_try, k1, k1_st)

        tol = ab + rel * jnp.maximum(jnp.abs(vv), jnp.abs(v5))
        err_ratio = jnp.max(jnp.abs(err) / tol)
        accept = (err_ratio <= 1.0) & (rhs_status == 0)

        t_new = jnp.where(accept, t + h_try, t)
        if comp:
            from rays_tpu.tracing.compensated import two_sum_add

            vc, cc5 = two_sum_add(vv, cc, dv5)
            v_new = jnp.where(accept, vc, vv)
            cc_new = jnp.where(accept, cc5, cc)
        else:
            v_new = jnp.where(accept, v5, vv)
        k1_new = jnp.where(accept, k7, k1)
        k1_st_new = jnp.where(accept, k7_st, k1_st)
        resid_new = jnp.where(accept, resid5, resid)
        chk_new = jnp.where(accept, chk5, chk)

        safe_ratio = jnp.maximum(err_ratio, constants.SAFE_TINY)
        factor = jnp.clip(_SAFETY * safe_ratio ** (-0.2), _MIN_FACTOR, _MAX_FACTOR)
        h_new = jax.lax.stop_gradient(jnp.maximum(h_try * factor, h_min))

        status = jnp.where(rhs_status != 0, rhs_status, status)
        status = jnp.where(
            (~accept) & (h_try <= h_min) & (status == 0),
            jnp.int32(StopCode.ODE_TOTAL_ERROR), status,
        )
        if comp:
            return (t_new, v_new, h_new, k1_new, k1_st_new, resid_new,
                    chk_new, cc_new, status, n_sub + 1)
        return (t_new, v_new, h_new, k1_new, k1_st_new, resid_new, chk_new,
                status, n_sub + 1)

    h_start = jnp.clip(h0, h_min, jnp.abs(ds))
    if comp:
        init = (s, v, h_start, f1, st1, jnp.zeros((), dt),
                jnp.int32(StopCode.OK), c0, jnp.int32(StopCode.OK),
                jnp.int32(0))
    else:
        init = (s, v, h_start, f1, st1, jnp.zeros((), dt),
                jnp.int32(StopCode.OK), jnp.int32(StopCode.OK), jnp.int32(0))
    n_scan = int(getattr(cfg, "sg_scan_substeps", 0))
    if n_scan > 0:
        # reverse-differentiable form: a fixed budget of masked substeps
        # replaces the while_loop (lax.while_loop has no reverse-mode
        # rule).  The substep budget becomes n_scan; the post-loop
        # ODE_TOTAL_ERROR check below still fires if a ray needed more.
        # UNROLLED in Python rather than lax.scan: under the production
        # tracer's per-outer-step remat, reverse-of-scan would write every
        # substep's residuals (stage linearization points) to device
        # memory, while straight-line code stays register/fusion-resident
        # exactly like the RK4 body (ROADMAP 1.3 re-measures the cost).
        carry = init
        for _ in range(n_scan):
            done = ~cond(carry)
            new = body(carry)
            keep = lambda a, b: jnp.where(done, a, b)
            carry = tuple(map(keep, carry, new))
    else:
        carry = jax.lax.while_loop(cond, body, init)
    if comp:
        t_f, v_f, h_f, k_f, k_st_f, resid_f, chk_f, c_f, status, _ = carry
    else:
        t_f, v_f, h_f, k_f, k_st_f, resid_f, chk_f, status, _ = carry
    # substep budget exhausted without reaching sout -> tolerance failure
    status = jnp.where(
        (status == 0) & (sout - t_f > done_tol),
        jnp.int32(StopCode.ODE_TOTAL_ERROR), status,
    )
    if comp:
        return v_f, status, h_f, k_f, k_st_f, resid_f, chk_f, c_f
    return v_f, status, h_f, k_f, k_st_f, resid_f, chk_f
