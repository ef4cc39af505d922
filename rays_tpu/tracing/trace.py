"""Batched ray tracing: `lax.scan` over steps, `vmap` over rays.

Re-design of the reference driver loop (reference RAYS_project/RAYS_lib/
ray_tracing.f90): the OpenMP `parallel do` over rays becomes a vmapped batch
(shardable over a device mesh, see rays_tpu.parallel); the per-ray
`trajectory:` loop becomes one `lax.scan` of length nstep_max with
mask-and-freeze stop semantics — a stopped ray's state is frozen and its
subsequent steps are masked out, reproducing the reference's early exits
with fixed shapes.

Stop-check ordering per outer step matches ray_tracing.f90:116-245:
  1. sout > s_max           (before stepping, :128-147)
  2. step budget            (scan length; flag NSTEP_MAX if still live)
  3. stops inside the solver (RHS statuses, :177-197)
  4. check_save stops        (residual / absorption, :212-234)
A step rejected by (3) or (4) does not update the ray state and is not
recorded — same as the reference, which exits `trajectory` before the
`ray_vec(:,nstep+1,:)` write.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from rays_tpu.tracing import compensated, rhs as rhs_mod
from rays_tpu.tracing import rk4, rk45
from rays_tpu.tracing.stop import StopCode


class RayResults(NamedTuple):
    """Pytree analog of the reference results store
    (ray_results_m.f90:44-58)."""

    ray_vec: Any            # (B, nstep_max+1, nv); zeros beyond npoints
    residual: Any           # (B, nstep_max+1)
    npoints: Any            # (B,) int32
    stop_flag: Any          # (B,) int32 StopCode
    initial_ray_power: Any  # (B,)
    end_residuals: Any      # (B,)
    max_residuals: Any      # (B,)
    end_ray_parameter: Any  # (B,)
    start_ray_vec: Any      # (B, nv)
    end_ray_vec: Any        # (B, nv)
    # compensated-summation residual of end_ray_vec (cfg.compensated_sum:
    # the accumulated state is end_ray_vec + end_ray_comp, to be summed in
    # f64 at output boundaries — tracing/compensated.resolved); None when
    # the mode is off
    end_ray_comp: Any = None


def get_step_fn(cfg):
    if cfg.ode_solver_name == "RK4_ODE":
        return rk4.rk4_step
    if cfg.ode_solver_name == "SG_ODE":
        # batched adaptive equivalent of the Shampine-Gordon suite
        return rk45.rk45_step
    raise ValueError(f"invalid ode solver {cfg.ode_solver_name}")


def get_carried_step_fn(cfg):
    """Stepper taking (s, v, h, f1, st1) with the first stage supplied from
    the previous step's shared endpoint evaluation."""
    if cfg.ode_solver_name == "RK4_ODE":
        return rk4.rk4_step_carried
    if cfg.ode_solver_name == "SG_ODE":
        return rk45.rk45_step_carried
    raise ValueError(f"invalid ode solver {cfg.ode_solver_name}")


def trace_rays(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Driver-level tracer (the analog of the reference's trace_rays,
    ray_tracing.f90:1): the jitted `trace_batch` scan, compiled once per
    cfg.  Inside jitted code (adjoints, sharded tracers) call trace_batch
    directly."""
    return _jitted_tracer(cfg)(params, v0, status0, pwr_wt)


@functools.lru_cache(maxsize=64)
def _jitted_tracer(cfg):
    """Per-cfg compiled tracer: repeat trace_rays calls (scans, iterative
    workflows) reuse the executable instead of retracing each time."""
    return jax.jit(lambda p, v, st, w: trace_batch(cfg, p, v, st, w))


def trace_batch(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Trace a batch of rays.  v0: (B, nv); status0: (B,) int32 (nonzero
    entries — e.g. padding rays — never start); pwr_wt: (B,).

    The scan carries (f1, st1) = eqn_ray at the current point: the endpoint
    evaluation that feeds check_save also supplies the next step's first
    stage (rhs.eqn_ray_and_check), so each outer step pays 4 equilibrium
    evaluations instead of the reference's 5 (check_save.f90 re-evaluates
    what eqn_ray's next k1 recomputes)."""
    sg = cfg.ode_solver_name == "SG_ODE"
    comp = bool(getattr(cfg, "compensated_sum", False))
    ds, s_max = params.ode.ds, params.ode.s_max

    combined_v = jax.vmap(
        lambda s, v: rhs_mod.eqn_ray_and_check(cfg, params, s, v),
        in_axes=(None, 0))
    if sg:
        # the adaptive stepper's FSAL 7th stage IS the endpoint
        # evaluation: it returns the next step's first stage AND the
        # check_save values from the same equilibrium eval
        if comp:
            step_full_v = jax.vmap(
                lambda s, v, h, f1, st1, c: rk45.rk45_step_carried_full(
                    cfg, params, s, v, h, f1, st1, c),
                in_axes=(None, 0, 0, 0, 0, 0))
        else:
            step_full_v = jax.vmap(
                lambda s, v, h, f1, st1: rk45.rk45_step_carried_full(
                    cfg, params, s, v, h, f1, st1),
                in_axes=(None, 0, 0, 0, 0))
    else:
        if comp:
            step_delta_v = jax.vmap(
                lambda s, v, h, f1, st1: rk4.rk4_step_carried_delta(
                    cfg, params, s, v, h, f1, st1),
                in_axes=(None, 0, 0, 0, 0))
        else:
            step_v = jax.vmap(
                lambda s, v, h, f1, st1: rk4.rk4_step_carried(
                    cfg, params, s, v, h, f1, st1),
                in_axes=(None, 0, 0, 0, 0))

    # initial validity check (ray_tracing.f90:100-112); the initial residual
    # is recorded as 0 ("assume initial k solves the dispersion relation",
    # ray_tracing.f90:93).  The same evaluation seeds the first step's k1.
    f1_0, st1_0, _, chk0 = combined_v(jnp.zeros((), v0.dtype), v0)
    status = jnp.where(status0 != 0, status0, chk0)

    def body(carry, k):
        if comp:
            v, f1, st1, hstate, status, nstep, end_res, max_res, cvec = carry
        else:
            v, f1, st1, hstate, status, nstep, end_res, max_res = carry
        s = k.astype(v.dtype) * ds
        sout = (k + 1).astype(v.dtype) * ds

        active = status == 0
        status = jnp.where(
            active & (sout > s_max), jnp.int32(StopCode.SOUT_GT_SMAX), status
        )
        active = status == 0

        c_new = None
        if sg:
            if comp:
                (v_new, solver_st, h_new, f_new, rhs_st_new, resid,
                 check_st, c_new) = step_full_v(s, v, hstate, f1, st1, cvec)
            else:
                (v_new, solver_st, h_new, f_new, rhs_st_new, resid,
                 check_st) = step_full_v(s, v, hstate, f1, st1)
        else:
            if comp:
                dv, solver_st, h_new = step_delta_v(s, v, hstate, f1, st1)
                v_new, c_new = compensated.two_sum_add(v, cvec, dv)
            else:
                v_new, solver_st, h_new = step_v(s, v, hstate, f1, st1)
            f_new, rhs_st_new, resid, check_st = combined_v(sout, v_new)
        status = jnp.where(active & (solver_st != 0), solver_st, status)
        accepted = active & (solver_st == 0)
        status = jnp.where(accepted & (check_st != 0), check_st, status)
        ok = accepted & (check_st == 0)

        if comp:
            cvec = jnp.where(ok[:, None], c_new, cvec)
        v = jnp.where(ok[:, None], v_new, v)
        # the endpoint RHS (and its status) becomes the next step's k1; a
        # frozen ray keeps the stage matching its frozen state
        f1 = jnp.where(ok[:, None], f_new, f1)
        st1 = jnp.where(ok, rhs_st_new, st1)
        # adaptive stepper state (converged h) persists across outer steps
        hstate = jnp.where(ok, h_new, hstate)
        nstep = nstep + ok.astype(jnp.int32)
        end_res = jnp.where(ok, resid, end_res)
        max_res = jnp.where(ok, jnp.maximum(max_res, resid), max_res)

        if cfg.save_trajectory:
            out = (jnp.where(ok[:, None], v, 0.0), jnp.where(ok, resid, 0.0), ok)
        else:
            out = None  # summaries live in the carry: no per-step writes
        if comp:
            return (v, f1, st1, hstate, status, nstep, end_res, max_res,
                    cvec), out
        return (v, f1, st1, hstate, status, nstep, end_res, max_res), out

    B = v0.shape[0]
    zero = jnp.zeros((B,), v0.dtype)
    h0 = jnp.full((B,), ds, v0.dtype)
    init = (v0, f1_0, st1_0, h0, status, jnp.zeros((B,), jnp.int32), zero, zero)
    if comp:
        init = init + (jnp.zeros_like(v0),)
    # rematerialize per-step internals on the backward pass: reverse-mode
    # through the scan then stores only the (small) carry per step instead
    # of every RK stage/equilibrium intermediate — the memory strategy of
    # SURVEY.md §5.7 that makes production-scale adjoints fit in device
    # memory.
    if getattr(cfg, "remat_steps", True):
        body = jax.checkpoint(body, prevent_cse=False)
    final, outs = jax.lax.scan(body, init, jnp.arange(cfg.nstep_max))
    if comp:
        (v_f, _, _, _, status_f, nstep_f, end_res, max_res, c_f) = final
    else:
        (v_f, _, _, _, status_f, nstep_f, end_res, max_res) = final
        c_f = None

    # still-live rays exhausted the step budget (ray_tracing.f90:150-172)
    status_f = jnp.where(status_f == 0, jnp.int32(StopCode.NSTEP_MAX), status_f)

    if cfg.save_trajectory:
        vs, resids, oks = outs
        ray_vec = jnp.concatenate([v0[:, None, :], jnp.moveaxis(vs, 0, 1)], axis=1)
        residual = jnp.concatenate(
            [jnp.zeros((B, 1), v0.dtype), jnp.moveaxis(resids, 0, 1)], axis=1
        )
    else:
        ray_vec = jnp.zeros((B, 1, v0.shape[1]), v0.dtype)
        residual = jnp.zeros((B, 1), v0.dtype)

    npoints = 1 + nstep_f
    # end/max residual over accepted points (kept in the scan carry).
    # (The reference's end/max indexing is off by one at the boundary,
    # ray_results writes residual(nstep,iray) — we use the last accepted
    # point, which is what its plots consume.)

    return RayResults(
        ray_vec=ray_vec,
        residual=residual,
        npoints=npoints,
        stop_flag=status_f,
        initial_ray_power=pwr_wt,
        end_residuals=end_res,
        max_residuals=max_res,
        end_ray_parameter=v_f[:, 6],
        start_ray_vec=v0,
        end_ray_vec=v_f,
        end_ray_comp=c_f,
    )
