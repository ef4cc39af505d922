"""Fixed-step RK4 over one outer step, branch-free.

Mirrors reference RAYS_project/RAYS_lib/RK4_ode_m.f90:59-94: four RHS
evaluations per ds; the reference aborts (leaving v unchanged) if any stage
flags a stop.  Here all four stages are computed unconditionally
(branchless lockstep across the vmapped ray batch) and the first-flagged
stage status wins; on any nonzero status the caller keeps the old v.
"""

from __future__ import annotations

import jax.numpy as jnp

from rays_tpu.tracing import rhs as rhs_mod


def _first_nonzero(*codes):
    out = codes[0]
    for c in codes[1:]:
        out = jnp.where(out != 0, out, c)
    return out


def rk4_step(cfg, params, s, v, h=None):
    """One RK4 step of size params.ode.ds.  Returns (v_new, status, h) —
    the stepper-state slot ``h`` is unused (RK4 keeps no state between
    outer steps, RK4_ode_m.f90:50-55) and passed through for interface
    uniformity with the adaptive stepper."""
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    return rk4_step_carried(cfg, params, s, v, h, f1, st1)


def rk4_step_carried(cfg, params, s, v, h, f1, st1):
    """RK4 step with the first stage (f1, st1) = eqn_ray(s, v) supplied by
    the caller — the production tracer carries it from the previous step's
    shared endpoint evaluation (rhs.eqn_ray_and_check), cutting the
    per-step equilibrium evals from 5 to 4."""
    dv, status, h = rk4_step_carried_delta(cfg, params, s, v, h, f1, st1)
    return v + dv, status, h


def rk4_step_carried_delta(cfg, params, s, v, h, f1, st1):
    """Increment form: returns (dv, status, h) with v_new = v + dv.  The
    compensated-summation tracer (trace.py, cfg.compensated_sum) needs the
    raw increment so it can TwoSum it into the carried state instead of
    losing the low bits of v + dv to f32 rounding."""
    ds = params.ode.ds
    f = lambda ss, vv: rhs_mod.eqn_ray(cfg, params, ss, vv)
    f2, st2 = f(s + ds / 2.0, v + ds * f1 / 2.0)
    f3, st3 = f(s + ds / 2.0, v + ds * f2 / 2.0)
    f4, st4 = f(s + ds, v + ds * f3)
    status = _first_nonzero(st1, st2, st3, st4)
    dv = ds * (f1 + 2.0 * f2 + 2.0 * f3 + f4) / 6.0
    return dv, status, h
