"""Compensated (Neumaier/Kahan) accumulation for the scan carry.

The f32-with-compensated-summation mode (SURVEY.md §7.3 item 6), for
devices where f64 costs a multiple of f32.  TwoSumming each ``v += dv``
increment into a running compensation vector removes the accumulation
rounding against the large carried state for ~4 extra adds/subs per
element.  MEASURED RESULT (scripts/precision_probe.py ->
artifacts/precision_probe.txt, recorded in BASELINE.md): on the slab
ECH cases this does NOT shrink the f32-vs-f64 end error (1.00x),
because the dominant error is stage-state quantization — every RK
stage state ``v + h*a*k`` is rounded to f32 ulp inside the step, which
no summation scheme can remove while the state itself is f32.  The
mode is kept, tested for its mechanics (tests/test_precision.py), and
available for workloads where the accumulation term dominates (very
long traces at large |v|); the 1e-9-tolerance parity tier stays on
f64.

The reference integrates everything in f64 (`real(KIND=rkind)`,
constants_m.f90) and never needed this; it is an f32 answer to the
same accuracy contract (e.g. the Solovev SG example's 1e-9
tolerances, solovev_ECH_90GHz_minus_root.in:50-80).

XLA preserves IEEE semantics (no reassociation) so the error term
``(v - t) + dv`` survives compilation; this is the standard Neumaier
branch-free form, branchless via ``where`` for lockstep rays.
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum_add(v, c, dv):
    """One compensated accumulation step: returns (t, c_new) with
    t = fl(v + dv) and c_new = c + (exact error of that sum).
    The mathematically accumulated state is t + c_new to ~2 ulp^2."""
    t = v + dv
    # Neumaier: the branch on |v| >= |dv| picks which operand's low bits
    # were lost; both branches are exact by Sterbenz-style analysis
    e = jnp.where(jnp.abs(v) >= jnp.abs(dv), (v - t) + dv, (dv - t) + v)
    return t, c + e


def resolved(v, c):
    """The best available value of the compensated state, summed in f64
    (host/output boundary only — on-device f32 would round c away)."""
    return v.astype(jnp.float64) + c.astype(jnp.float64)
