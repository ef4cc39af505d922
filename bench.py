"""Benchmark: rays/s per device for batched ray tracing, forward and
adjoint, analytic and spline geometries.

Prints ONE JSON line.  The headline metric is the f32 forward trace through
the XLA scan; `extra` carries:

  * the scan forward in both precisions (f32 production, f64 parity),
  * forward+adjoint throughput in both precisions (rematerialized scan),
  * an honest FLOP estimate: XLA's cost_analysis reports a while-loop body
    ONCE regardless of trip count, so per-ray-step FLOPs are counted from
    the jaxpr of one RK4 step + residual check and multiplied out,
  * the BASELINE.md headline experiment: 1e5 rays with full adjoint,
    wall-clock vs the pinned single-core Fortran estimate for 100 rays,
  * a spline (gather-bound) geometry: the MPEX mirror example traced at
    production batch size in both precisions.

Baseline note: the reference (ORNL-Fusion/RAYS, Fortran/OpenMP) publishes
no benchmark numbers (BASELINE.md).  ``vs_baseline`` is measured against a
pinned single-core Fortran throughput estimate for the same problem
(500-step ray, ~2 RHS evals/step Adams or 4 RK4, ~1-2 us per equilibrium +
deriv eval on a modern x86 core -> ~1e3 rays/s); recorded here explicitly
so the ratio is reproducible and honest.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp

import rays_tpu  # noqa: F401
from rays_tpu import examples
from rays_tpu.tracing import trace as trace_mod

# Pinned single-core Fortran estimate, see above.  Epistemic status: this
# is a reasoned ESTIMATE, not a measurement — no Fortran toolchain exists
# in this environment and the reference publishes no numbers (PARITY.md
# header); vs_baseline ratios inherit that caveat.
BASELINE_RAYS_PER_S = 1.0e3
# BASELINE.md headline: 1e5 rays + full adjoint in under the Fortran
# wall-clock for 100 rays = 100 / BASELINE_RAYS_PER_S seconds
HEADLINE_RAYS = 100_000
HEADLINE_BUDGET_S = 100 / BASELINE_RAYS_PER_S
N_RAYS = int(os.environ.get("RAYS_TPU_BENCH_RAYS", 32768))
N_STEPS = 500
MPEX_DIR = ("/root/reference/examples_RAYS/MPEX_examples/"
            "MPX_2nd_harm_11_rays_nz_delta_d_0.05_psiP_0.05")


def _cast(tree, dt):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dt)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        tree,
    )


def _time(fn, *args, n_rep=3):
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_rep, out


def _time_sustained(fn, *args, n_call=5, n_rep=3):
    """Wall per call of n_call back-to-back async dispatches, blocked
    once; best of n_rep."""
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(n_call)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / n_call)
    return best


_ARITH_PRIMS = {
    "add", "sub", "mul", "div", "neg", "max", "min", "pow", "integer_pow",
    "sqrt", "rsqrt", "exp", "log", "abs", "sign", "floor", "ceil", "round",
    "select_n", "clamp", "erf", "tanh", "logistic", "dot_general",
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "cumsum",
    "atan2", "sin", "cos", "expm1", "log1p", "square",
}


def _jaxpr_flops(jaxpr) -> float:
    """Arithmetic-op count of a jaxpr, elements x ops, recursing into
    sub-jaxprs (pjit/custom_jvp/scan bodies x their trip counts where
    known).  XLA's own cost_analysis cannot be used here: it reports a
    while-loop body ONCE, independent of trip count, so the scan tracer's
    FLOPs come out ~nstep_max too small (the round-2 bug)."""
    import numpy as _np

    total = 0.0
    for eqn in jaxpr.eqns:
        mult = 1.0
        sub = []
        for k, v in eqn.params.items():
            if hasattr(v, "jaxpr"):
                sub.append(v.jaxpr if hasattr(v.jaxpr, "eqns") else v)
            elif isinstance(v, (list, tuple)):
                sub.extend(x.jaxpr for x in v if hasattr(x, "jaxpr"))
        if eqn.primitive.name == "scan":
            mult = float(eqn.params.get("length", 1))
        if sub:
            total += mult * sum(_jaxpr_flops(s) for s in sub)
        if eqn.primitive.name in _ARITH_PRIMS:
            out = eqn.outvars[0].aval
            total += float(_np.prod(out.shape)) if out.shape else 1.0
    return total


def _count_gathers(jaxpr) -> int:
    """Number of gather ops in a jaxpr (recursing into sub-jaxprs x scan
    trip counts).  Built from the per-ray step jaxpr, each gather op
    fetches one row per ray — so this count IS gathers/ray/step."""
    total = 0
    for eqn in jaxpr.eqns:
        mult = 1
        sub = []
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):
                sub.append(v.jaxpr if hasattr(v.jaxpr, "eqns") else v)
            elif isinstance(v, (list, tuple)):
                sub.extend(x.jaxpr for x in v if hasattr(x, "jaxpr"))
        if eqn.primitive.name == "scan":
            mult = int(eqn.params.get("length", 1))
        if sub:
            total += mult * sum(_count_gathers(s) for s in sub)
        if eqn.primitive.name in ("gather", "dynamic_slice"):
            total += 1
    return total


def _step_gathers(cfg, params, v0):
    """Gathers per ray per outer step of the production scan body (one
    carried-stage RK4 step + the shared endpoint eval)."""
    from rays_tpu.tracing import rhs as rhs_mod, rk4

    v = v0[0]
    h = jnp.zeros((), v.dtype)
    s = jnp.zeros((), v.dtype)
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    step_jx = jax.make_jaxpr(
        lambda vv, ff: rk4.rk4_step_carried(cfg, params, s, vv, h, ff, st1))(
            v, f1)
    end_jx = jax.make_jaxpr(
        lambda vv: rhs_mod.eqn_ray_and_check(cfg, params, s, vv))(v)
    return _count_gathers(step_jx.jaxpr) + _count_gathers(end_jx.jaxpr)


def _measure_gather_rate(n_rows=N_RAYS, iters=200, row_width=48, k_ind=8):
    """Measured gather THROUGHPUT (row-gathers/s) in the production
    regime: per scan iteration, ``k_ind`` INDEPENDENT batched single-axis
    row gathers (jnp.take) from a device-memory table — matching the
    production step, which issues its ~8 cell-coefficient gathers per
    eval with no dependency between them (ops/splines.py,
    start_index_map={0}).  Indices advance by a loop-carried +1 so the
    gathers cannot be hoisted, but stay data-INdependent: a
    data-dependent index chain serializes the gathers and understates
    the bound ~2x (measured round 5 — the spline tracers then sat at
    '2.1x of the roofline', i.e. the old number was not a roofline)."""
    table = jnp.arange(4096 * row_width, dtype=jnp.float32
                       ).reshape(4096, row_width)
    idx0 = jnp.arange(n_rows, dtype=jnp.int32) % 4096

    def body(i, _):
        acc = jnp.zeros((n_rows,), jnp.float32)
        for k in range(k_ind):
            rows = jnp.take(table, (i + k * 37) % 4096, axis=0)
            acc = acc + rows[:, 0]
        return (i + 1) % 4096, acc

    run = jax.jit(lambda i0: jax.lax.scan(body, i0, None, length=iters))
    sec, _ = _time(run, idx0)
    return k_ind * n_rows * iters / sec


def _step_flops(cfg, params, v0):
    """FLOPs per ray per outer step, mirroring the production scan body:
    one carried-stage RK4 step (3 fresh RHS evals) + the shared endpoint
    evaluation (RHS + check from one equilibrium eval)."""
    from rays_tpu.tracing import rhs as rhs_mod, rk4

    v = v0[0]
    h = jnp.zeros((), v.dtype)
    s = jnp.zeros((), v.dtype)
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    step_jx = jax.make_jaxpr(
        lambda vv, ff: rk4.rk4_step_carried(cfg, params, s, vv, h, ff, st1))(
            v, f1)
    end_jx = jax.make_jaxpr(
        lambda vv: rhs_mod.eqn_ray_and_check(cfg, params, s, vv))(v)
    return _jaxpr_flops(step_jx.jaxpr) + _jaxpr_flops(end_jx.jaxpr)


def bench_slab(extra):
    cfg, params, v0, status0, pwr = examples.setup_example()
    cfg = dataclasses.replace(cfg, nstep_max=N_STEPS, save_trajectory=False)
    v0, status0, pwr = examples.replicate_rays(v0, status0, pwr, N_RAYS)

    # --- forward XLA scan, f64 and f32 ---
    fwd_times = {}
    p32 = v32 = w32 = None
    for dt, tag in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        p, v, w = _cast(params, dt), _cast(v0, dt), _cast(pwr, dt)
        if tag == "f32":
            p32, v32, w32 = p, v, w
        tracer = jax.jit(
            lambda p, v, st, w: trace_mod.trace_batch(cfg, p, v, st, w))
        sec, _ = _time(tracer, p, v, status0, w)
        fwd_times[tag] = sec
        extra[f"rays_per_s_forward_{tag}_scan"] = round(N_RAYS / sec, 1)

    # per-batch FLOPs (f32) counted from the jaxpr, and the achieved rate
    try:
        per_ray_step = _step_flops(cfg, p32, v32)
        flops = per_ray_step * N_RAYS * N_STEPS
        extra["est_flops_per_ray_step"] = round(per_ray_step, 1)
        extra["est_flops_per_batch"] = flops
        extra["flops_per_sec_f32"] = round(flops / fwd_times["f32"], 1)
    except Exception as e:  # noqa: BLE001  (estimate is best-effort)
        extra["flops_note"] = f"flop estimate unavailable: {e}"

    # --- compensated-summation mode (tracing/compensated.py): measured
    # overhead of the TwoSum carry; trajectories are bit-identical to
    # plain f32 (accuracy findings: BASELINE.md precision section) ---
    cfg_comp = dataclasses.replace(cfg, compensated_sum=True)
    tracer_c = jax.jit(
        lambda p, v, st, w: trace_mod.trace_batch(cfg_comp, p, v, st, w))
    sec_c, _ = _time(tracer_c, p32, v32, status0, w32)
    extra["rays_per_s_forward_f32_compensated"] = round(N_RAYS / sec_c, 1)

    # --- saturated-batch forward (the throughput ceiling; the batch-size
    # sweep artifact is scripts/run_batch_scan.py -> artifacts/) ---
    vP, sP, wP = examples.replicate_rays(v0, status0, pwr, 262144)
    tracer32 = jax.jit(
        lambda p, v, st, w: trace_mod.trace_batch(cfg, p, v, st, w))
    vP32, wP32 = vP.astype(jnp.float32), wP.astype(jnp.float32)
    secP, _ = _time(tracer32, p32, vP32, sP, wP32)
    extra["rays_per_s_forward_f32_peak_batch"] = round(262144 / secP, 1)

    # --- sustained forward: back-to-back calls ---
    secS = _time_sustained(tracer32, p32, vP32, sP, wP32)
    extra["rays_per_s_forward_f32_sustained"] = round(262144 / secS, 1)
    extra["dispatch_overhead_s_est"] = round(max(secP - secS, 0.0), 4)

    # --- forward + adjoint (rematerialized scan), f64 and f32 ---
    def loss_fn(p, v, st, w):
        res = trace_mod.trace_batch(cfg, p, v, st, w)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * w[:, None])

    grad_step = jax.jit(jax.value_and_grad(loss_fn))
    for (p, v, w), tag in (((params, v0, pwr), "f64"),
                           ((p32, v32, w32), "f32")):
        sec_adj, _ = _time(grad_step, p, v, status0, w)
        extra[f"rays_per_s_adjoint_{tag}"] = round(N_RAYS / sec_adj, 1)
        extra[f"adjoint_over_forward_{tag}"] = round(
            sec_adj / fwd_times[tag], 2)

    # --- the 1e5-ray adjoint, one device, f32 ---
    vh, sh, wh = examples.replicate_rays(v0, status0, pwr, HEADLINE_RAYS)
    vh, wh = vh.astype(jnp.float32), wh.astype(jnp.float32)
    sec_head, _ = _time(grad_step, p32, vh, sh, wh)
    extra["headline_adjoint_1e5_rays_f32_wall_s"] = round(sec_head, 4)
    extra["headline_budget_s"] = HEADLINE_BUDGET_S
    extra["headline_met_single_chip"] = bool(sec_head < HEADLINE_BUDGET_S)
    extra["headline_chips_needed_at_this_rate"] = max(
        1, int(-(-sec_head // HEADLINE_BUDGET_S)))
    # back-to-back calls of the same adjoint
    sec_head_s = _time_sustained(grad_step, p32, vh, sh, wh, n_call=3)
    extra["headline_adjoint_sustained_wall_s"] = round(sec_head_s, 4)
    extra["headline_chips_needed_at_sustained_rate"] = max(
        1, int(-(-sec_head_s // HEADLINE_BUDGET_S)))

    return N_RAYS / fwd_times["f32"], fwd_times["f32"]


def bench_sg_adaptive(extra):
    """The reference's daily-driver integration mode: SG_ODE (-> DP5(4)
    with PI control, SG_ode_m.f90:89-159) on the slab ECH case at the
    production batch, forward and adjoint f32."""
    text = examples.SLAB_ECH_90GHZ.replace(
        "ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
    cfg, params, v0, status0, pwr = examples.setup_example(text)
    cfg = dataclasses.replace(cfg, nstep_max=N_STEPS, save_trajectory=False)
    v0, status0, pwr = examples.replicate_rays(v0, status0, pwr, N_RAYS)
    p, v, w = (_cast(params, jnp.float32), _cast(v0, jnp.float32),
               _cast(pwr, jnp.float32))
    tracer = jax.jit(
        lambda p, v, st, w: trace_mod.trace_batch(cfg, p, v, st, w))
    sec, _ = _time(tracer, p, v, status0, w)
    extra["rays_per_s_sg_f32"] = round(N_RAYS / sec, 1)

    # adjoint: the substep while_loop has no reverse-mode rule, so the
    # differentiable fixed-length-scan form prices the adaptive adjoint.
    # A budget of 2 suffices for the slab at tol 1e-4 (every outer step
    # accepts its first substep) — verified by asserting full trajectories
    cfg_adj = dataclasses.replace(cfg, sg_scan_substeps=2)
    res_chk = jax.jit(
        lambda p, v, st, w: trace_mod.trace_batch(cfg_adj, p, v, st, w))(
            p, v, status0, w)
    assert int(jnp.min(res_chk.npoints)) == N_STEPS + 1, (
        "sg_scan_substeps budget too small for this case")

    def loss_fn(pp, vv, st, ww):
        res = trace_mod.trace_batch(cfg_adj, pp, vv, st, ww)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * ww[:, None])

    grad_step = jax.jit(jax.value_and_grad(loss_fn))
    sec_adj, _ = _time(grad_step, p, v, status0, w)
    extra["rays_per_s_sg_adjoint_f32"] = round(N_RAYS / sec_adj, 1)
    extra["sg_adjoint_over_forward_f32"] = round(sec_adj / sec, 2)


def bench_mirror_spline(extra):
    """Gather-bound spline geometry: the MPEX mirror example (the
    reference's hottest spline path, mirror_magnetics_spline_interp_m.f90:
    132-207), production batch — same N_RAYS as the slab row."""
    if not os.path.isdir(MPEX_DIR):
        extra["mirror_note"] = "MPEX example dir unavailable"
        return
    from rays_tpu import run as runner

    cfg, params, v0, status0, pwr = runner.setup(
        os.path.join(MPEX_DIR, "rays.in"))
    cfg = dataclasses.replace(cfg, nstep_max=N_STEPS, save_trajectory=False)
    n = N_RAYS
    v0, status0, pwr = examples.replicate_rays(v0, status0, pwr, n)
    sec32 = None
    for dt, tag in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        p, v, w = _cast(params, dt), _cast(v0, dt), _cast(pwr, dt)
        tracer = jax.jit(
            lambda p, v, st, w: trace_mod.trace_batch(cfg, p, v, st, w))
        sec, _ = _time(tracer, p, v, status0, w)
        extra[f"rays_per_s_mirror_spline_{tag}"] = round(n / sec, 1)
        if tag == "f32":
            sec32 = sec

    # adjoint through the spline geometry: gradients w.r.t. the field-cell
    # coefficients (i.e. the measured Brz data) and all profile params
    p32, v32, w32 = (_cast(params, jnp.float32), _cast(v0, jnp.float32),
                     _cast(pwr, jnp.float32))

    def loss_fn(pp, vv, st, ww):
        res = trace_mod.trace_batch(cfg, pp, vv, st, ww)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * ww[:, None])

    grad_step = jax.jit(jax.value_and_grad(loss_fn))
    sec_adj, _ = _time(grad_step, p32, v32, status0, w32)
    extra["rays_per_s_mirror_adjoint_f32"] = round(n / sec_adj, 1)
    extra["mirror_adjoint_over_forward_f32"] = round(sec_adj / sec32, 2)

    # gather roofline: the spline path is bound by the gather point rate,
    # not the flop rate — state the bound next to the measurement
    try:
        g_per_step = _step_gathers(cfg, p32, v32)
        rate = extra.get("measured_gather_points_per_s") or \
            _measure_gather_rate()
        extra["measured_gather_points_per_s"] = round(rate, 0)
        extra["mirror_gathers_per_ray_step"] = g_per_step
        bound = rate / (g_per_step * N_STEPS)
        extra["mirror_gather_roofline_rays_per_s"] = round(bound, 1)
        extra["mirror_fraction_of_gather_roofline"] = round(
            (n / sec32) / bound, 3)
    except Exception as e:  # noqa: BLE001
        extra["mirror_gather_note"] = f"gather roofline unavailable: {e}"


def bench_eqdsk_toroid(extra):
    """The reference's hottest tokamak spline path: psi(R,Z) 2-D spline +
    1-D profile splines (eqdsk_magnetics_spline_interp_m.f90:206-286),
    from a solovev_2_eqdsk-generated 129x129 EQDSK, production batch."""
    import tempfile

    from rays_tpu import run as runner
    from rays_tpu.config import schema
    from rays_tpu.config.namelist import parse_namelist
    from rays_tpu.rayinit import vector as init_vector
    from rays_tpu.utils import solovev_2_eqdsk
    from rays_tpu.utils.eqdsk_io import write_geqdsk

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "solovev.geqdsk")
        write_geqdsk(path, solovev_2_eqdsk.solovev_geqdsk(
            rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3, outer_bound=1.55,
            nrbox=129, nzbox=129))
        cfg, params = schema.from_namelist(parse_namelist(
            examples.EQDSK_TOROID_TMPL.format(EQDSK=path)))
    rvec0, rindex0, pwr = runner.init_rays(cfg, params)
    v0 = init_vector.initial_ode_vectors(cfg, params, rvec0, rindex0)
    status0 = jnp.zeros((v0.shape[0],), jnp.int32)
    cfg = dataclasses.replace(cfg, nstep_max=N_STEPS, save_trajectory=False)
    n = N_RAYS
    v0, status0, pwr = examples.replicate_rays(v0, status0, pwr, n)
    p, v, w = (_cast(params, jnp.float32), _cast(v0, jnp.float32),
               _cast(pwr, jnp.float32))
    tracer = jax.jit(
        lambda p, v, st, w: trace_mod.trace_batch(cfg, p, v, st, w))
    sec, _ = _time(tracer, p, v, status0, w)
    extra["rays_per_s_eqdsk_toroid_f32"] = round(n / sec, 1)

    # adjoint through the EQDSK spline path: gradients w.r.t. the psi
    # cell coefficients (i.e. the equilibrium reconstruction) and all
    # profile params
    def loss_fn(pp, vv, st, ww):
        res = trace_mod.trace_batch(cfg, pp, vv, st, ww)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * ww[:, None])

    grad_step = jax.jit(jax.value_and_grad(loss_fn))
    sec_adj, _ = _time(grad_step, p, v, status0, w)
    extra["rays_per_s_eqdsk_adjoint_f32"] = round(n / sec_adj, 1)
    extra["eqdsk_adjoint_over_forward_f32"] = round(sec_adj / sec, 2)

    # gather roofline for the folded psi-cell fetch
    try:
        g_per_step = _step_gathers(cfg, p, v)
        rate = extra.get("measured_gather_points_per_s") or \
            _measure_gather_rate()
        extra["measured_gather_points_per_s"] = round(rate, 0)
        extra["eqdsk_gathers_per_ray_step"] = g_per_step
        bound = rate / (g_per_step * N_STEPS)
        extra["eqdsk_gather_roofline_rays_per_s"] = round(bound, 1)
        extra["eqdsk_fraction_of_gather_roofline"] = round(
            (n / sec) / bound, 3)
    except Exception as e:  # noqa: BLE001
        extra["eqdsk_gather_note"] = f"gather roofline unavailable: {e}"


def main():
    extra = {}
    rays_per_s, sec = bench_slab(extra)
    bench_sg_adaptive(extra)
    bench_mirror_spline(extra)
    bench_eqdsk_toroid(extra)

    print(json.dumps({
        "metric": "rays_per_s_per_chip_rk4_forward_f32",
        "value": round(rays_per_s, 1),
        "unit": (f"rays/s ({N_RAYS} rays x {N_STEPS} RK4 steps, f32 "
                 f"scan, slab ECH, {sec:.3f}s/batch)"),
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
