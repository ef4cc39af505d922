"""Run the tracer's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --four-gpus  # the sharded path on four GPUs, alone

Phases, all on one card and in this one process:

1. CLI to netCDF: a 4096-ray slab ECH launch fan through
   ``rays_tpu.run.main([path, "--netcdf"])``, read back and checked.
2. Slab RK4 forward at production width (32768 rays x 500 steps), f64 and
   f32: f64 end states against the NumPy oracle (tests/_oracle.py), f32 end
   states against f64.
3. Adjoint of the endpoint loss at 32768 rays (f32, f64) and 1e5 rays
   (f32); a 256-ray f64 gradient against the same program on the CPU.
4. Adaptive DP5(4) (SG_ODE) forward and fixed-budget adjoint, f32; a
   256-ray f64 forward against the same program on the CPU.
5. A generated 129x129 G-EQDSK equilibrium at 32768 rays, f32; 8 rays in
   f64 against the oracle's EQDSK equilibrium.

``--four-gpus`` runs only the sharded trace + deposition + adjoint of
``__graft_entry__.dryrun_multichip`` at 4 x 32768 rays, its unsharded
comparison on one card, and the check that the sharded forward HLO holds no
collectives.

The script prints the card's nvidia-smi name and power limit, and for every
compiled program its compile time, run time, rays/s and compiled memory.
Its last line is one JSON object ``{"ok": true, "device": {...}}``.  It
exits non-zero, printing no such line, when JAX finds no GPU or any phase
fails.  The CPU is used only as the named reference of phases 3 and 4.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

N_RAYS = 32768          # production batch (bench.py)
N_STEPS = 500
N_BIG = 100_000         # the 1e5-ray adjoint
N_CPU = 256             # rays compared against the CPU backend
FAN_SIDE = 16           # CLI fan: 16 x-launches x 16 n_y x 16 n_z rays

# Tolerances, each relative to the trajectory scale of its quantity:
# - two f64 implementations of the same formulas (package vs NumPy oracle)
#   differ by integrator rounding only (tests/test_parity.py);
ORACLE_RTOL = 1e-7
# - the spline path: same interpolant, independent implementations, ~1e-12
#   apart in B, grown along the trajectory (tests/test_parity.py);
EQDSK_RTOL = 1e-6
# - f32 against f64 after 500 RK4 steps: the f32 rounding floor of the
#   slab case (worst end-state drift on the CPU backend ~1e-4);
F32_RTOL = 5e-4
# - one f64 program on two backends differs in summation order, fused
#   multiply-adds and last-bit transcendentals; the smooth slab trajectory
#   amplifies that far less than to 1e-9;
GRAD_RTOL = 1e-9
# - the adaptive stepper on two backends: a changed summation order may
#   change an accept/reject decision, so end states agree only to the
#   controller's own tolerance (rel_err0 = abs_err0 = 1e-4);
SG_RTOL = 1e-4
# - the dispersion residual is the physics invariant of a trace.
RESID_MAX = 1e-6


def log(msg=""):
    print(msg, flush=True)


def _cast(tree, dt):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda x: x.astype(dt)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _mem(compiled):
    """compiled.memory_analysis() in MiB."""
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis unavailable"
    fields = (("args", "argument_size_in_bytes"),
              ("out", "output_size_in_bytes"),
              ("temp", "temp_size_in_bytes"),
              ("code", "generated_code_size_in_bytes"))
    return "memory " + " ".join(
        f"{name} {getattr(ma, attr, 0) / 2**20:.1f} MiB"
        for name, attr in fields)


def _peak():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" not in stats:
        return "peak n/a"
    return f"process peak {stats['peak_bytes_in_use'] / 2**30:.2f} GiB"


def _run(label, fn, args, n_rays):
    """Compile fn for args, run it once to warm up and once timed; log
    compile time, run time, rays/s and compiled memory."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = compiled(*args)
    jax.block_until_ready(out)
    t_run = time.perf_counter() - t0
    log(f"  {label}: compile {t_compile:.2f} s, run {t_run:.4f} s, "
        f"{n_rays / t_run:.1f} rays/s, {_mem(compiled)}, {_peak()}")
    return out, {"compile_s": t_compile, "run_s": t_run,
                 "rays_per_s": n_rays / t_run}


def _on_cpu(fn, args):
    """The same program on the CPU backend: the named reference."""
    import jax

    cpu = jax.devices("cpu")[0]
    out = jax.jit(fn)(*jax.device_put(args, cpu))
    return jax.block_until_ready(out)


def _spread(n_total, k):
    import numpy as np

    return np.unique(np.linspace(0, n_total - 1, k).round().astype(int))


def _slot_groups(nv):
    """Position, wavevector, then each further slot of the ODE vector."""
    return [slice(0, 3), slice(3, 6)] + [slice(i, i + 1) for i in range(6, nv)]


def _scale(*arrays):
    """Per-ray magnitude of a slot group over the given states."""
    import numpy as np

    return np.maximum(
        np.max([np.abs(a).max(axis=-1) for a in arrays], axis=0), 1e-12)


def _assert_close_to_scale(got, ref, starts, rtol, what):
    """End states agree per ray within rtol of each slot group's scale
    (position, wavevector, ray parameter and any further slot)."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    starts = np.asarray(starts, np.float64)
    worst = 0.0
    for g in _slot_groups(ref.shape[1]):
        err = (np.abs(got[:, g] - ref[:, g]).max(axis=-1)
               / _scale(ref[:, g], starts[:, g]))
        ir = int(err.argmax())
        assert err[ir] <= rtol, (
            f"{what}: slots {g.start}:{g.stop} differ by {err[ir]:.3e} "
            f"of scale on ray {ir} (limit {rtol:g})")
        worst = max(worst, float(err[ir]))
    return worst


def _oracle_end_states(cfg, params, oc, res, idx, rtol, atol_x=1e-9):
    """Trace rays idx with the NumPy oracle from the same start states and
    check npoints, stop flag and end state against res (test_parity's
    tolerances, taken relative to the oracle trajectory's scale)."""
    import numpy as np

    import _oracle as oracle
    from rays_tpu.tracing.stop import flag_string

    v0 = np.asarray(res.start_ray_vec, np.float64)
    end = np.asarray(res.end_ray_vec, np.float64)
    npts = np.asarray(res.npoints)
    flags = np.asarray(res.stop_flag)
    worst = 0.0
    for ir in idx:
        traj, _, flag = oracle.trace_ray(oc, v0[ir], cfg.nstep_max,
                                         float(params.ode.ds),
                                         float(params.ode.s_max))
        assert len(traj) == npts[ir], (ir, len(traj), npts[ir])
        assert flag == flag_string(flags[ir]), (ir, flag, flags[ir])
        for g in _slot_groups(traj.shape[1]):
            sc = max(1e-12, np.abs(traj[:, g]).max())
            err = np.abs(end[ir, g] - traj[-1, g]).max()
            tol = rtol * sc + (atol_x if g.start == 0 else 0.0)
            assert err <= tol, (
                f"ray {ir} slots {g.start}:{g.stop}: |repo - oracle| = "
                f"{err:.3e} > {tol:.3e}")
            worst = max(worst, err / sc)
    return worst


def _slab_fan_namelist(n_side, n_steps):
    """SLAB_ECH_90GHZ widened to an n_side^3 launch fan (x, n_y, n_z) of
    propagating rays whose residual stays at the 1e-8 level."""
    from rays_tpu import examples

    text = examples.SLAB_ECH_90GHZ
    for old, new in (
            ("nray_max=100", f"nray_max={n_side ** 3}"),
            ("n_x_launch=1, x_launch0=-0.08, dx_launch=0.4",
             f"n_x_launch={n_side}, x_launch0=-0.1, "
             f"dx_launch={0.1 / n_side}"),
            ("n_ky_launch=1, rindex_y0=0., delta_rindex_y0=.1",
             f"n_ky_launch={n_side}, rindex_y0=0.03, "
             f"delta_rindex_y0={0.16 / n_side}"),
            ("n_kz_launch=3, rindex_z0=0.4, delta_rindex_z0=0.1",
             f"n_kz_launch={n_side}, rindex_z0=0.3, "
             f"delta_rindex_z0={0.32 / n_side}"),
            ("nstep_max=500", f"nstep_max={n_steps}")):
        assert old in text, old
        text = text.replace(old, new)
    return text


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_cli(n_side=FAN_SIDE, n_steps=N_STEPS):
    """Namelist -> rays_tpu.run.main -> run_results.<label>.nc, twice: the
    first call compiles, the second is the warm time to solution."""
    import numpy as np

    from rays_tpu import run as runner
    from rays_tpu.results.netcdf import read_results_nc
    from rays_tpu.tracing.stop import StopCode, flag_string

    n_rays = n_side ** 3
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "rays.in")
        with open(path, "w") as fh:
            fh.write(_slab_fan_namelist(n_side, n_steps))
        os.chdir(td)
        try:
            walls = []
            for _ in range(2):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    runner.main([path, "--netcdf"])
                walls.append(time.perf_counter() - t0)
            nc = read_results_nc(os.path.join(td, "run_results.slab_demo.nc"))
        finally:
            os.chdir(cwd)
    names = {"ray_vec", "residual", "npoints", "initial_ray_power",
             "ray_trace_time", "end_residuals", "max_residuals",
             "end_ray_parameter", "start_ray_vec", "end_ray_vec",
             "ray_stop_flag", "total_trace_time", "date_vector"}
    missing = names - set(nc)
    assert not missing, f"netCDF lacks {sorted(missing)}"
    assert nc["ray_vec"].shape == (n_rays, n_steps + 1, 7), nc["ray_vec"].shape
    assert (nc["npoints"] == n_steps + 1).all(), np.unique(nc["npoints"])
    flags = {bytes(r).decode().strip() for r in nc["ray_stop_flag"]}
    assert flags == {flag_string(StopCode.NSTEP_MAX).strip()}, flags
    max_res = float(nc["max_residuals"].max())
    assert max_res < RESID_MAX, max_res
    assert np.isfinite(nc["ray_vec"]).all()
    log(f"  CLI {n_rays} rays x {n_steps} steps to netCDF: first call "
        f"{walls[0]:.2f} s (compile included), second {walls[1]:.2f} s "
        f"({n_rays / walls[1]:.1f} rays/s end to end); max residual "
        f"{max_res:.3e}; {_peak()}")
    return {"n_rays": n_rays, "cold_s": walls[0], "warm_s": walls[1],
            "rays_per_s": n_rays / walls[1], "max_residual": max_res}


def phase_slab_rk4(n_rays=N_RAYS, n_steps=N_STEPS, n_oracle=16):
    import jax.numpy as jnp
    import numpy as np

    from rays_tpu import examples
    from rays_tpu.tracing import trace as trace_mod
    from test_parity import _oracle_cfg, _slab_eq_fn

    cfg, params, v0, st, pwr = examples.setup_example()
    cfg = dataclasses.replace(cfg, nstep_max=n_steps, save_trajectory=False)
    v0, st, pwr = examples.replicate_rays(v0, st, pwr, n_rays)

    def fwd(p, v, s, w):
        return trace_mod.trace_batch(cfg, p, v, s, w)

    r64, m64 = _run(f"slab RK4 forward f64, {n_rays} x {n_steps}", fwd,
                    (params, v0, st, pwr), n_rays)
    r32, m32 = _run(f"slab RK4 forward f32, {n_rays} x {n_steps}", fwd,
                    _cast((params, v0, st, pwr), jnp.float32), n_rays)

    oc = _oracle_cfg(cfg, params, _slab_eq_fn(cfg, params))
    idx = _spread(n_rays, n_oracle)
    e_oracle = _oracle_end_states(cfg, params, oc, r64, idx, ORACLE_RTOL)

    np.testing.assert_array_equal(np.asarray(r32.npoints),
                                  np.asarray(r64.npoints))
    np.testing.assert_array_equal(np.asarray(r32.stop_flag),
                                  np.asarray(r64.stop_flag))
    assert np.asarray(r64.max_residuals).max() < RESID_MAX
    e32 = _assert_close_to_scale(r32.end_ray_vec, r64.end_ray_vec, v0,
                                 F32_RTOL, "f32 vs f64")
    log(f"  oracle ({len(idx)} rays, f64): worst end-state error "
        f"{e_oracle:.3e} of scale (limit {ORACLE_RTOL:g}); f32 vs f64 "
        f"worst {e32:.3e} (limit {F32_RTOL:g})")
    return {"f64": m64, "f32": m32, "oracle_err": e_oracle, "f32_err": e32}


def phase_adjoint(n_rays=N_RAYS, n_steps=N_STEPS, n_big=N_BIG, n_cpu=N_CPU):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rays_tpu import examples
    from rays_tpu.tracing import trace as trace_mod

    cfg, params, v0, st, pwr = examples.setup_example()
    cfg = dataclasses.replace(cfg, nstep_max=n_steps, save_trajectory=False)

    def loss(p, v, s, w):
        res = trace_mod.trace_batch(cfg, p, v, s, w)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * w[:, None])

    vg = jax.value_and_grad(loss)

    def finite(out):
        return all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree_util.tree_leaves(out))

    out = {}
    batch = examples.replicate_rays(v0, st, pwr, n_rays)
    for tag, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        args = _cast((params,) + batch, dt)
        got, out[tag] = _run(f"adjoint {tag}, {n_rays} x {n_steps}", vg,
                             args, n_rays)
        assert finite(got), f"adjoint {tag} not finite"
    big = _cast((params,) + examples.replicate_rays(v0, st, pwr, n_big),
                jnp.float32)
    got, out["big_f32"] = _run(f"adjoint f32, {n_big} x {n_steps}", vg, big,
                               n_big)
    assert finite(got), "1e5-ray adjoint not finite"

    sub = (params,) + examples.replicate_rays(v0, st, pwr, n_cpu)
    (l_dev, g_dev), _ = _run(f"adjoint f64, {n_cpu} x {n_steps}", vg, sub,
                             n_cpu)
    l_cpu, g_cpu = _on_cpu(vg, sub)
    np.testing.assert_allclose(float(l_dev), float(l_cpu), rtol=GRAD_RTOL)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(g_dev),
                    jax.tree_util.tree_leaves(g_cpu)):
        a, b = np.asarray(a), np.asarray(b)
        # relative to each parameter leaf's scale: an element that cancels
        # to ~0 carries the leaf's absolute rounding, not its own
        sc = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_RTOL * sc)
        worst = max(worst, float(np.abs(a - b).max() / sc))
    log(f"  adjoint f64 device vs CPU ({n_cpu} rays): worst gradient "
        f"difference {worst:.3e} of leaf scale (limit {GRAD_RTOL:g})")
    out["grad_err"] = worst
    return out


def phase_sg(n_rays=N_RAYS, n_steps=N_STEPS, n_cpu=N_CPU, substeps=2):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rays_tpu import examples
    from rays_tpu.tracing import trace as trace_mod

    text = examples.SLAB_ECH_90GHZ.replace(
        "ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
    cfg, params, v0, st, pwr = examples.setup_example(text)
    cfg = dataclasses.replace(cfg, nstep_max=n_steps, save_trajectory=False)

    def fwd(p, v, s, w):
        return trace_mod.trace_batch(cfg, p, v, s, w)

    batch = _cast((params,) + examples.replicate_rays(v0, st, pwr, n_rays),
                  jnp.float32)
    r32, m_fwd = _run(f"SG forward f32, {n_rays} x {n_steps}", fwd, batch,
                      n_rays)
    assert np.isfinite(np.asarray(r32.end_ray_vec)).all()

    # the substep while_loop has no reverse-mode rule: the adjoint runs the
    # fixed-budget form; a budget of 2 suffices for the slab at tol 1e-4
    # when every ray still runs its full step count
    cfg_adj = dataclasses.replace(cfg, sg_scan_substeps=substeps)

    def loss(p, v, s, w):
        res = trace_mod.trace_batch(cfg_adj, p, v, s, w)
        return (jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * w[:, None]),
                res.npoints)

    ((_, npts), grads), m_adj = _run(
        f"SG adjoint f32 (sg_scan_substeps={substeps}), {n_rays} x {n_steps}",
        jax.value_and_grad(loss, has_aux=True), batch, n_rays)
    assert int(np.asarray(npts).min()) == n_steps + 1, (
        "sg_scan_substeps budget too small for this case")
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(grads))

    sub = (params,) + examples.replicate_rays(v0, st, pwr, n_cpu)
    r_dev, _ = _run(f"SG forward f64, {n_cpu} x {n_steps}", fwd, sub, n_cpu)
    r_cpu = _on_cpu(fwd, sub)
    np.testing.assert_array_equal(np.asarray(r_dev.npoints),
                                  np.asarray(r_cpu.npoints))
    err = _assert_close_to_scale(r_dev.end_ray_vec, r_cpu.end_ray_vec,
                                 sub[1], SG_RTOL, "SG device vs CPU")
    log(f"  SG f64 device vs CPU ({n_cpu} rays): worst end-state difference "
        f"{err:.3e} of scale (limit {SG_RTOL:g})")
    return {"forward_f32": m_fwd, "adjoint_f32": m_adj, "cpu_err": err}


def phase_eqdsk(n_rays=N_RAYS, n_steps=N_STEPS, n_oracle=8, grid=129):
    import jax.numpy as jnp
    import numpy as np

    from rays_tpu import examples, run as runner
    from rays_tpu.config import schema
    from rays_tpu.config.namelist import parse_namelist
    from rays_tpu.rayinit import vector as init_vector
    from rays_tpu.tracing import trace as trace_mod
    from rays_tpu.utils import solovev_2_eqdsk
    from rays_tpu.utils.eqdsk_io import write_geqdsk
    from test_parity import _assert_parity, _eqdsk_eq_fn, _oracle_cfg

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "solovev.geqdsk")
        write_geqdsk(path, solovev_2_eqdsk.solovev_geqdsk(
            rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3, outer_bound=1.55,
            nrbox=grid, nzbox=grid))
        cfg, params = schema.from_namelist(parse_namelist(
            examples.EQDSK_TOROID_TMPL.format(EQDSK=path)))
        oc = _oracle_cfg(cfg, params, _eqdsk_eq_fn(cfg, params, path))
    rvec0, rindex0, pwr = runner.init_rays(cfg, params)
    v0 = init_vector.initial_ode_vectors(cfg, params, rvec0, rindex0)
    st = jnp.zeros((v0.shape[0],), jnp.int32)
    cfg = dataclasses.replace(cfg, nstep_max=n_steps, save_trajectory=False)
    v0, st, pwr = examples.replicate_rays(v0, st, pwr, n_rays)

    def fwd(p, v, s, w):
        return trace_mod.trace_batch(cfg, p, v, s, w)

    r32, m32 = _run(f"EQDSK {grid}x{grid} forward f32, {n_rays} x {n_steps}",
                    fwd, _cast((params, v0, st, pwr), jnp.float32), n_rays)
    assert np.isfinite(np.asarray(r32.end_ray_vec)).all()
    assert int(np.asarray(r32.npoints).min()) > 1

    # f64 rays spread over the batch, whole trajectories against the oracle
    idx = _spread(n_rays, n_oracle)
    cfg_t = dataclasses.replace(cfg, save_trajectory=True)
    r64, _ = _run(f"EQDSK forward f64, {len(idx)} x {n_steps}",
                  lambda p, v, s, w: trace_mod.trace_batch(cfg_t, p, v, s, w),
                  (params, v0[idx], st[idx], pwr[idx]), len(idx))
    _assert_parity(cfg_t, params, r64, oc, rtol=EQDSK_RTOL)
    log(f"  EQDSK oracle ({len(idx)} rays, f64): trajectories within "
        f"{EQDSK_RTOL:g} of scale")
    return {"forward_f32": m32}


def sharded_matches_unsharded(n_per_device=N_RAYS, n_steps=N_STEPS):
    """Sharded trace + deposition + adjoint over a 4-device mesh against the
    unsharded run on one device, at __graft_entry__'s tolerances."""
    import __graft_entry__ as graft

    t0 = time.perf_counter()
    info = graft.dryrun_multichip(4, n_rays=4 * n_per_device, nstep=n_steps)
    info["wall_s"] = time.perf_counter() - t0
    log(f"  sharded train step, {4 * n_per_device} rays x {n_steps} steps "
        f"f64 on 4 devices: compile {info['sharded_compile_s']:.2f} s, "
        f"first run {info['sharded_first_run_s']:.4f} s; whole check "
        f"(unsharded reference included) {info['wall_s']:.1f} s; "
        f"sharded == unsharded")
    return info


def forward_hlo_collective_free(n_per_device=N_RAYS, n_steps=N_STEPS):
    """The sharded forward trace compiles to an HLO with no collectives."""
    import jax

    from rays_tpu import examples
    from rays_tpu.parallel import sharded

    cfg, params, v0, st, pwr = examples.setup_example(
        examples.SLAB_ECH_DAMPED)
    cfg = dataclasses.replace(cfg, nstep_max=n_steps, save_trajectory=False)
    v0, st, pwr = examples.replicate_rays(v0, st, pwr, 4 * n_per_device)
    mesh = sharded.make_ray_mesh(jax.devices()[:4])
    hlo = sharded.make_sharded_tracer(cfg, mesh).lower(
        params, v0, st, pwr).compile().as_text()
    found = sharded.collective_ops(hlo)
    assert not found, f"sharded forward trace has collectives: {found}"
    log("  sharded forward HLO: no collectives")
    return {"collectives": sorted(found)}


FOUR_GPU_PHASES = (
    ("four-GPU sharded == unsharded", sharded_matches_unsharded),
    ("four-GPU forward HLO", forward_hlo_collective_free),
)


SINGLE_CARD_PHASES = (
    ("1 CLI to netCDF", phase_cli),
    ("2 slab RK4 forward", phase_slab_rk4),
    ("3 adjoint", phase_adjoint),
    ("4 adaptive SG", phase_sg),
    ("5 EQDSK spline", phase_eqdsk),
)


def _card_lines():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    # the CPU backend is the named reference of phases 3 and 4
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default device {dev}); "
                 "this script checks the GPU path only")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import rays_tpu  # noqa: F401  (x64, matmul precision, compile cache)

    log(_card_lines())
    log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}; "
        f"jax {jax.__version__}; compile cache: "
        f"{jax.config.jax_compilation_cache_dir}")

    if args.four_gpus:
        if len(jax.devices()) < 4:
            sys.exit(f"chip_smoke: --four-gpus needs 4 GPUs, JAX found "
                     f"{len(jax.devices())}")
        phases = FOUR_GPU_PHASES
    else:
        log("mirror geometry: not run (its only input, the MPEX example, "
            "is not part of the repository)")
        phases = SINGLE_CARD_PHASES
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001  (report every phase)
            failed.append(name)
            log(f"  FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
        log(f"  phase wall {time.perf_counter() - t0:.1f} s")
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    if failed:
        sys.exit(f"chip_smoke: failed phases: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
