"""Trajectory parity against the independent NumPy oracle (tests/_oracle.py).

The correctness anchor: every example class (slab, damped slab,
Solovev fan, EQDSK toroid, MPEX mirror) is traced both by the JAX
implementation and by a scalar-loop NumPy transcription of the reference
Fortran (formulas verbatim from eqn_ray.f90 / deriv_cold.f90 / RK4_ode_m.f90
/ equilibrium_m.f90 / the geometry modules), from identical initial
conditions, and the trajectories must agree to integrator-rounding level.

Also: analytic anchors — the slab ray's turning point sits on the n_x^2 = 0
cutoff surface, and the fundamental ECH resonance gamma_e = -1 is where the
cold formulas put it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rays_tpu  # noqa: F401
from rays_tpu import examples
from rays_tpu.tracing import trace as trace_mod
from rays_tpu.tracing.stop import flag_string

import _oracle as oracle


def _oracle_cfg(cfg, params, eq_fn):
    sp = params.species
    return oracle.OracleConfig(
        eq_fn,
        qs=np.asarray(sp.qs, float),
        ms=np.asarray(sp.ms, float),
        omgrf=float(params.rf.omgrf),
        k0=float(params.rf.k0),
        ray_param=cfg.ray_param,
        damping_model=cfg.damping_model,
        multi_spec_damping=cfg.multi_spec_damping,
        integrate_eq_gradients=cfg.integrate_eq_gradients,
        dispersion_resid_limit=float(params.limits.dispersion_resid_limit),
        total_damping_limit=float(params.limits.total_damping_limit),
        n_norm=float(sp.n_ref),  # package stores the ne diag normalized
    )


def _slab_eq_fn(cfg, params):
    st, e, sp = cfg.eq_static, params.eq, params.species
    keys = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax", "rmaj", "rmin",
            "x0", "by0", "bz0", "lby_shear_scale", "lbz_scale", "dbzdx",
            "ln_scale", "lt_scale")
    p = {k: float(getattr(e, k)) for k in keys}
    models = dict(by_prof_model=st.by_prof_model,
                  bz_prof_model=st.bz_prof_model,
                  dens_prof_model=st.dens_prof_model,
                  t_prof_model=st.t_prof_model)
    n_phys = np.asarray(sp.n0s, float) * float(sp.n_ref)
    return oracle.SlabEq(models, p, n_phys, np.asarray(sp.t0s, float))


def _solovev_eq_fn(cfg, params):
    st, e, sp = cfg.eq_static, params.eq, params.species
    p = {k: float(getattr(e, k)) for k in
         ("rmaj", "kappa", "bphi0", "iota0", "outer_bound",
          "alphan1", "alphan2", "box_rmin", "box_rmax", "box_zmin",
          "box_zmax")}
    p["alphat1"] = np.asarray(e.alphat1, float)
    p["alphat2"] = np.asarray(e.alphat2, float)
    models = dict(dens_prof_model=st.dens_prof_model,
                  t_prof_model=st.t_prof_model)
    n_phys = np.asarray(sp.n0s, float) * float(sp.n_ref)
    return oracle.SolovevEq(models, p, n_phys, np.asarray(sp.t0s, float))


def _trace_repo(cfg, params, v0, st, pwr):
    tracer = jax.jit(lambda p, v, s, w: trace_mod.trace_batch(cfg, p, v, s, w))
    res = tracer(params, v0, st, pwr)
    jax.block_until_ready(res)
    return res


def _assert_parity(cfg, params, res, oc, rtol=1e-7, atol_x=1e-9):
    """Per-ray: trace with the oracle from the same v0 and compare."""
    v0 = np.asarray(res.start_ray_vec, float)
    vrepo = np.asarray(res.ray_vec, float)
    npts = np.asarray(res.npoints)
    flags = np.asarray(res.stop_flag)
    ds, s_max = float(params.ode.ds), float(params.ode.s_max)

    for ir in range(v0.shape[0]):
        traj, resids, flag = oracle.trace_ray(oc, v0[ir], cfg.nstep_max,
                                              ds, s_max)
        # identical stop semantics: same point count and same flag string
        assert len(traj) == npts[ir], (
            f"ray {ir}: oracle npoints {len(traj)} != repo {npts[ir]} "
            f"(repo flag {flag_string(flags[ir])!r}, oracle {flag!r})")
        assert flag == flag_string(flags[ir]), (
            f"ray {ir}: stop flag mismatch oracle={flag!r} "
            f"repo={flag_string(flags[ir])!r}")
        got = vrepo[ir, :len(traj), :]
        # positions/k: relative to the trajectory scale, not each component
        scale_x = max(1e-12, np.abs(traj[:, 0:3]).max())
        scale_k = max(1e-12, np.abs(traj[:, 3:6]).max())
        np.testing.assert_allclose(got[:, 0:3], traj[:, 0:3],
                                   atol=rtol * scale_x + atol_x, rtol=0,
                                   err_msg=f"ray {ir} positions")
        np.testing.assert_allclose(got[:, 3:6], traj[:, 3:6],
                                   atol=rtol * scale_k, rtol=0,
                                   err_msg=f"ray {ir} wavevector")
        # remaining slots (arclength, absorption, diagnostics)
        for slot in range(6, traj.shape[1]):
            sc = max(1e-12, np.abs(traj[:, slot]).max())
            np.testing.assert_allclose(got[:, slot], traj[:, slot],
                                       atol=rtol * sc, rtol=0,
                                       err_msg=f"ray {ir} slot {slot}")


def test_parity_slab_rk4_time():
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ)
    res = _trace_repo(cfg, params, v0, st, pwr)
    oc = _oracle_cfg(cfg, params, _slab_eq_fn(cfg, params))
    _assert_parity(cfg, params, res, oc)


def test_parity_slab_damped_multispec():
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED)
    res = _trace_repo(cfg, params, v0, st, pwr)
    oc = _oracle_cfg(cfg, params, _slab_eq_fn(cfg, params))
    # damping path: Z-function implementations differ (Dawson/Weideman vs
    # scipy wofz) at ~1e-13; absorption integrates that difference.
    _assert_parity(cfg, params, res, oc, rtol=5e-7)


def test_parity_solovev_rk4():
    cfg, params, v0, st, pwr = examples.setup_example(
        examples.SOLOVEV_ECH_90GHZ)
    # fixed-step goldens: run both sides with RK4 (the reference's examples
    # are re-runnable the same way, SURVEY.md §7.2 item 6)
    cfg = dataclasses.replace(cfg, ode_solver_name="RK4_ODE")
    res = _trace_repo(cfg, params, v0, st, pwr)
    oc = _oracle_cfg(cfg, params, _solovev_eq_fn(cfg, params))
    _assert_parity(cfg, params, res, oc)


@pytest.fixture(scope="module")
def eqdsk_file(tmp_path_factory):
    from rays_tpu.utils import solovev_2_eqdsk
    from rays_tpu.utils.eqdsk_io import write_geqdsk

    path = str(tmp_path_factory.mktemp("eqdsk_par") / "solovev.geqdsk")
    write_geqdsk(path, solovev_2_eqdsk.solovev_geqdsk(
        rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3, outer_bound=1.55,
        nrbox=129, nzbox=129))
    return path


def test_parity_eqdsk_toroid(eqdsk_file):
    from rays_tpu.config import schema
    from rays_tpu.config.namelist import parse_namelist
    from rays_tpu import run as runner
    from rays_tpu.rayinit import vector as init_vector
    from test_axisym import AXISYM_TMPL

    cfg, params = schema.from_namelist(parse_namelist(AXISYM_TMPL.format(
        MAG="eqdsk_magnetics_spline_interp", EQDSK=eqdsk_file)))
    rvec0, rindex0, pwr = runner.init_rays(cfg, params)
    v0 = init_vector.initial_ode_vectors(cfg, params, rvec0, rindex0)
    st = jnp.zeros((v0.shape[0],), jnp.int32)
    res = _trace_repo(cfg, params, v0, st, pwr)
    oc = _oracle_cfg(cfg, params, _eqdsk_eq_fn(cfg, params, eqdsk_file))
    # spline backends: same interpolant, independent implementations; the
    # rounding difference (~1e-12 in B) grows along the trajectory
    _assert_parity(cfg, params, res, oc, rtol=1e-6)


def _eqdsk_eq_fn(cfg, params, eqdsk_file):
    """The oracle's EQDSK toroid equilibrium for a package run on the same
    G-EQDSK file."""
    from rays_tpu.utils.eqdsk_io import read_geqdsk

    e, sp = params.eq, params.species
    p = {
        "box_rmin": float(e.box_rmin), "box_rmax": float(e.box_rmax),
        "box_zmin": float(e.box_zmin), "box_zmax": float(e.box_zmax),
        "plasma_psi_limit": float(e.plasma_psi_limit),
        "alphan1": float(e.alphan1), "alphan2": float(e.alphan2),
        "d_scrape_off": float(e.d_scrape_off),
        "t_scrape_off": float(e.t_scrape_off),
        "alphat1": np.asarray(e.alphat1, float),
        "alphat2": np.asarray(e.alphat2, float),
    }
    models = dict(
        density_prof_model=cfg.eq_static.density_prof_model,
        temperature_prof_model=cfg.eq_static.temperature_prof_model)
    n_phys = np.asarray(sp.n0s, float) * float(sp.n_ref)
    return oracle.EqdskToroidEq(models, p, n_phys, np.asarray(sp.t0s, float),
                                read_geqdsk(eqdsk_file))


MPEX_DIR = ("/root/reference/examples_RAYS/MPEX_examples/"
            "MPX_2nd_harm_11_rays_nz_delta_d_0.05_psiP_0.05")


def test_parity_mpex_mirror():
    from rays_tpu import run as runner
    from scipy.io import netcdf_file

    cwd = os.getcwd()
    os.chdir(MPEX_DIR)
    try:
        cfg, params, v0, st, pwr = runner.setup("rays.in")
    finally:
        os.chdir(cwd)
    # oracle is O(steps * splines) in Python: trace 3 of the 11 rays and
    # trim the step budget; parity over 250 steps is ample evidence
    cfg = dataclasses.replace(cfg, nstep_max=250)
    keep = slice(0, 3)
    v0, st, pwr = v0[keep], st[keep], pwr[keep]
    res = _trace_repo(cfg, params, v0, st, pwr)

    fpath = os.path.join(
        MPEX_DIR, "Brz_fields.MPEX_9_filaments_D3-6_ECH_2nd_harm.nc")
    f = netcdf_file(fpath, "r", mmap=False)
    try:
        rg = np.array(f.variables["r_grid"][:], float)
        zg = np.array(f.variables["z_grid"][:], float)
        br = np.array(f.variables["Br"][:], float).T
        bz = np.array(f.variables["Bz"][:], float).T
        aphi = np.array(f.variables["Aphi"][:], float).T
        r_lufs = float(f.variables["r_LUFS"].getValue())
        z_lufs = float(f.variables["z_LUFS"].getValue())
    finally:
        f.close()

    e, sp = params.eq, params.species
    p = {
        "box_rmax": float(e.box_rmax), "box_zmin": float(e.box_zmin),
        "box_zmax": float(e.box_zmax),
        "plasma_aphin_limit": float(e.plasma_aphin_limit),
        "alphan1": float(e.alphan1), "alphan2": float(e.alphan2),
        "aphin0_d": float(e.aphin0_d), "delta_d": float(e.delta_d),
        "d_scrape_off": float(e.d_scrape_off),
        "t_scrape_off": float(e.t_scrape_off),
        "alphat1": np.asarray(e.alphat1, float),
        "alphat2": np.asarray(e.alphat2, float),
        "aphin0_t": np.asarray(e.aphin0_t, float),
        "delta_t": np.asarray(e.delta_t, float),
    }
    models = dict(
        density_prof_model=cfg.eq_static.density_prof_model,
        temperature_prof_model=cfg.eq_static.temperature_prof_model)
    n_phys = np.asarray(sp.n0s, float) * float(sp.n_ref)
    eq_fn = oracle.MirrorEq(models, p, n_phys, np.asarray(sp.t0s, float),
                            rg, zg, br, bz, aphi,
                            oracle.NotAKnot2D(rg, zg, aphi)
                            .evaluate(r_lufs, z_lufs)[0])
    oc = _oracle_cfg(cfg, params, eq_fn)
    _assert_parity(cfg, params, res, oc, rtol=1e-6)


def test_ray_power_weights_pinned():
    """Ray power weights are 1/nray, summing to exactly 1, in EVERY init
    model — the deliberate, documented divergence from the reference, which
    divides the slab weights by nray twice (simple_slab_ray_init_m.f90:
    179-182, weights sum to 1/nray) while the solovev init divides once
    (solovev_ray_init_nphi_ntheta_m.f90:206).  Deposition profiles
    therefore normalize to total launched power = 1 for all geometries."""
    for text in (examples.SLAB_ECH_90GHZ, examples.SLAB_ECH_DAMPED,
                 examples.SOLOVEV_ECH_90GHZ):
        cfg, params, v0, st, pwr = examples.setup_example(text)
        w = np.asarray(pwr, float)
        n = w.shape[0]
        np.testing.assert_allclose(w, np.full(n, 1.0 / n), rtol=1e-14)
        assert w.sum() == pytest.approx(1.0, rel=1e-13)


# ---------------------------------------------------------------------------
# analytic anchors
# ---------------------------------------------------------------------------


def test_anchor_slab_turning_point_on_cutoff():
    """The slab ray's turning point in x must sit on a zero of the local
    cold dispersion for the ray's conserved (n_y, n_z): either n_x^2 = 0 on
    the followed branch (cutoff) or root coalescence (the biquadratic
    discriminant = 0 — the mode-conversion/reflection layer of Batchelor et
    al. 1980).  Closed-form Stix algebra, no integration involved."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ)
    res = _trace_repo(cfg, params, v0, st, pwr)
    eq_fn = _slab_eq_fn(cfg, params)
    k0 = float(params.rf.k0)
    omgrf = float(params.rf.omgrf)
    qs = np.asarray(params.species.qs, float)
    ms = np.asarray(params.species.ms, float)

    def roots(x, n3):
        """Both n1^2 roots of A n1^4 - B n1^2 + C (Stix biquadratic)."""
        raw, err = eq_fn(np.array([x, 0.0, 0.0]))
        assert not err
        eq = oracle.make_eq_point(raw, qs, ms, omgrf)
        S = 1.0 - float(np.sum(eq.alpha / (1.0 - eq.gamma**2)))
        D = -float(np.sum(eq.alpha * eq.gamma / (1.0 - eq.gamma**2)))
        P = 1.0 - float(np.sum(eq.alpha))
        R, L = S + D, S - D
        A = S
        Bc = R * L + P * S - (P + S) * n3**2
        C = P * (n3**2 - R) * (n3**2 - L)
        disc = max(Bc**2 - 4.0 * A * C, 0.0)
        sq = np.sqrt(disc)
        return (Bc - sq) / (2.0 * A), (Bc + sq) / (2.0 * A)

    vr = np.asarray(res.ray_vec, float)
    npts = np.asarray(res.npoints)
    n_checked = 0
    for ir in range(vr.shape[0]):
        traj = vr[ir, :npts[ir]]
        i_top = int(np.argmax(traj[:, 0]))
        if i_top in (0, npts[ir] - 1):
            continue  # no interior turning point for this ray
        # conserved transverse refractive indices (slab: ky, kz constant;
        # b along z in this example, so n3 = nz)
        ny, nz = traj[0, 4] / k0, traj[0, 5] / k0
        r0a, r0b = roots(traj[0, 0], nz)
        n1sq_launch = (traj[0, 3] / k0) ** 2 + ny**2
        # follow the branch the ray launched on
        follow_first = abs(r0a - n1sq_launch) < abs(r0b - n1sq_launch)
        sep0 = abs(r0a - r0b)

        x_top = traj[i_top, 0]
        ra, rb = roots(x_top, nz)
        nxsq_branch = (ra if follow_first else rb) - ny**2
        coalescence = abs(ra - rb) / max(sep0, 1e-12)
        assert min(abs(nxsq_branch), coalescence) < 5e-3, (
            f"ray {ir}: turning point x={x_top:.6f} neither on nx^2=0 "
            f"(={nxsq_branch:.3e}) nor on root coalescence "
            f"(rel sep {coalescence:.3e})")
        n_checked += 1
    assert n_checked >= 1  # the example has interior turning points


def test_anchor_ech_resonance_location():
    """gamma_e = -1 (fundamental ECH resonance) location: the cold formula
    |B| = m_e omega / e must land where the slab field model says it does."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED)
    omgrf = float(params.rf.omgrf)
    me_ = float(np.asarray(params.species.ms)[0])
    qe = float(np.asarray(params.species.qs)[0])  # negative
    # slab damped example: Bz = bz0 (1 + x / LBz_scale)
    e = params.eq
    b_res = me_ * omgrf / abs(qe)
    x_res = (b_res / float(e.bz0) - 1.0) * float(e.lbz_scale)
    # cross-check with the oracle equilibrium: gamma_e(x_res) == -1
    eq_fn = _slab_eq_fn(cfg, params)
    raw, err = eq_fn(np.array([x_res, 0.0, 0.0]))
    assert not err
    eq = oracle.make_eq_point(raw, np.asarray(params.species.qs, float),
                              np.asarray(params.species.ms, float), omgrf)
    assert eq.gamma[0] == pytest.approx(-1.0, rel=1e-12)
    # absorption must be confined to the Doppler window |zeta| <= 5 around
    # that resonance, zeta = (omega + Omega_ce)/(k_par v_th)
    # (damp_fund_ECH.f90:70-73); rays absorb on approach and may deplete
    # before reaching x_res, so the window — not the peak — is the anchor
    res = _trace_repo(cfg, params, v0, st, pwr)
    vr = np.asarray(res.ray_vec, float)
    npts = np.asarray(res.npoints)
    qs = np.asarray(params.species.qs, float)
    ms = np.asarray(params.species.ms, float)
    n_abs = 0
    for ir in range(vr.shape[0]):
        traj = vr[ir, :npts[ir]]
        dP = np.diff(traj[:, 7])
        if dP.max() <= 1e-8:
            continue
        n_abs += 1
        for istep in np.nonzero(dP > 1e-3 * dP.max())[0]:
            vmid = traj[istep]
            raw, err2 = eq_fn(vmid[0:3])
            assert not err2
            eqp = oracle.make_eq_point(raw, qs, ms, omgrf)
            k3 = float(np.dot(vmid[3:6], eqp.bunit))
            vth = np.sqrt(2.0 * eqp.ts[0] / ms[0])
            zeta = (omgrf + eqp.omgc[0]) / (k3 * vth)
            assert abs(zeta) <= 5.5, (
                f"ray {ir} step {istep}: absorption outside the Doppler "
                f"window, zeta={zeta:.2f} at x={vmid[0]:.4f} "
                f"(resonance x={x_res:.4f})")
    assert n_abs >= 1  # the damped example absorbs
