"""Per-ray detailed diagnostics -> ray_detailed_diagnostics.<label>.nc.

Re-design of the reference's per-geometry ray_detailed_diagnostics
subroutines (axisym_toroid_processor_m.f90:252-465,
slab_processor_m.f90:123-330, mirror_processor_m.f90:235-465): for every
trajectory point, extract/recompute ne, Te, |B|, alpha_e, gamma_e, the
geometry coordinate (psiN / X,Y / AphiN), n_par, n_perp, absorbed power,
n_imag = ki/k0, the electron Z-function arguments for harmonics 0-2
(xi_l = (omega + l*Omega_ce)/(k_par v_th), :407-411), and the dispersion
residual; write them in the reference's netCDF schema so
graphics_RAYS/plot_ray_diags.py consumes the file unchanged.

Device shape: the reference's scalar (iray, istep) double loop is ONE jitted
vmap over the flattened (ray, step) axis — every quantity for every point
in a single device pass; invalid points (beyond npoints) are masked to the
reference's zero fill.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rays_tpu import constants
from rays_tpu.models import base as model_base
from rays_tpu.wave import damping as damping_mod
from rays_tpu.wave import deriv_cold as deriv_cold_mod


def _coordinate_vars(cfg, params, rvec):
    """Geometry-specific coordinate variables, name -> value."""
    x, y, z = rvec[0], rvec[1], rvec[2]
    r_cyl = jnp.sqrt(x**2 + y**2)
    if cfg.equilib_model == "slab":
        # slab_processor_m.f90: X, Y, Z
        return {"X": x, "Y": y, "Z": z}
    if cfg.equilib_model == "solovev":
        from rays_tpu.models import solovev as sv

        _, _, psiN, _ = sv.psi(params.eq, rvec)
        return {"Psi": psiN, "R": r_cyl, "Z": z}
    if cfg.equilib_model == "axisym_toroid":
        from rays_tpu.models import axisym_toroid as at

        _, _, psiN = at.magnetics(cfg.eq_static, params.eq, rvec)
        return {"Psi": psiN, "R": r_cyl, "Z": z}
    if cfg.equilib_model == "multiple_mirror":
        from rays_tpu.models import multiple_mirror as mm

        _, _, aphin = mm.magnetics(params.eq, rvec)
        return {"Aphi": aphin, "R": r_cyl, "Z": z}
    raise ValueError(f"ray diagnostics: unknown geometry {cfg.equilib_model}")


def compute_ray_diagnostics(cfg, params, results):
    """dict of (B, n_pts) arrays (plus npoints) matching the reference's
    variable set."""
    ray_vec = results.ray_vec            # (B, n_pts, nv)
    B, n_pts, _ = ray_vec.shape
    npoints = results.npoints
    step_idx = jnp.arange(n_pts)
    k0, omgrf = params.rf.k0, params.rf.omgrf
    sp = params.species
    e_charge = constants.E_CHARGE

    def per_point(v):
        rvec, kvec = v[0:3], v[3:6]
        eq = model_base.equilibrium(cfg, params, rvec)
        out = {}
        out["s"] = v[6]
        out.update(_coordinate_vars(cfg, params, rvec))
        out["ne"] = eq.ns[0] * sp.n_ref   # physical density, reference units
        out["Te_kev"] = eq.ts[0] / e_charge / 1000.0
        out["modB"] = eq.bmag
        out["alpha_e"] = eq.alpha[0]
        out["gamma_e"] = jnp.abs(eq.gamma[0])

        k3 = jnp.dot(kvec, eq.bunit)
        k1 = jnp.sqrt(jnp.sum((kvec - k3 * eq.bunit) ** 2))
        out["n_par"] = k3 / k0
        out["n_perp"] = k1 / k0

        if cfg.damping_model != "no_damp":
            dddx, dddk, dddw = deriv_cold_mod.deriv_cold(
                eq, kvec / k0, omgrf, k0)
            safe_dddw = jnp.where(dddw == 0.0, 1.0, dddw)
            vg = -dddk / safe_dddw
            _, ki = damping_mod.damping(cfg, params, eq, v[0:6], vg)
            out["n_imag"] = ki / k0
            out["P_absorbed"] = v[7]
        else:
            out["n_imag"] = jnp.zeros_like(k3)
            out["P_absorbed"] = jnp.zeros_like(k3)

        # Z-function arguments for harmonics 0..2
        # (axisym_toroid_processor_m.f90:407-411)
        vth = jnp.sqrt(2.0 * jnp.maximum(eq.ts[0], constants.SAFE_TINY)
                       / sp.ms[0])
        safe_k3 = jnp.where(k3 == 0.0, 1.0, k3)
        live = (eq.ts[0] > 0.0) & (k3 != 0.0)
        for l in range(3):
            xi = (omgrf + l * eq.omgc[0]) / (safe_k3 * vth)
            out[f"xi_{l}"] = jnp.where(live, xi, 0.0)
        return out

    f = jax.jit(jax.vmap(jax.vmap(per_point)))
    diags = f(ray_vec)
    # zero-fill beyond npoints (the reference's source=0.0 allocation)
    valid = (step_idx[None, :] < npoints[:, None])
    diags = {k: jnp.where(valid, v, 0.0) for k, v in diags.items()}
    diags["residual"] = jnp.where(valid, results.residual, 0.0)
    return diags


def write_ray_diagnostics_nc(cfg, params, results, path=None):
    """Write the reference-schema netCDF (…processor_m.f90:430-465).
    Returns the filename."""
    from scipy.io import netcdf_file

    diags = compute_ray_diagnostics(cfg, params, results)
    B, n_pts = np.asarray(diags["s"]).shape
    suffix = "_slab" if cfg.equilib_model == "slab" else ""
    fn = path or f"ray_detailed_diagnostics{suffix}.{cfg.run_label}.nc"

    f = netcdf_file(fn, "w")
    try:
        f.createDimension("number_of_rays", B)
        f.createDimension("max_number_of_points", n_pts)
        f.createDimension("dim_v_vector", cfg.nv)
        f.createDimension("d8", 8)
        f.RAYS_run_label = cfg.run_label.encode()

        import datetime

        now = datetime.datetime.now()
        dv = f.createVariable("date_vector", np.int32, ("d8",))
        dv[:] = np.array([now.year, now.month, now.day, 0, now.hour,
                          now.minute, now.second, 0], np.int32)
        npv = f.createVariable("npoints", np.int32, ("number_of_rays",))
        npv[:] = np.asarray(results.npoints, np.int32)
        for name, arr in diags.items():
            v = f.createVariable(
                name, np.float64, ("number_of_rays", "max_number_of_points"))
            v[:] = np.asarray(arr, np.float64)
    finally:
        f.close()
    return fn
