"""Power-deposition profiles.

Re-design of reference RAYS_project/post_process_lib/deposition_profiles_m
.f90: per-geometry profile registry ('Ptotal_x' for slab; 'Ptotal_psi',
'Ptotal_rho' for toroids, :38-45), a Q-evaluator giving (grid coordinate,
absorbed power) per trajectory point (:50-68), per-ray binning via the
uniform-grid binner, then the sum over rays (:229-293).

Device shape: the per-ray binning is the dense segment-overlap kernel in
ops/binning.py, vmapped over the ray batch and summed — under a sharded ray
axis the sum lowers to a psum over the mesh.  Absorbed power per point is
initial_ray_power * v[damping_slot] (the integrated absorption fraction),
frozen (dQ = 0) beyond npoints via masking.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rays_tpu.models import base as model_base
from rays_tpu.ops import binning


class DepositionProfile(NamedTuple):
    name: str
    grid: jnp.ndarray      # (n_bins+1,) bin edges
    profile: jnp.ndarray   # (n_bins,) summed over rays


def _coordinate_fn(cfg, params, which: str):
    """Map trajectory position -> profile coordinate."""
    if which == "Ptotal_x":
        return lambda r: r[0]
    if which == "Ptotal_psi":
        from rays_tpu.models import axisym_toroid as at

        if cfg.equilib_model == "axisym_toroid":
            return lambda r: at.magnetics(cfg.eq_static, params.eq, r)[2]
        if cfg.equilib_model == "solovev":
            from rays_tpu.models import solovev as sv

            return lambda r: sv.psi(params.eq, r)[2]
        raise ValueError(f"Ptotal_psi not available for {cfg.equilib_model}")
    if which == "Ptotal_rho":
        # rho = sqrt(normalized toroidal flux); EQDSK magnetics only
        # (Ptotal_axisym_rho_evaluator, deposition_profiles_m.f90:479-499)
        from rays_tpu.models import axisym_toroid as at

        if cfg.equilib_model != "axisym_toroid":
            raise ValueError(f"Ptotal_rho not available for {cfg.equilib_model}")
        return lambda r: at.rho_and_grad(cfg.eq_static, params.eq, r)[0]
    if which == "Ptotal_AphiN":
        from rays_tpu.models import multiple_mirror as mm

        if cfg.equilib_model != "multiple_mirror":
            raise ValueError(f"Ptotal_AphiN not available for {cfg.equilib_model}")
        return lambda r: mm.aphi_and_grad(cfg.eq_static, params.eq, r)[2]
    raise ValueError(f"unknown deposition profile {which}")


def calculate_deposition_profile(cfg, params, results, which: str,
                                 n_bins: int = 50, xmin=0.0, xmax=1.0):
    """Binned power deposition summed over rays
    (deposition_profiles_m.f90:229-293)."""
    if cfg.damping_slot < 0:
        raise ValueError("deposition profiles need a damping model")
    coord = _coordinate_fn(cfg, params, which)
    slot = cfg.damping_slot

    ray_vec = results.ray_vec          # (B, n_pts, nv)
    npoints = results.npoints          # (B,)
    pwr = results.initial_ray_power    # (B,)
    n_pts = ray_vec.shape[1]
    step_idx = jnp.arange(n_pts)

    def per_ray(rv, npts, w):
        valid = step_idx < npts
        xs = jax.vmap(coord)(rv[:, 0:3])
        Q = w * rv[:, slot]
        # freeze beyond the last valid point: constant Q, constant x -> dQ=0
        last = npts - 1
        xs = jnp.where(valid, xs, xs[last])
        Q = jnp.where(valid, Q, Q[last])
        return binning.bin_to_uniform_grid(Q, xs, xmin, xmax, n_bins)

    profiles = jax.vmap(per_ray)(ray_vec, npoints, pwr)
    total = jnp.sum(profiles, axis=0)
    edges = jnp.linspace(xmin, xmax, n_bins + 1)
    return DepositionProfile(name=which, grid=edges, profile=total)


def write_deposition_profiles_nc(cfg, params, results, n_bins: int = 50,
                                 path=None):
    """deposition_profiles.<label>.nc in the reference's exact schema
    (write_deposition_profiles_NC, deposition_profiles_m.f90:336-420):
    dims (n_profiles, n_bins, n_bins_p1, d20); per-profile Q_sum,
    grid_min/max, 20-char profile_name/grid_name, bin-edge grid
    (n_bins+1) and binned profile; global attrs RAYS_run_label +
    date_vector.  Consumed unmodified by graphics_RAYS/plot_profiles.py,
    P_profiles.py and PC_profiles.py (tests/test_aux_plotters.py)."""
    import datetime

    import numpy as np
    from scipy.io import netcdf_file

    names = profile_names_for_geometry(cfg.equilib_model, cfg, params)
    grids = {"Ptotal_x": "x", "Ptotal_psi": "psi", "Ptotal_rho": "rho",
             "Ptotal_AphiN": "AphiN"}
    profs = []
    for nm in names:
        if nm == "Ptotal_x":
            lo, hi = float(params.eq.xmin), float(params.eq.xmax)
        else:
            lo, hi = 0.0, 1.0
        profs.append((calculate_deposition_profile(
            cfg, params, results, nm, n_bins, lo, hi), lo, hi))

    fn = path or f"deposition_profiles.{cfg.run_label}.nc"
    now = datetime.datetime.now()
    f = netcdf_file(fn, "w")
    try:
        f.createDimension("n_profiles", len(profs))
        f.createDimension("n_bins", n_bins)
        f.createDimension("n_bins_p1", n_bins + 1)
        f.createDimension("d20", 20)
        f.createDimension("d8", 8)
        f.RAYS_run_label = cfg.run_label.encode()
        f.date_vector = np.array(
            [now.year, now.month, now.day, 0, now.hour, now.minute,
             now.second, 0], np.int32)

        def var(name, dtype, dims, data):
            v = f.createVariable(name, dtype, dims)
            v[:] = data
            return v

        def chars(strings):
            out = np.full((len(strings), 20), b" ", "S1")
            for i, s in enumerate(strings):
                b = s.encode()[:20]
                out[i, :len(b)] = np.frombuffer(b, "S1")
            return out

        var("Q_sum", np.float64, ("n_profiles",),
            [float(np.sum(np.asarray(p.profile))) for p, _, _ in profs])
        var("grid_min", np.float64, ("n_profiles",),
            [lo for _, lo, _ in profs])
        var("grid_max", np.float64, ("n_profiles",),
            [hi for _, _, hi in profs])
        var("profile_name", "S1", ("n_profiles", "d20"),
            chars([p.name for p, _, _ in profs]))
        var("grid_name", "S1", ("n_profiles", "d20"),
            chars([grids[p.name] for p, _, _ in profs]))
        var("grid", np.float64, ("n_profiles", "n_bins_p1"),
            np.stack([np.asarray(p.grid) for p, _, _ in profs]))
        var("profile", np.float64, ("n_profiles", "n_bins"),
            np.stack([np.asarray(p.profile) for p, _, _ in profs]))
    finally:
        f.close()
    return fn


def write_deposition_profiles_ld(cfg, params, results, n_bins: int = 50,
                                 path=None):
    """deposition_profiles.<label> in the reference's list-directed layout
    (write_deposition_profiles_LD, deposition_profiles_m.f90:296-331):
    per profile a name line, the binned values, a grid-name line, the bin
    edges, and the Q_sum total."""
    import numpy as np

    names = profile_names_for_geometry(cfg.equilib_model, cfg, params)
    grids = {"Ptotal_x": "x", "Ptotal_psi": "psi", "Ptotal_rho": "rho",
             "Ptotal_AphiN": "AphiN"}
    fn = path or f"deposition_profiles.{cfg.run_label}"
    with open(fn, "w") as f:
        for nm in names:
            if nm == "Ptotal_x":
                lo, hi = float(params.eq.xmin), float(params.eq.xmax)
            else:
                lo, hi = 0.0, 1.0
            prof = calculate_deposition_profile(
                cfg, params, results, nm, n_bins, lo, hi)
            f.write(f" profile_name = {nm}\n")
            f.write(" " + " ".join(
                f"{float(v):.17g}" for v in np.asarray(prof.profile)) + "\n")
            f.write(f" grid_name = {grids[nm]}\n")
            f.write(" " + " ".join(
                f"{float(v):.17g}" for v in np.asarray(prof.grid)) + "\n")
            f.write(" Ptotal_total_deposition\n")
            f.write(f" {float(np.sum(np.asarray(prof.profile))):.17g}\n")
    return fn


def profile_names_for_geometry(equilib_model: str, cfg=None, params=None):
    """Registry (deposition_profiles_m.f90:38-45).  Ptotal_rho joins the
    axisym_toroid list only when the magnetics backend defines rho (EQDSK
    spline with a usable Q profile) — the reference would fatal-error on
    other backends (axisym_toroid_eq_m.f90:399-437)."""
    if equilib_model == "slab":
        return ("Ptotal_x",)
    if equilib_model == "solovev":
        return ("Ptotal_psi",)
    if equilib_model == "axisym_toroid":
        names = ["Ptotal_psi"]
        if (cfg is not None and "eqdsk" in cfg.eq_static.magnetics_model
                and (params is None
                     or getattr(params.eq.mag, "rho_spline", None)
                     is not None)):
            names.append("Ptotal_rho")
        return tuple(names)
    if equilib_model == "multiple_mirror":
        return ("Ptotal_AphiN",)
    return ()
