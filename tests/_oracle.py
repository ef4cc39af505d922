"""Independent pure-NumPy/SciPy trajectory oracle.

A deliberately dumb, scalar-loop transcription of the reference Fortran's
ray integration — formulas verbatim from

  * RAYS_project/RAYS_lib/eqn_ray.f90:86-229        (ray RHS)
  * RAYS_project/RAYS_lib/deriv_cold.f90:40-171     (analytic D derivatives)
  * RAYS_project/RAYS_lib/RK4_ode_m.f90:59-94       (fixed-step RK4)
  * RAYS_project/RAYS_lib/equilibrium_m.f90:237-269 (eq_point assembly)
  * RAYS_project/RAYS_lib/slab_eq_m.f90:125-309     (slab equilibrium)
  * RAYS_project/RAYS_lib/solovev_eq_m.f90:150-322  (Solovev equilibrium)
  * RAYS_project/RAYS_lib/eqdsk_magnetics_spline_interp_m.f90:206-283
  * RAYS_project/RAYS_lib/multiple_mirror_eq_m.f90:223-375
  * RAYS_project/RAYS_lib/check_save.f90:64-133,163-235 (residual + stops)
  * RAYS_project/RAYS_lib/damp_fund_ECH.f90:39-127  (weak ECH damping)
  * RAYS_project/RAYS_lib/suscep_m.f90:53-176       (cold dielectric)

It shares NO code with rays_tpu: plain Python scalar loops, Python complex
arithmetic, scipy not-a-knot cubic splines (vs. the package's own spline
kernels), and scipy.special.wofz for the plasma dispersion function (vs. the
package's Dawson/Weideman implementation).  tests/test_parity.py traces the
reference example classes with both implementations from identical initial
conditions and asserts the trajectories agree.

NOT device code.  Slow on purpose: correctness anchor only.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.special import wofz

# --- constants (reference constants_m.f90:42-48; NONSTANDARD values) ---
PI = 3.1415926535897932385
CLIGHT = 2.997930e8
MU0 = PI * 4.0e-7
EPS0 = 1.0 / (MU0 * CLIGHT**2)
ME = 9.1094e-31
MP = 1.6726e-27
E = 1.6022e-19


# ---------------------------------------------------------------------------
# equilibrium models: rvec -> (bvec, gradbtensor, ns, gradns, ts, gradts, err)
# gradbtensor[i][j] = d B_j / d x_i (reference convention).
# ns are PHYSICAL densities [m^-3]; ts in Joules.
# ---------------------------------------------------------------------------


def parabolic_prof(rho, f_min, alpha1, alpha2):
    """Reference slab_eq_m.f90:354-381 (verbatim, incl. rho >= 1 -> f = 0)."""
    f, fp = 0.0, 0.0
    if rho < 1.0:
        f = (1.0 - rho**alpha2) ** alpha1
        fp = (-alpha1 * alpha2 * rho ** (alpha2 - 1.0)
              * (1.0 - rho**alpha2) ** (alpha1 - 1.0))
    if f < f_min:
        f, fp = f_min, 0.0
    return f, fp


def hyperbolic_prof(rho, f_min, rho0, delta):
    """Reference multiple_mirror_eq_m.f90:486-505."""
    th0 = math.tanh(rho0 / delta)
    f = (math.tanh((rho + rho0) / delta)
         - math.tanh((rho - rho0) / delta)) / 2.0 / th0
    fp = (1.0 / math.cosh((rho + rho0) / delta) ** 2
          - 1.0 / math.cosh((rho - rho0) / delta) ** 2) / (2.0 * delta) / th0
    return (1.0 - f_min) * f + f_min, (1.0 - f_min) * fp


class SlabEq:
    """slab_eq_m.f90:125-309.  p: dict of namelist-style numbers; models:
    dict of profile-model strings; species: (n0s_phys, t0s) arrays."""

    def __init__(self, models, p, n0s_phys, t0s, eta=None):
        self.m = models
        self.p = p
        self.n0s = np.asarray(n0s_phys, float)
        self.t0s = np.asarray(t0s, float)
        self.eta = (np.ones_like(self.n0s) if eta is None
                    else np.asarray(eta, float))

    def __call__(self, rvec):
        p, m = self.p, self.m
        S = len(self.n0s)
        x, y, z = rvec
        bvec = np.zeros(3)
        gradb = np.zeros((3, 3))
        ns = np.zeros(S)
        gradns = np.zeros((3, S))
        ts = np.zeros(S)
        gradts = np.zeros((3, S))

        if x < p["xmin"] or x > p["xmax"]:
            return None, "x out_of_bounds"
        if y < p["ymin"] or y > p["ymax"]:
            return None, "y out_of_bounds"
        if z < p["zmin"] or z > p["zmax"]:
            return None, "z out_of_bounds"

        # By (slab_eq_m.f90:184-206)
        bym = m.get("by_prof_model", "zero")
        if bym == "zero":
            pass
        elif bym == "constant":
            bvec[1] = p["by0"]
        elif bym == "toroid":
            bvec[1] = p["by0"] / (1.0 + x / p["rmaj"])
            gradb[0][1] = -bvec[1] / (p["rmaj"] + x)
        elif bym == "linear_shear":
            bvec[1] = p["by0"] * x / p["lby_shear_scale"]
            gradb[0][1] = p["by0"] / p["lby_shear_scale"]
        else:
            raise ValueError(bym)

        # Bz (slab_eq_m.f90:209-233)
        bzm = m.get("bz_prof_model", "constant")
        if bzm == "zero":
            pass
        elif bzm == "constant":
            bvec[2] = p["bz0"]
        elif bzm == "toroid":
            bvec[2] = p["bz0"] / (1.0 + x / p["rmaj"])
            gradb[0][2] = -bvec[2] / (p["rmaj"] + x)
        elif bzm == "linear":
            bvec[2] = p["bz0"] * (1.0 + x / p["lbz_scale"])
            gradb[0][2] = p["bz0"] / p["lbz_scale"]
        elif bzm == "linear_2":
            bvec[2] = p["bz0"] + p["dbzdx"] * (x - p["x0"])
            gradb[0][2] = p["dbzdx"]
        else:
            raise ValueError(bzm)

        # density (slab_eq_m.f90:237-267)
        dm = m.get("dens_prof_model", "constant")
        if dm == "constant":
            ns[:] = self.n0s
        elif dm == "linear":
            ns[:] = self.n0s * (1.0 + x / p["ln_scale"])
            gradns[0, :] = self.n0s / p["ln_scale"]
        elif dm == "Gaussian":
            ns[:] = self.n0s * np.exp(-3.0 * p["alphan1"] * (x / p["rmin"]) ** 2)
            gradns[0, :] = ns * (-6.0 * p["alphan1"] * x / p["rmin"] ** 2)
        else:
            raise ValueError(dm)

        # temperature (slab_eq_m.f90:270-301)
        for i, tm in enumerate(m.get("t_prof_model", ("zero",) * S)):
            if tm == "zero":
                ts[i] = 0.0
            elif tm == "constant":
                ts[i] = self.t0s[i]
            elif tm == "linear":
                ts[i] = self.t0s[i] * (1.0 + x / p["lt_scale"])
                gradts[0, i] = self.t0s[i] / p["lt_scale"]
            else:
                raise ValueError(tm)

        if ns.min() < 0.0:
            return None, "negative_dens"
        if ts.min() < 0.0:
            return None, "negative_temp"
        return (bvec, gradb, ns, gradns, ts, gradts), ""


def _cyl_gradbtensor(x, y, z, r, br, bz, bphi,
                     dbrdr, dbrdz, dbzdr, dbzdz, dbphidr, dbphidz=0.0):
    """Cylindrical (br, bz, bphi)(r, z) -> cartesian gradbtensor
    (reference solovev_eq_m.f90:191-204, generalized with dbphidz)."""
    g = np.zeros((3, 3))
    g[0][0] = (dbrdr * x**2 + br * y**2 / r
               + (-dbphidr + bphi / r) * x * y) / r**2
    g[1][0] = ((dbrdr - br / r) * x * y - dbphidr * y**2
               - bphi * x**2 / r) / r**2
    g[2][0] = dbrdz * x / r - dbphidz * y / r
    g[0][1] = ((dbrdr - br / r) * x * y + dbphidr * x**2
               + bphi * y**2 / r) / r**2
    g[1][1] = (dbrdr * y**2 + br * x**2 / r
               + (dbphidr - bphi / r) * x * y) / r**2
    g[2][1] = dbrdz * y / r + dbphidz * x / r
    g[0][2] = dbzdr * x / r
    g[1][2] = dbzdr * y / r
    g[2][2] = dbzdz
    return g


class SolovevEq:
    """solovev_eq_m.f90:150-276."""

    def __init__(self, models, p, n0s_phys, t0s):
        self.m = models
        self.p = p
        self.n0s = np.asarray(n0s_phys, float)
        self.t0s = np.asarray(t0s, float)

    def psi(self, rvec):
        p = self.p
        x, y, z = rvec
        r = math.sqrt(x**2 + y**2)
        bp0 = p["bphi0"] * p["iota0"]
        psi = 0.5 * bp0 * ((r * z / (p["rmaj"] * p["kappa"])) ** 2
                           + ((r**2 - p["rmaj"] ** 2) ** 2) / p["rmaj"] ** 2 / 4.0)
        br = -bp0 * r * z / (p["rmaj"] * p["kappa"]) ** 2
        bz = bp0 * ((z / (p["rmaj"] * p["kappa"])) ** 2
                    + 0.5 * ((r / p["rmaj"]) ** 2 - 1.0))
        gradpsi = np.array([x * bz, y * bz, -r * br])
        psib = 0.5 * bp0 * (p["outer_bound"] ** 2 - p["rmaj"] ** 2) ** 2 \
            / p["rmaj"] ** 2 / 4.0
        return psi, gradpsi, psi / psib, gradpsi / psib

    def __call__(self, rvec):
        p, m = self.p, self.m
        S = len(self.n0s)
        x, y, z = rvec
        r = math.sqrt(x**2 + y**2)
        if r < p["box_rmin"] or r > p["box_rmax"]:
            return None, "R out_of_box"
        if z < p["box_zmin"] or z > p["box_zmax"]:
            return None, "z out_of_box"

        bp0 = p["bphi0"] * p["iota0"]
        _, _, psiN, gradpsiN = self.psi(rvec)

        # field + derivatives (solovev_eq_m.f90:169-204)
        br = -bp0 * r * z / (p["rmaj"] * p["kappa"]) ** 2
        bz = bp0 * ((z / (p["rmaj"] * p["kappa"])) ** 2
                    + 0.5 * ((r / p["rmaj"]) ** 2 - 1.0))
        bphi = p["bphi0"] * p["rmaj"] / r
        dbrdr = br / r
        dbrdz = -bp0 * r / (p["rmaj"] * p["kappa"]) ** 2
        dbzdr = bp0 * r / p["rmaj"] ** 2
        dbzdz = bp0 * 2.0 * z / (p["rmaj"] * p["kappa"]) ** 2
        dbphidr = -bphi / r
        bvec = np.array([br * x / r - bphi * y / r,
                         br * y / r + bphi * x / r, bz])
        gradb = _cyl_gradbtensor(x, y, z, r, br, bz, bphi,
                                 dbrdr, dbrdz, dbzdr, dbzdz, dbphidr)

        ns = np.zeros(S)
        gradns = np.zeros((3, S))
        ts = np.zeros(S)
        gradts = np.zeros((3, S))

        dm = m.get("dens_prof_model", "parabolic")
        if dm == "constant":
            ns[:] = self.n0s
        elif dm == "parabolic":
            # solovev_eq_m.f90:214-225
            if psiN < 1.0:
                ns[:] = self.n0s * (1.0 - psiN ** p["alphan2"]) ** p["alphan1"]
                dd = (-p["alphan1"] * p["alphan2"] * psiN ** (p["alphan2"] - 1.0)
                      * (1.0 - psiN ** p["alphan2"]) ** (p["alphan1"] - 1.0))
                for i in range(3):
                    gradns[i, :] = self.n0s * dd * gradpsiN[i]
        else:
            raise ValueError(dm)

        for i, tm in enumerate(m.get("t_prof_model", ("zero",) * S)):
            if tm == "zero":
                ts[i] = 0.0
            elif tm == "constant":
                ts[i] = self.t0s[i]
            elif tm == "parabolic":
                # values from solovev_eq_m.f90:254-255; gradient from the
                # CORRECT chain rule (the reference's :256-257 exponent
                # `alphat1` instead of `alphat1-1` is an upstream bug; the
                # package's autodiff gradient is consistent, and gradts does
                # not enter the cold-plasma trajectory in any case)
                if psiN < 1.0:
                    a1, a2 = p["alphat1"][i], p["alphat2"][i]
                    ts[i] = self.t0s[i] * (1.0 - psiN ** a2) ** a1
                    dd = (-a1 * a2 * psiN ** (a2 - 1.0)
                          * (1.0 - psiN ** a2) ** (a1 - 1.0))
                    for k in range(3):
                        gradts[k, i] = self.t0s[i] * dd * gradpsiN[k]
            else:
                raise ValueError(tm)

        if ns.min() < 0.0:
            return None, "negative_dens"
        if ts.min() < 0.0:
            return None, "negative_temp"
        return (bvec, gradb, ns, gradns, ts, gradts), ""


class NotAKnot2D:
    """Independent tensor-product not-a-knot bicubic via nested scipy
    CubicSplines (mathematically the same interpolant as the package's
    quick-cube-spline re-design; completely different code path)."""

    def __init__(self, xg, yg, f):
        self.yg = np.asarray(yg, float)
        # array-valued spline over x: S(x) -> values on the y grid
        self.sx = CubicSpline(np.asarray(xg, float), np.asarray(f, float),
                              axis=0, bc_type="not-a-knot")
        self.sx_d1 = self.sx.derivative(1)
        self.sx_d2 = self.sx.derivative(2)

    def evaluate(self, x, y):
        """(f, fx, fy, fxx, fxy, fyy) at scalar (x, y)."""
        rowf = self.sx(x)      # f(x, y_j)
        rowfx = self.sx_d1(x)  # f_x(x, y_j)
        rowfxx = self.sx_d2(x)
        sf = CubicSpline(self.yg, rowf, bc_type="not-a-knot")
        sfx = CubicSpline(self.yg, rowfx, bc_type="not-a-knot")
        f = float(sf(y))
        fy = float(sf(y, 1))
        fyy = float(sf(y, 2))
        fx = float(sfx(y))
        fxy = float(sfx(y, 1))
        fxx = float(CubicSpline(self.yg, rowfxx, bc_type="not-a-knot")(y))
        return f, fx, fy, fxx, fxy, fyy


class EqdskToroidEq:
    """axisym_toroid_eq_m.f90:215-363 with the EQDSK spline magnetics
    backend (eqdsk_magnetics_spline_interp_m.f90:206-283):
    B = (psi_z/R, -psi_R/R, RBphi/R) in cylindrical, psi shifted to 0 on
    axis, psiN = psi/(psiB-psiAxis)."""

    def __init__(self, models, p, n0s_phys, t0s, geqdsk):
        self.m = models
        self.p = p
        self.n0s = np.asarray(n0s_phys, float)
        self.t0s = np.asarray(t0s, float)
        g = geqdsk
        self.psi2d = NotAKnot2D(g.r_grid, g.z_grid, g.psi - g.psiaxis)
        self.rbphi = CubicSpline(np.asarray(g.r_grid, float),
                                 np.asarray(g.T, float), bc_type="not-a-knot")
        self.psib = float(g.psibound - g.psiaxis)

    def __call__(self, rvec):
        p, m = self.p, self.m
        S = len(self.n0s)
        x, y, z = rvec
        r = math.sqrt(x**2 + y**2)
        if r < p["box_rmin"] or r > p["box_rmax"]:
            return None, "R out_of_box"
        if z < p["box_zmin"] or z > p["box_zmax"]:
            return None, "z out_of_box"

        psi, psir, psiz, psirr, psirz, psizz = self.psi2d.evaluate(r, z)
        rb = float(self.rbphi(r))
        drb = float(self.rbphi(r, 1))

        br = psiz / r
        bz = -psir / r
        bphi = rb / r
        dbrdr = psirz / r - psiz / r**2
        dbrdz = psizz / r
        dbzdr = -psirr / r + psir / r**2
        dbzdz = -psirz / r
        dbphidr = drb / r - rb / r**2

        bvec = np.array([br * x / r - bphi * y / r,
                         br * y / r + bphi * x / r, bz])
        gradb = _cyl_gradbtensor(x, y, z, r, br, bz, bphi,
                                 dbrdr, dbrdz, dbzdr, dbzdz, dbphidr)

        psiN = psi / self.psib
        gradpsiN = np.array([psir * x / r, psir * y / r, psiz]) / self.psib
        if psiN > p.get("plasma_psi_limit", 1.0):
            return None, "out_of_plasma"

        ns = np.zeros(S)
        gradns = np.zeros((3, S))
        ts = np.zeros(S)
        gradts = np.zeros((3, S))

        dm = m.get("density_prof_model", "parabolic")
        if dm == "constant":
            ns[:] = self.n0s
        elif dm == "parabolic":
            f, fp = parabolic_prof(psiN, p.get("d_scrape_off", 0.0),
                                   p["alphan1"], p["alphan2"])
            ns[:] = self.n0s * f
            for i in range(3):
                gradns[i, :] = self.n0s * fp * gradpsiN[i]
        else:
            raise ValueError(dm)

        for i, tm in enumerate(m.get("temperature_prof_model", ("zero",) * S)):
            if tm == "zero":
                ts[i] = 0.0
            elif tm == "constant":
                ts[i] = self.t0s[i]
            elif tm == "parabolic":
                f, fp = parabolic_prof(psiN, p.get("t_scrape_off", 0.0),
                                       p["alphat1"][i], p["alphat2"][i])
                ts[i] = self.t0s[i] * f
                for k in range(3):
                    gradts[k, i] = self.t0s[i] * fp * gradpsiN[k]
            else:
                raise ValueError(tm)

        if ns.min() < 0.0:
            return None, "negative_dens"
        if ts.min() < 0.0:
            return None, "negative_temp"
        return (bvec, gradb, ns, gradns, ts, gradts), ""


class MirrorEq:
    """multiple_mirror_eq_m.f90:223-375 with the Brz spline backend
    (mirror_magnetics_spline_interp_m.f90:132-207)."""

    def __init__(self, models, p, n0s_phys, t0s, rg, zg, br, bz, aphi,
                 aphi_lufs):
        self.m = models
        self.p = p
        self.n0s = np.asarray(n0s_phys, float)
        self.t0s = np.asarray(t0s, float)
        self.br2d = NotAKnot2D(rg, zg, br)
        self.bz2d = NotAKnot2D(rg, zg, bz)
        self.aphi2d = NotAKnot2D(rg, zg, aphi)
        self.aphi_lufs = float(aphi_lufs)

    def __call__(self, rvec):
        p, m = self.p, self.m
        S = len(self.n0s)
        x, y, z = rvec
        r = max(math.sqrt(x**2 + y**2), 1e-12)
        if r > p["box_rmax"]:
            return None, "R out_of_box"
        if z < p["box_zmin"] or z > p["box_zmax"]:
            return None, "z out_of_box"

        br, dbrdr, dbrdz, _, _, _ = self.br2d.evaluate(r, z)
        bz, dbzdr, dbzdz, _, _, _ = self.bz2d.evaluate(r, z)
        aphi, daphidr, daphidz, _, _, _ = self.aphi2d.evaluate(r, z)

        bvec = np.array([x * br / r, y * br / r, bz])
        gradb = _cyl_gradbtensor(x, y, z, r, br, bz, 0.0,
                                 dbrdr, dbrdz, dbzdr, dbzdz, 0.0)

        aphiN = aphi / self.aphi_lufs
        gradaphiN = np.array([daphidr * x / r, daphidr * y / r,
                              daphidz]) / self.aphi_lufs
        if aphiN > p.get("plasma_aphin_limit", 1.0):
            return None, "out_of_plasma"

        ns = np.zeros(S)
        gradns = np.zeros((3, S))
        ts = np.zeros(S)
        gradts = np.zeros((3, S))

        dm = m.get("density_prof_model", "parabolic")
        if dm == "constant":
            ns[:] = self.n0s
        elif dm == "parabolic":
            f, fp = parabolic_prof(aphiN, p.get("d_scrape_off", 0.0),
                                   p["alphan1"], p["alphan2"])
            ns[:] = self.n0s * f
            for i in range(3):
                gradns[i, :] = self.n0s * fp * gradaphiN[i]
        elif dm == "hyperbolic":
            f, fp = hyperbolic_prof(aphiN, p.get("d_scrape_off", 0.0),
                                    p["aphin0_d"], p["delta_d"])
            ns[:] = self.n0s * f
            for i in range(3):
                gradns[i, :] = self.n0s * fp * gradaphiN[i]
        else:
            raise ValueError(dm)

        for i, tm in enumerate(m.get("temperature_prof_model", ("zero",) * S)):
            if tm == "zero":
                ts[i] = 0.0
            elif tm == "constant":
                ts[i] = self.t0s[i]
            elif tm == "parabolic":
                f, fp = parabolic_prof(aphiN, p.get("t_scrape_off", 0.0),
                                       p["alphat1"][i], p["alphat2"][i])
                ts[i] = self.t0s[i] * f
                for k in range(3):
                    gradts[k, i] = self.t0s[i] * fp * gradaphiN[k]
            elif tm == "hyperbolic":
                f, fp = hyperbolic_prof(aphiN, p.get("t_scrape_off", 0.0),
                                        p["aphin0_t"][i], p["delta_t"][i])
                ts[i] = self.t0s[i] * f
                for k in range(3):
                    gradts[k, i] = self.t0s[i] * fp * gradaphiN[k]
            else:
                raise ValueError(tm)

        if ns.min() < 0.0:
            return None, "negative_dens"
        if ts.min() < 0.0:
            return None, "negative_temp"
        return (bvec, gradb, ns, gradns, ts, gradts), ""


# ---------------------------------------------------------------------------
# eq_point assembly (equilibrium_m.f90:237-269)
# ---------------------------------------------------------------------------


class EqPoint:
    pass


def make_eq_point(raw, qs, ms, omgrf):
    bvec, gradb, ns, gradns, ts, gradts = raw
    eq = EqPoint()
    eq.bvec, eq.gradbtensor = bvec, gradb
    eq.ns, eq.gradns, eq.ts, eq.gradts = ns, gradns, ts, gradts
    bmag = math.sqrt(float(np.sum(bvec**2)))
    bunit = bvec / bmag
    eq.bmag, eq.bunit = bmag, bunit
    gradbmag = np.zeros(3)
    for i in range(3):
        gradbmag[i] = float(np.sum(gradb[i, :] * bunit))
    eq.gradbmag = gradbmag
    gradbunit = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            gradbunit[i][j] = (gradb[i][j] - gradbmag[i] * bunit[j]) / bmag
    eq.gradbunit = gradbunit
    S = len(ns)
    eq.omgc = np.array([qs[s] * bmag / ms[s] for s in range(S)])
    eq.omgp2 = np.array([ns[s] * qs[s] ** 2 / (EPS0 * ms[s]) for s in range(S)])
    eq.alpha = eq.omgp2 / omgrf**2
    eq.gamma = eq.omgc / omgrf
    return eq


# ---------------------------------------------------------------------------
# deriv_cold (deriv_cold.f90:40-171, scalar loops verbatim)
# ---------------------------------------------------------------------------


def deriv_cold(eq, nvec, omgrf, k0):
    S = len(eq.alpha)
    alpha, gamma = eq.alpha, eq.gamma

    n3 = float(np.dot(nvec, eq.bunit))
    n1 = math.sqrt(float(np.sum((nvec - n3 * eq.bunit) ** 2)))

    dn3dk = eq.bunit / k0
    dn12dk = (2.0 / k0) * (nvec - n3 * eq.bunit)

    dn3dx = np.zeros(3)
    for i in range(3):
        dn3dx[i] = float(np.sum(eq.gradbunit[i, :] * nvec))
    dn12dx = -2.0 * n3 * dn3dx

    dadx = np.zeros((3, S))
    dgdx = np.zeros((3, S))
    for i in range(3):
        for s in range(S):
            # deriv_cold.f90:64 divides alpha*gradns by ns; at ns = 0
            # (outside the plasma) alpha = C*ns so the true limit is
            # C*gradns = 0 there (gradns = 0 too) — guard the 0/0
            if eq.ns[s] != 0.0:
                dadx[i][s] = alpha[s] * eq.gradns[i][s] / eq.ns[s]
            dgdx[i][s] = gamma[s] * eq.gradbmag[i] / eq.bmag

    dn3dw = -n3 / omgrf
    dn12dw = (-2.0 / omgrf) * n1**2
    dadw = -2.0 / omgrf * alpha
    dgdw = -1.0 / omgrf * gamma

    p = 1.0 - float(np.sum(alpha))
    t = float(np.prod(1.0 - gamma**2))

    dq1da = np.ones(S)
    dq2da = np.ones(S)
    for s1 in range(S):
        for s in range(S):
            if s != s1:
                dq1da[s1] *= 1.0 + gamma[s]
                dq2da[s1] *= 1.0 - gamma[s]
    q1 = float(np.sum(alpha * dq1da))
    q2 = float(np.sum(alpha * dq2da))
    u = t - float(np.sum(alpha * dq1da * dq2da))
    q = 2.0 * u - t + q1 * q2
    duda = -dq1da * dq2da
    dqda = 2.0 * duda + dq1da * q2 + q1 * dq2da

    ddda = (-t * n3**4
            + (2.0 * (u - p * duda) + (-t + duda) * n1**2) * n3**2
            - q + p * dqda - (dqda - u + p * duda) * n1**2 + duda * n1**4)

    gp = np.ones((S, S))
    gm = np.ones((S, S))
    for s1 in range(S):
        for s2 in range(S):
            for s in range(S):
                if s != s1 and s != s2:
                    gp[s1][s2] *= 1.0 + gamma[s]
                    gm[s1][s2] *= 1.0 - gamma[s]
    gpm = gp * gm

    dtdg = 2.0 * gamma * duda
    dudg = np.zeros(S)
    for s in range(S):
        dudg[s] = float(np.sum(alpha * gpm[:, s]))
    dudg = dtdg + 2.0 * gamma * (dudg + alpha * duda)

    dq1dg = np.zeros(S)
    for s in range(S):
        dq1dg[s] = float(np.sum(alpha * gp[:, s]))
    dq1dg = dq1dg - alpha * dq1da

    dq2dg = np.zeros(S)
    for s in range(S):
        dq2dg[s] = float(np.sum(alpha * gm[:, s]))
    dq2dg = -dq2dg + alpha * dq2da

    dqdg = 2.0 * dudg - dtdg + dq1dg * q2 + q1 * dq2dg

    dddg = (dtdg * p * n3**4
            + (-2.0 * p * dudg + (dtdg * p + dudg) * n1**2) * n3**2
            + p * dqdg - (dqdg + p * dudg) * n1**2 + dudg * n1**4)

    dddn3 = (4.0 * t * p * n3**2
             + 2.0 * (-2.0 * p * u + (t * p + u) * n1**2)) * n3
    dddn12 = (t * p + u) * n3**2 - (q + p * u) + 2.0 * u * n1**2

    dddk = dddn3 * dn3dk + dddn12 * dn12dk
    dddx = np.zeros(3)
    for i in range(3):
        dddx[i] = float(np.sum(ddda * dadx[i, :] + dddg * dgdx[i, :]))
    dddx = dddx + dddn3 * dn3dx + dddn12 * dn12dx
    dddw = (float(np.sum(ddda * dadw + dddg * dgdw))
            + dddn3 * dn3dw + dddn12 * dn12dw)
    return dddx, dddk, dddw


# ---------------------------------------------------------------------------
# dispersion residual (check_save.f90:163-235) and cold dielectric
# (suscep_m.f90:53-176)
# ---------------------------------------------------------------------------


def dielectric_cold(eq):
    S = len(eq.alpha)
    eps = np.zeros((3, 3), complex)
    for s in range(S):
        a, g = eq.alpha[s], eq.gamma[s]
        chi = np.zeros((3, 3), complex)
        chi[0][0] = -a / (1.0 - g**2)
        chi[1][1] = chi[0][0]
        chi[2][2] = -a
        chi[0][1] = -1j * a * g / (1.0 - g**2)
        chi[1][0] = -chi[0][1]
        eps += chi
    for i in range(3):
        eps[i][i] += 1.0
    return eps


def residual(eq, k1, k3, k0):
    eps = dielectric_cold(eq)
    eps_h = 0.5 * (eps + eps.conj().T)
    n = np.array([k1 / k0, 0.0, k3 / k0])
    nsq = float(np.sum(n**2))
    epsn = np.zeros((3, 3), complex)
    eps_norm = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            delta = 1.0 if i == j else 0.0
            epsn[i][j] = eps_h[i][j] + n[i] * n[j] - delta * nsq
            eps_norm[i][j] = abs(eps_h[i][j]) + abs(n[i] * n[j])
    ctmp = (epsn[2][2] * (epsn[0][0] * epsn[1][1] - epsn[1][0] * epsn[0][1])
            - epsn[2][1] * (epsn[0][0] * epsn[1][2] - epsn[1][0] * epsn[0][2])
            + epsn[2][0] * (epsn[0][1] * epsn[1][2] - epsn[1][1] * epsn[0][2]))
    denom = (eps_norm[2][2] * (eps_norm[0][0] * eps_norm[1][1])
             + eps_norm[2][2] * (eps_norm[1][0] * eps_norm[0][1])
             + eps_norm[2][1] * (eps_norm[0][0] * eps_norm[1][2])
             + eps_norm[2][1] * (eps_norm[1][0] * eps_norm[0][2])
             + eps_norm[2][0] * (eps_norm[0][1] * eps_norm[1][2])
             + eps_norm[2][0] * (eps_norm[1][1] * eps_norm[0][2]))
    return abs(ctmp) / denom


# ---------------------------------------------------------------------------
# damping (damp_fund_ECH.f90:39-127); Z function via scipy wofz
# ---------------------------------------------------------------------------


def zfun(z):
    """Plasma dispersion function Z(z) = i sqrt(pi) w(z)."""
    return 1j * math.sqrt(PI) * wofz(z)


def zfun0(xi, kz):
    """zfun0.f90: Landau sign from k_parallel."""
    if kz > 0.0:
        return zfun(xi)
    return -zfun(-xi)


def damp_fund_ech(eq, v_xk, vg, omgrf, k0, ms):
    S = len(eq.alpha)
    ksi = np.zeros(S)
    kvec = np.asarray(v_xk[3:6])
    nvec = kvec / k0
    k3 = float(np.dot(kvec, eq.bunit))
    k1 = math.sqrt(float(np.sum((kvec - k3 * eq.bunit) ** 2)))
    r3 = k3 / k0
    r1 = k1 / k0
    r1s, r3s = r1**2, r3**2
    rs = r1s + r3s
    b1 = eq.gamma[0]
    betae = b1**2
    if r3 == 0.0:
        return ksi, 0.0
    vth = math.sqrt(2.0 * eq.ts[0] / ms[0])
    vt = vth / CLIGHT
    xi = (omgrf + eq.omgc[0]) / (k3 * vth)
    if abs(xi) > 5.0:
        return ksi, 0.0
    zf = zfun0(complex(xi), k3)

    p = eq.alpha[0]
    q = p / 2.0 / (1.0 - b1)
    lam1 = ((1.0 - q) * rs * r1s + (1.0 - p) * rs * r3s
            - (1.0 - q) * (1.0 - p) * (rs + r3s)
            - (1.0 - 2.0 * q) * r1s + (1.0 - 2.0 * q) * (1.0 - p))
    lam2 = (-p / b1 * (rs * r1s - (1.0 - 2.0 * q) * r1s)
            + p**2 / 4.0 / betae * r1s / r3s
            * (rs + r3s - 2.0 * (1.0 - 2.0 * q)))
    lam5 = p * (rs * r3s - (1.0 - q) * (rs + r3s) + (1.0 - 2.0 * q))
    d_warm = (-(1.0 - b1) * r3 * vt
              * (lam1 + lam2 + r1s / 2.0 / r3 / betae * vt * xi * lam5)
              * (xi + 1.0 / zf))

    a = 1.0 - p - betae
    b = (-((1.0 - p) * a + (1.0 - p) ** 2 - betae)
         + (a + (1.0 - p) * (1.0 - betae)) * r3s)
    ddnx2 = 2.0 * a * r1s + b
    ddnz = 2.0 * r3 * ((a + (1.0 - p) * (1.0 - betae)) * r1s
                       + (1.0 - p) * (2.0 * (1.0 - betae) * r3s - 2.0 * a))
    dn_par = eq.bunit
    dn_perp2 = 2.0 * (nvec - r3 * eq.bunit)
    ddn = ddnx2 * dn_perp2 + ddnz * dn_par

    vg_unit = vg / math.sqrt(float(np.sum(vg**2)))
    delta = -d_warm / float(np.dot(ddn, vg_unit))
    ksi[0] = k0 * delta.imag
    return ksi, ksi[0]


# ---------------------------------------------------------------------------
# eqn_ray RHS (eqn_ray.f90:82-229) and the RK4 trace loop
# ---------------------------------------------------------------------------


class OracleConfig:
    def __init__(self, eq_fn, qs, ms, omgrf, k0, ray_param="arcl",
                 damping_model="no_damp", multi_spec_damping=False,
                 integrate_eq_gradients=False,
                 dispersion_resid_limit=0.1, total_damping_limit=0.99,
                 n_norm=1.0):
        self.eq_fn = eq_fn
        self.qs = np.asarray(qs, float)
        self.ms = np.asarray(ms, float)
        self.omgrf = float(omgrf)
        self.k0 = float(k0)
        self.ray_param = ray_param
        self.damping_model = damping_model
        self.multi_spec_damping = multi_spec_damping
        self.integrate_eq_gradients = integrate_eq_gradients
        self.dispersion_resid_limit = dispersion_resid_limit
        self.total_damping_limit = total_damping_limit
        # divisor for the ne gradient-diagnostic slot: the reference
        # integrates physical gradns (eqn_ray.f90:226, "ne normalized to
        # peak electron density" is its stated intent); pass n_ref to match
        # an implementation that stores the diagnostic normalized
        self.n_norm = float(n_norm)
        self.nspec = len(self.qs) - 1

    @property
    def nv(self):
        nv = 7
        if self.damping_model != "no_damp":
            nv += 1
            if self.multi_spec_damping:
                nv += 1 + self.nspec
        if self.integrate_eq_gradients:
            nv += 5
        return nv


def eqn_ray(oc: OracleConfig, s, v):
    """Returns (dvds, stop_flag_str)."""
    nv = oc.nv
    dvds = np.zeros(nv)
    rvec = np.asarray(v[0:3])
    kvec = np.asarray(v[3:6])
    nvec = kvec / oc.k0

    raw, err = oc.eq_fn(rvec)
    if err:
        return dvds, err
    eq = make_eq_point(raw, oc.qs, oc.ms, oc.omgrf)

    dddx, dddk, dddw = deriv_cold(eq, nvec, oc.omgrf, oc.k0)

    if dddw != 0.0:
        vg = -dddk / dddw
        vg0 = math.sqrt(float(np.sum(vg**2)))
        vg_unit = vg / vg0
    else:
        return dvds, "infinite Vg"

    if oc.ray_param == "arcl":
        if np.any(dddk != 0.0):
            sgn = 1.0 if dddw >= 0.0 else -1.0
            dkmag = math.sqrt(float(np.sum(dddk**2)))
            dvds[0:3] = -sgn * dddk / dkmag
            dvds[3:6] = sgn * dddx / dkmag
            dsd_ray_param = 1.0
        else:
            return dvds, "ray stalled"
    elif oc.ray_param == "time":
        dvds[0:3] = -dddk / dddw
        dvds[3:6] = dddx / dddw
        dsd_ray_param = vg0
    else:
        raise ValueError(oc.ray_param)

    dvds[6] = dsd_ray_param
    nv0 = 7
    if oc.damping_model != "no_damp":
        if oc.damping_model == "damp_fund_ECH":
            ksi, ki = damp_fund_ech(eq, v[0:6], vg, oc.omgrf, oc.k0, oc.ms)
        else:
            raise ValueError(oc.damping_model)
        dvds[nv0] = dsd_ray_param * 2.0 * ki * (1.0 - v[nv0])
        if oc.multi_spec_damping:
            for js in range(oc.nspec + 1):
                dvds[nv0 + 1 + js] = (dsd_ray_param * 2.0 * ksi[js]
                                      * (1.0 - v[nv0]))
            nv0 = nv0 + 1 + oc.nspec
        nv0 += 1

    if oc.integrate_eq_gradients:
        for i in range(3):
            dvds[nv0 + i] = dsd_ray_param * float(
                np.sum(vg_unit * eq.gradbtensor[:, i]))
        dvds[nv0 + 3] = dsd_ray_param * float(
            np.sum(vg_unit * eq.gradns[:, 0])) / oc.n_norm
        dvds[nv0 + 4] = dsd_ray_param * float(np.sum(vg_unit * eq.gradts[:, 0]))

    return dvds, ""


def rk4_step(oc, s, v, ds):
    """RK4_ode_m.f90:59-94: abort (v unchanged) on any stage stop."""
    f1, e1 = eqn_ray(oc, s, v)
    if e1:
        return v, e1
    f2, e2 = eqn_ray(oc, s + ds / 2.0, v + ds * f1 / 2.0)
    if e2:
        return v, e2
    f3, e3 = eqn_ray(oc, s + ds / 2.0, v + ds * f2 / 2.0)
    if e3:
        return v, e3
    f4, e4 = eqn_ray(oc, s + ds, v + ds * f3)
    if e4:
        return v, e4
    return v + ds * (f1 + 2.0 * f2 + 2.0 * f3 + f4) / 6.0, ""


def check_save(oc, v):
    """check_save.f90:64-133 — residual + limit stops at the new point."""
    rvec, kvec = np.asarray(v[0:3]), np.asarray(v[3:6])
    raw, err = oc.eq_fn(rvec)
    if err:
        return 0.0, err
    eq = make_eq_point(raw, oc.qs, oc.ms, oc.omgrf)
    k3 = float(np.dot(kvec, eq.bunit))
    k1 = math.sqrt(float(np.sum((kvec - k3 * eq.bunit) ** 2)))
    resid = residual(eq, k1, k3, oc.k0)
    if resid > oc.dispersion_resid_limit:
        return resid, "dispersion_residual"
    if oc.damping_model != "no_damp" and v[7] > oc.total_damping_limit:
        return resid, "total_absorption"
    return resid, ""


def trace_ray(oc, v0, nstep_max, ds, s_max):
    """Outer trajectory loop with the package's stop ordering
    (ray_tracing.f90:116-245 / rays_tpu.tracing.trace).  Returns
    (traj (npoints, nv), resids (npoints,), stop_flag)."""
    v = np.asarray(v0, float).copy()
    traj = [v.copy()]
    resids = [0.0]
    flag = ""
    for k in range(nstep_max):
        s = k * ds
        sout = (k + 1) * ds
        if sout > s_max:
            flag = "sout > s_max"
            break
        v_new, err = rk4_step(oc, s, v, ds)
        if err:
            flag = err
            break
        resid, err = check_save(oc, v_new)
        if err:
            flag = err
            break
        v = v_new
        traj.append(v.copy())
        resids.append(resid)
    else:
        flag = " nstep > nstep_max"
    return np.asarray(traj), np.asarray(resids), flag
