"""Damping models.

Dispatch is static (cfg.damping_model), mirroring the reference's runtime
select (reference RAYS_project/RAYS_lib/damping_m.f90:93-112):

* ``no_damp``      — zeros.
* ``damp_fund_ECH`` — weak-damping fundamental electron-cyclotron absorption
  (damp_fund_ECH.f90), electrons only.  Returns the imaginary wavenumber
  k_i and its per-species split ksi (only ksi[0] nonzero).

The ECH model computes a warm correction D_warm from the Z function at
zeta = (omega + Omega_ce)/(k_par v_th) and divides by the cold-dispersion
directional derivative along the group velocity (damp_fund_ECH.f90:65-123).
Branch conditions (k_par == 0, |zeta| > 5 -> no damping) are masks, not
branches.
"""

from __future__ import annotations

import jax.numpy as jnp

from rays_tpu import constants
from rays_tpu.ops import zfun


def damping(cfg, params, eq, v_xk, vg):
    """(ksi (S,), ki ()) — wrapper (damping_m.f90:74-117)."""
    if cfg.damping_model == "no_damp":
        S = cfg.ns
        ksi = jnp.zeros((S,), dtype=v_xk.dtype)
        return ksi, jnp.sum(ksi)
    if cfg.damping_model == "damp_fund_ECH":
        return damp_fund_ech(cfg, params, eq, v_xk, vg)
    raise ValueError(f"damping: unimplemented damping model {cfg.damping_model}")


def damp_fund_ech(cfg, params, eq, v_xk, vg):
    """Weak fundamental-ECH damping (damp_fund_ECH.f90:39-127)."""
    dt = v_xk.dtype
    sp = params.species
    omgrf, k0 = params.rf.omgrf, params.rf.k0

    kvec = v_xk[3:6]
    nvec = kvec / k0
    k3 = jnp.dot(kvec, eq.bunit)
    k1sq = jnp.sum((kvec - k3 * eq.bunit) ** 2)
    r3 = k3 / k0
    r1s = k1sq / k0**2
    r3s = r3**2
    rs = r1s + r3s

    b1 = eq.gamma[0]           # signed electron gamma (negative)
    betae = b1**2

    # thermal speed; guard Te = 0 (t_prof_model 'zero') — masked out below
    te = jnp.maximum(eq.ts[0], jnp.asarray(1e-30, dt))
    vth = jnp.sqrt(2.0 * te / sp.ms[0])
    vt = vth / constants.CLIGHT

    safe_k3 = jnp.where(k3 == 0.0, jnp.asarray(1.0, dt), k3)
    xi = (omgrf + eq.omgc[0]) / (safe_k3 * vth)

    # Z function as a real pair (real arithmetic only).  |xi| > 5 is
    # masked to no-damping below; clamp the argument BEFORE the evaluation
    # (double-where discipline) so reverse-mode AD through the masked-out
    # branch never sees the inf/underflow intermediates a huge xi produces
    # (this is what NaN'd d(loss)/d(m_e) in adjoint runs).
    xi_z = jnp.clip(xi, -6.0, 6.0)
    zr, zi = zfun.zfun0_real_parts(xi_z, safe_k3)
    zmag2 = jnp.maximum(zr**2 + zi**2, constants.SAFE_TINY)

    p = eq.alpha[0]
    q = p / 2.0 / (1.0 - b1)

    lam1 = ((1.0 - q) * rs * r1s + (1.0 - p) * rs * r3s
            - (1.0 - q) * (1.0 - p) * (rs + r3s)
            - (1.0 - 2.0 * q) * r1s + (1.0 - 2.0 * q) * (1.0 - p))
    lam2 = (-p / b1 * (rs * r1s - (1.0 - 2.0 * q) * r1s)
            + p**2 / 4.0 / betae * r1s / jnp.where(r3s == 0, 1.0, r3s)
            * (rs + r3s - 2.0 * (1.0 - 2.0 * q)))
    lam5 = p * (rs * r3s - (1.0 - q) * (rs + r3s) + (1.0 - 2.0 * q))

    # D_warm = f_real * (xi + 1/Z); only its imaginary part enters ki:
    # Im(xi + 1/Z) = -Im(Z)/|Z|^2  (damp_fund_ECH.f90:88-90 in real form)
    f_real = (-(1.0 - b1) * r3 * vt
              * (lam1 + lam2 + r1s / 2.0 / jnp.where(r3 == 0, 1.0, r3)
                 / betae * vt * xi_z * lam5))
    d_warm_im = f_real * (-zi / zmag2)

    # cold-plasma directional derivative of D along vg (damp_fund_ECH.f90:92-109)
    a = 1.0 - p - betae
    b = -((1.0 - p) * a + (1.0 - p) ** 2 - betae) + (a + (1.0 - p) * (1.0 - betae)) * r3s
    ddnx2 = 2.0 * a * r1s + b
    ddnz = 2.0 * r3 * ((a + (1.0 - p) * (1.0 - betae)) * r1s
                       + (1.0 - p) * (2.0 * (1.0 - betae) * r3s - 2.0 * a))
    dn_par = eq.bunit
    dn_perp2 = 2.0 * (nvec - r3 * eq.bunit)
    ddn = ddnx2 * dn_perp2 + ddnz * dn_par

    vg_mag = jnp.sqrt(jnp.sum(vg**2))
    vg_unit = vg / jnp.maximum(vg_mag, constants.SAFE_TINY)
    denom = jnp.dot(ddn, vg_unit)
    safe_denom = jnp.where(denom == 0.0, jnp.asarray(1.0, dt), denom)

    # delta = -D_warm / (dD.vg_unit); ki = k0 * Im(delta)
    ki0 = k0 * (-d_warm_im / safe_denom)

    # mask the no-damping conditions (k_par == 0, |zeta| > 5, Te == 0)
    live = (k3 != 0.0) & (jnp.abs(xi) <= 5.0) & (eq.ts[0] > 0.0) & (denom != 0.0)
    ki0 = jnp.where(live, ki0, 0.0)

    ksi = jnp.zeros((cfg.ns,), dtype=dt).at[0].set(ki0)
    return ksi, ki0
