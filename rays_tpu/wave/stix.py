"""Cold-plasma Stix parameters and the pole-free polynomial pieces.

Everything is a pure function of the per-species arrays
``alpha = (omega_p/omega)^2`` and ``gamma = omega_c/omega`` (electron gamma
negative — the reference keeps signed charges, suscep_m.f90:65-75).

Two equivalent representations are provided:

* ``rlsdp(alpha, gamma)``: R, L, S, D, P as in Stix eq. 1.19-1.22
  (reference RAYS_project/RAYS_lib/suscep_m.f90:180-219).  These have poles
  at cyclotron resonances (gamma = ±1).

* ``poly_pieces(alpha, gamma)``: the pole-free species-product quantities
  (p, t, u, q, q1, q2) underlying the reference's hand-derived ray
  derivatives (deriv_cold.f90:77-101).  Identities:
      t = prod_s (1-gamma_s^2),  u = t*S,  q = t*R*L,
      q1 = sum_s alpha_s prod_{i!=s}(1+gamma_i),
      q2 = sum_s alpha_s prod_{i!=s}(1-gamma_i),
      q  = 2u - t + q1*q2,      p = P.
  The ray Hamiltonian uses D_poly = t * D_stix, which is finite through
  cyclotron resonances — the same normalization the reference applies to its
  numerical derivatives (deriv_num.f90:99-153).

Leave-one-out products are computed with masked (S,S) products rather than
division, so gamma = ±1 is exactly representable.  S <= 6, so these tiny
tensor ops are negligible and fuse completely under XLA.
"""

from __future__ import annotations

import jax.numpy as jnp


def rlsdp(alpha, gamma):
    """Returns (S, D, P, R, L) — reference RLSDP_cold (suscep_m.f90:180-219)."""
    R = 1.0 - jnp.sum(alpha / (1.0 + gamma))
    L = 1.0 - jnp.sum(alpha / (1.0 - gamma))
    S = (R + L) / 2.0
    D = (R - L) / 2.0
    P = 1.0 - jnp.sum(alpha)
    return S, D, P, R, L


def leave_one_out_products(gamma):
    """(dq1da, dq2da): dq1da[s] = prod_{i!=s}(1+gamma_i), dq2da likewise
    with (1-gamma_i) (deriv_cold.f90:83-91)."""
    n = gamma.shape[0]
    eye = jnp.eye(n, dtype=bool)
    mp = jnp.where(eye, 1.0, (1.0 + gamma)[None, :])
    mm = jnp.where(eye, 1.0, (1.0 - gamma)[None, :])
    return jnp.prod(mp, axis=1), jnp.prod(mm, axis=1)


def leave_two_out_products(gamma):
    """(gp, gm): gp[s1,s2] = prod_{i not in {s1,s2}}(1+gamma_i)
    (deriv_cold.f90:116-125)."""
    n = gamma.shape[0]
    i = jnp.arange(n)
    # mask[s1, s2, i] = (i != s1) & (i != s2)
    mask = (i[None, None, :] != i[:, None, None]) & (i[None, None, :] != i[None, :, None])
    gp = jnp.prod(jnp.where(mask, (1.0 + gamma)[None, None, :], 1.0), axis=-1)
    gm = jnp.prod(jnp.where(mask, (1.0 - gamma)[None, None, :], 1.0), axis=-1)
    return gp, gm


def poly_pieces(alpha, gamma):
    """(p, t, u, q, q1, q2) — the pole-free pieces (deriv_cold.f90:77-101)."""
    dq1da, dq2da = leave_one_out_products(gamma)
    t = jnp.prod((1.0 + gamma) * (1.0 - gamma))
    q1 = jnp.sum(alpha * dq1da)
    q2 = jnp.sum(alpha * dq2da)
    u = t - jnp.sum(alpha * dq1da * dq2da)
    q = 2.0 * u - t + q1 * q2
    p = 1.0 - jnp.sum(alpha)
    return p, t, u, q, q1, q2


def cold_eps_hermitian(alpha, gamma):
    """Cold dielectric tensor (Hermitian; no collisions) as a complex (3,3):
    eps = [[S, -iD, 0], [iD, S, 0], [0, 0, P]]
    (dielectric_cold, suscep_m.f90:142-176).

    HOST-SIDE ONLY (complex dtypes).  Device code uses
    the real (S, D, P) decomposition directly (see dispersion.residual).
    """
    S, D, P, _, _ = rlsdp(alpha, gamma)
    z = jnp.zeros_like(S)
    row0 = jnp.stack([S + 0j, -1j * D, z + 0j])
    row1 = jnp.stack([1j * D, S + 0j, z + 0j])
    row2 = jnp.stack([z + 0j, z + 0j, P + 0j])
    return jnp.stack([row0, row1, row2])
