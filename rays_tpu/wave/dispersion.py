"""The scalar dispersion function D(x, k, omega) and its root solvers.

This is the heart of the framework.  ``dispersion_D`` is a pure scalar JAX
function; the ray equations are obtained from it by ``jax.grad`` (see
tracing/rhs.py), replacing the reference's 228 lines of hand chain-rule
(deriv_cold.f90) and its finite-difference fallback (deriv_num.f90) — both
retained as test oracles.

We trace the pole-free polynomial form

    D = u*n1s^2 + ((t*p+u)*n3^2 - (q+p*u))*n1s + t*p*n3^4 - 2*p*u*n3^2 + p*q

with n1s = n_perp^2, which equals prod_s(1-gamma_s^2) times the Stix
biquadratic A*n1s^2 + B*n1s + C (coefficients at suscep_m.f90:244-247).
This is exactly the function whose derivatives deriv_cold.f90:157-171
computes, and it is finite through cyclotron resonances.
"""

from __future__ import annotations

import jax.numpy as jnp

from rays_tpu import constants
from rays_tpu.models import base
from rays_tpu.wave import stix

_MODE_INDEX = {"plus": 0, "minus": 1, "fast": 2, "slow": 3}


def alpha_gamma(cfg, params, x, omega):
    """(alpha, gamma, bunit, bmag) at x for frequency omega — the minimal
    plasma state needed by the cold dispersion relation.  Formed from the
    host-precomputed nondimensional coefficients (SpeciesParams docstring):
    the raw SI expressions would leave a float32 exponent range."""
    bvec, ns, _ = base.eq_fields(cfg, params, x)
    bmag = jnp.sqrt(jnp.sum(bvec**2))
    bunit = bvec / jnp.maximum(bmag, constants.SAFE_TINY)
    sp = params.species
    wratio = params.rf.omgrf_ref / omega
    alpha = sp.alpha_coef * ns * wratio**2
    gamma = sp.gamma_coef * bmag * wratio
    return alpha, gamma, bunit, bmag


def poly_D_of_n(alpha, gamma, n1sq, n3):
    """Pole-free scalar dispersion function vs (n_perp^2, n_par)."""
    p, t, u, q, _, _ = stix.poly_pieces(alpha, gamma)
    return (
        u * n1sq**2
        + ((t * p + u) * n3**2 - (q + p * u)) * n1sq
        + t * p * n3**4
        - 2.0 * p * u * n3**2
        + p * q
    )


def dispersion_D(cfg, params, x, kvec, omega):
    """Scalar D(x, k, omega).  nvec = k*c/omega (k0 = omega/c, rf_m.f90:91)."""
    alpha, gamma, bunit, _ = alpha_gamma(cfg, params, x, omega)
    nvec = kvec * constants.CLIGHT / omega
    n3 = jnp.dot(nvec, bunit)
    n1sq = jnp.sum(nvec**2) - n3**2
    return poly_D_of_n(alpha, gamma, n1sq, n3)


# --------------------------------------------------------------------------
# Root solvers (ray initialization) — reference dispersion_solvers_m.f90
# --------------------------------------------------------------------------


def solve_cold_n1sq_vs_n3(alpha, gamma, n3):
    """Cold-plasma n_perp^2 roots vs n_par, with the numerically stable
    quadratic branch (reference disp_solve_cold_n1sq_vs_n3.f90:53-87).

    Device code keeps to real arithmetic, so instead of the
    reference's complex(4) result we return ``(roots (4,), evanescent ())``:
    when the discriminant is negative the roots are a complex-conjugate pair;
    ``roots`` then holds their common real part and ``evanescent`` is True.
    Root order: [plus, minus, fast, slow].
    """
    S, D, P, R, L = stix.rlsdp(alpha, gamma)
    a = S
    b = -R * L - P * S + n3**2 * (P + S)
    c = P * (n3**2 - R) * (n3**2 - L)
    discr = b**2 - 4.0 * a * c
    evanescent = discr < 0.0
    sqrt_d = jnp.sqrt(jnp.maximum(discr, 0.0))

    # sign convention: Fortran sign(1., b) is +1 at b == 0
    b_neg = b < 0.0
    denom_plus = -b + sqrt_d   # used when b < 0
    denom_minus = -b - sqrt_d  # used when b >= 0
    safe = lambda d: jnp.where(d == 0.0, jnp.ones_like(d), d)
    plus = jnp.where(b_neg, denom_plus / (2.0 * a), 2.0 * c / safe(denom_minus))
    minus = jnp.where(b_neg, 2.0 * c / safe(denom_plus), denom_minus / (2.0 * a))

    fast_is_plus = jnp.abs(plus) <= jnp.abs(minus)
    fast = jnp.where(fast_is_plus, plus, minus)
    slow = jnp.where(fast_is_plus, minus, plus)
    return jnp.stack([plus, minus, fast, slow]), evanescent


def solve_n1_vs_n2_n3(alpha, gamma, wave_mode, k_sign, n2, n3):
    """n1 for the selected mode (dispersion_solvers_m.f90:49-112).

    Returns (n1, valid): valid is False where the mode is evanescent
    (n1 would be complex); n1 is then 0.
    """
    roots, evanescent = solve_cold_n1sq_vs_n3(alpha, gamma, n3)
    n1sq = roots[_MODE_INDEX[wave_mode]]
    rad = n1sq - n2**2
    valid = (~evanescent) & (rad >= 0.0)
    return k_sign * jnp.sqrt(jnp.maximum(rad, 0.0)), valid


def solve_nx_vs_ny_nz_by_bz(alpha, gamma, bunit, wave_mode, k_sign, ny, nz):
    """Resolve (ny, nz) into transverse/parallel components against B lying
    in the y-z plane, then solve for nx
    (dispersion_solvers_m.f90:116-166).  Returns (nx, valid)."""
    n2 = ny * bunit[2] - nz * bunit[1]
    n3 = ny * bunit[1] + nz * bunit[2]
    return solve_n1_vs_n2_n3(alpha, gamma, wave_mode, k_sign, n2, n3)


def solve_cold_nsq_vs_theta(alpha, gamma, theta):
    """Appleton-Hartree-like n^2 roots vs angle theta between n and B
    (disp_solve_cold_nsq_vs_theta.f90:33-70).  Returns real (4,):
    [plus, minus, fast, slow]; entries may be negative (evanescent)."""
    S, D, P, R, L = stix.rlsdp(alpha, gamma)
    cos2 = jnp.cos(theta) ** 2
    sin2 = 1.0 - cos2
    a = S * sin2 + P * cos2
    b = -R * L * sin2 - P * S * (1.0 + cos2)
    c = P * R * L
    discr = b**2 - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(discr, 0.0))

    b_neg = b < 0.0
    denom_plus = -b + sqrt_d
    denom_minus = -b - sqrt_d
    plus = jnp.where(b_neg, denom_plus / (2.0 * a), 2.0 * c / denom_minus)
    minus = jnp.where(b_neg, 2.0 * c / denom_plus, denom_minus / (2.0 * a))

    fast_is_plus = jnp.abs(plus) <= jnp.abs(minus)
    fast = jnp.where(fast_is_plus, plus, minus)
    slow = jnp.where(fast_is_plus, minus, plus)
    return jnp.stack([plus, minus, fast, slow])


def solve_n_vs_theta(alpha, gamma, wave_mode, k_sign, theta):
    """n for the selected mode at angle theta
    (dispersion_solvers_m.f90:169-231).  Returns (n, valid): valid is False
    where n^2 < 0 (evanescent)."""
    nsq = solve_cold_nsq_vs_theta(alpha, gamma, theta)[_MODE_INDEX[wave_mode]]
    return k_sign * jnp.sqrt(jnp.maximum(nsq, 0.0)), nsq >= 0.0


# --------------------------------------------------------------------------
# Dispersion residual monitor — reference check_save.f90:163-235
# --------------------------------------------------------------------------


def residual(alpha, gamma, n1, n3):
    """|det(eps_h + n n - n^2 I)| normalized by the sum of |term| products.

    This is the continuously-enforced physics invariant of the production
    path: large residual means the integrated k has drifted off the
    dispersion surface (check_save.f90:163-235).

    The cold Hermitian dielectric is eps = [[S,-iD,0],[iD,S,0],[0,0,P]]
    with real S, D, P; with n = (n1, 0, n3) the determinant of
    M = eps_h + nn - n^2 I is real and expands in purely real arithmetic
    (device code keeps to real arithmetic):

        det = M33*(M11*M22 - D^2) - n1^2 n3^2 * M22
    """
    S, D, P, _, _ = stix.rlsdp(alpha, gamma)
    nsq = n1**2 + n3**2
    m11 = S + n1**2 - nsq
    m22 = S - nsq
    m33 = P + n3**2 - nsq
    m13 = n1 * n3
    det = m33 * (m11 * m22 - D**2) - m13**2 * m22

    # |eps_h[i,j]| + |n_i n_j| entries that appear in the reference's norm
    # (check_save.f90:226-232); zero entries dropped.
    en11 = jnp.abs(S) + n1**2
    en22 = jnp.abs(S)
    en33 = jnp.abs(P) + n3**2
    en12 = jnp.abs(D)
    en13 = jnp.abs(m13)
    denom = (
        en33 * (en11 * en22)
        + en33 * (en12 * en12)
        + en13 * (en22 * en13)  # en31*(en22*en13) term
    )
    return jnp.abs(det) / denom
