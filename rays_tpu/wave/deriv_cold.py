"""Closed-form cold-plasma D-derivatives — the PRODUCTION derivative path.

Vectorized re-derivation of the reference's hand chain-rule
(reference RAYS_project/RAYS_lib/deriv_cold.f90:40-171).  This is what
``ray_deriv_name='cold'`` (the default) dispatches to in tracing/rhs.py;
the ``jax.grad``-of-scalar-D path (``ray_deriv_name='autodiff'``) is the
independent A/B partner, reproducing the reference's
``ray_deriv_name = 'cold' | 'numerical'`` check (eqn_ray.f90:106-123)
with an exact rather than finite-difference alternative — tests assert
the two agree.

Op-mix notes: divides are issued once per unique denominator and
multiplied through; the tiny matvecs use broadcast multiply-reduce, not
``@`` (which would be a vmapped (S,)x(S,S) dot_general).
"""

from __future__ import annotations

import jax.numpy as jnp

from rays_tpu import constants

from rays_tpu.wave import stix


def deriv_cold(eq, nvec, omgrf, k0):
    """(dddx (3,), dddk (3,), dddw ()) at an EqPoint for refractive index
    nvec (deriv_cold.f90)."""
    alpha, gamma = eq.alpha, eq.gamma
    tiny = constants.SAFE_TINY

    n3 = jnp.sum(nvec * eq.bunit)
    nperp = nvec - n3 * eq.bunit
    n1sq = jnp.sum(nperp**2)

    # d(n3)/dk, d(n1^2)/dk  (deriv_cold.f90:49-51)
    inv_k0 = 1.0 / k0
    dn3dk = eq.bunit * inv_k0
    dn12dk = (2.0 * inv_k0) * nperp

    # spatial derivatives (deriv_cold.f90:53-67)
    dn3dx = jnp.sum(eq.gradbunit * nvec[None, :], axis=1)    # (3,)
    dn12dx = -2.0 * n3 * dn3dx
    dadx = alpha[:, None] * eq.gradns \
        * (1.0 / jnp.maximum(eq.ns, tiny))[:, None]          # (S,3)
    dgdx = gamma[:, None] * (
        eq.gradbmag * (1.0 / jnp.maximum(eq.bmag, tiny)))[None, :]

    # omega derivatives (deriv_cold.f90:69-75)
    inv_w = 1.0 / omgrf
    dn3dw = -n3 * inv_w
    dn12dw = (-2.0 * inv_w) * n1sq
    dadw = -2.0 * inv_w * alpha
    dgdw = -inv_w * gamma

    # species products (deriv_cold.f90:77-101)
    p = 1.0 - jnp.sum(alpha)
    t = jnp.prod(1.0 - gamma**2)
    dq1da, dq2da = stix.leave_one_out_products(gamma)
    q1 = jnp.sum(alpha * dq1da)
    q2 = jnp.sum(alpha * dq2da)
    u = t - jnp.sum(alpha * dq1da * dq2da)
    q = 2.0 * u - t + q1 * q2

    duda = -dq1da * dq2da
    dqda = 2.0 * duda + dq1da * q2 + q1 * dq2da

    # dD/d(alpha) (deriv_cold.f90:110-112)
    ddda = (
        -t * n3**4
        + (2.0 * (u - p * duda) + (-t + duda) * n1sq) * n3**2
        - q + p * dqda - (dqda - u + p * duda) * n1sq + duda * n1sq**2
    )

    # dD/d(gamma) via leave-two-out kernels (deriv_cold.f90:114-154)
    gp, gm = stix.leave_two_out_products(gamma)
    gpm = gp * gm
    dtdg = 2.0 * gamma * duda
    dudg = jnp.sum(alpha[:, None] * gpm, axis=0)
    dudg = dtdg + 2.0 * gamma * (dudg + alpha * duda)
    dq1dg = jnp.sum(alpha[:, None] * gp, axis=0) - alpha * dq1da
    dq2dg = -jnp.sum(alpha[:, None] * gm, axis=0) + alpha * dq2da
    dqdg = 2.0 * dudg - dtdg + dq1dg * q2 + q1 * dq2dg
    dddg = (
        dtdg * p * n3**4
        + (-2.0 * p * dudg + (dtdg * p + dudg) * n1sq) * n3**2
        + p * dqdg - (dqdg + p * dudg) * n1sq + dudg * n1sq**2
    )

    # dD/d(n3), dD/d(n1^2) (deriv_cold.f90:157-158)
    dddn3 = (4.0 * t * p * n3**2 + 2.0 * (-2.0 * p * u + (t * p + u) * n1sq)) * n3
    dddn12 = (t * p + u) * n3**2 - (q + p * u) + 2.0 * u * n1sq

    # assemble (deriv_cold.f90:160-171)
    dddk = dddn3 * dn3dk + dddn12 * dn12dk
    dddx = (jnp.sum(ddda[:, None] * dadx, axis=0)
            + jnp.sum(dddg[:, None] * dgdx, axis=0)
            + dddn3 * dn3dx + dddn12 * dn12dx)
    dddw = jnp.sum(ddda * dadw + dddg * dgdw) + dddn3 * dn3dw + dddn12 * dn12dw

    return dddx, dddk, dddw
