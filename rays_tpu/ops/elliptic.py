"""Complete elliptic integrals K(m), E(m) — reference
RAYS_project/math_functions_lib/complete_elliptic_int_m.f90 (used by the
mirror coil fields, mirror_magnetics_lib/B_loop_m.f90).

Computed by the arithmetic-geometric mean: a fixed 12-iteration AGM reaches
machine precision for m in [0, 1) and is branch-free/differentiable —
unlike the reference's series/iteration with convergence tests.
Convention: parameter m = k^2 (matching K(m) = F(pi/2 | m))."""

import jax
import jax.numpy as jnp

_N_AGM = 12


def ellipk_ellipe(m):
    """(K(m), E(m)) for parameter m in [0, 1)."""
    m = jnp.asarray(m)
    one = jnp.ones_like(m)
    a, b = one, jnp.sqrt(jnp.clip(1.0 - m, 1e-30, None))
    c2_sum = 0.5 * m  # c0^2 * 2^{-1} with c0^2 = m, coefficient 2^{n-1}

    # track 2^{n-1} by doubling a carry value: `2.0 ** n` with a traced
    # exponent lowers through exp/log and loses precision
    def body(n, carry):
        a, b, s, pw = carry
        an = 0.5 * (a + b)
        bn = jnp.sqrt(a * b)
        cn = 0.5 * (a - b)
        s = s + pw * cn**2
        return an, bn, s, 2.0 * pw

    a, b, s, _ = jax.lax.fori_loop(
        1, _N_AGM + 1, body, (a, b, c2_sum, jnp.ones_like(m)))
    K = jnp.pi / (2.0 * a)
    E = K * (1.0 - s)
    return K, E


def ellipk(m):
    return ellipk_ellipe(m)[0]


def ellipe(m):
    return ellipk_ellipe(m)[1]
