"""Plasma dispersion (Fried-Conte Z) function, as device code.

The reference evaluates Z via the classic continued-fraction/asymptotic
routine `wzdisp` and accelerates the real-axis case with cubic splines on a
2001-point grid over [-10, 10] (reference RAYS_project/math_functions_lib/
zfunctions_m.f90:19-34,45-51; tabulated accuracy ~7e-11, see
"Splined Z function results.txt").

Here Z on the real axis is computed from the Dawson function,

    Z(x) = -2*dawsn(x) + i*sqrt(pi)*exp(-x^2),

with ``dawsn`` evaluated by Rybicki's exponentially convergent sampling
formula

    dawsn(x) ~= (1/sqrt(pi)) * sum_{n odd} exp(-(x - n h)^2) / n,

whose error is O(exp(-(pi/(2h))^2)): with h = 0.25 that is ~7e-18, far
below the reference's spline accuracy.  The sum is a fixed-size, branch-free
vector reduction — trivially vmappable and exactly
differentiable (no data-dependent control flow, unlike the reference's
region-switching rational approximations).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

_H = 0.25
# cover |x| <= ~14 with exp(-(x-nh)^2) support ~6.5: n*h up to ~21
_N_ODD = jnp.arange(1, 169, 2)  # 84 positive odd integers, n*h up to 41.75


def dawsn(x):
    """Dawson integral F(x) = exp(-x^2) * int_0^x exp(t^2) dt, real x."""
    x = jnp.asarray(x)
    n = _N_ODD.astype(x.dtype)
    nh = n * _H
    # odd symmetry folded in: sum over +-n of e^{-(x-nh)^2}/n
    terms = (jnp.exp(-(x[..., None] - nh) ** 2)
             - jnp.exp(-(x[..., None] + nh) ** 2)) / n
    return jnp.sum(terms, axis=-1) / math.sqrt(math.pi)


def zfun_real_parts(x):
    """(Re, Im) of Z(x) for real x: (-2*dawsn(x), sqrt(pi)*exp(-x^2)).

    The device API keeps to real arithmetic and returns the real pair;
    compose with 1j on host if a complex value is wanted.
    """
    x = jnp.asarray(x)
    return -2.0 * dawsn(x), math.sqrt(math.pi) * jnp.exp(-(x**2))


def zfun0_real_parts(x, kz):
    """(Re, Im) of Z with the Landau-sign convention of the reference
    ``zfun0``: Z(x) for kz > 0, -Z(-x) for kz < 0
    (zfunctions_m.f90:57-75).  Branch-free: -Z(-x) = -2*dawsn(x)
    - i*sqrt(pi)*e^{-x^2}."""
    x = jnp.asarray(x)
    re = -2.0 * dawsn(x)
    im = math.sqrt(math.pi) * jnp.exp(-(x**2)) * jnp.sign(kz)
    return re, im


def zfun_real(x):
    """Complex Z(x) for real x — host-side convenience."""
    re, im = zfun_real_parts(x)
    return re + 1j * im


def zfun_prime_real(x):
    """Z'(x) = -2*(1 + x*Z(x)) — handy closed form for tests (host-side)."""
    return -2.0 * (1.0 + x * zfun_real(x))


# ---------------------------------------------------------------------------
# Complex-argument Faddeeva function w(z) and full complex Z(zeta).
#
# The reference evaluates complex Z via the region-switching continued-
# fraction/asymptotic routine pair zzdisp/wzdisp (reference
# RAYS_project/math_functions_lib/zfunctions_m.f90:109-260): w is computed
# in the first quadrant and extended by the symmetries
#   w(conj(z)) = conj(w(-z)),   w(-z) = 2 exp(-z^2) - w(z).
#
# Design: complex dtypes are avoided (devices that emulate f64 have no
# complex128), so everything is explicit real-pair arithmetic.  Whether the
# GPU keeps this is ROADMAP debt 3.4.
# Instead of region switching (data-dependent branches), the upper half-
# plane uses ONE uniformly valid rational approximation — Weideman's method
# (SIAM J. Numer. Anal. 31 (1994) 1497): with the Mobius map
# Z = (L + i z)/(L - i z), w(z) ~= 2 p(Z)/(L - i z)^2 + (1/sqrt(pi))/(L-iz),
# where p is a degree-(N-1) polynomial whose coefficients come from one
# host-side FFT at import.  N = 64 gives max abs error ~1e-14 over the
# closed upper half-plane — comparable to the reference's double-precision
# wzdisp and far below its splined real-axis table (~7e-11).  The evaluation
# is a fixed 64-step fused-multiply-add chain: branch-free, vmappable, and
# differentiable (w'(z) = -2 z w(z) + 2i/sqrt(pi) holds to the same accuracy
# through AD of the rational form).
# ---------------------------------------------------------------------------

_WEIDEMAN_N = 64


def _weideman_coeffs(n: int) -> tuple[np.ndarray, float]:
    """Host-side polynomial coefficients a_0..a_{n-1} (highest degree first)
    and the map scale L for Weideman's w(z) approximation."""
    m = 2 * n
    L = math.sqrt(n / math.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    a = a[1:n + 1][::-1]  # highest degree first, for Horner
    return a, L


_W_COEF, _W_L = _weideman_coeffs(_WEIDEMAN_N)
_SQRT_PI = math.sqrt(math.pi)


def _wofz_upper(x, y):
    """(Re, Im) of w(x + iy) for y >= 0 (Weideman rational approximation)."""
    L = x.dtype.type(_W_L) if hasattr(x, "dtype") else _W_L
    # d = L - i z = (L + y) - i x ;  Z = (L + i z)/d
    dr, di = L + y, -x
    d2 = dr * dr + di * di
    zr = (L * L - x * x - y * y) / d2
    zi = (2.0 * L * x) / d2
    # Horner in complex (zr, zi) with real coefficients
    pr = jnp.full_like(x, _W_COEF[0])
    pi_ = jnp.zeros_like(x)
    for c in _W_COEF[1:]:
        pr, pi_ = pr * zr - pi_ * zi + c, pr * zi + pi_ * zr
    # w = 2 p / d^2 + (1/sqrt(pi)) / d
    d2r, d2i = dr * dr - di * di, 2.0 * dr * di
    d2n = d2r * d2r + d2i * d2i
    wr = 2.0 * (pr * d2r + pi_ * d2i) / d2n + (dr / d2) / _SQRT_PI
    wi = 2.0 * (pi_ * d2r - pr * d2i) / d2n + (-di / d2) / _SQRT_PI
    return wr, wi


def wofz_parts(x, y):
    """(Re, Im) of the Faddeeva function w(z), z = x + iy, full plane.

    Lower half-plane by w(z) = 2 exp(-z^2) - w(-z) (the reference's
    reflection scheme, zfunctions_m.f90:117-130).  Like every w(z)
    implementation this grows as exp(y^2 - x^2) for y < 0 (Landau growth);
    overflow there is physical, not a code defect.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y, dtype=x.dtype)
    upper = y >= 0.0
    xs = jnp.where(upper, x, -x)
    ys = jnp.abs(y)
    wr, wi = _wofz_upper(xs, ys)
    # 2 exp(-z^2): -z^2 = (y^2 - x^2) - 2ixy
    er = 2.0 * jnp.exp(y * y - x * x) * jnp.cos(2.0 * x * y)
    ei = -2.0 * jnp.exp(y * y - x * x) * jnp.sin(2.0 * x * y)
    return jnp.where(upper, wr, er - wr), jnp.where(upper, wi, ei - wi)


def zfun_parts(x, y):
    """(Re, Im) of the plasma dispersion function Z(zeta) = i sqrt(pi)
    w(zeta), zeta = x + iy (reference zzdisp, zfunctions_m.f90:109-130)."""
    wr, wi = wofz_parts(x, y)
    return -_SQRT_PI * wi, _SQRT_PI * wr


def zfun0_parts(x, y, kz):
    """Complex-argument Z with the Landau-sign convention of the reference
    ``zfun0`` (zfunctions_m.f90:57-75): Z(zeta) for kz > 0, -Z(-zeta) for
    kz < 0.  kz = 0 is the reference's fatal error; here it selects the
    kz > 0 branch (callers mask)."""
    neg = jnp.asarray(kz) < 0.0
    zr, zi = zfun_parts(jnp.where(neg, -x, x), jnp.where(neg, -y, y))
    sgn = jnp.where(neg, -1.0, 1.0)
    return sgn * zr, sgn * zi


def wofz(z):
    """Complex w(z) — host-side convenience."""
    z = jnp.asarray(z)
    re, im = wofz_parts(jnp.real(z), jnp.imag(z))
    return re + 1j * im


def zfun(z):
    """Complex Z(z) — host-side convenience (reference zfun_D)."""
    z = jnp.asarray(z)
    re, im = zfun_parts(jnp.real(z), jnp.imag(z))
    return re + 1j * im
