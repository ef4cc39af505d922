"""Numeric-library accuracy tests: splines, binner, elliptic, bisect,
quadrature, inversion."""

import jax
import jax.numpy as jnp
import numpy as np

import rays_tpu  # noqa: F401
from rays_tpu.ops import binning, bisect, elliptic, invert, quadrature, splines


def test_spline_1d_accuracy_and_derivative():
    """Cubic-spline accuracy on a smooth function: O(h^4).  The reference's
    own accuracy anchor is ~7e-11 average abs error for Z(x) on a 2001-point
    grid (math_functions_lib/'Splined Z function results.txt')."""
    n = 201
    x = np.linspace(0.0, 2 * np.pi, n)
    f = np.sin(x)
    sp = splines.build_spline_1d(x[0], x[1] - x[0], f)

    xq = jnp.asarray(np.linspace(0.3, 2 * np.pi - 0.3, 501))
    fq, fpq = jax.jit(jax.vmap(lambda t: splines.eval_1d_fp(sp, t)))(xq)
    np.testing.assert_allclose(np.asarray(fq), np.sin(np.asarray(xq)), atol=2e-8)
    np.testing.assert_allclose(np.asarray(fpq), np.cos(np.asarray(xq)), atol=2e-6)

    # knot-value gradients flow (profile-fitting adjoints)
    g = jax.jit(jax.grad(
        lambda knots: splines.eval_1d(
            splines.build_spline_1d(x[0], x[1] - x[0], knots), 1.234)
    ))(jnp.asarray(f))
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).sum() > 0.9


def test_spline_2d_accuracy():
    nx, ny = 81, 91
    xs = np.linspace(0, 1, nx)
    ys = np.linspace(-1, 1, ny)
    F = np.sin(2 * xs)[:, None] * np.cos(1.5 * ys)[None, :]
    sp = splines.build_spline_2d(xs[0], xs[1] - xs[0], ys[0], ys[1] - ys[0], F)

    rng = np.random.default_rng(1)
    xq = rng.uniform(0.1, 0.9, 200)
    yq = rng.uniform(-0.9, 0.9, 200)
    out = jax.jit(jax.vmap(lambda a, b: splines.eval_2d_fp(sp, a, b)))(
        jnp.asarray(xq), jnp.asarray(yq))
    f, fx, fy = (np.asarray(o) for o in out)
    np.testing.assert_allclose(f, np.sin(2 * xq) * np.cos(1.5 * yq), atol=1e-6)
    np.testing.assert_allclose(fx, 2 * np.cos(2 * xq) * np.cos(1.5 * yq), atol=1e-4)
    np.testing.assert_allclose(fy, -1.5 * np.sin(2 * xq) * np.sin(1.5 * yq), atol=1e-4)

    # AD through eval_2d equals the closed-form first derivatives
    gx = jax.jit(jax.grad(lambda a, b: splines.eval_2d(sp, a, b), argnums=(0, 1)))
    dfx, dfy = gx(jnp.float64(0.4), jnp.float64(0.2))
    f0, fx0, fy0 = splines.eval_2d_fp(sp, jnp.float64(0.4), jnp.float64(0.2))
    np.testing.assert_allclose(float(dfx), float(fx0), rtol=1e-11)
    np.testing.assert_allclose(float(dfy), float(fy0), rtol=1e-11)


def test_binner_conserves_and_splits():
    """Total binned Q equals the net deposited increment; a segment
    spanning several bins splits in proportion to overlap
    (bin_to_uniform_grid_m.f90 semantics)."""
    xq = jnp.asarray([0.05, 0.15, 0.45, 0.85])
    Q = jnp.asarray([0.0, 1.0, 3.0, 3.5])
    binned = jax.jit(lambda: binning.bin_to_uniform_grid(Q, xq, 0.0, 1.0, 10))()
    b = np.asarray(binned)
    np.testing.assert_allclose(b.sum(), 3.5, rtol=1e-12)
    # first segment [0.05, 0.15] splits half/half between bins 0 and 1
    np.testing.assert_allclose(b[0], 0.5, rtol=1e-12)
    # segment 2 deposits dQ=2 uniformly over [0.15, 0.45]: bin1 gets
    # (0.2-0.15)/0.3*2, bins 2,3 get 0.1/0.3*2 each, bin4 gets 0.05/0.3*2
    np.testing.assert_allclose(b[2], 2 * 0.1 / 0.3, rtol=1e-12)


def test_elliptic_golden():
    """AGM is 1-ulp exact in true f64 (verified on host numpy); an
    emulated-f64 sqrt would limit E to ~4e-8 relative — ample for coil
    fields."""
    K, E = jax.jit(elliptic.ellipk_ellipe)(jnp.float64(0.5))
    np.testing.assert_allclose(float(K), 1.8540746773013719, rtol=1e-9)
    np.testing.assert_allclose(float(E), 1.3506438810476755, rtol=1e-6)
    K0, E0 = jax.jit(elliptic.ellipk_ellipe)(jnp.float64(0.0))
    np.testing.assert_allclose(float(K0), np.pi / 2, rtol=1e-10)
    np.testing.assert_allclose(float(E0), np.pi / 2, rtol=1e-10)


def test_bisect_and_invert_and_quadrature():
    f = lambda x: x**3 - 2.0
    root, ok = jax.jit(lambda: bisect.solve_bisection(f, 0.0, 0.0, 2.0))()
    assert bool(ok)
    np.testing.assert_allclose(float(root), 2.0 ** (1 / 3), rtol=1e-12)

    x = jnp.linspace(0, 1, 101)
    y = x**2  # monotonic
    y_out, x_of_y = invert.invert_monotonic(x, y)
    np.testing.assert_allclose(np.asarray(x_of_y),
                               np.sqrt(np.asarray(y_out)), atol=2e-4)

    ct = quadrature.cumulative_trapezoid(3 * x**2, x)
    np.testing.assert_allclose(float(ct[-1]), 1.0, atol=1e-4)
