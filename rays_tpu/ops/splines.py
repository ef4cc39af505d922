"""Differentiable uniform-grid cubic splines (1-D and 2-D tensor product).

Replacement for the reference's pspline extraction
(reference RAYS_project/splines_lib/quick_cube_splines_m.f90): uniform
grid, not-a-knot boundary conditions (the reference's fixed choice,
quick_cube_splines_m.f90:88-93), C2 continuity.

Design: the second-derivative (M) arrays are precomputed at build time by a
dense linear solve M = T @ f (T = A^{-1} B for the not-a-knot tridiagonal
system) — an O(n^2) one-time cost that makes evaluation a pure
4-point-gather + cubic polynomial, branch-free and trivially vmappable.
Because M is LINEAR in the knot values, gradients w.r.t. the knot values
(spline-parameter adjoints, e.g. fitting ne(psi) profiles) flow exactly
through both build and eval.  2-D evaluation composes the same 1-D formula
along each axis from four precomputed grids (F, Mx, My, Mxy) — 16 gathers
per point.

Evaluation derivatives come from the closed-form polynomial (and from AD,
which agrees exactly since the whole thing is polynomial in x).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np


class Spline1D(NamedTuple):
    x0: Any   # grid origin
    dx: Any   # grid spacing
    f: Any    # (n,) knot values
    m: Any    # (n,) second derivatives at knots


class Spline2D(NamedTuple):
    x0: Any
    dx: Any
    y0: Any
    dy: Any
    f: Any     # (nx, ny)
    mx: Any    # d2/dx2
    my: Any    # d2/dy2
    mxy: Any   # d4/dx2dy2


def _second_deriv_matrix(n: int, h: float) -> np.ndarray:
    """T with M = T @ f for the uniform-grid not-a-knot cubic spline.

    Interior: M[i-1] + 4 M[i] + M[i+1] = 6 (f[i-1] - 2 f[i] + f[i+1]) / h^2.
    Not-a-knot (third derivative continuous at x1, x_{n-2}):
    M0 - 2 M1 + M2 = 0 and M_{n-3} - 2 M_{n-2} + M_{n-1} = 0.
    """
    if n < 4:
        raise ValueError("cubic spline needs at least 4 points")
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    for i in range(1, n - 1):
        A[i, i - 1] = 1.0
        A[i, i] = 4.0
        A[i, i + 1] = 1.0
        B[i, i - 1] = 6.0 / h**2
        B[i, i] = -12.0 / h**2
        B[i, i + 1] = 6.0 / h**2
    A[0, 0], A[0, 1], A[0, 2] = 1.0, -2.0, 1.0
    A[n - 1, n - 3], A[n - 1, n - 2], A[n - 1, n - 1] = 1.0, -2.0, 1.0
    return np.linalg.solve(A, B)


def build_spline_1d(x0, dx, f) -> Spline1D:
    """Build from knot values.  T is computed in numpy (host, exact f64) but
    applied to ``f`` with jnp so knot-value gradients flow."""
    n = int(np.shape(f)[-1])
    T = jnp.asarray(_second_deriv_matrix(n, float(dx)))
    f = jnp.asarray(f)
    return Spline1D(x0=jnp.asarray(x0), dx=jnp.asarray(dx), f=f, m=f @ T.T)


def _local(fi, fi1, mi, mi1, u, h):
    """1-D cubic segment value from endpoint values/second derivs."""
    w = 1.0 - u
    return (fi * w + fi1 * u
            + (h * h / 6.0) * ((w**3 - w) * mi + (u**3 - u) * mi1))


def _local_du(fi, fi1, mi, mi1, u, h):
    w = 1.0 - u
    return (fi1 - fi
            + (h * h / 6.0) * ((-3.0 * w**2 + 1.0) * mi + (3.0 * u**2 - 1.0) * mi1))


def _cell(sp_x0, sp_dx, n, x):
    t = (x - sp_x0) / sp_dx
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
    return i, t - i.astype(t.dtype)


def _seg_1d(sp: Spline1D, x):
    """(fi, fi1, mi, mi1, u): the segment endpoint data for x, fetched as
    ONE contiguous row of a (n-1, 4) segment table with jnp.take.  Four
    separate scalar indexings (f[i], f[i+1], m[i], m[i+1]) would batch
    under vmap into four gathers; the table stack is loop-invariant in the
    knots so XLA hoists it out of trace scans."""
    n = sp.f.shape[-1]
    i, u = _cell(sp.x0, sp.dx, n, x)
    tab = jnp.stack([sp.f[..., :-1], sp.f[..., 1:],
                     sp.m[..., :-1], sp.m[..., 1:]], axis=-1)   # (n-1, 4)
    row = jnp.take(tab, i, axis=0)
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3], u


def eval_1d(sp: Spline1D, x):
    """Spline value at x (clamped-cell extrapolation outside the grid,
    matching pspline's behavior of evaluating the edge polynomial)."""
    fi, fi1, mi, mi1, u = _seg_1d(sp, x)
    return _local(fi, fi1, mi, mi1, u, sp.dx)


def eval_1d_fp(sp: Spline1D, x):
    """(f, df/dx)."""
    fi, fi1, mi, mi1, u = _seg_1d(sp, x)
    f = _local(fi, fi1, mi, mi1, u, sp.dx)
    fp = _local_du(fi, fi1, mi, mi1, u, sp.dx) / sp.dx
    return f, fp


def build_spline_2d(x0, dx, y0, dy, f) -> Spline2D:
    """f: (nx, ny) knot values; spline-of-splines tensor product."""
    f = jnp.asarray(f)
    nx, ny = int(f.shape[0]), int(f.shape[1])
    Tx = jnp.asarray(_second_deriv_matrix(nx, float(dx)))
    Ty = jnp.asarray(_second_deriv_matrix(ny, float(dy)))
    mx = Tx @ f          # d2f/dx2 at knots
    my = f @ Ty.T        # d2f/dy2 at knots
    mxy = Tx @ my        # d4f/dx2dy2
    return Spline2D(x0=jnp.asarray(x0), dx=jnp.asarray(dx),
                    y0=jnp.asarray(y0), dy=jnp.asarray(dy),
                    f=f, mx=mx, my=my, mxy=mxy)


def _gather4(a, i, j):
    """The four corners of cell (i, j) as fast single-axis takes on the
    flat view (vmapped a[i, j] batches into the slow 2-component-index
    gather form — see _cell_gather)."""
    ny = a.shape[-1]
    flat = a.reshape(-1)
    lin = i * ny + j
    return (jnp.take(flat, lin), jnp.take(flat, lin + 1),
            jnp.take(flat, lin + ny), jnp.take(flat, lin + ny + 1))


def eval_2d(sp: Spline2D, x, y):
    """Bicubic spline value at (x, y): apply the 1-D formula in y to
    (F, My) and (Mx, Mxy), then in x to the results."""
    nx, ny = sp.f.shape
    i, u = _cell(sp.x0, sp.dx, nx, x)
    j, v = _cell(sp.y0, sp.dy, ny, y)

    f00, f01, f10, f11 = _gather4(sp.f, i, j)
    my00, my01, my10, my11 = _gather4(sp.my, i, j)
    mx00, mx01, mx10, mx11 = _gather4(sp.mx, i, j)
    mxy00, mxy01, mxy10, mxy11 = _gather4(sp.mxy, i, j)

    g0 = _local(f00, f01, my00, my01, v, sp.dy)     # f(x_i, y)
    g1 = _local(f10, f11, my10, my11, v, sp.dy)     # f(x_{i+1}, y)
    h0 = _local(mx00, mx01, mxy00, mxy01, v, sp.dy) # fxx(x_i, y)
    h1 = _local(mx10, mx11, mxy10, mxy11, v, sp.dy)
    return _local(g0, g1, h0, h1, u, sp.dx)


class CellSpline2D(NamedTuple):
    """Per-cell bicubic coefficient form of K stacked Spline2Ds on one grid.

    Rationale: `eval_2d` costs 16 scalar gathers per point per field, the
    dominant cost of spline-geometry tracing.  Folding
    (F, Mx, My, Mxy) into per-cell polynomial coefficients and stacking all
    K fields makes evaluation ONE gather of a contiguous (K, 4, 4) block
    per point, with values AND first derivatives coming from the same
    fetched coefficients.  Coefficients are linear in the knot values
    (built with jnp), so knot-value adjoints flow exactly.
    """

    x0: Any
    dx: Any
    y0: Any
    dy: Any
    cells: Any   # (nxm, nym, K, 4, 4): axes (y-power q, x-power p)


def _seg_coef(fi, fi1, mi, mi1, h):
    """Cubic-segment monomial coefficients [a0..a3] in the local coordinate
    u in [0,1], stacked on a NEW last axis, from endpoint values/2nd derivs:
    f(u) = fi(1-u) + fi1 u + h^2/6 [((1-u)^3-(1-u)) mi + (u^3-u) mi1]."""
    c = h * h / 6.0
    return jnp.stack([
        fi,
        (fi1 - fi) + c * (-2.0 * mi - mi1),
        3.0 * c * mi,
        c * (mi1 - mi),
    ], axis=-1)


def build_cell_spline_2d(sps, x_splines=()) -> CellSpline2D:
    """Fuse Spline2Ds (same grid) into one per-cell coefficient table.

    ``x_splines``: Spline1Ds on the SAME x grid, appended as extra K
    channels whose cells carry the 1-D u-segment cubic in the q=0 row
    (constant in y).  Rationale: a gather's cost is set by the number of
    points more than by the row width, so folding a co-gridded 1-D spline
    into the one cell fetch saves the EQDSK toroid's separate RBphi(R)
    gather.  (Chosen before the GPU port; ROADMAP 1.5 re-measures it.)
    """
    sps = list(sps)
    sp0 = sps[0]
    cells = []
    for sp in sps:
        F, Mx, My, Mxy = sp.f, sp.mx, sp.my, sp.mxy
        # along y first: value/fxx segment coefficients, (nx, nym, 4q)
        gy = _seg_coef(F[:, :-1], F[:, 1:], My[:, :-1], My[:, 1:], sp.dy)
        hy = _seg_coef(Mx[:, :-1], Mx[:, 1:], Mxy[:, :-1], Mxy[:, 1:], sp.dy)
        # then along x: (nxm, nym, 4q, 4p)
        cells.append(_seg_coef(gy[:-1], gy[1:], hy[:-1], hy[1:], sp.dx))
    nym = cells[0].shape[1]
    for sp in x_splines:
        cu = _seg_coef(sp.f[..., :-1], sp.f[..., 1:],
                       sp.m[..., :-1], sp.m[..., 1:], sp.dx)   # (nxm, 4p)
        block = jnp.zeros(cells[0].shape, cu.dtype)
        block = block.at[:, :, 0, :].set(cu[:, None, :])
        cells.append(block)
    return CellSpline2D(x0=sp0.x0, dx=sp0.dx, y0=sp0.y0, dy=sp0.dy,
                        cells=jnp.stack(cells, axis=2))


def _cell_gather(cs: CellSpline2D, x, y):
    """Locate the cell and fetch its (K, 4, 4) coefficient block with ONE
    flat row gather.  Instead of the two-index form ``cells[i, j]``, the
    cell table is viewed as (nxm*nym, K*16) — a free bitcast, hoisted out
    of the trace loop — and indexed linearly."""
    nxm, nym, K = cs.cells.shape[0], cs.cells.shape[1], cs.cells.shape[2]
    tx = (x - cs.x0) / cs.dx
    ty = (y - cs.y0) / cs.dy
    i = jnp.clip(jnp.floor(tx).astype(jnp.int32), 0, nxm - 1)
    j = jnp.clip(jnp.floor(ty).astype(jnp.int32), 0, nym - 1)
    u = tx - i.astype(tx.dtype)
    v = ty - j.astype(ty.dtype)
    flat = cs.cells.reshape(nxm * nym, K * 16)
    # jnp.take, NOT flat[lin]: under vmap, scalar [] indexing batches into
    # a gather with start_index_map={0,1} (a 2-component start index);
    # take's batching rule emits the single-axis row gather
    # (start_index_map={0}).
    c = jnp.take(flat, i * nym + j, axis=0).reshape(K, 4, 4)   # (K, 4q, 4p)
    return c, u, v


def _poly_weights(u, v):
    """Monomial and derivative weight vectors for one point: each (4,)."""
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    up = jnp.stack([one, u, u * u, u * u * u], axis=-1)
    vq = jnp.stack([one, v, v * v, v * v * v], axis=-1)
    dup = jnp.stack([zero, one, 2.0 * u, 3.0 * u * u], axis=-1)
    dvq = jnp.stack([zero, one, 2.0 * v, 3.0 * v * v], axis=-1)
    return up, vq, dup, dvq


def _contract(c, a, b):
    """sum_{q,p} c[k, q, p] a[p] b[q] as broadcast multiply-reduce (an
    einsum here lowers to a tiny batched dot_general under vmap)."""
    return (c * a[None, None, :] * b[None, :, None]).sum((-1, -2))


def eval_cell_2d(cs: CellSpline2D, x, y):
    """(f, fx, fy), each (K,), at one point — a single coefficient gather.
    Clamped-cell extrapolation outside the grid like eval_2d."""
    c, u, v = _cell_gather(cs, x, y)
    up, vq, dup, dvq = _poly_weights(u, v)
    f = _contract(c, up, vq)
    fx = _contract(c, dup, vq) / cs.dx
    fy = _contract(c, up, dvq) / cs.dy
    return f, fx, fy


def eval_cell_2d_second(cs: CellSpline2D, x, y):
    """(f, fx, fy, fxx, fxy, fyy), each (K,), from the same single gather —
    for consumers that assemble field jacobians analytically (e.g. the
    EQDSK toroid's gradB needs psi second derivatives)."""
    c, u, v = _cell_gather(cs, x, y)
    up, vq, dup, dvq = _poly_weights(u, v)
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    d2up = jnp.stack([zero, zero, 2.0 * one, 6.0 * u], axis=-1)
    d2vq = jnp.stack([zero, zero, 2.0 * one, 6.0 * v], axis=-1)

    f = _contract(c, up, vq)
    fx = _contract(c, dup, vq) / cs.dx
    fy = _contract(c, up, dvq) / cs.dy
    fxx = _contract(c, d2up, vq) / (cs.dx * cs.dx)
    fxy = _contract(c, dup, dvq) / (cs.dx * cs.dy)
    fyy = _contract(c, up, d2vq) / (cs.dy * cs.dy)
    return f, fx, fy, fxx, fxy, fyy


def eval_2d_fp(sp: Spline2D, x, y):
    """(f, df/dx, df/dy)."""
    nx, ny = sp.f.shape
    i, u = _cell(sp.x0, sp.dx, nx, x)
    j, v = _cell(sp.y0, sp.dy, ny, y)

    f00, f01, f10, f11 = _gather4(sp.f, i, j)
    my00, my01, my10, my11 = _gather4(sp.my, i, j)
    mx00, mx01, mx10, mx11 = _gather4(sp.mx, i, j)
    mxy00, mxy01, mxy10, mxy11 = _gather4(sp.mxy, i, j)

    g0 = _local(f00, f01, my00, my01, v, sp.dy)
    g1 = _local(f10, f11, my10, my11, v, sp.dy)
    h0 = _local(mx00, mx01, mxy00, mxy01, v, sp.dy)
    h1 = _local(mx10, mx11, mxy10, mxy11, v, sp.dy)
    f = _local(g0, g1, h0, h1, u, sp.dx)
    fx = _local_du(g0, g1, h0, h1, u, sp.dx) / sp.dx

    g0v = _local_du(f00, f01, my00, my01, v, sp.dy) / sp.dy
    g1v = _local_du(f10, f11, my10, my11, v, sp.dy) / sp.dy
    h0v = _local_du(mx00, mx01, mxy00, mxy01, v, sp.dy) / sp.dy
    h1v = _local_du(mx10, mx11, mxy10, mxy11, v, sp.dy) / sp.dy
    fy = _local(g0v, g1v, h0v, h1v, u, sp.dx)
    return f, fx, fy
