"""Uniform-grid binning of an extensive quantity along a trajectory.

Re-design of reference RAYS_project/math_functions_lib/
bin_to_uniform_grid_m.f90: for each consecutive trajectory segment
[x_{i-1}, x_i] the increment dQ = Q_i - Q_{i-1} is distributed over the
bins the segment spans, proportionally to overlap in index space
(bin_to_uniform_grid_m.f90:80-148).

Instead of the reference's per-segment scalar loop with four special
cases, each segment's contribution to ALL bins is computed as a clipped
interval-overlap vector — one dense (segments x bins) elementwise kernel
(branch-free, differentiable, vmappable over rays).  Out-of-range
portions fall out of the clipped overlap exactly like the reference's
fraction_in scaling; segments with zero extent put their whole dQ into the
single containing bin.
"""

from __future__ import annotations

import jax.numpy as jnp


def bin_to_uniform_grid(Q, xQ, xmin, xmax, n_bins: int):
    """Returns binned_Q (n_bins,).

    Q, xQ: (n,) cumulative quantity and its coordinate along the
    trajectory; optionally mask invalid tail segments by making Q constant
    there (dQ = 0 contributes nothing).
    """
    dx_bin = (xmax - xmin) / n_bins
    ix = (xQ - xmin) / dx_bin                       # index-space coords
    ix_lo = jnp.minimum(ix[:-1], ix[1:])            # (n-1,)
    ix_hi = jnp.maximum(ix[:-1], ix[1:])
    dQ = Q[1:] - Q[:-1]
    d_ix = ix_hi - ix_lo

    edges = jnp.arange(n_bins + 1, dtype=Q.dtype)   # bin b covers [b, b+1)
    lo = jnp.maximum(ix_lo[:, None], edges[None, :-1])
    hi = jnp.minimum(ix_hi[:, None], edges[None, 1:])
    overlap = jnp.clip(hi - lo, 0.0, None)          # (n-1, n_bins)

    wide = d_ix > 1e-12
    safe_dix = jnp.where(wide, d_ix, 1.0)
    frac_wide = overlap / safe_dix[:, None]

    # zero-extent segment: all dQ into the containing bin (if in range)
    ibin = jnp.clip(jnp.floor(ix_lo).astype(jnp.int32), 0, n_bins - 1)
    in_range = (ix_lo >= 0.0) & (ix_lo <= n_bins)
    one_hot = (jnp.arange(n_bins)[None, :] == ibin[:, None]) & in_range[:, None]

    frac = jnp.where(wide[:, None], frac_wide, one_hot.astype(Q.dtype))
    return jnp.sum(dQ[:, None] * frac, axis=0)
