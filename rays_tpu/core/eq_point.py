"""The universal equilibrium-point data contract.

``EqPoint`` is the pytree analog of the reference derived type ``eq_point``
(reference RAYS_project/RAYS_lib/equilibrium_m.f90:39-59).  The derivation of
|B|, b-hat, their gradients and the alpha/gamma plasma parameters from the
raw fields follows equilibrium_m.f90:237-269 exactly.

Index conventions (differ from the Fortran in species-major gradients):
  * gradb[i, j]   = d B_j / d x_i        (same as reference gradbtensor)
  * gradns[s, i]  = d n_s / d x_i        (reference stores gradns(i, s))
  * gradts[s, i]  = d T_s / d x_i
Error state is an int32 code (see rays_tpu.tracing.stop) instead of a
string, so it can live inside jitted code.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from rays_tpu import constants
from rays_tpu.tracing.stop import StopCode


class RawEq(NamedTuple):
    """What an equilibrium model must provide at a point."""

    bvec: Any    # (3,)
    gradb: Any   # (3,3)  gradb[i,j] = dB_j/dx_i
    ns: Any      # (S,)
    gradns: Any  # (S,3)
    ts: Any      # (S,)
    gradts: Any  # (S,3)
    err: Any     # int32 StopCode (0 = ok)


class EqPoint(NamedTuple):
    bvec: Any       # (3,)
    bmag: Any       # ()
    bunit: Any      # (3,)
    gradb: Any      # (3,3)
    gradbmag: Any   # (3,)
    gradbunit: Any  # (3,3)
    ns: Any         # (S,)
    gradns: Any     # (S,3)
    ts: Any         # (S,)
    gradts: Any     # (S,3)
    omgc: Any       # (S,)  cyclotron frequency, signed (electron negative)
    omgp2: Any      # (S,)  plasma frequency squared
    alpha: Any      # (S,)  omgp2/omgrf^2
    gamma: Any      # (S,)  omgc/omgrf
    err: Any        # int32


def derive_eq_point(raw: RawEq, species, rf) -> EqPoint:
    """Raw fields -> full EqPoint (reference equilibrium_m.f90:237-269).

    omgc/omgp2/alpha/gamma are formed from the host-precomputed
    nondimensional coefficients (see SpeciesParams), which keep every
    intermediate inside a float32 exponent range (constants.SAFE_TINY).
    """
    bvec = raw.bvec
    bmag = jnp.sqrt(jnp.sum(bvec**2))
    # one reciprocal, multiplied through (this spot issued 12 divides per
    # eval)
    inv_bmag = 1.0 / jnp.maximum(bmag, constants.SAFE_TINY)
    bunit = bvec * inv_bmag
    # gradbmag[i] = sum_j gradb[i,j] * bunit[j], as a broadcast
    # multiply-reduce rather than a vmapped tiny dot_general
    gradbmag = jnp.sum(raw.gradb * bunit[None, :], axis=1)
    # gradbunit[i,j] = (gradb[i,j] - gradbmag[i]*bunit[j]) / bmag
    gradbunit = (raw.gradb - gradbmag[:, None] * bunit[None, :]) * inv_bmag

    wref = rf.omgrf_ref
    omgc = species.gamma_coef * bmag * wref          # qs*B/ms
    omgp2 = species.alpha_coef * raw.ns * wref**2    # ns*qs^2/(eps0*ms)
    wratio = wref / rf.omgrf
    alpha = species.alpha_coef * raw.ns * wratio**2
    gamma = species.gamma_coef * bmag * wratio

    return EqPoint(
        bvec=bvec, bmag=bmag, bunit=bunit, gradb=raw.gradb,
        gradbmag=gradbmag, gradbunit=gradbunit,
        ns=raw.ns, gradns=raw.gradns, ts=raw.ts, gradts=raw.gradts,
        omgc=omgc, omgp2=omgp2, alpha=alpha, gamma=gamma, err=raw.err,
    )


def value_and_jacfwd(f, x):
    """Forward-mode value+jacobian in one pass (3 JVPs for x in R^3).

    Returns (y, jac) with jac[..., i] = d y / d x_i.
    """
    basis = jnp.eye(x.shape[0], dtype=x.dtype)
    pushfwd = lambda v: jax.jvp(f, (x,), (v,))
    y, jac = jax.vmap(pushfwd, out_axes=(None, -1))(basis)
    return y, jac
