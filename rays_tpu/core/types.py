"""Core pytree types and the static run configuration.

Design split: everything numeric that may change between runs
without recompiling lives in ``Params`` (a pytree of arrays, traced);
everything that selects code paths (model names, flags, vector layout) lives
in ``Config`` (a frozen, hashable dataclass closed over at trace time).
This replaces the reference's runtime string dispatch
(reference RAYS_project/RAYS_lib/equilibrium_m.f90:177-195 et al.) with
dispatch-once-at-trace-time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax.numpy as jnp


class SpeciesParams(NamedTuple):
    """Plasma species table (reference RAYS_lib/species_m.f90).

    Index 0 is electrons, 1..nspec are ions; arrays have length nspec+1.

    DENSITIES ARE NORMALIZED on device: ``n0s`` holds the species densities
    relative to the reference electron density ``n_ref`` (i.e. the eta
    concentrations), and every equilibrium model's ns output is in the same
    units.  The physical scale lives only in the host-precomputed

        alpha_coef_s = n_ref * qs^2 / (eps0 * ms * omgrf_ref^2)

    so that on device

        alpha_s = alpha_coef_s * ns_norm_s * (omgrf_ref/omega)^2
        gamma_s = gamma_coef_s * |B| * (omgrf_ref/omega)

    with every quantity O(1)..O(1e27), inside a float32 exponent range
    (~1e+-38): the raw SI forms would underflow it forward (eps0*m_e ~
    8e-42) and physical densities overflow it in REVERSE mode (the
    transpose of gradns/ns squares ns ~ 1e20).  Multiply by ``n_ref`` only
    at output boundaries (post-processing profiles).
    """

    qs: Any          # (S,) charge [C]
    ms: Any          # (S,) mass [kg]
    eta: Any         # (S,) concentration as fraction of electron density
    n0s: Any         # (S,) NORMALIZED reference densities (= eta)
    n_ref: Any       # () physical reference electron density [m^-3]
    t0s: Any         # (S,) temperature [J]
    alpha_coef: Any  # (S,) n_ref*qs^2/(eps0*ms*omgrf_ref^2)
    gamma_coef: Any  # (S,) qs/(ms*omgrf_ref)


class RFParams(NamedTuple):
    """Wave parameters (reference RAYS_lib/rf_m.f90:17-20)."""

    omgrf: Any      # 2*pi*frf (traced; differentiate w.r.t. this for dD/domega)
    k0: Any         # omgrf/clight
    omgrf_ref: Any  # reference omega used in the species coefficients


class OdeParams(NamedTuple):
    """Integrator parameters (reference RAYS_lib/ode_m.f90:98-104,
    SG_ode_m namelist)."""

    ds: Any        # outer step in ray parameter (arclength or time)
    s_max: Any     # maximum ray parameter
    rel_err: Any   # adaptive stepper relative tolerance (SG rel_err0)
    abs_err: Any   # adaptive stepper absolute tolerance (SG abs_err0)


class Limits(NamedTuple):
    """Run-validity limits enforced each step (reference check_save.f90)."""

    dispersion_resid_limit: Any   # rf_m.f90:48
    total_damping_limit: Any      # damping_m.f90:38
    sg_error_limit: Any           # SG_ode_m error-growth abort


class Params(NamedTuple):
    """The full traced parameter bundle for a run.

    ``eq`` is a model-specific NamedTuple (slab.SlabParams,
    solovev.SolovevParams, ...) selected by ``Config.equilib_model``.
    Differentiating a run w.r.t. ``params`` gives adjoints w.r.t. every
    physics parameter at once.
    """

    species: SpeciesParams
    rf: RFParams
    eq: Any
    ode: OdeParams
    limits: Limits


@dataclasses.dataclass(frozen=True)
class Config:
    """Static configuration: selects compiled code paths.

    Mirrors the union of the reference's namelist switches that change
    control flow (catalog: reference RAYS_lib/namelist_description.md).
    """

    # identity
    run_label: str = "run"
    run_description: str = ""

    # species (names fix charge/mass lookup; count fixes array sizes)
    nspec: int = 1  # number of ION species; arrays sized nspec+1

    # rf (rf_m.f90 namelist)
    ray_dispersion_model: str = "cold"
    wave_mode: str = "plus"        # plus | minus | fast | slow
    k0_sign: int = 1
    ray_param: str = "arcl"        # arcl | time

    # equilibrium
    equilib_model: str = "slab"    # slab | solovev | axisym_toroid | multiple_mirror
    eq_static: Any = None          # model-specific frozen dataclass

    # damping
    damping_model: str = "no_damp"  # no_damp | damp_fund_ECH
    multi_spec_damping: bool = False

    # diagnostics
    integrate_eq_gradients: bool = False
    verbosity: int = 0

    # integrator
    ode_solver_name: str = "RK4_ODE"  # RK4_ODE | SG_ODE (-> adaptive RK45)
    # 'cold' = closed-form chain rule of pole-free D (default);
    # 'autodiff' = jax.grad of the scalar D (independent-path A/B, the
    # analog of the reference's ray_deriv_name='numerical' FD check)
    ray_deriv_name: str = "cold"
    nstep_max: int = 500
    max_substeps: int = 512        # adaptive stepper: bound on internal steps per ds
    # > 0 replaces the adaptive substep while_loop with a fixed-length
    # masked scan of this many iterations — reverse-differentiable (the
    # while_loop is not), at the cost of always paying that many substeps;
    # set for adjoint runs through the SG_ODE path
    sg_scan_substeps: int = 0
    # rematerialize scan-step internals in reverse mode (jax.checkpoint):
    # adjoints at production ray counts/step counts without storing every
    # RK stage (SURVEY.md §5.7); no effect on forward-only runs
    remat_steps: bool = True
    # compensated (Neumaier) accumulation of the scan carry: f32 runs
    # keep a per-ray compensation vector so the state-update rounding
    # (the dominant f32 error term over a long trace) cancels, reaching
    # near-f64 end-state accuracy at f32 throughput
    # (tracing/compensated.py; results land in RayResults.end_ray_comp)
    compensated_sum: bool = False

    # ray initialization
    ray_init_model: str = "simple_slab"
    rayinit_static: Any = None     # model-specific frozen dataclass
    nray_max: int = 10000

    # output
    save_trajectory: bool = True
    # per-step formatted ray files ray_out/<ray_list>.<label> for crash
    # forensics (reference diagnostics_m.f90:85-91, check_save.f90:152-154)
    write_formatted_ray_files: bool = False
    # &ray_results_list flags (reference ray_results_m.f90:98-101, honored
    # by finalize_run.f90:21-28): write run_results.<label> (list-directed)
    # and/or run_results.<label>.nc at the end of the run
    write_results_list_directed: bool = False
    write_results_netcdf: bool = False

    @property
    def ns(self) -> int:
        """Number of species entries (electrons + ions)."""
        return self.nspec + 1

    @property
    def nv(self) -> int:
        """ODE vector length (reference RAYS_lib/ode_m.f90:158-175)."""
        nv = 7
        if self.damping_model != "no_damp":
            nv += 1
            if self.multi_spec_damping:
                nv += 1 + self.nspec
        if self.integrate_eq_gradients:
            nv += 5
        return nv

    @property
    def damping_slot(self) -> int:
        """Index of the total-absorption slot in v, or -1 if absent."""
        return 7 if self.damping_model != "no_damp" else -1

    @property
    def grad_diag_slot(self) -> int:
        """Index of the first gradient-diagnostic slot in v, or -1."""
        if not self.integrate_eq_gradients:
            return -1
        nv0 = 7
        if self.damping_model != "no_damp":
            nv0 += 1
            if self.multi_spec_damping:
                nv0 += 1 + self.nspec
        return nv0


def asarrays(tree, dtype=jnp.float64):
    """Map a NamedTuple/pytree of python scalars and lists to jnp arrays."""
    import jax

    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype=dtype), tree)
