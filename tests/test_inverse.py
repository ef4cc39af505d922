"""The flagship differentiability claim, reproduced in CI (VERDICT r3
item 8): the inverse-problem demo — recover perturbed Solovev (kappa,
iota0) from ray endpoints by Adam through the full integration scan —
must make verifiable progress in a bounded configuration.  The full run
is scripts/inverse_demo.py.
"""

import os
import sys

import rays_tpu  # noqa: F401

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))


def test_inverse_demo_converges_bounded():
    from inverse_demo import run_demo

    out = run_demo(n_iters=12, nstep_max=40, n_newton=2,
                   log=lambda *_: None)
    losses = [h[0] for h in out["history"]]
    # misfit strictly decreases over the bounded run
    assert losses[-1] < losses[0] * 0.5, losses
    # both parameters moved toward truth from the perturbed start
    (tk, ti), (sk, si), (fk, fi) = out["true"], out["start"], out["final"]
    assert abs(fk - tk) < abs(sk - tk), (fk, sk, tk)
    assert abs(fi - ti) < abs(si - ti), (fi, si, ti)
    # the Newton stage (jax.hessian through the integration scan) ran and
    # produced at least one accepted second-order step
    assert len(losses) > 12, "no accepted Newton step in bounded run"
