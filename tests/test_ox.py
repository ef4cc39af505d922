"""O-X mode-conversion analysis (rays_tpu/post/ox_conversion.py) vs the
Mjolhus Eq. 19 model evaluated independently in NumPy.

Synthetic slab: B = bz0 zhat (constant), ne linear in x so alpha_e(x) =
alpha0 (1 + x/Ln) crosses the O-mode cutoff alpha = 1 at the analytically
known x_cut = Ln (1/alpha0 - 1).  With B ⊥ grad(ne) the Mjolhus frame is
(xc, yc, zc) = (xhat, yhat, zhat) and theta = pi/2, so every coefficient in
Eq. 19 has a closed form the test evaluates with plain NumPy (reference
OX_conv_analysis_m.f90:318-394,411+).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

import rays_tpu  # noqa: F401
from rays_tpu import constants, examples
from rays_tpu.post import ox_conversion
from rays_tpu.tracing.stop import StopCode
from rays_tpu.tracing.trace import RayResults

# 90 GHz O-mode: cutoff density ~1.006e20 m^-3 with the reference constants;
# n0 = 0.9e20 and Ln = 1 put the alpha=1 surface inside the box.
OX_SLAB = examples.SLAB_ECH_90GHZ.replace(
    "n0=1.0e20,", "n0=0.9e20,").replace(
    "dens_prof_model='linear', Ln_scale=0.714286,",
    "dens_prof_model='linear', Ln_scale=1.0,")


@pytest.fixture(scope="module")
def ox_case():
    # no ray init needed (the analysis consumes synthetic trajectories, and
    # the O-mode 'minus' root is evanescent at the launch fan anyway)
    from rays_tpu.config import schema
    from rays_tpu.config.namelist import parse_namelist

    cfg, params = schema.from_namelist(parse_namelist(OX_SLAB))
    return cfg, params


def _analytic(cfg, params):
    """Closed-form ingredients of Eq. 19 for this slab."""
    omega = 2.0 * math.pi * 90.0e9
    n0, ln = 0.9e20, 1.0
    alpha0 = n0 * constants.E_CHARGE**2 / (
        constants.EPS0 * constants.ME * omega**2)
    x_cut = ln * (1.0 / alpha0 - 1.0)
    bz0 = 1.286
    gamma = constants.E_CHARGE * bz0 / (constants.ME * omega)
    L = ln + x_cut                        # ne/|grad ne| for the linear profile
    k0 = omega / constants.CLIGHT
    n_crit = math.sqrt(gamma / (1.0 + gamma))  # sin(theta)=1 at theta=pi/2
    return dict(x_cut=x_cut, gamma=gamma, L=L, k0=k0, n_crit=n_crit)


def test_newton_finds_cutoff(ox_case):
    cfg, params = ox_case
    a = _analytic(cfg, params)
    x_cut, ok = ox_conversion._find_cutoff_point(
        cfg, params, jnp.array([0.0, 0.0, 0.0]))
    assert bool(ok), "Newton did not converge to alpha=1"
    alpha = float(ox_conversion._alpha_e(cfg, params, x_cut))
    assert abs(alpha - 1.0) < 1e-6
    np.testing.assert_allclose(float(x_cut[0]), a["x_cut"], rtol=1e-6)
    # gradient direction is x: y,z stay put
    np.testing.assert_allclose(np.asarray(x_cut[1:]), 0.0, atol=1e-12)


def test_conv_coeff_matches_numpy(ox_case):
    cfg, params = ox_case
    a = _analytic(cfg, params)
    x_cut = jnp.array([a["x_cut"], 0.0, 0.0])
    x_max = jnp.array([a["x_cut"] - 0.05, 0.0, 0.0])

    # theta = pi/2: cos^2 = 0, sin^2 = 1
    g = a["gamma"]
    F = 0.5 * (1.0 + g) * math.sqrt(g) / (0.5) ** 1.5
    G = 0.5 * math.sqrt(g) / math.sqrt(0.5)

    # N.B. keep each T within a float32 exponent range
    # (~1e-38, constants.py): detuning by ~0.05 in nz gives T ~ 1e-9
    for nz, ny in [(a["n_crit"], 0.0), (a["n_crit"] - 0.05, 0.0),
                   (a["n_crit"] + 0.03, 0.01), (a["n_crit"], 0.02)]:
        k_max = jnp.array([0.1 * a["k0"], ny * a["k0"], nz * a["k0"]])
        got = float(ox_conversion._conv_coeff(cfg, params, x_max, k_max, x_cut))
        want = math.exp(-math.pi * a["k0"] * a["L"]
                        * (F * (abs(nz) - a["n_crit"]) ** 2 + G * ny**2))
        # rtol: the device's host-precomputed alpha/gamma coefficients agree
        # with the raw constants to ~1e-7 relative; the ~20 exponent
        # amplifies that into the value
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   err_msg=f"nz={nz} ny={ny}")

    # optimal launch (nz = n_crit, ny = 0) converts fully
    k_opt = jnp.array([0.0, 0.0, a["n_crit"] * a["k0"]])
    np.testing.assert_allclose(
        float(ox_conversion._conv_coeff(cfg, params, x_max, k_opt, x_cut)),
        1.0, rtol=1e-10)


def _synthetic_results(cfg, params, k_end, x_apex=0.05, n=41):
    """One ray whose x(t) rises to an interior apex then retreats —
    the found_max shape the reference's analysis keys on."""
    xs = np.concatenate([np.linspace(-0.3, x_apex, (n + 1) // 2),
                         np.linspace(x_apex, -0.3, n - (n + 1) // 2 + 1)[1:]])
    nv = cfg.nv
    ray_vec = np.zeros((1, n, nv))
    ray_vec[0, :, 0] = xs
    ray_vec[0, :, 3:6] = np.asarray(k_end)
    return RayResults(
        ray_vec=jnp.asarray(ray_vec),
        residual=jnp.zeros((1, n)),
        npoints=jnp.array([n], jnp.int32),
        stop_flag=jnp.array([int(StopCode.NSTEP_MAX)], jnp.int32),
        initial_ray_power=jnp.ones((1,)),
        end_residuals=jnp.zeros((1,)),
        max_residuals=jnp.zeros((1,)),
        end_ray_parameter=jnp.ones((1,)),
        start_ray_vec=jnp.asarray(ray_vec[:, 0, :]),
        end_ray_vec=jnp.asarray(ray_vec[:, -1, :]),
    )


def test_branches_converting_nonconverting_monotonic(ox_case, tmp_path):
    cfg, params = ox_case
    a = _analytic(cfg, params)

    # converting: k at the optimal Mjolhus launch -> T = 1
    res = _synthetic_results(cfg, params,
                             [0.0, 0.0, a["n_crit"] * a["k0"]])
    conv = ox_conversion.ox_conv_analysis(cfg, params, res)
    assert len(conv) == 1
    c = conv[0]
    assert c.ray_number == 1 and c.conv_coeff > 0.99
    assert 0 < c.step_number < int(res.npoints[0]) - 1
    np.testing.assert_allclose(c.x_max[0], 0.05, atol=1e-12)

    # non-converting: large transverse ny kills the coefficient
    res_bad = _synthetic_results(cfg, params, [0.0, 0.3 * a["k0"], 0.0])
    assert ox_conversion.ox_conv_analysis(cfg, params, res_bad) == []

    # no interior maximum: monotonic trajectory is skipped outright
    xs = np.linspace(-0.3, 0.05, 41)
    ray_vec = np.zeros((1, 41, cfg.nv))
    ray_vec[0, :, 0] = xs
    res_mono = res._replace(ray_vec=jnp.asarray(ray_vec))
    assert ox_conversion.ox_conv_analysis(cfg, params, res_mono) == []

    # list-directed output file (OX_conv_analysis_m.f90:411+)
    path = ox_conversion.write_ox_conversion_data(
        conv, "ox_test", path=str(tmp_path / "OX_conversion.ox_test"))
    text = open(path).read()
    assert "number_of_rays_converted = 1" in text
    assert "conv_coeff" in text
