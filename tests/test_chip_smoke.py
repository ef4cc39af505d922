"""chip_smoke.py on the CPU: every phase at a tiny size, the refusal to run
without a GPU, the four-device path on a virtual CPU mesh, and where the
package puts its compilation cache.

The phases' own comparisons run here against the CPU itself (the GPU-vs-CPU
checks are then trivially met, the oracle and f32-vs-f64 checks are not).
The full widths run only on the card: ``python chip_smoke.py``.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {
    "phase_cli": dict(n_side=2, n_steps=40),
    "phase_slab_rk4": dict(n_rays=8, n_steps=40, n_oracle=3),
    # equal ray counts share one compiled program per dtype
    "phase_adjoint": dict(n_rays=8, n_steps=40, n_big=8, n_cpu=8),
    # one substep keeps the unrolled adjoint's CPU compile short
    "phase_sg": dict(n_rays=8, n_steps=40, n_cpu=8, substeps=1),
    "phase_eqdsk": dict(n_rays=8, n_steps=40, n_oracle=2, grid=33),
}


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


@pytest.mark.parametrize("name", [fn.__name__
                                  for _, fn in chip_smoke.SINGLE_CARD_PHASES])
def test_phase_tiny(name, capsys):
    out = getattr(chip_smoke, name)(**TINY[name])
    assert isinstance(out, dict) and out
    assert "rays/s" in capsys.readouterr().out


def test_main_refuses_without_gpu():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, env=_cpu_env(),
                          cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("name", [fn.__name__
                                  for _, fn in chip_smoke.FOUR_GPU_PHASES])
def test_four_gpu_path_on_virtual_cpu_mesh(name):
    prog = (f"import chip_smoke; "
            f"chip_smoke.{name}(n_per_device=2, n_steps=20); print('OK')")
    env = _cpu_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join([REPO,
                                               os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


_CACHE_PROG = ("import json, jax, rays_tpu; "
               "print(json.dumps(jax.config.jax_compilation_cache_dir))")


def _cache_dir(env):
    proc = subprocess.run([sys.executable, "-c", _CACHE_PROG],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_compile_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir(_cpu_env(JAX_COMPILATION_CACHE_DIR=want)) == want


def test_compile_cache_defaults_inside_checkout():
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir(env) == os.path.join(REPO, ".jax_cache")
