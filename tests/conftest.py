"""Test environment setup.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``).  Multi-device
sharding paths run in subprocesses on a virtual CPU mesh
(``--xla_force_host_platform_device_count``); tests that need several
devices in-process skip themselves when fewer than 2 are visible.  The GPU
path is checked by ``python chip_smoke.py`` on the card.
"""

import jax

jax.config.update("jax_enable_x64", True)
