"""Parameter-scan harness: convergence and scaling studies.

Re-design of the reference's ray_scan application
(reference RAYS_project/ray_scan/ray_scan.f90 + scanner_m.f90): loop
{update scan parameter -> re-run trace -> aggregate end/max residuals and
wall time} -> scan summary.  Scan parameters and algorithms follow
scanner_m.f90:1-20: 'ds' with fixed_increment / pwr_of_2 / integer_divide;
the reference's 'num_threads' scaling scan maps to a ray-batch-size sweep
(the device analog of thread count).

Property: ds is a *traced* parameter, so the whole ds-scan
reuses one compiled executable — the reference re-initializes the ODE
module per run; we just call the jitted tracer with a new params pytree.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def scan_values(start, n_runs, algorithm="fixed_increment", increment=None,
                factor=2.0):
    """Scan-parameter schedule (scanner_m.f90 algorithms)."""
    vals = []
    v = start
    for i in range(n_runs):
        vals.append(v)
        if algorithm == "fixed_increment":
            v = v + (increment if increment is not None else start)
        elif algorithm == "pwr_of_2":
            v = v * 2.0
        elif algorithm == "integer_divide":
            v = start / (i + 2)
        elif algorithm == "factor":
            v = v * factor
        else:
            raise ValueError(f"unknown scan algorithm {algorithm}")
    return vals


def ds_scan(cfg, params, v0, status0, pwr, ds_values):
    """Step-size convergence scan.  Returns list of per-run summaries."""
    from rays_tpu.tracing import trace as trace_mod

    tracer = jax.jit(lambda p, v, s, w: trace_mod.trace_batch(cfg, p, v, s, w))
    rows = []
    for ds in ds_values:
        p = params._replace(ode=params.ode._replace(ds=ds))
        t0 = time.perf_counter()
        res = tracer(p, v0, status0, pwr)
        jax.block_until_ready(res)
        wall = time.perf_counter() - t0
        rows.append({
            "ds": float(ds),
            "wall_s": wall,
            "max_residual": float(np.asarray(res.max_residuals).max()),
            "mean_end_residual": float(np.asarray(res.end_residuals).mean()),
            "min_npoints": int(np.asarray(res.npoints).min()),
            "end_x": np.asarray(res.end_ray_vec[:, 0:3]),
        })
    return rows


def batch_scan(cfg, params, v0, status0, pwr, batch_sizes):
    """Throughput scaling vs ray-batch size (the num_threads-scan analog)."""
    from rays_tpu import examples
    from rays_tpu.tracing import trace as trace_mod

    rows = []
    for B in batch_sizes:
        vb, sb, wb = examples.replicate_rays(v0, status0, pwr, B)
        tracer = jax.jit(
            lambda p, v, s, w: trace_mod.trace_batch(cfg, p, v, s, w))
        res = tracer(params, vb, sb, wb)
        jax.block_until_ready(res)  # compile + warm
        t0 = time.perf_counter()
        res = tracer(params, vb, sb, wb)
        jax.block_until_ready(res)
        wall = time.perf_counter() - t0
        rows.append({"batch": B, "wall_s": wall, "rays_per_s": B / wall})
    return rows


def write_scan_summary(rows, path="scan_summary.txt"):
    keys = [k for k in rows[0] if not isinstance(rows[0][k], np.ndarray)]
    with open(path, "w") as f:
        f.write(" ".join(f"{k:>16s}" for k in keys) + "\n")
        for r in rows:
            f.write(" ".join(f"{r[k]:16.6g}" for k in keys) + "\n")
    return path
