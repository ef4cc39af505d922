"""Profile the production slab scan on a GPU: kernels per scan step and
device time per step.

    python scripts/step_profile.py [--out profiles]

1. XLA cost analysis of the jitted f32 slab tracer (XLA counts the scan
   body once, so these are per-step figures);
2. a `jax.profiler` trace of one warm 500-step batch, reduced to a kernel
   census: the GPU device planes' stream lines, kernels that run once per
   scan step, their summed device time per step, and the device's busy
   share of the traced window (union of kernel intervals over the window).

Writes <out>/step_profile.txt and keeps the trace under <out>/trace.
"""

import argparse
import collections
import dataclasses
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rays_tpu  # noqa: E402,F401
from rays_tpu import examples  # noqa: E402
from rays_tpu.tracing import trace as trace_mod  # noqa: E402

N_RAYS = 32768
N_STEPS = 500


def make_tracer(n_rays):
    cfg, params, v0, st, pwr = examples.setup_example()
    cfg = dataclasses.replace(cfg, nstep_max=N_STEPS, save_trajectory=False)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    v, s, w = examples.replicate_rays(v0, st, pwr, n_rays)
    args = (cast(params), v.astype(jnp.float32), s, w.astype(jnp.float32))
    f = jax.jit(lambda p, vv, ss, ww: trace_mod.trace_batch(cfg, p, vv, ss, ww))
    return f, args


def kernel_events(xplane_path):
    """(line names seen, [(name, start_ns, dur_ns)]) of the kernels on the
    GPU device planes' stream lines."""
    from jax.profiler import ProfileData

    lines_seen, events = [], []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen.append(f"{plane.name} | {line.name} ({len(evs)})")
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.duration_ns) for e in evs]
    return lines_seen, events


def busy_ns(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, -1.0
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def census(events, n_steps):
    """Kernels that run a whole number of times per scan step, their device
    time per step, and the whole census as text lines."""
    durs, counts = collections.Counter(), collections.Counter()
    for name, _, d in events:
        durs[name] += d
        counts[name] += 1
    per_step = [k for k in counts if counts[k] % n_steps == 0]
    launches = sum(counts[k] for k in per_step) / n_steps
    us_per_step = sum(durs[k] for k in per_step) / n_steps / 1e3
    lines = [f"kernel names run a multiple of {n_steps} times: {len(per_step)}"
             f" ({launches:.0f} launches per step)",
             f"device time per step (those kernels): {us_per_step:.1f} us",
             "top per-step kernels (us per step, launches per step, name):"]
    for k in sorted(per_step, key=lambda k: -durs[k])[:12]:
        lines.append(f"  {durs[k] / n_steps / 1e3:8.2f}  {counts[k] // n_steps:3d}"
                     f"  {k[:90]}")
    others = [k for k in counts if k not in per_step]
    lines.append(f"other kernels: {len(others)} names, "
                 f"{sum(durs[k] for k in others) / 1e3:.1f} us in all")
    return len(per_step), launches, us_per_step, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "profiles"))
    args = ap.parse_args(argv)
    lines = []

    def say(msg=""):
        print(msg, flush=True)
        lines.append(str(msg))

    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError as e:
        card = f"nvidia-smi unavailable: {e}"
    say(f"# {card}; device_kind {dev.device_kind}; jax {jax.__version__}")

    B = N_RAYS
    f, fargs = make_tracer(B)
    compiled = f.lower(*fargs).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops = ca.get("flops", float("nan"))
    byts = ca.get("bytes accessed", float("nan"))
    say(f"# XLA cost analysis, f32 slab tracer, B={B}, {N_STEPS} steps "
        f"(scan body counted once)")
    say(f"flops {flops:.4g} ({flops / B:.0f} per ray-step); bytes accessed "
        f"{byts:.4g} ({byts / B:.0f} per ray-step)")

    jax.block_until_ready(f(*fargs))
    t0 = time.perf_counter()
    jax.block_until_ready(f(*fargs))
    wall = time.perf_counter() - t0
    trace_dir = os.path.join(args.out, "trace")
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    jax.block_until_ready(f(*fargs))
    traced_wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    xp = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                       "*.xplane.pb")))[-1]
    seen, events = kernel_events(xp)
    say()
    say(f"# Kernel census of one traced batch ({xp})")
    say("GPU lines: " + "; ".join(seen))
    for ln in census(events, N_STEPS)[3]:
        say(ln)
    if events:
        span = (max(s + d for _, s, d in events)
                - min(s for _, s, d in events))
        busy = busy_ns(events)
        say(f"kernel span {span / 1e6:.2f} ms, busy {busy / 1e6:.2f} ms "
            f"({busy / span:.3f} of the span)")
    say(f"batch wall {wall:.4f} s untraced ({B / wall:.1f} rays/s), "
        f"{traced_wall:.4f} s traced")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "step_profile.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    say(f"wrote {path}")


if __name__ == "__main__":
    main()
