"""Capture a jax.profiler trace of bounce_step and print top device ops.

The trace lands in chiprun_out/bounce_trace.  Usage:

    python tools/trace_bounce.py            # top ops by name
    DETAIL=1 python tools/trace_bounce.py   # re-read it, by source line
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from photorealistic_rendering_using_opencl_tpu.models import integrator  # noqa: E402
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler  # noqa: E402
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene  # noqa: E402
from photorealistic_rendering_using_opencl_tpu.utils.config import (  # noqa: E402
    enable_compile_cache,
)

TRACE_DIR = "chiprun_out/bounce_trace"


def main():
    enable_compile_cache()
    cfg, scene = load_scene("scenes/cornell.json")
    n = 262144
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    pix = jnp.arange(n, dtype=jnp.uint32)
    smp = jnp.zeros_like(pix)
    state = integrator.init_state(o, d)

    @jax.jit
    def steps(state):
        def body(st, i):
            sampler = Sampler(pix, smp + i, seed=0, scheme="pcg4d", dim=8)
            return integrator.bounce_step(cfg, scene, st, sampler,
                                          jnp.asarray(0, jnp.int32)), None
        st, _ = jax.lax.scan(body, state, jnp.arange(8, dtype=jnp.uint32))
        return st.acc.sum()

    float(steps(state))  # compile
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        float(steps(state))

    files = glob.glob(TRACE_DIR + "/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace file found", glob.glob(TRACE_DIR + "/**", recursive=True))
        return
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("dur")]
    # aggregate by name
    agg = {}
    for e in events:
        name = e.get("name", "?")
        agg[name] = agg.get(name, 0) + e["dur"]
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:30]
    total = sum(agg.values())
    print(f"total traced op-us {total}")
    for name, us in top:
        print(f"{us/1e3:9.2f} ms  {name[:110]}")


if __name__ == "__main__" and not os.environ.get("DETAIL"):
    main()


def detail():
    files = glob.glob(TRACE_DIR + "/**/*.trace.json.gz", recursive=True)
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("dur")]
    # find the device lane (pid/tid) hosting xla ops: pick events named like fusions
    agg = {}
    for e in events:
        name = e.get("name", "?")
        if not any(k in name for k in ("fusion", "copy", "closed_call",
                                       "reduce", "while", "select", "convert",
                                       "broadcast", "iota", "scatter",
                                       "gather", "sort", "dot", "cosine",
                                       "concatenate", "slice", "bitcast",
                                       "transpose", "pad", "dynamic")):
            continue
        args = e.get("args", {})
        src = args.get("source_info") or args.get("long_name") or ""
        key = (name.split(".")[0], src[:90])
        agg[key] = agg.get(key, 0) + e["dur"]
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:40]
    for (name, src), us in top:
        print(f"{us/1e3:9.2f} ms  {name:28s} {src}")


if __name__ == "__main__" and os.environ.get("DETAIL"):
    detail()
