#!/usr/bin/env python3
"""Where a SamplerEngine tick's time goes on the GPU.

    python3 chip_profile.py [--out-dir DIR]

Builds the same full-width ONDPP kernel and preprocessed sampler as
``chip_smoke.py`` (M = 2^20, K = 100, block 64), timing each preprocess
stage (host Youla, proposal eigens, tree), serves 64 requests once to
warm up, then serves 64 more under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON line: wall seconds per tick, the device's
busy share (the sum of kernel time over the wall time of the profiled
window, which the profiler itself lengthens; an unprofiled run's tick
time is printed beside it), kernel launches per tick, and the kernels
and host-side operators that take the most time.  The full operator
table goes to ``<out-dir>/profile_table.txt`` (default ``profile_out/``).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from chip_smoke import _device_us
    from repro_torch.core import (
        NDPPSampler,
        construct_tree,
        proposal_eigens,
        spectral_from_params,
    )
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    V, B, D = cs.ondpp_factors(cs.M_ITEMS, cs.K_RANK, cs.SEED)
    stages = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    # the stages of preprocess, one by one
    sp = timed("youla_s", spectral_from_params, V, B, D, device="cuda")
    lam, w = timed("eigens_s", proposal_eigens, sp)
    tree = timed("tree_s", construct_tree, lam, w, block=cs.BLOCK)
    sampler = NDPPSampler(sp=sp, tree=tree)

    def serve(first_seed):
        eng = SamplerEngine(sampler, n_slots=cs.N_SLOTS)
        for rid in range(cs.N_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=first_seed + rid))
        eng.run()
        torch.cuda.synchronize()
        return eng

    serve(1000)                                   # warm-up
    t0 = time.perf_counter()
    plain = serve(1500)                           # unprofiled reference
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng = serve(2000)
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _device_us(e) > 0 and e.cpu_time_total == 0]
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top_kernels = sorted(kernels, key=_device_us, reverse=True)[:8]
    host_ops = [e for e in avgs if e.self_cpu_time_total > 0]
    top_host = sorted(host_ops, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "profile_table.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps({"profile": {
        "device": torch.cuda.get_device_name(0),
        "preprocess_stages": stages,
        "unprofiled": {"ticks": plain.ticks, "wall_s": plain_wall,
                       "ms_per_tick": plain_wall / plain.ticks * 1e3},
        "ticks": eng.ticks, "wall_s": wall,
        "ms_per_tick": wall / eng.ticks * 1e3,
        "device_busy_share": device_us * 1e-6 / wall,
        "kernel_launches_per_tick": launches / eng.ticks,
        "top_kernels_ms": [[e.key[:80], _device_us(e) / 1e3, e.count]
                           for e in top_kernels],
        "top_host_ops_ms": [[e.key[:80], e.self_cpu_time_total / 1e3, e.count]
                            for e in top_host]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
