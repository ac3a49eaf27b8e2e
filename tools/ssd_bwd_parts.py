"""Where the SSD backward's outputs pass (pass C of the wgmma route,
``csrc/ssd.cu::ssd_bwd_chunk_kernel``) spends its time: the pass built
whole and with parts compiled out, each timed by ``torch.profiler`` at
``chip_smoke.py``'s train shape (B = 2, S = 4,096, H = 64, P = 64,
N = 128, chunk 128, bf16, B and C one row over the heads).

    PYTHONPATH=src python tools/ssd_bwd_parts.py

Copies of ``csrc/ssd.cu`` go to ``src/repro_torch/_build/parts/`` (git
ignores it) with ``#if 0`` around the parts named in ``VARIANTS``: phase
1 (dc), phase 2 (dx, db), the d log a scan, or all three (the loads
alone).  A part runs from its line ``// PART <name>`` in the kernel to
the next such line (the last is ``// PART end``).  Each copy is built
with ``_build``'s flags and launched through its own
``ssd_bwd_wgmma_launch``.  Prints one JSON line per variant and round
(two rounds): the mean device ms a call of each of the route's kernels.
A part's cost is the whole pass's time less the time without it; the
outputs of a cut copy are not used.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

#: the parts ssd_bwd_chunk_kernel marks with "// PART <name>", in order
PARTS = ["p1", "p2", "scan", "end"]
VARIANTS = {"whole": [], "no_scan": ["scan"], "no_phase1": ["p1"],
            "no_phase2": ["p2"], "loads_only": ["p1", "p2", "scan"]}


def cut(src: str, parts) -> str:
    """``src`` with ``#if 0`` around each named part, from its mark to the
    next mark."""
    marks = list(re.finditer(r"^[ \t]*// PART (\w+)\n", src, re.M))
    found = [m.group(1) for m in marks]
    if found != PARTS:
        raise ValueError(f"ssd.cu marks parts {found}, expected {PARTS}")
    for k in reversed(range(len(marks) - 1)):
        if found[k] in parts:
            a, b = marks[k].end(), marks[k + 1].start()
            src = src[:a] + "#if 0\n" + src[a:b] + "#endif\n" + src[b:]
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_parts: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops

    src = (_build.CSRC / "ssd.cu").read_text()
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, parts in VARIANTS.items():
        cu = out_dir / f"ssd_{name}.cu"
        cu.write_text(cut(src, parts))
        so = out_dir / f"ssd_{name}.so"
        jobs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"ssd_bwd_parts: nvcc failed on {name}:\n{log}",
                  file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).ssd_bwd_wgmma_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    bsz, s, h, p, n, q = 2, 4096, 64, 64, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(mk(bsz, s, h))
    a = torch.exp(-torch.linspace(1.0, 16.0, h, device=dev) * dt)
    x = (mk(bsz, s, h, p) * dt[..., None]).bfloat16()
    b = mk(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    c = mk(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    dy = mk(bsz, s, h, p).bfloat16()
    _, _, st = ops.ssd_forward(x, a, b, c, q, keep_states=True)
    dx, da = torch.empty_like(x), torch.empty_like(a)
    db = torch.empty(bsz, s, h, n, dtype=x.dtype, device=dev)
    dc = torch.empty_like(db)
    dh_end = torch.empty(bsz, h, s // q, n, p, device=dev)
    strides = [v for t in (x, b, c, dy) for v in t.stride()[:3]]

    def call(fn):
        _build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        c.data_ptr(), st.data_ptr(), dy.data_ptr(), None,
                        dx.data_ptr(), da.data_ptr(), db.data_ptr(),
                        dc.data_ptr(), dh_end.data_ptr(), bsz, s, h, p, n, q,
                        *strides, torch.cuda.current_stream().cuda_stream),
                     "ssd backward (a cut copy)")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    reps = 20
    for rnd in range(2):
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call(fn)
                torch.cuda.synchronize()
            ms = {}
            for evt in prof.key_averages():
                m = re.search(r"ssd_bwd_\w+_kernel", evt.key)
                if m:
                    us = float(getattr(evt, "self_device_time_total",
                                       getattr(evt, "self_cuda_time_total",
                                               0.0)))
                    ms[m.group(0)] = us / reps / 1e3
            print(json.dumps({"round": rnd, "variant": name,
                              "nvidia_smi": smi, "device_ms": ms}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
