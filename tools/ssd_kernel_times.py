"""Time the SSD scan's two routes, forward (kernel 8) and backward (8b),
on the card, in one process, at the path shape of ``chip_smoke.py``'s
``train_ssm`` layer 0: B = 2, S = 4,096, H = 64, P = 64, N = 128, chunk
128, x, B, C, dy in bf16, a in float32, B and C one row over all heads (a
head stride of 0), dh_last zero.

    PYTHONPATH=src python tools/ssd_kernel_times.py [--tag change]

Both routes of each direction launch through their own C entries on the
same inputs (``ops._launch_forward``, ``ops._launch_backward``): "wgmma"
(``ssd_fwd_wgmma_launch``, ``ssd_bwd_wgmma_launch``: passes A, B, C) and
"simt" (``ssd_fwd_launch``, ``ssd_bwd_launch``: the SIMT kernels), in
turns simt, wgmma, wgmma, simt; the forward keeps its states, as the
train step does.  Prints one JSON line: the tag, the card's name and
power limit as ``nvidia-smi`` gives them, and for each direction each
turn's mean CUDA-event time of warm calls (``ms``), the wgmma route's
kernels by name with their mean device time from ``torch.profiler``
(``device_ms``), and the two routes' largest |difference| relative to
the largest |value| of each output (da as d log a = da * a).
Decays are made as the Mamba2 mixer makes them (a = exp(-A_h dt),
A_h = 1..16 over the heads, dt = softplus(z)); data are normal draws from
``--seed``.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match: str, reps: int = 10) -> dict:
    """Mean device ms a call of ``fn`` of each CUDA kernel whose name holds
    ``match``, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if match in evt.key and evt.device_type.name == "CUDA":
            us = float(getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0)))
            name = re.search(match + r"\w*", evt.key).group(0)
            out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    bsz, s, h, p, n, q = 2, 4096, 64, 64, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(mk(bsz, s, h))
    a = torch.exp(-torch.linspace(1.0, 16.0, h, device=dev) * dt)
    x = (mk(bsz, s, h, p) * dt[..., None]).bfloat16()
    b = mk(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    c = mk(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    dy = mk(bsz, s, h, p).bfloat16()
    _, _, states = ops.ssd_forward(x, a, b, c, q, keep_states=True)

    def rel_diff(names, us, vs):
        return {name: float((u.float() - v.float()).abs().max()
                            / v.float().abs().max().clamp_min(1e-30))
                for name, u, v in zip(names, us, vs)}

    def timed(run, match):
        turns = [{"route": r, "ms": cuda_ms(lambda: run(r), args.reps)}
                 for r in ("simt", "wgmma", "wgmma", "simt")]
        return {"turns": turns,
                "wgmma_device_ms": device_ms(lambda: run("wgmma"), match)}

    def fwd(route):
        return ops._launch_forward(route, x, a, b, c, q, True)

    outs = {r: fwd(r) for r in ("simt", "wgmma")}
    torch.cuda.synchronize()
    fdiff = rel_diff(("y", "h_last", "states"), outs["wgmma"], outs["simt"])
    del outs

    def bwd(route):
        return ops._launch_backward(route, x, a, b, c, states, dy, None, q)

    outs = {r: bwd(r) for r in ("simt", "wgmma")}
    torch.cuda.synchronize()
    # d log a = da * a: da itself divides float32 sums by decays near 0
    bdiff = rel_diff(
        ("dx", "dloga", "db", "dc"),
        (outs["wgmma"][0], outs["wgmma"][1] * a, *outs["wgmma"][2:]),
        (outs["simt"][0], outs["simt"][1] * a, *outs["simt"][2:]))
    del outs
    out = {"tag": args.tag, "nvidia_smi": smi,
           "shape": {"B": bsz, "S": s, "H": h, "P": p, "N": n, "chunk": q,
                     "dtype": "bfloat16", "b_c_head_stride": b.stride(2)},
           "fwd": dict(timed(fwd, "ssd_fwd"), wgmma_vs_simt_rel_diff=fdiff),
           "bwd": dict(timed(bwd, "ssd_bwd"), wgmma_vs_simt_rel_diff=bdiff)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
