"""Where the Cholesky scan kernel's flip rule sits between sound readings and
planted faults.

    PYTHONPATH=src python tools/cholesky_flip_rule.py

For the card tests' scan cases (``tests/test_torch_gpu.py``: R 1–224, M
1–4,097, N 1–300, zero rows), 1,024 rows at R = 200 with marginals of
O(0.1), and the first 2^14 of 2^20 rows of E|Y| ~ 40 (marginals ~4e-5, as
on the main path), the kernel (``csrc/cholesky_scan.cu``, on the route of
R: "blocked" to R = 208, "resident" past it) and the plain scan with each
planted fault of ``ref.FAULTS`` are held to the plain version by
``ref.flip_gaps`` at the rule's limits (``ref.RTOL``, ``ref.ATOL_FRAC``)
and at limits ten and a hundred times tighter.  Prints one JSON line a
case (the route, the kernel's excess under each pair of limits, the
largest |p - p_plain|, the decisions held, each fault's excess; an excess
of at most 1 passes), then the card's name and power limit as
``nvidia-smi`` gives them.  Data are seeded normal draws.  Needs a CUDA
device; imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys

LIMITS = ((1e-4, 1e-6), (1e-5, 1e-7), (1e-6, 1e-8))


def hold(name, z, w, u) -> dict:
    from repro_torch.kernels.cholesky_scan import ops, ref

    take, p = ops.cholesky_scan(z, w, u)
    take_r, p_r = ref.cholesky_scan_ref(z, w, u)
    rec = {"case": name, "route": ops.route(z.shape[1]),
           "mean_p": float(p_r.mean()),
           "max_p": float(p_r.abs().max())}
    for rtol, atol_frac in LIMITS:
        g = ref.flip_gaps(take, p, take_r, p_r, u, rtol, atol_frac)
        rec[f"kernel_{rtol:g}_{atol_frac:g}"] = {
            k: g[k] for k in ("p_excess", "flip_excess", "flipped_draws")}
    g = ref.flip_gaps(take, p, take_r, p_r, u)
    rec["max_p_gap"] = g["max_p_gap"]
    rec["compared_takes"] = g["compared_takes"]
    for fault in ref.FAULTS:
        b = ref.flip_gaps(*ref.planted_scan(z, w, u, fault), take_r, p_r, u)
        rec[fault] = {"p_excess": b["p_excess"],
                      "flip_excess": b["flip_excess"], "within": b["within"]}
    return rec


def main() -> None:
    import torch

    from repro_torch.kernels.cholesky_scan.ref import random_inputs

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cases = ([(257, r, 3) for r in (1, 8, 33, 200, 208, 209, 224)]
             + [(m, 200, 5) for m in (1, 31, 32, 33, 63, 64, 65, 4097)]
             + [(300, 64, n) for n in (1, 131, 132, 133, 300)])
    for m, r, n in cases:
        print(json.dumps(hold(f"M {m}, R {r}, N {n}",
                              *random_inputs(m, r, n, m * 1000 + r + n,
                                             "cuda"))),
              flush=True)
    print(json.dumps(hold("zero rows, M 1024, R 200, N 133", *random_inputs(
        1024, 200, 133, 7, "cuda", zero_rows=(0, 5, 6, 100, 1023)))),
        flush=True)
    print(json.dumps(hold("M 1024, R 200, N 132",
                          *random_inputs(1024, 200, 132, 11, "cuda"))),
          flush=True)
    big = 1 << 20
    z, w, u = random_inputs(big, 200, 132, 13, "cuda",
                            scale=(10.0 / 190.0 / big) ** 0.5)
    print(json.dumps(hold("first 2^14 of 2^20 rows, R 200, N 132",
                          z[: 1 << 14].contiguous(), w,
                          u[:, : 1 << 14].contiguous())), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
