"""Time ``descend_score``, ``block_outer_sums``, ``bilinear_batched``,
``gathered_block_grams``, ``score_all`` and ``bilinear`` on the card at the
shapes of
``chip_smoke.py``'s paths, beside their one-call PyTorch yardsticks,
``score_all_sharded`` at a mesh's M/S rows a shard and ``score_all`` on a
few rows (host dispatch), and the MCMC path's greedy start, which calls
``score_all`` eight times.  ``--only descend_score`` times that kernel
alone.

It times the kernels of whichever ``repro_torch`` comes first on
``PYTHONPATH``, so two trees are compared in one call by running it in
turns, for example (the parent unpacked with ``git archive`` into a
git-ignored directory):

    PYTHONPATH=_ab/parent/src python tools/tree_kernel_times.py --tag parent
    PYTHONPATH=src python tools/tree_kernel_times.py --tag change
    PYTHONPATH=src python tools/tree_kernel_times.py --tag change
    PYTHONPATH=_ab/parent/src python tools/tree_kernel_times.py --tag parent

Each run prints one JSON line: the tag, the card's name and power limit
as ``nvidia-smi`` gives them, and per kernel the mean CUDA-event time of
warm calls through the wrapper (``ms``: host dispatch included, where it
is longer than the kernel), the kernel's own mean device time from
``torch.profiler`` (``device_ms``) and the yardstick's event time in the
same process.  Data are normal draws from ``--seed``; no kernel's time
depends on them.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
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


def device_ms(fn, name: str, reps: int = 50) -> float:
    """Mean device time of the kernels whose name holds ``name`` (or one of
    its ``|``-separated parts) over ``reps`` calls of ``fn``, from a
    profiler trace (0 if none showed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if any(part in evt.key for part in name.split("|")):
            total += float(getattr(evt, "self_device_time_total",
                                   getattr(evt, "self_cuda_time_total", 0.0)))
    return total / reps / 1e3


def descend_score_times(g, dev) -> dict:
    """``descend_score`` at the main path's shape: a tree built by
    ``construct_tree`` from normal rows (M = 2^20, R = 200, blocks of 64:
    depth 14) and 64 lanes of diagonal projectors, each choosing 10 of the
    200 eigenvectors, as the main path's first step of a round makes them
    (E|Y| ~ 10); timed at depth 14 and at depth 0 (the first leaf block
    alone, under the root: the leaf stage).  ``blk_sum`` ties the descents
    of two trees' runs together."""
    import torch
    from repro_torch.core.tree import construct_tree
    from repro_torch.kernels.spec_round import ops as spec_ops

    m, r, block, n = 1 << 20, 200, 64, 64
    w = torch.randn((m, r), generator=g, device=dev)
    tree = construct_tree(torch.zeros(r, device=dev), w, block=block)
    del w
    pick = torch.rand((n, r), generator=g, device=dev).argsort(dim=1)[:, :10]
    q = torch.diag_embed(torch.zeros((n, r), device=dev).scatter_(
        1, pick, 1.0)).contiguous()
    us = torch.rand((n, tree.depth), generator=g, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pick_c = getattr(spec_ops, "cluster_size", None)  # absent where lanes take one CTA
    out = {"shape": [n, r, block], "sms": sms,
           "cluster": pick_c(n, sms) if pick_c else 1}
    for name, nodes, w_rows in (
            (f"depth{tree.depth}", tree.nodes, tree.W),
            ("depth0", tree.nodes[:1], tree.W[:block])):
        fn = lambda: spec_ops.descend_score(nodes, w_rows, block, q, us)  # noqa: E731
        blk, _ = fn()
        out[name] = {"ms": cuda_ms(fn, 200),
                     "device_ms": device_ms(fn, "descend_score_kernel"),
                     "blk_sum": int(blk.sum())}
    del tree
    torch.cuda.empty_cache()
    return out


def greedy_start_ms(m: int, k: int, seed: int, dev, starts: int = 5) -> dict:
    """Host ms of the MCMC path's greedy start (``core/mcmc.py::
    init_greedy``: one chain of size 8, i.e. 8 ``score_all`` calls at
    C = 1 over all m rows and each round's draw), on the spectral state of
    the paper's synthetic features at m items and rank k (R = 2k); one
    warm start, then ``starts`` timed ones, each synchronised."""
    import time

    import torch
    from repro_torch import random as trandom
    from repro_torch.core import mcmc as mcmc_core
    from repro_torch.core.youla import spectral_from_params
    from repro_torch.data.baskets import synthetic_features

    sp = spectral_from_params(*synthetic_features(m, k, seed=seed), device=dev)
    times = []
    for i in range(starts + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcmc_core.init_greedy(sp, trandom.PRNGKey(seed + i, dev), 1, 8)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"M": m, "R": 2 * k, "k": 8, "ms": times[1:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["descend_score"],
                    help="time this kernel alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.mcmc_score import ops as score_ops
    from repro_torch.kernels.tree_sum import ops as tree_sum_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"tag": args.tag, "card": smi,
           "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
           "source": tree_sum_ops.__file__}
    out["descend_score"] = descend_score_times(g, dev)
    if args.only:
        print(json.dumps(out), flush=True)
        return 0

    # block_outer_sums: the main path's leaf level (2^20 rows of R = 200,
    # blocks of 64)
    n, block, r = 1 << 14, 64, 200
    w = torch.randn((n * block, r), generator=g, device=dev)
    wb = w.view(n, block, r)
    leaf = torch.empty((n, r, r), device=dev)
    tree_sum_ops.block_outer_sums(w, block, out=leaf)
    outer = lambda: tree_sum_ops.block_outer_sums(w, block, out=leaf)  # noqa: E731
    out["block_outer_sums"] = {
        "shape": [n, block, r],
        "ms": cuda_ms(outer, 20),
        "device_ms": device_ms(outer, "block_outer_sums_kernel", 10),
        "library_ms": cuda_ms(lambda: torch.bmm(wb.transpose(1, 2), wb), 10),
        # writing the 2.6 GB leaf level once, nothing read: the stores' floor
        "fill_ms": cuda_ms(lambda: leaf.fill_(1.0), 10)}
    del w, wb, leaf
    torch.cuda.empty_cache()

    # bilinear_batched: the sharded path's leaf scoring (64 lanes of 64
    # rows, R = 200)
    n, b = 64, 64
    z = torch.randn((n, b, r), generator=g, device=dev)
    q = torch.randn((n, r, r), generator=g, device=dev)
    batched = lambda: bilinear_ops.bilinear_batched(z, q)  # noqa: E731
    out["bilinear_batched"] = {
        "shape": [n, b, r],
        "ms": cuda_ms(batched, 200),
        "device_ms": device_ms(batched, "bilinear_batched_kernel"),
        "library_ms": cuda_ms(lambda: (torch.bmm(z, q) * z).sum(-1), 200)}
    del z, q

    # gathered_block_grams: the catalog's update batch (1,024 distinct
    # blocks of 64 rows out of 16,384, R = 200); its kernel is
    # block_outer_sums_kernel, or gathered_block_grams_kernel in trees
    # that kept the first port's design
    n, nb = 1 << 14, 1024
    w = torch.randn((n * block, r), generator=g, device=dev)
    blks = torch.randperm(n, generator=g, device=dev)[:nb]
    rows = (blks[:, None] * block + torch.arange(block, device=dev)).reshape(-1)

    def gathered_library():
        wb = w.index_select(0, rows).view(nb, block, r)
        return torch.bmm(wb.transpose(1, 2), wb)

    gathered = lambda: tree_sum_ops.gathered_block_grams(w, blks, block)  # noqa: E731
    out["gathered_block_grams"] = {
        "shape": [nb, block, r], "ms": cuda_ms(gathered, 50),
        "device_ms": device_ms(gathered, "block_outer_sums_kernel|"
                                         "gathered_block_grams_kernel", 20),
        "library_ms": cuda_ms(gathered_library, 50)}
    del w

    # score_all and bilinear: the greedy start's all-catalog scores (M =
    # 2^20, R = 200) at C = 1 and chip_smoke.py's C = 8, and bilinear in
    # float32 and bfloat16; the kernels' names start with quad_ in this
    # tree (quad_resident_kernel) and in the first port's (quad_form_kernel)
    m = 1 << 20
    zm = torch.randn((m, r), generator=g, device=dev)
    for c in (1, 8):
        a = torch.randn((c, r, r), generator=g, device=dev)
        fn = lambda: score_ops.score_all(zm, a)  # noqa: E731
        out[f"score_all_C{c}"] = {
            "shape": [c, m, r], "ms": cuda_ms(fn, 10 if c == 1 else 3),
            "device_ms": device_ms(fn, "quad_", 10 if c == 1 else 3),
            "library_ms": cuda_ms(lambda: ((zm @ a) * zm).sum(-1),
                                  10 if c == 1 else 3)}
    # the sharded MCMC path's greedy-start scores: score_all_sharded at
    # C = 1 over meshes of S = 1 and 2 on the one card (one launch of M/S
    # rows a shard), and one launch of 4,096 rows, where the wrapper's host
    # dispatch and each CTA's staging of A show
    from repro_torch.launch.mesh import make_sampler_mesh

    a1 = torch.randn((1, r, r), generator=g, device=dev)
    for s in (1, 2):
        mesh = make_sampler_mesh(devices=[zm.device] * s)
        fn = lambda: score_ops.score_all_sharded(zm, a1, mesh)  # noqa: E731
        out[f"score_all_sharded_S{s}"] = {
            "shape": [1, m, r], "shards": s, "ms": cuda_ms(fn, 10),
            "device_ms": device_ms(fn, "quad_", 10)}
    z4k = zm[:4096]
    fn = lambda: score_ops.score_all(z4k, a1)  # noqa: E731
    out["score_all_M4096"] = {"shape": [1, 4096, r], "ms": cuda_ms(fn, 200),
                              "device_ms": device_ms(fn, "quad_", 50)}
    wq = torch.randn((r, r), generator=g, device=dev)
    for name, zz, ww in (("bilinear", zm, wq),
                         ("bilinear_bf16", zm.bfloat16(), wq.bfloat16())):
        fn = lambda: bilinear_ops.bilinear(zz, ww)  # noqa: E731
        out[name] = {
            "shape": [m, r], "ms": cuda_ms(fn, 10),
            "device_ms": device_ms(fn, "quad_", 10),
            "library_ms": cuda_ms(lambda: ((zz @ ww) * zz).sum(-1), 10)}
    del zm, zz, wq
    torch.cuda.empty_cache()
    out["greedy_start"] = greedy_start_ms(m, r // 2, args.seed, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
