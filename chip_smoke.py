#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, serves
requests through the port's main path at full width, and holds every
kernel against its plain PyTorch version on the card:

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
2. the main path at the paper's M = 1e6, K = 100 setting (M = 2^20 items,
   R = 2K = 200, leaf blocks of 64: 16,384 blocks, tree depth 14): an ONDPP
   kernel from a seed, ``preprocess`` on the card, then ``SamplerEngine``s
   with 8 slots and automatic speculation depth serving 64 requests cold
   (first solver handles and allocator growth; other seeds) and 64 timed
   warm requests; every result is checked, and the kernels' launch counts
   are read around this run only -> one ``{"main_path": ...}`` line (every
   later phase sets the counts to 0 before it and reads them after it);
3. the admission scheduler and the front door on the main path's sampler,
   nothing cut: a ``Scheduler`` over a rejection pool (8 slots, n_spec 8)
   and an MCMC pool (8 slots, k = 8) sharing one ``Telemetry``, replaying
   on the wall clock a trace of 256 requests made with numpy from the seed
   (exponential gaps at 200 requests/s, priorities 0-2, a quarter with
   deadlines of 50-500 ms, 32 pinned to the MCMC pool; a queue of 64 that
   evicts when full): every rid terminal exactly once, every shed by a
   known reason with its flight event and span, every done draw equal to
   a direct engine submission of the same (rid, seed), mean trials within
   [0.5, 2] x exact; then 64 requests through an engine with telemetry and
   one without, equal per rid, with the same ticks, device-to-host copies
   and kernel launches (kernel 1's and all) by the profiler's events; then
   64 requests through the asyncio ``FrontDoor`` and 8 ``POST
   /v1/sample`` calls through ``serve_http`` on 127.0.0.1, each equal to
   direct submission, and ``GET /v1/metrics`` exposing the engine's and
   the scheduler's instruments -> ``{"serve": ...}`` (requests/s direct,
   through the front door and through HTTP, queue-wait, latency, service
   and tick p50 / p99 from the telemetry, shed counts by reason);
4. the Cholesky sampler (Alg. 1) on the main path's state:
   ``sample_cholesky_spectral`` on one key a SM (one draw a CTA of the
   ``cholesky_scan`` kernel) and on one key (equal to the wave's row 0),
   mean |Y| within 5 standard errors of E|Y| = tr(W Z^T Z), then the
   samplers on ported kernels: a sequential ``sample_batch`` of 8
   requests and a ``sample_k_ndpp`` of size 10 (``descend_score``), one
   ``sample_elementary_dense`` draw (``bilinear`` over all 2^20 rows a
   step) -> ``{"cholesky": ...}``;
5. the learned path at the same width, nothing cut: ``planted_baskets``
   (4,096 baskets of up to 8 items over the 2^20 items, 410 held out),
   ``fit_ondpp`` from the main path's factors (20 AdamW steps of 256
   baskets, each iterate projected; every loss finite, the last full-batch
   loss below the first, max|B^T B - I| and max|V^T B| / (|V| |B|) within
   1e-4; step ms cold and warm, the slogdet and QR times beside them, a
   2-step fit under the profiler),
   ``export_spectral`` and ``export_sampler`` (``block_outer_sums``), 64
   requests through an 8-slot engine (``descend_score``; valid, mean trials
   within [0.5, 2] x det_ratio_exact), a ``NextItemServer``'s scores and top
   10 on 8 held-out baskets (``bilinear`` on W_J, observed items at -inf),
   ``greedy_map`` of 10, a completion wave of one key a SM on one basket
   (``cholesky_scan``; no observed item taken, mean |Y| within 5 standard
   errors of tr(K_J)) and MPR against the popularity baseline on the
   held-out baskets -> ``{"learned": ...}``;
6. the dynamic catalog at the same width: a ``Catalog`` of the main path's
   factors with 2^20 rows of capacity and 2^20 - 4,096 live items
   (staleness 1) and a ``Telemetry`` (one flight event and one count a
   mutation batch, checked), four timed mutation batches (insert 2,048
   items into the slack, update 1,024, delete 1,024 with the snapshot
   deferred, refresh), the maintained tree held ``torch.equal`` to a full rebuild, then an
   8-slot engine serving 64 cold and 64 timed requests with a
   ``swap_catalog`` to a further-deleted version after its first tick:
   pre-swap requests must equal an engine that never swapped, and no
   request may draw an item deleted in its version -> ``{"catalog": ...}``;
7. the MCMC backend on the main path's spectral state: fixed-size chains
   (k = 8, the main path's mean |Y|) from stochastic-greedy starts, 8
   slots, 64 requests, each result 8 distinct items with det(L_Y) > 0
   -> ``{"mcmc": ...}``;
8. item-axis sharding at the same width on meshes of S = 1 and S = 2
   shards (both on the one card, or on two cards where the host has
   them): 64 rejection requests through ``SamplerEngine(mesh=)`` per S
   (S = 1 and S = 2 equal per rid, valid, mean trials against
   det_ratio_exact; how many rids equal the unsharded main path's, and the
   float64 margin of every descent decision the sharded descent takes
   otherwise than the ``descend_score`` kernel), the catalog's per-item
   qualities L_ii through ``bilinear_sharded``, a meshed ``Catalog``
   through one round of the four mutation batches (its tree, gathered,
   ``torch.equal`` to a sharded rebuild and to the unsharded catalog's
   tree; 16 requests equal at S = 1 and 2) and 16 MCMC requests (S = 1
   and 2 equal) -> one ``{"sharded": ...}`` line;
9. the LM template's training path, with the NDPP phases' memory freed:
   qwen3-1.7b at full width and depth (28 layers, d_model 2,048, GQA 16 /
   8 heads of 128, vocab 151,936, bfloat16, 2.03 B parameters) from the
   port's seeded init, AdamW with the reference defaults, ``lm_batch`` at
   ``SHAPES["train_4k"]``'s sequence of 4,096 with its global batch of 256
   cut to 2 for one card: one cold step, 3 timed ones and one under the
   profiler; every loss finite, the first within 1.5 of ln(V), and the
   flash kernels launched 2 x 28 times a step forward (remat runs each
   layer's forward again in the backward) and 28 times backward, every
   launch on the tensor-core ("wgmma") route -> one ``{"train": ...}``
   line (losses, cold and warm step ms, data ms apart, tokens/s, MFU, the
   profiled step's device busy share, top kernels and flash kernel ms,
   peak device GB, launches by kernel and route), and a plain witness at
   the same size: the
   same seeded init and batches with ``mha_ref`` under autograd in place
   of the flash kernels, step 0's loss, grad norm and every gradient leaf
   on the same params against the kernels', then the witness's own
   steps' losses and grad norms against the kernel run's;
10. the SSM training path, with the qwen3 phase's memory freed:
   mamba2-1.3b at full width and depth (48 FFN-less Mamba2 layers, d_model
   2,048, d_inner 4,096, 64 heads of P = 64, state N = 128, chunk 128,
   vocab 50,280, bfloat16, 1.44 B parameters) through the same steps at
   the same 2 x 4,096: every loss finite, the first within 1.5 of ln(V),
   the SSD kernel launched 2 x 48 times a step forward (remat) and 48
   times backward, every launch, forward and backward, on the tensor-core
   ("wgmma") route ->
   one ``{"train_ssm": ...}`` line (the same readings;
   MFU counts 6 N T + 3 x the SSD forward's own FLOP) with a plain witness
   that runs ``ssd_chunked_ref`` under autograd in place of the kernels,
   both paths in float32 (bf16 rounding alone moves mamba2's step-0
   gradients by more than the witness's tolerance: how far is a reading);
11. each kernel against its plain version at its path's shapes, on inputs
   the paths themselves produced (the main path's tree rows and first
   round's projectors and uniforms; the catalog's update batch; the greedy
   start's score matrices; the sharded descent's leaf blocks and
   projectors; the catalog's rows and X, and the learned path's rows and
   nonsymmetric W_J of a held-out basket; layer 0's q, k, v of a timed
   train step and a seeded dO; layer 0's x, a, B, C of a timed SSM train
   step and a seeded dy; planted faults must fail the attention and SSD
   per-row tolerances), with times, bounds and launch counts by path ->
   one ``{"kernels": [...]}`` line of eleven entries.  The
   ``cholesky_scan`` entry is timed at the wave's full M on its route
   (``ops.route``: "blocked" at R = 200) and, on the same inputs, on the
   "resident" route (one item at a time), with its bound at float32 FMA and
   at the TF32 tensor-core rate; it is held to its plain version by the
   flip rule (decisions equal up to each draw's first flip; p within 1e-4
   of the plain p relative, plus 1e-6 of the largest, before it, and u
   that close to the plain p at it): against the plain scan in float64 on
   4 of the wave's draws over all 2^20 rows (a CUDA graph of the plain
   steps, replayed along the rows), on the first 2^14 rows of every draw
   and on 4 draws of the learned path's completion wave over all its
   rows (which must equal the draws the path took); against the float32
   plain scan on 1,024 seeded rows whose marginals are O(0.1) (there on
   both routes); on the first 2^14 rows and the seeded ones, the rule
   must refuse the plain scan with each planted fault (all
   zeros, the downdate skipped, the denominator's sign flipped, the
   blocked form's rejected pivot left at p).  The ``descend_score
   entry adds its device time from a profiler trace taken right after the
   build on seeded inputs at the main path's shape, the lanes' cluster
   size and how many such clusters the card holds, and two calls equal.  The two flash entries
   hold the tensor-core kernels (``csrc/flash_attn_sm90.cu``, whose SASS
   must show HGMMA) with SDPA's own excess on the same inputs beside
   theirs, and a ``simt`` sub-entry: the float32 route
   (``csrc/flash_attn.cu``) at batch 1, 1,024 positions, within 2e-5.
   The ``score_all`` and ``bilinear`` entries name the quadratic form's
   route (chosen by R in ``quad_form.cuh``: "resident" at R = 200) and must
   have taken it, with the paths' launches by route beside the totals.
   The ``ssd`` and ``ssd_bwd`` entries run the forward's and the
   backward's tensor-core routes at the train shape (``csrc/ssd.cu``'s
   three CUDA kernels each, each counted once in a profiler trace of one
   call at that shape, taken right after the build, HGMMA in the SASS,
   every float32 operand a bf16 pair hi + lo, two calls equal) with the
   float32 SIMT kernel, the other route, timed beside it on the same
   inputs (the forward's chunk-start states held to the SIMT kernel's);
12. the last line: ``{"ok": true, "device": {...}}``.

Any failure exits nonzero (an exception's traceback, or a FAIL line)
before the last line: no GPU, a build or launch error, a parity miss, an
invalid draw.  Times are CUDA-event times of warm
launches on the card this runs on; every number is this run's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

M_ITEMS = 1 << 20          # the paper's M = 1e6, rounded to whole blocks
K_RANK = 100               # the paper's K = 100: R = 2K = 200
BLOCK = 64
N_SLOTS = 8
N_REQUESTS = 64
TARGET_TRIALS = 7.9        # E[#trials] of the ONDPP kernel (Theorem 2): ~8,
                           # below 8 so the automatic n_spec is 8
TARGET_SIZE = 10.0         # E[|Y|] of the proposal DPP
SEED = 0
CAT_CAPACITY = 1 << 20     # the catalog's rows: 16,384 blocks of 64
CAT_SLACK = 4096           # rows not live at build (the insert slack)
CAT_BATCH = 1024           # rows of the update and delete batches
CAT_SWAP_DELETES = 1024    # further deletes of the swapped-in version
CAT_ROUNDS = 2             # rounds of the four batches: cold, then warm
MCMC_K = 8                 # the main path's mean |Y| (7.92), rounded
SHARD_COUNTS = (1, 2)      # the sharded phase's meshes
SHARDED_REQUESTS = 16      # the sharded catalog and MCMC requests
TRAIN_ARCH = "qwen3-1.7b"   # the LM template's train path, full width and depth
TRAIN_SHAPE = "train_4k"    # sequence 4,096; its global batch of 256 ...
TRAIN_BATCH = 2             # ... cut to 2 sequences for one card
TRAIN_STEPS = 3             # timed steps, after one cold step
TRAIN_SSM_ARCH = "mamba2-1.3b"  # the SSM train path, full width and depth
DEVICE = "cuda"
KERNEL_SOURCES = ("tree_sum", "spec_round", "mcmc_score", "bilinear",
                  "flash_attn", "flash_attn_sm90", "ssd", "cholesky_scan")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, fp32 outside tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12   # H100 SXM data sheet, dense TF32 tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` warm calls."""
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


def bound(n_bytes: float, n_flop: float, flop_per_s: float = FP32_FLOP_PER_S):
    """The least time for the work: bytes over HBM's rate or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / flop_per_s * 1e3
    return max(t_bytes, t_flop), ("bytes" if t_bytes >= t_flop else "operations")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_window(fn, track: str = "") -> dict:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA): its wall ms
    (lengthened by the profiler), the ATen operator calls it made (nested
    calls included), the device's kernel ms and launch count in the
    window, the five kernels and host operators that take the most time
    and, with ``track``, the kernels whose names hold it (ms, launches)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _device_us(e) > 0 and e.cpu_time_total == 0]
    host = [e for e in avgs if e.self_cpu_time_total > 0]
    tracked = [e for e in kernels if track and track in e.key]
    return {
        "wall_ms": wall * 1e3,
        "aten_calls": sum(e.count for e in avgs if e.key.startswith("aten::")),
        "device_ms": sum(_device_us(e) for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": [[e.key[:60], _device_us(e) / 1e3, e.count]
                           for e in sorted(kernels, key=_device_us,
                                           reverse=True)[:5]],
        "top_host_ops_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                            for e in sorted(host, reverse=True,
                                            key=lambda e: e.self_cpu_time_total
                                            )[:5]],
        **({"tracked": {"match": track,
                        "ms": sum(_device_us(e) for e in tracked) / 1e3,
                        "kernels_ms": [[e.key[:60], _device_us(e) / 1e3,
                                        e.count] for e in tracked]}}
           if track else {})}


# --------------------------------------------------------------- the kernel
def ondpp_factors(m: int, k: int, seed: int):
    """An ONDPP kernel at the paper's widths: the paper's synthetic features
    (Section 6.2), B orthonormalised (QR, positive diagonal) and V projected
    off B, as the reference's learner constrains them; V scaled so the
    proposal DPP has E|Y| ~ TARGET_SIZE, and one sigma for every pair so
    that E[#trials] = TARGET_TRIALS.  Returns float32 numpy V, B, D."""
    import torch
    from repro_torch.core.types import d_from_sigma
    from repro_torch.data.baskets import synthetic_features

    v, b, _ = synthetic_features(m, k, seed=seed)
    dev = torch.device(DEVICE)
    q, rr = torch.linalg.qr(torch.from_numpy(b).to(dev, torch.float64))
    q = q * torch.sign(torch.diagonal(rr))[None, :]
    vv = torch.from_numpy(v).to(dev, torch.float64)
    vv = vv - q @ (q.T @ vv)
    # (1 + 2s/(s^2+1))^(k/2) = TARGET_TRIALS, small root
    c = TARGET_TRIALS ** (2.0 / k) - 1.0
    s = (1.0 - math.sqrt(1.0 - c * c)) / c
    mu = torch.linalg.eigvalsh(vv.T @ vv).clamp_min(0).cpu().numpy()
    want = TARGET_SIZE - k * s / (1.0 + s)

    def size(a):
        return float(np.sum(a * a * mu / (1.0 + a * a * mu)))

    lo, hi = 1e-6, 1e3
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        lo, hi = (mid, hi) if size(mid) < want else (lo, mid)
    vv = vv * math.sqrt(lo * hi)
    d = d_from_sigma(torch.full((k // 2,), s, dtype=torch.float64))
    return (vv.float().cpu().numpy(), q.float().cpu().numpy(),
            d.float().numpy())


def valid_result(res, m: int, max_trials: int) -> bool:
    """Distinct items in [0, m), a mask that marks exactly the filled
    slots, and accepted within budget or exhausted at it."""
    items, mask = np.asarray(res.items), np.asarray(res.mask)
    chosen = items[mask]
    subset_ok = (np.array_equal(mask, items >= 0) and bool(np.all(chosen < m))
                 and len(set(chosen.tolist())) == chosen.size)
    budget_ok = ((res.accepted and 1 <= res.trials <= max_trials)
                 or (not res.accepted and res.trials == max_trials))
    return bool(subset_ok and budget_ok)


# ------------------------------------------------------------ launch counts
def _count_owners():
    """(kernel name, module, attribute) of every kernel's launch count."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.cholesky_scan import ops as scan_ops
    from repro_torch.kernels.mcmc_score import ops as mcmc_score_ops
    from repro_torch.kernels.spec_round import ops as spec_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.tree_sum import ops as tree_sum_ops

    return (("descend_score", spec_ops, "launches"),
            ("block_outer_sums", tree_sum_ops, "launches"),
            ("gathered_block_grams", tree_sum_ops, "gathered_launches"),
            ("score_all", mcmc_score_ops, "launches"),
            ("bilinear_batched", bilinear_ops, "batched_launches"),
            ("bilinear", bilinear_ops, "launches"),
            ("flash_attention", attn_ops, "launches"),
            ("flash_attention_bwd", attn_ops, "bwd_launches"),
            ("ssd", ssd_ops, "launches"),
            ("ssd_bwd", ssd_ops, "bwd_launches"),
            ("cholesky_scan", scan_ops, "launches"))


def _route_owners():
    """(kernel name, module, {route: attribute}) of every kernel whose
    launches are also counted by route: flash's (``attention/ops.py::
    _route``), the quadratic form's (chosen by R in ``quad_form.cuh``),
    the SSD forward's and backward's (``ssd/ops.py::_fwd_route``,
    ``_bwd_route``) and the Cholesky scan's (``cholesky_scan/ops.py::
    route``).  Each launch adds one to its route's count and to the
    kernel's total."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.cholesky_scan import ops as scan_ops
    from repro_torch.kernels.mcmc_score import ops as mcmc_score_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    quad = {"resident": "resident_launches", "panel": "panel_launches"}
    return (("flash_attention", attn_ops,
             {"wgmma": "wgmma_launches", "simt": "simt_launches"}),
            ("flash_attention_bwd", attn_ops,
             {"wgmma": "wgmma_bwd_launches", "simt": "simt_bwd_launches"}),
            ("score_all", mcmc_score_ops, quad),
            ("bilinear", bilinear_ops, quad),
            ("ssd", ssd_ops,
             {"wgmma": "wgmma_fwd_launches", "simt": "simt_fwd_launches"}),
            ("ssd_bwd", ssd_ops,
             {"wgmma": "wgmma_bwd_launches", "simt": "simt_bwd_launches"}),
            ("cholesky_scan", scan_ops,
             {"blocked": "blocked_launches",
              "resident": "resident_launches"}))


def reset_counts() -> None:
    for _, mod, attr in _count_owners():
        setattr(mod, attr, 0)
    for _, mod, attrs in _route_owners():
        for attr in attrs.values():
            setattr(mod, attr, 0)


def read_counts() -> dict:
    """Every kernel's launches since the last reset, and those of the
    kernels with routes by route, as "score_all.resident",
    "flash_attention.wgmma", ..."""
    counts = {name: getattr(mod, attr) for name, mod, attr in _count_owners()}
    for name, mod, attrs in _route_owners():
        for route, attr in attrs.items():
            counts[f"{name}.{route}"] = getattr(mod, attr)
    return counts


def by_route(counts: dict, name: str) -> dict:
    """Kernel ``name``'s launches by route out of ``read_counts()``."""
    head = name + "."
    return {k[len(head):]: v for k, v in counts.items() if k.startswith(head)}


def route_delta(name: str, fn):
    """``fn()``'s result and kernel ``name``'s launches by route in it."""
    before = by_route(read_counts(), name)
    out = fn()
    after = by_route(read_counts(), name)
    return out, {r: after[r] - before[r] for r in after}


# ----------------------------------------------------------- the main path
def run_main_path():
    import torch
    from repro_torch.core import det_ratio_exact, preprocess
    from repro_torch.kernels.spec_round import ops as spec_ops
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    t0 = time.perf_counter()
    V, B, D = ondpp_factors(M_ITEMS, K_RANK, SEED)
    t_data = time.perf_counter() - t0

    # record the timed run's first descent calls' inputs (step 0 of the
    # first round and two downdated steps) for the parity phase; the wrapped
    # function is the one the main path calls, so its launches count as the
    # main path's
    kernel = spec_ops.descend_score
    captured = []
    recording_on = False

    def recording(nodes, W, block, q, us):
        if recording_on and len(captured) < 3:
            captured.append((q.clone(), us.clone()))
        return kernel(nodes, W, block, q, us)

    def serve(sampler, first_seed):
        eng = SamplerEngine(sampler, n_slots=N_SLOTS)
        for rid in range(N_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=first_seed + rid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t0

    spec_ops.descend_score = recording
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = preprocess(V, B, D, block=BLOCK, device=DEVICE)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        # cold: the first requests pay for solver handles and allocator growth
        cold, cold_out, t_cold = serve(sampler, SEED + 10_000)
        recording_on = True
        eng, out, t_serve = serve(sampler, SEED)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        spec_ops.descend_score = kernel

    expect = float(det_ratio_exact(sampler.sp))
    for what, res in (("cold", cold_out), ("timed", out)):
        check(sorted(res) == list(range(N_REQUESTS)),
              f"{what} engine returned {len(res)} of {N_REQUESTS} requests")
        bad = [rid for rid, r in res.items()
               if not valid_result(r, M_ITEMS, SampleRequest(rid=0).max_trials)]
        check(not bad, f"invalid {what} results for rids {bad[:10]}")
    trials = np.array([r.trials for r in out.values()], np.float64)
    sizes = np.array([int(np.sum(r.mask)) for r in out.values()])
    mean_trials = float(trials.mean())
    check(0.5 * expect <= mean_trials <= 2.0 * expect,
          f"mean trials {mean_trials} outside [0.5, 2] x det_ratio_exact "
          f"{expect}")
    for name in ("descend_score", "block_outer_sums"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    check(len(captured) == 3, "fewer than 3 descent calls were recorded")
    emit({"main_path": {
        "M": M_ITEMS, "K": K_RANK, "R": sampler.tree.R, "block": BLOCK,
        "depth": sampler.tree.depth, "n_slots": N_SLOTS,
        "n_spec": eng.n_spec, "requests": N_REQUESTS,
        "data_s": t_data, "preprocess_s": t_pre, "serve_s": t_serve,
        "ticks": eng.ticks, "requests_per_s": N_REQUESTS / t_serve,
        "ms_per_tick": t_serve / eng.ticks * 1e3,
        "cold_serve_s": t_cold, "cold_ticks": cold.ticks,
        "cold_requests_per_s": N_REQUESTS / t_cold,
        "mean_trials": mean_trials, "det_ratio_exact": expect,
        "accepted": int(sum(r.accepted for r in out.values())),
        "mean_subset_size": float(sizes.mean()),
        "tree_gb": sampler.tree.nodes.numel() * 4 / 1e9,
        "peak_device_gb": peak / 1e9, "launches": launches}})
    return sampler, captured, launches, (V, B, D), out


# ------------------------------------------------------ the front door
SERVE_REQUESTS = 256       # the replayed trace's requests
SERVE_RATE = 200.0         # arrivals a second, above the 60-217 requests/s
                           # the engine sustains: the queue fills
SERVE_MCMC = 32            # of them pinned to the "mcmc" pool
SERVE_MAX_QUEUE = 64
SERVE_DEADLINE_FRAC = 0.25
SERVE_DEADLINE_S = (0.05, 0.5)
SERVE_N_SPEC = 8
SERVE_AB_REQUESTS = 64     # the telemetry A/B's and the FrontDoor's
SERVE_HTTP_REQUESTS = 8
SERVE_TIMEOUT_S = 300.0    # the bound of every wait in the phase


def serve_trace(seed: int) -> list:
    """The replayed trace, made with numpy from ``seed``: (arrival s, rid,
    seed, priority, deadline s after submission or None, pool) by arrival.
    Exponential gaps at SERVE_RATE, priorities {0, 1, 2}, a quarter of the
    requests with deadlines of 50-500 ms, SERVE_MCMC pinned to "mcmc" and
    the rest to "rejection"."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / SERVE_RATE, SERVE_REQUESTS))
    prio = rng.integers(0, 3, SERVE_REQUESTS)
    has_deadline = rng.random(SERVE_REQUESTS) < SERVE_DEADLINE_FRAC
    deadline = rng.uniform(*SERVE_DEADLINE_S, SERVE_REQUESTS)
    mcmc = set(rng.choice(SERVE_REQUESTS, SERVE_MCMC, replace=False).tolist())
    seeds = rng.integers(0, 2 ** 31, SERVE_REQUESTS)
    return [(float(t[i]), i, int(seeds[i]), int(prio[i]),
             float(deadline[i]) if has_deadline[i] else None,
             "mcmc" if i in mcmc else "rejection")
            for i in range(SERVE_REQUESTS)]


def direct_results(sampler, reqs, backend: str) -> dict:
    """{rid: SampleResult} of (rid, seed) pairs submitted straight to a
    fresh engine of ``backend``: the draws a scheduled request must get
    (a draw depends on neither the pool's size nor the admission order)."""
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    if not reqs:
        return {}
    eng = (SamplerEngine(sampler, n_slots=N_SLOTS, n_spec=SERVE_N_SPEC)
           if backend == "rejection"
           else SamplerEngine(sampler, backend="mcmc", mcmc_k=MCMC_K,
                              n_slots=min(len(reqs), 4 * N_SLOTS)))
    for rid, seed in reqs:
        eng.submit(SampleRequest(rid=rid, seed=seed))
    return eng.run()


def replay_wall(sched, trace) -> float:
    """Submit each request of ``trace`` when the wall clock reaches its
    arrival and tick the scheduler whenever it holds work, until it
    drains; returns the seconds it took."""
    import torch
    from repro_torch.serve.scheduler import ServeRequest

    clock = sched.clock
    t0 = clock()
    i = 0
    while i < len(trace) or sched.busy():
        now = clock() - t0
        check(now < SERVE_TIMEOUT_S, f"the replay took over {SERVE_TIMEOUT_S} s")
        while i < len(trace) and trace[i][0] <= now:
            _, rid, seed, prio, deadline_in, pool = trace[i]
            sched.submit(ServeRequest(
                rid=rid, seed=seed, priority=prio, pool=pool,
                deadline=None if deadline_in is None
                else clock() + deadline_in))
            i += 1
        if sched.busy():
            sched.tick()
        elif i < len(trace):
            time.sleep(max(0.0, trace[i][0] - (clock() - t0)))
    torch.cuda.synchronize()
    return clock() - t0


def _pcts(h) -> list:
    """[p50, p99] of a LogHistogram (seconds), None when empty."""
    return [h.percentile(50), h.percentile(99)] if h.count else None


def telemetry_ab(sampler) -> dict:
    """SERVE_AB_REQUESTS requests through an engine without telemetry and
    one with it, timed, then again under ``torch.profiler``: the results
    per rid and the ticks must be equal, and so must a tick's events: the
    CUDA runtime calls by name (the kernel launches in total, the copies,
    the syncs), the ATen operators by name, and by the device's events the
    device-to-host copies and kernel 1's launches.  On the H100 the
    profiler loses a few device events of a window now and then (1 to 3
    elementwise kernels of ~35,000 in most windows, thousands in one),
    never a host event, so a pair of traces that differs is taken
    again, up to TRACE_ATTEMPTS times; a difference that telemetry made
    would show in every pair."""
    import collections

    import torch
    from repro_torch.kernels.spec_round import ops as spec_ops
    from repro_torch.obs import Telemetry
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def run(tel, profiled: bool):
        eng = SamplerEngine(sampler, n_slots=N_SLOTS, n_spec=SERVE_N_SPEC,
                            telemetry=tel)
        for rid in range(SERVE_AB_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=SEED + 50_000 + rid))
        before = spec_ops.launches
        torch.cuda.synchronize()
        ctx = (torch.profiler.profile(activities=acts) if profiled
               else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            out = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        reading = {"ticks": eng.ticks, "tick_ms": wall / eng.ticks * 1e3,
                   "descend_score_wrapper": spec_ops.launches - before}
        if profiled:
            host = collections.Counter()
            dev = collections.Counter()
            for e in prof.key_averages():
                if _device_us(e) > 0 and e.cpu_time_total == 0:
                    dev[e.key] += e.count
                elif e.key.startswith(("cuda", "aten::")):
                    host[e.key] += e.count
            kern = {k: v for k, v in dev.items()
                    if not k.startswith(("Memcpy", "Memset"))}
            reading.update(
                runtime_calls={k: v for k, v in host.items()
                               if k.startswith("cuda")},
                aten_ops=sum(v for k, v in host.items()
                             if k.startswith("aten::")),
                aten_by_name={k: v for k, v in host.items()
                              if k.startswith("aten::")},
                launch_calls=sum(v for k, v in host.items()
                                 if k.startswith("cudaLaunchKernel")),
                device_kernels=sum(kern.values()),
                descend_score=sum(v for k, v in kern.items()
                                  if "descend_score" in k),
                d2h=sum(v for k, v in dev.items() if "DtoH" in k))
        return out, reading

    compared = ("ticks", "descend_score_wrapper", "runtime_calls",
                "aten_by_name", "descend_score", "d2h")
    # timed in turns (bare, telemetry, telemetry, bare): the host's clock
    # drifts within a process
    timed, outs = {"bare": [], "telemetry": []}, {}
    for i, name in enumerate(("bare", "telemetry", "telemetry", "bare")):
        outs[f"{name}_{i}"], reading = run(
            Telemetry() if name == "telemetry" else None, profiled=False)
        timed[name].append(reading)
    attempts = []
    for _ in range(TRACE_ATTEMPTS):
        pair = {}
        for name, make in (("bare", lambda: None), ("telemetry", Telemetry)):
            outs[name + "_traced"], pair[name] = run(make(), profiled=True)
        attempts.append(pair)
        if (pair["bare"]["launch_calls"] and pair["bare"]["d2h"]
                and all(pair["bare"][k] == pair["telemetry"][k]
                        for k in compared)):
            break
    base = outs["bare_0"]
    check(sorted(base) == list(range(SERVE_AB_REQUESTS)),
          f"the bare engine returned {len(base)} of {SERVE_AB_REQUESTS}")
    differ = sorted({rid for o in outs.values() for rid in base
                     if rid not in o or not same_result(o[rid], base[rid])})
    check(not differ, f"telemetry changed the draws of rids {differ[:10]}")
    check(len({r["ticks"] for rs in timed.values() for r in rs}) == 1,
          f"telemetry changed the ticks: {timed}")
    last = attempts[-1]
    summary = {n: {k: r[k] for k in r if k != "aten_by_name"}
               for n, r in last.items()}
    check(last["bare"]["launch_calls"] > 0 and last["bare"]["d2h"] > 0,
          f"the profiler saw no launch or copy in {len(attempts)} traces")
    check(all(last["bare"][k] == last["telemetry"][k] for k in compared),
          f"telemetry changed a tick's events in all {len(attempts)} pairs "
          f"of traces: {summary}")
    per_tick = {n: {k: r[k] / r["ticks"] for k in (
        "launch_calls", "aten_ops", "device_kernels", "descend_score", "d2h")}
        for n, r in last.items()}
    return {"requests": SERVE_AB_REQUESTS,
            "tick_ms": {n: [r["tick_ms"] for r in rs]
                        for n, rs in timed.items()},
            "traced": summary, "per_tick": per_tick,
            "trace_attempts": len(attempts),
            "device_kernels_by_attempt": [
                {n: r["device_kernels"] for n, r in a.items()}
                for a in attempts],
            # per pair of traces, the compared readings that differed
            "differed_by_attempt": [
                {k: [a["bare"][k], a["telemetry"][k]] for k in compared
                 if a["bare"][k] != a["telemetry"][k] and k != "aten_by_name"}
                | ({"aten_by_name": "differs"} if a["bare"]["aten_by_name"]
                   != a["telemetry"]["aten_by_name"] else {})
                for a in attempts],
            "equal": True}


def frontdoor_runs(sampler) -> tuple:
    """SERVE_AB_REQUESTS requests through the asyncio ``FrontDoor`` over an
    8-slot rejection pool, then SERVE_HTTP_REQUESTS ``POST /v1/sample``
    calls through ``serve_http`` on 127.0.0.1 from client threads, and a
    ``GET /v1/metrics``; every answer against a direct submission.  Returns
    (the reading, the kernels' launches in the two runs)."""
    import asyncio
    import concurrent.futures
    import threading
    import urllib.request

    import torch
    from repro_torch.obs import Telemetry
    from repro_torch.serve.frontdoor import FrontDoor, serve_http
    from repro_torch.serve.sampler_engine import SamplerEngine
    from repro_torch.serve.scheduler import Scheduler

    door_reqs = [(rid, SEED + 60_000 + rid) for rid in range(SERVE_AB_REQUESTS)]
    http_reqs = [(1000 + i, SEED + 70_000 + i)
                 for i in range(SERVE_HTTP_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    truth = direct_results(sampler, door_reqs, "rejection")
    torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    truth.update(direct_results(sampler, http_reqs, "rejection"))

    def post(url, rid, seed):
        body = json.dumps({"rid": rid, "seed": seed,
                           "pool": "rejection"}).encode()
        req = urllib.request.Request(url + "/v1/sample", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())

    def get(url, path):
        with urllib.request.urlopen(url + path, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, r.read().decode()

    async def main():
        tel = Telemetry()
        sched = Scheduler({"rejection": SamplerEngine(
            sampler, n_slots=N_SLOTS, n_spec=SERVE_N_SPEC, telemetry=tel)},
            telemetry=tel, max_queue=4 * SERVE_AB_REQUESTS)
        loop = asyncio.get_running_loop()
        out = {}
        async with FrontDoor(sched) as door:
            reset_counts()
            t0 = time.perf_counter()
            res = await asyncio.wait_for(asyncio.gather(*(
                door.sample(seed, rid=rid, pool="rejection")
                for rid, seed in door_reqs)), SERVE_TIMEOUT_S)
            out["door_s"] = time.perf_counter() - t0
            out["door_launches"] = read_counts()
            out["door"] = dict(zip((rid for rid, _ in door_reqs), res))
            srv = serve_http(door, loop, timeout_s=SERVE_TIMEOUT_S)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            url = "http://%s:%d" % srv.server_address
            pool = concurrent.futures.ThreadPoolExecutor(SERVE_HTTP_REQUESTS)
            try:
                reset_counts()
                t0 = time.perf_counter()
                answers = await asyncio.wait_for(asyncio.gather(*(
                    loop.run_in_executor(pool, post, url, rid, seed)
                    for rid, seed in http_reqs)), SERVE_TIMEOUT_S)
                out["http_s"] = time.perf_counter() - t0
                out["http_launches"] = read_counts()
                out["http"] = answers
                out["metrics"] = await asyncio.wait_for(loop.run_in_executor(
                    pool, get, url, "/v1/metrics"), SERVE_TIMEOUT_S)
                out["stats"] = await asyncio.wait_for(loop.run_in_executor(
                    pool, get, url, "/v1/stats"), SERVE_TIMEOUT_S)
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(SERVE_TIMEOUT_S)
                pool.shutdown(wait=True)
        return out

    out = asyncio.run(main())
    door_differ = [rid for rid, _ in door_reqs
                   if not same_result(out["door"][rid], truth[rid])]
    check(not door_differ, f"FrontDoor answers differ from direct "
                           f"submission for rids {door_differ[:10]}")
    http_differ = []
    for (rid, _), (code, body) in zip(http_reqs, out["http"]):
        t = truth[rid]
        if not (code == 200 and body["rid"] == rid
                and body["items"] == t.items[t.mask].tolist()
                and body["trials"] == t.trials
                and body["accepted"] == t.accepted):
            http_differ.append(rid)
    check(not http_differ, f"HTTP answers differ from direct submission for "
                           f"rids {http_differ}")
    code, text = out["metrics"]
    needed = ("ndpp_requests_retired_total", "ndpp_sched_submitted_total",
              "ndpp_sched_admitted_total", "ndpp_sched_queue_wait_seconds")
    check(code == 200 and all(n in text for n in needed),
          f"GET /v1/metrics ({code}) lacks one of {needed}")
    check(out["stats"][0] == 200, "GET /v1/stats failed")
    launches = {k: out["door_launches"][k] + out["http_launches"][k]
                for k in out["door_launches"]}
    return {"requests_per_s": {
        "direct": SERVE_AB_REQUESTS / t_direct,
        "frontdoor": SERVE_AB_REQUESTS / out["door_s"],
        "http": SERVE_HTTP_REQUESTS / out["http_s"]},
        "frontdoor_equal_to_direct": True, "http_equal_to_direct": True,
        "http_requests": SERVE_HTTP_REQUESTS,
        "metrics_exposed": list(needed),
        "stats": json.loads(out["stats"][1])}, launches


def run_serve(sampler):
    """The admission scheduler and the front door over the main path's
    sampler (M = 2^20, R = 200, nothing cut): a seeded trace of
    SERVE_REQUESTS replayed on the wall clock through a ``Scheduler`` over
    a rejection and an MCMC pool that share one ``Telemetry``, every rid's
    outcome checked and every done draw held to direct submission; the
    telemetry A/B; the ``FrontDoor`` and HTTP runs -> one ``{"serve":
    ...}`` line.  Kernel launches are counted around the replay and the
    FrontDoor and HTTP runs."""
    import torch
    from repro_torch.core import det_ratio_exact
    from repro_torch.obs import LogHistogram, Telemetry
    from repro_torch.serve.sampler_engine import SamplerEngine
    from repro_torch.serve.scheduler import SHED_REASONS, Scheduler

    trace = serve_trace(SEED + 0x5E5E)
    tel = Telemetry(flight_capacity=1 << 14)
    pools = {"rejection": SamplerEngine(sampler, n_slots=N_SLOTS,
                                        n_spec=SERVE_N_SPEC, telemetry=tel),
             "mcmc": SamplerEngine(sampler, backend="mcmc", mcmc_k=MCMC_K,
                                   n_slots=N_SLOTS, telemetry=tel)}
    sched = Scheduler(pools, max_queue=SERVE_MAX_QUEUE, on_full="evict",
                      telemetry=tel)
    reset_counts()
    wall = replay_wall(sched, trace)
    launches = read_counts()
    outcomes = sched.outcomes
    check(sorted(outcomes) == list(range(SERVE_REQUESTS)),
          f"{len(outcomes)} of {SERVE_REQUESTS} rids reached an outcome")
    check(sched.stats()["requests"].keys() <= {"done", "shed"},
          f"rids in other states: {sched.stats()['requests']}")
    bad = [rid for rid, o in outcomes.items()
           if not ((o.status == "done" and o.reason is None
                    and o.result is not None)
                   or (o.status == "shed" and o.reason in SHED_REASONS
                       and o.result is None))]
    check(not bad, f"rids {bad[:10]} ended outside done / shed by a reason "
                   f"in {SHED_REASONS}")
    shed_events = {e["rid"] for e in tel.flight.events("sched_shed")}
    shed = [rid for rid, o in outcomes.items() if o.status == "shed"]
    check(tel.flight.dropped == 0 and set(shed) == shed_events
          and all(sched.spans[rid].state == "shed" for rid in shed),
          "a shed rid lacks its flight event or its shed span")
    done = {pool: {rid: o.result for rid, o in outcomes.items()
                   if o.status == "done" and o.pool == pool}
            for pool in ("rejection", "mcmc")}
    check(all(done.values()), f"a pool served nothing: "
                              f"{ {p: len(d) for p, d in done.items()} }")
    by_rid = {rid: seed for _, rid, seed, *_ in trace}
    differ = []
    for pool, res in done.items():
        truth = direct_results(sampler, [(rid, by_rid[rid]) for rid in res],
                               pool)
        differ += [rid for rid in res if not same_result(res[rid],
                                                         truth[rid])]
    check(not differ, f"scheduled draws differ from direct submission for "
                      f"rids {differ[:10]}")
    bad = [rid for rid, r in done["rejection"].items()
           if not valid_result(r, M_ITEMS, 256)]
    bad += invalid_mcmc(sampler.sp, done["mcmc"])
    check(not bad, f"invalid served results for rids {bad[:10]}")
    expect = float(det_ratio_exact(sampler.sp))
    mean_trials = float(np.mean([r.trials for r in
                                 done["rejection"].values()]))
    check(0.5 * expect <= mean_trials <= 2.0 * expect,
          f"served mean trials {mean_trials} outside [0.5, 2] x "
          f"det_ratio_exact {expect}")
    for name in ("descend_score", "score_all"):
        check(launches[name] > 0, f"kernel {name} was not launched in the "
                                  f"serve phase's replay")
    reg = tel.registry
    service = {}
    for pool, res in done.items():
        h = LogHistogram(start=1e-5, factor=2 ** 0.25)
        for rid in res:
            h.observe(sched.spans[rid].service_time)
        service[pool] = _pcts(h)
    shed_by_reason = {reason: int(reg.get("ndpp_sched_shed_total").value(
        reason=reason)) for reason in SHED_REASONS}
    check(sum(shed_by_reason.values()) == len(shed),
          f"ndpp_sched_shed_total {shed_by_reason} against {len(shed)} sheds")
    gc.collect()
    torch.cuda.empty_cache()
    ab = telemetry_ab(sampler)
    door, door_launches = frontdoor_runs(sampler)
    launches = {k: launches[k] + door_launches[k] for k in launches}
    emit({"serve": {
        "M": M_ITEMS, "R": sampler.tree.R, "requests": SERVE_REQUESTS,
        "rate_per_s": SERVE_RATE, "max_queue": SERVE_MAX_QUEUE,
        "on_full": "evict",
        "pools": {"rejection": {"n_slots": N_SLOTS, "n_spec": SERVE_N_SPEC},
                  "mcmc": {"n_slots": N_SLOTS, "k": MCMC_K}},
        "replay_s": wall, "ticks": sched.ticks,
        "done": {p: len(d) for p, d in done.items()},
        "done_per_s": sum(len(d) for d in done.values()) / wall,
        "shed_by_reason": shed_by_reason,
        "done_equal_to_direct": True,
        "mean_trials": mean_trials, "det_ratio_exact": expect,
        "sched_queue_wait_s_p50_p99": _pcts(
            reg.get("ndpp_sched_queue_wait_seconds").data()),
        # the pools are named after their backends
        "latency_s_p50_p99": {p: _pcts(reg.get(
            "ndpp_request_latency_seconds").data(backend=p)) for p in done},
        "service_s_p50_p99": service,
        "tick_s_p50_p99": {p: _pcts(reg.get("ndpp_tick_seconds").data(
            backend=p)) for p in done},
        "flight_events": tel.flight.total,
        "telemetry_free": ab, **door, "launches": launches}})
    return launches


# ------------------------------------------------------------- the kernels
def check_block_outer_sums(sampler, launches):
    import torch
    from repro_torch.kernels.tree_sum import ops, ref

    W, block = sampler.tree.W, sampler.tree.block
    m, r = W.shape
    n = m // block
    got = ops.block_outer_sums(W, block)
    want = ref.block_outer_sums_ref(W, block)
    torch.cuda.synchronize()
    err = (got - want).abs()
    scale = float(want.abs().max())
    tol = 1e-5 * scale          # block * eps32 * |w_i||w_j| <= 4e-6 * scale
    mismatches = int((err > tol).sum())
    same_as_tree = bool(torch.equal(got, sampler.tree.level(sampler.tree.depth)))
    ok = mismatches == 0 and same_as_tree
    wb = W.reshape(n, block, r)
    ms = cuda_ms(lambda: ops.block_outer_sums(W, block), reps=10)
    plain_ms = cuda_ms(lambda: ref.block_outer_sums_ref(W, block), reps=5)
    library_ms = cuda_ms(lambda: torch.bmm(wb.transpose(1, 2), wb), reps=5)
    # Sigma_n is symmetric: the Gram needs block * R(R+1)/2 multiply-adds
    bms, by = bound((m * r + n * r * r) * 4.0, 1.0 * n * block * r * (r + 1))
    entry = {"name": "block_outer_sums", "route": "cuda",
             "source": "src/repro_torch/csrc/tree_sum.cu",
             "replaces": "src/repro/kernels/tree_sum/tree_sum.py:27",
             "launches": launches["block_outer_sums"],
             "max_abs_err": float(err.max()), "tolerance": tol,
             "mismatches": mismatches, "bitwise_equal_to_main_path": same_as_tree,
             "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": by, "library_ms": library_ms,
             "shape": {"n_blocks": n, "block": block, "R": r}}
    del got, want
    torch.cuda.empty_cache()
    return entry


def _tie_margin(nodes, depth, q, us, lane, blk_a, blk_b):
    """Relative float64 margin |u p_all - p_left| / p_all of the decision at
    which two descents of ``lane`` (ending in blocks a and b) part."""
    import torch

    qd = q[lane].double()
    p_all = float((qd * nodes[0].double()).sum())
    idx = 0
    for lvl in range(1, depth + 1):
        left = nodes[(1 << lvl) - 1 + 2 * idx].double()
        p_left = float((qd * left).sum())
        u = float(us[lane, lvl - 1])
        go_a = (blk_a >> (depth - lvl)) & 1
        go_b = (blk_b >> (depth - lvl)) & 1
        if go_a != go_b:
            return abs(u * max(p_all, 1e-30) - max(p_left, 0.0)) / max(
                abs(p_all), 1e-30)
        idx = 2 * idx + go_a
        p_all = max(p_left if go_a == 0 else p_all - p_left, 0.0)
    return math.inf


#: calls of descend_score in its profiler window (``trace_descend_score``)
DESCEND_TRACE_CALLS = 20


def trace_descend_score():
    """Kernel 1 at the main path's shape on seeded inputs, right after the
    build (later in the run the profiler drops a short window's kernels,
    §6 of PERF.md): a tree built by ``construct_tree`` from normal rows
    (M_ITEMS x 2K, blocks of BLOCK) and N_SLOTS x 8 lanes of diagonal
    projectors, each choosing TARGET_SIZE of the 2K eigenvectors, as the
    main path's first step of a round makes them.  Its mean device time
    from a ``torch.profiler`` trace of DESCEND_TRACE_CALLS calls (a trace
    that holds fewer of them is taken again, up to TRACE_ATTEMPTS times:
    the profiler has lost one of the 20 launches in a fresh process's
    first trace), the
    time through the wrapper, the lanes' cluster size and how many such
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``),
    printed once."""
    import torch
    from repro_torch.core.tree import construct_tree
    from repro_torch.kernels.spec_round import ops

    r, n = 2 * K_RANK, N_SLOTS * 8
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    w = torch.randn((M_ITEMS, r), generator=gen, device=DEVICE)
    tree = construct_tree(torch.zeros(r, device=DEVICE), w, block=BLOCK)
    del w
    pick = torch.rand((n, r), generator=gen, device=DEVICE).argsort(
        dim=1)[:, :int(TARGET_SIZE)]
    q = torch.diag_embed(torch.zeros((n, r), device=DEVICE).scatter_(
        1, pick, 1.0)).contiguous()
    us = torch.rand((n, tree.depth), generator=gen, device=DEVICE)

    def call():
        return ops.descend_score(tree.nodes, tree.W, BLOCK, q, us)

    call()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        tracked = profile_window(
            lambda: [call() for _ in range(DESCEND_TRACE_CALLS)],
            "descend_score_kernel")["tracked"]
        traced = sum(k[2] for k in tracked["kernels_ms"])
        if traced == DESCEND_TRACE_CALLS:
            break
    check(traced == DESCEND_TRACE_CALLS,
          f"descend_score's trace holds {traced} of {DESCEND_TRACE_CALLS} "
          f"launches after {attempt} attempts")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c = ops.cluster_size(n, sms)
    active = ops.max_active_clusters(c, r, torch.device(DEVICE))
    print(f"descend_score: {n} lanes in clusters of {c} CTAs on {sms} SMs; "
          f"cudaOccupancyMaxActiveClusters {active}", flush=True)
    out = {"device_ms": tracked["ms"] / traced,
           "ms": cuda_ms(call, reps=50), "trace_attempts": attempt,
           "cluster": c, "max_active_clusters": active, "sms": sms,
           "shape": {"N": n, "R": r, "block": BLOCK, "depth": tree.depth}}
    del tree, q, us
    torch.cuda.empty_cache()
    return out


def check_descend_score(sampler, captured, launches, traced):
    """Kernel 1 on the main path's first recorded descent calls against
    its plain version; ``traced``: ``trace_descend_score()``'s reading."""
    import torch
    from repro_torch.kernels.spec_round import ops, ref

    tree = sampler.tree
    nodes, W, block, depth, r = tree.nodes, tree.W, tree.block, tree.depth, tree.R
    lanes = ties = mismatched = 0
    max_err = worst_rel = 0.0
    first_blk = None
    for q, us in captured:
        blk, sc = ops.descend_score(nodes, W, block, q, us)
        blk_p, sc_p = ref.descend_score_ref(nodes, W, block, q, us)
        torch.cuda.synchronize()
        first_blk = blk.tolist() if first_blk is None else first_blk
        lanes += q.shape[0]
        for lane in (blk != blk_p).nonzero().flatten().tolist():
            margin = _tie_margin(nodes, depth, q, us, lane,
                                 int(blk[lane]), int(blk_p[lane]))
            if margin < 1e-4:
                ties += 1
            else:
                mismatched += 1
        agree = blk == blk_p
        if bool(agree.any()):
            e = float((sc[agree] - sc_p[agree]).abs().max())
            max_err = max(max_err, e)
            worst_rel = max(worst_rel,
                            e / max(float(sc_p[agree].abs().max()), 1e-30))
    ok = mismatched == 0 and ties <= 0.01 * lanes and worst_rel <= 1e-4

    q0, us0 = captured[0]
    n = q0.shape[0]
    once = ops.descend_score(nodes, W, block, q0, us0)
    again = ops.descend_score(nodes, W, block, q0, us0)
    deterministic = all(torch.equal(a, b) for a, b in zip(once, again))
    ok = ok and deterministic
    ms = cuda_ms(lambda: ops.descend_score(nodes, W, block, q0, us0), reps=50)
    plain_ms = cuda_ms(lambda: ref.descend_score_ref(nodes, W, block, q0, us0),
                       reps=10)
    # bytes the first capture's data needs: Q and the uniforms, each distinct
    # node and leaf block its lanes visit read once, ids and scores written
    visited = {0}
    for b in first_blk:
        for lvl in range(1, depth + 1):
            visited.add((1 << lvl) - 1 + 2 * (b >> (depth - lvl + 1)))
    n_bytes = 4.0 * (n * r * r + us0.numel() + len(visited) * r * r
                     + len(set(first_blk)) * block * r + n * block) + 8.0 * n
    n_flop = n * ((depth + 1) * 2.0 * r * r + block * (2.0 * r * r + 2.0 * r))
    bms, by = bound(n_bytes, n_flop)
    return {"name": "descend_score", "route": "cuda",
            "source": "src/repro_torch/csrc/spec_round.cu",
            "replaces": "src/repro/kernels/spec_round/spec_round.py:57",
            "launches": launches["descend_score"],
            "max_abs_err": max_err, "max_err_over_max_score": worst_rel,
            "tolerance": "scores within 1e-4 of the largest |score| on lanes "
                         "whose block ids agree; differing ids only at a "
                         "float64 decision margin < 1e-4, on <= 1% of lanes; "
                         "two calls equal",
            "lanes": lanes, "near_tie_lanes": ties,
            "mismatched_lanes": mismatched, "deterministic": deterministic,
            "ok": ok, "ms": ms, "device_ms": traced["device_ms"],
            "device_ms_of": "the kernel's mean device time in a profiler "
                            "trace of DESCEND_TRACE_CALLS calls at this "
                            "shape on seeded inputs (trace_descend_score), "
                            "right after the build",
            "seeded": {k: traced[k] for k in ("ms", "trace_attempts", "sms",
                                              "shape")},
            "cluster": traced["cluster"],
            "max_active_clusters": traced["max_active_clusters"],
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": {"N": n, "R": r, "block": block, "depth": depth}}


# ------------------------------------------------------ the Cholesky sampler
CHOL_K_SIZE = 10           # the k-NDPP draw's size: the main path's E|Y|
CHOL_BATCH = 8             # requests of the sequential sample_batch
CHOL_PLAIN_M = 1 << 14     # the rows the scan is held to its plain version on
CHOL_DECIDE_M = 1024       # seeded rows whose marginals are O(0.1): every
                           # draw takes ~170 of them


def run_cholesky(sampler):
    """Alg. 1 on the main path's state: ``sample_cholesky_spectral`` on one
    key a SM (a wave: one draw a CTA) and on one key, mean |Y| against
    E|Y| = tr(W Z^T Z), then the samplers that ride on ported kernels: a
    sequential ``sample_batch`` of 8 requests and a ``sample_k_ndpp`` of
    size 10 (``descend_score``), one ``sample_elementary_dense`` draw
    (``bilinear`` over every row at each step).  Returns the path's launch
    counts and the wave's keys, X and W for the kernel check."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import (
        marginal_inner,
        sample_batch,
        sample_cholesky_spectral,
        sample_elementary_dense,
        sample_k_ndpp,
        x_from_sigma,
    )
    from repro_torch.core.rejection import RejectionSample

    sp, tree = sampler.sp, sampler.tree
    m, r = sp.Z.shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    keys = trandom.split(trandom.PRNGKey(SEED + 20_000, device=DEVICE), n_sm)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    wave, t_wave = timed(lambda: sample_cholesky_spectral(sp, keys))
    one, t_one = timed(lambda: sample_cholesky_spectral(sp, keys[0]))
    peak = torch.cuda.max_memory_allocated()
    batch, t_batch = timed(lambda: sample_batch(
        sampler, trandom.PRNGKey(SEED + 30_000, device=DEVICE), CHOL_BATCH))
    kres, t_k = timed(lambda: sample_k_ndpp(
        sampler, CHOL_K_SIZE, trandom.PRNGKey(SEED + 40_000, device=DEVICE)))
    kd = trandom.split(trandom.PRNGKey(SEED + 50_000, device=DEVICE))
    e_mask = trandom.uniform(kd[0], (r,)) < tree.lam / (tree.lam + 1.0)
    (dense, _), t_dense = timed(
        lambda: sample_elementary_dense(tree.W, e_mask, kd[1]))
    launches = read_counts()

    check(wave.shape == (n_sm, m) and wave.dtype == torch.bool,
          f"wave of shape {tuple(wave.shape)}, {wave.dtype}")
    check(torch.equal(one, wave[0]), "one key's draw differs from row 0 of "
          "the wave's")
    # E|Y| = tr(K) and Var|Y| = tr(K) - tr(K^2) for K = Z W Z^T, in float64
    x = x_from_sigma(sp.K, sp.sigma)
    w64 = marginal_inner(sp.Z.double(), x.double())
    kg = w64 @ (sp.Z.double().T @ sp.Z.double())
    expect = float(torch.trace(kg))
    var = expect - float(torch.trace(kg @ kg))
    sizes = torch.cat([wave.sum(1), one.sum()[None]]).double().cpu()
    se = math.sqrt(max(var, 0.0) / sizes.numel())
    mean = float(sizes.mean())
    check(abs(mean - expect) <= 5 * se,
          f"mean |Y| {mean} not within 5 standard errors ({se}) of E|Y| "
          f"{expect}")
    rows = [RejectionSample(*(t[i].cpu() for t in batch))
            for i in range(CHOL_BATCH)]
    bad = [i for i, res in enumerate(rows) if not valid_result(res, m, 1000)]
    check(not bad, f"invalid sample_batch results {bad}")
    kres = RejectionSample(*(t.cpu() for t in kres))
    check(valid_result(kres, m, 1000) and int(kres.mask.sum()) == CHOL_K_SIZE,
          f"sample_k_ndpp gave {int(kres.mask.sum())} items, trials "
          f"{int(kres.trials)}, accepted {bool(kres.accepted)}")
    chosen = dense[dense >= 0].cpu()
    check(chosen.numel() == int(e_mask.sum())
          and len(set(chosen.tolist())) == chosen.numel()
          and bool((chosen < m).all()),
          f"sample_elementary_dense gave {chosen.tolist()} for |E| = "
          f"{int(e_mask.sum())}")
    for name in ("cholesky_scan", "descend_score", "bilinear"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the cholesky path")
    emit({"cholesky": {
        "M": m, "R": r, "draws_a_wave": n_sm, "wave_s": t_wave,
        "draws_per_s": n_sm / t_wave, "one_key_s": t_one,
        "one_key_equal_to_row_0": True, "mean_size": mean,
        "expected_size": expect, "size_standard_error": se,
        "peak_device_gb": peak / 1e9,
        "sample_batch": {"requests": CHOL_BATCH, "s": t_batch,
                         "trials": [int(t.trials) for t in rows],
                         "accepted": sum(bool(t.accepted) for t in rows)},
        "sample_k_ndpp": {"k": CHOL_K_SIZE, "s": t_k,
                          "trials": int(kres.trials),
                          "size": int(kres.mask.sum())},
        "sample_elementary_dense": {"s": t_dense, "size": chosen.numel()},
        "launches": launches}})
    return launches, keys, x


def _hold_scan(zs, W, us, take, p, plain=None):
    """``take, p`` of the kernel against the plain version (``plain``, or
    computed here) by the flip rule (``ref.flip_gaps``), and each planted
    fault of ``ref.FAULTS`` against it too: the rule must refuse every
    one."""
    from repro_torch.kernels.cholesky_scan import ref

    take_r, p_r = plain if plain is not None else ref.cholesky_scan_ref(
        zs, W, us)
    gaps = ref.flip_gaps(take, p, take_r, p_r, us)
    gaps["mean_p"] = float(p_r.mean())
    return gaps, _refusals(zs, W, us, (take_r, p_r))


#: the planted faults that need no loop over the rows, run over all M
FULL_M_FAULTS = ("zeros", "skip_downdate")


def _refusals(zs, W, us, plain, faults=None) -> dict:
    """Each planted fault of ``faults`` (default ``ref.FAULTS``) on the
    rows zs, held to ``plain`` = (take, p) by the flip rule, which must
    refuse it."""
    from repro_torch.kernels.cholesky_scan import ref

    out = {}
    for fault in faults or ref.FAULTS:
        bad = ref.flip_gaps(*ref.planted_scan(zs, W, us, fault), *plain, us)
        out[fault] = {"p_excess": bad["p_excess"],
                      "flip_excess": bad["flip_excess"],
                      "refused": not bad["within"]}
    return out


FLOAT64_DRAWS = 4          # draws held over the full M to a float64 scan
FLOAT64_CHUNK = 256        # the float64 scan's rows a CUDA graph replay


def scan_float64(Z, W, u):
    """The plain scan (``ref.scan_rows_``, ``cholesky_scan_ref``'s steps) in
    float64 over every row of Z for the draws of u: the steps of
    FLOAT64_CHUNK rows captured once in a CUDA graph and replayed along
    the rows, since the plain scan launches ~13 small kernels a row.  The
    rows are padded with zero rows, which change no state and are never
    taken.  Returns (take (N, M) bool, p (N, M) float64)."""
    import torch
    from repro_torch.kernels.cholesky_scan import ref

    m, r = Z.shape
    n, c = u.shape[0], FLOAT64_CHUNK
    pad = (-m) % c
    f64 = dict(dtype=torch.float64, device=Z.device)
    z64 = torch.cat([Z.double(), torch.zeros((pad, r), **f64)])
    u64 = torch.cat([u.double(), torch.ones((n, pad), **f64)], 1)
    q = W.double().expand(n, r, r).clone()
    zc, uc = torch.zeros((c, r), **f64), torch.ones((n, c), **f64)
    tc = torch.empty((n, c), dtype=torch.bool, device=Z.device)
    pc = torch.empty((n, c), **f64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on zero rows: q stays W
        ref.scan_rows_(q, zc, uc, tc, pc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ref.scan_rows_(q, zc, uc, tc, pc)
    take = torch.empty((n, m + pad), dtype=torch.bool, device=Z.device)
    p = torch.empty((n, m + pad), **f64)
    for s in range(0, m + pad, c):
        zc.copy_(z64[s:s + c])
        uc.copy_(u64[:, s:s + c])
        graph.replay()
        take[:, s:s + c].copy_(tc)
        p[:, s:s + c].copy_(pc)
    return take[:, :m], p[:, :m]


def _hold_full_m(Z, W, u):
    """The kernel's draws on uniforms u (FLOAT64_DRAWS, M) over all M rows
    held to ``scan_float64`` on the same inputs by the flip rule, with the
    float64 scan's seconds, and FULL_M_FAULTS over all M held to it too
    (``planted_faults``).  Returns (gaps, the kernel's (take, p), the
    float64 scan's (take, p))."""
    import torch
    from repro_torch.kernels.cholesky_scan import ops, ref

    take, p = ops.cholesky_scan(Z, W, u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    take64, p64 = scan_float64(Z, W, u)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    gaps = ref.flip_gaps(take, p, take64, p64.float(), u)
    gaps.update(draws=u.shape[0], M=Z.shape[0], float64_scan_s=t64,
                takes=int(take.sum()), mean_p=float(p64.mean()),
                planted_faults=_refusals(Z, W, u, (take64, p64.float()),
                                         FULL_M_FAULTS))
    return gaps, (take, p), (take64, p64)


def check_cholesky_scan(sp, keys, x, launches, learned):
    """The scan kernel on the main path's rows and inner matrix with the
    wave's uniforms: timed at full M on its route (``ops.route``) and, on
    the same inputs, on the "resident" route.  It is held by the flip rule
    (``ref.flip_gaps``: decisions equal up to each draw's first flip,
    |p - p_ref| <= RTOL |p_ref| + ATOL_FRAC max|p_ref| before it, a flip
    only where |u - p_ref| is within that) to the plain scan in float64:
    on the wave's first FLOAT64_DRAWS draws over all M rows, on the first
    CHOL_PLAIN_M rows of every draw, and on the learned path's
    completion wave (its first FLOAT64_DRAWS draws over all M conditional
    rows, which must be the draws the path took); on CHOL_DECIDE_M seeded
    rows with marginals of O(0.1), where the draws take items, to the
    float32 plain scan (both routes there).  The rule must refuse each
    planted fault on the main rows, on the decision rows and on the
    learned completions' first CHOL_PLAIN_M rows, and each of
    FULL_M_FAULTS over all M rows of both float64 holds; two calls equal,
    one launch a call.  Two bounds for the same 6 R^2 M FLOP a
    draw: float32 FMA, and the blocked route's three TF32 passes (3xTF32)
    on the tensor cores; the entry's ``bound_ms`` is the route's."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import marginal_inner
    from repro_torch.kernels.cholesky_scan import ops, ref

    Z = sp.Z.contiguous()
    m, r = Z.shape
    W = marginal_inner(Z, x)
    n = keys.shape[0]
    route = ops.route(r)
    u = trandom.uniform(keys, (m,))
    ms = cuda_ms(lambda: ops.cholesky_scan(Z, W, u), reps=1, warmup=0)
    resident_ms = (cuda_ms(lambda: ops._launch("resident", Z, W, u), reps=1,
                           warmup=0) if route != "resident" else ms)
    n_bytes = 4.0 * (m * r + r * r + n * m) + 5.0 * n * m
    n_flop = n * 6.0 * r * r * m
    bound_fma, by_fma = bound(n_bytes, n_flop)
    bound_tf32, by_tf32 = bound(n_bytes, 3 * n_flop, TF32_FLOP_PER_S)
    bms, by = (bound_tf32, by_tf32) if route == "blocked" else (bound_fma,
                                                                by_fma)
    full, _, _ = _hold_full_m(Z, W, u[:FLOAT64_DRAWS].contiguous())
    zs = Z[:CHOL_PLAIN_M].contiguous()
    us = u[:, :CHOL_PLAIN_M].contiguous()
    del u
    before = ops.launches
    take, p = ops.cholesky_scan(zs, W, us)
    once = ops.launches - before
    again = ops.cholesky_scan(zs, W, us)
    deterministic = torch.equal(take, again[0]) and torch.equal(p, again[1])
    plain = ref.cholesky_scan_ref(zs, W, us)
    take64, p64 = ref.cholesky_scan_ref(zs.double(), W.double(), us.double())
    # the gate and the planted faults against float64: the float32 plain
    # version's own rounding grows along the rows (2^14 sequential downdates)
    gaps, faults = _hold_scan(zs, W, us, take, p, (take64, p64.float()))
    vs32 = {name: {k: g[k] for k in ("p_excess", "flip_excess", "max_p_gap")}
            for name, g in (
                ("kernel", ref.flip_gaps(take, p, *plain, us)),
                ("plain_against_float64",
                 ref.flip_gaps(*plain, take64, p64.float(), us)))}
    del take64, p64, plain
    z_c, w_c, u_c, drawn = learned
    lgaps, (ltake, lp), (ltake64, lp64) = _hold_full_m(z_c, w_c, u_c)
    learned_same = all(np.array_equal(np.flatnonzero(t), d)
                       for t, d in zip(ltake.cpu().numpy(), drawn))
    # every planted fault on the completions' first CHOL_PLAIN_M rows, held
    # to the float64 scan's prefix (a prefix of a scan is the scan of it)
    lrows, lfaults = _hold_scan(
        z_c[:CHOL_PLAIN_M].contiguous(), w_c,
        u_c[:, :CHOL_PLAIN_M].contiguous(), ltake[:, :CHOL_PLAIN_M],
        lp[:, :CHOL_PLAIN_M], (ltake64[:, :CHOL_PLAIN_M],
                               lp64[:, :CHOL_PLAIN_M].float()))
    del lp, ltake64, lp64
    zd, wd, ud = ref.random_inputs(CHOL_DECIDE_M, r, n, SEED + 60_000,
                                   DEVICE)
    decide, decide_faults = _hold_scan(zd, wd, ud,
                                       *ops.cholesky_scan(zd, wd, ud))
    resident = ref.flip_gaps(*ops._launch("resident", zd, wd, ud),
                             *ref.cholesky_scan_ref(zd, wd, ud), ud)
    torch.cuda.synchronize()
    refused = all(f["refused"] for fs in (
        faults, decide_faults, lfaults, full["planted_faults"],
        lgaps["planted_faults"]) for f in fs.values())
    ok = (gaps["within"] and full["within"] and lgaps["within"]
          and lrows["within"]
          and learned_same and decide["within"] and resident["within"]
          and refused and deterministic and once == 1)
    ms_small = cuda_ms(lambda: ops.cholesky_scan(zs, W, us), reps=3)
    plain_ms = cuda_ms(lambda: ref.cholesky_scan_ref(zs, W, us), reps=1,
                       warmup=0)
    held = ("p_excess", "flip_excess", "flipped_draws", "compared_takes",
            "max_p_gap", "mean_p")
    return {"name": "cholesky_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/cholesky_scan.cu",
            "replaces": "none: the port's own kernel for the lax.scan of "
                        "src/repro/core/cholesky.py:54 (sample_cholesky_inner)",
            "design": route,
            "launches": launches["cholesky_scan"],
            "launches_by_route": by_route(launches, "cholesky_scan"),
            "max_abs_err": full["max_p_gap"],
            "max_abs_err_of": f"the first {FLOAT64_DRAWS} draws over all "
                              f"M rows against the float64 scan",
            "tolerance": f"decisions equal up to each draw's first flip; "
                         f"before it |p - p_ref| <= {ref.RTOL} |p_ref| + "
                         f"{ref.ATOL_FRAC} max|p_ref|, at it |u - p_ref| "
                         f"within the same (excess <= 1); p_ref the float64 "
                         f"scan's on {FLOAT64_DRAWS} draws over all M rows, "
                         f"on the main path's first {CHOL_PLAIN_M} rows and "
                         f"on {FLOAT64_DRAWS} draws of the learned path's "
                         f"completion wave over all M rows; the float32 "
                         f"plain scan's on {CHOL_DECIDE_M} seeded rows of "
                         f"marginals O(0.1); every planted fault refused "
                         f"(on the main, decision and first {CHOL_PLAIN_M} "
                         f"learned rows; {', '.join(FULL_M_FAULTS)} over "
                         f"all M); "
                         f"two calls equal; one launch a call",
            "full_m_against_float64": {k: full[k] for k in held + (
                "draws", "M", "float64_scan_s", "takes", "within",
                "planted_faults")},
            **{k: gaps[k] for k in held if k != "max_p_gap"},
            "main_rows_against_float32_plain": vs32,
            "learned_completions_against_float64": dict(
                {k: lgaps[k] for k in held + ("draws", "M", "float64_scan_s",
                                              "takes", "within",
                                              "planted_faults")},
                equal_to_the_path_draws=learned_same,
                first_rows={"M": CHOL_PLAIN_M,
                            **{k: lrows[k] for k in held + ("within",)},
                            "planted_faults": lfaults}),
            "decisions": {"shape": {"M": CHOL_DECIDE_M, "N": n, "R": r},
                          **{k: decide[k] for k in held}},
            "resident_decisions": {k: resident[k] for k in
                                   ("p_excess", "flip_excess", "within")},
            "planted_faults": {"main_rows": faults,
                               "decision_rows": decide_faults},
            "deterministic": deterministic, "launches_a_call": once,
            "ok": ok, "ms": ms, "ms_of": f"one call at M = {m}, N = {n}",
            "resident_ms": resident_ms,
            "resident_ms_of": "the resident route (one item at a time) on the "
                              "same inputs in the same process",
            "plain_ms": plain_ms, "ms_at_plain_shape": ms_small,
            "plain_shape": {"M": CHOL_PLAIN_M, "N": n, "R": r},
            "bound_ms": bms, "bound_by": by,
            "bound_fma_ms": bound_fma, "bound_tf32_ms": bound_tf32,
            "bound_of": "6 R^2 M FLOP a draw: at float32 FMA, and as three "
                        "TF32 passes (3xTF32) on the tensor cores; bound_ms "
                        "is the route's",
            "ms_over_bound_fma": ms / bound_fma,
            "ms_over_bound_tf32": ms / bound_tf32,
            "library_ms": None,
            "library": "none (no single PyTorch call)",
            "shape": {"M": m, "N": n, "R": r}}


# ------------------------------------------- learning and next-item serving
LEARN_BASKETS = 4096       # planted baskets: 3,686 to fit, 410 held out
LEARN_K_MAX = 8
LEARN_MINIBATCH = 256
LEARN_STEPS = 20
LEARN_LR = 1e-5            # V's entries are ~3e-4 at M = 2^20 and Adam moves
                           # each by ~lr a step: 20 steps keep sigma, and so
                           # E[#trials], near the main path's ~7.9
LEARN_ORTHO_TOL = 1e-4     # max |B^T B - I| after the last projection
LEARN_VB_TOL = 1e-5        # max |cos(v_i, b_j)| over column pairs after
                           # it: float32 rounding of the projection reads
                           # ~1e-8, unrelated columns of 2^20 rows ~1e-3
LEARN_REQUESTS = 64
SCORED_BASKETS = 8         # held-out baskets scored and ranked
TOP_K = 10
GREEDY_K = 10


def _constraint_gaps(params) -> tuple:
    """max |B^T B - I| and the largest |cosine| between a column of V and
    one of B, max |v_i^T b_j| / (|v_i| |b_j|), in float64."""
    import torch

    b64, v64 = params.B.double(), params.V.double()
    eye = torch.eye(b64.shape[1], dtype=torch.float64, device=b64.device)
    ortho = float((b64.T @ b64 - eye).abs().max())
    norms = v64.norm(dim=0)[:, None] * b64.norm(dim=0)[None, :]
    cos = (v64.T @ b64).abs() / norms.clamp_min(1e-300)
    return ortho, float(cos.max())


def _keep_v(params):
    """A planted fault of the projection: B orthonormalised and sigma made
    positive as ``project_constraints`` does, V's projection off B
    skipped.  The gate on the constraints must refuse a fit run with it."""
    from repro_torch.core.learning import project_constraints
    from repro_torch.core.types import ONDPPParams

    q = project_constraints(params)
    return ONDPPParams(V=params.V, B=q.B, sigma=q.sigma)


def _step_part_ms(params, k_max: int, mb: int) -> dict:
    """The device ms of the step's two solver calls, alone at the step's
    shapes: both slogdets (the minibatch's (mb, k_max, k_max) basket
    kernels and the 2K x 2K normalizer) forward and backward, and the
    projection's QR of B."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = torch.randn((mb, k_max, k_max), generator=gen, device=DEVICE) * 0.1
    ly = (a @ a.transpose(-1, -2) + torch.eye(k_max, device=DEVICE)
          ).requires_grad_(True)
    k = params.K
    z = torch.cat([params.V, params.B], 1)
    lz = (torch.eye(2 * k, device=DEVICE) + z.T @ z).requires_grad_(True)

    def slogdets():
        s = (torch.linalg.slogdet(ly)[1].sum()
             + torch.linalg.slogdet(lz)[1])
        torch.autograd.grad(s, [ly, lz])

    return {"slogdet_ms": cuda_ms(slogdets, reps=5),
            "qr_ms": cuda_ms(lambda: torch.linalg.qr(params.B), reps=3)}


def run_learned(factors):
    """The learned path at M = 2^20, K = 100 (R = 200): ``planted_baskets``
    (4,096 baskets of up to 8 items), ``fit_ondpp`` from the main path's
    ONDPP factors (minibatch 256, 20 AdamW steps, every iterate
    projected), the constraints after the last step (which must refuse
    the same fit with V's projection skipped), then the learned
    kernel served: ``export_spectral``, ``export_sampler`` (kernel 2) and
    64 requests through an 8-slot rejection engine (kernel 1); a
    ``NextItemServer``'s scores and top 10 on held-out baskets and
    ``greedy_map`` (kernel 6 on W_J), a completion wave of one key a SM
    (kernel 9 on the conditional rows, no observed item taken, mean |Y|
    within 5 standard errors of tr(K_J)), and MPR against the popularity
    baseline on the 410 held-out baskets.  Returns the path's launch
    counts and the inputs for holding kernels 6 and 9 on this path."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.convert import ondpp_params_from_numpy
    from repro_torch.core import (
        conditional_inner_matrix,
        det_ratio_exact,
        expected_trials,
        greedy_map,
        marginal_inner,
    )
    from repro_torch.core.learning import (
        item_frequencies,
        ondpp_loss,
        project_constraints,
    )
    from repro_torch.core.map_inference import conditional_rows
    from repro_torch.data.baskets import planted_baskets
    from repro_torch.serve.next_item import NextItemServer
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine
    from repro_torch.train import ndpp as ndpp_mod
    from repro_torch.train.ndpp import (
        BasketTrainConfig,
        export_sampler,
        export_spectral,
        fit_ondpp,
    )

    V, B, D = factors
    m, k = V.shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (tr, te), t_data = timed(lambda: planted_baskets(
        m, LEARN_BASKETS, k_max=LEARN_K_MAX, seed=SEED, device=DEVICE))
    init = ondpp_params_from_numpy(V, B, D[np.arange(0, k, 2),
                                           np.arange(1, k, 2)], device=DEVICE)
    stamps = []
    cfg = BasketTrainConfig(steps=LEARN_STEPS, minibatch=LEARN_MINIBATCH,
                            lr=LEARN_LR, seed=SEED, scan_chunk=1,
                            log_every=1)
    t0 = time.perf_counter()
    res = fit_ondpp(tr, m, k, cfg, init_params=init,
                    log_fn=lambda _: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    # one log a step, after the step's loss reached the host; the first
    # interval also holds the projection of the init and its full-batch loss
    step_s = np.diff([t0] + stamps)
    losses = [float(x) for x in res.losses]
    check(len(losses) == LEARN_STEPS and all(map(math.isfinite, losses))
          and math.isfinite(res.loss_init) and math.isfinite(res.loss_final),
          f"non-finite fit losses {losses} ({res.loss_init}, "
          f"{res.loss_final})")
    check(res.loss_final < res.loss_init,
          f"the fit did not lower the loss: {res.loss_init} -> "
          f"{res.loss_final}")
    params = res.params
    ortho, vb = _constraint_gaps(params)
    check(ortho <= LEARN_ORTHO_TOL and vb <= LEARN_VB_TOL
          and bool((params.sigma >= 0).all()),
          f"constraints after the fit: max|B^T B - I| {ortho}, max |cos(v_i, "
          f"b_j)| {vb}, min sigma {float(params.sigma.min())}")
    # the same fit from the same projected init with V's projection skipped
    # (``_keep_v`` in place of ``project_constraints``): the gate must
    # refuse it
    with swapped((ndpp_mod, "project_constraints", _keep_v)):
        planted = fit_ondpp(tr, m, k, dataclasses.replace(cfg, log_every=0),
                            init_params=project_constraints(init))
    ortho_f, vb_f = _constraint_gaps(planted.params)
    check(vb_f > LEARN_VB_TOL,
          f"the constraint gate passed a fit with V's projection skipped: "
          f"max |cos(v_i, b_j)| {vb_f} <= {LEARN_VB_TOL}")
    del planted
    with torch.no_grad():
        freq = item_frequencies(tr, m)
        full_loss_ms = cuda_ms(lambda: ondpp_loss(params, tr, freq), reps=3)
    parts = _step_part_ms(params, LEARN_K_MAX, LEARN_MINIBATCH)
    warm_ms = float(np.median(step_s[1:])) * 1e3
    # where a step's device time goes: a 2-step fit from the learned
    # parameters under the profiler (with its init's projection and two
    # full-batch losses)
    profiled = profile_window(lambda: fit_ondpp(
        tr, m, k, dataclasses.replace(cfg, steps=2, log_every=0),
        init_params=params))

    sp, t_spec = timed(lambda: export_spectral(params))
    thm2, exact = float(expected_trials(sp)), float(det_ratio_exact(sp))
    del sp
    sampler, t_pre = timed(lambda: export_sampler(params, block=BLOCK))
    eng = SamplerEngine(sampler, n_slots=N_SLOTS)
    for rid in range(LEARN_REQUESTS):
        eng.submit(SampleRequest(rid=rid, seed=SEED + 70_000 + rid))
    out, t_serve = timed(eng.run)
    ticks = eng.ticks
    check(sorted(out) == list(range(LEARN_REQUESTS)),
          f"learned engine returned {len(out)} of {LEARN_REQUESTS}")
    max_trials = SampleRequest(rid=0).max_trials
    bad = [rid for rid, r in out.items()
           if not valid_result(r, m, max_trials)]
    check(not bad, f"invalid learned-kernel results for rids {bad[:10]}")
    mean_trials = float(np.mean([r.trials for r in out.values()]))
    check(0.5 * exact <= mean_trials <= 2.0 * exact,
          f"learned kernel: mean trials {mean_trials} outside [0.5, 2] x "
          f"det_ratio_exact {exact}")
    del sampler, eng

    srv = NextItemServer(params)
    scored = []
    for i in range(SCORED_BASKETS):
        basket = te.items[i][te.mask[i] > 0].tolist()
        s = srv.scores(basket)
        top = srv.top_k(basket, TOP_K)
        fin = torch.isfinite(s)
        ok = (bool(torch.isneginf(s[basket]).all())
              and int(fin.sum()) == m - len(basket)
              and len(top) == TOP_K and not set(top.tolist()) & set(basket)
              and float(s[int(top[0])]) == float(s[fin].max()))
        check(ok, f"held-out basket {i} {basket}: scores or top-{TOP_K} "
                  f"{top.tolist()} malformed")
        scored.append({"basket": basket, "top": top.tolist()})
    basket = scored[0]["basket"]
    scores_ms = cuda_ms(lambda: srv.scores(basket), reps=5)
    picks, t_greedy = timed(lambda: greedy_map(srv.params, GREEDY_K))
    picks = picks.tolist()
    check(len(set(picks)) == GREEDY_K and all(0 <= i < m for i in picks),
          f"greedy_map picks {picks}")
    keys = trandom.split(trandom.PRNGKey(SEED + 80_000, device=DEVICE), n_sm)
    many, t_wave = timed(lambda: srv.complete_many(
        basket, trandom.PRNGKey(SEED + 80_000, device=DEVICE), n_sm))
    check(len(many) == n_sm and not any(set(c.tolist()) & set(basket)
                                        for c in many),
          "a completion took an observed item")
    obs, obs_mask = srv._pad(basket)
    z_c, w_marg = conditional_rows(srv._z, srv._x, obs, obs_mask)
    w64 = marginal_inner(z_c.double(), conditional_inner_matrix(
        srv._z[obs.clamp_min(0)], obs_mask, srv._x).double())
    kg = w64 @ (z_c.double().T @ z_c.double())
    expect = float(torch.trace(kg))
    var = expect - float(torch.trace(kg @ kg))
    sizes = np.array([c.size for c in many], np.float64)
    se = math.sqrt(max(var, 0.0) / sizes.size)
    check(abs(float(sizes.mean()) - expect) <= 5 * se,
          f"completions: mean |Y| {sizes.mean()} not within 5 standard "
          f"errors ({se}) of tr(K_J) {expect}")
    rep, t_mpr = timed(lambda: srv.evaluate_mpr(
        te, trandom.PRNGKey(SEED + 90_000, device=DEVICE), train=tr))
    check(all(map(math.isfinite, (rep.model, rep.frequency))),
          f"MPR {rep.model}, baseline {rep.frequency}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("block_outer_sums", "descend_score", "bilinear",
                 "cholesky_scan"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the learned path")
    w_j = conditional_inner_matrix(srv._z[obs.clamp_min(0)], obs_mask,
                                   srv._x).contiguous()
    emit({"learned": {
        "M": m, "K": k, "R": 2 * k, "baskets": {
            "train": int(tr.items.shape[0]), "test": int(te.items.shape[0]),
            "k_max": LEARN_K_MAX, "data_s": t_data},
        "fit": {"steps": LEARN_STEPS, "minibatch": LEARN_MINIBATCH,
                "lr": LEARN_LR, "losses": losses,
                "loss_init": res.loss_init, "loss_final": res.loss_final,
                "improvement": res.improvement, "fit_s": t_fit,
                "step_ms": [float(x) * 1e3 for x in step_s],
                "first_step_ms": float(step_s[0]) * 1e3,
                "first_step_holds": "the init's projection and its "
                                    "full-batch loss",
                "full_batch_loss_ms": full_loss_ms,
                "warm_step_ms": warm_ms, **parts,
                "slogdet_share": parts["slogdet_ms"] / warm_ms,
                "qr_share": parts["qr_ms"] / warm_ms,
                "parts_of": "each timed alone at the step's shapes",
                "profiled_2_step_fit": profiled},
        "constraints": {"max_btb_minus_i": ortho,
                        "btb_bound": LEARN_ORTHO_TOL,
                        "max_cos_v_b": vb, "cos_bound": LEARN_VB_TOL,
                        "min_sigma": float(params.sigma.min()),
                        "v_projection_skipped": {
                            "max_btb_minus_i": ortho_f, "max_cos_v_b": vb_f,
                            "refused": vb_f > LEARN_VB_TOL}},
        "export": {"spectral_s": t_spec, "sampler_s": t_pre,
                   "expected_trials": thm2, "det_ratio_exact": exact},
        "serve": {"requests": LEARN_REQUESTS, "n_slots": N_SLOTS,
                  "serve_s": t_serve, "ticks": ticks,
                  "mean_trials": mean_trials,
                  "accepted": int(sum(r.accepted for r in out.values())),
                  "mean_subset_size": float(np.mean(
                      [int(np.sum(r.mask)) for r in out.values()]))},
        "next_item": {"scored_baskets": scored, "scores_ms": scores_ms,
                      "greedy_map": {"k": GREEDY_K, "s": t_greedy,
                                     "items": picks},
                      "completions": {"basket": basket, "draws": n_sm,
                                      "wave_s": t_wave,
                                      "mean_size": float(sizes.mean()),
                                      "expected_size": expect,
                                      "size_standard_error": se},
                      "mpr": {"model": rep.model,
                              "frequency": rep.frequency,
                              "lift": rep.lift, "baskets": rep.n_baskets,
                              "s": t_mpr}},
        "peak_device_gb": peak / 1e9, "launches": launches}})
    u = trandom.uniform(keys[:FLOAT64_DRAWS], (m,))
    return launches, {
        "bilinear": (srv._z, w_j),
        "cholesky_scan": (z_c, w_marg, u, many[:FLOAT64_DRAWS])}


# ------------------------------------------------------- the dynamic catalog
def run_catalog(factors):
    """A Catalog from the main path's factors (capacity 2^20 rows, all but
    4,096 of them live, staleness 1), four timed mutation batches, the
    maintained tree against a full rebuild, and an 8-slot engine with a
    catalog swap after its first tick -> one ``{"catalog": ...}`` line."""
    import torch
    from repro_torch.core.dynamic import dual_rows
    from repro_torch.core.tree import construct_tree
    from repro_torch.kernels.tree_sum import ops as tree_sum_ops
    from repro_torch.obs import Telemetry
    from repro_torch.serve.catalog import Catalog
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    V, B, D = factors
    m0 = CAT_CAPACITY - CAT_SLACK
    pool_v, pool_b = V[m0:], B[m0:]          # rows of items not yet listed
    rng = np.random.default_rng(SEED + 1)
    # the update batch's blocks and rows, recorded for the kernel phase
    kernel = tree_sum_ops.gathered_block_grams
    captured = []

    def recording(W, blks, block):
        if not captured:
            captured.append((W, blks.clone(), block))
        return kernel(W, blks, block)

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    cat_tel = Telemetry()
    cat, build_ms = timed(Catalog, V[:m0], B[:m0], D, block=BLOCK,
                          capacity=CAT_CAPACITY, staleness=1, device=DEVICE,
                          telemetry=cat_tel)
    check(cat.capacity == CAT_CAPACITY and cat.m == m0,
          f"catalog capacity {cat.capacity}, live {cat.m}")
    n_ins = CAT_BATCH * 2
    rounds = []
    for rnd in range(CAT_ROUNDS):
        ms = {}
        _, ms["insert"] = timed(cat.insert_items,
                                pool_v[rnd * n_ins:(rnd + 1) * n_ins],
                                pool_b[rnd * n_ins:(rnd + 1) * n_ins])
        check(cat.capacity == CAT_CAPACITY, "an insert batch grew the catalog")
        upd = rng.choice(cat.alive_ids(), size=CAT_BATCH, replace=False)
        src = rng.choice(m0, size=CAT_BATCH, replace=False)   # new factors
        tree_sum_ops.gathered_block_grams = recording
        try:
            _, ms["update"] = timed(cat.update_items, upd, V[src], B[src])
        finally:
            tree_sum_ops.gathered_block_grams = kernel
        gone = rng.choice(cat.alive_ids(), size=CAT_BATCH, replace=False)
        _, ms["delete"] = timed(cat.delete_items, gone)
        check(cat.state().stale, "a delete batch did not defer the snapshot")
        _, ms["refresh"] = timed(cat.refresh)
        rounds.append(ms)
    batch_ms = {k: [r[k] for r in rounds] for k in rounds[0]}
    # where an update batch's time goes, from one more batch under the
    # profiler
    upd = rng.choice(cat.alive_ids(), size=CAT_BATCH, replace=False)
    src = rng.choice(m0, size=CAT_BATCH, replace=False)
    update_profile = profile_window(
        lambda: cat.update_items(upd, V[src], B[src]))
    mutate_launches = read_counts()

    # the maintained live tree against a full rebuild through block_outer_sums
    live = cat._live_prop.tree
    a = dual_rows(cat._sp)
    rebuilt = construct_tree(torch.zeros(a.shape[1], device=a.device), a,
                             block=BLOCK)
    tree_equal = (live.depth == rebuilt.depth and torch.equal(live.W, rebuilt.W)
                  and all(torch.equal(live.level(lvl), rebuilt.level(lvl))
                          for lvl in range(live.depth + 1)))
    check(tree_equal, "the maintained catalog tree differs from a rebuild")
    del a, rebuilt
    torch.cuda.empty_cache()
    # what one copy-on-write costs: the node stack, the dual rows and Z
    cow_ms = cuda_ms(lambda: (live.nodes.clone(), live.W.clone(),
                              cat._sp.Z.clone()), reps=3, warmup=1)

    def serve(st, first_seed, swap=None):
        eng = SamplerEngine(st, n_slots=N_SLOTS)
        for rid in range(N_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=first_seed + rid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if swap is not None:
            eng.step()
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            new_st = swap()                       # a mutation, not serving
            t0 = time.perf_counter()
            eng.swap_catalog(new_st)
        out = eng.run()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0 + (t_first if swap is not None else 0.0)
        return eng, out, t

    before = cat.state()
    alive_before = cat._alive.copy()
    pre_swap = set(range(N_SLOTS))                # admitted at the first tick
    swap_deleted = rng.choice(cat.alive_ids(), size=CAT_SWAP_DELETES,
                              replace=False)

    def swap():
        cat.delete_items(swap_deleted)
        return cat.state()

    serve(before, SEED + 20_000)                  # cold: other seeds
    reset_counts()
    eng, out, t_serve = serve(before, SEED, swap=swap)
    serve_launches = read_counts()
    after = cat.state()
    check(after.stale and after.version == before.version + 1,
          "the swapped-in version is not the stale delete version")
    _, never, _ = serve(before, SEED)
    peak = torch.cuda.max_memory_allocated()

    check(sorted(out) == list(range(N_REQUESTS)),
          f"catalog engine returned {len(out)} of {N_REQUESTS} requests")
    bad = [rid for rid, r in out.items()
           if not valid_result(r, CAT_CAPACITY, SampleRequest(rid=0).max_trials)]
    check(not bad, f"invalid catalog results for rids {bad[:10]}")
    differ = [rid for rid in pre_swap
              if not (np.array_equal(out[rid].items, never[rid].items)
                      and np.array_equal(out[rid].mask, never[rid].mask)
                      and out[rid].trials == never[rid].trials)]
    check(not differ, f"pre-swap requests {differ} differ from an engine "
                      f"that never swapped")
    alive_after = cat._alive
    hits = [rid for rid, r in out.items()
            if not (alive_before if rid in pre_swap
                    else alive_after)[r.items[r.mask]].all()]
    check(not hits, f"requests {hits[:10]} drew an item not live in their "
                    f"catalog version")
    post = [r.trials for rid, r in out.items() if rid not in pre_swap]
    mean_trials = float(np.mean(post))
    expect = after.expected_trials()
    check(0.5 * expect <= mean_trials <= 2.0 * expect,
          f"post-swap mean trials {mean_trials} outside [0.5, 2] x "
          f"expected_trials_dynamic {expect}")
    launches = {k: mutate_launches[k] + serve_launches[k]
                for k in mutate_launches}
    for name in ("block_outer_sums", "gathered_block_grams", "descend_score"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the catalog path")
    # the catalog's telemetry: one event and one count a mutation batch
    mutations = {op: int(v) for (op,), v in cat_tel.registry.get(
        "ndpp_catalog_mutations_total").labelsets()}
    want = {"build": 1, "insert": CAT_ROUNDS, "update": CAT_ROUNDS + 1,
            "delete": CAT_ROUNDS + 1, "refresh": CAT_ROUNDS}
    check(mutations == want and len(cat_tel.flight) == sum(want.values()),
          f"catalog telemetry counted {mutations}, "
          f"{len(cat_tel.flight)} events; want {want}")
    emit({"catalog": {
        "capacity": CAT_CAPACITY, "live_items": m0, "R": live.R,
        "block": BLOCK, "staleness": 1, "build_ms": build_ms,
        "batch_rows": {"insert": n_ins, "update": CAT_BATCH,
                       "delete": CAT_BATCH, "refresh": 0},
        "batch_ms": batch_ms, "copy_on_write_ms": cow_ms,
        "copy_on_write_share": {k: [cow_ms / t for t in v]
                                for k, v in batch_ms.items() if k != "refresh"},
        "update_profile": update_profile,
        "tree_equal_to_rebuild": tree_equal,
        "n_slots": N_SLOTS, "n_spec": eng.n_spec, "requests": N_REQUESTS,
        "swap_deletes": CAT_SWAP_DELETES, "ticks": eng.ticks,
        "serve_s": t_serve, "requests_per_s": N_REQUESTS / t_serve,
        "post_swap_mean_trials": mean_trials,
        "expected_trials_dynamic": expect,
        "pre_swap_equal_to_never_swapped": True,
        "telemetry_mutations": mutations,
        "peak_device_gb": peak / 1e9, "launches": launches}})
    del eng, out, never, before, after, live
    return cat, captured, launches


def check_gathered_block_grams(captured, launches):
    import torch
    from repro_torch.kernels.tree_sum import ops, ref

    W, blks, block = captured[0]
    m, r = W.shape
    nb = blks.shape[0]
    got = ops.gathered_block_grams(W, blks, block)
    want = ref.gathered_block_grams_ref(W, blks, block)
    full = ops.block_outer_sums(W, block)         # every block of the same W
    torch.cuda.synchronize()
    equal_full = bool(torch.equal(got, full[blks]))
    del full
    err = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    mismatches = int((err > tol).sum())
    ms = cuda_ms(lambda: ops.gathered_block_grams(W, blks, block), reps=20)
    plain_ms = cuda_ms(lambda: ref.gathered_block_grams_ref(W, blks, block),
                       reps=10)
    row_idx = (blks[:, None] * block
               + torch.arange(block, device=W.device)).reshape(-1)

    def library():
        wb = W.index_select(0, row_idx).view(nb, block, r)
        return torch.bmm(wb.transpose(1, 2), wb)

    library_ms = cuda_ms(library, reps=10)
    bms, by = bound(nb * (block * r + r * r) * 4.0,
                    1.0 * nb * block * r * (r + 1))
    return {"name": "gathered_block_grams", "route": "cuda",
            "source": "src/repro_torch/csrc/tree_sum.cu",
            "replaces": "src/repro/kernels/tree_sum/tree_sum.py:54",
            "launches": launches, "max_abs_err": float(err.max()),
            "tolerance": tol, "mismatches": mismatches,
            "bitwise_equal_to_plain": bool(torch.equal(got, want)),
            "bitwise_equal_to_block_outer_sums": equal_full,
            "ok": equal_full and mismatches == 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library": "index_select of the rows, then torch.bmm",
            "shape": {"blocks": nb,
                      "distinct_blocks": int(torch.unique(blks).shape[0]),
                      "block": block, "R": r, "W_rows": m}}


# -------------------------------------------------------------------- MCMC
def invalid_mcmc(sp, out) -> list:
    """Rids whose result is not MCMC_K distinct items in [0, M) with
    det(L_Y) > 0 (float64)."""
    import torch

    m = sp.Z.shape[0]
    x = sp.x_matrix().double()
    bad = []
    for rid, r in out.items():
        y = r.items[r.mask].astype(np.int64)
        ok = (r.accepted and len(y) == MCMC_K and len(set(y.tolist())) == MCMC_K
              and bool(np.all((y >= 0) & (y < m))))
        if ok:
            zy = sp.Z[torch.as_tensor(y, device=sp.Z.device)].double()
            ok = float(torch.linalg.det(zy @ x @ zy.T)) > 0
        if not ok:
            bad.append(rid)
    return bad


def run_mcmc(sp):
    """The fixed-size MCMC backend on the main path's spectral state
    (M = 2^20, R = 200), k = MCMC_K, 8 slots, default burn-in and thin ->
    one ``{"mcmc": ...}`` line."""
    import torch
    from repro_torch.core import mcmc as mcmc_core
    from repro_torch.kernels.mcmc_score import ops as score_ops
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    run_chains = mcmc_core.run_chains
    score_all = score_ops.score_all
    accepts = []
    captured = []

    def recording_chains(*a, **kw):
        out = run_chains(*a, **kw)
        accepts.append(out[3].float().mean())
        return out

    def recording_scores(Z, A):
        if len(captured) < MCMC_K:
            captured.append(A.clone())
        return score_all(Z, A)

    def serve(first_seed, n):
        eng = SamplerEngine(sp, backend="mcmc", mcmc_k=MCMC_K,
                            n_slots=N_SLOTS)
        for rid in range(n):
            eng.submit(SampleRequest(rid=rid, seed=first_seed + rid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t0

    serve(SEED + 30_000, N_SLOTS)                 # cold: other seeds
    mcmc_core.run_chains = recording_chains
    score_ops.score_all = recording_scores
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        eng, out, t_serve = serve(SEED, N_REQUESTS)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        mcmc_core.run_chains = run_chains
        score_ops.score_all = score_all

    m = sp.Z.shape[0]
    check(sorted(out) == list(range(N_REQUESTS)),
          f"MCMC engine returned {len(out)} of {N_REQUESTS} requests")
    bad = invalid_mcmc(sp, out)
    check(not bad, f"invalid MCMC results for rids {bad[:10]}")
    check(launches["score_all"] > 0, "kernel score_all was not launched on "
                                     "the MCMC path")
    keys = torch.from_numpy(eng.slot_key.astype(np.int64)).to(sp.Z.device)
    tick_profile = profile_window(lambda: run_chains(
        sp, keys, eng._states, n_steps=eng.mcmc_steps_per_tick, fixed=True,
        p_swap=eng.mcmc_p_swap, refresh_every=eng.mcmc_refresh_every))
    harvest_ms = time_mcmc_harvest(sp, eng, keys)
    # the refresh's batched inverse (MAGMA getrf/getri through inv_ex) on
    # the engine's chains, alone: wall ms a call, then one profiled call
    ly = mcmc_core._padded_l(sp.Z, sp.x_matrix(), eng._states.items,
                             eng._states.mask)
    mcmc_core._inv(ly)
    inv_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcmc_core._inv(ly)
        torch.cuda.synchronize()
        inv_ms.append((time.perf_counter() - t0) * 1e3)
    inv_profile = profile_window(lambda: mcmc_core._inv(ly))
    greedy_ms = []
    for seed in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._init_chain_state(SEED + 40_000 + seed)
        torch.cuda.synchronize()
        greedy_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"mcmc": {
        "M": m, "R": sp.Z.shape[1], "k": MCMC_K, "n_slots": N_SLOTS,
        "burn_in": eng.mcmc_burn_in, "thin": eng.mcmc_thin,
        "steps_per_tick": eng.mcmc_steps_per_tick, "requests": N_REQUESTS,
        "ticks": eng.ticks, "serve_s": t_serve,
        "requests_per_s": N_REQUESTS / t_serve,
        "ms_per_tick": t_serve / eng.ticks * 1e3,
        "ms_per_greedy_start": greedy_ms,
        "mean_acceptance": float(torch.stack(accepts).mean()),
        "tick_profile": tick_profile,
        "refresh_every": eng.mcmc_refresh_every,
        "inv_shape": list(ly.shape), "inv_ms": inv_ms,
        "inv_profile": inv_profile, "harvest_ms": harvest_ms,
        "peak_device_gb": peak / 1e9, "launches": launches}})
    return captured, launches, out


HARVEST_REPS = 10


def time_mcmc_harvest(sp, eng, keys) -> dict:
    """Wall ms of the MCMC tick's one device-to-host copy on one tick's
    traces, in turns: the items and masks alone, and with the acceptance
    trace packed beside them as ``SamplerEngine._step_mcmc`` packs it, with
    or without telemetry (one cast more a tick: its cost to the bare
    engine)."""
    import torch
    from repro_torch.core import mcmc as mcmc_core

    _, items_tr, mask_tr, acc_tr = mcmc_core.run_chains(
        sp, keys, eng._states, n_steps=eng.mcmc_steps_per_tick, fixed=True,
        p_swap=eng.mcmc_p_swap, refresh_every=eng.mcmc_refresh_every)

    def harvest(with_acc: bool):
        parts = [items_tr, mask_tr.long()]
        if with_acc:
            parts.append(acc_tr.long()[..., None])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cat(parts, dim=2).cpu().numpy()
        return (time.perf_counter() - t0) * 1e3

    out = {"items_mask": [], "with_acceptance": [],
           "shape": list(items_tr.shape)}
    harvest(False), harvest(True)                 # warm
    for _ in range(HARVEST_REPS):
        for name, flag in (("items_mask", False), ("with_acceptance", True),
                           ("with_acceptance", True), ("items_mask", False)):
            out[name].append(harvest(flag))
    for name in ("items_mask", "with_acceptance"):
        out[name + "_median"] = float(np.median(out[name]))
    return out


def check_score_all(sp, captured, launches):
    import torch
    from repro_torch.kernels.mcmc_score import ops, ref

    Z = sp.Z
    m, r = Z.shape

    def one(A, reps):
        c = A.shape[0]
        got, routes = route_delta("score_all", lambda: ops.score_all(Z, A))
        want = ref.score_all_ref(Z, A)
        torch.cuda.synchronize()
        # per chain: the greedy rounds' scores differ in scale by orders of
        # magnitude, so each chain's error is held to its own largest score
        scale = want.abs().amax(dim=1)
        err = (got - want).abs().amax(dim=1)
        ms = cuda_ms(lambda: ops.score_all(Z, A), reps=reps)
        plain_ms = cuda_ms(lambda: ref.score_all_ref(Z, A), reps=reps)
        library_ms = cuda_ms(lambda: ((Z @ A) * Z).sum(-1), reps=reps)
        # a quadratic form sees only A's symmetric part: R^2 to symmetrize
        # each A_c, then R(R+1)/2 multiply-adds a row over i <= j
        bms, by = bound((m * r + c * r * r + c * m) * 4.0,
                        1.0 * c * m * r * (r + 1) + 1.0 * c * r * r)
        return {"C": c, "max_abs_err": float(err.max()),
                "max_err_over_chain_max_score": float((err / scale).max()),
                "max_abs_score_by_chain": scale.tolist(),
                "route_launches": routes,
                "ok": bool((err <= 1e-4 * scale).all())
                and routes == {"resident": 1, "panel": 0}, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": library_ms}

    c1 = one(captured[-1][:1].contiguous(), reps=10)
    c8 = one(torch.cat(captured[:8]).contiguous(), reps=3)
    return {"name": "score_all", "route": "cuda",
            "source": "src/repro_torch/csrc/mcmc_score.cu",
            "replaces": "src/repro/kernels/mcmc_score/mcmc_score.py:32",
            "quad_route": "resident", "route_launches": c1["route_launches"],
            "launches": launches, "max_abs_err": c1["max_abs_err"],
            "tolerance": "each chain within 1e-4 of its largest |score|; "
                         "the resident route",
            "ok": c1["ok"] and c8["ok"], "ms": c1["ms"],
            "plain_ms": c1["plain_ms"], "bound_ms": c1["bound_ms"],
            "bound_by": c1["bound_by"], "library_ms": c1["library_ms"],
            "library": "((Z @ A_c) * Z).sum(-1), two calls",
            "shape": {"C": 1, "M": m, "R": r}, "at_C8": c8}


# ---------------------------------------------------------------- sharding
def sampler_mesh(n: int):
    """n shards on n cards where the host has them, else all on cuda:0."""
    import torch
    from repro_torch.launch.mesh import make_sampler_mesh

    if torch.cuda.device_count() >= n:
        return make_sampler_mesh(n)
    return make_sampler_mesh(devices=["cuda:0"] * n)


def same_result(a, b) -> bool:
    return (np.array_equal(a.items, b.items) and np.array_equal(a.mask, b.mask)
            and a.trials == b.trials and a.accepted == b.accepted)


def run_sharded_rejection(sampler, main_out):
    """The main path's sampler placed on meshes of S = 1 and 2 (views of
    its arrays: the shards share the card), 64 requests each with the main
    path's seeds; the S = 2 run's descents and leaf blocks are recorded for
    the tie analysis and the kernel phase.  After each engine run, the
    per-item qualities of the placed rows through ``bilinear_sharded``, a
    public op that no engine calls, counted apart.  Returns the line's
    rejection part, the engine's and the qualities' counts, the records
    and the S = 2 mesh."""
    import torch
    from repro_torch.core import det_ratio_exact
    from repro_torch.core import tree as tree_mod
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.serve import sampler_engine as engine_mod
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    descend, leaf = tree_mod._descend_batch, tree_mod._leaf_scores_batch
    fused = engine_mod._spec_round_fused
    descents, leaves, ticks = [], [], []
    eng = None

    def rec_descend(tree, q, us):
        blk = descend(tree, q, us)
        if recording:
            descents.append((q.clone(), us.clone(), blk.clone()))
        return blk

    def rec_leaf(w_blk, q):
        if recording and not leaves:
            leaves.append((w_blk.clone(), q.clone()))
        return leaf(w_blk, q)

    def rec_round(*a, **kw):
        if recording:     # (first descent of the tick, the slots' rids)
            ticks.append((len(descents), [None if r is None else r.rid
                                          for r in eng.slot_req]))
        return fused(*a, **kw)

    expect = float(det_ratio_exact(sampler.sp))
    part, outs, launches, q_launches = {}, {}, {}, {}
    for n in SHARD_COUNTS:
        mesh = sampler_mesh(n)
        recording = n == max(SHARD_COUNTS)
        tree_mod._descend_batch, tree_mod._leaf_scores_batch = (rec_descend,
                                                                rec_leaf)
        engine_mod._spec_round_fused = rec_round
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            eng = SamplerEngine(sampler, n_slots=N_SLOTS, mesh=mesh)
            for rid in range(N_REQUESTS):
                eng.submit(SampleRequest(rid=rid, seed=SEED + rid))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run()
            torch.cuda.synchronize()
            t_serve = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            tree_mod._descend_batch, tree_mod._leaf_scores_batch = descend, leaf
            engine_mod._spec_round_fused = fused
        # per-item qualities L_ii = z_i^T X z_i = |v_i|^2 over the sharded
        # catalog rows, through the public bilinear_sharded
        reset_counts()
        sp = eng.sampler.sp
        quality = bilinear_ops.bilinear_sharded(sp.Z, sp.x_matrix(), mesh)
        q_launches[n] = read_counts()
        check(q_launches[n]["bilinear"] > 0,
              f"kernel bilinear was not launched by bilinear_sharded (S={n})")
        z = sampler.sp.Z
        want_q = (z[:, :K_RANK] ** 2).sum(dim=1)
        q_err = float((quality - want_q).abs().max())
        check(q_err <= 1e-4 * float(want_q.abs().max()),
              f"S={n}: item qualities off by {q_err}")
        check(sorted(out) == list(range(N_REQUESTS)),
              f"S={n}: sharded engine returned {len(out)} requests")
        bad = [rid for rid, r in out.items()
               if not valid_result(r, M_ITEMS, SampleRequest(rid=0).max_trials)]
        check(not bad, f"S={n}: invalid sharded results for rids {bad[:10]}")
        mean_trials = float(np.mean([r.trials for r in out.values()]))
        check(0.5 * expect <= mean_trials <= 2.0 * expect,
              f"S={n}: mean trials {mean_trials} outside [0.5, 2] x "
              f"det_ratio_exact {expect}")
        check(counts["bilinear_batched"] > 0,
              f"kernel bilinear_batched was not launched on the sharded "
              f"path (S={n})")
        outs[n], launches[n] = out, counts
        part[str(n)] = {
            "shards": n, "devices": [str(d) for d in mesh.devices],
            "n_spec": eng.n_spec, "ticks": eng.ticks, "serve_s": t_serve,
            "requests_per_s": N_REQUESTS / t_serve,
            "ms_per_tick": t_serve / eng.ticks * 1e3,
            "mean_trials": mean_trials, "quality_max_abs_err": q_err,
            "equal_to_unsharded": sum(same_result(out[r], main_out[r])
                                      for r in out),
            "peak_device_gb": peak / 1e9, "launches": counts,
            "item_quality_launches": q_launches[n]}
    differ = [r for r in range(N_REQUESTS)
              if not same_result(outs[1][r], outs[2][r])]
    check(not differ, f"rids {differ[:10]} differ between S = 1 and S = 2")

    # the sharded descent (torch operations) against the descend_score
    # kernel on the same projectors and uniforms: every lane that parts
    # is a decision the two round differently; its float64 margin, and for
    # each rid the first one
    from repro_torch.kernels.spec_round import ops as spec_ops

    tree = sampler.tree
    lanes = parted = 0
    first_margin = {}
    for i, (q, us, blk) in enumerate(descents):
        blk_k, _ = spec_ops.descend_score(tree.nodes, tree.W, tree.block, q, us)
        lanes += q.shape[0]
        start, rids = max((t for t in ticks if t[0] <= i), key=lambda t: t[0])
        for lane in (blk != blk_k).nonzero().flatten().tolist():
            parted += 1
            rid = rids[lane // eng.n_spec]
            if rid is not None and rid not in first_margin:
                first_margin[rid] = _tie_margin(
                    tree.nodes, tree.depth, q, us, lane, int(blk[lane]),
                    int(blk_k[lane]))
    part.update({
        "equal_S1_S2": True, "descent_lanes": lanes,
        "parted_lanes": parted,
        "first_parting_margin_by_rid": {
            str(r): m for r, m in sorted(first_margin.items())},
        "rids_differing_from_unsharded": [
            r for r in range(N_REQUESTS)
            if not same_result(outs[2][r], main_out[r])]})
    check(all(m < 1e-4 for m in first_margin.values()),
          f"the sharded descent parts from the kernel's away from a near "
          f"tie: {first_margin}")
    return part, launches, q_launches, descents, leaves[0], sampler_mesh(2)


def run_sharded_catalog(factors):
    """One round of the four mutation batches on an unsharded catalog and
    on meshed ones (S = 2 timed, then S = 1), the S = 2 tree against a
    sharded rebuild and the unsharded tree, and 16 requests per catalog.
    Returns the line's catalog part and the counts of the meshed runs."""
    import torch
    from repro_torch.core.dynamic import build_dual_proposal
    from repro_torch.core.types import SpectralNDPP
    from repro_torch.models import sharding as msh
    from repro_torch.serve.catalog import Catalog
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    V, B, D = factors
    m0 = CAT_CAPACITY - CAT_SLACK
    rng = np.random.default_rng(SEED + 2)
    n_ins = CAT_BATCH * 2
    upd = rng.choice(m0, size=CAT_BATCH, replace=False)
    src = rng.choice(m0, size=CAT_BATCH, replace=False)
    gone = rng.choice(np.setdiff1d(np.arange(m0), upd), size=CAT_BATCH,
                      replace=False)

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def build_and_mutate(mesh):
        cat = Catalog(V[:m0], B[:m0], D, block=BLOCK, capacity=CAT_CAPACITY,
                      staleness=1, device=DEVICE, mesh=mesh)
        ms = {"insert": timed(cat.insert_items, V[m0:m0 + n_ins],
                              B[m0:m0 + n_ins]),
              "update": timed(cat.update_items, upd, V[src], B[src]),
              "delete": timed(cat.delete_items, gone),
              "refresh": timed(cat.refresh)}
        return cat, ms

    def serve(cat):
        eng = SamplerEngine(cat, n_slots=N_SLOTS)
        for rid in range(SHARDED_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=SEED + 50_000 + rid))
        return eng.run()

    def level_rows(tree, lvl):
        return msh.full_rows(tree.level(lvl))

    def trees_equal(a, b):
        return (a.depth == b.depth
                and torch.equal(msh.full_rows(a.W), msh.full_rows(b.W))
                and all(torch.equal(level_rows(a, lvl), level_rows(b, lvl))
                        for lvl in range(a.depth + 1)))

    plain, _ = build_and_mutate(None)
    plain_tree = plain._live_prop.tree
    plain_out = serve(plain)
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    part, outs, launches = {}, {}, {}
    for n in sorted(SHARD_COUNTS, reverse=True):
        mesh = sampler_mesh(n)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        cat, ms = build_and_mutate(mesh)
        outs[n] = serve(cat)
        launches[n] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        entry = {"batch_ms": ms, "peak_device_gb": peak / 1e9,
                 "launches": launches[n]}
        if n == 2:
            live = cat._live_prop.tree
            rebuilt = build_dual_proposal(
                SpectralNDPP(Z=msh.full_rows(cat._sp.Z), sigma=cat._sp.sigma),
                BLOCK, mesh=mesh).tree
            entry["tree_equal_to_sharded_rebuild"] = trees_equal(live, rebuilt)
            entry["tree_equal_to_unsharded"] = trees_equal(live, plain_tree)
            check(entry["tree_equal_to_sharded_rebuild"],
                  "the maintained sharded tree differs from a sharded rebuild")
            check(entry["tree_equal_to_unsharded"],
                  "the maintained sharded tree differs from the unsharded "
                  "catalog's tree")
            del live, rebuilt
        for name in ("gathered_block_grams", "bilinear_batched"):
            check(launches[n][name] > 0, f"kernel {name} was not launched on "
                                         f"the sharded catalog (S={n})")
        bad = [rid for rid, r in outs[n].items()
               if not valid_result(r, CAT_CAPACITY,
                                   SampleRequest(rid=0).max_trials)]
        check(sorted(outs[n]) == list(range(SHARDED_REQUESTS)) and not bad,
              f"S={n}: sharded catalog results missing or invalid {bad[:10]}")
        entry["equal_to_unsharded"] = sum(
            same_result(outs[n][r], plain_out[r]) for r in outs[n])
        part[str(n)] = entry
        del cat
        gc.collect()
        torch.cuda.empty_cache()
    differ = [r for r in range(SHARDED_REQUESTS)
              if not same_result(outs[1][r], outs[2][r])]
    check(not differ, f"catalog rids {differ} differ between S = 1 and 2")
    part["equal_S1_S2"] = True
    part["requests"] = SHARDED_REQUESTS
    return part, launches


def run_sharded_mcmc(sp, mcmc_out):
    """16 fixed-size MCMC requests (the MCMC phase's seeds) at S = 1 and 2.
    Returns the line's MCMC part and the counts."""
    import torch
    from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

    part, outs, launches = {}, {}, {}
    for n in SHARD_COUNTS:
        mesh = sampler_mesh(n)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        eng = SamplerEngine(sp, backend="mcmc", mcmc_k=MCMC_K, n_slots=N_SLOTS,
                            mesh=mesh)
        for rid in range(SHARDED_REQUESTS):
            eng.submit(SampleRequest(rid=rid, seed=SEED + rid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[n] = eng.run()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        launches[n] = read_counts()
        check(sorted(outs[n]) == list(range(SHARDED_REQUESTS)),
              f"S={n}: sharded MCMC returned {len(outs[n])} requests")
        bad = invalid_mcmc(sp, outs[n])
        check(not bad, f"S={n}: invalid sharded MCMC results {bad[:10]}")
        check(launches[n]["score_all"] > 0,
              f"kernel score_all was not launched on the sharded MCMC (S={n})")
        part[str(n)] = {
            "serve_s": t_serve, "requests_per_s": SHARDED_REQUESTS / t_serve,
            "ticks": eng.ticks,
            "equal_to_unsharded": sum(same_result(outs[n][r], mcmc_out[r])
                                      for r in outs[n]),
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches[n]}
    differ = [r for r in range(SHARDED_REQUESTS)
              if not same_result(outs[1][r], outs[2][r])]
    check(not differ, f"MCMC rids {differ} differ between S = 1 and 2")
    part["equal_S1_S2"] = True
    part["requests"] = SHARDED_REQUESTS
    return part, launches


def check_bilinear_batched(sampler, descents, leaf, launches):
    """Kernel 3 on the sharded path's first leaf scoring (N lanes, their
    blocks' rows and projectors) against its plain version, and on every
    recorded descent against descend_score's raw scores of the blocks the
    kernel chose: the shared leaf stage must give the same bits."""
    import torch
    from repro_torch.kernels.bilinear import ops, ref
    from repro_torch.kernels.spec_round import ops as spec_ops

    w_blk, q = leaf
    n, b, r = w_blk.shape
    got = ops.bilinear_batched(w_blk, q)
    want = ref.bilinear_batched_ref(w_blk, q)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    worst = err / max(float(want.abs().max()), 1e-30)
    tree = sampler.tree
    equal = 0
    arange = torch.arange(tree.block, device=q.device)
    for qd, us, _ in descents:
        blk_k, raw = spec_ops.descend_score(tree.nodes, tree.W, tree.block,
                                            qd, us)
        rows = blk_k[:, None] * tree.block + arange
        equal += bool(torch.equal(ops.bilinear_batched(tree.W[rows], qd), raw))
    ok = worst <= 1e-4 and equal == len(descents)
    ms = cuda_ms(lambda: ops.bilinear_batched(w_blk, q), reps=50)
    plain_ms = cuda_ms(lambda: ref.bilinear_batched_ref(w_blk, q), reps=20)
    library_ms = cuda_ms(lambda: (torch.bmm(w_blk, q) * w_blk).sum(-1),
                         reps=20)
    # Q_n is read once per lane, each row once; a quadratic form needs only
    # Q_n's symmetric part: R^2 to symmetrize, R(R+1) FLOP a row
    bms, by = bound((n * b * r + n * r * r + n * b) * 4.0,
                    1.0 * n * b * r * (r + 1) + 1.0 * n * r * r)
    return {"name": "bilinear_batched", "route": "cuda",
            "source": "src/repro_torch/csrc/bilinear.cu",
            "replaces": "src/repro/kernels/bilinear/bilinear.py:43",
            "launches": launches, "max_abs_err": err,
            "max_err_over_max_score": worst,
            "tolerance": "within 1e-4 of the largest |score|; bit-equal to "
                         "descend_score's raw scores of the same blocks",
            "descents_equal_to_descend_score": equal,
            "descents_compared": len(descents), "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library": "(torch.bmm(Zb, Q) * Zb).sum(-1)",
            "shape": {"N": n, "B": b, "R": r}}


def check_bilinear(sp, mesh, launches, learned):
    """Kernel 6 on the catalog's rows and X (the sharded path's item
    qualities) at M = 2^20 and at a shard's M/2, in float32 and bfloat16,
    and on the learned path's rows Z = [V, B] and nonsymmetric W_J of a
    held-out basket (its next-item scores), against its plain version;
    bilinear_sharded bit-equal to bilinear."""
    import torch
    from repro_torch.kernels.bilinear import ops, ref

    Z, W = sp.Z, sp.x_matrix()
    m, r = Z.shape

    def one(z, w, reps):
        # float32 products run outside the tensor cores; bfloat16 ones,
        # accumulated in float32, at the tensor cores' rate
        rate = BF16_FLOP_PER_S if z.dtype == torch.bfloat16 else FP32_FLOP_PER_S
        got, routes = route_delta("bilinear", lambda: ops.bilinear(z, w))
        want = ref.bilinear_ref(z, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        mm = z.shape[0]
        bms, by = bound((mm * r + r * r) * z.element_size() + mm * 4.0,
                        1.0 * mm * r * (r + 1) + 1.0 * r * r, rate)
        return {"M": mm, "dtype": str(z.dtype).replace("torch.", ""),
                "max_abs_err": err, "max_err_over_max_score": err / scale,
                "route_launches": routes,
                "ok": (err <= 1e-4 * scale
                       and routes == {"resident": 1, "panel": 0}),
                "ms": cuda_ms(lambda: ops.bilinear(z, w), reps=reps),
                "plain_ms": cuda_ms(lambda: ref.bilinear_ref(z, w), reps=reps),
                "library_ms": cuda_ms(lambda: ((z @ w) * z).sum(-1),
                                      reps=reps),
                "bound_ms": bms, "bound_by": by}

    def with_ratio(e):
        return dict(e, ms_over_bound=e["ms"] / e["bound_ms"])

    full = with_ratio(one(Z, W, 10))
    half = with_ratio(one(Z[:m // 2], W, 10))
    bf16 = with_ratio(one(Z.bfloat16(), W.bfloat16(), 10))
    z_l, w_l = learned
    on_w_j = with_ratio(one(z_l, w_l, 5))
    on_w_j["w_j_asymmetry"] = float((w_l - w_l.T).abs().max()
                                    / w_l.abs().max())
    sharded_equal = bool(torch.equal(ops.bilinear_sharded(Z, W, mesh),
                                     ops.bilinear(Z, W)))
    return {"name": "bilinear", "route": "cuda",
            "source": "src/repro_torch/csrc/bilinear.cu",
            "replaces": "src/repro/kernels/bilinear/bilinear.py:65",
            "quad_route": "resident", "route_launches": full["route_launches"],
            "launches": launches, "max_abs_err": full["max_abs_err"],
            "tolerance": "within 1e-4 of the largest |score| (bfloat16 "
                         "inputs widen exactly); bilinear_sharded bit-equal; "
                         "the resident route",
            "bilinear_sharded_bit_equal": sharded_equal,
            "ok": (full["ok"] and half["ok"] and bf16["ok"]
                   and on_w_j["ok"] and sharded_equal),
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": full["library_ms"],
            "library": "((Z @ W) * Z).sum(-1), two calls",
            "shape": {"M": m, "R": r}, "at_half_M": half, "bfloat16": bf16,
            "learned_w_j": on_w_j}


# ------------------------------------------------- the LM template's train path
def matmul_params(cfg) -> int:
    """The parameters that enter a matrix product: all of them but an
    untied token table, which is a gather forward and a scatter-add
    backward (a tied one is also the unembedding, a product)."""
    table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    return cfg.param_count() - table


def ssd_fwd_flop(b: int, s: int, h: int, p: int, n: int, q: int) -> float:
    """The SSD forward's own products: per (batch, head, chunk of Q steps)
    C B^T over the Q(Q+1)/2 causally live pairs (2N a pair), its masked
    product with X (2P a pair), the carried state's term (2 Q N P) and the
    state update (2 Q N P)."""
    pairs = q * (q + 1) / 2
    return b * h * (s // q) * (2.0 * pairs * (n + p) + 4.0 * q * n * p)


def ssd_bwd_flop(b: int, s: int, h: int, p: int, n: int, q: int) -> float:
    """The SSD backward's products, each once, per (batch, head, chunk),
    the Q x Q ones over the Q(Q+1)/2 causally live pairs: C B^T again (2N
    a pair), dY X^T (2P), dx's (2P a pair + 2 Q N P), dc's (2N a pair + 2
    Q N P), db's (2N a pair + 2 Q N P) and dH's (2 Q N P)."""
    pairs = q * (q + 1) / 2
    return b * h * (s // q) * (pairs * (6.0 * n + 4.0 * p)
                               + 8.0 * q * n * p)


def train_flop(cfg, batch: int, seq: int) -> float:
    """FLOP of one train step as MFU counts them: 6 N T for the parameter
    products, N without an untied token table (forward and backward,
    without remat's recompute), and three times each mixer's own forward:
    causal attention, 4 B H D S(S+1)/2 a layer, or the SSD scan
    (``ssd_fwd_flop``) a Mamba layer."""
    tokens = batch * seq
    attn_fwd = 4.0 * batch * cfg.n_heads * cfg.head_dim * seq * (seq + 1) / 2
    mixers = 0.0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "mamba":
            mc = cfg.mamba
            mixers += ssd_fwd_flop(batch, seq, cfg.n_mamba_heads, mc.head_dim,
                                   mc.d_state, min(mc.chunk, seq))
        else:
            mixers += attn_fwd
    return 6.0 * matmul_params(cfg) * tokens + 3.0 * mixers


def train_steps(cfg, seq, hook, track: str):
    """``cfg`` at full width and depth from the port's seeded init, AdamW
    with the reference defaults, ``lm_batch`` at TRAIN_BATCH x ``seq``: one
    cold step, TRAIN_STEPS timed ones, then one under ``torch.profiler``.
    ``hook`` = (module, attribute) of the op whose first call in the first
    timed step (layer 0's) has its inputs recorded for the kernels' parity
    phase; the profiled step reports the kernels whose names hold
    ``track``.  Launch counts are set to 0 before and read after."""
    import torch
    from repro_torch.data.lm import lm_batch
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step

    mod, attr = hook
    op = getattr(mod, attr)
    captured = []
    recording_on = False

    def keep(t):
        t = t.detach()
        if t.dim() == 4 and t.stride(2) == 0:  # a head-broadcast view
            return t[:, :, :1].clone().expand(t.shape)
        return t.clone()

    def recording(*args, **kw):
        if recording_on and not captured:
            captured.append(tuple(keep(x) for x in args))
        return op(*args, **kw)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=SEED, device=DEVICE)
    ocfg = OptimizerConfig()
    opt = make_optimizer(ocfg)
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt)
    losses, gnorms, step_ms, data_ms = [], [], [], []
    with swapped((mod, attr, recording)):
        for step in range(1 + TRAIN_STEPS):
            recording_on = step == 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = lm_batch(cfg, SEED, step, TRAIN_BATCH, seq, device=DEVICE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, state, metrics = step_fn(model, state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del batch
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            data_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
    # one more step under the profiler: device busy time and top kernels
    batch = lm_batch(cfg, SEED, 1 + TRAIN_STEPS, TRAIN_BATCH, seq,
                     device=DEVICE)
    prof = profile_window(
        lambda: float(step_fn(model, state, batch)[2]["loss"]), track)
    del batch
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"non-finite train loss or grad norm: {losses}, {gnorms}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 1.5,
          f"first loss {losses[0]} not within 1.5 of ln(V) = "
          f"{math.log(cfg.vocab)}")
    check(len(captured) == 1, f"layer 0's {attr} inputs were not recorded")
    return {"ocfg": ocfg, "init_s": init_s, "losses": losses,
            "grad_norms": gnorms, "step_ms": step_ms, "data_ms": data_ms,
            "prof": prof, "launches": launches,
            "peak": peak, "captured": captured[0]}


def check_launches(launches, name, want, what):
    check(launches[name] == want,
          f"{name} launched {launches[name]} times, not {what} ({want})")


def train_line(cfg, seq, run, witness, mfu_counts, **extra) -> dict:
    """The train phase's JSON line: the configuration, the steps' losses,
    times, tokens/s, MFU, profile, peak memory and launches."""
    from repro_torch.configs import SHAPES

    ocfg = run["ocfg"]
    warm_ms = float(np.mean(run["step_ms"][1:]))
    flop = train_flop(cfg, TRAIN_BATCH, seq)
    prof = run["prof"]
    return dict({
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        **extra, "vocab": cfg.vocab, "params": cfg.param_count(),
        "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq_len": seq,
        "reduced": [f"global batch {SHAPES[TRAIN_SHAPE].global_batch} -> "
                    f"{TRAIN_BATCH} sequences (one card)"],
        "optimizer": {"name": ocfg.name, "lr": ocfg.lr, "b1": ocfg.b1,
                      "b2": ocfg.b2, "grad_clip": ocfg.grad_clip},
        "remat": cfg.remat, "init_s": run["init_s"],
        "losses": run["losses"], "grad_norms": run["grad_norms"],
        "step_ms_cold": run["step_ms"][0], "step_ms": run["step_ms"][1:],
        "step_ms_warm_mean": warm_ms, "data_ms": run["data_ms"],
        "tokens_per_s": TRAIN_BATCH * seq / (warm_ms / 1e3),
        "flop_per_step": flop,
        "mfu": flop / (warm_ms / 1e3 * BF16_FLOP_PER_S),
        "matmul_params": matmul_params(cfg), "mfu_counts": mfu_counts,
        "step_profile": dict(prof, device_busy_share=prof["device_ms"] /
                             prof["wall_ms"]),
        "peak_device_gb": run["peak"] / 1e9, "launches": run["launches"],
        "plain_witness": witness})


def run_train():
    """qwen3-1.7b at full width and depth, bfloat16 (``train_steps``),
    the flash kernels launched 2 x 28 times a step forward and 28
    backward, and the plain witness with ``mha_ref``.  Returns layer 0's
    attention inputs of the first timed step and the launch counts."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention import ref as attn_ref

    cfg = get_config(TRAIN_ARCH)
    seq = SHAPES[TRAIN_SHAPE].seq_len
    run = train_steps(cfg, seq, (attn_ops, "mha"), "flash_")
    n_steps = 2 + TRAIN_STEPS
    check_launches(run["launches"], "flash_attention",
                   2 * cfg.n_layers * n_steps,
                   f"2 x {cfg.n_layers} a step (remat) over {n_steps} steps")
    check_launches(run["launches"], "flash_attention_bwd",
                   cfg.n_layers * n_steps,
                   f"{cfg.n_layers} a step over {n_steps} steps")
    for name in ("flash_attention", "flash_attention_bwd"):
        routes = by_route(run["launches"], name)
        check(routes["wgmma"] == run["launches"][name],
              f"{name}: not every launch of the train step took the wgmma "
              f"route: {routes}")
    witness = train_witness(cfg, seq, run, (attn_ops, "mha", attn_ref.mha_ref),
                            "mha_ref under autograd", WITNESS_TOL)
    emit({"train": train_line(
        cfg, seq, run, witness,
        "(6 N T + 3 x causal attention forward) / (warm step s x 989e12), "
        "N = matmul_params (the untied token table, a gather, left out); "
        "remat's recompute not counted",
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, flash_routes={
            n: by_route(run["launches"], n)
            for n in ("flash_attention", "flash_attention_bwd")})})
    check(witness["ok"], f"the train run parted from its plain witness: "
                         f"{witness}")
    return run["captured"], run["launches"]


def run_train_ssm():
    """mamba2-1.3b at full width and depth (48 FFN-less Mamba2 layers,
    d_model 2,048, d_inner 4,096, 64 heads of P = 64, N = 128, chunk 128,
    vocab 50,280), bfloat16 (``train_steps``): the SSD kernel launched 2 x
    48 times a step forward (remat) and 48 backward, and the plain witness
    with ``ssd_chunked_ref``.  Returns layer 0's SSD inputs (x, a, B, C;
    B and C broadcast over the heads) of the first timed step and the
    launch counts."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    cfg = get_config(TRAIN_SSM_ARCH)
    seq = SHAPES[TRAIN_SHAPE].seq_len
    run = train_steps(cfg, seq, (ssd_ops, "ssd"), "ssd_")
    n_steps = 2 + TRAIN_STEPS
    check_launches(run["launches"], "ssd", 2 * cfg.n_layers * n_steps,
                   f"2 x {cfg.n_layers} a step (remat) over {n_steps} steps")
    check_launches(run["launches"], "ssd.wgmma", 2 * cfg.n_layers * n_steps,
                   f"2 x {cfg.n_layers} a step over {n_steps} steps, all on "
                   f"the wgmma route")
    check_launches(run["launches"], "ssd.simt", 0, "none on the simt route")
    check_launches(run["launches"], "ssd_bwd", cfg.n_layers * n_steps,
                   f"{cfg.n_layers} a step over {n_steps} steps")
    check_launches(run["launches"], "ssd_bwd.wgmma", cfg.n_layers * n_steps,
                   f"{cfg.n_layers} a step over {n_steps} steps, all on "
                   f"the wgmma route")
    check_launches(run["launches"], "ssd_bwd.simt", 0, "none on the simt "
                   "route")

    def plain_ssd(x, a, b, c, h0=None, *, chunk=128):
        return ssd_ref.ssd_chunked_ref(x, a, b, c, h0, chunk=chunk)

    swap = (ssd_ops, "ssd", plain_ssd)
    # bf16 rounding alone moves mamba2's step-0 gradients by ~15% (median
    # leaf) from their float32 values, on the kernel and the plain path
    # alike, so the witness runs in float32 (the kernel's float32 mode):
    # there the two paths agree to ~2e-5 and a fault cannot hide.  The bf16
    # paths are held against each other and against it (``bf16_step0``)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    k32_step0 = step0_grads(cfg32, seq)
    bf16 = bf16_step0(cfg, seq, swap, k32_step0[1])
    k32 = seeded_steps(cfg32, seq, run["ocfg"], 1 + TRAIN_STEPS)  # kernels
    witness = train_witness(cfg32, seq, dict(run, **k32), swap,
                            "ssd_chunked_ref under autograd, both paths in "
                            "float32", WITNESS_SSM_TOL, kernel_step0=k32_step0)
    del k32_step0
    witness["float32_kernel_steps"] = k32
    witness["bf16_step0"] = bf16
    witness["ok"] = witness["ok"] and bf16["ok"]
    mc = cfg.mamba
    emit({"train_ssm": train_line(
        cfg, seq, run, witness,
        "(6 N T + 3 x SSD forward) / (warm step s x 989e12), N = "
        "matmul_params (the untied token table, a gather, left out), the "
        "SSD forward Q(Q+1)(N + P) + 4QNP a (batch, head, chunk), its "
        "causally live pairs; remat's "
        "recompute not counted",
        d_inner=cfg.d_inner, n_mamba_heads=cfg.n_mamba_heads,
        head_dim=mc.head_dim, d_state=mc.d_state, chunk=mc.chunk,
        ssd_routes=by_route(run["launches"], "ssd"),
        ssd_bwd_routes=by_route(run["launches"], "ssd_bwd"),
        ssd_fwd_flop_per_layer=ssd_fwd_flop(
            TRAIN_BATCH, seq, cfg.n_mamba_heads, mc.head_dim, mc.d_state,
            mc.chunk))})
    check(witness["ok"], f"the SSM train run parted from its plain witness: "
                         f"{witness}")
    return run["captured"], run["launches"]


class swapped:
    """Within the block, ``swap`` = (module, attribute, plain function)
    puts the plain version in place of the kernels' op; None swaps
    nothing."""

    def __init__(self, swap):
        self.swap = swap

    def __enter__(self):
        if self.swap:
            mod, attr, plain = self.swap
            self.op = getattr(mod, attr)
            setattr(mod, attr, plain)

    def __exit__(self, *exc):
        if self.swap:
            setattr(self.swap[0], self.swap[1], self.op)


def seeded_steps(cfg, seq, ocfg, n: int, swap=None) -> dict:
    """``n`` AdamW steps of ``cfg`` from the seeded init on the seeded
    batches, untimed, the plain version in place of the kernels with
    ``swap``: their losses and grad norms."""
    import torch
    from repro_torch.data.lm import lm_batch
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.steps import make_train_step

    model = init_model(cfg, seed=SEED, device=DEVICE)
    opt = make_optimizer(ocfg)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt)
    losses, gnorms = [], []
    with swapped(swap):
        for step in range(n):
            batch = lm_batch(cfg, SEED, step, TRAIN_BATCH, seq, device=DEVICE)
            _, state, metrics = step_fn(model, state, batch)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            del batch
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms}


def step0_grads(cfg, seq, swap=None):
    """Step 0's loss and gradient leaves (name -> float32 tensor on the
    card) of ``cfg`` from the seeded init, the plain version in place of
    the kernels with ``swap``."""
    import torch
    from repro_torch.data.lm import lm_batch
    from repro_torch.models.model import forward_hidden, init_model, lm_loss

    model = init_model(cfg, seed=SEED, device=DEVICE)
    params = dict(model.named_parameters())
    batch = lm_batch(cfg, SEED, 0, TRAIN_BATCH, seq, device=DEVICE)
    with swapped(swap):
        h, _ = forward_hidden(cfg, model, batch["tokens"])
        loss = lm_loss(cfg, model, h, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
    out = float(loss.detach()), {k: g.float() for k, g in zip(params, grads)}
    del model, params, batch, grads, h, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def leaf_gaps(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| of every leaf."""
    import torch

    return {k: float(torch.linalg.vector_norm(got[k] - want[k])) / max(
        float(torch.linalg.vector_norm(want[k])), 1e-30) for k in want}


def gap_summary(gaps: dict) -> dict:
    worst = max(gaps, key=gaps.get)
    return {"median": float(np.median(list(gaps.values()))),
            "worst": [worst, gaps[worst]]}


def grad_norm(grads: dict) -> float:
    import torch

    return math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2
                         for g in grads.values()))


#: the bf16 step-0 gate (``bf16_step0``), set from the H100's reading of
#: mamba2-1.3b at full size (leaf gaps, median / worst: kernel vs plain
#: 0.082 / 0.143, kernel vs float32 0.147 / 0.303, plain vs float32 0.147 /
#: 0.294): the two bf16 paths no further apart, median and worst leaf, than
#: the plain bf16 path is from float32, and the kernel's bf16 path no
#: further from float32 than the plain one's, by a margin
BF16_STEP0_MARGIN = {"median": 1.1, "worst": 1.25}


def bf16_step0(cfg, seq, swap, k32: dict) -> dict:
    """Step 0's gradient leaves of the bf16 kernel path and the bf16 plain
    path against each other and each against ``k32``, the kernel path's
    in float32.  ok when kernel vs plain <= plain vs float32 and kernel
    vs float32 <= BF16_STEP0_MARGIN x plain vs float32, in the median and
    the worst leaf."""
    k16 = step0_grads(cfg, seq)[1]
    p16 = step0_grads(cfg, seq, swap)[1]
    out = {"kernel_vs_plain": gap_summary(leaf_gaps(k16, p16)),
           "kernel_vs_float32": gap_summary(leaf_gaps(k16, k32)),
           "plain_vs_float32": gap_summary(leaf_gaps(p16, k32))}
    del k16, p16
    gc.collect()

    def at(key, stat):
        v = out[key][stat]
        return v[1] if stat == "worst" else v

    out["margin"] = BF16_STEP0_MARGIN
    out["ok"] = all(
        at("kernel_vs_plain", st) <= at("plain_vs_float32", st)
        and at("kernel_vs_float32", st)
        <= BF16_STEP0_MARGIN[st] * at("plain_vs_float32", st)
        for st in ("median", "worst"))
    return out


#: the plain witnesses' tolerances (bfloat16 training, two
#: implementations of a mixer whose outputs differ by bf16 roundings):
#: step 0 on the same params, then the witness's own steps.  qwen3: at
#: full size the H100 read at most a third of each (loss 8e-5, grad norm
#: 5e-5, leaf 9.6e-3, step loss 1.6e-4, step grad norm 1.0e-3); a fault in
#: a layer's attention gradients moves its leaves by O(1).  mamba2: the
#: same values, set before its first run on the card, applied since that
#: run to a float32 witness (``run_train_ssm``)
WITNESS_TOL = {"step0_loss_abs": 1e-3, "step0_grad_norm_rel": 1e-3,
               "step0_leaf_rel": 3e-2, "step_loss_rel": 2e-3,
               "step_grad_norm_rel": 1e-2}
WITNESS_SSM_TOL = dict(WITNESS_TOL)


def train_witness(cfg, seq, run, swap, what: str, tol: dict,
                  kernel_step0=None) -> dict:
    """The train run again with a plain version in place of its kernels
    (``swap`` = (module, attribute, plain function)), from the same seeded
    init and batches.  Step 0 on the same params and batch: the loss, the
    grad norm and every gradient leaf of the kernels against the plain
    path's.  Then the plain path's own 1 + TRAIN_STEPS AdamW steps: their
    losses and grad norms against the kernel run's (``run``).  The kernel
    launches here are comparisons, outside every counted window.
    ``kernel_step0``, where given, is the kernel path's step 0 (loss,
    leaves) already taken."""
    t0 = time.perf_counter()
    k_loss, k_grads = kernel_step0 or step0_grads(cfg, seq)
    p_loss, p_grads = step0_grads(cfg, seq, swap)
    gaps = leaf_gaps(k_grads, p_grads)
    k_gnorm, p_gnorm = grad_norm(k_grads), grad_norm(p_grads)
    del k_grads, p_grads
    plain = seeded_steps(cfg, seq, run["ocfg"], len(run["losses"]), swap)
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(plain["losses"],
                                                     run["losses"])]
    gnorm_rel = [abs(a - b) / abs(b) for a, b in zip(plain["grad_norms"],
                                                     run["grad_norms"])]
    ok = (abs(k_loss - p_loss) <= tol["step0_loss_abs"]
          and abs(k_gnorm - p_gnorm) <= tol["step0_grad_norm_rel"] * p_gnorm
          and worst[0][1] <= tol["step0_leaf_rel"]
          and max(loss_rel) <= tol["step_loss_rel"]
          and max(gnorm_rel) <= tol["step_grad_norm_rel"])
    return {"plain": what,
            "step0": {"loss_kernel": k_loss, "loss_plain": p_loss,
                      "grad_norm_kernel": k_gnorm,
                      "grad_norm_plain": p_gnorm, "leaves": len(gaps),
                      "leaf_rel_err_worst5": worst,
                      "leaf_rel_err_median": float(np.median(
                          list(gaps.values())))},
            "losses": plain["losses"], "grad_norms": plain["grad_norms"],
            "loss_rel_err": loss_rel, "grad_norm_rel_err": gnorm_rel,
            "tolerance": tol, "s": time.perf_counter() - t0, "ok": ok}


def _attn_bytes_flop(q, k, backward: bool):
    """Bytes the call must move (each input read once, each output written
    once) and the causal FLOP these shapes need: 4 D per live (query, key)
    pair forward, 2.5 times that backward (dV, dP, dQ, dK and the
    recomputed scores).  The forward writes O and, for bfloat16, O in
    float32, which the backward reads."""
    b, h, s, d = q.shape
    qo = q.numel() * q.element_size()
    o32 = q.numel() * 4
    kv = 2 * k.numel() * k.element_size()
    lse = b * h * s * 4
    pairs = b * h * s * (s + 1) / 2
    if not backward:
        # read q, k, v; write O, O in float32 (bf16 only), lse
        return (2 * qo + kv + lse + (o32 if q.element_size() < 4 else 0),
                4.0 * d * pairs)
    # read q, k, v, O in float32, dO, lse; write dq, dk, dv
    return 3 * qo + o32 + kv + lse + kv, 10.0 * d * pairs


def flash_sass_has_hgmma() -> bool:
    """The built tensor-core flash library's SASS holds HGMMA (wgmma)."""
    from repro_torch.kernels import _build

    return "HGMMA" in _build.sass("flash_attn_sm90")


#: the SIMT sub-entries' shape: the float32 route at one sequence of the
#: train inputs (batch 1, the first 1,024 positions, all heads)
SIMT_SEQ = 1024


def check_flash_simt(qkv, backward: bool) -> dict:
    """The SIMT kernels (the float32 route) on layer 0's q, k, v cut to
    batch 1 and SIMT_SEQ positions, in float32, against the plain version
    (autograd of it for the backward): within 2e-5 of the output's max
    |.|, as the float32 cases of tests/test_torch_gpu.py; with its time."""
    import torch
    from repro_torch.kernels.attention import ops, ref

    q, k, v = (x[:1, :, :SIMT_SEQ].float().contiguous() for x in qkv)
    scale = q.shape[-1] ** -0.5
    name = "flash_attention_bwd" if backward else "flash_attention"
    if not backward:
        (got, _, _), routes = route_delta(
            name, lambda: ops.flash_forward(q, k, v, True, scale))
        got, want = [got], [ref.mha_ref(q, k, v)]
        ms = cuda_ms(lambda: ops.flash_forward(q, k, v, True, scale), reps=5)
    else:
        gen = torch.Generator(device=q.device)
        gen.manual_seed(SEED + 1)
        dout = torch.randn(q.shape, generator=gen, device=q.device)
        _, lse, o32 = ops.flash_forward(q, k, v, True, scale)
        got, routes = route_delta(name, lambda: ops.flash_backward(
            q, k, v, o32, lse, dout, True, scale))
        qf, kf, vf = (x.clone().requires_grad_(True) for x in (q, k, v))
        want = torch.autograd.grad(ref.mha_ref(qf, kf, vf), (qf, kf, vf),
                                   dout)
        ms = cuda_ms(lambda: ops.flash_backward(q, k, v, o32, lse, dout, True,
                                                scale), reps=5)
    torch.cuda.synchronize()
    rel = max(float((g - w).abs().max()) / float(w.abs().max())
              for g, w in zip(got, want))
    b, h, s, d = q.shape
    return {"source": "src/repro_torch/csrc/flash_attn.cu",
            "flash_route": "simt", "route_launches": routes,
            "max_err_over_max": rel, "tolerance": "2e-5 of the max |.|",
            "ms": ms, "ok": rel <= 2e-5 and routes == {"wgmma": 0, "simt": 1},
            "shape": {"B": b, "H": h, "KVH": k.shape[1], "S": s, "D": d,
                      "dtype": "float32"}}


def check_flash_attention(qkv, launches, hgmma: bool):
    """Kernel 7's forward on layer 0's q, k, v of a timed train step
    against the plain version in float32 on the same bf16 inputs (the
    wgmma route), SDPA's excess on the same inputs beside it, and the
    SIMT route in float32 (``check_flash_simt``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    q, k, v = qkv
    scale = q.shape[-1] ** -0.5
    s = q.shape[2]
    (o, lse, o32), routes = route_delta(
        "flash_attention", lambda: ops.flash_forward(q, k, v, True, scale))
    rounded = bool(torch.equal(o, o32.to(o.dtype)))
    want = ref.mha_ref(q.float(), k.float(), v.float())
    want_lse = ref.mha_lse_ref(q, k, v)
    torch.cuda.synchronize()
    err = float((o.float() - want).abs().max())
    rel = err / float(want.abs().max())
    excess = ref.bf16_excess(o, want)
    lse_err = float((lse - want_lse).abs().max())
    lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
    library_excess = ref.bf16_excess(lib_out, want)
    del lib_out
    # planted faults the tolerance must reject
    late_zero = o.clone()
    late_zero[:, :, s // 2:] = 0
    next_head_v = ops.flash_forward(q, k, v.roll(-1, dims=1), True, scale)[0]
    mutants = {"O zero for rows >= S/2": ref.bf16_excess(late_zero, want),
               "V of kv head (kh + 1) % KVH": ref.bf16_excess(next_head_v,
                                                              want)}
    del late_zero, next_head_v
    simt = check_flash_simt(qkv, backward=False)
    ok = (excess <= 1 and lse_err <= 1e-4 and rounded
          and all(x > 1 for x in mutants.values())
          and routes == {"wgmma": 1, "simt": 0} and hgmma and simt["ok"])
    del want, want_lse, o32
    ms = cuda_ms(lambda: ops.flash_forward(q, k, v, True, scale), reps=10)
    plain_ms = cuda_ms(lambda: ref.mha_ref(q, k, v), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=10)
    n_bytes, n_flop = _attn_bytes_flop(q, k, backward=False)
    bms, by = bound(n_bytes, n_flop, BF16_FLOP_PER_S)
    b, h, s, d = q.shape
    return {"name": "flash_attention", "route": "cuda",
            "flash_route": "wgmma", "route_launches": routes,
            "sass_has_hgmma": hgmma,
            "source": "src/repro_torch/csrc/flash_attn_sm90.cu",
            "replaces": "src/repro/kernels/attention/flash.py:87",
            "launches": launches, "max_abs_err": err,
            "max_err_over_max_out": rel, "excess": excess,
            "library_excess": library_excess,
            "lse_max_abs_err": lse_err, "mutants_excess": mutants,
            "o_is_float32_o_rounded": rounded,
            "tolerance": "against the plain version in float32 on the same "
                         "bf16 inputs, every element of O within 2^-8 of "
                         "its |value| + 2^-8 of its row's max + 2^-16 of "
                         "the global max (excess <= 1, ref.bf16_excess); "
                         "log-sum-exp within 1e-4; O equal to the kept "
                         "float32 O rounded; each planted fault rejected "
                         "(excess > 1); the launch on the wgmma route, "
                         "HGMMA in the SASS; the simt entry within 2e-5",
            "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)",
            "shape": {"B": b, "H": h, "KVH": k.shape[1], "S": s, "D": d,
                      "dtype": str(q.dtype).replace("torch.", "")},
            "simt": simt}


def check_flash_attention_bwd(qkv, launches, hgmma: bool):
    """Kernel 7b, the backward, on the same inputs and a dO drawn from a
    seed, against autograd of the plain version in float32 (the wgmma
    route), SDPA's excess beside it, and the SIMT route in float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    q, k, v = qkv
    scale = q.shape[-1] ** -0.5
    gen = torch.Generator(device=q.device)
    gen.manual_seed(SEED)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    _, lse, o32 = ops.flash_forward(q, k, v, True, scale)
    (dq, dk, dv), routes = route_delta(
        "flash_attention_bwd",
        lambda: ops.flash_backward(q, k, v, o32, lse, dout, True, scale))
    qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(ref.mha_ref(qf, kf, vf), (qf, kf, vf),
                               dout.float())
    del qf, kf, vf
    torch.cuda.synchronize()
    errs, excess, library_excess = {}, {}, {}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        errs[name] = float((got.float() - w).abs().max()) / float(
            w.abs().max())
        excess[name] = ref.bf16_excess(got, w)
    qp, kp, vp = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qp, kp, vp, is_causal=True,
                                         enable_gqa=True)
    lib_grads = torch.autograd.grad(lib, (qp, kp, vp), dout)
    for name, got, w in zip(("dq", "dk", "dv"), lib_grads, want):
        library_excess[name] = ref.bf16_excess(got, w)
    del lib, lib_grads
    # planted faults the tolerance must reject
    s = q.shape[2]
    zq, zk = dq.clone(), dk.clone()
    zq[:, :, s // 2:] = 0
    zk[:, :, s // 2:] = 0
    nq, nk, _ = ops.flash_backward(q, k, v.roll(-1, dims=1), o32, lse,
                                   dout, True, scale)
    mutants = {
        "dq zero for rows >= S/2": ref.bf16_excess(zq, want[0]),
        "dk zero for keys >= S/2": ref.bf16_excess(zk, want[1]),
        "dv of kv head (kh + 1) % KVH": ref.bf16_excess(dv.roll(-1, dims=1),
                                                        want[2]),
        "dq from V of the next kv head": ref.bf16_excess(nq, want[0]),
        "dk from V of the next kv head": ref.bf16_excess(nk, want[1])}
    del zq, zk, nq, nk, want
    simt = check_flash_simt(qkv, backward=True)
    ok = (max(excess.values()) <= 1
          and all(x > 1 for x in mutants.values())
          and routes == {"wgmma": 1, "simt": 0} and hgmma and simt["ok"])
    ms = cuda_ms(lambda: ops.flash_backward(q, k, v, o32, lse, dout, True,
                                            scale), reps=10)
    out = ref.mha_ref(qp, kp, vp)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qp, kp, vp), dout, retain_graph=True), reps=3)
    del out
    lib = F.scaled_dot_product_attention(qp, kp, vp, is_causal=True,
                                         enable_gqa=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib, (qp, kp, vp), dout, retain_graph=True), reps=10)
    del lib
    n_bytes, n_flop = _attn_bytes_flop(q, k, backward=True)
    bms, by = bound(n_bytes, n_flop, BF16_FLOP_PER_S)
    b, h, s, d = q.shape
    return {"name": "flash_attention_bwd", "route": "cuda",
            "flash_route": "wgmma", "route_launches": routes,
            "sass_has_hgmma": hgmma,
            "source": "src/repro_torch/csrc/flash_attn_sm90.cu",
            "replaces": "src/repro/kernels/attention/flash.py:87 (the TPU "
                        "kernel has no backward; this is the port's own)",
            "launches": launches, "max_abs_err": max(errs.values()),
            "max_err_over_max_grad": errs, "excess": excess,
            "library_excess": library_excess,
            "mutants_excess": mutants,
            "tolerance": "against autograd of the plain version in float32, "
                         "every element of dq, dk and dv within 2^-8 of its "
                         "|value| + 2^-8 of its row's max (a query's for "
                         "dq, a key's for dk, dv) + 2^-16 of the global max "
                         "(excess <= 1, ref.bf16_excess); each planted fault "
                         "rejected (excess > 1); the launch on the wgmma "
                         "route, HGMMA in the SASS; the simt entry within "
                         "2e-5",
            "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "library": "autograd backward of F.scaled_dot_product_attention",
            "shape": {"B": b, "H": h, "KVH": k.shape[1], "S": s, "D": d,
                      "dtype": str(q.dtype).replace("torch.", "")},
            "simt": simt}


#: the SSD entries' per-row tolerance (``ssd/ref.py::row_excess``): one
#: bfloat16 rounding for the bf16 outputs (y, dx, db, dc), 2^-12 for the
#: float32 ones (h_last, d log a), against the plain version in float32
SSD_REL_BF16 = 2.0 ** -8
SSD_REL_F32 = 2.0 ** -12


def _ssd_bytes(x, a, b, c, backward: bool) -> float:
    """Bytes the call must move, each input read once and each output
    written once: x, a, and B and C as stored (one row over all heads when
    broadcast); y and h_last forward; dy read, and dx, da, db and dc
    written backward, db and dc at the width of the input they are the
    gradient of (one row over all heads when broadcast: the per-head rows
    the kernel writes for autograd's expand to sum are the design's).
    The chunk-start states the forward keeps for its backward are the
    design's, not the function's."""
    def stored(t):
        return (t[:, :, :1] if t.stride(2) == 0 else t).numel() * \
            t.element_size()

    bsz, s, h, p = x.shape
    n = b.shape[-1]
    ins = stored(x) + a.numel() * 4 + stored(b) + stored(c)
    if not backward:
        return ins + x.numel() * x.element_size() + bsz * h * n * p * 4
    return (ins + 2 * x.numel() * x.element_size() + a.numel() * 4
            + stored(b) + stored(c))


def _ssd_shape(x, b, chunk):
    bsz, s, h, p = x.shape
    return {"B": bsz, "S": s, "H": h, "P": p, "N": b.shape[-1],
            "chunk": chunk, "dtype": str(x.dtype).replace("torch.", ""),
            "b_c_head_stride": b.stride(2)}


def _ssd_trace_inputs():
    """Seeded inputs at the train_ssm path's shape: its layer's x, B, C
    and a dy in bf16, a in float32, B and C one row over the heads."""
    import torch
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(TRAIN_SSM_ARCH)
    bsz, s = TRAIN_BATCH, SHAPES[TRAIN_SHAPE].seq_len
    h, p, n = cfg.n_mamba_heads, cfg.mamba.head_dim, cfg.mamba.d_state
    chunk = min(cfg.mamba.chunk, s)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    x, dy = rand(bsz, s, h, p).bfloat16(), rand(bsz, s, h, p).bfloat16()
    a = torch.sigmoid(rand(bsz, s, h))
    b = rand(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    c = rand(bsz, s, 1, n).bfloat16().expand(bsz, s, h, n)
    return x, a, b, c, dy, chunk


#: traces of one call taken at most, while a trace holds no kernel of the
#: call at all (``_trace_kernels``)
TRACE_ATTEMPTS = 3


def _trace_kernels(call, prefix: str, expected: tuple) -> dict:
    """The CUDA kernels whose names hold ``prefix`` that one ``call()``
    launched, counted by name, from a ``torch.profiler`` trace (after one
    untraced call), and the number of traces taken: a trace that does not
    hold each of ``expected`` once is taken again, up to TRACE_ATTEMPTS
    times (on the H100 the first trace of a fresh process has come back
    without any kernel, and the profiler loses a device event of a window
    now and then)."""
    call()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        counts = {}
        for key, _, count in profile_window(call, prefix)["tracked"][
                "kernels_ms"]:
            name = re.search(prefix + r"\w*", key).group(0)
            counts[name] = counts.get(name, 0) + count
        if counts == dict.fromkeys(expected, 1):
            break
    return {"kernels": counts, "attempts": attempt}


def trace_ssd_fwd():
    """One call of the SSD forward at the train_ssm path's shape
    (``_ssd_trace_inputs``), keeping its states as training does, traced
    by ``torch.profiler``: the CUDA kernels it launched, counted by name,
    and the shape.  ``main`` takes it right after the build, as
    ``trace_ssd_bwd``."""
    from repro_torch.kernels.ssd import ops

    x, a, b, c, _, chunk = _ssd_trace_inputs()
    return dict(_trace_kernels(lambda: ops.ssd_forward(
        x, a, b, c, chunk, keep_states=True), "ssd_fwd",
        SSD_FWD_WGMMA_KERNELS),
        shape=_ssd_shape(x, b, chunk))


def trace_ssd_bwd():
    """One call of the SSD backward at the train_ssm path's shape
    (``_ssd_trace_inputs``) traced by ``torch.profiler``: the CUDA kernels
    it launched, counted by name, and the shape.  ``main`` takes it right
    after the build: later in the run the profiler drops the kernels of a
    short window (on the H100 one call's three kernels were traced 3, 2,
    1, then 0 times as the phases went by, with or without idle time
    around the call)."""
    from repro_torch.kernels.ssd import ops

    x, a, b, c, dy, chunk = _ssd_trace_inputs()
    states = ops.ssd_forward(x, a, b, c, chunk, keep_states=True)[2]
    return dict(_trace_kernels(lambda: ops.ssd_backward(
        x, a, b, c, states, dy, None, chunk), "ssd_bwd",
        SSD_BWD_WGMMA_KERNELS),
        shape=_ssd_shape(x, b, chunk))


#: the forward's wgmma route's float32 operands, each entering its product
#: as a bf16 pair hi + lo (``tools/ssd_rounding.py --direction fwd``: any
#: one rounded once fails or nearly fails the tolerances below)
SSD_FWD_SPLIT = ["B o w (S_q)", "H_prev (y)", "G o L (y)"]
#: the CUDA kernels a call of the forward's wgmma route must launch, once
#: each: S_q a chunk, the carry of the states across chunks, y a chunk tile
SSD_FWD_WGMMA_KERNELS = ("ssd_fwd_state_kernel", "ssd_fwd_carry_kernel",
                         "ssd_fwd_chunk_kernel")


def check_ssd(xabc, chunk, launches, traced):
    """Kernel 8's forward on layer 0's x, a, B, C of a timed SSM train step
    (B and C read through a head stride of 0, as the path reads them)
    against the plain version in float32 on the same inputs.  The train
    shape takes the wgmma route; the SIMT kernel (the simt route, which
    takes float32 and the other shapes) runs beside it on the same inputs
    through its own C entry, and the two routes' chunk-start states are
    held to each other.  ``traced``: ``trace_ssd_fwd()``'s count of the
    route's CUDA kernels, which must be each of its three once, at the same
    shape."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops, ref

    x, a, b, c = xabc
    s = x.shape[1]
    (y, hl, states), routes = route_delta("ssd", lambda: ops.ssd_forward(
        x, a, b, c, chunk, keep_states=True))
    again = ops.ssd_forward(x, a, b, c, chunk, keep_states=True)
    deterministic = all(bool(torch.equal(u, v))
                        for u, v in zip((y, hl, states), again))
    del again
    sy, shl, sstates = ops._launch_forward("simt", x, a, b, c, chunk, True)
    want, want_h = ref.ssd_chunked_ref(x.float(), a, b.float(), c.float(),
                                       chunk=chunk)
    torch.cuda.synchronize()
    err = float((y.float() - want).abs().max())
    excess = {"y": ref.row_excess(y, want, 1, SSD_REL_BF16),
              "h_last": ref.row_excess(hl, want_h, 2, SSD_REL_F32)}
    simt_excess = {"y": ref.row_excess(sy, want, 1, SSD_REL_BF16),
                   "h_last": ref.row_excess(shl, want_h, 2, SSD_REL_F32)}
    # the states the backward reads, against the simt route's
    states_excess = ref.row_excess(states, sstates, 2, SSD_REL_F32)
    del sy, shl, sstates, states
    # planted faults the tolerance must reject
    k = s // 2
    halves = torch.cat([ops.ssd_forward(x[:, sl], a[:, sl], b[:, sl],
                                        c[:, sl], chunk)[0]
                        for sl in (slice(0, k), slice(k, None))], 1)
    rolled = ops.ssd_forward(x, a.roll(1, dims=2), b, c, chunk)[0]
    mutants = {"y, state not carried into chunk S/2": ref.row_excess(
                   halves, want, 1, SSD_REL_BF16),
               "y, decays of head (h - 1) % H": ref.row_excess(
                   rolled, want, 1, SSD_REL_BF16)}
    del halves, rolled, want, want_h
    hgmma = "HGMMA" in _build.sass("ssd")
    cuda_kernels = traced["kernels"]
    ok = (max(excess.values()) <= 1 and all(v > 1 for v in mutants.values())
          and routes == {"wgmma": 1, "simt": 0} and hgmma and deterministic
          and max(simt_excess.values()) <= 1 and states_excess <= 1
          and cuda_kernels == dict.fromkeys(SSD_FWD_WGMMA_KERNELS, 1)
          and traced["shape"] == _ssd_shape(x, b, chunk))
    ms = cuda_ms(lambda: ops.ssd_forward(x, a, b, c, chunk), reps=10)
    simt_ms = cuda_ms(lambda: ops._launch_forward("simt", x, a, b, c, chunk,
                                                  False), reps=5)
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(x, a, b, c, chunk=chunk),
                       reps=3)
    bsz, _, h, p = x.shape
    n_flop = ssd_fwd_flop(bsz, s, h, p, b.shape[-1], chunk)
    n_bytes = _ssd_bytes(x, a, b, c, backward=False)
    bms, by = bound(n_bytes, n_flop, BF16_FLOP_PER_S)
    return {"name": "ssd", "route": "cuda",
            "ssd_route": "wgmma", "route_launches": routes,
            "cuda_launches_per_call": sum(cuda_kernels.values()),
            "cuda_kernels_per_call": cuda_kernels,
            "cuda_kernels_traced": "one call on seeded inputs of this "
                                   "shape, by torch.profiler, right after "
                                   "the build",
            "cuda_kernels_trace_attempts": traced["attempts"],
            "sass_has_hgmma": hgmma, "split": SSD_FWD_SPLIT,
            "deterministic": deterministic,
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:80",
            "launches": launches, "max_abs_err": err, "excess": excess,
            "mutants_excess": mutants,
            "tolerance": "against the plain version (ssd_chunked_ref) in "
                         "float32 on the same bf16 inputs, per row "
                         "(ssd/ref.py::row_excess; a row: one (batch, step, "
                         "head) of y, one (batch, head) state of h_last): "
                         "every element within rel |value| + rel of its "
                         "row's max + rel 2^-8 of the global max, rel = "
                         "2^-8 for y, 2^-12 for h_last (excess <= 1); each "
                         "planted fault rejected (excess > 1); the launch "
                         "on the wgmma route, HGMMA in the SASS, two calls "
                         "equal, one call's trace holding each of the "
                         "route's three CUDA kernels once; the simt route "
                         "within the same tolerances, and the two routes' "
                         "chunk-start states within h_last's",
            "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by,
            "bound_ms_fp32_fma": max(n_bytes / HBM_BYTES_PER_S,
                                     n_flop / FP32_FLOP_PER_S) * 1e3,
            "flop": n_flop, "bytes": n_bytes, "library_ms": None,
            "library": "none (no single PyTorch call)",
            "shape": _ssd_shape(x, b, chunk),
            "simt": {"ms": simt_ms, "excess": simt_excess,
                     "states_excess_vs_wgmma": states_excess,
                     "what": "the SIMT kernel (the simt route) on the "
                             "same bf16 inputs, timed in this process"}}


#: the backward's wgmma route's float32 operands, each entering its
#: product as a bf16 pair hi + lo (``tools/ssd_rounding.py``: any one rounded once fails or
#: nearly fails the tolerances below)
SSD_BWD_SPLIT = ["C o e (U)", "G o L (dx)", "M (dc, db)", "H_prev (dc)",
                 "dH (dx, db)"]
#: the CUDA kernels a call of the wgmma route must launch, once each: U a
#: chunk, the carry of dH across chunks, the outputs a chunk
SSD_BWD_WGMMA_KERNELS = ("ssd_bwd_u_kernel", "ssd_bwd_carry_kernel",
                         "ssd_bwd_chunk_kernel")


def check_ssd_bwd(xabc, chunk, launches, traced):
    """Kernel 8b, the backward, on the same inputs and a dy drawn from a
    seed (h_last's gradient zero, as in training), against autograd of the
    plain version in float32; db and dc a head at a time.  The train shape
    takes the wgmma route; the SIMT kernel (the simt route, which takes
    float32 and the other shapes) runs beside it on the same inputs.
    ``traced``: ``trace_ssd_bwd()``'s count of the route's CUDA kernels,
    which must be each of its three once, at the same shape."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops, ref

    x, a, b, c = xabc
    s = x.shape[1]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SEED)
    dy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    _, _, states = ops.ssd_forward(x, a, b, c, chunk, keep_states=True)
    got, routes = route_delta("ssd_bwd", lambda: ops.ssd_backward(
        x, a, b, c, states, dy, None, chunk))
    again = ops.ssd_backward(x, a, b, c, states, dy, None, chunk)
    deterministic = all(bool(torch.equal(u, v)) for u, v in zip(got, again))
    del again
    simt = ops._launch_backward("simt", x, a, b, c, states, dy, None, chunk)
    leaves = [t.float().contiguous().requires_grad_(True) for t in (x, a, b, c)]
    want = torch.autograd.grad(ref.ssd_chunked_ref(*leaves, chunk=chunk)[0],
                               leaves, dy.float())
    del leaves
    torch.cuda.synchronize()

    def excess_of(dx, da, db, dc):
        return {"dx": ref.row_excess(dx, want[0], 1, SSD_REL_BF16),
                "dloga": ref.row_excess(ref.da_rows(da * a, chunk),
                                        ref.da_rows(want[1] * a, chunk), 1,
                                        SSD_REL_F32),
                "db": ref.row_excess(db, want[2], 1, SSD_REL_BF16),
                "dc": ref.row_excess(dc, want[3], 1, SSD_REL_BF16)}

    excess = excess_of(*got)
    simt_excess = excess_of(*simt)
    del simt
    err = max(float((g.float() - w).abs().max()) / float(w.abs().max())
              for g, w in zip(got, want))
    # planted faults the tolerance must reject
    k = s // 2
    parts = []
    for sl in (slice(0, k), slice(k, None)):
        st = ops.ssd_forward(x[:, sl], a[:, sl], b[:, sl], c[:, sl], chunk,
                             keep_states=True)[2]
        parts.append(ops.ssd_backward(x[:, sl], a[:, sl], b[:, sl], c[:, sl],
                                      st, dy[:, sl], None, chunk)[0])
    ar = a.roll(1, dims=2)
    st = ops.ssd_forward(x, ar, b, c, chunk, keep_states=True)[2]
    rolled = ops.ssd_backward(x, ar, b, c, st, dy, None, chunk)[0]
    mutants = {"dx, dH not carried out of chunk S/2": ref.row_excess(
                   torch.cat(parts, 1), want[0], 1, SSD_REL_BF16),
               "dx, decays of head (h - 1) % H": ref.row_excess(
                   rolled, want[0], 1, SSD_REL_BF16)}
    del parts, rolled, st, want, got
    hgmma = "HGMMA" in _build.sass("ssd")
    cuda_kernels = traced["kernels"]
    ok = (max(excess.values()) <= 1 and all(v > 1 for v in mutants.values())
          and routes == {"wgmma": 1, "simt": 0} and hgmma and deterministic
          and max(simt_excess.values()) <= 1
          and cuda_kernels == dict.fromkeys(SSD_BWD_WGMMA_KERNELS, 1)
          and traced["shape"] == _ssd_shape(x, b, chunk))
    ms = cuda_ms(lambda: ops.ssd_backward(x, a, b, c, states, dy, None,
                                          chunk), reps=5)
    simt_ms = cuda_ms(lambda: ops._launch_backward(
        "simt", x, a, b, c, states, dy, None, chunk), reps=3)
    leaves = [t.detach().requires_grad_(True) for t in (x, a, b, c)]
    out = ref.ssd_chunked_ref(*leaves, chunk=chunk)[0]
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                                   retain_graph=True), reps=2)
    del out, leaves
    bsz, _, h, p = x.shape
    n_flop = ssd_bwd_flop(bsz, s, h, p, b.shape[-1], chunk)
    n_bytes = _ssd_bytes(x, a, b, c, backward=True)
    bms, by = bound(n_bytes, n_flop, BF16_FLOP_PER_S)
    return {"name": "ssd_bwd", "route": "cuda",
            "ssd_route": "wgmma", "route_launches": routes,
            "cuda_launches_per_call": sum(cuda_kernels.values()),
            "cuda_kernels_per_call": cuda_kernels,
            "cuda_kernels_traced": "one call on seeded inputs of this "
                                   "shape, by torch.profiler, right after "
                                   "the build",
            "cuda_kernels_trace_attempts": traced["attempts"],
            "sass_has_hgmma": hgmma, "split": SSD_BWD_SPLIT,
            "deterministic": deterministic,
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:80 (the TPU kernel "
                        "has no backward; this is the port's own)",
            "launches": launches, "max_abs_err": err, "excess": excess,
            "mutants_excess": mutants,
            "tolerance": "against autograd of the plain version "
                         "(ssd_chunked_ref) in float32, per row "
                         "(ssd/ref.py::row_excess; a row: one (batch, step, "
                         "head) of dx, db, dc, one chunk of one head of d "
                         "log a = da * a): rel = 2^-8 for dx, db, dc, 2^-12 "
                         "for d log a (excess <= 1); each planted fault "
                         "rejected (excess > 1); the launch on the wgmma "
                         "route, HGMMA in the SASS, two calls equal, one "
                         "call's trace holding each of the route's three "
                         "CUDA kernels once; the simt route within the "
                         "same tolerances",
            "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by,
            "bound_ms_fp32_fma": max(n_bytes / HBM_BYTES_PER_S,
                                     n_flop / FP32_FLOP_PER_S) * 1e3,
            "flop": n_flop, "bytes": n_bytes, "library_ms": None,
            "library": "none (no single PyTorch call)",
            "shape": _ssd_shape(x, b, chunk),
            "simt": {"ms": simt_ms, "excess": simt_excess,
                     "what": "the SIMT kernel (the simt route) on the same "
                             "bf16 inputs, timed in this process"}}


# --------------------------------------------------------------------- main
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: FAIL: src/repro_torch not found beside this script "
              "(run it from a checkout of the repository)", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)

    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for kname in KERNEL_SOURCES:
        for line in _build.build_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {kname}: {line.strip()}", flush=True)
    ssd_fwd_traced = trace_ssd_fwd()
    ssd_bwd_traced = trace_ssd_bwd()
    descend_traced = trace_descend_score()
    gc.collect()
    torch.cuda.empty_cache()

    by_path = {}
    sampler, captured, by_path["main_path"], factors, main_out = \
        run_main_path()
    entries = [check_block_outer_sums(sampler, by_path["main_path"]),
               check_descend_score(sampler, captured, by_path["main_path"],
                                   descend_traced)]
    by_path["serve"] = run_serve(sampler)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["cholesky"], chol_keys, chol_x = run_cholesky(sampler)
    by_path["learned"], learned = run_learned(factors)
    entries.append(check_cholesky_scan(sampler.sp, chol_keys, chol_x,
                                       by_path["cholesky"],
                                       learned.pop("cholesky_scan")))
    del chol_keys, chol_x
    gc.collect()
    torch.cuda.empty_cache()
    sharded = {"meshes": list(SHARD_COUNTS)}
    sharded["rejection"], rej_counts, q_counts, descents, leaf, mesh2 = \
        run_sharded_rejection(sampler, main_out)
    entries.append(check_bilinear_batched(sampler, descents, leaf, None))
    sp = sampler.sp                  # the MCMC phase's state; the tree goes
    del sampler, captured, descents, leaf, main_out
    gc.collect()
    torch.cuda.empty_cache()

    cat, cat_captured, by_path["catalog"] = run_catalog(factors)
    entries.append(check_gathered_block_grams(
        cat_captured, by_path["catalog"]["gathered_block_grams"]))
    del cat, cat_captured
    gc.collect()
    torch.cuda.empty_cache()
    sharded["catalog"], cat_counts = run_sharded_catalog(factors)
    del factors
    gc.collect()
    torch.cuda.empty_cache()

    mcmc_captured, by_path["mcmc"], mcmc_out = run_mcmc(sp)
    entries.append(check_score_all(sp, mcmc_captured,
                                   by_path["mcmc"]["score_all"]))
    sharded["mcmc"], mcmc_counts = run_sharded_mcmc(sp, mcmc_out)
    entries.append(check_bilinear(sp, mesh2, None, learned.pop("bilinear")))
    # the sharded path's launches: its rejection, catalog and MCMC runs
    runs = [c for counts in (rej_counts, cat_counts, mcmc_counts)
            for c in counts.values()]
    by_path["sharded"] = {k: sum(c[k] for c in runs) for k in runs[0]}
    # bilinear_sharded's own launches: no engine, sampler or catalog
    # calls kernel 6
    qs = list(q_counts.values())
    by_path["item_qualities"] = {k: sum(c[k] for c in qs) for k in qs[0]}
    sharded["peak_device_gb"] = max(
        p[str(n)]["peak_device_gb"] for p in (sharded["rejection"],
                                              sharded["catalog"],
                                              sharded["mcmc"])
        for n in SHARD_COUNTS)
    sharded["launches"] = by_path["sharded"]
    emit({"sharded": sharded})
    del sp, mesh2, learned
    gc.collect()
    torch.cuda.empty_cache()

    qkv, by_path["train"] = run_train()
    gc.collect()
    torch.cuda.empty_cache()
    hgmma = flash_sass_has_hgmma()
    entries.append(check_flash_attention(qkv, None, hgmma))
    entries.append(check_flash_attention_bwd(qkv, None, hgmma))
    del qkv
    gc.collect()
    torch.cuda.empty_cache()

    xabc, by_path["train_ssm"] = run_train_ssm()
    gc.collect()
    torch.cuda.empty_cache()
    chunk = min(get_config(TRAIN_SSM_ARCH).mamba.chunk, xabc[0].shape[1])
    entries.append(check_ssd(xabc, chunk, None, ssd_fwd_traced))
    entries.append(check_ssd_bwd(xabc, chunk, None, ssd_bwd_traced))
    del xabc
    # the float32 yardsticks run in full float32 only while this is False
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    for e in entries:
        e["launches_by_path"] = {p: c[e["name"]] for p, c in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        routes = [by_route(c, e["name"]) for c in by_path.values()]
        if routes[0]:  # the paths' launches by route
            e["launches_by_route"] = {rt: sum(r[rt] for r in routes)
                                      for rt in routes[0]}
            e["ok"] = e["ok"] and (sum(e["launches_by_route"].values())
                                   == e["launches"])
        e["ms_over_bound"] = e["ms"] / e["bound_ms"]
        if e["library_ms"] is not None:
            e["ms_over_library"] = e["ms"] / e["library_ms"]
            e["library_allow_tf32"] = tf32
    emit({"kernels": entries})
    bad = [e["name"] for e in entries if not e["ok"]]
    check(not bad, f"kernel parity failed: {bad}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
