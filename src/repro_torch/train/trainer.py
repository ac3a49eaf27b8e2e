"""Training loop with straggler-aware step deadlines (port of
``repro/train/trainer.py::train``).

Runs on one device (``cuda`` unless the caller names another).  Checkpoint
and restart (``train/checkpoint.py``) and a mesh come with later slices
(ROADMAP.md, Queue 1): a ``checkpoint_dir`` or a mesh raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..data.lm import lm_batch
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import init_model
from .optimizer import OptimizerConfig, make_optimizer
from .steps import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    async_checkpoint: bool = True
    log_every: int = 10
    # straggler mitigation: if a step exceeds deadline_factor x the median
    # step time, record it; after `max_slow_steps` consecutive slow steps
    # the reference checkpoints so the scheduler can requeue the job
    deadline_factor: float = 3.0
    max_slow_steps: int = 3


def train(cfg: ModelConfig, tcfg: TrainerConfig, ocfg: OptimizerConfig,
          mesh=None, log_fn: Callable[[str], None] = print,
          device: DeviceLike = None) -> Dict[str, Any]:
    if tcfg.checkpoint_dir is not None or mesh is not None:
        raise NotImplementedError("checkpoint/restart (train/checkpoint.py) "
                                  "and meshes come with later slices; see "
                                  "ROADMAP.md, Queue 1")
    dev = resolve_device(device)
    opt = make_optimizer(ocfg)
    model = init_model(cfg, tcfg.seed, dev)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt)

    losses = []
    times = []
    slow = 0
    for step in range(tcfg.steps):
        t0 = time.perf_counter()
        batch = lm_batch(cfg, tcfg.seed, step, tcfg.batch, tcfg.seq_len,
                         device=dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])   # waits for the step
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)

        med = float(np.median(times[-20:]))
        if len(times) > 5 and dt > tcfg.deadline_factor * med:
            slow += 1
            log_fn(f"[trainer] slow step {step}: {dt:.3f}s vs median "
                   f"{med:.3f}s")
            if slow >= tcfg.max_slow_steps:
                log_fn("[trainer] persistent straggler (no checkpoint to "
                       "requeue from in the port yet)")
                slow = 0
        else:
            slow = 0

        if step % tcfg.log_every == 0:
            log_fn(f"[trainer] step {step} loss {loss:.4f} "
                   f"({dt * 1e3:.0f} ms)")
    return {
        "model": model,
        "opt_state": opt_state,
        "losses": losses,
        "mean_step_time": float(np.mean(times[1:])) if len(times) > 1 else None,
    }
