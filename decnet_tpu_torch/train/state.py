"""Optimizer and learning-rate schedules — the port of
decnet_tpu/train/state.py:25-55 (optax: clip_by_global_norm(10), then Adam,
or AdamW when weight_decay > 0, scaled by the schedule).

The schedules follow optax's formulas.  `schedule(count)` is the rate of
the update that follows `count` earlier updates, so the first update of a
cosine schedule has rate 0.  torch.optim.Adam and AdamW compute optax's
update (bias-corrected moments, eps added to the corrected root, decoupled
weight decay); the rate is set on the optimizer before every step.  The
clip is optax's rule: scale by max_norm / norm only when norm >= max_norm
(torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm and scales whenever
the norm exceeds it, so it is not used)."""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

from decnet_tpu_torch.config import TrainConfig

CLIP_NORM = 10.0
BETAS = (0.9, 0.999)
EPS = 1e-8


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    lr = cfg.lr
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, 0.01 lr)
        warmup = min(cfg.warmup_steps, max(1, cfg.total_steps // 10))
        decay = max(cfg.total_steps, warmup + 1) - warmup
        alpha = 0.01

        def cosine(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            t = min(count - warmup, decay)
            cos = 0.5 * (1.0 + math.cos(math.pi * t / decay))
            return lr * ((1.0 - alpha) * cos + alpha)
        return cosine
    if cfg.lr_schedule == "piecewise":
        # optax.piecewise_constant_schedule: x0.1 from each boundary on
        bounds = (int(cfg.total_steps * 0.6), int(cfg.total_steps * 0.85))
        return lambda count: lr * 0.1 ** sum(count >= b for b in bounds)
    raise ValueError(cfg.lr_schedule)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Optimizer:
    """Adam (AdamW when weight_decay > 0) at rate 0; `apply_updates` sets
    the scheduled rate before each step."""
    params = list(params)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, lr=0.0, betas=BETAS, eps=EPS,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=0.0, betas=BETAS, eps=EPS)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                        max_norm: float = CLIP_NORM) -> None:
    """optax's clip in place: g -> (g / norm) * max_norm when
    norm >= max_norm, unchanged otherwise (no host sync)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def apply_updates(optimizer: torch.optim.Optimizer,
                  schedule: Callable[[int], float], count: int) -> None:
    """One optimizer step at the rate schedule(count)."""
    lr = schedule(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
