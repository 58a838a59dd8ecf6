"""Optimizer and LR schedule (counterpart of ``se3conv3d_tpu/train/schedule.py``).

AdamW with decoupled weight decay on every parameter, a clamped one-cycle
schedule stepped per optimizer step, and clipping by global norm -- the
optax chain ``clip_by_global_norm -> adamw(onecycle)`` of the JAX package,
written with ``torch.optim.AdamW`` and a ``LambdaLR``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

__all__ = ["onecycle", "global_norm", "Optimizer", "make_optimizer", "optimizer_from_training"]


def onecycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], float]:
    """Piecewise cosine one-cycle: ``max_lr / div_factor`` rising to
    ``max_lr`` over the warmup, then falling to
    ``max_lr / (div_factor * final_div_factor)`` at ``total_steps`` and
    staying there.

    The warmup is clamped to ``[1, total_steps - 1]`` steps: optax's
    ``cosine_onecycle_schedule`` floors it to zero at small step counts and
    divides by it (NaN learning rate).  Not ``torch.optim.lr_scheduler.
    OneCycleLR``, which anneals to its minimum at ``total_steps - 1``.
    """
    total = max(int(total_steps), 2)
    warm = min(max(int(pct_start * total), 1), total - 1)
    start = max_lr / div_factor
    peak = start * div_factor
    end = peak * (1.0 / (div_factor * final_div_factor))

    def cosine(a: float, b: float, pct: float) -> float:
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def schedule(step: int) -> float:
        if step < 0:
            return 0.0
        if step < warm:
            return cosine(start, peak, step / warm)
        if step < total:
            return cosine(peak, end, (step - warm) / (total - warm))
        return end

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all elements of all tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """AdamW (betas 0.9 / 0.999, eps 1e-8) whose learning rate follows
    ``schedule(step)``, after clipping the gradients to a global norm of at
    most ``clip_grad_norm`` (optax's rule: scaled by ``clip / norm`` when
    ``norm >= clip``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, clip_grad_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.clip_grad_norm = clip_grad_norm
        self.adamw = torch.optim.AdamW(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)

    @property
    def lr(self) -> float:
        """Learning rate of the next step."""
        return self.adamw.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule; returns the global gradient
        norm before clipping (a device tensor: no host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip_grad_norm is not None:
            keep = norm < self.clip_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_grad_norm))
        self.adamw.step()
        self.scheduler.step()
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], max_lr: float, total_steps: int,
                   weight_decay: float = 1e-4, clip_grad_norm: Optional[float] = None,
                   accum_steps: int = 1, pct_start: float = 0.3, div_factor: float = 25.0,
                   final_div_factor: float = 1e4) -> Optimizer:
    """AdamW + one-cycle (+ clipping), as the JAX ``make_optimizer``.

    ``div_factor`` / ``final_div_factor`` default to the JAX package's
    values; the recipes' ``Training`` sections set their own.  Gradient
    accumulation (``accum_steps > 1``, ``optax.MultiSteps`` in JAX) is not
    ported and raises.
    """
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    schedule = onecycle(max_lr, total_steps, pct_start, div_factor, final_div_factor)
    return Optimizer(params, schedule, weight_decay, clip_grad_norm)


def optimizer_from_training(params: Iterable[torch.nn.Parameter], training: Dict[str, Any],
                            total_steps: int) -> Optimizer:
    """A recipe's ``Training`` section (e.g. ``models.presets.
    DFAUST_I_ROT_PCA_2F_TRAINING``) -> :func:`make_optimizer`.  Unlike the
    JAX package's ``train/run.py``, the section's ``div_factor`` and
    ``final_div_factor`` are honoured."""
    return make_optimizer(
        params, float(training["max_lr"]), total_steps,
        weight_decay=float(training.get("weight_decay", 0.0)),
        clip_grad_norm=training.get("clip_grads"),
        accum_steps=int(training.get("accum_grads", 1)),
        pct_start=float(training.get("pct_start", 0.3)),
        div_factor=float(training.get("div_factor", 25.0)),
        final_div_factor=float(training.get("final_div_factor", 1e4)),
    )
