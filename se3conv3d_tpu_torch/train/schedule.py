"""Optimizer and LR schedule (counterpart of ``se3conv3d_tpu/train/schedule.py``).

AdamW with decoupled weight decay on every parameter, a clamped one-cycle
schedule stepped per optimizer step, and clipping by global norm -- the
optax chain ``clip_by_global_norm -> adamw(onecycle)`` of the JAX package,
written with ``torch.optim.AdamW`` and a ``LambdaLR`` -- optionally
accumulating the gradients of ``accum_steps`` micro-batches per optimizer
step, as the JAX package's ``optax.MultiSteps`` wrapper.
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
    ``norm >= clip``).

    With ``accum_steps = k > 1`` each :meth:`step` call is one micro-batch,
    with ``optax.MultiSteps(k)`` semantics: the call adds the parameters'
    gradients to an accumulator; every k-th call takes the accumulator's
    mean over the k micro-batches as the gradient, clips it, updates,
    advances the schedule and clears the accumulator; the other calls
    leave the parameters, the AdamW state and the schedule untouched.  The
    count lives here, so any caller that sets ``.grad`` and calls
    :meth:`step` (the plain and the scene-sequential train steps alike)
    shares it.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, clip_grad_norm: Optional[float] = None,
                 accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.params = [p for p in params if p.requires_grad]
        self.clip_grad_norm = clip_grad_norm
        self.accum_steps = accum_steps
        self.micro_step = 0  # micro-batches in the accumulator
        self._acc: Optional[List[Optional[torch.Tensor]]] = None
        self.adamw = torch.optim.AdamW(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)

    def state_dict(self) -> Dict[str, Any]:
        """AdamW's moments and step, the schedule's step, and the
        accumulation counter and accumulator (a checkpoint's optimizer)."""
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict(),
                "micro_step": self.micro_step, "acc": self._acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.micro_step = int(state["micro_step"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            None if a is None else a.to(p.device) for a, p in zip(acc, self.params)]

    @property
    def lr(self) -> float:
        """Learning rate of the next update."""
        return self.adamw.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One micro-batch: returns the global norm of this call's gradients
        (a device tensor: no host sync).  Without accumulation, or at the
        k-th call, clips the (mean) gradient, updates and advances the
        schedule."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.accum_steps > 1:
            if self._acc is None:
                self._acc = [None if p.grad is None else p.grad.clone() for p in self.params]
            else:
                for i, p in enumerate(self.params):
                    if p.grad is not None:
                        self._acc[i] = p.grad.clone() if self._acc[i] is None else self._acc[i].add_(p.grad)
            self.micro_step += 1
            if self.micro_step < self.accum_steps:
                return norm
            for p, acc in zip(self.params, self._acc):
                p.grad = None if acc is None else acc.div_(self.accum_steps)
            self._acc, self.micro_step = None, 0
            grads = [p.grad for p in self.params if p.grad is not None]
            mean_norm = global_norm(grads)
        else:
            mean_norm = norm
        if self.clip_grad_norm is not None:
            keep = mean_norm < self.clip_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / mean_norm * self.clip_grad_norm))
        self.adamw.step()
        self.scheduler.step()
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], max_lr: float, total_steps: int,
                   weight_decay: float = 1e-4, clip_grad_norm: Optional[float] = None,
                   accum_steps: int = 1, pct_start: float = 0.3, div_factor: float = 25.0,
                   final_div_factor: float = 1e4) -> Optimizer:
    """AdamW + one-cycle (+ clipping, + gradient accumulation over
    ``accum_steps`` micro-batches), as the JAX ``make_optimizer``.

    ``total_steps`` counts :meth:`Optimizer.step` calls (micro-batches);
    the one-cycle runs over the ``max(total_steps // accum_steps, 1)`` real
    updates, as in JAX.  ``div_factor`` / ``final_div_factor`` default to
    the JAX package's values; the recipes' ``Training`` sections set their
    own.
    """
    schedule = onecycle(max_lr, max(int(total_steps) // max(accum_steps, 1), 1), pct_start,
                        div_factor, final_div_factor)
    return Optimizer(params, schedule, weight_decay, clip_grad_norm, accum_steps)


def optimizer_from_training(params: Iterable[torch.nn.Parameter], training: Dict[str, Any],
                            total_steps: int) -> Optimizer:
    """A recipe's ``Training`` section (e.g. ``models.presets.
    DFAUST_I_ROT_PCA_2F_TRAINING``) -> :func:`make_optimizer`, with
    ``accum_grads`` micro-batches per update and ``total_steps``
    micro-batches in all.  Unlike the JAX package's ``train/run.py``, the
    section's ``div_factor`` and ``final_div_factor`` are honoured."""
    return make_optimizer(
        params, float(training["max_lr"]), total_steps,
        weight_decay=float(training.get("weight_decay", 0.0)),
        clip_grad_norm=training.get("clip_grads"),
        accum_steps=int(training.get("accum_grads", 1)),
        pct_start=float(training.get("pct_start", 0.3)),
        div_factor=float(training.get("div_factor", 25.0)),
        final_div_factor=float(training.get("final_div_factor", 1e4)),
    )
