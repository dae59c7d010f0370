"""Optimizer, schedules, parameter masks and EMA (port of yolo_dbl_tpu/engine/train_state.py).

The JAX package builds one optax chain (`build_optimizer`, :135):

    MultiSteps(                                   # only with grad_accumulate
      chain(apply_if_finite(                      # skip non-finite gradients
              chain(clip_by_global_norm(10),
                    <SGD | Adam | RMSProp scaling and coupled weight decay>,
                    scale_by_learning_rate(schedule)),
              max_consecutive_errors=100),
            freeze))                              # zero the frozen updates

`Optimizer` below is that chain as explicit tensor updates, in the same
order, on the model's parameter tensors (multi-tensor `torch._foreach_*`
ops, a few launches per step for all parameters). The state is the chain's:
one count, which the skipped steps do not advance, and the moment buffers of
every parameter, frozen ones included. Masks are rules on the JAX path of
each parameter (utils/convert.py `jax_param_paths`), so they pick the same
leaves as the JAX masks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.convert import jax_param_paths

MAX_GRAD_NORM = 10.0
MAX_CONSECUTIVE_NONFINITE = 100


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True for parameters that receive weight decay: conv/dense kernels
    outside BatchNorm; not biases, BN, `prototype_base` or `gate` (:32)."""
    out = {}
    for name, path in jax_param_paths(model).items():
        keys = path.split("/")
        out[name] = "bn" not in keys and keys[-1] == "kernel"
    return out


def freeze_mask(model: torch.nn.Module, freeze) -> Optional[Dict[str, bool]]:
    """True for parameters that receive no update, or None when nothing is
    frozen (:48). `freeze=N` freezes layers m0..m{N-1}; a list freezes the
    layer indices it holds and every parameter whose JAX path contains one of
    its strings."""
    if freeze in (None, 0, False) or (isinstance(freeze, (list, tuple)) and not freeze):
        return None
    items = list(freeze) if isinstance(freeze, (list, tuple)) else list(range(int(freeze)))
    idx_keys, fragments = set(), []
    for x in items:
        if isinstance(x, bool):
            raise ValueError(f"freeze entries must be layer indices or names, got {x}")
        if isinstance(x, int) or (isinstance(x, str) and x.isdigit()):
            idx_keys.add(f"m{int(x)}")
        else:
            fragments.append(str(x))
    out = {}
    for name, path in jax_param_paths(model).items():
        out[name] = path.split("/")[0] in idx_keys or any(f in path for f in fragments)
    return out


def auto_optimizer(nc: int, lr0: float, momentum: float, iterations: float) -> Tuple[str, float, float]:
    """The 'auto' optimizer heuristic (:97)."""
    if iterations > 10000:
        return "SGD", 0.01, 0.9
    lr_fit = round(0.002 * 5 / (4 + nc), 6)
    return "AdamW", lr_fit, 0.9


def make_lr_schedule(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
                     warmup_epochs: float = 3.0, cos_lr: bool = False) -> Callable[[int], float]:
    """Per-step learning rate (:105): linear warmup over max(warmup_epochs
    epochs, 100) steps from exactly 0 at step 0, then cosine or linear decay
    by epoch."""
    warmup_steps = max(round(warmup_epochs * steps_per_epoch), 100)

    def lf(epoch):
        if cos_lr:
            return ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
        return (1 - epoch / epochs) * (1.0 - lrf) + lrf

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        base = lr0 * lf(min(epoch, epochs))
        if step < warmup_steps:
            return base * min(max(step / warmup_steps, 0.0), 1.0)
        return base

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it: at small counts the
    float32 rounding of 1 - 0.999**count is 2e-5 of its value, which 120
    Adam steps carry into the parameters."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


class Optimizer:
    """The optax chain of `build_optimizer` as explicit updates (see the
    module note). `step(grads)` takes one gradient per parameter, in the
    order of `params`, and updates the parameters in place."""

    def __init__(self, names: Sequence[str], params: Sequence[torch.Tensor], name: str,
                 schedule: Callable[[int], float], momentum: float, weight_decay: float,
                 decay: Dict[str, bool], frozen: Optional[Dict[str, bool]] = None,
                 accumulate: int = 1):
        if name not in ("SGD", "AdamW", "Adam", "NAdam", "RAdam", "RMSProp"):
            raise ValueError(f"unknown optimizer '{name}'")
        self.name, self.schedule = name, schedule
        self.momentum, self.weight_decay = momentum, weight_decay
        self.params = list(params)
        self.decay_idx = [i for i, n in enumerate(names) if decay[n]]
        self.train_idx = [i for i, n in enumerate(names) if not (frozen or {}).get(n, False)]
        self.count = 0  # the inner chain's step count: skipped steps do not advance it
        self.notfinite_count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        if name == "SGD":
            self.trace = zeros()
        elif name == "RMSProp":
            self.nu = zeros()
        else:
            self.mu, self.nu = zeros(), zeros()
        self.accumulate = max(int(accumulate), 1)
        self.mini_step = 0
        self.acc = zeros() if self.accumulate > 1 else None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        """One call of the chain."""
        grads = list(grads)
        if self.accumulate > 1:
            # optax.MultiSteps, mean of the micro-batch gradients
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(grads, self.acc), n + 1))
            self.mini_step = (n + 1) % self.accumulate
            if not self.mini_step:
                self._apply_if_finite(self.acc)
                torch._foreach_mul_(self.acc, 0.0)  # (1 - emit) * acc: NaN stays, as in optax
        else:
            self._apply_if_finite(grads)

    def _apply_if_finite(self, grads: List[torch.Tensor]):
        # optax.apply_if_finite: a non-finite gradient leaves params and state
        # as they were, unless more than MAX_CONSECUTIVE_NONFINITE in a row.
        # Reading `finite` is the step's one host sync.
        finite = bool(torch.isfinite(torch.stack(torch._foreach_norm(grads, math.inf))).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not (finite or self.notfinite_count > MAX_CONSECUTIVE_NONFINITE):
            return
        updates = self._updates(self._clip(grads))
        lr = self.schedule(self.count)
        self.count += 1
        # frozen parameters get a zero update
        torch._foreach_add_([self.params[i] for i in self.train_idx],
                            [updates[i] for i in self.train_idx], alpha=-lr)

    def _clip(self, grads):
        # clip_by_global_norm: t unchanged below the bound, else (t / norm) * bound
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = norm < MAX_GRAD_NORM
        div = torch.where(below, torch.ones_like(norm), norm)
        mul = torch.where(below, torch.ones_like(norm), torch.full_like(norm, MAX_GRAD_NORM))
        return torch._foreach_mul(torch._foreach_div(grads, div), mul)

    def _add_decay(self, updates):
        if self.weight_decay and self.decay_idx:
            torch._foreach_add_([updates[i] for i in self.decay_idx],
                                [self.params[i] for i in self.decay_idx], alpha=self.weight_decay)

    def _updates(self, g):
        """The chain between the clip and the learning rate, on clipped gradients."""
        if self.name == "SGD":
            # add_decayed_weights, then trace(nesterov): t = g + m t; u = g + m t
            self._add_decay(g)
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, g)
            return torch._foreach_add(g, self.trace, alpha=self.momentum)
        if self.name == "RMSProp":
            # scale_by_rms(decay=0.9, eps=1e-8 inside the root), then decay
            torch._foreach_mul_(self.nu, 0.9)
            torch._foreach_addcmul_(self.nu, g, g, value=0.1)
            u = torch._foreach_div(g, torch._foreach_sqrt(torch._foreach_add(self.nu, 1e-8)))
            self._add_decay(u)
            return u
        # scale_by_adam(b1=momentum, b2=0.999, eps=1e-8), then decay
        b1, b2, t = self.momentum, 0.999, self.count + 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, _bias_correction(b2, t)))
        torch._foreach_add_(denom, 1e-8)
        u = torch._foreach_div(torch._foreach_div(self.mu, _bias_correction(b1, t)), denom)
        self._add_decay(u)
        return u


def build_optimizer(model: torch.nn.Module, nc: int, cfg, steps_per_epoch: int
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """The optimizer and its schedule from the training config (:135)."""
    name, lr0, momentum = cfg.optimizer, cfg.lr0, cfg.momentum
    if name == "auto":
        name, lr0, momentum = auto_optimizer(nc, lr0, momentum, steps_per_epoch * cfg.epochs)
    # decay scaled by batch * accumulate / nbs, as the reference does
    accumulate = max(round(cfg.nbs / cfg.batch), 1)
    weight_decay = cfg.weight_decay * cfg.batch * accumulate / cfg.nbs
    schedule = make_lr_schedule(lr0, cfg.lrf, cfg.epochs, steps_per_epoch, cfg.warmup_epochs,
                                cfg.cos_lr)
    names, params = zip(*model.named_parameters())
    opt = Optimizer(names, params, name, schedule, momentum, weight_decay, decay_mask(model),
                    freeze_mask(model, cfg.freeze),
                    accumulate if cfg.grad_accumulate else 1)
    return opt, schedule


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Sequence[torch.Tensor], updates: float,
               decay: float = 0.9999, tau: float = 2000.0):
    """Ramped EMA of the parameters, in place: d = decay (1 - exp(-updates /
    tau)); ema = ema d + p (1 - d) (:215)."""
    d = decay * (1.0 - math.exp(-updates / tau))
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, list(params), alpha=1.0 - d)
