"""Optimizer construction: ``varnet_tpu/train/optim.py``'s optax chains as
``torch.optim`` optimizers with optax's numerics.

* adam: :class:`AdamF32BiasCorrection` (b1 0.9, b2 0.999, eps 1e-8).  optax
  computes the bias corrections 1 - b^t in f32, where 1 - 0.999 is off by
  4.7e-5; ``torch.optim.Adam`` computes them in f64, and the two land 2e-5
  apart (relative) after 10 steps.  The port keeps optax's numerics.
* rmsprop: optax.rmsprop decays by 0.9 and adds eps INSIDE the square root
  (``g / sqrt(nu + eps)``); ``torch.optim.RMSprop`` adds it outside, so
  :class:`RMSpropEpsInSqrt` implements optax's form.
* sgd: ``torch.optim.SGD`` without momentum.
* decay: ``LambdaLR`` stepped once per update, lr * rate^(step / decay_steps)
  (optax.exponential_decay, staircase off).
* clip: optax.clip_by_global_norm (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``).

``Optimizer.state_dict()`` / ``load_state_dict()`` carry the slots, Adam's count
and the schedule's step through a checkpoint (``train/checkpoint.py``), so a
resumed run continues the bias correction and the decay where they stopped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer + schedule selection (reference ctor kwargs equivalent).

    name:        'adam' | 'rmsprop' | 'sgd'
    lr:          base learning rate
    decay_rate:  if set, exponential decay factor applied every
                 ``decay_steps`` steps (staircase=False)
    decay_steps: period for the exponential decay
    grad_clip:   optional global-norm gradient clip
    """

    name: str = "adam"
    lr: float = 1e-3
    decay_rate: Optional[float] = None
    decay_steps: int = 10_000
    grad_clip: Optional[float] = None


class AdamF32BiasCorrection(torch.optim.Optimizer):
    """optax.adam: m_hat / (sqrt(v_hat) + eps) with f32 bias corrections.

    One ``torch._foreach_*`` launch per elementwise op over all parameters; the
    bias corrections are host f32 scalars, so a step copies nothing to the device."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            ps = [p for p in group["params"] if p.grad is not None]
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(count=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
                self.state[p]["count"] += 1
            if not ps:
                continue
            gs = [p.grad for p in ps]
            ms = [self.state[p]["m"] for p in ps]
            vs = [self.state[p]["v"] for p in ps]
            count = np.float32(self.state[ps[0]]["count"])
            bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
            bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(ms, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(ps, update)


class RMSpropEpsInSqrt(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay nu + (1 - decay) g^2;  p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.sub_(group["lr"] * p.grad * torch.rsqrt(nu + group["eps"]))


class Optimizer:
    """One update per :meth:`step` from the parameters' ``.grad``: global-norm
    clip, then the optimizer, then the per-step schedule."""

    def __init__(self, cfg: OptimizerConfig, params):
        self.params = list(params)
        self.name = cfg.name
        if cfg.name == "adam":
            self.opt = AdamF32BiasCorrection(self.params, lr=cfg.lr)
        elif cfg.name == "rmsprop":
            self.opt = RMSpropEpsInSqrt(self.params, lr=cfg.lr)
        elif cfg.name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=cfg.lr)
        else:
            raise ValueError(f"unknown optimizer '{cfg.name}' (adam|rmsprop|sgd)")
        self.sched = None
        if cfg.decay_rate is not None:
            rate, steps = float(cfg.decay_rate), int(cfg.decay_steps)
            self.sched = torch.optim.lr_scheduler.LambdaLR(
                self.opt, lambda step: rate ** (step / steps))
        self.clip = None if cfg.grad_clip is None else float(cfg.grad_clip)

    @torch.no_grad()
    def step(self):
        if self.clip is not None:
            # on the device, no host sync: factor 1 below the clip norm
            norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in self.params))
            factor = torch.clamp(self.clip / norm, max=1.0)
            for p in self.params:
                p.grad.mul_(factor)
        self.opt.step()
        if self.sched is not None:
            self.sched.step()

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The optimizer's state in a layout fixed from the first step on (so
        a checkpoint's structure can be checked against a fresh optimizer's):
        the name, the slot tensors per parameter (adam: ``count``, ``m``,
        ``v``; rmsprop: ``nu``; zeros before the first step, which is the
        state a first step creates), and the schedule's step and rates (its
        lambda is rebuilt from the config, not stored)."""
        state = [self.opt.state.get(p, {}) for p in self.params]
        out = {"name": self.name, "slots": {}, "sched": None}
        slots = {"adam": ("m", "v"), "rmsprop": ("nu",)}.get(self.name, ())
        for key in slots:
            out["slots"][key] = [s[key] if key in s else torch.zeros_like(p)
                                 for s, p in zip(state, self.params)]
        if self.name == "adam":
            out["count"] = int(state[0].get("count", 0)) if state else 0
        if self.sched is not None:
            out["sched"] = {"last_epoch": int(self.sched.last_epoch),
                            "step_count": int(self.sched._step_count),
                            "lrs": [float(g["lr"]) for g in self.opt.param_groups]}
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Inverse of :meth:`state_dict` (the slot tensors are copied into the
        optimizer's own, on the parameters' device)."""
        if sd["name"] != self.name or (sd["sched"] is None) != (self.sched is None):
            raise ValueError(f"optimizer state of '{sd['name']}' (schedule "
                             f"{sd['sched'] is not None}) does not fit '{self.name}' "
                             f"(schedule {self.sched is not None})")
        with torch.no_grad():
            for i, p in enumerate(self.params):
                st = self.opt.state[p]
                for key, tensors in sd["slots"].items():
                    st[key] = tensors[i].to(device=p.device, dtype=p.dtype).clone()
                if self.name == "adam":
                    st["count"] = int(sd["count"])
        if self.sched is not None:
            self.sched.last_epoch = int(sd["sched"]["last_epoch"])
            self.sched._step_count = int(sd["sched"]["step_count"])
            for g, lr in zip(self.opt.param_groups, sd["sched"]["lrs"]):
                g["lr"] = float(lr)
            self.sched._last_lr = [float(lr) for lr in sd["sched"]["lrs"]]


def make_optimizer(cfg: OptimizerConfig, params) -> Optimizer:
    return Optimizer(cfg, params)
