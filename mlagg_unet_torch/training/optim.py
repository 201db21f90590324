"""The optimizer chains of the recipes: clip by global norm, then the
recipe's optimizer with a per-step learning rate, as the ``optax.chain``s of
``mlagg_unet_tpu/training/trainer.py:276-311``:

- ``sgd``: ``add_decayed_weights(wd)`` -> ``sgd(lr, momentum=0.99,
  nesterov=True)``, which is ``torch.optim.SGD(momentum=0.99,
  nesterov=True, weight_decay=wd)``: the trace ``t = g + 0.99 t`` starts
  from zero, so its first value is torch's first buffer;
- ``adamw``: ``adamw(lr, eps, wd)``, which is ``torch.optim.AdamW`` with
  betas (0.9, 0.999): the same bias-corrected moments, ``eps`` outside the
  square root and weight decay decoupled, scaled by the learning rate;
- ``adamw_amsgrad``: ``scale_by_amsgrad(eps)`` -> ``add_decayed_weights(wd)``
  -> ``scale_by_learning_rate(lr)``. optax keeps the running maximum of the
  bias-corrected second moment where torch's ``amsgrad`` keeps that of the
  uncorrected one, so it is written out here (``AMSGrad``);
- ``adam_l2``: ``add_decayed_weights(wd)`` -> ``adam(lr, eps)``, which is
  ``torch.optim.Adam(weight_decay=wd)`` (the decay coupled to the gradient);
- ``adan``: ``training/adan.py``'s transform.

``clip_by_global_norm_`` takes optax's form: gradients whose global norm
``n`` reaches ``max_norm`` are scaled by ``max_norm / n``, with no epsilon
in the denominator. ``OptimizerChain`` sets the lr to ``schedule(count)``
before each step, with optax's count: the first step uses ``schedule(0)``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch

from mlagg_unet_torch.training.adan import Adan


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping (a 0-d tensor, no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class AMSGrad(torch.optim.Optimizer):
    """optax's ``scale_by_amsgrad`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``: ``m`` and ``v`` as Adam's, their bias
    corrections in fp32 as optax computes them, ``v_max = max(v_max,
    v_hat)``, ``p -= lr (m_hat / (sqrt(v_max) + eps) + wd p)``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    for k in ("mu", "nu", "nu_max"):
                        st[k] = torch.zeros_like(p)
                g = p.grad
                st["step"] += 1
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = st["mu"] / (1 - b1 ** st["step"])   # fp32, as optax's
                nu_hat = st["nu"] / (1 - b2 ** st["step"])
                torch.maximum(st["nu_max"], nu_hat, out=st["nu_max"])
                u = mu_hat / (st["nu_max"].sqrt() + group["eps"])
                u.add_(p, alpha=group["weight_decay"])
                p.add_(u, alpha=-group["lr"])


def _make(kind: str, params: List[torch.nn.Parameter], lr: float, eps: float,
          weight_decay: float) -> torch.optim.Optimizer:
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.99, nesterov=True,
                               weight_decay=weight_decay)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                                 weight_decay=weight_decay)
    if kind == "adamw_amsgrad":
        return AMSGrad(params, lr=lr, eps=eps, weight_decay=weight_decay)
    if kind == "adam_l2":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                                weight_decay=weight_decay)
    if kind == "adan":
        return Adan(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"optimizer {kind!r}: one of {OPTIMIZERS}")


OPTIMIZERS = ("sgd", "adamw", "adamw_amsgrad", "adam_l2", "adan")


class OptimizerChain:
    """clip_by_global_norm -> the optimizer ``kind`` (one of ``OPTIMIZERS``)
    with a per-step learning-rate schedule. ``opt`` is the torch optimizer;
    ``state_dict`` / ``load_state_dict`` carry ``{"count", kind: opt's
    state}``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str, schedule: Callable,
                 clip_norm: float, eps: float, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.kind = kind
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.opt = _make(kind, self.params, schedule(0), eps, weight_decay)

    def step(self) -> torch.Tensor:
        """Clip the parameters' gradients, then one optimizer step; returns
        the global gradient norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"count": self.count, self.kind: self.opt.state_dict()}

    def holds_state(self, state) -> bool:
        """Whether ``state`` is this chain's ``state_dict`` (an optax state
        from a JAX checkpoint is not)."""
        return isinstance(state, dict) and self.kind in state and "count" in state

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state[self.kind])
        self.count = int(state["count"])
