"""Adan (Xie et al. 2022) as a torch optimizer: a copy of the JAX package's
optax transform (``mlagg_unet_tpu/training/adan.py``), which follows the
reference's nnUNetTrainerAdan (lucidrains' ``adan_pytorch`` with betas
(0.02, 0.08, 0.01)):

    m_t = (1-b1) m + b1 g
    v_t = (1-b2) v + b2 (g - g_prev)          (zero on the first step)
    n_t = (1-b3) n + b3 (g + (1-b2)(g - g_prev))^2
    p  <- (p - lr (m_t + (1-b2) v_t) / sqrt(n_t + eps)) / (1 + lr wd)

with no bias correction and the weight decay decoupled and multiplicative.
The new parameter is applied as the JAX update ``p + (p_new - p)``.
"""
from __future__ import annotations

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas=(0.02, 0.08, 0.01), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    for k in ("m", "v", "n", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                # g - g_prev is zero on the first step
                diff = (g - st["prev_grad"]) * (0.0 if st["step"] == 0 else 1.0)
                st["m"].mul_(1 - b1).add_(g, alpha=b1)
                st["v"].mul_(1 - b2).add_(diff, alpha=b2)
                st["n"].mul_(1 - b3).add_((g + (1 - b2) * diff) ** 2, alpha=b3)
                step = lr * (st["m"] + (1 - b2) * st["v"]) / torch.sqrt(st["n"] + eps)
                p.add_((p - step) / (1 + lr * wd) - p)
                st["prev_grad"].copy_(g)
                st["step"] += 1
