"""Adam and AMSGrad with optax's semantics, as a ``torch.optim.Optimizer``.

The JAX package trains with ``optax.inject_hyperparams(optax.adam)`` (or
``optax.amsgrad``), after ``optax.add_decayed_weights`` when
``optimizer.weight_decay`` is set (``dmmfods_tpu/trainer.py``). This is the
same update in f32, with optax's f32 constants (it injects ``b1``, ``b2``,
``eps`` and the learning rate as f32 arrays):

    g      = grad + weight_decay * p
    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g**2 + b2 * nu
    mu_hat = mu / (1 - b1**t),  nu_hat = nu / (1 - b2**t)
    nu_max = max(nu_max, nu_hat)                      (AMSGrad only)
    p      = p + (-lr) * mu_hat / (sqrt(nu_hat or nu_max) + eps)

``torch.optim.Adam`` differs in two ways: its AMSGrad keeps the running max
of the raw second moment and divides it by ``1 - b2**t`` afterwards (optax
keeps the max of the bias-corrected one, so the two diverge once gradients
shrink), and it rounds its plain update in another order. The update here
runs as in-place ``torch._foreach_*`` operations over all parameters with
one list of temporaries (the denominator), so a step costs the host a few
calls rather than an allocation per parameter per operation; its fused
multiply-adds round within an ulp or two of optax's separate roundings.
Like optax, every parameter is updated at every step (a missing gradient
counts as zero), and the count ``t`` is shared. The learning rate is read from the param group at
each step, so StepLR-style decay is a host-side assignment
(:func:`dmmfods_tpu_torch.trainer.set_learning_rate`).

State per parameter: ``step`` (a host int, so a step needs no device sync),
``mu``, ``nu`` and, with ``amsgrad``, ``nu_max`` (optax's names).
"""

from __future__ import annotations

import numpy as np
import torch


class Adam(torch.optim.Optimizer):
    """optax's Adam / AMSGrad; ``weight_decay`` is added to the gradient
    first, as optax's ``add_decayed_weights`` chained in front. Dense f32
    parameters only."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False):
        if lr < 0 or eps < 0 or weight_decay < 0 or not all(0 <= b < 1 for b in betas):
            raise ValueError(f"invalid Adam hyperparameters: lr={lr}, betas={betas}, "
                             f"eps={eps}, weight_decay={weight_decay}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, amsgrad=amsgrad))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            self._update_group(group)
        return loss

    def _update_group(self, group):
        params = group["params"]
        if not params:
            return
        amsgrad = group["amsgrad"]
        for p in params:
            if p.is_sparse or (p.grad is not None and p.grad.is_sparse):
                raise RuntimeError("Adam does not support sparse tensors")
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if amsgrad:
                    state["nu_max"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["step"] += 1
        states = [self.state[p] for p in params]
        t = states[0]["step"]
        if any(s["step"] != t for s in states):
            raise RuntimeError("Adam's parameters of one group must share their step count")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        mus = [s["mu"] for s in states]
        nus = [s["nu"] for s in states]

        # optax's hyperparameters are f32: every constant is its f32 value
        f32 = np.float32
        b1, b2 = f32(group["betas"][0]), f32(group["betas"][1])
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=float(f32(group["weight_decay"])))
        torch._foreach_mul_(mus, float(b1))
        torch._foreach_add_(mus, grads, alpha=float(f32(1) - b1))
        torch._foreach_mul_(nus, float(b2))
        torch._foreach_addcmul_(nus, grads, grads, value=float(f32(1) - b2))
        del grads

        # the denominator in one list of temporaries: sqrt(nu_hat or nu_max) + eps
        denom = torch._foreach_div(nus, float(f32(1) - b2 ** t))
        if amsgrad:
            nu_max = [s["nu_max"] for s in states]
            torch._foreach_maximum_(denom, nu_max)
            torch._foreach_copy_(nu_max, denom)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(f32(group["eps"])))
        # p + (-lr) * (mu / (1 - b1**t)) / denom
        step_size = -float(f32(group["lr"])) / float(f32(1) - b1 ** t)
        torch._foreach_addcdiv_(params, mus, denom, value=step_size)
