"""Optimizers and learning-rate schedules with optax 0.2.6 semantics.

The JAX package names its optimizers and schedules after optax's
(``elephas_tpu/api/compile.py:27-46``). optax is a separate library, so
this module has no counterpart file: it copies the update rules the
names resolve to, because torch's look alike and differ:

- ``sgd`` / ``momentum``: optax's trace, ``t = g + momentum * t``;
- ``adam``: eps outside the square root, ``eps_root`` inside it;
- ``adamw``: adam plus ``weight_decay * p`` (optax's default 1e-4;
  torch's ``AdamW`` defaults to 1e-2 and decays before the step);
- ``rmsprop``: decay 0.9 and ``rsqrt(nu + eps)``, eps inside the root
  (torch: alpha 0.99, eps outside), momentum applied after the learning
  rate;
- ``adagrad``: accumulator starts at 0.1, ``rsqrt(sum + eps)`` with eps
  1e-7, and 0 where the sum is 0 (torch differs in all three);
- ``lamb``: adam, plus ``weight_decay * p``, scaled by the trust ratio
  ``|p| / |u|`` (1 where either norm is 0); torch has none.

Each optimizer is a ``torch.optim.Optimizer``. Its param groups hold
optax's hyperparameters by optax's names, ``lr`` (the learning rate of
the next update, which a caller may change), ``schedule`` (``None`` or a
function of the update count that sets ``lr`` before each update) and
``count`` (updates taken). As in optax, the first update is at count 0
for the schedule and at count 1 for bias corrections; a parameter
without a gradient is updated as if its gradient were 0. A step updates
a whole param group with ``torch._foreach_*`` ops. The per-param
state carries optax's names (``trace``; ``mu``, ``nu``; ``sum_of_squares``).

Schedules are plain functions of the update count, returning floats.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


class OptaxRule(torch.optim.Optimizer):
    """Base of the optax rules: subclasses define ``updates``, the change
    of every parameter of a group (learning rate included) at update
    ``count`` (1-based). Each rule works on the whole group at once with
    ``torch._foreach_*`` ops, so a step launches a few multi-tensor
    kernels per operation, not one per parameter."""

    def __init__(self, params, learning_rate, **hyper):
        schedule = learning_rate if callable(learning_rate) else None
        lr = float(schedule(0) if schedule is not None else learning_rate)
        super().__init__(params, dict(lr=lr, schedule=schedule, count=0, **hyper))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if group["schedule"] is not None:
                group["lr"] = float(group["schedule"](group["count"]))
            group["count"] += 1
            params = group["params"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            torch._foreach_add_(params, self.updates(group, params, grads, group["count"]))
        return loss

    def updates(self, group, params, grads, count):
        raise NotImplementedError

    def _states(self, params, key, fill):
        """``state[key]`` of each parameter, created full of ``fill``."""
        return [self.state[p].setdefault(key, torch.full_like(p, fill)) for p in params]

    def _moment(self, params, key, g, decay, fill=0.0):
        """optax's ``(1 - decay) * g + decay * t``, in place on ``state[key]``."""
        t = self._states(params, key, fill)
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g, alpha=1 - decay)
        return t

    def _trace(self, params, u, decay, nesterov):
        """optax's ``trace``: ``t = u + decay * t``; returns the update."""
        t = self._states(params, "trace", 0.0)
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, u)
        return torch._foreach_add(u, t, alpha=decay) if nesterov else t


def _debias(decay, count):
    """optax's bias correction ``1 - decay ** count``, taken in float32 as
    optax takes it; a Python float that a float32 tensor divides by
    exactly."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


class SGD(OptaxRule):
    """``optax.sgd``: the gradient, through a trace when ``momentum`` is set."""

    def __init__(self, params, learning_rate, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(params, learning_rate, momentum=momentum, nesterov=nesterov)

    def updates(self, group, params, grads, count):
        if group["momentum"] is not None:
            grads = self._trace(params, grads, group["momentum"], group["nesterov"])
        return torch._foreach_mul(grads, -group["lr"])


class AdamFamily(OptaxRule):
    """``optax.scale_by_adam``, then ``add_decayed_weights`` when
    ``weight_decay`` is not None, then ``scale_by_trust_ratio`` when
    ``trust_ratio``: adam, adamw and lamb."""

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay: Optional[float] = None,
                 trust_ratio: bool = False, nesterov: bool = False):
        super().__init__(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay, trust_ratio=trust_ratio,
                         nesterov=nesterov)

    def updates(self, group, params, grads, count):
        b1, b2 = group["b1"], group["b2"]
        mu = self._moment(params, "mu", grads, b1)
        nu = self._states(params, "nu", 0.0)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        if group["nesterov"]:
            u = torch._foreach_div(mu, _debias(b1, count + 1))
            torch._foreach_mul_(u, b1)
            torch._foreach_add_(u, torch._foreach_div(grads, _debias(b1, count)),
                                alpha=1 - b1)
        else:
            u = torch._foreach_div(mu, _debias(b1, count))
        den = torch._foreach_div(nu, _debias(b2, count))
        if group["eps_root"]:
            torch._foreach_add_(den, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(u, den)
        if group["weight_decay"] is not None:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        if group["trust_ratio"]:
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
            torch._foreach_mul_(u, list(ratio.unbind()))
        torch._foreach_mul_(u, -group["lr"])
        return u


class RMSprop(OptaxRule):
    """``optax.rmsprop`` (``scale_by_rms``, or ``scale_by_stddev`` when
    ``centered``; then the learning rate; then a trace when ``momentum``)."""

    def __init__(self, params, learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(params, learning_rate, decay=decay, eps=eps,
                         initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
                         centered=centered, momentum=momentum, nesterov=nesterov,
                         bias_correction=bias_correction)

    def updates(self, group, params, grads, count):
        decay = group["decay"]
        nu = self._moment(params, "nu", torch._foreach_mul(grads, grads), decay,
                          group["initial_scale"])
        mu = self._moment(params, "mu", grads, decay) if group["centered"] else None
        if group["bias_correction"]:
            nu = torch._foreach_div(nu, _debias(decay, count))
            mu = torch._foreach_div(mu, _debias(decay, count)) if mu is not None else None
        var = torch._foreach_addcmul(nu, mu, mu, value=-1) if mu is not None else nu
        if group["eps_in_sqrt"]:
            scaling = torch._foreach_add(var, group["eps"])
            torch._foreach_rsqrt_(scaling)
        else:
            scaling = torch._foreach_sqrt(var)
            torch._foreach_add_(scaling, group["eps"])
            torch._foreach_reciprocal_(scaling)
        u = torch._foreach_mul(scaling, grads)
        torch._foreach_mul_(u, -group["lr"])
        if group["momentum"] is not None:
            u = self._trace(params, u, group["momentum"], group["nesterov"])
        return u


class Adagrad(OptaxRule):
    """``optax.adagrad`` (``scale_by_rss``)."""

    def __init__(self, params, learning_rate, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, learning_rate,
                         initial_accumulator_value=initial_accumulator_value, eps=eps)

    def updates(self, group, params, grads, count):
        total = self._states(params, "sum_of_squares", group["initial_accumulator_value"])
        torch._foreach_addcmul_(total, grads, grads)
        inv = torch._foreach_add(total, group["eps"])
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(t > 0, i, 0.0) for t, i in zip(total, inv)]
        u = torch._foreach_mul(inv, grads)
        torch._foreach_mul_(u, -group["lr"])
        return u


# optax's aliases, one builder per name, with optax's signatures.

def sgd(params, learning_rate, momentum=None, nesterov=False):
    return SGD(params, learning_rate, momentum, nesterov)


def adam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, *,
         nesterov=False):
    return AdamFamily(params, learning_rate, b1, b2, eps, eps_root, nesterov=nesterov)


def adamw(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4, *, nesterov=False):
    return AdamFamily(params, learning_rate, b1, b2, eps, eps_root, weight_decay,
                      nesterov=nesterov)


def rmsprop(params, learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0,
            eps_in_sqrt=True, centered=False, momentum=None, nesterov=False,
            bias_correction=False):
    return RMSprop(params, learning_rate, decay, eps, initial_scale, eps_in_sqrt,
                   centered, momentum, nesterov, bias_correction)


def adagrad(params, learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return Adagrad(params, learning_rate, initial_accumulator_value, eps)


def lamb(params, learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
         weight_decay=0.0):
    return AdamFamily(params, learning_rate, b1, b2, eps, eps_root, weight_decay,
                      trust_ratio=True)


# ------------------------------------------------------------- schedules


def constant_schedule(value) -> Callable:
    return lambda count: value


def polynomial_schedule(init_value, end_value, power, transition_steps,
                        transition_begin=0) -> Callable:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        done = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1 - done / transition_steps) ** power + end_value

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate, transition_begin=0,
                      staircase=False, end_value=None) -> Callable:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        elapsed = count - transition_begin
        power = elapsed / transition_steps
        if staircase:
            power = math.floor(power)
        value = init_value if elapsed <= 0 else init_value * decay_rate ** power
        if end_value is not None:
            value = max(value, end_value) if decay_rate < 1.0 else min(value, end_value)
        return value

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0, exponent=1.0) -> Callable:
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}."
        )

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales=None) -> Callable:
    boundaries = sorted((boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in boundaries):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")

    def schedule(count):
        value = init_value
        for threshold, scale in boundaries:
            if count >= threshold:
                value *= scale
        return value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0, exponent=1.0) -> Callable:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = polynomial_schedule(init_value, peak_value, 1, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count):
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule
