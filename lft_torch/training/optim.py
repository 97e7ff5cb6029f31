"""Optimizer: Adam + StepLR with the reference's and the JAX package's
semantics (counterpart of lft_tpu/training/optim.py).

The reference trains with `Adam(lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay=decay_rate)` and `StepLR(step_size=n_steps, gamma)`
(reference train.py:77-84): classic Adam with eps outside the sqrt and the
weight decay added to the gradient before the moments, the learning rate
multiplied by gamma every n_steps epochs. As in the JAX package (an optax
chain), the schedule is indexed by optimizer steps and evaluated on the
step count before the update, in float32.

The state carries across packages: `state_flat` writes, and
`opt_state_from_jax_flat` reads, the optax chain's leaves as the JAX
package's checkpoints hold them (`leaf0000` Adam's step count, then `mu` of
every parameter in sorted-name order, then `nu` in the same order, last the
schedule's step count; `add_decayed_weights` adds no leaf).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _pow_f32(base: float, k: int) -> np.float32:
    """base ** k for an integer k >= 0 in float32, by binary powering: the
    rounding of XLA's power with an integer exponent, which lft_tpu's
    schedule takes on its int32 step count. Equal to it bit for bit wherever
    the result is a normal float32."""
    r, b = np.float32(1.0), np.float32(base)
    while k:
        if k & 1:
            r = np.float32(r * b)
        b = np.float32(b * b)
        k >>= 1
    return r


def step_lr_schedule(base_lr: float, gamma: float, n_steps_epochs: int,
                     steps_per_epoch: int):
    """lr(step) = base_lr * gamma ** (epoch // n_steps_epochs), in float32
    as the JAX package evaluates it (a rounding of the float64 value is an
    ulp off at a gamma that is not a power of two)."""
    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return float(np.float32(base_lr) * _pow_f32(gamma, epoch // n_steps_epochs))
    return schedule


def cosine_schedule(base_lr: float, total_epochs: int, steps_per_epoch: int):
    """Cosine decay to 0 over the whole run (optax.cosine_decay_schedule)."""
    decay_steps = max(total_epochs * steps_per_epoch, 1)

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


class Optimizer:
    """`torch.optim.Adam` over the params in sorted-name order, with the
    learning rate of the schedule set before every step. `count` is the
    schedule's step count; Adam keeps its own (they differ after a resume
    from a `.pth`, which restarts the moments but not the schedule)."""

    def __init__(self, params: Dict[str, torch.Tensor], args, steps_per_epoch: int):
        self.names = sorted(params)
        self.params = [params[n] for n in self.names]
        if getattr(args, "lr_schedule", "step") == "cosine":
            self.schedule = cosine_schedule(args.lr, args.epoch, steps_per_epoch)
        else:
            self.schedule = step_lr_schedule(args.lr, args.gamma, args.n_steps,
                                             steps_per_epoch)
        self.adam = torch.optim.Adam(self.params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=args.decay_rate)
        self.count = 0

    def lr(self) -> float:
        """The learning rate of the next step, rounded to float32 as optax's."""
        return float(np.float32(self.schedule(self.count)))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.count += 1

    def state_flat(self) -> Dict[str, np.ndarray]:
        """The optax chain's leaves (see the module docstring)."""
        st = [self.adam.state.get(p, {}) for p in self.params]
        adam_count = int(st[0]["step"]) if st[0] else 0
        zeros = lambda p: np.zeros(tuple(p.shape), np.float32)
        moments = lambda key: [s[key].detach().cpu().numpy() if s else zeros(p)
                               for s, p in zip(st, self.params)]
        leaves = ([np.asarray(adam_count, np.int32)] + moments("exp_avg")
                  + moments("exp_avg_sq") + [np.asarray(self.count, np.int32)])
        return {f"leaf{i:04d}": a for i, a in enumerate(leaves)}

    def load_state(self, state: dict) -> None:
        """Restore the state `opt_state_from_jax_flat` returns."""
        self.adam.state.clear()
        if state["count"]:
            for name, p in zip(self.names, self.params):
                self.adam.state[p] = {
                    "step": torch.tensor(float(state["count"]), dtype=torch.float32),
                    "exp_avg": state["mu"][name].to(p.device).clone(),
                    "exp_avg_sq": state["nu"][name].to(p.device).clone()}
        self.count = int(state["schedule_count"])


def opt_state_from_jax_flat(flat: Dict[str, np.ndarray],
                            params: Dict[str, torch.Tensor]) -> dict:
    """A checkpoint's optimizer leaves (`leafNNNN`, written by either
    package) -> {count, mu, nu, schedule_count} with mu and nu float32
    tensors by parameter name, for `Optimizer.load_state`."""
    names = sorted(params)
    P = len(names)
    if len(flat) != 2 * P + 2:
        raise ValueError(f"optimizer state has {len(flat)} leaves; an Adam chain over "
                         f"{P} parameters has {2 * P + 2}")
    leaf = lambda i: np.asarray(flat[f"leaf{i:04d}"])
    state = dict(count=int(leaf(0)), schedule_count=int(leaf(2 * P + 1)), mu={}, nu={})
    for i, n in enumerate(names):
        for key, j in (("mu", 1 + i), ("nu", 1 + P + i)):
            a = leaf(j)
            if a.shape != tuple(params[n].shape):
                raise ValueError(f"optimizer leaf {j} ({key} of {n}): shape {a.shape}, "
                                 f"want {tuple(params[n].shape)}")
            state[key][n] = torch.from_numpy(np.array(a, dtype=np.float32))
    return state


def make_optimizer(params: Dict[str, torch.Tensor], args, steps_per_epoch: int) -> Optimizer:
    """Adam + the run's schedule over `params` (leaf tensors that require
    grad; the optimizer updates them in place)."""
    return Optimizer(params, args, steps_per_epoch)


class SGD:
    """Plain SGD (optax.sgd without momentum) with `Optimizer`'s interface.
    Its update is the gradient times `lr`, so the data-parallel checks use
    it to isolate the gradient average (Adam's m / sqrt(v) amplifies f32
    noise in near-zero gradients into lr-sized differences)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr = [params[k] for k in sorted(params)], lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p.sub_(self.lr * p.grad)
