"""AdamW, warmup-cosine schedule and global-norm clipping.

The port of the JAX package's ``train/optimizer.py`` on one device, with
its arithmetic in its order, so that on the CPU the port's update follows
the JAX package's within a few f32 ulps (``tests/test_torch_train.py``
states the bound): gradients cast to f32, clipped by the global norm,
then per leaf ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``delta = (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - b**step``
in f32, ``+ wd p`` on the decay mask, and ``p - lr delta`` cast back to
the parameter's dtype.  ``torch.optim.AdamW`` decays as ``p (1 - lr wd)``
and rounds differently, so it is not used.

Trees are the model's nested dicts of tensors.  :func:`adamw_update`
writes the parameters and the moments in place and returns them (the
JAX package's loop donates both to its jitted step): no second copy of
either is made.  The master copy and the moments are f32 whatever the
parameters' dtype.  Under a mesh the moments inherit the parameters'
partition specs (:func:`opt_specs`, ZeRO-style: each rank updates its
shards) and the caller passes the global norm, summed across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..dist.sharding import P

__all__ = ["AdamWConfig", "schedule", "adamw_init", "ef_init", "adamw_update",
           "opt_specs", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress: str = "none"        # none | int8_ef


def tree_map(fn: Callable, tree, *rest, path: Tuple[str, ...] = (),
             with_path: bool = False):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure), keys in sorted order as the JAX package's tree order;
    with ``with_path`` it receives the key path first."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,), with_path=with_path)
                for k in sorted(tree)}
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: f32, on
    ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> Dict[str, Any]:
    """f32 zero moments beside each leaf, and step 0 (an int32 scalar on
    the parameters' device)."""
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def ef_init(params) -> Dict[str, Any]:
    """Error-feedback residual state for int8 compressed reductions."""
    return {"resid": tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)}


def opt_specs(param_spec_tree, with_ef: bool = False):
    """The optimizer state's spec tree: the moments (and the
    error-feedback residual) as the parameters, the step replicated."""
    out = {"m": param_spec_tree, "v": param_spec_tree, "step": P()}
    if with_ef:
        out["ef"] = {"resid": param_spec_tree}
    return out


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack(
        [_sum_squares(x) for x in tree_leaves(tree)])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


_NO_DECAY = ("ln1", "ln2", "ln1_post", "ln2_post", "scale", "bias", "a_log",
             "d_skip", "dt_bias")


def _decay_mask(path: Tuple[str, ...]) -> bool:
    """Weight decay on matrices only: not on a leaf whose key path names
    a norm, a scale or a bias."""
    return not any(("norm" in n) or n in _NO_DECAY for n in map(str, path))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state,
                 gnorm: Optional[torch.Tensor] = None,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` may be bf16 (the wire dtype); the math
    is f32.  Writes ``params`` and ``state``'s moments in place and
    returns ``(params, state, {"lr", "grad_norm"})``.  ``gnorm`` is the
    global gradient norm, ``global_norm(grads)`` unless given (a mesh
    step sums it across the ranks' shards)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    # The global norm of the f32 gradients; each leaf is cast and scaled
    # again in its update, so that no f32 copy of the whole tree is held.
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(path, p, g, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"], with_path=True)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
