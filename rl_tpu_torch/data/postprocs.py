"""Post-collection batch processors (counterpart of
:mod:`rl_tpu.data.postprocs`; ``MultiStep`` is ported).

``MultiStep`` folds n-step returns into a time-major ``[T, ...]`` batch:
each transition's reward becomes the discounted sum of up to ``n_steps``
rewards, and its ``"next"`` content that of the step where the sum
stopped, so a one-step TD loss trains on n-step targets unchanged
(``bootstrap_discount`` reads ``"steps_to_next_obs"``). The collector
applies it to each batch (``Collector(postproc=MultiStep(...))``).
"""

from __future__ import annotations

import torch

from .._stubs import not_ported
from .arraydict import ArrayDict

__all__ = ["MultiStep", "DensifyReward"]


class MultiStep:
    """n-step reward folding over a time-major batch.

    For each t: ``R_t = sum_{k<n} gamma^k r_{t+k}``, the sum stopping after
    a done and at the batch's end; ("next", ...) becomes the content of the
    step where it stopped; writes ``"steps_to_next_obs"`` (the rewards
    folded, int32) and keeps the original reward at ``("next",
    "original_reward")``.
    """

    def __init__(self, gamma: float = 0.99, n_steps: int = 3):
        self.gamma = gamma
        self.n_steps = n_steps

    def __call__(self, batch: ArrayDict) -> ArrayDict:
        T = batch.batch_shape[0]
        nxt = batch["next"]
        reward, done = nxt["reward"], nxt["done"]
        nd = (~done).to(torch.float32)
        folded = reward
        alive = torch.ones_like(nd)  # steps t .. t+k-1 all not done
        base = torch.arange(T, device=done.device).reshape(
            (T,) + (1,) * (done.dim() - 1)).expand(done.shape)
        src = base  # the step whose "next" content the transition takes
        steps = torch.ones(done.shape, dtype=torch.int32, device=done.device)
        avail = torch.ones_like(nd)
        for k in range(1, self.n_steps):
            # the window grows only while step t+k exists (the batch's end
            # is a cut) and step t+k-1 was not done
            avail = _shift_back(avail, 1)
            alive = alive * _shift_back(nd, k - 1) * avail
            folded = folded + (self.gamma**k) * alive * _shift_back(reward, k)
            src = torch.where(alive > 0, _shift_back(base, k, fill_last=True), src)
            steps = steps + (alive > 0).to(torch.int32)

        def gather_t(x):
            if x.dim() < src.dim():
                return x
            idx = src.reshape(tuple(src.shape) + (1,) * (x.dim() - src.dim()))
            return torch.gather(x, 0, idx.expand(tuple(src.shape) + tuple(x.shape[src.dim():])))

        new_next = nxt.apply(gather_t).set("reward", folded).set("original_reward", reward)
        return batch.set("next", new_next).set("steps_to_next_obs", steps)


def _shift_back(x: torch.Tensor, k: int, fill_last: bool = False) -> torch.Tensor:
    """``x[t] <- x[t + k]`` along axis 0; the tail takes zeros, or the last
    row with ``fill_last``."""
    if k == 0:
        return x
    pad = x[-1:] if fill_last else torch.zeros_like(x[:1])
    return torch.cat([x[k:], pad.repeat_interleave(k, dim=0)], dim=0)


DensifyReward = not_ported("DensifyReward", __name__, "A7: the remaining postprocessors")
