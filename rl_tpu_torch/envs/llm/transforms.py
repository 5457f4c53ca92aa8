"""Batch-level reward transforms of the RLHF collection path: copies of
:class:`rl_tpu.envs.llm.transforms.KLRewardTransform` and
``PolicyVersion``.

``LLMCollector(reward_transform=...)`` applies them to the collected batch
before group advantages, as the reference does. In the port the batch
arrays are tensors on the rollout device, so the shaping runs there too
(no copy of the log-probs to the host); the rewards come back as a float32
tensor on that device.
"""

from __future__ import annotations

import torch

__all__ = ["KLRewardTransform", "PolicyVersion"]


class KLRewardTransform:
    """reward_i -= coeff * sum_t (log pi(a_t) - log pi_ref(a_t)) over
    response tokens: the sequence-level KL(pi || pi_ref) estimate, each
    token's term clipped to ``[-clip, clip]``. Needs ``ref_log_prob`` in
    the batch (an ``LLMCollector`` built with a reference model)."""

    def __init__(self, coeff: float = 0.1, clip: float | None = 20.0):
        self.coeff = coeff
        self.clip = clip

    def __call__(self, rewards, batch: dict) -> torch.Tensor:
        if "ref_log_prob" not in batch:
            raise ValueError(
                "KLRewardTransform needs ref_log_prob: construct the "
                "LLMCollector with a reference model"
            )
        lp = batch["sample_log_prob"].float()
        mask = batch["assistant_mask"].bool()
        delta = torch.where(mask, lp - batch["ref_log_prob"].float(), 0.0)
        if self.clip is not None:
            delta = delta.clamp(-self.clip, self.clip)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=lp.device)
        return rewards - self.coeff * delta.sum(dim=1)


class PolicyVersion:
    """Stamp each collected batch with the policy version that generated
    it (``batch["policy_version"]``, int32 [B]); the trainer bumps it on
    every weight push."""

    def __init__(self):
        self.version = 0

    def bump(self) -> int:
        self.version += 1
        return self.version

    def __call__(self, rewards, batch: dict):
        n = len(rewards)
        device = batch["tokens"].device if "tokens" in batch else None
        batch["policy_version"] = torch.full((n,), self.version, dtype=torch.int32,
                                             device=device)
        return rewards
