"""GRPO-family RLHF losses and group-relative advantages (counterpart of
:mod:`rl_tpu.objectives.llm.grpo`).

Batch layout (a dict of tensors on one device, produced by
:class:`rl_tpu_torch.collectors.LLMCollector`): ``tokens`` [B, T],
``attention_mask`` [B, T], ``assistant_mask`` [B, T] (True on response
tokens — the loss support), ``sample_log_prob`` [B, T] behavior per-token
log-probs, ``advantage`` [B] or [B, T], optional ``ref_log_prob`` [B, T].

Where the reference takes a params pytree, the port takes the model
(``torch.nn.Module``): ``log_prob_fn(model, batch) -> [B, T]``. Metrics
are a dict of 0-dim tensors on the batch's device, detached, so reading
them is the caller's choice of when to sync.
"""

from __future__ import annotations

import torch

__all__ = ["CISPOLoss", "DAPOLoss", "GRPOLoss", "mc_advantage"]


def _masked_token_mean(x, mask, per_seq_norm: bool = False):
    m = mask.to(x.dtype)
    if per_seq_norm:
        seq = (x * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)
        return seq.mean()
    return (x * m).sum() / m.sum().clamp_min(1.0)


class GRPOLoss:
    """Group-relative PPO over assistant tokens, with a k3 KL penalty to a
    frozen reference (``kl_coeff``, reads ``ref_log_prob``) and an
    optional entropy bonus. ``clip_epsilon`` is one value or
    ``(eps_low, eps_high)``."""

    def __init__(self, log_prob_fn, clip_epsilon: float | tuple[float, float] = 0.2,
                 kl_coeff: float = 0.0, entropy_coeff: float = 0.0,
                 per_seq_norm: bool = False):
        self.log_prob_fn = log_prob_fn
        if isinstance(clip_epsilon, tuple):
            self.eps_low, self.eps_high = clip_epsilon
        else:
            self.eps_low = self.eps_high = clip_epsilon
        self.kl_coeff = kl_coeff
        self.entropy_coeff = entropy_coeff
        self.per_seq_norm = per_seq_norm

    def microbatch_weight(self, batch: dict) -> torch.Tensor:
        """Weight that makes gradient accumulation over microbatches exact:
        the loss normalizes by assistant-token count (or by sequence count
        with ``per_seq_norm``), so microbatch i's gradient is scaled by
        ``w_i`` and the sum divided by ``sum(w_i)``."""
        m = batch["assistant_mask"]
        if self.per_seq_norm:
            return torch.tensor(float(m.shape[0]), device=m.device)
        return m.float().sum()

    def _objective(self, ratio, adv, mask):
        clipped = ratio.clamp(1.0 - self.eps_low, 1.0 + self.eps_high)
        gain = torch.minimum(ratio * adv, clipped * adv)
        outside = (ratio < 1.0 - self.eps_low) | (ratio > 1.0 + self.eps_high)
        return gain, {"clip_fraction": _masked_token_mean(outside.float(), mask).detach()}

    def __call__(self, model, batch: dict):
        mask = batch["assistant_mask"].bool()
        log_prob = self.log_prob_fn(model, batch)
        behav = batch["sample_log_prob"].detach()
        log_ratio = torch.where(mask, log_prob - behav, 0.0)
        ratio = torch.exp(log_ratio)
        adv = batch["advantage"].detach()
        if adv.dim() == 1:
            adv = adv[:, None]

        gain, extra = self._objective(ratio, adv, mask)
        loss_obj = -_masked_token_mean(gain, mask, self.per_seq_norm)
        total = loss_obj
        metrics = {
            "loss_objective": loss_obj.detach(),
            "kl_approx": _masked_token_mean(-log_ratio.detach(), mask),
            **extra,
        }
        if self.kl_coeff and "ref_log_prob" in batch:
            # k3 estimator: e^(ref-pi) - (ref-pi) - 1 >= 0
            d = torch.where(mask, batch["ref_log_prob"].detach() - log_prob, 0.0)
            kl = _masked_token_mean(torch.exp(d) - d - 1.0, mask, self.per_seq_norm)
            total = total + self.kl_coeff * kl
            metrics["kl_to_ref"] = kl.detach()
        if self.entropy_coeff:
            ent = -_masked_token_mean(log_prob, mask, self.per_seq_norm)
            total = total - self.entropy_coeff * ent
            metrics["entropy"] = ent.detach()
        metrics["loss"] = total.detach()
        return total, metrics


class DAPOLoss(GRPOLoss):
    """Decoupled-clip GRPO: asymmetric (eps_low, eps_high) clipping,
    token-level normalization."""

    def __init__(self, log_prob_fn, clip_epsilon=(0.2, 0.28), **kw):
        super().__init__(log_prob_fn, clip_epsilon=clip_epsilon, **kw)


class CISPOLoss(GRPOLoss):
    """Clipped-IS-weight policy gradient: the ratio is clipped and
    detached; the gradient flows through the log-prob only."""

    def __call__(self, model, batch: dict):
        mask = batch["assistant_mask"].bool()
        log_prob = self.log_prob_fn(model, batch)
        behav = batch["sample_log_prob"].detach()
        log_ratio = torch.where(mask, log_prob - behav, 0.0)
        ratio = torch.exp(log_ratio).clamp(1.0 - self.eps_low, 1.0 + self.eps_high).detach()
        adv = batch["advantage"].detach()
        if adv.dim() == 1:
            adv = adv[:, None]
        loss = -_masked_token_mean(ratio * adv * log_prob, mask, self.per_seq_norm)
        return loss, {"kl_approx": _masked_token_mean(-log_ratio.detach(), mask),
                      "loss": loss.detach()}


def mc_advantage(reward: torch.Tensor, group_id: torch.Tensor, num_groups: int,
                 std_normalize: bool = True, eps: float = 1e-4) -> torch.Tensor:
    """Group-relative Monte-Carlo advantage: ``A_i = r_i - mean(r in
    group)``, optionally over the group's std. Segment statistics over
    ``group_id`` in ``[0, num_groups)``, on the rewards' device."""
    gid = group_id.long()
    zeros = torch.zeros(num_groups, dtype=reward.dtype, device=reward.device)
    sums = zeros.index_add(0, gid, reward)
    counts = zeros.index_add(0, gid, torch.ones_like(reward))
    means = sums / counts.clamp_min(1.0)
    adv = reward - means[gid]
    if std_normalize:
        sq = zeros.index_add(0, gid, adv**2)
        std = torch.sqrt(sq / counts.clamp_min(1.0))
        adv = adv / (std[gid] + eps)
    return adv
