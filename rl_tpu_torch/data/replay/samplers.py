"""Replay samplers (counterpart of :mod:`rl_tpu.data.replay.samplers`;
all eight are ported).

``PrioritizedSampler`` keeps the reference's flat two-level sum-tree on
the device: ``priorities`` holds ``(|p| + eps)^alpha`` for every slot
(padded to a multiple of the fanout ``F``) and ``esum`` the sum of each
block of ``F`` leaves. Sampling is stratified inverse-CDF descent (a
block ``cumsum`` and ``searchsorted``, then one ``[B, F]`` row gather);
priority write-back is a delta update of both levels through kernel B7
(:func:`rl_tpu_torch.kernels.sumtree.sumtree_update`), in place. Nothing
is read back to the host.

``sample`` takes ``u``, what the sampler would draw from its generator
(the batch's uniforms in [0, 1) for the uniform and prioritized samplers;
each other sampler's docstring says what its ``u`` is), so a test can
feed both packages the same draws.

Every ``sample`` and ``on_write`` runs on the device without a host read
and with shapes fixed by the capacity and batch size, so a CUDA graph can
hold it: the without-replacement samplers keep their epoch's permutation
in the state and pick a reshuffle with ``torch.where``. The rings of the
state (written versions, trajectory ids, priorities) are written in
place; its counters are replaced.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...kernels.sumtree import sumtree_update
from ..arraydict import ArrayDict

__all__ = ["Sampler", "StalenessAwareSampler", "RandomSampler", "SamplerWithoutReplacement",
           "PrioritizedSampler", "SliceSampler", "SliceSamplerWithoutReplacement",
           "PrioritizedSliceSampler"]


class Sampler:
    """``init(capacity, device)`` builds the state; ``sample`` returns
    ``(indices, info, new_state)``; hooks for writes and priorities."""

    def init(self, capacity: int, device=None) -> ArrayDict:
        return ArrayDict()

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        raise NotImplementedError

    def on_write(self, sstate, idx, items):
        return sstate

    def update_priority(self, sstate, idx, priority, ok=None):
        return sstate


class RandomSampler(Sampler):
    """Uniform with replacement over the filled slots."""

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=size.device)
        n = torch.clamp_min(size, 1)
        idx = torch.minimum((u * n).to(torch.int64), n - 1)  # floor(u * n), no host read of n
        return idx, ArrayDict(), sstate


class PrioritizedSampler(Sampler):
    """Proportional PER: ``P(i) ~ p_i^alpha``, importance weights ``(N
    P(i))^-beta`` normalised by the batch's largest. With
    ``beta_annealing_steps`` beta grows linearly from ``beta`` to 1 over
    that many samples, computed on the device from the state's ``step``
    (so a graph of the PER cycle anneals as it replays)."""

    def __init__(self, alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-8,
                 beta_annealing_steps: int | None = None, fanout: int = 16):
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.beta_annealing_steps = beta_annealing_steps
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        self.fanout = fanout

    def _layout(self, capacity: int) -> tuple[int, int]:
        """(num_blocks, padded_len); pad slots keep zero mass forever."""
        n_blocks = max(1, -(-capacity // self.fanout))
        return n_blocks, n_blocks * self.fanout

    def init(self, capacity: int, device=None) -> ArrayDict:
        n_blocks, padded = self._layout(capacity)
        return ArrayDict(
            priorities=torch.zeros(padded, dtype=torch.float32, device=device),
            esum=torch.zeros(n_blocks, dtype=torch.float32, device=device),
            max_priority=torch.ones((), dtype=torch.float32, device=device),
            step=torch.zeros((), dtype=torch.int64, device=device),
        )

    def _beta(self, step: torch.Tensor):
        """The importance exponent at sampler step ``step``: ``beta``, or
        with annealing ``beta + (1 - beta) * clip(step / steps, 0, 1)`` in
        float32 on ``step``'s device."""
        if self.beta_annealing_steps is None:
            return self.beta
        frac = torch.clamp(step.to(torch.float32) / self.beta_annealing_steps, 0.0, 1.0)
        return self.beta + (1.0 - self.beta) * frac

    def _pa(self, priority):
        return torch.pow(priority.to(torch.float32).abs().reshape(-1) + self.eps, self.alpha)

    def _delta_update(self, sstate, idx, pa_new, *, indices_sorted, ok=None):
        """Set the leaves at ``idx`` to ``pa_new`` by delta adds on both
        levels (kernel B7, in place). Duplicate indices collapse to the
        last writer: with sorted indices a neighbour compare marks it,
        otherwise a scatter-max of positions. ``ok`` zeroes every delta
        where it is false (``x + 0.0 == x`` for the non-negative leaves)."""
        idx = idx.reshape(-1)
        b = idx.shape[0]
        leaves = sstate["priorities"]
        if b > 1:
            if indices_sorted:
                last = torch.cat([idx[:-1] != idx[1:],
                                  torch.ones(1, dtype=torch.bool, device=idx.device)])
            else:
                pos = torch.arange(1, b + 1, device=idx.device)
                win = torch.zeros(leaves.shape[0], dtype=pos.dtype, device=idx.device)
                win.scatter_reduce_(0, idx, pos, "amax")
                last = win[idx] == pos
            delta = torch.where(last, pa_new - leaves[idx], 0.0)
        else:
            delta = pa_new - leaves[idx]
        if ok is not None:
            delta = torch.where(ok, delta, 0.0)
        sumtree_update(leaves, sstate["esum"], idx, delta, fanout=self.fanout)
        return sstate

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        F = self.fanout
        n_blocks, _ = self._layout(capacity)
        esum = sstate["esum"]
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=esum.device)
        # prefix sums accumulated in float64 and rounded to float32: what
        # torch's CPU cumsum does, so the card (whose float32 scan rounds
        # along another tree) picks the same blocks as the CPU
        block_csum = torch.cumsum(esum.double(), 0).float()
        total = block_csum[-1]
        # stratified: one draw per equal slice of the mass; the indices come
        # out ascending, which the sorted dedup of the write-back relies on
        u = (torch.arange(batch_size, device=esum.device) + u) / batch_size * total
        block = torch.clamp(torch.searchsorted(block_csum, u, right=True), 0, n_blocks - 1)
        prev = block_csum[torch.clamp_min(block - 1, 0)]
        r = u - torch.where(block > 0, prev, 0.0)
        rows = sstate["priorities"].view(n_blocks, F)[block]  # [B, F]
        csum = torch.cumsum(rows.double(), -1).float()
        # keep the residual inside the block: the running esum and the row's
        # fresh cumsum may disagree in the last ulps, and a residual past the
        # row's total would step into zero-mass trailing leaves
        r = torch.minimum(r, csum[:, -1] * (1.0 - 1e-6))
        col = torch.clamp((csum <= r[:, None]).sum(-1), 0, F - 1)
        idx = torch.clamp(block * F + col, 0, capacity - 1)

        n = torch.clamp_min(size.to(torch.float32), 1.0)
        total_c = torch.clamp_min(total, 1e-12)
        p_alpha = torch.gather(rows, 1, col[:, None])[:, 0]
        beta = self._beta(sstate["step"])
        weights = torch.pow(n * torch.clamp_min(p_alpha / total_c, 1e-12), -beta)
        weights = weights / torch.clamp_min(weights.max(), 1e-12)
        info = ArrayDict(_weight=weights, index=idx)
        return idx, info, sstate.set("step", sstate["step"] + 1)

    def on_write(self, sstate, idx, items):
        """New items get the max priority; then every block sum is rebuilt
        from its leaves (which also clears the delta path's drift)."""
        pa = torch.pow(sstate["max_priority"], self.alpha)
        leaves = sstate["priorities"]
        leaves[idx.reshape(-1)] = pa
        sstate["esum"].copy_(leaves.view(-1, self.fanout).sum(-1))
        return sstate

    def update_priority(self, sstate, idx, priority, *, indices_sorted=False, ok=None):
        """Write back ``priority`` for ``idx``. With ``ok`` (a 0-dim bool
        tensor) a false ``ok`` leaves the tree and ``max_priority``
        untouched, decided on the device: the in-place counterpart of the
        reference's ``tree_where(ok, new, old)`` over the sampler state."""
        priority = priority.to(torch.float32).abs().reshape(-1)
        sstate = self._delta_update(sstate, idx, self._pa(priority),
                                    indices_sorted=indices_sorted, ok=ok)
        max_p = torch.maximum(sstate["max_priority"], priority.max() + self.eps)
        if ok is not None:
            max_p = torch.where(ok, max_p, sstate["max_priority"])
        return sstate.set("max_priority", max_p)

    def sample_and_update(self, sstate, generator, batch_size, size, capacity,
                          priority_fn: Callable, u=None):
        """One PER cycle: sample, ``priority_fn(idx, info) -> [B]``, write
        back (the stratified indices are ascending: the sorted dedup)."""
        idx, info, sstate = self.sample(sstate, generator, batch_size, size, capacity, u=u)
        sstate = self.update_priority(sstate, idx, priority_fn(idx, info), indices_sorted=True)
        return idx, info, sstate

    def jit_sample_and_update(self, priority_fn: Callable, batch_size: int, capacity: int, *,
                              donate: bool = True, fingerprint: str = "", warmup: bool = False,
                              registry=None, device=None):
        """The PER cycle as a registered program (``per.sample_and_update``):
        ``prog(sstate, generator, size) -> (idx, info, sstate)``, with
        ``batch_size`` and ``capacity`` fixed. On the card each signature
        is one CUDA graph (the sample, ``priority_fn``, the last-writer
        mask, the leaf gather and the deltas around kernel B7); on the CPU
        it runs eagerly. ``fingerprint`` tells apart callers whose
        ``priority_fn`` differ. ``warmup=True`` captures it now from
        :meth:`init`'s layout on ``device`` (default: the card). The tree is
        updated in place, as the reference's donated state is:
        ``donate=False`` is refused."""
        if not donate:
            raise ValueError("jit_sample_and_update(donate=False): the port updates the tree "
                             "in place")
        from ... import resolve_device
        from ...compile import get_program_registry

        def fused(sstate, generator, size):
            return self.sample_and_update(sstate, generator, batch_size, size, capacity,
                                          priority_fn)

        registry = registry or get_program_registry()
        prog = registry.register(
            "per.sample_and_update", fused,
            fingerprint=repr((self.alpha, self.beta, self.beta_annealing_steps, self.eps,
                              self.fanout, batch_size, capacity, fingerprint)))
        if warmup:
            dev = resolve_device(device)
            prog.add_signature(self.init(capacity, dev), torch.Generator(device=dev),
                               torch.zeros((), dtype=torch.int64, device=dev))
            registry.aot_warmup(programs=[prog])
        return prog




def _filled_order(perm: torch.Tensor, hi: torch.Tensor, capacity: int) -> torch.Tensor:
    """The values of ``perm`` below ``hi``, in ``perm``'s order, at the
    front of a ``[capacity]`` tensor: a scatter by rank, every other value
    sent to a spare slot past the end."""
    valid = perm < hi
    rank = torch.cumsum(valid, 0) - 1
    target = torch.where(valid, rank, capacity)
    order = torch.zeros(capacity + 1, dtype=perm.dtype, device=perm.device)
    order.scatter_(0, target, perm)
    return order[:capacity]


def _epoch_perm(sstate, generator, capacity, u):
    """The permutation a reshuffle would take: ``u`` when given, else an
    argsort of float64 uniforms from ``generator``."""
    if u is not None:
        return u.to(device=sstate["perm"].device, dtype=torch.int64)
    keys = torch.rand(capacity, generator=generator, dtype=torch.float64,
                      device=sstate["perm"].device)
    return torch.argsort(keys)


def _epoch_state(capacity: int, device) -> ArrayDict:
    zero = lambda: torch.zeros((), dtype=torch.int64, device=device)  # noqa: E731
    return ArrayDict(pos=zero(), epoch=zero(),
                     perm=torch.arange(capacity, dtype=torch.int64, device=device))


def _windows_ok(tids: torch.Tensor, starts: torch.Tensor, slice_len: int) -> torch.Tensor:
    """Whether the ``slice_len`` steps from each start lie in one written
    trajectory. Positions past the ring read its last slot, as XLA's
    gather clamps them."""
    window = torch.arange(slice_len, device=starts.device)
    w = tids[torch.clamp_max(starts[..., None] + window, tids.shape[0] - 1)]
    return (w == w[..., :1]).all(-1) & (w[..., 0] >= 0)


class SamplerWithoutReplacement(Sampler):
    """Epoch-style sampling without replacement: each epoch walks a
    permutation of the filled slots in order, and a new epoch starts (the
    permutation redrawn) when the rest of the walk cannot fill a batch,
    and at the first sample. The state holds the epoch's permutation of
    ``[0, capacity)`` (the reference holds the key it derives it from);
    the reshuffle is a ``torch.where`` on the device. ``u`` replaces the
    permutation a reshuffle takes."""

    def init(self, capacity: int, device=None) -> ArrayDict:
        return _epoch_state(capacity, device)

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        fresh = _epoch_perm(sstate, generator, capacity, u)
        pos = sstate["pos"]
        need = (pos + batch_size > size) | (sstate["epoch"] == 0)
        perm = torch.where(need, fresh, sstate["perm"])
        pos = torch.where(need, 0, pos)
        order = _filled_order(perm, size, capacity)
        wanted = (pos + torch.arange(batch_size, device=pos.device)) % torch.clamp_min(size, 1)
        idx = order[wanted]
        new = ArrayDict(pos=pos + batch_size, epoch=sstate["epoch"] + need.to(torch.int64),
                        perm=perm)
        return idx, ArrayDict(), new


class StalenessAwareSampler(Sampler):
    """Freshness-weighted sampling: each slot keeps the version it was
    written at; a slot is drawn with weight ``(1 + staleness)^-eta``,
    slots staler than ``max_staleness`` never, and with no mass left the
    draw is uniform over the filled slots. Items that carry ``stamp_key``
    (the async collector's per-item ``("collector", "policy_version")``)
    are written at their own versions and the state's version becomes the
    freshest seen; a write without stamps bumps the version by one.
    Samples carry ``"staleness"``. ``u = (u_w, u_u)`` replaces the two
    uniform streams: the weighted draw's and the uniform fallback's
    (``floor(u_u * size)``)."""

    def __init__(self, eta: float = 1.0, max_staleness: int | None = None,
                 stamp_key=("collector", "policy_version")):
        self.eta = eta
        self.max_staleness = max_staleness
        self.stamp_key = stamp_key

    def init(self, capacity: int, device=None) -> ArrayDict:
        return ArrayDict(written=torch.zeros(capacity, dtype=torch.int64, device=device),
                         version=torch.zeros((), dtype=torch.int64, device=device))

    def on_write(self, sstate, idx, items):
        written = sstate["written"]
        if self.stamp_key is not None and self.stamp_key in items:
            v_items = items[self.stamp_key].to(torch.int64).reshape(idx.shape)
            # the version never goes back, so staleness stays >= 0 per slot
            version = torch.maximum(sstate["version"], v_items.max())
            written[idx] = v_items
            return sstate.set("version", version)
        version = sstate["version"] + 1
        written[idx] = version
        return sstate.set("version", version)

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        dev = size.device
        stal_all = (sstate["version"] - sstate["written"]).to(torch.float32)
        mask = torch.arange(capacity, device=dev) < size
        if self.max_staleness is not None:
            mask = mask & (stal_all <= self.max_staleness)
        w = torch.where(mask, torch.pow(1.0 + stal_all, -self.eta), 0.0)
        csum = torch.cumsum(w.double(), 0).float()  # as PrioritizedSampler sums
        any_mass = csum[-1] > 0
        if u is None:
            u_w = torch.rand(batch_size, generator=generator, device=dev)
            u_u = torch.rand(batch_size, generator=generator, device=dev)
        else:
            u_w, u_u = u
        target = u_w * torch.where(any_mass, csum[-1], 1.0)
        idx_w = torch.clamp(torch.searchsorted(csum, target, right=True), 0, capacity - 1)
        n = torch.clamp_min(size, 1)
        idx_u = torch.minimum((u_u * n).to(torch.int64), n - 1)
        idx = torch.where(any_mass, idx_w, idx_u)
        return idx, ArrayDict(staleness=stal_all[idx]), sstate


class SliceSampler(Sampler):
    """Windows of ``slice_len`` consecutive steps within one trajectory
    (``traj_key``, written by the collector). Each of the ``batch_size //
    slice_len`` slices draws ``oversample`` candidate starts and takes the
    first whose window stays in one trajectory, else the first candidate,
    marked invalid in ``valid_slices`` and in the per-step ``mask`` that
    the losses read. ``u`` (int, ``[num_slices, oversample]``) replaces
    the candidate starts."""

    def __init__(self, slice_len: int, traj_key=("collector", "traj_ids"),
                 oversample: int = 8):
        self.slice_len = slice_len
        self.traj_key = traj_key
        self.oversample = oversample

    def init(self, capacity: int, device=None) -> ArrayDict:
        return ArrayDict(traj_ids=torch.full((capacity,), -1, dtype=torch.int64, device=device))

    def on_write(self, sstate, idx, items):
        tids = sstate["traj_ids"]
        if self.traj_key in items:
            tids[idx] = items[self.traj_key].to(torch.int64).reshape(idx.shape)
        else:
            tids.index_fill_(0, idx, 0)
        return sstate

    def _slices(self, starts: torch.Tensor, ok: torch.Tensor):
        window = torch.arange(self.slice_len, device=starts.device)
        idx = (starts[:, None] + window).reshape(-1)
        return idx, ArrayDict(valid_slices=ok, mask=ok.repeat_interleave(self.slice_len))

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        num_slices = batch_size // self.slice_len
        hi = torch.clamp_min(size - self.slice_len + 1, 1)
        if u is None:
            r = torch.rand((num_slices, self.oversample), generator=generator, device=size.device)
            u = torch.minimum((r * hi).to(torch.int64), hi - 1)
        starts = u.to(device=size.device, dtype=torch.int64)
        ok = _windows_ok(sstate["traj_ids"], starts, self.slice_len)  # [slices, oversample]
        first = torch.argmax(ok.to(torch.int32), dim=1)  # the first valid, or 0
        chosen = torch.gather(starts, 1, first[:, None])[:, 0]
        any_ok = ok.any(1)
        idx, info = self._slices(torch.where(any_ok, chosen, starts[:, 0]), any_ok)
        return idx, info, sstate


class SliceSamplerWithoutReplacement(SliceSampler):
    """Epoch-style slices: each epoch walks a permutation of the start
    positions whose window fits the filled slots, so no start repeats
    until the walk is done; a start whose window crosses an episode is
    marked invalid. ``u`` replaces the permutation a reshuffle takes, as
    in :class:`SamplerWithoutReplacement`."""

    def init(self, capacity: int, device=None) -> ArrayDict:
        return super().init(capacity, device).update(_epoch_state(capacity, device))

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        num_slices = batch_size // self.slice_len
        hi = torch.clamp_min(size - self.slice_len + 1, 1)
        fresh = _epoch_perm(sstate, generator, capacity, u)
        pos = sstate["pos"]
        need = (pos + num_slices > hi) | (sstate["epoch"] == 0)
        perm = torch.where(need, fresh, sstate["perm"])
        pos = torch.where(need, 0, pos)
        order = _filled_order(perm, hi, capacity)
        starts = order[(pos + torch.arange(num_slices, device=pos.device)) % hi]
        idx, info = self._slices(starts, _windows_ok(sstate["traj_ids"], starts, self.slice_len))
        new = sstate.replace(pos=pos + num_slices,
                             epoch=sstate["epoch"] + need.to(torch.int64), perm=perm)
        return idx, info, new


class PrioritizedSliceSampler(SliceSampler):
    """PER over slices: a start's mass is ``(p + eps)^alpha`` of its own
    element's priority, 0 where its window crosses an episode or passes
    the filled slots. Importance weights ``(N P)^-beta`` are normalised by
    the largest possible weight (that of the least likely valid start),
    not the batch's largest. ``update_priority`` writes the elements'
    priorities as given (no tree: a scatter). ``u`` replaces the
    ``num_slices`` uniforms."""

    def __init__(self, slice_len: int, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-8, traj_key=("collector", "traj_ids")):
        super().__init__(slice_len, traj_key=traj_key)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    def init(self, capacity: int, device=None) -> ArrayDict:
        return super().init(capacity, device).update(ArrayDict(
            priorities=torch.zeros(capacity, dtype=torch.float32, device=device),
            max_priority=torch.ones((), dtype=torch.float32, device=device)))

    def on_write(self, sstate, idx, items):
        sstate = super().on_write(sstate, idx, items)
        sstate["priorities"][idx] = sstate["max_priority"]
        return sstate

    def update_priority(self, sstate, idx, priority, ok=None):
        """Write ``|priority| + eps`` at ``idx`` in place; a false ``ok`` (a
        0-dim bool tensor) leaves the priorities and ``max_priority`` as
        they were."""
        priority = priority.to(torch.float32).abs().reshape(-1) + self.eps
        prio = sstate["priorities"]
        max_p = torch.maximum(sstate["max_priority"], priority.max())
        if ok is not None:
            priority = torch.where(ok, priority, prio[idx])
            max_p = torch.where(ok, max_p, sstate["max_priority"])
        prio[idx] = priority
        return sstate.set("max_priority", max_p)

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        num_slices = batch_size // self.slice_len
        positions = torch.arange(capacity, device=size.device)
        hi = torch.clamp_min(size - self.slice_len + 1, 1)
        valid = _windows_ok(sstate["traj_ids"], positions, self.slice_len) & (positions < hi)
        p_alpha = torch.where(valid, torch.pow(sstate["priorities"] + self.eps, self.alpha), 0.0)
        csum = torch.cumsum(p_alpha.double(), 0).float()  # as PrioritizedSampler sums
        total = torch.clamp_min(csum[-1], 1e-12)
        if u is None:
            u = torch.rand(num_slices, generator=generator, device=size.device)
        starts = torch.clamp(torch.searchsorted(csum, u * total, right=True), 0, capacity - 1)
        probs = p_alpha / total
        n = torch.clamp_min(valid.to(torch.float32).sum(), 1.0)
        weights = torch.pow(n * torch.clamp_min(probs[starts], 1e-12), -self.beta)
        min_prob = torch.where(valid, probs, float("inf")).min()
        max_w = torch.pow(n * torch.clamp_min(min_prob, 1e-12), -self.beta)
        weights = weights / torch.clamp_min(max_w, 1e-12)
        ok = valid[starts]
        idx, info = self._slices(starts, ok)
        info = info.update(ArrayDict(_weight=weights.repeat_interleave(self.slice_len),
                                     start_index=starts))
        return idx, info, sstate
