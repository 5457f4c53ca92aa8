"""The five replay samplers beside the uniform and prioritized ones
(``SamplerWithoutReplacement``, ``StalenessAwareSampler``,
``SliceSampler``, ``SliceSamplerWithoutReplacement``,
``PrioritizedSliceSampler``) against ``rl_tpu``'s, on the CPU.

Each port sampler is fed what the reference draws from the same key: the
epoch permutation (``jax.random.permutation``), the candidate starts
(``jax.random.randint``), the weighted draw's uniforms and, for the
uniform fallback, ``u = (index + 0.5) / size`` from the reference's
``randint`` (the port takes ``floor(u * size)``). Indices, ``mask``,
``valid_slices``, ``start_index`` and every state tensor are held
exactly; ``_weight`` and ``staleness`` within 1e-6 relative (both are
float32 powers of the same float32 values; the port sums the weights in
float64 before rounding, so a weight may differ in its last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data.replay import samplers as ref
from rl_tpu_torch.data import ArrayDict, DeviceStorage, ReplayBuffer
from rl_tpu_torch.data.replay import samplers as port

torch.set_num_threads(1)
CAP = 64
KEY = jax.random.key(7)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def keys(n, salt=0):
    return [jax.random.fold_in(KEY, salt * 1000 + i) for i in range(n)]


def assert_state(pst, jst, skip=()):
    for k in jst.keys():
        if k in skip:
            continue
        np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]), err_msg=k)


def traj_items(tids):
    tids = np.asarray(tids, np.int32)
    return (JaxArrayDict(collector=JaxArrayDict(traj_ids=jnp.asarray(tids))),
            ArrayDict(collector=ArrayDict(traj_ids=t(tids))))


def episode_ids(n, lengths):
    """Trajectory ids of ``n`` steps cut into episodes of ``lengths`` (cycled)."""
    out, tid = [], 0
    while len(out) < n:
        out += [tid] * lengths[tid % len(lengths)]
        tid += 1
    return out[:n]


def test_without_replacement_walks_the_reference_epochs():
    """Sizes 40 then 64: batches of 16 reach the end of a 40-slot epoch
    and reshuffle; the size grows mid-epoch; the first sample reshuffles
    whatever its position."""
    js, ps = ref.SamplerWithoutReplacement(), port.SamplerWithoutReplacement()
    jst, pst = js.init(CAP), ps.init(CAP)
    batch, reshuffles = 16, 0
    for i, key in enumerate(keys(9)):
        size = 40 if i < 5 else CAP
        jidx, jinfo, jst = js.sample(jst, key, batch, jnp.asarray(size, jnp.int32), CAP)
        perm = t(jax.random.permutation(key, CAP))
        pidx, pinfo, pst = ps.sample(pst, None, batch, torch.tensor(size), CAP, u=perm)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        assert len(pinfo.keys()) == len(jinfo.keys()) == 0
        assert_state(pst, jst, skip=("epoch_key",))
        np.testing.assert_array_equal(pst["perm"].numpy(),
                                      np.asarray(jax.random.permutation(jst["epoch_key"], CAP)))
        reshuffles = int(pst["epoch"])
    assert reshuffles >= 3


def test_without_replacement_epoch_from_the_generator():
    """Without ``u`` each epoch is a permutation of the filled slots drawn
    from the generator: 5 batches of 8 over 40 slots visit each once, the
    next batch opens a new epoch."""
    s = port.SamplerWithoutReplacement()
    st = s.init(CAP)
    gen = torch.Generator().manual_seed(3)
    seen = []
    for _ in range(5):
        idx, _, st = s.sample(st, gen, 8, torch.tensor(40), CAP)
        seen += idx.tolist()
    assert sorted(seen) == list(range(40)) and int(st["epoch"]) == 1
    idx, _, st = s.sample(st, gen, 8, torch.tensor(40), CAP)
    assert int(st["epoch"]) == 2 and int(st["pos"]) == 8


def staleness_draws(key, batch, size):
    k_w, k_u = jax.random.split(key)
    u_w = t(jax.random.uniform(k_w, (batch,)))
    n = max(size, 1)
    u_u = (t(jax.random.randint(k_u, (batch,), 0, n)).double() + 0.5) / n
    return u_w, u_u.float()


@pytest.mark.parametrize("case", ["stamped", "stampless", "gated", "all_gated"])
def test_staleness_sampler_matches_reference(case):
    """Per-item stamps (a late batch of older stamps keeps the version),
    stampless writes bumping the version, ``max_staleness`` gating some
    slots, and every slot gated out (the uniform fallback)."""
    max_st = {"stamped": None, "stampless": None, "gated": 2, "all_gated": 0}[case]
    js = ref.StalenessAwareSampler(eta=0.7, max_staleness=max_st)
    ps = port.StalenessAwareSampler(eta=0.7, max_staleness=max_st)
    jst, pst = js.init(CAP), ps.init(CAP)
    rng = np.random.default_rng(0)
    size = 0
    for w in range(4):
        idx = np.arange(w * 10, w * 10 + 10)
        if case == "stampless":
            jitems, pitems = JaxArrayDict(), ArrayDict()
        else:
            v = rng.integers(0, 6, 10).astype(np.int32) if w != 2 else np.zeros(10, np.int32)
            jitems = JaxArrayDict(collector=JaxArrayDict(policy_version=jnp.asarray(v)))
            pitems = ArrayDict(collector=ArrayDict(policy_version=t(v)))
        jst = js.on_write(jst, jnp.asarray(idx), jitems)
        pst = ps.on_write(pst, torch.from_numpy(idx), pitems)
        assert_state(pst, jst)
        size += 10
    if case == "all_gated":  # a stampless write moves the version past every slot
        jst, pst = js.on_write(jst, jnp.arange(0), JaxArrayDict()), ps.on_write(
            pst, torch.arange(0), ArrayDict())
    for key in keys(3, 5):
        jidx, jinfo, jst = js.sample(jst, key, 32, jnp.asarray(size, jnp.int32), CAP)
        pidx, pinfo, pst = ps.sample(pst, None, 32, torch.tensor(size), CAP,
                                     u=staleness_draws(key, 32, size))
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(pinfo["staleness"].numpy(), np.asarray(jinfo["staleness"]),
                                   rtol=1e-6)
        assert int(pidx.max()) < size
    if case == "stamped":
        assert int(pst["version"]) == 5  # the freshest stamp, not the last write's
    if case == "stampless":
        assert int(pst["version"]) == 4 and pst["written"][:40].tolist() == sum(
            ([v] * 10 for v in (1, 2, 3, 4)), [])


def test_staleness_sampler_prefers_fresh_slots_from_the_generator():
    s = port.StalenessAwareSampler(eta=2.0)
    st = s.init(16)
    for v in range(4):
        st = s.on_write(st, torch.arange(v * 4, v * 4 + 4),
                        ArrayDict(collector=ArrayDict(policy_version=torch.full((4,), 3 * v))))
    idx, info, _ = s.sample(st, torch.Generator().manual_seed(0), 4000, torch.tensor(16), 16)
    counts = torch.bincount(idx // 4, minlength=4)
    assert bool((counts[1:] > counts[:-1]).all()) and float(info["staleness"].min()) == 0.0


def slice_pair(slice_len, lengths, size, oversample=8):
    js = ref.SliceSampler(slice_len, oversample=oversample)
    ps = port.SliceSampler(slice_len, oversample=oversample)
    jst, pst = js.init(CAP), ps.init(CAP)
    jitems, pitems = traj_items(episode_ids(size, lengths))
    jst = js.on_write(jst, jnp.arange(size), jitems)
    pst = ps.on_write(pst, torch.arange(size), pitems)
    assert_state(pst, jst)
    return js, ps, jst, pst


@pytest.mark.parametrize("lengths,size,oversample", [((9, 5, 13), 48, 8), ((3, 2), 40, 4),
                                                     ((6,), 3, 8)])
def test_slice_sampler_matches_reference(lengths, size, oversample):
    """Episodes long and short (windows crossing an episode are common,
    and with episodes of 3 and 2 steps no window of 4 fits: every slice
    falls back to its first candidate), and a buffer shorter than a
    window."""
    L, B = 4, 32
    js, ps, jst, pst = slice_pair(L, lengths, size, oversample)
    for key in keys(4, size):
        jidx, jinfo, _ = js.sample(jst, key, B, jnp.asarray(size, jnp.int32), CAP)
        hi = max(size - L + 1, 1)
        starts = t(jax.random.randint(key, (B // L, oversample), 0, hi))
        pidx, pinfo, _ = ps.sample(pst, None, B, torch.tensor(size), CAP, u=starts)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        for k in ("valid_slices", "mask"):
            np.testing.assert_array_equal(pinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    if lengths == (3, 2):
        assert not pinfo["valid_slices"].any()
    elif size > L:
        assert pinfo["valid_slices"].any()


@pytest.mark.parametrize("lengths", [(9, 5, 13), (4,)])
def test_slice_without_replacement_matches_reference(lengths):
    """Epochs over the 40 start positions (10 batches of 4 starts a walk,
    the 11th reshuffles), windows crossing an episode marked invalid."""
    L, B, size = 4, 16, 43
    js, ps = ref.SliceSamplerWithoutReplacement(L), port.SliceSamplerWithoutReplacement(L)
    jst, pst = js.init(CAP), ps.init(CAP)
    jitems, pitems = traj_items(episode_ids(size, lengths))
    jst = js.on_write(jst, jnp.arange(size), jitems)
    pst = ps.on_write(pst, torch.arange(size), pitems)
    for key in keys(12, 3):
        jidx, jinfo, jst = js.sample(jst, key, B, jnp.asarray(size, jnp.int32), CAP)
        perm = t(jax.random.permutation(key, CAP))
        pidx, pinfo, pst = ps.sample(pst, None, B, torch.tensor(size), CAP, u=perm)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        for k in ("valid_slices", "mask"):
            np.testing.assert_array_equal(pinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
        assert_state(pst, jst, skip=("epoch_key",))
        np.testing.assert_array_equal(pst["perm"].numpy(),
                                      np.asarray(jax.random.permutation(jst["epoch_key"], CAP)))
    assert int(pst["epoch"]) == 2
    if lengths == (4,):  # only starts at an episode's first step fit
        assert pinfo["valid_slices"].any() and not pinfo["valid_slices"].all()


def test_prioritized_slice_sampler_matches_reference():
    """Writes at max priority, element-wise priority updates (the new max
    kept), then slices drawn by their start's priority, invalid starts at
    zero mass, weights normalised by the largest possible weight."""
    L, B, size = 4, 32, 50
    js, ps = ref.PrioritizedSliceSampler(L, alpha=0.7, beta=0.5), port.PrioritizedSliceSampler(
        L, alpha=0.7, beta=0.5)
    jst, pst = js.init(CAP), ps.init(CAP)
    jitems, pitems = traj_items(episode_ids(size, (9, 5, 13)))
    jst = js.on_write(jst, jnp.arange(size), jitems)
    pst = ps.on_write(pst, torch.arange(size), pitems)
    rng = np.random.default_rng(2)
    for _ in range(2):
        idx = rng.choice(size, 20, replace=False)
        prio = rng.uniform(-3, 3, 20).astype(np.float32)
        jst = js.update_priority(jst, jnp.asarray(idx), jnp.asarray(prio))
        pst = ps.update_priority(pst, torch.from_numpy(idx), t(prio))
    jitems, pitems = traj_items([99] * 6)  # a write after the updates: max priority
    jst = js.on_write(jst, jnp.arange(size, size + 6), jitems)
    pst = ps.on_write(pst, torch.arange(size, size + 6), pitems)
    assert_state(pst, jst)
    size += 6
    for key in keys(3, 9):
        jidx, jinfo, _ = js.sample(jst, key, B, jnp.asarray(size, jnp.int32), CAP)
        u = t(jax.random.uniform(key, (B // L,)))
        pidx, pinfo, _ = ps.sample(pst, None, B, torch.tensor(size), CAP, u=u)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
        for k in ("valid_slices", "mask", "start_index"):
            np.testing.assert_array_equal(pinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
        np.testing.assert_allclose(pinfo["_weight"].numpy(), np.asarray(jinfo["_weight"]),
                                   rtol=1e-6)
        assert bool(pinfo["valid_slices"].all())
    # a false ok leaves the priorities and max_priority as they were
    before = {k: pst[k].clone() for k in ("priorities", "max_priority")}
    pst = ps.update_priority(pst, torch.arange(4), torch.full((4,), 50.0),
                             ok=torch.tensor(False))
    for k, v in before.items():
        assert torch.equal(pst[k], v)


@pytest.mark.parametrize("name", ["without_replacement", "staleness", "slice",
                                  "slice_without_replacement", "prioritized_slice"])
def test_samplers_through_the_replay_buffer_from_the_generator(name):
    """Each sampler behind ``ReplayBuffer``: its ``on_write`` through
    ``extend`` (chunks lapping a 48-slot ring), its draws from the
    generator, the batch gathered at its indices with its info."""
    make = {"without_replacement": lambda: port.SamplerWithoutReplacement(),
            "staleness": lambda: port.StalenessAwareSampler(),
            "slice": lambda: port.SliceSampler(4),
            "slice_without_replacement": lambda: port.SliceSamplerWithoutReplacement(4),
            "prioritized_slice": lambda: port.PrioritizedSliceSampler(4)}[name]
    buf = ReplayBuffer(DeviceStorage(48), make(), batch_size=16)
    example = ArrayDict(x=torch.zeros(()), collector=ArrayDict(
        traj_ids=torch.zeros((), dtype=torch.int64),
        policy_version=torch.zeros((), dtype=torch.int32)))
    state = buf.init(example)
    for c in range(4):
        n = 20
        items = ArrayDict(x=torch.arange(c * n, (c + 1) * n, dtype=torch.float32),
                          collector=ArrayDict(traj_ids=torch.arange(c * n, (c + 1) * n) // 10,
                                              policy_version=torch.full((n,), c)))
        state = buf.extend(state, items)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        batch, state = buf.sample(state, gen)
        assert torch.equal(batch["x"], state["storage", "data", "x"][batch["index"]])
        assert bool((batch["index"] < 48).all())
    if "slice" in name:
        tids = batch["collector", "traj_ids"].view(4, 4)
        same = (tids == tids[:, :1]).all(1)
        assert torch.equal(same, batch["valid_slices"])
    if name == "staleness":
        assert int(state["sampler", "version"]) == 3
