#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``, and exits nonzero without them. Phases, each
printing one JSON line:

1. ``build``   — compile every CUDA kernel of the port from its source;
   then a ``ptxas`` line:
   registers, static shared memory and spills of every kernel of
   ``paged_decode.cu``, ``paged_decode_int8.cu``, ``sumtree.cu``,
   ``flash_fwd.cu`` and ``flash_bwd.cu``, with the dynamic shared memory
   their launchers ask for at the main shapes.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card (paged decode: bf16 and f32 pools, GQA and MHA, tables with -1/0
   entries, lengths at block edges, and the train collect's shape, 8
   slots of 513-1024 positions, timed beside the serving shape; fused
   sampling: greedy and sampled on
   the same noise, an exact tie, top-k with ties at the threshold; flash
   attention forward, dQ and dK/dV: bf16 and f32, MHA, GQA 12/4 and MQA,
   causal and not, a left-padded kv_mask with fully masked rows, packed
   segment ids, T = 1000, bf16 views at an odd offset, and the training
   shape with a left-padded kv_mask, where the backward is also timed as
   a whole, delta pre-pass included, beside SDPA's whole backward, each
   read by CUDA events after a ~0.1 and a ~1 ms spin and by the
   profiler's sum of kernel times (SDPA's backend named from its
   kernels); dense-cache decode: f32 and bf16, MHA, GQA 12/4 and MQA, D
   32/64/128, cache_len at 1, a tile edge, mid-cache and S, a left-padded
   kv_mask, an S that is not a tile multiple, and the evaluate shape;
   int8 paged decode: f32 and bf16 q, GQA and MHA, tables with -1/0
   entries (also inside a 64-position split), lengths at block and split
   edges (63, 64, 65, 128, 129), D 32/64/128, blocks 8/16/64, a GQA
   group above the kernel's 4 heads, scales from real int8 writes with
   one grown block, the serving shape and the train collect's, and
   ``c1_redraw_float32``, with the kernel's and the plain version's
   errors against a float64 oracle (the kernel's at or under the plain
   version's); the PER sum-tree
   update, bit for bit against its plain version on CPU copies, through
   the route the kernel takes by batch size: the path's 1M-leaf
   tree with 256 sorted updates, unsorted duplicates in one block, B = 1,
   B = 4096 (uniform; all equal; unsorted duplicates over the whole
   range), B = 6000 (above the segment route's cap, so the scan route),
   fanouts 2 and 64, the last block, negative deltas and skipped
   out-of-range indices, with the sort at B = 4096 and the scan route at
   B = 6000 timed), and time the kernel
   at its main path's shape, the plain version and, where one PyTorch
   call computes the same function, that call; and time the int8 cache
   write (plain PyTorch) at decode and prefill sizes, its requantize
   both ways.
3. ``serve``   — a GPT-2-small-width LM (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, bf16, max_seq_len 1024, seeded random
   weights) served by the continuous-batching engine: 16 greedy requests
   with prompts of 16-480 tokens and 64 new tokens each, then the same
   16 sampled at temperature 1.0; the 16 greedy requests again through a
   ``kv_int8`` engine (token agreement and mean |d log-prob| against the
   bf16 engine); 16 requests behind one 384-token system prompt served
   with and without the prefix cache (hit rate, blocks charged, prefill
   seconds, forks, token agreement; where a request's tokens part, the
   logit gap there, at most 2 bf16 steps); one sampled run with
   ``kv_int8`` and the prefix cache together (16 new tokens). Every
   kernel's launch count is set to 0 just before and read just after;
   paged decode (bf16 and int8) and sampling must be > 0, and int8's
   mean |d log-prob| below 0.1. Last, the 16 greedy requests to 16 new
   tokens under ``torch.profiler``, through bf16 and through int8 pools
   (B6's device ms per decode step apart).
4. ``check``   — the same width in float32: engine tokens against the
   argmax of the no-cache forward, teacher-forced on prompt + completion,
   for the float pools and for ``kv_int8`` pools (at positions whose
   top-2 margin clears 4x the int8 cache's measured log-prob error; that
   error at most 0.03, at least half the positions decisive); and a
   shared-prefix run whose greedy tokens with the prefix cache equal
   those without it.
5. ``train``   — the same width in bf16 with ``attention_impl="flash"``:
   ``GRPOTrainer`` (16 rollouts of 512 prompt + 512 new tokens through the
   engine, microbatch 8) takes 3 steps; per step collect and update
   seconds, update MFU, loss, reward, bad steps; then greedy
   ``evaluate`` over 8 prompts (the dense-cache ``generate`` with
   ``flash_decode``), one collect of 2 prompts x 8 through
   ``LLMCollector(engine_prefix_cache=True)`` (group hits > 0) and one
   profiled update, its device time split by kernel. Every kernel's count
   is set to 0 before the steps
   and read after the collect; every kernel of the path must be > 0.
6. ``train_check`` — full width in float32, one microbatch of 8 x 1024
   with left padding: the GRPO loss and every parameter gradient through
   the flash kernels (also under per-block remat "none" and "dots")
   against the dense attention, same weights.

7. ``offpolicy`` — SAC with device prioritized replay at the reference's
   full size (``bench.py`` full widths, ``make_sac_trainer(prioritized=
   True)`` defaults): ``OffPolicyProgram`` over ``VmapEnv(PendulumEnv(),
   256)``, 2048 frames a batch, 256x256 actor and twin critics, batch
   256, 4 updates a step, ``ReplayBuffer(DeviceStorage(1_000_000),
   PrioritizedSampler(alpha=0.6, beta=0.4, fanout=16))``, float32.
   ``prefill`` (5000 random frames), one warm-up step, 30 counted steps
   (env steps/s, updates/s; every kernel's count set to 0 before and
   read after; B7 must launch 4 times a step), 3 steps split into
   collect, extend and updates, one profiled step (idle share, B7's
   device time). Gates: finite losses, 0 bad steps, priorities moved,
   every block sum within 1e-5 of its leaves' sum, the reference's PER
   distribution check; then ``offpolicy_check``: 4 updates on the card
   and the same 4 on the CPU from one state and one set of draws, same
   sampled indices, parameters and the PER tree within stated limits.

Then one line with each phase's seconds, one line ``{"kernels": [...]}``
(per kernel: launches in the main path's phases, error, times, bound),
a ``headlines`` line (serve: tokens/s, decode step, profiled device ms
per decode step and idle share; train: update seconds and MFU per step,
the profiled update's device ms, its split by kernel and idle share;
B2's times beside SDPA's backward; the off-policy split),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failed check raises.

"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, tensor core bf16 / fp32 ALU
TOL_DECODE = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_SAMPLE_LP = 1e-5
# B4 at the train collect's shape: 8 slots, 512-token prompts grown toward
# 1024 positions (max_blocks 64), lengths spread over that range
COLLECT_LENS = [513, 586, 659, 732, 805, 878, 951, 1024]
# flash kernels against their plain versions. Both compute in float32 from
# the same inputs. A float32 output: |kernel - plain| <= 1e-4 + 1e-4 *
# max|plain| (summation order only). A bf16 output is rounded in both, so
# an element whose float32 value lies at a rounding boundary may differ by
# one bf16 step, at most 2^-7 |plain|; per element, |kernel - plain| <=
# 2^-7 |plain| + 1e-3 rms(plain), the second term (1/8 of a step at a
# typical value) for elements near 0, where the float32 sums' own rounding
# shows.
TOL_FLASH_F32 = (1e-4, 1e-4)
TOL_FLASH_BF16 = (2.0**-7, 1e-3)
# flash vs dense training gradients in float32: the reference's own
# flash-vs-dense gradient tolerance (tests/test_pallas_attention.py)
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
# int8 KV check: the engine's token must equal the float32 forward's argmax
# where the forward's top-2 margin is at least this many times the int8
# cache's largest measured log-prob error. A flip needs the two top logits
# to move margin/2 each toward the other; the log-prob error of the
# emitted token measures one logit's move, so a factor 4 leaves 2x room
# for the other logit's move being larger.
INT8_MARGIN_PER_LP_ERR = 4.0
# That floor grows with the error it is derived from, so the error itself
# is capped, and enough positions must stay decisive: the sound int8 cache
# measured a largest log-prob error of 0.00817 with 69 of 80 positions
# decisive (H100 runs of this script); a damaged write (scales not grown,
# not carried, blocks not requantized) moves logits by a whole step.
INT8_LP_ERR_MAX = 0.03
INT8_MIN_DECISIVE_SHARE = 0.5
# int8 against bf16 pools in the serve phase: the reference's gate on mean
# |d log-prob| (tests/test_kernels.py, int8 engine accuracy). Its token
# agreement gate (0.75) is not applied here: with random bf16 weights one
# early flip at a near-tie changes the rest of a 64-token greedy sequence;
# the check phase holds int8 tokens position by position in float32.
INT8_SERVE_DLP_MAX = 0.1
# bf16 greedy tokens with and without the prefix cache: the cached
# prefix's K/V and the suffix come from products of other shapes than a
# whole-prompt prefill, so a request may part at a near-tie. Where one
# does, the no-cache forward's logits of the two runs' tokens must lie
# within this many bf16 steps (at the top logit) of each other; wrong K/V
# read from the cache would part them at any margin. On the H100 one
# request of 16 parted, at a gap of exactly 1 step.
PREFIX_FLIP_MAX_STEPS = 2.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Headline numbers of the phases, printed again on a short line after the
# kernels line, so that they sit in the last few kilobytes of the output.
HEADLINES = {}


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def path_kernels():
    """The wrapper of every kernel of the port's main path, in the order of
    the kernels line. Each counts its launches in ``.launches``."""
    from rl_tpu_torch.kernels import paged_attention, sampling, sumtree
    from rl_tpu_torch.ops import attention

    return [attention.flash_fwd, attention.flash_bwd_dq, attention.flash_bwd_dkv,
            attention.flash_decode, attention.paged_flash_decode, sampling.fused_sample,
            paged_attention.paged_flash_decode_int8, sumtree.sumtree_update]


def zero_launches() -> None:
    for f in path_kernels():
        f.launches = 0


def read_launches() -> dict:
    return {f.__name__: f.launches for f in path_kernels()}


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# device-side spin before a timed call, in clock cycles: ~0.1 ms, enough
# for one ctypes launch but not for a call that enqueues many operations
# (an SDPA backward took up to 0.69 ms of host time, and its reading after
# the short spin doubled; PERF.md §6); ~1 ms, the default, for all
SPIN_SHORT, SPIN_LONG = 200_000, 2_000_000


def time_ms(torch, fn, iters=30, warmup=3, spin=SPIN_LONG) -> float:
    """Median device time of ``fn`` in ms, each launch after an L2 flush
    (the serving path finds its inputs cold: other layers' weights and
    caches pass through L2 in between). A device-side spin of ``spin``
    clock cycles after the flush keeps the card busy while the host
    enqueues ``fn``, so the host's launch overhead does not land between
    the two events, as long as the spin outlasts the enqueue."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_kernels(torch, prof) -> dict:
    """{kernel name: (device ms, launches)} of a finished profiler."""
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profiled_ms(torch, fn, iters=10):
    """Device time of one ``fn`` call as ``torch.profiler`` reads it: the
    CUDA kernels' own times over ``iters`` calls, each after the L2 flush,
    less the flushes' kernels profiled alone, per call. Host time between
    the kernels cannot count. Returns (ms, {kernel: [ms, launches] per
    call})."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()

    def run(body):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                body()
            torch.cuda.synchronize()
        return device_kernels(torch, prof)

    both, alone = run(fn), run(lambda: None)
    per_call = {}
    for key, (ms, n) in both.items():
        ms0, n0 = alone.get(key, (0.0, 0))
        if n > n0:
            per_call[key[:100]] = [(ms - ms0) / iters, (n - n0) / iters]
    return sum(ms for ms, _ in per_call.values()), per_call


def host_enqueue_ms(torch, fn, iters=10) -> float:
    """Median host time of enqueueing one ``fn`` call (the card idle and
    synchronised before each)."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def backward_readings(torch, fn, rounds=3) -> dict:
    """One backward call read three ways, ``rounds`` times each, to show
    what the reading depends on: CUDA events after the usual ~0.1 ms spin
    (``time_ms``), after a ~1 ms spin, and the profiler's sum of the
    call's kernel times; with the host time of enqueueing the call."""
    res = {"host_enqueue_ms": host_enqueue_ms(torch, fn),
           "event_ms_spin_0p1": [time_ms(torch, fn, iters=20, spin=SPIN_SHORT)
                                 for _ in range(rounds)],
           "event_ms_spin_1": [time_ms(torch, fn, iters=20) for _ in range(rounds)],
           "profiler_ms": []}
    for _ in range(rounds):
        ms, kernels = profiled_ms(torch, fn)
        res["profiler_ms"].append(ms)
    res["profiler_kernels"] = kernels
    return res


def sdpa_backend(kernels) -> str:
    """The SDPA backend that ran, from its backward's kernel names."""
    names = " ".join(kernels).lower()
    for tag, backend in [("cudnn", "cudnn"), ("flash", "flash"), ("fmha_cutlass", "efficient"),
                         ("efficient", "efficient"), ("mem_eff", "efficient")]:
        if tag in names:
            return backend
    return "math"


# -- phase 2: kernels against their plain versions --------------------------


def decode_case(torch, gen, *, S, H, Hk, D, block, max_blocks, N, dtype, lens, holes=False):
    """Random pools/q and a block table of distinct blocks covering each
    slot's ``lens`` (the rest -1). ``holes`` puts a -1 and a 0 (scratch)
    entry inside one slot's range, as the kernel's contract allows."""
    dev = "cuda"
    pool_k = torch.randn((N, Hk, block, D), generator=gen, device=dev).to(dtype)
    pool_v = torch.randn((N, Hk, block, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((S, 1, H, D), generator=gen, device=dev).to(dtype)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = np.random.default_rng(S * 1000 + D).permutation(np.arange(1, N))
    used = 0
    for s, L in enumerate(lens):
        nb = -(-int(L) // block)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    if holes:
        s = int(np.argmax(lens))
        table[s, 1] = -1
        table[s, 2] = 0
    lens = np.asarray(lens, np.int32)
    return q, pool_k, pool_v, torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev)


def decode_bound(q, pool_k, table, lens):
    """(bound_ms, bound_by): bytes of q, out, table, lens and of the K/V
    rows this data attends (positions < len in entries > 0), against the
    ops of the two products on those rows."""
    S, _, H, D = q.shape
    _, Hk, block, _ = pool_k.shape
    t, ln = table.cpu().numpy(), lens.cpu().numpy()
    rows = 0
    for s in range(S):
        for j in range(t.shape[1]):
            if t[s, j] > 0:
                rows += max(0, min(block, int(ln[s]) - j * block))
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + t.size * 4 + S * 4 + 2 * rows * Hk * D * esz
    ops = 4 * rows * (H // Hk) * Hk * D
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def paged_decode_times(torch, q, pk, pv, table, lens):
    """B4's kernel time (its split kernel and combine, one C call), its
    plain version's, its bound and the SDPA yardstick's on one input."""
    import torch.nn.functional as F

    from rl_tpu_torch.ops import attention

    scale = q.shape[-1] ** -0.5
    qs = (q * scale).contiguous()
    out = torch.empty_like(qs)
    ms = time_ms(torch, lambda: attention._launch(qs, pk, pv, table, lens, out))
    plain_ms = time_ms(torch, lambda: attention.paged_flash_decode_ref(q, pk, pv, table, lens))
    # yardstick: one SDPA call over the slots' K/V gathered into
    # contiguous [S, H, Lmax, D] with a length mask (not used by the port)
    S, Lmax = q.shape[0], int(lens.max().item())
    safe = table.long().clamp_min(0)
    kc = pk[safe].permute(0, 2, 1, 3, 4).reshape(S, pk.shape[1], -1, q.shape[-1])[:, :, :Lmax]
    vc = pv[safe].permute(0, 2, 1, 3, 4).reshape(S, pk.shape[1], -1, q.shape[-1])[:, :, :Lmax]
    kc, vc = kc.contiguous(), vc.contiguous()
    mask = (torch.arange(Lmax, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()
    library_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask, scale=scale)
    )
    bound_ms, bound_by = decode_bound(q, pk, table, lens)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def decode_excess(a, b):
    """(max |a - b|, max of |a - b| less its limit) for a decode kernel's
    output against its plain version: per element 2^-7 |plain| + 1e-3
    rms(plain) in bf16 (TOL_FLASH_BF16, one bf16 step), 1e-5 absolute in
    float32 (TOL_DECODE)."""
    bf = b.float()
    d = (a.float() - bf).abs()
    if str(b.dtype).endswith("bfloat16"):
        rel, floor = TOL_FLASH_BF16
        lim = rel * bf.abs() + floor * bf.square().mean().sqrt()
    else:
        lim = TOL_DECODE["float32"]
    return d.max().item(), (d - lim).max().item()


def evaluate_pads(n=8, prompt_len=512):
    """Left pads of the train phase's ``evaluate`` batch: its first ``n``
    arithmetic prompts, tokenized and left-padded to ``prompt_len``."""
    from rl_tpu_torch.data.llm import SimpleTokenizer
    from rl_tpu_torch.envs.llm import DatasetChatEnv, arithmetic_dataset

    ds = arithmetic_dataset(64)
    env = DatasetChatEnv(ds.prompts, SimpleTokenizer(ds.corpus()), reward_fn=None,
                         max_prompt_len=prompt_len)
    mask = np.asarray(env.reset(ds.prompts[:n])["attention_mask"])
    return (prompt_len - mask.sum(axis=1)).astype(int).tolist()


def dense_decode_bound(q, k, cache_len, mask):
    """(bound_ms, bound_by) of flash_decode: q in, out written, the mask
    bytes below cache_len, and the K/V rows of every visible position
    (below cache_len, mask set) once; 4 * H * D flops per visible
    position."""
    B, _, H, D = q.shape
    Hk = k.shape[2]
    if mask is None:
        visible, mask_bytes = B * cache_len, 0
    else:
        visible, mask_bytes = int(mask[:, :cache_len].sum().item()), B * cache_len
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + mask_bytes + 2 * visible * Hk * D * esz
    ops = 4 * visible * H * D
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def flash_decode_cases(torch, gen, cases):
    """B3 against its plain version over dtypes, head groupings, head
    dims, fill levels, masks and ragged S; then held and timed at the
    evaluate shape [8, 1024, 12, 64] bf16 at cache_len 768 with the
    evaluate's left pads."""
    import torch.nn.functional as F

    from rl_tpu_torch.ops import attention as A

    def inputs(B, S, H, Hk, D, dtype, pads=None):
        dt = getattr(torch, dtype)
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(dt)
        mask = None
        if pads is not None:
            mask = torch.arange(S, device="cuda")[None, :] >= torch.tensor(pads, device="cuda")[:, None]
        return q, k, v, mask

    def hold(label, q, k, v, n, mask):
        out = A.flash_decode(q, k, v, n, kv_mask=mask)
        ref = A.flash_decode_ref(q, k, v, n, kv_mask=mask)
        torch.cuda.synchronize()
        err, excess = decode_excess(out, ref)
        cases.append({"kernel": "flash_decode", "case": label, "max_abs_err": err,
                      "excess_over_limit": excess})
        require(torch.isfinite(out.float()).all().item(), f"flash_decode {label}: non-finite")
        require(excess <= 0.0, f"flash_decode {label}: max abs err {err}, excess {excess}")
        if mask is not None:  # a row with no visible key is exactly 0
            dead = ~mask[:, :n].any(dim=1)
            if dead.any():
                require(out[dead].float().abs().max().item() == 0.0,
                        f"flash_decode {label}: a row with no visible key is not 0")
        return err

    specs = [  # (name, shape, fill levels); tile edge 64
        ("mha_d64", dict(B=3, S=256, H=12, Hk=12, D=64), (1, 64, 65, 150, 256)),
        ("gqa12_4_d64", dict(B=3, S=256, H=12, Hk=4, D=64), (1, 64, 200, 256)),
        ("mqa_d32", dict(B=4, S=128, H=8, Hk=1, D=32), (1, 63, 128)),
        ("gqa8_2_d128", dict(B=2, S=192, H=8, Hk=2, D=128), (64, 100, 192)),
        ("leftpad_gqa", dict(B=3, S=256, H=12, Hk=4, D=64, pads=[0, 70, 199]), (64, 150, 256)),
        ("s200_not_tile_multiple", dict(B=2, S=200, H=4, Hk=2, D=64), (130, 199, 200)),
    ]
    for name, shape, fills in specs:
        for dtype in ("float32", "bfloat16"):
            q, k, v, mask = inputs(dtype=dtype, **shape)
            for n in fills:
                hold(f"{name}_len{n}_{dtype}", q, k, v, n, mask)

    # the evaluate shape: 8 prompts of 512 + 512 new tokens, cache at 768
    pads, n = evaluate_pads(), 768
    q, k, v, mask = inputs(B=8, S=1024, H=12, Hk=12, D=64, dtype="bfloat16", pads=pads)
    err = hold("main_evaluate_bfloat16", q, k, v, n, mask)
    scale = q.shape[-1] ** -0.5
    qs, out = (q * scale).contiguous(), torch.empty_like(q)
    ms = time_ms(torch, lambda: A._decode_launch(qs, k, v, mask, out, n))
    plain_ms = time_ms(torch, lambda: A.flash_decode_ref(q, k, v, n, kv_mask=mask))
    # yardstick (not used by the port): one SDPA call over the cache up to
    # cache_len, laid out [B, H, n, D] beforehand, with the boolean mask
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t[:, :n].transpose(1, 2).contiguous() for t in (k, v))
    mh = mask[:, None, None, :n].contiguous()
    library_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mh, scale=scale))
    bound_ms, bound_by = dense_decode_bound(q, k, n, mask)
    return {
        "name": "flash_decode", "tpu_kernel": "B3", "route": "cuda",
        "source": "rl_tpu_torch/kernels/csrc/flash_decode.cu",
        "replaces": "rl_tpu/ops/attention.py:599",
        "shape": f"B=8 S=1024 H=Hk=12 D=64 bf16, cache_len {n}, kv_mask left pads {pads}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def int8_pools(torch, gen, N, Hk, block, D):
    """int8 pools and scales filled by the port's own quantize_block_write
    of standard-normal K/V (the scale of B4's cases, for which the float32
    limit is set), block by block; then a second write of one row 4x
    larger into block 1, so its scale grows and its earlier rows
    requantize."""
    from rl_tpu_torch.kernels.kvcache import init_scales, quantize_block_write

    blk = torch.arange(1, N, device="cuda").repeat_interleave(block)
    off = torch.arange(block, device="cuda").repeat(N - 1)
    out = []
    for _ in range(2):
        pool = torch.zeros((N, Hk, block, D), dtype=torch.int8, device="cuda")
        sc = init_scales(N, Hk, "cuda")
        vals = torch.randn((len(blk), Hk, D), generator=gen, device="cuda")
        quantize_block_write(pool, sc, blk, off, vals)
        before = sc[1].clone()
        grow = torch.randn((1, Hk, D), generator=gen, device="cuda") * 4.0
        quantize_block_write(pool, sc, torch.ones(1, dtype=torch.long, device="cuda"),
                             torch.zeros(1, dtype=torch.long, device="cuda"), grow)
        require(bool((sc[1] > before).all()), "int8 pools: block 1's scale did not grow")
        out += [pool, sc]
    return out  # pool_k, scale_k, pool_v, scale_v


def int8_decode_bound(q, pool_k, table, lens):
    """(bound_ms, bound_by) of paged_flash_decode_int8: q in, out written,
    the table and lengths, the int8 K/V rows of every attended position
    and the two scales of every attended (block, kv head) once; 4 * H * D
    flops per attended row."""
    S, _, H, D = q.shape
    _, Hk, block, _ = pool_k.shape
    t, ln = table.cpu().numpy(), lens.cpu().numpy()
    rows = tiles = 0
    for s in range(S):
        for j in range(t.shape[1]):
            n = max(0, min(block, int(ln[s]) - j * block))
            if t[s, j] > 0 and n > 0:
                rows += n
                tiles += 1
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + t.size * 4 + S * 4 + 2 * rows * Hk * D + 2 * 4 * tiles * Hk
    ops = 4 * rows * H * D
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def int8_oracle(torch, q, pk, pv, sk, sv, table, lens):
    """B6's function in float64 on the card: the plain version's gather,
    dequantize and masked softmax with every step in float64, from the
    same ``q * scale`` the kernel is given (rounded in q's dtype)."""
    from rl_tpu_torch.ops.attention import decode_softmax_pv

    S, _, H, D = q.shape
    N, Hk, block, _ = pk.shape
    L = table.shape[1] * block
    safe = table.long().clamp(0, N - 1)

    def rows(pool, sc):  # [S, Hk, L, D] float64
        x = pool[safe].double() * sc[safe].double()[..., None, None]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Hk, L, D)

    qs = (q * D**-0.5)[:, 0].double().reshape(S, Hk, H // Hk, D)
    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < lens.long()[:, None]) & (table > 0).repeat_interleave(block, dim=1)
    return decode_softmax_pv(qs, rows(pk, sk), rows(pv, sv), valid[:, None, None, :]).reshape(
        S, 1, H, D)


def c1_readings(torch, P, label, q, pk, pv, sk, sv, table, lens):
    """B6's float32 output and its plain version's, each against the
    float64 oracle: which of the two carries the error the gate sees."""
    out = P.paged_flash_decode_int8(q, pk, pv, sk, sv, table, lens)
    ref = P.paged_flash_decode_int8_ref(q, pk, pv, sk, sv, table, lens)
    exact = int8_oracle(torch, q, pk, pv, sk, sv, table, lens)
    torch.cuda.synchronize()
    return {"case": label, "kernel_vs_plain": (out - ref).abs().max().item(),
            "kernel_vs_float64": (out.double() - exact).abs().max().item(),
            "plain_vs_float64": (ref.double() - exact).abs().max().item(),
            "max_abs_out": exact.abs().max().item()}


# B6 cases added with the split design: lengths at the 64-position split
# edges, D 32 and 128, blocks 8 and 64, a GQA group above the kernel's 4
# heads, entries <= 0 inside a split (slot, entry); own generator, so the
# earlier cases keep their inputs
B6_SPLIT_SPECS = [
    ("split_edges", dict(S=5, H=12, Hk=12, D=64, block=16, max_blocks=16, N=64,
                         lens=[63, 64, 65, 128, 129]), []),
    ("d32_b8_edges", dict(S=4, H=4, Hk=2, D=32, block=8, max_blocks=24, N=96,
                          lens=[63, 65, 128, 192]), []),
    ("d128_b64_edges", dict(S=3, H=4, Hk=4, D=128, block=64, max_blocks=4, N=12,
                            lens=[64, 129, 256]), []),
    ("gqa6_over_max_group", dict(S=3, H=12, Hk=2, D=64, block=16, max_blocks=16, N=48,
                                 lens=[1, 100, 256]), []),
    ("holes_mid_split_b8", dict(S=2, H=8, Hk=4, D=64, block=8, max_blocks=32, N=64,
                                lens=[130, 200]), [(0, 3, -1), (0, 4, 0), (1, 9, -1), (1, 15, 0)]),
]


def int8_case(torch, gen, dtype, overrides=(), **kw):
    """B6 inputs: decode_case's q and table (block 1, the grown one, first
    in the longest slot; ``overrides``: (slot, entry, value) table
    entries) over int8_pools."""
    q, _, _, table, lens = decode_case(torch, gen, dtype=dtype, **kw)
    table[int(np.argmax(kw["lens"])), 0] = 1
    for s, j, val in overrides:
        table[s, j] = val
    pk, sk, pv, sv = int8_pools(torch, gen, kw["N"], kw["Hk"], kw["block"], kw["D"])
    return q, pk, pv, sk, sv, table, lens


def hold_int8(torch, cases, label, args):
    """B6 on ``args`` against its plain version; returns the max abs err."""
    from rl_tpu_torch.kernels import paged_attention as P

    out = P.paged_flash_decode_int8(*args)
    ref = P.paged_flash_decode_int8_ref(*args)
    torch.cuda.synchronize()
    err, excess = decode_excess(out, ref)
    cases.append({"kernel": "paged_flash_decode_int8", "case": label,
                  "max_abs_err": err, "excess_over_limit": excess})
    require(torch.isfinite(out.float()).all().item(), f"int8 decode {label}: non-finite")
    require(excess <= 0.0, f"int8 decode {label}: max abs err {err}, excess {excess}")
    return err


def int8_decode_times(torch, args):
    """B6's kernel time (split kernel and combine, one C call), its plain
    version's, its bound and the SDPA yardstick's on one input."""
    import torch.nn.functional as F

    from rl_tpu_torch.kernels import paged_attention as P
    from rl_tpu_torch.kernels.kvcache import dequantize

    q, pk, pv, sk, sv, table, lens = args
    scale = q.shape[-1] ** -0.5
    qs, o = (q * scale).contiguous(), torch.empty_like(q)
    ms = time_ms(torch, lambda: P._launch(qs, pk, pv, sk, sv, table, lens, o))
    plain_ms = time_ms(torch, lambda: P.paged_flash_decode_int8_ref(*args))
    # yardstick: SDPA over K/V gathered and dequantized to q's dtype
    # beforehand (leaves the gather and the dequantization out)
    S, Lmax, Hk, D = q.shape[0], int(lens.max().item()), pk.shape[1], q.shape[-1]
    safe = table.long().clamp_min(0)

    def gathered(pool, sc):
        x = dequantize(pool[safe], sc[safe]).to(q.dtype)
        return x.permute(0, 2, 1, 3, 4).reshape(S, Hk, -1, D)[:, :, :Lmax].contiguous()

    kc, vc = gathered(pk, sk), gathered(pv, sv)
    mask = (torch.arange(Lmax, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=mask, scale=scale))
    bound_ms, bound_by = int8_decode_bound(q, pk, table, lens)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def int8_decode_cases(torch, gen, cases, main, main_lens):
    """B6 against its plain version (f32 and bf16 q, GQA and MHA, tables
    with -1/0 entries, lengths at block and split edges, D 32/64/128,
    blocks 8/16/64, a GQA group above 4 heads, scales from real int8
    writes with one grown block), then held and timed at the serving
    shape and at the train collect's. Then the float32 ``main`` case on
    two inputs against a float64 oracle, the kernel's and the plain
    version's error each: the kernel's must stay at or under the plain
    version's."""
    from rl_tpu_torch.kernels import paged_attention as P

    # c1_redraw_float32: the float32 main case on the inputs that once
    # read 1.0014e-5 against TOL_DECODE, in a run where the train
    # collect's decode case drew from the shared generator first; Philox
    # offsets add, so the shared generator's state here moved on by that
    # case's draws gives them again, on a generator of its own.
    gen_c1 = torch.Generator(device="cuda")
    gen_c1.set_state(gen.get_state())
    decode_case(torch, gen_c1, dtype=torch.bfloat16, **dict(main, lens=COLLECT_LENS))

    specs = [
        ("main", dict(main, lens=main_lens)),
        ("holes", dict(main, S=4, lens=[0, 33, 64, 200], holes=True)),
        ("gqa3_d64_b16", dict(S=4, H=12, Hk=4, D=64, block=16, max_blocks=16, N=80,
                              lens=[16, 31, 160, 256])),
        ("mqa_d32_b8", dict(S=5, H=4, Hk=1, D=32, block=8, max_blocks=16, N=90,
                            lens=[1, 8, 9, 100, 128])),
        ("gqa4_d128_b64", dict(S=3, H=8, Hk=2, D=128, block=64, max_blocks=8, N=30,
                               lens=[64, 65, 512])),
    ]
    row, c1 = None, []
    for name, kw in specs:
        for dtype in (torch.float32, torch.bfloat16):
            args = int8_case(torch, gen, dtype, **kw)
            label = f"{name}_{str(dtype).split('.')[-1]}"
            err = hold_int8(torch, cases, label, args)
            if label == "main_float32":
                c1.append(c1_readings(torch, P, label, *args))
            if label == "main_bfloat16":
                row = {
                    "name": "paged_flash_decode_int8", "tpu_kernel": "B6", "route": "cuda",
                    "source": "rl_tpu_torch/kernels/csrc/paged_decode_int8.cu",
                    "replaces": "rl_tpu/kernels/paged_attention.py:76",
                    "shape": "S=8 H=12 Hk=12 D=64 block=16 max_blocks=64 int8 pools, bf16 q, "
                             "lens " + str(main_lens),
                    "max_abs_err": err, **int8_decode_times(torch, args),
                }
    args = int8_case(torch, gen_c1, torch.float32, **dict(main, lens=main_lens))
    c1.append(c1_readings(torch, P, "c1_redraw_float32", *args))
    err = c1[-1]["kernel_vs_plain"]
    excess = err - TOL_DECODE["float32"]
    cases.append({"kernel": "paged_flash_decode_int8", "case": "c1_redraw_float32",
                  "max_abs_err": err, "excess_over_limit": excess})
    require(excess <= 0.0, f"int8 decode c1_redraw_float32: max abs err {err}")
    for r in c1:
        require(r["kernel_vs_float64"] <= r["plain_vs_float64"],
                f"int8 decode {r['case']}: {r['kernel_vs_float64']} from float64, above the "
                f"plain version's {r['plain_vs_float64']}")
    row["c1_float64_oracle"] = c1

    gen_split = torch.Generator(device="cuda")
    gen_split.manual_seed(3)
    for name, kw, overrides in B6_SPLIT_SPECS:
        for dtype in (torch.float32, torch.bfloat16):
            hold_int8(torch, cases, f"{name}_{str(dtype).split('.')[-1]}",
                      int8_case(torch, gen_split, dtype, overrides, **kw))
    # the train collect's shape, as B4 has it
    args = int8_case(torch, gen_split, torch.bfloat16, **dict(main, lens=COLLECT_LENS))
    row["collect_case"] = {
        "shape": "S=8 H=12 Hk=12 D=64 block=16 max_blocks=64 int8 pools, bf16 q, lens "
                 + str(COLLECT_LENS),
        "max_abs_err": hold_int8(torch, cases, "collect_bfloat16", args),
        **int8_decode_times(torch, args)}
    return row


def int8_write_times(torch, gen, N=513, Hk=12, block=16, D=64):
    """Device ms of the int8 cache write (plain PyTorch, no kernel of its
    own) on the serve phase's pool: the whole ``quantize_block_write`` and
    its requantize step both ways (the written blocks only; the whole
    pool), at a decode write (8 slots, one row each), a write of one
    block's worth of rows short of the pool's blocks (512 rows on 32
    blocks) and a full prefill round (8 prompts of 512: 4096 rows on 256
    blocks)."""
    from rl_tpu_torch.kernels import kvcache

    pool = torch.randint(-127, 128, (N, Hk, block, D), generator=gen, device="cuda",
                         dtype=torch.int8)
    scale = torch.rand((N, Hk), generator=gen, device="cuda") * 0.02 + 0.01
    res = {}
    for name, blocks in [("decode_8_rows", torch.arange(1, 9)),
                         ("rows_512_on_32_blocks", torch.arange(1, 33).repeat_interleave(block)),
                         ("prefill_4096_rows", torch.arange(1, 257).repeat_interleave(block))]:
        blk = blocks.to("cuda")
        off = torch.arange(len(blk), device="cuda") % block
        vals = torch.randn((len(blk), Hk, D), generator=gen, device="cuda")
        need = vals.abs().amax(dim=-1) / 127.0
        grown = scale.clone().scatter_reduce_(0, blk[:, None].expand_as(need), need, "amax",
                                              include_self=True)
        factor = scale / grown
        p, s = pool.clone(), scale.clone()
        res[name] = {
            "rows": len(blk),
            "quantize_block_write_ms": time_ms(
                torch, lambda: kvcache.quantize_block_write(p, s, blk, off, vals)),
            "requant_written_blocks_ms": time_ms(
                torch, lambda: kvcache._requant_written(p, factor, blk)),
            "requant_whole_pool_ms": time_ms(torch, lambda: kvcache._requant_pool(p, factor)),
            "path_taken": "written_blocks" if len(blk) < N else "whole_pool",
        }
    return res


def sumtree_inputs(rng, *, P, F, B, order="skewed", dedup=True, negative=False,
                   one_block=None, last_block=False, out_of_range=False):
    """Leaves in [0, 3), their block sums, and B updates: sorted indices
    drawn with most mass near slot 0 (so blocks and leaves repeat, as
    stratified PER draws cluster on high priorities), or all inside one
    block, or uniform and unsorted, or all equal, or unsorted draws from
    B / 8 leaves spread over the whole range; deltas of the dedup's last
    writer only (the others 0.0, as ``_delta_update`` sends them) or raw."""
    pri = (rng.random(P) * 3.0).astype(np.float32)
    esum = pri.reshape(-1, F).sum(-1).astype(np.float32)
    if one_block is not None:
        idx = one_block * F + rng.integers(0, F, B)
    elif order == "skewed":
        idx = np.sort((rng.random(B) ** 4 * P).astype(np.int64))
    elif order == "equal":
        idx = np.full(B, rng.integers(0, P), np.int64)
    elif order == "dups":
        idx = rng.choice(rng.integers(0, P, max(B // 8, 1)), B)
    else:
        idx = rng.integers(0, P, B)
        idx[: B // 4] = idx[B // 4 : 2 * (B // 4)]
    if last_block:
        idx[-3:] = [P - F, P - 2, P - 1]
    if out_of_range:  # -1 and -P wrap as NumPy's; P and -P - 1 are dropped
        idx[:4] = [-1, P, -P, -P - 1]
    pa_new = (rng.random(B) * 3.0).astype(np.float32)
    delta = (pa_new - pri[np.clip(idx, 0, P - 1)]).astype(np.float32)
    if not negative:
        delta = np.abs(delta)
    if dedup:
        last = np.ones(B, bool)
        last[:-1] = idx[:-1] != idx[1:]
        delta = np.where(last, delta, np.float32(0.0)).astype(np.float32)
    return pri, esum, idx.astype(np.int64), delta


SUMTREE_MAIN = dict(P=1_000_000, F=16, B=256)  # the off-policy path's tree and batch
SUMTREE_CASES = [
    ("main_P1M_F16_B256_sorted_dedup", SUMTREE_MAIN),
    ("unsorted_dups_in_one_block", dict(P=4096, F=16, B=64, order="uniform", dedup=False,
                                        one_block=7)),
    ("b1", dict(P=1_000_000, F=16, B=1)),
    ("b4096_many_thread_blocks", dict(P=1_000_000, F=16, B=4096, order="uniform",
                                      dedup=False)),
    ("fanout2", dict(P=65536, F=2, B=512)),
    ("fanout64", dict(P=65536, F=64, B=512)),
    ("last_block", dict(P=1_000_000, F=16, B=256, last_block=True)),
    ("negative_deltas_unsorted", dict(P=65536, F=16, B=256, order="uniform", dedup=False,
                                      negative=True)),
    ("negative_and_out_of_range_idx", dict(P=4096, F=16, B=64, order="uniform", out_of_range=True)),
    # the segment route's cap: its longest run, its largest sort, and one
    # batch above it, which takes the scan route
    ("b4096_all_equal", dict(P=1_000_000, F=16, B=4096, order="equal", dedup=False)),
    ("b4096_unsorted_dups_whole_range", dict(P=1_000_000, F=16, B=4096, order="dups",
                                             dedup=False, negative=True)),
    ("b6000_above_cap_scan_route", dict(P=1_000_000, F=16, B=6000, order="dups", dedup=False)),
]


def sumtree_bound(idx, P, F):
    """(bound_ms, bound_by) of B7: idx (int64) and delta read once, and a
    32-byte sector read and written for every distinct leaf and every
    distinct block this data touches; two float32 adds per update."""
    valid = idx[(idx >= 0) & (idx < P)]
    nbytes = idx.size * (8 + 4) + 64 * (len(np.unique(valid)) + len(np.unique(valid // F)))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * idx.size / PEAK_OPS["float32"]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def sumtree_cases(torch, cases):
    """B7 on the card against its plain version run on CPU copies of the
    same inputs, bit for bit (as uint32: the plain version is the ordered
    fold the reference's scatter-adds apply; CUDA ``index_add_`` adds in
    no fixed order, so it is no check), each case on the route the kernel
    takes for its batch size (segments up to 4096 updates, scan above).
    Then timed at the path's shape, with the two ``index_add_`` calls
    (leaves, then blocks) as the library yardstick, and each route at the
    top of its range: the segment route's sort at B = 4096 unsorted, the
    scan route at B = 6000."""
    from rl_tpu_torch.kernels import sumtree as S

    rng = np.random.default_rng(7)
    worst = 0.0
    for name, kw in SUMTREE_CASES:
        pri, esum, idx, delta = sumtree_inputs(rng, **kw)
        F = kw["F"]
        cp, ce = S.sumtree_update_ref(torch.from_numpy(pri.copy()), torch.from_numpy(esum.copy()),
                                      torch.from_numpy(idx), torch.from_numpy(delta), fanout=F)
        gp, ge, gi, gd = (torch.from_numpy(a.copy()).cuda() for a in (pri, esum, idx, delta))
        S.sumtree_update(gp, ge, gi, gd, fanout=F)
        torch.cuda.synchronize()
        gp, ge = gp.cpu(), ge.cpu()
        same = (torch.equal(gp.view(torch.int32), cp.view(torch.int32))
                and torch.equal(ge.view(torch.int32), ce.view(torch.int32)))
        err = max((gp - cp).abs().max().item(), (ge - ce).abs().max().item())
        worst = max(worst, err)
        cases.append({"kernel": "sumtree_update", "case": name, "bit_exact": same,
                      "max_abs_err": err,
                      "leaves_changed": int((gp != torch.from_numpy(pri)).sum())})
        require(same, f"sumtree_update {name}: not bit-exact with the plain version (err {err})")

    P, F, B = SUMTREE_MAIN["P"], SUMTREE_MAIN["F"], SUMTREE_MAIN["B"]
    pri, esum, idx, delta = sumtree_inputs(np.random.default_rng(8), **SUMTREE_MAIN)
    p, e, i, d = (torch.from_numpy(a.copy()).cuda() for a in (pri, esum, idx, delta))
    blk = i // F
    ms = time_ms(torch, lambda: S._launch(p, e, i, d, F))
    plain_ms = time_ms(torch, lambda: S.sumtree_update_ref(p, e, i, d, fanout=F), iters=10,
                       warmup=1)
    # yardstick (not used by the port, and not order-exact)
    library_ms = time_ms(torch, lambda: (p.index_add_(0, i, d), e.index_add_(0, blk, d)))
    bound_ms, bound_by = sumtree_bound(idx, P, F)
    routes = {}
    for key, b in (("segments_sort_b4096_ms", 4096), ("scan_route_b6000_ms", 6000)):
        _, _, ib, db = sumtree_inputs(np.random.default_rng(9), P=P, F=F, B=b, order="dups",
                                      dedup=False)
        ib, db = torch.from_numpy(ib).cuda(), torch.from_numpy(db).cuda()
        routes[key] = time_ms(torch, lambda: S._launch(p, e, ib, db, F))
    return {
        "name": "sumtree_update", "tpu_kernel": "B7", "route": "cuda",
        "source": "rl_tpu_torch/kernels/csrc/sumtree.cu",
        "replaces": "rl_tpu/kernels/sumtree.py:50",
        "shape": f"P={P} F={F} ({P // F} blocks) B={B} sorted, dedup zero deltas, "
                 f"{len(np.unique(idx))} distinct leaves in {len(np.unique(idx // F))} blocks",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library_call": "index_add_ on the leaves, then on the blocks (not order-exact)",
        "routes": routes,
    }


def kernels_phase(torch):
    from rl_tpu_torch.kernels import sampling
    from rl_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the serving path's decode shapes: 8 slots, 12 heads of 64, block 16,
    # 64 table entries (max_seq_len 1024), 513 pool blocks; lengths spread
    # over the served range, several at block edges
    main = dict(S=8, H=12, Hk=12, D=64, block=16, max_blocks=64, N=513)
    main_lens = [1, 16, 17, 128, 255, 256, 400, 544]
    decode_cases = [
        ("main_bf16", dict(main, dtype=torch.bfloat16, lens=main_lens)),
        ("main_f32", dict(main, dtype=torch.float32, lens=main_lens)),
        ("holes_bf16", dict(main, dtype=torch.bfloat16, lens=[0, 33, 64, 200], S=4, holes=True)),
        ("holes_f32", dict(main, dtype=torch.float32, lens=[0, 33, 64, 200], S=4, holes=True)),
        ("gqa3_d64_b16_bf16", dict(S=4, H=12, Hk=4, D=64, block=16, max_blocks=16, N=80,
                                   dtype=torch.bfloat16, lens=[16, 31, 160, 256])),
        ("gqa4_d128_b64_f32", dict(S=3, H=8, Hk=2, D=128, block=64, max_blocks=8, N=30,
                                   dtype=torch.float32, lens=[64, 65, 512])),
        ("mqa_d32_b8_bf16", dict(S=5, H=4, Hk=1, D=32, block=8, max_blocks=16, N=90,
                                 dtype=torch.bfloat16, lens=[1, 8, 9, 100, 128])),
        ("gqa2_d128_b32_f32", dict(S=2, H=16, Hk=8, D=128, block=32, max_blocks=8, N=20,
                                   dtype=torch.float32, lens=[32, 200])),
        # the train collect's shape (8 slots of 512-token prompts growing
        # to 1024 positions, collectors/llm.py), timed beside main_bf16
        ("collect_bf16", dict(main, dtype=torch.bfloat16, lens=COLLECT_LENS)),
    ]
    # the collect case draws from its own generator, so that every later
    # case keeps the inputs it had before that case was added
    gen_collect = torch.Generator(device="cuda")
    gen_collect.manual_seed(1)
    cases, rows = [], {}
    for name, kw in decode_cases:
        dtype = kw["dtype"]
        q, pk, pv, table, lens = decode_case(
            torch, gen_collect if name == "collect_bf16" else gen, **kw)
        out_k = attention.paged_flash_decode(q, pk, pv, table, lens)
        out_r = attention.paged_flash_decode_ref(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        require(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite output")
        err = (out_k.float() - out_r.float()).abs().max().item()
        tol = TOL_DECODE[str(dtype).split(".")[-1]]
        cases.append({"kernel": "paged_flash_decode", "case": name, "max_abs_err": err, "tol": tol})
        require(err <= tol, f"paged_flash_decode {name}: max abs err {err} > {tol}")
        if name == "main_bf16":
            rows["paged_flash_decode"] = {
                "name": "paged_flash_decode", "tpu_kernel": "B4", "route": "cuda",
                "source": "rl_tpu_torch/kernels/csrc/paged_decode.cu",
                "replaces": "rl_tpu/ops/attention.py:761",
                "shape": "S=8 H=12 Hk=12 D=64 block=16 max_blocks=64 bf16, lens " + str(main_lens),
                "max_abs_err": err, **paged_decode_times(torch, q, pk, pv, table, lens),
            }
        elif name == "collect_bf16":
            rows["paged_flash_decode"]["collect_case"] = {
                "shape": "S=8 H=12 Hk=12 D=64 block=16 max_blocks=64 bf16, lens "
                + str(COLLECT_LENS),
                "max_abs_err": err, **paged_decode_times(torch, q, pk, pv, table, lens),
            }

    S, V = 8, 32768
    x = torch.randn((S, V), generator=gen, device="cuda") * 3.0
    x[1] = x[1].to(torch.bfloat16).float()  # the serving path's logits come from bf16
    x[0, 100] = x[0, 2000] = x[0].max() + 1.0  # exact tie: the first index must win
    noise = sampling.gumbel_like(x, gen)
    noise[0, 100] = noise[0, 2000] = 50.0  # tie under sampling too
    for name, kw in [
        ("greedy", dict(temperature=1.0, greedy=True)),
        ("sampled_t1", dict(temperature=1.0, greedy=False)),
        ("sampled_t07", dict(temperature=0.7, greedy=False)),
    ]:
        tok_k, lp_k = sampling.fused_sample(x, noise, **kw)
        tok_r, lp_r = sampling.fused_sample_ref(x, noise, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(tok_k, tok_r))
        err = (lp_k - lp_r).abs().max().item()
        cases.append({"kernel": "fused_sample", "case": name, "tokens_equal": same,
                      "max_abs_err": err, "tol": TOL_SAMPLE_LP, "tie_token": int(tok_k[0])})
        require(same, f"fused_sample {name}: tokens differ")
        require(int(tok_k[0]) == 100, f"fused_sample {name}: tie went to {int(tok_k[0])}, not 100")
        require(err <= TOL_SAMPLE_LP, f"fused_sample {name}: lp err {err}")
        if name == "sampled_t1":
            tok, lp = torch.empty_like(tok_k), torch.empty_like(lp_k)
            ms = time_ms(torch, lambda: sampling._launch(x, noise, 1.0, tok, lp))
            plain_ms = time_ms(torch, lambda: sampling.fused_sample_ref(x, noise, temperature=1.0))
            nbytes = 2 * x.numel() * 4 + S * 8
            ops = 8 * x.numel()  # divide, max, subtract, exp, sum, subtract, add, compare
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
            rows["fused_sample"] = {
                "name": "fused_sample", "tpu_kernel": "B5", "route": "cuda",
                "source": "rl_tpu_torch/kernels/csrc/fused_sample.cu",
                "replaces": "rl_tpu/kernels/sampling.py:82",
                "shape": "S=8 V=32768 f32, sampled (logits + noise)",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": None,  # no single PyTorch call samples
            }
    # top-k: row 2 holds three exact ties at the k-th largest value; the
    # noise favours the last of them, so only a threshold that keeps every
    # tie can pick it
    xk = x.clone()
    order = torch.argsort(xk[2], descending=True)
    thr_val = xk[2, order[9]].item()
    ties = order[9:12]
    xk[2, ties] = thr_val
    nk = noise.clone()
    nk[2] = 0.0
    nk[2, ties[-1]] = 80.0
    for name, kw in [
        ("topk10_sampled_ties", dict(temperature=1.0, greedy=False, top_k=10)),
        ("topk1_sampled", dict(temperature=0.8, greedy=False, top_k=1)),
        ("topk50_greedy", dict(temperature=0.7, greedy=True, top_k=50)),
    ]:
        tok_k, lp_k = sampling.fused_sample(xk, nk, **kw)
        tok_r, lp_r = sampling.fused_sample_ref(xk, nk, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(tok_k, tok_r))
        err = (lp_k - lp_r).abs().max().item()
        cases.append({"kernel": "fused_sample", "case": name, "tokens_equal": same,
                      "max_abs_err": err, "tol": TOL_SAMPLE_LP, "row2_token": int(tok_k[2])})
        require(same, f"fused_sample {name}: tokens differ")
        require(err <= TOL_SAMPLE_LP, f"fused_sample {name}: lp err {err}")
        if name == "topk10_sampled_ties":
            require(int(tok_k[2]) == int(ties[-1]),
                    f"fused_sample {name}: tie at the threshold not kept")

    rows.update(flash_cases(torch, gen, cases))
    rows["flash_decode"] = flash_decode_cases(torch, gen, cases)
    rows["paged_flash_decode_int8"] = int8_decode_cases(torch, gen, cases, main, main_lens)
    rows["sumtree_update"] = sumtree_cases(torch, cases)
    b6, b7 = rows["paged_flash_decode_int8"], rows["sumtree_update"]
    HEADLINES["b6_b7"] = {
        "b6_ms": b6["ms"], "b6_sdpa_ms": b6["library_ms"], "b6_collect_ms": b6["collect_case"]["ms"],
        "b6_collect_sdpa_ms": b6["collect_case"]["library_ms"],
        "b6_float64": {r["case"]: [r["kernel_vs_float64"], r["plain_vs_float64"]]
                       for r in b6["c1_float64_oracle"]},
        "b7_ms": b7["ms"], "b7_index_add_ms": b7["library_ms"], "b7_routes": b7["routes"]}
    emit({"phase": "kernels", "cases": cases,
          "timed": [{"name": r["name"], "tpu_kernel": r["tpu_kernel"],
                     "max_abs_err": r["max_abs_err"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "library_ms": r["library_ms"]} for r in rows.values()],
          "int8_write": int8_write_times(torch, gen)})
    return rows


# training shape; the left pads are drawn as the train_check phase draws
# them (row 0 unpadded, row 1 one real prompt token, the rest uniform below
# the 512-token prompt), so rows with no key are present
FLASH_MAIN = dict(B=8, T=1024, H=12, Hk=12, D=64, dtype="bfloat16", causal=True)
FLASH_MAIN_PROMPT = 512


def flash_main_pads():
    pads = np.random.default_rng(3).integers(0, FLASH_MAIN_PROMPT, FLASH_MAIN["B"])
    pads[0], pads[1] = 0, FLASH_MAIN_PROMPT - 1
    return pads.tolist()


def flash_inputs(torch, gen, *, B, T, H, Hk, D, dtype, causal, pad=None, packed=False):
    """Seeded q, k, v, do; ``pad`` left-pads row b by pad[b] keys
    (kv_mask), ``packed`` gives every row three packed segments."""
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v, do = rnd(B, T, H, D), rnd(B, T, Hk, D), rnd(B, T, Hk, D), rnd(B, T, H, D)
    kv_mask = seg = None
    if pad is not None:
        kv_mask = torch.arange(T, device="cuda")[None, :] >= torch.tensor(pad, device="cuda")[:, None]
    if packed:
        seg = (torch.arange(T, device="cuda")[None, :] * 3 // T).expand(B, T).contiguous()
    return q, k, v, do, kv_mask, seg


def flash_excess(a, b):
    """(max |a - b|, max of |a - b| less its limit) for a flash kernel's
    output ``a`` against its plain version ``b``: TOL_FLASH_BF16 per
    element for a bf16 output, TOL_FLASH_F32 for a float32 one. The lse of
    a row with no key (-1e30 in both) sets no scale."""
    bf = b.float()
    d = (a.float() - bf).abs()
    real = bf.abs() < 1e29
    if str(b.dtype).endswith("bfloat16"):
        rel, floor = TOL_FLASH_BF16
        lim = rel * bf.abs() + floor * bf[real].square().mean().sqrt()
    else:
        atol, rtol = TOL_FLASH_F32
        lim = atol + rtol * bf[real].abs().max()
    return d.max().item(), (d - lim).max().item()


def hold_flash(torch, A, label, q, k, v, do, kv_mask, seg, causal, cases):
    """B1, B2-dQ and B2-dK/dV on one input against their plain versions:
    every output within its limit, and a row with no attended key exactly
    (o = 0, lse = -1e30). Returns {kernel: max abs error}."""
    qseg, kseg = A._seg_from_args(kv_mask, seg, q.shape[0], q.shape[1], q.device)
    o_k, lse_k = A.flash_fwd(q, k, v, qseg, kseg, causal)
    o_r, lse_r = A.flash_attention_ref(q, k, v, causal, None, qseg, kseg)
    dq_k, dk_k, dv_k = A.flash_bwd(q, k, v, o_r, lse_r, do, qseg, kseg, causal)
    dq_r, dk_r, dv_r = A.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, causal, None,
                                                 qseg, kseg)
    torch.cuda.synchronize()
    errs = {}
    for kern, pairs in [("flash_fwd", [(o_k, o_r), (lse_k, lse_r)]),
                        ("flash_bwd_dq", [(dq_k, dq_r)]),
                        ("flash_bwd_dkv", [(dk_k, dk_r), (dv_k, dv_r)])]:
        res = [flash_excess(a, b) for a, b in pairs]
        finite = all(torch.isfinite(a.float()).all().item() for a, _ in pairs)
        errs[kern] = max(e for e, _ in res)
        cases.append({"kernel": kern, "case": label, "max_abs_err": errs[kern],
                      "excess_over_limit": [x for _, x in res]})
        require(finite, f"{kern} {label}: non-finite output")
        require(all(x <= 0.0 for _, x in res), f"{kern} {label}: (max abs err, excess) {res}")
    if kv_mask is not None:  # rows with no attended key: zeros, lse -1e30
        dead = ~kv_mask if causal else (~kv_mask).all(dim=1, keepdim=True).expand_as(kv_mask)
        if dead.any():
            require(o_k.float()[dead].abs().max().item() == 0.0
                    and (lse_k.transpose(1, 2)[dead] == -1e30).all().item(),
                    f"flash_fwd {label}: a row with no key is not (0, -1e30)")
    return errs


def flash_bound(q, k, valid, seg_bytes, kind):
    """(bound_ms, bound_by) for one flash kernel on these inputs: the
    multiply-adds over the (query, key) pairs this data attends (``valid``,
    [B or 1, 1, T, T]) at the bf16 or float32 peak, against each input
    read once and each output written once at 3.35 TB/s. Per pair: fwd
    QK^T + PV (4D flops); dQ: QK^T, dO V^T, dS K (6D); dK/dV: QK^T, dO V^T,
    P^T dO, dS^T Q (8D); the whole backward from (q, k, v, o, lse, do) to
    (dq, dk, dv): the five distinct products (10D), delta made inside."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    pairs = H * int(valid.expand(B, 1, T, T).sum().item())
    esz = q.element_size()
    qbytes, kbytes, rows = B * T * H * D * esz, B * T * Hk * D * esz, B * H * T * 4
    flops, nbytes = {
        "fwd": (4 * D * pairs, 2 * qbytes + 2 * kbytes + rows),  # q, k, v in; o, lse out
        "dq": (6 * D * pairs, 3 * qbytes + 2 * kbytes + 2 * rows),  # q, do, k, v, lse, delta; dq
        "dkv": (8 * D * pairs, 2 * qbytes + 4 * kbytes + 2 * rows),  # q, do, k, v, lse, delta; dk, dv
        "bwd": (10 * D * pairs, 4 * qbytes + 4 * kbytes + rows),  # q, o, do, k, v, lse; dq, dk, dv
    }[kind]
    by_bytes = (nbytes + seg_bytes) / HBM_BYTES_PER_S
    by_ops = flops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def flash_cases(torch, gen, cases):
    """B1, B2-dQ and B2-dK/dV against their plain versions (also on bf16
    views at an odd offset), then each held and timed at the training
    shape [8, 1024, 12, 64] bf16 causal with a left-padded kv_mask, and B2
    as a whole beside SDPA's whole backward (``backward_readings``)."""
    import torch.nn.functional as F

    from rl_tpu_torch.ops import attention as A

    small = dict(B=3, T=200, H=12, D=64)
    specs = [
        ("mha_causal", dict(small, Hk=12, causal=True)),
        ("mha_full", dict(small, Hk=12, causal=False)),
        ("gqa12_4_causal", dict(small, Hk=4, causal=True)),
        ("mqa_full", dict(small, Hk=1, causal=False)),
        ("leftpad_causal", dict(small, Hk=4, causal=True, pad=[0, 70, 199])),
        ("leftpad_full", dict(small, Hk=12, causal=False, pad=[5, 64, 130])),
        ("packed_causal", dict(small, Hk=12, causal=True, packed=True)),
        ("t1000_gqa_d128", dict(B=2, T=1000, H=8, Hk=2, D=128, causal=True, pad=[0, 333])),
        ("t40_mqa_d32", dict(B=2, T=40, H=4, Hk=1, D=32, causal=True, pad=[3, 40])),
    ]
    for name, kw in specs:
        for dtype in ("float32", "bfloat16"):
            q, k, v, do, kv_mask, seg = flash_inputs(torch, gen, dtype=dtype, **kw)
            hold_flash(torch, A, f"{name}_{dtype}", q, k, v, do, kv_mask, seg, kw["causal"],
                       cases)
    # bf16 q, k, v and do as views 2 bytes past an aligned start: B1 and B2
    # take one aligned copy of each instead of raising (own generator, so
    # the shared one's later cases keep their inputs)
    gen_odd = torch.Generator(device="cuda")
    gen_odd.manual_seed(2)
    kw = dict(B=2, T=200, H=12, Hk=4, D=64, causal=True, pad=[0, 70])
    q, k, v, do, kv_mask, _ = flash_inputs(torch, gen_odd, dtype="bfloat16", **kw)
    odd = [torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")[1:1 + t.numel()]
           .view(t.shape).copy_(t) for t in (q, k, v, do)]
    require(all(t.data_ptr() % 16 for t in odd), "odd-offset views are aligned")
    hold_flash(torch, A, "odd_offset_views_bfloat16", *odd, kv_mask, None, True, cases)

    # the training shape: held to the plain versions, then timed
    m, pads = FLASH_MAIN, flash_main_pads()
    c, B, T, D = m["causal"], m["B"], m["T"], m["D"]
    q, k, v, do, kv_mask, _ = flash_inputs(torch, gen, pad=pads, **m)
    errs = hold_flash(torch, A, "main_leftpad_bfloat16", q, k, v, do, kv_mask, None, c, cases)
    qseg, kseg = A._seg_from_args(kv_mask, None, B, T, q.device)
    scale = D**-0.5
    o, lse = A.flash_fwd(q, k, v, qseg, kseg, c)
    prep = A.flash_bwd_inputs(q, k, v, o, lse, do, qseg, kseg)
    fwd_ms = time_ms(torch, lambda: A.flash_fwd(q, k, v, qseg, kseg, c), iters=20)
    dq_ms = time_ms(torch, lambda: A.flash_bwd_dq(*prep, qseg, kseg, c, scale), iters=20)
    dkv_ms = time_ms(torch, lambda: A.flash_bwd_dkv(*prep, qseg, kseg, c, scale), iters=20)
    plain_fwd_ms = time_ms(torch, lambda: A.flash_attention_ref(q, k, v, c, None, qseg, kseg),
                           iters=5)
    plain_bwd = lambda: A.flash_attention_bwd_ref(q, k, v, o, lse, do, c, None, qseg, kseg)  # noqa: E731
    plain_bwd_ms = time_ms(torch, plain_bwd, iters=5)
    # yardstick (not used by the port): one SDPA call with the same causal
    # and padding mask, and its whole backward (its rows with no key are not 0)
    valid = A._attend_mask(B, T, c, qseg, kseg, q.device)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    lib_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=valid),
                         iters=20)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=valid)
    doh = do.transpose(1, 2).contiguous()
    # B2 as a whole (delta pre-pass, casts, dQ, dK/dV) beside SDPA's whole
    # backward, each read by events after two spins and by the profiler
    sdpa = backward_readings(
        torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
    whole = backward_readings(torch, lambda: A.flash_bwd(q, k, v, o, lse, do, qseg, kseg, c))
    lib_bwd_ms = statistics.median(sdpa["event_ms_spin_1"])
    seg_bytes = 2 * B * T * 4  # query and key segment ids
    whole_bound_ms, whole_bound_by = flash_bound(q, k, valid, seg_bytes, "bwd")
    yardstick = {
        "sdpa_backend": sdpa_backend(sdpa["profiler_kernels"]), "sdpa_bwd": sdpa,
        "b2_whole": {**whole, "ms": statistics.median(whole["event_ms_spin_1"]),
                     "plain_ms": plain_bwd_ms, "bound_ms": whole_bound_ms,
                     "bound_by": whole_bound_by, "library_ms": lib_bwd_ms},
        "library_ms_is": "median of sdpa_bwd event_ms_spin_1",
    }
    shape = f"B=8 T=1024 H=Hk=12 D=64 bf16 causal, kv_mask left pads {pads}"
    out_rows = {}
    for name, tpu, src, rep, ms, plain, lib, kind in [
        ("flash_fwd", "B1", "flash_fwd.cu", "rl_tpu/ops/attention.py:137", fwd_ms,
         plain_fwd_ms, lib_fwd_ms, "fwd"),
        ("flash_bwd_dq", "B2", "flash_bwd.cu", "rl_tpu/ops/attention.py:211", dq_ms,
         plain_bwd_ms, lib_bwd_ms, "dq"),
        ("flash_bwd_dkv", "B2", "flash_bwd.cu", "rl_tpu/ops/attention.py:261", dkv_ms,
         plain_bwd_ms, lib_bwd_ms, "dkv"),
    ]:
        bound_ms, bound_by = flash_bound(q, k, valid, seg_bytes, kind)
        out_rows[name] = {
            "name": name, "tpu_kernel": tpu, "route": "cuda",
            "source": f"rl_tpu_torch/kernels/csrc/{src}", "replaces": rep, "shape": shape,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib,
        }
    # both B2 rows carry the whole backward's readings
    out_rows["flash_bwd_dq"]["b2_yardstick"] = out_rows["flash_bwd_dkv"]["b2_yardstick"] = yardstick
    HEADLINES["b2"] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms, "whole_ms": yardstick["b2_whole"]["ms"],
                       "whole_profiler_ms": whole["profiler_ms"], "sdpa_bwd_ms": lib_bwd_ms,
                       "sdpa_profiler_ms": sdpa["profiler_ms"],
                       "sdpa_backend": yardstick["sdpa_backend"]}
    return out_rows


# -- phase 3: serve at full width --------------------------------------------

FULL_WIDTH = dict(vocab_size=32768, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                  max_seq_len=1024)


def prompts(n, lo, hi, vocab, seed):
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_run(torch, engine, reqs, max_new, vocab, keep=None, key=None):
    """Serve ``reqs`` to ``max_new`` tokens each and check every request;
    ``keep[key]`` gets the finished requests in submission order."""
    sync(torch, engine.device)
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new) for p in reqs]
    out = engine.run()
    sync(torch, engine.device)
    wall = time.perf_counter() - t0
    require(len(out) == len(reqs), f"{len(out)} of {len(reqs)} requests finished")
    for f in out.values():
        require(len(f.tokens) == max_new and f.finished_reason == "length",
                f"request {f.rid}: {len(f.tokens)} tokens, {f.finished_reason}")
        require(np.isfinite(f.log_probs).all() and (f.log_probs <= 1e-6).all(),
                f"request {f.rid}: bad log-probs")
        require(((f.tokens >= 0) & (f.tokens < vocab)).all(),
                f"request {f.rid}: token out of range")
    tokens = sum(len(f.tokens) for f in out.values())
    if keep is not None:
        keep[key] = [out[r] for r in rids]
    return {
        "requests": len(out), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "prefill_ms_total": engine.prefill_s * 1e3,
        "prefill_rounds": engine.prefill_rounds,
        "prefill_ms_per_round": engine.prefill_s * 1e3 / max(engine.prefill_rounds, 1),
        "decode_steps": engine.decode_steps,
        "decode_step_ms_mean": (wall - engine.prefill_s) * 1e3 / max(engine.decode_steps, 1),
    }


def profile_run(torch, engine, reqs, max_new, focus=None):
    """One more greedy run under ``torch.profiler``: device time by
    kernel against the run's wall clock (the profiler's own host cost
    inflates that wall; the device times are the card's). ``focus``:
    (label, substrings): the device ms per decode step of the kernels
    whose names hold one of the substrings, reported apart."""
    from torch.profiler import ProfilerActivity, profile

    for p in reqs:
        engine.submit(p, max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [  # device-side events only (CPU ops carry their kernels' time too)
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    steps = max(engine.decode_steps, 1)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "decode_steps": engine.decode_steps, "device_ms_per_decode_step": busy_ms / steps,
        **({f"{focus[0]}_ms_per_decode_step":
            sum(t for k, t, _ in kernels if any(f in k for f in focus[1])) / steps}
           if focus else {}),
        "device_launches_per_decode_step": sum(c for *_, c in kernels) / max(engine.decode_steps, 1),
        "top_device_ms": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top],
    }


def shared_prefix_prompts(n, system_len, lo, hi, vocab, seed):
    """``n`` prompts behind one ``system_len``-token system prompt, each
    with ``lo``..``hi`` distinct tokens of its own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, system_len).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, int(k)).astype(np.int32)])
            for k in np.linspace(lo, hi, n).astype(int)]


def agreement(a, b):
    """(share of equal tokens, mean |d log-prob|) of two runs' requests,
    position by position."""
    same = [x == y for ra, rb in zip(a, b) for x, y in zip(ra.tokens, rb.tokens)]
    dlp = [abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra.log_probs, rb.log_probs)]
    return float(np.mean(same)), float(np.mean(dlp))


def first_flips(torch, model, base, other, device):
    """For each request whose greedy tokens differ between two runs of the
    same prompts: the first differing position, and there the no-cache
    forward's logits (in the model's dtype) over the prompt and ``base``'s
    tokens before it: the gap between the two runs' tokens and the top-2
    margin, each also in steps of the dtype at the top logit."""
    flips = []
    with torch.no_grad():
        for fa, fb in zip(base, other):
            diff = np.flatnonzero(fa.tokens != fb.tokens)
            if not len(diff):
                continue
            i = int(diff[0])
            seq = torch.from_numpy(np.concatenate([fa.prompt, fa.tokens[:i]])).to(device)
            logits = model(seq[None])[0, -1]
            top2 = logits.float().topk(2).values.tolist()
            step = float(torch.finfo(logits.dtype).eps * 2.0 ** np.floor(np.log2(abs(top2[0]))))
            gap = float(logits[int(fa.tokens[i])].float() - logits[int(fb.tokens[i])].float())
            flips.append({"rid": fa.rid, "position": i, "tokens": [int(fa.tokens[i]),
                                                                   int(fb.tokens[i])],
                          "logit_gap": gap, "logit_gap_steps": gap / step,
                          "top2_margin": top2[0] - top2[1],
                          "top2_margin_steps": (top2[0] - top2[1]) / step, "step": step})
    return flips


def prefix_report(engine, run, n_requests):
    st = engine.stats()
    return {**run, "hit_rate": st["kv_prefix_hit_rate"], "hits": st["kv_prefix_hits"],
            "exact_hits": st["kv_prefix_exact_hits"], "cow_forks": st["kv_cow_copies_total"],
            "blocks_charged_per_request": st["kv_blocks_charged_total"] / n_requests,
            "prefill_tokens_computed": st["prefill_tokens_computed"],
            "prefill_tokens_cached": st["prefill_tokens_cached"]}


def serve_phase(torch, card, device="cuda", width=FULL_WIDTH):
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM

    seconds, t_last = {}, [time.perf_counter()]

    def lap(name):  # host seconds of each part of the phase
        sync(torch, device)
        now = time.perf_counter()
        seconds[name], t_last[0] = now - t_last[0], now

    cfg = TransformerConfig(**width, dtype=torch.bfloat16)
    model = TransformerLM(cfg, device=device, seed=0)
    # the same weights (same seed) over int8 pools
    model_int8 = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16, kv_int8=True),
                               device=device, seed=0)

    def engine(m=model, **kw):
        return ContinuousBatchingEngine(
            m, n_slots=8, block_size=16, n_blocks=513, prompt_buckets=(32, 128, 512),
            decode_chunk=4, device=device, **kw,
        )

    V = cfg.vocab_size
    reqs = prompts(16, 16, 480, V, seed=1)
    shared = shared_prefix_prompts(16, 384, 8, 32, V, seed=5)
    lap("models")
    # warm-up (cuBLAS handles, allocator pools), not timed or counted
    serve_run(torch, engine(greedy=True), reqs[:2] + reqs[-1:], 8, V)
    lap("warm_up")

    zero_launches()
    outs = {}
    greedy = serve_run(torch, engine(greedy=True), reqs, 64, V, outs, "greedy")
    sampled = serve_run(torch, engine(greedy=False, temperature=1.0, seed=1), reqs, 64, V)
    lap("bf16_runs")
    int8 = serve_run(torch, engine(model_int8, greedy=True), reqs, 64, V, outs, "int8")
    int8["token_agreement"], int8["mean_abs_dlogprob"] = agreement(outs["int8"], outs["greedy"])
    lap("int8_run")
    plain_run = serve_run(torch, engine(greedy=True), shared, 64, V, outs, "noprefix")
    eng = engine(greedy=True, prefix_cache=True)
    prefix = prefix_report(eng, serve_run(torch, eng, shared, 64, V, outs, "prefix"), len(shared))
    prefix["token_agreement"], prefix["mean_abs_dlogprob"] = agreement(outs["prefix"],
                                                                       outs["noprefix"])
    prefix["prefill_s_without_prefix_cache"] = plain_run["prefill_ms_total"] / 1e3
    prefix["prefill_s_with_prefix_cache"] = prefix["prefill_ms_total"] / 1e3
    lap("prefix_runs")
    # int8 pools and the prefix cache together, sampled, 16 new tokens;
    # every shared prompt twice, so exact repeats fork their last block
    # (with scales)
    eng = engine(model_int8, greedy=False, temperature=1.0, seed=2, prefix_cache=True)
    int8_prefix = prefix_report(eng, serve_run(torch, eng, shared[:8] * 2, 16, V), 16)
    launches = read_launches()
    lap("int8_prefix_run")
    # where bf16 greedy tokens with and without the prefix cache part: the
    # no-cache forward's logits at the first differing position
    prefix["first_flips"] = first_flips(torch, model, outs["noprefix"], outs["prefix"], device)
    lap("flip_margins")
    for name in ("paged_flash_decode", "fused_sample", "paged_flash_decode_int8"):
        require(launches[name] > 0, f"{name} was not launched on the serving path")
    require(prefix["hits"] > 0 and int8_prefix["cow_forks"] > 0,
            f"serve: prefix hits {prefix['hits']}, int8 forks {int8_prefix['cow_forks']}")
    require(int8["mean_abs_dlogprob"] < INT8_SERVE_DLP_MAX,
            f"serve: int8 mean |d log-prob| {int8['mean_abs_dlogprob']} against bf16 pools")
    require(all(abs(f["logit_gap_steps"]) <= PREFIX_FLIP_MAX_STEPS for f in prefix["first_flips"]),
            f"serve: prefix-cache tokens part from the plain engine's beyond a near-tie: "
            f"{prefix['first_flips']}")
    # 16 new tokens: the profiler's cost grows with the events it records
    prof = prof8 = None
    if device == "cuda":
        prof = profile_run(torch, engine(greedy=True), reqs, 16)
        # the same through int8 pools; B6's kernels are the split kernel
        # and the combine, which only B6 launches on this engine
        prof8 = profile_run(torch, engine(model_int8, greedy=True), reqs, 16,
                            focus=("b6", ("paged_decode_int8", "paged_decode_combine")))
    lap("profiled_run")
    HEADLINES["serve"] = {
        "greedy_tokens_per_s": greedy["tokens_per_s"],
        "decode_step_ms": greedy["decode_step_ms_mean"],
        "profiled_device_ms_per_decode_step":
            prof and prof["device_busy_ms"] / max(prof["decode_steps"], 1),
        "profiled_idle_share": prof and prof["device_idle_share"],
        "int8_profiled_device_ms_per_decode_step":
            prof8 and prof8["device_ms_per_decode_step"],
        "int8_profiled_b6_ms_per_decode_step": prof8 and prof8["b6_ms_per_decode_step"],
    }
    emit({"phase": "serve", "config": {**width, "dtype": "bfloat16", "n_slots": 8,
                                       "block_size": 16, "n_blocks": 513,
                                       "decode_chunk": 4, "max_new_tokens": 64},
          "greedy": greedy, "sampled_t1": sampled, "int8_greedy": int8,
          "shared_prefix": {"system_prompt": 384, "own_tokens": [8, 32],
                            "without_prefix_cache": plain_run, "with_prefix_cache": prefix},
          "int8_prefix_sampled": int8_prefix, "launches": launches,
          "profiled_greedy": prof, "profiled_int8_greedy": prof8, "seconds": seconds,
          "card": card})
    return launches


# -- phase 4: teacher-forced check in float32 -------------------------------


def teacher_forced(torch, model, finished, device):
    """Per request: (top-2 margin, argmax, log-prob of the emitted token) of
    the no-cache forward over prompt + completion, at the completion's
    positions."""
    res = []
    with torch.no_grad():
        for f in finished:
            P = len(f.prompt)
            seq = torch.from_numpy(np.concatenate([f.prompt, f.tokens[:-1]])).to(device)
            rows = model(seq[None])[0, P - 1 :].float()
            top2 = rows.topk(2, dim=-1).values
            lp = torch.log_softmax(rows, dim=-1)[
                torch.arange(len(f.tokens), device=device),
                torch.from_numpy(f.tokens).to(device).long(),
            ]
            res.append(((top2[:, 0] - top2[:, 1]).cpu().numpy(),
                        rows.argmax(dim=-1).cpu().numpy(), lp.cpu().numpy()))
    return res


def check_engine(torch, model, finished, device, margin_floor=None):
    """Engine tokens against the teacher-forced float32 forward: the
    largest log-prob error, and agreement at positions whose top-2 margin
    is at least ``margin_floor`` (default: INT8_MARGIN_PER_LP_ERR times
    that error)."""
    tf = teacher_forced(torch, model, finished, device)
    lp_err = max(float(np.abs(lp - f.log_probs).max()) for (_, _, lp), f in zip(tf, finished))
    floor = margin_floor if margin_floor is not None else INT8_MARGIN_PER_LP_ERR * lp_err
    decisive = agree = 0
    for (margin, pred, _), f in zip(tf, finished):
        ok = margin >= floor
        decisive += int(ok.sum())
        agree += int((pred == f.tokens)[ok].sum())
    return {"decisive_positions": decisive, "agreement": agree / max(decisive, 1),
            "margin_floor": floor, "max_abs_logprob_err": lp_err}


def check_phase(torch, device="cuda", width=FULL_WIDTH, shared_n=8, shared_new=32):
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM

    cfg = TransformerConfig(**width, dtype=torch.float32)
    model = TransformerLM(cfg, device=device, seed=0)
    model_int8 = TransformerLM(TransformerConfig(**width, dtype=torch.float32, kv_int8=True),
                               device=device, seed=0)

    def serve(m, reqs, new, **kw):
        eng = ContinuousBatchingEngine(
            m, n_slots=4, block_size=16, n_blocks=257, prompt_buckets=(32, 128, 512),
            decode_chunk=4, greedy=True, device=device, **kw,
        )
        rids = [eng.submit(p, new) for p in reqs]
        out = eng.run()
        require(len(out) == len(reqs), "check: not every request finished")
        return [out[r] for r in rids], eng

    reqs = prompts(5, 20, 480, cfg.vocab_size, seed=2)
    n_positions = len(reqs) * 16
    plain = check_engine(torch, model, serve(model, reqs, 16)[0], device, margin_floor=1e-3)
    int8 = check_engine(torch, model, serve(model_int8, reqs, 16)[0], device)
    # the prefix cache changes which rows a prefill computes, not the result
    shared = shared_prefix_prompts(shared_n, 384, 8, 32, cfg.vocab_size, seed=6)
    base, _ = serve(model, shared, shared_new)
    cached, eng = serve(model, shared, shared_new, prefix_cache=True)
    same = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(base, cached))
    st = eng.stats()
    emit({"phase": "check", "dtype": "float32", "requests": len(reqs), "float_pools": plain,
          "int8_pools": {**int8, "margin_per_lp_err": INT8_MARGIN_PER_LP_ERR,
                         "lp_err_max": INT8_LP_ERR_MAX,
                         "min_decisive_share": INT8_MIN_DECISIVE_SHARE,
                         "positions": n_positions},
          "shared_prefix": {"requests": len(shared), "tokens_identical": same,
                            "hits": st["kv_prefix_hits"], "hit_rate": st["kv_prefix_hit_rate"],
                            "token_agreement": agreement(cached, base)[0]}})
    require(plain["decisive_positions"] > 0, "check: no position with a top-2 margin >= 1e-3")
    require(plain["agreement"] == 1.0,
            f"check: engine tokens agree with the forward on {plain['agreement']:.4f}")
    require(plain["max_abs_logprob_err"] < 1e-3,
            f"check: log-prob error {plain['max_abs_logprob_err']}")
    require(int8["max_abs_logprob_err"] <= INT8_LP_ERR_MAX,
            f"check: int8 log-prob error {int8['max_abs_logprob_err']} > {INT8_LP_ERR_MAX}")
    require(int8["decisive_positions"] >= INT8_MIN_DECISIVE_SHARE * n_positions,
            f"check: int8 engine has {int8['decisive_positions']} of {n_positions} positions "
            f"decisive at margins >= {int8['margin_floor']}")
    require(int8["agreement"] == 1.0,
            f"check: int8 engine tokens agree with the forward on {int8['agreement']:.4f} "
            f"at margins >= {int8['margin_floor']}")
    require(st["kv_prefix_hits"] > 0, "check: the prefix cache had no hit")
    require(same, "check: prefix-cache greedy tokens differ from the engine without it")


# -- phase 5: GRPO training at full width -------------------------------------


def train_phase(torch, card, device="cuda", width=FULL_WIDTH, steps=3, prompt_len=512,
                max_new=512, microbatch=8, collect_new=64):
    """``GRPOTrainer`` at GPT-2-small width in bf16 with the flash kernels:
    3 steps of 16 engine rollouts (2 prompts x 8) and a microbatched
    update, the dense-cache ``evaluate`` through ``flash_decode``, and one
    prefix-cache collect; the kernels' launch counts are read around
    them."""
    from rl_tpu_torch.collectors import LLMCollector
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.models import TransformerConfig, train_step_flops
    from rl_tpu_torch.ops import attention
    from rl_tpu_torch.trainers import GRPOTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                            flash_decode=True)
    t_build = time.perf_counter()
    trainer = GRPOTrainer(
        arithmetic_dataset(64), model_config=cfg, num_prompts=2, group_repeats=8,
        max_prompt_len=prompt_len, max_new_tokens=max_new, microbatch_size=microbatch,
        continuous_batching=True, device=device,
    )
    build_s = time.perf_counter() - t_build
    master0 = [p.detach().clone() for p in trainer.policy.parameters()]
    n_params = sum(p.numel() for p in trainer.policy.parameters())
    B, T = 16, prompt_len + max_new
    flops = train_step_flops(cfg, n_params, B, T)
    zero_launches()
    outs, per_step = [], []
    t_phase = time.perf_counter()
    for i in range(steps):
        sync(torch, device)
        t0 = time.perf_counter()
        batch = trainer.collect()
        sync(torch, device)
        t1 = time.perf_counter()
        outs.append(trainer.update(batch))
        sync(torch, device)
        t2 = time.perf_counter()
        per_step.append({"step": i + 1, "collect_s": t1 - t0, "update_s": t2 - t1,
                         "update_mfu": flops / (t2 - t1) / PEAK_OPS["bfloat16"],
                         "response_tokens": int(batch["assistant_mask"].sum().item())})
    phase_s = time.perf_counter() - t_phase
    final = trainer.metrics_snapshot()
    # update k returns step k-1's metrics (lagged drain); the last step's
    # come from the snapshot
    step_metrics = [outs[i + 1] for i in range(steps - 1)] + [final]
    for rec, m in zip(per_step, step_metrics):
        rec.update(loss=m["loss"], reward=m["reward"], kl_approx=m["kl_approx"],
                   bad_steps=m["bad_steps"])
    with torch.no_grad():
        changed = any(not torch.equal(p0, p) for p0, p in
                      zip(master0, trainer.policy.parameters()))
        serving = dict(trainer.gen_model.named_parameters())
        synced = all(torch.equal(serving[n], p.to(serving[n].dtype))
                     for n, p in trainer.policy.named_parameters())
    version = trainer.policy_version.version
    # the dense-cache generate path: greedy exact-match accuracy
    sync(torch, device)
    t0 = time.perf_counter()
    accuracy = trainer.evaluate(num_prompts=8)
    sync(torch, device)
    evaluate = {"prompts": 8, "accuracy": accuracy, "seconds": time.perf_counter() - t0,
                "flash_decode_launches": attention.flash_decode.launches}
    # one GRPO batch through the prefix-cache engine: each group of 8
    # rollouts shares one prompt
    collector = LLMCollector(trainer.env, trainer.gen_model, num_prompts=2,
                             max_new_tokens=collect_new, continuous_batching=True,
                             engine_prefix_cache=True, eos_id=trainer.tokenizer.eos_token_id)
    sync(torch, device)
    t0 = time.perf_counter()
    pbatch = collector.collect(seed=7)
    sync(torch, device)
    st = collector._engine.stats()
    prefix_collect = {"rows": int(pbatch["tokens"].shape[0]), "new_tokens": collect_new,
                      "seconds": time.perf_counter() - t0, "hits": st["kv_prefix_hits"],
                      "exact_hits": st["kv_prefix_exact_hits"],
                      "hit_rate": st["kv_prefix_hit_rate"],
                      "prefill_tokens_computed": st["prefill_tokens_computed"],
                      "prefill_tokens_cached": st["prefill_tokens_cached"]}
    launches = read_launches()
    # profiled after every value the checks read is taken
    prof = profile_update(torch, trainer, batch) if device == "cuda" else None
    HEADLINES["train"] = {
        "update_s": [r["update_s"] for r in per_step],
        "update_mfu": [r["update_mfu"] for r in per_step],
        "profiled_update_device_ms": prof and prof["device_busy_ms"],
        "profiled_update_idle_share": prof and prof["device_idle_share"],
        "profiled_update_by_kernel_ms": prof and {k: v["ms"] for k, v in prof["by_kernel"].items()},
    }
    emit({"phase": "train", "config": {**width, "dtype": "bfloat16", "attention_impl": "flash",
                                       "num_prompts": 2, "group_repeats": 8,
                                       "max_prompt_len": prompt_len, "max_new_tokens": max_new,
                                       "microbatch_size": microbatch, "n_params": n_params,
                                       "train_step_flops": flops},
          "build_s": build_s, "phase_s": phase_s, "steps": per_step,
          "bad_steps": final["bad_steps"], "policy_version": version,
          "master_changed": changed, "serving_equals_master_bf16": synced,
          "launches": launches, "evaluate": evaluate, "prefix_cache_collect": prefix_collect,
          "profiled_update": prof, "card": card})
    require(all(np.isfinite(r["loss"]) for r in per_step), "train: non-finite loss")
    require(final["bad_steps"] == 0, f"train: {final['bad_steps']} bad steps")
    require(version == steps, f"train: policy version {version}, not {steps}")
    require(changed, "train: master weights did not change")
    require(synced, "train: serving copy differs from master.to(bf16)")
    require(0.0 <= accuracy <= 1.0, f"train: evaluate accuracy {accuracy}")
    require(prefix_collect["exact_hits"] > 0, f"train: prefix-cache collect {prefix_collect}")
    require(bool(torch.isfinite(pbatch["sample_log_prob"]).all()), "train: collect log-probs")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode",
                 "paged_flash_decode", "fused_sample"):  # all but int8 decode
        require(launches[name] > 0, f"{name} was not launched on the training path")
    return launches


def profile_update(torch, trainer, batch):
    """One more update on the last batch under ``torch.profiler``: device
    time by kernel against the update's wall clock (after the checks, so
    the extra step changes nothing they read)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.update(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(k, t, c) for k, (t, c) in device_kernels(torch, prof).items()]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:15]
    # the update's device time split by the port's kernels (B1; B2's dQ and
    # dK/dV, float32 and bf16 bodies alike) and everything else
    split = {}
    for key, t, c in kernels:
        part = next((n for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if n in key),
                    "other")
        ms0, n0 = split.get(part, (0.0, 0))
        split[part] = (ms0 + t, n0 + c)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_launches": sum(c for *_, c in kernels),
            "by_kernel": {k: {"ms": t, "launches": c} for k, (t, c) in split.items()},
            "top_device_ms": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top]}


# -- phase 6: flash against dense gradients in float32 --------------------------


def train_check_phase(torch, device="cuda", width=FULL_WIDTH, B=8, T=1024, prompt=512):
    """One left-padded microbatch through the GRPO loss with the flash
    kernels (plain, and under per-block remat "none" and "dots") and with
    dense attention, same float32 weights: loss and every parameter
    gradient within the reference's flash-vs-dense tolerance."""
    from rl_tpu_torch.models import TransformerConfig, TransformerLM, token_log_probs
    from rl_tpu_torch.objectives import GRPOLoss

    rng = np.random.default_rng(3)
    pads = rng.integers(0, prompt, B)
    pads[0], pads[1] = 0, prompt - 1  # no padding; a single real prompt token
    pos = np.arange(T)[None, :]
    attn = pos >= pads[:, None]
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, width["vocab_size"], (B, T))).to(device),
        "attention_mask": torch.from_numpy(attn.astype(np.float32)).to(device),
        "assistant_mask": torch.from_numpy(attn & (pos >= prompt)).to(device),
        "advantage": torch.from_numpy(rng.standard_normal(B).astype(np.float32)).to(device),
    }
    loss_fn = GRPOLoss(lambda m, b: token_log_probs(m, b["tokens"], b["attention_mask"]))
    variants = {"local": dict(attention_impl="local"), "flash": dict(attention_impl="flash"),
                "flash_remat_none": dict(attention_impl="flash", remat=True),
                "flash_remat_dots": dict(attention_impl="flash", remat=True,
                                         remat_policy="dots")}
    models = {name: TransformerLM(TransformerConfig(**width, dtype=torch.float32, **kw),
                                  device=device, seed=0, param_dtype=torch.float32)
              for name, kw in variants.items()}
    with torch.no_grad():  # behavior log-probs near the policy's: ratios near 1
        lp = token_log_probs(models["local"], batch["tokens"], batch["attention_mask"])
        noise = torch.from_numpy(rng.normal(0, 0.05, (B, T)).astype(np.float32)).to(device)
        batch["sample_log_prob"] = lp + noise
    res = {}
    for name, model in models.items():
        loss, _ = loss_fn(model, batch)
        loss.backward()
        res[name] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
        models[name] = None  # free the model's activations and weights before the next
    sync(torch, device)
    l_loc, g_loc = res.pop("local")
    report = {}
    for name, (loss, grads) in res.items():
        worst, worst_name = None, None
        for n, gl in g_loc.items():
            excess = ((grads[n] - gl).abs() - TRAIN_ATOL - TRAIN_RTOL * gl.abs()).max().item()
            if worst is None or excess > worst:
                worst, worst_name = excess, n
        report[name] = {"loss": loss, "loss_abs_err": abs(loss - l_loc),
                        "worst_grad_excess_over_tol": worst, "worst_param": worst_name}
    emit({"phase": "train_check", "dtype": "float32", "batch": [B, T],
          "pads": pads.tolist(), "loss_local": l_loc, "params": len(g_loc),
          "against_local": report, "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL})
    for name, r in report.items():
        require(r["loss_abs_err"] <= TRAIN_ATOL + TRAIN_RTOL * abs(l_loc),
                f"train_check: {name} loss differs")
        require(r["worst_grad_excess_over_tol"] <= 0.0,
                f"train_check: {name} gradient of {r['worst_param']} off by "
                f"{r['worst_grad_excess_over_tol']} beyond tol")


# -- phase 7: SAC with device prioritized replay --------------------------------

# The reference's full-size SAC-with-PER run: bench.py's full widths, the
# make_sac_trainer(prioritized=True) buffer and PER defaults.
OFFPOLICY = dict(n_envs=256, frames_per_batch=2048, num_cells=(256, 256), capacity=1_000_000,
                 batch_size=256, utd_ratio=4, learning_rate=3e-4, tau=0.005,
                 init_random_frames=5000, alpha=0.6, beta=0.4, fanout=16)
# After the run each block sum is within this relative distance of a fresh
# sum of its leaves: on_write rebuilds every block sum at each extend, and
# the 4 delta updates since add a few float32 roundings (ulp 6e-8) each.
ESUM_RTOL = 1e-5
# Card against CPU over 4 updates from the same state and draws: cuBLAS
# and the CPU sum the float32 products in other orders (~1e-6 relative in
# a gradient); after 4 Adam steps a weight moves by at most ~4 x lr x
# that. A leaf is (td + eps)^alpha, and a td-error is a difference of Q
# values of magnitude up to ~50 that agree to ~1e-6 relative, so leaves
# are compared as the td-errors they encode, within an absolute 1e-4
# (near td = 0 the pow turns that into any relative gap of the leaf);
# block sums and max_priority as they are.
CPU_CHECK_PARAMS = (1e-4, 1e-5)  # rtol, atol
CPU_CHECK_TD = (1e-4, 1e-4)
CPU_CHECK_TREE = (1e-4, 1e-6)


def make_offpolicy(torch, device, cfg=OFFPOLICY):
    """``OffPolicyProgram`` training SAC on ``VmapEnv(PendulumEnv(), n)``
    with ``ReplayBuffer(DeviceStorage(capacity), PrioritizedSampler)`` and
    ``priority_key="td_error"``, float32 (the reference's MLP default)."""
    from rl_tpu_torch.collectors import Collector
    from rl_tpu_torch.data import DeviceStorage, PrioritizedSampler, ReplayBuffer
    from rl_tpu_torch.envs import PendulumEnv, VmapEnv
    from rl_tpu_torch.modules import (MLP, ConcatMLP, NormalParamExtractor, ProbabilisticActor,
                                      TanhNormal, TDModule, TDSequential)
    from rl_tpu_torch.objectives import SACLoss
    from rl_tpu_torch.trainers import OffPolicyConfig, OffPolicyProgram

    cells = cfg["num_cells"]
    actor = ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=cells), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})
    loss = SACLoss(actor, ConcatMLP(out_features=1, num_cells=cells))
    coll = Collector(VmapEnv(PendulumEnv(), cfg["n_envs"]), lambda td, g: actor(td, g),
                     frames_per_batch=cfg["frames_per_batch"])
    buffer = ReplayBuffer(DeviceStorage(cfg["capacity"]),
                          PrioritizedSampler(alpha=cfg["alpha"], beta=cfg["beta"],
                                             fanout=cfg["fanout"]))
    config = OffPolicyConfig(batch_size=cfg["batch_size"], utd_ratio=cfg["utd_ratio"],
                             learning_rate=cfg["learning_rate"], tau=cfg["tau"],
                             init_random_frames=cfg["init_random_frames"])
    return OffPolicyProgram(coll, loss, buffer, config, priority_key="td_error",
                            device_metrics=True, device=device)


def profile_train_step(torch, program, ts):
    """One more train step under ``torch.profiler``: device busy time and
    idle share against the step's wall clock, B7's device time per
    launch, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        ts, _ = program.train_step(ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(k for _, k, _ in kernels)
    # B7's two routes: sumtree_segments (up to 4096 updates), sumtree_scan
    b7 = [(ms, n) for key, ms, n in kernels
          if "sumtree_segments" in key or "sumtree_scan" in key]
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    return ts, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
                "device_launches": sum(c for *_, c in kernels),
                "sumtree_update_ms_per_launch": (sum(m for m, _ in b7) / sum(n for _, n in b7)
                                                 if b7 else None),
                "sumtree_update_launches": sum(n for _, n in b7),
                "top_device_ms": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top]}


def per_distribution_check(torch, device):
    """The reference's PER distribution test (tests/test_replay.py::TestPER)
    on the card: priority 10 on index 3 and 0.1 on 9 others (alpha 1), so
    index 3 holds ~92% of the mass; more than 70% of 256 draws land there."""
    from rl_tpu_torch.data import ArrayDict, DeviceStorage, PrioritizedSampler, ReplayBuffer

    rb = ReplayBuffer(DeviceStorage(32), PrioritizedSampler(alpha=1.0, beta=1.0),
                      batch_size=256)
    state = rb.init(ArrayDict(x=torch.zeros((), device=device)))
    state = rb.extend(state, ArrayDict(x=torch.arange(10.0, device=device)))
    prio = torch.full((10,), 0.1, device=device)
    prio[3] = 10.0
    state = rb.update_priority(state, torch.arange(10, device=device), prio)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    batch, _ = rb.sample(state, gen)
    frac = (batch["index"] == 3).float().mean().item()
    require(frac > 0.7, f"offpolicy: PER put {frac} of 256 draws on the ~92% index, not > 0.7")
    return frac


def recorded_updates(torch, program, ts, draws):
    """``program.updates`` with the indices each update sampled."""
    seen = []
    sample = program.buffer.sample

    def recording(*args, **kw):
        batch, st = sample(*args, **kw)
        seen.append(batch["index"].cpu())
        return batch, st

    program.buffer.sample = recording
    try:
        ts, metrics = program.updates(ts, draws)
    finally:
        program.buffer.sample = sample
    return ts, metrics, seen


def offpolicy_cpu_check(torch, program, ts, cfg):
    """4 updates on the card (kernel B7) and the same 4 on the CPU (plain
    versions) from the same state and the same draws: sampled indices
    equal; parameters, targets, priorities and block sums within the
    stated tolerances."""
    cpu = make_offpolicy(torch, "cpu", cfg)
    cts = cpu.init(seed=0)
    cpu.loss.load_state_dict({k: v.cpu() for k, v in program.loss.state_dict().items()})
    for dst, src in zip(cpu.optimizer.mu + cpu.optimizer.nu,
                        program.optimizer.mu + program.optimizer.nu):
        dst.copy_(src.cpu())
    cpu.optimizer.count = program.optimizer.count.cpu().clone()
    cts["buffer"] = ts["buffer"].apply(lambda x: x.cpu().clone())
    cts["update_count"] = ts["update_count"]
    rng = np.random.default_rng(11)
    B, k = cfg["batch_size"], cfg["utd_ratio"]
    draws = [tuple(torch.from_numpy(a) for a in (
        rng.random(B, dtype=np.float32), rng.standard_normal((B, 1), dtype=np.float32),
        rng.standard_normal((B, 1), dtype=np.float32))) for _ in range(k)]
    ts, m_gpu, idx_gpu = recorded_updates(torch, program, ts,
                                          [tuple(a.cuda() for a in d) for d in draws])
    cts, m_cpu, idx_cpu = recorded_updates(torch, cpu, cts, draws)
    torch.cuda.synchronize()
    same_idx = all(torch.equal(a, b) for a, b in zip(idx_gpu, idx_cpu))

    def excess(a, b, tol):  # max of |a - b| less its limit
        rtol, atol = tol
        return ((a.float() - b.float()).abs() - atol - rtol * b.float().abs()).max().item()

    gsd, csd = program.loss.state_dict(), cpu.loss.state_dict()
    worst_param = max(((excess(gsd[n].cpu(), csd[n], CPU_CHECK_PARAMS), n) for n in csd))
    tree = {kk: excess(ts["buffer"]["sampler", kk].cpu(), cts["buffer"]["sampler", kk],
                       CPU_CHECK_TREE) for kk in ("esum", "max_priority")}
    td = lambda leaves: leaves.clamp_min(0.0) ** (1.0 / cfg["alpha"])  # noqa: E731
    tree["leaves_as_td_error"] = excess(td(ts["buffer"]["sampler", "priorities"].cpu()),
                                        td(cts["buffer"]["sampler", "priorities"]), CPU_CHECK_TD)
    report = {"updates": k, "indices_equal": same_idx,
              "worst_param_excess_over_tol": worst_param[0], "worst_param": worst_param[1],
              "tree_excess_over_tol": tree, "params_tol": CPU_CHECK_PARAMS,
              "tree_tol": CPU_CHECK_TREE, "td_error_tol": CPU_CHECK_TD,
              "loss_card": m_gpu["loss"].item(), "loss_cpu": m_cpu["loss"].item()}
    emit({"phase": "offpolicy_check", **report})
    require(same_idx, "offpolicy_check: the card and the CPU sampled other indices")
    require(worst_param[0] <= 0.0, f"offpolicy_check: {worst_param[1]} beyond tolerance")
    require(all(v <= 0.0 for v in tree.values()), f"offpolicy_check: PER tree {tree}")


def offpolicy_phase(torch, card, device="cuda", cfg=OFFPOLICY, steps=30, split_steps=3):
    """SAC with device PER at the reference's full size: ``prefill``, one
    warm-up step, then ``steps`` train steps with every kernel's count set
    to 0 before and read after; the split of a few more steps into
    collect, extend and updates (host seconds); one profiled step; the
    gates; the PER distribution check and the card-against-CPU check."""
    program = make_offpolicy(torch, device, cfg)
    t0 = time.perf_counter()
    ts = program.init(seed=0)
    sync(torch, device)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = program.prefill(ts)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    initial_leaf = float(ts["buffer"]["sampler", "priorities"][0])
    ts, _ = program.train_step(ts)  # warm-up (cuBLAS handles, allocator), not counted
    sync(torch, device)

    zero_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        ts, metrics = program.train_step(ts)
        losses.append(metrics["loss"])
    sync(torch, device)
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    frames = steps * cfg["frames_per_batch"]

    split = []
    for _ in range(split_steps):  # the parts of train_step, each timed alone
        t0 = time.perf_counter()
        batch, cstate = program.collector.collect(ts["collector"])
        sync(torch, device)
        t1 = time.perf_counter()
        bstate = program.buffer.extend(ts["buffer"], program._flatten(batch),
                                       n=cfg["frames_per_batch"])
        sync(torch, device)
        t2 = time.perf_counter()
        ts, metrics = program.updates({**ts, "collector": cstate, "buffer": bstate})
        sync(torch, device)
        split.append({"collect_s": t1 - t0, "extend_s": t2 - t1,
                      "updates_s": time.perf_counter() - t2})
    prof = None
    if device == "cuda":
        ts, prof = profile_train_step(torch, program, ts)

    final = {k: v.item() for k, v in metrics.items()}
    flat = program.publish_device_metrics(ts)
    leaves = ts["buffer"]["sampler", "priorities"]
    size = int(ts["buffer"]["storage", "size"])
    written = leaves[:size]
    fresh = leaves.view(-1, cfg["fanout"]).sum(-1)
    esum = ts["buffer"]["sampler", "esum"]
    esum_rel = ((esum - fresh).abs() / fresh.abs().clamp_min(1e-30)).max().item()
    all_losses = torch.stack(losses)
    report = {
        "config": {**cfg, "num_cells": list(cfg["num_cells"]), "dtype": "float32",
                   "env": "VmapEnv(PendulumEnv(), 256)", "priority_key": "td_error"},
        "init_s": init_s, "prefill_s": prefill_s, "steps": steps, "loop_s": loop_s,
        "env_steps_per_s": frames / loop_s,
        "grad_updates_per_s": steps * cfg["utd_ratio"] / loop_s,
        "step_s_mean": loop_s / steps, "split": split, "profiled_step": prof,
        "launches": launches,
        "sumtree_update_launches_per_step": launches["sumtree_update"] / steps,
        "final_metrics": final, "bad_steps": flat["bad_steps"], "updates": flat["updates"],
        "td_error_hist": flat["td_error"], "buffer_size": size,
        "leaves_changed_share": (written != initial_leaf).float().mean().item(),
        "esum_max_rel_err": esum_rel, "esum_rtol": ESUM_RTOL, "card": card,
    }
    require(bool(torch.isfinite(all_losses).all()), "offpolicy: non-finite loss")
    require(all(np.isfinite(v) for v in final.values()), f"offpolicy: final metrics {final}")
    require(flat["bad_steps"] == 0, f"offpolicy: {flat['bad_steps']} bad steps")
    require(report["leaves_changed_share"] > 0.0,
            "offpolicy: no priority moved from its initial max-priority value")
    require(esum_rel <= ESUM_RTOL, f"offpolicy: block sums drift {esum_rel} > {ESUM_RTOL}")
    require(launches["sumtree_update"] == steps * cfg["utd_ratio"],
            f"offpolicy: sumtree_update launched {launches['sumtree_update']} times in "
            f"{steps} steps of {cfg['utd_ratio']} updates")
    report["per_distribution_share_on_top_index"] = per_distribution_check(torch, device)
    emit({"phase": "offpolicy", **report})
    HEADLINES["offpolicy"] = {
        "step_ms_mean": report["step_s_mean"] * 1e3,
        "env_steps_per_s": report["env_steps_per_s"],
        "grad_updates_per_s": report["grad_updates_per_s"],
        "split_ms_mean": {k[:-2]: statistics.mean(s_[k] for s_ in split) * 1e3
                          for k in split[0]},
        **{k: (prof or {}).get(k) for k in ("device_busy_ms", "device_idle_share",
                                            "device_launches", "sumtree_update_ms_per_launch")},
    }
    if device == "cuda":
        offpolicy_cpu_check(torch, program, ts, cfg)
    return launches


def ptxas_report(build) -> dict:
    """``ptxas -v``'s registers, static shared memory and spills for every
    kernel of the five redesigned sources, with the dynamic shared memory
    their launchers ask for at the main path's shapes (bf16, D = 64; the
    backward's at D = 32 and 128 too)."""
    from rl_tpu_torch.kernels import paged_attention
    from rl_tpu_torch.ops import attention

    T, D = FLASH_MAIN["T"], FLASH_MAIN["D"]
    tiles = -(-T // 64)
    return {
        "phase": "ptxas",
        **{f"{stem}.cu": build.ptxas_usage(stem)
           for stem in ("paged_decode", "paged_decode_int8", "sumtree", "flash_fwd", "flash_bwd")},
        "dynamic_smem_bytes": {
            "paged_decode_split bf16 D=64 G=1": attention._paged_decode_smem(2, D, 1),
            **{f"paged_decode_int8_split D={d} G={g}": paged_attention._paged_decode_int8_smem(d, g)
               for d, g in ((64, 1), (32, 4), (128, 4))},
            # sumtree.cu segment_smem: two levels of 8-byte keys, the
            # deltas and two levels of values, per key of a power of two
            **{f"sumtree_segments B={b}": b * (2 * 8 + 3 * 4) for b in (256, 4096)},
            # flash_fwd.cu bf16_smem: Q tile, two K and two V stages of 64
            # rows of D + 8 bf16, then one int per key tile and two more
            "flash_fwd_bf16 D=64 T=1024": 2 * (64 + 4 * 64) * (D + 8) + 4 * (tiles + 2),
            # flash_bwd.cu bwd_bf16_smem: six 64-row tiles of d + 8 bf16,
            # three 64-word rows for each of two stages, one int per tile
            # and two more
            **{f"flash_bwd_bf16 dq and dkv D={d} T=1024": 2 * 6 * 64 * (d + 8) + 4 * 6 * 64
               + 4 * (tiles + 2) for d in (32, 64, 128)},
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from rl_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"rl_tpu_torch/kernels/csrc/{s}.cu" for s in libs],
          "flags": list(_build.NVCC_FLAGS)})
    emit(ptxas_report(_build))
    card = power_line()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernels", kernels_phase, torch)
    # registers, shared memory and spills of each redesigned kernel at its
    # main path's instance (bf16 q, D = 64, one head a block; B7's segment
    # route with one update a thread)
    for name, stem, needles in [
            ("paged_flash_decode", "paged_decode", ("Li64ELi1E", "bfloat16")),
            ("paged_flash_decode_int8", "paged_decode_int8", ("Li64ELi1E", "bfloat16")),
            ("sumtree_update", "sumtree", ("sumtree_segmentsILi1E",))]:
        rows[name]["ptxas"] = [k for k in _build.ptxas_usage(stem)
                               if all(n in k["kernel"] for n in needles)
                               or ("combine" in k["kernel"] and "bfloat16" in k["kernel"])]
    by_phase = {"serve": timed("serve", serve_phase, torch, card)}
    timed("check", check_phase, torch)
    by_phase["train"] = timed("train", train_phase, torch, card)
    timed("train_check", train_check_phase, torch)
    by_phase["offpolicy"] = timed("offpolicy", offpolicy_phase, torch, card)
    emit({"phase_seconds": seconds})
    order = [f.__name__ for f in path_kernels()]
    for name in order:
        row = rows[name]
        # each phase zeroes and reads every kernel's count
        require(all(name in n for n in by_phase.values()), f"{name}: a phase has no count")
        row["launches_by_phase"] = {ph: n[name] for ph, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        row["card"] = card
    emit({"kernels": [rows[n] for n in order]})
    emit({"headlines": HEADLINES, "phase_seconds": seconds})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
