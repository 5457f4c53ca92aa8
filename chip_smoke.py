#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``, and exits nonzero without them. Phases, each
printing one JSON line:

1. ``build``   — compile every CUDA kernel of the port from its source;
   then a ``ptxas`` line:
   registers, static shared memory and spills of every kernel of
   ``paged_decode.cu``, ``paged_decode_int8.cu``, ``sumtree.cu``,
   ``flash_fwd.cu``, ``flash_bwd.cu``, ``flash_decode.cu`` and
   ``fused_sample.cu``, with the dynamic shared memory their launchers ask
   for at the main shapes.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card (paged decode: bf16 and f32 pools, GQA and MHA, tables with -1/0
   entries, lengths at block edges, and the train collect's shape, 8
   slots of 513-1024 positions, timed beside the serving shape; fused
   sampling: greedy and sampled on
   the same noise, an exact tie, top-k with ties at the threshold, and
   the row split's cases: a tie across a chunk boundary, bf16 logits
   without a cast, S = 1, 64 and 70000 (V = 64), V = 32000 and 50257, a
   row of -inf but one entry, each greedy and sampled at temperature 1,
   0.7 and 1e-9 (the 1e-6 clamp), timed sampled, greedy, with bf16 logits
   and with top-k 50 on its own route; flash
   attention forward, dQ and dK/dV: bf16 and f32, MHA, GQA 12/4 and MQA,
   causal and not, a left-padded kv_mask with fully masked rows, packed
   segment ids, T = 1000, bf16 views at an odd offset, and the training
   shape with a left-padded kv_mask, where the backward is also timed as
   a whole, delta pre-pass included, beside SDPA's whole backward, each
   read by CUDA events after a ~0.1 and a ~1 ms spin and by the
   profiler's sum of kernel times (SDPA's backend named from its
   kernels); dense-cache decode: f32 and bf16, MHA, GQA 12/4 and MQA, D
   32/64/128, cache_len at 1, a tile edge, mid-cache and S, a left-padded
   kv_mask, an S that is not a tile multiple, and the evaluate shape,
   timed at cache_len 513, 768 and 1023; the split design's cases: fills
   at the 64-position split edges up to 1023, pads that hide whole
   splits, a row with no visible key, visible keys in the last split
   only, GQA 12/4, MQA 8/1, D 32 and 128, S = 200, each in f32 and bf16;
   ``dense_oracle``: the kernel and the plain version against float64 at
   the evaluate shape in float32, plain and with |s| of tens (the
   kernel's error at or under the plain version's);
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
   mean |d log-prob| below 0.1. Last, every other of the 16 greedy
   requests to 16 new tokens under ``torch.profiler``, through bf16 and
   through int8 pools
   (B5's device ms a call and B6's device ms per decode step apart).
3b. ``fleet`` — the serving engine's outer layers at ``bench_fleet``'s
   full tier (``bench.py:2177-2360``, uncut: max_seq_len 256, bf16, three
   members of 8 slots, block 16, one prompt rung of 32, greedy, chunk 4).
   (a) Each member's ladder captured, one warm member's rate measured
   alone, then seeded open-loop Poisson arrivals over 20 s at 0.9 x 3 x
   that rate, 3x over [0.4T, 0.55T], 70/30 interactive/batch, with
   ``fleet.engine_crash.1`` armed at 0.5T: the fleet's tokens/s beside
   the member's, TTFT p50/p99 before and after the crash, sheds, the
   accounting, the crash and re-admission; gates: admitted == completed
   + shed and no request completed twice, the crash on member 1, no
   capture during the traffic. (b) The KV handoff (``kv_handoff=True``)
   over bf16, int8, float32 and float32 int8 pools: bytes and ms a
   request (the detached prefill with its read-back; the scatter), the
   tokens against one mixed engine, and in float32 (directly, and over
   float pools also through a ``disaggregate=True`` fleet of one prefill
   and two decode members) gated as ``check`` gates the engine: equal,
   else the first parting at a top-2 margin under its floor. (c) A ``ServingService`` on
   127.0.0.1:0 through ``RemoteEngine``, float32: the tokens of a local
   engine by the same rule, and a ``/metrics`` scrape with the engine's
   series. (d) A live ``Autoscaler`` taking a 1-member fleet to 2 under
   a TTFT burn and back to 1 under slack: one scale-down, every request
   completed once, and the scale-up's capture delta the new member's
   ladder. (e) One GRPO collect of 2 prompts x 8 through a 2-member
   fleet's batch lane after its weight push; every row completed.
   (a) runs with a trace recorder armed, as bench_fleet runs it: the
   dispatcher's ``fleet/dispatch`` and each member's ``fleet/step`` spans,
   and, once the plan is submitted and requests still wait, the card's
   idle share from ``nvidia-smi``'s utilization over 2 s. Launch counts are set to 0
   before each part and read after it; the graph replays of (a) and (d)
   are counted as each program's replays times its launches in one
   traced replay. B4 and B5 must be > 0 in every part, B6 in (b).
4. ``check``   — the same width in float32: engine tokens against the
   argmax of the no-cache forward, teacher-forced on prompt + completion,
   for the float pools and for ``kv_int8`` pools (at positions whose
   top-2 margin clears 4x the int8 cache's measured log-prob error; that
   error at most 0.03, at least half the positions decisive); and a
   shared-prefix run whose greedy tokens with the prefix cache equal
   those without it.
4b. ``spec``  — speculative decoding at ``bench_spec``'s full width
   (``bench.py:3236-3272``: GPT-2-small width, bf16, max_seq_len 256, 8
   slots, 16-token blocks, 1025 blocks, prompt rung 128 and suffix rungs
   8 and 16, the prefix cache, decode chunk 4, 15 drafts a verify; a
   96-token system prompt before 2-7 tokens of each of 8 replayed
   prompts, 128 new tokens), every engine ``slot_rng=True``. Arms: greedy
   vanilla against ``speculative=True`` drafting from the radix tree (a
   cold round, then a replay); the same pair at temperature 1.0 from one
   seed, drafting the vanilla completions (a sampled replay's new rids
   have other streams than the tree's continuations); ``NGramDraft``;
   ``kv_int8`` pools, cold and replay; and the sampled speculative engine
   with every program a CUDA graph (``registry=``, ``warmup=True``),
   equal to the eager one bit for bit, its programs the reference's
   ladder. Each arm is held to vanilla by the margin rule: the two
   engines' tokens agree up to the first position where they part, and
   there the vanilla run's top-2 gap (logits, plus the gumbel noise when
   sampled) is within the route margin, the most a gap between two logits
   moves between the decode route (B4/B6, T = 1) and the verify route
   (the gather route, T = 16 and 4), measured teacher-forced on the
   vanilla tokens. Also the device's threefry against the CPU's (key
   words, bits and uniforms bit for bit) at verify's 8 x 16 x 32768
   shape. Prints tokens/s of each arm, accepted tokens a verify, the draft
   hit rate, the margins and the positions under them, and peak memory.
   Launch counts are set to 0 before the arms and read after the int8
   arm; B4, B5 and B6 must be > 0.
5. ``train``   — the same width in bf16 with ``attention_impl="flash"``:
   ``GRPOTrainer`` (16 rollouts of 512 prompt + 512 new tokens through the
   engine, microbatch 8) takes 2 steps; per step collect and update
   seconds, update MFU, loss, reward, bad steps; then greedy
   ``evaluate`` over 8 prompts (the dense-cache ``generate`` with
   ``flash_decode``), one collect of 2 prompts x 8 through
   ``LLMCollector(engine_prefix_cache=True)`` (group hits > 0), one
   profiled update, its device time split by kernel, and 16 profiled
   decode steps of the evaluate's ``generate`` (B3's device ms a call).
   Every kernel's count
   is set to 0 before the steps
   and read after the collect; every kernel of the path must be > 0.
6. ``train_check`` — full width in float32, one microbatch of 8 x 1024
   with left padding: the GRPO loss and every parameter gradient through
   the flash kernels (also under per-block remat "none" and "dots")
   against the dense attention, same weights.

7. ``offpolicy`` — SAC with device prioritized replay at the reference's
   full size (``bench.py`` full widths), built by
   ``make_sac_trainer(prioritized=True)``: its ``OffPolicyProgram`` over
   ``VmapEnv(PendulumEnv(), 256)``, 2048 frames a batch, 256x256 actor and
   twin critics, batch 256, 4 updates a step,
   ``ReplayBuffer(DeviceStorage(1_000_000), PrioritizedSampler())``
   (alpha 0.6, beta 0.4, fanout 16), float32.
   ``prefill`` (5000 random frames), one warm-up step, 30 counted steps
   (env steps/s, updates/s; every kernel's count set to 0 before and
   read after; B7 must launch 4 times a step), 3 steps split into
   collect, extend and updates, one profiled step (idle share, B7's
   device time). Gates: finite losses, 0 bad steps, priorities moved,
   every block sum within 1e-5 of its leaves' sum, the reference's PER
   distribution check; then ``offpolicy_check``: 4 updates on the card
   and the same 4 on the CPU from one state and one set of draws, same
   sampled indices, parameters and the PER tree within stated limits.
7b. ``td3_family`` — DDPG, TD3, TD3+BC (TD3's factory with the BC loss),
   REDQ (10 critics, UTD 8) and CrossQ from the reference factories'
   defaults on ``VmapEnv(PendulumEnv(), 256)``: 256x256 nets, 1024 frames
   a step, batch 256, a 1M-slot uniform ``DeviceStorage``, 5000 random
   frames, float32. Each: two copies built alike, 2 eager steps, then 4
   steps of one through ``jit_train_step`` against eager steps of the
   other, equal bit for bit (state, metrics, parameters, targets, Adam,
   CrossQ's running statistics; TD3's held and moving updates both
   seen); host ms a call, env steps/s and updates/s eager and replayed
   over 8 calls, one profiled call each (idle share); 4 updates on the
   card against the same 4 on the CPU from one state and fed draws.
   Discrete SAC: loss, metrics and gradients on a CartPole batch, card
   against CPU. No kernel of the port lies on these paths.
7c. ``async_offpolicy`` — ``bench_async_collect``'s full tier
   (``bench.py:1829-1835``): ``AsyncOffPolicyTrainer`` on 16 host envs
   with Pendulum-v1's dynamics (:class:`NumpyPendulum`, gymnasium's
   ``PendulumEnv`` in numpy) in a ``ThreadedEnvPool``, 256 frames a
   batch, UTD 4, batch 256, ``DeviceStorage(1 << 14)`` with
   ``PrioritizedSampler()`` and "td_error", SAC with 64x64 nets, lr
   3e-4: the K-update (``offpolicy.k_updates``, B7 4 times) and the
   chunk write (``replay.extend``) captured by ``aot_warmup``; a 512-frame
   warm-up pass, a 4096-frame async run (env steps/s, updates/s,
   straggler cutoffs, harvests, the largest queue depth, the host's ms a
   batch split into wait, extend, dispatch and publish, peak memory), a
   profiled 1024-frame window (B7's launches = UTD x its batches), the
   K-update's and the write's device ms by CUDA events around unprofiled
   replays and the async run's idle share from them, then the same two
   programs serially behind a ``HostCollector`` (``bench.py:1893-1955``)
   and the async/sync ratios (printed, not gated). Gates: one replay of
   each program equal to its eager run bit for bit (parameters, Adam,
   targets, the ring, the PER tree, the metrics), one capture each and
   none after warm-up, per-env policy versions monotone and the last
   version the number of dispatches, 4 K-updates on the card, each within
   ``CPU_CHECK_PARAMS`` of the CPU's from the card's state before it (the
   same indices, the PER tree after each; fed draws), and
   the five other samplers at 16,384 slots on fed draws equal on the card
   and the CPU (indices and masks exactly, weights and staleness within
   1e-6 relative), each one's ``sample`` and ``on_write`` captured and
   replayed equal to eager.
7d. ``resilience`` — checkpoints and chaos on the card. GRPO at the
   train phase's width (bf16, flash, the continuous-batching engine: B1,
   B2, B4, B5; 16 rollouts of 128 + 64 tokens, microbatch 8), every
   trainer with ``warmup=True``: an uninterrupted run of 4 steps; a run
   preempted through the injector's ``trainer.preempt`` before step 2,
   whose ``emergency_save`` is timed and sized; a fresh trainer built
   alike in the same process, ``emergency_restore`` and the other 2
   steps, the seconds from its construction to the end of its first step
   (build, the update's capture, the load, the decode chunks' captures);
   then a restart in a new process (``chip_smoke.py restart``): torch's
   import, CUDA's start, the kernels' libraries loaded from ``build/``,
   the build and capture, the load of the same checkpoint (just written:
   a warm read) and one step at the train phase's lengths (16 x (512 +
   512) tokens), timed from ``Popen`` to its exit and split by the child.
   Gate: the resumed run's master weights, Adam, device metrics and
   history equal the uninterrupted run's bit for bit (failing that, a
   second uninterrupted run measures the run-to-run spread, printed, and
   the resumed run must lie within it); the new process resumes at the
   saved step with a finite step and no bad step. Launches: the
   wrappers' counts, and each GRPO trainer's update and engine graphs'
   replays from one traced replay of each kind. Then the async cell's trainer (7c's
   config) with the chaos injector: two trainers built alike dispatch
   ``offpolicy.k_updates_chaos`` (a graph) and its eager body over three
   chunks with poisons NaN, 0, NaN, bit for bit, and one more replay
   traced (B7 once an update, its launches counted for every chaos
   replay of the phase); a poisoned single
   update leaves parameters, targets and Adam bit for bit unchanged and
   counts one bad step; a 2560-frame ``train`` run with a ``LastGoodState``
   guard (rollback after 1 bad step), an ``offpolicy.update`` NaN at
   dispatch 3 and a ``collector.actor_loop`` crash at iteration 40 under
   a ``Supervisor``: one rollback that restores the snapshot bit for bit,
   one bad step, one restart, every frame consumed.
8. ``ppo``     — the bench headline's program (``bench.py:225-281`` at its
   full tier): ``OnPolicyProgram`` over ``TransformedEnv(VmapEnv(
   CartPoleEnv(), 2048), RewardSum())``, 64x64 actor and critic,
   ``ClipPPOLoss(normalize_advantage=True)`` with GAE(0.99, 0.95), 65536
   frames a step, 4 epochs of minibatch 8192, float32. One warm-up step,
   8 counted steps (env steps/s; every kernel's count set to 0 before and
   read after: no kernel of the port lies on this path), 3 steps split
   into collect, advantage and update, one profiled step (device busy
   time, idle share, launches). Gates: every metric finite, parameters
   moved. Then ``ppo_check``: one ``update_from_batch`` (64 envs x 32
   steps, minibatch 512) on the card and on the CPU from one set of
   weights, one batch and one permutation: the first minibatch's loss and
   gradients and the final parameters within stated limits; and
   ``ppo_learn``: the README quick start (``make_ppo_trainer`` over 32
   envs, 100 steps of 2048 frames), whose last 5 steps' mean episode
   reward beats the first 5's by more than 20.
9. ``pipeline`` — ``PipelinedGRPOTrainer(max_pending=1)`` at the train
   phase's configuration (a producer thread on its own CUDA stream
   collects batch k + 1 through the engine while the update runs on
   batch k; two serving copies): one warm-up step and 1 counted step,
   each with the consumer's wait in ``get``, the update, the producer's
   collect (timed in its thread) and the cycle; ``overlap_frac``
   (``bench.py:1288-1290``) and the tokens a cycle beside the train
   phase's sequential collect plus update. Gates: staleness at most 1
   and 0 first, ``policy_version`` equal to the steps, no bad step,
   finite metrics, B1, B2, B4 and B5 launched, every serving copy equal
   to ``master.to(cfg.dtype)`` at the version it holds after ``close()``
   (bit for bit), and the first update equal to the train phase's first
   update from the same seed, parameter by parameter.
10. ``dqn``    — ``examples/dqn_cartpole.py`` on the port:
   ``make_dqn_trainer`` defaults over ``TransformedEnv(VmapEnv(
   CartPoleEnv(), 16), RewardSum())`` (256x256 q-net, double DQN,
   ``MultiStep(0.99, 3)``, epsilon-greedy, a 1M-slot ``DeviceStorage``
   with ``PrioritizedSampler``), 512 frames a batch, batch 256, UTD 4,
   2000 random frames, 200 steps through ``Trainer.train(0)``: env
   steps/s, updates/s, 3 steps split into collect, extend and updates,
   one profiled step. Gates: finite metrics, no bad step, B7 launched 4
   times a step, every block sum within 1e-5 of its leaves' sum.
11. ``dqn_check`` — 4 updates on the card and the same 4 on the CPU from
   the dqn phase's state and one set of sampler draws: the same indices,
   parameters, targets and the PER tree within stated limits.
12. ``dqn_learn`` — the reference's DQN learning check
   (``tests/test_offpolicy.py:187-219``): 8 CartPole envs capped at 200
   steps, 64x64 q-net, uniform 20k buffer, batch 128, UTD 8, 60 steps;
   the last 10 steps' mean episode reward beats the first 10's by more
   than 15.
13. ``per``    — ``bench.py:1566-1776`` (``bench_per``) at its full tier: a
   1M-slot ``PrioritizedSampler``, batch 256, the device cycle (sample,
   gather of a [1M, 8] table's rows, td-error, write-back through B7)
   eagerly and as its CUDA graph, against the port's
   ``HostPrioritizedSampler`` (C++ segment tree) serving the same device
   learner and the host tree alone: microseconds a cycle (the best of 5
   calls of 50 cycles) and ``per_on_device_speedup_vs_host_tree``; then
   DQN on CartPole (the dqn cell, 30 steps) with each sampler. Gates:
   block sums, finite DQN losses, no bad step.
14. ``graphs`` — each registered program, eager against its CUDA graph,
   from two copies built alike: the SAC step (offpolicy cell) and the
   DQN step (dqn cell) through ``jit_train_step``, the PER cycle through
   ``jit_sample_and_update`` (also with ``beta_annealing_steps=2``: beta
   0.4, 0.7, 1.0 over the three gated calls), the engine at serving width
   over bf16 and int8 pools and behind the 384-token system prompt with
   the prefix cache (``registry=``, ``warmup=True``: the decode chunk and
   the whole admission ladder, ``serving.prefill``/``pprefill``,
   ``cowcopy`` and ``admit_update``), the PPO update at the bench shape
   through ``jit_update_from_batch`` and the whole PPO step through
   ``jit_train_step`` (the ``collector.collect`` graph, the permutations,
   the update's graph), and the GRPO update and ``evaluate``'s
   ``grpo.eval_gen`` at the train cell's shape (``GRPOTrainer(warmup=
   True)``: B1 and B2 in the update's graph, B3 in evaluate's) on one
   collected batch. Gates: every replay equal to the eager run bit for
   bit (states, batches, outputs, parameters; the engines' tokens and
   log-probs of 16 sampled requests served in lockstep; evaluate before
   and after an update), one capture per graph, none in an engine's
   traffic after its warm-up. Then per path: host ms a call (the
   engines: a decode step and an admission round), device launches (the
   profiler's, since a replay runs no wrapper), busy time, idle share
   and peak device memory, eager and replayed; the device memory the
   engines' ladders reserve (decode only, the full ladder in the
   engine's one pool, one pool a graph); evaluate's capture seconds.
   Two more cases: the PPO step (bench shape) with ``anneal_lr_to``
   through ``jit_train_step``, 3 replays equal to eager bit for bit while
   the learning rate (computed on the card from Adam's count) moves; and
   ``PrioritizedSliceSampler.update_priority`` at 1M slots with 32
   overlapping slices of 8 (repeated positions), the card equal to the
   CPU and a replay equal to eager.

Then one line with each phase's seconds, one line ``{"kernels": [...]}``
(per kernel: launches in the main path's phases, error, times, bound),
a ``headlines`` line (serve: tokens/s, decode step, profiled device ms
per decode step and idle share; spec: vanilla and speculative tokens/s of
the greedy replay, accepted tokens a verify, the route margins, positions
under them, flips and peak memory; train: update seconds and MFU per step,
the profiled update's device ms, its split by kernel and idle share;
B2's times beside SDPA's backward; B3 and B5 beside SDPA and the
float64 oracle; the off-policy split; the PPO headline's env steps/s,
split, idle share and launches, the card-against-CPU check's worst
excesses and the quick start's first and last episode rewards; the
pipeline's cycle, collect, update, wait and ``overlap_frac``; DQN's env
steps/s, updates/s, split, idle share and B7 launches, its card-against-CPU
excess and its learning windows; PER; per registered program, eager and
replayed host ms, launches, host API calls, idle share and peak memory,
the engines' admission rounds, tokens/s and ladder memory, the PPO
step's env steps/s, evaluate's capture seconds),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failed check raises.

"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

T_IMPORT = time.perf_counter()  # a restarted process's clock (restart_child)
T_MAIN = T_IMPORT  # set by main() once torch is imported

import numpy as np  # noqa: E402

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
# What the train phase's sequential GRPOTrainer leaves for the pipeline
# phase: its parameters after the first update and its per-step seconds.
SEQUENTIAL = {}


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def excess(a, b, tol) -> float:
    """The largest ``|a - b|`` less its limit ``atol + rtol * |b|``
    (``tol = (rtol, atol)``): at most 0 where ``a`` is within it."""
    rtol, atol = tol
    return ((a.float() - b.float()).abs() - atol - rtol * b.float().abs()).max().item()


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


def dense_inputs(torch, gen, B, S, H, Hk, D, dtype, pads=None):
    """Random q [B, 1, H, D], k and v [B, S, Hk, D] and, with ``pads``, a
    left-pad kv_mask [B, S] (position >= pad)."""
    dt = getattr(torch, dtype)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(dt)
    mask = None
    if pads is not None:
        mask = torch.arange(S, device="cuda")[None, :] >= torch.tensor(pads, device="cuda")[:, None]
    return q, k, v, mask


# the evaluate's decode: 8 prompts left-padded to 512, 512 new tokens, 12
# heads of 64; cache_len runs 513 .. 1023 over its steps
EVALUATE_SHAPE = dict(B=8, S=1024, H=12, Hk=12, D=64)
EVALUATE_LENS = (513, 768, 1023)


def dense_oracle(torch, q, k, v, cache_len, mask):
    """B3's function in float64 on the card: the plain version's masked
    softmax with every step in float64, from the same ``q * scale`` the
    kernel is given (rounded in q's dtype)."""
    from rl_tpu_torch.ops.attention import decode_softmax_pv

    B, _, H, D = q.shape
    Hk, n = k.shape[2], cache_len
    qs = (q * D**-0.5)[:, 0].double().reshape(B, Hk, H // Hk, D)
    kk, vv = (t[:, :n].permute(0, 2, 1, 3).double() for t in (k, v))
    valid = torch.ones((B, n), dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = valid & mask[:, :n]
    return decode_softmax_pv(qs, kk, vv, valid[:, None, None, :]).reshape(B, 1, H, D)


def dense_oracle_readings(torch):
    """B3's float32 output and its plain version's, each against the
    float64 oracle, at the evaluate shape and cache_len 768 with the
    evaluate's left pads: ``main_evaluate_float32``, and
    ``large_scores_float32`` with q x 8, so that |s| reaches tens. Inputs
    from a generator of their own. Returns the readings; the caller
    gates."""
    from rl_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    n, pads = 768, evaluate_pads()
    out = []
    for label, q_gain in (("main_evaluate_float32", 1.0), ("large_scores_float32", 8.0)):
        q, k, v, mask = dense_inputs(torch, gen, dtype="float32", pads=pads, **EVALUATE_SHAPE)
        q = q * q_gain
        got = A.flash_decode(q, k, v, n, kv_mask=mask)
        ref = A.flash_decode_ref(q, k, v, n, kv_mask=mask)
        exact = dense_oracle(torch, q, k, v, n, mask)
        s = torch.einsum("bhd,bnhd->bhn", (q * q.shape[-1] ** -0.5)[:, 0].double(),
                         k[:, :n].double())
        torch.cuda.synchronize()
        out.append({"case": label, "kernel_vs_plain": (got - ref).abs().max().item(),
                    "kernel_vs_float64": (got.double() - exact).abs().max().item(),
                    "plain_vs_float64": (ref.double() - exact).abs().max().item(),
                    "max_abs_score": s[mask[:, None, :n].expand_as(s)].abs().max().item(),
                    "max_abs_out": exact.abs().max().item()})
    return out


def flash_decode_timings(torch, q, k, v, mask, lens=EVALUATE_LENS):
    """B3's kernel time (one C call), its plain version's, its bound and
    SDPA's at each cache_len of ``lens`` on one input."""
    import torch.nn.functional as F

    from rl_tpu_torch.ops import attention as A

    scale = q.shape[-1] ** -0.5
    qs, out = (q * scale).contiguous(), torch.empty_like(q)
    qh = q.transpose(1, 2).contiguous()
    res = {}
    for n in lens:
        ms = time_ms(torch, lambda: A._decode_launch(qs, k, v, mask, out, n))
        plain_ms = time_ms(torch, lambda: A.flash_decode_ref(q, k, v, n, kv_mask=mask))
        # yardstick (not used by the port): one SDPA call over the cache up
        # to cache_len, laid out [B, H, n, D] beforehand, with the mask
        kh, vh = (t[:, :n].transpose(1, 2).contiguous() for t in (k, v))
        mh = mask[:, None, None, :n].contiguous()
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mh, scale=scale))
        bound_ms, bound_by = dense_decode_bound(q, k, n, mask)
        res[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms,
                  "visible_positions": int(mask[:, :n].sum().item())}
    return res


def fused_sample_bound(S, V, x_bytes, with_noise):
    """(bound_ms, bound_by) of B5: each logit (``x_bytes`` each) and noise
    value (4 bytes) read once, token and log-prob written; ~8 float32
    operations an entry."""
    nbytes = S * V * (x_bytes + (4 if with_noise else 0)) + S * 8
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 8 * S * V / PEAK_OPS["float32"]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def fused_sample_timings(torch, x, noise):
    """B5 on [S, V] float32 logits ``x``: sampled and greedy through one
    C call, top-k 50 on its own route, and bf16 logits through the public
    wrapper (which the parent design cast to a float32 copy first); each
    with its bound and the plain version's time."""
    from rl_tpu_torch.kernels import sampling

    S, V = x.shape
    xb = x.to(torch.bfloat16)
    tok = torch.empty(S, dtype=torch.int32, device="cuda")
    lp = torch.empty(S, dtype=torch.float32, device="cuda")
    runs = {
        "sampled_float32": (lambda: sampling._launch(x, noise, 1.0, tok, lp),
                            lambda: sampling.fused_sample_ref(x, noise), 4, True),
        "greedy_float32": (lambda: sampling._launch(x, None, 1.0, tok, lp),
                           lambda: sampling.fused_sample_ref(x, None, greedy=True), 4, False),
        "sampled_bfloat16_wrapper": (lambda: sampling.fused_sample(xb, noise),
                                     lambda: sampling.fused_sample_ref(xb, noise), 2, True),
        "topk50_sampled_float32": (lambda: sampling._launch(x, noise, 1.0, tok, lp, 50),
                                   lambda: sampling.fused_sample_ref(x, noise, top_k=50), 4, True),
    }
    res = {}
    for name, (fn, plain, x_bytes, with_noise) in runs.items():
        bound_ms, bound_by = fused_sample_bound(S, V, x_bytes, with_noise)
        res[name] = {"ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain),
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return res


# B5 cases added with the row split (own generator, so the earlier cases
# keep their inputs): an exact tie across a chunk boundary (indices 100
# and 30000, chunks 0 and 14); bf16 logits, which go to the kernel without
# a cast; S = 1 and 64 (other chunk counts) and 70000 rows of 64; V =
# 32000 and 50257 (no multiple of the chunk); a row of -inf but one
# entry. Each under greedy, and sampled at temperature 1, 0.7 and 1e-9
# (clamped to 1e-6).
B5_SPLIT_SPECS = [
    ("tie_across_chunks", dict(S=8, V=32768, tie=(100, 30000))),
    ("bf16_logits", dict(S=8, V=32768, dtype="bfloat16")),
    ("s1", dict(S=1, V=32768)),
    ("s64", dict(S=64, V=32768)),
    ("s70000_v64", dict(S=70000, V=64)),  # more rows than a grid's y or z dimension holds
    ("v32000", dict(S=8, V=32000)),
    ("v50257", dict(S=8, V=50257)),
    ("neg_inf_but_one", dict(S=8, V=32768, lone=20000)),
]
B5_MODES = [("greedy", dict(greedy=True)), ("sampled_t1", dict(temperature=1.0)),
            ("sampled_t07", dict(temperature=0.7)), ("sampled_t1e-9", dict(temperature=1e-9))]


def fused_sample_split_cases(torch, cases):
    """B5 on the split design's cases against its plain version: tokens
    equal, log-probs within TOL_SAMPLE_LP; the tie to its first index, the
    lone finite entry chosen."""
    from rl_tpu_torch.kernels import sampling

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for name, kw in B5_SPLIT_SPECS:
        S, V = kw["S"], kw["V"]
        x = torch.randn((S, V), generator=gen, device="cuda") * 3.0
        noise = sampling.gumbel_like(x, gen)
        if "tie" in kw:
            i, j = kw["tie"]
            x[0, i] = x[0, j] = x[0].max() + 1.0
            noise[0, i] = noise[0, j] = 50.0
        if "lone" in kw:
            x[1] = float("-inf")
            x[1, kw["lone"]] = 2.5
        x = x.to(getattr(torch, kw.get("dtype", "float32")))
        for mode, mkw in B5_MODES:
            tok_k, lp_k = sampling.fused_sample(x, noise, **mkw)
            tok_r, lp_r = sampling.fused_sample_ref(x, noise, **mkw)
            torch.cuda.synchronize()
            same = bool(torch.equal(tok_k, tok_r))
            err = (lp_k - lp_r).abs().max().item()
            label = f"{name}_{mode}"
            cases.append({"kernel": "fused_sample", "case": label, "tokens_equal": same,
                          "max_abs_err": err, "tol": TOL_SAMPLE_LP,
                          "chunks": sampling.sample_plan(S, V)})
            require(same, f"fused_sample {label}: tokens differ")
            require(err <= TOL_SAMPLE_LP, f"fused_sample {label}: lp err {err}")
            if "tie" in kw:
                require(int(tok_k[0]) == kw["tie"][0],
                        f"fused_sample {label}: tie went to {int(tok_k[0])}")
            if "lone" in kw:
                require(int(tok_k[1]) == kw["lone"], f"fused_sample {label}: lone entry missed")


# B3 cases added with the split design (fill levels; own generator, so
# the earlier cases keep their inputs): fills at and across the 64-position
# split edges up to 1023; left pads that hide whole splits, one row with
# no visible key at cache_len 129; visible keys in the last split only;
# GQA 12/4, MQA 8/1, D 32 and 128, S = 200
B3_SPLIT_SPECS = [
    ("split_edges_s1024", dict(B=2, S=1024, H=4, Hk=4, D=64), (63, 64, 65, 128, 129, 1023)),
    ("whole_split_pads", dict(B=4, S=256, H=12, Hk=12, D=64, pads=[0, 64, 128, 200]),
     (129, 201, 256)),
    ("last_split_only", dict(B=2, S=256, H=12, Hk=12, D=64, pads=[192, 250]), (256,)),
    ("gqa12_4", dict(B=3, S=256, H=12, Hk=4, D=64, pads=[0, 70, 130]), (65, 200, 256)),
    ("mqa8_1", dict(B=3, S=256, H=8, Hk=1, D=64), (1, 129, 256)),
    ("d32", dict(B=3, S=192, H=8, Hk=4, D=32, pads=[0, 64, 100]), (64, 150, 192)),
    ("d128", dict(B=2, S=192, H=8, Hk=2, D=128, pads=[0, 64]), (63, 129, 192)),
    ("s200", dict(B=2, S=200, H=4, Hk=2, D=64, pads=[0, 128]), (129, 199, 200)),
]


def flash_decode_cases(torch, gen, cases):
    """B3 against its plain version over dtypes, head groupings, head
    dims, fill levels, masks and ragged S; then held and timed at the
    evaluate shape [8, 1024, 12, 64] bf16 with the evaluate's left pads at
    cache_len 768 (and 513 and 1023); then the split design's cases, and
    the kernel and the plain version each against a float64 oracle in
    float32 (the kernel's error at or under the plain version's)."""
    from rl_tpu_torch.ops import attention as A

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
            q, k, v, mask = dense_inputs(torch, gen, dtype=dtype, **shape)
            for n in fills:
                hold(f"{name}_len{n}_{dtype}", q, k, v, n, mask)

    # the evaluate shape: 8 prompts of 512 + 512 new tokens, cache at 768
    pads, n = evaluate_pads(), 768
    q, k, v, mask = dense_inputs(torch, gen, dtype="bfloat16", pads=pads, **EVALUATE_SHAPE)
    err = hold("main_evaluate_bfloat16", q, k, v, n, mask)
    timings = flash_decode_timings(torch, q, k, v, mask)

    gen_split = torch.Generator(device="cuda")
    gen_split.manual_seed(4)
    for name, shape, fills in B3_SPLIT_SPECS:
        for dtype in ("float32", "bfloat16"):
            qs, ks, vs, ms = dense_inputs(torch, gen_split, dtype=dtype, **shape)
            for fill in fills:
                hold(f"{name}_len{fill}_{dtype}", qs, ks, vs, fill, ms)
    oracle = dense_oracle_readings(torch)
    for r in oracle:
        excess = r["kernel_vs_plain"] - TOL_DECODE["float32"]
        cases.append({"kernel": "flash_decode", "case": r["case"],
                      "max_abs_err": r["kernel_vs_plain"], "excess_over_limit": excess})
        require(excess <= 0.0, f"flash_decode {r['case']}: max abs err {r['kernel_vs_plain']}")
        require(r["kernel_vs_float64"] <= r["plain_vs_float64"],
                f"flash_decode {r['case']}: {r['kernel_vs_float64']} from float64, above the "
                f"plain version's {r['plain_vs_float64']}")
    return {
        "name": "flash_decode", "tpu_kernel": "B3", "route": "cuda",
        "source": "rl_tpu_torch/kernels/csrc/flash_decode.cu",
        "replaces": "rl_tpu/ops/attention.py:599",
        "shape": f"B=8 S=1024 H=Hk=12 D=64 bf16, cache_len {n}, kv_mask left pads {pads}",
        "max_abs_err": err,
        **{key: timings[n][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        "by_cache_len": timings, "float64_oracle": oracle,
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
            sampled_err = err
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

    fused_sample_split_cases(torch, cases)
    by_mode = fused_sample_timings(torch, x, noise)
    rows["fused_sample"] = {
        "name": "fused_sample", "tpu_kernel": "B5", "route": "cuda",
        "source": "rl_tpu_torch/kernels/csrc/fused_sample.cu",
        "replaces": "rl_tpu/kernels/sampling.py:82",
        "shape": "S=8 V=32768 f32, sampled (logits + noise)", "max_abs_err": sampled_err,
        **by_mode["sampled_float32"],
        "library_ms": None,  # no single PyTorch call samples
        "by_mode": by_mode,
    }
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
    b3, b5 = rows["flash_decode"], rows["fused_sample"]
    HEADLINES["b3_b5"] = {
        "b3_ms": {n: r["ms"] for n, r in b3["by_cache_len"].items()},
        "b3_sdpa_ms": {n: r["library_ms"] for n, r in b3["by_cache_len"].items()},
        "b3_float64": {r["case"]: [r["kernel_vs_float64"], r["plain_vs_float64"]]
                       for r in b3["float64_oracle"]},
        "b5_ms": {mode: r["ms"] for mode, r in b5["by_mode"].items()}}
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


def serve_run(torch, engine, reqs, max_new, vocab, keep=None, key=None, lockstep=False):
    """Serve ``reqs`` to ``max_new`` tokens each and check every request;
    ``keep[key]`` gets the finished requests in submission order.
    ``lockstep`` waits for the card after every engine step, so that each
    step settles the previous chunk before it admits: a schedule, and
    with it an order of the sampling generator's draws, that no timing
    moves. Counts and times are this run's (an engine may have served
    before)."""
    prefill_s, rounds, steps = engine.prefill_s, engine.prefill_rounds, engine.decode_steps
    sync(torch, engine.device)
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new) for p in reqs]
    if lockstep:
        while engine.step():
            sync(torch, engine.device)
        out = engine.harvest()
    else:
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
    prefill_s, rounds = engine.prefill_s - prefill_s, engine.prefill_rounds - rounds
    steps = engine.decode_steps - steps
    return {
        "requests": len(out), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "prefill_ms_total": prefill_s * 1e3,
        "prefill_rounds": rounds,
        "prefill_ms_per_round": prefill_s * 1e3 / max(rounds, 1),
        "decode_steps": steps,
        "decode_step_ms_mean": (wall - prefill_s) * 1e3 / max(steps, 1),
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
    # B5: its two kernels, one sample_pick a call
    b5_ms = sum(t for k, t, _ in kernels if "sample_chunk_stats" in k or "sample_pick" in k)
    b5_calls = sum(c for k, _, c in kernels if "sample_pick" in k)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "decode_steps": engine.decode_steps, "device_ms_per_decode_step": busy_ms / steps,
        **({f"{focus[0]}_ms_per_decode_step":
            sum(t for k, t, _ in kernels if any(f in k for f in focus[1])) / steps}
           if focus else {}),
        "device_launches_per_decode_step": sum(c for *_, c in kernels) / max(engine.decode_steps, 1),
        "b5_calls": b5_calls, "b5_ms_per_call": b5_ms / b5_calls if b5_calls else None,
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
        # every other request (16-480 prompt tokens still), 8 in all, to
        # keep the script's time beside the fleet phase
        prof = profile_run(torch, engine(greedy=True), reqs[::2], 16)
        # the same through int8 pools; B6's kernels are the split kernel
        # and the combine, which only B6 launches on this engine
        prof8 = profile_run(torch, engine(model_int8, greedy=True), reqs[::2], 16,
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
        "profiled_b5_ms_per_call": prof and prof["b5_ms_per_call"],
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


# -- the serving fleet: bench_fleet's full tier and the outer layers ---------

# bench.py:2177-2360 (bench_fleet, full tier), uncut: three members at
# GPT-2-small width, max_seq_len 256, bf16; 8 slots of 16-token blocks and
# S * (256 // 16) + 1 blocks each; one prompt rung of 32, greedy, decode
# chunk 4; prompts of 4-23 tokens, 16-47 new tokens; seeded open-loop
# Poisson arrivals over 20 s at 0.9 x 3 x one warm member's rate, 3x over
# [0.4T, 0.55T], 70/30 interactive/batch, member 1 crashed at 0.5T
FLEET_WIDTH = dict(FULL_WIDTH, max_seq_len=256)
FLEET = dict(members=3, n_slots=8, block_size=16, bucket=32, decode_chunk=4, pmax=24,
             n_lo=16, n_hi=48, horizon_s=20.0, burst=(0.4, 0.55), burst_mult=3.0,
             interactive=0.7, load=0.9, crash_member=1, wait_s=300.0,
             handoff_requests=8, handoff_new=32, service_requests=8, service_new=32,
             collect_prompts=2, collect_repeats=8, collect_new=32)


def fleet_engine(torch, model, cfg, device, **kw):
    from rl_tpu_torch.models import ContinuousBatchingEngine

    S = cfg["n_slots"]
    return ContinuousBatchingEngine(
        model, n_slots=S, block_size=cfg["block_size"],
        n_blocks=S * (model.cfg.max_seq_len // cfg["block_size"]) + 1,
        prompt_buckets=(cfg["bucket"],), greedy=kw.pop("greedy", True),
        decode_chunk=cfg["decode_chunk"], device=device, **kw)


def fleet_requests(rng, n, cfg, vocab):
    return [(rng.integers(0, vocab, int(rng.integers(4, cfg["pmax"]))).astype(np.int32),
             int(rng.integers(cfg["n_lo"], cfg["n_hi"]))) for _ in range(n)]


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def fleet_chaos(torch, device, width, cfg, per_replay):
    """(a) bench_fleet's chaos run: the members' ladders captured, one warm
    member's rate measured alone, then the seeded open-loop plan against
    the fleet with ``fleet.engine_crash.<crash_member>`` armed at 0.5T.
    A trace recorder is armed for the traffic, as bench_fleet arms one:
    its ``fleet/dispatch`` spans (the dispatcher's submit to a member) and
    ``fleet/step`` spans (a member's step under its lock) give the host's
    side; on the card, once the plan is submitted and requests still
    wait, ``nvidia-smi``'s utilization over 2 s gives the card's idle
    share (:func:`window_utilization`). The
    launches are the wrappers' (eager, set to 0 just before the traffic)
    and each program's replays in the traffic times its launches in one
    traced replay (:func:`engine_replays`; ``per_replay`` holds those
    traced counts by program, shared with (d))."""
    from rl_tpu_torch.compile import CompileDelta, ExecutableStore, ProgramRegistry
    from rl_tpu_torch.models import (FinishedRequest, ServiceSaturated, ServingFleet,
                                     TransformerConfig, TransformerLM)
    from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder, set_tracer
    from rl_tpu_torch.resilience import Fault, FaultInjector, injection

    model = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16), device=device, seed=0)
    V, S = model.cfg.vocab_size, cfg["n_slots"]
    reg = ProgramRegistry(ExecutableStore())
    engines = [fleet_engine(torch, model, cfg, device, registry=reg, seed=i)
               for i in range(cfg["members"])]
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ladders = [sum(src == "capture" for runs in e.aot_warmup().values() for src, _ in runs)
               for e in engines]
    for e in engines:  # one traffic round through each member's graphs
        for p, n in fleet_requests(rng, 2, cfg, V):
            e.submit(p, n)
        e.run()
    warm_s = time.perf_counter() - t0
    emit({"phase": "fleet_progress", "ladders_captured": ladders, "warm_s": warm_s})
    # one warm member alone: the calibration, and the rate the fleet's
    # tokens/s stands beside
    cal = fleet_requests(rng, 3 * S, cfg, V)
    for p, n in cal:
        engines[0].submit(p, n)
    sync(torch, device)
    t0 = time.perf_counter()
    done = engines[0].run()
    sync(torch, device)
    cal_s = time.perf_counter() - t0
    member = {"requests_per_s": len(cal) / cal_s,
              "tokens_per_s": sum(len(f.tokens) for f in done.values()) / cal_s}
    lam = cfg["load"] * cfg["members"] * member["requests_per_s"]
    emit({"phase": "fleet_progress", "one_member": member, "offered_requests_per_s": lam})
    T = cfg["horizon_s"]
    arrivals, t = [], 0.0
    while t < T:
        t += rng.exponential(1.0 / lam)
        arrivals.append(t)
    b0, b1 = cfg["burst"][0] * T, cfg["burst"][1] * T
    t = b0
    while t < b1:
        t += rng.exponential(1.0 / ((cfg["burst_mult"] - 1.0) * lam))
        arrivals.append(t)
    arrivals = sorted(a for a in arrivals if a < T)
    plan = [(a, "interactive" if rng.random() < cfg["interactive"] else "batch",
             *fleet_requests(rng, 1, cfg, V)[0]) for a in arrivals]
    crash_at = 0.5 * T
    metrics = MetricsRegistry()
    tracer = TraceRecorder(capacity=1 << 17)
    prev_tracer = set_tracer(tracer)  # the fleet takes the tracer at construction
    try:
        fleet = ServingFleet(engines, registry=metrics, probe_interval_s=0.02,
                             max_queue=len(plan))
    finally:
        set_tracer(prev_tracer)
    inj = FaultInjector({f"fleet.engine_crash.{cfg['crash_member']}": Fault("crash", at=(1,))},
                        registry=metrics)
    admitted, rejected, crash_wall, window = [], 0, None, None
    steady = CompileDelta()
    zero_launches()
    replays0 = program_replays(engines)
    try:
        with contextlib.ExitStack() as stack:
            fleet.start()
            stack.enter_context(steady)
            t_start = time.monotonic()
            t_trace = tracer.now_us()
            for a, lane, prompt_, n_new in plan:
                now = time.monotonic() - t_start
                if crash_wall is None and now >= crash_at:
                    # armed at 0.5T: the member's next busy iteration crashes
                    crash_wall = time.monotonic()
                    stack.enter_context(injection(inj))
                if a > now:
                    time.sleep(a - now)
                try:
                    admitted.append(fleet.submit(prompt_, n_new, lane=lane))
                except ServiceSaturated:
                    rejected += 1
            if crash_wall is None:
                crash_wall = time.monotonic()
                stack.enter_context(injection(inj))
            if device == "cuda":
                # the card while the fleet still works through the plan
                outstanding = fleet.pending()
                window = {"at_s": time.monotonic() - t_start, "outstanding": outstanding,
                          **window_utilization(), "outstanding_after": fleet.pending()}
                emit({"phase": "fleet_progress", "card_window": window})
            results = fleet.wait(admitted, timeout=cfg["wait_s"])
            wall = time.monotonic() - t_start
            emit({"phase": "fleet_progress", "wall_s": wall, "results": len(results),
                  "admitted": len(admitted)})
        deadline = time.monotonic() + 30.0
        while fleet.metrics_snapshot()["readmissions"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        acc, snap, stats = fleet.accounting(), fleet.metrics_snapshot(), fleet.request_stats()
        slo = fleet.slo.snapshot()
    finally:
        fleet.shutdown()
    launches = read_launches()
    host = fleet_host_trace(tracer.export(since_us=t_trace), wall, cfg["members"])
    replayed = {}
    if device == "cuda":
        window_replays = replays_between(replays0, program_replays(engines))
        for e in engines:
            add_counts(replayed, engine_replays(torch, e, per_replay, window_replays))
    finished = [r for r in results.values() if isinstance(r, FinishedRequest)]
    tokens = sum(len(r.tokens) for r in finished)

    def ttfts(pred):
        return [s["first_token_at"] - s["submitted_at"] for s in stats
                if s["first_token_at"] is not None and pred(s)]

    pre = ttfts(lambda s: s["submitted_at"] < crash_wall)
    post = ttfts(lambda s: s["submitted_at"] >= crash_wall)
    report = {
        "config": {**{k: cfg[k] for k in ("members", "n_slots", "block_size", "bucket",
                                           "decode_chunk", "horizon_s", "burst", "burst_mult",
                                           "interactive", "load", "crash_member")},
                   "width": width, "dtype": "bfloat16",
                   "source": "bench.py:2177-2360 (bench_fleet), full tier, uncut"},
        "ladder_captures": ladders, "warm_s": warm_s, "one_member": member,
        "offered_requests_per_s": lam, "plan_requests": len(plan), "rejected_at_submit": rejected,
        "fleet_tokens_per_s": tokens / wall, "wall_s": wall, "tokens": tokens,
        "fleet_over_one_member": (tokens / wall) / member["tokens_per_s"],
        "ttft_s": {"p50_pre": pct(pre, 50), "p99_pre": pct(pre, 99),
                   "p50_post": pct(post, 50), "p99_post": pct(post, 99),
                   "n_pre": len(pre), "n_post": len(post)},
        "shed": snap["shed"], "accounting": acc,
        "crash": {"fired": [(s, k) for s, k, _ in inj.fired], "crashes": snap["crashes"],
                  "quarantines": snap["quarantines"], "readmissions": snap["readmissions"],
                  "member_restarts": [m["restarts"] for m in snap["members"]],
                  "member_states": [m["state"] for m in snap["members"]]},
        "capture_delta": steady.delta, "captures_by_program": steady.by_program,
        "slo": {k: {kk: v.get(kk) for kk in ("attainment", "p50", "p99")} for k, v in slo.items()},
        "host_trace": host, "card_window": window,
        "launches_counted_by_wrappers": dict(launches), "launches_replayed": replayed,
        "launches": add_counts(launches, replayed),
    }
    require(acc["lost"] == 0 and acc["outstanding"] == 0, f"fleet: accounting {acc}")
    require(acc["admitted"] == acc["completed"] + acc["shed_post_admission"]
            and acc["completed"] == len(finished) and len(results) == len(admitted),
            f"fleet: admitted != completed + shed, or a frid twice: {acc}")
    require(report["crash"]["fired"] == [(f"fleet.engine_crash.{cfg['crash_member']}", "crash")]
            and snap["crashes"] == 1, f"fleet: the crash {report['crash']}")
    require(steady.delta == 0, f"fleet: captures during traffic: {steady.explain()}")
    for f in finished:
        require(np.isfinite(f.log_probs).all() and ((f.tokens >= 0) & (f.tokens < V)).all(),
                f"fleet: bad output for request {f.rid}")
    return report


def fleet_host_trace(trace, wall_s, members) -> dict:
    """The host's side of a traced fleet run: the dispatcher's
    ``fleet/dispatch`` spans (a submit to a member) and each member's
    ``fleet/step`` spans (a step under its lock): counts, ms quantiles,
    and the share of the run's wall each thread spent in them."""
    spans = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev["name"] in ("fleet/dispatch", "fleet/step"):
            key = ev["name"] if ev["name"] == "fleet/dispatch" else ev["args"]["engine"]
            spans[key].append(ev["dur"] / 1e3)

    def summary(ms):
        return {"n": len(ms), "p50_ms": pct(ms, 50), "p99_ms": pct(ms, 99),
                "max_ms": max(ms, default=None), "share_of_wall": sum(ms) / 1e3 / wall_s}

    dropped = sum(ev["args"].get("dropped", 0) for ev in trace["traceEvents"]
                  if ev.get("ph") == "M")
    return {"dispatch": summary(spans["fleet/dispatch"]),
            "step_by_member": [summary(spans[i]) for i in range(members)],
            "events_dropped": dropped}


def handoff_direct(torch, pre, dec, reqs):
    """The handoff alone, per request: the detached prefill with its KV
    read back to host memory (synchronous), then the adopt's scatter
    (timed to the card's end); then ``dec`` decodes them all. Returns the
    finished requests in order and the bytes and ms a request."""
    rows, rids = [], []
    for p, n in reqs:
        t0 = time.perf_counter()
        ho = pre.prefill_detached(p, n)
        t1 = time.perf_counter()
        rids.append(dec.adopt_handoff(ho))
        dec.synchronize()
        t2 = time.perf_counter()
        require(rids[-1] is not None, "fleet handoff: no room to adopt")
        nbytes = sum(f.numel() * f.element_size() if isinstance(f, torch.Tensor) else f.nbytes
                     for layer in ho.kv for f in layer)
        rows.append((nbytes, (t1 - t0) * 1e3, (t2 - t1) * 1e3))
    out = dec.run()
    return [out[r] for r in rids], {
        "bytes_per_request": float(np.mean([r[0] for r in rows])),
        "prefill_and_read_back_ms": float(np.mean([r[1] for r in rows])),
        "scatter_ms": float(np.mean([r[2] for r in rows])), "requests": len(rows)}


def fleet_handoff(torch, device, width, cfg, dtype, kv_int8, through_fleet):
    """(b) the plan's requests handed from a prefill engine to a decode
    engine (bytes and ms a request), and with ``through_fleet`` through a
    ``disaggregate=True`` fleet of one prefill and two decode members,
    each against one mixed engine on the same requests."""
    from rl_tpu_torch.models import FinishedRequest, ServingFleet, TransformerConfig, TransformerLM
    from rl_tpu_torch.obs import MetricsRegistry

    model = TransformerLM(TransformerConfig(**width, dtype=dtype, kv_int8=kv_int8),
                          device=device, seed=0)
    rng = np.random.default_rng(7)
    reqs = [(p, cfg["handoff_new"]) for p, _ in
            fleet_requests(rng, cfg["handoff_requests"], cfg, model.cfg.vocab_size)]
    mixed = fleet_engine(torch, model, cfg, device)
    rids = [mixed.submit(p, n) for p, n in reqs]
    out = mixed.run()
    base = [out[r] for r in rids]
    engines = [fleet_engine(torch, model, cfg, device, kv_handoff=True)
               for _ in range(cfg["members"])]
    direct, timings = handoff_direct(torch, engines[0], engines[1], reqs)
    runs = {"direct": direct}
    rep = {"dtype": str(dtype).split(".")[-1], "kv_int8": kv_int8, "requests": len(reqs),
           "new_tokens": cfg["handoff_new"], **timings}
    if through_fleet:
        for e in engines:
            e.reset()
        fleet = ServingFleet(engines, registry=MetricsRegistry(), probe_interval_s=0.02,
                             disaggregate=True, roles=["prefill", "decode", "decode"]).start()
        steps0 = [e.decode_steps for e in engines]
        try:
            frids = [fleet.submit(p, n) for p, n in reqs]
            got = fleet.wait(frids, timeout=120)
            rep["accounting"] = acc = fleet.accounting()
        finally:
            fleet.shutdown()
        runs["fleet"] = [got[f] for f in frids]
        require(all(isinstance(f, FinishedRequest) for f in runs["fleet"]) and acc["lost"] == 0,
                f"fleet handoff: {acc}")
        steps = [e.decode_steps - s0 for e, s0 in zip(engines, steps0)]
        require(steps[0] == 0 and all(n > 0 for n in steps[1:]),
                f"fleet handoff: decode steps by member {steps}")
    flips = {}
    for path, handed in runs.items():
        for h, b in zip(handed, base):
            h.rid, h.prompt = b.rid, b.prompt  # first_flips reads the base's prompt
        flips[path] = first_flips(torch, model, base, handed, device)
        rep[f"{path}_token_agreement"] = agreement(handed, base)[0]
    rep["first_flips"] = flips
    return model, base, flips, rep


def handoff_gates(torch, device, width, cfg):
    """(b): the handoff over bf16 pools and int8 pools (B6), each against
    one mixed engine, measured; and held in float32 as the check phase
    holds the engine (directly, and over float pools also through the
    fleet): the tokens equal the mixed engine's, else at the first parting
    the top-2 margin of the float32 forward is under the check phase's
    floor (1e-3 over float pools; INT8_MARGIN_PER_LP_ERR x the engine's
    log-prob error over int8 pools)."""
    out = {}
    for label, dtype, int8 in (("bf16", torch.bfloat16, False), ("int8", torch.bfloat16, True),
                               ("float32", torch.float32, False),
                               ("float32_int8", torch.float32, True)):
        f32 = dtype == torch.float32
        model, base, flips, rep = fleet_handoff(torch, device, width, cfg, dtype, int8,
                                                f32 and not int8)
        if f32:
            floor = (check_engine(torch, model, base, device)["margin_floor"] if int8
                     else 1e-3)
            rep["margin_floor"] = floor
            worst = max((f["top2_margin"] for fl in flips.values() for f in fl), default=0.0)
            rep["gate"] = worst < floor
            require(rep["gate"], f"fleet handoff {label}: tokens part at a margin above "
                    f"{floor}: {flips}")
        out[label] = rep
        del model, base
    return out


def fleet_service(torch, device, width, cfg):
    """(c) a ``ServingService`` on 127.0.0.1:0 driven through
    ``RemoteEngine``: the tokens of a local engine on the same requests
    (float32, the check phase's margin where they part), and a ``GET
    /metrics`` scrape carrying the engine's series."""
    import urllib.request

    from rl_tpu_torch.models import RemoteEngine, ServingService, TransformerConfig, TransformerLM
    from rl_tpu_torch.obs import MetricsRegistry

    model = TransformerLM(TransformerConfig(**width, dtype=torch.float32), device=device, seed=0)
    rng = np.random.default_rng(11)
    reqs = [(p, cfg["service_new"]) for p, _ in
            fleet_requests(rng, cfg["service_requests"], cfg, model.cfg.vocab_size)]
    local = fleet_engine(torch, model, cfg, device)
    rids = [local.submit(p, n) for p, n in reqs]
    out = local.run()
    base = [out[r] for r in rids]
    svc = ServingService(fleet_engine(torch, model, cfg, device), host="127.0.0.1", port=0,
                         metrics_port=0, registry=MetricsRegistry()).start()
    try:
        remote = RemoteEngine(*svc.address)
        t0 = time.perf_counter()
        remote_rids = [remote.submit(p, n) for p, n in reqs]
        got = remote.wait_all(remote_rids, timeout=120)
        wall = time.perf_counter() - t0
        host, port = svc.metrics_address
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30).read().decode()
        stats = remote.stats()
    finally:
        svc.shutdown()
    from rl_tpu_torch.models import FinishedRequest

    served = [FinishedRequest(b.rid, b.prompt, np.asarray(got[r]["tokens"], np.int32),
                              np.asarray(got[r]["log_probs"], np.float32),
                              got[r]["finished_reason"]) for b, r in zip(base, remote_rids)]
    flips = first_flips(torch, model, base, served, device)
    series = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                     if ln.startswith("rl_tpu_serving_")})
    rep = {"requests": len(reqs), "wall_s": wall, "token_agreement": agreement(served, base)[0],
           "first_flips": flips, "metrics_series": series, "stats": stats}
    require(all(f["top2_margin"] < 1e-3 for f in flips),
            f"fleet service: tokens part from the local engine's at a margin >= 1e-3: {flips}")
    require({"rl_tpu_serving_tokens_total", "rl_tpu_serving_admissions_total",
             "rl_tpu_serving_kv_utilization"} <= set(series),
            f"fleet service: the scrape lacks the engine's series: {series}")
    require(stats["pending"] == 0 and stats["error"] is None, f"fleet service: {stats}")
    return rep


def fleet_autoscale(torch, device, width, cfg, per_replay):
    """(d) a live ``Autoscaler`` over a 1-member fleet of captured ladders:
    breaching traffic (TTFT objective 1e-4 s) until it scales to 2, the new
    member's ladder captured while the first serves; then idle until it
    drains back to 1."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
    from rl_tpu_torch.models import (Autoscaler, AutoscalerConfig, FinishedRequest, ServingFleet,
                                     TransformerConfig, TransformerLM)
    from rl_tpu_torch.obs import MetricsRegistry

    model = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16), device=device, seed=0)
    reg = ProgramRegistry(ExecutableStore())
    made = []

    def factory():
        made.append(fleet_engine(torch, model, cfg, device, registry=reg))
        return made[-1]

    fleet = ServingFleet([factory()], registry=MetricsRegistry(), slo_ttft_s=1e-4,
                         probe_timeout_s=30.0)
    fleet.aot_warmup()
    replays0 = program_replays(made)
    fleet.start()
    auto = Autoscaler(fleet, engine_factory=factory, registry=MetricsRegistry(),
                      config=AutoscalerConfig(scale_up_burn=0.5, burn_window_s=5.0,
                                              scale_down_free_frac=0.5, scale_down_sustain_s=0.3,
                                              cooldown_s=0.2, poll_interval_s=0.02,
                                              max_members=2))
    rng = np.random.default_rng(13)
    frids, t0 = [], time.monotonic()
    try:
        auto.start()
        while auto.snapshot()["scale_ups"] < 1:
            require(time.monotonic() - t0 < 120.0, "fleet autoscale: no scale-up in 120 s")
            batch = [fleet.submit(p, n) for p, n in fleet_requests(rng, 4, cfg,
                                                                   model.cfg.vocab_size)]
            fleet.wait(batch, timeout=120)
            frids += batch
        t_up = time.monotonic() - t0
        batch = [fleet.submit(p, n) for p, n in fleet_requests(rng, 8, cfg, model.cfg.vocab_size)]
        fleet.wait(batch, timeout=120)
        frids += batch
        while auto.snapshot()["scale_downs"] < 1:
            require(time.monotonic() - t0 < 180.0, "fleet autoscale: no scale-down in 180 s")
            time.sleep(0.05)
        t_down = time.monotonic() - t0
        auto.stop()
        got = fleet.wait(frids, timeout=120)
        acc = fleet.accounting()
        events = list(fleet.scale_events)
        snap = auto.snapshot()
    finally:
        auto.stop()
        fleet.shutdown()
    replayed = {}
    if device == "cuda":  # both members decode through captured graphs
        window_replays = replays_between(replays0, program_replays(made))
        for e in made:
            add_counts(replayed, engine_replays(torch, e, per_replay, window_replays))
    up = next(d for d in snap["decisions"] if d["action"] == "scale_up")
    own = {n for n in made[1]._programs}
    ladder_sigs = sum(len(p.signatures) for p in made[1]._programs.values())
    downs = [e for e in events if e["event"] == "scale_down"]
    rep = {"scale_up_after_s": t_up, "scale_down_after_s": t_down, "decisions": snap["decisions"],
           "scale_events": events, "accounting": acc, "requests": len(frids),
           "new_member_ladder": ladder_sigs, "launches_replayed": replayed}
    # on the CPU every program runs eagerly: nothing to capture
    want = ladder_sigs if device == "cuda" else 0
    require(up["compile_delta"] == up["ladder"] == want and (want > 0 or device != "cuda")
            and set(up["by_program"]) <= own,
            f"fleet autoscale: the scale-up captured beyond the new member's ladder: {up}")
    require(len(downs) == 1 and fleet.n_routable() == 1, f"fleet autoscale: drains {downs}")
    require(acc["lost"] == 0 and acc["completed"] == len(frids)
            and all(isinstance(r, FinishedRequest) for r in got.values()),
            f"fleet autoscale: {acc}")
    return rep


def fleet_collect(torch, device, width, cfg):
    """(e) one GRPO collect through a 2-member fleet's batch lane: each
    member serves its own model copy (other weights), the collect pushes
    the rollout model's first; every row must complete."""
    from rl_tpu_torch.collectors import LLMCollector
    from rl_tpu_torch.data.llm.tokenizer import SimpleTokenizer
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.envs.llm.chat import DatasetChatEnv
    from rl_tpu_torch.envs.llm.reward import ExactMatchScorer
    from rl_tpu_torch.models import ServingFleet, TransformerConfig, TransformerLM
    from rl_tpu_torch.obs import MetricsRegistry

    mcfg = TransformerConfig(**width, dtype=torch.bfloat16)
    policy = TransformerLM(mcfg, device=device, seed=0)
    members = [TransformerLM(mcfg, device=device, seed=1 + i) for i in range(2)]
    data = arithmetic_dataset(64)
    tok = SimpleTokenizer(data.corpus())
    env = DatasetChatEnv(data.prompts, tok, reward_fn=ExactMatchScorer(data.answers),
                         group_repeats=cfg["collect_repeats"], max_prompt_len=cfg["bucket"] - 8)
    fleet = ServingFleet([fleet_engine(torch, m, cfg, device, greedy=False, seed=i)
                          for i, m in enumerate(members)],
                         registry=MetricsRegistry()).start()
    try:
        col = LLMCollector(env, policy, num_prompts=cfg["collect_prompts"],
                           max_new_tokens=cfg["collect_new"], eos_id=tok.eos_token_id,
                           fleet=fleet, fleet_timeout_s=120.0)
        t0 = time.perf_counter()
        batch = col.collect(policy)
        sync(torch, device)
        wall = time.perf_counter() - t0
        acc = fleet.accounting()
    finally:
        fleet.shutdown()
    with torch.no_grad():
        pushed = all(torch.equal(a, b) for m in members
                     for a, b in zip(m.parameters(), policy.parameters()))
    rows = batch["tokens"].shape[0]
    done = int(batch["assistant_mask"].any(dim=1).sum().item())
    rep = {"rows": rows, "rows_completed": done, "wall_s": wall, "accounting": acc,
           "weights_pushed": pushed,
           "response_tokens": int(batch["assistant_mask"].sum().item()),
           "reward_mean": float(batch["reward"].float().mean().item())}
    require(rows == cfg["collect_prompts"] * cfg["collect_repeats"] and done == rows
            and acc["completed"] == rows and acc["lost"] == 0, f"fleet collect: {rep}")
    require(pushed, "fleet collect: push_params left a member's weights")
    require(all(torch.isfinite(batch[k].float()).all() for k in ("sample_log_prob", "advantage")),
            "fleet collect: non-finite batch")
    return rep


def fleet_phase(torch, card, device="cuda", width=FLEET_WIDTH, cfg=FLEET):
    """The serving engine's outer layers at bench_fleet's full tier: (a)
    the chaos run, (b) the KV handoff, (c) the TCP service, (d) the
    autoscaler, (e) the collector's batch lane. Every kernel's count is set
    to 0 before each part and read after it; the graph replays of (a) and
    (d) are counted from traces (:func:`engine_replays`). B4 and B5 must
    run in every part, B6 in the int8 handoff."""
    seconds, t_last = {}, [time.perf_counter()]

    def lap(name):
        sync(torch, device)
        now = time.perf_counter()
        seconds[name], t_last[0] = now - t_last[0], now

    per_replay = {}  # a program's traced launches, shared by (a) and (d)
    chaos = fleet_chaos(torch, device, width, cfg, per_replay)
    lap("chaos")
    emit({"phase": "fleet_progress", "seconds": seconds})
    parts = {"chaos": chaos["launches"]}
    zero_launches()
    handoff = handoff_gates(torch, device, width, cfg)
    lap("handoff")
    parts["handoff"] = read_launches()
    zero_launches()
    service = fleet_service(torch, device, width, cfg)
    lap("service")
    parts["service"] = read_launches()
    zero_launches()
    autoscale = fleet_autoscale(torch, device, width, cfg, per_replay)
    lap("autoscale")
    parts["autoscale"] = add_counts(read_launches(), autoscale["launches_replayed"])
    zero_launches()
    collect = fleet_collect(torch, device, width, cfg)
    lap("collect")
    parts["collect"] = read_launches()
    launches = {}
    for counts in parts.values():
        add_counts(launches, counts)
    if device == "cuda":
        # the fleets' members, graphs and streams sit in reference cycles
        # (members, their stepper closures, the supervisor): free them
        # before the later phases
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "fleet", "chaos": chaos, "handoff": handoff, "service": service,
          "autoscale": autoscale, "collect": collect, "launches": launches,
          "launches_by_part": parts, "seconds": seconds, "card": card})
    HEADLINES["fleet"] = {
        "tokens_per_s": chaos["fleet_tokens_per_s"],
        "one_member_tokens_per_s": chaos["one_member"]["tokens_per_s"],
        "ttft_s": chaos["ttft_s"], "shed": chaos["shed"], "accounting": chaos["accounting"],
        "crash": {k: chaos["crash"][k] for k in ("crashes", "readmissions")},
        "capture_delta": chaos["capture_delta"], "host_trace": chaos["host_trace"],
        "card_window": chaos["card_window"],
        "handoff": {k: {kk: v.get(kk) for kk in ("bytes_per_request",
                                                 "prefill_and_read_back_ms", "scatter_ms",
                                                 "direct_token_agreement",
                                                 "fleet_token_agreement")}
                    for k, v in handoff.items()},
        "autoscale": {"scale_up_after_s": autoscale["scale_up_after_s"],
                      "scale_down_after_s": autoscale["scale_down_after_s"],
                      "new_member_ladder": autoscale["new_member_ladder"]},
        "seconds": seconds}
    if device == "cuda":
        for part in ("chaos", "handoff", "service", "autoscale", "collect"):
            require(parts[part]["paged_flash_decode"] > 0 and parts[part]["fused_sample"] > 0,
                    f"fleet: B4/B5 not launched in {part}: {parts[part]}")
        require(parts["handoff"]["paged_flash_decode_int8"] > 0,
                f"fleet: B6 not launched in the handoff: {parts['handoff']}")
    return launches


# -- phase 4b: speculative decoding at the reference's bench_spec width -------

# bench.py:3236-3272 (bench_spec, full tier): GPT-2-small width at
# max_seq_len 256, 8 slots of 16-token blocks, a pool 8x the live slots'
# footprint, one prompt rung of 128 and suffix rungs 8 and 16, the prefix
# cache, decode chunk 4, 15 drafts a verify; a 96-token system prompt
# before 2-7 tokens of each of 8 replayed prompts, 128 new tokens
SPEC_WIDTH = dict(FULL_WIDTH, max_seq_len=256)
SPEC_ENGINE = dict(n_slots=8, block_size=16, n_blocks=8 * 8 * (256 // 16) + 1,
                   decode_chunk=4, prefix_cache=True)
SPEC_LOOKAHEAD = 15
SPEC_SYSTEM, SPEC_POOL, SPEC_NEW = 96, 8, 128
# the verify widths the gather route is measured at: every rung of the ladder
SPEC_ROUTE_CHUNKS = (16, 8, 4, 2)


def spec_prompts(vocab, seed=0):
    """The replay pool of ``bench_spec``: one system prompt, 2-7 tokens each."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SPEC_SYSTEM)
    return [np.concatenate([system, rng.integers(0, vocab, int(rng.integers(2, 8)))])
            .astype(np.int32) for _ in range(SPEC_POOL)]


class ReplayDraft:
    """Drafts the rest of whichever recorded completion the context is a
    prefix of (the reference test's oracle): a sampled replay gets new rids,
    whose streams the tree's donated continuations do not follow."""

    def __init__(self, finished):
        self.seqs = [f.prompt.tolist() + f.tokens.tolist() for f in finished]
        self.hits = self.misses = self.proposed_tokens = 0

    def propose(self, context, k):
        c = list(map(int, context))
        for s in self.seqs:
            if len(s) > len(c) and s[: len(c)] == c:
                out = s[len(c): len(c) + k]
                self.hits += 1
                self.proposed_tokens += len(out)
                return out
        self.misses += 1
        return []

    def stats(self):
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "proposed_tokens": self.proposed_tokens}


def route_logits(torch, model, finished, chunk):
    """Teacher-forced logits [R, N, V] (float32) of each request's N
    completion positions through a paged cache of the engine's layout:
    the prompts in one prefill, then completion tokens fed ``chunk`` at a
    time, each route writing its own K/V. ``chunk`` 1 reads the cache
    through the paged-decode kernel (B4, or B6 over int8 pools) as decode
    does, ``chunk`` > 1 through the gather route as verify does."""
    dev = model.device
    R, N = len(finished), len(finished[0].tokens)
    block, width = 16, model.cfg.max_seq_len // 16
    cache = model.init_paged_cache(R, R * width + 1, block, width)
    table = (1 + torch.arange(R * width, dtype=torch.int32, device=dev)).reshape(R, width)

    def run(x, lens, active):
        return model(x, cache=[dict(c, block_table=table, len=lens, active=active)
                               for c in cache])

    P = np.array([len(f.prompt) for f in finished])
    toks = np.zeros((R, P.max()), np.int32)
    for i, f in enumerate(finished):
        toks[i, : P[i]] = f.prompt
    mask = torch.from_numpy(np.arange(P.max())[None, :] < P[:, None]).to(dev)
    with torch.no_grad():
        logits, new = run(torch.from_numpy(toks).to(dev), torch.zeros(R, dtype=torch.int32,
                                                                      device=dev), mask)
        last = torch.from_numpy(P - 1).to(dev)
        out = [logits[torch.arange(R, device=dev), last].float()[:, None]]
        lens = new[0]["len"]
        comp = torch.from_numpy(np.stack([f.tokens for f in finished])).to(dev)
        for j in range(0, N - 1, chunk):
            x = comp[:, j:min(j + chunk, N - 1)]
            active = (torch.ones(R, dtype=torch.bool, device=dev) if x.shape[1] == 1
                      else torch.ones(x.shape, dtype=torch.bool, device=dev))
            logits, new = run(x, lens, active)
            out.append(logits.float())
            lens = new[0]["len"]
    return torch.cat(out, dim=1)


def route_margin(torch, model, finished):
    """The largest logit difference between the decode route and the
    verify route on ``finished``'s sequences: the most any gap between
    two logits of a position moves (max - min of the difference over the
    vocabulary, at most twice the largest |difference|), over the verify
    widths of SPEC_ROUTE_CHUNKS. Returns (margin, largest |difference|,
    the decode route's logits)."""
    a = route_logits(torch, model, finished, 1)
    spread = absmax = 0.0
    for chunk in SPEC_ROUTE_CHUNKS:
        d = route_logits(torch, model, finished, chunk) - a
        spread = max(spread, float((d.amax(-1) - d.amin(-1)).max()))
        absmax = max(absmax, float(d.abs().max()))
    return spread, absmax, a


def spec_gate(torch, label, vanilla, spec, logits, margin, noise=None):
    """The margin rule: a speculative request equals its vanilla slot-stream
    request up to the first position where they part, and there the
    vanilla run's top-2 gap (of the logits, plus the position's gumbel
    noise when sampled: ``noise(finished, n)``) is at most ``margin``.
    Returns the counts: positions compared, under the margin, flips."""
    under = compared = flips = 0
    first = []
    for r, (v, s) in enumerate(zip(vanilla, spec)):
        x = logits[r]
        if noise is not None:
            x = x + noise(v)
        top2 = x.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        diff = np.flatnonzero(v.tokens != s.tokens)
        n = int(diff[0]) if len(diff) else len(v.tokens)
        compared += n
        under += int((gap[:n + (n < len(gap))] <= margin).sum())
        if n < len(v.tokens):
            flips += 1
            first.append({"rid": v.rid, "position": n, "gap": float(gap[n]),
                          "above_margin": bool(gap[n] > margin)})
        require(s.finished_reason == v.finished_reason, f"spec: {label}: finish reasons differ")
    return {"positions_compared": compared, "positions_under_margin": under, "flips": flips,
            "first_flips": first}


def spec_noise(torch, engine):
    """``noise(finished)``: the gumbel noise of each completion position
    of a request under ``engine``'s slot streams, [N, V]."""
    from rl_tpu_torch.models.speculative import row_gumbel, slot_keys

    def noise(f):
        n = torch.arange(len(f.tokens), dtype=torch.int32, device=engine.device)
        rid = torch.full_like(n, f.rid)
        return row_gumbel(slot_keys(engine._base_key, rid, n), engine.model.cfg.vocab_size)

    return noise


def threefry_device_check(torch, device, V):
    """The device's threefry against the same computation on the CPU at
    verify's shape (8 slots x 16 positions x V): key words, raw bits and
    uniforms bit for bit, the gumbel noise within 2 eps * max(1, |g|)
    (each of its logs may round differently, by 1 ulp). Reports the MiB
    the noise of one verify takes on the card above what is live (its
    int64 temporaries). Resets the peak-memory statistics."""
    from rl_tpu_torch.models.speculative import (key_from_seed, random_bits, row_gumbel,
                                                 spec_keys, uniform_from_bits)

    rid = torch.arange(8, dtype=torch.int32) * 37 - 1
    ntok = torch.arange(8, dtype=torch.int32) * 5
    out = {}
    for dev in ("cpu", device):
        keys = spec_keys(key_from_seed(3, dev), rid.to(dev), ntok.to(dev), 16).reshape(-1, 2)
        bits = random_bits(keys, V)
        out[dev] = [t.cpu() for t in (keys, bits, uniform_from_bits(bits), row_gumbel(keys, V))]
    for name, a, b in zip(("keys", "bits", "uniforms"), out["cpu"], out[device]):
        require(torch.equal(a, b), f"spec: the device's threefry {name} differ from the CPU's")
    g, gd = out["cpu"][3], out[device][3]
    err = float(((gd - g).abs() / g.abs().clamp_min(1.0)).max())
    require(err <= 2 * torch.finfo(torch.float32).eps,
            f"spec: device gumbel noise off the CPU's by {err} x max(1, |g|)")
    extra = None
    if torch.device(device).type == "cuda":
        keys = spec_keys(key_from_seed(3, device), rid.to(device), ntok.to(device), 16)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated() / 2**20
        extra = peak_mib(torch, lambda: row_gumbel(keys.reshape(-1, 2), V)) - live
    return {"rows": 8 * 16, "V": V, "bit_equal": ["keys", "bits", "uniforms"],
            "gumbel_rel_err_max": err, "verify_noise_peak_mib_above_live": extra}


def spec_expected_ladder(buckets, n_slots, chunk, lookahead) -> set:
    """The reference engine's ``aot_warmup`` names for a speculative
    prefix-cache engine (``rl_tpu/models/serving.py:1056-1169``; the
    formats are held to its source in ``tests/test_torch_speculative.py``)."""
    from rl_tpu_torch.compile import pow2ceil

    names = {f"serving.sdecode.k{chunk}", "serving.sadmit_update"}
    k_max = pow2ceil(min(lookahead, 31) + 1)
    names |= {f"serving.verify.k{k}" for k in (2, 4, 8, 16, 32) if k <= k_max}
    names |= {f"serving.spprefill.a{a}.s{b}" for a in buckets.admit_sizes(n_slots)
              for b in buckets.suffix_ladder()}
    n = 1
    while n <= pow2ceil(n_slots):
        names.add(f"serving.cowcopy.n{n}")
        n *= 2
    return names


def spec_phase(torch, card, device="cuda", width=SPEC_WIDTH, new=SPEC_NEW):
    """Speculative decoding at ``bench_spec``'s full width: five arms, each
    against the vanilla slot-stream engine under the margin rule."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry, ShapeBuckets
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16), device=device, seed=0)
    model_int8 = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16, kv_int8=True),
                               device=device, seed=0)
    V = model.cfg.vocab_size
    buckets = ShapeBuckets(prompt=(128,), suffix=(8, 16))
    pool = spec_prompts(V)

    def engine(m=model, **kw):
        return ContinuousBatchingEngine(m, buckets=buckets, device=device, **SPEC_ENGINE,
                                        slot_rng=True, spec_lookahead=SPEC_LOOKAHEAD, **kw)

    def spec_counts(eng):
        st = eng.stats()
        hist = st["spec_accept_counts"]
        return np.array([st["spec_dispatches"], st["spec_accepted_tokens"],
                         sum(hist.values()), st["spec_draft_hits"], st["spec_draft_misses"],
                         st["spec_plain_rounds_no_draft"], st["spec_plain_rounds_pool_tight"]])

    def spec_run(eng, keep, key):
        """One round of the replay pool; with speculation this round's
        verify dispatches, accepted tokens a dispatch (all slots) and a
        slot's verify, draft hit rate and plain-decode rounds."""
        before = spec_counts(eng) if eng.speculative else None
        run = serve_run(torch, eng, pool, new, V, keep, key)
        if before is not None:
            d, acc, slot_verifies, hits, misses, no_draft, tight = spec_counts(eng) - before
            run.update(verify_dispatches=int(d), accepted_per_verify=acc / max(d, 1),
                       accepted_per_slot_verify=acc / max(slot_verifies, 1),
                       draft_hit_rate=hits / max(hits + misses, 1),
                       plain_rounds_no_draft=int(no_draft), plain_rounds_pool_tight=int(tight))
        return run

    out, runs = {}, {}
    zero_launches()
    # 1. greedy: vanilla slot streams against speculation drafting from the
    # tree; the cold round donates each completion, the replay drafts it
    van, spec = engine(greedy=True), engine(greedy=True, speculative=True)
    for rnd in ("cold", "replay"):
        out[f"greedy_vanilla_{rnd}"] = spec_run(van, runs, f"van_{rnd}")
        out[f"greedy_spec_{rnd}"] = spec_run(spec, runs, f"spec_{rnd}")
    # 2. sampled at temperature 1 from one seed, drafting the vanilla run's
    # completions (same rids: both engines are fresh)
    van_t = engine(greedy=False, temperature=1.0, seed=1)
    out["sampled_vanilla"] = spec_run(van_t, runs, "van_t1")
    spec_t = engine(greedy=False, temperature=1.0, seed=1, speculative=True,
                    draft_source=ReplayDraft(runs["van_t1"]))
    out["sampled_spec"] = spec_run(spec_t, runs, "spec_t1")
    # 3. n-gram drafts, greedy
    out["ngram_spec"] = spec_run(engine(greedy=True, speculative=True, draft_source="ngram"),
                                 runs, "ngram")
    # 4. int8 pools: vanilla and speculative, cold round and replay
    van8, spec8 = engine(model_int8, greedy=True), engine(model_int8, greedy=True,
                                                          speculative=True)
    for rnd in ("cold", "replay"):
        out[f"int8_vanilla_{rnd}"] = spec_run(van8, runs, f"van8_{rnd}")
        out[f"int8_spec_{rnd}"] = spec_run(spec8, runs, f"spec8_{rnd}")
    launches = read_launches()
    # 5. every program a CUDA graph: the sampled arm again, against the eager
    # engine of arm 2 bit for bit (speculation drains every dispatch before
    # the next, so its schedule is fixed whatever the card's timing)
    registry = ProgramRegistry(ExecutableStore())
    t0 = time.perf_counter()
    graphed = engine(greedy=False, temperature=1.0, seed=1, speculative=True,
                     draft_source=ReplayDraft(runs["van_t1"]), registry=registry, warmup=True)
    warmup_s = time.perf_counter() - t0
    captured = engine_captures(graphed)
    out["graphed_spec"] = spec_run(graphed, runs, "graphed")
    for a, b in zip(runs["spec_t1"], runs["graphed"]):
        require(np.array_equal(a.tokens, b.tokens) and np.array_equal(a.log_probs, b.log_probs),
                f"spec: request {a.rid}: the graphed engine differs from the eager one")
    want = spec_expected_ladder(buckets, SPEC_ENGINE["n_slots"], SPEC_ENGINE["decode_chunk"],
                                SPEC_LOOKAHEAD)
    require(set(registry.names()) == want,
            f"spec: registered {sorted(set(registry.names()) ^ want)} off the reference's ladder")
    require(engine_captures(graphed) == captured or not cuda,
            "spec: the graphed engine captured in traffic after its warm-up")
    graphs = {"programs": len(want), "captures": captured, "warmup_s": warmup_s,
              "verify_replays": sum(p.stats["replays"] for p in engine_programs(graphed)
                                    if p.name.startswith("serving.verify."))}

    # the margin rule, per arm, from the routes' teacher-forced logits
    # the decode route's logits of each vanilla run, and the margins: the
    # largest route difference on the bf16 cold run's sequences and on the
    # int8 replay's
    margin, absmax, logits = {}, {}, {}
    for key, m in (("van_cold", model), ("van8_replay", model_int8)):
        margin[key], absmax[key], logits[key] = route_margin(torch, m, runs[key])
    for key in ("van_replay", "van_t1"):
        logits[key] = route_logits(torch, model, runs[key], 1)
    margin, absmax, margin8, absmax8 = (margin["van_cold"], absmax["van_cold"],
                                        margin["van8_replay"], absmax["van8_replay"])
    gates = {
        "greedy_cold": spec_gate(torch, "greedy cold", runs["van_cold"], runs["spec_cold"],
                                 logits["van_cold"], margin),
        "greedy_replay": spec_gate(torch, "greedy replay", runs["van_replay"],
                                   runs["spec_replay"], logits["van_replay"], margin),
        "sampled_t1": spec_gate(torch, "sampled", runs["van_t1"], runs["spec_t1"],
                                logits["van_t1"], margin, spec_noise(torch, van_t)),
        "ngram": spec_gate(torch, "ngram", runs["van_cold"], runs["ngram"], logits["van_cold"],
                           margin),
        "int8_replay": spec_gate(torch, "int8 replay", runs["van8_replay"], runs["spec8_replay"],
                                 logits["van8_replay"], margin8),
    }
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
    noise = threefry_device_check(torch, device, V)
    speedup = (out["greedy_spec_replay"]["tokens_per_s"]
               / out["greedy_vanilla_replay"]["tokens_per_s"])
    HEADLINES["spec"] = {
        "greedy_replay_tokens_per_s": [out["greedy_vanilla_replay"]["tokens_per_s"],
                                       out["greedy_spec_replay"]["tokens_per_s"]],
        "speedup": speedup,
        "accepted_per_verify": out["greedy_spec_replay"]["accepted_per_verify"],
        "accepted_per_slot_verify": out["greedy_spec_replay"]["accepted_per_slot_verify"],
        "draft_hit_rate": out["greedy_spec_replay"]["draft_hit_rate"],
        "route_margin": [margin, margin8],
        "positions_under_margin": {k: v["positions_under_margin"] for k, v in gates.items()},
        "flips": {k: v["flips"] for k, v in gates.items()}, "peak_mib": peak,
    }
    emit({"phase": "spec", "config": {**width, "dtype": "bfloat16", **SPEC_ENGINE,
                                      "buckets": {"prompt": [128], "suffix": [8, 16]},
                                      "spec_lookahead": SPEC_LOOKAHEAD,
                                      "system_prompt": SPEC_SYSTEM, "replay_pool": SPEC_POOL,
                                      "max_new_tokens": new},
          "arms": out, "route": {"margin": margin, "max_abs_logit_diff": absmax,
                                 "int8_margin": margin8, "int8_max_abs_logit_diff": absmax8,
                                 "chunks": list(SPEC_ROUTE_CHUNKS)},
          "gates": gates, "graphs": graphs, "threefry": noise, "launches": launches,
          "peak_mib": peak, "card": card})
    for name in ("paged_flash_decode", "fused_sample", "paged_flash_decode_int8"):
        require(launches[name] > 0, f"spec: {name} was not launched")
    require(out["greedy_spec_replay"]["accepted_per_verify"] > 1.0,
            f"spec: {out['greedy_spec_replay']['accepted_per_verify']} tokens a verify")
    require(out["sampled_spec"]["verify_dispatches"] > 0 and
            out["int8_spec_replay"]["verify_dispatches"] > 0, "spec: an arm never verified")
    for name, g in gates.items():  # the margin rule, after the line that reports it
        for f in g["first_flips"]:
            require(not f["above_margin"],
                    f"spec: {name}: request {f['rid']} parts from vanilla at position "
                    f"{f['position']} with a top-2 gap {f['gap']} above the route margin")
    return launches


# -- phase 5: GRPO training at full width -------------------------------------


def train_phase(torch, card, device="cuda", width=FULL_WIDTH, steps=2, prompt_len=512,
                max_new=512, microbatch=8, collect_new=64):
    """``GRPOTrainer`` at GPT-2-small width in bf16 with the flash kernels:
    2 steps of 16 engine rollouts (2 prompts x 8) and a microbatched
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
        if i == 0:  # the pipeline phase's first update must equal this one
            SEQUENTIAL["first_update"] = [p.detach().clone() for p in trainer.policy.parameters()]
    phase_s = time.perf_counter() - t_phase
    SEQUENTIAL["steps"] = [{k: r[k] for k in ("collect_s", "update_s")} for r in per_step]
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
    prof_eval = profile_evaluate(torch, trainer) if device == "cuda" else None
    HEADLINES["train"] = {
        "update_s": [r["update_s"] for r in per_step],
        "update_mfu": [r["update_mfu"] for r in per_step],
        "profiled_update_device_ms": prof and prof["device_busy_ms"],
        "profiled_update_idle_share": prof and prof["device_idle_share"],
        "profiled_update_by_kernel_ms": prof and {k: v["ms"] for k, v in prof["by_kernel"].items()},
        "profiled_evaluate_b3_ms_per_call": prof_eval and prof_eval["b3_ms_per_call"],
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
          "profiled_update": prof, "profiled_evaluate": prof_eval, "card": card})
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


def profile_evaluate(torch, trainer, active=16):
    """B3's device ms a call in the evaluate's decode, as ``torch.profiler``
    reads it: the evaluate's greedy ``generate`` over its 8 prompts once
    more, with ``active`` decode steps profiled (the forwards at cache_len
    514 to 513 + ``active``) and the rest not. A B3 call is its split
    kernel and its combine; the count is the combine's. After the checks
    and the launch counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from rl_tpu_torch.models import generate

    state = trainer.env.reset(trainer.dataset.prompts[:8])
    model = trainer.scheme.pull()
    tokens = torch.from_numpy(state["tokens"]).to(trainer.device)
    mask = torch.from_numpy(np.asarray(state["attention_mask"], np.float32)).to(trainer.device)
    forward = model.forward
    torch.cuda.synchronize()
    # a profiler step per forward: the prefill and the first decode step
    # wait, the second warms up, the next ``active`` are recorded
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=2, warmup=1, active=active, repeat=1)) as prof:
        def stepped(*args, **kw):
            prof.step()
            return forward(*args, **kw)

        model.forward = stepped
        try:
            generate(model, tokens, mask, None, max_new_tokens=trainer.max_new_tokens,
                     eos_id=trainer.tokenizer.eos_token_id, greedy=True)
            torch.cuda.synchronize()
        finally:
            del model.forward
    kernels = device_kernels(torch, prof)
    b3_ms = sum(ms for k, (ms, _) in kernels.items() if "flash_decode_" in k)
    b3_calls = sum(n for k, (_, n) in kernels.items() if "flash_decode_combine" in k)
    busy_ms = sum(ms for ms, _ in kernels.values())
    return {"decode_steps_profiled": active, "cache_len": [514, 513 + active],
            "b3_calls": b3_calls, "b3_ms_per_call": b3_ms / b3_calls if b3_calls else None,
            "device_ms_per_decode_step": busy_ms / active}


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
    """The ``OffPolicyProgram`` of ``make_sac_trainer(prioritized=True)``
    training SAC on ``VmapEnv(PendulumEnv(), n)``: the default actor (of
    ``num_cells``: 256x256 at full size), the 256x256 critic ensemble,
    ``ReplayBuffer(DeviceStorage(capacity), PrioritizedSampler())`` and
    ``priority_key="td_error"``, float32 (the reference's MLP default),
    with the program's device metrics on (they count bad steps)."""
    from rl_tpu_torch.envs import PendulumEnv, VmapEnv
    from rl_tpu_torch.trainers import (OffPolicyConfig, default_continuous_actor,
                                       default_device_metrics, make_sac_trainer)

    env = VmapEnv(PendulumEnv(), cfg["n_envs"])
    config = OffPolicyConfig(batch_size=cfg["batch_size"], utd_ratio=cfg["utd_ratio"],
                             learning_rate=cfg["learning_rate"], tau=cfg["tau"],
                             init_random_frames=cfg["init_random_frames"])
    program = make_sac_trainer(
        env, total_steps=0, actor=default_continuous_actor(env, num_cells=cfg["num_cells"]),
        buffer_capacity=cfg["capacity"], frames_per_batch=cfg["frames_per_batch"],
        config=config, prioritized=True, device=device).program
    sampler = program.buffer.sampler
    require((sampler.alpha, sampler.beta, sampler.fanout) == (cfg["alpha"], cfg["beta"],
                                                              cfg["fanout"]),
            "offpolicy: make_sac_trainer's PER defaults differ from the configuration")
    program.device_metrics = default_device_metrics()
    return program


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


def cpu_twin(program, ts, cpu) -> dict:
    """``cpu`` (the same program built on the CPU) initialised, then given
    ``program``'s parameters, targets and buffers, Adam's state and, from
    ``ts``, the replay ring and update count: its train state."""
    cts = cpu.init(seed=0)
    cpu.loss.load_state_dict({k: v.cpu() for k, v in program.loss.state_dict().items()})
    for dst, src in zip(cpu.optimizer.mu + cpu.optimizer.nu,
                        program.optimizer.mu + program.optimizer.nu):
        dst.copy_(src.cpu())
    cpu.optimizer.count = program.optimizer.count.cpu().clone()
    cts["buffer"] = ts["buffer"].apply(lambda x: x.cpu().clone())
    cts["update_count"] = ts["update_count"]
    return cts


def card_cpu_updates(torch, program, ts, cpu, draws, alpha, td_tol):
    """``program.updates`` on the card (kernel B7) and ``cpu.updates`` (plain
    versions) from the card's state and the same ``draws``: the card's
    launch counts, whether both sampled the same indices, the worst
    parameter's and the PER tree's excess over their limits (leaves
    compared as the td-errors they encode, within ``td_tol``), and the
    report's common fields."""
    cts = cpu_twin(program, ts, cpu)
    zero_launches()
    ts, m_gpu, idx_gpu = recorded_updates(torch, program, ts,
                                          [tuple(a.cuda() for a in d) for d in draws])
    launches = read_launches()
    cts, m_cpu, idx_cpu = recorded_updates(torch, cpu, cts, draws)
    torch.cuda.synchronize()
    same_idx = all(torch.equal(a, b) for a, b in zip(idx_gpu, idx_cpu))

    gsd, csd = program.loss.state_dict(), cpu.loss.state_dict()
    worst_param = max(((excess(gsd[n].cpu(), csd[n], CPU_CHECK_PARAMS), n) for n in csd))
    tree = tree_excess(ts["buffer"], cts["buffer"], alpha, td_tol)
    report = {"updates": len(draws), "indices_equal": same_idx,
              "worst_param_excess_over_tol": worst_param[0], "worst_param": worst_param[1],
              "max_param_diff": max((gsd[n].cpu() - csd[n]).abs().max().item() for n in csd),
              "tree_excess_over_tol": tree, "params_tol": CPU_CHECK_PARAMS,
              "tree_tol": CPU_CHECK_TREE, "td_error_tol": td_tol,
              "loss_card": m_gpu["loss"].item(), "loss_cpu": m_cpu["loss"].item(),
              "launches": launches}
    return report


def tree_excess(card_buffer, cpu_buffer, alpha, td_tol) -> dict:
    """The PER tree's excess over its limits, card against CPU: the block
    sums and the largest priority within ``CPU_CHECK_TREE``, the leaves as
    the td-errors they encode within ``td_tol``."""
    tree = {kk: excess(card_buffer["sampler", kk].cpu(), cpu_buffer["sampler", kk],
                       CPU_CHECK_TREE) for kk in ("esum", "max_priority")}
    td = lambda leaves: leaves.clamp_min(0.0) ** (1.0 / alpha)  # noqa: E731
    tree["leaves_as_td_error"] = excess(td(card_buffer["sampler", "priorities"].cpu()),
                                        td(cpu_buffer["sampler", "priorities"]), td_tol)
    return tree


def offpolicy_cpu_check(torch, program, ts, cfg):
    """4 updates on the card (kernel B7) and the same 4 on the CPU (plain
    versions) from the same state and the same draws: sampled indices
    equal; parameters, targets, priorities and block sums within the
    stated tolerances."""
    rng = np.random.default_rng(11)
    B, k = cfg["batch_size"], cfg["utd_ratio"]
    draws = [tuple(torch.from_numpy(a) for a in (
        rng.random(B, dtype=np.float32), rng.standard_normal((B, 1), dtype=np.float32),
        rng.standard_normal((B, 1), dtype=np.float32))) for _ in range(k)]
    report = card_cpu_updates(torch, program, ts, make_offpolicy(torch, "cpu", cfg), draws,
                              cfg["alpha"], CPU_CHECK_TD)
    emit({"phase": "offpolicy_check", **report})
    require(report["indices_equal"], "offpolicy_check: the card and the CPU sampled other indices")
    require(report["worst_param_excess_over_tol"] <= 0.0,
            f"offpolicy_check: {report['worst_param']} beyond tolerance")
    tree = report["tree_excess_over_tol"]
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


# -- phase 7b: the TD3 family and discrete SAC ----------------------------------

# The reference's factories at their own widths and defaults
# (rl_tpu/trainers/algorithms.py:212-257, :520-631): 256x256 actor and
# critics, a 1M-slot DeviceStorage sampled uniformly, batch 256, 5000
# random frames, TD3 policy_delay 2, REDQ 10 critics at UTD 8; on
# VmapEnv(PendulumEnv(), 256), 1024 frames a step, float32. TD3+BC is
# TD3's factory with the BC loss. B7 lies on none of these paths.
TD3_FAMILY = dict(n_envs=256, frames_per_batch=1024, capacity=1_000_000, batch_size=256,
                  init_random_frames=5000, eager_steps=2, graph_steps=4, timed_calls=8,
                  check_updates=4)
TD3_ALGOS = ("ddpg", "td3", "td3bc", "redq", "crossq")


def make_td3_family(torch, algo, device, cfg=TD3_FAMILY):
    """The ``OffPolicyProgram`` of ``make_{algo}_trainer`` on
    ``VmapEnv(PendulumEnv(), n_envs)`` with the factory's defaults; for
    ``td3bc``, TD3's program with a ``TD3BCLoss`` over its actor."""
    from rl_tpu_torch.envs import PendulumEnv, VmapEnv
    from rl_tpu_torch.modules import ConcatMLP
    from rl_tpu_torch.objectives import TD3BCLoss
    from rl_tpu_torch.trainers import (OffPolicyProgram, make_crossq_trainer, make_ddpg_trainer,
                                       make_redq_trainer, make_td3_trainer)

    make = {"ddpg": make_ddpg_trainer, "td3": make_td3_trainer, "td3bc": make_td3_trainer,
            "redq": make_redq_trainer, "crossq": make_crossq_trainer}[algo]
    program = make(VmapEnv(PendulumEnv(), cfg["n_envs"]), total_steps=0,
                   buffer_capacity=cfg["capacity"], frames_per_batch=cfg["frames_per_batch"],
                   device=device).program
    require((program.config.batch_size, program.config.init_random_frames)
            == (cfg["batch_size"], cfg["init_random_frames"]),
            f"td3_family: make_{algo}_trainer's defaults differ from the configuration")
    if algo == "td3bc":
        td3 = program.loss
        loss = TD3BCLoss(td3.actor, ConcatMLP(out_features=1, num_cells=(256, 256)),
                         td3.action_low, td3.action_high)
        program = OffPolicyProgram(program.collector, loss, program.buffer, program.config,
                                   device=device)
    return program


def td3_family_draws(torch, algo, program, rng):
    """One update's fed draws: the sampler's uniforms, then the loss's
    (TD3's smoothing noise; the SAC-style pair of normals; REDQ's
    subset)."""
    B = program.config.batch_size
    u = torch.from_numpy(rng.random(B, dtype=np.float32))
    normal = lambda: torch.from_numpy(rng.standard_normal((B, 1), dtype=np.float32))  # noqa: E731
    if algo == "ddpg":
        return (u,)
    if algo in ("td3", "td3bc"):
        return (u, normal())
    if algo == "crossq":
        return (u, normal(), normal())
    n_q, m = program.loss.num_qvalue_nets, program.loss.sub_sample_len
    return (u, normal(), normal(), torch.from_numpy(rng.permutation(n_q)[:m].astype(np.int64)))


def rounding_only(algo, program, k) -> dict:
    """CrossQ's tensors whose card-against-CPU gap is rounding amplified
    by Adam, with the bound each is held to instead of CPU_CHECK_PARAMS:
    a bias that reaches a train-mode BatchNorm through affine maps only
    (the first BatchNorm's and the hidden layers') has a gradient of 0 but
    for rounding, whose sign Adam's step turns into a move of up to lr,
    so the two runs part by up to 2 lr an update; the running mean of the
    BatchNorm after such a bias takes (1 - momentum) of its gap at each
    update."""
    if algo != "crossq":
        return {}
    lr, q = program.config.learning_rate, program.loss.qvalue
    out = {"qvalue.bn_biases.0": 2 * lr * k}
    for j in range(len(q.weights) - 1):
        out[f"qvalue.biases.{j}"] = 2 * lr * k
        out[f"qvalue.mean_{j + 1}"] = (1 - q.momentum) * lr * k * (k - 1) + CPU_CHECK_PARAMS[1]
    return out


def td3_card_cpu(torch, algo, program, ts, cfg, device="cuda"):
    """``check_updates`` single updates on the card and the same on the
    CPU, from the card's state (parameters, targets, running statistics,
    Adam, the replay ring) and one set of fed draws: each parameter,
    target and running statistic within CPU_CHECK_PARAMS (CrossQ's
    rounding-only tensors within their own bound), and the losses."""
    import dataclasses

    k = cfg["check_updates"]
    cpu = make_td3_family(torch, algo, "cpu", cfg)
    cts = cpu_twin(program, ts, cpu)
    rng = np.random.default_rng(23)
    draws = [td3_family_draws(torch, algo, program, rng) for _ in range(k)]
    losses = {}
    for name, prog, state, dev in (("card", program, ts, device), ("cpu", cpu, cts, "cpu")):
        config = prog.config
        prog.config = dataclasses.replace(config, utd_ratio=1)  # one update a call
        try:
            out = []
            for d in draws:
                state, m = prog.updates(state, [tuple(x.to(dev) for x in d)])
                out.append(m["loss"].item())
        finally:
            prog.config = config
        losses[name] = out
    sync(torch, device)

    gsd, csd = program.loss.state_dict(), cpu.loss.state_dict()
    own = rounding_only(algo, program, k)
    strict = [n for n in csd if n not in own]
    worst = max((excess(gsd[n].cpu(), csd[n], CPU_CHECK_PARAMS), n) for n in strict)
    own_excess = {n: (gsd[n].cpu() - csd[n]).abs().max().item() - bound
                  for n, bound in own.items()}
    return {"updates": k, "worst_param_excess_over_tol": worst[0], "worst_param": worst[1],
            "params_tol": CPU_CHECK_PARAMS, "tensors_compared": len(csd),
            "rounding_only_excess_over_bound": own_excess,
            "max_param_diff": max((gsd[n].cpu() - csd[n]).abs().max().item() for n in csd),
            "loss_card": losses["card"], "loss_cpu": losses["cpu"]}


def td3_family_one(torch, algo, cfg, device="cuda"):
    """One algorithm: (a) eager steps on two copies built alike, then
    ``graph_steps`` steps of one copy through ``jit_train_step`` against
    eager steps of the other, equal bit for bit (state, metrics, every
    parameter, target and running statistic, Adam's moments and count),
    TD3's held and moving updates counted; (c) host ms a call of each
    path over ``timed_calls`` calls and one profiled call; (b) the
    card-against-CPU check."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry

    progs = [make_td3_family(torch, algo, device, cfg) for _ in range(2)]
    t0 = time.perf_counter()
    states = [p.prefill(p.init(seed=0)) for p in progs]
    sync(torch, device)
    prefill_s = (time.perf_counter() - t0) / 2
    for _ in range(cfg["eager_steps"]):
        for i, p in enumerate(progs):
            states[i], _ = p.train_step(states[i])
    reg = ProgramRegistry(ExecutableStore())
    step = progs[1].jit_train_step(registry=reg)
    moved, held = 0, 0
    t0 = time.perf_counter()
    for i in range(cfg["graph_steps"]):
        actor0 = [a.clone() for a in progs[0].loss.actor.parameters()]
        states[0], m_e = progs[0].train_step(states[0])
        states[1], m_g = step(states[1])
        equal_trees(torch, (states[1], m_g), (states[0], m_e), f"td3_family {algo} step {i}")
        for a, b in zip(progs[0]._hidden_state(), progs[1]._hidden_state()):
            require(torch.equal(a, b), f"td3_family: {algo} step {i}: a parameter, statistic "
                    "or Adam moment differs between replay and eager")
        if any(not torch.equal(a, b) for a, b in zip(actor0, progs[0].loss.actor.parameters())):
            moved += 1
        else:
            held += 1
    sync(torch, device)
    graph_steps_s = time.perf_counter() - t0
    if algo in ("td3", "td3bc"):
        require(moved >= 1 and held >= 1, f"td3_family: {algo}: {moved} updates moved the "
                f"policy and {held} held it; the check needs both")
    stats = program_stats(step.program)
    if device == "cuda":  # TD3's two phases of the delay: two graphs
        require(stats["executables"] == (2 if algo in ("td3", "td3bc") else 1),
                f"td3_family: {algo}: {stats['executables']} graphs")
    metrics = {k: v.item() for k, v in m_e.items()}
    require(all(np.isfinite(v) for k, v in metrics.items() if k != "episode_reward_mean"),
            f"td3_family: {algo}: metrics {metrics}")
    if algo == "crossq":
        q = progs[0].loss.qvalue
        require(bool((q.mean_0 != 0).all()) and bool((q.var_0 != 1).all()),
                "td3_family: crossq: the running statistics did not move")
    box = {"e": states[0], "g": states[1]}
    paths = compare_paths(torch, f"td3_family {algo}",
                          lambda: box.__setitem__("e", progs[0].train_step(box["e"])[0]),
                          lambda: box.__setitem__("g", step(box["g"])[0]), cfg["timed_calls"])
    utd = progs[0].config.utd_ratio
    rates = {p: {"env_steps_per_s": cfg["frames_per_batch"] * 1e3 / paths[p]["host_ms_per_call"],
                 "updates_per_s": utd * 1e3 / paths[p]["host_ms_per_call"]}
             for p in ("eager", "replay")}
    check = td3_card_cpu(torch, algo, progs[0], box["e"], cfg, device)
    require(check["worst_param_excess_over_tol"] <= 0.0,
            f"td3_family_check: {algo}: {check['worst_param']} beyond tolerance")
    require(all(v <= 0.0 for v in check["rounding_only_excess_over_bound"].values()),
            f"td3_family_check: {algo}: {check['rounding_only_excess_over_bound']}")
    return {"utd_ratio": utd, "policy_delay": progs[0].config.policy_delay,
            "prefill_s": prefill_s, "graph_steps": cfg["graph_steps"],
            "graph_steps_s": graph_steps_s, "replay_equals_eager": True,
            "policy_moved_updates": moved, "policy_held_updates": held,
            "program": stats, "final_metrics": metrics, "rates": rates,
            **paths, "card_cpu": check}


def discrete_sac_check(torch, device="cuda", n_envs=256, frames=1024, batch=256):
    """Discrete SAC's loss, metrics and gradients on the card against the
    CPU: 256x256 actor and critics (``DiscreteSACLoss`` has no factory in
    either package) on one CartPole batch collected on the card, within
    the PPO check's limits."""
    from rl_tpu_torch.collectors import Collector
    from rl_tpu_torch.envs import CartPoleEnv, VmapEnv
    from rl_tpu_torch.modules import MLP
    from rl_tpu_torch.objectives import DiscreteSACLoss
    from rl_tpu_torch.trainers import default_discrete_actor

    def build(device):
        env = VmapEnv(CartPoleEnv(), n_envs)
        loss = DiscreteSACLoss(default_discrete_actor(env), MLP(2, (256, 256)), num_actions=2)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        coll = Collector(env, loss.actor, frames_per_batch=frames)
        cstate = coll.init(gen)
        loss.init_params(cstate["carry"], gen)
        return loss, coll, cstate

    card, coll, cstate = build(device)
    cpu, _, _ = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    data, _ = coll.collect(cstate)
    flat = data.apply(lambda x: x.reshape((-1,) + tuple(x.shape[2:])))
    mb = flat[torch.arange(0, frames, frames // batch, device=device)]
    lg, gg, mg = card.grad(mb)
    lc, gc, mc = cpu.grad(mb.apply(lambda x: x.cpu()))
    sync(torch, device)

    names = [n for n, _ in cpu.trainable_parameters()]
    grad = max((excess(a.cpu(), b, PPO_CHECK_GRADS), n) for a, b, n in zip(gg, gc, names))
    met = max((excess(mg[k].cpu(), mc[k], PPO_CHECK_LOSS), k) for k in mc.keys())
    report = {"batch": batch, "loss_card": lg.item(), "loss_cpu": lc.item(),
              "loss_excess_over_tol": excess(lg.cpu(), lc, PPO_CHECK_LOSS),
              "loss_tol": PPO_CHECK_LOSS, "worst_metric_excess_over_tol": met[0],
              "worst_metric": met[1], "worst_grad_excess_over_tol": grad[0],
              "worst_grad": grad[1], "grads_tol": PPO_CHECK_GRADS}
    require(report["loss_excess_over_tol"] <= 0.0, f"discrete_sac: loss {lg.item()} vs {lc.item()}")
    require(met[0] <= 0.0, f"discrete_sac: metric {met[1]} beyond tolerance")
    require(grad[0] <= 0.0, f"discrete_sac: gradient of {grad[1]} beyond tolerance")
    return report


def td3_family_phase(torch, card, device="cuda", cfg=TD3_FAMILY, algos=TD3_ALGOS):
    """DDPG, TD3, TD3+BC, REDQ and CrossQ at the reference factories' full
    widths, each through :func:`td3_family_one`, then discrete SAC's
    card-against-CPU check; every kernel's count set to 0 before and read
    after (B7 is not on these paths: the factories sample uniformly)."""
    zero_launches()
    report = {}
    for algo in algos:
        t0 = time.perf_counter()
        report[algo] = td3_family_one(torch, algo, cfg, device)
        report[algo]["seconds"] = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.empty_cache()
    report["discrete_sac"] = discrete_sac_check(torch, device)
    launches = read_launches()
    emit({"phase": "td3_family", "config": cfg,
          "env": f"VmapEnv(PendulumEnv(), {cfg['n_envs']})", "dtype": "float32", **report,
          "launches": launches, "card": card})
    HEADLINES["td3_family"] = {
        a: {"eager_ms": report[a]["eager"]["host_ms_per_call"],
            "replay_ms": report[a]["replay"]["host_ms_per_call"],
            "env_steps_per_s": {p: report[a]["rates"][p]["env_steps_per_s"]
                                for p in ("eager", "replay")},
            "idle": {p: report[a][p]["device_idle_share"] for p in ("eager", "replay")},
            "card_cpu_max_param_diff": report[a]["card_cpu"]["max_param_diff"]}
        for a in algos}
    return launches


# -- phase 7c: the overlapped host-env trainer ---------------------------------

# bench_async_collect's full tier (bench.py:1829-1835): 16 host envs,
# batches of 256 frames, UTD 4, batch 256, a 16,384-slot DeviceStorage
# sampled by PrioritizedSampler() with "td_error" written back, SAC with a
# TanhNormal actor and a ConcatMLP critic of (64, 64), lr 3e-4, 4096
# frames; Pendulum-v1 as gymnasium steps it, in numpy.
ASYNC_OFFPOLICY = dict(n_envs=16, frames_per_batch=256, utd_ratio=4, batch_size=256,
                       capacity=1 << 14, num_cells=(64, 64), learning_rate=3e-4,
                       warmup_frames=512, total_frames=4096, profiled_frames=1024,
                       timed_replays=20, slice_len=8)
SAMPLER_WEIGHT_RTOL = 1e-6  # _weight and staleness, card against CPU


class NumpyPendulum:
    """Pendulum-v1's dynamics as gymnasium's ``PendulumEnv`` steps them
    (max speed 8, max torque 2, dt 0.05, g 10, m 1, l 1; reward
    ``-(angle_normalize(th)^2 + 0.1 thdot^2 + 0.001 u^2)``; truncated at 200
    steps; reset uniform in [-pi, pi] x [-1, 1]), as a numpy host env:
    gymnasium is not installed beside the card."""

    max_speed, max_torque, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0

    def __init__(self, max_episode_steps: int = 200):
        from rl_tpu_torch.data.specs import Bounded, Composite, Unbounded

        self.observation_spec = Composite(observation=Unbounded((3,)))
        self.action_spec = Bounded(shape=(1,), low=-self.max_torque, high=self.max_torque)
        self.max_episode_steps = max_episode_steps
        self.state = np.zeros(2)
        self.t = 0

    def _obs(self):
        th, thdot = self.state
        return {"observation": np.array([np.cos(th), np.sin(th), thdot], np.float32)}

    def reset(self, seed=None):
        self.state = np.random.default_rng(seed).uniform(low=[-np.pi, -1.0], high=[np.pi, 1.0])
        self.t = 0
        return self._obs()

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(np.asarray(action).ravel()[0], -self.max_torque, self.max_torque))
        norm = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                         + 3.0 / (self.m * self.l**2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        self.state = np.array([th + thdot * self.dt, thdot])
        self.t += 1
        return self._obs(), -cost, False, self.t >= self.max_episode_steps

    def close(self):
        pass


def make_async(torch, device, cfg=ASYNC_OFFPOLICY, registry=None, metrics=None,
               supervisor=None):
    """``bench_async_collect``'s trainer: SAC (a ``TanhNormal`` actor and a
    ``ConcatMLP`` critic ensemble of ``num_cells``), an
    ``AsyncHostCollector`` over ``n_envs`` :class:`NumpyPendulum` in a
    ``ThreadedEnvPool``, ``ReplayBuffer(DeviceStorage(capacity),
    PrioritizedSampler())`` with "td_error", the device metrics on; its
    programs in ``registry`` (default: a fresh one); the actor thread under
    ``supervisor`` when one is given."""
    from rl_tpu_torch.collectors import AsyncHostCollector, ThreadedEnvPool
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
    from rl_tpu_torch.data import DeviceStorage, PrioritizedSampler, ReplayBuffer
    from rl_tpu_torch.modules import (MLP, ConcatMLP, NormalParamExtractor, ProbabilisticActor,
                                      TanhNormal, TDModule, TDSequential)
    from rl_tpu_torch.objectives import SACLoss
    from rl_tpu_torch.obs import MetricsRegistry
    from rl_tpu_torch.trainers import AsyncOffPolicyTrainer, OffPolicyConfig

    cells = cfg["num_cells"]
    actor = ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=cells), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_keys=("loc", "scale"))
    loss = SACLoss(actor, ConcatMLP(out_features=1, num_cells=cells))
    metrics = metrics if metrics is not None else MetricsRegistry()
    pool = ThreadedEnvPool([NumpyPendulum for _ in range(cfg["n_envs"])])
    coll = AsyncHostCollector(pool, loss.actor, frames_per_batch=cfg["frames_per_batch"],
                              seed=0, registry=metrics, supervisor=supervisor, device=device)
    config = OffPolicyConfig(batch_size=cfg["batch_size"], utd_ratio=cfg["utd_ratio"],
                             learning_rate=cfg["learning_rate"])
    return AsyncOffPolicyTrainer(
        coll, loss, ReplayBuffer(DeviceStorage(cfg["capacity"]), PrioritizedSampler()), config,
        priority_key="td_error", device_metrics=True, metrics_registry=metrics, device=device,
        registry=registry or ProgramRegistry(ExecutableStore()))


def host_chunk(torch, tr, rng, version=0):
    """A chunk of ``frames_per_batch`` host transitions in the trainer's
    schema, random from ``rng``."""
    n = tr.collector.frames_per_batch
    example = tr.example_item().apply(lambda x: x.cpu())

    def fill(path, x):
        if path[-1] == "policy_version":
            return torch.full((n,), version, dtype=x.dtype)
        if path[-1] in ("env_ids", "step"):
            return torch.arange(n, dtype=x.dtype) % (64 if path[-1] == "env_ids" else n)
        if x.dtype == torch.bool:
            return torch.from_numpy(rng.random(n) < 0.05)
        return torch.from_numpy(rng.standard_normal((n,) + tuple(x.shape)).astype(np.float32))

    return example.named_apply(fill)


def async_graph_gate(torch, device, cfg):
    """Two trainers built alike, their replays holding the same 3 chunks:
    one writes a host chunk through ``replay.extend`` and dispatches
    ``offpolicy.k_updates`` as graphs (captured by ``aot_warmup``), the
    other runs both bodies eagerly; state, metrics, parameters, targets
    and Adam equal bit for bit, one capture each."""
    eager, graphed = make_async(torch, device, cfg), make_async(torch, device, cfg)
    try:
        ts_e, ts_g = eager.init(seed=0), graphed.init(seed=0)
        rng = np.random.default_rng(1)
        for c in range(3):
            items = host_chunk(torch, eager, rng, c).to(device)
            ts_e = {**ts_e, "buffer": eager.extend._write(ts_e["buffer"], items)}
            ts_g = {**ts_g, "buffer": graphed.extend._write(ts_g["buffer"], items)}
        t0 = time.perf_counter()
        graphed.aot_warmup(ts_g)
        capture_s = time.perf_counter() - t0
        items = host_chunk(torch, eager, rng, 3)
        ts_e = {**ts_e, "buffer": eager.extend._write(ts_e["buffer"], items.to(device))}
        ts_g = {**ts_g, "buffer": graphed.extend(ts_g["buffer"], items)}
        equal_trees(torch, ts_g["buffer"], ts_e["buffer"], "async_offpolicy: replay.extend")
        inner, m_e = eager.updates(eager._inner(ts_e))
        ts_e = {**ts_e, **inner, "update_count": ts_e["update_count"] + cfg["utd_ratio"]}
        ts_g, m_g = graphed.k_updates(ts_g)
        equal_trees(torch, (m_g, ts_g), (m_e, ts_e), "async_offpolicy: offpolicy.k_updates")
        for a, b in zip(eager._hidden_state(), graphed._hidden_state()):
            require(torch.equal(a, b), "async_offpolicy: a parameter, target or Adam moment "
                    "differs between the K-update's replay and eager")
        stats = {n: program_stats(p) for n, p in (("k_updates", graphed.k_program),
                                                  ("extend", graphed.extend.program))}
        if device == "cuda":
            require(all(v["compiles"] == v["executables"] == 1 and v["replays"] == 1
                        for v in stats.values()), f"async_offpolicy: graphs {stats}")
        return {"replay_equals_eager": True, "capture_s": capture_s, "programs": stats}
    finally:
        for tr in (eager, graphed):
            tr.collector.pool.close()


def sampler_cases(torch, cfg):
    """The five other samplers at the phase's capacity: (name, sampler,
    writes, fed draws), the writes three chunks of items whose trajectory
    ids cut episodes of 5-40 steps and whose policy versions rise."""
    from rl_tpu_torch.data import ArrayDict
    from rl_tpu_torch.data.replay import samplers as sp

    cap, B, L = cfg["capacity"], cfg["batch_size"], cfg["slice_len"]
    rng = np.random.default_rng(5)
    lengths = rng.integers(5, 40, cap)
    tids = np.repeat(np.arange(cap), lengths)[:cap]
    chunks = []
    cuts = (0, cap * 3 // 8, cap * 3 // 4, cap)
    for c, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        items = ArrayDict(collector=ArrayDict(
            traj_ids=torch.from_numpy(tids[lo:hi]),
            policy_version=torch.from_numpy(rng.integers(c, 3 * c + 4, hi - lo))))
        chunks.append((torch.arange(lo, hi), items))
    size = cap - 100  # the ring nearly full
    hi = size - L + 1
    return [
        ("without_replacement", sp.SamplerWithoutReplacement(), chunks,
         torch.from_numpy(rng.permutation(cap))),
        ("staleness", sp.StalenessAwareSampler(max_staleness=6), chunks,
         (torch.from_numpy(rng.random(B, dtype=np.float32)),
          torch.from_numpy(rng.random(B, dtype=np.float32)))),
        ("slice", sp.SliceSampler(L), chunks,
         torch.from_numpy(rng.integers(0, hi, (B // L, 8)))),
        ("slice_without_replacement", sp.SliceSamplerWithoutReplacement(L), chunks,
         torch.from_numpy(rng.permutation(cap))),
        ("prioritized_slice", sp.PrioritizedSliceSampler(L), chunks,
         torch.from_numpy(rng.random(B // L, dtype=np.float32))),
    ], size


def samplers_card_check(torch, cfg, device="cuda"):
    """Each of the five samplers written and sampled on fed draws on the
    card and on the CPU: indices, masks, valid slices and start indices
    equal, ``_weight`` and ``staleness`` within SAMPLER_WEIGHT_RTOL, the
    new state equal; then its ``on_write`` and its ``sample`` (drawing from
    a generator) each registered and captured, two replays equal to eager
    runs on a copy of the same state bit for bit."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
    from rl_tpu_torch.data import Sampler

    cap, B = cfg["capacity"], cfg["batch_size"]
    cases, size = sampler_cases(torch, cfg)
    out = {}
    for name, sampler, chunks, fed in cases:
        states = {}
        for dev in ("cpu", device):
            st = sampler.init(cap, dev)
            for idx, items in chunks:
                st = sampler.on_write(st, idx.to(dev), items.to(dev))
            if name == "prioritized_slice":
                g = torch.Generator().manual_seed(2)
                st = sampler.update_priority(
                    st, torch.arange(0, cap, 3).to(dev),
                    (torch.rand(len(range(0, cap, 3)), generator=g) * 4).to(dev))
            u = tuple(f.to(dev) for f in fed) if isinstance(fed, tuple) else fed.to(dev)
            idx, info, st = sampler.sample(st, None, B, torch.tensor(size, device=dev), cap, u=u)
            states[dev] = (idx, info, st)
        (ic, infc, stc), (ig, infg, stg) = states["cpu"], states[device]
        require(torch.equal(ig.cpu(), ic), f"samplers: {name}: indices differ card/CPU")
        worst = 0.0
        for k in infc.keys():
            a, b = infg[k].cpu(), infc[k]
            if k in ("_weight", "staleness"):
                worst = max(worst, ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item())
            else:
                require(torch.equal(a, b), f"samplers: {name}: {k} differs card/CPU")
        require(worst <= SAMPLER_WEIGHT_RTOL, f"samplers: {name}: weights {worst} apart")
        equal_trees(torch, stg.apply(lambda x: x.cpu()), stc, f"samplers: {name} state")
        # the bodies as graphs: on_write of a chunk (where it writes), then
        # two draws
        reg = ProgramRegistry(ExecutableStore())
        draw = reg.register(f"sampler.{name}.sample", sampler.sample)
        progs = [draw]
        twins = [stg.apply(lambda x: x.clone()) for _ in range(2)]
        gens = [torch.Generator(device=device).manual_seed(4) for _ in range(2)]
        if type(sampler).on_write is not Sampler.on_write:
            write = reg.register(f"sampler.{name}.on_write", sampler.on_write)
            progs.append(write)
            idx, items = chunks[0]
            idx, items = idx[:512].to(device), items[:512].to(device)
            twins[0] = sampler.on_write(twins[0], idx, items)
            twins[1] = write(twins[1], idx, items)
            equal_trees(torch, twins[1], twins[0], f"samplers: {name} on_write graph")
        sz = torch.tensor(size, device=device)
        for _ in range(2):
            e = sampler.sample(twins[0], gens[0], B, sz, cap)
            g = draw(twins[1], gens[1], B, sz, cap)
            equal_trees(torch, g, e, f"samplers: {name} sample graph")
            twins = [e[2], g[2]]
        if device == "cuda":
            require(all(p.program_count() == 1 for p in progs),
                    f"samplers: {name}: not one graph each")
        out[name] = {"indices_equal": True, "weights_max_rel": worst,
                     "valid_share": (infc["valid_slices"].float().mean().item()
                                     if "valid_slices" in infc else None)}
    return out


def versions_check(ts, coll, dispatches):
    """Every env's stored policy versions never go back in step order, none
    runs ahead of the collector's, and the collector's is the number of
    dispatches. Returns the stored versions' range."""
    data, size = ts["buffer"]["storage", "data"], int(ts["buffer"]["storage", "size"])
    v, env, step = (data["collector", k][:size].cpu() for k in ("policy_version", "env_ids",
                                                               "step"))
    for e in env.unique().tolist():
        mine = v[env == e][step[env == e].argsort()]
        require(bool((mine.diff() >= 0).all()), f"async_offpolicy: env {e}'s policy versions "
                "go back")
    require(coll.policy_version == dispatches, f"async_offpolicy: policy version "
            f"{coll.policy_version} after {dispatches} dispatches")
    require(int(v.max()) <= coll.policy_version, "async_offpolicy: a stamp runs ahead")
    return {"min": int(v.min()), "max": int(v.max()), "stored": size}


def event_ms(torch, fn, n):
    """Device ms of each of ``n`` calls of ``fn`` (CUDA events around each,
    after a synchronise: the card idle before it), median and all."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out), out


def run_async(torch, tr, ts, frames, batch_timeout=120.0):
    """``tr.train`` over ``frames`` frames: (ts, wall s, batches, metrics)."""
    batches, last = 0, None
    t0 = time.perf_counter()
    for ts, m in tr.train(ts, frames, batch_timeout=batch_timeout):
        batches += 1
        last = m if m is not None else last
    sync(torch, tr.device)
    return ts, time.perf_counter() - t0, batches, last


def serial_run(torch, device, cfg):
    """``bench.py:1893-1955``: the same two programs driven serially behind
    a ``HostCollector`` (collect, flatten with the stamps the async writer
    records, write, K-update): env steps/s and updates/s over
    ``total_frames`` after one warm-up iteration."""
    from rl_tpu_torch.collectors import HostCollector
    from rl_tpu_torch.data import ArrayDict

    tr = make_async(torch, device, cfg)
    try:
        fpb, n = cfg["frames_per_batch"], cfg["n_envs"]
        hc = HostCollector(tr.collector.pool, tr.loss.actor, frames_per_batch=fpb, seed=0,
                           device=device)
        ts = tr.init(seed=0)
        if device == "cuda":
            tr.aot_warmup(ts)

        def iteration(ts, version):
            batch = hc.collect()
            flat = ArrayDict({k: batch[k] for k in ("observation", "action", "next")}).apply(
                lambda x: x.reshape((-1,) + tuple(x.shape[2:])))
            stamps = ArrayDict(
                policy_version=torch.full((fpb,), version, dtype=torch.int32, device=device),
                env_ids=torch.arange(n, dtype=torch.int32, device=device).repeat(fpb // n),
                step=torch.arange(version * fpb, (version + 1) * fpb, dtype=torch.int32,
                                  device=device))
            ts = {**ts, "buffer": tr.extend(ts["buffer"], flat.set("collector", stamps))}
            return tr.k_updates(ts)[0]

        ts = iteration(ts, 0)
        sync(torch, device)
        iters = cfg["total_frames"] // fpb
        t0 = time.perf_counter()
        for i in range(iters):
            ts = iteration(ts, i + 1)
        sync(torch, device)
        wall = time.perf_counter() - t0
        return {"iterations": iters, "wall_s": wall,
                "env_steps_per_s": iters * fpb / wall,
                "updates_per_s": iters * cfg["utd_ratio"] / wall,
                "programs": {"k_updates": program_stats(tr.k_program),
                             "extend": program_stats(tr.extend.program)}}
    finally:
        tr.collector.pool.close()


def async_offpolicy_phase(torch, card, device="cuda", cfg=ASYNC_OFFPOLICY):
    """The overlapped host-env trainer at ``bench_async_collect``'s full
    tier (see the module docstring, 7c): the samplers' card check and the
    graph gate, then the async run, its profiled window, the programs'
    device ms, the card-against-CPU check and the serial run."""
    from torch.profiler import ProfilerActivity, profile

    zero_launches()
    samplers = samplers_card_check(torch, cfg, device) if device == "cuda" else None
    gate = async_graph_gate(torch, device, cfg)
    tr = make_async(torch, device, cfg)
    try:
        ts = tr.init(seed=0)
        t0 = time.perf_counter()
        warm = tr.aot_warmup(ts)
        capture_s = time.perf_counter() - t0
        captured = {n: p.stats["compiles"] for n, p in (("k", tr.k_program),
                                                        ("w", tr.extend.program))}
        ts, warm_s, warm_batches, _ = run_async(torch, tr, ts, cfg["warmup_frames"])
        coll = tr.collector
        before = coll.stats()
        u0 = ts["update_count"]
        tr.host_split.clear()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ts, wall, batches, metrics = run_async(torch, tr, ts, cfg["total_frames"])
        peak = torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else None
        after = coll.stats()
        split = {k: statistics.mean(h[k] for h in tr.host_split) * 1e3
                 for k in ("wait", "extend", "dispatch", "publish")}
        updates = ts["update_count"] - u0
        rates = {"env_steps_per_s": (after["env_steps"] - before["env_steps"]) / wall,
                 "updates_per_s": updates / wall, "wall_s": wall, "batches": batches,
                 "updates": updates}
        dispatches = warm_batches + batches
        prof = None
        if device == "cuda":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as p:
                time.sleep(TRACE_MARGIN_S * 4)
                ts, p_wall, p_batches, _ = run_async(torch, tr, ts, cfg["profiled_frames"])
                time.sleep(TRACE_MARGIN_S)
            kernels = device_kernels(torch, p)
            b7 = sum(n for key, (_, n) in kernels.items()
                     if any(s in key for s in PROFILE_NAMES["sumtree_update"]))
            require(b7 == cfg["utd_ratio"] * p_batches, f"async_offpolicy: B7 launched {b7} "
                    f"times in a profiled window of {p_batches} batches")
            prof = {"batches": p_batches, "wall_s": p_wall, "sumtree_update_launches": b7,
                    "device_launches": sum(n for _, n in kernels.values())}
            dispatches += p_batches
        versions = versions_check(ts, coll, dispatches)
        final = {k: v.item() for k, v in metrics.items()}
        require(all(np.isfinite(v) for v in final.values()), f"async_offpolicy: metrics {final}")
        flat = tr.publish_device_metrics(ts)
        require(flat["bad_steps"] == 0, f"async_offpolicy: {flat['bad_steps']} bad steps")
        stats = {"k_updates": program_stats(tr.k_program),
                 "extend": program_stats(tr.extend.program)}
        dev_ms = None
        if device == "cuda":
            require(all(v["compiles"] == v["executables"] == 1 for v in stats.values())
                    and captured == {"k": 1, "w": 1},
                    f"async_offpolicy: a capture after warm-up: {stats}")
            box = {"ts": ts}
            chunk = tr.extend.chunk(ts["buffer"])

            def kupd():
                box["ts"] = tr.k_updates(box["ts"])[0]

            def write():
                box["ts"] = {**box["ts"], "buffer": tr.extend(box["ts"]["buffer"], chunk)}

            k_ms, k_all = event_ms(torch, kupd, cfg["timed_replays"])
            w_ms, _ = event_ms(torch, write, cfg["timed_replays"])
            ts = box["ts"]
            busy = batches * (k_ms + w_ms)
            dev_ms = {"k_updates_ms": k_ms, "k_updates_ms_all": k_all, "extend_ms": w_ms,
                      "async_device_busy_ms": busy,
                      "async_device_idle_share": 1 - busy / (wall * 1e3),
                      "k_updates_host_ms": host_ms(torch, kupd, cfg["timed_replays"])}
        # the wrappers' counts (eager runs: captures, the gate's eager
        # bodies); replays, from the profiled window's B7 a dispatch
        launches = read_launches()
        if prof is not None:
            replays = (tr.k_program.stats["replays"]
                       + gate["programs"]["k_updates"]["replays"])
            launches["sumtree_update"] += cfg["utd_ratio"] * replays
        check = None
        if device == "cuda":
            cpu = make_async(torch, "cpu", cfg)
            try:
                rng = np.random.default_rng(13)
                B, k = cfg["batch_size"], cfg["utd_ratio"]
                draws = [tuple(torch.from_numpy(a) for a in (
                    rng.random(B, dtype=np.float32),
                    rng.standard_normal((B, 1), dtype=np.float32),
                    rng.standard_normal((B, 1), dtype=np.float32))) for _ in range(k)]
                ts, check = card_cpu_stepwise(torch, tr, ts, cpu, draws, 0.6, CPU_CHECK_TD)
            finally:
                cpu.collector.pool.close()
            require(check["indices_equal"], "async_offpolicy_check: other indices card/CPU")
            require(check["worst_param_excess_over_tol"] <= 0.0,
                    f"async_offpolicy_check: {check['worst_param']} beyond tolerance")
            require(all(v <= 0.0 for v in check["tree_excess_over_tol"].values()),
                    f"async_offpolicy_check: PER tree {check['tree_excess_over_tol']}")
        registry_text = tr.metrics_registry.render()
    finally:
        tr.collector.pool.close()
    serial = serial_run(torch, device, cfg)
    ratios = {"env_steps": rates["env_steps_per_s"] / serial["env_steps_per_s"],
              "updates": rates["updates_per_s"] / serial["updates_per_s"]}
    report = {
        "config": {**cfg, "num_cells": list(cfg["num_cells"]),
                   "source": "bench.py:1829-1835 (bench_async_collect), full tier",
                   "env": f"NumpyPendulum (Pendulum-v1's dynamics) x {cfg['n_envs']}, "
                          "ThreadedEnvPool",
                   "sampler": "PrioritizedSampler()", "priority_key": "td_error"},
        "samplers": samplers, "graph_gate": gate, "capture_s": capture_s, "aot": warm,
        "warmup": {"batches": warm_batches, "wall_s": warm_s}, "async": rates,
        "collector": {"straggler_cutoffs": after["straggler_cutoffs"] - before["straggler_cutoffs"],
                      "harvests": after["harvests"] - before["harvests"],
                      "max_queue_depth": after["max_queue_depth"],
                      "env_steps": after["env_steps"] - before["env_steps"]},
        "host_ms_per_batch": split, "peak_mib": peak, "profiled": prof, "device": dev_ms,
        "versions": {**versions, "final": coll.policy_version, "dispatches": dispatches},
        "final_metrics": final, "bad_steps": flat["bad_steps"], "updates_on_device": flat["updates"],
        "programs": stats, "serial": serial, "async_over_sync": ratios,
        "registry_series": sorted({line.split("{")[0].split(" ")[0]
                                   for line in registry_text.splitlines()
                                   if line and not line.startswith("#")}),
        "launches": launches, "card_cpu": check, "card": card,
    }
    emit({"phase": "async_offpolicy", **report})
    HEADLINES["async_offpolicy"] = {
        "env_steps_per_s": {"async": rates["env_steps_per_s"],
                            "sync": serial["env_steps_per_s"]},
        "updates_per_s": {"async": rates["updates_per_s"], "sync": serial["updates_per_s"]},
        "async_over_sync": ratios, "host_ms_per_batch": split,
        "straggler_cutoffs": report["collector"]["straggler_cutoffs"],
        "max_queue_depth": after["max_queue_depth"],
        **{k: (dev_ms or {}).get(k) for k in ("k_updates_ms", "extend_ms",
                                              "async_device_idle_share")},
        "card_cpu_max_param_diff": (check or {}).get("max_param_diff")}
    return launches


def card_cpu_alone(torch, program, ts, cpu, draws, alpha=None, td_tol=None):
    """The updates of ``draws`` one at a time, each on the card and on the
    CPU from the card's state before it (:func:`cpu_twin`): per update,
    whether both sampled the same indices, the worst parameter's excess
    over ``CPU_CHECK_PARAMS`` and the largest parameter difference; with
    ``alpha``, the PER tree's excess after it (:func:`tree_excess`).
    Returns the card's state after them."""
    out = []
    for d in draws:
        cts, seen, after = cpu_twin(program, ts, cpu), {}, {}
        for who, prog, draw in (("card", program, tuple(a.cuda() for a in d)), ("cpu", cpu, d)):
            state = ts if who == "card" else cts
            sample = prog.buffer.sample

            def recording(*args, _sample=sample, _who=who, **kw):
                batch, st = _sample(*args, **kw)
                seen[_who] = batch["index"].cpu()
                return batch, st

            prog.buffer.sample = recording
            try:
                bstate, dm, _ = prog._update(state["buffer"], state.get("obs"),
                                             state["generator"], state["update_count"],
                                             draw[0], tuple(draw[1:]))
            finally:
                prog.buffer.sample = sample
            new = {**state, "buffer": bstate, "update_count": state["update_count"] + 1}
            if dm is not None:
                new["obs"] = dm
            after[who] = new
            if who == "card":
                ts = new
        gsd, csd = program.loss.state_dict(), cpu.loss.state_dict()
        worst = max((excess(gsd[n].cpu(), csd[n], CPU_CHECK_PARAMS), n) for n in csd)
        row = {"indices_equal": torch.equal(seen["card"], seen["cpu"]),
               "worst_param_excess_over_tol": worst[0], "worst_param": worst[1],
               "max_param_diff": max((gsd[n].cpu() - csd[n]).abs().max().item() for n in csd)}
        if alpha is not None:
            row["tree_excess_over_tol"] = tree_excess(after["card"]["buffer"],
                                                      after["cpu"]["buffer"], alpha, td_tol)
        out.append(row)
    return ts, out


def card_cpu_stepwise(torch, program, ts, cpu, draws, alpha, td_tol):
    """The async phase's card-against-CPU gate (ROADMAP C10): each update
    of ``draws`` made on the card and on the CPU from the card's state
    before it (:func:`card_cpu_alone`), so each is held to one update's
    rounding: the same indices at every update, the parameters within
    ``CPU_CHECK_PARAMS`` and the PER tree within its limits after every
    update. Four chained updates let the last-bit differences of the
    priorities written back move a stratified draw across a leaf boundary
    on one side; from the card's state each draw sees the same tree.
    Returns the card's state after them and the report (the worst of the
    updates, and each update's row)."""
    zero_launches()
    ts, rows = card_cpu_alone(torch, program, ts, cpu, draws, alpha, td_tol)
    launches = read_launches()
    worst = max(rows, key=lambda r: r["worst_param_excess_over_tol"])
    report = {"updates": len(rows), "held": "each update from the card's state before it",
              "indices_equal": all(r["indices_equal"] for r in rows),
              "worst_param_excess_over_tol": worst["worst_param_excess_over_tol"],
              "worst_param": worst["worst_param"],
              "max_param_diff": max(r["max_param_diff"] for r in rows),
              "tree_excess_over_tol": {k: max(r["tree_excess_over_tol"][k] for r in rows)
                                       for k in rows[0]["tree_excess_over_tol"]},
              "params_tol": CPU_CHECK_PARAMS, "tree_tol": CPU_CHECK_TREE, "td_error_tol": td_tol,
              "per_update": rows, "launches": launches}
    return ts, report


def gate_fails(report) -> list:
    """The updates of a :func:`card_cpu_stepwise` report that fail its gate."""
    return [i for i, r in enumerate(report["per_update"])
            if not r["indices_equal"] or r["worst_param_excess_over_tol"] > 0.0
            or any(v > 0.0 for v in r["tree_excess_over_tol"].values())]


def async_check_rate(torch, card, n, device="cuda", cfg=ASYNC_OFFPOLICY, between=512):
    """``chip_smoke.py async_check_rate N``: the async phase's card/CPU
    gate (:func:`card_cpu_stepwise`: 4 updates, each from the card's state
    before it, tree checked after each) made N times, from the train state
    after the phase's frames and then after each ``between`` more frames
    of the async run. One JSON line a check and a summary: the gate's
    failing updates out of 4 N."""
    tr, cpu = make_async(torch, device, cfg), make_async(torch, "cpu", cfg)
    rng = np.random.default_rng(13)
    B, k = cfg["batch_size"], cfg["utd_ratio"]

    def fed():
        return [tuple(torch.from_numpy(a) for a in (
            rng.random(B, dtype=np.float32), rng.standard_normal((B, 1), dtype=np.float32),
            rng.standard_normal((B, 1), dtype=np.float32))) for _ in range(k)]

    rows = []
    try:
        ts = tr.init(seed=0)
        tr.aot_warmup(ts)
        frames = cfg["warmup_frames"] + cfg["total_frames"] + cfg["profiled_frames"]
        ts = run_async(torch, tr, ts, frames)[0]
        for c in range(n):
            if c:
                ts = run_async(torch, tr, ts, between)[0]
            ts, gate = card_cpu_stepwise(torch, tr, ts, cpu, fed(), 0.6, CPU_CHECK_TD)
            row = {"check": c, "gate_failing_updates": gate_fails(gate),
                   "gate_worst_param_excess_over_tol": gate["worst_param_excess_over_tol"],
                   "gate_tree_excess_over_tol": gate["tree_excess_over_tol"]}
            rows.append(row)
            emit({"phase": "async_check_rate", **row})
    finally:
        tr.collector.pool.close()
        cpu.collector.pool.close()
    summary = {"phase": "async_check_rate_summary", "checks": n, "between_frames": between,
               "gate_updates": k * n,
               "gate_update_fails": sum(len(r["gate_failing_updates"]) for r in rows),
               "gate_check_fails": sum(bool(r["gate_failing_updates"]) for r in rows),
               "card": card}
    emit(summary)
    HEADLINES["async_check_rate"] = {k_: summary[k_] for k_ in (
        "checks", "gate_updates", "gate_update_fails")}


# The resilience phase: GRPO at the train phase's width on shorter
# rollouts (16 x (128 + 64) tokens), 4 steps with a preemption before the
# third, and the restart in a new process taking its first step at the
# train phase's rollout lengths (16 x (512 + 512) tokens); the async
# cell's trainer under the chaos injector.
RESILIENCE = dict(prompt_len=128, max_new=64, microbatch=8, steps=4, preempt_at=2,
                  restart_prompt_len=512, restart_max_new=512,
                  async_frames=2560, poison_dispatch=3, crash_iteration=40)


def build_dir():
    """The checkout's ``build/`` (listed in ``.gitignore``), for files a
    phase writes and removes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def resilience_grpo(torch, device, width, cfg):
    """``GRPOTrainer(warmup=True)`` at ``width`` in bf16 with the flash
    kernels and the continuous-batching engine (B1, B2, B4, B5)."""
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.models import TransformerConfig
    from rl_tpu_torch.trainers import GRPOTrainer

    tcfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                             flash_decode=True)
    return GRPOTrainer(arithmetic_dataset(64), model_config=tcfg, num_prompts=2, group_repeats=8,
                       max_prompt_len=cfg["prompt_len"], max_new_tokens=cfg["max_new"],
                       microbatch_size=cfg["microbatch"], continuous_batching=True,
                       warmup=True, device=device)


def grpo_state(torch, tr) -> dict:
    """Clones of what a resumed GRPO run must reproduce."""
    from rl_tpu_torch.obs import DeviceMetrics

    return {"tensors": [p.detach().clone() for p in tr.policy.parameters()]
            + [t.clone() for t in tr.opt.mu + tr.opt.nu + [tr.opt.count]]
            + [t.clone() for _, t in DeviceMetrics._leaves(tr._dm)],
            "history": {k: list(v) for k, v in tr.history.items()}}


def state_diff(torch, a, b) -> dict:
    """Bit-for-bit equality of two :func:`grpo_state`, and the largest
    absolute difference of any tensor element."""
    worst, same = 0.0, True
    for x, y in zip(a["tensors"], b["tensors"]):
        if not torch.equal(x, y):
            same = False
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return {"bit_equal": same and a["history"] == b["history"], "max_abs_diff": worst,
            "history_equal": a["history"] == b["history"]}


def grpo_replays(torch, tr, per_replay: dict, chaos: bool = False) -> dict:
    """The path kernels launched by every replay of ``tr``'s graphs: its
    update's, and its engine's programs' (:func:`engine_replays`). One
    more replay of each kind of graph is profiled, once for all the
    trainers that share ``per_replay``, and its launches count for each
    replay. ``chaos``: the trainer ran under an injector, so its update
    replayed the graph that takes the poison; that one is profiled under
    an injector that poisons nothing. Call it after ``tr``'s state was
    read: the profiled update replays over zeros shaped as the batch."""
    from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
    from rl_tpu_torch.resilience import FaultInjector, injection

    prog = tr._update_prog
    key = (prog.name, prog.fingerprint, chaos)
    if key not in per_replay:
        require(prog.program_count() == 1 + chaos,
                f"{prog.name}: {prog.program_count()} graphs, not {1 + chaos}")
        batch, before = tr.example_batch(), prog.stats["replays"]

        def call():
            if chaos:
                with injection(FaultInjector({}, registry=MetricsRegistry(),
                                             tracer=TraceRecorder())):
                    tr._update(batch)
            else:
                tr._update(batch)

        prof = profile_seen(torch, call, what=prog.name + (" (chaos)" if chaos else ""))
        require(prog.stats["replays"] == before + prof["calls"],
                f"{prog.name}: a profiled call was not one replay")
        per_replay[key] = prof["path_kernel_launches"]
    total = {k: v * prog.stats["replays"] for k, v in per_replay[key].items()}
    return add_counts(total, engine_replays(torch, tr.collector._engine, per_replay))


def restart_in_new_process(root, device, width, cfg, timeout_s=300) -> dict:
    """A restart as a preempted job's replacement makes it: ``chip_smoke.py
    restart`` in a new process (:func:`restart_child`) restores the latest
    emergency checkpoint under ``root`` into a trainer built with ``cfg``
    and takes one step. Its seconds from the parent's ``Popen`` to the
    child's exit, and the child's own split."""
    here = os.path.dirname(os.path.abspath(__file__))
    job = json.dumps({"root": root, "device": device, "width": width, "cfg": cfg})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "restart", job],
                          capture_output=True, text=True, timeout=timeout_s, cwd=here)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"resilience: the restarted process exited "
            f"{proc.returncode}: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"popen_to_exit_s": wall, **child}


def restart_child(torch, job: str) -> int:
    """``chip_smoke.py restart JOB``: the new process of
    :func:`restart_in_new_process`. From the start of :func:`main` (torch
    imported) it times CUDA's start, the trainer's build with the
    update's capture, the load, and the first step (its decode and
    admission graphs captured in it), and prints them as one JSON line.
    The kernels' libraries are loaded from ``build/`` at their first use,
    as a restarted job finds them. Gates: it resumes at the saved step,
    and its step is finite with no bad step."""
    from rl_tpu_torch.resilience import EmergencyCheckpointer

    job = json.loads(job)
    device, cfg = job["device"], job["cfg"]
    t0 = time.perf_counter()
    if device == "cuda":
        torch.zeros((), device=device)
        sync(torch, device)
    t1 = time.perf_counter()
    tr = resilience_grpo(torch, device, job["width"], cfg)  # build + the update's capture
    sync(torch, device)
    t2 = time.perf_counter()
    start = tr.emergency_restore(EmergencyCheckpointer(job["root"]))
    sync(torch, device)
    t3 = time.perf_counter()
    tr.train(1, start_step=start)
    sync(torch, device)
    t4 = time.perf_counter()
    last = {k: v[-1] for k, v in tr.history.items()}
    snap = tr.metrics_snapshot()
    require(start == cfg["preempt_at"] and len(tr.history["loss"]) == start + 1,
            f"restart: resumed at {start} with {len(tr.history['loss'])} steps of history")
    require(all(np.isfinite(v) for v in last.values()) and snap["bad_steps"] == 0,
            f"restart: the first step's metrics {last}, {snap['bad_steps']} bad steps")
    print(json.dumps({"since_main_s": t4 - T_MAIN, "import_s": T_MAIN - T_IMPORT,
                      "cuda_start_s": t1 - t0, "build_and_update_capture_s": t2 - t1,
                      "load_s": t3 - t2, "first_step_s": t4 - t3, "resumed_at": start,
                      "prompt_len": cfg["prompt_len"], "max_new": cfg["max_new"],
                      "first_step": last}), flush=True)
    return 0


def grpo_resume_gate(torch, device, width, cfg) -> dict:
    """Uninterrupted, preempted and resumed GRPO runs and a restart in a
    new process (see the module docstring, 7d); every trainer freed
    before the next is built. ``replayed``: the path kernels launched by
    the trainers' graph replays, from the profiler (:func:`grpo_replays`)."""
    import gc
    import tempfile

    from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
    from rl_tpu_torch.resilience import EmergencyCheckpointer, Fault, FaultInjector, injection
    from rl_tpu_torch.trainers.resilience import PreemptionHandler

    steps, at = cfg["steps"], cfg["preempt_at"]
    out, replayed, per_replay = {}, {}, {}
    graphs = device == "cuda"

    def uninterrupted():
        t0 = time.perf_counter()
        tr = resilience_grpo(torch, device, width, cfg)
        tr.train(steps)
        sync(torch, device)
        state, seconds = grpo_state(torch, tr), time.perf_counter() - t0
        if graphs:
            add_counts(replayed, grpo_replays(torch, tr, per_replay))
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return state, seconds

    want, out["uninterrupted_s"] = uninterrupted()
    reg = MetricsRegistry()
    with tempfile.TemporaryDirectory(dir=build_dir(), prefix="resilience-") as root:
        first = resilience_grpo(torch, device, width, cfg)
        handler = PreemptionHandler(registry=reg, tracer=TraceRecorder())
        emergency = EmergencyCheckpointer(root, registry=reg, tracer=TraceRecorder())
        save = first.emergency_save
        saved = {}

        def timed_save(em, step):
            sync(torch, device)
            t0 = time.perf_counter()
            saved["path"] = save(em, step)
            saved["s"] = time.perf_counter() - t0
            return saved["path"]

        first.emergency_save = timed_save
        inj = FaultInjector({"trainer.preempt": Fault("preempt", at=(at + 1,), target=handler)},
                            registry=reg, tracer=TraceRecorder())
        with injection(inj):
            first.train(steps, preemption=handler, emergency=emergency)
        require(len(first.history["loss"]) == at and emergency.latest_step() == at,
                f"resilience: the preempted run stopped after {len(first.history['loss'])} "
                f"steps, checkpoint {emergency.latest_step()}")
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(saved["path"])
                   for f in fs)
        if graphs:
            add_counts(replayed, grpo_replays(torch, first, per_replay, chaos=True))
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = resilience_grpo(torch, device, width, cfg)  # build + the update's capture
        t1 = time.perf_counter()
        start = resumed.emergency_restore(emergency)
        sync(torch, device)
        t2 = time.perf_counter()
        resumed.train(1, start_step=start)  # the decode chunks are captured in it
        sync(torch, device)
        t3 = time.perf_counter()
        resumed.train(steps - at - 1, start_step=start + 1)
        sync(torch, device)
        got = grpo_state(torch, resumed)
        out["update_program"] = program_stats(resumed._update_prog)
        if graphs:
            add_counts(replayed, grpo_replays(torch, resumed, per_replay))
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        # the same checkpoint restored by a new process, at the train
        # phase's rollout lengths (the saved state does not depend on them)
        out["restart_new_process"] = restart_in_new_process(
            root, device, width, {**cfg, "prompt_len": cfg["restart_prompt_len"],
                                  "max_new": cfg["restart_max_new"]})
    out.update(save_s=saved["s"], save_mib=size / 2**20, resumed_at=start,
               rebuild_in_process_to_first_step_s=t3 - t0,
               rebuild_in_process_split_s={"build_and_update_capture": t1 - t0,
                                           "load": t2 - t1, "first_step": t3 - t2},
               vs_uninterrupted=state_diff(torch, want, got))
    if not out["vs_uninterrupted"]["bit_equal"]:  # measure the spread of two whole runs
        again, _ = uninterrupted()
        out["spread_of_two_uninterrupted"] = state_diff(torch, want, again)
        spread = out["spread_of_two_uninterrupted"]["max_abs_diff"]
        require(out["vs_uninterrupted"]["max_abs_diff"] <= spread and spread > 0.0,
                f"resilience: the resumed GRPO run differs from the uninterrupted one by "
                f"{out['vs_uninterrupted']['max_abs_diff']} (run-to-run spread {spread})")
    out["emergency_saves"] = reg.counter("rl_tpu_resilience_emergency_checkpoints_total").value()
    out["replayed"] = replayed
    return out


def async_chaos_gate(torch, device, cfg) -> dict:
    """Two async trainers built alike: ``offpolicy.k_updates_chaos`` as a
    graph against its eager body over three chunks poisoned NaN, 0, NaN;
    then a single poisoned update leaves parameters, targets and Adam bit
    for bit and counts one bad step."""
    from rl_tpu_torch.obs import DeviceMetrics

    eager, graphed = make_async(torch, device, cfg), make_async(torch, device, cfg)
    try:
        ts_e, ts_g = eager.init(seed=0), graphed.init(seed=0)
        rng = np.random.default_rng(2)
        for c in range(3):
            items = host_chunk(torch, eager, rng, c).to(device)
            ts_e = {**ts_e, "buffer": eager.extend._write(ts_e["buffer"], items)}
            ts_g = {**ts_g, "buffer": graphed.extend._write(ts_g["buffer"], items)}
        poisons = [torch.full((), v, device=device) for v in (float("nan"), 0.0, float("nan"))]
        for i, poison in enumerate(poisons):
            items = host_chunk(torch, eager, rng, 3 + i).to(device)
            ts_e = {**ts_e, "buffer": eager.extend._write(ts_e["buffer"], items)}
            ts_g = {**ts_g, "buffer": graphed.extend._write(ts_g["buffer"], items)}
            inner, m_e = eager.updates(eager._inner(ts_e), poison=poison)
            ts_e = {**ts_e, **inner, "update_count": ts_e["update_count"] + cfg["utd_ratio"]}
            ts_g, m_g = graphed.k_updates(ts_g, poison=poison)
            equal_trees(torch, (m_g, ts_g), (m_e, ts_e), f"resilience: chaos K-update {i}")
            for a, b in zip(eager._hidden_state(), graphed._hidden_state()):
                require(torch.equal(a, b), f"resilience: chaos K-update {i}: a parameter, "
                        "target or Adam moment differs between replay and eager")
        stats = program_stats(graphed.k_chaos_program)
        per_replay = None
        if device == "cuda":
            require(stats["compiles"] == stats["executables"] == 1 and stats["replays"] == 3,
                    f"resilience: the chaos K-update's graph {stats}")
            # one more replay, traced: B7 once an update
            prog = graphed.k_chaos_program
            prof = profile_seen(torch, lambda: graphed.k_updates(
                ts_g, poison=torch.zeros((), device=device)), what=prog.name)
            require(prog.stats["replays"] == 3 + prof["calls"],
                    f"{prog.name}: a profiled call was not one replay")
            per_replay = prof["path_kernel_launches"]
            require(per_replay.get("sumtree_update") == cfg["utd_ratio"],
                    f"resilience: a chaos K-update replay launched B7 "
                    f"{per_replay.get('sumtree_update')} times, not {cfg['utd_ratio']}")

        def bad_steps(ts):
            snap = DeviceMetrics.drain(DeviceMetrics.drain_async(ts["obs"]))
            return eager.device_metrics.to_flat(snap)["bad_steps"]

        bad_before = bad_steps(ts_e)
        before = [t.clone() for t in eager._hidden_state()]
        # a new NaN: the graph took poisons[0] as its own input at the
        # capture, and the replays since copied their poisons into it
        bstate, dm, _ = eager._update(ts_e["buffer"], ts_e["obs"], ts_e["generator"],
                                      ts_e["update_count"],
                                      poison=torch.full((), float("nan"), device=device))
        unchanged = all(torch.equal(a, b) for a, b in zip(before, eager._hidden_state()))
        require(unchanged, "resilience: a poisoned update moved a parameter, target or Adam")
        counted = bad_steps({"obs": dm}) - bad_before
        require(counted == 1.0, f"resilience: a poisoned update counted {counted} bad steps")
        return {"chaos_replays_equal_eager": 3, "poisoned_bad_steps_in_the_three": bad_before,
                "poisoned_update_leaves_state": unchanged, "bad_steps_counted": counted,
                "chaos_program": program_stats(graphed.k_chaos_program),
                "chaos_replay_launches": per_replay}
    finally:
        for tr in (eager, graphed):
            tr.collector.pool.close()


def async_chaos_run(torch, device, cfg, rcfg) -> dict:
    """The async trainer's ``train`` under the injector (a NaN at one
    K-update dispatch, a crash of the actor loop), with a ``LastGoodState``
    guard and a ``Supervisor``."""
    from rl_tpu_torch.compile.registry import _flatten
    from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
    from rl_tpu_torch.resilience import Fault, FaultInjector, LastGoodState, Supervisor, injection

    reg = MetricsRegistry()
    sup = Supervisor(backoff_base_s=0.0, jitter=0.0, registry=reg, tracer=TraceRecorder())
    tr = make_async(torch, device, cfg, metrics=reg, supervisor=sup)
    guard = LastGoodState(rollback_after=1, snapshot_interval=1, registry=reg,
                          tracer=TraceRecorder())
    inj = FaultInjector({"offpolicy.update": Fault("nan", at=(rcfg["poison_dispatch"],)),
                         "collector.actor_loop": Fault("crash", at=(rcfg["crash_iteration"],))},
                        registry=reg, tracer=TraceRecorder())
    frames, restored, t0 = 0, [], time.perf_counter()
    try:
        ts = tr.init(seed=0)
        with injection(inj):
            tr.aot_warmup(ts)  # the chaos K-update too, before the actor thread starts
            for ts, _ in tr.train(ts, rcfg["async_frames"], guard=guard, batch_timeout=120.0):
                frames += cfg["frames_per_batch"]
                if guard.rollbacks > len(restored):  # the live state is the snapshot now
                    live, snap = [], []
                    _flatten(tr._guarded(), live)
                    _flatten(guard._snap, snap)
                    restored.append(len(live) == len(snap) and all(
                        torch.equal(x, y) for x, y in zip(live, snap)))
        flat = tr.publish_device_metrics(ts)
        restarts = sup.restarts("async-collector")
    finally:
        tr.collector.pool.close()
        sup.stop(timeout=30.0)
    out = {"frames": frames, "seconds": time.perf_counter() - t0, "rollbacks": guard.rollbacks,
           "rollback_restored_snapshot": restored, "bad_steps": flat["bad_steps"],
           "updates_on_device": flat["updates"], "actor_restarts": restarts,
           "fired": [list(f) for f in inj.fired],
           "chaos_program": program_stats(tr.k_chaos_program),
           "plain_program": program_stats(tr.k_program)}
    require(frames == rcfg["async_frames"], f"resilience: the chaos run ended at {frames} frames")
    require(guard.rollbacks == 1 and restored == [True],
            f"resilience: rollbacks {guard.rollbacks}, snapshot restored {restored}")
    require(flat["bad_steps"] == 1, f"resilience: {flat['bad_steps']} bad steps, not 1")
    require(restarts == 1, f"resilience: the actor loop restarted {restarts} times, not 1")
    require(not any(c.is_alive() for c in sup.children()), "resilience: a supervised thread lives")
    # with the injector installed every dispatch takes the chaos graph
    require(out["plain_program"]["replays"] == 0,
            f"resilience: the plain K-update replayed {out['plain_program']['replays']} times")
    return out


def resilience_phase(torch, card, device="cuda", width=FULL_WIDTH, cfg=RESILIENCE,
                     async_cfg=ASYNC_OFFPOLICY):
    """Checkpoints and chaos on the card (module docstring, 7d). Launch
    counts: the wrappers' (eager work and the captures' runs) and, from
    the profiler, the graphs' replays: the GRPO updates' and engines'
    (:func:`grpo_replays`) and the chaos K-update's (one replay traced, B7
    once an update, times the replays of both trainers' chaos graphs)."""
    zero_launches()
    t0 = time.perf_counter()
    grpo = grpo_resume_gate(torch, device, width, cfg)
    t1 = time.perf_counter()
    gate = async_chaos_gate(torch, device, async_cfg)
    run = async_chaos_run(torch, device, async_cfg, cfg)
    t2 = time.perf_counter()
    counted = read_launches()
    replayed = dict(grpo["replayed"])
    if gate["chaos_replay_launches"] is not None:
        k_replays = gate["chaos_program"]["replays"] + run["chaos_program"]["replays"]
        add_counts(replayed, {k: v * k_replays for k, v in gate["chaos_replay_launches"].items()})
    launches = add_counts(dict(counted), replayed)
    emit({"phase": "resilience", "config": {**cfg, "width": width, "async": "7c's cell"},
          "grpo": grpo, "async_chaos_gate": gate, "async_chaos_run": run,
          "seconds": {"grpo": t1 - t0, "async": t2 - t1}, "launches": launches,
          "launches_counted_by_wrappers": counted, "launches_replayed": replayed, "card": card})
    restart = grpo["restart_new_process"]
    HEADLINES["resilience"] = {
        "save_s": grpo["save_s"], "save_mib": grpo["save_mib"],
        "restart_new_process_s": restart["popen_to_exit_s"],
        "restart_new_process_split_s": {k: restart[k] for k in (
            "import_s", "cuda_start_s", "build_and_update_capture_s", "load_s",
            "first_step_s")},
        "restart_lengths": [restart["prompt_len"], restart["max_new"]],
        "rebuild_in_process_to_first_step_s": grpo["rebuild_in_process_to_first_step_s"],
        "resumed_bit_equal": grpo["vs_uninterrupted"]["bit_equal"],
        "async_rollbacks": run["rollbacks"], "async_actor_restarts": run["actor_restarts"]}
    return launches


# The bench headline's program at its full shape (bench.py:60-66, tier
# "full"; the program at bench.py:225-281): 2048 CartPole envs x 32 steps,
# 64x64 actor and critic, ClipPPO with GAE(0.99, 0.95), 4 epochs of
# minibatch 8192 (32 clipped Adam updates a step), float32.
PPO = dict(n_envs=2048, frames_per_batch=65536, num_cells=(64, 64), num_epochs=4,
           minibatch_size=8192, gamma=0.99, lmbda=0.95)
PPO_STEPS = 8  # bench.py:63, TRAIN_STEPS at the full tier
# ppo_check: one update_from_batch on the card and the same on the CPU (64
# envs x 32 steps, minibatch 512: 16 updates). The loss and the first
# minibatch's gradients go through one forward and backward each, whose
# float32 products cuBLAS and the CPU sum in other orders (~1e-6
# relative); the parameters after 16 Adam steps move by at most ~16 x lr x
# that where no gradient sits at 0 (a sign flip there would move a weight
# by lr = 3e-4, and fails the check).
PPO_CHECK = dict(PPO, n_envs=64, frames_per_batch=2048, minibatch_size=512)
PPO_CHECK_LOSS = (1e-5, 1e-6)  # rtol, atol
PPO_CHECK_GRADS = (1e-4, 1e-6)
PPO_CHECK_PARAMS = (1e-4, 1e-5)
# ppo_learn: the README quick start (README.md:42-51); the gate is the
# reference's own margin (tests/test_collector_ppo.py:83-103)
PPO_LEARN = dict(n_envs=32, frames_per_batch=2048, total_steps=100, margin=20.0)


def make_ppo(torch, cfg=PPO, **config):
    """The bench headline's program, through the port's entry points;
    ``config``: more ``OnPolicyConfig`` fields (the anneal)."""
    from rl_tpu_torch.collectors import Collector
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.modules import (MLP, Categorical, ProbabilisticActor, TDModule,
                                      ValueOperator)
    from rl_tpu_torch.objectives import ClipPPOLoss
    from rl_tpu_torch.trainers import OnPolicyConfig, OnPolicyProgram

    env = TransformedEnv(VmapEnv(CartPoleEnv(), cfg["n_envs"]), RewardSum())
    cells = cfg["num_cells"]
    actor = ProbabilisticActor(
        TDModule(MLP(out_features=2, num_cells=cells), ["observation"], ["logits"]),
        Categorical, dist_keys=("logits",))
    critic = ValueOperator(MLP(out_features=1, num_cells=cells))
    loss = ClipPPOLoss(actor, critic, normalize_advantage=True)
    loss.make_value_estimator(gamma=cfg["gamma"], lmbda=cfg["lmbda"])
    coll = Collector(env, actor, frames_per_batch=cfg["frames_per_batch"])
    return OnPolicyProgram(coll, loss, OnPolicyConfig(num_epochs=cfg["num_epochs"],
                                                      minibatch_size=cfg["minibatch_size"],
                                                      **config))


def profile_ppo_step(torch, program, ts):
    """One train step under ``torch.profiler``: the device's busy time and
    idle share against the step's wall clock, its kernel launches, and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        ts, _ = program.train_step(ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return ts, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms,
                "device_launches": sum(n for _, n in kernels.values()),
                "top_device_ms": [{"kernel": k[:80], "ms": ms, "count": n}
                                  for k, (ms, n) in top]}


def ppo_phase(torch, card, device="cuda", cfg=PPO, steps=PPO_STEPS, split_steps=3):
    """The bench headline's program on the card: one warm-up step, then
    ``steps`` counted steps (env steps/s; every kernel's count set to 0
    before and read after), ``split_steps`` steps split into collect,
    advantage and update seconds (synchronised between the parts), one
    profiled step. Gates: every metric of the counted steps finite, the
    parameters moved."""
    program = make_ppo(torch, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    ts = program.init(gen)
    sync(torch, device)
    init_s = time.perf_counter() - t0
    start = [p.detach().clone() for p in program.loss.parameters()]
    t0 = time.perf_counter()
    ts, first = program.train_step(ts)  # warm-up (cuBLAS handles, allocator)
    sync(torch, device)
    warmup_s = time.perf_counter() - t0

    zero_launches()
    t0 = time.perf_counter()
    counted = []
    for _ in range(steps):
        ts, metrics = program.train_step(ts)
        counted.append(metrics)
    sync(torch, device)
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    frames = cfg["frames_per_batch"]

    split = []
    for _ in range(split_steps):
        t0 = time.perf_counter()
        batch, cstate = program.collector.collect(ts["collector"])
        sync(torch, device)
        t1 = time.perf_counter()
        batch = program.advantage(batch)
        sync(torch, device)
        t2 = time.perf_counter()
        ts, metrics = program.update_from_batch({**ts, "collector": cstate}, batch)
        sync(torch, device)
        split.append({"collect_s": t1 - t0, "advantage_s": t2 - t1,
                      "update_s": time.perf_counter() - t2})
    prof = None
    if torch.device(device).type == "cuda":
        ts, prof = profile_ppo_step(torch, program, ts)

    per_step = [{k: v.item() for k, v in m.items()} for m in counted]
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(program.loss.parameters(), start))
    report = {
        "config": {**cfg, "num_cells": list(cfg["num_cells"]), "dtype": "float32",
                   "env": f"TransformedEnv(VmapEnv(CartPoleEnv(), {cfg['n_envs']}), "
                          "RewardSum())", "source": "bench.py:60-66,225-281 (full tier)"},
        "init_s": init_s, "warmup_s": warmup_s, "steps": steps, "loop_s": loop_s,
        "env_steps_per_s": steps * frames / loop_s, "step_s_mean": loop_s / steps,
        "updates_per_step": program.num_minibatches * cfg["num_epochs"],
        "split": split, "profiled_step": prof, "launches": launches,
        "warmup_metrics": {k: v.item() for k, v in first.items()},
        "metrics_by_step": per_step, "max_param_move": moved, "card": card,
    }
    emit({"phase": "ppo", **report})
    require(all(np.isfinite(v) for m in per_step for v in m.values()),
            "ppo: a metric of a counted step is not finite")
    require(moved > 0.0, "ppo: no parameter moved")
    HEADLINES["ppo"] = {
        "env_steps_per_s": report["env_steps_per_s"],
        "step_ms_mean": report["step_s_mean"] * 1e3,
        "split_ms_mean": {k[:-2]: statistics.mean(s_[k] for s_ in split) * 1e3
                          for k in split[0]},
        **{k: (prof or {}).get(k) for k in ("device_busy_ms", "device_idle_share",
                                            "device_launches")},
        "episode_reward_mean_last": per_step[-1]["episode_reward_mean"],
    }
    return launches


def ppo_cpu_check(torch, device="cuda", cfg=PPO_CHECK):
    """One ``update_from_batch`` on the card and the same on the CPU: one
    set of weights, one batch (collected on the card), one permutation
    per epoch. The loss of the first minibatch, its gradients and the
    final parameters within the stated limits."""
    card, cpu = make_ppo(torch, cfg), make_ppo(torch, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    ts = card.init(gen)
    batch, cstate = card.collector.collect(ts["collector"])
    cts = cpu.init(torch.Generator().manual_seed(1))
    cpu.loss.load_state_dict({k: v.cpu() for k, v in card.loss.state_dict().items()})
    n = cfg["frames_per_batch"]
    perms = [torch.randperm(n, generator=torch.Generator().manual_seed(e))
             for e in range(cfg["num_epochs"])]
    first = perms[0][: cfg["minibatch_size"]]
    results = {}
    for name, prog, state, b in (("card", card, ts, batch), ("cpu", cpu, cts, batch.to("cpu"))):
        adv = prog.advantage(b)
        loss_val, grads, _ = prog.loss.grad(adv.flatten_batch()[first.to(b["action"].device)])
        _, metrics = prog.update_from_batch(state, adv, permutations=perms)
        results[name] = (loss_val, grads, metrics)
    sync(torch, device)

    (lg, gg, mg), (lc, gc, mc) = results["card"], results["cpu"]
    names = [nm for nm, _ in cpu.loss.trainable_parameters()]
    loss_excess = excess(lg.cpu(), lc, PPO_CHECK_LOSS)
    grad_excess = max((excess(a.cpu(), b, PPO_CHECK_GRADS), nm)
                      for a, b, nm in zip(gg, gc, names))
    gsd, csd = card.loss.state_dict(), cpu.loss.state_dict()
    param_excess = max((excess(gsd[nm].cpu(), csd[nm], PPO_CHECK_PARAMS), nm) for nm in csd)
    report = {"updates": card.num_minibatches * cfg["num_epochs"],
              "config": {k: cfg[k] for k in ("n_envs", "frames_per_batch", "minibatch_size",
                                              "num_epochs")},
              "loss_card": lg.item(), "loss_cpu": lc.item(),
              "loss_excess_over_tol": loss_excess, "loss_tol": PPO_CHECK_LOSS,
              "worst_grad_excess_over_tol": grad_excess[0], "worst_grad": grad_excess[1],
              "grads_tol": PPO_CHECK_GRADS,
              "worst_param_excess_over_tol": param_excess[0], "worst_param": param_excess[1],
              "params_tol": PPO_CHECK_PARAMS,
              "max_param_diff": max((gsd[nm].cpu() - csd[nm]).abs().max().item() for nm in csd),
              "mean_loss_card": mg["loss"].item(), "mean_loss_cpu": mc["loss"].item()}
    emit({"phase": "ppo_check", **report})
    require(loss_excess <= 0.0, f"ppo_check: loss {lg.item()} against {lc.item()}")
    require(grad_excess[0] <= 0.0, f"ppo_check: gradient of {grad_excess[1]} beyond tolerance")
    require(param_excess[0] <= 0.0, f"ppo_check: {param_excess[1]} beyond tolerance")
    HEADLINES["ppo_check"] = {k: report[k] for k in (
        "loss_excess_over_tol", "worst_grad_excess_over_tol", "worst_param_excess_over_tol",
        "max_param_diff")}


def ppo_learn_phase(torch, card, device="cuda", cfg=PPO_LEARN):
    """The README quick start on the card: ``make_ppo_trainer`` over 32
    CartPole envs, ``total_steps`` steps of 2048 frames; the mean
    ``episode_reward_mean`` of the last 5 steps beats the first 5's by more
    than the reference's margin (each window the mean of the steps in
    which an episode ended)."""
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.trainers.algorithms import make_ppo_trainer

    env = TransformedEnv(VmapEnv(CartPoleEnv(), cfg["n_envs"]), RewardSum())
    trainer = make_ppo_trainer(env, total_steps=cfg["total_steps"],
                               frames_per_batch=cfg["frames_per_batch"], device=device)
    rewards = []
    trainer.register_op("post_step", lambda tr, m: rewards.append(m["episode_reward_mean"]))
    zero_launches()
    t0 = time.perf_counter()
    trainer.train(0)
    sync(torch, device)
    train_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = torch.stack(rewards).tolist()
    # a step in which no episode ended reads NaN (no return to average; at
    # 500-step episodes over 32 envs x 64 steps that happens): each window
    # averages its readings, and needs at least 3 of its 5
    windows = [[r for r in w if np.isfinite(r)] for w in (per_step[:5], per_step[-5:])]
    require(all(len(w) >= 3 for w in windows),
            f"ppo_learn: fewer than 3 readings in a window of 5: {per_step}")
    early, late = (statistics.mean(w) for w in windows)
    report = {"config": {**cfg, "source": "README.md:42-51 (make_ppo_trainer defaults: "
                                           "256x256 nets, minibatch 256, 4 epochs)"},
              "train_s": train_s, "step_s_mean": train_s / cfg["total_steps"],
              "env_steps_per_s": cfg["total_steps"] * cfg["frames_per_batch"] / train_s,
              "episode_reward_mean_by_step": per_step, "first5_mean": early,
              "last5_mean": late, "launches": launches, "card": card}
    emit({"phase": "ppo_learn", **report})
    require(late > early + cfg["margin"],
            f"ppo_learn: did not learn (first 5 {early:.1f}, last 5 {late:.1f})")
    HEADLINES["ppo_learn"] = {k: report[k] for k in ("first5_mean", "last5_mean", "train_s")}
    return launches


# -- the pipelined GRPO loop ------------------------------------------------


def pipeline_phase(torch, card, device="cuda", width=FULL_WIDTH, steps=1, prompt_len=512,
                   max_new=512, microbatch=8, sequential=SEQUENTIAL):
    """``PipelinedGRPOTrainer(max_pending=1)`` at the train phase's
    configuration: one warm-up step, then ``steps`` counted steps. Per
    step the consumer's wait in ``get``, the update (the consumer's stream
    synchronised, not the producer's), the producer's collect (host
    seconds, timed in its thread) and the cycle; ``overlap_frac`` as
    ``bench.py:1288-1290`` defines it, and the tokens a cycle beside the
    train phase's sequential collect plus update. Gates: staleness at most
    1 and 0 first, ``policy_version`` equal to the steps, no bad step,
    finite metrics, B1, B2, B4 and B5 launched, every serving copy equal to
    the master at the version it holds, and the first update equal to the
    train phase's first sequential update, bit for bit."""
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.models import TransformerConfig
    from rl_tpu_torch.trainers import PipelinedGRPOTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                            flash_decode=True)
    t_build = time.perf_counter()
    trainer = PipelinedGRPOTrainer(
        arithmetic_dataset(64), max_pending=1, model_config=cfg, num_prompts=2,
        group_repeats=8, max_prompt_len=prompt_len, max_new_tokens=max_new,
        microbatch_size=microbatch, continuous_batching=True, device=device)
    build_s = time.perf_counter() - t_build
    serving_dtypes = [p.dtype for p in trainer.scheme.target.parameters()]

    def cast_master():  # the master as a serving copy holds it (kept for the check)
        return [p.detach().to(dt, copy=True)
                for p, dt in zip(trainer.policy.parameters(), serving_dtypes)]

    history = {1: cast_master()}
    zero_launches()
    pipe = trainer._ensure_pipeline()  # the producer starts collecting here
    get = pipe.get
    waits = []

    def timed_get(*args, **kw):
        t0 = time.perf_counter()
        out = get(*args, **kw)
        waits.append(time.perf_counter() - t0)
        return out

    pipe.get = timed_get
    consumer = torch.cuda.current_stream() if device == "cuda" else None
    records, outs = [], []
    t_phase = time.perf_counter()
    try:
        for i in range(1 + steps):
            t0 = time.perf_counter()
            outs.append(trainer.step())
            if consumer is not None:
                consumer.synchronize()
            cycle = time.perf_counter() - t0
            history[trainer.scheme.version] = cast_master()
            if i == 0:
                first = [p.detach().clone() for p in trainer.policy.parameters()]
            records.append({"step": i, "cycle_s": cycle, "wait_s": waits[-1],
                            "update_s": cycle - waits[-1]})
        # after the counted steps: the overlap window under the profiler
        overlap_prof = None
        if device == "cuda":
            out, overlap_prof = profile_overlap(torch, trainer)
            outs.append(out)
            history[trainer.scheme.version] = cast_master()
    finally:
        trainer.close()
    sync(torch, device)
    phase_s = time.perf_counter() - t_phase
    launches = read_launches()
    for r in records:
        r["collect_s"] = pipe.collect_seconds[r["step"]]
    final = trainer.metrics_snapshot()
    # update k returns step k-1's metrics (lagged drain), the last from the snapshot
    step_metrics = (outs[1:] + [final])[:len(records)]
    for r, m in zip(records, step_metrics):
        r.update({k: m[k] for k in ("loss", "reward", "kl_approx", "bad_steps")})
    # every serving copy equals the master at the version it holds
    slots = trainer.scheme.slot_versions
    slot_ok = [all(torch.equal(p, q) for p, q in zip(model.parameters(), history[v]))
               for model, v in zip(trainer.scheme.targets, slots)]
    seq_first = sequential.get("first_update")
    first_equal = (seq_first is not None and len(seq_first) == len(first)
                   and all(torch.equal(a, b) for a, b in zip(first, seq_first)))
    first_diff = (None if seq_first is None else
                  max((a - b).abs().max().item() for a, b in zip(first, seq_first)))
    counted = records[1:]
    mean = lambda key: statistics.mean(r[key] for r in counted)  # noqa: E731
    gen_p, upd_p, cycle_p = mean("collect_s"), mean("update_s"), mean("cycle_s")
    overlap = max(0.0, (gen_p + upd_p - cycle_p) / max(1e-9, min(gen_p, upd_p)))
    tokens = 16 * (prompt_len + max_new)  # B x T through one cycle, bench.py:1292
    seq_steps = sequential.get("steps", [])[1:]  # after the train phase's warm-up step
    seq_cycle = (statistics.mean(s["collect_s"] + s["update_s"] for s in seq_steps)
                 if seq_steps else None)
    report = {
        "config": {**width, "dtype": "bfloat16", "attention_impl": "flash", "num_prompts": 2,
                   "group_repeats": 8, "max_prompt_len": prompt_len, "max_new_tokens": max_new,
                   "microbatch_size": microbatch, "max_pending": 1, "serving_copies": len(slots)},
        "build_s": build_s, "phase_s": phase_s, "steps": records,
        "staleness_history": trainer.staleness_history,
        "policy_version": trainer.policy_version.version, "bad_steps": final["bad_steps"],
        "mean_collect_s": gen_p, "mean_update_s": upd_p, "mean_cycle_s": cycle_p,
        "mean_wait_s": mean("wait_s"), "overlap_frac": overlap,
        "tokens_per_cycle": tokens, "tokens_per_s_pipelined": tokens / cycle_p,
        "sequential_cycle_s": seq_cycle,
        "tokens_per_s_sequential": tokens / seq_cycle if seq_cycle else None,
        "profiled_overlap": overlap_prof,
        "slot_versions": slots, "slots_equal_master": slot_ok,
        "first_update_equals_sequential": first_equal,
        "first_update_max_abs_diff": first_diff, "launches": launches, "card": card,
    }
    emit({"phase": "pipeline", **report})
    HEADLINES["pipeline"] = {k: report[k] for k in (
        "mean_cycle_s", "mean_collect_s", "mean_update_s", "mean_wait_s", "overlap_frac",
        "tokens_per_s_pipelined", "tokens_per_s_sequential", "staleness_history")}
    HEADLINES["pipeline"]["overlap_device_idle_share"] = (overlap_prof or {}).get(
        "device_idle_share")
    hist = trainer.staleness_history
    require(max(hist) <= 1 and hist[0] == 0, f"pipeline: staleness {hist}")
    taken = 1 + steps + (overlap_prof is not None)
    require(trainer.policy_version.version == taken,
            f"pipeline: policy version {trainer.policy_version.version}, not {taken}")
    require(final["bad_steps"] == 0, f"pipeline: {final['bad_steps']} bad steps")
    require(all(np.isfinite(v) for r in records for k, v in r.items() if k != "step"),
            f"pipeline: a metric is not finite: {records}")
    require(all(slot_ok), f"pipeline: a serving copy differs from its version: {slot_ok}")
    require(first_equal, f"pipeline: first update differs from the sequential one "
                         f"(max |diff| {first_diff})")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_flash_decode",
                 "fused_sample"):
        require(launches[name] > 0, f"{name} was not launched on the pipelined path")
    return launches


def profile_overlap(torch, trainer):
    """One more pipelined step whose update runs under ``torch.profiler``
    (device activity only) while the producer collects the next batch:
    the device's busy time in that window is the union of every kernel's
    span, on either stream; the idle share is the rest of the window's
    host wall. The consumer's wait in ``get`` lies outside the window.
    Returns the step's output and the reading."""
    from torch.profiler import ProfilerActivity, profile

    update = trainer.update
    seen = {}

    def profiled(batch):
        consumer = torch.cuda.current_stream()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = update(batch)
            consumer.synchronize()
            seen["wall_ms"] = (time.perf_counter() - t0) * 1e3
        seen["prof"] = prof
        return out

    trainer.update = profiled
    try:
        out = trainer.step()
    finally:
        del trainer.update
    spans = sorted((e.time_range.start, e.time_range.end) for e in seen["prof"].events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' spans (the two streams overlap)
        if b > end:
            busy_us += b - max(a, end)
            end = b
    wall = seen["wall_ms"]
    return out, {"update_wall_ms": wall, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": 1.0 - busy_us / 1e3 / wall, "kernels": len(spans)}


def pipeline_ab(torch, card, order="ABCDDCBAE", device="cuda", width=FULL_WIDTH,
                prompt_len=512, max_new=512, warmup=False):
    """Where the pipelined collect's time goes, in blocks of one call
    (``python3 chip_smoke.py pipeline_ab``, not part of the default run;
    ``pipeline_ab graphs`` runs blocks A B B A with both trainers built
    with ``warmup=True``: the updates captured, and every collect's engine
    decoding through CUDA graphs of the same registry).
    The train phase's configuration: a sequential ``GRPOTrainer`` and a
    ``PipelinedGRPOTrainer(max_pending=1)`` from the same seed, each warmed
    by one step. Block A: 2 sequential steps (collect, then update, the
    card synchronised around each). B: 3 pipelined steps as they run. C: B
    with the update's work removed (the consumer only pushes). D: B with
    the interpreter's GIL switch interval at 0.5 ms instead of 5. E: a
    sequential collect in this thread while the producer collects in its
    own. A pipelined block starts its producer afresh (its first batch
    overlaps no step) and ends with ``close``, which waits for the collect
    in flight; the collects of batches 1 and 2 overlapped a step. The
    blocks run in ``order`` (mirrored, so a drift of the host's speed
    over the call weighs on each kind alike); last, each kind's mean."""
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.models import TransformerConfig
    from rl_tpu_torch.trainers import GRPOTrainer, PipelinedGRPOTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                            flash_decode=True)
    kw = dict(model_config=cfg, num_prompts=2, group_repeats=8, max_prompt_len=prompt_len,
              max_new_tokens=max_new, microbatch_size=8, continuous_batching=True, device=device,
              warmup=warmup)
    seq = GRPOTrainer(arithmetic_dataset(64), **kw)
    pipe = PipelinedGRPOTrainer(arithmetic_dataset(64), max_pending=1, **kw)
    seq.step()
    pipe.step()
    pipe.close()
    sync(torch, device)

    def sequential_collect():
        sync(torch, device)
        t0 = time.perf_counter()
        batch = seq.collect()
        sync(torch, device)
        return batch, time.perf_counter() - t0

    interval = sys.getswitchinterval()
    blocks = []
    for kind in order:
        if kind == "A":
            steps = []
            for _ in range(2):
                batch, collect_s = sequential_collect()
                t0 = time.perf_counter()
                seq.update(batch)
                sync(torch, device)
                steps.append({"collect_s": collect_s, "update_s": time.perf_counter() - t0})
            rec = {"steps": steps, "collects_s": [s["collect_s"] for s in steps]}
        elif kind == "E":
            producer = pipe._ensure_pipeline()  # its first collect starts now
            _, collect_s = sequential_collect()
            pipe.close()
            rec = {"sequential_collect_s": collect_s,
                   "producer_collects_s": producer.collect_seconds,
                   "collects_s": [collect_s] + producer.collect_seconds}
        else:
            sys.setswitchinterval(0.0005 if kind == "D" else interval)
            if kind == "C":
                pipe._update = lambda batch: None
            producer = pipe._ensure_pipeline()
            cycles = []
            try:
                for _ in range(3):
                    t0 = time.perf_counter()
                    pipe.step()
                    if device == "cuda":
                        torch.cuda.current_stream().synchronize()
                    cycles.append(time.perf_counter() - t0)
                pipe.close()
            finally:
                sys.setswitchinterval(interval)
                pipe.__dict__.pop("_update", None)
            rec = {"cycles_s": cycles, "producer_collects_s": producer.collect_seconds,
                   "collects_s": producer.collect_seconds[1:3]}
        emit({"phase": "pipeline_ab", "kind": kind, **rec})
        blocks.append((kind, rec["collects_s"]))
    means = {}
    for kind in sorted(set(order)):
        vals = [v for k, vs in blocks if k == kind for v in vs]
        means[kind] = {"collect_s_mean": statistics.mean(vals), "collect_s_min": min(vals),
                       "collect_s_max": max(vals), "n": len(vals)}
    emit({"phase": "pipeline_ab_summary", "order": order, "collects_by_kind": means,
          "card": card})


# -- DQN on CartPole with device PER ------------------------------------------

# examples/dqn_cartpole.py as written: 16 CartPole envs with RewardSum,
# make_dqn_trainer's defaults (256x256 q-net, double DQN, MultiStep(0.99,
# 3), epsilon 1.0 -> 0.05 over 100k, a 1M-slot DeviceStorage sampled by
# PrioritizedSampler with "td_error" written back), 512 frames a batch,
# batch 256, UTD 4, lr 1e-3, tau 0.01, 2000 random frames; 200 of the
# example's 300 steps (the whole run keeps within its time).
DQN = dict(n_envs=16, frames_per_batch=512, batch_size=256, utd_ratio=4, learning_rate=1e-3,
           tau=0.01, init_random_frames=2000, total_steps=200)
# dqn_check: 4 updates on the card against the same 4 on the CPU. The
# reasoning of the SAC check holds (CPU_CHECK_PARAMS, CPU_CHECK_TREE);
# CartPole's returns at gamma 0.99 reach 100, so a td-error is a
# difference of Q values up to ~100 that agree to ~2e-6 relative: leaves
# are compared as td-errors within an absolute 5e-4.
DQN_CHECK_TD = (1e-4, 5e-4)  # rtol, atol
# dqn_learn: the reference's own learning check (tests/test_offpolicy.py:
# 187-219): 8 CartPole envs capped at 200 steps, a 64x64 q-net, 128 frames
# a batch, a uniform 20k buffer, batch 128, UTD 8, tau 0.01, epsilon 1.0
# -> 0.05 over 2000, 1000 random frames, 60 steps; the last 10 steps' mean
# episode reward beats the first 10's by more than 15.
DQN_LEARN = dict(n_envs=8, max_episode_steps=200, num_cells=(64, 64), frames_per_batch=128,
                 capacity=20_000, batch_size=128, utd_ratio=8, learning_rate=1e-3, tau=0.01,
                 init_random_frames=1000, annealing_num_steps=2000, total_steps=60,
                 margin=15.0)


def make_dqn(torch, device, cfg=DQN):
    """``examples/dqn_cartpole.py``'s trainer, through the port's entry
    points, with the program's device metrics on (they count bad steps)."""
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.trainers import OffPolicyConfig, default_device_metrics, make_dqn_trainer

    env = TransformedEnv(VmapEnv(CartPoleEnv(), cfg["n_envs"]), RewardSum())
    trainer = make_dqn_trainer(
        env, total_steps=cfg["total_steps"], frames_per_batch=cfg["frames_per_batch"],
        config=OffPolicyConfig(batch_size=cfg["batch_size"], utd_ratio=cfg["utd_ratio"],
                               learning_rate=cfg["learning_rate"], tau=cfg["tau"],
                               init_random_frames=cfg["init_random_frames"]),
        device=device)
    trainer.program.device_metrics = default_device_metrics()
    return trainer


def dqn_phase(torch, card, device="cuda", cfg=DQN, split_steps=3):
    """``examples/dqn_cartpole.py`` on the card: ``Trainer.train(0)``
    (init, 2000 random frames, ``total_steps`` steps) with every kernel's
    count set to 0 before and read after; env steps/s and updates/s over
    the steps; 3 more steps split into collect, extend and updates; one
    profiled step. Gates: finite metrics, no bad step, B7 launched
    ``utd_ratio`` times a step, every block sum within ESUM_RTOL of its
    leaves' sum. Returns the counts, the program and its train state
    (``dqn_check`` goes on from them)."""
    trainer = make_dqn(torch, device, cfg)
    program = trainer.program
    marks, metrics = {}, []
    trainer.register_op("pre_step", lambda tr: marks.setdefault("start", time.perf_counter()))
    trainer.register_op("post_step", lambda tr, m: metrics.append(m))
    zero_launches()
    t0 = time.perf_counter()
    ts = trainer.train(0)
    sync(torch, device)
    t_end = time.perf_counter()
    launches = read_launches()
    steps = trainer.step_count
    loop_s = t_end - marks["start"]
    setup_s = marks["start"] - t0

    split = []
    for _ in range(split_steps):
        t0 = time.perf_counter()
        batch, cstate = program.collector.collect(ts["collector"])
        sync(torch, device)
        t1 = time.perf_counter()
        bstate = program.buffer.extend(ts["buffer"], program._flatten(batch),
                                       n=cfg["frames_per_batch"])
        sync(torch, device)
        t2 = time.perf_counter()
        ts, _ = program.updates({**ts, "collector": cstate, "buffer": bstate})
        sync(torch, device)
        split.append({"collect_s": t1 - t0, "extend_s": t2 - t1,
                      "updates_s": time.perf_counter() - t2})
    prof = None
    if device == "cuda":
        ts, prof = profile_train_step(torch, program, ts)

    per_step = {k: torch.stack([m[k] for m in metrics]).tolist() for k in metrics[0].keys()}
    flat = program.publish_device_metrics(ts)
    leaves = ts["buffer"]["sampler", "priorities"]
    fanout = program.buffer.sampler.fanout
    fresh = leaves.view(-1, fanout).sum(-1)
    esum = ts["buffer"]["sampler", "esum"]
    esum_rel = ((esum - fresh).abs() / fresh.abs().clamp_min(1e-30)).max().item()
    rewards = [r for r in per_step["episode_reward_mean"] if np.isfinite(r)]
    report = {
        "config": {**cfg, "env": f"TransformedEnv(VmapEnv(CartPoleEnv(), {cfg['n_envs']}), "
                                 "RewardSum())", "source": "examples/dqn_cartpole.py",
                   "trainer": "make_dqn_trainer defaults (256x256, double DQN, MultiStep(0.99,"
                              " 3), EGreedy 1.0->0.05/100k, DeviceStorage(1M) + PER)"},
        "setup_s": setup_s, "steps": steps, "loop_s": loop_s,
        "env_steps_per_s": steps * cfg["frames_per_batch"] / loop_s,
        "updates_per_s": steps * cfg["utd_ratio"] / loop_s, "step_s_mean": loop_s / steps,
        "split": split, "profiled_step": prof, "launches": launches,
        "sumtree_update_launches_per_step": launches["sumtree_update"] / steps,
        "bad_steps": flat["bad_steps"], "updates": flat["updates"],
        "td_error_hist": flat["td_error"], "buffer_size": int(ts["buffer"]["storage", "size"]),
        "eg_step": int(ts["collector"]["carry"]["exploration", "eg_step"]),
        "esum_max_rel_err": esum_rel, "esum_rtol": ESUM_RTOL,
        "episode_reward_mean_first10": per_step["episode_reward_mean"][:10],
        "episode_reward_mean_last10": per_step["episode_reward_mean"][-10:],
        "loss_last": per_step["loss"][-1], "q_mean_last": per_step["q_mean"][-1], "card": card,
    }
    emit({"phase": "dqn", **report})
    require(all(np.isfinite(v) for k, vs in per_step.items() if k != "episode_reward_mean"
                for v in vs), "dqn: a metric of a step is not finite")
    require(len(rewards) > 0, "dqn: no episode ended in any step")
    require(flat["bad_steps"] == 0, f"dqn: {flat['bad_steps']} bad steps")
    require(launches["sumtree_update"] == steps * cfg["utd_ratio"],
            f"dqn: sumtree_update launched {launches['sumtree_update']} times in {steps} "
            f"steps of {cfg['utd_ratio']} updates")
    require(esum_rel <= ESUM_RTOL, f"dqn: block sums drift {esum_rel} > {ESUM_RTOL}")
    HEADLINES["dqn"] = {
        "env_steps_per_s": report["env_steps_per_s"], "updates_per_s": report["updates_per_s"],
        "step_ms_mean": report["step_s_mean"] * 1e3,
        "split_ms_mean": {k[:-2]: statistics.mean(s_[k] for s_ in split) * 1e3
                          for k in split[0]},
        **{k: (prof or {}).get(k) for k in ("device_busy_ms", "device_idle_share",
                                            "device_launches", "sumtree_update_ms_per_launch")},
        "sumtree_update_launches": launches["sumtree_update"],
    }
    return launches, program, ts


def dqn_cpu_check(torch, program, ts, cfg):
    """``utd_ratio`` (4) updates on the card (B7) and the same on the CPU
    (its plain version) from the dqn phase's state and one set of sampler
    draws: the same sampled indices; parameters, targets, leaves (as
    td-errors), block sums and max_priority within the stated limits.
    Every kernel's count is set to 0 before the card's updates and read
    after them."""
    cpu = make_dqn(torch, "cpu", cfg).program
    rng = np.random.default_rng(12)
    draws = [(torch.from_numpy(rng.random(cfg["batch_size"], dtype=np.float32)),)
             for _ in range(cfg["utd_ratio"])]
    report = card_cpu_updates(torch, program, ts, cpu, draws, cpu.buffer.sampler.alpha,
                              DQN_CHECK_TD)
    emit({"phase": "dqn_check", **report})
    HEADLINES["dqn_check"] = {k: report[k] for k in (
        "indices_equal", "worst_param_excess_over_tol", "max_param_diff")}
    require(report["indices_equal"], "dqn_check: the card and the CPU sampled other indices")
    require(report["worst_param_excess_over_tol"] <= 0.0,
            f"dqn_check: {report['worst_param']} beyond tolerance")
    tree = report["tree_excess_over_tol"]
    require(all(v <= 0.0 for v in tree.values()), f"dqn_check: PER tree {tree}")
    return report["launches"]


def dqn_learn_phase(torch, card, device="cuda", cfg=DQN_LEARN):
    """The reference's DQN learning check on the card, through
    ``make_dqn_trainer`` (uniform replay, no n-step: the check's own
    program): the mean ``episode_reward_mean`` of the last 10 steps beats
    the first 10's by more than 15 (each window the mean of its finite
    readings, as ``np.nanmean``)."""
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.modules import MLP, TDModule
    from rl_tpu_torch.trainers import OffPolicyConfig, make_dqn_trainer

    env = TransformedEnv(VmapEnv(CartPoleEnv(max_episode_steps=cfg["max_episode_steps"]),
                                 cfg["n_envs"]), RewardSum())
    trainer = make_dqn_trainer(
        env, total_steps=cfg["total_steps"],
        qnet=TDModule(MLP(out_features=2, num_cells=cfg["num_cells"]), ["observation"],
                      ["action_value"]),
        buffer_capacity=cfg["capacity"], frames_per_batch=cfg["frames_per_batch"],
        config=OffPolicyConfig(batch_size=cfg["batch_size"], utd_ratio=cfg["utd_ratio"],
                               learning_rate=cfg["learning_rate"], tau=cfg["tau"],
                               init_random_frames=cfg["init_random_frames"]),
        prioritized=False, n_step=None, annealing_num_steps=cfg["annealing_num_steps"],
        device=device)
    rewards = []
    trainer.register_op("post_step", lambda tr, m: rewards.append(m["episode_reward_mean"]))
    zero_launches()
    t0 = time.perf_counter()
    trainer.train(0)
    sync(torch, device)
    train_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = torch.stack(rewards).tolist()
    windows = [[r for r in w if np.isfinite(r)] for w in (per_step[:10], per_step[-10:])]
    require(all(windows), f"dqn_learn: a window of 10 steps has no reading: {per_step}")
    early, late = (statistics.mean(w) for w in windows)
    report = {"config": {**cfg, "num_cells": list(cfg["num_cells"]),
                         "source": "tests/test_offpolicy.py:187-219"},
              "train_s": train_s, "episode_reward_mean_by_step": per_step,
              "first10_mean": early, "last10_mean": late, "launches": launches, "card": card}
    emit({"phase": "dqn_learn", **report})
    HEADLINES["dqn_learn"] = {k: report[k] for k in ("first10_mean", "last10_mean", "train_s")}
    require(late > early + cfg["margin"],
            f"dqn_learn: did not learn (first 10 {early:.1f}, last 10 {late:.1f})")
    return launches


# -- per: device PER against the host segment tree ----------------------------

# bench.py:1566-1776 (bench_per) at its full tier: a 1M-slot tree, batch
# 256, 50 cycles a timed call, the best of 5 calls; then DQN on CartPole
# (the dqn cell) with each sampler for 30 steps.
PER = dict(capacity=1 << 20, batch=256, inner=50, reps=5, dqn_steps=30)

# The kernels' names as the profiler reports them, per wrapper: a replayed
# graph runs no Python (and the wrappers count nothing while a graph is
# captured), so its launches are counted from the trace. Each call
# launches one kernel of these names (B3, B4, B6: the split kernel; B5:
# its first kernel, or the top-k route's one).
PROFILE_NAMES = {
    "flash_fwd": ("flash_fwd_",), "flash_bwd_dq": ("flash_bwd_dq",),
    "flash_bwd_dkv": ("flash_bwd_dkv",), "flash_decode": ("flash_decode_split",),
    "paged_flash_decode": ("paged_decode_split",), "fused_sample": ("sample_chunk_stats",
                                                                    "fused_sample_topk"),
    "paged_flash_decode_int8": ("paged_decode_int8_split",),
    "sumtree_update": ("sumtree_segments", "sumtree_scan"),
}


def best_per_cycle(torch, cycle, inner, reps):
    """Seconds a cycle: ``inner`` cycles a timed call, ending in a
    synchronise, the best of ``reps`` calls after one warm-up cycle."""
    cycle()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            cycle()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def per_phase(torch, card, device="cuda", cfg=PER):
    """``bench_per`` on the port: the device cycle (sample, gather of the
    stored rows, td-error, write-back through B7) eagerly and as its CUDA
    graph (``jit_sample_and_update``), against the port's host tree
    serving the same device learner (indices up, td-errors down, the tree
    updated on the host) and the host tree alone (td-errors drawn on the
    host). ``per_on_device_speedup_vs_host_tree`` = host in-program over
    the eager device cycle, as in the bench. Then DQN on CartPole with
    each sampler. Gates: block sums within ESUM_RTOL, finite DQN metrics,
    no bad step."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
    from rl_tpu_torch.data import HostPrioritizedSampler, PrioritizedSampler

    cap, B, inner, reps = cfg["capacity"], cfg["batch"], cfg["inner"], cfg["reps"]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prio0 = torch.rand(cap, generator=gen, device=device) + 0.01
    data = torch.randn(cap, 8, generator=gen, device=device)

    def fake_td(idx, info=None):  # the learner: gather the rows, derive a priority
        return data[idx].sum(-1).abs() + 0.01

    sampler = PrioritizedSampler()
    st = sampler.init(cap, device)
    st = sampler.update_priority(st, torch.arange(cap, device=device), prio0,
                                 indices_sorted=True)
    size = torch.tensor(cap, device=device)
    box = {"st": st}
    zero_launches()

    def device_cycle():
        box["st"] = sampler.sample_and_update(box["st"], gen, B, size, cap, fake_td)[2]

    t_device = best_per_cycle(torch, device_cycle, inner, reps)
    prog = sampler.jit_sample_and_update(fake_td, B, cap,
                                         registry=ProgramRegistry(ExecutableStore()))

    def graph_cycle():
        box["st"] = prog(box["st"], gen, size)[2]

    t_graph = best_per_cycle(torch, graph_cycle, inner, reps)
    # the eager cycles and the capture's eager run, counted by the
    # wrappers; the replays, by the profiler
    launches = add_counts(read_launches(), replay_launches(torch, prog, graph_cycle))
    leaves, esum = box["st"]["priorities"], box["st"]["esum"]
    fresh = leaves.view(-1, sampler.fanout).sum(-1)
    esum_rel = ((esum - fresh).abs() / fresh.abs().clamp_min(1e-30)).max().item()

    host_gen = torch.Generator()  # the bench draws the host tree's uniforms on the host
    host_gen.manual_seed(1)
    trees = {}
    for where in (device, "cpu"):
        host = trees[where] = HostPrioritizedSampler(alpha=sampler.alpha, beta=sampler.beta,
                                                     eps=sampler.eps)
        host.init(cap, where)
        host.update_priority(None, np.arange(cap), prio0.cpu().numpy())
    rng = np.random.default_rng(0)

    def host_cycle():  # serving the device learner
        host = trees[device]
        idx, _, _ = host.sample(None, host_gen, B, cap, cap)
        host.update_priority(None, idx, fake_td(idx))

    def host_pure_cycle():  # the tree alone, td-errors drawn on the host
        host = trees["cpu"]
        idx, _, _ = host.sample(None, host_gen, B, cap, cap)
        host.update_priority(None, idx, rng.uniform(0.01, 1.01, B))

    t_host = best_per_cycle(torch, host_cycle, inner, reps)
    t_pure = best_per_cycle(torch, host_pure_cycle, inner, reps)

    dqn = {}
    for name in ("device", "host"):
        trainer = make_dqn(torch, device, dict(DQN, total_steps=cfg["dqn_steps"]))
        if name == "host":
            trainer.program.buffer.sampler = HostPrioritizedSampler()
        marks, metrics = {}, []
        trainer.register_op("pre_step", lambda tr: marks.setdefault("start", time.perf_counter()))
        trainer.register_op("post_step", lambda tr, m: metrics.append(m))
        ts = trainer.train(0)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - marks["start"]
        steps = trainer.step_count
        flat = trainer.program.publish_device_metrics(ts)
        losses = torch.stack([m["loss"] for m in metrics]).tolist()
        require(all(np.isfinite(v) for v in losses), f"per: dqn with the {name} sampler: "
                "a loss is not finite")
        require(flat["bad_steps"] == 0, f"per: dqn with the {name} sampler: "
                f"{flat['bad_steps']} bad steps")
        dqn[name] = {"steps": steps, "loop_s": loop_s,
                     "env_steps_per_s": steps * DQN["frames_per_batch"] / loop_s,
                     "updates_per_s": steps * DQN["utd_ratio"] / loop_s,
                     "step_ms_mean": loop_s / steps * 1e3, "loss_last": losses[-1]}
        del trainer, ts
    report = {
        "config": {**cfg, "source": "bench.py:1566-1776 (bench_per), full tier",
                   "sampler": "PrioritizedSampler(alpha=0.6, beta=0.4, fanout=16)",
                   "learner": "rows of a [capacity, 8] table gathered, |sum| + 0.01"},
        "per_on_device_speedup_vs_host_tree": t_host / t_device,
        "per_graph_speedup_vs_host_tree": t_host / t_graph,
        "device_fused_us_per_cycle": t_device * 1e6,
        "device_graph_us_per_cycle": t_graph * 1e6,
        "host_inprogram_us_per_cycle": t_host * 1e6,
        "host_pure_loop_us_per_cycle": t_pure * 1e6,
        "host_pure_loop_ratio": t_pure / t_device, "native_tree": trees["cpu"]._sum.IS_NATIVE,
        "esum_max_rel_err": esum_rel, "launches": launches, "dqn": dqn,
        "dqn_device_over_host_env_steps": (dqn["device"]["env_steps_per_s"]
                                           / dqn["host"]["env_steps_per_s"]),
        "card": card,
    }
    emit({"phase": "per", **report})
    require(esum_rel <= ESUM_RTOL, f"per: block sums drift {esum_rel} > {ESUM_RTOL}")
    HEADLINES["per"] = {k: report[k] for k in (
        "per_on_device_speedup_vs_host_tree", "per_graph_speedup_vs_host_tree",
        "device_fused_us_per_cycle", "device_graph_us_per_cycle", "host_inprogram_us_per_cycle",
        "host_pure_loop_us_per_cycle", "dqn_device_over_host_env_steps")}
    HEADLINES["per"]["dqn_env_steps_per_s"] = {k: v["env_steps_per_s"] for k, v in dqn.items()}
    return launches


# -- graphs: the registered programs captured as CUDA graphs -----------------

TRACE_MARGIN_S = 0.05  # host sleep before and after fn in a trace; doubled on each call again
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")
PROFILER_CALLS = {}  # what profile_seen traced -> the most calls it took


def profile_call(torch, fn, margin_s=TRACE_MARGIN_S):
    """One ``fn()`` under the profiler after a synchronise: wall ms,
    device busy ms, idle share, every device kernel launched (a replayed
    graph's kernels each count), and the path kernels' launches by name.
    ``margin_s`` of host sleep opens and closes the trace, outside the
    wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        time.sleep(margin_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin_s)
    kernels = device_kernels(torch, prof)
    busy = sum(ms for ms, _ in kernels.values())
    # what the host issued: kernel launches against whole-graph launches
    api = {e.key: e.count for e in prof.key_averages()
           if e.key in (*LAUNCH_CALLS, "cudaMemcpyAsync")}
    path = {name: sum(n for key, (_, n) in kernels.items() if any(s in key for s in needles)
                      and not (name == "paged_flash_decode" and "int8" in key))
            for name, needles in PROFILE_NAMES.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "device_launches": sum(n for _, n in kernels.values()), "host_api_calls": api,
            "path_kernel_launches": {k: v for k, v in path.items() if v}}


def profile_seen(torch, fn, tries=6, what="a profiled call", repeat=1):
    """:func:`profile_call` of ``fn``, made again (``tries`` calls at
    most, the margins doubled each time) while the trace holds no device
    kernel: every program profiled here launches some, and on the H100 a
    trace has held none of a short graph replay's (:func:`main` keeps
    CUPTI set up between traces against it). With ``repeat``, ``fn`` runs
    that many times in each trace (a graph of a few microseconds, such as
    an admission merge, lost its trace's kernels in 6 calls late in a
    run), a trace counts only where every path kernel's count divides by
    ``repeat`` (a trace may hold one copy or fill more than ``repeat``
    calls make: the path kernels alone are counted), and the counts
    returned are one call's. ``calls``: how many traces."""
    body = fn if repeat == 1 else (lambda: [fn() for _ in range(repeat)])
    seen = []
    for calls in range(1, tries + 1):
        out = profile_call(torch, body, margin_s=TRACE_MARGIN_S * 2 ** (calls - 1))
        whole = all(n % repeat == 0 for n in out["path_kernel_launches"].values())
        seen.append((out["device_launches"], out["path_kernel_launches"]))
        if out["device_launches"] and whole:
            break
    require(out["device_launches"] > 0 and whole,
            f"{what}: the profiler saw no device kernel, or not {repeat} whole calls of the "
            f"path kernels, in {tries} traces: (device launches, path kernels) {seen}")
    PROFILER_CALLS[what] = max(calls, PROFILER_CALLS.get(what, 0))
    if repeat > 1:
        out = {**out, "device_launches": out["device_launches"] // repeat,
               "path_kernel_launches": {k: v // repeat
                                        for k, v in out["path_kernel_launches"].items()}}
    return {**out, "calls": calls}


def replay_launches(torch, prog, call) -> dict:
    """The path kernels launched by every replay of ``prog``'s one graph:
    the profiler's count for one more replay (``call()``), times all the
    replays, that one included. Each replay of a graph launches the same
    kernels, and no wrapper counts them."""
    require(prog.program_count() == 1, f"{prog.name}: {prog.program_count()} graphs, not one")
    before = prog.stats["replays"]
    prof = profile_seen(torch, call, what=prog.name)
    require(prog.stats["replays"] == before + prof["calls"], f"{prog.name}: a profiled call "
            "was not one replay")
    return {k: v * prog.stats["replays"] for k, v in prof["path_kernel_launches"].items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def engine_programs(eng) -> list:
    """Every registered program of ``eng``: its decode chunks, prefills,
    copies and merge."""
    return list(eng._programs.values())


def engine_captures(eng) -> int:
    return sum(p.stats["compiles"] for p in engine_programs(eng))


def engine_replays(torch, eng, per_replay: dict, replays: dict | None = None) -> dict:
    """The path kernels launched by every replay of ``eng``'s programs: a
    program's launches of one replay times its replays (with ``replays``,
    times ``replays[id(program)]``, the replays of a window such as a
    fleet's traffic, read before the profiled ones; a program with none
    there is skipped). One replay of each
    program (name and fingerprint) is profiled, once for all the engines
    that share ``per_replay``: one more replay under ``no_grad`` as the
    engine calls it (the engine idle, the outputs dropped), of a decode
    chunk over the engine's own buffers and of an admission program that
    replayed in traffic over zeros shaped as its warm-up arguments
    (all-False token masks, block 0 onto itself: its writes land in
    scratch block 0). An admission program captured at its first call
    (no warm-up signature, as a trainer's collector engine captures them)
    has its one graph replayed as it stands, over its last call's inputs;
    that replay is not one of the program's, and rewrites what that call
    wrote, so only an engine that is done may be read so."""
    decode = (eng.model, eng.dev_table, eng.dev_lens, eng.dev_active, eng.dev_budget,
              eng.dev_last, eng._dev_run)
    total = {}
    for prog in engine_programs(eng):
        key = (prog.name, prog.fingerprint)
        n = prog.stats["replays"] if replays is None else replays.get(id(prog), 0)
        if replays is not None and not n:
            continue
        if key not in per_replay:
            raw = False
            if prog.name.startswith("serving.decode."):
                args = decode
            elif prog.stats["replays"] and prog.signatures:
                args = tuple(torch.zeros_like(x) if isinstance(x, torch.Tensor)
                             and x is not eng.dev_table else x for x in prog.signatures[0])
            elif prog.stats["replays"]:
                raw = True
                (entry,) = prog._registry.store._graphs[prog].values()
            else:
                continue
            require(prog.program_count() == 1, f"{prog.name}: {prog.program_count()} graphs")
            before = prog.stats["replays"]
            call = (entry.graph.replay if raw
                    else lambda p=prog, a=args: torch.no_grad()(p)(*a))
            # an admission program's replay is a few microseconds: 8 a trace
            repeat = 1 if prog.name.startswith("serving.decode.") else 8
            prof = profile_seen(torch, call, what=prog.name, repeat=repeat, tries=8)
            require(prog.stats["replays"] == before + (0 if raw else prof["calls"] * repeat),
                    f"{prog.name}: a profiled call was not one replay")
            per_replay[key] = prof["path_kernel_launches"]
            if replays is None:
                n = prog.stats["replays"]
        add_counts(total, {k: v * n for k, v in per_replay[key].items()})
    return total


def program_replays(engines) -> dict:
    """Each of ``engines``' programs' replays so far, by ``id``."""
    return {id(p): p.stats["replays"] for e in engines for p in engine_programs(e)}


def replays_between(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def window_utilization(window_s=2.0, every_ms=100) -> dict:
    """The card's busy share while other threads drive it, read through
    NVML rather than by a profiler (which this process would start
    while those threads launch graphs): ``nvidia-smi``'s
    ``utilization.gpu``, the share of its sample period (1/6 to 1 s) in
    which a kernel ran, every ``every_ms`` over ``window_s``."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                             "--format=csv,noheader,nounits", f"--loop-ms={every_ms}"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(window_s)
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
    busy = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    return {"window_s": window_s, "samples": len(busy), "utilization_pct": busy,
            "device_idle_share": 1.0 - statistics.mean(busy) / 100 if busy else None}


def ladder_reserved_mib(torch, make, *, private=False, decode_only=False) -> dict:
    """Device memory an engine's warmed program ladder holds: the
    allocator's reserved MiB after ``aot_warmup`` less before it (the
    engine's pools made before; freed cached blocks released around
    both). ``private``: one memory pool per graph, in place of the
    engine's one shared pool; ``decode_only``: no prefill (the decode
    chunk, the merge and, with a prefix cache, the copies)."""
    import gc

    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry

    eng = make(registry=ProgramRegistry(ExecutableStore()))
    if private:
        eng._graph_pool = None  # each program registered from here on gets its own pool
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    eng.aot_warmup(**({"admit_sizes": ()} if decode_only else {}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"reserved_mib": (torch.cuda.memory_reserved() - before) / 2**20,
           "graphs": engine_captures(eng)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def program_stats(prog) -> dict:
    return {**prog.stats, "executables": prog.program_count()}


def host_ms(torch, fn, n):
    """Wall ms a call over ``n`` calls, the card synchronised around them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def peak_mib(torch, fn):
    """``torch.cuda.max_memory_allocated`` over one ``fn()``, in MiB. A
    graph's private pool is reserved, not allocated, while no replay
    runs: :func:`reserved_mib` reads it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def reserved_mib(torch):
    return torch.cuda.memory_reserved() / 2**20


def equal_trees(torch, a, b, what):
    """Every tensor of ``a`` equals ``b``'s bit for bit (NaN where NaN)."""
    from rl_tpu_torch.compile.registry import _flatten

    la, lb = [], []
    require(_flatten(a, la) == _flatten(b, lb), f"graphs: {what}: the trees differ")
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            same = torch.equal(x, y) or bool(((x == y) | (x.isnan() & y.isnan())).all()) \
                if x.is_floating_point() else torch.equal(x, y)
            require(same, f"graphs: {what}: a tensor differs between replay and eager")


def compare_paths(torch, name, eager, graphed, n):
    """Eager against replay: host ms a call over ``n`` calls each, one
    profiled call each, peak device memory of one call each."""
    out = {}
    for path, fn in (("eager", eager), ("replay", graphed)):
        out[path] = {"host_ms_per_call": host_ms(torch, fn, n),
                     **profile_seen(torch, fn, what=f"{name} {path}"),
                     "peak_mib": peak_mib(torch, fn), "reserved_mib": reserved_mib(torch)}
    out["host_speedup"] = out["eager"]["host_ms_per_call"] / out["replay"]["host_ms_per_call"]
    return out


def anneal_and_c9_cases(torch, device, reg, ppo) -> dict:
    """The graphs phase's cases of the learning-rate anneal and C9 (module
    docstring, 14): the PPO step with ``anneal_lr_to`` through
    ``jit_train_step``, 3 replays against eager with the rate moving; the
    prioritized-slice write-back with repeated positions, the card
    against the CPU and a replay against eager."""
    report = {}
    # the PPO step with the learning-rate anneal: each update's rate is
    # computed in the update's graph from Adam's count on the card
    progs = [make_ppo(torch, ppo, anneal_lr_to=0.0, total_steps=80) for _ in range(2)]
    tss = []
    for p in progs:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        tss.append(p.init(g))
    step = progs[1].jit_train_step(registry=reg)
    rates = []
    for i in range(3):
        tss[0], m_e = progs[0].train_step(tss[0])
        tss[1], m_g = step(tss[1])
        equal_trees(torch, (m_g, tss[1]["collector"]), (m_e, tss[0]["collector"]),
                    f"ppo anneal step {i}")
        opt_e, opt_g = tss[0]["optimizer"], tss[1]["optimizer"]
        for a, b in zip(opt_e.params + opt_e.mu + opt_e.nu + [opt_e.count],
                        opt_g.params + opt_g.mu + opt_g.nu + [opt_g.count]):
            require(torch.equal(a, b), f"graphs: ppo anneal step {i}: a parameter or Adam differs")
        rates.append(float(progs[1].schedule(opt_g.count)))  # the next update's rate
    require(len(set(rates)) == 3, f"graphs: ppo anneal: the rate did not move: {rates}")
    report["ppo_anneal"] = {"program": program_stats(step.update.program),
                            "collect_program": program_stats(step.collect.program),
                            "updates": tss[1]["update_count"], "next_rates": rates}
    del progs, tss, step
    # C9: the prioritized-slice write-back with repeated positions (32
    # overlapping slices of 8) at 1M slots, card against CPU, replay
    # against eager
    from rl_tpu_torch.data import PrioritizedSliceSampler

    sampler, cap = PrioritizedSliceSampler(8), 1 << 20
    rng = np.random.default_rng(3)
    idx = torch.from_numpy((rng.integers(0, 64, 32)[:, None] + np.arange(8)).reshape(-1))
    states = [sampler.init(cap), sampler.init(cap, device), sampler.init(cap, device)]
    write = reg.register("replay.slice_priority_write",
                         lambda st, i, pr: sampler.update_priority(st, i, pr))
    for i in range(3):
        prio = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        states[0] = sampler.update_priority(states[0], idx, prio)
        states[1] = sampler.update_priority(states[1], idx.to(device), prio.to(device))
        states[2] = write(states[2], idx.to(device), prio.to(device))
        equal_trees(torch, states[2], states[1], f"c9 write {i}")
        equal_trees(torch, states[1].to("cpu"), states[0], f"c9 write {i}: card against CPU")
    report["c9_write"] = {"program": program_stats(write), "capacity": cap,
                          "writes": int(idx.numel()),
                          "repeated": int(idx.numel() - idx.unique().numel())}
    return report


def graphs_phase(torch, card, device="cuda", offpolicy=OFFPOLICY, dqn=DQN, ppo=PPO,
                 width=FULL_WIDTH, steps=5):
    """Each registered program on the card, eager against its CUDA graph,
    from two copies built alike (same seeds): the SAC step at the
    offpolicy cell's size and the DQN step at the dqn cell's
    (``jit_train_step``: collect, extend, 4 updates with B7), the PER cycle
    at 1M/256 (``jit_sample_and_update``), plain and with beta annealing,
    the engine at serving width over bf16 and int8 pools and behind the
    384-token system prompt with the prefix cache (``registry=``,
    ``warmup=True``: the decode chunk, B4, B5, B6, and the admission
    ladder, B5), the PPO update at the bench shape
    (``jit_update_from_batch``, permutations fed) and the whole PPO step
    (``jit_train_step``: the collect program, the permutations, the
    update program), and the GRPO update and ``evaluate``'s
    ``grpo.eval_gen`` (B3) at the train cell's shape
    (``GRPOTrainer(warmup=True)``; B1, B2) on one collected batch. Gates:
    every replay's state and outputs equal the eager run's bit for bit (3
    calls; the engines: every token and log-probs of 16 sampled requests,
    served in lockstep; ``evaluate`` before and after an update); one
    capture per program, and none in an engine's traffic after its
    warm-up. Then each path's host ms a call over ``steps`` calls
    (evaluate: 2 eager, 3 replayed),
    launches, busy and idle share of one profiled call, and peak device
    memory; the engines' host ms per admission round and the device
    memory their ladders reserve. The phase's launch counts: the
    wrappers' for eager work, :func:`replay_launches` for every replay."""
    from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry, set_program_registry
    from rl_tpu_torch.data import PrioritizedSampler
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM

    reg = ProgramRegistry(ExecutableStore())
    report = {}
    replayed = {}  # path kernel -> launches of every replay, from the profiler
    per_replay = {}  # (program name, fingerprint) -> path kernels of one replay
    seconds, t_last = {}, [time.perf_counter()]

    def lap(name):  # host seconds of each part of the phase, also on stderr as it goes
        sync(torch, device)
        now = time.perf_counter()
        seconds[name], t_last[0] = now - t_last[0], now
        print(f"graphs: {name} {seconds[name]:.1f} s", file=sys.stderr, flush=True)

    zero_launches()
    for name, make in (("sac", lambda: make_offpolicy(torch, device, offpolicy)),
                       ("dqn", lambda: make_dqn(torch, device, dqn).program)):
        progs = [make(), make()]
        states = [p.prefill(p.init(seed=0)) for p in progs]
        step = progs[1].jit_train_step(registry=reg)
        t0 = time.perf_counter()
        for i in range(3):
            states[0], m_e = progs[0].train_step(states[0])
            states[1], m_g = step(states[1])
            equal_trees(torch, (states[1], m_g), (states[0], m_e), f"{name} step {i}")
            for a, b in zip(progs[0].loss.parameters(), progs[1].loss.parameters()):
                require(torch.equal(a, b), f"graphs: {name} step {i}: a parameter differs")
        first3_s = time.perf_counter() - t0
        box = {"e": states[0], "g": states[1]}
        report[name] = {
            "first_three_calls_s": first3_s, "program": program_stats(step.program),
            **compare_paths(torch, name,
                            lambda: box.__setitem__("e", progs[0].train_step(box["e"])[0]),
                            lambda: box.__setitem__("g", step(box["g"])[0]), steps)}
        add_counts(replayed, replay_launches(torch, step.program,
                                             lambda: box.__setitem__("g", step(box["g"])[0])))
        del progs, states, step, box
        lap(name)
    # PER, then PER with beta annealed over 2 samples (beta 0.4, 0.7, 1.0)
    cap, B = PER["capacity"], PER["batch"]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    data = torch.randn(cap, 8, generator=gen, device=device)
    prio0 = torch.rand(cap, generator=gen, device=device) + 0.01
    fn = lambda idx, info: data[idx].sum(-1).abs() + 0.01  # noqa: E731
    for name, sampler in (("per", PrioritizedSampler()),
                          ("per_annealed", PrioritizedSampler(beta_annealing_steps=2))):
        sts = [sampler.update_priority(sampler.init(cap, device),
                                       torch.arange(cap, device=device), prio0,
                                       indices_sorted=True) for _ in range(2)]
        gens = [torch.Generator(device=device) for _ in range(2)]
        for g in gens:
            g.manual_seed(3)
        size = torch.tensor(cap, device=device)
        prog = sampler.jit_sample_and_update(fn, B, cap, registry=reg)
        drawn, betas = [], []
        for i in range(3):
            betas.append(float(sampler._beta(sts[1]["step"])))
            a = sampler.sample_and_update(sts[0], gens[0], B, size, cap, fn)
            b = prog(sts[1], gens[1], size)
            equal_trees(torch, b, a, f"{name} cycle {i}")
            sts = [a[2], b[2]]
            drawn.append(b[0])
        require(not torch.equal(drawn[0], drawn[1]), f"graphs: two {name} replays drew the "
                "same indices: the generator is not advanced by a replay")
        report[name] = {"program": program_stats(prog), "beta_per_call": betas}
        if name == "per_annealed":
            require(betas[0] < betas[1] < betas[2], f"graphs: beta did not move: {betas}")
        else:
            box = {"e": sts[0], "g": sts[1]}
            report[name].update(compare_paths(
                torch, name,
                lambda: box.__setitem__("e", sampler.sample_and_update(
                    box["e"], gens[0], B, size, cap, fn)[2]),
                lambda: box.__setitem__("g", prog(box["g"], gens[1], size)[2]), steps * 10))
            sts = [box["e"], box["g"]]
        add_counts(replayed, replay_launches(
            torch, prog, lambda: sts.__setitem__(1, prog(sts[1], gens[1], size)[2])))
        del sts, prog
        lap(name)
    del data
    # the engine: the decode chunk and the admission ladder, over bf16 and
    # int8 pools and behind one 384-token system prompt with the prefix cache
    V = width["vocab_size"]
    for name, kv_int8, prefix in (("engine_bf16", False, False), ("engine_int8", True, False),
                                  ("engine_prefix", False, True)):
        model = TransformerLM(TransformerConfig(**width, dtype=torch.bfloat16, kv_int8=kv_int8),
                              device=device, seed=0)
        reqs = (shared_prefix_prompts(16, 384, 8, 32, V, seed=5) if prefix
                else prompts(16, 16, 480, V, seed=1))

        def engine(**kw):
            return ContinuousBatchingEngine(
                model, n_slots=8, block_size=16, n_blocks=513, prompt_buckets=(32, 128, 512),
                decode_chunk=4, greedy=False, temperature=1.0, seed=1, device=device,
                prefix_cache=prefix, **kw)

        memory = {}
        if not kv_int8:  # the ladder's reserved memory: decode only, one pool, a pool a graph
            for key, kw in (("decode_only", dict(decode_only=True)), ("full_ladder", {}),
                            ("full_ladder_pool_per_graph", dict(private=True))):
                memory[key] = ladder_reserved_mib(torch, engine, **kw)
            memory["full_over_decode_only_mib"] = (memory["full_ladder"]["reserved_mib"]
                                                   - memory["decode_only"]["reserved_mib"])
            lap(f"{name}_ladder_memory")
        t0 = time.perf_counter()
        eng_g = engine(registry=reg, warmup=True)
        capture_s = time.perf_counter() - t0
        captured = engine_captures(eng_g)
        want = len(engine_programs(eng_g)) if torch.device(device).type == "cuda" else 0
        require(captured == want, f"graphs: {name}: {captured} captures for "
                f"{len(engine_programs(eng_g))} programs")
        eng_e = engine()
        lap(f"{name}_warmup")
        outs, runs = {}, {}
        # the gate: both in lockstep; then both as traffic runs them, timed
        for path, eng in (("eager", eng_e), ("replay", eng_g)):
            serve_run(torch, eng, reqs, 64, V, outs, path, lockstep=True)
        lap(f"{name}_lockstep")
        for a, b in zip(outs["eager"], outs["replay"]):
            require(np.array_equal(a.tokens, b.tokens) and np.array_equal(a.log_probs,
                                                                         b.log_probs),
                    f"graphs: {name}: request {a.rid}'s tokens or log-probs differ")
        for path, eng in (("eager", eng_e), ("replay", eng_g)):
            runs[path] = serve_run(torch, eng, reqs, 64, V, outs, path)
        if not prefix:  # one request length, so the schedule does not depend on timing
            for a, b in zip(outs["eager"], outs["replay"]):
                require(np.array_equal(a.tokens, b.tokens)
                        and np.array_equal(a.log_probs, b.log_probs),
                        f"graphs: {name}: request {a.rid} differs in the timed runs")
        lap(f"{name}_timed")
        profiled, peaks = {}, {}
        for path, eng in (("eager", eng_e), ("replay", eng_g)):
            steps0 = eng.decode_steps
            profiled[path] = profile_call(
                torch, lambda: serve_run(torch, eng, reqs[:8], 16, V))
            profiled[path]["decode_steps"] = eng.decode_steps - steps0
            profiled[path]["launches_per_decode_step"] = (profiled[path]["device_launches"]
                                                          / profiled[path]["decode_steps"])
            # over the profiled run's 8 requests (the pools and the graphs'
            # pool, which set the peak, do not depend on the count)
            peaks[path] = peak_mib(torch, lambda: serve_run(torch, eng, reqs[:8], 16, V))
        require(engine_captures(eng_g) == captured,
                f"graphs: {name}: {engine_captures(eng_g) - captured} captures in traffic "
                "after the warm-up")
        add_counts(replayed, engine_replays(torch, eng_g, per_replay))
        progs = engine_programs(eng_g)
        report[name] = {
            "capture_s": capture_s, "program": program_stats(eng_g._programs["serving.decode.k4"]),
            "ladder": {"programs": len(progs), "captures_after_warmup": captured,
                       "captures_after_traffic": engine_captures(eng_g),
                       "compile_s": sum(p.stats["compile_s"] for p in progs),
                       "replays": {p.name: p.stats["replays"] for p in progs
                                   if p.stats["replays"]}},
            "runs": runs, "profiled": profiled, "peak_mib": peaks, "ladder_memory": memory,
            "decode_step_host_speedup": (runs["eager"]["decode_step_ms_mean"]
                                         / runs["replay"]["decode_step_ms_mean"]),
            "admission_round_host_speedup": (runs["eager"]["prefill_ms_per_round"]
                                             / runs["replay"]["prefill_ms_per_round"])}
        del model, eng_g, eng_e
        lap(f"{name}_profiled")
    # the PPO update at the bench shape, then the whole PPO step
    progs = [make_ppo(torch, ppo), make_ppo(torch, ppo)]
    tss = []
    for p in progs:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        tss.append(p.init(g))
    update = progs[1].jit_update_from_batch(registry=reg)
    n = ppo["frames_per_batch"]
    pgen = torch.Generator(device=device)
    pgen.manual_seed(7)
    for i in range(3):
        batch, cstate = progs[0].collector.collect(tss[0]["collector"])
        tss[0]["collector"] = cstate
        perms = [torch.randperm(n, generator=pgen, device=device)
                 for _ in range(ppo["num_epochs"])]
        tss[0], m_e = progs[0].update_from_batch(tss[0], batch, permutations=perms)
        tss[1], m_g = update(tss[1], batch, perms)
        equal_trees(torch, m_g, m_e, f"ppo update {i}")
        for a, b in zip(progs[0].loss.parameters(), progs[1].loss.parameters()):
            require(torch.equal(a, b), f"graphs: ppo update {i}: a parameter differs")
    box = {"e": tss[0], "g": tss[1]}
    report["ppo"] = {"program": program_stats(update.program)}
    report["ppo"].update(compare_paths(
        torch, "ppo",
        lambda: box.__setitem__("e", progs[0].update_from_batch(box["e"], batch, perms)[0]),
        lambda: box.__setitem__("g", update(box["g"], batch, perms)[0]), steps))
    add_counts(replayed, replay_launches(
        torch, update.program, lambda: box.__setitem__("g", update(box["g"], batch, perms)[0])))
    del progs, tss, update, box, batch
    lap("ppo")
    progs = [make_ppo(torch, ppo), make_ppo(torch, ppo)]
    tss = []
    for p in progs:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        tss.append(p.init(g))
    step = progs[1].jit_train_step(registry=reg)
    for i in range(3):  # train_step's two halves, so that the batches compare too
        batch_e, cs_e = progs[0].collector.collect(tss[0]["collector"])
        batch_g, cs_g = step.collect(tss[1]["collector"])
        equal_trees(torch, (batch_g, cs_g), (batch_e, cs_e), f"ppo step {i}: the collect")
        tss[0], m_e = progs[0].update_from_batch({**tss[0], "collector": cs_e}, batch_e)
        tss[1], m_g = step.update({**tss[1], "collector": cs_g}, batch_g)
        equal_trees(torch, (m_g, tss[1]["collector"]), (m_e, tss[0]["collector"]),
                    f"ppo step {i}")
        require(tss[0]["update_count"] == tss[1]["update_count"], "graphs: ppo step counts")
        for a, b in zip(progs[0].loss.parameters(), progs[1].loss.parameters()):
            require(torch.equal(a, b), f"graphs: ppo step {i}: a parameter differs")
    box = {"e": tss[0], "g": tss[1]}
    report["ppo_step"] = {"program": program_stats(step.update.program),
                          "collect_program": program_stats(step.collect.program)}
    report["ppo_step"].update(compare_paths(
        torch, "ppo_step", lambda: box.__setitem__("e", progs[0].train_step(box["e"])[0]),
        lambda: box.__setitem__("g", step(box["g"])[0]), steps))
    for path in ("eager", "replay"):
        report["ppo_step"][path]["env_steps_per_s"] = (
            n / report["ppo_step"][path]["host_ms_per_call"] * 1e3)
    require(report["ppo_step"]["collect_program"]["compiles"]
            == report["ppo_step"]["collect_program"]["executables"]
            == (1 if torch.device(device).type == "cuda" else 0),
            f"graphs: ppo_step: the collect {report['ppo_step']['collect_program']}")
    del progs, tss, step, box, batch_e, batch_g
    lap("ppo_step")
    # the GRPO update at the train cell's shape (B1, B2 inside the graph),
    # then evaluate's greedy decode through grpo.eval_gen (B3)
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.trainers import GRPOTrainer

    tcfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                             flash_decode=True)
    kw = dict(model_config=tcfg, num_prompts=2, group_repeats=8, max_prompt_len=512,
              max_new_tokens=512, microbatch_size=8, continuous_batching=True, device=device)
    eager = GRPOTrainer(arithmetic_dataset(64), **kw)
    t0 = time.perf_counter()
    prev = set_program_registry(reg)
    try:
        graphed = GRPOTrainer(arithmetic_dataset(64), warmup=True, **kw)
    finally:
        set_program_registry(prev)
    capture_s = time.perf_counter() - t0
    batch = eager.collect()
    for i in range(3):
        eager._update(batch)
        graphed._update(batch)
        equal_trees(torch, graphed._dm, eager._dm, f"grpo update {i}")
        for a, b in zip(eager.policy.parameters(), graphed.policy.parameters()):
            require(torch.equal(a, b), f"graphs: grpo update {i}: a parameter differs")
    lap("grpo_build_and_gate")
    state = eager.env.reset(eager.dataset.prompts[:8])
    ptoks = torch.from_numpy(state["tokens"]).to(device)
    pmask = torch.from_numpy(np.asarray(state["attention_mask"], np.float32)).to(device)
    evaluate_e = lambda: eager._eval_generate(eager.gen_model, ptoks, pmask)  # noqa: E731
    evaluate_g = lambda: graphed._eval_generate(graphed.gen_model, ptoks, pmask)  # noqa: E731
    prog, chunk = graphed._eval_prog, graphed.eval_chunk
    n_chunks = -(-kw["max_new_tokens"] // chunk)
    eager_s, first_s = [], {}
    for i in range(2):  # evaluate, then an update published into the serving copy, again
        t0 = time.perf_counter()
        want = evaluate_e()
        sync(torch, device)
        eager_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = evaluate_g()
        sync(torch, device)
        first_s.setdefault("replay_with_capture", time.perf_counter() - t0)
        equal_trees(torch, got, want, f"evaluate {i}")
        if i == 0:
            require(eager.update(batch) == graphed.update(batch), "graphs: grpo update metrics")
    require(prog.program_count() == prog.stats["compiles"]
            == (n_chunks if torch.device(device).type == "cuda" else 0),
            f"graphs: evaluate: {prog.program_count()} graphs, not {n_chunks}")
    lap("evaluate_gate")
    accuracy = graphed.evaluate(num_prompts=8)  # the trainer's own call: replays only
    require(0.0 <= accuracy <= 1.0, f"graphs: evaluate accuracy {accuracy}")
    report["evaluate"] = {"program": program_stats(prog), "prompts": 8, "chunk_steps": chunk,
                          "graphs": n_chunks, "accuracy": accuracy,
                          "capture_s_per_graph": prog.stats["capture_s"] / n_chunks,
                          "first_call_s": first_s,
                          "eager": {"host_ms_per_call": statistics.mean(eager_s) * 1e3},
                          "replay": {"host_ms_per_call": host_ms(torch, evaluate_g, 3),
                                     "peak_mib": peak_mib(torch, evaluate_g)}}
    report["evaluate"]["host_speedup"] = (report["evaluate"]["eager"]["host_ms_per_call"]
                                          / report["evaluate"]["replay"]["host_ms_per_call"])
    # every replay's launches: one profiled replay of the first chunk (the
    # prefill and its steps) and one of the second, the later chunks
    # launching what the second does; each whole call replays every chunk
    require(kw["max_new_tokens"] % chunk == 0, "graphs: evaluate: a short last chunk")
    calls = prog.stats["replays"] // n_chunks
    with torch.no_grad():
        first = profile_seen(torch, lambda: prog(graphed.gen_model,
                                                 {"tokens": ptoks, "mask": pmask}, 0, chunk),
                             what="grpo.eval_gen first chunk")
        state0 = prog(graphed.gen_model, {"tokens": ptoks, "mask": pmask}, 0, chunk)
        later = profile_seen(torch, lambda: prog(graphed.gen_model, state0, chunk, chunk),
                             what="grpo.eval_gen later chunk")
    per_call = add_counts(dict(first["path_kernel_launches"]),
                          {k: v * (n_chunks - 1) for k, v in later["path_kernel_launches"].items()})
    add_counts(replayed, {k: v * calls for k, v in per_call.items()})
    # and the chunk replays just made: the profiled ones and state0's
    add_counts(replayed, {k: v * (first["calls"] + 1)
                          for k, v in first["path_kernel_launches"].items()})
    add_counts(replayed, {k: v * later["calls"] for k, v in later["path_kernel_launches"].items()})
    report["evaluate"]["replay"].update(
        {"launches_per_call": per_call, "first_chunk": first, "later_chunk": later})
    # beside it, the whole decode as one graph (what the chunks replace):
    # its capture and instantiation seconds, one replay's host ms and peak
    want = evaluate_g()  # the chunks' replay, equal to the eager decode above
    before = dict(prog.stats)
    graphed.eval_chunk = kw["max_new_tokens"]
    t0 = time.perf_counter()
    equal_trees(torch, evaluate_g(), want, "evaluate as one graph")
    sync(torch, device)
    report["evaluate"]["one_graph"] = {
        "first_call_s": time.perf_counter() - t0,
        **{k: prog.stats[k] - before[k] for k in ("compile_s", "capture_s", "compiles")},
        "host_ms_per_call": host_ms(torch, evaluate_g, 2), "peak_mib": peak_mib(torch, evaluate_g)}
    add_counts(replayed, {k: v * 5 for k, v in per_call.items()})  # want's and its four
    graphed.eval_chunk = chunk
    report["evaluate"].update(graphs=n_chunks + 1, program=program_stats(prog))
    lap("evaluate_timed")
    report["grpo"] = {"construct_and_capture_s": capture_s,
                      "program": program_stats(graphed._update_prog)}
    report["grpo"].update(compare_paths(torch, "grpo", lambda: eager._update(batch),
                                        lambda: graphed._update(batch), 5))
    add_counts(replayed, replay_launches(torch, graphed._update_prog,
                                         lambda: graphed._update(batch)))
    del eager, graphed, batch
    lap("grpo")
    report.update(anneal_and_c9_cases(torch, device, reg, ppo))
    lap("ppo_anneal_c9")
    counted = read_launches()  # eager work and the captures' eager runs
    launches = add_counts(dict(counted), replayed)
    for name, r in report.items():  # one capture a graph, then replays only
        want = r.get("graphs", 1) if torch.device(device).type == "cuda" else 0
        require(r["program"]["compiles"] == r["program"]["executables"] == want,
                f"graphs: {name}: {r['program']}")
    emit({"phase": "graphs", **report, "seconds": seconds, "registry": reg.stats(),
          "launches": launches,
          "launches_counted_by_wrappers": counted, "launches_replayed": replayed,
          "capture_error_mode": "thread_local", "profiler_calls": PROFILER_CALLS,
          "card": card})
    HEADLINES["graphs"] = {
        name: {"host_ms_eager": (r.get("eager") or {}).get("host_ms_per_call"),
               "host_ms_replay": (r.get("replay") or {}).get("host_ms_per_call"),
               "launches_eager": (r.get("eager") or {}).get("device_launches"),
               "launches_replay": (r.get("replay") or {}).get("device_launches"),
               "host_api_calls": [(r.get(p) or {}).get("host_api_calls")
                                  for p in ("eager", "replay")],
               "idle_eager": (r.get("eager") or {}).get("device_idle_share"),
               "idle_replay": (r.get("replay") or {}).get("device_idle_share"),
               "peak_mib": [(r.get(p) or {}).get("peak_mib") for p in ("eager", "replay")],
               **({"capture_s": r["program"]["capture_s"],
                   "compile_s": r["program"]["compile_s"], "graphs": r["graphs"]}
                  if name == "evaluate" else {}),
               **({"env_steps_per_s": [r[p]["env_steps_per_s"] for p in ("eager", "replay")]}
                  if name == "ppo_step" else {})}
        if "runs" not in r else
        {"decode_step_ms": [r["runs"][p]["decode_step_ms_mean"] for p in ("eager", "replay")],
         "admission_round_ms": [r["runs"][p]["prefill_ms_per_round"]
                                for p in ("eager", "replay")],
         "tokens_per_s": [r["runs"][p]["tokens_per_s"] for p in ("eager", "replay")],
         "host_api_calls": [r["profiled"][p]["host_api_calls"] for p in ("eager", "replay")],
         "launches_per_decode_step": [r["profiled"][p]["launches_per_decode_step"]
                                      for p in ("eager", "replay")],
         "idle": [r["profiled"][p]["device_idle_share"] for p in ("eager", "replay")],
         "peak_mib": [r["peak_mib"][p] for p in ("eager", "replay")],
         "ladder": {k: r["ladder"][k] for k in ("programs", "captures_after_traffic")},
         "ladder_reserved_mib": {k: (v["reserved_mib"] if isinstance(v, dict) else v)
                                 for k, v in r["ladder_memory"].items()}}
        for name, r in report.items()}
    return launches


def ptxas_report(build) -> dict:
    """``ptxas -v``'s registers, static shared memory and spills for every
    kernel of the seven redesigned sources, with the dynamic shared memory
    their launchers ask for at the main path's shapes (bf16, D = 64; the
    backward's at D = 32 and 128 too)."""
    from rl_tpu_torch.kernels import paged_attention
    from rl_tpu_torch.ops import attention

    T, D = FLASH_MAIN["T"], FLASH_MAIN["D"]
    tiles = -(-T // 64)
    return {
        "phase": "ptxas",
        **{f"{stem}.cu": build.ptxas_usage(stem)
           for stem in ("paged_decode", "paged_decode_int8", "sumtree", "flash_fwd", "flash_bwd",
                        "flash_decode", "fused_sample")},
        "dynamic_smem_bytes": {
            "paged_decode_split bf16 D=64 G=1": attention._paged_decode_smem(2, D, 1),
            # flash_decode.cu split_smem: two stages of 32 K and 32 V rows in
            # bf16, one head's float32 query, four warps' (acc, m, l)
            "flash_decode_split bf16 D=64 G=1": 2 * 2 * 2 * 32 * D + 4 * (D + 4 * (D + 2)),
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
    # keep CUPTI set up between profiler traces, as PyTorch does where it
    # captures CUDA graphs itself (graphs do not work well with CUPTI's
    # teardown); read before torch is imported
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
    import torch

    global T_MAIN
    T_MAIN = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["restart"]:  # the new process of a timed restart
        return restart_child(torch, sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from rl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"rl_tpu_torch/kernels/csrc/{s}.cu" for s in libs],
          "flags": list(_build.NVCC_FLAGS)})
    emit(ptxas_report(_build))
    card = power_line()
    if sys.argv[1:2] == ["async_check_rate"]:  # the diagnostic alone
        async_check_rate(torch, card, int(sys.argv[2]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:2] == ["fleet"]:  # the fleet phase alone
        fleet_phase(torch, card)
        emit({"headlines": HEADLINES})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:2] == ["pipeline_ab"]:  # the diagnostic alone
        if sys.argv[2:] == ["graphs"]:  # its sequential and pipelined blocks, in graphs
            from rl_tpu_torch.compile import get_program_registry

            pipeline_ab(torch, card, order="ABBA", warmup=True)
            emit({"phase": "pipeline_ab_graphs", "registry": get_program_registry().stats()})
        else:
            pipeline_ab(torch, card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernels", kernels_phase, torch)
    # registers, shared memory and spills of each redesigned kernel at its
    # main path's instance (bf16 q, D = 64, one head a block; B7's segment
    # route with one update a thread; B5's bf16 kernels)
    for name, stem, needles in [
            ("paged_flash_decode", "paged_decode", ("Li64ELi1E", "bfloat16")),
            ("paged_flash_decode_int8", "paged_decode_int8", ("Li64ELi1E", "bfloat16")),
            ("sumtree_update", "sumtree", ("sumtree_segmentsILi1E",)),
            ("flash_decode", "flash_decode", ("Li64ELi1E", "bfloat16")),
            ("fused_sample", "fused_sample", ("sample_", "bfloat16"))]:
        rows[name]["ptxas"] = [k for k in _build.ptxas_usage(stem)
                               if all(n in k["kernel"] for n in needles)
                               or ("combine" in k["kernel"] and "bfloat16" in k["kernel"])]
    by_phase = {"serve": timed("serve", serve_phase, torch, card)}
    by_phase["fleet"] = timed("fleet", fleet_phase, torch, card)
    timed("check", check_phase, torch)
    by_phase["spec"] = timed("spec", spec_phase, torch, card)
    by_phase["train"] = timed("train", train_phase, torch, card)
    timed("train_check", train_check_phase, torch)
    by_phase["offpolicy"] = timed("offpolicy", offpolicy_phase, torch, card)
    by_phase["td3_family"] = timed("td3_family", td3_family_phase, torch, card)
    by_phase["async_offpolicy"] = timed("async_offpolicy", async_offpolicy_phase, torch, card)
    by_phase["resilience"] = timed("resilience", resilience_phase, torch, card)
    by_phase["ppo"] = timed("ppo", ppo_phase, torch, card)
    timed("ppo_check", ppo_cpu_check, torch)
    timed("ppo_learn", ppo_learn_phase, torch, card)
    by_phase["pipeline"] = timed("pipeline", pipeline_phase, torch, card)
    by_phase["dqn"], program, ts = timed("dqn", dqn_phase, torch, card)
    by_phase["dqn_check"] = timed("dqn_check", dqn_cpu_check, torch, program, ts, DQN)
    del program, ts
    by_phase["dqn_learn"] = timed("dqn_learn", dqn_learn_phase, torch, card)
    by_phase["per"] = timed("per", per_phase, torch, card)
    by_phase["graphs"] = timed("graphs", graphs_phase, torch, card)
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
