"""Fault-tolerant serving fleet: health-checked membership, failover
re-dispatch and SLO-aware admission (counterpart of
:mod:`rl_tpu.models.fleet`).

:class:`ServingFleet` puts several
:class:`~rl_tpu_torch.models.serving.ContinuousBatchingEngine` members
behind one front door that survives a member's death:

- **Health-checked membership.** Each member is driven by a supervised
  stepper thread (:class:`~rl_tpu_torch.resilience.Supervisor`) that
  beats a :class:`~rl_tpu_torch.comm.Watchdog` each iteration. A monitor
  thread probes each member every ``probe_interval_s`` (thread alive,
  fresh beat, and the ``fleet.probe_drop`` chaos site); after
  ``quarantine_after`` consecutive failures the member is quarantined
  (routed around, never removed). A crashed stepper restarts under the
  supervisor's backoff, and a quarantined member rejoins after
  ``readmit_probes`` healthy probes past an exponential backoff gate.
- **Failover re-dispatch, exactly once.** Every fleet request carries a
  fleet id (``frid``); each dispatch maps the member's rid back to it.
  When a member crashes (``fleet.engine_crash`` raising in its stepper)
  or is quarantined, its outstanding requests go back to the front of
  their lane and are re-dispatched to survivors, from the prompt; the
  first completion wins, and a late duplicate from a quarantined but
  live member is suppressed by frid.
- **KV-aware admission.** ``submit`` sheds with
  :class:`~rl_tpu_torch.models.serving.ServiceSaturated` when the
  fleet's free KV fraction falls below ``admission_watermark`` or
  ``max_queue`` requests are outstanding.
- **SLO-aware routing.** The ``interactive`` lane is always dispatched
  before ``batch``; interactive picks the member with the least expected
  wait (queue depth x an EMA of its completion latency, plus KV
  pressure), batch goes through the embedded ``LoadBalancer``.
- **Disaggregation** (``disaggregate=True`` with ``roles``): a
  prefill-role member runs a detached prefill and a decode-role member
  adopts its :class:`~rl_tpu_torch.models.serving.KVHandoff`.

On the card every member gets a CUDA stream of its own
(:meth:`~rl_tpu_torch.models.serving.ContinuousBatchingEngine.own_stream`):
its stepper, the dispatcher's submits, prefills and adopts and a weight
push all queue its work there, in the order its lock grants them, and
members overlap on one card. All members must sit on one device: the
fleet refuses a mix, and nothing in it moves work elsewhere when a
member fails; a member whose kernel raises is a crashed member.

Chaos surface: ``fleet.engine_crash`` (and a per-member
``fleet.engine_crash.<idx>`` registered through
:func:`~rl_tpu_torch.resilience.register_site`, so that a plan can kill
one member deterministically), ``fleet.probe_drop`` and
``fleet.dispatch_delay``. The reference's burn-rate profiler trigger
waits for ``obs/profiling`` (ROADMAP A7).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

import numpy as np

from ..comm.liveness import Watchdog
from ..compile import CompileDelta
from ..obs.slo import SLOEngine, StreamingHistogram, merge_histograms
from ..obs.trace import ctx_args, current_context, new_trace, use_context
from ..resilience.faults import fault_point, register_site, should_drop
from .serving import (
    ContinuousBatchingEngine,
    FinishedRequest,
    LoadBalancer,
    ServiceSaturated,
)

__all__ = [
    "HEALTHY", "QUARANTINED", "DEAD", "RETIRED", "ServingFleet", "ShedRequest",
]

HEALTHY = "healthy"
QUARANTINED = "quarantined"
DEAD = "dead"
# scale-down terminal state: the member was drained deliberately (its
# outstanding work re-dispatched through the failover path) and left the
# routing/accounting sets — unlike DEAD it is a success, not a failure
RETIRED = "retired"
_STATE_VALUE = {HEALTHY: 0.0, QUARANTINED: 1.0, DEAD: 2.0, RETIRED: 3.0}
_OUT = (DEAD, RETIRED)  # states excluded from routing and KV aggregation

# tracked-request states
_QUEUED, _DISPATCHING, _DISPATCHED, _DONE, _SHED = (
    "queued", "dispatching", "dispatched", "done", "shed",
)


@dataclasses.dataclass
class ShedRequest:
    """A post-admission shed, delivered through ``harvest`` — the explicit
    counterpart of a completion (the caller backs off ``retry_after``
    seconds and resubmits). Made only when a request exhausts its
    re-dispatch budget or the last live member is gone; admission-time
    sheds raise :class:`ServiceSaturated` instead and are never
    admitted."""

    frid: int
    retry_after: float
    reason: str


@dataclasses.dataclass
class _Tracked:
    frid: int
    prompt: np.ndarray
    max_new_tokens: int
    lane: str
    state: str
    submitted_at: float
    member: int = -1
    erid: int = -1
    dispatches: int = 0
    first_token_at: float | None = None
    done_at: float | None = None
    result: Any = None  # FinishedRequest | ShedRequest
    # the request's node in the causal trace tree (None when tracing is
    # off); every dispatch/failover/settle event parents under it
    ctx: Any = None


class _Member:
    """One engine replica plus its routing-side bookkeeping. ``lock``
    guards the ENGINE object only, held by its stepper through a whole
    step; ``engine.submit`` alone is called without it (it takes the
    engine's own rid lock and appends), so the dispatcher never waits
    for a member's step. Every other field is guarded by the fleet lock
    (lock order: fleet lock may take ``lock``, never the reverse)."""

    def __init__(self, idx: int, engine: ContinuousBatchingEngine):
        self.idx = idx
        self.name = f"engine-{idx}"
        self.engine = engine
        self.lock = threading.Lock()
        self.state = HEALTHY
        # per-member stop flag: scale-down must end ONE stepper loop
        # without touching the fleet-wide stop event
        self.stop = threading.Event()
        # warm-up grace: while True and inside warm_deadline, failed
        # probes don't count toward quarantine; ends at the first healthy
        # probe
        self.warming = False
        self.warm_deadline = 0.0
        # disaggregation role: "mixed" serves both phases; "prefill"
        # members only run detached prefills, "decode" members only adopt
        self.role = "mixed"
        self.assigned: dict[int, int] = {}  # engine rid -> frid
        self.admit_events: list[tuple[int, float]] = []  # stepper-thread only
        self.probe_failures = 0
        self.probe_successes = 0
        self.quarantines = 0  # lifetime count -> re-admission backoff exponent
        self.readmit_at = 0.0
        self.lat_ema: float | None = None  # per-request completion latency
        # per-member streaming histograms: rolled up via merge() into the
        # fleet-wide TTFT/latency quantile gauges (merged quantiles equal
        # pooling the raw samples — counts add exactly), while staying
        # per-member for routing diagnostics and debug_state
        self.ttft_hist = StreamingHistogram()
        self.lat_hist = StreamingHistogram()
        # accepted tokens per decode dispatch (speculative members report
        # their verify-accept EMA; 1.0 — one token per dispatch — for
        # legacy members, so mixed fleets score on one scale)
        self.spec_ema = 1.0
        self.child = None  # Supervisor child


class ServingFleet:
    """N continuous-batching engines behind health-checked, SLO-aware
    routing that survives member death (module docstring has the design).

    Args:
        engines: the member replicas (homogeneous configs assumed: the
            first engine's limits validate submissions for all), on one
            device.
        supervisor: optional :class:`rl_tpu_torch.resilience.Supervisor`; the
            fleet creates (and owns) one when omitted.
        registry: optional :class:`rl_tpu_torch.obs.MetricsRegistry`; defaults
            to the process registry.
        probe_interval_s / probe_timeout_s: monitor sweep cadence and the
            watchdog staleness bound a beat must stay inside. The stepper
            cannot beat while blocked inside ``engine.step()``, so the
            timeout must exceed the worst single step INCLUDING first-use
            graph captures: warm the engines (:meth:`aot_warmup`) before
            ``start()`` when using a tight timeout. A stale-probe
            quarantine of a merely-slow member is SAFE (its late
            completions dedup) but wastes duplicated decode work.
        quarantine_after: consecutive probe failures before quarantine.
        readmit_probes: consecutive probe successes (past the backoff
            gate) before a quarantined member rejoins.
        readmit_backoff_s / readmit_backoff_max_s: re-admission gate —
            doubles per lifetime quarantine of that member, capped.
        admission_watermark: shed admission when fleet-wide free KV
            blocks (across non-dead members) fall below this fraction.
        max_queue: cap on outstanding admitted requests (None = no cap).
        max_pending_per_engine: dispatcher capacity gate per member
            (default ``2 * n_slots`` of the first engine).
        max_dispatches: re-dispatch budget per request; exceeding it
            sheds the request through ``harvest`` with ``retry_after``.
        retry_after_s: the explicit back-off hint carried by every shed.
    """

    LANES = ("interactive", "batch")

    def __init__(
        self,
        engines,
        *,
        supervisor=None,
        registry=None,
        probe_interval_s: float = 0.02,
        probe_timeout_s: float = 5.0,
        quarantine_after: int = 3,
        readmit_probes: int = 2,
        readmit_backoff_s: float = 0.05,
        readmit_backoff_max_s: float = 2.0,
        admission_watermark: float = 0.05,
        max_queue: int | None = None,
        max_pending_per_engine: int | None = None,
        max_dispatches: int = 5,
        retry_after_s: float = 0.25,
        idle_sleep_s: float = 0.002,
        batch_strategy="requests",
        slo_ttft_s: float = 1.0,
        slo_latency_s: float = 10.0,
        slo_target: float = 0.99,
        warmup_grace_s: float | None = None,
        max_members: int | None = None,
        disaggregate: bool = False,
        roles=None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("ServingFleet needs at least one engine")
        self.device = engines[0].device
        for i, e in enumerate(engines[1:], start=1):
            if e.device != self.device:
                raise ValueError(f"fleet members must share one device: engine 0 is on "
                                 f"{self.device}, engine {i} on {e.device}")
        # the fleet's shape contract: every member must run the SAME
        # bucket ladder, otherwise failover re-dispatch lands a request on
        # a member whose compiled program set doesn't cover its shape (a
        # surprise compile inside the stepper — exactly what the AOT
        # subsystem exists to prevent)
        b0 = engines[0].shape_buckets
        for i, e in enumerate(engines[1:], start=1):
            if e.shape_buckets != b0:
                raise ValueError(
                    f"fleet members must share one ShapeBuckets config: "
                    f"engine 0 has {b0}, engine {i} has {e.shape_buckets}"
                )
        self.shape_buckets = b0
        for e in engines:
            e.own_stream()  # one stream per member on the card
        self._members = [_Member(i, e) for i, e in enumerate(engines)]
        if roles is not None:
            roles = list(roles)
            if len(roles) != len(self._members):
                raise ValueError(
                    f"roles must name every initial member: got {len(roles)} "
                    f"roles for {len(self._members)} engines"
                )
            for m, r in zip(self._members, roles):
                if r not in ("mixed", "prefill", "decode"):
                    raise ValueError(f"unknown member role {r!r}")
                if r != "mixed" and not disaggregate:
                    raise ValueError(
                        "prefill/decode member roles need disaggregate=True")
                m.role = r
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.quarantine_after = quarantine_after
        self.readmit_probes = readmit_probes
        self.readmit_backoff_s = readmit_backoff_s
        self.readmit_backoff_max_s = readmit_backoff_max_s
        self.admission_watermark = admission_watermark
        self.max_queue = max_queue
        self.max_pending_per_engine = (
            max_pending_per_engine
            if max_pending_per_engine is not None
            else 2 * engines[0].n_slots
        )
        self.max_dispatches = max_dispatches
        self.retry_after_s = retry_after_s
        self.idle_sleep_s = idle_sleep_s
        # elastic membership (the Autoscaler's primitives): members are
        # never REMOVED from the list — retirement is a terminal state —
        # so indices stay stable for metrics/labels/fault-site names
        self.warmup_grace_s = (
            warmup_grace_s
            if warmup_grace_s is not None
            else max(5.0, 3.0 * probe_timeout_s)
        )
        self.max_members = max_members
        self.disaggregate = bool(disaggregate)
        self._next_member_idx = len(engines)
        self._prefill_rr = 0  # round-robin cursor over prefill-role members
        self.scale_ups = 0
        self.scale_downs = 0
        # the decision trail: one dict per membership change, the flight
        # recorder's scale-event source
        self.scale_events: list[dict] = []

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False
        self._error: str | None = None
        self._next_frid = 0
        self._tracked: dict[int, _Tracked] = {}
        self._lanes: dict[int, Any] = {
            lane: collections.deque() for lane in self.LANES
        }
        self._ready: dict[int, Any] = {}  # frid -> result, drained by harvest

        # the embedded balancer IS the O(1) KV accounting + the batch-lane
        # strategy chain; its engine list is swapped to the healthy set per
        # selection (allow_empty: an all-quarantined moment must shed, not
        # raise ValueError — the satellite fix this fleet depends on)
        self._lb = LoadBalancer(
            engines, batch_strategy, retry_after_s=retry_after_s, allow_empty=True
        )
        self._watchdog = Watchdog(timeout=probe_timeout_s)
        if supervisor is None:
            from ..resilience.supervisor import Supervisor

            supervisor = Supervisor(name="fleet", max_restarts=8, window_s=60.0,
                                    backoff_base_s=0.01, backoff_max_s=0.25)
            self._own_sup = True
        else:
            self._own_sup = False
        self._sup = supervisor

        for m in self._members:
            register_site(
                f"fleet.engine_crash.{m.idx}",
                f"ServingFleet member {m.idx} stepper, per busy iteration",
            )
            m.engine.on_admit = self._make_on_admit(m)

        # fleet-level accounting (guarded by the fleet lock); the invariant
        # the chaos run asserts is admitted == done + shed + outstanding
        # at every instant, with outstanding == 0 once drained
        self.admitted = 0
        self.completed = 0
        self.shed: dict[str, int] = {}
        self.redispatched = 0
        self.duplicates_suppressed = 0
        self.crashes = 0
        self.quarantines_total = 0
        self.readmissions = 0

        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        self.registry = registry
        from ..obs import get_tracer

        self._tracer = get_tracer()
        # declarative SLOs over streaming histograms (the Autoscaler's
        # calibrated signals): TTFT and completion latency are value
        # objectives fed in _settle; availability counts completed vs
        # shed-after-admission. The per-objective histograms are ALSO the
        # export truth for ttft quantile gauges — the member lat_ema
        # survives only as the router's recency signal.
        self.slo = SLOEngine(registry=registry)
        self._slo_ttft = self.slo.objective(
            "fleet_ttft", threshold=slo_ttft_s, target=slo_target,
            description="time to first token")
        self._slo_latency = self.slo.objective(
            "fleet_latency", threshold=slo_latency_s, target=slo_target,
            description="submit-to-completion latency")
        self._slo_avail = self.slo.objective(
            "fleet_availability", target=slo_target,
            description="admitted requests completed (vs shed post-admission)")
        self._init_metrics(registry)

    # -- obs wiring ------------------------------------------------------------

    def _init_metrics(self, reg):
        p = "rl_tpu_fleet"
        self._c_admitted = reg.counter(f"{p}_admitted_total", "requests admitted")
        self._c_completed = reg.counter(f"{p}_completions_total",
                                        "admitted requests completed exactly once")
        self._c_shed = reg.counter(f"{p}_shed_total",
                                   "requests shed with an explicit retry-after",
                                   labels=("reason",))
        self._c_redispatched = reg.counter(
            f"{p}_redispatched_total", "failover re-dispatches onto survivors")
        self._c_dups = reg.counter(
            f"{p}_duplicates_suppressed_total",
            "late duplicate completions suppressed by request-id dedup")
        self._c_crashes = reg.counter(f"{p}_engine_crashes_total",
                                      "member stepper crashes")
        self._c_quarantines = reg.counter(f"{p}_quarantines_total",
                                          "members quarantined")
        self._c_readmissions = reg.counter(f"{p}_readmissions_total",
                                           "quarantined members re-admitted")
        self._c_scale_ups = reg.counter(f"{p}_scale_ups_total",
                                        "members added by elastic scale-up")
        self._c_scale_downs = reg.counter(
            f"{p}_scale_downs_total", "members drained and retired by scale-down")
        self._g_members = reg.gauge(
            f"{p}_members", "routable members (not dead or retired)")
        self._g_health = reg.gauge(
            f"{p}_engine_health",
            "member health (0=healthy, 1=quarantined, 2=dead, 3=retired)",
            labels=("engine",))
        self._g_free_kv = reg.gauge(f"{p}_free_kv_blocks",
                                    "fleet-wide free KV blocks (non-dead members)")
        self._g_total_kv = reg.gauge(f"{p}_kv_blocks_total",
                                     "fleet-wide KV pool size (non-dead members)")
        self._g_lane = reg.gauge(f"{p}_lane_queue_depth",
                                 "requests waiting for dispatch", labels=("lane",))
        self._g_outstanding = reg.gauge(f"{p}_outstanding",
                                        "admitted requests not yet done or shed")
        # real quantiles from the streaming histograms (not the EMA): the
        # ttft_seconds{quantile} satellite the dashboards key on
        self._g_ttft = reg.gauge(
            f"{p}_ttft_seconds", "time-to-first-token quantiles",
            labels=("quantile",))
        self._g_latency = reg.gauge(
            f"{p}_latency_seconds", "submit-to-completion latency quantiles",
            labels=("quantile",))
        for m in self._members:
            self._g_health.set(0.0, {"engine": str(m.idx)})
        reg.register_collector(self._update_gauges)
        try:
            from ..obs.trace import wire_tracer_obs

            wire_tracer_obs(reg)  # ring-lap visibility rides along
        except Exception:
            pass

    def _update_gauges(self):
        with self._lock:
            free, total = self._kv_blocks_locked()
            lanes = {lane: len(q) for lane, q in self._lanes.items()}
            outstanding = self._outstanding_locked()
            states = [(m.idx, m.state) for m in self._members]
        self._g_members.set(
            float(sum(1 for _, s in states if s not in _OUT)))
        self._g_free_kv.set(float(free))
        self._g_total_kv.set(float(total))
        for lane, depth in lanes.items():
            self._g_lane.set(float(depth), {"lane": lane})
        self._g_outstanding.set(float(outstanding))
        for idx, state in states:
            self._g_health.set(_STATE_VALUE[state], {"engine": str(idx)})
        # fleet-wide quantiles from the per-member histograms rolled up
        # via merge() (exact: counts add, so merged quantiles == pooling
        # the raw samples). Histogram locks are leaves taken one at a
        # time — deliberately outside the fleet lock above.
        for g, pick in ((self._g_ttft, lambda m: m.ttft_hist),
                        (self._g_latency, lambda m: m.lat_hist)):
            merged = merge_histograms(pick(m) for m in self._members)
            if merged is not None and merged.count:
                for q in (0.5, 0.99):
                    v = merged.quantile(q)
                    if v is not None:
                        g.set(v, {"quantile": str(q)})

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ServingFleet":
        if self._started:
            return self
        self._started = True
        for m in self._members:
            self._watchdog.register(m.name)
            m.child = self._sup.spawn(
                m.name, lambda m=m: self._member_loop(m),
                escalate=False,
                on_giveup=lambda exc, m=m: self._on_member_giveup(m, exc),
            )
        self._dispatcher = self._sup.spawn(
            "fleet-dispatcher", self._dispatch_loop, escalate=False,
            on_giveup=self._on_control_giveup,
        )
        self._monitor = self._sup.spawn(
            "fleet-monitor", self._monitor_loop, escalate=False,
            on_giveup=self._on_control_giveup,
        )
        return self

    def aot_warmup(self, *, background: bool = False):
        """Capture every member's whole program ladder BEFORE ``start()``,
        so steppers never capture under the probe watchdog and steady-state
        traffic stays at a capture delta of zero. A graph captures over its
        member's own buffers, so each member captures its own ladder.
        Returns ``{member_index: {program: [(source, s)]}}``, or a list of
        :class:`~rl_tpu_torch.compile.WarmupHandle` with
        ``background=True``.
        """
        if background:
            return [m.engine.aot_warmup(background=True) for m in self._members]
        return {
            m.idx: m.engine.aot_warmup(background=False) for m in self._members
        }

    def shutdown(self) -> None:
        self._stop.set()
        if self._started:
            if self._own_sup:
                self._sup.stop()
            else:
                for m in self._members:
                    if m.child is not None:
                        m.child.stop()
                self._dispatcher.stop()
                self._monitor.stop()
        if self.registry is not None:
            self.registry.unregister_collector(self._update_gauges)
            self.registry.unregister_collector(self.slo._collect)

    # -- admission (the SLO-aware front door) ----------------------------------

    def submit(self, prompt, max_new_tokens: int, lane: str = "interactive") -> int:
        """Admit a request into ``lane`` and return its fleet id, or shed
        with :class:`ServiceSaturated` when the KV watermark or queue cap
        says the fleet cannot absorb it. Validation errors (bad lane,
        oversize prompt) raise ``ValueError`` BEFORE admission so the
        dispatcher never meets a request no engine can serve."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if lane not in self._lanes:
            raise ValueError(f"unknown lane {lane!r}; want one of {self.LANES}")
        # pre-validate against the (homogeneous) engine limits: an invalid
        # request must fail the CALLER, not crash the dispatcher later
        eng0 = self._members[0].engine
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > eng0.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({eng0.max_seq_len})"
            )
        if len(prompt) > eng0.buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest prefill "
                f"bucket {eng0.buckets[-1]}"
            )
        with self._lock:
            if self._error is not None:
                raise RuntimeError(f"fleet control plane died:\n{self._error}")
            alive = [m for m in self._members if m.state not in _OUT]
            if not alive:
                self._count_shed_locked("no_members")
                raise ServiceSaturated(self.retry_after_s)
            free, total = self._kv_blocks_locked()
            if total > 0 and free < self.admission_watermark * total:
                if not self._prefix_covered_locked(prompt, alive):
                    self._count_shed_locked("kv_watermark")
                    raise ServiceSaturated(self.retry_after_s)
            if self.max_queue is not None and self._outstanding_locked() >= self.max_queue:
                self._count_shed_locked("queue_full")
                raise ServiceSaturated(self.retry_after_s)
            frid = self._next_frid
            self._next_frid += 1
            # the request's trace node: child of the caller's context (a
            # TCP handler span when submit arrives over the wire) or a new
            # root. Created only when it can be observed — a disabled
            # tracer with no inherited context keeps submit at zero cost.
            parent = current_context()
            ctx = None
            if parent is not None:
                ctx = parent.child()
            elif self._tracer.enabled:
                ctx = new_trace()
            self._tracked[frid] = _Tracked(
                frid, prompt, int(max_new_tokens), lane, _QUEUED,
                time.monotonic(), ctx=ctx,
            )
            self._lanes[lane].append(frid)
            self.admitted += 1
            self._c_admitted.inc()
            if ctx is not None:
                self._tracer.instant(
                    "fleet_admit", {"frid": frid, "lane": lane, **ctx_args(ctx)}
                )
            return frid

    def _count_shed_locked(self, reason: str) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        self._c_shed.inc(1, {"reason": reason})
        self._tracer.instant("fleet_shed", {"reason": reason})

    def _prefix_covered_locked(self, prompt, alive) -> bool:
        """Watermark-bypass check: admit a below-watermark request anyway
        when some alive member's prefix cache already holds the ENTIRE
        prompt prefix (every token but the last, which is always
        recomputed for its logits) AND that member has the few new blocks
        the request still needs. A fully-shared prompt adds almost
        nothing to the pool — shedding it would throw away exactly the
        traffic the prefix tier makes cheap. Plain engines (no
        ``kv_admission_probe``) never bypass."""
        P = len(prompt)
        if P < 2:
            return False
        for m in alive:
            probe = getattr(m.engine, "kv_admission_probe", None)
            if probe is None:
                continue
            shared, needed = probe(prompt, 1)
            if shared >= P - 1 and needed <= m.engine.kv_free_blocks():
                return True
        return False

    def _kv_blocks_locked(self) -> tuple[int, int]:
        """Fleet-wide (free, total) KV blocks over non-dead members —
        each term is the LoadBalancer's O(1) accounting (sharing-adjusted
        for prefix-cache engines: unreferenced cached blocks count as
        free, so a pool full of reusable prefixes is not pressure)."""
        free = total = 0
        for m in self._members:
            if m.state in _OUT:
                continue
            n = m.engine._n_pool_blocks
            total += n
            free += n - int(round(self._lb._kv_utilization(m.engine) * n))
        return free, total

    _ADMISSION_SHEDS = ("kv_watermark", "queue_full", "no_members")

    def _outstanding_locked(self) -> int:
        return self.admitted - self.completed - self._post_shed_locked()

    def _post_shed_locked(self) -> int:
        """Sheds of ADMITTED requests (admission-time sheds were never
        admitted, so they don't reduce the outstanding count)."""
        return sum(n for r, n in self.shed.items() if r not in self._ADMISSION_SHEDS)

    # -- results ---------------------------------------------------------------

    def harvest(self) -> dict[int, Any]:
        """Pop results ready so far: ``{frid: FinishedRequest | ShedRequest}``.
        Every admitted request eventually appears here exactly once."""
        with self._lock:
            out = self._ready
            self._ready = {}
            return out

    def wait(self, frids=None, timeout: float = 120.0, poll_s: float = 0.005) -> dict:
        """Collect until every frid (default: everything outstanding at
        call time) is done-or-shed; raises ``TimeoutError`` otherwise."""
        deadline = time.monotonic() + timeout
        with self._lock:
            want = (
                set(int(f) for f in frids)
                if frids is not None
                else {f for f, t in self._tracked.items()
                      if t.state not in (_DONE, _SHED)}
            )
            got = {f: self._tracked[f].result
                   for f in want if f in self._tracked
                   and self._tracked[f].state in (_DONE, _SHED)}
        self.harvest()  # results also stay in _tracked; drain the buffer
        want -= set(got)
        while want:
            if time.monotonic() > deadline:
                raise TimeoutError(f"requests {sorted(want)[:8]}... not settled "
                                   f"in {timeout}s")
            time.sleep(poll_s)
            with self._lock:
                if self._error is not None:
                    raise RuntimeError(
                        f"fleet control plane died:\n{self._error}")
                for f in list(want):
                    t = self._tracked.get(f)
                    if t is not None and t.state in (_DONE, _SHED):
                        got[f] = t.result
                        want.discard(f)
            self.harvest()
        return got

    def pending(self) -> int:
        with self._lock:
            return self._outstanding_locked()

    def request_stats(self) -> list[dict]:
        """Per-request timing/routing snapshot (the TTFT source)."""
        with self._lock:
            return [
                {
                    "frid": t.frid, "lane": t.lane, "state": t.state,
                    "submitted_at": t.submitted_at,
                    "first_token_at": t.first_token_at,
                    "done_at": t.done_at, "dispatches": t.dispatches,
                    "tokens": (len(t.result.tokens)
                               if isinstance(t.result, FinishedRequest) else 0),
                }
                for t in self._tracked.values()
            ]

    def metrics_snapshot(self) -> dict:
        with self._lock:
            free, total = self._kv_blocks_locked()
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "shed": dict(self.shed),
                "redispatched": self.redispatched,
                "duplicates_suppressed": self.duplicates_suppressed,
                "crashes": self.crashes,
                "quarantines": self.quarantines_total,
                "readmissions": self.readmissions,
                "outstanding": self._outstanding_locked(),
                "free_kv_blocks": free,
                "kv_blocks_total": total,
                "lane_depth": {lane: len(q) for lane, q in self._lanes.items()},
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "members_routable": sum(
                    1 for m in self._members if m.state not in _OUT),
                "members": [
                    {"idx": m.idx, "state": m.state, "role": m.role,
                     "pending": m.engine.pending(),
                     "quarantines": m.quarantines,
                     "restarts": (m.child.restarts if m.child else 0)}
                    for m in self._members
                ],
            }

    def accounting(self) -> dict:
        """The invariant, as numbers: ``lost`` must be zero always."""
        with self._lock:
            post = self._post_shed_locked()
            adm = sum(self.shed.get(r, 0) for r in self._ADMISSION_SHEDS)
            outstanding = self._outstanding_locked()
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "shed_admission": adm,
                "shed_post_admission": post,
                "outstanding": outstanding,
                "redispatched": self.redispatched,
                "duplicates_suppressed": self.duplicates_suppressed,
                "lost": self.admitted - self.completed - post - outstanding,
            }

    # -- elastic membership (the Autoscaler's primitives) ----------------------

    def add_member(self, engine, *, warm: bool = True, role: str = "mixed") -> dict:
        """Join ``engine`` to the fleet mid-flight (scale-up). The engine
        must run the SAME :class:`~rl_tpu_torch.compile.ShapeBuckets`
        ladder as the fleet (a mismatched member would capture under
        traffic on its first failover re-dispatch) and sit on the fleet's
        device. With ``warm`` (default) its whole program ladder is
        captured BEFORE it joins routing and its stepper starts, and the
        event carries the :class:`~rl_tpu_torch.compile.CompileDelta` over
        the warm-up (``compile_delta``, ``by_program``) beside ``ladder``,
        the captures the member made for itself: a delta above the ladder
        means another program captured meanwhile (the Autoscaler asserts
        they are equal). The new member starts inside the warm-up probe
        grace window. Returns the scale event dict."""
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown member role {role!r}")
        if role != "mixed" and not self.disaggregate:
            raise ValueError(
                "prefill/decode member roles need disaggregate=True")
        if engine.shape_buckets != self.shape_buckets:
            raise ValueError(
                f"fleet members must share one ShapeBuckets config: fleet "
                f"has {self.shape_buckets}, new member has "
                f"{engine.shape_buckets}"
            )
        if engine.device != self.device:
            raise ValueError(f"fleet members must share one device: the fleet is on "
                             f"{self.device}, the new member on {engine.device}")
        engine.own_stream()
        with self._lock:
            routable = sum(1 for m in self._members if m.state not in _OUT)
            if self.max_members is not None and routable >= self.max_members:
                raise RuntimeError(
                    f"fleet already at max_members={self.max_members}")
            idx = self._next_member_idx
            self._next_member_idx += 1
        # warm OUTSIDE every lock: compiles/store-loads are slow, and
        # serving must not pause while a new replica pages its ladder in
        delta = by_program = ladder = None
        if warm:
            with CompileDelta() as d:
                report = engine.aot_warmup()
            delta, by_program = d.delta, dict(d.by_program)
            # the graphs this member captured for itself: a capture works
            # over the member's own buffers, so no member reuses another's
            ladder = sum(src == "capture" for runs in report.values() for src, _ in runs)
        m = _Member(idx, engine)
        m.role = role
        register_site(
            f"fleet.engine_crash.{m.idx}",
            f"ServingFleet member {m.idx} stepper, per busy iteration",
        )
        m.engine.on_admit = self._make_on_admit(m)
        now = time.monotonic()
        # register BEFORE the member becomes routable: a fresh beat, so the
        # first watchdog sweep cannot see a stale never-beaten entry
        self._watchdog.register(m.name)
        with self._lock:
            m.warming = True
            m.warm_deadline = now + self.warmup_grace_s
            self._members.append(m)
            self.scale_ups += 1
            ev = {
                "event": "scale_up", "idx": idx, "role": role,
                "warm": bool(warm), "compile_delta": delta, "ladder": ladder,
                "by_program": by_program, "t": now,
            }
            self.scale_events.append(ev)
        self._c_scale_ups.inc()
        self._g_health.set(0.0, {"engine": str(idx)})
        self._tracer.instant(
            "fleet_scale_up",
            {"engine": idx, "role": role, "compile_delta": delta})
        if self._started:
            m.child = self._sup.spawn(
                m.name, lambda m=m: self._member_loop(m),
                escalate=False,
                on_giveup=lambda exc, m=m: self._on_member_giveup(m, exc),
            )
        return ev

    def scale_down(self, idx: int | None = None, *, reason: str = "scale_down"):
        """Retire one member (default: the least-loaded healthy one,
        newest on ties) and drain its outstanding requests through the
        existing failover re-dispatch path — the same exactly-once
        machinery a crash uses, so ``lost == 0`` by construction. The
        member leaves routing/aggregation immediately (state RETIRED),
        its stepper thread is joined, salvageable completions are
        settled, and everything still outstanding is re-queued at the
        front of its lane. Returns the scale event dict, or ``None`` when
        no member can be spared (never drains the last routable one)."""
        with self._lock:
            routable = [m for m in self._members if m.state not in _OUT]
            if len(routable) <= 1:
                return None
            if idx is None:
                cands = [m for m in routable if m.state == HEALTHY]
                if not cands:
                    return None
                victim = min(cands, key=lambda m: (len(m.assigned), -m.idx))
            else:
                found = [m for m in self._members if m.idx == idx]
                if not found or found[0].state in _OUT:
                    raise ValueError(f"no routable member with idx {idx}")
                victim = found[0]
            m = victim
            m.state = RETIRED
            outstanding_before = len(m.assigned)
            self.scale_downs += 1
            self._tracer.instant(
                "fleet_retire", {"engine": m.idx, "reason": reason,
                                 "outstanding": outstanding_before})
        self._c_scale_downs.inc()
        self._g_health.set(3.0, {"engine": str(m.idx)})
        # stop the stepper OUTSIDE the fleet lock: the join blocks until
        # the current step returns, and that step may be waiting on the
        # fleet lock inside _settle
        m.stop.set()
        if m.child is not None:
            m.child.stop()
        # salvage finished-but-unsettled completions, then reset the engine
        # so its KV blocks return to the free list (a RETIRED member no
        # longer aggregates, keeping the O(1) watermark accounting exact)
        fin: list = []
        try:
            with m.lock:
                fin = list(m.engine.finished)
                m.engine.finished.clear()
                m.engine.reset()
        except Exception:
            pass  # a wedged engine still drains through failover
        self._settle(m, fin)
        with self._lock:
            self._failover_locked(m, clear_assignments=True)
            ev = {
                "event": "scale_down", "idx": m.idx, "reason": reason,
                "outstanding_redispatched": outstanding_before,
                "salvaged": len(fin), "t": time.monotonic(),
            }
            self.scale_events.append(ev)
        self._watchdog.unregister(m.name)
        return ev

    def push_params(self, model) -> int:
        """Roll ``model``'s weights across the routable members, one at a
        time under that member's lock only: each member copies them into
        its own model in place
        (:meth:`~rl_tpu_torch.models.serving.ContinuousBatchingEngine.load_weights`),
        queued on its stream after the chunk in flight, so its captured
        graphs stay valid and serving never pauses globally (the reference
        swaps the params pointer). A member's failed copy raises (its
        reset never reloads weights, so it would serve the old policy);
        the members before it keep the new weights. Returns the number of
        members updated."""
        with self._lock:
            members = [m for m in self._members if m.state not in _OUT]
        for m in members:
            with m.lock:
                m.engine.load_weights(model)
        return len(members)

    def poll(self, frids) -> dict[int, Any]:
        """Non-blocking tenant harvest: results for exactly ``frids`` that
        have settled, removed from the shared ready buffer so an
        interactive ``harvest()`` loop never sees another tenant's rows."""
        out: dict[int, Any] = {}
        with self._lock:
            for f in frids:
                f = int(f)
                t = self._tracked.get(f)
                if t is not None and t.state in (_DONE, _SHED):
                    out[f] = t.result
                    self._ready.pop(f, None)
        return out

    def ttft_burn_rate(self, window_s: float = 60.0) -> float:
        """The scale-up signal: fleet_ttft error-budget burn rate over the
        trailing window (0.0 with no traffic)."""
        return self._slo_ttft.burn_rate(window_s)

    def kv_slack(self) -> tuple[int, int]:
        """The scale-down signal: fleet-wide (free, total) KV blocks over
        routable members — sharing-adjusted ``free_adjusted`` per member."""
        with self._lock:
            return self._kv_blocks_locked()

    def n_routable(self) -> int:
        with self._lock:
            return sum(1 for m in self._members if m.state not in _OUT)

    def kv_recount(self) -> tuple[int, int]:
        """Ground-truth recount of :meth:`kv_slack`, bypassing the O(1)
        free-list counters: per member, a full
        :meth:`~rl_tpu_torch.kvmem.PrefixKVAllocator.audit` (which asserts the
        pool partitions exactly) for prefix engines, or a block-table scan
        for plain ones. The membership property test's oracle — counter ==
        recount must hold after any join/leave/crash sequence."""
        with self._lock:
            members = [m for m in self._members if m.state not in _OUT]
        free = total = 0
        for m in members:
            with m.lock:
                eng = m.engine
                n = eng._n_pool_blocks
                total += n
                kvmem = getattr(eng, "_kvmem", None)
                if kvmem is not None:
                    a = kvmem.audit()
                    free += a["free"] + a["reclaimable"]
                else:
                    free += n - int((eng.table >= 0).sum())
        return free, total

    # -- member stepper (supervised) -------------------------------------------

    def _make_on_admit(self, m: _Member):
        # runs on m's stepper thread inside engine.step() -> _admit, under
        # m.lock: appending is safe because admit_events is only ever
        # touched from that thread (settle + crash paths included)
        def on_admit(erid: int, m=m):
            m.admit_events.append((erid, time.monotonic()))

        return on_admit

    def _member_loop(self, m: _Member) -> None:
        eng = m.engine
        while not self._stop.is_set() and not m.stop.is_set():
            self._watchdog.beat(m.name)
            # a representative request context for this iteration (the
            # first assigned request's node), so injected faults and crash
            # events link into the trace of the work they hit. Looked up
            # BEFORE m.lock: lock order is fleet lock -> m.lock, never the
            # reverse. Tracing off: one bool check, no lock taken.
            step_ctx = None
            if self._tracer.enabled:
                with self._lock:
                    for frid in m.assigned.values():
                        tr = self._tracked.get(frid)
                        if tr is not None and tr.ctx is not None:
                            step_ctx = tr.ctx
                            break
            try:
                with m.lock:
                    busy = eng.pending() > 0
                    if busy:
                        # chaos sites fire only when there is work to lose:
                        # an idle replica cannot crash mid-decode
                        with use_context(step_ctx):
                            fault_point("fleet.engine_crash")
                            fault_point(f"fleet.engine_crash.{m.idx}")
                            with self._tracer.span("fleet/step", {"engine": m.idx}):
                                eng.step()
                    fin = list(eng.finished)
                    eng.finished.clear()
            except BaseException as e:
                self._on_member_crash(m, e)
                raise  # the Supervisor restarts this loop after backoff
            if fin or m.admit_events:
                self._settle(m, fin)
            if not busy:
                self._stop.wait(self.idle_sleep_s)

    def _settle(self, m: _Member, fin) -> None:
        """Attribute admissions (TTFT) and completions back to fleet
        requests; first completion wins, duplicates are suppressed."""
        events, m.admit_events = m.admit_events, []
        now = time.monotonic()
        with self._lock:
            for erid, t in events:
                frid = m.assigned.get(erid)
                tr = self._tracked.get(frid) if frid is not None else None
                if tr is not None and tr.first_token_at is None:
                    tr.first_token_at = t
                    # streaming-histogram TTFT (the exported truth; the
                    # EMA below only routes). Objective locks nest inside
                    # the fleet lock, never the reverse.
                    self._slo_ttft.record(t - tr.submitted_at)
                    m.ttft_hist.observe(t - tr.submitted_at)
                    if tr.ctx is not None:
                        self._tracer.instant(
                            "fleet_first_token",
                            {"frid": frid, "engine": m.idx, **ctx_args(tr.ctx)},
                        )
            for f in fin:
                frid = m.assigned.pop(f.rid, None)
                if frid is None:
                    continue  # assignment was cleared by a crash reset
                tr = self._tracked[frid]
                if tr.state in (_DONE, _SHED):
                    self.duplicates_suppressed += 1
                    self._c_dups.inc()
                    self._tracer.instant(
                        "fleet_duplicate_suppressed",
                        {"frid": frid, "engine": m.idx})
                    continue
                tr.state, tr.result, tr.done_at = _DONE, f, now
                self._ready[frid] = f
                self.completed += 1
                self._c_completed.inc()
                lat = now - tr.submitted_at
                m.lat_ema = lat if m.lat_ema is None else 0.7 * m.lat_ema + 0.3 * lat
                m.spec_ema = float(getattr(m.engine, "spec_accept_ema", 1.0))
                self._slo_latency.record(lat)
                m.lat_hist.observe(lat)
                self._slo_avail.record_event(True)
                if tr.ctx is not None:
                    self._tracer.instant(
                        "fleet_request_done",
                        {"frid": frid, "engine": m.idx,
                         "dispatches": tr.dispatches, **ctx_args(tr.ctx)},
                    )

    def _on_member_crash(self, m: _Member, exc: BaseException) -> None:
        """Stepper-thread crash path: salvage finished-but-unsettled
        completions, reset the engine in place, fail outstanding work over
        to survivors, quarantine the member until probes re-admit it."""
        fin: list = []
        try:
            with m.lock:
                fin = list(m.engine.finished)
                m.engine.finished.clear()
                m.engine.reset()
        except Exception:
            pass  # a wedged engine still fails over; reset retried on restart
        self._settle(m, fin)
        with self._lock:
            self.crashes += 1
            self._c_crashes.inc()
            self._tracer.instant(
                "fleet_engine_crash", {"engine": m.idx, "error": repr(exc)})
            if m.state == HEALTHY:
                self._quarantine_locked(m, reason="crash")
            else:
                # crashed while already quarantined: push the gate out again
                m.readmit_at = time.monotonic() + self._readmit_backoff(m)
            self._failover_locked(m, clear_assignments=True)

    def _on_member_giveup(self, m: _Member, exc: BaseException) -> None:
        """Restart budget exhausted: the member is beyond saving. Mark it
        DEAD (permanent), fail its work over; if it was the LAST live
        member, shed everything still queued — an explicit retry_after
        beats a queue that waits forever."""
        with self._lock:
            m.state = DEAD
            self._tracer.instant("fleet_engine_dead", {"engine": m.idx})
            self._failover_locked(m, clear_assignments=True)
            if all(mm.state in _OUT for mm in self._members):
                for lane, q in self._lanes.items():
                    while q:
                        frid = q.popleft()
                        tr = self._tracked[frid]
                        if tr.state != _QUEUED:
                            continue
                        self._shed_tracked_locked(tr, "all_members_dead")

    def _on_control_giveup(self, exc: BaseException) -> None:
        import traceback as _tb

        with self._lock:
            self._error = "".join(
                _tb.format_exception(type(exc), exc, exc.__traceback__, limit=5))

    def _shed_tracked_locked(self, tr: _Tracked, reason: str) -> None:
        tr.state = _SHED
        tr.done_at = time.monotonic()
        tr.result = ShedRequest(tr.frid, self.retry_after_s, reason)
        self._ready[tr.frid] = tr.result
        self._count_shed_locked(reason)
        # a post-admission shed is an availability miss (admission-time
        # sheds never reach this path — they raise before tracking)
        self._slo_avail.record_event(False)
        if tr.ctx is not None:
            self._tracer.instant(
                "fleet_request_shed",
                {"frid": tr.frid, "reason": reason, **ctx_args(tr.ctx)},
            )

    # -- failover --------------------------------------------------------------

    def _failover_locked(self, m: _Member, clear_assignments: bool) -> None:
        """Re-queue (front of lane) every request currently attributed to
        ``m``. ``clear_assignments`` distinguishes a crash-reset (the
        engine will NEVER finish those rids — drop the map) from a
        quarantine of a possibly-alive member (keep the map so a late
        completion is recognized and deduped instead of orphaned)."""
        moved = 0
        for erid, frid in list(m.assigned.items()):
            tr = self._tracked.get(frid)
            if tr is None or tr.state != _DISPATCHED or tr.member != m.idx:
                continue
            if tr.dispatches >= self.max_dispatches:
                self._shed_tracked_locked(tr, "dispatch_budget")
                continue
            tr.state, tr.member, tr.erid = _QUEUED, -1, -1
            self._lanes[tr.lane].appendleft(frid)  # failover beats new work
            moved += 1
            if tr.ctx is not None:
                # one node per re-queued request, PARENTED to the request's
                # own span — the failover leg of the causal tree (the
                # aggregate fleet_failover instant below stays engine-level)
                self._tracer.instant(
                    "fleet_failover_redispatch",
                    {"frid": frid, "engine": m.idx, **ctx_args(tr.ctx.child())},
                )
        if clear_assignments:
            m.assigned.clear()
        if moved:
            self.redispatched += moved
            self._c_redispatched.inc(moved)
            self._tracer.instant(
                "fleet_failover", {"engine": m.idx, "redispatched": moved})

    # -- dispatcher ------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            fault_point("fleet.dispatch_delay")
            if not self._dispatch_once():
                self._stop.wait(self.idle_sleep_s)

    def _dispatch_once(self) -> bool:
        """Move ONE request from the lanes onto an engine: interactive
        strictly before batch. Two-phase so the (possibly slow) engine
        submit never runs under the fleet lock."""
        with self._lock:
            pick = None
            for lane in self.LANES:
                q = self._lanes[lane]
                while q:
                    tr = self._tracked[q[0]]
                    if tr.state != _QUEUED:  # settled late or shed: stale entry
                        q.popleft()
                        continue
                    m = self._select_member_locked(tr)
                    if m is None:
                        break  # no capacity for this lane's head right now
                    q.popleft()
                    tr.state = _DISPATCHING
                    tr.dispatches += 1
                    pick = (tr, m)
                    break
                if pick is not None:
                    break
            if pick is None:
                return False
        tr, m = pick
        if self.disaggregate and m.role == "prefill":
            return self._dispatch_handoff(tr, m)
        try:
            # the dispatch span hangs under the request's node and is the
            # ACTIVE context while the engine admits — engine.submit
            # captures it onto its Request, linking the engine-side leg
            with self._tracer.ctx_span(
                "fleet/dispatch",
                {"frid": tr.frid, "engine": m.idx, "attempt": tr.dispatches},
                ctx=tr.ctx,
            ):
                # no member lock: submit only queues, and the member's
                # stepper holds that lock through its whole step
                erid = m.engine.submit(tr.prompt, tr.max_new_tokens)
        except Exception:
            # pre-validated at submit(), so this is an engine in a bad
            # place — shed explicitly rather than wedge the dispatcher
            with self._lock:
                self._shed_tracked_locked(tr, "dispatch_error")
            return True
        with self._lock:
            m.assigned[erid] = tr.frid
            if tr.state == _DISPATCHING:
                tr.state, tr.member, tr.erid = _DISPATCHED, m.idx, erid
                if m.state != HEALTHY:
                    # the member sickened between the two phases; requeue —
                    # the assignment stays so a late completion still dedups
                    tr.state, tr.member, tr.erid = _QUEUED, -1, -1
                    self._lanes[tr.lane].appendleft(tr.frid)
            # else: a late duplicate completion settled it mid-submit;
            # the new assignment stays and will be suppressed on arrival
        return True

    def _select_member_locked(self, tr: _Tracked):
        if self.disaggregate:
            # disaggregated split: route to a prefill-role member only when a
            # decode-role member has adoption capacity (a handoff with no
            # adopter is wasted prefill work); otherwise fall through to
            # whatever mixed members exist
            pre = [m for m in self._members
                   if m.state == HEALTHY and m.role == "prefill"]
            dec = [m for m in self._members
                   if m.state == HEALTHY and m.role == "decode"
                   and m.engine.pending() < self.max_pending_per_engine]
            if pre and dec:
                self._prefill_rr += 1
                return pre[self._prefill_rr % len(pre)]
        cands = [
            m for m in self._members
            if m.state == HEALTHY and m.role == "mixed"
            and m.engine.pending() < self.max_pending_per_engine
        ]
        if not cands:
            return None
        if tr.lane == "batch":
            # the LoadBalancer strategy chain over the healthy members
            self._lb.engines = [m.engine for m in cands]
            try:
                return cands[self._lb.select_engine(tr.prompt)]
            except ServiceSaturated:
                return None
        # interactive: tail-latency-aware — expected wait is queue depth
        # times this member's recent per-request latency, discounted by
        # its speculative accept rate (a member accepting 3 tokens per
        # dispatch clears its queue ~3x faster than its latency EMA alone
        # suggests while the EMA catches up), plus KV pressure
        fallback = max((m.lat_ema for m in cands if m.lat_ema is not None),
                       default=1.0)

        def score(m: _Member) -> float:
            lat = m.lat_ema if m.lat_ema is not None else fallback
            return ((m.engine.pending() + 1) * lat / max(m.spec_ema, 1e-3)
                    + self._lb._kv_utilization(m.engine))

        return min(cands, key=score)

    def _select_decode_locked(self):
        cands = [m for m in self._members
                 if m.state == HEALTHY and m.role == "decode"
                 and m.engine.pending() < self.max_pending_per_engine]
        if not cands:
            return None
        fallback = max((m.lat_ema for m in cands if m.lat_ema is not None),
                       default=1.0)

        def score(m: _Member) -> float:
            lat = m.lat_ema if m.lat_ema is not None else fallback
            return ((m.engine.pending() + 1) * lat
                    + self._lb._kv_utilization(m.engine))

        return min(cands, key=score)

    def _dispatch_handoff(self, tr: _Tracked, pm: _Member) -> bool:
        """Disaggregated dispatch (the ``disaggregate`` flag): run the
        bucketed prefill on a prefill-role member, then hand its paged KV
        block contents to a decode-role member that adopts the sequence
        and continues decoding. The request is attributed to the DECODE
        member — failover replays from the prompt exactly as in the mixed
        path — and a prefill that already finished the request (eos first
        token, or a one-token budget) settles directly."""
        try:
            with self._tracer.ctx_span(
                "fleet/prefill_handoff",
                {"frid": tr.frid, "engine": pm.idx, "attempt": tr.dispatches},
                ctx=tr.ctx,
            ):
                with pm.lock:
                    ho = pm.engine.prefill_detached(tr.prompt, tr.max_new_tokens)
        except Exception:
            with self._lock:
                self._shed_tracked_locked(tr, "dispatch_error")
            return True
        now = time.monotonic()
        if ho is None:
            # the prefill member is out of slots/blocks this instant:
            # requeue at the front and let the dispatcher idle one beat
            return self._requeue_dispatching(tr)
        with self._lock:
            if tr.state != _DISPATCHING:
                return True  # settled concurrently by a late duplicate
            if tr.first_token_at is None:
                # the first token exists the moment the prefill sampled it
                tr.first_token_at = now
                self._slo_ttft.record(now - tr.submitted_at)
                pm.ttft_hist.observe(now - tr.submitted_at)
            if ho.finished is not None:
                tr.state, tr.result, tr.done_at = _DONE, ho.finished, now
                self._ready[tr.frid] = ho.finished
                self.completed += 1
                self._c_completed.inc()
                lat = now - tr.submitted_at
                self._slo_latency.record(lat)
                pm.lat_hist.observe(lat)
                self._slo_avail.record_event(True)
                return True
            dm = self._select_decode_locked()
        if dm is None:
            # no adoption capacity: the handoff is self-contained host
            # state, dropping it leaks nothing — replay from the prompt
            return self._requeue_dispatching(tr)
        try:
            with dm.lock:
                erid = dm.engine.adopt_handoff(ho)
        except Exception:
            with self._lock:
                self._shed_tracked_locked(tr, "dispatch_error")
            return True
        if erid is None:
            return self._requeue_dispatching(tr)
        with self._lock:
            dm.assigned[erid] = tr.frid
            if tr.state == _DISPATCHING:
                tr.state, tr.member, tr.erid = _DISPATCHED, dm.idx, erid
                if dm.state != HEALTHY:
                    tr.state, tr.member, tr.erid = _QUEUED, -1, -1
                    self._lanes[tr.lane].appendleft(tr.frid)
        return True

    def _requeue_dispatching(self, tr: _Tracked) -> bool:
        with self._lock:
            if tr.state == _DISPATCHING:
                tr.state = _QUEUED
                self._lanes[tr.lane].appendleft(tr.frid)
        return False

    # -- health monitor --------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self._watchdog.check()
            for m in list(self._members):
                with self._lock:
                    state = m.state
                if state in _OUT:
                    continue
                ok = self._probe(m)
                self._on_probe(m, ok)
            self._profiler_tick()

    def _profiler_tick(self) -> None:
        """The reference feeds its armed triggered profiler here once per
        monitor sweep (a capture when the TTFT burn rate crosses its
        threshold); ``obs/profiling`` is not ported yet (ROADMAP A7)."""

    def _probe(self, m: _Member) -> bool:
        """One liveness probe: supervised thread alive, watchdog beat
        fresh, and the probe itself not chaos-dropped. Runs OUTSIDE the
        fleet lock (the drop site may sleep under a delay fault)."""
        alive = m.child.is_alive() if m.child is not None else True
        fresh = m.name in self._watchdog.alive
        dropped = should_drop("fleet.probe_drop")
        return alive and fresh and not dropped

    def _on_probe(self, m: _Member, ok: bool) -> None:
        now = time.monotonic()
        with self._lock:
            if ok:
                # the first healthy round ends the warm-up grace: from here
                # on the member is held to the normal probe deadline
                m.warming = False
                m.probe_failures = 0
                m.probe_successes += 1
                if (m.state == QUARANTINED
                        and now >= m.readmit_at
                        and m.probe_successes >= self.readmit_probes):
                    m.state = HEALTHY
                    # re-admission grace: the restarted stepper may still be
                    # slow; failures are ignored until its first healthy
                    # round
                    m.warming = True
                    m.warm_deadline = now + self.warmup_grace_s
                    self.readmissions += 1
                    self._c_readmissions.inc()
                    self._g_health.set(0.0, {"engine": str(m.idx)})
                    self._tracer.instant("fleet_readmit", {"engine": m.idx})
            else:
                if m.warming and now < m.warm_deadline:
                    # warm-up grace (scale-up / re-admission): slow first
                    # probes do NOT count toward quarantine
                    return
                m.probe_successes = 0
                m.probe_failures += 1
                if (m.state == HEALTHY
                        and m.probe_failures >= self.quarantine_after):
                    self._quarantine_locked(m, reason="probe")
                    # the member may well still be alive (false positive):
                    # keep its assignments so late completions dedup
                    self._failover_locked(m, clear_assignments=False)

    def _readmit_backoff(self, m: _Member) -> float:
        return min(self.readmit_backoff_s * (2.0 ** max(m.quarantines - 1, 0)),
                   self.readmit_backoff_max_s)

    def _quarantine_locked(self, m: _Member, reason: str) -> None:
        m.state = QUARANTINED
        m.quarantines += 1
        m.probe_successes = 0
        m.readmit_at = time.monotonic() + self._readmit_backoff(m)
        self.quarantines_total += 1
        self._c_quarantines.inc()
        self._g_health.set(1.0, {"engine": str(m.idx)})
        self._tracer.instant("fleet_quarantine", {"engine": m.idx, "reason": reason})
