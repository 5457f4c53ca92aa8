"""SLO-burn autoscaler: elastic membership control for the serving fleet
(counterpart of :mod:`rl_tpu.models.autoscale`).

- **Scale-up** when the ``fleet_ttft`` error-budget burn rate (the
  fleet's :class:`~rl_tpu_torch.obs.SLOEngine`) over ``burn_window_s``
  crosses ``scale_up_burn``: build a member through ``engine_factory``,
  capture its program ladder and join it through
  :meth:`~rl_tpu_torch.models.fleet.ServingFleet.add_member`. A graph is
  captured over its engine's own buffers, so a new member always captures
  its own ladder (the reference's identical replica loads compiled
  executables from its store instead). Scale-up is held to that: with
  ``require_compile_free`` a capture during the warm-up beyond the new
  member's ladder (``compile_delta`` above ``ladder``) raises.
- **Scale-down** when the fleet's sharing-adjusted free KV fraction
  shows ``scale_down_free_frac`` slack sustained for
  ``scale_down_sustain_s``: retire the least-loaded member through
  :meth:`~rl_tpu_torch.models.fleet.ServingFleet.scale_down`, which
  drains its outstanding requests through the exactly-once failover path.
  Each scale-down dumps the decision trail to the flight recorder, when
  one is given.
- **Cooldown** gates both directions so one burst cannot thrash
  membership.

One daemon control thread runs :meth:`Autoscaler.poll_once` every
``poll_interval_s``. The decision state lives under the autoscaler's own
leaf lock; the fleet's signals are read before taking it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable

__all__ = ["Autoscaler", "AutoscalerConfig"]

# env knobs: every threshold is tunable without a redeploy
ENV_PREFIX = "RL_TPU_AUTOSCALE_"


@dataclasses.dataclass
class AutoscalerConfig:
    """Control-loop thresholds. Defaults suit the production cadence
    (60 s burn window); short runs shrink the windows to seconds."""

    min_members: int = 1
    max_members: int = 4
    burn_window_s: float = 60.0
    scale_up_burn: float = 2.0  # fleet_ttft burn rate that triggers growth
    scale_down_free_frac: float = 0.6  # KV slack fraction that allows shrink
    scale_down_sustain_s: float = 10.0  # slack must persist this long
    # KV slack alone is NOT idleness: under overload the queue waits in
    # the admission lanes, not in KV, so free blocks stay high while the
    # SLO burns. Slack only accumulates while burn is also below this.
    scale_down_max_burn: float = 0.25
    cooldown_s: float = 5.0  # between ANY two membership changes
    poll_interval_s: float = 0.25
    role_for_new: str = "mixed"  # role given to scale-up members
    # raise if a scale-up's warm-up captured beyond the new member's ladder
    require_compile_free: bool = True

    @classmethod
    def from_env(cls, **overrides) -> "AutoscalerConfig":
        """Construct from ``RL_TPU_AUTOSCALE_*`` environment variables
        (UP_BURN, DOWN_FREE_FRAC, SUSTAIN_S, DOWN_MAX_BURN, COOLDOWN_S,
        POLL_S, BURN_WINDOW_S, MIN, MAX), with explicit kwargs winning."""
        env_map = {
            "scale_up_burn": ("UP_BURN", float),
            "scale_down_free_frac": ("DOWN_FREE_FRAC", float),
            "scale_down_sustain_s": ("SUSTAIN_S", float),
            "scale_down_max_burn": ("DOWN_MAX_BURN", float),
            "cooldown_s": ("COOLDOWN_S", float),
            "poll_interval_s": ("POLL_S", float),
            "burn_window_s": ("BURN_WINDOW_S", float),
            "min_members": ("MIN", int),
            "max_members": ("MAX", int),
        }
        kw: dict[str, Any] = {}
        for field, (suffix, cast) in env_map.items():
            raw = os.environ.get(ENV_PREFIX + suffix, "")
            if raw:
                try:
                    kw[field] = cast(raw)
                except ValueError:
                    pass
        kw.update(overrides)
        return cls(**kw)


class Autoscaler:
    """The control loop over an elastic :class:`ServingFleet`.

    Args:
        fleet: the fleet to control (must expose ``ttft_burn_rate``,
            ``kv_slack``, ``n_routable``, ``add_member``, ``scale_down``).
        engine_factory: zero-arg callable building a NEW replica engine
            sharing the fleet's ShapeBuckets and device. Called only on
            scale-up, outside every lock.
        config: :class:`AutoscalerConfig` (default: from_env()).
        registry: optional metrics registry; defaults to the process one.
        flight: optional :class:`~rl_tpu_torch.obs.FlightRecorder`; when
            given, the autoscaler registers a ``autoscaler`` state source
            and dumps the decision trail on every scale-down.
    """

    def __init__(
        self,
        fleet,
        engine_factory: Callable[[], Any],
        *,
        config: AutoscalerConfig | None = None,
        registry=None,
        flight=None,
    ):
        self._fleet = fleet
        self._engine_factory = engine_factory
        self.cfg = config if config is not None else AutoscalerConfig.from_env()
        self._flight = flight
        # ALL mutable decision state below lives under this leaf lock:
        # poll_once runs on the control thread, snapshot() on scrape and
        # dump threads
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        self._slack_since: float | None = None
        self._last_action_at = float("-inf")
        self.polls = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.failures = 0
        self.last_burn = 0.0
        self.last_free_frac = 1.0
        self.decisions: list[dict] = []

        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        p = "rl_tpu_autoscaler"
        self._c_up = registry.counter(
            f"{p}_scale_ups_total", "autoscaler scale-up decisions")
        self._c_down = registry.counter(
            f"{p}_scale_downs_total", "autoscaler scale-down decisions")
        self._c_failures = registry.counter(
            f"{p}_failures_total", "autoscaler decision/poll failures")
        self._g_burn = registry.gauge(
            f"{p}_burn_rate", "last observed fleet_ttft burn rate")
        self._g_free = registry.gauge(
            f"{p}_kv_free_frac", "last observed fleet KV slack fraction")
        if flight is not None:
            flight.add_source("autoscaler", self.snapshot)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        t = threading.Thread(
            target=self._loop, name="fleet-autoscaler", daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.cfg.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                with self._lock:
                    self.failures += 1
                self._c_failures.inc()

    # -- the control loop body (deterministic, directly testable) --------------

    def poll_once(self, now: float | None = None):
        """One control decision. Reads the fleet's signals (which take
        the fleet's own locks) BEFORE the autoscaler lock, decides under
        the autoscaler lock, acts OUTSIDE both. Returns the decision dict
        when membership changed (or a change was attempted), else None."""
        now = time.monotonic() if now is None else now
        burn = self._fleet.ttft_burn_rate(self.cfg.burn_window_s)
        free, total = self._fleet.kv_slack()
        routable = self._fleet.n_routable()
        free_frac = free / total if total > 0 else 1.0
        action = None
        with self._lock:
            self.polls += 1
            self.last_burn = burn
            self.last_free_frac = free_frac
            if (free_frac < self.cfg.scale_down_free_frac
                    or burn > self.cfg.scale_down_max_burn):
                self._slack_since = None  # pressure is back: restart the clock
            elif self._slack_since is None:
                self._slack_since = now
            if now - self._last_action_at >= self.cfg.cooldown_s:
                if (burn > self.cfg.scale_up_burn
                        and routable < self.cfg.max_members):
                    action = "scale_up"
                elif (routable > self.cfg.min_members
                        and self._slack_since is not None
                        and now - self._slack_since
                        >= self.cfg.scale_down_sustain_s):
                    action = "scale_down"
            if action is not None:
                # cooldown starts at the DECISION, success or not — a
                # failing factory must not retry at poll cadence
                self._last_action_at = now
                self._slack_since = None
        self._g_burn.set(burn)
        self._g_free.set(free_frac)
        if action == "scale_up":
            return self._do_scale_up(burn, free_frac, routable, now)
        if action == "scale_down":
            return self._do_scale_down(burn, free_frac, routable, now)
        return None

    def _do_scale_up(self, burn, free_frac, routable, now) -> dict:
        try:
            engine = self._engine_factory()
            ev = self._fleet.add_member(
                engine, warm=True, role=self.cfg.role_for_new)
        except Exception as e:
            dec = {
                "action": "scale_up_failed", "error": repr(e),
                "burn": burn, "free_frac": free_frac,
                "members_before": routable, "t": now,
            }
            with self._lock:
                self.failures += 1
                self.decisions.append(dec)
            self._c_failures.inc()
            return dec
        dec = {
            "action": "scale_up", "member": ev["idx"],
            "burn": burn, "free_frac": free_frac,
            "members_before": routable,
            "compile_delta": ev.get("compile_delta"), "ladder": ev.get("ladder"),
            "by_program": ev.get("by_program"), "t": now,
        }
        with self._lock:
            self.scale_ups += 1
            self.decisions.append(dec)
        self._c_up.inc()
        foreign = (ev.get("compile_delta") or 0) - (ev.get("ladder") or 0)
        if self.cfg.require_compile_free and foreign:
            # something beside the new member's own ladder captured during
            # its warm-up: a serving member met a shape its ladder lacks
            raise RuntimeError(
                f"scale-up was not compile-free: {ev['compile_delta']} "
                f"capture(s) for a ladder of {ev.get('ladder') or 0}, "
                f"in {ev.get('by_program')}"
            )
        return dec

    def _do_scale_down(self, burn, free_frac, routable, now) -> dict | None:
        ev = self._fleet.scale_down(reason="kv_slack")
        if ev is None:
            dec = {
                "action": "scale_down_skipped", "burn": burn,
                "free_frac": free_frac, "members_before": routable, "t": now,
            }
            with self._lock:
                self.decisions.append(dec)
            return dec
        dec = {
            "action": "scale_down", "member": ev["idx"],
            "burn": burn, "free_frac": free_frac,
            "members_before": routable,
            "outstanding_redispatched": ev.get("outstanding_redispatched"),
            "salvaged": ev.get("salvaged"), "t": now,
        }
        with self._lock:
            self.scale_downs += 1
            self.decisions.append(dec)
        self._c_down.inc()
        if self._flight is not None:
            # the scale-down decision trail, on disk: why the member was
            # drained, what moved, and the fleet state around it
            try:
                self._flight.dump("autoscale_down")
            except Exception:
                pass
        return dec

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Decision-trail state (the flight recorder's ``autoscaler``
        source)."""
        with self._lock:
            return {
                "polls": self.polls,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "failures": self.failures,
                "last_burn": self.last_burn,
                "last_free_frac": self.last_free_frac,
                "slack_since": self._slack_since,
                "decisions": list(self.decisions[-50:]),
                "config": dataclasses.asdict(self.cfg),
            }
