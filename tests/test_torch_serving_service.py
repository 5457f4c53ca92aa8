"""The port's ``LoadBalancer``, ``ServingService``, ``RemoteEngine`` and
TCP control plane against ``rl_tpu``'s, on the CPU.

The balancer picks the same replica sequence as the reference's under
every strategy chain, on the same load changes. The wire is the
reference's, byte for byte: the port's client drives the reference's
service and the reference's client the port's, with the same replies to
the same commands (greedy tokens equal to the JAX engine's), and the
command server and client answer each other across packages, binary
frames included. Sockets bind 127.0.0.1:0; every service is shut down
(its threads joined) in ``finally``.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.comm import BinaryReply as JaxBinaryReply
from rl_tpu.comm import TCPCommandClient as JaxClient
from rl_tpu.comm import TCPCommandServer as JaxServer
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import LoadBalancer as JaxLoadBalancer
from rl_tpu.models import RemoteEngine as JaxRemote
from rl_tpu.models import ServiceSaturated as JaxSaturated
from rl_tpu.models import ServingService as JaxService
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.comm import BinaryReply, TCPCommandClient, TCPCommandServer
from rl_tpu_torch.models import (ContinuousBatchingEngine, LoadBalancer, RemoteEngine,
                                 ServiceSaturated, ServingService, TransformerConfig,
                                 TransformerLM, params_from_flax)
from rl_tpu_torch.obs import MetricsRegistry
from rl_tpu_torch.resilience import Fault, FaultInjector, Supervisor, injection
from test_torch_resilience import no_process_state  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16), greedy=True)
LENGTHS = [3, 8, 12, 16, 5, 9, 7, 11]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    from rl_tpu.compile import registry as jax_registry

    jax_registry._ATTR._ensure_thread()  # the reference's lasting daemon thread, started early
    return jm, params, tm


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SMALL["vocab_size"], n).astype(np.int32) for n in LENGTHS]


def reference(jm, params, max_new=6):
    eng = JaxEngine(jm, params, **ENGINE)
    rids = [eng.submit(p, max_new) for p in prompts()]
    while eng.step():
        jax.block_until_ready(eng.dev_lens)
    out = {f.rid: f for f in eng.finished}
    return [out[r] for r in rids]


class FakeEngine:
    """What the balancer reads of an engine."""

    def __init__(self, pending, free, total=64):
        self._p, self.free_blocks, self._n_pool_blocks = pending, [0] * free, total

    def pending(self):
        return self._p

    def kv_free_blocks(self):
        return len(self.free_blocks)


@pytest.mark.parametrize("strategy", ["prefix-aware", "requests", "kv-cache", "round-robin",
                                      ("kv-cache", "requests"), ("prefix-aware", "kv-cache")])
def test_balancer_picks_the_reference_s_sequence(strategy):
    picks = []
    for cls in (LoadBalancer, JaxLoadBalancer):
        r = np.random.default_rng(7)
        loads = [(int(a), int(b)) for a, b in r.integers(0, 40, (5, 2))]
        fakes = [FakeEngine(p, f) for p, f in loads]
        lb = cls(fakes, strategy, prefix_length=4, overload_threshold=1.5)
        seq = []
        for step in range(40):
            p = r.integers(0, 16, 6) if step % 3 else None
            i = lb.select_engine(p)
            seq.append(i)
            fakes[i]._p += 1  # the pick takes the request
            fakes[i].free_blocks = fakes[i].free_blocks[:-1] or [0]
            if step % 7 == 0:
                fakes[int(r.integers(0, 5))]._p = 0
        picks.append(seq)
    assert picks[0] == picks[1]


def test_balancer_routes_real_engines_and_sheds_when_empty(models):
    jm, params, tm = models
    engs = [ContinuousBatchingEngine(tm, device="cpu", **ENGINE) for _ in range(2)]
    lb = LoadBalancer(engs, "requests")
    keys = [lb.submit(p, 6) for p in prompts()]
    assert {i for i, _ in keys} == {0, 1}
    out = lb.run_all()
    for k, ref in zip(keys, reference(jm, params)):
        np.testing.assert_array_equal(out[k].tokens, ref.tokens)
    empty = LoadBalancer([], allow_empty=True, retry_after_s=0.5)
    with pytest.raises(ServiceSaturated) as ei:
        empty.select_engine()
    assert ei.value.retry_after == 0.5
    with pytest.raises(ValueError):
        LoadBalancer([])
    with pytest.raises(ValueError, match="unknown strategy"):
        LoadBalancer(engs, "fastest")


def _serve_and_collect(remote, n_new=6):
    rids = [remote.submit(p, n_new) for p in prompts()]
    got = remote.wait_all(rids, timeout=60)
    return [got[r] for r in rids], remote.stats()


def test_port_client_drives_the_reference_s_service(models):
    jm, params, _ = models
    svc = JaxService(JaxEngine(jm, params, **ENGINE), metrics_port=None).start()
    try:
        got, stats = _serve_and_collect(RemoteEngine(*svc.address))
    finally:
        svc.shutdown()
    for g, ref in zip(got, reference(jm, params)):
        assert g["tokens"] == ref.tokens.tolist() and g["finished_reason"] == ref.finished_reason
        np.testing.assert_allclose(g["log_probs"], ref.log_probs, atol=1e-6)
    assert set(stats) == {"pending", "free_blocks", "decode_steps", "error"}


def test_reference_client_drives_the_port_s_service(models):
    jm, params, tm = models
    svc = ServingService(ContinuousBatchingEngine(tm, device="cpu", **ENGINE),
                         metrics_port=None).start()
    try:
        got, stats = _serve_and_collect(JaxRemote(*svc.address))
        assert JaxRemote(*svc.address).collect() == {}
    finally:
        svc.shutdown()
    for g, ref in zip(got, reference(jm, params)):
        assert g["tokens"] == ref.tokens.tolist() and g["finished_reason"] == ref.finished_reason
        np.testing.assert_allclose(g["log_probs"], ref.log_probs, atol=1e-4)
    assert stats["pending"] == 0 and stats["error"] is None
    assert stats["free_blocks"] == ENGINE["n_blocks"] - 1


def test_same_replies_to_the_same_commands(models):
    """The two services answer a shed, a stats and an unknown command
    alike (the shed through the handler, before the stepper runs)."""
    jm, params, tm = models
    ours = ServingService(ContinuousBatchingEngine(tm, device="cpu", **ENGINE),
                          metrics_port=None, max_queue=1, retry_after_s=0.375)
    ref = JaxService(JaxEngine(jm, params, **ENGINE), metrics_port=None, max_queue=1,
                     retry_after_s=0.375)
    payload = {"prompt": prompts()[0].tolist(), "max_new_tokens": 4}
    replies = []
    for svc in (ours, ref):
        replies.append([svc._h_submit(payload), svc._h_submit(payload), svc._h_stats(None),
                        svc._h_collect({"rids": [0, 7]})])
    assert replies[0] == replies[1]
    assert replies[0][1] == {"saturated": True, "retry_after": 0.375}
    for svc in (ours, ref):
        svc.start()
    try:
        for client in (TCPCommandClient(*ours.address), JaxClient(*ref.address)):
            with pytest.raises(RuntimeError, match="unknown command 'nope'"):
                client.call("nope")
        for remote, exc in ((RemoteEngine(*ours.address, max_shed_retries=0), ServiceSaturated),
                            (JaxRemote(*ref.address, max_shed_retries=0), JaxSaturated)):
            remote.wait_all([0], timeout=60)
            remote.submit(prompts()[1], 40)
            with pytest.raises(exc):  # the cap counts live requests too
                for _ in range(50):
                    remote.submit(prompts()[1], 40)
    finally:
        ours.shutdown()
        ref.shutdown()


def test_command_wire_crosses_packages_with_binary_frames():
    def echo(reply_cls):
        def handler(payload):
            blob = payload.pop("__blob__", b"")
            return reply_cls({"n": len(blob), **payload}, blob[::-1])

        return handler

    ours, ref = TCPCommandServer(), JaxServer()
    for srv, cls in ((ours, BinaryReply), (ref, JaxBinaryReply)):
        srv.register_handler("echo", echo(cls))
        srv.register_handler("add", lambda p: p["a"] + p["b"])
        srv.start()
    try:
        for client in (TCPCommandClient(*ours.address), JaxClient(*ours.address),
                       TCPCommandClient(*ref.address), JaxClient(*ref.address)):
            assert client.call("add", {"a": 2, "b": 3}) == 5
            out, blob = client.call_binary("echo", {"k": 1}, blob=b"abc\n\x00")
            assert out == {"n": 5, "k": 1} and blob == b"\x00\ncba"
    finally:
        ours.shutdown()
        ref.shutdown()


def test_metrics_sidecar_serves_the_engine_s_series(models):
    _, _, tm = models
    reg = MetricsRegistry()
    svc = ServingService(ContinuousBatchingEngine(tm, device="cpu", **ENGINE),
                         registry=reg).start()
    try:
        remote = RemoteEngine(*svc.address)
        remote.wait_all([remote.submit(p, 6) for p in prompts()], timeout=60)
        host, port = svc.metrics_address
        base = f"http://{host}:{port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        for series in ("rl_tpu_serving_tokens_total", "rl_tpu_serving_admissions_total",
                       "rl_tpu_serving_decode_steps_total", "rl_tpu_serving_kv_utilization",
                       'rl_tpu_serving_completions_total{reason="length"} 8'):
            assert series in text, series
        assert urllib.request.urlopen(f"{base}/healthz", timeout=10).read() == b"ok\n"
        state = json.loads(urllib.request.urlopen(f"{base}/debug/state", timeout=10).read())
        assert state["engine"]["admissions"] == 8 and state["error"] is None
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(f"{base}/profile", method="POST"),
                                   timeout=10)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/profile", timeout=10)
        assert ei.value.code == 405
    finally:
        svc.shutdown()


def test_supervised_stepper_survives_a_crash(models):
    """A ``serving.stepper`` crash restarts the supervised stepper and
    every request still completes with the JAX engine's tokens."""
    jm, params, tm = models
    sup = Supervisor(name="svc", max_restarts=3, backoff_base_s=0.001, backoff_max_s=0.002,
                     registry=MetricsRegistry())
    svc = ServingService(ContinuousBatchingEngine(tm, device="cpu", **ENGINE), metrics_port=None,
                         supervisor=sup)
    inj = FaultInjector({"serving.stepper": Fault("crash", at=(5,))},
                        registry=MetricsRegistry())
    try:
        with injection(inj):
            svc.start()
            got, _ = _serve_and_collect(RemoteEngine(*svc.address))
        assert [(s, k) for s, k, _ in inj.fired] == [("serving.stepper", "crash")]
        assert sup.restarts() == 1
    finally:
        svc.shutdown()
        sup.stop()
    for g, ref in zip(got, reference(jm, params)):
        assert g["tokens"] == ref.tokens.tolist()
