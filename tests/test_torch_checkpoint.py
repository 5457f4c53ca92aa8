"""The port's checkpoints (``rl_tpu_torch.checkpoint``) against
``rl_tpu.checkpoint``, on the CPU: the registry's directory layout,
``latest_step`` over complete, partial and foreign directories, schema
migrations, the JSON and pickle adapters read by the other package, the
host RNG capture, and the port's own array format (``torch.save`` of CPU
copies, ``torch.Generator`` states, ArrayDicts; restored onto the
template's devices, in place with ``restore_into``); and the
``EmergencyCheckpointer``.

Every path is under ``tmp_path``; the resilience files' autouse fixture
checks that no test leaves an injector, a signal handler, a moved global
generator or a thread behind (a load with ``capture_rng`` sets the global
generators, so those tests put them back).
"""

import contextlib
import json
import os
import random

import numpy as np
import pytest
import torch
from test_torch_resilience import no_process_state  # noqa: F401

from rl_tpu.checkpoint import Checkpoint as JaxCheckpoint
from rl_tpu.checkpoint import GlobalRNGState as JaxGlobalRNGState
from rl_tpu.checkpoint import JSONAdapter as JaxJSONAdapter
from rl_tpu.checkpoint import PickleAdapter as JaxPickleAdapter
from rl_tpu_torch.checkpoint import (ArrayTreeAdapter, Checkpoint, GlobalRNGState, JSONAdapter,
                                     PickleAdapter, restore_into, to_tree)
from rl_tpu_torch.data import ArrayDict
from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
from rl_tpu_torch.resilience import EmergencyCheckpointer
from rl_tpu_torch.trainers import Adam

torch.set_num_threads(1)


@contextlib.contextmanager
def global_rng_kept():
    py, npst = random.getstate(), np.random.get_state()
    try:
        yield
    finally:
        random.setstate(py)
        np.random.set_state(npst)


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    torch.rand(5, generator=gen)  # a generator part way through its stream
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    return {"w": torch.randn(3, 4, generator=gen), "view": base[1:3, ::2],
            "ints": torch.arange(5, dtype=torch.int64), "flags": torch.tensor([True, False]),
            "half": torch.randn(4, generator=gen).to(torch.bfloat16),
            "ad": ArrayDict(x=torch.ones(2, 3), nested=ArrayDict(y=torch.zeros(2))),
            "seq": [torch.tensor(1.5), (3, "s", None)], "count": 7, "gen": gen}


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, (dict, ArrayDict)):
        assert list(a.keys()) == list(b.keys())
        for k in a.keys():
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a == b


def test_array_tree_round_trips_onto_the_template(tmp_path):
    """Tensors of every dtype (a strided view saves only its elements),
    ArrayDicts, lists, tuples, scalars and a generator part way through
    its stream come back equal, as new tensors; the restored generator
    draws what the saved one draws next."""
    tree = _tree()
    ArrayTreeAdapter().save(str(tmp_path / "a"), tree)
    out = ArrayTreeAdapter().load(str(tmp_path / "a"), template=_tree(seed=1))
    _assert_trees_equal(out, tree)
    assert out["w"].data_ptr() != tree["w"].data_ptr()
    assert isinstance(out["ad"], ArrayDict) and out["ad"].batch_shape == (2,)
    assert torch.equal(torch.rand(3, generator=out["gen"]), torch.rand(3, generator=tree["gen"]))
    view = ArrayTreeAdapter().load(str(tmp_path / "a"))["view"]  # no template: the CPU
    assert view.shape == (2, 3) and view.untyped_storage().nbytes() == 6 * 4


def test_a_template_of_another_layout_raises(tmp_path):
    ArrayTreeAdapter().save(str(tmp_path / "a"), {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="template"):
        ArrayTreeAdapter().load(str(tmp_path / "a"), template={"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="template"):
        ArrayTreeAdapter().load(str(tmp_path / "a"), template={"v": torch.zeros(3)})
    with pytest.raises(TypeError, match="cannot save"):
        ArrayTreeAdapter().save(str(tmp_path / "c"), {"obj": object()})


def test_restore_into_writes_live_tensors_generators_and_adam_in_place(tmp_path):
    """``to_tree`` turns Adam into its parameters, moments and count;
    ``restore_into`` copies a loaded tree into the live objects without
    replacing them (a captured graph keeps its addresses)."""
    params = [torch.randn(3, 2), torch.randn(4)]
    adam = Adam(params, 1e-2)
    adam.step([torch.ones(3, 2), torch.ones(4)], torch.tensor(True))
    gen = torch.Generator().manual_seed(4)
    live = {"opt": adam, "gen": gen, "n": 3}
    saved = to_tree(live)
    assert set(saved["opt"]) == {"params", "mu", "nu", "count"}
    ArrayTreeAdapter().save(str(tmp_path / "s"), live)
    want = {"p": [p.clone() for p in params], "mu": [m.clone() for m in adam.mu],
            "state": gen.get_state()}
    adam.step([torch.ones(3, 2), torch.ones(4)], torch.tensor(True))
    torch.rand(4, generator=gen)
    addresses = [p.data_ptr() for p in params + adam.mu + adam.nu]
    merged = restore_into(live, ArrayTreeAdapter().load(str(tmp_path / "s"), template=live))
    assert merged["opt"] is adam and merged["gen"] is gen and merged["n"] == 3
    assert [p.data_ptr() for p in params + adam.mu + adam.nu] == addresses
    assert all(torch.equal(a, b) for a, b in zip(params, want["p"]))
    assert all(torch.equal(a, b) for a, b in zip(adam.mu, want["mu"]))
    assert adam.count.item() == 1.0 and torch.equal(gen.get_state(), want["state"])


def test_layout_and_adapters_read_by_the_other_package(tmp_path):
    """The same directory layout as the reference (``step_<n>``, a
    directory a component, ``_rng``, ``meta.json`` with the same keys);
    JSON and pickle components written by one package load in the other."""
    state = {"step_count": 3, "history": [1.5, 2.5]}
    host = {"names": ["a", "b"], "t": (1, 2)}
    ours = Checkpoint(str(tmp_path / "ours"))
    ours.register("counters", lambda: state, lambda v: None, adapter=JSONAdapter())
    ours.register("host", lambda: host, lambda v: None, adapter=PickleAdapter())
    ref = JaxCheckpoint(str(tmp_path / "ref"))
    ref.register("counters", lambda: state, lambda v: None, adapter=JaxJSONAdapter())
    ref.register("host", lambda: host, lambda v: None, adapter=JaxPickleAdapter())
    d_ours, d_ref = ours.save(2), ref.save(2)
    assert sorted(os.listdir(d_ours)) == sorted(os.listdir(d_ref))
    assert json.load(open(os.path.join(d_ours, "meta.json"))) == \
        json.load(open(os.path.join(d_ref, "meta.json")))
    assert JaxJSONAdapter().load(os.path.join(d_ours, "counters")) == state
    assert JSONAdapter().load(os.path.join(d_ref, "counters")) == state
    assert JaxPickleAdapter().load(os.path.join(d_ours, "host")) == host
    assert PickleAdapter().load(os.path.join(d_ref, "host")) == host
    assert not [n for n in os.listdir(os.path.join(d_ours, "counters")) if n.startswith(".tmp")]


def test_latest_step_skips_partial_and_foreign_directories_as_the_reference(tmp_path):
    root = tmp_path / "ck"
    ckpt = Checkpoint(str(root), capture_rng=False)
    ckpt.register("w", lambda: {"w": torch.ones(2)}, lambda v: None)
    for step in (1, 4):
        ckpt.save(step)
    os.makedirs(root / "step_9" / "w")  # partial: no meta.json
    os.makedirs(root / "step_x")
    (root / "notes").write_text("foreign")
    assert ckpt.latest_step() == JaxCheckpoint(str(root)).latest_step() == 4
    assert Checkpoint(str(tmp_path / "none")).latest_step() is None


def test_a_save_that_fails_part_way_never_looks_complete(tmp_path):
    """A component that raises during a save over step 4 leaves step 4
    without ``meta.json``: ``latest_step`` falls back to step 2."""
    ckpt = Checkpoint(str(tmp_path), capture_rng=False)
    ok = {"fail": False}

    def getter():
        if ok["fail"]:
            raise RuntimeError("disk went away")
        return {"w": torch.ones(2)}

    ckpt.register("w", getter, lambda v: None)
    ckpt.save(2)
    ckpt.save(4)
    ok["fail"] = True
    with pytest.raises(RuntimeError, match="disk went away"):
        ckpt.save(4)
    assert ckpt.latest_step() == 2
    assert not os.path.exists(tmp_path / "step_4" / "meta.json")


def test_migration_runs_once_as_the_reference(tmp_path):
    """The reference's ``test_migration``: an old schema without a
    migration raises; with one it migrates once and records the version."""
    ckpt = Checkpoint(str(tmp_path / "ck3"), capture_rng=False)
    state = {"v": 1}
    ckpt.register("counters", lambda: state, lambda v: state.update(v), adapter=JSONAdapter())
    d = ckpt.save(step=1)
    meta = json.load(open(os.path.join(d, "meta.json")))
    meta["schema_version"] = 0
    json.dump(meta, open(os.path.join(d, "meta.json"), "w"))
    with pytest.raises(RuntimeError, match="no migration registered"):
        ckpt.load(step=1)
    migrated = []
    ckpt.register_migration(0, lambda path: migrated.append(path))
    ckpt.load(step=1)
    ckpt.load(step=1)
    assert migrated == [d]
    assert json.load(open(os.path.join(d, "meta.json")))["schema_version"] == 1


def test_global_rng_state_is_the_reference_s():
    """The same capture as the reference's (Python's and numpy's state),
    restorable by either package; a load with ``capture_rng`` restores the
    host generators as they were at the save."""
    with global_rng_kept():
        random.seed(5)
        np.random.seed(6)
        ours, ref = GlobalRNGState.get(), JaxGlobalRNGState.get()
        assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
        a = (random.random(), np.random.rand())
        JaxGlobalRNGState.set(ours)
        assert (random.random(), np.random.rand()) == a
        GlobalRNGState.set(ref)
        assert (random.random(), np.random.rand()) == a


def test_checkpoint_load_restores_the_host_generators(tmp_path):
    with global_rng_kept():
        ckpt = Checkpoint(str(tmp_path))
        ckpt.register("w", lambda: {"w": torch.ones(1)}, lambda v: None)
        ckpt.save(1)
        a = np.random.rand(3)
        ckpt.load(1)
        np.testing.assert_array_equal(np.random.rand(3), a)


def test_emergency_checkpointer_round_trip(tmp_path):
    """Arrays (with an Adam and a generator) and JSON meta at a step; the
    latest step, a restore onto a template, the saves counted in the
    given registry, and no checkpoint: ``FileNotFoundError``."""
    reg = MetricsRegistry()
    em = EmergencyCheckpointer(str(tmp_path / "em"), registry=reg, tracer=TraceRecorder())
    with pytest.raises(FileNotFoundError):
        em.restore({"w": torch.zeros(2)})
    params = [torch.randn(4)]
    adam = Adam(params, 1e-3)
    arrays = {"opt": adam, "w": torch.arange(3.0), "gen": torch.Generator().manual_seed(2)}
    em.save(5, arrays, {"frames": 80, "rng": {"state": 2**100}})
    em.save(3, arrays, {"frames": 48})
    assert em.latest_step() == 5
    out, meta, step = em.restore(arrays)
    assert step == 5 and meta == {"frames": 80, "rng": {"state": 2**100}}
    assert torch.equal(out["opt"]["params"][0], params[0]) and out["opt"]["count"].item() == 0
    assert torch.equal(out["gen"].get_state(), arrays["gen"].get_state())
    assert reg.counter("rl_tpu_resilience_emergency_checkpoints_total").value() == 2
