"""The port's host segment trees (``rl_tpu_torch.csrc``): the cases of
``tests/test_csrc.py`` on the port's C++ trees, each held to the
reference's numpy bodies (``rl_tpu.csrc._NumpySumTree`` and
``_NumpyMinTree``; the reference's own C++ tree is never built here), and
the port's build: hashed, atomic, at first use, raising when ``g++``
fails. Sums agree to 1e-12 relative (the tree adds in another order than
numpy's ``sum``); scans and mins exactly."""

import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
from rl_tpu.csrc import _NumpyMinTree as RefMin
from rl_tpu.csrc import _NumpySumTree as RefSum

import rl_tpu_torch.csrc as st
from rl_tpu_torch.csrc import MinSegmentTree, SumSegmentTree

ROOT = Path(__file__).resolve().parents[1]


def test_native_built_into_the_port_build_dir():
    t = SumSegmentTree(8)
    assert t.IS_NATIVE
    path = st.library_path()
    assert path.parent == ROOT / "build" / "rl_tpu_torch" and path.exists()
    assert path.name.startswith("libsegment_tree-") and path.suffix == ".so"


def test_set_get_reduce():
    t, ref = SumSegmentTree(10), RefSum(10)
    for tree in (t, ref):
        tree[np.arange(10)] = np.arange(10, dtype=np.float64)
    assert t.reduce() == ref.reduce() == 45.0
    assert t.reduce(2, 5) == ref.reduce(2, 5) == 2 + 3 + 4
    np.testing.assert_array_equal(t[np.array([3, 7])], ref[np.array([3, 7])])
    assert t[4] == 4.0


def test_scan_prefix_search():
    t = SumSegmentTree(4)
    t[np.arange(4)] = np.array([1.0, 2.0, 3.0, 4.0])  # prefix: 1, 3, 6, 10
    np.testing.assert_array_equal(t.scan([0.5, 1.5, 5.9, 6.1, 9.99]), [0, 1, 2, 3, 3])


def test_scan_matches_numpy_reference():
    rng = np.random.default_rng(0)
    vals = rng.random(1000)
    t, ref = SumSegmentTree(1000), RefSum(1000)
    t[np.arange(1000)] = vals
    ref[np.arange(1000)] = vals
    us = rng.random(256) * vals.sum()
    np.testing.assert_array_equal(t.scan(us), ref.scan(us))


def test_overwrite_updates_internal_nodes():
    t = SumSegmentTree(8)
    t[0] = 5.0
    t[0] = 1.0
    assert t.reduce() == 1.0


def test_min_semantics():
    t, ref = MinSegmentTree(6), RefMin(6)
    for tree in (t, ref):
        tree[np.arange(6)] = np.array([5.0, 3.0, 8.0, 1.0, 9.0, 2.0])
    assert t.reduce() == ref.reduce() == 1.0
    assert t.reduce(0, 3) == ref.reduce(0, 3) == 3.0
    t[3] = ref[3] = 10.0
    assert t.reduce() == ref.reduce() == 2.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_the_reference_numpy_trees(seed):
    """Batched and scalar writes (duplicates included: the last write
    wins), range sums and mins, point reads and scans, interleaved."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(5, 3000))
    ours, ref = (SumSegmentTree(cap), MinSegmentTree(cap)), (RefSum(cap), RefMin(cap))
    for _ in range(40):
        idx = rng.integers(0, cap, int(rng.integers(1, 64)))
        vals = rng.random(idx.shape) * 10.0
        for a, b in zip(ours, ref):
            a[idx] = vals
            b[idx] = vals
        j = int(rng.integers(0, cap))
        ours[0][j] = ref[0][j] = 0.5
        lo = int(rng.integers(0, cap))
        hi = int(rng.integers(lo + 1, cap + 1))
        np.testing.assert_allclose(ours[0].reduce(lo, hi), ref[0].reduce(lo, hi), rtol=1e-12)
        np.testing.assert_allclose(ours[0].reduce(), ref[0].reduce(), rtol=1e-12)
        assert ours[1].reduce(lo, hi) == ref[1].reduce(lo, hi)
        assert ours[1].reduce() == ref[1].reduce()
        np.testing.assert_array_equal(ours[0][idx], ref[0][idx])
        us = rng.random(128) * ref[0].reduce()
        got, want = ours[0].scan(us), ref[0].scan(us)
        # a draw within rounding of a prefix boundary may land either side
        cs = np.cumsum(ref[0]._v)
        near = np.abs(cs[np.minimum(want, cap - 1)] - us) < 1e-9 * cs[-1]
        assert np.all((got == want) | near)


def test_native_scan_faster_than_numpy_body():
    cap = 1 << 17
    vals = np.random.default_rng(1).random(cap)
    native, body = SumSegmentTree(cap), RefSum(cap)
    native[np.arange(cap)] = vals
    body[np.arange(cap)] = vals
    us = np.random.default_rng(2).random(64) * vals.sum() * 0.999
    idx = np.arange(64)

    def time_min(tree, runs=3, iters=200):
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(iters):
                tree[idx] = vals[:64]
                tree.scan(us)
            best = min(best, time.perf_counter() - t0)
        return best

    t_native, t_body = time_min(native), time_min(body)
    assert t_native < t_body, (t_native, t_body)


_BUILDER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    import rl_tpu_torch.csrc as st
    st.BUILD_DIR = Path(sys.argv[1])
    time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
    t = st.SumSegmentTree(1000)
    t[np.arange(1000)] = np.ones(1000)
    print(t.IS_NATIVE, t.reduce(), st.library_path())
""")


def test_two_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Both start g++ into the same empty directory within a few ms of
    each other; each loads a whole library and no temporary file stays."""
    start = time.time() + 4.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path), str(start)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        native, total, path = out.split()
        assert native == "True" and float(total) == 1000.0
        assert Path(path).parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [Path(outs[0][0].split()[2]).name]


def test_a_restart_loads_the_hashed_library_without_g_plus_plus(tmp_path, monkeypatch):
    st.load()  # an earlier process built the library ...
    built = tmp_path / st.library_path().name
    shutil.copy(st.library_path(), built)  # ... into this build directory
    monkeypatch.setattr(st, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(st, "_libs", {})  # a new process: nothing loaded

    def no_compiler(*args, **kwargs):
        raise AssertionError("g++ ran although the hashed library exists")

    monkeypatch.setattr(st.subprocess, "run", no_compiler)
    t = MinSegmentTree(4)
    t[np.arange(4)] = np.array([3.0, 1.0, 2.0, 4.0])
    assert t.reduce() == 1.0
    assert st.library_path() == built


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(st, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(st, "GXX_FLAGS", st.GXX_FLAGS + ("-fno-such-flag-anywhere",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        SumSegmentTree(4)
    assert not list(tmp_path.iterdir())  # the temporary file is removed


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(st, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        SumSegmentTree(4)


def test_library_name_follows_the_source_and_the_flags(monkeypatch):
    a = st.library_path()
    monkeypatch.setattr(st, "GXX_FLAGS", st.GXX_FLAGS + ("-g",))
    assert st.library_path() != a and st.library_path().parent == a.parent
