"""The port's data engine (groupby, top-k, join, the streamed folds), its
counters and ``utils.metrics`` against heat_tpu, on the same seeded numpy
data: 1,003 rows of keys in [-2, 9) bucketed into 7 groups (negative and
out-of-range keys dropped) with float32, int32 and float64 two-column
values, and six bool values in 5 groups; 41 float32 values with NaN, ±inf,
-0.0, +0.0 and ties for top-k; 57 left rows with duplicate and negative
keys joined to 21 unique right keys; a 300-row (station, magnitude)
float64 table and 300-element float32, float64 and int32 columns streamed
in chunks of 64 rows from a list, a callable, ``.npy`` files and HDF5
``DataStream`` s.

One table of cases (``torch_data_cases.py``) runs twice: in process at world
size 1, and in ONE spawned 2-rank gloo world shared by the module, against
heat_tpu on one and on two devices (its references computed in processes of
their own). Every world-2 case pins its collectives against heat_tpu's
plan: a groupby one ``packed_all_reduce`` (sum, mean, count; heat_tpu's one
``packed_psum``) or one ``all_reduce`` (min, max; its one ``pmin``/
``pmax``); a top-k one ``packed_all_reduce`` of the (p, k) candidates (its
k-sized exchange); a join two ``all_to_all`` and one ``all_reduce`` of the
match counts (heat_tpu's two programs send seven all-to-alls, an exclusive
scan and a sum); a streamed fold none per chunk and one all-reduce of the
ranks' carries (heat_tpu reads its (p, ...) carry to the host), a quantile
one a pass. No case gathers. Cases named ``*_w1`` (the engine switched off,
a replicated right side: the plain forms on the logical arrays) run at
world size 1 only.

Tolerances: bit for bit for integer results, counts, min and max, top-k
values and positions, quantiles, join rows and counters; float32 sums
within rtol 1e-5 of heat_tpu's (summed in another order); float64 sums and
means within rtol 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
from torch_data_cases import CASES, _build_env, _spec  # noqa: E402
from torch_world import (finish_world, pack, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)

RTOL = {"f32": 1e-5, "f64": 1e-10}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _same(got, want, kind):
    if isinstance(want, dict) and "lshape_map" in want:
        assert (got["dtype"], got["gshape"], got["split"]) == \
            (want["dtype"], want["gshape"], want["split"])
        np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
        got, want = got["values"], want["values"]
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, kind)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if kind == "exact" or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
        if want.dtype.kind == "f":  # -0.0 and +0.0 apart
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[kind], atol=0)


_REFS: dict = {}
WORLD2 = [c for c in CASES if not c.endswith("_w1")]


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """heat_tpu's results on one and on two devices, in six processes of
    their own from the module's start."""
    names = list(CASES)
    refs = start_refs(tmp_path_factory.mktemp("data_refs"), "torch_data_cases",
                      [(comm, cases[i::3]) for comm, cases in (("C1", names), ("C2", WORLD2))
                       for i in range(3)])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    spec = dict(_spec(), cases={k: CASES[k][0] for k in WORLD2})
    handle = start_world(tmp_path_factory.mktemp("data_world2"), spec, 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(references, started, case):
    """(``started``: the world-2 ranks run beside these tests.)"""
    ht.get_comm().reset_stats()
    got = pack(eval(CASES[case][0], _build_env(ht, _spec())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _same(got, reference(_REFS["refs"], "C1", case), CASES[case][2])


@pytest.mark.parametrize("case", WORLD2)
def test_world2_matches_heat_tpu(references, world2, case):
    got, stats = world2[case]
    _same(got, reference(_REFS["refs"], "C2", case), CASES[case][2])
    assert stats == CASES[case][1], stats


def test_engine_stats_and_metrics(tmp_path):
    """``data.stats()`` reads every engine counter and its program cache,
    its two fallback counters stay 0, and ``utils.metrics`` exports them with the streams'
    ``io.stream_*`` counters as one JSON line."""
    import json

    from heat_tpu_torch.utils import metrics

    env = _build_env(ht, _spec())
    before = ht.data.stats()
    ht.data.stream_quantile(env["h5"]("s64"), 0.5, rows_per_chunk=128)
    after = ht.data.stats()
    assert set(after) == {"enabled", "dispatches", "exchange_fallbacks", "stream_chunks",
                          "stream_fallbacks", "groupby_calls", "topk_calls", "quantile_calls",
                          "join_calls", "program_cache"}
    assert after["exchange_fallbacks"] == after["stream_fallbacks"] == 0
    # 8 passes of 3 chunks, each a dispatch
    assert after["stream_chunks"] - before["stream_chunks"] == 24
    assert after["quantile_calls"] - before["quantile_calls"] == 1
    # reset drops the cached programs (heat_tpu's) and keeps the counters
    ht.data.reset()
    cleared = ht.data.stats()
    assert cleared.pop("program_cache") == dict.fromkeys(
        ("hits", "misses", "compiles", "evictions", "entries"), 0)
    assert cleared == {k: v for k, v in after.items() if k != "program_cache"}
    m = metrics.Metrics()
    m.inc("a", 2)
    m.gauge("g", torch.tensor([1.5, float("nan")]))
    m.observe("loss", torch.tensor(0.25))
    m.observe("loss", 0.75)
    with m.timer("t") as t:
        t.sync(torch.ones(3))
    d = m.to_dict()
    assert d["counters"] == {"a": 2.0} and d["gauges"] == {"g": [1.5, None]}
    assert d["series"]["loss"] == {"count": 2, "last": 0.75, "mean": 0.5, "min": 0.25,
                                   "max": 0.75}
    assert d["series"]["t"]["count"] == 1
    m.dump(str(tmp_path / "m.jsonl"), step=3)
    line = json.loads((tmp_path / "m.jsonl").read_text())
    assert line["step"] == 3 and line["counters"] == {"a": 2.0} and "loss" in line["series"]
    assert m.to_dict()["series"] == {}  # dump clears the window
    assert metrics.counters()["io.stream_chunks"] >= 25


def test_groupby_bool_values_raise_as_heat_tpu(references):
    """A groupby of bool values at split None and 0 raises, for ``sum``,
    ``min`` and ``max``, the exception class heat_tpu raises on one device
    (case ``gb_bool_values``), and its ``mean`` and ``count`` equal
    heat_tpu's. (torch's ``index_add_`` in bool is a logical or: the port
    once returned that for the sum.)"""
    import builtins

    want = reference(_REFS["refs"], "C1", "gb_bool_values")
    for split, (names, mean, count) in zip((None, 0), want):
        keys = ht.array(np.array([3, 3, 1, 0, 2, 2], np.int32), split=split)
        vals = ht.array(np.array([1, 0, 1, 1, 0, 1], bool), split=split)
        for op, name in zip(("sum", "min", "max"), names):
            assert name, op  # heat_tpu refuses each of them
            with pytest.raises(getattr(builtins, name)) as err:
                ht.data.groupby_agg(keys, 5, op, vals)
            assert type(err.value).__name__ == name
        _same(pack(ht.data.groupby_agg(keys, 5, "mean", vals)), mean, "exact")
        _same(pack(ht.data.groupby_agg(keys, 5, "count", vals)), count, "exact")
