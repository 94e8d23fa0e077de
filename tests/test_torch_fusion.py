"""The fusion engine's whole-step programs (``heat_tpu_torch.core.fusion``)
against heat_tpu's (``heat_tpu/core/fusion.py``): ``value_and_grad`` and
``grad``, ``trace_step`` with its cache, donation, fallbacks, fault sites and
escape hatch, ``fit_step_call`` under every estimator that takes it,
``packed_psum``, ``stats()``, the switches, the data engine's program cache,
and the flagship's training step as one program.

The cases are heat_tpu's own (``tests/test_trace_step.py``) on seeded numpy
data (``torch_fusion_cases.py``), run in process at world size 1 against
heat_tpu on one device, and the fits whose distributed step takes
``fit_step_call`` only above one rank in ONE spawned 2-rank gloo world
against heat_tpu on two devices; heat_tpu's results come from processes of
their own (its traced static-int case does not finish: that case is held
against heat_tpu's eager values). Tolerances: the traced steps, gradients
and float fits within rtol 1e-5 of heat_tpu's (its traced-against-eager
contract, ``test_trace_step.py:78``), the Lanczos basis within 1e-4 (as
``test_torch_linalg.py``'s case), integers, layouts and every counter
exactly; the port's traced step bit for bit its own eager step. On the CPU a
program is the step run eagerly; the CUDA graphs run on the card
(``chip_smoke.py`` phase 10, and the card tests here).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import fusion  # noqa: E402
import torch_fusion_cases as T  # noqa: E402
from torch_world import (REPO, finish_world, reference, start_refs,  # noqa: E402
                         start_world, stop_refs, stop_world)

RTOL = {"f32": (1e-5, 1e-6), "lanczos": (1e-4, 1e-5)}


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
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            # counters are exact whatever the case's tolerance
            _same(got[key], want[key], "exact" if key in ("counts", "first", "then",
                                                          "second") else kind)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, kind)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if kind == "exact" or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[kind][0], atol=RTOL[kind][1])


_REFS: dict = {}
_STEPS = [c for c in T.CASES if not c.startswith(("fit_", "stats", "signatures"))]


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """heat_tpu's results in processes of their own from the module's
    start: the steps, the fits on one device and the fits on two apart."""
    fits = [c for c in T.CASES if c not in _STEPS]
    refs = start_refs(tmp_path_factory.mktemp("fusion_refs"), "torch_fusion_cases",
                      [("C1", _STEPS + ["static_int"]), ("C1", fits), ("C2", T.WORLD2)])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    cases = {k: T.CASES[k][0] for k in T.WORLD2} | T.WORLD2_PORT
    funcs = (T._counts, T._delta, T._problem, T._mlp_step, T._blobs, T.vg, T.vg_split_param,
             T.vg_aux, T.traced, T.int_step, T.steady, T.fallback, T.escape, T.static_int,
             T.apply_grads, T.fit, T.fit_fault, T.stats_keys, T.signatures, T.dp_step,
             T.psum_dtypes, T._flagship, T.flagship_step, T._build_env)
    handle = start_world(tmp_path_factory.mktemp("fusion_world2"), {"cases": cases}, 2, funcs)
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


def _port(case):
    return eval(T.CASES[case][0], T._build_env(ht, None))  # noqa: S307


@pytest.mark.parametrize("case", list(T.CASES))
def test_world1_matches_heat_tpu(references, started, case):
    """(``started``: the world-2 ranks run beside these tests.)"""
    _same(_port(case), reference(_REFS["refs"], "C1", case), T.CASES[case][1])


@pytest.mark.parametrize("case", T.WORLD2)
def test_world2_matches_heat_tpu(references, world2, case):
    got, _ = world2[case]
    want = reference(_REFS["refs"], "C2", case)
    assert got["counts"]["fit_step_flushes"] > 0, got["counts"]
    _same(got, want, T.CASES[case][1])


def test_static_int_args_key_the_program(references):
    """Python ints are static: each value keys a program of its own, and the
    values are heat_tpu's eager ones."""
    got = T.static_int(ht, True)
    want = reference(_REFS["refs"], "C1", "static_int")
    _same(got["values"], want["values"], "exact")
    assert {k: got["counts"][k] for k in ("step_flushes", "misses", "compiles")} == \
        {"step_flushes": 2, "misses": 2, "compiles": 2}


@pytest.mark.parametrize("split", [None, 0, 1])
def test_traced_step_is_the_eager_step_bitwise(split):
    """On the CPU a program is the step run eagerly: bit for bit."""
    _, train_step = T._mlp_step(ht)
    params, X, y = T._problem(ht, 13, 5, 3, split)
    with fusion.step_override(False):
        pe = dict(params)
        eager = []
        for _ in range(3):
            pe, l = train_step(pe, X, y)
            eager.append(l.larray)
    step = fusion.trace_step(train_step)
    pt = dict(params)
    for i in range(3):
        pt, l = step(pt, X, y)
        assert torch.equal(l.larray, eager[i])
    for k in pe:
        assert torch.equal(pt[k].larray, pe[k].larray)
        assert (pt[k].gshape, pt[k].split) == (pe[k].gshape, pe[k].split)


def test_donation_invalidates_and_a_reused_tree_raises():
    """``donate_argnums``: the donated DNDarrays are dead after the call, a
    call with them raises without making the signature eager, and the new
    tree keeps working (``test_trace_step.py:192``, ``:236``)."""
    _, train_step = T._mlp_step(ht)
    params, X, y = T._problem(ht, 16, 4, 3, 0, seed=6)
    step = fusion.trace_step(train_step, donate_argnums=(0,))
    newp, _ = step(params, X, y)
    assert params["w"].is_deleted() and not newp["w"].is_deleted()
    with pytest.raises(RuntimeError, match="donated"):
        params["w"].larray
    with pytest.raises(RuntimeError):
        step(params, X, y)
    assert not step._eager_keys
    newp, _ = step(newp, X, y)
    assert not X.is_deleted()


def test_step_fault_sites():
    """``fusion.step.trace`` degrades the first call to the eager step,
    counted; ``fusion.step.dispatch`` on a program that ran propagates."""
    _, train_step = T._mlp_step(ht)
    params, X, y = T._problem(ht, 8, 4, 3, None, seed=11)
    step = fusion.trace_step(train_step)
    fb = fusion.stats()["step_fallbacks"]
    with ht.utils.faults.inject("fusion.step.trace=nth:1"):
        p, _ = step(dict(params), X, y)
    assert fusion.stats()["step_fallbacks"] == fb + 1 and len(step._eager_keys) == 1
    step = fusion.trace_step(train_step)
    p, _ = step(dict(params), X, y)
    with ht.utils.faults.inject("fusion.step.dispatch=nth:1"):
        with pytest.raises(Exception):
            step(p, X, y)
    assert not step._eager_keys
    step(p, X, y)


def test_trace_runs_on_data_free_tensors():
    """The trace sees tensors without data: a host read fails there, so a
    body that reads a value falls back before it runs for real."""
    seen = []

    def body(x):
        seen.append(fusion.abstract(x.larray))
        return x * 2.0

    step = fusion.trace_step(body)
    x = ht.array(np.ones((3, 2), np.float32), split=0)
    step(x)
    step(x)
    assert seen == [True, False, False]


def test_packed_psum_contract():
    """One rank: the values come back untouched and nothing is counted; the
    codecs of heat_tpu's part (c) are refused."""
    comm = ht.get_comm()
    comm.reset_stats()
    vals = [torch.ones(3), torch.arange(2)]
    out = fusion.packed_psum(vals, comm)
    assert all(a is b for a, b in zip(out, vals)) and comm.stats == {}
    assert fusion.packed_psum(vals, ()) == vals
    off = (fusion.quant_key(), fusion.chunk_key(), fusion.hier_key())
    assert off == ((None, 256, 128), (1, 4096), (True, None, None, 0))
    fusion.packed_psum(vals, comm, quant=off[0], chunks=off[1], hier=off[2])
    for kw in ({"quant": ("int8", 256, 128)}, {"chunks": (4, 4096)},
               {"hier": (True, ("dcn",), None, 0)}, {"replicated": ("ici",)}):
        with pytest.raises(NotImplementedError, match="part \\(c\\)"):
            fusion.packed_psum(vals, comm, **kw)


def test_world2_packed_psum_and_dataparallel(world2):
    """At world size 2: ``packed_psum`` is one all-reduce a dtype; the
    packed DataParallel step one all-reduce a step (heat_tpu's HLO audit,
    ``test_trace_step.py:407``) and one flush, the same losses as the
    per-parameter all-reduces of the switch off."""
    got, stats = world2["psum_dtypes"]
    assert stats == {"packed_all_reduce": 3}, stats
    for g, want in zip(got, ([3.0] * 3, [3] * 2, [0.75] * 4, [6.0])):
        np.testing.assert_array_equal(g, want)
    packed, pstats = world2["dp_packed"]
    eager, estats = world2["dp_eager"]
    assert pstats == {"packed_all_reduce": 4}, pstats
    assert estats == {"all_reduce": 4 * 5}, estats  # 4 parameters and the loss
    assert packed["counts"]["step_flushes"] == 4 and eager["counts"]["step_flushes"] == 0
    np.testing.assert_allclose(packed["losses"], eager["losses"], rtol=1e-6)


def test_switches_and_names():
    """The engine switches and the flat names, with heat_tpu's defaults."""
    for name in ("fusion", "fusion_enabled", "set_fusion", "pallas_enabled", "set_pallas"):
        assert hasattr(ht, name), name
    assert ht.fusion is fusion and ht.fusion_enabled() and ht.pallas_enabled()
    assert fusion.step_enabled() and fusion.fit_enabled()
    prev = ht.set_fusion(False)
    try:
        assert prev and not fusion.step_enabled() and not fusion.fit_enabled()
    finally:
        ht.set_fusion(prev)
    with fusion.fit_override(False):
        assert not fusion.fit_enabled() and fusion.step_enabled()
    # no setting sends a card tensor to a plain version
    with pytest.raises(NotImplementedError):
        ht.set_pallas(False)
    ht.set_pallas(True)
    ht.set_pallas(None)
    assert ht.pallas_enabled()


def test_switches_read_the_ports_environment():
    """``HEAT_TPU_TORCH_FUSION*`` and ``HEAT_TPU_TORCH_DATA_ENGINE`` turn the
    port's engines off; heat_tpu's own variables leave them on, and no
    ``*_PALLAS`` variable turns the port's kernels off."""
    code = ("import heat_tpu_torch as ht; from heat_tpu_torch.core import fusion; "
            "print(fusion.enabled(), fusion.step_enabled(), fusion.fit_enabled(), "
            "ht.pallas_enabled(), ht.data.enabled())")
    base = {k: v for k, v in os.environ.items() if not k.startswith("HEAT_TPU")}
    got = {}
    for prefix in ("HEAT_TPU", "HEAT_TPU_TORCH"):
        env = dict(base, PYTHONPATH=str(REPO), **{f"{prefix}_{n}": "0" for n in (
            "FUSION_STEP", "FUSION_FIT", "PALLAS", "DATA_ENGINE")})
        res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        got[prefix] = res.stdout.split()
    assert got["HEAT_TPU"] == ["True"] * 5
    assert got["HEAT_TPU_TORCH"] == ["True", "False", "False", "True", "False"]


def test_data_engine_program_cache():
    """``data.stats()["program_cache"]``: a groupby builds one program, a
    repeat hits it, and the eager route with the engine off builds none."""
    cache = ht.data.engine.program_cache()
    ht.data.reset()
    rng = np.random.default_rng(0)
    keys = ht.array(rng.integers(0, 4, 40), split=0)
    vals = ht.array(rng.standard_normal(40), split=0)
    a = ht.data.groupby(keys, 4).sum(vals)
    b = ht.data.groupby(keys, 4).sum(vals)
    with ht.data.override(False):
        c = ht.data.groupby(keys, 4).sum(vals)
    st = ht.data.stats()
    assert st["program_cache"] == cache.stats()
    assert {k: st["program_cache"][k] for k in ("hits", "misses", "compiles")} == \
        {"hits": 1, "misses": 1, "compiles": 1}
    assert torch.equal(a.larray, b.larray) and torch.allclose(a.larray, c.larray)


def test_flagship_step_builds_one_program():
    """The flagship's step program (the ``flagship_step`` case, held against
    heat_tpu above) is built once for its signature and replayed by the
    later steps."""
    got, step = T._flagship(ht)
    assert got["counts"] == {"step_flushes": 3, "step_fallbacks": 0}
    assert {k: step.program_cache.stats()[k] for k in ("hits", "misses", "compiles")} == \
        {"hits": 2, "misses": 1, "compiles": 1}


@pytest.mark.cuda
def test_programs_replay_cuda_graphs_on_card():
    """On the card a traced step is warmed up, captured once and replayed,
    bit for bit the eager step, with the launches of its graph counted at
    each replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured only there")
    from heat_tpu_torch.core import kernels

    ht.use_device(None)
    x = torch.rand(4096, 16, device="cuda")
    c0 = x[:4].clone()
    km = ht.cluster.KMeans(n_clusters=4, max_iter=5, tol=-1)
    comm = ht.get_comm()
    with fusion.fit_override(False):
        want, _, _ = km._run_lloyd(km._lloyd_step(comm, 0), x, c0)
    kernels.reset_launches()
    got, _, _ = km._run_lloyd(km._lloyd_step(comm, 0), x, c0)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.launches["kmeans_step"] == 5
    prog = next(p for k, p in fusion.program_cache()._programs.items()
                if k[:2] == ("fit", "kmeans.lloyd"))
    assert prog.captures == 1 and prog._owned[0] is None


def test_program_binding_rules():
    """How a card program binds its slots (``fusion._Program._bind``): a
    tensor that stays put stays bound; a bound tensor that moves is
    captured again, still bound, and on a second move in a row (or at once
    when donated) gets a buffer of its own; a buffer takes any tensor of its
    shape and type without a new capture; a new static value or shape is
    captured again."""
    prog = fusion._Program(lambda *a: None)
    x, c, tok = torch.ones(4, 3), torch.zeros(2, 3), torch.arange(4)

    def captured(*args):  # what a capture records
        prog._sig = [fusion._slot_sig(a) for a in args]

    captured(x, c, tok, 5)
    prog._owned = [None, None, tok.clone(), None]
    prog._moved = [False, False, True, False]
    assert not prog._bind((x, c, torch.arange(4) + 1, 5), ())
    c2 = c.clone()
    assert prog._bind((x, c2, tok, 5), ()) and prog._owned[1] is None
    captured(x, c2, tok, 5)
    c3 = c.clone()
    assert prog._bind((x, c3, tok, 5), ()) and prog._owned[1] is not None
    captured(x, c3, tok, 5)
    assert not prog._bind((x, c.clone(), tok, 5), ())  # now copied into its buffer
    x2 = x.clone()
    assert prog._bind((x2, c, tok, 5), (0,)) and prog._owned[0] is not None
    captured(x2, c, tok, 5)
    assert prog._bind((x2, c, tok, 6), ())
    captured(x2, c, tok, 6)
    assert prog._bind((x2, c, torch.arange(5), 6), ()) and prog._owned[2].shape == (5,)
