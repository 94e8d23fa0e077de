"""The port's random draws against heat_tpu's Threefry stream, bit for bit.

One table of seeded draws runs twice: in process at world size 1 against
heat_tpu on one device, and in ONE spawned 2-rank gloo world shared by the
module against heat_tpu on two devices; every world-2 draw makes no
collective (each rank computes its own chunk's bits). The shapes split
unevenly (7 rows over 2 ranks: 4, 3), along axis 0 and 1.

Tolerance: ``rand``/``uniform``/``random_sample`` (float16 to float64),
``randint`` (int8 to int64, spans past 2**32 included), ``randperm``/
``permutation`` and the seeded KMeans draws are bitwise, with heat_tpu's
type, gshape, split and lshape_map. ``randn``/``normal``/
``standard_normal`` take ``erfinv`` from XLA's own polynomials
(``core/random.py``), evaluated by torch's ``log1p``/``sqrt``; they agree
within 8 units in the last place of ``max(|value|, 1)`` for float32 (3
measured) and 64 for float64 (30 measured). The seeded KMeans
(``KMeans(n_clusters=3, random_state=1, max_iter=20)`` on
40 × 5 float32, both ``init`` modes) agrees in ``n_iter_`` and labels,
centroids within 1e-5 and ``inertia_`` within rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from torch_world import (finish_world, pack, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)

C1 = TPUCommunication(jax.devices()[:1])
C2 = TPUCommunication(jax.devices()[:2])


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _spec():
    rng = np.random.default_rng(5)
    return {"km": rng.standard_normal((40, 5)).astype(np.float32) * 3,
            "rows": np.arange(28.0).reshape(7, 4)}


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh."""
    def draw(name, *args, seed=42, **kwargs):
        lib.random.seed(seed)
        return getattr(lib.random, name)(*args, **kwargs, **kw)

    def draws():
        """``tests/test_torch_manipulations.py``'s draws, in one stream after
        one seed."""
        lib.random.seed(7)
        x = lib.array(spec["rows"], split=0, **kw)
        state = lib.random.get_state()
        r = lib.random
        out = (r.rand(7, 3, split=0, **kw), r.randn(9, split=0, **kw),
               r.randint(-5, 5, (6, 2), split=1, **kw),
               r.uniform(-2.0, 3.0, (7, 3), split=0, **kw),
               r.normal(1.0, 2.0, (5, 4), split=1, **kw),
               r.random_sample((4, 7), split=1, **kw), r.standard_normal((3, 3), **kw),
               r.randperm(11, split=0, **kw), r.permutation(x), r.permutation(9, **kw))
        r.set_state(state)
        return out + (r.rand(7, 3, split=0, **kw), state[1:3])

    def kmeans(init):
        km = lib.cluster.KMeans(n_clusters=3, random_state=1, max_iter=20, init=init)
        km.fit(lib.array(spec["km"], split=0, **kw))
        return km.cluster_centers_, km.labels_, km.n_iter_, km.inertia_

    return {"lib": lib, "np": np, "draw": draw, "draws": draws, "kmeans": kmeans}


# name -> (expression, tolerance in ulp of max(|value|, 1); 0 = bitwise)
CASES = {
    "rand_f32": ("draw('rand', 7, 5)", 0),
    "rand_f32_s0": ("draw('rand', 7, 5, split=0)", 0),
    "rand_f32_s1": ("draw('rand', 5, 7, split=1)", 0),
    "rand_f64_s0": ("draw('rand', 7, 5, dtype=lib.float64, split=0)", 0),
    "rand_f64_s1": ("draw('rand', 3, 7, 2, dtype=lib.float64, split=1)", 0),
    "rand_f16_s0": ("draw('rand', 9, 3, dtype=lib.float16, split=0)", 0),
    "rand_bf16_s1": ("draw('rand', 3, 9, dtype=lib.bfloat16, split=1)", 0),
    "rand_0d": ("draw('rand')", 0),
    "random_sample_s1": ("draw('random_sample', (4, 7), split=1)", 0),
    "uniform_f32_s0": ("draw('uniform', -2.0, 3.0, (7, 3), split=0)", 0),
    "uniform_f64": ("draw('uniform', 0.5, 4.0, (11,), dtype=lib.float64)", 0),
    "randint_i64": ("draw('randint', 0, 1000, (7, 3))", 0),
    "randint_i64_s0": ("draw('randint', -5, 5, (13,), split=0)", 0),
    "randint_i64_s1": ("draw('randint', -7, 2**40, (3, 7), split=1)", 0),
    "randint_i64_wide": ("draw('randint', -2**63, 2**63 - 1, (9,), split=0)", 0),
    "randint_i32_s0": ("draw('randint', 3, 17, (7, 2), dtype=lib.int32, split=0)", 0),
    "randint_i32_s1": ("draw('randint', -2**31, 2**31 - 1, (2, 7), dtype=lib.int32, split=1)",
                       0),
    "randint_i16": ("draw('randint', -300, 300, (9,), dtype=lib.int16, split=0)", 0),
    "randint_i8": ("draw('randint', -5, 100, (9,), dtype=lib.int8)", 0),
    "randint_high_only": ("draw('randint', 6, size=(7,), split=0)", 0),
    "randperm": ("draw('randperm', 11)", 0),
    "randperm_s0": ("draw('randperm', 13, split=0)", 0),
    "randperm_two_rounds": ("draw('randperm', 2000, split=0)", 0),
    "permutation_int": ("draw('permutation', 9)", 0),
    "permutation_rows": ("(lib.random.seed(3), lib.random.permutation("
                         "lib.array(np.arange(21.0).reshape(7, 3), split=0, **{}))"
                         ")[1]", 0),
    "randn_f32_s0": ("draw('randn', 7, 5, split=0)", 8),
    "randn_f32_s1": ("draw('randn', 5, 7, split=1, seed=9)", 8),
    "randn_f64_s0": ("draw('randn', 7, 5, dtype=lib.float64, split=0)", 64),
    "standard_normal": ("draw('standard_normal', (300,), split=0)", 8),
    "normal": ("draw('normal', 1.0, 2.0, (5, 4), split=1)", 8),
    "draws": ("draws()", 8),
    # tests/test_torch_kmeans.py's world-2 draws, held there against the
    # port's own world size 1, here against heat_tpu
    "kmeans_test_rand": ("draw('rand', 70000, 2, split=0, seed=3)", 0),
    "kmeans_test_randint": ("draw('randint', 0, 1000, (70001,), split=0, seed=3)", 0),
    "state": ("(lib.random.seed(11), draw('rand', 3, seed=11), lib.random.get_state()[1:3])[2]",
              0),
    "kmeans_random": ("kmeans('random')", None),
    "kmeans_pp": ("kmeans('kmeans++')", None),
}


def _heat_tpu(case, comm):
    expr = CASES[case][0].replace("**{}", "comm=comm")
    env = _build_env(hj, _spec(), comm=comm)
    env["comm"] = comm
    return pack(eval(expr, env))  # noqa: S307


def _close(got, want, ulps):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, ulps)
        return
    if not isinstance(want, dict):
        assert got == want, (got, want)
        return
    assert (got["dtype"], got["gshape"], got["split"]) == \
        (want["dtype"], want["gshape"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
    g, w = got["values"], want["values"]
    if ulps == 0 or w.dtype.kind not in "fc":
        np.testing.assert_array_equal(g, w)
        assert np.array_equal(np.signbit(g), np.signbit(w))
    else:
        eps = np.finfo(w.dtype).eps
        np.testing.assert_allclose(g, w, rtol=ulps * eps, atol=ulps * eps)


def _same_kmeans(got, want):
    (gc, gl, gn, gi), (wc, wl, wn, wi) = got, want
    assert gn == wn
    assert (gc["gshape"], gc["split"], gc["dtype"]) == (wc["gshape"], wc["split"], wc["dtype"])
    np.testing.assert_allclose(gc["values"], wc["values"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gl["values"], wl["values"])
    np.testing.assert_allclose(gi, wi, rtol=1e-5)


def _check(case, got, want):
    if CASES[case][1] is None:
        _same_kmeans(got, want)
    else:
        _close(got, want, CASES[case][1])


_REFS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """heat_tpu's draws on one and on two devices, in four processes of their
    own from the module's start (two a mesh, every other case)."""
    names = list(CASES)
    refs = start_refs(tmp_path_factory.mktemp("random_refs"), "test_torch_random",
                      [(c, names[k::2]) for c in ("C1", "C2") for k in range(2)])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(case):
    ht.get_comm().reset_stats()
    env = _build_env(ht, _spec())
    got = pack(eval(CASES[case][0].replace("**{}", ""), env))  # noqa: S307
    assert ht.get_comm().stats == {}
    _check(case, got, reference(_REFS["refs"], "C1", case))


def test_threefry_words_match_jax():
    """The port's key derivation and word layout against jax itself: the
    first words of ``bits(fold_in(key(s), c))`` and of both keys of a split,
    for a seed past 2**32 and a counter past 2**31."""
    from heat_tpu_torch.core import random as tr

    for seed_, counter in ((42, 3), (2**40 + 17, 2**31 + 5)):
        key = jax.random.fold_in(jax.random.key(seed_), counter)
        want = np.asarray(jax.random.bits(key, (10,), "uint32"))
        k = tr._key_of(seed_, counter)
        got = tr._words(k, torch.arange(10), False).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
        want_split = np.asarray(jax.random.key_data(jax.random.split(key)))
        assert [tuple(w) for w in want_split.tolist()] == [tuple(s) for s in tr._split(k)]


def test_chunked_draw_equals_one_pass(monkeypatch):
    """A draw cut into passes of ``_CHUNK`` elements gives the same bits."""
    from heat_tpu_torch.core import random as tr

    ht.random.seed(5)
    whole = ht.random.randn(37, 11, split=1).numpy()
    monkeypatch.setattr(tr, "_CHUNK", 64)
    ht.random.seed(5)
    np.testing.assert_array_equal(ht.random.randn(37, 11, split=1).numpy(), whole)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    spec = dict(_spec(), cases={k: v[0].replace("**{}", "") for k, v in CASES.items()})
    handle = start_world(tmp_path_factory.mktemp("random_world2"), spec, 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(world2, case):
    got, stats = world2[case]
    want = reference(_REFS["refs"], "C2", case)
    _check(case, got, want)
    if not case.startswith(("kmeans", "permutation_rows", "draws")):
        assert stats == {}, stats
