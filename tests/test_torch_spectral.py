"""The port's distance matrices (``manhattan``, ``rbf``), graph Laplacian,
Spectral clustering and Lasso against heat_tpu, on the same seeded numpy
data: three well-separated Gaussian blobs of 61 points in 4 dimensions.

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 2-rank gloo world shared by the module
against heat_tpu on two devices (its references in processes of their own;
61 rows split 31, 30). Every world-2 case pins its collectives: a distance
matrix of two split-0 operands one ``ring_step`` (the ring), a replicated
``Y`` none; the Laplacian's one cross-rank step is the degree vector (one
``all_gather``; the similarity matrix is never gathered); Lasso's split
sweep one ``all_reduce`` of the column norms and one per feature (5) each
sweep.

Tolerance: distances and the Laplacian within rtol 2e-6 and atol 3e-5
(float32; the quadratic expansion's ``|x|² + |y|² - 2x·y`` rounds in another
order, an error of a few eps·|x|² ≈ 3e-5 in d² here, and the rbf ``exp``
differs by an ulp), bfloat16 rbf within one bfloat16 rounding (2^-8)
of heat_tpu's, both taking the exp of float32 squared distances; Spectral's Lanczos eigenvalues within 2e-4 and its
leading eigenvectors within 2e-3 up to the sign of each column (20 float32
Lanczos steps amplify the rounding of the operator); labels as the same
partition, with the same number of Lloyd iterations and clusters; Lasso's
theta within 5e-5 absolute (float32 sweeps of a coordinate descent) with
the same ``n_iter``.
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
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((3, 4)) * 4
    blobs = (centers[np.arange(61) % 3] + rng.standard_normal((61, 4)) * 0.5).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    y = (blobs @ w + 0.3 + 0.1 * rng.standard_normal(61)).astype(np.float32)
    return {"X": blobs, "Y": blobs[:13] + np.float32(0.25), "y": y}


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh."""
    def arr(name, split=None):
        return lib.array(spec[name], split=split, **kw)

    def sim(x):
        return lib.spatial.rbf(x, sigma=3.0, quadratic_expansion=True)

    def laplacian(definition, mode, key="upper"):
        lap = lib.graph.Laplacian(sim, definition=definition, mode=mode, threshold_key=key,
                                  threshold_value=0.3)
        return lap.construct(arr("X", 0))

    def spectral(split, k=3):
        lib.random.seed(4)
        s = lib.cluster.Spectral(n_clusters=k, gamma=0.05, n_lanczos=20)
        evals, evecs = s._spectral_embedding(arr("X", split))
        lib.random.seed(4)
        s.fit(arr("X", split))
        return np.asarray(evals), evecs[:, :3], s.labels_, s.n_iter_, s.n_clusters

    def lasso(split):
        est = lib.regression.Lasso(lam=0.01, max_iter=40, tol=1e-6)
        est.fit(arr("X", split), arr("y", split))
        return est.theta, est.n_iter, est.predict(arr("X", split))

    return {"lib": lib, "np": np, "arr": arr, "laplacian": laplacian, "spectral": spectral,
            "lasso": lasso}


RS = {"ring_step": 1}
# the embedding, then the fit (the embedding again, then KMeans++ and its
# Lloyd steps): each embedding rbf's ring, the degree's gather, the start's
# norm and 20 Lanczos steps of one all-gather each
SPECTRAL = {"ring_step": 5, "all_gather": 49, "all_reduce": 3, "packed_all_reduce": 2}
# name -> (expression, collectives at world size 2, kind of comparison)
CASES = {
    "manhattan": ("lib.spatial.manhattan(arr('X'))", {}, "dist"),
    "manhattan_ring": ("lib.spatial.manhattan(arr('X', 0))", RS, "dist"),
    "manhattan_local": ("lib.spatial.manhattan(arr('X', 0), arr('Y'))", {}, "dist"),
    "manhattan_t": ("lib.spatial.manhattan(arr('Y'), arr('X', 0))", {}, "dist"),
    "rbf_expand_ring": ("lib.spatial.rbf(arr('X', 0), sigma=2.0, quadratic_expansion=True)",
                        RS, "dist"),
    "rbf_diff_ring": ("lib.spatial.rbf(arr('X', 0), arr('Y', 0), sigma=1.5)", RS, "dist"),
    "rbf_local": ("lib.spatial.rbf(arr('X', 0), arr('Y'), quadratic_expansion=True)", {},
                  "dist"),
    "rbf_replicated": ("lib.spatial.rbf(arr('X'), sigma=2.0)", {}, "dist"),
    "rbf_bf16": ("lib.spatial.rbf(arr('X', 0).astype(lib.bfloat16), sigma=2.0, "
                 "quadratic_expansion=True)", RS, "bf16"),
    "laplacian_norm_sym": ("laplacian('norm_sym', 'fully_connected')", dict(RS, all_gather=1),
                           "dist"),
    "laplacian_simple": ("laplacian('simple', 'fully_connected')", dict(RS, all_gather=1),
                         "dist"),
    "laplacian_norm_sym_eps": ("laplacian('norm_sym', 'eNeighbour')", dict(RS, all_gather=1),
                               "dist"),
    "laplacian_simple_eps_lower": ("laplacian('simple', 'eNeighbour', 'lower')",
                                   dict(RS, all_gather=1), "dist"),
    "spectral": ("spectral(0)", SPECTRAL, "spectral"),
    "spectral_eigengap": ("spectral(0, k=None)", SPECTRAL, "spectral"),
    "lasso": ("lasso(None)", {}, "lasso"),
    "lasso_split": ("lasso(0)", {"all_reduce": 40 * (1 + 5)}, "lasso"),
}


def _heat_tpu(case, comm):
    env = _build_env(hj, _spec(), comm=comm)
    return pack(eval(CASES[case][0], env))  # noqa: S307


def _meta(got, want):
    assert (got["dtype"], got["gshape"], got["split"]) == \
        (want["dtype"], want["gshape"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])


def _same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist())), pairs


def _signs(got, want):
    idx = np.argmax(np.abs(want), axis=0)
    cols = np.arange(want.shape[1])
    return np.where((np.sign(got[idx, cols]) != np.sign(want[idx, cols]))[None, :], -got, got)


def _check(case, got, want):
    kind = CASES[case][2]
    if kind == "dist":
        _meta(got, want)
        np.testing.assert_allclose(got["values"], want["values"], rtol=2e-6, atol=3e-5)
    elif kind == "bf16":  # the exp of float32 d², rounded once to bfloat16
        _meta(got, want)
        np.testing.assert_allclose(got["values"], want["values"], rtol=2.0**-8, atol=0)
    elif kind == "spectral":
        (ge, gv, gl, gn, gk), (we, wv, wl, wn, wk) = got, want
        np.testing.assert_allclose(ge, we, rtol=0, atol=2e-4)
        _meta(gv, wv)
        np.testing.assert_allclose(_signs(gv["values"], wv["values"]), wv["values"], rtol=0,
                                   atol=2e-3)
        _meta(gl, wl)
        _same_partition(gl["values"], wl["values"])
        assert (gn, gk) == (wn, wk)
    else:
        (gt, gn, gp), (wt, wn, wp) = got, want
        assert gn == wn
        for g, w in ((gt, wt), (gp, wp)):
            _meta(g, w)
            np.testing.assert_allclose(g["values"], w["values"], rtol=0, atol=5e-5)


_REFS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """heat_tpu's results on one and on two devices, in four processes of
    their own from the module's start."""
    names = list(CASES)
    refs = start_refs(tmp_path_factory.mktemp("spectral_refs"), "test_torch_spectral",
                      [(c, names[k::2]) for c in ("C1", "C2") for k in range(2)])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(case):
    ht.get_comm().reset_stats()
    got = pack(eval(CASES[case][0], _build_env(ht, _spec())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _check(case, got, reference(_REFS["refs"], "C1", case))


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    spec = dict(_spec(), cases={k: v[0] for k, v in CASES.items()})
    handle = start_world(tmp_path_factory.mktemp("spectral_world2"), spec, 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(world2, case):
    got, stats = world2[case]
    _check(case, got, reference(_REFS["refs"], "C2", case))
    assert stats == CASES[case][1], stats
