"""The port's linear algebra against heat_tpu: ``matmul``/``@`` in every
split pair, the rest of ``linalg.basics``, the distributed Gauss-Jordan,
QR, SVD, the solvers, ``cov``/``corrcoef`` and the DNDarray's ``norm``,
``qr``, ``trace``, ``tril`` and ``triu``.

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 2-rank gloo world shared by the module
against heat_tpu on two devices (its references in processes of their own).
Every world-2 case pins its collectives (``comm.stats``). ``matmul``'s plan
(``core/linalg/basics.py``): ``local0``/``local1``/replicated none; the
contracted axis sharded (``(1, None)``, ``(None, 0)``, ``(1, 0)``) one
``all_reduce``; ``(0, 0)`` and ``(0, 1)`` one ``all_gather`` of ``b``,
``(1, 1)`` one of ``a``. The Gauss-Jordan two ``all_reduce`` per pivot;
TSQR one ``all_gather``; the panel CAQR one ``all_gather`` and one
``all_reduce`` per panel; split-1 QR one ``all_reduce`` per panel; the
split-0 Cholesky two ``all_reduce`` per rank; Lanczos one ``all_gather``
per iteration. Reading a split result back (``numpy()``) gathers after the
counts are taken.

Tolerance: float32 results within rtol 2e-5 and atol 2e-5 of heat_tpu
(GEMM and cross-rank sums in another order; the data are O(1)), float64
within 1e-10; integer and bool results, ``tril``/``triu``/``transpose``
bitwise. Singular and eigen vectors are compared up to the sign of each
column (LAPACK's sign is free), and ``lanczos``' basis within 1e-4 (its
float32 Gram-Schmidt passes round in another order). ``gshape``, ``split``,
``dtype`` and ``lshape_map`` always equal heat_tpu's.
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
    rng = np.random.default_rng(13)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    spd = rng.standard_normal((8, 8))
    spd = spd @ spd.T + 8 * np.eye(8)
    return {
        "A": f32(9, 7), "B": f32(7, 5), "v7": f32(7), "v9": f32(9), "C3": f32(7, 3),
        "D3": f32(7, 3), "T3": f32(4, 3, 5), "U3": f32(4, 5, 3), "tall": f32(21, 3),
        "sq": f32(6, 6), "wide": f32(4, 9), "spd": spd, "spd32": spd.astype(np.float32),
        "I": rng.integers(-4, 5, (5, 4)).astype(np.int64), "y": f32(3, 7),
    }


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh."""
    def arr(name, split=None):
        return lib.array(spec[name], split=split, **kw)

    def seeded(fn, *args, **kwargs):
        lib.random.seed(3)
        return fn(*args, **kwargs)

    def rebuilt(res):
        """A factorization's product, as a check that is free of sign."""
        U, S, V = res
        return (U * S.reshape((1, S.shape[0]))) @ V.T

    return {"lib": lib, "np": np, "torch": torch, "arr": arr, "seeded": seeded,
            "rebuilt": rebuilt, "la": lib.linalg}


AR, AG = "all_reduce", "all_gather"
_CAQR = {AG: 2, AR: 2}  # svd through the panel CAQR of a 9 x 7 (two panels)
_DIAG = {"exscan": 1, AR: 2, "ring_step": 1}  # the distributed diagonal, a masked select
# name -> (expression, collectives at world size 2, options)
CASES = {}
for _sa in (None, 0, 1):
    for _sb in (None, 0, 1):
        _plan = {(None, None): {}, (0, None): {}, (None, 1): {}, (1, None): {AR: 1},
                 (None, 0): {AR: 1}, (1, 0): {AR: 1}, (0, 0): {AG: 1}, (0, 1): {AG: 1},
                 (1, 1): {AG: 1}}[_sa, _sb]
        CASES[f"matmul_{_sa}_{_sb}"] = (f"arr('A', {_sa}) @ arr('B', {_sb})", _plan, {})
CASES.update({
    "matmul_vec_left": ("lib.matmul(arr('v9', 0), arr('A', 0))", {AG: 2, "permute": 2}, {}),
    "matmul_vec_right": ("arr('A', 0) @ arr('v7')", {}, {}),
    "matmul_vec_vec": ("arr('v7', 0) @ arr('v7', 0)", {AR: 1}, {}),
    "matmul_batched_split0": ("lib.matmul(arr('T3', 0), arr('U3', 0))", {}, {}),
    "matmul_batched_gather": ("lib.matmul(arr('T3', 1), arr('U3'))", {AG: 1}, {}),
    "matmul_int": ("arr('I', 0) @ arr('I').T", {}, {}),
    "dot_2d": ("lib.dot(arr('A', 1), arr('B', 0))", {AR: 1}, {}),
    "dot_1d": ("lib.dot(arr('v9', 0), arr('v9'))", {AR: 1}, {}),
    "outer": ("lib.outer(arr('v7', 0), arr('v9'))", {}, {}),
    "outer_split1": ("lib.outer(arr('v7', 0), arr('v9'), split=1)", {AG: 1}, {}),
    "vdot": ("lib.vdot(arr('A', 0), arr('A', 0))", {AR: 1, "permute": 4}, {}),
    "vecdot": ("lib.vecdot(arr('C3', 0), arr('D3', 0))", {}, {}),
    "tensordot": ("lib.tensordot(arr('T3', 0), arr('U3'), axes=([1, 2], [2, 1]))", {}, {}),
    "tensordot_contracted": ("lib.tensordot(arr('A', 1), arr('B', 0), axes=1)", {AR: 1}, {}),
    "kron": ("lib.kron(arr('C3', 0), arr('v7'))", {}, {}),
    "cross": ("lib.cross(arr('C3', 0), arr('D3', 0))", {}, {}),
    "einsum_rows": ("lib.einsum('ij,jk->ik', arr('A', 0), arr('B'))", {}, {}),
    "einsum_contracted": ("lib.einsum('ij,jk->ik', arr('A', 1), arr('B'))", {AR: 1}, {}),
    "einsum_mixed": ("lib.einsum('ij,ik->jk', arr('A', 1), arr('A', 0))", {AG: 2}, {}),
    "transpose": ("lib.transpose(arr('T3', 0), (2, 0, 1))", {}, {}),
    "trace_split0": ("lib.trace(arr('A', 0))", _DIAG, {}),
    "trace_split1": ("arr('A', 1).trace(offset=1)", _DIAG, {}),
    "tril_split0": ("arr('A', 0).tril(-1)", {}, {}),
    "tril_split1": ("lib.tril(arr('A', 1), 2)", {}, {}),
    "triu_split0": ("arr('A', 0).triu(1)", {}, {}),
    "triu_split1": ("lib.triu(arr('A', 1), -2)", {}, {}),
    "triu_batched": ("lib.triu(arr('T3', 1))", {}, {}),
    "tril_vector": ("lib.tril(arr('v7', 0))", {AG: 1}, {}),
    "norm": ("arr('A', 0).norm()", {AR: 1}, {}),
    "norm_axis": ("lib.norm(arr('A', 0), axis=0)", {AR: 1}, {}),
    "vector_norm_inf": ("la.vector_norm(arr('v9', 0), ord=np.inf)", {AR: 1}, {}),
    "vector_norm_0": ("la.vector_norm(arr('A', 1), axis=1, ord=0)", {AR: 1}, {}),
    "vector_norm_3": ("la.vector_norm(arr('A', 0), axis=0, ord=3)", {AR: 1}, {}),
    "matrix_norm_1": ("la.matrix_norm(arr('A', 0), ord=1)", {AR: 1}, {}),
    "matrix_norm_inf": ("la.matrix_norm(arr('A', 0), ord=np.inf)", {AR: 1}, {}),
    "matrix_norm_neg1": ("la.matrix_norm(arr('A', 1), ord=-1, keepdims=True)", {AR: 1}, {}),
    "matrix_norm_2": ("la.matrix_norm(arr('A', 0), ord=2)", _CAQR, {}),
    "matrix_norm_nuc": ("la.matrix_norm(arr('A', 0), ord='nuc')", _CAQR, {}),
    "projection": ("lib.projection(arr('v9', 0), arr('v9'))", {AR: 1}, {}),
    "det": ("lib.linalg.det(arr('spd'))", {}, {}),
    "det_split0": ("lib.linalg.det(arr('spd', 0))", {AR: 16}, {}),
    "det_split1": ("lib.linalg.det(arr('sq', 1))", {AR: 12}, {}),
    "slogdet_split0": ("lib.linalg.slogdet(arr('sq', 0))", {AR: 12}, {}),
    "inv": ("lib.linalg.inv(arr('spd32'))", {}, {}),
    "inv_split0": ("lib.linalg.inv(arr('spd', 0))", {AR: 16}, {}),
    "inv_split1": ("lib.linalg.inv(arr('spd32', 1))", {AR: 16}, {}),
    "cond": ("lib.linalg.cond(arr('sq', 0))", _CAQR, {}),
    "cond_1": ("lib.linalg.cond(arr('spd', 0), p=1)", {AR: 18}, {}),
    "qr": ("lib.linalg.qr(arr('A'))", {}, {}),
    "qr_tsqr": ("lib.linalg.qr(arr('tall', 0))", {AG: 1}, {}),
    "qr_caqr": ("lib.linalg.qr(arr('sq', 0))", {AG: 2, AR: 2}, {}),
    "qr_caqr_wide": ("arr('wide', 0).qr()", {AG: 2, AR: 2}, {}),
    "qr_split1": ("lib.linalg.qr(arr('A', 1))", {AR: 2}, {}),
    "qr_split1_wide": ("lib.linalg.qr(arr('wide', 1))", {AR: 1, "permute": 2}, {}),
    "qr_r_only": ("lib.linalg.qr(arr('tall', 0), calc_q=False).R", {AG: 1}, {}),
    "svd_tall": ("lib.linalg.svd(arr('tall', 0))", {AG: 1}, {"sign": True}),
    "svd_tall_rebuilt": ("rebuilt(lib.linalg.svd(arr('tall', 0)))", {AG: 1}, {}),
    "svd_wide": ("rebuilt(lib.linalg.svd(arr('wide', 1)))", {AG: 1}, {}),
    "svd_values": ("lib.linalg.svd(arr('A', 1), compute_uv=False)", dict(_CAQR, all_to_all=1), {}),
    "svd_replicated": ("lib.linalg.svd(arr('A'))", {}, {"sign": True}),
    "pinv": ("lib.linalg.pinv(arr('tall', 0))", {AG: 1}, {"tol": 1e-4}),
    "matrix_rank": ("lib.linalg.matrix_rank(arr('A', 0))", _CAQR, {}),
    "cg": ("lib.linalg.cg(arr('spd', 0), arr('v9')[:8], lib.zeros(8, dtype=lib.float64, **{}))",
           {AR: 17, AG: 8}, {}),
    "lanczos": ("seeded(lib.linalg.lanczos, arr('spd32', 0), 6)", {AR: 1, AG: 7},
                {"tol": 1e-4}),
    "lanczos_replicated": ("seeded(lib.linalg.lanczos, arr('spd32'), 4)", {}, {"tol": 1e-4}),
    "solve": ("lib.linalg.solve(arr('spd'), arr('v9')[:8])", {}, {}),
    "solve_split0": ("lib.linalg.solve(arr('spd', 0), arr('v9')[:8])", {AR: 16}, {}),
    "cholesky": ("lib.linalg.cholesky(arr('spd'))", {}, {}),
    "cholesky_split0": ("lib.linalg.cholesky(arr('spd', 0))", {AR: 4}, {}),
    "cholesky_split1": ("lib.linalg.cholesky(arr('spd', 1))", {AR: 4, "all_to_all": 1}, {}),
    "eigh": ("lib.linalg.eigh(arr('spd'))", {}, {"sign": True}),
    "eigh_split0": ("lib.linalg.eigh(arr('spd', 0))", {AR: 3, AG: 2, "all_to_all": 1}, {"sign": True}),
    "lstsq_tall": ("lib.linalg.lstsq(arr('tall', 0), arr('tall', 0)[:, 0])", {AG: 1, AR: 1}, {}),
    "lstsq_wide": ("lib.linalg.lstsq(arr('wide', 1), arr('v9')[:4])", {AG: 1}, {"tol": 1e-4}),
    "cov": ("lib.cov(arr('A', 0))", {AG: 1}, {}),
    "cov_rowvar": ("lib.cov(arr('A', 0), rowvar=False)", {AR: 2}, {}),
    "cov_y": ("lib.cov(arr('A', 1)[:3], arr('y', 1), bias=True)", {AR: 2}, {}),
    "corrcoef": ("lib.corrcoef(arr('A', 1), rowvar=False)", {AG: 2, "permute": 2}, {}),
})


def _heat_tpu(case, comm):
    env = dict(_build_env(hj, _spec(), comm=comm), comm=comm)
    return pack(eval(CASES[case][0].replace("**{}", "comm=comm"), env))  # noqa: S307


def _signs(got, want):
    """``got`` with each column's sign flipped to ``want``'s."""
    if got.ndim != 2:
        return got
    idx = np.argmax(np.abs(want), axis=0)
    flip = np.sign(got[idx, np.arange(got.shape[1])]) != np.sign(want[idx, np.arange(want.shape[1])])
    return np.where(flip[None, :], -got, got)


def _close(got, want, opts):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, opts)
        return
    if not isinstance(want, dict):
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64), rtol=1e-6)
        return
    assert (got["dtype"], got["gshape"], got["split"]) == \
        (want["dtype"], want["gshape"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
    g, w = got["values"], want["values"]
    if w.dtype.kind not in "fc":
        np.testing.assert_array_equal(g, w)
        return
    if opts.get("sign"):
        g = _signs(g, w)
    tol = opts.get("tol", 2e-5 if w.dtype != np.float64 else 1e-10)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


_REFS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """heat_tpu's results on one and on two devices, in four processes of
    their own from the module's start."""
    names = list(CASES)
    refs = start_refs(tmp_path_factory.mktemp("linalg_refs"), "test_torch_linalg",
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
    _close(got, reference(_REFS["refs"], "C1", case), CASES[case][2])


# world-2 cases of the port's communicator alone: a column-major tensor (as
# LAPACK returns its factors) all-reduced
_COMM_CASES = {"allreduce_strided": "lib.get_comm().Allreduce(torch.arange(6.0).reshape(3, 2).T"
                                    ".clone() * (1 + lib.get_comm().rank))"}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    cases = {k: v[0].replace("**{}", "") for k, v in CASES.items()}
    spec = dict(_spec(), cases=dict(cases, **_COMM_CASES))
    handle = start_world(tmp_path_factory.mktemp("linalg_world2"), spec, 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(world2, case):
    got, stats = world2[case]
    _close(got, reference(_REFS["refs"], "C2", case), CASES[case][2])
    assert stats == CASES[case][1], stats


def test_world2_allreduce_of_a_strided_tensor(world2):
    got, stats = world2["allreduce_strided"]
    np.testing.assert_array_equal(got, 3 * np.arange(6.0).reshape(3, 2).T)
    assert stats == {AR: 1}


def test_matmul_keeps_float32_at_full_precision():
    """No TF32: a float32 product of a 1 + 2^-20 entry keeps that bit."""
    a = ht.array(np.array([[1 + 2.0 ** -20]], dtype=np.float32))
    assert float((a @ a).item()) == np.float32(1 + 2.0 ** -20) ** 2
    assert not torch.backends.cuda.matmul.allow_tf32
