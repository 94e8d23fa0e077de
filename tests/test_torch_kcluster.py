"""The port's out-of-core ``fit_stream`` (KMeans' exact epoch, the minibatch
form of KMedians and KMedoids), KMedians and KMedoids against heat_tpu, on
the same seeded numpy data: three well-separated Gaussian blobs of 61
points in 4 dimensions, streamed in chunks of 16 rows (16, 16, 16, 13).

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 2-rank gloo world shared by the module
against heat_tpu on two devices (those references in two processes of
their own, the one-device ones in the test process while they run). The
streams are a ``DataStream`` of an HDF5 file, a callable and a list of
split-0 chunks; the case table is ``torch_kcluster_cases.py``. Every
world-2 case pins its collectives against heat_tpu's plan: KMeans' streamed
epoch one ``packed_all_reduce`` a chunk (``packed_psum`` of sums, counts
and inertia), also in the finalize pass;
a KMedians step one network-sort round (``permute``), one ``all_reduce`` of
the counts and one ``packed_all_reduce`` of the two order statistics; a
KMedoids step one ``all_reduce`` of the counts, two ``all_reduce`` (min) of
the snap's distance and row and two ``packed_all_reduce`` (the member sums,
the medoid rows).

Tolerance: KMeans' centroids and inertia within rtol 1e-5 of heat_tpu's
(float32 sums in another order), bfloat16 within one bfloat16 rounding
(2^-7 relative); a streamed KMeans within 1e-3 of the port's own in-memory
fit. KMedians' medians and KMedoids' medoids are picked data values and
their means, so they and the labels are compared bitwise (the blobs are
far apart: no near-tie).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
import torch_kcluster_cases as cases  # noqa: E402
from torch_kcluster_cases import CASES, _build_env, _heat_tpu, _spec  # noqa: E402
from torch_world import (finish_world, pack, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _meta(got, want):
    assert (got["dtype"], got["gshape"], got["split"]) == \
        (want["dtype"], want["gshape"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])


def _check(case, got, want):
    kind = CASES[case][2]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _meta(g, w)
            g, w = g["values"], w["values"]
        if kind == "exact" or w is None or isinstance(w, (int, np.integer)) or \
                np.asarray(w).dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            rtol = 2.0**-7 if kind == "bf16" else 1e-5
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


def _expected(case, got):
    want = CASES[case][1]
    return want(got[2]) if callable(want) else want


_REFS: dict = {}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """heat_tpu's results on two devices, in two processes of their own
    from the module's start (``torch_kcluster_cases``, which does not import
    the port), one for KMeans and one for KMedians and KMedoids, so that
    related cases share heat_tpu's compiled programs. The world-1 tests
    compute the one-device results themselves meanwhile."""
    kmeans = [n for n in CASES if n.startswith("kmeans_")]
    refs = start_refs(tmp_path_factory.mktemp("kcluster_refs"), "torch_kcluster_cases",
                      [("C2", kmeans), ("C2", [n for n in CASES if n not in kmeans])])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    spec = dict(_spec(), cases={k: v[0] for k, v in CASES.items()})
    handle = start_world(tmp_path_factory.mktemp("kcluster_world2"), spec, 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


# a one-row tail chunk differs from the other chunks only at world size 2,
# where one rank holds none of it
WORLD1 = [case for case in CASES if not case.endswith("_tail")]


@pytest.mark.parametrize("case", WORLD1)
def test_world1_matches_heat_tpu(references, started, case):
    """(``started``: the world-2 ranks run beside these tests.)"""
    ht.get_comm().reset_stats()
    got = pack(eval(CASES[case][0], _build_env(ht, _spec())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _check(case, got, _heat_tpu(case, cases.C1))


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(references, world2, case):
    got, stats = world2[case]
    _check(case, got, reference(_REFS["refs"], "C2", case))
    assert stats == _expected(case, got), stats


@pytest.mark.parametrize("world", [1, 2])
def test_stream_matches_in_memory_fit(world2, world):
    """KMeans streamed from a file, six exact epochs, within 1e-3 of the
    in-memory fit of the same data and seed rows, inertia within 1e-4."""
    res = {name: (world2[name][0] if world == 2 else
                  pack(eval(CASES[name][0], _build_env(ht, _spec()))))  # noqa: S307
           for name in ("kmeans_datastream", "kmeans_in_memory")}
    (sc, si, sn), (mc, _, mn, _, mi) = res["kmeans_datastream"], res["kmeans_in_memory"]
    assert sn == mn == 6
    np.testing.assert_allclose(sc["values"], mc["values"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(si, mi, rtol=1e-4)


def test_stream_refusals_match_heat_tpu():
    """kmeans++ cannot seed a stream; a DataStream needs its chunk size; a
    stream of no chunks has nothing to fit."""
    import heat_tpu as hj
    from torch_kcluster_cases import C1

    x = _spec()["X"]
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        chunks = [lib.array(x[:16], split=0, **kw)]
        with pytest.raises(ValueError):
            lib.cluster.KMedians(n_clusters=3, init="kmeans++").fit_stream(chunks)
        with pytest.raises(ValueError):
            lib.cluster.KMeans(n_clusters=3).fit_stream([])
    with pytest.raises(ValueError):
        ht.cluster.KMeans(n_clusters=3).fit_stream(
            ht.io.DataStream(None, (4, 2), ht.float32, ht.cpu, ht.get_comm()))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_fit_stream_launches_one_kernel_per_chunk_on_card(tmp_path):
    """``fit_stream`` of a NetCDF file onto the card: one ``kmeans_step``
    launch per chunk per pass (the epochs and the finalize pass), none for
    the geometry read, and the centroids of the in-memory fit."""
    from heat_tpu_torch.core import kernels

    x = _spec()["X"]
    ht.use_device(None)
    ht.array(x, split=0).save_netcdf(str(tmp_path / "x.nc"))
    stream = ht.load_netcdf(str(tmp_path / "x.nc"), "data", stream=True)
    init = ht.array(_spec()["C0"])
    kernels.reset_launches()
    km = ht.cluster.KMeans(n_clusters=3, init=init, max_iter=5, tol=-1.0).fit_stream(
        stream, rows_per_chunk=16)
    assert kernels.launches["kmeans_step"] == 4 * 6, kernels.launches
    assert stream.chunks_read == 1 + 4 * 6
    assert km.cluster_centers_.larray.device.type == "cuda"
    ref = ht.cluster.KMeans(n_clusters=3, init=init, max_iter=5, tol=-1.0).fit(
        ht.array(x, split=0))
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref.cluster_centers_.numpy(),
                               rtol=0, atol=1e-3)
