"""The port's last estimators (GaussianNB, KNeighborsClassifier), its data
utilities (``utils.data``: Dataset, DataLoader and the seeded shuffles,
MNIST, ``parter``, ``PartialH5Dataset``, the TFRecord helpers) and
``utils.vision_transforms`` against heat_tpu, on the same seeded numpy
data: three Gaussian blobs of 61 points in 4 dimensions with labels 2, 5
and 9 (also float labels, and four labels cycling through every blob so
that votes tie; twenty of the points thrice, so that distances tie), 23
test points, sample weights and priors; small IDX files (raw and
gzipped), an HDF5 file of 300 rows and a TFRecord file built byte by
byte, written by the test.

One table of cases (``torch_estimator_cases.py``) runs twice: in process at
world size 1, and in ONE spawned 2-rank gloo world shared by the module,
against heat_tpu on one and on two devices (its references computed in
processes of their own). Every world-2 case pins its collectives against
heat_tpu's plan: a GaussianNB fit its class moments in ONE
``packed_all_reduce`` (heat_tpu runs five eager all-reduce programs, the
counts, the two moment products and the two column sums), after the
distributed ``unique`` of the labels where no classes are given; KNN's ring
one ``ring_step`` (heat_tpu's ``ppermute`` pair of its one step), the
replicated training set none; a shuffle one ``ring_step`` an array (the
getitem's ring gather of heat_tpu's permutation).

Tolerances: bit for bit for labels, classes, counts, shuffles, batches,
files and transforms; the float64 moments and log likelihoods within rtol
1e-10 of heat_tpu's. On the CPU the port's ``cdist_tile`` is its plain
version; the kernel is held against it on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
from torch_estimator_cases import CASES, _build_env, _spec, _tf_example  # noqa: E402
from torch_world import (finish_world, pack, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)

RTOL = {"f64": 1e-10}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _same(got, want, kind):
    if isinstance(got, dict) and "lshape_map" in got:
        if isinstance(want, dict) and "lshape_map" in want:
            assert (got["dtype"], got["gshape"], got["split"]) == \
                (want["dtype"], want["gshape"], want["split"])
            if kind != "any_mesh":
                np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
            want = want["values"]
        got = got["values"]  # a DNDarray batch against heat_tpu's array slice
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key], kind)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, kind)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if kind in ("exact", "any_mesh") or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[kind], atol=0)


_REFS: dict = {}
WORLD2 = [c for c in CASES if not c.endswith("_w1")]


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """heat_tpu's results on one and on two devices, in six processes of
    their own from the module's start: GaussianNB's cases, KNN's and the
    rest apart, so that related cases share heat_tpu's compiled programs."""
    groups = [[c for c in CASES if c.startswith(pre)] for pre in ("gnb", "knn")]
    groups.append([c for c in CASES if not c.startswith(("gnb", "knn"))])
    refs = start_refs(tmp_path_factory.mktemp("estimator_refs"), "torch_estimator_cases",
                      [(comm, [c for c in g if comm == "C1" or c in WORLD2])
                       for comm in ("C1", "C2") for g in groups])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    spec = dict(_spec(), cases={k: CASES[k][0] for k in WORLD2})
    handle = start_world(tmp_path_factory.mktemp("estimator_world2"), spec, 2,
                         (_build_env, _tf_example))
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


def test_gaussiannb_state_carried_from_heat_tpu(references):
    """A heat_tpu fit carried across by ``gaussiannb_from_numpy_state``
    predicts as heat_tpu's does, and keeps its moments bit for bit."""
    want = reference(_REFS["refs"], "C1", "gnb_state")
    state = {k: v for k, v in want.items() if k != "predict"}
    nb = ht.utils.convert.gaussiannb_from_numpy_state(state)
    for key in ("classes_", "theta_", "var_", "class_count_", "class_prior_"):
        got = getattr(nb, key)
        assert got.split is None
        np.testing.assert_array_equal(got.numpy(), state[key])
    assert nb.epsilon_ == float(state["epsilon_"])
    np.testing.assert_array_equal(nb.predict(ht.array(_spec()["XT"], split=0)).numpy(),
                                  want["predict"])
    with pytest.raises(ValueError):
        ht.utils.convert.gaussiannb_from_numpy_state(dict(state, var_=state["var_"][:2]))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_knn_predict_launches_one_cdist_tile_on_card():
    """A replicated KNN predict on the card: one ``cdist_tile`` launch, and
    the labels of the same predict on the CPU."""
    from heat_tpu_torch.core import kernels

    spec = _spec()
    want = ht.classification.KNeighborsClassifier(5).fit(
        ht.array(spec["X"]), ht.array(spec["Y"])).predict(ht.array(spec["XT"], split=0))
    ht.use_device(None)
    knn = ht.classification.KNeighborsClassifier(5).fit(ht.array(spec["X"]),
                                                        ht.array(spec["Y"]))
    kernels.reset_launches()
    got = knn.predict(ht.array(spec["XT"], split=0))
    assert kernels.launches["cdist_tile"] == 1, kernels.launches
    assert got.larray.device.type == "cuda"
    np.testing.assert_array_equal(got.numpy(), want.numpy())
