"""The port's KMeans fit, predict and cdist against heat_tpu, on the same
numpy data, at world size 1 in-process and at world size 2 in one spawned
gloo world shared by the module.

Tolerances: float32 rtol 1e-5 (sums taken in another order); the data are
well-separated blobs, so labels, counts and iteration counts agree exactly.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu as hj  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.utils.convert import kmeans_from_numpy_state  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
K = 4


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _blobs(n=301, d=6, k=K, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 8
    x = (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    c0 = (centers + rng.standard_normal((k, d))).astype(np.float32)
    return x, c0


def _fit_both(x, c0, **kw):
    kt = ht.cluster.KMeans(n_clusters=K, init=ht.array(c0), **kw).fit(ht.array(x, split=0))
    kj = hj.cluster.KMeans(n_clusters=K, init=hj.array(c0), **kw).fit(hj.array(x, split=0))
    return kt, kj


def test_fit_matches_heat_tpu():
    x, c0 = _blobs()
    kt, kj = _fit_both(x, c0, max_iter=30)
    assert kt.n_iter_ == kj.n_iter_
    np.testing.assert_allclose(kt.cluster_centers_.numpy(), kj.cluster_centers_.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kt.labels_.numpy(), kj.labels_.numpy())
    np.testing.assert_allclose(kt.inertia_, kj.inertia_, rtol=1e-5)
    assert kt.labels_.split == kj.labels_.split == 0
    # tol < 0 runs every iteration
    kt, kj = _fit_both(x, c0, max_iter=5, tol=-1.0)
    assert kt.n_iter_ == kj.n_iter_ == 5
    np.testing.assert_allclose(kt.cluster_centers_.numpy(), kj.cluster_centers_.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_half_precision_fit_matches_heat_tpu():
    x, c0 = _blobs(seed=3)
    kt = ht.cluster.KMeans(n_clusters=K, init=ht.array(c0).astype(ht.bfloat16),
                           max_iter=10).fit(ht.array(x, split=0).astype(ht.bfloat16))
    kj = hj.cluster.KMeans(n_clusters=K, init=hj.array(c0).astype(hj.bfloat16),
                           max_iter=10).fit(hj.array(x, split=0).astype(hj.bfloat16))
    assert kt.n_iter_ == kj.n_iter_
    np.testing.assert_array_equal(kt.labels_.numpy(), kj.labels_.numpy())
    np.testing.assert_allclose(kt.cluster_centers_.numpy(),
                               kj.cluster_centers_.numpy().astype(np.float32), rtol=2 ** -7)


def test_predict_matches_heat_tpu():
    x, c0 = _blobs(seed=1)
    kt, kj = _fit_both(x, c0, max_iter=30)
    xt, _ = _blobs(n=97, seed=2)
    np.testing.assert_array_equal(kt.predict(ht.array(xt, split=0)).numpy(),
                                  kj.predict(hj.array(xt, split=0)).numpy())


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_seeded_inits_give_finite_centers(init):
    x, _ = _blobs(seed=4)
    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=10, random_state=0)
    km.fit(ht.array(x, split=0))
    c = km.cluster_centers_.numpy()
    assert c.shape == (K, x.shape[1]) and np.isfinite(c).all()
    assert km.labels_.shape == (x.shape[0],)


@pytest.mark.parametrize("expand", [True, False])
def test_cdist_matches_heat_tpu(expand):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((37, 5)).astype(np.float32)
    b = rng.standard_normal((11, 5)).astype(np.float32)
    pairs = [((a, 0), None), ((a, 0), (b, None)), ((a, None), (b, 0)), ((a, 0), (b, 0))]
    for (xa, xs), y in pairs:
        yt = None if y is None else ht.array(y[0], split=y[1])
        yj = None if y is None else hj.array(y[0], split=y[1])
        dt = ht.spatial.cdist(ht.array(xa, split=xs), yt, quadratic_expansion=expand)
        dj = hj.spatial.cdist(hj.array(xa, split=xs), yj, quadratic_expansion=expand)
        assert (dt.shape, dt.split, dt.dtype.__name__) == (dj.shape, dj.split, dj.dtype.__name__)
        np.testing.assert_allclose(dt.numpy(), dj.numpy(), rtol=1e-5, atol=3e-3 if expand else 1e-5)


def test_column_slice_reaches_kernels_contiguous(monkeypatch):
    # X[:, :4] of a split-0 array is a strided view; the card's kernels take
    # contiguous rows only, so the callers must hand them copies
    from heat_tpu_torch.cluster import kmeans as km_mod
    from heat_tpu_torch.core import kernels as tk
    from heat_tpu_torch.spatial import distance as dist_mod

    def contiguous_only(fn):
        def wrapper(*args, **kwargs):
            assert all(a.is_contiguous() for a in args if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(km_mod, "kmeans_step", contiguous_only(tk.kmeans_step))
    monkeypatch.setattr(dist_mod, "cdist_tile", contiguous_only(tk.cdist_tile))
    x, c0 = _blobs(seed=8)
    X = ht.array(x, split=0)
    assert not X[:, :4].larray.is_contiguous()
    init = ht.array(c0[:, :4])
    kt = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=10).fit(X[:, :4])
    kj = hj.cluster.KMeans(n_clusters=K, init=hj.array(c0[:, :4]), max_iter=10).fit(
        hj.array(np.ascontiguousarray(x[:, :4]), split=0))
    np.testing.assert_allclose(kt.cluster_centers_.numpy(), kj.cluster_centers_.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kt.predict(X[:, :4]).numpy(), kj.labels_.numpy())
    seeded = ht.cluster.KMeans(n_clusters=K, init="kmeans++", max_iter=3, random_state=0)
    assert np.isfinite(seeded.fit(X[:, :4]).cluster_centers_.numpy()).all()
    d = ht.spatial.cdist(X[:, :4], quadratic_expansion=True)
    ref = ht.array(np.ascontiguousarray(x[:, :4]), split=0)
    np.testing.assert_array_equal(d.numpy(),
                                  ht.spatial.cdist(ref, quadratic_expansion=True).numpy())


def test_carried_state_predicts_like_heat_tpu():
    x, c0 = _blobs(seed=7)
    kj = hj.cluster.KMeans(n_clusters=K, init=hj.array(c0), max_iter=30).fit(hj.array(x, split=0))
    state = {"cluster_centers_": np.asarray(kj.cluster_centers_.numpy()), "n_clusters": K,
             "inertia_": kj.inertia_, "n_iter_": kj.n_iter_}
    kt = kmeans_from_numpy_state(state, device="cpu")
    assert kt.n_iter_ == kj.n_iter_ and kt.inertia_ == kj.inertia_
    np.testing.assert_array_equal(kt.predict(ht.array(x, split=0)).numpy(),
                                  kj.predict(hj.array(x, split=0)).numpy())


@pytest.mark.parametrize("k,d", [(128, 64), (64, 1024)])
def test_large_kd_lloyd_partial_matches_heat_tpu(k, d):
    """The plain ``kmeans_step`` at k·d past what the card's shared-memory
    path holds (the kernel streams the centroids there) against heat_tpu's
    Lloyd partial (its default XLA step, ``cluster/kmeans.py``
    ``_lloyd_partial``) on the same data and centroids. Well-separated
    blobs: labels and counts agree exactly; float32 sums rtol 1e-5."""
    import jax.numpy as jnp
    from heat_tpu.cluster.kmeans import _lloyd_partial
    from heat_tpu_torch.core import kernels as tk

    rng = np.random.default_rng(k + d)
    n = 1501
    centers = rng.standard_normal((k, d)) * 10
    x = (centers[rng.integers(0, k, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    c = (centers + 0.5 * rng.standard_normal((k, d))).astype(np.float32)
    valid = np.arange(n) < n - 19
    js, jc, ji = _lloyd_partial(jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid[:, None]), k,
                                jnp.float32, jnp.float32)
    ts, tc, ti = tk.kmeans_step_plain(torch.from_numpy(x), torch.from_numpy(c),
                                      torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5 * np.abs(x).max())
    # min(c² − 2·x·c) + x² per row cancels against x²: an absolute limit
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5,
                               atol=1e-6 * float((x.astype(np.float64) ** 2).sum()))


# --------------------------------------------------------------------------- #
# one 2-rank gloo world for the module                                        #
# --------------------------------------------------------------------------- #

_WORKER = r'''
import sys
import numpy as np
import torch.distributed as dist

rank, world, port, data, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
import heat_tpu_torch as ht

ht.use_device("cpu")
d = np.load(data)
res = {}
x = ht.array(d["x"], split=0)
comm = x.comm
comm.reset_stats()
km = ht.cluster.KMeans(n_clusters=int(d["k"]), init=ht.array(d["c0"]), max_iter=30).fit(x)
stats = {kind: rec["calls"] for kind, rec in comm.stats.items()}
res["n_iter"] = km.n_iter_
res["packed"] = stats.get("packed_all_reduce", 0)
res["all_reduce"] = stats.get("all_reduce", 0)
res["other"] = sum(v for kd, v in stats.items() if kd not in ("packed_all_reduce", "all_reduce"))
res["centers"] = km.cluster_centers_.numpy()
res["labels"] = km.labels_.numpy()
res["inertia"] = km.inertia_
res["predict"] = km.predict(x).numpy()
a = ht.array(d["a"], split=0)
res["ring_sym"] = ht.spatial.cdist(a, quadratic_expansion=True).numpy()
res["ring_ab"] = ht.spatial.cdist(a, ht.array(d["b"], split=0)).numpy()
ht.random.seed(3)
res["rand"] = ht.random.rand(70000, 2, split=0).numpy()
res["randint"] = ht.random.randint(0, 1000, (70001,), split=0).numpy()
res["arange_sum"] = ht.arange(13, split=0).sum().item()
res["lshape_map"] = ht.zeros((13, 2), split=0).lshape_map
res["rows"] = x[np.array([300, 0, 151, 150])].numpy()
# a split operand of extent 1 along its split axis broadcasts (rank 1 holds
# no row of it), in both operand orders
A, A0 = ht.array(d["pow_a"], split=0), ht.array(d["pow_a"][:1], split=0)
for key, r in (("pow_a_a0", A ** A0), ("pow_a0_a", A0 ** A)):
    res[key] = r.numpy()
    res[key + "_meta"] = np.array([r.split] + list(r.gshape))
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Run the worker on two gloo ranks once; returns (results, inputs)."""
    tmp = tmp_path_factory.mktemp("world2")
    x, c0 = _blobs()
    rng = np.random.default_rng(8)
    inputs = {"x": x, "c0": c0, "k": K,
              "a": rng.standard_normal((37, 5)).astype(np.float32),
              "b": rng.standard_normal((29, 5)).astype(np.float32),
              "pow_a": rng.uniform(0.5, 2.0, (4, 3)).astype(np.float32)}
    np.savez(tmp / "in.npz", **inputs)
    (tmp / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), "2", port,
                               str(tmp / "in.npz"), str(tmp / "out.npz")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return dict(np.load(tmp / "out.npz")), inputs


def test_world2_fit_equals_world1(world2):
    res, inp = world2
    k1 = ht.cluster.KMeans(n_clusters=K, init=ht.array(inp["c0"]), max_iter=30)
    k1.fit(ht.array(inp["x"], split=0))
    assert int(res["n_iter"]) == k1.n_iter_
    np.testing.assert_allclose(res["centers"], k1.cluster_centers_.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res["labels"], k1.labels_.numpy())
    np.testing.assert_array_equal(res["predict"], k1.labels_.numpy())
    np.testing.assert_allclose(float(res["inertia"]), k1.inertia_, rtol=1e-6)


def test_world2_one_all_reduce_per_lloyd_iteration(world2):
    res, _ = world2
    # one packed all-reduce per iteration, one for the final inertia, no other collective
    assert int(res["packed"]) == int(res["n_iter"]) > 1
    assert int(res["all_reduce"]) == 1
    assert int(res["other"]) == 0


def test_world2_ring_cdist_matches_heat_tpu(world2):
    res, inp = world2
    a, b = hj.array(inp["a"], split=0), hj.array(inp["b"], split=0)
    np.testing.assert_allclose(res["ring_sym"],
                               hj.spatial.cdist(a, quadratic_expansion=True).numpy(),
                               rtol=1e-5, atol=3e-3)
    np.testing.assert_allclose(res["ring_ab"], hj.spatial.cdist(a, b).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_world2_random_and_layout_equal_world1(world2):
    res, inp = world2
    ht.random.seed(3)
    np.testing.assert_array_equal(res["rand"], ht.random.rand(70000, 2, split=0).numpy())
    np.testing.assert_array_equal(res["randint"],
                                  ht.random.randint(0, 1000, (70001,), split=0).numpy())
    assert int(res["arange_sum"]) == 78
    np.testing.assert_array_equal(res["lshape_map"], [[7, 2], [6, 2]])
    np.testing.assert_array_equal(res["rows"], inp["x"][[300, 0, 151, 150]])


def test_world2_extent1_split_operand_broadcasts_like_heat_tpu(world2):
    res, inp = world2
    a = inp["pow_a"]
    A, A0 = hj.array(a, split=0), hj.array(a[:1], split=0)
    for key, want in (("pow_a_a0", A ** A0), ("pow_a0_a", A0 ** A)):
        assert res[key + "_meta"].tolist() == [want.split] + list(want.gshape) == [0, 4, 3]
        np.testing.assert_allclose(res[key], want.numpy(), rtol=4 * 2.0 ** -23, atol=0)
