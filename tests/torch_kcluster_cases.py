"""The case table of ``test_torch_kcluster.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu: the processes computing heat_tpu's references start
sooner, and so does the test module's own world.
"""

import numpy as np

from torch_world import pack

K = 3


def __getattr__(name):
    """``C1`` and ``C2``: heat_tpu communicators of one and two devices."""
    if name in ("C1", "C2"):
        import jax
        from heat_tpu.core.communication import TPUCommunication

        comm = TPUCommunication(jax.devices()[:int(name[1])])
        globals()[name] = comm
        return comm
    raise AttributeError(name)


def _spec():
    rng = np.random.default_rng(41)
    centers = rng.standard_normal((K, 4)) * 6
    x = (centers[np.arange(61) % K] + rng.standard_normal((61, 4))).astype(np.float32)
    return {"X": x, "C0": x[[1, 2, 3]] + np.float32(0.5)}


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh. The
    stream's HDF5 file is written once per process, into a folder of its
    own that is removed when the process exits."""
    import os
    import tempfile

    import h5py

    g = globals()
    if "_STREAM_FILE" not in g:
        g["_STREAM_DIR"] = tempfile.TemporaryDirectory()
        g["_STREAM_FILE"] = os.path.join(g["_STREAM_DIR"].name, "x.h5")
        with h5py.File(g["_STREAM_FILE"], "w") as f:
            f.create_dataset("data", data=spec["X"])
    path = g["_STREAM_FILE"]
    x = spec["X"]

    def arr(a, split=None):
        return lib.array(a, split=split, **kw)

    def chunks(dtype=None):
        out = [arr(x[i:i + 16], 0) for i in range(0, 61, 16)]
        return out if dtype is None else [c.astype(getattr(lib, dtype)) for c in out]

    def est(name, init="c0", **k):
        if isinstance(init, str) and init == "c0":
            init = arr(spec["C0"])
        if "dtype" in k:
            init = init.astype(getattr(lib, k.pop("dtype")))
        return getattr(lib.cluster, name)(n_clusters=3, init=init, **k)

    def streamed(e, source, rows=16):
        e.fit_stream(source, rows_per_chunk=rows if hasattr(source, "iter_chunks") else None)
        assert e.labels_ is None
        return e.cluster_centers_, e.inertia_, e.n_iter_

    def datastream():
        return lib.load_hdf5(path, "data", stream=True, **kw)

    def fitted(e, split=0):
        e.fit(arr(x, split))
        return e.cluster_centers_, e.labels_, e.n_iter_, e.predict(arr(x, split)), e.inertia_

    return {"lib": lib, "np": np, "est": est, "streamed": streamed, "chunks": chunks,
            "datastream": datastream, "fitted": fitted}


def _kmeans_stream(epochs):
    return {"packed_all_reduce": (epochs + 1) * 4}


def _per_step(step):
    """The collectives of ``n`` KMedians or KMedoids steps."""
    return lambda n: {kind: n * calls for kind, calls in step.items()}


KMEDIANS = _per_step({"permute": 1, "all_reduce": 1, "packed_all_reduce": 1})
KMEDOIDS = _per_step({"all_reduce": 3, "packed_all_reduce": 2})
# random seeding with random_state=7 draws rows 13, 34 and 15, which lie in
# chunks 0 and 2: each of those chunks' x[rows] is one ring step and its
# resplit(None) one all-gather; then four epochs and the finalize pass
SEEDED = dict(_kmeans_stream(4), ring_step=2, all_gather=2)
# name -> (expression, collectives at world size 2 (or a function of the
# result's n_iter), kind of comparison)
CASES = {
    "kmeans_datastream": ("streamed(est('KMeans', max_iter=6, tol=-1.0), datastream())",
                          _kmeans_stream(6), "kmeans"),
    "kmeans_callable": ("streamed(est('KMeans', max_iter=5, tol=-1.0), lambda: iter(chunks()))",
                        _kmeans_stream(5), "kmeans"),
    "kmeans_list_converges": ("streamed(est('KMeans', max_iter=30), chunks())",
                              lambda n: _kmeans_stream(n), "kmeans"),
    "kmeans_random_init": ("streamed(est('KMeans', 'random', max_iter=4, tol=-1.0, "
                           "random_state=7), datastream())", SEEDED, "kmeans"),
    "kmeans_tail": ("streamed(est('KMeans', max_iter=3, tol=-1.0), datastream(), 20)",
                    {"packed_all_reduce": 4 * 4}, "kmeans"),
    "kmeans_bf16": ("streamed(est('KMeans', max_iter=4, tol=-1.0, dtype='bfloat16'), "
                    "chunks('bfloat16'))", _kmeans_stream(4), "bf16"),
    "kmeans_in_memory": ("fitted(est('KMeans', max_iter=6, tol=-1.0))",
                         {"packed_all_reduce": 6, "all_reduce": 1}, "kmeans"),
    "kmedians_fit": ("fitted(est('KMedians', max_iter=5, tol=-1.0))", KMEDIANS(5), "exact"),
    "kmedians_converges": ("fitted(est('KMedians', max_iter=30))", KMEDIANS, "exact"),
    "kmedians_stream": ("streamed(est('KMedians', max_iter=3, tol=-1.0), chunks())",
                        KMEDIANS(12), "exact"),
    "kmedians_datastream": ("streamed(est('KMedians', max_iter=2, tol=-1.0), datastream())",
                            KMEDIANS(8), "exact"),
    "kmedoids_fit": ("fitted(est('KMedoids', max_iter=30))", KMEDOIDS, "exact"),
    "kmedoids_fit_replicated": ("fitted(est('KMedoids', max_iter=30), None)", {}, "exact"),
    "kmedoids_stream": ("streamed(est('KMedoids', max_iter=3), chunks())",
                        lambda n: KMEDOIDS(4 * n), "exact"),
    # chunks of 20 rows: the last one holds 1 row, so rank 1 has none of it
    "kmedoids_stream_tail": ("streamed(est('KMedoids', max_iter=3), datastream(), 20)",
                             lambda n: KMEDOIDS(4 * n), "exact"),
    "kmedians_stream_tail": ("streamed(est('KMedians', max_iter=2, tol=-1.0), datastream(), "
                             "20)", KMEDIANS(8), "exact"),
}


def _preload():
    """heat_tpu, imported once before the reference jobs fork (its import
    starts no jax backend)."""
    import heat_tpu  # noqa: F401


def _heat_tpu(case, comm):
    import heat_tpu as hj

    env = _build_env(hj, _spec(), comm=comm)
    return pack(eval(CASES[case][0], env))  # noqa: S307
