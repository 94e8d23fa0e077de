"""The case table of ``test_torch_estimators.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu, so the processes computing heat_tpu's references start
quickly. ``_build_env(lib, spec, **kw)`` binds the same helpers to the port
(``lib = ht``) or to heat_tpu (``lib = hj``, ``kw`` its mesh).
"""

import numpy as np

from torch_world import pack


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
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((3, 4)) * 5
    y = rng.integers(0, 3, 61)
    x = (centers[y] + rng.standard_normal((61, 4))).astype(np.float32)
    yt = rng.integers(0, 3, 23)
    xt = (centers[yt] + 1.5 * rng.standard_normal((23, 4))).astype(np.float32)
    return {
        "X": x,
        "XD": np.concatenate([x[:20]] * 3),  # every row thrice: distances tie exactly
        "YD": np.arange(60) % 7,
        "Y": np.array([2, 5, 9])[y],  # classes with gaps
        "YF": (y + 0.5).astype(np.float32),  # float labels
        "Y4": np.arange(61) % 4,  # four labels in every blob: vote ties
        "XT": xt,
        "W": rng.uniform(0.1, 2.0, 61),
        "IMG": rng.integers(0, 256, (10, 4, 5), dtype=np.uint8),
        "LBL": rng.integers(0, 10, 10, dtype=np.uint8),
        "H5": rng.standard_normal((300, 3)).astype(np.float32),
        "H5L": rng.integers(0, 7, 300),
        "HWC": rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
    }


def _tf_example():
    """A serialized ``tf.train.Example`` built byte by byte: an int64 list
    (a negative value, ten varint bytes), a bytes list, a packed float list
    and an unpacked one, and the TFRecord frame of two such records."""
    import struct

    def varint(v):
        v &= (1 << 64) - 1
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num, wire, payload):
        tag = varint(num << 3 | wire)
        if wire == 2:
            return tag + varint(len(payload)) + payload
        return tag + payload

    def feature(name, kind, body):
        entry = field(1, 2, name.encode()) + field(2, 2, field(kind, 2, body))
        return field(1, 2, entry)

    ints = field(1, 2, varint(7) + varint(-3) + varint(300))
    raw = field(1, 2, b"abc") + field(1, 2, b"")
    packed = field(1, 2, struct.pack("<2f", 1.5, -2.0))
    unpacked = field(1, 5, struct.pack("<f", 0.25)) + field(1, 5, struct.pack("<f", 8.0))
    body = field(1, 2, feature("image/height", 3, ints) + feature("name", 1, raw)
                 + feature("vals", 2, packed) + feature("more", 2, unpacked))

    def frame(b):
        return struct.pack("<q", len(b)) + b"\0" * 4 + b + b"\0" * 4

    return body, frame(body) + frame(body[:0])


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh.
    The MNIST, HDF5 and TFRecord files are written once per process, into a
    folder that is removed when the process exits."""
    import gzip
    import os
    import struct
    import tempfile

    import h5py

    g = globals()
    if "_DIR" not in g:
        g["_DIR"] = tempfile.TemporaryDirectory()
        d = g["_DIR"].name

        def idx(path, a, opener=open):
            with opener(path, "wb") as f:
                f.write(struct.pack(">HBB", 0, 8, a.ndim))
                f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
                f.write(a.tobytes())

        idx(os.path.join(d, "train-images-idx3-ubyte"), spec["IMG"])
        idx(os.path.join(d, "train-labels-idx1-ubyte"), spec["LBL"])
        os.makedirs(os.path.join(d, "MNIST", "raw"))
        idx(os.path.join(d, "MNIST", "raw", "t10k-images-idx3-ubyte.gz"), spec["IMG"][::-1],
            gzip.open)
        idx(os.path.join(d, "MNIST", "raw", "t10k-labels-idx1-ubyte.gz"), spec["LBL"][::-1],
            gzip.open)
        with h5py.File(os.path.join(d, "p.h5"), "w") as f:
            f.create_dataset("data", data=spec["H5"])
            f.create_dataset("labels", data=spec["H5L"])
        with open(os.path.join(d, "r.tfrecord"), "wb") as f:
            f.write(_tf_example()[1])
    d = g["_DIR"].name

    def arr(name, split=0):
        return lib.array(spec[name] if isinstance(name, str) else name, split=split, **kw)

    def state(nb, x=None):
        out = {k: np.asarray(getattr(nb, k).numpy()) for k in
               ("classes_", "theta_", "var_", "class_count_", "class_prior_")}
        out["epsilon_"] = np.float64(nb.epsilon_)
        if x is not None:
            out["predict"] = np.asarray(nb.predict(x).numpy())
        return out

    def gnb(split=0, y="Y", **fit):
        nb = lib.naive_bayes.GaussianNB(**fit.pop("init", {}))
        nb.fit(arr("X", split), arr(y, split), **fit)
        xt = arr("XT", split)
        return (nb.classes_, nb.theta_, nb.var_, nb.class_count_, nb.class_prior_,
                np.float64(nb.epsilon_), nb.predict(xt), nb.predict_proba(xt),
                nb.predict_log_proba(xt), nb.logsumexp(nb.predict_log_proba(xt), axis=1))

    def gnb_parts():
        nb = lib.naive_bayes.GaussianNB()
        x, y = spec["X"], spec["Y"]
        nb.partial_fit(arr(x[:37]), arr(y[:37]), classes=np.array([2, 5, 9]))
        nb.partial_fit(arr(x[37:]), arr(y[37:]))
        return (nb.theta_, nb.var_, nb.class_count_, nb.class_prior_, np.float64(nb.epsilon_),
                nb.predict(arr("XT")))

    def knn(k=5, xsplit=0, ysplit=0, tsplit=0, y="Y", x="X"):
        c = lib.classification.KNeighborsClassifier(n_neighbors=k)
        c.fit(arr(x, xsplit), arr(y, ysplit))
        return c.predict(arr("XT", tsplit))

    def shuffled(seed=3):
        lib.random.seed(seed)
        ds = lib.utils.data.Dataset([arr("X"), arr("Y")])
        lib.utils.data.dataset_shuffle(ds)
        return tuple(ds.arrays)

    def loader(seed=4, **kws):
        lib.random.seed(seed)
        dl = lib.utils.data.DataLoader(data=[arr("X"), arr("Y")], batch_size=16, **kws)
        # heat_tpu's batches as numpy arrays (a jax int64 array unpickled
        # where x64 is off would narrow)
        return [tuple(t if hasattr(t, "gshape") else np.asarray(t) for t in b)
                for epoch in range(2) for b in dl], len(dl)

    def mnist(train=True):
        ds = lib.utils.data.MNISTDataset(d, train=train)
        return tuple(ds.arrays) + (len(ds),)

    def partial_h5():
        ds = lib.utils.data.PartialH5Dataset(os.path.join(d, "p.h5"),
                                             dataset_names=["data", "labels"], initial_load=100,
                                             load_length=70)
        it = lib.utils.data.PartialH5DataLoaderIter(ds, batch_size=32, seed=5)
        return [tuple(np.asarray(t) for t in b) for b in it], len(ds)

    def tfrecord():
        from importlib import import_module

        tools = import_module(lib.__name__ + ".utils.data._utils")
        body = _tf_example()[0]
        parsed = tools.parse_tf_example(body)
        return (tuple(tools.tfrecord_index(os.path.join(d, "r.tfrecord"))),
                tuple((k, tuple(v)) for k, v in sorted(parsed.items())))

    def parter(n, **k):
        return lib.utils.data.parter(n, **k, **kw)

    def transforms():
        vt = lib.utils.vision_transforms
        t = vt.Compose([vt.ToTensor(), vt.Normalize(0.5, 0.25), vt.Lambda(lambda v: v * 2)])
        return np.asarray(t(spec["HWC"]))

    return {"lib": lib, "np": np, "arr": arr, "gnb": gnb, "gnb_parts": gnb_parts, "knn": knn,
            "shuffled": shuffled, "loader": loader, "mnist": mnist, "partial_h5": partial_h5,
            "tfrecord": tfrecord, "transforms": transforms, "state": state, "parter": parter,
            "spec": spec}


# a fit that finds its classes: the distributed unique of the labels and its
# read to the host (heat_tpu: two network programs, two all-gathers), then
# the class moments in ONE packed all-reduce
GNB_FIT = {"permute": 3, "all_reduce": 1, "exscan": 1, "all_gather": 2, "packed_all_reduce": 1}
# two epochs of a shuffle (a ring step an array) and 16-row batches of the
# two arrays, each a split-axis slice of two permute rounds
LOADER = {"ring_step": 4, "permute": 2 * 3 * 2 * 2}

# name -> (expression, collectives at world size 2, comparison)
CASES = {
    "gnb_fit": ("gnb()", GNB_FIT, "f64"),
    "gnb_sample_weight": ("gnb(sample_weight=spec['W'])", GNB_FIT, "f64"),
    "gnb_priors": ("gnb(init={'priors': [0.2, 0.5, 0.3]})", GNB_FIT, "f64"),
    "gnb_replicated": ("gnb(split=None)", {}, "f64"),
    "gnb_partial_fit": ("gnb_parts()", {"packed_all_reduce": 2}, "f64"),
    "gnb_state": ("state(lib.naive_bayes.GaussianNB().fit(arr('X'), arr('Y')), arr('XT'))",
                  GNB_FIT, "f64"),
    "knn": ("knn()", {"ring_step": 1}, "exact"),
    "knn_replicated_train": ("knn(xsplit=None, ysplit=None)", {}, "exact"),
    "knn_replicated_test": ("knn(tsplit=None)", {"ring_step": 1}, "exact"),
    "knn_labels_replicated": ("knn(ysplit=None)", {"ring_step": 1}, "exact"),
    "knn_float_labels": ("knn(3, y='YF')", {"ring_step": 1}, "exact"),
    "knn_vote_ties": ("knn(4, y='Y4')", {"ring_step": 1}, "exact"),
    "knn_distance_ties": ("knn(4, x='XD', y='YD')", {"ring_step": 1}, "exact"),
    "knn_distance_ties_replicated": ("knn(4, xsplit=None, ysplit=None, x='XD', y='YD')", {},
                                     "exact"),
    "knn_vote_ties_replicated": ("knn(4, xsplit=None, ysplit=None, y='Y4')", {}, "exact"),
    "shuffle": ("shuffled()", {"ring_step": 2}, "exact"),
    "loader": ("loader()", LOADER, "exact"),
    "loader_no_shuffle": ("loader(shuffle=False, drop_last=False)", {"permute": 2 * 4 * 2 * 2},
                          "exact"),
    "parter": ("parter(9, split=0)", {}, "exact"),
    "parter_f64": ("parter(6, split=1, dtype=lib.float64)", {}, "exact"),
    # heat_tpu builds the dataset on its default mesh: the layout is not compared
    "mnist_raw": ("mnist()", {}, "any_mesh"),
    "mnist_gz": ("mnist(False)", {}, "any_mesh"),
    "partial_h5": ("partial_h5()", {}, "exact"),
    "tfrecord": ("tfrecord()", {}, "exact"),
    "transforms": ("transforms()", {}, "exact"),
}


def _preload():
    """heat_tpu, imported once before the reference jobs fork (its import
    starts no jax backend)."""
    import heat_tpu  # noqa: F401


def _heat_tpu(case, comm):
    import heat_tpu as hj

    return pack(eval(CASES[case][0], _build_env(hj, _spec(), comm=comm)))  # noqa: S307
