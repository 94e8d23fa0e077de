"""The case table of ``test_torch_fusion.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu. Every case is a function of the library (``lib``, the
port or heat_tpu) that builds its inputs from seeded numpy data and returns
plain data: results packed by :func:`torch_world.pack` and the fusion
engine's counter deltas around the calls it makes.
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


def _counts(lib):
    """The counters the port holds against heat_tpu's: the step and fit
    flushes and fallbacks, the fusion program cache's hits, misses and
    compiles."""
    f = lib.core.fusion
    s = f.stats()
    c = f.program_cache().stats()
    return {k: s[k] for k in ("step_flushes", "step_fallbacks", "fit_step_flushes",
                              "fit_step_fallbacks")} | {k: c[k] for k in ("hits", "misses",
                                                                            "compiles")}


def _delta(lib, before):
    after = _counts(lib)
    return {k: after[k] - before[k] for k in after}


def _problem(lib, n, d, h, split, seed=0):
    """heat_tpu's ``_make_problem`` (``tests/test_trace_step.py:49``)."""
    rng = np.random.default_rng(seed)
    X = lib.array(rng.standard_normal((n, d)).astype(np.float32), split=split)
    y = lib.array(rng.standard_normal((n, 1)).astype(np.float32),
                  split=0 if split == 0 else None)
    params = {"w": lib.array(rng.standard_normal((d, h)).astype(np.float32)),
              "b": lib.array(np.zeros(h, np.float32)),
              "v": lib.array(rng.standard_normal((h, 1)).astype(np.float32))}
    return params, X, y


def _mlp_step(lib, lr=0.1):
    """heat_tpu's tanh-MLP regression step with its SGD update
    (``tests/test_trace_step.py:35``)."""
    fusion = lib.core.fusion

    def loss_fn(p, bx, by):
        h = lib.tanh(lib.matmul(bx, p["w"]) + p["b"])
        d = lib.reshape(lib.matmul(h, p["v"]), by.shape) - by
        return lib.mean(d * d)

    def train_step(p, bx, by):
        lval, g = fusion.value_and_grad(loss_fn)(p, bx, by)
        return {k: p[k] - lr * g[k] for k in p}, lval

    return loss_fn, train_step


def vg(lib, split):
    """value_and_grad of the tanh-MLP loss: the loss and each gradient."""
    loss_fn, _ = _mlp_step(lib)
    params, X, y = _problem(lib, 13, 5, 3, split)
    val, g = lib.core.fusion.value_and_grad(loss_fn)(params, X, y)
    return {"loss": pack(val), "grads": {k: pack(v) for k, v in g.items()}}


def vg_split_param(lib):
    """The gradient of a split parameter keeps its layout
    (``tests/test_trace_step.py:143``)."""
    x = lib.array(np.arange(13 * 3, dtype=np.float32).reshape(13, 3), split=0)
    _, g = lib.core.fusion.value_and_grad(lambda p: lib.sum(p["x"] * p["x"] * 0.5))({"x": x})
    return pack(g["x"])


def vg_aux(lib):
    """``has_aux`` (``tests/test_trace_step.py:159``)."""
    def loss_fn(p):
        return lib.sum(p["x"] * 2.0), {"twice": p["x"] * 2.0}

    x = lib.array(np.ones((4, 3), np.float32))
    (val, aux), g = lib.core.fusion.value_and_grad(loss_fn, has_aux=True)({"x": x})
    return {"loss": pack(val), "aux": pack(aux["twice"]), "grad": pack(g["x"])}


def traced(lib, split):
    """Three steps of the tanh-MLP through ``trace_step``."""
    fusion = lib.core.fusion
    _, train_step = _mlp_step(lib)
    params, X, y = _problem(lib, 13, 5, 3, split)
    step = fusion.trace_step(train_step)
    before = _counts(lib)
    with fusion.override(True), fusion.step_override(True):
        p, losses = dict(params), []
        for _ in range(3):
            p, l = step(p, X, y)
            losses.append(pack(l))
    return {"losses": losses, "params": {k: pack(v) for k, v in p.items()},
            "counts": _delta(lib, before)}


def int_step(lib, split):
    """A gradient-free integer step (``tests/test_trace_step.py:110``)."""
    fusion = lib.core.fusion

    def body(state, delta):
        acc = (state * 2 + delta) % 1000003
        return acc, lib.sum(acc)

    rng = np.random.default_rng(3)
    s0 = lib.array(rng.integers(0, 997, (13, 5)).astype(np.int32), split=split)
    d0 = lib.array(rng.integers(0, 997, (13, 5)).astype(np.int32), split=split)
    with fusion.override(True), fusion.step_override(True):
        st, tot = fusion.trace_step(body)(s0, d0)
    return {"state": pack(st), "total": pack(tot)}


def steady(lib):
    """A warm-up call, then five: no program built after the first
    (``tests/test_trace_step.py:175``)."""
    fusion = lib.core.fusion
    _, train_step = _mlp_step(lib)
    params, X, y = _problem(lib, 16, 4, 3, 0, seed=5)
    step = fusion.trace_step(train_step)
    with fusion.override(True), fusion.step_override(True):
        before = _counts(lib)
        p, _ = step(dict(params), X, y)
        first = _delta(lib, before)
        before = _counts(lib)
        for _ in range(5):
            p, _ = step(p, X, y)
    return {"first": first, "then": _delta(lib, before)}


def fallback(lib):
    """A body that reads its loss on the host falls back for its signature
    (``tests/test_trace_step.py:216``)."""
    fusion = lib.core.fusion

    def bad_step(p, bx, by):
        lval, g = fusion.value_and_grad(
            lambda q, a, b: lib.mean((lib.matmul(a, q["w"]) - b) * 1.0))(p, bx, by)
        scale = float(lval)
        return {"w": p["w"] - 0.1 * scale * g["w"]}, lval

    params, X, y = _problem(lib, 8, 4, 1, None, seed=7)
    p = {"w": params["w"][:, :1]}
    step = fusion.trace_step(bad_step)
    out = {}
    with fusion.override(True), fusion.step_override(True):
        for call in ("first", "second"):
            before = _counts(lib)
            pt, lt = step(dict(p), X, y)
            d = _delta(lib, before)
            out[call] = {k: d[k] for k in ("step_flushes", "step_fallbacks")}
    out["loss"], out["w"] = pack(lt), pack(pt["w"])
    return out


def escape(lib):
    """The escape hatch runs eagerly and counts nothing
    (``tests/test_trace_step.py:264``)."""
    fusion = lib.core.fusion
    _, train_step = _mlp_step(lib)
    params, X, y = _problem(lib, 8, 4, 3, None, seed=8)
    step = fusion.trace_step(train_step)
    before = _counts(lib)
    with fusion.step_override(False):
        p, l = step(dict(params), X, y)
    d = _delta(lib, before)
    return {"counts": {k: d[k] for k in ("step_flushes", "step_fallbacks")}, "loss": pack(l)}


def static_int(lib, traced_form):
    """Python ints key the program (``tests/test_trace_step.py:274``);
    ``traced_form`` False runs the eager form (heat_tpu's traced form of
    this case does not finish)."""
    fusion = lib.core.fusion

    def stepn(p, k):
        out = p
        for _ in range(k):
            out = out * 2.0
        return out

    x = lib.array(np.ones((4, 4), np.float32))
    step = fusion.trace_step(stepn)
    with fusion.step_override(traced_form):
        before = _counts(lib)
        res = [pack(step(x, 2)), pack(step(x, 3))]
    return {"values": res, "counts": _delta(lib, before)}


def apply_grads(lib):
    """Four Adam updates of a tree through the optimizer's traced step
    (``tests/test_trace_step.py:289``)."""
    fusion = lib.core.fusion
    rng = np.random.default_rng(9)
    params = {"w": lib.array(rng.standard_normal((6, 3)).astype(np.float32)),
              "b": lib.array(np.zeros(3, np.float32)),
              "deep": {"v": lib.array(np.ones((3, 2), np.float32))}}
    grads = {"w": lib.array(np.ones((6, 3), np.float32)), "b": lib.array(np.ones(3, np.float32)),
             "deep": {"v": lib.array(np.ones((3, 2), np.float32))}}
    opt = lib.optim.DataParallelOptimizer(lib.optim.Adam(lr=0.1))
    before = _counts(lib)
    with fusion.override(True), fusion.step_override(True):
        p = params
        for _ in range(4):
            p = opt.apply_gradients(p, grads)
    d = _delta(lib, before)
    return {"w": pack(p["w"]), "v": pack(p["deep"]["v"]),
            "counts": {k: d[k] for k in ("step_flushes", "misses", "compiles")}}


def _blobs(lib, split):
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((3, 4)) * 5
    lab = rng.integers(0, 3, 61)
    x = (centers[lab] + rng.standard_normal((61, 4))).astype(np.float32)
    return lib.array(x, split=split), lib.array(np.array([2, 5, 9])[lab], split=split), x


def fit(lib, name, on):
    """One estimator with the fit-step engine on or off: its results and
    the fit-step counters."""
    fusion = lib.core.fusion
    X, Y, x = _blobs(lib, 0)
    before = _counts(lib)
    with fusion.fit_override(on):
        if name == "kmeans":
            init = lib.array(x[[0, 20, 40]])
            est = lib.cluster.KMeans(n_clusters=3, init=init, max_iter=6, tol=-1).fit(X)
            res = {"centers": pack(est.cluster_centers_), "labels": pack(est.labels_),
                   "inertia": float(est.inertia_)}
        elif name in ("kmedians", "kmedoids"):
            init = lib.array(x[[0, 20, 40]])
            cls = lib.cluster.KMedians if name == "kmedians" else lib.cluster.KMedoids
            est = cls(n_clusters=3, init=init, max_iter=6).fit(X)
            res = {"centers": pack(est.cluster_centers_), "labels": pack(est.labels_)}
        elif name == "lanczos":
            a = np.random.default_rng(5).standard_normal((24, 24))
            A = lib.array((a + a.T).astype(np.float32), split=0)
            v0 = lib.array(np.full(24, 1 / np.sqrt(24), np.float32), split=0)
            V, T = lib.linalg.lanczos(A, 8, v0)
            res = {"V": pack(V), "T": pack(T)}
        elif name == "lasso":
            yv = lib.array(x[:, 0] * 2.0 - x[:, 1] + 0.5, split=0)
            est = lib.regression.Lasso(lam=0.01, max_iter=12, tol=-1.0).fit(X, yv)
            res = {"theta": pack(est.theta), "n_iter": est.n_iter}
        elif name == "gnb":
            est = lib.naive_bayes.GaussianNB().fit(X, Y)
            res = {"predict": pack(est.predict(X)), "proba": pack(est.predict_proba(X))}
        else:  # knn
            est = lib.classification.KNeighborsClassifier(5).fit(X, Y)
            res = {"predict": pack(est.predict(X))}
    d = _delta(lib, before)
    res["counts"] = {k: d[k] for k in ("fit_step_flushes", "fit_step_fallbacks")}
    return res


def fit_fault(lib):
    """A ``fit.step.dispatch`` fault: one counted fallback, the same fit."""
    fusion = lib.core.fusion
    X, _, x = _blobs(lib, 0)
    init = lib.array(x[[0, 20, 40]])
    before = _counts(lib)
    with lib.utils.faults.inject("fit.step.dispatch=nth:2"):
        est = lib.cluster.KMeans(n_clusters=3, init=init, max_iter=4, tol=-1).fit(X)
    d = _delta(lib, before)
    return {"centers": pack(est.cluster_centers_),
            "counts": {k: d[k] for k in ("fit_step_flushes", "fit_step_fallbacks")}}


def stats_keys(lib):
    """The key sets of the engine's snapshots."""
    return {"fusion": sorted(lib.core.fusion.stats()),
            "runtime": sorted(lib.runtime_stats()["op_engine"]["fusion"]),
            "data": sorted(lib.data.stats())}


def signatures(lib):
    """The parameters (names, kinds, defaults) of part (a)'s public names."""
    import inspect

    names = ("enabled", "set_enabled", "override", "step_enabled", "set_step_enabled",
             "step_override", "fit_enabled", "set_fit_enabled", "fit_override", "quant_key",
             "chunk_key", "hier_key", "program_cache", "packed_psum", "value_and_grad", "grad",
             "trace_step", "sync", "fit_step_call", "stats", "reset")
    return {n: [(p.name, str(p.kind), repr(p.default)) for p in
                inspect.signature(getattr(lib.core.fusion, n)).parameters.values()]
            for n in names}


def dp_step(lib, packed):
    """Four DataParallel steps of a two-layer MLP on each rank's 8 rows, the
    packed program (``packed``) or the per-parameter all-reduces."""
    import torch

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    opt = lib.optim.DataParallelOptimizer(lib.optim.SGD(lr=0.1))
    dp = lib.nn.DataParallel(net, optimizer=opt)
    rng = np.random.default_rng(0)
    n = lib.get_comm().size * 8
    X = lib.array(rng.standard_normal((n, 8)).astype(np.float32), split=0)
    y = lib.array(rng.integers(0, 4, n), split=0)
    dp.init(X)
    lib.get_comm().reset_stats()
    before = _counts(lib)
    with lib.core.fusion.step_override(packed):
        losses = [dp.step(X, y) for _ in range(4)]
    return {"losses": losses, "counts": _delta(lib, before)}


def psum_dtypes(lib):
    """``packed_psum`` of float32, int64, float64 and float32 values: one
    all-reduce a dtype."""
    import torch

    r = lib.get_comm().rank + 1
    vals = [torch.full((3,), float(r)), torch.full((2,), r, dtype=torch.int64),
            torch.full((4,), r / 4, dtype=torch.float64), torch.full((1,), 2.0 * r)]
    return [v.numpy() for v in lib.core.fusion.packed_psum(vals, lib.get_comm())]


def _flagship(lib):
    """Three steps of the flagship at a tiny width (vocab 61, d_model 32, 4
    heads, 2 layers, d_ff 64) through its step program, Adam(1e-2) (optax's
    ``adam(1e-2)`` for heat_tpu) from ``init(0)`` on a (2, 40) token batch:
    the losses with the step flushes and fallbacks, and the step."""
    cfg = lib.nn.TransformerLMConfig(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    toks = np.random.default_rng(0).integers(0, 61, (2, 40)).astype(np.int32)
    axes = ("dp", "pp", "tp", "sp")
    port = lib.__name__ == "heat_tpu_torch"
    if port:
        import torch

        model = lib.nn.TransformerLM(lib.MeshGrid((1, 1, 1, 1), axes, device="cpu"), cfg)
        params, tx = model.init(0, dtype=torch.float32), lib.optim.Adam(1e-2)
    else:
        import jax
        import optax

        model = lib.nn.TransformerLM(lib.MeshGrid((1, 1, 1, 1), axes,
                                                  devices=jax.devices()[:1]), cfg)
        params, tx, toks = model.init(0), optax.adam(1e-2), model.shard_batch(toks)
    opt_state = tx.init(params)
    before = _counts(lib)
    with lib.core.fusion.override(True), lib.core.fusion.step_override(True):
        step = model.make_train_step(tx)
        losses = []
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, toks)
            losses.append(float(loss))
    d = _delta(lib, before)
    return {"losses": losses, "counts": {k: d[k] for k in ("step_flushes",
                                                           "step_fallbacks")}}, step


def flagship_step(lib):
    return _flagship(lib)[0]


def _build_env(lib, spec, comm=None):
    if comm is not None:
        lib.use_comm(comm)
    return {"lib": lib, "vg": vg, "vg_split_param": vg_split_param, "vg_aux": vg_aux,
            "traced": traced, "int_step": int_step, "steady": steady, "fallback": fallback,
            "escape": escape, "static_int": static_int, "apply_grads": apply_grads,
            "fit": fit, "fit_fault": fit_fault, "stats_keys": stats_keys,
            "signatures": signatures, "dp_step": dp_step, "psum_dtypes": psum_dtypes,
            "flagship_step": flagship_step}


FITS = ("kmeans", "kmedians", "kmedoids", "lanczos", "lasso", "gnb", "knn")

# name -> (expression, tolerance kind); "f32" within rtol 1e-5 (heat_tpu's
# traced-against-eager contract), "lanczos" within 1e-4, "exact" bit for bit
CASES = {
    **{f"vg_{s}": (f"vg(lib, {s})", "f32") for s in ("None", "0", "1")},
    "vg_split_param": ("vg_split_param(lib)", "exact"),
    "vg_aux": ("vg_aux(lib)", "exact"),
    **{f"traced_{s}": (f"traced(lib, {s})", "f32") for s in ("None", "0", "1")},
    **{f"int_step_{s}": (f"int_step(lib, {s})", "exact") for s in ("None", "0", "1")},
    "steady": ("steady(lib)", "exact"),
    "fallback": ("fallback(lib)", "f32"),
    "escape": ("escape(lib)", "f32"),
    "apply_grads": ("apply_grads(lib)", "f32"),
    "flagship_step": ("flagship_step(lib)", "f32"),
    # the Lanczos basis within 1e-4, as test_torch_linalg.py's own case
    **{f"fit_{n}_{on}": (f"fit(lib, {n!r}, {on})", "lanczos" if n == "lanczos" else "f32")
       for n in FITS for on in ("True", "False")},
    "fit_fault": ("fit_fault(lib)", "f32"),
    "stats_keys": ("stats_keys(lib)", "exact"),
    "signatures": ("signatures(lib)", "exact"),
}
# the cases the 2-rank world runs against heat_tpu on two devices: the fits
# whose distributed step goes through fit_step_call only above one rank
WORLD2 = [f"fit_{n}_True" for n in ("kmedians", "kmedoids", "lasso", "knn", "lanczos")]
# the port's own world-2 cases: the packed DataParallel step and the
# per-dtype packing, with their pinned collectives
WORLD2_PORT = {"dp_packed": "dp_step(lib, True)", "dp_eager": "dp_step(lib, False)",
               "psum_dtypes": "psum_dtypes(lib)"}


def _preload():
    """heat_tpu, imported once before the reference jobs fork (its import
    starts no jax backend)."""
    import heat_tpu  # noqa: F401


def _heat_tpu(case, comm):
    import heat_tpu as hj

    if case == "static_int":
        # heat_tpu's traced form of this case does not finish: its eager one
        return static_int(hj, False)
    return eval(CASES[case][0], _build_env(hj, None, comm=comm))  # noqa: S307
