"""heat_tpu_torch's checkpointing against heat_tpu's, at world size 1.

* A checkpoint written by either package loads in the other: DNDarrays of
  split 0 and None (float32, int64, bfloat16), a transformer parameter tree
  (the port's through ``utils.convert``), scalars and the step; the arrays
  bitwise equal, split and dtype kept, and the two packages write the same
  manifest for the same state.
* An estimator checkpointed by one package restores into the other's.
* The port's Adam state round-trips within the port: one more step from the
  restored parameters and optimizer is bitwise the step from the originals.
* A corrupt newest step is quarantined and the older one restored; one
  injected ``checkpoint.leaf.write`` fault is retried
  (``checkpoint.write_retries``), two fail the save and leave no file.
* ``run_with_recovery`` with a ``train_fn`` that raises once after step 3's
  save ends bitwise equal to an uninterrupted run and counts one restart.
"""

import json
import os
from collections import namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu as hj  # noqa: E402
from heat_tpu.utils import checkpointing as jck  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.utils import checkpointing as tck  # noqa: E402
from heat_tpu_torch.utils import faults as tfaults  # noqa: E402
from heat_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from heat_tpu_torch.utils.convert import transformer_tree_to_numpy  # noqa: E402

AXES = ("dp", "pp", "tp", "sp")
SMOKE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
_MEMO = {}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


@pytest.fixture(scope="module", autouse=True)
def _drop_memo():
    yield
    _MEMO.clear()


def _model():
    if "model" not in _MEMO:
        grid = ht.MeshGrid((1, 1, 1, 1), AXES, device="cpu")
        _MEMO["model"] = ht.nn.TransformerLM(grid, ht.nn.TransformerLMConfig(**SMOKE))
    return _MEMO["model"]


def _data():
    rng = np.random.default_rng(3)
    return {"a0": rng.standard_normal((7, 3)).astype(np.float32),
            "an": rng.integers(-9, 9, 5).astype(np.int64),
            "ab": np.round(rng.standard_normal((6, 2)) * 8) / 8}


def _state(lib):
    d = _data()
    model = _model()
    tree = transformer_tree_to_numpy(model.init(1, dtype=torch.float32))
    return {"a0": lib.array(d["a0"], split=0), "an": lib.array(d["an"]),
            "ab": lib.array(d["ab"].astype(np.float32), dtype=lib.bfloat16, split=0),
            "params": tree, "lr": 0.01, "name": "run", "flag": True, "none": None,
            "mixed": {"d": lib.array(d["an"], split=0), "n": [np.arange(4), (np.ones(2),)]}}


def _check_loaded(state, values):
    d = _data()
    assert state["__step__"] == 12
    for name, want, split, dtype in (("a0", d["a0"], 0, "float32"), ("an", d["an"], None, "int64"),
                                     ("ab", d["ab"], 0, "bfloat16")):
        got = state[name]
        assert got.split == split and got.dtype.__name__ == dtype, name
        assert np.array_equal(np.asarray(got.numpy(), np.float64), np.asarray(want, np.float64))
    tree = transformer_tree_to_numpy(_model().init(1, dtype=torch.float32))
    flat_got, flat_want = _leaves(state["params"]), _leaves(tree)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        got = values(flat_got[k])
        assert got.dtype == flat_want[k].dtype and np.array_equal(got, flat_want[k]), k
    assert (state["lr"], state["name"], state["flag"], state["none"]) == (0.01, "run", True, None)
    mixed = state["mixed"]  # a DNDarray leaf of a tree keeps its split and dtype
    assert mixed["d"].split == 0 and mixed["d"].dtype.__name__ == "int64"
    assert np.array_equal(np.asarray(mixed["d"].numpy()), d["an"])
    assert isinstance(mixed["n"], list) and isinstance(mixed["n"][1], tuple)
    assert np.array_equal(values(mixed["n"][0]), np.arange(4))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_port_checkpoint_loads_in_heat_tpu(tmp_path):
    tck.save_checkpoint(str(tmp_path / "p"), _state(ht), step=12)
    _check_loaded(jck.load_checkpoint(str(tmp_path / "p")), np.asarray)


def test_heat_tpu_checkpoint_loads_in_port(tmp_path):
    jck.save_checkpoint(str(tmp_path / "j"), _state(hj), step=12)
    state = tck.load_checkpoint(str(tmp_path / "j"))
    _check_loaded(state, lambda t: t.numpy())
    # the parameter tree goes through the converter into the port's model
    tree = {k: {kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict) else v.numpy()
            for k, v in state["params"].items()}
    params = _model().shard_params(tree, dtype=torch.float32)
    ref = _model().init(1, dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(_leaves_list(params), _leaves_list(ref)))


def test_both_packages_write_one_manifest(tmp_path):
    tck.save_checkpoint(str(tmp_path / "p"), _state(ht), step=12)
    jck.save_checkpoint(str(tmp_path / "j"), _state(hj), step=12)
    with open(tmp_path / "p" / "manifest.json") as f, open(tmp_path / "j" / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(tmp_path / "p" / "arrays.npz") as a, np.load(tmp_path / "j" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_estimator_checkpoints_cross_packages(tmp_path):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal((20, 3)) + c for c in (0, 6, 12)]).astype(np.float32)
    jk = hj.cluster.KMeans(n_clusters=3, init="random", random_state=2).fit(hj.array(x, split=0))
    jck.checkpoint_estimator(str(tmp_path / "j"), jk, step=1)
    tk = tck.restore_estimator(str(tmp_path / "j"), ht.cluster.KMeans(n_clusters=5))
    assert tk.n_clusters == 3 and tk.n_iter_ == jk.n_iter_
    assert np.array_equal(tk.cluster_centers_.numpy(), np.asarray(jk.cluster_centers_.numpy()))
    assert np.array_equal(tk.predict(ht.array(x)).numpy(),
                          np.asarray(jk.predict(hj.array(x)).numpy()))
    tck.checkpoint_estimator(str(tmp_path / "p"), tk)
    back = jck.restore_estimator(str(tmp_path / "p"), hj.cluster.KMeans(n_clusters=5))
    assert np.array_equal(np.asarray(back.cluster_centers_.numpy()), tk.cluster_centers_.numpy())
    with pytest.raises(TypeError, match="KMeans"):
        tck.restore_estimator(str(tmp_path / "j"), ht.cluster.KMedians())


def _train(model, tx, params, opt, steps, seed=0):
    toks = np.random.default_rng(seed).integers(0, SMOKE["vocab"], (2, 24))
    step = model.make_train_step(tx)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    return params, opt, losses


def test_adam_state_round_trips_in_port(tmp_path):
    model = _model()
    tx = ht.optim.Adam(1e-2)
    params = model.init(0, dtype=torch.float32)
    opt = tx.init(params)
    params, opt, _ = _train(model, tx, params, opt, 2)
    tck.save_checkpoint(str(tmp_path / "c"), {"params": params, "opt": opt, "step": 2})
    state = tck.load_checkpoint(str(tmp_path / "c"))
    p2, o2 = state["params"], state["opt"]
    assert type(o2) is type(opt) and o2.defaults == opt.defaults
    held = [p for g in o2.param_groups for p in g["params"]]
    assert all(a is b for a, b in zip(held, _leaves_list(p2)))
    a, _, la = _train(model, tx, params, opt, 1, seed=1)
    b, _, lb = _train(model, tx, p2, o2, 1, seed=1)
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(_leaves_list(a), _leaves_list(b)))


def _leaves_list(tree):
    from heat_tpu_torch.core.tree import tree_flatten

    return tree_flatten(tree)[0]


def test_manager_quarantines_corrupt_steps_and_retries_writes(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), every_steps=2, keep=2)
    x = ht.arange(6, split=0)
    assert not mgr.save(1, {"x": x})
    for step in (2, 4, 6):
        assert mgr.save(step, {"x": x * step})
    assert mgr.all_steps() == [4, 6]
    with open(os.path.join(mgr._path(6), "arrays.npz"), "wb") as f:
        f.write(b"truncated")
    c0 = tmetrics.counters()
    with pytest.warns(UserWarning, match="corrupt"):
        step, state = mgr.restore()
    c1 = tmetrics.counters()
    assert step == 4 and np.array_equal(state["x"].numpy(), np.arange(6) * 4)
    assert os.path.isdir(mgr._path(6) + ".corrupt") and mgr.all_steps() == [4]
    assert c1.get("checkpoint.corrupt_skipped", 0) - c0.get("checkpoint.corrupt_skipped", 0) == 1
    assert c1.get("checkpoint.read_retries", 0) - c0.get("checkpoint.read_retries", 0) == 1
    with tfaults.inject("checkpoint.leaf.write=once"):
        assert mgr.save(8, {"x": x})
    c2 = tmetrics.counters()
    assert c2.get("checkpoint.write_retries", 0) - c1.get("checkpoint.write_retries", 0) == 1
    assert mgr.restore()[0] == 8 and os.path.isdir(mgr._path(6) + ".corrupt")
    with tfaults.inject("checkpoint.leaf.write=every:1"):
        with pytest.raises(OSError, match="injected"):
            mgr.save(10, {"x": x})
    assert not os.path.exists(os.path.join(mgr._path(10), "manifest.json"))
    assert [n for n in os.listdir(mgr._path(10)) if "tmp" in n] == []
    Pair = namedtuple("Pair", "a b")
    tck.save_checkpoint(str(tmp_path / "nt"), {"t": Pair(np.ones(2), (np.zeros(1), [3]))})
    with pytest.warns(UserWarning, match="allow"):
        got = tck.load_checkpoint(str(tmp_path / "nt"))["t"]
    assert type(got) is tuple and isinstance(got[1], tuple) and isinstance(got[1][1], list)


def test_run_with_recovery_is_bitwise_an_uninterrupted_run(tmp_path):
    model = _model()
    tx = ht.optim.Adam(1e-2)
    toks = np.random.default_rng(5).integers(0, SMOKE["vocab"], (2, 24))
    step_fn = model.make_train_step(tx)
    crashed = []

    def init():
        params = model.init(0, dtype=torch.float32)
        return {"params": params, "opt": tx.init(params)}

    def train_fn(state, start, save, crash=True):
        params, opt = state["params"], state["opt"]
        for step in range(start, 4):
            params, opt, _ = step_fn(params, opt, toks)
            save(step + 1, {"params": params, "opt": opt})
            if crash and step + 1 == 3 and not crashed:
                crashed.append(step)
                raise RuntimeError("worker lost")
        return {"params": params, "opt": opt}

    ref = train_fn(init(), 0, lambda *a: None, crash=False)
    before = tmetrics.counters().get("checkpoint.recovery_restarts", 0)
    mgr = tck.CheckpointManager(str(tmp_path), every_steps=1, keep=2)
    out = tck.run_with_recovery(train_fn, mgr, init(), backoff_s=0.0)
    assert crashed == [2]
    assert tmetrics.counters().get("checkpoint.recovery_restarts", 0) - before == 1
    assert mgr.all_steps() == [3, 4]
    assert all(torch.equal(a, b) for a, b in zip(_leaves_list(out["params"]),
                                                 _leaves_list(ref["params"])))
    # past max_restarts the failure surfaces
    with pytest.raises(RuntimeError, match="always"):
        tck.run_with_recovery(lambda s, st, sv: (_ for _ in ()).throw(RuntimeError("always")),
                              tck.CheckpointManager(str(tmp_path / "b")), {}, max_restarts=1,
                              backoff_s=0.0)
