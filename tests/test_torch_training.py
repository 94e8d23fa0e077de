"""heat_tpu_torch's transformer training path against heat_tpu's, on the
decode-smoke configuration (vocab 61, d_model 32, 4 heads, 2 layers, d_ff
64), a (2, 40) token batch and identical float32 master weights from
``init(0)``.

Held against heat_tpu: ``loss_and_grad_fn`` in float32 (heat_tpu dense, and
with its Pallas flash kernels in interpret mode) and in bfloat16 compute;
three ``make_train_step`` steps of ``ht.optim.Adam(1e-2)`` against optax's
``adam(1e-2)``, and one of ``SGD(0.05)`` against ``sgd(0.05)``: the losses
and the parameters after the steps. Plus the collective counters at world
size 1, the serving parameters' dtype, serving with parameters that require
grad, and the tree conversion both ways.

Tolerances: float32 losses at rtol 1e-5; float32 gradients and parameters
within 1e-5 of each leaf's largest magnitude (the same float32 products and
sums, taken in another order; measured below 1e-6). After Adam steps the
parameters may differ by 1e-3 of the steps' largest movement (n · lr) on
top: Adam divides each gradient element by its own running magnitude, so an
element whose gradient lies within float32 noise of zero steps by an amount
that noise decides (measured: 6e-5 of it). bfloat16: the loss
within twice ``chip_smoke.bf16_loss_tol`` and every gradient leaf within
twice ``chip_smoke.bf16_grad_tol`` in relative norm, the rules the card
holds the bf16 model to against a float32 copy, doubled because here both
sides round.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import pallas_kernels as pk  # noqa: E402
from heat_tpu.nn.transformer import TransformerLM as JaxLM  # noqa: E402
from heat_tpu.nn.transformer import TransformerLMConfig as JaxConfig  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import kernels as tk  # noqa: E402
from heat_tpu_torch.utils.convert import (transformer_params_from_numpy,  # noqa: E402
                                          transformer_tree_to_numpy)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
AXES = ("dp", "pp", "tp", "sp")
F32_TOL = 1e-5
_MEMO = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_memo():
    yield
    _MEMO.clear()


def _chip_smoke():
    if "cs" not in _MEMO:
        spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MEMO["cs"] = mod
    return _MEMO["cs"]


def _jax_model(dtype=jnp.float32):
    """A fresh heat_tpu model on one CPU device (each has its own program
    cache, so a Pallas setting is traced into its own programs)."""
    grid = hj.MeshGrid((1, 1, 1, 1), AXES, devices=jax.devices()[:1])
    return JaxLM(grid, JaxConfig(**SMOKE, compute_dtype=dtype))


def _port(dtype=torch.float32):
    grid = ht.MeshGrid((1, 1, 1, 1), AXES, device="cpu")
    model = ht.nn.TransformerLM(grid, ht.nn.TransformerLMConfig(**SMOKE, compute_dtype=dtype))
    return model, model.init(0, dtype=torch.float32)


def _toks():
    return np.random.default_rng(0).integers(0, SMOKE["vocab"], (2, 40)).astype(np.int32)


def _leaves(tree):
    """``(path, array)`` of a heat_tpu-layout numpy tree."""
    return [(jax.tree_util.keystr(path), np.asarray(a))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_trees_close(got, want, tol=F32_TOL, atol=0.0):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max() + atol,
                                   err_msg=path)


def _jax_loss_and_grad(dtype, pallas):
    key = ("jax_lg", str(dtype), pallas)
    if key not in _MEMO:
        jm = _jax_model(dtype)
        pk.set_pallas(pallas)
        try:
            loss, grads = jm.loss_and_grad_fn()(jm.init(0), jm.shard_batch(_toks()))
        finally:
            pk.set_pallas(None)
        _MEMO[key] = (float(loss), jax.tree.map(np.asarray, grads))
    return _MEMO[key]


@pytest.mark.parametrize("pallas", [False, True])
def test_loss_and_grad_matches_jax_float32(pallas):
    want_loss, want_grads = _jax_loss_and_grad(jnp.float32, pallas)
    tm, tp = _port()
    loss, grads = tm.loss_and_grad_fn()(tp, _toks())
    assert loss.shape == () and loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), want_loss, rtol=F32_TOL)
    assert all(g.dtype == torch.float32 for g in (grads["embed"], grads["layers"][1]["wqkv"]))
    _assert_trees_close(transformer_tree_to_numpy(grads), want_grads)
    # the parameters are untouched and still need no grad
    assert not tp["embed"].requires_grad and tp["embed"].grad is None


def test_loss_and_grad_bf16_within_rule():
    cs = _chip_smoke()
    want_loss, want_grads = _jax_loss_and_grad(jnp.bfloat16, False)
    tm, tp = _port(torch.bfloat16)
    loss, grads = tm.loss_and_grad_fn()(tp, _toks())
    assert grads["layers"][0]["w_up"].dtype == torch.float32  # gradients of the masters
    tm32, tp32 = _port()
    logits32 = tm32.logits_fn()(tp32, _toks())
    lim = 2 * cs.bf16_loss_tol(torch, logits32, SMOKE["n_layers"])
    assert abs(float(loss) - want_loss) <= lim, (float(loss), want_loss, lim)
    g_lim = 2 * cs.bf16_grad_tol(SMOKE["n_layers"])
    for (path, g), (_, w) in zip(_leaves(transformer_tree_to_numpy(grads)), _leaves(want_grads)):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= g_lim, (path, rel, g_lim)


def _jax_steps(tx, n):
    jm = _jax_model()
    params, toks = jm.init(0), jm.shard_batch(_toks())
    opt_state = tx.init(params)
    step = jm.make_train_step(tx)
    losses = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name,n", [("adam", 3), ("sgd", 1)])
def test_train_steps_match_optax(name, n):
    adam = name == "adam"
    jtx, ttx = ((optax.adam(1e-2), ht.optim.Adam(1e-2)) if adam
                else (optax.sgd(0.05), ht.optim.SGD(0.05)))
    want_losses, want_params = _jax_steps(jtx, n)
    tm, tp = _port()
    opt_state = ttx.init(tp)
    step = tm.make_train_step(ttx)
    ids = {id(t) for t in tp["layers"][0].values()}
    comm = ht.get_comm()
    comm.reset_stats()
    losses = []
    for _ in range(n):
        params, opt_state, loss = step(tp, opt_state, _toks())
        assert params is tp and loss.shape == ()  # updated in place, the same objects
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=F32_TOL)
    if n > 1:
        assert losses[0] > losses[1] > losses[2]
    assert {id(t) for t in tp["layers"][0].values()} == ids
    _assert_trees_close(transformer_tree_to_numpy(tp), want_params,
                        atol=1e-3 * n * 1e-2 if adam else 0.0)
    # world size 1: no collective of any kind ran
    assert comm.size == 1 and comm.stats == {}
    assert all(tm.grid.axis(a).stats == {} for a in AXES)
    assert tm.packed_step_supported


def test_serving_params_stay_in_compute_dtype_and_need_no_grad():
    tm, _ = _port(torch.bfloat16)
    serve = tm.init(0)
    assert {t.dtype for t in (serve["embed"], serve["unembed"], *serve["layers"][1].values())} \
        == {torch.bfloat16}
    # the per-use cast is the identity on them: no copy per call
    cast = tm._cast_params(serve["layers"][0])
    assert all(cast[k] is serve["layers"][0][k] for k in cast)
    # every parameter has a storage of its own (in-place updates stay local)
    ptrs = [t.data_ptr() for t in (serve["embed"], *serve["layers"][0].values(),
                                   *serve["layers"][1].values())]
    assert len(set(ptrs)) == len(ptrs)
    # serving entry points record no graph, whatever the parameters require
    grad_params = {k: v for k, v in serve.items() if k != "layers"}
    grad_params["layers"] = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
                             for p in serve["layers"]]
    toks = _toks()[:1, :12]
    tk.reset_launches()
    logits = tm.logits_fn()(grad_params, toks)
    assert not logits.requires_grad and logits.dtype == torch.float32
    assert torch.equal(logits, tm.logits_fn()(serve, toks))
    out = tm.generate(grad_params, toks, 3)
    assert torch.equal(out, tm.generate(serve, toks, 3))
    with ht.serve.serve_transformer(tm, grad_params, 32, decode=True, slots=2) as eng:
        got = eng.generate(toks[0], 3, timeout=60)
    assert np.array_equal(got, out[0].numpy())
    assert tk.launches == {name: 0 for name in tk.launches}  # CPU: plain versions only


def test_tree_conversion_round_trip():
    tm, tp = _port()
    tree = tm.host_init(0)
    back = transformer_tree_to_numpy(tp)
    _assert_trees_close(back, tree, tol=0.0)
    assert back["stages"]["wqkv"].shape == (1, 2, 32, 3, 4, 8)
    again = transformer_params_from_numpy(back, tm.cfg, device="cpu", dtype=torch.float64)
    assert again["layers"][1]["w_down"].dtype == torch.float64
    np.testing.assert_array_equal(again["layers"][1]["w_down"].numpy(),
                                  tree["stages"]["w_down"][0, 1])
    # the tensors copy the numpy input: an in-place update leaves it alone
    before = tree["embed"].copy()
    own = transformer_params_from_numpy(tree, tm.cfg, device="cpu")
    own["embed"].add_(1.0)
    np.testing.assert_array_equal(tree["embed"], before)
