"""Data-parallel training, DASO, the optimizer constructors, the plateau
detector and ``nn.functional`` against heat_tpu, on the same numpy inputs.

One spawned gloo world of 4 ranks runs the cases of ``torch_dp_cases.py``
while heat_tpu computes its references on 4 CPU devices in processes of
their own: ``DataParallel`` on heat_tpu's flax MLP (``Dense(16)``, ReLU,
``Dense(4)``, the same initial weights carried into both packages) for five
SGD(0.5) steps on 32 rows, with the built-in mean cross-entropy (the packed
step) and with a summed loss (the exact per-parameter form);
``DataParallelMultiGPU`` on DASO with nodes of 2 for five steps; DASO's
global sync (the node divergence halves) and its delayed schedule (skip 2,
wait 1). In process: five steps of each of the six optimizer constructors
against heat_tpu's optax transforms, ``DetectMetricPlateau`` and ``F``
against ``jax.nn``.

Tolerances: the losses and parameters within 1e-5 relative of heat_tpu's
(float32 GEMMs and sums in another order); DASO's bfloat16 average of two
nodes is one rounding in either package: equal to 1e-6; an optimizer's
parameters within eight float32 ulps of their value plus 1e-6 of the five
steps' movement (the same formula in optax's order of operations, but for
Adam and AdamW, whose square roots and divisions torch orders its own way,
and AdamW, which rounds its decay and its step apart: a rounding of the
parameter a step more).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import heat_tpu as hj  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402
import torch_dp_cases as C  # noqa: E402
from torch_world import (finish_world, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)

CASES = {"dp_packed": "dp_case('dp_packed')", "dp_exact": "dp_case('dp_exact')",
         "multi": "multi_case()", "daso_sync": "daso_case('daso_sync')",
         "daso_schedule": "daso_case('daso_schedule')"}
_REFS: dict = {}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    refs = start_refs(tmp_path_factory.mktemp("dp_refs"), "torch_dp_cases",
                      [("REF", ["dp_packed", "dp_exact"]),
                       ("REF", ["multi", "daso_sync", "daso_schedule"])])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    handle = start_world(tmp_path_factory.mktemp("dp_world4"), dict(C._spec(), cases=CASES),
                         C.WORLD, (C._build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world(started):
    return finish_world(started, timeout=300)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _flax_to_torch(params):
    """heat_tpu's flax tree as the torch MLP's state names and layout."""
    p = params["params"]

    def weight(k):  # (..., in, out) -> (..., out, in); a replica axis may lead
        return np.swapaxes(np.asarray(k), -1, -2)

    return {"0.weight": weight(p["Dense_0"]["kernel"]), "0.bias": p["Dense_0"]["bias"],
            "2.weight": weight(p["Dense_1"]["kernel"]), "2.bias": p["Dense_1"]["bias"]}


_OPTS = [("SGD", dict(lr=0.1)), ("SGD", dict(lr=0.1, momentum=0.9)),
         ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)), ("Adam", {}),
         ("Adam", dict(lr=1e-2, b1=0.8, b2=0.99)), ("AdamW", {}), ("AdamW", dict(lr=1e-2)),
         ("Adagrad", {}), ("Adadelta", {}), ("RMSprop", {})]


@pytest.mark.parametrize("name,kw", _OPTS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(_OPTS)])
def test_optimizer_matches_optax(references, started, name, kw):
    """(``references``, ``started``: heat_tpu's processes and the spawned
    world run beside these tests.) Five updates of each constructor, heat_tpu's defaults, against the
    optax transform heat_tpu's constructor returns, on the same gradients."""
    rng = np.random.default_rng(7)
    p0 = {"w": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    grads[2]["b"][1] = 0.0  # an element with no gradient on one step
    tx = getattr(hj.optim, name)(**kw)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = tx.init(pj)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    txt = getattr(ht.optim, name)(**kw)
    st = txt.init(pt)
    for g in grads:
        u, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        txt.update({k: torch.tensor(v) for k, v in g.items()}, st, pt)
        for k in p0:
            move = float(np.abs(np.asarray(pj[k]) - p0[k]).max())
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=2.0**-20,
                                       atol=1e-6 * move, err_msg=f"{name} {k}")


def test_detect_metric_plateau_matches_heat_tpu():
    seq = [1.0, 0.9, 0.95, 0.92, 0.91, 0.9, 0.9, 0.89, 0.95, 0.96, 0.97, 0.5]
    for kw in (dict(patience=2, threshold=0.0), dict(mode="max", patience=1,
                                                     threshold_mode="abs", cooldown=2),
               dict(patience=2, threshold=0.05)):
        a, b = hj.optim.DetectMetricPlateau(**kw), ht.optim.DetectMetricPlateau(**kw)
        assert [a.test_if_improving(x) for x in seq] == [b.test_if_improving(x) for x in seq]
        assert a.get_state() == b.get_state()
    c = ht.optim.DetectMetricPlateau()
    c.set_state(b.get_state())
    assert c.get_state() == b.get_state()
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(mode="median")
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(threshold_mode="ratio")


def test_functional_matches_jax_nn():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    lab = rng.integers(0, 7, 5)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    F, J = ht.nn.F, hj.nn.functional
    for name in ("relu", "sigmoid", "softmax", "log_softmax", "gelu", "silu", "swish", "elu",
                 "leaky_relu", "tanh"):
        np.testing.assert_allclose(getattr(F, name)(xt).numpy(),
                                   np.asarray(getattr(J, name)(xj)), rtol=2e-6, atol=2e-7,
                                   err_msg=name)
    np.testing.assert_array_equal(F.one_hot(torch.tensor([0, 6, -1, 7]), 7).numpy(),
                                  np.asarray(J.one_hot(jnp.asarray([0, 6, -1, 7]), 7)))
    for name, args in (("cross_entropy", (lab,)), ("nll_loss", (lab,)), ("mse_loss", (x[::-1],))):
        a = x if name != "nll_loss" else np.asarray(jax.nn.log_softmax(xj))
        got = getattr(F, name)(torch.tensor(a), *(torch.as_tensor(v.copy()) for v in args))
        want = getattr(J, name)(jnp.asarray(a), *(jnp.asarray(v) for v in args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)
    assert F.conv1d is torch.nn.functional.conv1d
    assert ht.nn.Linear is torch.nn.Linear and ht.nn.Dense is torch.nn.Linear
    with pytest.raises(AttributeError):
        ht.nn.NoSuchLayer


def test_dense_stack_state_from_numpy():
    spec = C._spec()
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    state = ht.utils.convert.dense_stack_state_from_numpy(spec["INIT"], net)
    net.load_state_dict(state)
    for name, w in _flax_to_torch(spec["INIT"]).items():
        np.testing.assert_array_equal(net.state_dict()[name].numpy(), w)
    with pytest.raises(ValueError, match="Linear"):
        ht.utils.convert.dense_stack_state_from_numpy(spec["INIT"], torch.nn.Linear(8, 16))


@pytest.mark.parametrize("case", ["dp_packed", "dp_exact"])
def test_data_parallel_matches_heat_tpu(references, world, case):
    got, _ = world[case]
    want = reference(_REFS["refs"], "REF", case)
    _close(got["losses"], want["losses"])
    for name, w in _flax_to_torch(want["params"]).items():
        _close(got["state"][name], w)
    if case == "dp_packed":
        # ONE packed all-reduce a step (heat_tpu's packed step), and a split
        # DNDarray forward comes back split
        assert got["counts"] == {"packed_all_reduce": C.STEPS}
        assert got["out_split"] == 0
    else:
        # the exact form: the rows' counts, the outputs and labels gathered,
        # one all-reduce a parameter (four)
        assert got["counts"] == {"all_reduce": 5 * C.STEPS, "all_gather": 2 * C.STEPS}


def test_data_parallel_multi_gpu_matches_heat_tpu(references, world):
    got, _ = world["multi"]
    want = reference(_REFS["refs"], "REF", "multi")
    _close(got["losses"], want["losses"])
    for name, w in _flax_to_torch(want["params"]).items():
        _close(got["replicas"][name], w)
    # the fast tier: one packed all-reduce a step; the slow tier: one
    # packed bf16 all-reduce a global sync (every batch at global_skip 1)
    assert got["counts"] == {"ici": {"packed_all_reduce": C.STEPS},
                             "dcn": {"packed_all_reduce": C.STEPS}}


@pytest.mark.parametrize("case", ["daso_sync", "daso_schedule"])
def test_daso_matches_heat_tpu(references, world, case):
    got, _ = world[case]
    want = reference(_REFS["refs"], "REF", case)
    assert (got["slow"], got["fast"]) == (2, 2)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        for key in w:
            _close(g[key], w[key], rtol=1e-6)

    def spread(p):
        return max(float(np.max(v.max(0) - v.min(0))) for v in p.values())

    if case == "daso_sync":
        # the blend (avg + local) / 2 halves the nodes' divergence
        assert spread(got["params"][0]) == pytest.approx(0.25 / 2, rel=0.05)
        assert got["counts"] == {"dcn": {"packed_all_reduce": 1}}
    else:
        # batch 1: nothing due; batch 2: captured, not applied; batch 3: applied
        s = [spread(p) for p in got["params"]]
        assert s[0] == pytest.approx(0.25) and s[1] == pytest.approx(0.25)
        assert s[2] == pytest.approx(0.125, rel=0.05)
        assert got["counts"] == {"dcn": {"packed_all_reduce": 1}}
