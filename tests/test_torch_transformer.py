"""heat_tpu_torch's transformer serving path against heat_tpu's, on the
decode-smoke configuration (vocab 61, d_model 32, 4 heads, 2 layers, d_ff
64; ``scripts/decode_smoke.py``) and identical weights from ``init(2)``.

Held against heat_tpu: the float32 logits forward (``logits_fn``), the
prefill's K/V and logits (``_prompt_kv_logits``, heat_tpu dense and with its
Pallas flash kernel in interpret mode), greedy ``generate`` tokens, and one
bfloat16 forward. Held against the port's own ``generate``: the
continuous-batching ``DecodeEngine``, per request over mixed lengths with an
EOS. Plus the engine's queue bound, close, stats and device-to-host rule,
the MeshGrid rules, and the weight conversion.

Tolerances: float32 logits and K/V within 1e-5 of their largest magnitude
(float32 GEMMs in another order); tokens equal, except that a token may
differ at a near-tie, where the reference's logits for the two tokens lie
within the float32 tolerance; after such a tie the sequences are not
compared further. bfloat16 logits within ``chip_smoke.bf16_logit_tol`` of
heat_tpu's: per logit 6 u sqrt(12 L) sigma + u max|z| for each side (u =
2^-8, L layers, sigma and max|z| of the float32 logits at that position).
"""

import importlib.util
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import pallas_kernels as pk  # noqa: E402
from heat_tpu.nn.transformer import TransformerLM as JaxLM  # noqa: E402
from heat_tpu.nn.transformer import TransformerLMConfig as JaxConfig  # noqa: E402
from heat_tpu.serve.decode import DECODE_STATS_KEYS as JAX_STATS_KEYS  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import communication, kernels as tk  # noqa: E402
from heat_tpu_torch.serve import (DECODE_STATS_KEYS, DecodeConfig, DecodeEngine,  # noqa: E402
                                  ServeClosed, ServeDeadlineExceeded, ServeOverloaded,
                                  serve_transformer)
from heat_tpu_torch.utils.convert import transformer_params_from_numpy  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
AXES = ("dp", "pp", "tp", "sp")
F32_TOL = 1e-5
_MEMO = {}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax(dtype="float32"):
    """heat_tpu's model and parameters on one CPU device, built once."""
    key = ("jax", dtype)
    if key not in _MEMO:
        grid = hj.MeshGrid((1, 1, 1, 1), AXES, devices=jax.devices()[:1])
        model = JaxLM(grid, JaxConfig(**SMOKE, compute_dtype=getattr(jnp, dtype)))
        _MEMO[key] = (model, model.init(2))
    return _MEMO[key]


def _port(dtype=torch.float32):
    key = ("port", dtype)
    if key not in _MEMO:
        grid = ht.MeshGrid((1, 1, 1, 1), AXES, device="cpu")
        model = ht.nn.TransformerLM(grid, ht.nn.TransformerLMConfig(**SMOKE,
                                                                     compute_dtype=dtype))
        _MEMO[key] = (model, model.init(2))
    return _MEMO[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_memo():
    yield
    _MEMO.clear()


def _prompts(n, s0, seed=0):
    return np.random.default_rng(seed).integers(0, SMOKE["vocab"], (n, s0)).astype(np.int32)


def _assert_tokens_match(got, want, logits_of, n_prompt):
    """``got`` equals ``want`` token for token; at the first difference the
    reference logits (``logits_of(sequence)`` -> (S, vocab), teacher-forced
    over ``got``) must hold the two tokens within the float32 tolerance,
    and nothing after it is compared."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    t = int(diff[0])
    assert t >= n_prompt, "the prompt came back changed"
    z = np.asarray(logits_of(got[None, :t]))[0, -1]
    gap = float(z[want[t]] - z[got[t]])
    assert abs(gap) <= 2 * F32_TOL * np.abs(z).max(), (t, gap)


def test_logits_forward_matches_jax():
    jm, jp = _jax()
    tm, tp = _port()
    toks = _prompts(2, 11)
    want = np.asarray(jm.logits_fn()(jp, jnp.asarray(toks)))
    got = tm.logits_fn()(tp, toks)
    assert got.dtype == torch.float32 and got.shape == (2, 11, SMOKE["vocab"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL * np.abs(want).max())
    assert torch.equal(tm(tp, toks), got)  # the nn.Module call is the same forward


@pytest.mark.parametrize("pallas", [False, True])
def test_prefill_matches_jax(pallas):
    jm, jp = _jax()
    tm, tp = _port()
    padded = np.zeros((2, 16), np.int32)
    padded[:, :11] = _prompts(2, 11)
    fn = jax.jit(lambda p, t, n: jm._prompt_kv_logits(p, t, n, wire=(None, None, None)))
    pk.set_pallas(pallas)
    try:
        ks, vs, logits = fn(jp, jnp.asarray(padded), jnp.int32(11))
    finally:
        pk.set_pallas(None)
    tks, tvs, tlogits = tm._prompt_kv_logits(tp, torch.from_numpy(padded).long(), 11)
    for l in range(SMOKE["n_layers"]):
        for got, want in ((tks[l], ks[l]), (tvs[l], vs[l])):
            want = np.asarray(want)
            assert got.shape == want.shape == (2, 16, 4, 8)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=F32_TOL * np.abs(want).max())
    want = np.asarray(logits)
    np.testing.assert_allclose(tlogits.numpy(), want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_generate_matches_jax():
    jm, jp = _jax()
    tm, tp = _port()
    prompts = _prompts(2, 11, seed=1)
    want = np.asarray(jm.generate(jp, prompts, 6))
    got = tm.generate(tp, prompts, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 17)
    fwd = jm.logits_fn()
    for row in range(2):
        _assert_tokens_match(got[row].numpy(), want[row],
                             lambda s: fwd(jp, jnp.asarray(s, jnp.int32)), 11)


def test_bf16_forward_matches_jax_within_bf16_rule():
    cs = _chip_smoke()
    jm, jp = _jax("bfloat16")
    tm, tp = _port(torch.bfloat16)
    tm32, tp32 = _port()
    toks = _prompts(2, 40, seed=2)
    want = np.asarray(jm.logits_fn()(jp, jnp.asarray(toks)))
    got = tm.logits_fn()(tp, toks).numpy()
    ref = tm32.logits_fn()(tp32, toks).numpy()
    sigma = ref.std(-1, keepdims=True)
    mag = np.abs(ref).max(-1, keepdims=True)
    tol = 2 * cs.bf16_logit_tol(sigma, mag, SMOKE["n_layers"])
    assert (np.abs(got - want) <= tol).all(), float((np.abs(got - want) / tol).max())
    # and the bf16 greedy decode runs end to end
    out = tm.generate(tp, toks[:, :9], 4)
    assert out.shape == (2, 13) and np.array_equal(out[:, :9].numpy(), toks[:, :9])


def _requests():
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(7):
        s0 = int(rng.integers(3, 21))
        reqs.append((rng.integers(0, SMOKE["vocab"], s0).astype(np.int32),
                     int(rng.integers(2, 11))))
    return reqs


def test_decode_engine_matches_generate():
    tm, tp = _port()
    reqs = _requests()
    refs = [tm.generate(tp, prompt[None], mn)[0].numpy() for prompt, mn in reqs]
    # EOS: the longest request stops at the first occurrence of its third new token
    ie = int(np.argmax([mn for _, mn in reqs]))
    pe = reqs[ie][0]
    eos = int(refs[ie][pe.size + 2])
    stop = pe.size + int(np.nonzero(refs[ie][pe.size:] == eos)[0][0]) + 1
    refs[ie] = refs[ie][:stop]
    fetched = []
    real_fetch = DecodeEngine._fetch

    def fetch(t):
        fetched.append(tuple(t.shape))
        return real_fetch(t)

    tk.reset_launches()
    eng = serve_transformer(tm, tp, 64, decode=True, slots=3)
    eng._fetch = fetch
    try:
        eng.warmup()
        fetched.clear()
        futs = [eng.submit(p, mn, eos_id=eos if i == ie else None)
                for i, (p, mn) in enumerate(reqs)]
        assert eng.flush(60) and all(f.done() for f in futs)
        outs = [f.result(0) for f in futs]
        stats = eng.stats()
    finally:
        eng.close()
    assert not eng.worker_alive
    for out, ref, (prompt, _) in zip(outs, refs, reqs):
        assert out.dtype == np.int32
        _assert_tokens_match(out, ref, lambda s: tm.logits_fn()(tp, s), prompt.size)
    assert outs[ie][-1] == eos and outs[ie].size == stop
    # the only device-to-host copies: one token per prefill, the slot vector per step
    assert fetched.count(()) == stats["prefills"] == len(reqs)
    assert fetched.count((3,)) == stats["decode_steps"] > 0
    assert len(fetched) == stats["prefills"] + stats["decode_steps"]
    assert stats["tokens_out"] == sum(o.size - p.size for o, (p, _) in zip(outs, reqs))
    assert set(DECODE_STATS_KEYS) <= set(stats) and DECODE_STATS_KEYS == JAX_STATS_KEYS
    assert stats["decode_fallbacks"] == 0 and stats["ttft_ms"]["n"] == len(reqs)
    assert tk.launches == {name: 0 for name in tk.launches}  # CPU: plain versions only


def test_decode_engine_queue_bound_close_and_refusals():
    tm, tp = _port()
    eng = DecodeEngine(tm, tp, DecodeConfig(slots=2, max_seq_len=32, queue_limit=2))
    prompt = np.arange(5, dtype=np.int32)
    eng.pause()
    late = eng.submit(prompt, 3, deadline_ms=1)
    time.sleep(0.01)
    eng.resume()
    with pytest.raises(ServeDeadlineExceeded):
        late.result(10)
    eng.pause()
    held = [eng.submit(prompt, 3), eng.submit(prompt, 3)]
    with pytest.raises(ServeOverloaded):
        eng.submit(prompt, 3)
    assert not eng.flush(0.05)  # the paused worker answers nothing
    with pytest.raises(ValueError, match="cache rows"):
        eng.submit(prompt, 40)
    with pytest.raises(ValueError, match="register_tenant"):
        eng.submit(prompt, 3, tenant="a")  # tenants need registering first
    eng.close(drain=False)
    for f in held:
        with pytest.raises(ServeClosed):
            f.result(10)
    with pytest.raises(ServeClosed):
        eng.submit(prompt, 3)
    assert not eng.worker_alive
    with serve_transformer(tm, tp, 32) as ex:  # the batching forward executor
        assert ex.predict(np.zeros((1, 32), np.int32), timeout=60).shape == (1, 32, 61)
    with serve_transformer(tm, tp, 32, decode=True, slots=2) as eng2:
        out = eng2.generate(prompt, 4, timeout=60)
    assert np.array_equal(out, tm.generate(tp, prompt[None], 4)[0].numpy())


def test_decode_engine_backstop_fails_inflight_and_recovers():
    tm, tp = _port()
    eng = DecodeEngine(tm, tp, DecodeConfig(slots=2, max_seq_len=32))
    real = eng._dispatch_step
    boom = threading.Event()

    def failing(live, record=True):
        if not boom.is_set():
            boom.set()
            raise RuntimeError("step failed")
        return real(live, record)

    eng._dispatch_step = failing
    try:
        with pytest.raises(RuntimeError, match="step failed"):
            eng.submit(np.arange(6, dtype=np.int32), 5).result(60)
        out = eng.submit(np.arange(6, dtype=np.int32), 5).result(60)
    finally:
        eng.close()
    assert np.array_equal(out, tm.generate(tp, np.arange(6)[None], 5)[0].numpy())


def test_meshgrid_rules(monkeypatch):
    grid = ht.MeshGrid((1, 1, 1, 1), AXES, device="cpu")
    assert grid.sizes == dict.fromkeys(AXES, 1) and grid.torch_device.type == "cpu"
    assert grid.axis("sp").size == 1 and grid.axis("tp").rank == 0
    with pytest.raises(ValueError, match="needs 2 processes"):
        ht.MeshGrid((2, 1, 1, 1), AXES, device="cpu")
    with pytest.raises(ValueError, match="length"):
        ht.MeshGrid((1, 1), AXES, device="cpu")
    with pytest.raises(ValueError, match="grid axes"):
        ht.nn.TransformerLM(ht.MeshGrid((1,), ("dp",), device="cpu"),
                            ht.nn.TransformerLMConfig(**SMOKE))

    class Two(communication.TorchCommunication):
        size = 2

    monkeypatch.setattr(communication, "get_comm", lambda: Two())
    # an axis as large as the world runs on the world group: no subgroup
    two = ht.MeshGrid((2, 1, 1, 1), AXES, device="cpu")
    assert two.axis("dp").size == 2 and two.axis("sp").size == 1
    assert two.coords == (0, 0, 0, 0) and two.groups_created == 0


def test_transformer_params_from_numpy_round_trip():
    jm, jp = _jax()
    tm, tp = _port()
    tree = jax.tree.map(np.asarray, jp)
    got = transformer_params_from_numpy(tree, tm.cfg, device="cpu")
    for name in ("embed", "final_ln", "unembed"):
        assert torch.equal(got[name], tp[name])
        np.testing.assert_array_equal(got[name].numpy(), tree[name])
    for l in range(SMOKE["n_layers"]):
        for name, t in got["layers"][l].items():
            assert torch.equal(t, tp["layers"][l][name])
            np.testing.assert_array_equal(t.numpy(), tree["stages"][name][0, l])
    # a pp = 2 tree (one layer per stage) runs its layers in stage order
    split = dict(tree, stages={k: v.reshape((2, 1) + v.shape[2:])
                               for k, v in tree["stages"].items()})
    got2 = transformer_params_from_numpy(split, tm.cfg, device="cpu")
    assert torch.equal(got2["layers"][1]["wqkv"], tp["layers"][1]["wqkv"])
    bf = transformer_params_from_numpy(tree, _port(torch.bfloat16)[0].cfg, device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    bad = dict(tree, embed=tree["embed"][:, :5])
    with pytest.raises(ValueError, match="embed"):
        transformer_params_from_numpy(bad, tm.cfg, device="cpu")


def test_sampling_at_temperature_is_seeded():
    # temperature > 0 draws heat_tpu's Threefry noise: the same seed gives the
    # same tokens (tests/test_torch_serve.py holds them against heat_tpu's)
    tm, tp = _port()
    prompts = _prompts(2, 7, seed=4)
    a = tm.generate(tp, prompts, 5, temperature=1.0, seed=3)
    assert torch.equal(a, tm.generate(tp, prompts, 5, temperature=1.0, seed=3))
    assert a.shape == (2, 12) and int(a.min()) >= 0 and int(a.max()) < SMOKE["vocab"]
    outs = []
    for _ in range(2):
        with DecodeEngine(tm, tp, DecodeConfig(slots=2, max_seq_len=32, temperature=1.0,
                                               seed=3)) as eng:
            outs.append(eng.generate(prompts[0], 5, timeout=60))
    assert np.array_equal(outs[0], outs[1]) and outs[0].size == 12
