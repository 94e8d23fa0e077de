"""heat_tpu_torch's serving front end against heat_tpu's, at world size 1
(heat_tpu on one CPU device) unless a collective is involved.

Held against heat_tpu, on the same inputs:

* fault plans: every rule of the grammar gives the same ``spec()``, the same
  fire pattern over 200 hits (``prob`` seeded) and the same ``stats()``;
* bucket ladders and ``bucket_nbytes`` over rows 1-4096 (both policies), the
  program cache's counters, and the ``AdmissionController`` driven by one
  fake clock through one event script: each decision's class and every
  ``tenant_stats()`` exact;
* the ``ServingExecutor``: a paused wave forms the same batches, buckets,
  ``ServeMetrics`` counters and program-cache counts (4 compiles after
  ``warmup(rows=range(1, 9))``, 0 after), with tenants too; deadlines,
  shedding, ``close(drain=False)`` and an armed ``serve.worker.batch`` fault
  end alike;
* the adapters: ``serve_transformer(decode=False)`` logits on a float32
  model (2 layers, d_model 64, 4 heads, vocab 97, seq 16) within
  ``F32_TOL x max|logits|``, and ``serve_estimator`` labels of KMeans,
  KMedians and KNN bitwise; at world size 2 (gloo) the replication
  all-gathers are counted;
* ``classify_outcome`` of every serve error, and the report keys of
  ``run_open_loop`` (0.5 s, every request answered) and
  ``estimate_capacity``;
* sampling at ``temperature = 0.8``: the Threefry words and uniforms of a
  draw bitwise, and the tokens of ``generate`` and of a ``DecodeEngine``
  fed one wave, where only a near-tie of ``logits / T + gumbel`` (within 4
  float32 ulp) may differ; the ties are counted;
* the decode engine's tenancy (priorities, counters) and its degraded
  per-slot step under an injected step fault (``decode_fallbacks == 1``,
  the greedy tokens of a fault-free run);
* ``ht.runtime_stats()``'s key set.
"""

import contextlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import heat_tpu as hj  # noqa: E402
import heat_tpu.serve as js  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402
from heat_tpu.nn.transformer import TransformerLM as JaxLM  # noqa: E402
from heat_tpu.nn.transformer import TransformerLMConfig as JaxConfig  # noqa: E402
from heat_tpu.utils import faults as jfaults  # noqa: E402
from heat_tpu.utils.program_cache import ProgramCache as JaxCache  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
import heat_tpu_torch.serve as ts  # noqa: E402
from heat_tpu_torch.core import random as trandom  # noqa: E402
from heat_tpu_torch.utils import faults as tfaults  # noqa: E402
from heat_tpu_torch.utils.program_cache import ProgramCache as PortCache  # noqa: E402

from torch_world import finish_world, start_world, stop_world  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
AXES = ("dp", "pp", "tp", "sp")
MODEL = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128)
SEQ = 16
F32_TOL = 1e-5
TIE_ULP = 4
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


def _c1():
    if "c1" not in _MEMO:
        _MEMO["c1"] = TPUCommunication(jax.devices()[:1])
    return _MEMO["c1"]


def _models():
    """heat_tpu's and the port's float32 model from the same ``init(0)``."""
    if "models" not in _MEMO:
        jgrid = hj.MeshGrid((1, 1, 1, 1), AXES, devices=jax.devices()[:1])
        jm = JaxLM(jgrid, JaxConfig(**MODEL))
        tgrid = ht.MeshGrid((1, 1, 1, 1), AXES, device="cpu")
        tm = ht.nn.TransformerLM(tgrid, ht.nn.TransformerLMConfig(**MODEL))
        _MEMO["models"] = (jm, jm.init(0), tm, tm.init(0))
    return _MEMO["models"]


# --------------------------------------------------------------------------- #
# faults                                                                      #
# --------------------------------------------------------------------------- #
SPECS = ["serve.batch.dispatch=once", "serve.worker.batch=nth:3",
         "checkpoint.leaf.write=every:7", "serve.decode.step=prob:0.3@11",
         "serve.bucket.policy=1;checkpoint.manifest.read=every:50",
         " program_cache.compile = prob:0.05@2 ; ", "reshard.dispatch=prob:1.0"]


def _fire_pattern(faults, spec):
    sites = list(faults.FaultPlan.from_spec(spec).rules)
    before = faults.stats()
    fired = []
    with faults.inject(spec):
        plan = faults.FaultPlan.from_spec(spec).spec()
        for hit in range(200):
            for site in sites:
                try:
                    faults.check(site)
                except (faults.FaultInjected, OSError) as exc:
                    fired.append((hit, site, type(exc).__name__))
        during = faults.stats()
    after = faults.stats()
    delta = {"arms": during["arms"] - before["arms"],
             "total_fires": during["total_fires"] - before["total_fires"],
             "fires": {s: during["fires"].get(s, 0) - before["fires"].get(s, 0) for s in sites}}
    return plan, fired, delta, during["armed"], during["plan"], after["armed"], during["sites"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plans_fire_as_heat_tpu(spec):
    assert _fire_pattern(tfaults, spec) == _fire_pattern(jfaults, spec)


@pytest.fixture(scope="module", autouse=True)
def env_arming():
    """A process importing the port's faults with heat_tpu's variable set,
    then again with the port's; started with the module."""
    code = ("import importlib, json, os; import heat_tpu_torch.utils.faults as f; "
            "out = [f.stats()['armed']]; "
            "os.environ['HEAT_TPU_TORCH_FAULTS'] = 'serve.batch.dispatch=every:2'; "
            "importlib.reload(f); s = f.stats(); "
            "print(json.dumps(out + [s['armed'], s['plan']]))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                                 "HEAT_TPU_FAULTS": "serve.batch.dispatch=every:2"})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# --------------------------------------------------------------------------- #
# bucketing, program cache, admission                                         #
# --------------------------------------------------------------------------- #
POLICIES = [("Pow2Buckets", {}), ("Pow2Buckets", {"min_rows": 4}),
            ("Pow2Buckets", {"min_rows": 3, "multiple_of": 3}),
            ("Pow2Buckets", {"multiple_of": 6, "max_rows": 1000}),
            ("FixedBuckets", {"sizes": (1, 3, 8, 100, 4096)})]


@pytest.mark.parametrize("policy", POLICIES, ids=[f"{p}{sorted(k.items())}" for p, k in POLICIES])
def test_bucket_ladders_match_heat_tpu(policy):
    name, kw = policy
    jp, tp = getattr(js.bucketing, name)(**kw), getattr(ts.bucketing, name)(**kw)

    def run(p):
        out = []
        for rows in range(1, 4097):
            try:
                out.append(p(rows))
            except ValueError as exc:
                out.append(str(exc))
        return out, p.ladder(4096), p.ladder(37), repr(p)

    assert run(tp) == run(jp)
    for feat, dt in (((3,), np.float32), ((), np.int32), ((16, 4), np.float64), ((0,), np.int8)):
        for b in (1, 8, 4096):
            assert ts.bucketing.bucket_nbytes(b, feat, dt) == js.bucketing.bucket_nbytes(b, feat, dt)
    assert ts.bucketing.next_pow2(1000) == js.bucketing.next_pow2(1000) == 1024


def test_program_cache_counts_as_heat_tpu(monkeypatch):
    def drive(cache):
        for key in (1, 2, 1, 3, 4, 2, 5, 5, 1):
            cache.get_custom(key, lambda k=key: (lambda: k))
        return cache.stats(), len(cache)

    assert drive(PortCache("p", max_entries=3)) == drive(JaxCache("p", max_entries=3))
    assert PortCache.STATS_KEYS == JaxCache.STATS_KEYS
    # the serving form: one program per (fn, shape, dtype, token)
    jc, tc = JaxCache("s"), PortCache("s")
    jf, tf = (lambda x: x + 1), (lambda x: x + 1)
    for shape, tok in (((2, 3), ()), ((2, 3), ()), ((4, 3), ()), ((2, 3), "other")):
        jc.get(jf, shape, np.float32, tok)
        prog = tc.get(tf, shape, np.float32, tok)
    assert tc.stats() == jc.stats()
    assert torch.equal(prog(np.ones((2, 3), np.float32)), torch.full((2, 3), 2.0))
    # with no ``device`` the payload lands on the port's default device
    # (the card unless ``use_device("cpu")``), never the CPU by fiat
    from heat_tpu_torch.core import devices

    class _Meta:
        torch_device = torch.device("meta")

    monkeypatch.setattr(devices, "get_device", lambda: _Meta())
    assert PortCache("d").get(tf, (2, 3), np.float32)(np.ones((2, 3), np.float32)).is_meta
    tc.reset()
    assert tc.stats() == dict.fromkeys(PortCache.STATS_KEYS, 0)


def _admission_script(adm_mod, faults):
    t = [100.0]
    ctl = adm_mod.AdmissionController(clock=lambda: t[0])
    ctl.register("hi", priority=2, slo_ms=50.0, max_queue=3, rate_limit=2.0)
    ctl.register("lo", rate_limit=1.0, burst=1.0, breaker_failures=2, breaker_cooldown_s=0.5,
                 half_open_max=1)
    out = []

    def attempt(name, consume=True):
        try:
            ctl.check_tenant(name, consume_token=consume)
            out.append("admit")
        except Exception as exc:  # noqa: BLE001 — the decision's class is the record
            out.append(type(exc).__name__)

    def snap():
        out.append(ctl.tenant_stats())

    attempt("hi"), attempt("hi"), attempt("hi")  # a burst of 2, then rate limited
    t[0] += 0.5
    attempt("hi")  # one token refilled
    ctl.refund_token("hi")
    attempt("hi")
    attempt("lo"), attempt("lo")
    snap()
    ctl.on_batch_outcome({"lo"}, ok=False)
    out.append(ctl.breaker_state("lo"))
    ctl.on_batch_outcome({"lo", "hi"}, ok=False)  # lo trips at 2, hi's streak is 1
    out.append(ctl.breaker_state("lo"))
    t[0] += 0.1
    attempt("lo", False)  # open: fast fail
    t[0] += 1.0
    attempt("lo", False)  # cool-down over: the half-open probe
    attempt("lo", False)  # probe budget spent
    ctl.on_batch_outcome({"lo"}, ok=False)  # the probe failed: open again
    out.append(ctl.breaker_state("lo"))
    t[0] += 0.6
    attempt("lo", False)
    t[0] += 0.6
    attempt("lo", False)  # the budget refills after another cool-down
    ctl.on_batch_outcome({"lo", "hi"}, ok=True)
    out.append(ctl.breaker_state("lo"))
    snap()
    group = ((3,), "<f4")
    out.append(ctl.estimate_service_s(group))
    for dt in (0.01, 0.03, 0.02):
        ctl.observe_service(group, 8, dt)
    est = ctl.estimate_service_s(group)
    out.append(est)
    out.append(t[0] + est > t[0] + 0.03)  # the executor's early-shed test
    ctl.count("hi", "early_shed")
    ctl.count(None, "shed")
    out.append(ctl.resolve(None))
    try:
        ctl.resolve("nobody")
    except ValueError as exc:
        out.append(str(exc))
    for bad in ({"rate_limit": 0.0}, {"max_queue": 0}):
        try:
            ctl.register("bad", **bad)
        except ValueError as exc:
            out.append(str(exc))
    ctl.on_batch_outcome({"lo"}, ok=False)
    ctl.on_batch_outcome({"lo"}, ok=False)
    with faults.inject("serve.breaker.probe=once"):
        attempt("lo", False)  # the consult fails: admitted (fail open)
        attempt("lo", False)
    ctl.register("hi", priority=5, rate_limit=1.0)  # re-register: counters survive
    attempt("hi"), attempt("hi")
    out.append((ctl.priority("hi"), ctl.slo_ms("hi"), sorted(ctl.tenants)))
    snap()
    return out


def test_admission_controller_matches_heat_tpu():
    assert _admission_script(ts.admission, tfaults) == _admission_script(js.admission, jfaults)
    assert ts.admission.TENANT_COUNTERS == js.admission.TENANT_COUNTERS
    assert ts.admission.__all__ == js.admission.__all__


# --------------------------------------------------------------------------- #
# the executor                                                                #
# --------------------------------------------------------------------------- #
WAVE = [1, 2, 1, 3, 2, 2, 1, 1, 3]


def _wave(pkg, fn, tenants=False):
    """A paused wave through ``pkg``'s executor: its answers, metrics and
    program-cache counts."""
    rng = np.random.default_rng(5)
    ex = pkg.ServingExecutor(fn, pkg.ServeConfig(max_batch=4, queue_limit=32), name="wave",
                             metrics=pkg.ServeMetrics(name="wave"))
    try:
        warm = ex.warmup(feat_shape=(3,), rows=range(1, 9))
        names = [None] * len(WAVE)
        if tenants:
            ex.register_tenant("hi", priority=1, max_queue=3)
            ex.register_tenant("lo")
            names = ["lo", "lo", "hi", "hi", "lo", "hi", "hi", "lo", "lo"]
        ex.pause()
        futs, shed = [], []
        xs = [rng.standard_normal((r, 3)).astype(np.float32) for r in WAVE]
        for x, name in zip(xs, names):
            try:
                futs.append((x, ex.submit(x, tenant=name)))
            except Exception as exc:  # noqa: BLE001
                shed.append(type(exc).__name__)
        ex.resume()
        outs = [(x, f.result(30)) for x, f in futs]
        assert ex.flush(30)
        stats = ex.stats()
        occ = list(ex.metrics._occupancy)
    finally:
        ex.close()
    for k in ("latency_ms",):
        stats.pop(k)
    return warm, stats, occ, shed, [np.asarray(o) for _, o in outs], [x for x, _ in outs]


@pytest.mark.parametrize("tenants", [False, True])
def test_executor_wave_matches_heat_tpu(tenants):
    jw, js_, jocc, jshed, jouts, _ = _wave(js, lambda x: x * 2.0 + 1.0, tenants)
    tw, ts_, tocc, tshed, touts, xs = _wave(ts, lambda x: x * 2.0 + 1.0, tenants)
    assert tw == jw and tw["compiles"] == 4 and tw["misses"] == 4
    assert ts_ == js_ and ts_["program_cache"]["compiles"] == 4  # 0 after warmup
    assert tocc == jocc and tshed == jshed
    for got, want, x in zip(touts, jouts, xs):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(got, x * 2 + 1)


def _lifecycle(pkg, faults, fn):
    out = []
    ex = pkg.ServingExecutor(fn, pkg.ServeConfig(max_batch=4, queue_limit=2),
                             metrics=pkg.ServeMetrics(name="life"))
    x = np.ones((1, 3), np.float32)
    ex.pause()
    late = ex.submit(x, deadline_ms=0)  # expired when the worker reaches it
    keep = ex.submit(x)
    try:
        ex.submit(x)
    except pkg.ServeOverloaded as exc:
        out.append(type(exc).__name__)
    ex.resume()
    for f in (late, keep):
        try:
            out.append(np.asarray(f.result(30)).tolist())
        except pkg.ServeError as exc:
            out.append(type(exc).__name__)
    with faults.inject("serve.worker.batch=once"):
        try:
            ex.predict(x, timeout=30)
        except faults.FaultInjected as exc:
            out.append(type(exc).__name__)
        out.append(np.asarray(ex.predict(x, timeout=30)).tolist())
    out.append(ex.worker_alive)
    ex.pause()
    held = [ex.submit(x), ex.submit(x)]
    ex.close(drain=False)
    for f in held:
        try:
            f.result(30)
        except pkg.ServeClosed as exc:
            out.append(type(exc).__name__)
    try:
        ex.submit(x)
    except pkg.ServeClosed as exc:
        out.append(type(exc).__name__)
    st = ex.stats()
    out.append({k: st[k] for k in pkg.ServeMetrics.COUNTERS})
    out.append(ex.worker_alive)
    return out


def test_executor_lifecycle_matches_heat_tpu():
    got = _lifecycle(ts, tfaults, lambda x: x + 1.0)
    assert got == _lifecycle(js, jfaults, lambda x: x + 1.0)
    assert got[:3] == ["ServeOverloaded", "ServeDeadlineExceeded", [[2.0, 2.0, 2.0]]]
    assert got[-1] is False


RECOVERY_COUNTERS = ("serve.batch_retries", "serve.bucket_splits", "serve.admission_fallbacks",
                     "serve.worker_backstops", "serve.admit")
# case -> (ServeConfig knobs, the paused wave's rows, its fault plan)
RECOVERY = {
    # the degraded one-request-a-program path
    "single": (dict(batching=False, max_batch=4), WAVE, None),
    # the coalesced bucket 8 is over the cap: one request at a time, and the
    # 5-row request runs at its exact shape rounded up to min_rows (6)
    "cap": (dict(max_batch=8, min_rows=2, max_bucket_bytes=24), [1, 1, 1, 5], None),
    # a bounded ladder rejects the coalesced 14 rows: re-split into two
    # 4-row batches, and the 6-row request alone fails its own future
    "fixed": (dict(max_batch=8, bucket_rows=("FixedBuckets", [4])), [2, 2, 2, 2, 6], None),
    # one transient dispatch failure: one bounded retry, every answer served
    "retry": (dict(max_batch=4), [1, 2, 1], "serve.batch.dispatch=once"),
    # a persistent one: the retry fails too, the batch's futures fail typed
    "persist": (dict(max_batch=2), [1, 1], "serve.batch.dispatch=every:1"),
    # the tenant admission machinery fails: that request is admitted by the
    # bounded FIFO, the next by the controller
    "admission": (dict(max_batch=4), [1, 2, 1], "serve.admission.decide=once"),
}


def _recovery(pkg, faults, pm, case):
    """A paused wave through ``pkg``'s executor under one recovery case:
    each answer (or its error's class), the metrics snapshot, the batches'
    occupancy, the program cache, the tenants and the recovery counters."""
    knobs, rows, plan = RECOVERY[case]
    knobs = dict(knobs)
    if "bucket_rows" in knobs:
        cls, sizes = knobs["bucket_rows"]
        knobs["bucket_rows"] = getattr(pkg.bucketing, cls)(sizes)
    ex = pkg.ServingExecutor(lambda x: x * 2.0 + 1.0, pkg.ServeConfig(**knobs), name=case,
                             metrics=pkg.ServeMetrics(name=case))
    tenant = None
    if case == "admission":
        ex.register_tenant("a")
        tenant = "a"
    before = pm.counters()
    xs = [np.arange(r * 3, dtype=np.float32).reshape(r, 3) + i for i, r in enumerate(rows)]
    out = []
    with (faults.inject(plan) if plan else contextlib.nullcontext()):
        ex.pause()
        futs = [ex.submit(x, tenant=tenant) for x in xs]
        ex.resume()
        for f in futs:
            try:
                out.append(np.asarray(f.result(30)))
            except Exception as exc:  # noqa: BLE001 — the outcome's class is the record
                out.append(type(exc).__name__)
    # the same executor serves on once the plan is disarmed
    out.append(np.asarray(ex.predict(xs[0], timeout=30, tenant=tenant)))
    assert ex.flush(30)
    stats = ex.stats()
    stats.pop("latency_ms")
    occ = list(ex.metrics._occupancy)
    alive = ex.worker_alive
    ex.close()
    after = pm.counters()
    delta = {k: int(after.get(k, 0)) - int(before.get(k, 0)) for k in RECOVERY_COUNTERS}
    return out, stats, occ, delta, alive, xs


@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_executor_recovery_matches_heat_tpu(case):
    from heat_tpu.utils import metrics as jpm

    from heat_tpu_torch.utils import metrics as tpm

    jout, jstats, jocc, jdelta, jalive, _ = _recovery(js, jfaults, jpm, case)
    tout, tstats, tocc, tdelta, talive, xs = _recovery(ts, tfaults, tpm, case)
    assert tstats == jstats and tocc == jocc and tdelta == jdelta
    assert talive and jalive
    for got, want in zip(tout, jout):
        if isinstance(want, str):
            assert got == want
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, x in zip(tout, xs + xs[:1]):
        if not isinstance(got, str):
            np.testing.assert_array_equal(got, x * 2 + 1)
    # what each case is there to show, as heat_tpu's own tests pin it
    expect = {"single": dict(batches=len(WAVE) + 1), "cap": dict(fallback_single=1),
              "fixed": dict(batches=3, errors=1), "retry": dict(errors=0),
              "persist": dict(errors=1)}.get(case, {})
    assert {k: tstats[k] for k in expect} == expect
    counts = {"fixed": {"serve.bucket_splits": 1}, "retry": {"serve.batch_retries": 1},
              "persist": {"serve.batch_retries": 1},
              "admission": {"serve.admission_fallbacks": 1}}.get(case, {})
    assert {k: tdelta[k] for k in counts} == counts
    if case == "cap":
        assert tstats["padded_rows"] == 1 + 1 + 1 + 1 + 1  # 1-row requests at 2, 5 at 6
    if case == "fixed":
        assert tout[-2] == "ValueError"


# --------------------------------------------------------------------------- #
# the adapters                                                                #
# --------------------------------------------------------------------------- #
def test_serve_transformer_logits_match_heat_tpu():
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, MODEL["vocab"], (r, SEQ)).astype(np.int32) for r in (1, 3, 2)]
    outs = {}
    for name, pkg, m, p in (("jax", js, jm, jp), ("port", ts, tm, tp)):
        ex = pkg.serve_transformer(m, p, SEQ, metrics=pkg.ServeMetrics(name="lm"))
        try:
            warm = ex.warmup(feat_shape=(SEQ,), dtype=np.int32, rows=range(1, 9))
            ex.pause()
            futs = [ex.submit(r) for r in reqs]
            ex.resume()
            outs[name] = ([f.result(60) for f in futs], warm, ex.stats()["program_cache"],
                          ex.stats()["batches"])
        finally:
            ex.close()
    want, got = outs["jax"], outs["port"]
    assert got[1:] == want[1:] and got[2]["compiles"] == 4
    for g, w in zip(got[0], want[0]):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL * np.abs(w).max())
    with pytest.raises(ValueError, match="DecodeConfig"):
        ts.serve_transformer(tm, tp, SEQ, config=ts.ServeConfig(), decode=True)


def _estimators(lib, x, y, centers, comm=None):
    """KMeans and KMedians of ``lib`` holding ``centers``, and KNN fitted on
    ``(x, y)``."""
    kw = {} if comm is None else {"comm": comm}
    out = {}
    for name in ("KMeans", "KMedians"):
        est = getattr(lib.cluster, name)(n_clusters=3)
        est._cluster_centers = lib.array(centers, **kw)
        out[name] = est
    out["KNN"] = lib.classification.KNeighborsClassifier(5).fit(lib.array(x, split=0, **kw),
                                                                lib.array(y, split=0, **kw))
    return out


def _estimator_data():
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((3, 6)) * 4
    y = rng.integers(0, 3, 120)
    x = (centers[y] + rng.standard_normal((120, 6))).astype(np.float32)
    q = (centers[rng.integers(0, 3, 29)] + 1.5 * rng.standard_normal((29, 6))).astype(np.float32)
    return x, y.astype(np.int64), q, centers.astype(np.float32)


def test_serve_estimator_labels_match_heat_tpu(world2):
    x, y, q, centers = _estimator_data()
    jest, test = _estimators(hj, x, y, centers, _c1()), _estimators(ht, x, y, centers)
    for name in ("KMeans", "KMedians", "KNN"):
        labels = {}
        for key, pkg, est, kw in (("jax", js, jest[name], {"comm": _c1()}),
                                  ("port", ts, test[name], {})):
            with pkg.serve_estimator(est, metrics=pkg.ServeMetrics(name="est"), **kw) as ex:
                ex.pause()
                futs = [ex.submit(q[a:b]) for a, b in ((0, 1), (1, 9), (9, 29))]
                ex.resume()
                labels[key] = [f.result(60) for f in futs]
        for g, w in zip(labels["port"], labels["jax"]):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        # the world-2 ranks answer their own requests as world 1 does
        got2, stats2 = world2[name]
        want2 = _serve_labels(ht, {"x": x, "y": y, "q": q,
                                   "centers": {"KMeans": centers, "KMedians": centers}}, name)
        assert np.array_equal(got2, want2), name
        assert stats2 == ({"all_gather": 2} if name == "KNN" else {}), (name, stats2)
    with pytest.raises(TypeError, match="no serving adapter"):
        ts.estimator_predict_fn(ht.naive_bayes.GaussianNB())
    with pytest.raises(ValueError, match="not fitted"):
        ts.estimator_predict_fn(ht.cluster.KMeans(n_clusters=2))


def _serve_labels(lib, spec, name):
    x, y, q = spec["x"], spec["y"], spec["q"]
    if name == "KNN":
        est = lib.classification.KNeighborsClassifier(5).fit(lib.array(x, split=0),
                                                             lib.array(y, split=0))
    else:
        est = getattr(lib.cluster, name)(n_clusters=3)
        est._cluster_centers = lib.array(spec["centers"][name])
    ex = lib.serve.serve_estimator(est)
    try:
        ex.pause()
        futs = [ex.submit(q[a:b]) for a, b in ((0, 1), (1, 9), (9, 29))]
        ex.resume()
        return np.concatenate([f.result(60) for f in futs])
    finally:
        ex.close()


def _build_env(lib, spec):
    import numpy as np

    return {"lib": lib, "spec": spec, "np": np, "serve_labels": _serve_labels}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The world-2 ranks, started with the module so they run beside its
    tests; their cluster estimators hold the data's own centers."""
    x, y, q, centers = _estimator_data()
    spec = {"x": x, "y": y, "q": q, "centers": {"KMeans": centers, "KMedians": centers},
            "cases": {n: f"serve_labels(lib, spec, {n!r})" for n in ("KMeans", "KMedians", "KNN")}}
    handle = start_world(tmp_path_factory.mktemp("serve_world2"), spec, 2,
                         (_serve_labels, _build_env))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


# --------------------------------------------------------------------------- #
# load generation                                                             #
# --------------------------------------------------------------------------- #
def test_loadgen_reports_as_heat_tpu():
    errs = [None, RuntimeError("x"), ValueError("y")] + [
        getattr(ts.errors, n)("z") for n in ts.errors.__all__]
    jerrs = [None, RuntimeError("x"), ValueError("y")] + [
        getattr(js.errors, n)("z") for n in js.errors.__all__]
    assert ts.errors.__all__ == js.errors.__all__
    assert [ts.loadgen.classify_outcome(e) for e in errs] == \
        [js.loadgen.classify_outcome(e) for e in jerrs]
    assert ts.loadgen.OUTCOMES == js.loadgen.OUTCOMES
    reports = {}
    for key, pkg in (("jax", js), ("port", ts)):
        with pkg.ServingExecutor(lambda x: x * 3.0, pkg.ServeConfig(max_batch=8),
                                 metrics=pkg.ServeMetrics(name="load")) as ex:
            ex.warmup(feat_shape=(4,), rows=range(1, 25))
            ex.register_tenant("a", priority=1)
            cap = pkg.estimate_capacity(ex, (4,), n=16)
            rep = pkg.run_open_loop(ex, [pkg.TenantLoad("a", 200.0),
                                         pkg.TenantLoad(None, 100.0, label="b")], 0.5, (4,))
        assert cap > 0
        reports[key] = rep

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    got, want = reports["port"], reports["jax"]
    assert keys(got) == keys(want)
    tot = got["totals"]
    assert tot["answered"] == tot["offered"] == tot["outcomes"]["ok"] > 0
    assert tot["untyped"] == 0 and tot["shed"] == 0


# --------------------------------------------------------------------------- #
# sampling: heat_tpu's Threefry draws                                         #
# --------------------------------------------------------------------------- #
def test_sampling_words_and_uniforms_are_heat_tpu_bits():
    V = 1000
    for seed, data in ((0, 0), (5, 3), (2**40 + 7, 99)):
        jkey = jax.random.fold_in(jax.random.key(seed), data)
        key = trandom._fold_in(trandom._base_key(seed), data)
        assert tuple(np.asarray(jax.random.key_data(jkey)).view(np.uint32)) == key
        words = trandom._words(key, torch.arange(V, dtype=torch.int64), False)
        want = np.asarray(jax.random.bits(jkey, (V,), jnp.uint32))
        assert np.array_equal(words.numpy().view(np.uint32), want)
        tiny = np.finfo(np.float32).tiny
        u = np.asarray(jax.random.uniform(jkey, (V,), jnp.float32, minval=tiny, maxval=1.0))
        assert np.array_equal(trandom._uniform_tiny(words).numpy(), u)
        # the keyed form (one key a row) gives the same words
        kt = torch.tensor([[trandom._signed32(a) for a in key]] * 2, dtype=torch.int32)
        x0, x1 = trandom._threefry_keyed(kt, torch.arange(V, dtype=torch.int32))
        assert np.array_equal((x0 ^ x1)[1].numpy().view(np.uint32), want)
        j0, j1 = jax.random.split(jkey)
        k0, k1 = trandom._split(key)
        assert tuple(np.asarray(jax.random.key_data(j1)).view(np.uint32)) == k1
        assert tuple(np.asarray(jax.random.key_data(jax.random.split(jkey, 5)[3]))
                     .view(np.uint32)) == trandom._threefry_host(key, 0, 3)


def _scores(logits, temperature, words):
    z = torch.as_tensor(np.asarray(logits), dtype=torch.float32)
    return (z / torch.tensor(temperature, dtype=torch.float32)
            - torch.log(-torch.log(trandom._uniform_tiny(words)))).numpy()


def _near_tie(s, a, b):
    """``s[a]`` and ``s[b]`` within TIE_ULP float32 ulp of the larger."""
    gap = abs(float(s[a]) - float(s[b]))
    return gap <= TIE_ULP * float(np.spacing(np.float32(max(abs(s[a]), abs(s[b])))))


def _compare_tokens(got, want, n_prompt, scores_at):
    """Tokens equal but at a near-tie of the scores (``scores_at(t, seq)``:
    the port's scores for position t given the port's prefix); nothing
    after the first tie is compared. Returns the ties."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if diff.size == 0:
        return 0
    t = int(diff[0])
    assert t >= n_prompt
    s = scores_at(t, np.asarray(got))
    assert _near_tie(s, int(got[t]), int(want[t])), (t, got[t], want[t])
    return 1


def test_generate_samples_heat_tpu_tokens():
    jm, jp, tm, tp = _models()
    T, seed, B, S0, N = 0.8, 7, 3, 6, 7
    prompts = np.random.default_rng(4).integers(0, MODEL["vocab"], (B, S0)).astype(np.int32)
    want = np.asarray(jm.generate(jp, prompts, N, temperature=T, seed=seed))
    got = tm.generate(tp, prompts, N, temperature=T, seed=seed).numpy()
    assert got.shape == want.shape == (B, S0 + N)
    key0, key = trandom._split(trandom._fold_in(trandom._base_key(seed), 0))
    V = MODEL["vocab"]
    fwd = tm.logits_fn()

    def scores_at(row):
        def fn(t, seq):
            z = fwd(tp, seq[None, :t])[0, -1]
            i = t - S0
            if i == 0:
                words = trandom._words(key0, torch.arange(row * V, (row + 1) * V), False)
            else:
                k = trandom._threefry_host(key, 0, i)
                words = trandom._words(k, torch.arange(row * V, (row + 1) * V), False)
            return _scores(z, T, words)
        return fn

    ties = sum(_compare_tokens(got[r], want[r], S0, scores_at(r)) for r in range(B))
    assert ties <= 1, ties
    # greedy stays argmax, and another seed draws other tokens
    assert not np.array_equal(got, tm.generate(tp, prompts, N, temperature=T, seed=8).numpy())


def _engine_wave(pkg, m, p, prompts, n_new, **cfg):
    eng = pkg.serve_transformer(m, p, 32, decode=True, slots=4, **cfg)
    try:
        eng.warmup()
        eng.pause()
        futs = [eng.submit(pr, n_new) for pr in prompts]
        eng.resume()
        return [f.result(120) for f in futs], eng.stats()
    finally:
        eng.close()


def test_decode_engine_samples_heat_tpu_tokens():
    jm, jp, tm, tp = _models()
    T, seed, n_new = 0.8, 5, 6
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, MODEL["vocab"], s).astype(np.int32) for s in (5, 9, 12, 7)]
    want, _ = _engine_wave(js, jm, jp, prompts, n_new, temperature=T, seed=seed)
    got, stats = _engine_wave(ts, tm, tp, prompts, n_new, temperature=T, seed=seed)
    again, _ = _engine_wave(ts, tm, tp, prompts, n_new, temperature=T, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))
    base = trandom._base_key(seed)
    n_warm = 2  # warmup's prefills at buckets 8 and 16 (S_cap 32), then one step
    fwd = tm.logits_fn()
    V = MODEL["vocab"]

    def scores_at(slot, s0):
        def fn(t, seq):
            z = fwd(tp, seq[None, :t])[0, -1]
            j = t - s0
            step_key = (trandom._fold_in(base, 2 * (n_warm + slot + 1) + 1) if j == 0
                        else trandom._fold_in(base, 2 * (1 + j)))
            words = trandom._words(trandom._fold_in(step_key, slot),
                                   torch.arange(V, dtype=torch.int64), False)
            return _scores(z, T, words)
        return fn

    ties = sum(_compare_tokens(g, w, pr.size, scores_at(i, pr.size))
               for i, (g, w, pr) in enumerate(zip(got, want, prompts)))
    assert ties <= 1, ties
    assert stats["tokens_out"] == len(prompts) * n_new and stats["decode_fallbacks"] == 0


# --------------------------------------------------------------------------- #
# the decode engine: tenancy and the degraded step                            #
# --------------------------------------------------------------------------- #
def _tenant_schedule(pkg, m, p):
    rng = np.random.default_rng(8)
    eng = pkg.serve_transformer(m, p, 32, decode=True, slots=2, queue_limit=5)
    order = []
    try:
        eng.register_tenant("gold", priority=2, slo_ms=60_000.0)
        eng.register_tenant("free")
        eng.warmup()
        eng.pause()
        futs, shed = [], []
        for i, name in enumerate(["free", "free", "gold", None, "gold", "free"]):
            prompt = rng.integers(0, MODEL["vocab"], 4 + i).astype(np.int32)
            try:
                f = eng.submit(prompt, 3, tenant=name)
                f.add_done_callback(lambda f, i=i: order.append(i))
                futs.append(f)
            except pkg.ServeOverloaded as exc:
                shed.append((i, type(exc).__name__))
        try:
            eng.submit(np.ones(3, np.int32), 2, tenant="nobody")
        except ValueError:
            shed.append("ValueError")
        eng.resume()
        outs = [f.result(120) for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    return [o.tolist() for o in outs], order, shed, st["tenants"], st["tokens_out"]


def test_decode_tenancy_matches_heat_tpu():
    jm, jp, tm, tp = _models()
    got = _tenant_schedule(ts, tm, tp)
    assert got == _tenant_schedule(js, jm, jp)
    # the gold requests took the two slots first
    assert got[1][:2] == [2, 4] and got[2] == [(5, "ServeOverloaded"), "ValueError"]
    assert got[3]["gold"]["completed"] == 2 and got[3]["free"]["shed"] == 1


def test_decode_step_fault_degrades_per_slot():
    _, _, tm, tp = _models()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, MODEL["vocab"], s).astype(np.int32) for s in (6, 10, 3)]
    clean, st0 = _engine_wave(ts, tm, tp, prompts, 5)
    before = ht.runtime_stats()["serve"]["decode"]["decode_fallbacks"]
    with tfaults.inject("serve.decode.step=nth:3"):  # warmup's step is hit 1
        got, st = _engine_wave(ts, tm, tp, prompts, 5)
    assert st["decode_fallbacks"] == 1 and st0["decode_fallbacks"] == 0
    assert ht.runtime_stats()["serve"]["decode"]["decode_fallbacks"] == before + 1
    for g, c in zip(got, clean):
        assert np.array_equal(g, c)
    assert [g.tolist() for g in clean] == [tm.generate(tp, pr[None], 5)[0].tolist()
                                           for pr in prompts]


# --------------------------------------------------------------------------- #
# observability                                                               #
# --------------------------------------------------------------------------- #
def test_runtime_stats_has_heat_tpu_keys():
    with ts.ServingExecutor(lambda x: x + 1.0) as ex:
        ex.register_tenant("a")
        ex.predict(np.ones((2, 3), np.float32), tenant="a", timeout=30)
        got = ht.runtime_stats()
    with js.ServingExecutor(lambda x: x + 1.0) as jex:
        jex.register_tenant("a")
        jex.predict(np.ones((2, 3), np.float32), tenant="a", timeout=30)
        want = hj.runtime_stats()
    assert set(got) == set(want)
    assert set(got["serve"]) == set(want["serve"])
    assert set(got["serve"]["decode"]) == set(want["serve"]["decode"]) == \
        set(ts.DECODE_STATS_KEYS)
    assert got["serve"]["tenants"]["a"].keys() == want["serve"]["tenants"]["a"].keys()
    assert set(got["op_engine"]) == set(want["op_engine"])
    assert set(got["op_engine"]["fusion"]) == set(want["op_engine"]["fusion"])
    assert got["op_engine"]["fusion"]["enabled"] is want["op_engine"]["fusion"]["enabled"]
    assert set(got["resharding"]) == set(want["resharding"])
    assert set(got["faults"]) == set(want["faults"])
    assert set(got["data_engine"]) == set(want["data_engine"])
    assert got["serve"]["executors"] >= 1
    # the plan resolutions count under heat_tpu's resharding keys
    before = ht.runtime_stats()["resharding"]
    a = ht.arange(10, split=0)
    a.resplit(None), a.resplit(None)
    after = ht.runtime_stats()["resharding"]
    assert after["misses"] - before["misses"] <= 1
    assert after["hits"] + after["misses"] - before["hits"] - before["misses"] == 2


def test_fault_registry_errors_and_env_arming(env_arming):
    assert tfaults.SITES.keys() == jfaults.SITES.keys()
    assert {k: v[0].__name__ for k, v in tfaults.SITES.items()} == \
        {k: v[0].__name__ for k, v in jfaults.SITES.items()}
    assert tfaults.__all__ == jfaults.__all__
    for bad in ("nope=once", "serve.worker.batch", "serve.worker.batch=nth:0",
                "serve.worker.batch=prob:2@1", "serve.worker.batch=sometimes"):
        with pytest.raises(ValueError) as want:
            jfaults.parse_spec(bad)
        with pytest.raises(ValueError) as got:
            tfaults.parse_spec(bad)
        assert str(got.value) == str(want.value)
    # heat_tpu's variable leaves the port disarmed; the port's arms it at import
    out, err = env_arming.communicate(timeout=120)
    assert env_arming.returncode == 0, err
    assert out.strip().splitlines()[-1] == \
        '[false, true, {"serve.batch.dispatch": "every:2"}]'
