"""The port's kernels against heat_tpu's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, held here against
heat_tpu's ``cdist_tile`` and ``kmeans_step_tile`` run in Pallas interpret
mode, on the same numpy inputs. Card-only cases (marker ``cuda``) hold each
CUDA kernel against its plain version; they import nothing of JAX, so on a
machine with a card and no JAX they run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.

Tolerances: rtol 1e-5 for float32 and 1e-12 for float64. The expansion
form x² + y² − 2·x·y loses absolute precision to cancellation, so the
squared distances also get an absolute term of rtol·(|x|² + |y|²)max, and
the inertia one of rtol·Σ|x|²; a bf16 output may differ by one bf16
rounding step (rtol 2⁻⁷).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heat_tpu_torch.core import kernels as tk  # noqa: E402


def _jax():
    """heat_tpu's Pallas kernels and ``jax.numpy``, imported by the CPU
    parity tests only."""
    import jax.numpy as jnp
    from heat_tpu.core import pallas_kernels as pk

    return pk, jnp

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _inputs(m, n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(dtype),
            rng.standard_normal((n, d)).astype(dtype))


def _scale(x, y):
    return float((x.astype(np.float64) ** 2).sum(1).max() + (y.astype(np.float64) ** 2).sum(1).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sqrt", [True, False])
def test_cdist_tile_plain_matches_pallas(dtype, sqrt):
    pk, jnp = _jax()
    x, y = _inputs(37, 129, 18, dtype)  # ragged in every dimension
    want = np.asarray(pk.cdist_tile(jnp.asarray(x), jnp.asarray(y), sqrt=sqrt))
    got = tk.cdist_tile_plain(torch.from_numpy(x), torch.from_numpy(y), sqrt=sqrt)
    assert got.dtype == torch.from_numpy(np.array(want)).dtype
    rtol = RTOL[dtype]
    scale = _scale(x, y)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * (np.sqrt(scale) if sqrt else scale))


def test_cdist_tile_dtype_rules():
    pk, jnp = _jax()
    x, y = _inputs(37, 129, 18, np.float32, seed=1)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    tb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    # bf16 in -> bf16 out, within one bf16 rounding step
    want = np.asarray(pk.cdist_tile(xb, yb).astype(jnp.float32))
    got = tk.cdist_tile(*tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-2)
    # out_dtype float32 on bf16 input (the rbf form)
    want = np.asarray(pk.cdist_tile(xb, yb, sqrt=False, out_dtype="float32"))
    got = tk.cdist_tile(*tb, sqrt=False, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * _scale(x, y))
    # integer in -> float32 out
    xi = np.arange(24, dtype=np.int32).reshape(8, 3)
    want = np.asarray(pk.cdist_tile(jnp.asarray(xi), jnp.asarray(xi)))
    got = tk.cdist_tile(torch.from_numpy(xi), torch.from_numpy(xi))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-2)


def _blobs(n, d, k, dtype, seed):
    """Well-separated clusters: no row is near a tie, so labels and counts
    must agree exactly."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 10
    lab = rng.integers(0, k, n)
    x = (centers[lab] + 0.1 * rng.standard_normal((n, d))).astype(dtype)
    c = (centers + 0.5 * rng.standard_normal((k, d))).astype(dtype)
    return x, c


def _pallas_step(x, c, valid):
    pk, jnp = _jax()
    sums, counts, inertia = pk.kmeans_step_tile(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid.astype(x.dtype)[:, None]))
    return np.asarray(sums), np.asarray(counts), float(inertia)


@pytest.mark.parametrize("dtype,k", [(np.float32, 3), (np.float32, 8), (np.float64, 8)])
def test_kmeans_step_plain_matches_pallas(dtype, k):
    n, d = 301, 12
    x, c = _blobs(n, d, k, dtype, seed=k)
    valid = np.arange(n) < n - 17  # masked tail rows
    want = _pallas_step(x, c, valid)
    sums, counts, inertia = tk.kmeans_step_plain(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(valid))
    assert sums.dtype == counts.dtype == inertia.dtype == torch.from_numpy(x).dtype
    rtol = RTOL[dtype]
    np.testing.assert_array_equal(counts.numpy(), want[1])
    np.testing.assert_allclose(sums.numpy(), want[0], rtol=rtol, atol=rtol * np.abs(x).max())
    # inertia sums min(c² − 2·x·c) + x² per row: cancellation against x²
    np.testing.assert_allclose(float(inertia), want[2], rtol=rtol,
                               atol=rtol * float((x.astype(np.float64) ** 2).sum()))


def test_kmeans_step_ties_take_the_first_index():
    # every row is exactly equidistant from centroids 0 and 1 (and 2 and 3)
    rng = np.random.default_rng(5)
    x = np.zeros((40, 4), np.float32)
    x[:, 1:] = rng.integers(-3, 4, (40, 3))
    c = np.zeros((4, 4), np.float32)
    c[0, 0], c[1, 0], c[2, 0], c[3, 0] = 1, -1, 1, -1
    c[2:, 1] = 50  # far away
    valid = np.ones(40, bool)
    want = _pallas_step(x, c, valid)
    sums, counts, inertia = tk.kmeans_step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(counts.numpy(), [40, 0, 0, 0])
    np.testing.assert_array_equal(counts.numpy(), want[1])
    np.testing.assert_allclose(sums.numpy(), want[0], rtol=1e-5)
    np.testing.assert_allclose(float(inertia), want[2], rtol=1e-5)


def test_kmeans_step_labels_agree_with_counts():
    x, c = _blobs(301, 12, 5, np.float32, seed=6)
    valid = torch.from_numpy(np.arange(301) < 290)
    sums, counts, _, labels = tk.kmeans_step(torch.from_numpy(x), torch.from_numpy(c), valid,
                                             return_labels=True)
    want = np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(want[:290], minlength=5))
    ref = np.zeros((5, 12))
    np.add.at(ref, want[:290], x[:290])
    np.testing.assert_allclose(sums.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(x).max())


def _tf32(t):
    """float32 rounded to TF32's 10-bit mantissa, as tensor-core products
    would see it."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_smoke_checks_reject_tf32_precision():
    # chip_smoke.py holds each kernel to float32 error bounds; a kernel that
    # took TF32 products would fail them, while the plain version passes
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(6000, 64, generator=g)
    c, y = x[:8].clone(), torch.rand(1500, 18, generator=g)
    for sqrt in (True, False):
        assert cs.check_cdist(torch, tk, y, y, sqrt=sqrt)[1] <= 1.0
        with pytest.raises(AssertionError, match="beyond their tolerance"):
            cs.check_cdist(torch, tk, y, y, sqrt=sqrt,
                           got=tk.cdist_tile_plain(_tf32(y), _tf32(y), sqrt=sqrt))
    mask = torch.arange(6000) < 5900
    got = tk.kmeans_step(x, c, mask, return_labels=True)
    want = tk.kmeans_step_plain(x, c, mask, return_labels=True)
    cs.check_kmeans_step(torch, x, c, mask, got, want)
    tf32_labels = tk.kmeans_step_plain(_tf32(x), _tf32(c), mask, return_labels=True)[3]
    with pytest.raises(AssertionError, match="near-ties"):
        cs.check_kmeans_step(torch, x, c, mask, got[:3] + (tf32_labels,), want)


def test_wrappers_take_plain_only_on_cpu():
    tk.reset_launches()
    x = torch.ones(5, 3)
    tk.cdist_tile(x, x)
    tk.kmeans_step(x, x[:2])
    assert tk.launches == {"cdist_tile": 0, "kmeans_step": 0, "flash_attention": 0,
                           "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "probe": 0}
    # data-free tensors (a step trace's) take the plain version too: shapes
    # only, no launch
    meta = torch.empty(5, 3, device="meta")
    d = tk.cdist_tile(meta, meta)
    sums, counts, inertia = tk.kmeans_step(meta, meta[:2])
    assert d.is_meta and d.shape == (5, 5)
    assert sums.is_meta and (sums.shape, counts.shape, inertia.shape) == ((2, 3), (2,), ())
    assert sum(tk.launches.values()) == 0
    with pytest.raises(ValueError):
        tk.kmeans_step(x, x[:2], torch.ones(5))  # a float mask is refused


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from heat_tpu_torch.core._build import library

    library()  # built and probed before a test counts launches, whatever runs first
    return torch.device("cuda")


# n <= 8 takes the kernel with two threads a row (tiles of 128 rows, a ring
# of two), larger n the 128 x 128 tiles (64 x 64 for float64); n = 8 and 9
# sit at that boundary, n = 8 and 12 store vectors, n = 5, 9, 77 and 129
# scalars, n = 129 is one column past a tile. m = 100 is less than one ring
# stage, 129 one row past a tile, 257 one row past the ring, 300 further;
# offset 1 takes x as a view one row in, which is not 16-byte aligned (d =
# 18: 8-byte pieces for 4-byte types, 4 for 2-byte ones; d = 17: 4, 8 for
# float64, and 2-byte pieces copied by plain loads).
# Row 7 of x is NaN for floating inputs: its distances stay NaN.
@pytest.mark.cuda
@pytest.mark.parametrize("m,d,offset", [(300, 18, 0), (100, 18, 0), (257, 18, 1),
                                        (129, 17, 1)])
@pytest.mark.parametrize("n", [5, 8, 9, 12, 77, 129])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, None), (torch.float64, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32), (torch.float16, None), (torch.float16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.float16), (torch.float16, torch.bfloat16), (torch.int32, None)])
def test_cdist_kernel_matches_plain_on_card(card, in_dtype, out_dtype, n, m, d, offset):
    x, y = _inputs(m + offset, n, d, np.float64, seed=2)
    tx = torch.from_numpy(x * 4).to(card, in_dtype)[offset:]
    ty = torch.from_numpy(y * 4).to(card, in_dtype)
    if in_dtype.is_floating_point:
        tx[7] = float("nan")
    before = tk.launches["cdist_tile"]
    for sqrt in (True, False):
        got = tk.cdist_tile(tx, ty, sqrt=sqrt, out_dtype=out_dtype)
        again = tk.cdist_tile(tx, ty, sqrt=sqrt, out_dtype=out_dtype)
        want = tk.cdist_tile_plain(tx, ty, sqrt=sqrt, out_dtype=out_dtype)
        assert got.dtype == want.dtype
        torch.testing.assert_close(again, got, rtol=0, atol=0, equal_nan=True)
        tol = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}.get(got.dtype, 1e-5)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * 600,
                                   equal_nan=True)
        assert bool(got[7].isnan().all()) == in_dtype.is_floating_point
    assert tk.launches["cdist_tile"] == before + 4


# k <= 8 keeps the k dot products and the partial sums in registers (rows of
# at most 256 bytes: float64 d = 64 does not), larger k takes one centroid at
# a time with the sums in shared memory; d % 4 != 0 (float32) or d % 2 != 0
# (float64) stages X in 8- or 4-byte pieces; k*d past 48 KB of shared memory
# (k = 8, d = 64 already) opts in to more; k = 90 (float32) at d = 64 fits
# only with tiles of 32 rows, and k = 70 (float64) takes the streaming path.
# The ring holds two tiles of up to 128 rows: n = 100 is less than one
# stage, 129 one row past a tile and less than both, 257 one row past the
# ring, 300 further; offset 1 takes x as a view one row in, which is not
# 16-byte aligned (d = 18 float32: 8-byte pieces; d = 17: 4-byte ones, 8 for
# float64); the "tiles" mask turns whole tiles of 128 rows off (every second
# one), "tail" the last rows (103 of 5003).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k,d,n,offset,masked", [
    (torch.float32, 3, 18, 5003, 0, "tail"), (torch.float32, 8, 64, 5003, 0, "tail"),
    (torch.float32, 20, 18, 5003, 0, "tail"), (torch.float32, 20, 64, 5003, 0, "tail"),
    (torch.float32, 40, 17, 5003, 0, "tail"), (torch.float32, 90, 64, 5003, 0, "tail"),
    (torch.float64, 3, 18, 5003, 0, "tail"), (torch.float64, 8, 64, 5003, 0, "tail"),
    (torch.float64, 20, 17, 5003, 0, "tail"), (torch.float64, 40, 64, 5003, 0, "tail"),
    (torch.float64, 70, 64, 5003, 0, "tail"),
    (torch.float32, 8, 64, 100, 0, "tail"), (torch.float32, 8, 64, 300, 0, "tiles"),
    (torch.float32, 8, 64, 129, 0, "tail"), (torch.float32, 8, 64, 257, 0, "tiles"),
    (torch.float32, 8, 18, 257, 1, "tiles"), (torch.float32, 5, 17, 129, 1, "tail"),
    (torch.float32, 20, 64, 257, 0, "tiles"), (torch.float32, 20, 17, 300, 1, "tiles"),
    (torch.float64, 8, 64, 257, 0, "tiles"), (torch.float64, 3, 17, 100, 1, "tail"),
    (torch.float64, 8, 17, 5003, 1, "tiles")])
def test_kmeans_kernel_matches_plain_on_card(card, dtype, k, d, n, offset, masked):
    x, c = _blobs(n + offset, d, k, np.float64, seed=9)
    tx = torch.from_numpy(x).to(card, dtype)[offset:]
    tc = torch.from_numpy(c).to(card, dtype)
    rows = torch.arange(n, device=card)
    valid = rows < n - min(103, n // 10) if masked == "tail" else (rows // 128) % 2 == 0
    before = tk.launches["kmeans_step"]
    got = tk.kmeans_step(tx, tc, valid, return_labels=True)
    again = tk.kmeans_step(tx, tc, valid, return_labels=True)
    want = tk.kmeans_step_plain(tx, tc, valid, return_labels=True)
    assert tk.launches["kmeans_step"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bitwise repeatable
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got[0], want[0], rtol=rtol, atol=rtol * 40)
    torch.testing.assert_close(got[2], want[2], rtol=rtol,
                               atol=rtol * float((tx.double() ** 2).sum()))


# k*d past what the shared path holds (float32 k > 99 at d = 64) streams the
# centroids in chunks and keeps each block's sums in its workspace row: k =
# 128 and 1024 at d = 64 (one and two chunks), k = 64 at d = 1024 (tiles of
# 16 rows, 8 threads a row); labels equal the plain version's, counts exact,
# bitwise repeatable
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,d", [(128, 64), (1024, 64), (64, 1024)])
def test_kmeans_kernel_streams_large_kd_on_card(card, dtype, k, d):
    cs = _smoke_module()
    n = 20011
    x, c = _blobs(n, d, k, np.float64, seed=k + d)
    tx, tc = torch.from_numpy(x).to(card, dtype), torch.from_numpy(c).to(card, dtype)
    valid = torch.arange(n, device=card) < n - 101
    before = tk.launches["kmeans_step"]
    got = tk.kmeans_step(tx, tc, valid, return_labels=True)
    again = tk.kmeans_step(tx, tc, valid, return_labels=True)
    want = tk.kmeans_step_plain(tx, tc, valid, return_labels=True)
    assert tk.launches["kmeans_step"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bitwise repeatable
    if dtype == torch.float32:
        cs.check_kmeans_step(torch, tx, tc, valid, got, want)
    else:
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], want[0], rtol=1e-12, atol=1e-12 * 40)
        torch.testing.assert_close(got[2], want[2], rtol=1e-12,
                                   atol=1e-12 * float((tx ** 2).sum()))


@pytest.mark.cuda
def test_kmeans_kernel_refuses_centroids_past_shared_memory(card):
    # only a row too wide for half a block's shared memory is refused
    # (float32, d > ~29,000); any k*d below that runs
    x = torch.zeros(100, 32768, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        tk.kmeans_step(x, torch.zeros(2, 32768, device=card))
    got = tk.kmeans_step(torch.zeros(100, 64, device=card), torch.zeros(200, 64, device=card))
    assert float(got[1][0]) == 100  # every row ties at 0: the first index takes it


@pytest.mark.cuda
def test_kmeans_fit_128_clusters_on_card(card):
    # KMeans(n_clusters=128) on (n, 64) float32 runs on the card (the
    # streaming path) and follows a plain Lloyd loop from the same centroids
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster.kmeans import _finish_update

    x, c = _blobs(30000, 64, 128, np.float32, seed=12)
    X, init = ht.array(x, split=0, device="gpu"), ht.array(c, device="gpu")
    before = tk.launches["kmeans_step"]
    km = ht.cluster.KMeans(n_clusters=128, init=init, max_iter=6, tol=-1).fit(X)
    assert tk.launches["kmeans_step"] == before + 6
    cp = init.larray.clone()
    for _ in range(6):
        s, n_, _ = tk.kmeans_step_plain(X.larray, cp)
        cp, _ = _finish_update(s, n_, cp)
    assert km.n_iter_ == 6
    torch.testing.assert_close(km.cluster_centers_.larray, cp, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_column_slice_runs_on_card(card):
    # X[:, :16] of a split-0 array is a strided view of the local shard
    import heat_tpu_torch as ht

    x, c = _blobs(3001, 40, 5, np.float32, seed=4)
    X, init = ht.array(x, split=0, device="gpu"), ht.array(c[:, :16], device="gpu")
    ref = ht.array(np.ascontiguousarray(x[:, :16]), split=0, device="gpu")
    assert not X[:, :16].larray.is_contiguous()
    before = dict(tk.launches)
    got = ht.cluster.KMeans(n_clusters=5, init=init, max_iter=5).fit(X[:, :16])
    want = ht.cluster.KMeans(n_clusters=5, init=init, max_iter=5).fit(ref)
    assert torch.equal(got.cluster_centers_.larray, want.cluster_centers_.larray)
    assert torch.equal(got.predict(X[:, :16]).larray, want.predict(ref).larray)
    d_got = ht.spatial.cdist(X[:, :16], quadratic_expansion=True)
    assert torch.equal(d_got.larray, ht.spatial.cdist(ref, quadratic_expansion=True).larray)
    assert tk.launches["kmeans_step"] > before["kmeans_step"]
    assert tk.launches["cdist_tile"] > before["cdist_tile"]


def _smoke_module():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_flash_and_near_tie_checks_reject_wrong_results():
    # chip_smoke.py's flash check passes the plain version and refuses
    # operands rounded to TF32, a missing causal mask and NaN rows filled
    # in; its near-tie rule passes the float32 argmax and refuses a
    # token far below it
    cs = _smoke_module()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 70, 64, generator=g) for _ in range(3))
    assert cs.check_flash(torch, tk, q, k, v, causal=True)[1] <= 1.0
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash(torch, tk, q, k, v, causal=True, got=tk.flash_attention_plain(
            _tf32(q), _tf32(k), _tf32(v), causal=True, return_lse=True))
    unmasked = tk.flash_attention_plain(q, k, v, causal=False, return_lse=True)
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash(torch, tk, q, k, v, causal=True, got=unmasked)
    qs = torch.randn(1, 2, 80, 64, generator=g)
    out, lse = tk.flash_attention_plain(qs, k, v, causal=True, return_lse=True)
    with pytest.raises(AssertionError, match="NaN rows"):
        cs.check_flash(torch, tk, qs, k, v, causal=True, got=(torch.nan_to_num(out), lse))
    z = torch.randn(50, 1000, generator=g) * 0.64
    assert cs.near_tie_check(torch, z, z.argmax(dim=1), 8)[0] == 0
    wrong = z.argmax(dim=1).clone()
    wrong[7] = int(z[7].argmin())
    with pytest.raises(AssertionError, match="near-tie"):
        cs.near_tie_check(torch, z, wrong, 8)
    assert cs.flash_live_pairs(300, 200, True) == sum(range(1, 201))
    assert cs.flash_live_pairs(4, 4, True) == 10 and cs.flash_live_pairs(3, 5, False) == 15


def test_smoke_flash_bound_counts_tensor_core_passes():
    # the prefill shape on an H100 SXM: 8.45 MB at 3.35 TB/s is 2.5 µs; one
    # bf16 pass for q·kᵀ and three for P·V over 16·1024·1025/2 live pairs
    # at 989 TFLOP/s is 4.3 µs, so the operations bound it
    cs = _smoke_module()
    live = 16 * 1024 * 1025 // 2
    ms, by = cs.flash_bound(1, 16, 1024, 1024, 64, True, 3.35e12, 989e12)
    assert by == "operations" and ms == pytest.approx(4 * 2 * 64 * live / 989e12 * 1e3)
    ms_nc, by_nc = cs.flash_bound(1, 16, 1024, 1024, 64, False, 3.35e12, 989e12)
    assert by_nc == "operations" and ms_nc > 1.99 * ms
    nbytes = 4 * 16 * 1024 * 64 * 2 + 16 * 1024 * 4
    assert cs.flash_bound(1, 16, 1024, 1024, 64, True, 1e12, 989e12) == (
        pytest.approx(nbytes / 1e12 * 1e3), "bytes")


def test_smoke_flash_bound_f32_is_the_fma_floor_or_the_bytes():
    # the float32 forward's bound is the card's: on the bf16 tensor cores
    # q·kᵀ and P·V, each of two float32 operands split into bf16 terms, take
    # six passes of 2·D FLOPs per live pair (the fewest check_flash takes,
    # tests/test_torch_sm90_precision.py, and the count the kernel runs, its
    # Layout::NP; 0.104 ms at (8, 16, 1024, 64) causal on an H100 SXM),
    # unless moving float32 Q, K, V, O and the lse takes longer
    cs = _smoke_module()
    text = (pathlib.Path(cs.__file__).parent / "heat_tpu_torch" / "csrc" /
            "flash_fwd_sm90.cu").read_text()
    assert f"int NP = F32 ? {cs.F32_PASSES_FWD} : 1;" in text
    pairs = 8 * 16 * 1024 * 1025 // 2
    ms, by = cs.flash_bound_f32(8, 16, 1024, 1024, 64, True, 3.35e12, 989e12)
    assert by == "operations" and cs.F32_PASSES_FWD == 6
    assert ms == pytest.approx(12 * 2 * 64 * pairs / 989e12 * 1e3)
    assert 0.104 < ms < 0.105
    nbytes = 4 * 8 * 16 * 1024 * 64 * 4 + 8 * 16 * 1024 * 4
    assert cs.flash_bound_f32(8, 16, 1024, 1024, 64, True, 1e11, 989e12) == (
        pytest.approx(nbytes / 1e11 * 1e3), "bytes")


def test_smoke_reach_reads_the_bytes_the_bounds_count():
    # phase 4's achieved TB/s and bound share for cdist_tile and kmeans_step
    # read the bytes their bounds count: at the bound's own time a kernel
    # reaches the card's rate and a share of 1
    cs = _smoke_module()
    bw = 3.35e12
    for nbytes, (ms, by) in (
            (cs.cdist_bytes(40_000, 40_000, 18, 4, 4), cs.cdist_bound(40_000, 40_000, 18, 4, 4,
                                                                      bw, 67e12)),
            (cs.cdist_bytes(2**23, 8, 64, 4, 4), cs.cdist_bound(2**23, 8, 64, 4, 4, bw, 67e12)),
            (cs.kmeans_bytes(2**23, 64, 8), cs.kmeans_bound(2**23, 64, 8, bw, 67e12, 989e12))):
        assert by == "bytes"
        r = cs.reach(nbytes, ms, ms)
        assert r["achieved_TB_per_s"] == pytest.approx(bw / 1e12)
        assert r["bound_over_ms"] == pytest.approx(1.0)
        assert cs.reach(nbytes, 2 * ms, ms)["bound_over_ms"] == pytest.approx(0.5)


def test_smoke_kmeans_bound_counts_split_passes_on_the_tensor_cores():
    # a float32 Lloyd partial on an H100 SXM: the n·k products x·c take
    # three split-bf16 passes on the tensor cores (the fewest that hold
    # check_kmeans_step, tests/test_torch_sm90_precision.py), so both
    # streaming shapes of chip_smoke.py are bound by reading x: 0.080 ms at
    # 2^20 x 64, k = 128 and 0.160 ms at 2^17 x 1024, k = 64
    cs = _smoke_module()
    assert cs.F32_PASSES_KMEANS == 3
    for n, d, k, lo, hi in ((2**20, 64, 128, 0.080, 0.0805), (2**17, 1024, 64, 0.160, 0.161),
                            (2**23, 64, 8, 0.641, 0.642)):
        ms, by = cs.kmeans_bound(n, d, k, 3.35e12, 67e12, 989e12)
        assert by == "bytes" and lo < ms < hi, (n, d, k, ms)
    # with the bytes free, the products at three passes and the per-row work
    n, d, k = 2**20, 64, 128
    ms, by = cs.kmeans_bound(n, d, k, 1e18, 67e12, 989e12)
    assert by == "operations"
    assert ms == pytest.approx((3 * 2 * n * k * d / 989e12 + (3 * n * d + 3 * n * k) / 67e12)
                               * 1e3)


def test_smoke_flash_bwd_bounds_f32_count_nine_passes_a_product():
    # the float32 backward kernels' bounds at the training shape on an H100
    # SXM: four float32 x float32 products per live pair for dK/dV (0.209
    # ms) and three for dQ (0.156 ms), six split-bf16 passes each, the count
    # both kernels run (their Layout::NP) and the fewest that hold
    # check_flash_bwd (tests/test_torch_sm90_precision.py; nine, every cross
    # term of two three-way splits, is the most a product could need); bytes
    # as the bf16 bounds count them, every tensor four bytes an element
    cs = _smoke_module()
    csrc = pathlib.Path(cs.__file__).parent / "heat_tpu_torch" / "csrc"
    for src in ("flash_bwd_dkv_sm90.cu", "flash_bwd_dq_sm90.cu"):
        text = (csrc / src).read_text()
        assert f"int NP = F32 ? {cs.F32_PASSES_BWD} : 1;" in text, src
    pairs = 8 * 16 * 1024 * 1025 // 2
    (dkv, by_dkv), (dq, by_dq) = cs.flash_bwd_bounds_f32(8, 16, 1024, 1024, 64, True,
                                                         3.35e12, 989e12)
    assert by_dkv == by_dq == "operations" and cs.F32_PASSES_BWD == 6 < 9
    assert dkv == pytest.approx(4 * 6 * 2 * 64 * pairs / 989e12 * 1e3)
    assert dq == pytest.approx(3 * 6 * 2 * 64 * pairs / 989e12 * 1e3)
    assert 0.208 < dkv < 0.209 and 0.156 < dq < 0.157
    n = 8 * 16 * 1024 * 64 * 4
    (b_dkv, _), (b_dq, _) = cs.flash_bwd_bounds_f32(8, 16, 1024, 1024, 64, True, 1e9, 989e12)
    assert b_dkv == pytest.approx((6 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)
    assert b_dq == pytest.approx((5 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)


def _flash_case(card, b, h, sq, sk, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g).to(card, dtype) for s in (sq, sk, sk))


# Every dtype runs on the tensor-core kernel (csrc/flash_fwd_sm90.cu; float32
# through its split planes, six passes a product). Head dims 8 to 64 pad to
# 64 columns in its shared memory, 128 fills its own (float32: a block of 64
# rows and 32-key tiles); d = 24 has 48-byte rows, which TMA addresses, and
# d = 20 has 40-byte rows, which it cannot, so bf16 and float16 stage those
# through plain loads (float32's planes are padded to whole 16-byte rows). Sq, Sk ragged against the tiles, Sq > Sk (empty
# rows), Sq = 1 (one query), Sk < Sq without causal, and Sk = 4096 with 300
# queries, which wraps the key ring many times.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 20, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,sk,causal", [
    (77, 130, True), (77, 130, False), (150, 70, True), (1, 200, True), (64, 64, True),
    (100, 37, False), (300, 4096, True), (300, 4096, False)])
def test_flash_kernel_matches_plain_on_card(card, d, dtype, sq, sk, causal):
    cs = _smoke_module()
    q, k, v = _flash_case(card, 2, 3, sq, sk, d, dtype, seed=d + sq)
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dtype, 0.0)
    before = tk.launches["flash_attention"]
    cs.check_flash(torch, tk, q, k, v, causal=causal, out_step=step)
    assert tk.launches["flash_attention"] == before + 1
    out = tk.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(tk.flash_attention(q, k, v, causal=causal, block_q=100,
                                                  block_k=32), out, rtol=0, atol=0,
                               equal_nan=True)
    if causal and sq > sk:
        assert bool(torch.isnan(out[:, :, :sq - sk]).all())


@pytest.mark.cuda
def test_flash_kernel_refusals_on_card(card):
    q, k, v = _flash_case(card, 1, 2, 10, 10, 64, torch.float32, seed=1)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tk.flash_attention(q.double(), k.double(), v.double())
    big = _flash_case(card, 1, 2, 10, 10, 160, torch.float32, seed=2)
    with pytest.raises(ValueError, match="head dims up to 128"):
        tk.flash_attention(*big)
    with pytest.raises(ValueError, match="contiguous"):
        tk.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    # inputs that require grad train through both backward kernels
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = dict(tk.launches)
    out, lse = tk.flash_attention(qg, kg, vg, causal=True, return_lse=True)
    w = torch.randn(lse.shape, device=card)
    grads = torch.autograd.grad((out ** 2).sum() + (lse * w).sum(), (qg, kg, vg))
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        assert tk.launches[name] == before[name] + 1, name
    want = tk.flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), 2 * out.detach(),
                                        w, causal=True)
    for g, wt in zip(grads, want):
        torch.testing.assert_close(g, wt, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert torch.equal(tk.flash_attention(qg, k, v), tk.flash_attention(q, k, v))
    # no key: NaN rows and a -inf lse, as the plain version gives, and no launch
    for dt in (torch.float32, torch.bfloat16):
        qd, kd = q.to(dt), k[:, :, :0].to(dt)
        before = tk.launches["flash_attention"]
        out0, lse0 = tk.flash_attention(qd, kd, kd, return_lse=True)
        assert tk.launches["flash_attention"] == before
        assert bool(torch.isnan(out0).all()) and bool(torch.isneginf(lse0).all())
    dmb = torch.zeros(lse.shape, device=card)
    with pytest.raises(ValueError, match="float32 lse and dmb"):
        tk.flash_bwd_dq(q, k, v, q, lse, dmb.double())
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tk.flash_bwd_dkv(q.double(), k.double(), v.double(), q.double(), lse, dmb)


@pytest.mark.cuda
def test_probe_on_card(card):
    x = torch.randn(8, 128, device=card)
    before = tk.launches["probe"]
    assert torch.equal(tk.probe(x), tk.probe_plain(x))
    assert torch.equal(tk.probe(torch.zeros(8, 128, device=card)),
                       torch.ones(8, 128, device=card))
    assert tk.launches["probe"] == before + 2
    with pytest.raises(ValueError, match="float32"):
        tk.probe(x.double())


def test_smoke_flash_bwd_check_rejects_wrong_results():
    # chip_smoke.py's backward check passes the plain versions and refuses
    # operands rounded to TF32, a dropped dmb term, a missing causal mask and
    # NaN rows filled in
    cs = _smoke_module()
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, s, 64, generator=g) for s in (70, 90, 90))
    out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    dout = torch.randn(out.shape, generator=g)
    dmb = tk._dmb(out, dout, torch.randn(lse.shape, generator=g))
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal=True)
    assert set(res) == {"dq", "dk", "dv"} and all(r <= 1.0 for _, r in res.values())

    def plain(*args, causal=True):
        dk, dv = tk.flash_bwd_dkv_plain(*args, causal=causal)
        return tk.flash_bwd_dq_plain(*args, causal=causal), dk, dv

    for wrong in (plain(_tf32(q), _tf32(k), _tf32(v), _tf32(dout), lse, dmb),
                  plain(q, k, v, dout, lse, torch.zeros_like(dmb)),
                  plain(q, k, v, dout, lse, dmb, causal=False)):
        with pytest.raises(AssertionError, match="beyond their tolerance"):
            cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal=True, got=wrong)
    qs = torch.randn(1, 2, 120, 64, generator=g)  # 30 empty rows
    out, lse = tk.flash_attention(qs, k, v, causal=True, return_lse=True)
    dout = torch.randn(out.shape, generator=g)
    dmb = tk._dmb(out, dout, None)
    filled = tuple(torch.nan_to_num(t) for t in plain(qs, k, v, dout, lse, dmb))
    with pytest.raises(AssertionError, match="NaN positions"):
        cs.check_flash_bwd(torch, tk, qs, k, v, dout, lse, dmb, causal=True, got=filled)


def test_smoke_flash_bwd_check_takes_the_exact_backward_where_ds_cancels():
    # a causal row's first query sees one key, so P = 1 there and dS =
    # dO·v0 + dmb = dO·v0 − dO·out = 0 exactly: what either version computes
    # is its rounding of dO·v0. With dO·v0 small that rounding exceeds
    # 1e-4·P·(|dO·vᵀ| + |dmb|), so without W's rounding term the check
    # refused the exact backward (float64, rounded once) on all 64 columns
    # of dQ's first row; with it the exact backward passes
    cs = _smoke_module()
    g = torch.Generator().manual_seed(5)
    q, k, v, dout = (torch.randn(1, 4, 64, 64, generator=g) for _ in range(4))
    v0 = v[..., 0, :]
    dout[..., 0, :] -= (((dout[..., 0, :] * v0).sum(-1, keepdim=True) - 0.005)
                        / (v0 * v0).sum(-1, keepdim=True) * v0)
    out, lse = tk.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    dmb = tk._dmb(out, dout, None)
    qd, kd, vd, od = (t.double() for t in (q, k, v, dout))
    vis = torch.ones(64, 64, dtype=torch.bool).tril()
    p = torch.softmax(((qd / 8) @ kd.transpose(-1, -2)).masked_fill(~vis, float("-inf")), -1)
    ds = p * (od @ vd.transpose(-1, -2) - (od * (p @ vd)).sum(-1)[..., None])
    exact = tuple(t.float() for t in ((ds @ kd) / 8, (ds.transpose(-1, -2) @ qd) / 8,
                                      p.transpose(-1, -2) @ od))
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, got=exact)
    assert all(r <= 1.0 for _, r in res.values()), res
    # the plain version's own first row of dQ lies further from the exact
    # one than the limit without the rounding term
    want = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=True)[..., 0, :]
    dp0 = (dout[..., 0, :] * v0).sum(-1, keepdim=True)
    former = 1e-4 * (dp0.abs() + dmb[..., :1].abs()) * k[..., 0, :].abs() / 8
    assert bool(((want - exact[0][..., 0, :]).abs() > former).any())


def test_smoke_flash_bwd_bounds_at_the_training_shape():
    # (8, 16, 1024, 64) bf16 causal on an H100 SXM: 67,174,400 live pairs;
    # dK/dV takes 16·D FLOPs per pair on the tensor cores (68.8 GFLOP,
    # 0.070 ms) against ~102 MB (0.030 ms), dQ 10·D (43.0 GFLOP, 0.043 ms)
    # against ~85 MB (0.025 ms)
    cs = _smoke_module()
    pairs = 8 * 16 * 1024 * 1025 // 2
    assert pairs == 67_174_400
    (dkv, by_dkv), (dq, by_dq) = cs.flash_bwd_bounds(8, 16, 1024, 1024, 64, True,
                                                     3.35e12, 989e12)
    assert by_dkv == by_dq == "operations"
    assert dkv == pytest.approx(16 * 64 * pairs / 989e12 * 1e3)
    assert dq == pytest.approx(10 * 64 * pairs / 989e12 * 1e3)
    assert 0.069 < dkv < 0.070 and 0.043 < dq < 0.044
    n = 8 * 16 * 1024 * 64 * 2
    (b_dkv, _), (b_dq, _) = cs.flash_bwd_bounds(8, 16, 1024, 1024, 64, True, 1e9, 989e12)
    assert b_dkv == pytest.approx((6 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)
    assert b_dq == pytest.approx((5 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)


def test_smoke_flash_bounds_count_two_f16_passes_a_split_product():
    # float16 at the training shape on an H100 SXM: the float32 operand of
    # P·V, Pᵀ·dO, dSᵀ·q and dS·k splits into F16_PASSES_SPLIT = 2 float16
    # terms (three bf16 ones for bf16, which keep their bounds): the forward
    # takes 1 + 2 passes per live pair (0.026 ms at B = 8, 0.0033 ms at
    # B = 1), dK/dV 2 + 2·2 (0.052 ms), dQ 2 + 2 (0.035 ms); bytes as bf16's
    cs = _smoke_module()
    assert cs.F16_PASSES_SPLIT == 2 and cs.BF16_PASSES_SPLIT == 3
    pairs = 8 * 16 * 1024 * 1025 // 2
    ms, by = cs.flash_bound(8, 16, 1024, 1024, 64, True, 3.35e12, 989e12,
                            split_passes=cs.F16_PASSES_SPLIT)
    assert by == "operations" and ms == pytest.approx(3 * 2 * 64 * pairs / 989e12 * 1e3)
    assert 0.026 < ms < 0.0261
    ms1, _ = cs.flash_bound(1, 16, 1024, 1024, 64, True, 3.35e12, 989e12, split_passes=2)
    assert 0.0032 < ms1 < 0.0033
    assert cs.flash_bound(8, 16, 1024, 1024, 64, True, 3.35e12, 989e12)[0] == pytest.approx(
        4 * 2 * 64 * pairs / 989e12 * 1e3)
    (dkv, by_dkv), (dq, by_dq) = cs.flash_bwd_bounds(8, 16, 1024, 1024, 64, True, 3.35e12,
                                                     989e12, split_passes=2)
    assert by_dkv == by_dq == "operations"
    assert dkv == pytest.approx(6 * 2 * 64 * pairs / 989e12 * 1e3) and 0.052 < dkv < 0.0522
    assert dq == pytest.approx(4 * 2 * 64 * pairs / 989e12 * 1e3) and 0.0347 < dq < 0.0348
    n = 8 * 16 * 1024 * 64 * 2
    (b_dkv, _), (b_dq, _) = cs.flash_bwd_bounds(8, 16, 1024, 1024, 64, True, 1e9, 989e12,
                                                split_passes=2)
    assert b_dkv == pytest.approx((6 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)
    assert b_dq == pytest.approx((5 * n + 2 * 8 * 16 * 1024 * 4) / 1e9 * 1e3)


def test_smoke_bf16_training_rules():
    # the loss rule is twice the mean per-position logit limit; the gradient
    # rule 2·u·sqrt(24·L) in relative norm (0.108 at the flagship's 8 layers)
    cs = _smoke_module()
    z = torch.randn(4, 7, 50, generator=torch.Generator().manual_seed(2)) * 0.64
    want = 2 * cs.bf16_logit_tol(z.std(dim=-1), z.abs().amax(dim=-1), 8).mean()
    assert cs.bf16_loss_tol(torch, z, 8) == pytest.approx(float(want))
    assert cs.bf16_grad_tol(8) == pytest.approx(2 * 2 ** -8 * (24 * 8) ** 0.5)


# dK/dV and dQ run on the tensor-core kernels in every dtype
# (csrc/flash_bwd_dkv_sm90.cu, csrc/flash_bwd_dq_sm90.cu).
# Head dims as in the forward's test (d = 20 stages through plain loads);
# lengths ragged against the tiles; Sq > Sk (empty rows: with 300 vs 100
# whole query tiles are skipped, and their NaN dmb reaches dK); Sq < Sk;
# Sq = 1; non-causal with Sk < Sq; 300 queries against 4096 keys, causal and
# not; every case with a nonzero lse cotangent
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 20, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,sk,causal", [
    (77, 130, True), (77, 130, False), (150, 70, True), (300, 100, True), (1, 200, True),
    (64, 64, True), (100, 37, False), (300, 4096, True), (300, 4096, False)])
def test_flash_bwd_kernels_match_plain_on_card(card, d, dtype, sq, sk, causal):
    cs = _smoke_module()
    q, k, v = _flash_case(card, 2, 3, sq, sk, d, dtype, seed=d + sq + 1)
    out, lse = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator().manual_seed(sq + sk)
    dout = torch.randn(q.shape, generator=g).to(card, dtype)
    dlse = torch.randn(lse.shape, generator=g).to(card)
    dmb = tk._dmb(out, dout, dlse)
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dtype, 0.0)
    before = dict(tk.launches)
    cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=step)
    assert tk.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert tk.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    dk, dv = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
    dq = tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal)
    again = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal) + (
        tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal),)
    for a, b in zip((dk, dv, dq), again):  # no atomics: bitwise repeatable
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    if causal and sq > sk:
        assert bool(torch.isnan(dq[:, :, :sq - sk]).all()) and bool(torch.isnan(dk).all())
        assert not bool(torch.isnan(dv).any())


@pytest.mark.cuda
def test_flash_routes_by_dtype_on_card(card):
    # every dtype reaches the tensor-core kernels and nothing else; float32
    # after its split passes (the forward's one, and one each for the two
    # backward wrappers)
    from torch.profiler import ProfilerActivity, profile

    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        q, k, v = _flash_case(card, 1, 2, 130, 130, 64, dtype, seed=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
            dmb = tk._dmb(out, q, None)
            tk.flash_bwd_dkv(q, k, v, q, lse, dmb, causal=True)
            tk.flash_bwd_dq(q, k, v, q, lse, dmb, causal=True)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        per = sum("flash_fwd_sm90_kernel" in n for n in names)  # events per launch
        assert per >= 1, names
        for kernel in ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"):
            assert sum(kernel in n for n in names) == per, (kernel, names)
        flash = [n for n in names if "flash_" in n]
        assert all("_sm90_kernel" in n for n in flash), flash
        # one split launch per float32 input: the forward's q, k, v, and q,
        # k, v, dout for each backward wrapper
        splits = sum("split_planes_kernel" in n for n in names)
        assert splits == (3 + 4 + 4) * per * (dtype == torch.float32), (dtype, names)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_f32_backward_splits_once_on_card(card, d):
    # flash_attention's float32 backward splits q, k, v and dout once: the
    # dK/dV launch writes the planes and the dQ launch reads them, so it
    # runs half the split-pass launches of the two wrappers, each of which
    # splits for itself; its gradients are bitwise theirs
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _flash_case(card, 1, 3, 200, 260, d, torch.float32, seed=d)
    g = torch.Generator().manual_seed(d + 1)
    dout = torch.randn(q.shape, generator=g).to(card)
    dlse = torch.randn(q.shape[:3], generator=g).to(card)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v), (dout, dlse))
        torch.cuda.synchronize()
    qd, kd, vd, od, ld = (t.detach() for t in (q, k, v, out, lse))
    dmb = tk._dmb(od, dout, dlse)
    with profile(activities=[ProfilerActivity.CUDA]) as prof2:
        want_dk, want_dv = tk.flash_bwd_dkv(qd, kd, vd, dout, ld, dmb, causal=True)
        want_dq = tk.flash_bwd_dq(qd, kd, vd, dout, ld, dmb, causal=True)
        torch.cuda.synchronize()
    once, twice = (sum("split_planes_kernel" in e.name for e in p.events()) for p in (prof, prof2))
    assert once > 0 and twice == 2 * once, (once, twice)
    for a, b in zip((dq, dk, dv), (want_dq, want_dk, want_dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_f32_dp128_bitwise_repeatable_on_card(card, causal):
    # the float32 kernels at head dim 128 (dK/dV: 32-row query tiles; dQ:
    # 32-key tiles in a ring of 3), over streams that wrap their rings many
    # times: no atomics, so dK, dV and dQ repeat bitwise, within
    # check_flash_bwd of the plain versions
    cs = _smoke_module()
    q, k, v = _flash_case(card, 1, 4, 1000, 2100, 128, torch.float32, seed=6)
    out, lse = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator().manual_seed(7)
    dout = torch.randn(q.shape, generator=g).to(card)
    dmb = tk._dmb(out, dout, torch.randn(lse.shape, generator=g).to(card))
    first = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal) + (
        tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal),)
    for _ in range(3):
        again = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal) + (
            tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal),)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal,
                       got=(first[2], first[0], first[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dkv_bitwise_repeatable_on_card(card, causal):
    # one block owns each key tile and writes it once: no atomics, so dK and
    # dV repeat bitwise, here over a query stream that wraps the ring ~50 times
    q, k, v = _flash_case(card, 2, 4, 1600, 4096, 64, torch.bfloat16, seed=4)
    out, lse = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(card, q.dtype)
    dmb = tk._dmb(out, dout, None)
    first = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
    for _ in range(3):
        again = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    again = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


# The bf16 dQ kernel (csrc/flash_bwd_dq_sm90.cu) alone, against its plain
# version: head dims 40 (80-byte rows, which TMA cannot address: plain
# loads), 64 and 128 (DP 64 and 128); Sq < Sk and Sq > Sk at lengths that
# are no multiple of any tile (with 333 queries against 200 keys, causal,
# rows 0-132 see no key and the whole first query tile is skipped: their NaN
# dmb must reach their dQ, and only theirs), causal and not, a nonzero lse
# cotangent; under the causal mask an infinite dmb on row 5, whose masked
# keys make its dQ NaN (0 x dmb); and two runs bitwise equal.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [
    (200, 333, True), (333, 200, True), (200, 333, False), (333, 200, False)])
def test_flash_bwd_dq_sm90_matches_plain_on_card(card, d, sq, sk, causal):
    cs = _smoke_module()
    q, k, v = _flash_case(card, 2, 3, sq, sk, d, torch.bfloat16, seed=d * sq + sk)
    out, lse = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator().manual_seed(d + sq)
    dout = torch.randn(q.shape, generator=g).to(card, torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=g).to(card)
    dmb = tk._dmb(out, dout, dlse)
    if causal:
        dmb[:, :, 5] = float("inf")
    before = tk.launches["flash_bwd_dq"]
    dq = tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal)
    assert tk.launches["flash_bwd_dq"] == before + 1
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=causal)
    cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=2.0 ** -7,
                       got=(dq, dk, dv))
    assert torch.equal(tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal).view(torch.int16),
                       dq.view(torch.int16))  # no atomics: bitwise repeatable
    # NaN rows, whole: those that see no key (causal, Sq > Sk) and row 5
    want_nan = torch.zeros(sq, dtype=torch.bool, device=card)
    if causal:
        want_nan[:max(sq - sk, 0)] = True
        want_nan[5] = True
    assert torch.equal(torch.isnan(dq).all(dim=-1), want_nan.expand(dq.shape[:3]))
    assert torch.equal(torch.isnan(dq).any(dim=-1), want_nan.expand(dq.shape[:3]))


# The float16 dQ (csrc/flash_bwd_dq_sm90.cu, float16 instantiation: dS scaled
# by a running power-of-two exponent per query row) at chip_smoke.py phase
# 4's stress inputs, (1, 16, 1024, 64) causal with a nonzero lse cotangent:
# gradients of σ 2^-14, whose dS lies in float16's subnormals unscaled, and v
# and dO of σ 128, whose dS passes float16's 65,504 while dQ stays inside it;
# within check_flash_bwd of the plain version and bitwise repeatable.
@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [(1.0, 1.0, 2.0 ** -14), (1.0, 128.0, 128.0)])
def test_flash_bwd_dq_f16_small_grad_and_large_ds_on_card(card, sigma):
    cs = _smoke_module()
    s_qk, s_v, s_do = sigma
    g = torch.Generator().manual_seed(21)
    q, k = ((torch.randn(1, 16, 1024, 64, generator=g) * s_qk).to(card, torch.float16)
            for _ in range(2))
    v = (torch.randn(1, 16, 1024, 64, generator=g) * s_v).to(card, torch.float16)
    out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    dout = (torch.randn(q.shape, generator=g) * s_do).to(card, torch.float16)
    dmb = tk._dmb(out, dout, (torch.randn(lse.shape, generator=g) * s_do).to(card))
    before = tk.launches["flash_bwd_dq"]
    dq = tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=True)
    assert tk.launches["flash_bwd_dq"] == before + 1
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=True)
    cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=2.0 ** -10,
                       got=(dq, dk, dv))
    assert torch.equal(tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=True).view(torch.int16),
                       dq.view(torch.int16))
    assert bool(torch.isfinite(dq).all())
    ds = tk._bwd_dense(q, k, v, dout, lse, dmb, 1.0 / 8, True)[4]
    if s_v > 1.0:
        assert float(ds.abs().max()) > torch.finfo(torch.float16).max
    else:  # nearly every visible dS lies among float16's subnormals
        vis = torch.ones(1024, 1024, dtype=torch.bool, device=card).tril()
        below = ds[..., vis].abs() < torch.finfo(torch.float16).tiny
        assert float(below.float().mean()) > 0.99


# The float32 forward (csrc/flash_fwd_sm90.cu, float32 instantiation, six
# passes a product) on rows that see one key each, whose lse is that one
# score: 16,384 rows at head dim 16, where five passes are refused, and
# 1,024 at head dim 64, where four are (tests/test_torch_sm90_precision.py);
# within check_flash and bitwise repeatable, one launch a call.
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,seed", [(1024, 16, 1), (64, 64, 0)])
def test_flash_f32_forward_single_key_rows_on_card(card, b, d, seed):
    cs = _smoke_module()
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, 16, 1, d, generator=g).to(card) for _ in range(3))
    before = tk.launches["flash_attention"]
    got = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    assert tk.launches["flash_attention"] == before + 1
    cs.check_flash(torch, tk, q, k, v, causal=True, got=got)
    again = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def _on_stream_cases(dev):
    """Per wrapper: a function of its first input, that input's values, and
    the rest of its inputs on ``dev``."""
    g = torch.Generator().manual_seed(11)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    q, k, v, dout = (randn(1, 2, 130, 64, dtype=torch.bfloat16) for _ in range(4))
    out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    dmb = tk._dmb(out, dout, None)
    y, c = randn(77, 18), randn(8, 18)
    return {
        "probe": (tk.probe, randn(8, 128), ()),
        "cdist_tile": (tk.cdist_tile, randn(300, 18), (y,)),
        "kmeans_step": (lambda x, cc: tk.kmeans_step(x, cc), randn(300, 18), (c,)),
        "flash_attention": (lambda qq, kk, vv: tk.flash_attention(qq, kk, vv, causal=True), q,
                            (k, v)),
        "flash_bwd_dkv": (lambda qq, *r: tk.flash_bwd_dkv(qq, *r, causal=True), q,
                          (k, v, dout, lse, dmb)),
        "flash_bwd_dq": (lambda qq, *r: tk.flash_bwd_dq(qq, *r, causal=True), q,
                         (k, v, dout, lse, dmb)),
    }


def _flat(res):
    return res if isinstance(res, tuple) else (res,)


@pytest.mark.cuda
def test_wrappers_launch_on_the_callers_stream_and_device(card):
    # Each wrapper runs on a side stream behind a ~10 ms sleep that holds
    # that stream, after its first input was filled in on the same stream:
    # a launch that landed anywhere but the caller's stream would run at
    # once and read the input's zeros.
    dev0 = torch.device("cuda", torch.cuda.current_device())
    for name, (fn, first, rest) in _on_stream_cases(dev0).items():
        want = _flat(fn(first, *rest))
        x = torch.zeros_like(first)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        before = tk.launches[name]
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            x.copy_(first)
            got = _flat(fn(x, *rest))
        side.synchronize()
        assert tk.launches[name] > before, name
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)
    # Where the host has a second card, tensors there launch there while
    # the first stays current: each entry point switches to its tensors'
    # device and back.
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1 - dev0.index)
        for name, (fn, first, rest) in _on_stream_cases(other).items():
            with torch.cuda.device(other):
                want = _flat(fn(first, *rest))
            got = _flat(fn(first, *rest))
            assert torch.cuda.current_device() == dev0.index, name
            for a, b in zip(got, want):
                assert a.device == other, name
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


@pytest.mark.cuda
def test_flash_refused_launch_raises_on_card(card):
    # a launch the C side refuses (here a head dim past 128, which the
    # wrappers never pass on) returns its CUDA error, and the launch path
    # shared by the wrappers raises it instead of running anything else
    q = torch.zeros(1, 1, 8, 136, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8, device=card)
    before = dict(tk.launches)
    with pytest.raises(RuntimeError, match="flash_attention launch failed: CUDA error"):
        tk._launch("flash_attention", q.get_device(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                   q.data_ptr(), lse.data_ptr(), None, 1, 8, 8, 136, 2, 0.1, 1)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv launch failed: CUDA error"):
        tk._launch("flash_bwd_dkv", q.get_device(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                   q.data_ptr(), lse.data_ptr(), lse.data_ptr(), q.data_ptr(), q.data_ptr(), None,
                   1, 1, 8, 8, 136, 2, 0.1, 1)
    with pytest.raises(RuntimeError, match="flash_bwd_dq launch failed: CUDA error"):
        tk._launch("flash_bwd_dq", q.get_device(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                   q.data_ptr(), lse.data_ptr(), lse.data_ptr(), q.data_ptr(), None, 1, 1, 8, 8,
                   136, 2, 0.1, 1)
    assert tk.launches == before  # a refused launch is not counted
    torch.cuda.synchronize()
