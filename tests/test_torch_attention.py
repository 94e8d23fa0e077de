"""heat_tpu_torch's attention against heat_tpu's, on the same numpy inputs.

``flash_attention_plain`` (what the port's wrapper runs for CPU tensors) is
held against heat_tpu's Pallas ``flash_attention`` in interpret mode, and
``local_attention``, ``_block_attn``, ``_fold`` and the size-1
``_ring_body`` against heat_tpu's (dense, and the ring's flash branch under
``set_pallas(True)``).

Tolerances: float32 rtol 1e-5 and float64 rtol 1e-12, each on
``|out| + max|v|`` for the output (an attention output is a convex
combination of V's rows, so max|v| is its scale) and on ``1 + |lse|`` for
the log-sum-exp; bfloat16 outputs may differ by one bf16 rounding (2^-7 of
|out|) on top, since both sides round their float32 result once. The lse is
float32 for every input dtype, as in heat_tpu.

The backward: ``flash_attention_bwd_plain`` and the per-kernel plain
versions ``flash_bwd_dkv_plain``/``flash_bwd_dq_plain`` against heat_tpu's
Pallas ``_flash_bwd_impl`` (interpret mode) and its dense fallback
(``_flash_diff_bwd``), with a nonzero lse cotangent, at rtol = atol = 2e-4
as heat_tpu's own kernel-vs-dense test (``test_pallas.py:379-392``): the
probabilities are recomputed from a float32 lse on both sides, and the
gradients sum O(S) such terms; a bfloat16 case within one bf16 rounding of
|g| plus 1e-5 of max|g|; the NaN positions of empty rows at Sq > Sk; and
``torch.autograd.grad`` through ``flash_attention(return_lse=True)`` against
``jax.grad`` of heat_tpu's ``_flash_diff``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import pallas_kernels as pk  # noqa: E402
from heat_tpu.nn import attention as jattn  # noqa: E402

from heat_tpu_torch.core import kernels as tk  # noqa: E402
from heat_tpu_torch.nn import attention as tattn  # noqa: E402

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
BF16_STEP = 2.0 ** -7


def _qkv(shape_q, sk, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    b, h, sq, d = shape_q
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, h, sk, d)).astype(dtype)
    v = rng.standard_normal((b, h, sk, d)).astype(dtype)
    return q, k, v


def _close_attention(got_out, got_lse, want_out, want_lse, vmax, rtol, out_step=0.0):
    """Output within rtol * (|out| + max|v|) (plus ``out_step`` of |out|),
    lse within rtol * (1 + |lse|); NaN and -inf at identical positions."""
    got_out, want_out = np.asarray(got_out, np.float64), np.asarray(want_out, np.float64)
    nan = np.isnan(want_out)
    np.testing.assert_array_equal(np.isnan(got_out), nan)
    lim = rtol * (np.abs(want_out) + vmax) + out_step * np.abs(want_out)
    assert (np.abs(got_out - want_out)[~nan] <= lim[~nan]).all(), \
        float(np.nanmax(np.abs(got_out - want_out) / lim))
    if got_lse is not None:
        got_lse, want_lse = np.asarray(got_lse, np.float64), np.asarray(want_lse, np.float64)
        inf = np.isneginf(want_lse)
        np.testing.assert_array_equal(np.isneginf(got_lse), inf)
        lse_tol = max(rtol, 1e-6)  # the lse is float32 even for float64 input
        g, w = got_lse[~inf], want_lse[~inf]
        assert (np.abs(g - w) <= lse_tol * (1 + np.abs(w))).all()


@pytest.mark.parametrize("dtype,causal,sq", [
    (np.float32, False, 77), (np.float32, True, 77), (np.float64, True, 77),
    (np.float32, True, 150)])  # Sq > Sk: the first 20 rows see no key
def test_flash_plain_matches_pallas(dtype, causal, sq):
    q, k, v = _qkv((2, 3, sq, 16), 130, dtype)
    want_out, want_lse = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal, return_lse=True)
    got_out, got_lse = tk.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                                torch.from_numpy(v), causal=causal,
                                                return_lse=True)
    assert got_out.dtype == torch.from_numpy(q).dtype and got_lse.dtype == torch.float32
    assert np.asarray(want_lse).dtype == np.float32
    _close_attention(got_out.numpy(), got_lse.numpy(), want_out, want_lse,
                     np.abs(v).max(), RTOL[dtype])
    if sq > 130:
        assert np.isnan(got_out.numpy()[:, :, :20]).all()
        assert np.isneginf(got_lse.numpy()[:, :, :20]).all()
        assert not np.isnan(got_out.numpy()[:, :, 20:]).any()


def test_flash_plain_matches_pallas_bf16():
    q, k, v = _qkv((2, 3, 77, 16), 130, np.float32, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_out, want_lse = pk.flash_attention(jq, jk, jv, causal=True, return_lse=True)
    tq, tk_, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got_out, got_lse = tk.flash_attention(tq, tk_, tv, causal=True, return_lse=True)
    assert got_out.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    _close_attention(got_out.float().numpy(), got_lse.numpy(),
                     np.asarray(want_out.astype(jnp.float32)), want_lse,
                     float(tv.float().abs().max()), RTOL[np.float32], out_step=BF16_STEP)


def test_flash_wrapper_on_cpu_and_its_refusals():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 9, 8), 9))
    tk.reset_launches()
    out = tk.flash_attention(q, k, v)
    assert torch.equal(out, tk.flash_attention_plain(q, k, v))
    # the card ignores the tile sizes; so does the plain version
    assert torch.equal(tk.flash_attention(q, k, v, block_q=100, block_k=100), out)
    assert torch.equal(tk.flash_attention(q, k, v, scale=1 / math.sqrt(8)), out)
    assert tk.launches["flash_attention"] == 0
    # data-free tensors (a step trace's) take the plain version: shapes only
    meta = torch.empty(1, 2, 9, 8, device="meta")
    got = tk.flash_attention(meta, meta, meta)
    assert got.is_meta and got.shape == (1, 2, 9, 8) and tk.launches["flash_attention"] == 0
    with pytest.raises(ValueError, match="4-D"):
        tk.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="one floating dtype"):
        tk.flash_attention(q, k.double(), v)
    # no key at all: every row is empty, as dense softmax over nothing
    out, lse = tk.flash_attention(q, k[:, :, :0], v[:, :, :0], return_lse=True)
    assert torch.isnan(out).all() and torch.isneginf(lse).all()
    assert torch.equal(tk.probe(torch.zeros(8, 128)), torch.ones(8, 128))
    assert tk.launches["probe"] == 0


@pytest.mark.parametrize("ndim,causal", [(4, True), (4, False), (3, True)])
def test_local_attention_matches_jax(ndim, causal):
    q, k, v = _qkv((2, 3, 20, 8), 20, seed=2)
    if ndim == 3:
        q, k, v = q[0], k[0], v[0]
    want = np.asarray(jattn.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal))
    got = tattn.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()
    _close_attention(got, None, want, None, np.abs(v).max(), RTOL[np.float32])


def test_block_attn_and_fold_match_jax():
    q, k, v = _qkv((1, 2, 24, 8), 40, seed=3)
    want = jattn._block_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, True)
    got = tattn._block_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            0.3, True)
    _close_attention(got[0].numpy(), got[1].numpy(), want[0], want[1], np.abs(v).max(),
                     RTOL[np.float32])
    rng = np.random.default_rng(4)
    acc, out_i = (rng.standard_normal((1, 2, 24, 8)).astype(np.float32) for _ in range(2))
    lse, lse_i = (rng.standard_normal((1, 2, 24)).astype(np.float32) for _ in range(2))
    lse[0, 0, :5] = -np.inf  # an empty running state
    lse_i[0, 1, :7] = -np.inf  # an empty piece: a no-op
    w_acc, w_lse = jattn._fold(*(jnp.asarray(a) for a in (acc, lse, out_i, lse_i)))
    g_acc, g_lse = tattn._fold(*(torch.from_numpy(a) for a in (acc, lse, out_i, lse_i)))
    np.testing.assert_allclose(g_acc.numpy(), w_acc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_lse.numpy(), w_lse, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g_acc.numpy()[0, 1, :7], acc[0, 1, :7])


@pytest.mark.parametrize("pallas", [False, True])
def test_ring_body_at_size_one_matches_jax(pallas):
    # (B, S, H, D) blocks; one sp device: the ring is one (flash) step
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 33, 4, 8)).astype(np.float32) for _ in range(3))
    grid = hj.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"), devices=jax.devices()[:1])
    pk.set_pallas(pallas)
    try:
        want = np.asarray(hj.nn.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), comm=grid.axis("sp"),
                                               causal=True))
    finally:
        pk.set_pallas(None)
    import heat_tpu_torch as ht

    tgrid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"), device="cpu")
    got = tattn._ring_body(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           tgrid.axis("sp"), scale=1 / math.sqrt(8), causal=True)
    assert got.shape == (2, 33, 4, 8)
    _close_attention(got.numpy(), None, want, None, np.abs(v).max(), RTOL[np.float32])


# --------------------------------------------------------------------------- #
# the backward                                                                #
# --------------------------------------------------------------------------- #

BWD_TOL = 2e-4


def _bwd_case(sq, sk, causal, dtype=np.float32, seed=0, d=16):
    """Forward residuals from heat_tpu's flash forward and numpy cotangents:
    (q, k, v, out, lse, dout, dlse) as numpy arrays."""
    q, k, v = _qkv((1, 2, sq, d), sk, np.float32, seed=seed)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    out, lse = pk.flash_attention(jq, jk, jv, causal=causal, return_lse=True)
    rng = np.random.default_rng(seed + 100)
    dout = rng.standard_normal(out.shape).astype(np.float32)
    dlse = rng.standard_normal(lse.shape).astype(np.float32)
    return jq, jk, jv, out, lse, jnp.asarray(dout, dtype), jnp.asarray(dlse)


def _t(a):
    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)
    return torch.from_numpy(np.array(a))


def _jax_bwd(case, causal, pallas):
    q, k, v, out, lse, dout, dlse = case
    scale = 1.0 / math.sqrt(q.shape[-1])
    if pallas:
        return pk._flash_bwd_impl(q, k, v, out, lse, dout, dlse, scale, causal, 128, 128)
    pk.set_pallas(False)
    try:
        return pk._flash_diff_bwd(scale, causal, 128, 128, (q, k, v, out, lse), (dout, dlse))
    finally:
        pk.set_pallas(None)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(192, 192), (100, 260)])
def test_flash_bwd_plain_matches_pallas_and_dense(sq, sk, causal):
    case = _bwd_case(sq, sk, causal)
    q, k, v, out, lse, dout, dlse = (_t(a) for a in case)
    scale = 1.0 / math.sqrt(16)
    got = tk.flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse, scale, causal)
    pallas = _jax_bwd(case, causal, pallas=True)
    dense = _jax_bwd(case, causal, pallas=False)
    for g, w_p, w_d in zip(got, pallas, dense):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_p), rtol=BWD_TOL, atol=BWD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_d), rtol=BWD_TOL, atol=BWD_TOL)
    # each kernel's plain version, fed dmb = dlse - rowsum(dout * out) as the
    # kernels are, against the Pallas kernel of the same output
    dmb = dlse - (dout * out).sum(-1)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, scale, causal)
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, scale, causal)
    for g, w in zip((dq, dk, dv), pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_TOL, atol=BWD_TOL)
    # the wrappers take the plain versions for CPU tensors and launch nothing
    tk.reset_launches()
    wk, wv = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, scale, causal)
    assert torch.equal(wk, dk) and torch.equal(wv, dv)
    assert torch.equal(tk.flash_bwd_dq(q, k, v, dout, lse, dmb, scale, causal), dq)
    assert tk.launches["flash_bwd_dkv"] == tk.launches["flash_bwd_dq"] == 0


def test_flash_bwd_plain_matches_jax_bf16():
    case = _bwd_case(128, 128, True, dtype=jnp.bfloat16, seed=1, d=32)
    q, k, v, out, lse, dout, dlse = (_t(a).bfloat16() if a.dtype == jnp.bfloat16 else _t(a)
                                     for a in case)
    got = tk.flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse, causal=True)
    want = _jax_bwd(case, True, pallas=False)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        lim = BF16_STEP * np.abs(w) + RTOL[np.float32] * np.abs(w).max()
        assert (np.abs(g - w) <= lim).all(), float((np.abs(g - w) / lim).max())


def test_flash_bwd_empty_rows_nan_where_jax_is():
    # causal Sq > Sk: the first 40 rows see no key, their output is NaN, so
    # their dmb is NaN and the dense math spreads it to every dK
    case = _bwd_case(100, 60, True, seed=2)
    q, k, v, out, lse, dout, dlse = (_t(a) for a in case)
    got = tk.flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse, causal=True)
    for want in (_jax_bwd(case, True, pallas=True), _jax_bwd(case, True, pallas=False)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w))
            np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL, atol=BWD_TOL)
    dq, dk, dv = (g.numpy() for g in got)
    assert np.isnan(dq[:, :, :40]).all() and not np.isnan(dq[:, :, 40:]).any()
    assert np.isnan(dk).all() and not np.isnan(dv).any()


@pytest.mark.parametrize("pallas", [False, True])
def test_flash_autograd_matches_jax_grad(pallas):
    q, k, v = _qkv((1, 2, 77, 16), 130, seed=6)
    w = np.random.default_rng(7).standard_normal((1, 2, 77)).astype(np.float32)
    scale = 1.0 / math.sqrt(16)

    def f(q, k, v):
        out, lse = pk._flash_diff(q, k, v, scale, True, 128, 128)
        return (out ** 2).sum() + (lse * jnp.asarray(w)).sum()

    pk.set_pallas(pallas)
    try:
        want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    finally:
        pk.set_pallas(None)
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = tk.flash_attention(tq, tk_, tv, scale=scale, causal=True, return_lse=True)
    loss = (out ** 2).sum() + (lse * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk_, tv))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=BWD_TOL, atol=BWD_TOL)
    # the output alone (no lse cotangent) takes the same backward
    out = tk.flash_attention(tq, tk_, tv, scale=scale, causal=True)
    g_out = torch.autograd.grad((out ** 2).sum(), tq)[0]
    lse_d = tk.flash_attention_plain(*(t.detach() for t in (tq, tk_, tv)), scale, True,
                                     return_lse=True)
    want_q = tk.flash_attention_bwd_plain(tq.detach(), tk_.detach(), tv.detach(), lse_d[0],
                                          lse_d[1], 2 * lse_d[0], None, scale, True)[0]
    assert torch.equal(g_out, want_q)
