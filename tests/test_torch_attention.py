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
    meta = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention(meta, meta, meta)
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
