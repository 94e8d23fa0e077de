"""The precision rule of the bf16 tensor-core flash kernels, on the CPU.

``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu`` and
``csrc/flash_bwd_dq_sm90.cu`` run every product on bf16 tensor cores with
float32 accumulation: a product of two bf16 operands takes one pass (the
products are exact in float32), and a product with a float32 operand (the
probabilities P, the score cotangents dS) splits that operand exactly into
three bf16 terms and takes three passes into one float32 accumulator,
smallest term first. The card cannot be reached from here, so this file
emulates that arithmetic in plain PyTorch (the kernels' 64-key online
softmax in the log2 domain for the forward, the recomputed P^T and dS^T
for dK/dV, P and dS for dQ) and holds the emulation, with
``chip_smoke.check_flash`` and ``check_flash_bwd`` and their limits as they
stand, against the port's plain versions, and against heat_tpu's Pallas
kernels run in interpret mode as heat_tpu's own tests run them.
The same checks refuse a single bf16 pass of P or dS, which shows that
they guard the rule.

The float32 backward kernels (the same two files, float32 instantiations)
multiply two float32 operands: both split into their three bf16 terms, and
a product takes the largest cross terms (the pairs i + j <= 2 of the nine),
summed smallest first. Six passes are the fewest that ``check_flash_bwd``
takes at ``out_step = 0`` in every case below, the training path's length
and a single query against 200 keys included; five are refused. A float32
forward (not built yet; ``chip_smoke.flash_bound_f32`` counts its passes)
holds ``check_flash`` with four, and three are refused.

The bound of ``kmeans_step`` (``chip_smoke.kmeans_bound``) counts the
float32 scores x·c the same way: three passes a product are the fewest that
``check_kmeans_step`` takes on ``chip_smoke.py``'s data (uniform points,
centroids drawn from them) at its shapes' widths, and two are refused.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from heat_tpu.core import pallas_kernels as pk  # noqa: E402

from heat_tpu_torch.core import kernels as tk  # noqa: E402

BF16_STEP = 2.0 ** -7
LOG2E = 1.4426950408889634
BK = 64  # keys per tile of the forward kernel
NEG_BIG = -1e30


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def split3(x):
    """The kernels' split of a float32 tensor into three bf16 terms (as
    float32): x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2)."""
    x1 = x.bfloat16().float()
    r = x - x1
    x2 = r.bfloat16().float()
    return x1, x2, (r - x2).bfloat16().float()


# the cross terms of two float32 operands, each split into its three split3
# terms (0 the largest), largest first
F32_TERMS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, 2), (2, 1), (2, 2))
F32_BWD_PASSES = 6  # the float32 backward kernels' passes a product
F32_FWD_PASSES = 4  # what a float32 forward needs (chip_smoke.F32_PASSES_FWD)


def _split_product(a, b, passes, split_b=False):
    """a @ b with the float32 ``a`` split into bf16 terms and ``b`` bf16:
    three passes, smallest term first, or one pass of bf16(a). With
    ``split_b`` both float32 operands split into three terms, and the
    ``passes`` largest cross terms (:data:`F32_TERMS`) are summed smallest
    first: six passes are 2·0 + 0·2 + 1·1 + 1·0 + 0·1 + 0·0, the kernels'
    order (``csrc/sm90_common.cuh`` ``pass_a``/``pass_b``)."""
    if split_b:
        terms = (split3(a), split3(b))
        out = None
        for i, j in reversed(F32_TERMS[:passes]):
            t = terms[0][i] @ terms[1][j]
            out = t if out is None else out + t
        return out
    if passes == 1:
        return a.bfloat16().float() @ b
    x1, x2, x3 = split3(a)
    return x3 @ b + x2 @ b + x1 @ b


def emulate_fwd(q, k, v, causal, passes=3, split_b=False):
    """The forward kernel's arithmetic on (B, H, S, D) bf16 tensors: S = Q Kᵀ
    from bf16 operands in float32, times scale·log2(e); per 64-key tile the
    running max and sum in the log2 domain, masked scores at -1e30 with
    their probabilities zeroed, the output rescaled and P·V added in
    ``passes`` bf16 passes of P; out in bf16, lse in float32. With
    ``split_b`` (float32 inputs) S and P·V both take ``passes`` passes of
    two split float32 operands, the rule that bounds a float32 forward."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale_log2 = np.float32(1.0 / math.sqrt(D) * LOG2E)
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), NEG_BIG)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, BK):
        cols = torch.arange(k0, min(k0 + BK, Sk))[None, :]
        kt = kf[:, :, k0:k0 + BK].transpose(-1, -2)
        s2 = (_split_product(qf, kt, passes, split_b=True) if split_b else qf @ kt) * float(
            scale_log2)
        ok = (cols <= rows + (Sk - Sq)) if causal else torch.ones_like(cols <= rows)
        s2 = torch.where(ok, s2, torch.full((), NEG_BIG))
        m_new = torch.maximum(m, s2.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s2 - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_product(p, vf[:, :, k0:k0 + BK], passes, split_b)
        m = m_new
    empty = l == 0
    out = torch.where(empty, torch.full((), float("nan")), o / torch.where(empty, 1.0, l))
    lse = torch.where(empty, torch.full((), float("-inf")),
                      m * math.log(2.0) + torch.log(torch.where(empty, 1.0, l)))
    return out.to(q.dtype), lse[..., 0]


def emulate_dkv(q, k, v, dout, lse, dmb, causal, passes=3):
    """The dK/dV kernel's arithmetic: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ from bf16
    operands, Pᵀ = exp2(scale·log2(e)·Sᵀ − lse·log2(e)) (one fused
    multiply-add) where the pair is
    visible and the lse finite, dSᵀ = Pᵀ ∘ (dPᵀ + dmb), then dV = Pᵀ dO and
    dK = scale · dSᵀ Q with Pᵀ and dSᵀ split into bf16 terms."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = q.float(), k.float(), v.float(), dout.float()
    st = kf @ qf.transpose(-1, -2)
    dpt = vf @ of.transpose(-1, -2)
    ls = (lse * np.float32(LOG2E))[..., None, :]
    ok = torch.isfinite(ls)
    if causal:
        keys = torch.arange(Sk)[:, None]
        ok = ok & (keys <= torch.arange(Sq)[None, :] + (Sk - Sq))
    # one rounding of s·c − lse, as the kernel's fused multiply-add (exact in
    # float64: s·c has at most 48 significant bits)
    c = float(np.float32(scale * LOG2E))
    arg = (st.double() * c - ls.double()).float()
    pt = torch.where(ok, torch.exp2(arg), torch.zeros(()))
    dst = pt * (dpt + dmb[..., None, :])
    dv = _split_product(pt, of, passes)
    dk = _split_product(dst, qf, passes) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate_dq(q, k, v, dout, lse, dmb, causal, passes=3):
    """The dQ kernel's arithmetic: S = Q Kᵀ and dP = dO Vᵀ from bf16
    operands, P = exp2(scale·log2(e)·S − lse·log2(e)) (one fused multiply-add)
    where the pair is visible and the lse finite, dS = P ∘ (dP + dmb) (zero
    past the keys only: a masked pair's 0 × a non-finite dmb stays NaN), then
    dQ = scale · dS K with dS split into bf16 terms."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = q.float(), k.float(), v.float(), dout.float()
    s = qf @ kf.transpose(-1, -2)
    dp = of @ vf.transpose(-1, -2)
    ls = (lse * np.float32(LOG2E))[..., None]
    ok = torch.isfinite(ls)
    if causal:
        ok = ok & (torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + (Sk - Sq))
    c = float(np.float32(scale * LOG2E))
    arg = (s.double() * c - ls.double()).float()
    p = torch.where(ok, torch.exp2(arg), torch.zeros(()))
    ds = p * (dp + dmb[..., None])
    return (_split_product(ds, kf, passes) * scale).to(q.dtype)


def _case(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk, sq))
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32)
    return q, k, v, dout, dlse


# causal ragged against the 64-key tiles, causal Sq > Sk (the first 20 rows
# see no key), non-causal
CASES = [(1, 2, 77, 130, 64, True), (1, 2, 150, 130, 32, True), (1, 2, 96, 70, 64, False)]


def test_split3_is_exact():
    rng = np.random.default_rng(0)
    e = rng.uniform(-100, 0, 200_000)
    x = torch.from_numpy((2.0 ** e * rng.uniform(1, 2, e.size)).clip(2.0 ** -100, 1.0)
                         .astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, 2.0 ** -100, 1 - 2.0 ** -24, 0.333333343267])])
    x1, x2, x3 = split3(x)
    assert torch.equal(x1.double() + x2.double() + x3.double(), x.double())
    # each term holds 8 significant bits: x1 alone is not exact
    assert not torch.equal(x1, x)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_sm90_forward_arithmetic_passes_check_flash(b, h, sq, sk, d, causal):
    cs = _smoke()
    q, k, v, _, _ = (torch.from_numpy(a).bfloat16() for a in _case(b, h, sq, sk, d, seed=sq))
    got = emulate_fwd(q, k, v, causal)
    assert cs.check_flash(torch, tk, q, k, v, causal, out_step=BF16_STEP, got=got)[1] <= 1.0
    if causal and sq > sk:
        assert bool(torch.isnan(got[0][:, :, :sq - sk]).all())
        assert bool(torch.isneginf(got[1][:, :, :sq - sk]).all())
    # against heat_tpu's Pallas forward (interpret mode on the CPU), with
    # check_flash's rule: both round a float32 result to bf16 once
    jo, jl = pk.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                                causal=causal, return_lse=True)
    jo = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    jl = torch.from_numpy(np.array(jl))
    assert cs.check_flash(torch, tk, q, k, v, causal, out_step=BF16_STEP,
                          got=(jo.bfloat16(), jl))[1] <= 1.0
    nan = torch.isnan(jo)
    assert torch.equal(torch.isnan(got[0]), nan)
    vmax = float(v.float().abs().max())
    err = (got[0].float() - jo).abs()[~nan]
    lim = (1e-5 * vmax + (2e-5 + 2 * BF16_STEP) * jo.abs())[~nan]
    assert bool((err <= lim).all()), float((err / lim).max())
    fin = torch.isfinite(jl)
    assert torch.equal(torch.isfinite(got[1]), fin)
    assert bool(((got[1] - jl).abs()[fin] <= 2e-5 * (1 + jl.abs()[fin])).all())


def _card_inputs(sq, sk, d, seed):
    """The card tests' flash inputs (``tests/test_torch_kernels.py``
    ``_flash_case``): two batches of three heads from a seeded torch
    generator."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(2, 3, s, d, generator=g) for s in (sq, sk, sk))


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES + [(1, 2, 77, 130, 128, True)])
def test_f32_forward_four_passes_pass_check_flash(b, h, sq, sk, d, causal):
    # a float32 forward on the tensor cores (chip_smoke.flash_bound_f32's
    # rule): four passes of S and of P·V pass check_flash
    cs = _smoke()
    q, k, v, _, _ = (torch.from_numpy(a) for a in _case(b, h, sq, sk, d, seed=sq + 9))
    got = emulate_fwd(q, k, v, causal, passes=F32_FWD_PASSES, split_b=True)
    assert cs.check_flash(torch, tk, q, k, v, causal, got=got)[1] <= 1.0


def test_check_flash_refuses_one_f32_forward_pass_fewer():
    # the card tests' causal 150 x 70 case at head dim 128: four passes
    # hold, three are refused
    cs = _smoke()
    q, k, v = _card_inputs(150, 70, 128, seed=128 + 150 + 1)
    got = emulate_fwd(q, k, v, True, passes=F32_FWD_PASSES, split_b=True)
    assert cs.check_flash(torch, tk, q, k, v, True, got=got)[1] <= 1.0
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash(torch, tk, q, k, v, True,
                       got=emulate_fwd(q, k, v, True, passes=F32_FWD_PASSES - 1, split_b=True))


def test_check_flash_refuses_one_bf16_pass_of_p():
    cs = _smoke()
    q, k, v, _, _ = (torch.from_numpy(a).bfloat16() for a in _case(1, 2, 77, 130, 64, seed=77))
    assert cs.check_flash(torch, tk, q, k, v, True, out_step=BF16_STEP,
                          got=emulate_fwd(q, k, v, True, passes=3))[1] <= 1.0
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash(torch, tk, q, k, v, True, out_step=BF16_STEP,
                       got=emulate_fwd(q, k, v, True, passes=1))


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_sm90_dkv_arithmetic_passes_check_flash_bwd(b, h, sq, sk, d, causal):
    cs = _smoke()
    qn, kn, vn, don, dlse = _case(b, h, sq, sk, d, seed=sq + 1)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    dk, dv = emulate_dkv(q, k, v, dout, lse, dmb, causal)
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=BF16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values())
    if causal and sq > sk:
        assert bool(torch.isnan(dk).all()) and not bool(torch.isnan(dv).any())
    # against heat_tpu's Pallas dK/dV (interpret mode) on the same forward
    # outputs, within one bf16 rounding of each and 1e-5 of the largest
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn, don))
    jo, jl = pk.flash_attention(jq, jk, jv, causal=causal, return_lse=True)
    _, wk, wv = pk._flash_bwd_impl(jq, jk, jv, jo, jl, jdo, jnp.asarray(dlse),
                                   1.0 / math.sqrt(d), causal, 128, 128)
    o32 = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    lse_j = torch.from_numpy(np.array(jl))
    dk, dv = emulate_dkv(q, k, v, dout, lse_j, tk._dmb(o32, dout, torch.from_numpy(dlse)), causal)
    # (where Sq > Sk, Pallas leaves the NaN of the empty rows' dmb out of a
    # key block whose query tiles it skips; the port follows heat_tpu's dense
    # backward, which spreads it to every dK, so Pallas's NaN are a subset)
    for g, w in ((dk, wk), (dv, wv)):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        nan = np.isnan(g)
        assert not (np.isnan(w) & ~nan).any()
        if nan.all():
            continue
        lim = 2 * BF16_STEP * np.abs(w) + 1e-5 * np.abs(w[~nan]).max()
        assert (np.abs(g - w)[~nan] <= lim[~nan]).all(), float((np.abs(g - w) / lim)[~nan].max())


def test_check_flash_bwd_refuses_one_bf16_pass():
    cs = _smoke()
    qn, kn, vn, don, dlse = _case(1, 2, 77, 130, 64, seed=5)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=True)
    dk, dv = emulate_dkv(q, k, v, dout, lse, dmb, True, passes=1)
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=BF16_STEP,
                           got=(dq, dk, dv))


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_sm90_dq_arithmetic_passes_check_flash_bwd(b, h, sq, sk, d, causal):
    cs = _smoke()
    qn, kn, vn, don, dlse = _case(b, h, sq, sk, d, seed=sq + 2)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    dq = emulate_dq(q, k, v, dout, lse, dmb, causal)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=BF16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values())
    if causal and sq > sk:  # the empty rows' NaN dmb reaches their dQ, and only theirs
        assert bool(torch.isnan(dq[:, :, :sq - sk]).all())
        assert not bool(torch.isnan(dq[:, :, sq - sk:]).any())
    # against heat_tpu's Pallas dQ (interpret mode) on the same forward
    # outputs, within one bf16 rounding of each and 1e-5 of the largest
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn, don))
    jo, jl = pk.flash_attention(jq, jk, jv, causal=causal, return_lse=True)
    wq, _, _ = pk._flash_bwd_impl(jq, jk, jv, jo, jl, jdo, jnp.asarray(dlse),
                                  1.0 / math.sqrt(d), causal, 128, 128)
    o32 = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    lse_j = torch.from_numpy(np.array(jl))
    g = emulate_dq(q, k, v, dout, lse_j, tk._dmb(o32, dout, torch.from_numpy(dlse)), causal)
    g, w = g.float().numpy(), np.asarray(wq.astype(jnp.float32))
    nan = np.isnan(g)
    assert np.array_equal(np.isnan(w), nan)
    lim = 2 * BF16_STEP * np.abs(w) + 1e-5 * np.abs(w[~nan]).max()
    assert (np.abs(g - w)[~nan] <= lim[~nan]).all(), float((np.abs(g - w) / lim)[~nan].max())


def test_check_flash_bwd_refuses_one_bf16_pass_of_ds():
    cs = _smoke()
    qn, kn, vn, don, dlse = _case(1, 2, 77, 130, 64, seed=6)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=True)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=BF16_STEP,
                             got=(emulate_dq(q, k, v, dout, lse, dmb, True), dk, dv))
    assert all(r <= 1.0 for _, r in res.values())
    with pytest.raises(AssertionError, match="dq: .* beyond their tolerance"):
        cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=BF16_STEP,
                           got=(emulate_dq(q, k, v, dout, lse, dmb, True, passes=1), dk, dv))


def emulate_dkv_f32(q, k, v, dout, lse, dmb, causal, passes=F32_BWD_PASSES):
    """The float32 dK/dV kernel's arithmetic: :func:`emulate_dkv` with every
    product of two float32 operands (Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, dV = Pᵀ dO,
    dK = dSᵀ Q) in ``passes`` split-bf16 passes; float32 out."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    st = _split_product(k, q.transpose(-1, -2), passes, split_b=True)
    dpt = _split_product(v, dout.transpose(-1, -2), passes, split_b=True)
    ls = (lse * np.float32(LOG2E))[..., None, :]
    ok = torch.isfinite(ls)
    if causal:
        ok = ok & (torch.arange(Sk)[:, None] <= torch.arange(Sq)[None, :] + (Sk - Sq))
    c = float(np.float32(scale * LOG2E))
    arg = (st.double() * c - ls.double()).float()
    pt = torch.where(ok, torch.exp2(arg), torch.zeros(()))
    dst = pt * (dpt + dmb[..., None, :])
    dv = _split_product(pt, dout, passes, split_b=True)
    dk = _split_product(dst, q, passes, split_b=True) * scale
    return dk, dv


def emulate_dq_f32(q, k, v, dout, lse, dmb, causal, passes=F32_BWD_PASSES):
    """The float32 dQ kernel's arithmetic: :func:`emulate_dq` with S = Q Kᵀ,
    dP = dO Vᵀ and dQ = dS K in ``passes`` split-bf16 passes; float32 out."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = _split_product(q, k.transpose(-1, -2), passes, split_b=True)
    dp = _split_product(dout, v.transpose(-1, -2), passes, split_b=True)
    ls = (lse * np.float32(LOG2E))[..., None]
    ok = torch.isfinite(ls)
    if causal:
        ok = ok & (torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + (Sk - Sq))
    c = float(np.float32(scale * LOG2E))
    arg = (s.double() * c - ls.double()).float()
    p = torch.where(ok, torch.exp2(arg), torch.zeros(()))
    ds = p * (dp + dmb[..., None])
    return _split_product(ds, k, passes, split_b=True) * scale


def _f32_case(b, h, sq, sk, d, causal, seed):
    qn, kn, vn, don, dlse = _case(b, h, sq, sk, d, seed)
    q, k, v, dout = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    return (qn, kn, vn, don, dlse), (q, k, v, dout, lse, dmb)


# the bf16 cases, the same at head dim 128, the training path's length, and
# one query against 200 keys (each dK row then sums a single term)
F32_CASES = CASES + [(1, 2, 77, 130, 128, True), (1, 2, 96, 70, 128, False),
                     (1, 2, 1024, 1024, 64, True), (2, 3, 1, 200, 64, True),
                     (2, 3, 1, 200, 128, True)]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", F32_CASES)
def test_sm90_f32_backward_arithmetic_passes_check_flash_bwd(b, h, sq, sk, d, causal):
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f32_case(b, h, sq, sk, d, causal, seed=sq + 3)
    dk, dv = emulate_dkv_f32(q, k, v, dout, lse, dmb, causal)
    dq = emulate_dq_f32(q, k, v, dout, lse, dmb, causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res
    if causal and sq > sk:
        assert bool(torch.isnan(dk).all()) and not bool(torch.isnan(dv).any())
        assert bool(torch.isnan(dq[:, :, :sq - sk]).all())
        assert not bool(torch.isnan(dq[:, :, sq - sk:]).any())


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [(1, 2, 77, 130, 64, True),
                                                (1, 2, 96, 70, 128, False)])
def test_sm90_f32_backward_arithmetic_matches_pallas(b, h, sq, sk, d, causal):
    # heat_tpu's Pallas backward (interpret mode, float32 at HIGHEST) on the
    # same forward outputs, and the emulation, both within check_flash_bwd
    # of the plain version; and within 1e-4 of the largest of each other
    cs = _smoke()
    (qn, kn, vn, don, dlse), _ = _f32_case(b, h, sq, sk, d, causal, seed=sq + 4)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qn, kn, vn, don))
    jo, jl = pk.flash_attention(jq, jk, jv, causal=causal, return_lse=True)
    wq, wk, wv = pk._flash_bwd_impl(jq, jk, jv, jo, jl, jdo, jnp.asarray(dlse),
                                    1.0 / math.sqrt(d), causal, 128, 128)
    q, k, v, dout = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    lse = torch.from_numpy(np.array(jl))
    dmb = tk._dmb(torch.from_numpy(np.array(jo)), dout, torch.from_numpy(dlse))
    want = tuple(torch.from_numpy(np.array(w)) for w in (wq, wk, wv))
    got = (emulate_dq_f32(q, k, v, dout, lse, dmb, causal),) + emulate_dkv_f32(
        q, k, v, dout, lse, dmb, causal)
    for g in (want, got):
        res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, got=g)
        assert all(r <= 1.0 for _, r in res.values()), res
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_check_flash_bwd_refuses_one_f32_pass_fewer():
    # five passes a product are refused where six pass: a single query
    # against 200 keys at head dim 128, five passes in the dK/dV kernel
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f32_case(2, 3, 1, 200, 128, True, seed=1)
    dq6 = emulate_dq_f32(q, k, v, dout, lse, dmb, True)
    dk6, dv6 = emulate_dkv_f32(q, k, v, dout, lse, dmb, True)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, got=(dq6, dk6, dv6))
    assert all(r <= 1.0 for _, r in res.values())
    fewer = F32_BWD_PASSES - 1
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, got=(
            (dq6,) + emulate_dkv_f32(q, k, v, dout, lse, dmb, True, passes=fewer)))


# --------------------------------------------------------------------------- #
# the float32 Lloyd partial's scores, as chip_smoke.kmeans_bound counts them  #
# --------------------------------------------------------------------------- #


def emulate_kmeans_step(x, c, mask, passes):
    """A Lloyd partial whose scores |c|² − 2·x·c take x·c in ``passes``
    split-bf16 passes of two float32 operands: the first-index argmin
    label, the inertia Σ(best + |x|²), sums and counts over those labels."""
    k, d = c.shape
    scores = (c * c).sum(1)[None, :] - 2.0 * _split_product(x, c.T.contiguous(), passes,
                                                            split_b=True)
    best, lab = scores.min(1)
    lk = lab[mask]
    sums = torch.zeros(k, d, dtype=torch.float64).index_add_(0, lk, x[mask].double())
    inertia = (best + (x * x).sum(1))[mask].double().sum()
    return (sums.float(), torch.bincount(lk, minlength=k).float(), inertia.float(),
            lab.to(torch.int32))


def _kmeans_case(n, d, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, d, generator=g)
    c = x[torch.randint(0, n, (k,), generator=g)].clone()
    mask = torch.arange(n) < n - 123
    return x, c, mask, tk.kmeans_step_plain(x, c, mask, return_labels=True)


KMEANS_CASES = [(8192, 64, 8, 0), (8192, 64, 128, 0), (8192, 64, 128, 1), (2048, 1024, 64, 0)]


@pytest.mark.parametrize("n,d,k,seed", KMEANS_CASES)
def test_kmeans_scores_in_three_f32_passes_pass_check_kmeans_step(n, d, k, seed):
    cs = _smoke()
    x, c, mask, want = _kmeans_case(n, d, k, seed)
    got = emulate_kmeans_step(x, c, mask, cs.F32_PASSES_KMEANS)
    cs.check_kmeans_step(torch, x, c, mask, got, want)
    assert cs.F32_PASSES_KMEANS == 3


def test_check_kmeans_step_refuses_one_f32_pass_fewer():
    # two passes (the cross terms 0·0 and 0·1) move labels off near-ties
    cs = _smoke()
    x, c, mask, want = _kmeans_case(8192, 64, 128, 0)
    with pytest.raises(AssertionError, match="labels differ, not all at near-ties"):
        cs.check_kmeans_step(torch, x, c, mask,
                             emulate_kmeans_step(x, c, mask, cs.F32_PASSES_KMEANS - 1), want)
