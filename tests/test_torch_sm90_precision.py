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

The float32 kernels (the same three files, float32 instantiations)
multiply two float32 operands: both split into their three bf16 terms, and
a product takes the largest cross terms, six (the pairs i + j <= 2 of the
nine), summed smallest first. Six are the fewest that hold every case below
(``chip_smoke.F32_PASSES_BWD``, ``F32_PASSES_FWD``). In the backward five
are refused on the card tests' own inputs of a single query against 200
keys at head dim 16, where the card refused three (and this emulation
three to five); at head dims 64 and 128 three would pass. In the forward,
whose split pass scales q before the product, every input of the card
tests takes three, but a causal row that sees one key has that one score
for its lse, and the terms of 2^-16·|q||k| that four and five passes drop
reach ``check_flash``'s 1e-5·(1 + |lse|): five are refused on 16,384 such
rows, four on 1,024.

The float16 kernels (float16 instantiations of all three) multiply float16
operands in one pass, as bf16's; the float32 operand of a product (P, Pᵀ,
dSᵀ, dS) is scaled by a power of two into float16's range and split into
``chip_smoke.F16_PASSES_SPLIT`` float16 terms: P by 2^15, dSᵀ by a running
exponent per key row, dS by one per query row. One term fewer is refused,
and so is the split of dSᵀ or dS without its scale at gradients of σ 2^-14.

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


# chip_smoke.py: the checks, and the pass counts (F32_PASSES_BWD, the float32
# backward kernels'; F32_PASSES_FWD, the float32 forward's) that they settle
CS = _smoke()


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
    ``split_b`` (float32 inputs; the float32 instantiation of the same
    kernel) q is scaled before the product, as the split pass writes the
    planes of q·scale rounded to float32, and S = (q·scale) Kᵀ and P·V each
    take ``passes`` passes of two split float32 operands; the scores are
    then multiplied by log2(e) alone, and at head dims past 64 the keys come
    in tiles of 32, as the kernel's narrow block takes them."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = np.float32(1.0 / math.sqrt(D))
    scale_log2 = np.float32(LOG2E) if split_b else np.float32(scale * LOG2E)
    qf, kf, vf = q.float(), k.float(), v.float()
    if split_b:
        qf = qf * torch.tensor(scale)
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), NEG_BIG)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, D))
    bk = 32 if split_b and D > 64 else BK
    for k0 in range(0, Sk, bk):
        cols = torch.arange(k0, min(k0 + bk, Sk))[None, :]
        kt = kf[:, :, k0:k0 + bk].transpose(-1, -2)
        s2 = (_split_product(qf, kt, passes, split_b=True) if split_b else qf @ kt) * float(
            scale_log2)
        ok = (cols <= rows + (Sk - Sq)) if causal else torch.ones_like(cols <= rows)
        s2 = torch.where(ok, s2, torch.full((), NEG_BIG))
        m_new = torch.maximum(m, s2.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s2 - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_product(p, vf[:, :, k0:k0 + bk], passes, split_b)
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
    got = emulate_fwd(q, k, v, causal, passes=CS.F32_PASSES_FWD, split_b=True)
    assert cs.check_flash(torch, tk, q, k, v, causal, got=got)[1] <= 1.0


def _card_inputs_sweep():
    """Every float32 input of ``tests/test_torch_kernels.py``'s
    ``test_flash_kernel_matches_plain_on_card`` (head dim, Sq, Sk, causal)."""
    return [(d, sq, sk, c) for d in (8, 16, 20, 24, 64, 128) for sq, sk, c in (
        (77, 130, True), (77, 130, False), (150, 70, True), (1, 200, True), (64, 64, True),
        (100, 37, False), (300, 4096, True), (300, 4096, False))]


@pytest.mark.parametrize("d,sq,sk,causal", _card_inputs_sweep())
def test_f32_forward_passes_hold_the_card_tests_inputs(d, sq, sk, causal):
    # the float32 forward's F32_PASSES_FWD on the card test's own inputs
    q, k, v = _card_inputs(sq, sk, d, seed=d + sq)
    got = emulate_fwd(q, k, v, causal, passes=CS.F32_PASSES_FWD, split_b=True)
    assert CS.check_flash(torch, tk, q, k, v, causal, got=got)[1] <= 1.0


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 4, 300, 200, 64, True), (1, 16, 1, 200, 64, True), (1, 4, 300, 4096, 64, True),
    (1, 4, 300, 4096, 64, False), (1, 2, 256, 256, 128, True)])
def test_f32_forward_passes_hold_phase_4_shapes(b, h, sq, sk, d, causal):
    # chip_smoke.py phase 4's float32 forward cases (empty rows, one query
    # against 200 keys, 4096 keys causal and not, head dim 128 at fewer
    # rows), on draws of the same kind
    g = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = (torch.randn(b, h, s, d, generator=g) for s in (sq, sk, sk))
    got = emulate_fwd(q, k, v, causal, passes=CS.F32_PASSES_FWD, split_b=True)
    assert CS.check_flash(torch, tk, q, k, v, causal, got=got)[1] <= 1.0


def _single_key_rows(b, d, seed):
    """``b`` batches of 16 heads of one query against one key: each row's lse
    is its one score."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, 16, 1, d, generator=g) for _ in range(3))


def test_check_flash_refuses_one_f32_forward_pass_fewer():
    # 16,384 rows that see one key at head dim 16: six passes hold, five
    # are refused (their lse, one score each, misses by a term q₂·k₀ of
    # 2^-16·|q||k|); four are refused already on 1,024 such rows at head dim
    # 64 (the model's), where five still hold
    q, k, v = _single_key_rows(1024, 16, seed=1)
    n = CS.F32_PASSES_FWD
    assert CS.check_flash(torch, tk, q, k, v, True,
                          got=emulate_fwd(q, k, v, True, passes=n, split_b=True))[1] <= 1.0
    with pytest.raises(AssertionError, match="lse values beyond their tolerance"):
        CS.check_flash(torch, tk, q, k, v, True,
                       got=emulate_fwd(q, k, v, True, passes=n - 1, split_b=True))
    q, k, v = _single_key_rows(64, 64, seed=0)
    assert CS.check_flash(torch, tk, q, k, v, True,
                          got=emulate_fwd(q, k, v, True, passes=n - 1, split_b=True))[1] <= 1.0
    with pytest.raises(AssertionError, match="lse values beyond their tolerance"):
        CS.check_flash(torch, tk, q, k, v, True,
                       got=emulate_fwd(q, k, v, True, passes=n - 2, split_b=True))


def test_sm90_f32_forward_arithmetic_matches_pallas():
    # heat_tpu's Pallas forward at float32 (interpret mode, HIGHEST) and the
    # emulation both hold check_flash, and agree within 1e-5 of max|v|
    qn, kn, vn, _, _ = _case(1, 2, 150, 130, 32, seed=11)
    jo, jl = pk.flash_attention(*(jnp.asarray(a) for a in (qn, kn, vn)), causal=True,
                                return_lse=True)
    jo, jl = (torch.from_numpy(np.array(t)) for t in (jo, jl))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = emulate_fwd(q, k, v, True, passes=CS.F32_PASSES_FWD, split_b=True)
    for g in (got, (jo, jl)):
        assert CS.check_flash(torch, tk, q, k, v, True, got=g)[1] <= 1.0
    nan = torch.isnan(jo)
    assert torch.equal(torch.isnan(got[0]), nan) and bool(nan.any())
    assert float((got[0] - jo).abs()[~nan].max()) <= 1e-5 * float(v.abs().max())


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


def emulate_dkv_f32(q, k, v, dout, lse, dmb, causal, passes=CS.F32_PASSES_BWD):
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


def emulate_dq_f32(q, k, v, dout, lse, dmb, causal, passes=CS.F32_PASSES_BWD):
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


def _card_f32_case(sq, sk, d, causal):
    """The float32 inputs of ``tests/test_torch_kernels.py``'s
    ``test_flash_bwd_kernels_match_plain_on_card`` (B 2, H 3), made on the
    CPU as that test makes them; lse and dmb from the plain forward."""
    g = torch.Generator().manual_seed(d + sq + 1)
    q, k, v = (torch.randn(2, 3, s, d, generator=g) for s in (sq, sk, sk))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator().manual_seed(sq + sk)
    dout = torch.randn(q.shape, generator=g)
    dmb = tk._dmb(out, dout, torch.randn(lse.shape, generator=g))
    return q, k, v, dout, lse, dmb


# the bf16 cases, the same at head dim 128, the training path's length, one
# query against 200 keys (each dK row then sums a single term) at the head
# dims where three passes failed on the card (8 to 24) and at 64 and 128,
# and 300 queries against 4096 keys at head dim 16
F32_CASES = CASES + [(1, 2, 77, 130, 128, True), (1, 2, 96, 70, 128, False),
                     (1, 2, 1024, 1024, 64, True)] + [
    (2, 3, 1, 200, d, True) for d in (8, 16, 20, 24, 64, 128)] + [(2, 3, 300, 4096, 16, True)]


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
    # one pass a product fewer than the kernels' F32_PASSES_BWD, in the
    # dK/dV kernel, is refused where theirs pass: a single query against
    # 200 keys at head dim 16, on the card test's own inputs
    cs = _smoke()
    n = cs.F32_PASSES_BWD
    q, k, v, dout, lse, dmb = _card_f32_case(1, 200, 16, True)
    dq = emulate_dq_f32(q, k, v, dout, lse, dmb, True, passes=n)
    dk, dv = emulate_dkv_f32(q, k, v, dout, lse, dmb, True, passes=n)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, got=(
            (dq,) + emulate_dkv_f32(q, k, v, dout, lse, dmb, True, passes=n - 1)))


# --------------------------------------------------------------------------- #
# float16: operands scaled into float16's range, split into float16 terms     #
# --------------------------------------------------------------------------- #

F16_STEP = 2.0 ** -10
P_SCALE = 2.0 ** 15  # the probabilities' scale: 2^15·P < 65,504 for P <= 1
E_MIN = -110         # the running exponent's floor (csrc/flash_bwd_dkv_sm90.cu)


def split_f16(x, passes):
    """The kernels' split of a float32 tensor into ``passes`` float16 terms
    (as float32), largest first: x1 = f16(x), x2 = f16(x - x1)."""
    x1 = x.half().float()
    return (x1,) if passes == 1 else (x1, (x - x1).half().float())


def _f16_product(a, b, passes):
    """a @ b with the float32 ``a`` split into float16 terms against the
    float16 ``b``, smallest term first."""
    out = None
    for t in reversed(split_f16(a, passes)):
        out = t @ b if out is None else out + t @ b
    return out


def pow2(n):
    """2^n as float32 for integer tensors n <= 127, zero below 2^-126 (the
    kernels' rescale factor, exact)."""
    return torch.where(n < -126, torch.zeros(()), torch.pow(2.0, n.clamp_min(-126).double())
                       .float())


def exponent(x):
    """The unbiased float32 exponent of |x| (-127 for zero and subnormals,
    128 for inf), from its bits, as the kernels read it."""
    return ((x.abs().view(torch.int32) >> 23) & 0xFF) - 127


def emulate_fwd_f16(q, k, v, causal, passes=2):
    """The float16 forward kernel's arithmetic: :func:`emulate_fwd`'s tile
    order and online softmax, S = Q Kᵀ in one pass (float16 products are
    exact in float32), and O += (2^15·P) V with 2^15·P split into
    ``passes`` float16 terms; the 2^15 is divided out with l at the end."""
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
        s2 = (qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * float(scale_log2)
        ok = (cols <= rows + (Sk - Sq)) if causal else torch.ones_like(cols <= rows)
        s2 = torch.where(ok, s2, torch.full((), NEG_BIG))
        m_new = torch.maximum(m, s2.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s2 - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _f16_product(p * P_SCALE, vf[:, :, k0:k0 + BK], passes)
        m = m_new
    empty = l == 0
    inv = torch.full((), 1.0 / P_SCALE) / torch.where(empty, 1.0, l)
    out = torch.where(empty, torch.full((), float("nan")), o * inv)
    lse = torch.where(empty, torch.full((), float("-inf")),
                      m * math.log(2.0) + torch.log(torch.where(empty, 1.0, l)))
    return out.half(), lse[..., 0]


def emulate_dkv_f16(q, k, v, dout, lse, dmb, causal, passes=2, scaled=True):
    """The float16 dK/dV kernel's arithmetic: :func:`emulate_dkv`'s Pᵀ and
    dSᵀ from one-pass Sᵀ and dPᵀ, then dV = 2^-15·(2^15·Pᵀ) dO with 2^15·Pᵀ
    split into ``passes`` float16 terms, and dK by query tiles in the
    kernel's order (64 rows at D <= 64, else 32): per key row a running
    exponent E of its largest |dSᵀ| so far (never below -110), the float32
    accumulator rescaled by 2^(E_old - E) where E grows, the tile's row
    times 2^(14 - E) (below 2^15) split into float16 terms; dK = scale ·
    2^(E - 14) · the accumulator. ``scaled=False`` splits dSᵀ as it is."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = q.float(), k.float(), v.float(), dout.float()
    st = kf @ qf.transpose(-1, -2)
    dpt = vf @ of.transpose(-1, -2)
    ls = (lse * np.float32(LOG2E))[..., None, :]
    ok = torch.isfinite(ls)
    if causal:
        ok = ok & (torch.arange(Sk)[:, None] <= torch.arange(Sq)[None, :] + (Sk - Sq))
    c = float(np.float32(scale * LOG2E))
    arg = (st.double() * c - ls.double()).float()
    pt = torch.where(ok, torch.exp2(arg), torch.zeros(()))
    dst = pt * (dpt + dmb[..., None, :])
    dv = _f16_product(pt * P_SCALE, of, passes) * (1.0 / P_SCALE)
    if not scaled:
        return (_f16_product(dst, qf, passes) * scale).half(), dv.half()
    bq = 64 if D <= 64 else 32
    e = torch.full(dst.shape[:-1] + (1,), E_MIN, dtype=torch.int32)
    acc = torch.zeros(dst.shape[:-1] + (D,))
    for q0 in range(0, Sq, bq):
        blk = dst[..., q0:q0 + bq]
        mx = blk.abs().nan_to_num(nan=0.0, posinf=float("inf")).amax(-1, keepdim=True)
        e_new = torch.maximum(e, exponent(mx))
        acc = acc * pow2(e - e_new)
        e = e_new
        acc = acc + _f16_product(blk * pow2(14 - e), qf[..., q0:q0 + bq, :], passes)
    dk = acc * (pow2(e - 14) * np.float32(scale))
    return dk.half(), dv.half()


def emulate_dq_f16(q, k, v, dout, lse, dmb, causal, passes=2, scaled=True):
    """The float16 dQ kernel's arithmetic: :func:`emulate_dq`'s P and dS from
    one-pass S and dP, then dQ by 64-key tiles in the kernel's order: per
    query row a running exponent E of its largest |dS| so far, NaN aside
    (never below -110), the float32 accumulator rescaled by 2^(E_old - E)
    where E grows, the tile's row times 2^(14 - E) (below 2^15) split into
    ``passes`` float16 terms against K; dQ = scale · 2^(E - 14) · the
    accumulator. ``scaled=False`` splits dS as it is."""
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
    if not scaled:
        return (_f16_product(ds, kf, passes) * scale).half()
    e = torch.full(ds.shape[:-1] + (1,), E_MIN, dtype=torch.int32)
    acc = torch.zeros(ds.shape[:-1] + (D,))
    for k0 in range(0, Sk, BK):
        blk = ds[..., k0:k0 + BK]
        mx = blk.abs().nan_to_num(nan=0.0, posinf=float("inf")).amax(-1, keepdim=True)
        e_new = torch.maximum(e, exponent(mx))
        acc = acc * pow2(e - e_new)
        e = e_new
        acc = acc + _f16_product(blk * pow2(14 - e), kf[..., k0:k0 + BK, :], passes)
    return (acc * (pow2(e - 14) * np.float32(scale))).half()


def _f16_case(b, h, sq, sk, d, causal, seed, sigma=(1.0, 1.0, 1.0)):
    """Float16 inputs from :func:`_case`, q and k times sigma[0], v times
    sigma[1], dout and the lse cotangent times sigma[2]; the plain forward's
    lse and dmb."""
    qn, kn, vn, don, dlse = _case(b, h, sq, sk, d, seed)
    s_qk, s_v, s_do = sigma
    qn, kn, vn, don = ((a * s).astype(np.float16) for a, s in
                       ((qn, s_qk), (kn, s_qk), (vn, s_v), (don, s_do)))
    dlse = (dlse * s_do).astype(np.float32)
    q, k, v, dout = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    dmb = tk._dmb(out, dout, torch.from_numpy(dlse))
    return (qn, kn, vn, don, dlse), (q, k, v, dout, lse, dmb)


SMALL_GRAD = (1.0, 1.0, 2.0 ** -14)  # float16 training without loss scaling
LARGE_DS = (1.0, 128.0, 128.0)       # |dS| past float16's 65,504, dK and dV inside it
# the bf16 cases; q and k of σ 3 (most probabilities below float16's
# smallest normal); head dim 128
F16_FWD_CASES = [c + (1.0,) for c in CASES] + [(1, 2, 200, 200, 64, True, 3.0),
                                                (1, 2, 77, 130, 128, True, 1.0)]
# the bf16 cases; gradients of σ 2^-14; v and dO of σ 128; head dim 128
F16_BWD_CASES = [c + ((1.0, 1.0, 1.0),) for c in CASES] + [
    (1, 2, 200, 200, 64, True, SMALL_GRAD), (1, 4, 256, 300, 64, True, LARGE_DS),
    (1, 2, 77, 130, 128, True, (1.0, 1.0, 1.0))]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,s_qk", F16_FWD_CASES)
def test_sm90_f16_forward_arithmetic_passes_check_flash(b, h, sq, sk, d, causal, s_qk):
    cs = _smoke()
    assert cs.F16_PASSES_SPLIT == 2
    qn, kn, vn, _, _ = _case(b, h, sq, sk, d, seed=sq + 7)
    q, k, v = (torch.from_numpy((a * s).astype(np.float16)) for a, s in
               ((qn, s_qk), (kn, s_qk), (vn, 1.0)))
    got = emulate_fwd_f16(q, k, v, causal, passes=cs.F16_PASSES_SPLIT)
    assert cs.check_flash(torch, tk, q, k, v, causal, out_step=F16_STEP, got=got)[1] <= 1.0
    if s_qk > 1.0:  # most visible probabilities lie below float16's smallest normal
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
        vis = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), -1)[..., vis]
        assert float((p < torch.finfo(torch.float16).tiny).float().mean()) > 0.5
    if causal and sq > sk:
        assert bool(torch.isnan(got[0][:, :, :sq - sk]).all())
        assert bool(torch.isneginf(got[1][:, :, :sq - sk]).all())


def test_check_flash_refuses_one_f16_pass_of_p():
    cs = _smoke()
    qn, kn, vn, _, _ = _case(1, 2, 77, 130, 64, seed=77)
    q, k, v = (torch.from_numpy(a.astype(np.float16)) for a in (qn, kn, vn))
    assert cs.check_flash(torch, tk, q, k, v, True, out_step=F16_STEP,
                          got=emulate_fwd_f16(q, k, v, True))[1] <= 1.0
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        cs.check_flash(torch, tk, q, k, v, True, out_step=F16_STEP,
                       got=emulate_fwd_f16(q, k, v, True, passes=cs.F16_PASSES_SPLIT - 1))


@pytest.mark.parametrize("b,h,sq,sk,d,causal,sigma", F16_BWD_CASES)
def test_sm90_f16_dkv_arithmetic_passes_check_flash_bwd(b, h, sq, sk, d, causal, sigma):
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f16_case(b, h, sq, sk, d, causal, seed=sq + 8,
                                             sigma=sigma)
    dk, dv = emulate_dkv_f16(q, k, v, dout, lse, dmb, causal, passes=cs.F16_PASSES_SPLIT)
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=F16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res
    if sigma is LARGE_DS:  # dS passes float16's range; dK and dV stay inside it
        ds = tk._bwd_dense(q, k, v, dout, lse, dmb, 1.0 / math.sqrt(d), causal)[4]
        assert float(ds.abs().max()) > torch.finfo(torch.float16).max
        assert bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all())
    if causal and sq > sk:
        assert bool(torch.isnan(dk).all()) and not bool(torch.isnan(dv).any())


def _f16_dkv_check(sigma, seed, **kw):
    """check_flash_bwd of :func:`emulate_dkv_f16` (options ``kw``) on the
    causal 200 x 200 float16 case of inputs ``sigma``."""
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f16_case(1, 2, 200, 200, 64, True, seed=seed, sigma=sigma)
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=True)
    return cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=F16_STEP,
                              got=(dq,) + emulate_dkv_f16(q, k, v, dout, lse, dmb, True, **kw))


def test_check_flash_bwd_refuses_one_f16_pass_fewer():
    # one float16 term of 2^15·Pᵀ and of the scaled dSᵀ, at unit-size inputs
    cs = _smoke()
    assert all(r <= 1.0 for _, r in _f16_dkv_check((1.0, 1.0, 1.0), 9).values())
    with pytest.raises(AssertionError, match="beyond their tolerance"):
        _f16_dkv_check((1.0, 1.0, 1.0), 9, passes=cs.F16_PASSES_SPLIT - 1)


def test_check_flash_bwd_refuses_the_unscaled_ds_split():
    # two float16 terms of dSᵀ as it is, at gradients of σ 2^-14: dS lies in
    # float16's subnormals, where two terms keep few of its bits
    assert all(r <= 1.0 for _, r in _f16_dkv_check(SMALL_GRAD, 9).values())
    with pytest.raises(AssertionError, match="dk: .* beyond their tolerance"):
        _f16_dkv_check(SMALL_GRAD, 9, scaled=False)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,sigma", F16_BWD_CASES)
def test_sm90_f16_dq_arithmetic_passes_check_flash_bwd(b, h, sq, sk, d, causal, sigma):
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f16_case(b, h, sq, sk, d, causal, seed=sq + 12,
                                             sigma=sigma)
    dq = emulate_dq_f16(q, k, v, dout, lse, dmb, causal, passes=cs.F16_PASSES_SPLIT)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=F16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res
    if sigma is LARGE_DS:  # dS passes float16's range; dQ stays inside it
        ds = tk._bwd_dense(q, k, v, dout, lse, dmb, 1.0 / math.sqrt(d), causal)[4]
        assert float(ds.abs().max()) > torch.finfo(torch.float16).max
        assert bool(torch.isfinite(dq).all())
    if causal and sq > sk:  # the empty rows' NaN dmb reaches their dQ, and only theirs
        assert bool(torch.isnan(dq[:, :, :sq - sk]).all())
        assert not bool(torch.isnan(dq[:, :, sq - sk:]).any())


def _card_f16_case(sq, sk, d, causal):
    """The float16 inputs of ``tests/test_torch_kernels.py``'s
    ``test_flash_bwd_kernels_match_plain_on_card`` (B 2, H 3), made on the
    CPU as that test makes them; lse and dmb from the plain forward."""
    g = torch.Generator().manual_seed(d + sq + 1)
    q, k, v = (torch.randn(2, 3, s, d, generator=g).half() for s in (sq, sk, sk))
    out, lse = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator().manual_seed(sq + sk)
    dout = torch.randn(q.shape, generator=g).half()
    dmb = tk._dmb(out, dout, torch.randn(lse.shape, generator=g))
    return q, k, v, dout, lse, dmb


@pytest.mark.parametrize("d", [8, 16, 20, 24, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [
    (77, 130, True), (77, 130, False), (150, 70, True), (300, 100, True), (1, 200, True),
    (64, 64, True), (100, 37, False), (300, 4096, True), (300, 4096, False)])
def test_sm90_f16_dq_holds_the_card_tests_inputs(d, sq, sk, causal):
    # the float16 dQ kernel's arithmetic on the card test's own inputs
    cs = _smoke()
    q, k, v, dout, lse, dmb = _card_f16_case(sq, sk, d, causal)
    dq = emulate_dq_f16(q, k, v, dout, lse, dmb, causal, passes=cs.F16_PASSES_SPLIT)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=causal)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=F16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res


@pytest.mark.parametrize("sigma", [SMALL_GRAD, LARGE_DS])
def test_sm90_f16_dq_holds_phase_4_stress_inputs(sigma):
    # chip_smoke.py phase 4's float16 small_grad and large_ds cases, at their
    # shape (1, 16, 1024, 64) causal with a nonzero lse cotangent
    cs = _smoke()
    g = torch.Generator().manual_seed(14)
    s_qk, s_v, s_do = sigma
    q, k = ((torch.randn(1, 16, 1024, 64, generator=g) * s_qk).half() for _ in range(2))
    v = (torch.randn(1, 16, 1024, 64, generator=g) * s_v).half()
    out, lse = tk.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    dout = (torch.randn(q.shape, generator=g) * s_do).half()
    dmb = tk._dmb(out, dout, torch.randn(lse.shape, generator=g) * s_do)
    dq = emulate_dq_f16(q, k, v, dout, lse, dmb, True, passes=cs.F16_PASSES_SPLIT)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=True)
    res = cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=F16_STEP,
                             got=(dq, dk, dv))
    assert all(r <= 1.0 for _, r in res.values()), res
    if sigma is LARGE_DS:
        ds = tk._bwd_dense(q, k, v, dout, lse, dmb, 1.0 / 8, True)[4]
        assert float(ds.abs().nan_to_num(0.0).max()) > torch.finfo(torch.float16).max


def _f16_dq_check(sigma, seed, **kw):
    """check_flash_bwd of :func:`emulate_dq_f16` (options ``kw``) on the
    causal 200 x 200 float16 case of inputs ``sigma``."""
    cs = _smoke()
    _, (q, k, v, dout, lse, dmb) = _f16_case(1, 2, 200, 200, 64, True, seed=seed, sigma=sigma)
    dk, dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=True)
    return cs.check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, True, out_step=F16_STEP,
                              got=(emulate_dq_f16(q, k, v, dout, lse, dmb, True, **kw), dk, dv))


def test_check_flash_bwd_refuses_one_f16_dq_term_fewer():
    # one float16 term of the scaled dS, at unit-size inputs
    cs = _smoke()
    assert all(r <= 1.0 for _, r in _f16_dq_check((1.0, 1.0, 1.0), 9).values())
    with pytest.raises(AssertionError, match="dq: .* beyond their tolerance"):
        _f16_dq_check((1.0, 1.0, 1.0), 9, passes=cs.F16_PASSES_SPLIT - 1)


def test_check_flash_bwd_refuses_the_unscaled_dq_ds_split():
    # two float16 terms of dS as it is, at gradients of σ 2^-14: dS lies in
    # float16's subnormals, where two terms keep few of its bits
    assert all(r <= 1.0 for _, r in _f16_dq_check(SMALL_GRAD, 9).values())
    with pytest.raises(AssertionError, match="dq: .* beyond their tolerance"):
        _f16_dq_check(SMALL_GRAD, 9, scaled=False)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [(1, 2, 77, 130, 64, True),
                                                (1, 2, 96, 70, 64, False)])
def test_sm90_f16_arithmetic_matches_pallas(b, h, sq, sk, d, causal):
    # heat_tpu's Pallas forward and backward at float16 (interpret mode):
    # float16 out, dq, dk and dv, float32 lse. Both they and the emulations
    # hold check_flash and check_flash_bwd; and they agree within one
    # float16 rounding of each and 1e-5 of the largest
    cs = _smoke()
    (qn, kn, vn, don, dlse), (q, k, v, dout, _, _) = _f16_case(b, h, sq, sk, d, causal,
                                                               seed=sq + 10)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qn, kn, vn, don))
    jo, jl = pk.flash_attention(jq, jk, jv, causal=causal, return_lse=True)
    assert jo.dtype == jnp.float16 and jl.dtype == jnp.float32
    _, wk, wv = pk._flash_bwd_impl(jq, jk, jv, jo, jl, jdo, jnp.asarray(dlse),
                                   1.0 / math.sqrt(d), causal, 128, 128)
    assert wk.dtype == wv.dtype == jnp.float16
    jo, jl = (torch.from_numpy(np.array(t)) for t in (jo, jl))
    got = emulate_fwd_f16(q, k, v, causal)
    for g in (got, (jo, jl)):
        assert cs.check_flash(torch, tk, q, k, v, causal, out_step=F16_STEP, got=g)[1] <= 1.0
    vmax = float(v.float().abs().max())
    err = (got[0].float() - jo.float()).abs()
    assert bool((err <= 1e-5 * vmax + (2e-5 + 2 * F16_STEP) * jo.float().abs()).all())
    # the backward on heat_tpu's forward outputs
    dmb = tk._dmb(jo, dout, torch.from_numpy(dlse))
    want = tuple(torch.from_numpy(np.array(w)) for w in (wk, wv))
    mine = emulate_dkv_f16(q, k, v, dout, jl, dmb, causal)
    dq = tk.flash_bwd_dq_plain(q, k, v, dout, jl, dmb, causal=causal)
    for g in (want, mine):
        res = cs.check_flash_bwd(torch, tk, q, k, v, dout, jl, dmb, causal, out_step=F16_STEP,
                                 got=(dq,) + g)
        assert all(r <= 1.0 for _, r in res.values()), res
    for g, w in zip(mine, want):
        g, w = g.float(), w.float()
        lim = 2 * F16_STEP * w.abs() + 1e-5 * w.abs().max()
        assert bool(((g - w).abs() <= lim).all()), float(((g - w).abs() / lim).max())


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
