"""The port's hand-written CUDA kernels (heat_tpu ``core/pallas_kernels.py``).

Each kernel sits beside a plain PyTorch version of the same function:

* :func:`cdist_tile` (``csrc/cdist_tile.cu``) for heat_tpu's ``cdist_tile``
  (``pallas_kernels.py:189``), and :func:`cdist_tile_plain`;
* :func:`kmeans_step` (``csrc/kmeans_step.cu``) for heat_tpu's
  ``kmeans_step_tile`` (``pallas_kernels.py:858``), and
  :func:`kmeans_step_plain`;
* :func:`flash_attention` for heat_tpu's ``flash_attention`` forward
  (``_flash_impl``, ``pallas_kernels.py:348``), and
  :func:`flash_attention_plain`;
* :func:`flash_bwd_dkv` and :func:`flash_bwd_dq` for heat_tpu's
  ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``
  (``pallas_kernels.py:412``, ``:488``, launched by ``_flash_bwd_impl``
  ``:549``), and :func:`flash_bwd_dkv_plain`, :func:`flash_bwd_dq_plain`;
  :func:`flash_attention`'s backward runs both (float32: one split pass,
  written by the dK/dV launch and read by the dQ launch), and
  :func:`flash_attention_bwd_plain` is the whole backward's plain version
  (heat_tpu's dense fallback, ``:668-686``).

  The three flash kernels run on the tensor cores in bf16, float16 and
  float32 (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``,
  ``csrc/flash_bwd_dq_sm90.cu``: wgmma, TMA, float32 accumulation): a
  float32 operand of a product splits into bf16 terms, or float16 terms
  scaled by a power of two (2^15 for P, a running exponent per row for dS);
  float32 inputs go through three bf16 planes each, which a split pass
  writes into a workspace the wrapper allocates;
* :func:`probe` (``csrc/probe.cu``) for heat_tpu's Mosaic probe
  (``_mosaic_available._probe``, ``pallas_kernels.py:85``), and
  :func:`probe_plain`.

A wrapper takes the plain version for tensors that lie on the CPU and for
the data-free tensors of a step trace (:mod:`.capture`: shapes only).
Otherwise a CUDA tensor launches the kernel, or the call raises: a kernel
that fails to build or launch never gives way to its plain version, and a
flash entry point picks its kernel's instantiation by dtype alone. Every
wrapper launches through :func:`_launch`, on its tensors' card and that
card's current stream. ``launches`` counts each wrapper's kernel launches;
a launch recorded into a CUDA graph (:mod:`.fusion`) goes to the capture's
tally (:mod:`.capture`) and counts at each replay of the graph instead.
Calling a plain version directly, as the card-side comparisons do,
launches no kernel and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build, capture, types

__all__ = ["pallas_enabled", "set_pallas", "cdist_tile", "cdist_tile_plain", "kmeans_step",
           "kmeans_step_plain", "flash_attention", "flash_attention_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "flash_bwd_dq", "flash_bwd_dq_plain", "flash_attention_bwd_plain",
           "probe", "probe_plain", "launches", "reset_launches"]

launches = {"cdist_tile": 0, "kmeans_step": 0, "flash_attention": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0, "probe": 0}

# dtype codes of the C interface (csrc/common.cuh)
_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
_KERNEL_INPUTS = (torch.float32, torch.bfloat16, torch.float16)
_MAX_GRID_Y = 65535
_FLASH_TILE = 64    # the fewest query rows (keys for dK/dV) a flash kernel block takes
_FLASH_MAX_D = 128
_NEG_BIG = -1e30    # heat_tpu's masked score (pallas_kernels.py:55)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def set_pallas(enabled: Optional[bool]) -> None:
    """heat_tpu's switch (``pallas_kernels.py:66``), kept for its name: True
    or ``None`` leave card tensors on the hand-written kernels, which is the
    only route the port has. ``False`` raises ``NotImplementedError``: no
    setting sends a card tensor to a plain version (an A/B run calls the
    ``*_plain`` functions itself), and heat_tpu's Mosaic probe fallback is
    not copied, so a kernel that fails to build or launch raises."""
    if enabled is not None and not enabled:
        raise NotImplementedError(
            "set_pallas(False): the port has no switch to the plain versions on the card; "
            "call the *_plain functions for an A/B comparison")


def pallas_enabled() -> bool:
    """True: card tensors go to the hand-written kernels (heat_tpu
    ``pallas_kernels.py:111``)."""
    return True


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.heat_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _plain(*ts) -> bool:
    """Whether a wrapper takes its plain version: every tensor lies on the
    CPU, or one holds no data (a step trace)."""
    ts = [t for t in ts if t is not None]
    return all(t.is_cpu for t in ts) or any(capture.abstract(t) for t in ts)


@functools.lru_cache(maxsize=256)
def _cdist_plan(m: int, n: int, d: int, in_code: int, out_code: int,
                index: int) -> Tuple[int, int]:
    """(grid, tile rows) of :func:`cdist_tile` on card ``index``: tile rows
    > 0 is the kernel for n <= 8 (two threads a row), 0 the register-blocked
    one (``csrc/cdist_tile.cu``, ``heat_cdist_tile_plan``). Cached per shape,
    dtypes and card, as :func:`_kmeans_plan`: a call of a known shape makes
    no planning call."""
    lib = _build.library()
    grid, tile_rows = ctypes.c_int(), ctypes.c_int()
    err = lib.heat_cdist_tile_plan(m, n, d, in_code, out_code, ctypes.byref(grid),
                                   ctypes.byref(tile_rows), index)
    _raise_on(err, lib, "cdist_tile planning")
    return grid.value, tile_rows.value


@functools.lru_cache(maxsize=256)
def _kmeans_plan(n: int, d: int, k: int, code: int, index: int) -> Tuple[int, int, int]:
    """(tile rows, grid, chunk) of :func:`kmeans_step` on card ``index``
    (``csrc/kmeans_step.cu``, ``heat_kmeans_step_plan``); the planner
    returns -1 where one row of d features does not fit half a block's
    shared memory."""
    lib = _build.library()
    outs = [ctypes.c_int() for _ in range(3)]
    err = lib.heat_kmeans_step_plan(n, d, k, code, *(ctypes.byref(o) for o in outs), index)
    if err == -1:
        raise ValueError(f"kmeans_step: one row of {d} features does not fit half the "
                         "card's shared memory per block")
    _raise_on(err, lib, "kmeans_step planning")
    return tuple(o.value for o in outs)


def _on_card(*ts) -> int:
    """The index of the one CUDA device that all of ``ts`` (``None`` aside)
    lie on; raises otherwise."""
    index = ts[0].get_device()
    for t in ts:
        if t is not None and (not t.is_cuda or t.get_device() != index):
            raise ValueError(
                f"tensors must all lie on the CPU or all on one CUDA device, got "
                f"{[str(t.device) for t in ts if t is not None]}")
    return index


def _launch(name: str, index: int, *args) -> None:
    """Launches wrapper ``name``'s kernel through the C entry point
    ``heat_<name>``, with ``args`` followed by the card ``index`` and that
    card's current stream, and counts the launch; raises the CUDA error of a
    refused launch. The library comes from its module global (only the
    first call builds and loads it, under a lock), the stream as its raw
    handle (no ``Stream`` object; ``torch.cuda.stream(...)`` still picks
    it), and the C side switches to the card only where another one is
    current."""
    lib = _build.library()
    err = getattr(lib, "heat_" + name)(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if err:
        _raise_on(err, lib, name)
    tally = capture.tally()
    (launches if tally is None else tally["launches"])[name] += 1


# --------------------------------------------------------------------------- #
# cdist tile                                                                  #
# --------------------------------------------------------------------------- #


def _cdist_dtypes(x, y, out_dtype) -> Tuple[torch.dtype, torch.dtype]:
    """(output, accumulation) dtypes, as heat_tpu's ``cdist_tile``: the
    promoted input dtype (float32 for integers) unless ``out_dtype`` is given;
    float64 accumulates in float64, everything else in float32."""
    if out_dtype is None:
        out = torch.promote_types(x.dtype, y.dtype)
    else:
        out = types.canonical_heat_type(out_dtype).torch_type()
    if not out.is_floating_point:
        out = torch.float32
    return out, (torch.float64 if out == torch.float64 else torch.float32)


def _check_pair(x, y) -> None:
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"cdist_tile needs 2-D inputs, got {x.ndim}-D and {y.ndim}-D")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dimensions differ: {x.shape[1]} != {y.shape[1]}")


def cdist_tile_plain(x: torch.Tensor, y: torch.Tensor, sqrt: bool = True,
                     out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`cdist_tile`."""
    _check_pair(x, y)
    out, acc = _cdist_dtypes(x, y, out_dtype)
    xf, yf = x.to(acc), y.to(acc)
    x2 = torch.sum(xf * xf, dim=1, keepdim=True)
    y2 = torch.sum(yf * yf, dim=1)[None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * (xf @ yf.T), min=0.0)
    return (torch.sqrt(d2) if sqrt else d2).to(out)


def cdist_tile(x: torch.Tensor, y: torch.Tensor, sqrt: bool = True,
               out_dtype=None) -> torch.Tensor:
    """Pairwise L2 distances ``(m, d) x (n, d) -> (m, n)`` (squared when
    ``sqrt=False``), accumulated in float32 (float64 for float64 output).
    The output dtype is the promoted input dtype, float32 for integer input,
    or ``out_dtype``."""
    _check_pair(x, y)
    if _plain(x, y):
        return cdist_tile_plain(x, y, sqrt, out_dtype)
    index = _on_card(x, y)
    out, acc = _cdist_dtypes(x, y, out_dtype)
    if acc == torch.float64:
        in_dt = torch.float64
    elif x.dtype == y.dtype and x.dtype in _KERNEL_INPUTS:
        in_dt = x.dtype
    else:
        in_dt = torch.float32  # integer or mixed inputs, as heat_tpu casts them
    x, y = x.to(in_dt), y.to(in_dt)
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("cdist_tile needs contiguous inputs")
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    res = x.new_empty((m, n), dtype=out)
    if m == 0 or n == 0:
        return res
    grid, tile_rows = _cdist_plan(m, n, d, _CODES[in_dt], _CODES[out], index)
    _launch("cdist_tile", index, x.data_ptr(), y.data_ptr(), res.data_ptr(), m, n, d,
            _CODES[in_dt], _CODES[out], int(bool(sqrt)), grid, tile_rows)
    return res


# --------------------------------------------------------------------------- #
# fused KMeans Lloyd step                                                     #
# --------------------------------------------------------------------------- #


def _check_step(x, centroids, valid_mask) -> None:
    if x.ndim != 2 or centroids.ndim != 2:
        raise ValueError("kmeans_step needs x (n, d) and centroids (k, d)")
    if x.shape[1] != centroids.shape[1] or x.shape[1] == 0 or centroids.shape[0] == 0:
        raise ValueError(f"kmeans_step: bad shapes x {tuple(x.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    if valid_mask is not None and (valid_mask.dtype != torch.bool
                                   or tuple(valid_mask.shape) != (x.shape[0],)):
        raise ValueError("valid_mask must be a bool tensor of shape (n,)")


def kmeans_step_plain(x: torch.Tensor, centroids: torch.Tensor,
                      valid_mask: Optional[torch.Tensor] = None, return_labels: bool = False):
    """Plain PyTorch version of :func:`kmeans_step`."""
    _check_step(x, centroids, valid_mask)
    acc = types.accumulation_dtype(x.dtype)
    k = centroids.shape[0]
    xf, cf = x.to(acc), centroids.to(acc)
    c2 = torch.sum(cf * cf, dim=1)
    scores = c2[None, :] - 2.0 * (xf @ cf.T)
    min_s, labels = torch.min(scores, dim=1)  # first index of the minimum
    x2 = torch.sum(xf * xf, dim=1)
    valid = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
             if valid_mask is None else valid_mask)
    onehot = ((labels[:, None] == torch.arange(k, device=x.device)[None, :])
              & valid[:, None]).to(acc)
    sums = onehot.T @ xf
    counts = onehot.sum(dim=0)
    inertia = torch.where(valid, min_s + x2, torch.zeros((), dtype=acc, device=x.device)).sum()
    res = (sums.to(x.dtype), counts.to(x.dtype), inertia.to(x.dtype))
    return res + (labels.to(torch.int32),) if return_labels else res


def kmeans_step(x: torch.Tensor, centroids: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None, return_labels: bool = False):
    """One Lloyd partial over a local shard, reading ``x`` once: per-cluster
    sums ``(k, d)``, counts ``(k,)`` and the inertia over the rows where
    ``valid_mask`` (bool ``(n,)``, default all) is set, in ``x``'s dtype.
    With ``return_labels`` it also returns every row's cluster (int32
    ``(n,)``), which lets a check hold the counts and sums against the labels
    the kernel chose. The card takes float32 and float64 at any ``k·d``:
    where the centroids and partial sums do not fit a block's shared memory
    the kernel streams the centroids in chunks and keeps each block's sums
    in its workspace row (``csrc/kmeans_step.cu``); only a row wider than
    half a block's shared memory (float32 ``d`` > ~29,000) is refused."""
    _check_step(x, centroids, valid_mask)
    if _plain(x, centroids, valid_mask):
        return kmeans_step_plain(x, centroids, valid_mask, return_labels)
    index = _on_card(x, centroids, valid_mask)
    if x.dtype not in (torch.float32, torch.float64) or centroids.dtype != x.dtype:
        raise ValueError(f"kmeans_step takes float32 or float64 x and centroids of the same "
                         f"dtype, got {x.dtype} and {centroids.dtype}")
    if not all(t is None or t.is_contiguous() for t in (x, centroids, valid_mask)):
        raise ValueError("kmeans_step needs contiguous inputs")
    n, d = x.shape
    k = centroids.shape[0]
    tile_rows, grid, chunk = _kmeans_plan(n, d, k, _CODES[x.dtype], index)
    width = k * d + k + 1
    ws = x.new_empty(grid * width)
    out = x.new_empty(width)
    labels = x.new_empty(n, dtype=torch.int32) if return_labels else None
    _launch("kmeans_step", index, x.data_ptr(), centroids.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if labels is None else labels.data_ptr(), n, d, k,
            _CODES[x.dtype], grid, tile_rows, chunk)
    res = (out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k])
    return res + (labels,) if return_labels else res


# --------------------------------------------------------------------------- #
# flash attention forward                                                     #
# --------------------------------------------------------------------------- #


def _check_attention(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention needs 4-D (B, H, S, D) inputs, got {q.ndim}-D, "
                         f"{k.ndim}-D and {v.ndim}-D")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k and v of shape "
                         f"(B, H, Sk, D) alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise ValueError(f"flash_attention needs q, k and v of one floating dtype, got "
                         f"{q.dtype}, {k.dtype} and {v.dtype}")
    if q.shape[3] == 0:
        raise ValueError("flash_attention needs a head dim of at least 1")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, causal: bool = False,
                          return_lse: bool = False, block_q: int = 256, block_k: int = 256):
    """Plain PyTorch version of :func:`flash_attention`: the same masks,
    scale and empty-row rule, computed densely (``block_q``/``block_k`` are
    accepted and ignored)."""
    _check_attention(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    if Sk == 0:  # no key: every row is empty
        out = torch.full((B, H, Sq, D), float("nan"), dtype=q.dtype, device=dev)
        lse = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=dev)
        return (out, lse) if return_lse else out
    s = (q.to(acc) * scale) @ k.to(acc).transpose(-1, -2)
    if causal:
        row = torch.arange(Sq, device=dev)[:, None]
        col = torch.arange(Sk, device=dev)[None, :]
        mask = col <= row + (Sk - Sq)
        s = torch.where(mask, s, torch.full((), _NEG_BIG, dtype=acc, device=dev))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), torch.zeros((), dtype=acc, device=dev))
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    l_safe = torch.where(empty, torch.ones((), dtype=acc, device=dev), l)
    out = torch.where(empty, torch.full((), float("nan"), dtype=acc, device=dev),
                      (p @ v.to(acc)) / l_safe).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(empty, torch.full((), float("-inf"), dtype=acc, device=dev),
                      m + torch.log(l_safe))[..., 0].to(torch.float32)
    return out, lse


def _check_card_attention(q, k, v) -> int:
    """What the flash kernels take on the card, beyond :func:`_check_attention`;
    returns the card's index."""
    index = _on_card(q, k, v)
    if q.dtype not in _KERNEL_INPUTS:
        raise ValueError(f"flash_attention on the card takes float32, bfloat16 or float16, "
                         f"got {q.dtype}")
    if q.shape[3] > _FLASH_MAX_D:
        raise ValueError(f"flash_attention on the card takes head dims up to {_FLASH_MAX_D}, "
                         f"got {q.shape[3]}")
    if -(-q.shape[2] // _FLASH_TILE) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention takes at most {_MAX_GRID_Y * _FLASH_TILE} query "
                         f"rows, got {q.shape[2]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous inputs")
    return index


def _flash_launch(q, k, v, scale: float, causal: bool, index: int):
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    lse = q.new_empty((B, H, Sq), dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    if Sk == 0:  # no key: every row is empty
        return out.fill_(float("nan")), lse.fill_(float("-inf"))
    ws = _split_workspace(q, k, backward=False)
    _launch("flash_attention", index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if ws is None else ws.data_ptr(), B * H, Sq, Sk, D,
            _CODES[q.dtype], scale, int(causal))
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """heat_tpu's ``_flash_diff`` (``pallas_kernels.py:643-689``): the
    forward saves ``q, k, v, out, lse``; the backward recomputes the
    probabilities from the lse. On the card the forward is the flash kernel
    and the backward launches :func:`flash_bwd_dkv`, then
    :func:`flash_bwd_dq`; on the CPU the forward is
    :func:`flash_attention_plain` and the backward
    :func:`flash_attention_bwd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if _plain(q, k, v):
            out, lse = flash_attention_plain(q, k, v, scale, causal, return_lse=True)
        else:
            out, lse = _flash_launch(q, k, v, scale, causal, q.get_device())
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        if _plain(q, k, v):
            grads = flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse, ctx.scale,
                                              ctx.causal)
            return grads + (None, None)
        dmb = _dmb(out, dout, dlse)
        _check_backward(q, k, v, dout, lse, dmb)
        index = _check_card_backward(q, k, v, dout, lse, dmb)
        # float32: dK/dV's launch writes the split planes, dQ's reads them
        ws = _split_workspace(q, k)
        dk, dv, split = _dkv_launch(q, k, v, dout, lse, dmb, ctx.scale, ctx.causal, index, ws,
                                    True)
        dq = _dq_launch(q, k, v, dout, lse, dmb, ctx.scale, ctx.causal, index, ws, not split)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = False,
                    return_lse: bool = False, block_q: int = 256, block_k: int = 256):
    """Blockwise attention with online softmax (heat_tpu
    ``pallas_kernels.flash_attention``).

    ``q``: ``(B, H, Sq, D)``; ``k``/``v``: ``(B, H, Sk, D)``, one floating
    dtype. Returns ``softmax((q * scale) kᵀ) v`` in ``q``'s dtype (``scale``
    defaults to ``1/sqrt(D)``), plus the per-row log-sum-exp ``(B, H, Sq)``
    in float32 when ``return_lse``. ``causal`` masks with the end-aligned
    diagonal: key ``j`` is visible to query ``i`` iff ``j <= i + Sk - Sq``;
    a row with no visible key gives NaN and an lse of ``-inf``. Accumulation
    is float32 (float64 for float64 input on the CPU).

    Differentiable in ``q``, ``k`` and ``v``, through the output and the
    lse: the backward recomputes the probabilities from the saved lse (the
    flash backward kernels on the card, :func:`flash_attention_bwd_plain` on
    the CPU), so no ``(Sq, Sk)`` matrix is kept between the passes.

    On the card the kernels take float32, bfloat16 and float16, contiguous
    inputs and head dims up to 128; float64 raises (ROADMAP). Every dtype
    runs on the tensor cores at float32 accuracy, the forward and both
    backward kernels alike (float32: six split-bf16 passes a product, after
    a split pass into bf16 planes). The card uses its own tiles and ignores
    ``block_q``/``block_k``, which stay for heat_tpu's signature: results do
    not depend on tile sizes. Where no gradient can flow (grad mode off, or
    no input requires grad) the call skips the autograd machinery: the same
    kernel, outputs and launch count.
    """
    _check_attention(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    causal = bool(causal)
    plain = _plain(q, k, v)
    index = None if plain else _check_card_attention(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, scale, causal)
    elif plain:
        out, lse = flash_attention_plain(q, k, v, scale, causal, return_lse=True)
    else:
        out, lse = _flash_launch(q, k, v, scale, causal, index)
    return (out, lse) if return_lse else out


# --------------------------------------------------------------------------- #
# flash attention backward                                                    #
# --------------------------------------------------------------------------- #


def _dmb(out, dout, dlse):
    """``dlse - rowsum(dout * out)`` in the accumulation dtype (heat_tpu
    ``pallas_kernels.py:571-573``); a missing ``dlse`` is zero."""
    acc = torch.float64 if out.dtype == torch.float64 else torch.float32
    delta = (dout.to(acc) * out.to(acc)).sum(dim=-1)
    return -delta if dlse is None else dlse.to(acc) - delta


def _check_backward(q, k, v, dout, lse, dmb) -> None:
    _check_attention(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash backward: dout must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("dmb", dmb)):
        if tuple(t.shape) != tuple(q.shape[:3]) or not t.dtype.is_floating_point:
            raise ValueError(f"flash backward: {name} must be a floating (B, H, Sq) tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_dense(q, k, v, dout, lse, dmb, scale: float, causal: bool):
    """The dense backward's tiles, in the accumulation dtype: ``q`` and
    ``dout`` upcast, the probabilities ``p`` recomputed from the lse (zero
    where the pair is masked or the lse is not finite) and the score
    cotangent ``ds = p * (dout vᵀ + dmb)``."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    Sq, Sk = q.shape[2], k.shape[2]
    qf, kf, vf, of = (t.to(acc) for t in (q, k, v, dout))
    s = (qf * scale) @ kf.transpose(-1, -2)
    lse_c = lse.to(acc)[..., None]
    ok = torch.isfinite(lse_c)
    if causal:
        row = torch.arange(Sq, device=dev)[:, None]
        col = torch.arange(Sk, device=dev)[None, :]
        ok = ok & (col <= row + (Sk - Sq))
    p = torch.where(ok, torch.exp(s - lse_c), torch.zeros((), dtype=acc, device=dev))
    ds = p * (of @ vf.transpose(-1, -2) + dmb.to(acc)[..., None])
    return qf, kf, of, p, ds


def flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, scale: Optional[float] = None,
                        causal: bool = False):
    """Plain PyTorch version of :func:`flash_bwd_dkv`."""
    _check_backward(q, k, v, dout, lse, dmb)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    qf, _, of, p, ds = _bwd_dense(q, k, v, dout, lse, dmb, scale, causal)
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ of
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, dout, lse, dmb, scale: Optional[float] = None,
                       causal: bool = False):
    """Plain PyTorch version of :func:`flash_bwd_dq`."""
    _check_backward(q, k, v, dout, lse, dmb)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    _, kf, _, _, ds = _bwd_dense(q, k, v, dout, lse, dmb, scale, causal)
    return ((ds @ kf) * scale).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse=None, scale: Optional[float] = None,
                              causal: bool = False):
    """The whole flash backward in plain PyTorch (heat_tpu's dense fallback,
    ``pallas_kernels.py:668-686``, accumulated in float64 for float64 input):
    ``(dq, dk, dv)`` in the inputs' dtypes for the cotangents ``dout`` of
    the output and ``dlse`` of the lse (``None`` is zero)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    dmb = _dmb(out, dout, dlse)
    _check_backward(q, k, v, dout, lse, dmb)
    qf, kf, of, p, ds = _bwd_dense(q, k, v, dout, lse, dmb, scale, causal)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ of
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _split_workspace(q, k, backward: bool = True):
    """The float32 kernels' workspace: their inputs (q, k, v, and for the
    backward dout) as three bf16 planes each (their exact split3 terms; the
    forward's q times the scale), rows padded to a multiple of 8 columns
    (``csrc/sm90_common.cuh`` ``split_inputs``); nothing for other dtypes."""
    if q.dtype != torch.float32:
        return None
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    d8 = -(-D // 8) * 8
    rows = 2 * (Sq + Sk) if backward else Sq + 2 * Sk
    return torch.empty(3 * B * H * d8 * rows, dtype=torch.bfloat16, device=q.device)


def _check_card_backward(q, k, v, dout, lse, dmb) -> int:
    """What the flash backward kernels take on the card; returns its index."""
    _check_card_attention(q, k, v)
    index = _on_card(q, k, v, dout, lse, dmb)
    if lse.dtype != torch.float32 or dmb.dtype != torch.float32:
        raise ValueError(f"flash backward on the card takes float32 lse and dmb, got "
                         f"{lse.dtype} and {dmb.dtype}")
    if not all(t.is_contiguous() for t in (dout, lse, dmb)):
        raise ValueError("flash backward needs contiguous dout, lse and dmb")
    if -(-k.shape[2] // _FLASH_TILE) > _MAX_GRID_Y:
        raise ValueError(f"flash backward takes at most {_MAX_GRID_Y * _FLASH_TILE} keys, got "
                         f"{k.shape[2]}")
    return index


def _dkv_launch(q, k, v, dout, lse, dmb, scale: float, causal: bool, index: int, ws,
                split: bool):
    """dK and dV on card ``index``; for float32 through the split planes in
    ``ws``, which the launch writes first where ``split`` is set. Returns
    (dk, dv, whether the split planes were written)."""
    B, H, Sq, D = q.shape
    if Sq == 0:  # no query: nothing reaches k or v
        return torch.zeros_like(k), torch.zeros_like(v), False
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv, False
    _launch("flash_bwd_dkv", index, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dmb.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if ws is None else ws.data_ptr(), int(split), B * H, Sq, k.shape[2], D,
            _CODES[q.dtype], float(scale), int(bool(causal)))
    return dk, dv, split and ws is not None


def _dq_launch(q, k, v, dout, lse, dmb, scale: float, causal: bool, index: int, ws,
               split: bool):
    """dQ on card ``index``, with the split planes of :func:`_dkv_launch`."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if Sk == 0:  # no key: every score cotangent is empty
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq", index, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dmb.data_ptr(), dq.data_ptr(), None if ws is None else ws.data_ptr(),
            int(split), B * H, Sq, Sk, D, _CODES[q.dtype], float(scale), int(bool(causal)))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dmb, scale: Optional[float] = None,
                  causal: bool = False):
    """dK and dV of attention (heat_tpu ``_flash_bwd_dkv_kernel``): for the
    forward's ``q, k, v`` and lse, the output cotangent ``dout`` and
    ``dmb = dlse - rowsum(dout * out)`` (``(B, H, Sq)``), with the
    probabilities ``p`` recomputed from the lse (zero where masked or where
    the lse is not finite) and ``ds = p * (dout vᵀ + dmb)``, returns
    ``dk = scale * dsᵀ q`` and ``dv = pᵀ dout`` in k's and v's dtypes."""
    _check_backward(q, k, v, dout, lse, dmb)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if _plain(q, k, v, dout, lse, dmb):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, scale, causal)
    index = _check_card_backward(q, k, v, dout, lse, dmb)
    dk, dv, _ = _dkv_launch(q, k, v, dout, lse, dmb, scale, causal, index,
                            _split_workspace(q, k), True)
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, dmb, scale: Optional[float] = None, causal: bool = False):
    """dQ of attention (heat_tpu ``_flash_bwd_dq_kernel``): the inputs of
    :func:`flash_bwd_dkv`; returns ``dq = scale * ds k`` in q's dtype."""
    _check_backward(q, k, v, dout, lse, dmb)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if _plain(q, k, v, dout, lse, dmb):
        return flash_bwd_dq_plain(q, k, v, dout, lse, dmb, scale, causal)
    index = _check_card_backward(q, k, v, dout, lse, dmb)
    return _dq_launch(q, k, v, dout, lse, dmb, scale, causal, index, _split_workspace(q, k),
                      True)


# --------------------------------------------------------------------------- #
# toolchain probe                                                             #
# --------------------------------------------------------------------------- #


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe`."""
    return x + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` over a float32 tensor (heat_tpu probes with zeros of shape
    (8, 128)) in one launch of the probe kernel. The library runs it once
    when it loads; a serving engine runs it on its own card. It gates
    nothing: a card that cannot run the kernels fails here with the CUDA
    error."""
    if x.dtype != torch.float32:
        raise ValueError(f"probe takes float32, got {x.dtype}")
    if _plain(x):
        return probe_plain(x)
    index = _on_card(x)
    n = x.numel()
    if n == 0 or not x.is_contiguous():
        raise ValueError("probe needs a contiguous, non-empty tensor")
    out = torch.empty_like(x)
    _launch("probe", index, x.data_ptr(), out.data_ptr(), n)
    return out
