#!/usr/bin/env python3
"""Drive heat_tpu_torch's main paths once on one CUDA card, and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:

1. card: ``nvidia-smi`` name and power limit, the TF32 and reduced-precision
   bf16 GEMM switches (the port never turns TF32 on).
2. build: ``nvcc`` builds every kernel from ``heat_tpu_torch/csrc``; the
   library runs the probe kernel once as it loads.
3. probe: one launch of the probe kernel, held bitwise against ``x + 1``;
   then where the host time of a wrapper call goes (``host_breakdown``: the
   probe and the flash forward at the prefill shape, whole and step by
   step, and the KMeans kernels' wrappers with their plans, µs per call over
   1,000 calls).
4. kernels: each CUDA kernel against its plain PyTorch version at the main
   paths' shapes, with its time (CUDA events around 10 back-to-back calls,
   median of 10 such samples), the plain
   version's time, the bound the card allows, and one PyTorch call that
   computes the same function where there is one; for ``cdist_tile`` and
   ``kmeans_step`` also the TB/s they reach over the bytes their bound
   counts and their share of that bound.
5. KMeans path: the README quick start at full size — 2^23 x 64 float32
   points, ``KMeans(n_clusters=8, init="kmeans++", max_iter=20, tol=-1)``,
   ``predict``, and the 40,000 x 18 ``cdist`` — with the launch counts of
   each kernel in that run, the result held against a plain Lloyd loop, and
   Lloyd iterations per second.
5b. array path: on the KMeans benchmark's data (2^23 x 64 float32
   points, a second array of weights, a replicated row of 64; bench.py:40-44,
   :495-503), ``ht.mean``/``var``/``std`` along axis 0 and along all axes,
   ``var(ddof=1)``, the weighted ``average``, ``max``/``argmax``/``min``/
   ``argmin``, ``cumsum``, ``(X > 0.5).sum()``, bench.py's 16-op chain and
   moment chains (``:495-533``), each checked against float64 on the same
   card tensors within its float32 error bound, with its device ms, bytes,
   bound ms, the same op as raw torch calls on ``X.larray``, and the host µs
   of both; the resplit round trip with its plan kinds; and the closing
   user flow ``Z = (X - ht.mean(X, 0)) / ht.std(X, 0)`` then ``KMeans(8,
   kmeans++, 20 iterations).fit(Z)`` (20 ``kmeans_step`` launches), with
   peak memory and ``comm.stats`` (empty at world size 1).
5c. array tour: on the same 2^23 x 64 float32 points, drawn with
   ``ht.random.uniform``, the boolean mask ``X[X[:, 0] > 0.5]``,
   ``ht.nonzero``, ``ht.where``, the mixed key ``X[idx, 2:6]`` (2^20 rows),
   ``X[1::3]``, ``X[..., None]``, the scatter ``X[idx] = 0.0`` on a copy,
   ``concatenate``, ``stack``, ``reshape``, ``flatten``, ``roll``, ``flip``,
   ``pad`` (constant, edge, and a maximum of the other axis), ``repeat``,
   ``tile``, ``diff``, ``swapaxes``, ``zeros_like``,
   ``full``, ``eye(8192)`` and ``linspace``, each held bitwise against the
   raw torch call on ``X.larray`` (``linspace`` within 4 float32 units of
   its float64 values), with its device ms, bound ms and host µs beside the
   raw call's; then ``F = X[X[:, 0] > 0.5]`` and ``KMeans(8, kmeans++, 20
   iterations).fit(F)`` (20 ``kmeans_step`` launches, centroids within 1e-3
   of a plain Lloyd loop), with peak memory and ``comm.stats``.
5d. order statistics: on the same X, ``ht.sort(X, axis=0)`` (held by
   properties: columns non-decreasing, the input gathered at the indices,
   the indices a permutation, ties in index order), ``ht.percentile`` of a
   column and of all 2^29 elements and ``ht.median(X, 0)`` (against
   ``torch.kthvalue`` and jax's formula in float64), ``ht.unique`` with
   counts and inverse of a column rounded to 1/1000, ``ht.topk`` (against
   the head of the stable descending sort), ``ht.isin`` and the four set
   operations on 2^20 int64 draws (against numpy), ``histogram``,
   ``histc`` and ``bincount`` (numpy on 2^20 rows; the full-size counts sum
   to n), ``searchsorted``, ``digitize``, ``interp``, ``gradient`` and
   ``trapz`` (against float64 on the card), each with its device ms, bound
   ms, raw torch call and host µs; then ``examples/data_pipeline.py``'s
   step 3 with its p90: ``F = X[X[:, 0] > percentile(X[:, 0], 90)]``,
   ``KMeans(8, kmeans++, 20 iterations).fit(F)`` and ``ht.median(F[:, 0])``,
   with peak memory and ``comm.stats``.
5e. linear algebra: ``X @ W`` at bench.py:69's 8192^2 in bf16 and float32
   (TF32 off; 256 rows against float64 within γ_k·|X||W|, plus bf16's
   rounding) and bench.py's GEMM chain (2^14 x 32 split 0, bias, tanh, a
   split-axis sum; against float64 within its error bound), each beside one
   ``torch.matmul``; the 2^23 x 64 draw of 5c (its first 2^20 values, and
   of ``randint``, bitwise the port's CPU draw; ``randn`` within 8 ulp)
   timed beside ``torch.rand``; ``cov(X, rowvar=False)`` within 1e-4 of the
   float64 covariance's largest entry; ``qr`` and ``svd`` of 2^22 x 64 (the
   residual and ``QᵀQ - I`` within 1e-4, S within sqrt(rows)·u·s_max of
   float64);
   ``cholesky``/``solve`` of a 4096^2 SPD matrix and ``det``/``inv`` at
   2048^2 (residuals, det within 1e-3 of float64), each beside the matching
   ``torch.linalg`` call; ``Spectral(n_clusters=4, gamma=1/72,
   n_lanczos=300)`` on four Gaussian blobs at distance_matrix's 40,000 x 18
   (the Lanczos relation ``LV - VT`` and ``VᵀV - I`` within 1e-3, labels
   against the blobs, wall seconds, peak memory, the ``cdist_tile`` (rbf)
   and ``kmeans_step`` launches of the fit); Lasso at the lasso benchmark's
   strong size (2^20 x 64, 100 sweeps, ``lam=0.01``, ``tol=-1``), theta
   within 1e-4 of max |theta| of a plain float64 coordinate descent on the
   card, and seconds per sweep.
5f. file I/O and the out-of-core fit: bench.py's out-of-core dataset
   (100,000,000 float32 elements, 1,562,500 x 64, 400 MB; bench.py:1120-1147)
   written by the port's ``save_netcdf`` (scipy's NetCDF-3 backend) and,
   where h5py imports, ``save_hdf5``; each file streamed back by
   ``load_*(stream=True)`` into ``KMeans(8, init=<seed rows>, max_iter=3,
   tol=-1).fit_stream(stream, rows_per_chunk=2**17)``: 12 chunks a pass (the
   last 120,708 rows), 49 chunks read (1 for the geometry, 36 for the epochs,
   12 for the finalize pass) and 48 ``kmeans_step`` launches, asserted; the
   centroids within 1e-3 and the inertia within a relative 1e-4 of the
   in-memory fit, the peak chunk 2^17 x 64 x 4 bytes and the card's peak
   allocation during the fit under four chunks plus the centroids;
   ``save_csv``/``load_csv`` of 40,000 x 18 float32 (distance_matrix's strong
   size) on the native parser, bitwise, with the MB/s of each direction; and
   ``KMedians``/``KMedoids(8, init="kmeans++", 10 iterations)`` on 2^20 x 64
   float32 (the kmeans cell's width and k at an eighth of its rows), the last
   step checked again in float64 (the medians equal, the medoids member rows
   within the float32 band, labels differing only at near-ties), with the
   seconds per iteration and the launches.
5g. the data engine and the last estimators: bench.py's ``--data-bench``
   sizes (:1217-1290) — ``groupby`` sum/mean/count/min/max of 10,000,000
   float32 values by int64 keys in 64 groups (count, min, max bitwise
   against ``torch.bincount``/``scatter_reduce``, sum and mean within the
   float32 summation bound of a float64 sum), ``data.topk`` of 64 (bitwise
   the head of a stable descending sort), and the exact
   ``stream_quantile`` p50 and p99 of a 100,000,000-element float32
   NetCDF-3 stream (``save_netcdf``) in 2^20-row chunks, linear, lower and
   higher: the picked order statistics bitwise ``torch.kthvalue``'s, the
   linear result numpy's rule on them in float64, with the passes and
   chunks read; ``data.join`` of those 10M rows (keys in [0, 2^21)) to a
   2^21-row dimension table, bitwise a sort-merge join; data_pipeline.py's
   (station, magnitude) table at 10,000,000 rows streamed in 2^20-row
   chunks through ``stream_groupby(16, "mean")`` and ``stream_topk(5)``
   against the in-memory ``groupby`` and ``topk``; ``GaussianNB`` on 2^20 x
   64 float32 in 8 blobs (counts exact, ``theta_``/``var_`` within 1e-10 of
   float64, labels differing only at near-ties of the float64 joint log
   likelihood); ``KNeighborsClassifier(5)`` on 40,000 x 18 against 40,000
   test rows (one ``cdist_tile`` launch asserted, labels against a float64
   top-5 vote, differing only at distance near-ties); the HDF5 loader
   where h5py imports; the engine's counters with both fallbacks at 0.
6. serving path: the flagship TransformerLM (vocab 32,768, d_model 1024,
   16 heads, 8 layers, d_ff 4096, RoPE, bf16; random weights from
   ``init(0)``) on one card — one ``logits_fn`` forward over (8, 1024)
   tokens, ``generate`` of 32 tokens after (8, 1000) prompts, and a
   ``serve_transformer(..., decode=True, slots=8)`` engine answering 80
   requests under the decode bench's load (``bench.py:942-953``) — with
   the flash launch count of that run, the chosen tokens of four requests
   and of ``generate`` held against a float32 copy of the model (the
   near-tie rule, ``bf16_logit_tol``), prefill ms per bucket, serving
   tokens/s with the mean slot occupancy, time to first token under that
   load (queueing included), the busy share of a decode step and a
   prefill, and peak memory.
7. training path: the same flagship model with float32 master weights from
   ``init(0)``, bf16 compute, ``make_train_step(ht.optim.Adam(1e-3))`` on
   the bench's fixed (8, 1024) batch (``bench.py:204-250``): 2 warm-up and
   10 timed steps, with the launches of the flash forward and both backward
   kernels per step, the loss at each step, step ms, training tokens/s, the
   bench's approximate MFU against the card's bf16 peak, the busy share of
   a step and peak memory; before it, one ``loss_and_grad_fn`` call held
   against a float32 copy of the model (``bf16_loss_tol``,
   ``bf16_grad_tol``).
8. grid path: the flagship with examples/nn/gpt_parallel.py's
   ``--moe-experts 4`` (capacity factor 1.25), ``n_micro = 2`` and
   ``remat``, float32 masters, bf16 compute, ``AdamW(1e-3)`` on the same
   (8, 1024) batch, grid (1, 1, 1, 1) (one card: NCCL refuses two ranks on
   one device): one ``loss_and_grad_fn`` held against a float32 copy that
   routes every token to the bf16 model's expert (the routing flips
   counted), 2 warm-up and 5 timed steps with the flash launches per step
   held to remat's count (forward twice a layer and microbatch, each
   backward once), step ms, tokens/s, the MoE drop share, the busy share,
   and peak memory beside one step without remat (which must peak higher).
   Then every rank's block calls of a 4-rank causal ring (blocks of 256
   rows) and zigzag ring (chunks of 128) at the flagship's attention shape
   (8, 16, 1024, 64) bf16, through ``nn.attention._block_attn`` and
   ``_fold``: 16 and 36 forward launches and as many of each backward
   kernel, the folded output, lse and q/k/v gradients held against one
   causal flash call over the whole sequence and against the same
   schedule on the plain version. Then ``nn.DataParallel`` on
   examples/nn/mlp_train.py's network and first batch, three steps of
   each of the six optimizer constructors: finite losses that fall.
9. serving executor: the flagship with float32 masters and bf16 compute,
   ``make_train_step(Adam(1e-3))`` on the (8, 1024) batch for 4 steps under
   ``run_with_recovery`` with a ``CheckpointManager(every_steps=1,
   keep=2)``: the first save's leaf write fails once (the fault plan
   ``checkpoint.leaf.write=once``, retried), the loop crashes after step 3's
   save and resumes from it; the result held bitwise against two
   uninterrupted runs (or within their difference, where they differ),
   with seconds and bytes a save. Then ``load_checkpoint`` and
   ``serve_transformer`` of the restored weights at 1024 tokens: warmup of
   buckets 1-8 (4 programs), a paused wave of 8 one-row requests as one
   bucket-8 batch (8 flash launches, every one on the worker's stream),
   its logits bitwise the in-memory weights', each argmax under the
   near-tie rule of a float32 copy, one prompt served alone within
   ``bf16_logit_tol``; where a batch's time goes (payload copy, forward,
   fetch of its 1 GiB of logits, the per-request copies), then an open
   loop of 10 s with two tenants (priorities 0 and 1) at 0.5 and 0.3 of the
   estimated capacity: latencies, outcomes, rows/s, 8 flash launches a
   batch, no program built after warmup, no batch retried. Then
   ``serve_estimator`` of phase 5's KMeans and of phase 5g's KNN with
   requests of 1-4096 rows, labels held against ``predict`` (float64
   near-ties aside), rows/s; and two decode engines at temperature 0.8
   (seed 0, two tenants, one wave of 8 requests) whose tokens repeat
   bitwise, with one step's Threefry words and uniforms on the card equal
   to the CPU's.

Phase 4 holds the flash forward (``csrc/flash_fwd_sm90.cu``) and the flash
backward kernels (``csrc/flash_bwd_dkv_sm90.cu``,
``csrc/flash_bwd_dq_sm90.cu``), all three on the tensor cores in bf16,
float16 and float32 (float32 after a split pass into three bf16 planes a
tensor), against their plain versions (``check_flash``,
``check_flash_bwd``) at the serving and training paths' shapes in each
dtype, at ragged lengths, empty rows, 300 queries against 4096 keys,
(float32) head dim 128 and one query against 200 keys, and (float16) wide
scores, gradients of σ 2^-14 and score cotangents past float16's range,
each bitwise repeatable, with their times, bounds, the float32 split
pass's share, SDPA's times, the aten flash backward's (bf16, float16) and
the aten memory-efficient backward's (float32). At the prefill shape the
forward's wrapper host time per call is measured apart from the kernel's
device time. Phase 3's
``kmeans_step`` checks add two shapes whose k·d takes the streaming path
(2^20 x 64 at k = 128, 2^17 x 1024 at k = 64).

Then the kernels line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits non-zero and prints no last line. It exits non-zero at once where no
CUDA card is visible.
"""

import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N_POINTS, N_FEATURES, K, ITERS = 2**23, 64, 8, 20
CDIST_N, CDIST_D = 40_000, 18
U32 = 2.0**-24  # float32 unit roundoff
U_BF16 = 2.0**-8  # bfloat16 unit roundoff
# tensor-core passes of a product of two float32 operands, each split into
# its three bf16 terms (split3): the largest cross terms of the two splits,
# (0,0), (0,1), (1,0), (1,1), (0,2), (2,0), ... The fewest that pass the
# checks in every case of tests/test_torch_sm90_precision.py (which
# emulates them with these constants, and refuses one fewer), and that the
# float32 kernels run (Layout::NP of csrc/flash_fwd_sm90.cu,
# csrc/flash_bwd_dkv_sm90.cu and csrc/flash_bwd_dq_sm90.cu): six for the
# backward, five refused on the card tests' single query against 200 keys at
# head dim 16; six for the forward, five refused on 16,384 causal rows that
# see one key (each lse is one score); three for the float32 scores x·c of a
# Lloyd step under check_kmeans_step.
F32_PASSES_BWD = 6
F32_PASSES_FWD = 6
F32_PASSES_KMEANS = 3
# tensor-core passes of a product with one float32 operand against a
# float16 one: the float32 operand, scaled by a power of two into float16's
# range (P by 2^15, dS by its running exponent), split into float16 terms.
# Two are the fewest that pass check_flash and check_flash_bwd in every case
# of tests/test_torch_sm90_precision.py (one is refused); a bf16 product
# takes three (split3).
F16_PASSES_SPLIT = 2
BF16_PASSES_SPLIT = 3

# the flagship model (bench.py:204-206, 222-223, transformer_train_metrics
# defaults; README's combined-parallelism model without the experts)
FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096)
# the decode bench's load (bench.py:942-953): R = 10 x slots requests, new
# tokens from its mix, arrival gaps U(0, 2 ms) with a sleep only for gaps
# above 1 ms; prompts of 100-1000 tokens (buckets 128-1024) at this width
SLOTS, SEQ_CAP = 8, 2048
# the training bench's batch and step count (bench.py:204-250)
TRAIN_BATCH, TRAIN_STEPS = (8, 1024), 10
N_REQ = 10 * SLOTS
MAX_NEW_MIX = ([8, 12, 16, 24, 192], [0.30, 0.30, 0.15, 0.10, 0.15])  # bench.py:948-949
GAP_MAX_S, GAP_SLEEP_S = 2e-3, 1e-3  # bench.py:953, :984
# bf16 roundings one layer adds to the residual stream: the two norms, q,
# k and v, the two RoPE casts, the attention output, the projection and
# its residual add, the MLP up, GELU, down and its residual add
ROUNDINGS_PER_LAYER = 12
KAPPA = 6.0  # standard deviations of the rounding walk allowed per logit

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s, fp32 and fp64 FLOP/s outside the tensor cores, and the
# bf16 tensor-core rate (the flash forward's bound, see flash_bound).
_PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12, 25.6e12, 756e12),
    "H100 NVL": (3.9e12, 60.0e12, 30.0e12, 835e12),
    "H200": (4.8e12, 67.0e12, 34.0e12, 989e12),
    "H100": (3.35e12, 67.0e12, 34.0e12, 989e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    for key, val in _PEAKS.items():
        if key in name:
            return key, val
    return "H100", _PEAKS["H100"]


def time_ms(torch, fn, reps=10, inner=10):
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls of ``fn``, per call, after one warm-up call. Queued
    launches hide the host's per-call overhead behind the card's work, so a
    short kernel's time is its own and not the launch latency."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def host_us(torch, fn, n=1000, chunk=100):
    """Host µs per call of ``fn`` over ``n`` calls, by ``time.perf_counter_ns``
    around chunks of ``chunk`` back-to-back calls, the card drained before
    each chunk (not timed), so queued launches never fill the launch queue
    and stall the host: the figure is the host's own cost of a call."""
    fn()
    total = 0
    for _ in range(n // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(chunk):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / n / 1e3


def host_breakdown(torch, tk, lib, dev, gen):
    """Where a wrapper's host time goes, in µs per call over 1,000 calls
    (:func:`host_us`): the probe at (8, 128) float32 and the flash forward at
    the prefill shape (1, 16, 1024, 64) bf16 causal under ``torch.no_grad``,
    whole and step by step: the checks, the output allocation, the ctypes
    call with the C side's work inside it (the device check, and for the
    flash forward three tensor-map encodes), the shared launch path
    (``kernels._launch``: library, raw stream, ctypes call, count), and for
    the flash forward the launch with and without ``autograd.Function.apply``
    around it; beside the probe, ``torch.add`` whole, its library yardstick.
    Then ``kmeans_step`` and ``cdist_tile`` at a small shape: the wrapper
    whole, its plan from the wrapper's cache and the C planner's own call,
    which every call paid before the cache. Then the steps that the launch
    path before this design paid
    on every call, alone: the stream lookup as a ``Stream`` object (against
    the raw handle), a ``torch.cuda.device`` guard entered and left, the
    library lock taken and released (against the lock-free lookup)."""
    from heat_tpu_torch.core import _build

    H, DH = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    x = torch.randn(8, 128, device=dev, generator=gen)
    q, k, v = (torch.randn(1, H, 1024, DH, device=dev, generator=gen).bfloat16()
               for _ in range(3))
    scale, idx = 1.0 / math.sqrt(DH), dev.index
    out_p, out = torch.empty_like(x), torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    flash_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), None,
                  H, 1024, 1024, DH, 2, scale, 1)

    def probe_checks():
        return (x.dtype != torch.float32, x.is_cpu, tk._on_card(x), x.numel(),
                x.is_contiguous())

    def flash_checks():
        tk._check_attention(q, k, v)
        tk._plain(q, k, v)
        tk._check_card_attention(q, k, v)

    def device_guard():
        with torch.cuda.device(dev):
            pass

    def library_lock():
        with _build._lock:
            pass

    res = {"probe_8x128_f32": {
        "wrapper": host_us(torch, lambda: tk.probe(x)),
        "checks": host_us(torch, probe_checks),
        "alloc": host_us(torch, lambda: torch.empty_like(x)),
        "ctypes_call": host_us(torch, lambda: lib.heat_probe(
            x.data_ptr(), out_p.data_ptr(), x.numel(), idx, stream)),
        "launch_path": host_us(torch, lambda: tk._launch(
            "probe", idx, x.data_ptr(), out_p.data_ptr(), x.numel())),
        "torch.add_whole": host_us(torch, lambda: torch.add(x, 1.0))}}
    with torch.no_grad():
        res["flash_attention_1x16x1024x64_bf16_causal_no_grad"] = {
            "wrapper": host_us(torch, lambda: tk.flash_attention(q, k, v, causal=True)),
            "checks": host_us(torch, flash_checks),
            "alloc": host_us(torch, lambda: (torch.empty_like(q), q.new_empty(
                q.shape[:3], dtype=torch.float32))),
            "ctypes_call": host_us(torch, lambda: lib.heat_flash_attention(
                *flash_args, idx, stream)),
            "launch_path": host_us(torch, lambda: tk._launch("flash_attention", idx,
                                                             *flash_args)),
            "launch_without_autograd": host_us(
                torch, lambda: tk._flash_launch(q, k, v, scale, True, idx)),
            "autograd_apply_with_launch": host_us(
                torch, lambda: tk._FlashAttention.apply(q, k, v, scale, True))}
    # the KMeans kernels at a small shape (the host's cost does not follow
    # it): the wrapper whole, its plan from the wrapper's cache, and the C
    # planner's call that the wrapper made on every call before the cache
    xk = torch.rand(4096, 64, device=dev, generator=gen)
    ck = xk[:8].clone()
    outs = [ctypes.c_int() for _ in range(3)]
    res["kmeans_step_4096x64_k8"] = {
        "wrapper": host_us(torch, lambda: tk.kmeans_step(xk, ck)),
        "plan_cached": host_us(torch, lambda: tk._kmeans_plan(4096, 64, 8, 0, idx)),
        "plan_call": host_us(torch, lambda: lib.heat_kmeans_step_plan(
            4096, 64, 8, 0, *(ctypes.byref(o) for o in outs), idx))}
    res["cdist_tile_4096x64_vs_8"] = {
        "wrapper": host_us(torch, lambda: tk.cdist_tile(xk, ck)),
        "plan_cached": host_us(torch, lambda: tk._cdist_plan(4096, 8, 64, 0, 0, idx)),
        "plan_call": host_us(torch, lambda: lib.heat_cdist_tile_plan(
            4096, 8, 64, 0, 0, *(ctypes.byref(o) for o in outs[:2]), idx))}
    res["former_launch_path_steps"] = {
        "stream_object": host_us(torch, lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": host_us(torch, lambda: torch._C._cuda_getCurrentRawStream(idx)),
        "device_guard": host_us(torch, device_guard),
        "library_lock": host_us(torch, library_lock),
        "library_lookup": host_us(torch, _build.library)}
    return res


def bound(nbytes, ops, bw, rate):
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cdist_bytes(m, n, d, in_bytes, out_bytes):
    """Each input read once, the output written once."""
    return (m + n) * d * in_bytes + m * n * out_bytes


def cdist_bound(m, n, d, in_bytes, out_bytes, bw, f32):
    # 2mnd for the products, 2(m+n)d for the norms, 5mn for the epilogue
    # (add, fma, clamp, sqrt, cast)
    return bound(cdist_bytes(m, n, d, in_bytes, out_bytes),
                 2 * m * n * d + 2 * (m + n) * d + 5 * m * n, bw, f32)


def kmeans_bytes(n, d, k):
    """A float32 Lloyd partial's bytes: x read once, the centroids once, the
    sums, counts and inertia written once."""
    return n * d * 4 + k * d * 4 + (k * d + k + 1) * 4


def reach(nbytes, ms, bound_ms):
    """What a kernel reaches: its achieved TB/s over the bytes its bound
    counts, and its share of the bound (bound_ms / ms)."""
    return {"achieved_TB_per_s": nbytes / (ms * 1e-3) / 1e12, "bound_over_ms": bound_ms / ms}


def kmeans_bound(n, d, k, bw, f32, tc_rate):
    """The least time of a float32 Lloyd partial: :func:`kmeans_bytes`; the
    n·k products x·c of two float32 operands on the bf16 tensor cores,
    :data:`F32_PASSES_KMEANS` split-bf16 passes of 2·d FLOPs each
    (:func:`flash_bound_f32`'s rule), and per row the |x|², the k score
    updates and the fold into the sums, 3·d + 3·k operations, at the float32
    rate."""
    t_bytes = kmeans_bytes(n, d, k) / bw * 1e3
    t_ops = (F32_PASSES_KMEANS * 2 * n * k * d / tc_rate + (3 * n * d + 3 * n * k) / f32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def d2_tol(d, scale):
    """Bound on the difference of two float32 evaluations of
    x² + y² − 2·x·y (or of c² − 2·x·c): each is within 2·(d + 3)·u·scale of
    the exact value (scale = |x|² + |y|², per element or its maximum), so two
    differ by at most twice that."""
    return 4 * (d + 3) * U32 * scale


def check_cdist(torch, tk, x, y, sqrt, rtol=0.0, got=None):
    """The kernel's output (``got``, else a new launch) against the plain
    version on every row, a stripe of rows at a time. Each squared distance
    may differ by ``d2_tol`` of its own |x|² + |y|²; a distance by that over
    √a + √b, since |√a − √b| = |a − b| / (√a + √b), and never by more than
    √tol; ``rtol`` adds one rounding of a half-precision output. Returns the
    max abs error and the largest ratio of error to limit."""
    if got is None:
        got = tk.cdist_tile(x, y, sqrt=sqrt)
    assert got.dtype == tk.cdist_tile_plain(x[:1], y[:1]).dtype, got.dtype
    assert got.shape == (x.shape[0], y.shape[0]), got.shape
    y2 = (y.float() ** 2).sum(1)[None, :]
    stripe = max(8192, 2**26 // y.shape[0])
    err_max = ratio_max = 0.0
    for r in range(0, x.shape[0], stripe):
        xs = x[r:r + stripe]
        want = tk.cdist_tile_plain(xs, y, sqrt=sqrt).float()
        g = got[r:r + stripe].float()
        tol = d2_tol(x.shape[1], (xs.float() ** 2).sum(1)[:, None] + y2)
        if sqrt:
            tol = torch.minimum(tol.sqrt(), tol / (g + want))
        limit = tol + rtol * want.abs()
        err = (g - want).abs()
        bad = int((err > limit).sum())
        assert bad == 0, f"cdist_tile: {bad} elements of rows {r}.. beyond their tolerance"
        err_max = max(err_max, float(err.max()))
        ratio_max = max(ratio_max, float((err / limit).max()))
        del want, g, tol, limit, err
    return err_max, ratio_max


def check_kmeans_step(torch, x, c, mask, got, want):
    """The kernel's Lloyd partial (``got``) against the plain one (``want``),
    both with each row's label. A row may take another label in the two
    versions, or another than the float64 argmin, only where its two best
    scores lie within ``d2_tol`` of its |x|² + max|c|² (a near-tie). The
    counts must equal the counts of each version's own labels exactly; the
    sums must match a float64 sum over the kernel's labels within rel 1e-5 of
    Σ|x| per element (blocked float32 sums of a few thousand terms each), the
    inertia a float64 Σ|x − c|² over the kernel's labels within rel 1e-5."""
    k, d = c.shape
    sums, counts, inertia, lab = got
    xd, cd = x.double(), c.double()
    scores = (cd ** 2).sum(1)[None, :] - 2.0 * (xd @ cd.T)
    top2 = torch.topk(scores, 2, dim=1, largest=False).values
    x2 = (xd ** 2).sum(1)
    near = top2[:, 1] - top2[:, 0] <= d2_tol(d, x2 + float((cd ** 2).sum(1).max()))
    lab64 = scores.argmin(1)
    del scores, top2, x2
    differ = lab != want[3]
    n_differ = int(differ.sum())
    n_off_exact = int((lab.long() != lab64).sum())
    assert int((differ & ~near).sum()) == 0, f"{n_differ} labels differ, not all at near-ties"
    assert int(((lab.long() != lab64) & ~near).sum()) == 0, "labels off the exact argmin"
    lk = lab.long()[mask]
    assert torch.equal(counts, torch.bincount(lk, minlength=k).to(counts.dtype)), counts
    assert torch.equal(want[1], torch.bincount(want[3].long()[mask], minlength=k)
                       .to(counts.dtype)), want[1]
    xm = xd[mask]
    ref = torch.zeros(k, d, dtype=torch.float64, device=x.device).index_add_(0, lk, xm)
    mag = torch.zeros_like(ref).index_add_(0, lk, xm.abs())
    err_sums = float(((sums.double() - ref).abs() / mag.clamp_min(1e-300)).max())
    assert err_sums <= 1e-5, err_sums
    ref_inertia = float(((xm - cd[lk]) ** 2).sum())
    err_inertia = abs(float(inertia) - ref_inertia) / ref_inertia
    assert err_inertia <= 1e-5, err_inertia
    del xd, xm, ref, mag
    return {"near_tie_rows": int((near & mask).sum()), "labels_differing_from_plain": n_differ,
            "labels_off_float64_argmin": n_off_exact,
            "max_abs_err_counts_vs_plain": float((counts - want[1]).abs().max()),
            "max_abs_err_sums_vs_plain": float((sums - want[0]).abs().max()),
            "rel_err_sums_vs_float64": err_sums, "rel_err_inertia_vs_float64": err_inertia,
            "rule": "differing labels only at near-ties; counts == bincount(own labels); "
                    "sums rel 1e-5 of sum|x|, inertia rel 1e-5, vs float64 over the "
                    "kernel's labels"}


def flash_live_pairs(sq, sk, causal):
    """(query, key) pairs a flash call must score: all of them, or with the
    end-aligned causal mask those with col <= row + (sk - sq)."""
    if not causal:
        return sq * sk
    rows = np.arange(sq, dtype=np.int64)
    return int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())


def flash_bound(b, h, sq, sk, d, causal, bw, tc_rate, split_passes=BF16_PASSES_SPLIT):
    """The least time of a bf16 (or float16) flash forward at float32
    accuracy: Q, K, V read once, O and the float32 lse written once (two
    bytes an element); per live (query, key) pair, on the tensor cores with
    float32 accumulation, 2·D FLOPs for q·kᵀ in one pass (bf16 and float16
    products are exact in float32, and the scale 1/8 at D = 64 is a power of
    two) plus ``split_passes`` × 2·D for P·V, where the float32 P is split
    into terms of V's type: three bf16 terms (24 significant bits, as
    float32 has), or :data:`F16_PASSES_SPLIT` float16 terms of 2^15·P. The
    softmax's one exp per pair is below this at these shapes (~4e12 exp/s on
    the H100's SFUs)."""
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * 2 + b * h * sq * 4
    flops = (1 + split_passes) * 2 * d * b * h * flash_live_pairs(sq, sk, causal)
    return bound(nbytes, flops, bw, tc_rate)


def flash_bound_f32(b, h, sq, sk, d, causal, bw, tc_rate):
    """The least time of a float32 flash forward at float32 accuracy: Q, K,
    V read and O written once as float32, the lse once; per live pair, on
    the bf16 tensor cores, q·kᵀ and P·V each with two float32 operands
    split into bf16 terms, :data:`F32_PASSES_FWD` passes of 2·D FLOPs a
    product."""
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * 4 + b * h * sq * 4
    flops = 2 * F32_PASSES_FWD * 2 * d * b * h * flash_live_pairs(sq, sk, causal)
    return bound(nbytes, flops, bw, tc_rate)


def flash_bwd_bounds(b, h, sq, sk, d, causal, bw, tc_rate, split_passes=BF16_PASSES_SPLIT):
    """The least times of the two bf16 (or float16) flash backward kernels
    at float32 accuracy, by :func:`flash_bound`'s rule (a product of two
    bf16 or float16 operands takes one tensor-core pass, one with a float32
    operand ``split_passes`` split passes: three bf16, or
    :data:`F16_PASSES_SPLIT` float16), per live pair: dK/dV recomputes q·kᵀ
    (1) and dO·vᵀ (1) and forms Pᵀ·dO and dSᵀ·q (a split product each), 16·D
    FLOPs in bf16; dQ recomputes the same two (1 + 1) and forms dS·k, 10·D.
    Bytes: q, k, v and dO read once, lse and dmb (float32) once, dK and dV,
    or dQ, written once, two bytes an element. Returns ((ms, by) for dK/dV,
    (ms, by) for dQ)."""
    pairs = b * h * flash_live_pairs(sq, sk, causal)
    inputs = (2 * b * h * sq * d + 2 * b * h * sk * d) * 2 + 2 * b * h * sq * 4
    dkv = bound(inputs + 2 * b * h * sk * d * 2, (2 + 2 * split_passes) * 2 * d * pairs, bw,
                tc_rate)
    dq = bound(inputs + b * h * sq * d * 2, (2 + split_passes) * 2 * d * pairs, bw, tc_rate)
    return dkv, dq


def flash_bwd_bounds_f32(b, h, sq, sk, d, causal, bw, tc_rate):
    """The least times of the two float32 flash backward kernels at float32
    accuracy, by :func:`flash_bound_f32`'s rule (:data:`F32_PASSES_BWD`
    split-bf16 passes for each product of two float32 operands): dK/dV's
    four products per live pair (q·kᵀ, dO·vᵀ, Pᵀ·dO, dSᵀ·q), dQ's three
    (q·kᵀ, dO·vᵀ, dS·k). Bytes as :func:`flash_bwd_bounds` counts them,
    every tensor float32. Returns ((ms, by) for dK/dV, (ms, by) for dQ)."""
    pairs = b * h * flash_live_pairs(sq, sk, causal)
    inputs = (2 * b * h * sq * d + 2 * b * h * sk * d) * 4 + 2 * b * h * sq * 4
    dkv = bound(inputs + 2 * b * h * sk * d * 4, 4 * F32_PASSES_BWD * 2 * d * pairs, bw,
                tc_rate)
    dq = bound(inputs + b * h * sq * d * 4, 3 * F32_PASSES_BWD * 2 * d * pairs, bw, tc_rate)
    return dkv, dq


def check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=0.0, got=None,
                    want=None, term_step=0.0):
    """The backward kernels' (dq, dk, dv) (``got``, else new launches)
    against the plain versions on the same inputs, everywhere: NaN at
    identical positions; elsewhere |Δg| <= 1e-4·A + (1e-5 + ``out_step``)·|g|,
    where A sums the absolute sizes of the terms that make up g: Pᵀ|dO| for
    dV, and with W = P·(|dO·vᵀ| + |dmb| + 2·√D·u·|dO|·|v|ᵀ / 1e-4),
    scale·Wᵀ|q| for dK and scale·W|k| for dQ; below the output type's
    smallest normal number its fixed subnormal spacing takes the place of
    ``out_step``·|g|. Both versions recompute each score in float32 from the
    same inputs, to within D·u·scale·|q||k| of exact (6e-5 for D = 64 and
    unit-variance inputs, |q|, |k| ≈ 8), so each probability agrees to about
    that relative size, and each dO·vᵀ to D·u·|dO|·|v|; a float32 sum of n
    terms is within n·u of its absolute sum. These worst cases add up to
    about 1e-4 of A; the errors of real sums grow as their square roots.
    W's last term is the two versions' rounding of dO·vᵀ itself, at the
    square-root size of a real sum's: where dO·vᵀ + dmb cancels (a causal
    row whose one visible key takes all its probability, whose dS is
    exactly zero) that rounding is all either version computes, and
    |dO·vᵀ| + |dmb| would not cover it. ``out_step`` adds one rounding of a
    half-precision output. ``want``: (dq, dk, dv) to hold ``got`` against
    in place of the plain versions'. ``term_step`` widens the limit by that
    share of A, for gradients whose pieces were rounded on the way (a ring
    schedule's blocks, each output and cotangent rounded to bf16 once); W
    then also counts P·Σ P|dO·vᵀ|, the size of what those roundings move in
    a piece's dmb. Returns {name: (max abs err, largest ratio of error to
    limit)}."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if got is None:
        dk, dv = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
        got = (tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal), dk, dv)
    if want is None:
        want_dk, want_dv = tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb, causal=causal)
        want = (tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb, causal=causal), want_dk, want_dv)
    qf, kf, of, p, ds = tk._bwd_dense(q, k, v, dout, lse, dmb, scale, causal)
    del ds
    vf = v.float()
    dov = (of @ vf.transpose(-1, -2)).abs()
    w_abs = p * (dov + dmb.float().abs()[..., None]
                 + (2 * math.sqrt(q.shape[-1]) * U32 / 1e-4)
                 * (of.abs() @ vf.abs().transpose(-1, -2)))
    if term_step:
        w_abs += p * (p * dov).sum(-1, keepdim=True)
    del dov
    terms = ((w_abs @ kf.abs()) * scale, (w_abs.transpose(-1, -2) @ qf.abs()) * scale,
             p.transpose(-1, -2) @ of.abs())
    del qf, kf, vf, of, p, w_abs
    res = {}
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, terms):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, g.shape)
        tiny = torch.finfo(g.dtype).tiny
        g, w = g.float(), w.float()
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), f"flash backward {name}: NaN positions differ"
        zero = torch.zeros((), device=g.device)
        err = torch.where(nan, zero, (g - w).abs())
        one_rounding = out_step * w.abs().clamp_min(tiny)
        lim = torch.where(nan, zero, (1e-4 + term_step) * a + 1e-5 * w.abs() + one_rounding)
        bad = int((err > lim).sum())
        if bad:
            at = tuple(torch.nonzero(err - lim == (err - lim).max())[0].tolist())
            raise AssertionError(f"flash backward {name}: {bad} elements beyond their tolerance "
                                 f"(worst at {at}: {float(g[at])} against {float(w[at])}, "
                                 f"limit {float(lim[at])})")
        res[name] = (float(err.max()), float((err / lim.clamp_min(1e-30)).max()))
        del g, w, a, err, lim
    return res


def check_flash(torch, tk, q, k, v, causal, out_step=0.0, got=None):
    """The kernel's (out, lse) (``got``, else a new launch) against the
    plain version on the same inputs, everywhere: NaN outputs and -inf lse
    at identical positions; elsewhere |Δout| <= 1e-5·max|v| + 1e-5·|out|
    (+ ``out_step``·|out| for one rounding of a half-precision output; both
    sides round their float32 result once) and |Δlse| <= 1e-5·(1 + |lse|).
    The float32 sums of the two versions run in other orders: each score is
    within D·u·|q||k| of exact, far below 1e-5 at these sizes. Returns the
    max abs error of out and the largest ratio of error to limit."""
    if got is None:
        got = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = tk.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    out, lse = (t.float() for t in got)
    w_out, w_lse = (t.float() for t in want)
    assert out.shape == w_out.shape and lse.shape == w_lse.shape == q.shape[:3]
    assert got[0].dtype == q.dtype and got[1].dtype == torch.float32
    nan = torch.isnan(w_out)
    assert torch.equal(torch.isnan(out), nan), "flash_attention: NaN rows differ"
    inf = torch.isneginf(w_lse)
    assert torch.equal(torch.isneginf(lse), inf), "flash_attention: -inf lse rows differ"
    vmax = float(v.float().abs().max())
    err = torch.where(nan, torch.zeros_like(out), (out - w_out).abs())
    lim = 1e-5 * vmax + (1e-5 + out_step) * torch.where(nan, torch.zeros_like(out), w_out.abs())
    bad = int((err > lim).sum())
    assert bad == 0, f"flash_attention: {bad} output elements beyond their tolerance"
    lse_err = torch.where(inf, torch.zeros_like(lse), (lse - w_lse).abs())
    lse_lim = 1e-5 * (1 + torch.where(inf, torch.zeros_like(lse), w_lse.abs()))
    bad = int((lse_err > lse_lim).sum())
    assert bad == 0, f"flash_attention: {bad} lse values beyond their tolerance"
    return float(err.max()), max(float((err / lim).max()), float((lse_err / lse_lim).max()))


def bf16_logit_tol(sigma, mag, n_layers):
    """How far one logit of the bf16 model may lie from the float32 model's,
    fixed before any run: each layer adds ROUNDINGS_PER_LAYER roundings of
    relative size u = 2^-8 to the residual stream; they walk like a random
    sum, so the normalised final hidden state is off by about
    u·sqrt(12·L) of its norm, and a logit z = ĥ·w by that much of the
    logits' standard deviation ``sigma`` (ĥ and w independent). KAPPA = 6
    such deviations, plus one rounding of the bf16 logit itself (u·max|z|,
    ``mag``)."""
    return KAPPA * U_BF16 * math.sqrt(ROUNDINGS_PER_LAYER * n_layers) * sigma + U_BF16 * mag


def bf16_loss_tol(torch, logits32, n_layers):
    """How far the bf16 model's mean next-token NLL may lie from the float32
    model's, fixed before any run: one NLL, logsumexp(z) − z_target, moves
    by at most twice the largest move of a logit, and every logit keeps
    within :func:`bf16_logit_tol` of the float32 model's at its position
    (``logits32``, (..., vocab)); so the mean moves by at most twice the
    mean of that limit."""
    sigma = logits32.std(dim=-1)
    mag = logits32.abs().amax(dim=-1)
    return float(2 * bf16_logit_tol(sigma, mag, n_layers).mean())


def bf16_grad_tol(n_layers):
    """How far, in relative norm, a gradient leaf of the bf16 model may lie
    from the float32 model's, fixed before any run: the forward rounds
    ROUNDINGS_PER_LAYER times per layer and the backward as often (it
    casts the same activations back), each rounding relative u = 2^-8;
    they walk like a random sum, u·sqrt(2·12·L) of the leaf's norm. Twice
    that is allowed (a norm sums many elements, so no tail of KAPPA
    deviations is needed)."""
    return 2 * U_BF16 * math.sqrt(2 * ROUNDINGS_PER_LAYER * n_layers)


def near_tie_check(torch, logits32, chosen, n_layers):
    """Every chosen token of the bf16 model (``chosen``, (T,)) against the
    float32 model's logits at the positions that chose them (``logits32``,
    (T, vocab)): the chosen token's float32 logit must lie within twice
    :func:`bf16_logit_tol` of the largest (the bf16 model picks the larger
    of its two rounded logits, each within the tolerance). Returns the
    number of tokens that differ from the float32 argmax and the largest
    gap over its limit."""
    sigma = logits32.std(dim=-1)
    mag = logits32.abs().amax(dim=-1)
    top = logits32.amax(dim=-1)
    picked = logits32.gather(1, chosen.long()[:, None])[:, 0]
    gap = top - picked
    limit = 2 * bf16_logit_tol(sigma, mag, n_layers)
    bad = int((gap > limit).sum())
    assert bad == 0, (f"{bad} chosen tokens lie beyond the near-tie tolerance of the float32 "
                      f"argmax (largest gap {float(gap.max())}, limit {float(limit.min())})")
    return int((chosen.long() != logits32.argmax(dim=-1)).sum()), float((gap / limit).max())


def device_share(torch, fn, n, kinds=None):
    """Host ms per call of ``fn`` (ending in a synchronize) over ``n`` calls,
    then the card's time per call in a torch.profiler window of ``n`` more
    calls (kernels, copies and sets; one stream, so they do not overlap),
    the device activities per call, and the busy share: device time over
    the unprofiled host time. ``kinds`` ({label: lower-case name parts})
    sums the device time per call by kind, the first matching label taking
    an activity and "other" the rest. Device figures are None where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us, acts, by_name = 0.0, 0, {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = e.time_range.elapsed_us()
            dev_us += us
            acts += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    if dev_us == 0:
        return {"host_ms_per_call": wall_ms, "device_ms_per_call": None,
                "device_activities_per_call": None, "device_busy_share": None}
    dev_ms = dev_us / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = {"host_ms_per_call": wall_ms, "device_ms_per_call": dev_ms,
           "device_activities_per_call": acts / n, "device_busy_share": dev_ms / wall_ms,
           "top_device_ms_per_call": {name[:80]: us / 1e3 / n for name, us in top}}
    if kinds:
        by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
        for name, us in by_name.items():
            low = name.lower()
            label = next((k for k, parts in kinds.items() if any(x in low for x in parts)),
                         "other")
            by_kind[label] += us / 1e3 / n
        res["device_ms_per_call_by_kind"] = by_kind
    return res


# the array path's data: the KMeans benchmark's points (bench.py:40-44), a
# second array of weights of the same shape, and a replicated row
# (bench.py:495-503)
REDUCE_CHAIN = 4096  # see sum_tol


def gamma(m):
    """γ_m = m·u / (1 - m·u): a float32 sum whose partial sums chain at
    most m additions is within γ_m·Σ|x| of the exact sum."""
    return m * U32 / (1 - m * U32)


def sum_tol(absum, n):
    """The error bound of a float32 sum of n terms by torch's CUDA
    reduction, over Σ|x| (``absum``): it folds the terms in per-thread
    partials of far fewer than REDUCE_CHAIN terms (Reduce.cuh splits a long
    reduction across blocks) and combines them in a tree, so each partial
    sum chains at most REDUCE_CHAIN + ⌈log2 n⌉ additions."""
    return gamma(REDUCE_CHAIN + math.ceil(math.log2(max(n, 2)))) * absum


def scan_chain(n, block):
    """The most additions that chain into one output of a blocked scan of n
    elements in blocks of ``block`` (``arithmetics._scan``): within a block
    and then one to add the scan of the earlier blocks' totals, at each
    level of blocks, and a plain scan of the last level's few totals."""
    chain = 0
    while n > block:
        chain += block + 1
        n = -(-n // block)
    return chain + n


class Bounded:
    """A float64 tensor ``v`` that mirrors a float32 computation, with ``e``
    a bound on that computation's error: each operation propagates the
    operands' bounds to first order and adds its own rounding, ``ulps``
    units of float32 roundoff of its result (1 for +, -, ×, ÷ and sqrt,
    correctly rounded on the card; 2 for tanhf, CUDA's documented bound).
    Scalars enter as their float32 roundings, as the card computes with
    them; the tensor inputs are exact float32 values."""

    def __init__(self, v, e):
        self.v, self.e = v, e

    @staticmethod
    def exact(t):
        return Bounded(t.double(), 0.0)

    def _round(self, v, e, ulps=1):
        return Bounded(v, e + ulps * U32 * v.abs())

    @staticmethod
    def _c(c):
        return float(np.float32(c))

    def __add__(self, o):
        if isinstance(o, Bounded):
            return self._round(self.v + o.v, self.e + o.e)
        return self._round(self.v + self._c(o), self.e)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Bounded):
            return self._round(self.v - o.v, self.e + o.e)
        return self._round(self.v - self._c(o), self.e)

    def __mul__(self, o):
        if isinstance(o, Bounded):
            return self._round(self.v * o.v, self.e * o.v.abs() + o.e * self.v.abs()
                               + self.e * o.e)
        c = self._c(o)
        return self._round(self.v * c, self.e * abs(c))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Bounded):
            lo = o.v.abs() - o.e
            return self._round(self.v / o.v, (self.e + (self.v / o.v).abs() * o.e) / lo)
        c = self._c(o)
        return self._round(self.v / c, self.e / abs(c))

    def __abs__(self):
        return Bounded(self.v.abs(), self.e)

    def sum(self, axis=0):
        n = self.v.shape[axis]
        v = self.v.sum(axis)
        return Bounded(v, (self.e.sum(axis) if torch_is_tensor(self.e) else self.e * n)
                       + sum_tol(self.v.abs().sum(axis), n))

    def sqrt(self):
        v = self.v.sqrt()
        return self._round(v, self.e / (2 * (self.v - self.e).clamp_min(1e-300).sqrt()))

    def tanh(self):
        return self._round(self.v.tanh(), self.e, ulps=2)


def torch_is_tensor(x):
    return hasattr(x, "shape")


class _BoundedLib:
    """``ht.sqrt`` and ``ht.tanh`` for :class:`Bounded` values."""

    @staticmethod
    def sqrt(x):
        return x.sqrt()

    @staticmethod
    def tanh(x):
        return x.tanh()


def chain16(lib, a, w, row):
    # bench.py:510-529: 16 ht-level ops, 2 of them transcendental
    t = a * 0.5
    t = t + w
    t = t - 0.25
    t = t * a
    t = abs(t)
    t = t + row
    t = t * 1.25
    t = lib.sqrt(t + 2.0)
    t = t - w
    t = t * 0.75
    t = t + a
    t = lib.tanh(t)
    t = t * t
    t = t - 0.125
    t = t + 0.5
    t = t * 2.0
    return t


def kmeans_mixed(lib, a, row):
    # bench.py:531-538: the Lloyd-style pre-assignment normalize
    t = (a - row) * 0.75
    t = t * t + t
    t = lib.tanh(t / 2.0)
    t = abs(t) + 0.125
    return t.sum(axis=0)


def reduce_chain(lib, a, w, row, n):
    # bench.py:540-548: the ht.mean((x-mu)**2) moment shape
    t = (a - row) * 0.5
    t = t * t
    t = t + 1.0
    t = t * w
    return t.sum(axis=0) * (1.0 / n)


def once_ms_us(torch, fn):
    """One call of ``fn``: its device ms by CUDA events and its host µs (the
    enqueue), for a call too long to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter_ns()
    fn()
    t1 = time.perf_counter_ns()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), (t1 - t0) / 1e3


def check_within(name, got, want, tol):
    """|got - want| <= tol everywhere (want and tol float64); returns the
    max abs error and the largest ratio of error to limit."""
    err = (got.double() - want).abs()
    tol = torch_tol(tol, err)
    bad = int((err > tol).sum())
    assert bad == 0, f"array_path {name}: {bad} values beyond their bound (worst " \
                     f"{float((err - tol).max())} over)"
    return float(err.max()), float((err / tol.clamp_min(1e-300)).max())


def torch_tol(tol, like):
    return tol if torch_is_tensor(tol) else like.new_full((), float(tol))


def array_path(torch, ht, tk, smi, bw):
    """The array path (bench.py's moment and fusion figures, the paper's
    Table I statistics) at the KMeans benchmark's size: each op through
    ht's entry points, checked against float64 on the same card tensors,
    timed beside one raw torch call on X.larray; the resplit round trip;
    and the closing standardize-then-cluster flow."""
    from heat_tpu_torch.core import arithmetics, resharding

    comm = ht.get_comm()
    torch.cuda.reset_peak_memory_stats()
    n, d = N_POINTS, N_FEATURES
    ht.random.seed(0)
    X = ht.random.rand(n, d, split=0)
    W = ht.random.rand(n, d, split=0)
    row = ht.random.rand(d)
    xl, wl, rl = X.larray, W.larray, row.larray
    nd = n * d * 4
    comm.reset_stats()
    x64 = xl.double()
    abs_col = x64.abs().sum(0)  # x is in [0, 1): Σ|x| per column
    mean64 = x64.sum(0) / n
    var64 = ((x64 - mean64) ** 2).sum(0) / n
    tol_mean = sum_tol(abs_col, n) / n + U32 * mean64.abs()
    # two passes: the mean's error δ adds δ²; the centered squares and their
    # sum round (4 units and the sum's bound) a value near var·n
    tol_var = (sum_tol(1.0, n) + 4 * U32) * var64 * 1.01 + tol_mean ** 2
    tol_std = tol_var / (2 * var64.sqrt()) + U32 * var64.sqrt()
    all64 = x64.sum() / (n * d)
    var_all64 = ((x64 - all64) ** 2).sum()
    tol_all = sum_tol(float(x64.abs().sum()), n * d) / (n * d) + U32 * float(all64)
    ops, checks = {}, {}

    def record(name, fn, raw, raw_what, nbytes, host_n=200, raw_once=False):
        """The op's device ms (:func:`time_ms`), bytes and bound ms, and its
        host µs a call, beside the same of the raw torch call(s); a raw call
        that takes seconds (``raw_once``) is timed once, its host µs that
        one call's enqueue."""
        rec = {"device_ms": time_ms(torch, fn), "bytes": nbytes,
               "bound_ms": nbytes / bw * 1e3, "raw_torch": raw_what,
               "host_us": host_us(torch, fn, n=host_n, chunk=host_n // 4)}
        if raw_once:
            rec["raw_ms"], rec["raw_host_us"] = once_ms_us(torch, raw)
        else:
            rec["raw_ms"] = time_ms(torch, raw)
            rec["raw_host_us"] = host_us(torch, raw, n=host_n, chunk=host_n // 4)
        ops[name] = rec

    # moments along axis 0 and along all axes
    got = ht.mean(X, 0).larray
    checks["mean_axis0"] = check_within("mean_axis0", got, mean64, tol_mean)
    record("mean_axis0", lambda: ht.mean(X, 0), lambda: torch.mean(xl, 0), "torch.mean(x, 0)",
           nd + d * 4)
    got = ht.var(X, 0).larray
    checks["var_axis0"] = check_within("var_axis0", got, var64, tol_var)
    record("var_axis0", lambda: ht.var(X, 0), lambda: torch.var(xl, 0, correction=0),
           "torch.var(x, 0, correction=0)", nd + d * 4)
    got = ht.std(X, 0).larray
    checks["std_axis0"] = check_within("std_axis0", got, var64.sqrt(), tol_std)
    record("std_axis0", lambda: ht.std(X, 0), lambda: torch.std(xl, 0, correction=0),
           "torch.std(x, 0, correction=0)", nd + d * 4)
    got = ht.mean(X).larray
    checks["mean_all"] = check_within("mean_all", got, all64, tol_all)
    record("mean_all", lambda: ht.mean(X), lambda: torch.mean(xl), "torch.mean(x)", nd + 4)
    va = var_all64 / (n * d)
    tol_va = (sum_tol(1.0, n * d) + 4 * U32) * va * 1.01 + tol_all ** 2
    got = ht.var(X).larray
    checks["var_all"] = check_within("var_all", got, va, tol_va)
    record("var_all", lambda: ht.var(X), lambda: torch.var(xl, correction=0),
           "torch.var(x, correction=0)", nd + 4)
    got = ht.std(X).larray
    checks["std_all"] = check_within("std_all", got, va.sqrt(),
                                     tol_va / (2 * va.sqrt()) + U32 * va.sqrt())
    record("std_all", lambda: ht.std(X), lambda: torch.std(xl, correction=0),
           "torch.std(x, correction=0)", nd + 4)
    vd = var_all64 / (n * d - 1)
    got = ht.var(X, ddof=1).larray
    checks["var_ddof1"] = check_within("var_ddof1", got, vd,
                                       (sum_tol(1.0, n * d) + 4 * U32) * vd * 1.01 + tol_all ** 2)
    record("var_ddof1", lambda: ht.var(X, ddof=1), lambda: torch.var(xl),
           "torch.var(x)", nd + 4)
    del got
    # the weighted average: Σ x·w over Σ w, all terms positive
    w64 = wl.double()
    num, den = (x64 * w64).sum(0), w64.sum(0)
    avg64 = num / den
    tol_avg = (2 * sum_tol(1.0, n) + 3 * U32) * avg64.abs() * 1.01
    del w64, num, den
    checks["average_axis0"] = check_within("average_axis0", ht.average(X, axis=0, weights=W).larray,
                                           avg64, tol_avg)
    record("average_axis0", lambda: ht.average(X, axis=0, weights=W),
           lambda: (xl * wl).sum(0) / wl.sum(0), "(x * w).sum(0) / w.sum(0), 3 calls",
           2 * nd + d * 4)
    # extrema along axis 0: exact
    for name, fn, raw, what, want in (
            ("max_axis0", lambda: ht.max(X, 0), lambda: torch.amax(xl, 0), "torch.amax(x, 0)",
             x64.amax(0)),
            ("min_axis0", lambda: ht.min(X, 0), lambda: torch.amin(xl, 0), "torch.amin(x, 0)",
             x64.amin(0)),
            ("argmax_axis0", lambda: ht.argmax(X, 0), lambda: torch.argmax(xl, 0),
             "torch.argmax(x, 0)", x64.argmax(0)),
            ("argmin_axis0", lambda: ht.argmin(X, 0), lambda: torch.argmin(xl, 0),
             "torch.argmin(x, 0)", x64.argmin(0))):
        got = fn()
        assert got.shape == (d,) and torch.equal(got.larray.double(), want.double()), name
        checks[name] = {"exact": True}
        record(name, fn, raw, what, nd + d * (8 if "arg" in name else 4))
    # the cumulative sum, scanned in blocks (arithmetics._scan): each row's
    # partial sums chain at most scan_chain(n) additions, so row i is within
    # γ_chain·Σ_(j<=i)|x_j|. The reference scans along the last axis: torch's
    # scan down axis 0 runs one thread per column (64 here; 3.0 s on an
    # "NVIDIA H100 80GB HBM3, 700.00 W")
    got = ht.cumsum(X, 0).larray
    want = x64.t().contiguous().cumsum(1).t()
    tol_cs = gamma(scan_chain(n, arithmetics._SCAN_BLOCK)) * want  # x >= 0: Σ|x| is the sum
    checks["cumsum_axis0"] = check_within("cumsum_axis0", got, want, tol_cs)
    del got, want, tol_cs
    record("cumsum_axis0", lambda: ht.cumsum(X, 0), lambda: torch.cumsum(xl, 0),
           "torch.cumsum(x, 0), one call", 2 * nd, raw_once=True)
    # a comparison and its count: exact
    count = ht.sum(X > 0.5)
    assert count.dtype is ht.int64 and int(count.item()) == int((x64 > 0.5).sum()), "count"
    checks["greater_sum"] = {"exact": True, "count": int(count.item())}
    record("greater_sum", lambda: (X > 0.5).sum(), lambda: (xl > 0.5).sum(),
           "(x > 0.5).sum(), 2 calls", nd + 8)
    del x64
    torch.cuda.empty_cache()

    # bench.py's chains, written as there, against their float64 mirrors
    bx, bw_, brow = Bounded.exact(xl), Bounded.exact(wl), Bounded.exact(rl)
    want = chain16(_BoundedLib, bx, bw_, brow)
    checks["chain16"] = check_within("chain16", chain16(ht, X, W, row).larray, want.v, want.e)
    del want
    record("chain16", lambda: chain16(ht, X, W, row), lambda: chain16(torch, xl, wl, rl),
           "the same 16 torch calls", 3 * nd, host_n=40)
    want = kmeans_mixed(_BoundedLib, bx, brow)
    checks["kmeans_mixed"] = check_within("kmeans_mixed", kmeans_mixed(ht, X, row).larray,
                                          want.v, want.e)
    record("kmeans_mixed", lambda: kmeans_mixed(ht, X, row), lambda: kmeans_mixed(torch, xl, rl),
           "the same 8 torch calls", nd + d * 4, host_n=40)
    want = reduce_chain(_BoundedLib, bx, bw_, brow, n)
    checks["moment_chain"] = check_within("moment_chain", reduce_chain(ht, X, W, row, n).larray,
                                          want.v, want.e)
    record("moment_chain", lambda: reduce_chain(ht, X, W, row, n),
           lambda: reduce_chain(torch, xl, wl, rl, n), "the same 6 torch calls",
           2 * nd + d * 4, host_n=40)
    del want, bx, bw_, brow
    torch.cuda.empty_cache()

    # the resplit round trip: local at world size 1
    kinds = [resharding.plan_kind(X.gshape, a, b, comm) for a, b in ((0, 1), (1, None),
                                                                        (None, 0))]
    Y = X.resplit(1).resplit(None).resplit(0)
    assert Y.split == 0 and torch.equal(Y.larray, xl), "resplit round trip"
    want_kinds = ["local"] * 3 if comm.size == 1 else ["all_to_all", "all_gather",
                                                       "local_slice"]
    assert kinds == want_kinds, kinds
    del Y
    stats = dict(comm.stats)
    assert comm.size > 1 or stats == {}, stats

    # the closing user flow: standardize, then cluster
    tk.reset_launches()
    t0 = time.perf_counter()
    Z = (X - ht.mean(X, 0)) / ht.std(X, 0)
    km = ht.cluster.KMeans(n_clusters=K, init="kmeans++", max_iter=ITERS, tol=-1,
                           random_state=0).fit(Z)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    assert launches["kmeans_step"] == ITERS, launches
    centers = km.cluster_centers_.larray
    assert km.n_iter_ == ITERS and bool(torch.isfinite(centers).all())
    assert math.isfinite(km.inertia_)
    mu = Bounded(mean64, tol_mean)
    sd = Bounded(var64.sqrt(), tol_std)
    zb = (Bounded.exact(xl) - mu) / sd
    checks["standardized"] = check_within("standardized", Z.larray, zb.v, zb.e)
    del zb, mu, sd
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "array_path", "card": smi, "shape": [n, d], "dtype": "float32",
          "ops": ops, "checks": checks, "resplit_plan_kinds": kinds,
          "comm_stats": stats, "closing_flow": {
              "seconds": flow_s, "launches": launches, "n_iter": km.n_iter_,
              "inertia": km.inertia_},
          "peak_memory_bytes": peak})
    return ops


def array_tour(torch, ht, tk, smi, bw):
    """Phase 5c, the array tour (examples/arrays/demo_distributed_arrays.py
    and examples/data_pipeline.py step 3) at the KMeans benchmark's size:
    boolean masks, nonzero, where, a mixed key, a stepped split-axis slice,
    a new axis, a scatter, the manipulations and the factories, each through
    ht's entry points and held bitwise against the raw torch call on the
    same card tensors, with its device ms, its bound (bytes read and
    written at the card's bandwidth) and the host µs of both; then the
    filter-then-fit flow, whose 20 ``kmeans_step`` launches are held
    against a plain Lloyd loop."""
    from heat_tpu_torch.cluster.kmeans import _finish_update

    comm = ht.get_comm()
    n, d = N_POINTS, N_FEATURES
    torch.cuda.reset_peak_memory_stats()
    ht.random.seed(0)
    X = ht.random.uniform(0.0, 1.0, (n, d), split=0)
    xl = X.larray
    assert X.split == 0 and xl.dtype == torch.float32
    nd = n * d * 4
    n_idx = 2**20
    idx = ht.random.randint(0, n, (n_idx,))
    it = idx.larray
    rows = 2**20
    comm.reset_stats()
    ops, checks = {}, {}

    def same(name, got, want, split):
        """``got`` (a DNDarray) bitwise ``want`` (a tensor), with its gshape,
        split and lshape_map."""
        assert tuple(got.gshape) == tuple(want.shape), (name, got.gshape, want.shape)
        assert got.split == split, (name, got.split, split)
        assert got.lshape_map.tolist() == [list(want.shape)], (name, got.lshape_map)
        assert got.larray.dtype == want.dtype and torch.equal(got.larray, want), name
        checks[name] = {"bitwise_equal": True, "gshape": list(got.gshape), "split": got.split}

    def record(name, fn, raw, raw_what, nbytes):
        """Device ms (CUDA events over 3 samples of 3 calls), bytes, bound
        ms and host µs a call (5 calls twice, the card drained before each
        five) of ``fn``, beside the same of the raw torch call."""
        ops[name] = {"device_ms": time_ms(torch, fn, reps=3, inner=3), "bytes": nbytes,
                     "bound_ms": nbytes / bw * 1e3,
                     "host_us": host_us(torch, fn, n=10, chunk=5), "raw_torch": raw_what,
                     "raw_ms": time_ms(torch, raw, reps=3, inner=3),
                     "raw_host_us": host_us(torch, raw, n=10, chunk=5)}
        torch.cuda.empty_cache()

    # masks and keys
    mask = xl[:, 0] > 0.5
    want = xl[mask]
    m = want.shape[0]
    same("mask_rows", X[X[:, 0] > 0.5], want, 0)
    record("mask_rows", lambda: X[X[:, 0] > 0.5], lambda: xl[xl[:, 0] > 0.5],
           "x[x[:, 0] > 0.5]", nd + m * d * 4)
    del want
    want = torch.nonzero(xl[:, 0] > 0.999)
    same("nonzero", ht.nonzero(X[:, 0] > 0.999), want, 0)
    record("nonzero", lambda: ht.nonzero(X[:, 0] > 0.999),
           lambda: torch.nonzero(xl[:, 0] > 0.999), "torch.nonzero(x[:, 0] > 0.999)",
           n * 4 + want.numel() * 8)
    got = ht.where(X > 0.5, X, 0.0)  # float64: heat_tpu's type for a float scalar
    same("where", got, torch.where(xl > 0.5, xl, 0.0).double(), 0)
    del got
    record("where", lambda: ht.where(X > 0.5, X, 0.0), lambda: torch.where(xl > 0.5, xl, 0.0),
           "torch.where(x > 0.5, x, 0.0) (float32)", nd + 2 * nd)
    same("mixed_key", X[idx, 2:6], xl[it, 2:6], 0)
    record("mixed_key", lambda: X[idx, 2:6], lambda: xl[it, 2:6], "x[idx, 2:6]",
           n_idx * 8 + 2 * n_idx * 4 * 4)
    same("stepped_slice", X[1::3], xl[1::3], 0)
    record("stepped_slice", lambda: X[1::3], lambda: xl[1::3], "x[1::3] (a view)", 0)
    same("new_axis", X[..., None], xl[..., None], 0)
    record("new_axis", lambda: X[..., None], lambda: xl[..., None], "x[..., None] (a view)", 0)
    zero = torch.zeros((), device=xl.device)

    def scatter():
        Y = X.copy()
        Y[idx] = 0.0
        return Y

    same("scatter", scatter(), xl.clone().index_put_((it,), zero), 0)
    record("scatter", scatter, lambda: xl.clone().index_put_((it,), zero),
           "x.clone().index_put_((idx,), 0)", 2 * nd + n_idx * 8)

    # manipulations
    for name, fn, raw, what, nbytes, split in (
            ("concatenate", lambda: ht.concatenate([X, X], 0), lambda: torch.cat([xl, xl], 0),
             "torch.cat([x, x], 0)", 4 * nd, 0),
            ("stack", lambda: ht.stack([X, X], 1), lambda: torch.stack([xl, xl], 1),
             "torch.stack([x, x], 1)", 4 * nd, 0),
            ("reshape", lambda: ht.reshape(X, (n // 2, 2 * d)), lambda: xl.reshape(n // 2, 2 * d),
             "x.reshape(n / 2, 128) (a view)", 0, 0),
            ("flatten", lambda: ht.flatten(X), lambda: xl.reshape(-1), "x.reshape(-1) (a view)",
             0, 0),
            ("roll", lambda: ht.roll(X, 12345, 0), lambda: torch.roll(xl, 12345, 0),
             "torch.roll(x, 12345, 0)", 2 * nd, 0),
            ("flip", lambda: ht.flip(X, 0), lambda: torch.flip(xl, (0,)), "torch.flip(x, (0,))",
             2 * nd, 0),
            ("pad", lambda: ht.pad(X, ((1, 1), (0, 0))),
             lambda: torch.nn.functional.pad(xl, (0, 0, 1, 1)),
             "torch.nn.functional.pad(x, (0, 0, 1, 1))", 2 * nd + 2 * d * 4, 0),
            ("pad_edge", lambda: ht.pad(X, ((1, 1), (0, 0)), mode="edge"),
             lambda: torch.nn.functional.pad(xl[None], (0, 0, 1, 1), mode="replicate")[0],
             "torch.nn.functional.pad(x[None], (0, 0, 1, 1), mode='replicate')[0]",
             2 * nd + 2 * d * 4, 0),
            ("pad_maximum", lambda: ht.pad(X, ((0, 0), (0, 1)), mode="maximum"),
             lambda: torch.cat([xl, xl.amax(1, keepdim=True)], 1),
             "torch.cat([x, x.amax(1, keepdim=True)], 1)", 2 * nd + n * 4, 0),
            ("repeat", lambda: ht.repeat(X[:rows], 2, 0),
             lambda: torch.repeat_interleave(xl[:rows], 2, 0),
             "torch.repeat_interleave(x[:2**20], 2, 0)", 3 * rows * d * 4, 0),
            ("tile", lambda: ht.tile(X[:rows], (2, 1)), lambda: torch.tile(xl[:rows], (2, 1)),
             "torch.tile(x[:2**20], (2, 1))", 3 * rows * d * 4, 0),
            ("diff", lambda: ht.diff(X, axis=0), lambda: torch.diff(xl, dim=0),
             "torch.diff(x, dim=0)", nd + (n - 1) * d * 4, 0),
            ("swapaxes", lambda: ht.swapaxes(X, 0, 1), lambda: xl.swapaxes(0, 1),
             "x.swapaxes(0, 1) (a view)", 0, 1)):
        same(name, fn(), raw(), split)
        record(name, fn, raw, what, nbytes)

    # factories
    for name, fn, raw, what, nbytes, split in (
            ("zeros_like", lambda: ht.zeros_like(X), lambda: torch.zeros_like(xl),
             "torch.zeros_like(x)", nd, 0),
            ("full", lambda: ht.full((n, d), 2.5, split=0),
             lambda: torch.full((n, d), 2.5, device=xl.device), "torch.full((n, 64), 2.5)", nd,
             0),
            ("eye", lambda: ht.eye(8192, split=0), lambda: torch.eye(8192, device=xl.device),
             "torch.eye(8192)", 8192 * 8192 * 4, 0)):
        same(name, fn(), raw(), split)
        record(name, fn, raw, what, nbytes)
    # linspace computes as jnp.linspace does (start·(1 - i/div) + stop·(i/div)),
    # torch.linspace otherwise: held to the float64 values, 4 float32 units
    lin = ht.linspace(0.0, 1.0, n, split=0)
    exact = torch.arange(n, dtype=torch.float64, device=xl.device) / (n - 1)
    err = float((lin.larray.double() - exact).abs().max())
    assert lin.shape == (n,) and lin.split == 0 and err <= 4 * U32, err
    checks["linspace"] = {"max_abs_err": err, "limit": 4 * U32}
    del lin, exact
    record("linspace", lambda: ht.linspace(0.0, 1.0, n, split=0),
           lambda: torch.linspace(0.0, 1.0, n, device=xl.device), "torch.linspace(0, 1, n)",
           n * 4)
    stats = dict(comm.stats)
    assert comm.size > 1 or stats == {}, stats

    # the closing flow: filter rows by a split-axis mask, then fit KMeans
    tk.reset_launches()
    t0 = time.perf_counter()
    F = X[X[:, 0] > 0.5]
    km = ht.cluster.KMeans(n_clusters=K, init="kmeans++", max_iter=ITERS, tol=-1,
                           random_state=0).fit(F)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    assert launches["kmeans_step"] == ITERS, launches
    seeded = ht.cluster.KMeans(n_clusters=K, init="kmeans++", random_state=0)
    seeded._initialize_cluster_centers(F)
    cp = seeded.cluster_centers_.larray.clone()
    for _ in range(ITERS):
        s_, n_, _ = tk.kmeans_step_plain(F.larray, cp)
        cp, _ = _finish_update(s_, n_, cp)
    d_centers = float((km.cluster_centers_.larray - cp).abs().max())
    assert d_centers <= 1e-3, d_centers
    assert km.n_iter_ == ITERS and math.isfinite(km.inertia_)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "array_tour", "card": smi, "shape": [n, d], "dtype": "float32",
          "ops": ops, "checks": checks, "comm_stats": stats,
          "closing_flow": {"rows_kept": F.shape[0], "seconds": flow_s, "launches": launches,
                           "n_iter": km.n_iter_, "inertia": km.inertia_,
                           "max_abs_err_centers_vs_plain_lloyd": d_centers},
          "peak_memory_bytes": peak})
    return ops


def order_stats(torch, ht, tk, smi, bw):
    """Phase 5d, order statistics (examples/data_pipeline.py step 3 with its
    p90) on the array tour's X, nothing cut: ``sort`` along the split axis,
    the percentiles and medians, ``unique``, ``topk``, ``isin`` and the set
    operations, the counts, the searches and the calculus, each held by
    properties or references that do not go through the port (torch's
    ``kthvalue`` and ``searchsorted``, numpy on a host copy, float64 on the
    card), with its device ms, its bound (each input read once, each output
    written once, int64 indices counted), the raw torch call's ms where one
    computes the same, and the host µs of both; then the p90 filter, a
    KMeans fit on the kept rows and their median."""
    from heat_tpu_torch.cluster.kmeans import _finish_update

    comm = ht.get_comm()
    n, d = N_POINTS, N_FEATURES
    eps64 = 2.0**-52
    torch.cuda.reset_peak_memory_stats()
    ht.random.seed(0)
    X = ht.random.uniform(0.0, 1.0, (n, d), split=0)
    xl = X.larray
    col = xl[:, 0].contiguous()
    c64 = col.double()
    nd = n * d * 4
    comm.reset_stats()
    ops, checks = {}, {}

    def record(name, fn, raw, raw_what, nbytes, big=False):
        """Device ms (CUDA events; sort-sized ops 3 samples of one call,
        others 3 of 3) and host µs a call (5 calls twice, or 3 one by one;
        the card drained before each) of ``fn``, beside the raw call's."""
        reps, inner = (3, 1) if big else (3, 3)
        hn, hc = (3, 1) if big else (10, 5)
        row = {"device_ms": time_ms(torch, fn, reps=reps, inner=inner), "bytes": nbytes,
               "bound_ms": nbytes / bw * 1e3, "host_us": host_us(torch, fn, n=hn, chunk=hc),
               "raw_torch": raw_what, "raw_ms": None, "raw_host_us": None}
        if raw is not None:
            row["raw_ms"] = time_ms(torch, raw, reps=reps, inner=inner)
            row["raw_host_us"] = host_us(torch, raw, n=hn, chunk=hc)
        ops[name] = row
        torch.cuda.empty_cache()

    def within(name, got, want, tol):
        err = (got.double() - want).abs()
        bad = int((err > tol).sum())
        assert bad == 0, f"order_stats {name}: {bad} values beyond their bound"
        checks[name] = {"max_abs_err": float(err.max()), "limit": float(torch.as_tensor(
            tol).max())}

    def picks(sorted_or_kth, m, q):
        """jax's local percentile of ``m`` sorted values: the neighbours of
        q·fl(0.01·(m-1)) and ``low·(1-w) + high·w`` in float64, the
        neighbours read by ``sorted_or_kth(k)`` (1-based)."""
        qx = q * (0.01 * (m - 1))
        lo, hi = math.floor(qx), math.ceil(qx)
        w = qx - lo
        low, high = sorted_or_kth(lo + 1).double(), sorted_or_kth(hi + 1).double()
        return low * (1 - w) + high * w, 2 * eps64 * torch.maximum(low.abs(), high.abs())

    # sort along the split axis: each column non-decreasing, the values
    # the input gathered at the indices, the indices a permutation of each
    # column, tied values in increasing index order
    vals, idx = ht.sort(X, axis=0)
    v, i = vals.larray, idx.larray
    assert vals.split == 0 and idx.dtype is ht.int64 and v.shape == (n, d)
    assert bool((v[1:] >= v[:-1]).all()), "sort: a column decreases"
    assert torch.equal(xl.gather(0, i), v), "sort: values are not the input at the indices"
    seen = torch.zeros((n, d), dtype=torch.bool, device=xl.device).scatter_(0, i, True)
    assert bool(seen.all()), "sort: a column's indices are no permutation"
    ties = v[1:] == v[:-1]
    assert bool((i[1:][ties] > i[:-1][ties]).all()), "sort: tied values out of index order"
    checks["sort"] = {"non_decreasing": True, "gather_bitwise": True, "permutation": True,
                      "tied_pairs_in_index_order": int(ties.sum())}
    del vals, idx, v, i, seen, ties
    record("sort(X, 0)", lambda: ht.sort(X, axis=0), lambda: torch.sort(xl, dim=0, stable=True),
           "torch.sort(x, 0, stable=True)", nd * 2 + n * d * 8, big=True)

    # percentiles and medians against torch.kthvalue and jax's formula
    got = ht.percentile(X[:, 0], [10, 50, 90]).larray
    for j, q in enumerate((10, 50, 90)):
        want, tol = picks(lambda k: torch.kthvalue(col, k).values, n, q)
        within(f"percentile(X[:, 0], {q})", got[j], want, tol)
    record("percentile(X[:, 0], [10, 50, 90])",
           lambda: ht.percentile(X[:, 0], [10, 50, 90]),
           lambda: torch.quantile(col, torch.tensor([0.1, 0.5, 0.9], device=col.device)),
           "torch.quantile(x[:, 0], [0.1, 0.5, 0.9]) (float32)", n * 4 + 3 * 8, big=True)
    got = ht.median(X, axis=0).larray
    want, tol = picks(lambda k: torch.kthvalue(xl, k, dim=0).values, n, 50)
    within("median(X, 0)", got, want, tol)
    record("median(X, 0)", lambda: ht.median(X, axis=0), None,
           "none (torch.quantile refuses above 2^24 elements)", nd + d * 8, big=True)
    got = ht.percentile(X, 90).larray
    want, tol = picks(lambda k: torch.kthvalue(xl.reshape(-1), k).values, n * d, 90)
    within("percentile(X, 90) over 2^29", got, want, tol)
    record("percentile(X, 90)", lambda: ht.percentile(X, 90), None,
           "none (torch.quantile refuses above 2^24 elements)", nd + 8, big=True)

    # unique with counts and inverse of the column rounded to 1/1000
    R = ht.round(X[:, 0] * 1000)
    r = R.larray
    u, inv, cnt = ht.unique(R, return_inverse=True, return_counts=True)
    ul, il, cl = u.larray, inv.larray, cnt.larray
    assert bool((ul[1:] > ul[:-1]).all()), "unique: not strictly increasing"
    assert int(cl.sum()) == n and torch.equal(ul[il], r), "unique: counts or inverse"
    checks["unique"] = {"uniques": int(ul.shape[0]), "counts_sum": int(cl.sum()),
                        "rebuilt_bitwise": True}
    record("unique(round(X[:, 0]·1000), inverse, counts)",
           lambda: ht.unique(R, return_inverse=True, return_counts=True),
           lambda: torch.unique(r, return_inverse=True, return_counts=True),
           "torch.unique(r, return_inverse=True, return_counts=True)",
           n * 4 + ul.shape[0] * 12 + n * 8, big=True)
    del u, inv, cnt, ul, il, cl

    # topk against the head of the stable descending sort
    tv, ti = ht.topk(X[:, 0], 1000)
    head = torch.sort(col, descending=True, stable=True)
    assert torch.equal(tv.larray, head.values[:1000]) and \
        torch.equal(ti.larray, head.indices[:1000]), "topk: not the sort's head"
    checks["topk"] = {"bitwise_vs_stable_sort_head": True}
    del head
    record("topk(X[:, 0], 1000)", lambda: ht.topk(X[:, 0], 1000),
           lambda: torch.topk(col, 1000), "torch.topk(x[:, 0], 1000)", n * 4 + 1000 * 12,
           big=True)

    # isin and the set operations on int64 draws, against numpy
    m = 2**20
    A = ht.random.randint(0, 2**21, (m,), split=0)
    B = ht.random.randint(0, 2**21, (m,), split=0)
    a_np, b_np = A.numpy(), B.numpy()
    al, bl = A.larray, B.larray
    for name, fn, ref, raw, what, out_n in (
            ("isin", lambda: ht.isin(A, B), np.isin(a_np, b_np), lambda: torch.isin(al, bl),
             "torch.isin(a, b)", m),
            ("union1d", lambda: ht.union1d(A, B), np.union1d(a_np, b_np),
             lambda: torch.unique(torch.cat([al, bl])), "torch.unique(torch.cat([a, b]))", None),
            ("intersect1d", lambda: ht.intersect1d(A, B), np.intersect1d(a_np, b_np), None,
             "none", None),
            ("setdiff1d", lambda: ht.setdiff1d(A, B), np.setdiff1d(a_np, b_np), None, "none",
             None),
            ("setxor1d", lambda: ht.setxor1d(A, B), np.setxor1d(a_np, b_np), None, "none",
             None)):
        res = fn().numpy()
        assert res.dtype == ref.dtype and np.array_equal(res, ref), f"{name}: not numpy's"
        checks[name] = {"equal_to_numpy": True, "length": int(ref.shape[0])}
        nbytes = 2 * m * 8 + (m if out_n else ref.shape[0] * 8)
        record(name, fn, raw, what, nbytes, big=name != "isin")

    # histograms and bincount: numpy on a host copy of 2^20 rows, the full
    # size counts summing to n
    rows = 2**20
    sub = X[:rows, 0]
    h, e = ht.histogram(sub, 100)
    edges = e.larray.double()
    lo, hi = float(edges[0]), float(edges[-1])
    np_counts, _ = np.histogram(sub.numpy(), bins=edges.cpu().numpy())
    assert np.array_equal(h.numpy(), np_counts.astype(np.float32)), "histogram: not numpy's"
    lin = torch.linspace(lo, hi, 101, dtype=torch.float64, device=edges.device)
    within("histogram edges", edges, lin, 4 * U32 * max(abs(lo), abs(hi)))
    hf, _ = ht.histogram(X[:, 0], 100)
    hc = ht.histc(X[:, 0], 100)
    assert float(hf.larray.sum()) == n and torch.equal(hc.larray, hf.larray), "histc/histogram"
    checks["histogram"] = {"equal_to_numpy_2^20": True, "full_size_sum": n,
                           "histc_equal": True}
    cmin, cmax = float(col.min()), float(col.max())
    record("histogram(X[:, 0], 100)", lambda: ht.histogram(X[:, 0], 100),
           lambda: torch.histc(col, 100, cmin, cmax), "torch.histc(x[:, 0], 100, min, max)",
           n * 4 + 100 * 4 + 101 * 4)
    record("histc(X[:, 0], 100)", lambda: ht.histc(X[:, 0], 100),
           lambda: torch.histc(col, 100, cmin, cmax), "torch.histc(x[:, 0], 100, min, max)",
           n * 4 + 100 * 4)
    C = ht.random.randint(0, 1000, (n,), split=0)
    bc = ht.bincount(C)
    assert int(bc.larray.sum()) == n
    np_bc = np.bincount(C[:rows].numpy(), minlength=1000)
    assert np.array_equal(ht.bincount(C[:rows], minlength=1000).numpy(), np_bc), "bincount"
    checks["bincount"] = {"equal_to_numpy_2^20": True, "full_size_sum": n}
    cl_ = C.larray
    record("bincount(randint(0, 1000, 2^23))", lambda: ht.bincount(C),
           lambda: torch.bincount(cl_), "torch.bincount(c)", n * 8 + 1000 * 8)

    # searches, interpolation and calculus against float64 on the card
    T = ht.linspace(0.0, 1.0, 101, dtype=ht.float64, split=None)
    tl = T.larray
    FP = ht.sin(T)
    fp = FP.larray
    ss = ht.searchsorted(T, X[:, 0])
    assert torch.equal(ss.larray, torch.searchsorted(tl, c64)), "searchsorted"
    dg = ht.digitize(X[:, 0], T)
    assert dg.dtype is ht.int32 and torch.equal(
        dg.larray, torch.searchsorted(tl, c64, right=True).int()), "digitize"
    checks["searchsorted"] = checks["digitize"] = {"bitwise_vs_torch_float64": True}
    record("searchsorted(T, X[:, 0])", lambda: ht.searchsorted(T, X[:, 0]),
           lambda: torch.searchsorted(tl, c64), "torch.searchsorted(t, x[:, 0] (float64))",
           n * 4 + 101 * 8 + n * 8)
    record("digitize(X[:, 0], T)", lambda: ht.digitize(X[:, 0], T),
           lambda: torch.bucketize(c64, tl, right=True),
           "torch.bucketize(x[:, 0] (float64), t, right=True)", n * 4 + 101 * 8 + n * 4)
    ip = ht.interp(X[:, 0], T, FP).larray
    j = torch.searchsorted(tl, c64, right=True).clamp(1, 100)
    want = fp[j - 1] + (c64 - tl[j - 1]) / (tl[j] - tl[j - 1]) * (fp[j] - fp[j - 1])
    within("interp", ip, want, 8 * eps64)
    record("interp(X[:, 0], T, sin(T))", lambda: ht.interp(X[:, 0], T, FP), None, "none",
           n * 4 + 2 * 101 * 8 + n * 8)
    g = ht.gradient(X[:, 0]).larray
    g64 = torch.cat([c64[1:2] - c64[:1], (c64[2:] - c64[:-2]) / 2, c64[-1:] - c64[-2:-1]])
    within("gradient", g, g64, U32 * g64.abs())
    record("gradient(X[:, 0])", lambda: ht.gradient(X[:, 0]), lambda: torch.gradient(col),
           "torch.gradient(x[:, 0])", n * 4 * 2)
    tz = ht.trapz(X[:, 0]).larray
    pair = c64[1:] + c64[:-1]
    absum = float(pair.abs().sum())
    within("trapz", tz, pair.sum() * 0.5, 0.5 * (U32 * absum + sum_tol(absum, n - 1)))
    record("trapz(X[:, 0])", lambda: ht.trapz(X[:, 0]), lambda: torch.trapezoid(col),
           "torch.trapezoid(x[:, 0])", n * 4 + 4)
    stats = dict(comm.stats)
    assert comm.size > 1 or stats == {}, stats

    # the closing flow: data_pipeline.py step 3 with its p90, then the
    # median of the kept rows
    tk.reset_launches()
    t0 = time.perf_counter()
    p90 = ht.percentile(X[:, 0], 90)
    F = X[X[:, 0] > p90]
    km = ht.cluster.KMeans(n_clusters=K, init="kmeans++", max_iter=ITERS, tol=-1,
                           random_state=0).fit(F)
    med = ht.median(F[:, 0])
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    assert launches["kmeans_step"] == ITERS, launches
    kept = col.double() > p90.larray
    assert F.shape[0] == int(kept.sum()), (F.shape, int(kept.sum()))
    fcol = F.larray[:, 0].contiguous()
    want, tol = picks(lambda k: torch.kthvalue(fcol, k).values, F.shape[0], 50)
    within("closing median(F[:, 0])", med.larray, want, tol)
    seeded = ht.cluster.KMeans(n_clusters=K, init="kmeans++", random_state=0)
    seeded._initialize_cluster_centers(F)
    cp = seeded.cluster_centers_.larray.clone()
    for _ in range(ITERS):
        s_, n_, _ = tk.kmeans_step_plain(F.larray, cp)
        cp, _ = _finish_update(s_, n_, cp)
    d_centers = float((km.cluster_centers_.larray - cp).abs().max())
    assert d_centers <= 1e-3, d_centers
    assert km.n_iter_ == ITERS and math.isfinite(km.inertia_)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "order_stats", "card": smi, "shape": [n, d], "dtype": "float32",
          "ops": ops, "checks": checks, "comm_stats": stats,
          "closing_flow": {"p90": float(p90.item()), "rows_kept": F.shape[0],
                           "median_kept": float(med.item()), "seconds": flow_s,
                           "launches": launches, "n_iter": km.n_iter_,
                           "inertia": km.inertia_,
                           "max_abs_err_centers_vs_plain_lloyd": d_centers},
          "peak_memory_bytes": peak})
    return ops


# phase 5e sizes: bench.py's matmul probe (:69) and GEMM chain (:539-543),
# the linear algebra at the array path's size, distance_matrix's and
# lasso's strong sizes (benchmarks/config.json; benchmarks/lasso/
# heat_tpu_bench.py:25-44)
MATMUL_M = 8192
GEMM_N, GEMM_D = 1 << 14, 32
QR_ROWS = 2**22
SOLVE_N, DET_N = 4096, 2048
SPECTRAL_K, SPECTRAL_LANCZOS = 4, 300
LASSO_N, LASSO_D, LASSO_SWEEPS, LASSO_LAM = 1_048_576, 64, 100, 0.01
DRAW_CHECK = 2**20  # leading values of the 2^23 x 64 draw held against the CPU's


def linalg_path(torch, ht, tk, smi, bw, f32, bf16_tc):
    """Phase 5e: ``@`` at bench.py's sizes, the linear algebra layer at the
    array path's, Spectral at distance_matrix's and Lasso at lasso's strong
    size, and the Threefry draw; every check against float64 on the card or
    the port's CPU draw. Returns the Spectral fit's kernel launches."""
    dev = ht.get_device().torch_device
    out, checks, times = {}, {}, {}
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off"

    def pair(name, port, raw, nbytes=None, ops=None, rate=None, reps=5, inner=2):
        """Device ms of the port's call and of the matching torch call."""
        row = {"ms": time_ms(torch, port, reps=reps, inner=inner),
               "torch_ms": time_ms(torch, raw, reps=reps, inner=inner)}
        if nbytes is not None:
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops or 0, bw, rate or f32)
        times[name] = row
        torch.cuda.empty_cache()

    # -- matmul: X @ W at bench.py:69's size in bf16 and float32 ----------- #
    m = MATMUL_M
    for dtype, rate, size in ((ht.bfloat16, bf16_tc, 2), (ht.float32, f32, 4)):
        ht.random.seed(1)
        X = ht.random.randn(m, m, dtype=dtype)
        W = ht.random.randn(m, m, dtype=dtype)
        P = X @ W
        x, w = X.larray, W.larray
        same = bool(torch.equal(P.larray, torch.matmul(x, w)))
        rows = slice(0, 256)
        want = x[rows].double() @ w.double()
        mag = x[rows].double().abs() @ w.double().abs()
        tol = gamma(m) * mag + (2.0**-8 if size == 2 else 0.0) * want.abs()
        err = (P.larray[rows].double() - want).abs()
        assert bool((err <= tol).all()), f"matmul {dtype.__name__}: beyond its bound"
        name = f"X @ W {m}^2 {dtype.__name__}"
        checks[name] = {"max_abs_err_256_rows_vs_float64": float(err.max()),
                        "max_err_over_limit": float((err / tol).max()),
                        "bitwise_equal_torch_matmul": same, "split": P.split}
        pair(name, lambda: X @ W, lambda: torch.matmul(x, w), 3 * m * m * size, 2 * m**3, rate)
        del X, W, P, x, w, want, mag, tol, err
    torch.cuda.empty_cache()

    # bench.py's GEMM chain: a row-split GEMM, bias, tanh and a split-axis sum
    rng = np.random.default_rng(0)
    xg = ht.array(rng.standard_normal((GEMM_N, GEMM_D)).astype(np.float32), split=0)
    wg = ht.array(rng.standard_normal((GEMM_D, GEMM_D)).astype(np.float32))
    bg = ht.array(rng.standard_normal((GEMM_D,)).astype(np.float32))

    def gemm_chain():
        t = ht.matmul(xg, wg) + bg
        t = ht.tanh(t * 0.5)
        t = t * t + t
        return t.sum(axis=0)

    got = gemm_chain().larray.double()
    x64, w64, b64 = xg.larray.double(), wg.larray.double(), bg.larray.double()
    h = torch.tanh((x64 @ w64 + b64) * 0.5)
    f = h * h + h
    # |Δt| of the float32 GEMM and bias, through tanh(t/2) (slope <= 1/2) and
    # its rounding, then h² + h and the sum
    dt = gamma(GEMM_D + 1) * (x64.abs() @ w64.abs() + b64.abs())
    dh = 0.5 * dt + 4 * U32 * h.abs() + 2 * U32
    term = (2 * h.abs() + 1) * dh + 3 * U32 * (h * h + h.abs())
    tol = term.sum(0) + sum_tol(float(f.abs().sum(0).max()), GEMM_N)
    err = (got - f.sum(0)).abs()
    assert bool((err <= tol).all()), "GEMM chain beyond its bound"
    checks["gemm_chain 2^14x32"] = {"max_abs_err_vs_float64": float(err.max()),
                                     "max_err_over_limit": float((err / tol).max())}
    xl, wl, bl = xg.larray, wg.larray, bg.larray
    pair("gemm_chain 2^14x32", gemm_chain,
         lambda: ((lambda t: t * t + t)(torch.tanh((xl @ wl + bl) * 0.5))).sum(0),
         (GEMM_N * GEMM_D + GEMM_D * GEMM_D + 2 * GEMM_D) * 4, 2 * GEMM_N * GEMM_D * GEMM_D)
    del xg, wg, bg, x64, w64, h, f, dt, dh, term

    # -- the array path's X: cov, and the Threefry draw it comes from ----- #
    n, d = N_POINTS, N_FEATURES
    ht.random.seed(0)
    X = ht.random.uniform(0.0, 1.0, (n, d), split=0)
    xl = X.larray
    ht.random.seed(0)
    rows = min(DRAW_CHECK // d, n)
    cpu = ht.random.uniform(0.0, 1.0, (rows, d), device="cpu")
    assert torch.equal(xl[:rows].cpu(), cpu.larray), "Threefry: card and CPU draws differ"
    ht.random.seed(1)
    g_card = ht.random.randn(rows, d).larray.cpu()
    ht.random.seed(1)
    g_cpu = ht.random.randn(rows, d, device="cpu").larray
    g_ulp = float(((g_card - g_cpu).abs() / torch.clamp(g_cpu.abs(), min=1.0)).max()) / (2 * U32)
    ht.random.seed(2)
    i_card = ht.random.randint(-7, 2**40, (rows, d)).larray.cpu()
    ht.random.seed(2)
    assert torch.equal(i_card, ht.random.randint(-7, 2**40, (rows, d), device="cpu").larray)
    checks["threefry"] = {"uniform_first_2^20_bitwise_cpu": True,
                          "randint_first_2^20_bitwise_cpu": True,
                          "randn_first_2^20_max_ulp_of_max(|x|,1)_vs_cpu": g_ulp}
    assert g_ulp <= 8, g_ulp
    pair("random.uniform 2^23x64", lambda: ht.random.uniform(0.0, 1.0, (n, d), split=0),
         lambda: torch.rand(n, d, device=dev), n * d * 4, reps=3, inner=1)
    del cpu, g_card, g_cpu, i_card

    C = ht.cov(X, rowvar=False)
    xd = xl.double()
    cen = xd - xd.mean(0)
    c64 = (cen.T @ cen) / (n - 1)
    del xd, cen
    err = float((C.larray.double() - c64).abs().max())
    rel = err / float(c64.abs().max())
    assert C.shape == (d, d) and rel <= 1e-4, rel
    checks["cov 2^23x64 rowvar=False"] = {"max_abs_err_vs_float64": err,
                                           "err_over_max_abs_cov": rel, "rtol": 1e-4}
    pair("cov 2^23x64", lambda: ht.cov(X, rowvar=False),
         lambda: torch.cov(xl.T), n * d * 4 + d * d * 4, 2 * n * d * d, reps=3, inner=1)
    del X, xl, C, c64
    torch.cuda.empty_cache()

    # -- qr and svd of a 2^22 x 64 float32 split-0 array ------------------ #
    ht.random.seed(3)
    A = ht.random.randn(QR_ROWS, d, split=0)
    al = A.larray
    Q, R = ht.linalg.qr(A)
    q, r = Q.larray, R.larray
    anorm = float(torch.linalg.norm(al))
    res_qr = float(torch.linalg.norm(q @ r - al)) / anorm
    orth = float((q.T @ q - torch.eye(d, device=dev)).abs().max())
    assert res_qr <= 1e-4 and orth <= 1e-4, (res_qr, orth)
    checks["qr 2^22x64"] = {"rel_residual_QR_minus_A": res_qr, "max_abs_QtQ_minus_I": orth,
                            "limits": [1e-4, 1e-4], "splits": [Q.split, R.split]}
    del Q, R, q, r
    pair("qr 2^22x64", lambda: ht.linalg.qr(A), lambda: torch.linalg.qr(al), 2 * QR_ROWS * d * 4,
         2 * QR_ROWS * d * d, reps=2, inner=1)
    U, S, V = ht.linalg.svd(A)
    s = S.larray
    ad = al.double()
    s64 = torch.linalg.eigvalsh(ad.T @ ad).clamp_min(0).sqrt().flip(0)
    del ad
    res_svd = float(torch.linalg.norm((U.larray * s) @ V.larray.T - al)) / anorm
    # a backward-stable SVD moves each singular value by about sqrt(rows)·u·‖A‖₂
    s_lim = math.sqrt(QR_ROWS) * U32 * float(s64[0])
    s_err = float((s.double() - s64).abs().max())
    assert res_svd <= 1e-4 and s_err <= s_lim, (res_svd, s_err, s_lim)
    checks["svd 2^22x64"] = {"rel_residual_USVt_minus_A": res_svd,
                             "max_abs_err_S_vs_float64": s_err, "limit_S": s_lim,
                             "limit_S_is": "sqrt(rows)·u·s_max", "limit_residual": 1e-4}
    del U, S, V, s
    pair("svd 2^22x64", lambda: ht.linalg.svd(A),
         lambda: torch.linalg.svd(al, full_matrices=False), 2 * QR_ROWS * d * 4,
         4 * QR_ROWS * d * d, reps=1, inner=1)
    del A, al
    torch.cuda.empty_cache()

    # -- solve and cholesky at 4096^2, det and inv at 2048^2 --------------- #
    ht.random.seed(4)
    M = ht.random.randn(SOLVE_N, SOLVE_N)
    ml = M.larray
    spd = ml @ ml.T / SOLVE_N + torch.eye(SOLVE_N, device=dev)
    SPD = ht.array(spd)
    b = ht.random.randn(SOLVE_N)
    L = ht.linalg.cholesky(SPD)
    ll = L.larray
    chol_res = float(torch.linalg.norm(ll @ ll.T - spd) / torch.linalg.norm(spd))
    assert bool((torch.triu(ll, 1) == 0).all()) and chol_res <= 1e-5, chol_res
    xs = ht.linalg.solve(SPD, b).larray
    solve_res = float(torch.linalg.norm(spd @ xs - b.larray) /
                      (torch.linalg.norm(spd) * torch.linalg.norm(xs)))
    assert solve_res <= 1e-5, solve_res
    checks["cholesky 4096^2"] = {"rel_residual_LLt_minus_A": chol_res, "limit": 1e-5}
    checks["solve 4096^2"] = {"rel_residual_Ax_minus_b": solve_res, "limit": 1e-5}
    pair("cholesky 4096^2", lambda: ht.linalg.cholesky(SPD), lambda: torch.linalg.cholesky(spd),
         2 * SOLVE_N**2 * 4, SOLVE_N**3 // 3, reps=3, inner=1)
    pair("solve 4096^2", lambda: ht.linalg.solve(SPD, b),
         lambda: torch.linalg.solve(spd, b.larray), SOLVE_N**2 * 4 + 2 * SOLVE_N * 4,
         2 * SOLVE_N**3 // 3, reps=3, inner=1)
    del M, ml, spd, SPD, b, L, ll, xs
    ht.random.seed(5)
    G = ht.random.randn(DET_N, DET_N)
    gl = torch.eye(DET_N, device=dev) + G.larray * (0.5 / math.sqrt(DET_N))
    Gm = ht.array(gl)
    det = float(ht.linalg.det(Gm).item())
    sgn, logabs = torch.linalg.slogdet(gl.double())
    det64 = float(sgn) * math.exp(float(logabs))
    det_rel = abs(det - det64) / abs(det64)
    inv_res = float((gl @ ht.linalg.inv(Gm).larray - torch.eye(DET_N, device=dev)).abs().max())
    assert det_rel <= 1e-3 and inv_res <= 1e-4, (det_rel, inv_res)
    checks["det 2048^2"] = {"det": det, "rel_err_vs_float64": det_rel, "limit": 1e-3}
    checks["inv 2048^2"] = {"max_abs_A_inv_minus_I": inv_res, "limit": 1e-4}
    pair("det 2048^2", lambda: ht.linalg.det(Gm), lambda: torch.linalg.det(gl),
         DET_N**2 * 4, 2 * DET_N**3 // 3, reps=3, inner=1)
    pair("inv 2048^2", lambda: ht.linalg.inv(Gm), lambda: torch.linalg.inv(gl),
         2 * DET_N**2 * 4, 2 * DET_N**3, reps=3, inner=1)
    del G, gl, Gm
    torch.cuda.empty_cache()

    # -- Spectral at distance_matrix's shape: four Gaussian blobs --------- #
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((SPECTRAL_K, CDIST_D)) * 10
    truth = rng.integers(0, SPECTRAL_K, CDIST_N)
    pts = (centers[truth] + rng.standard_normal((CDIST_N, CDIST_D))).astype(np.float32)
    gam = 1.0 / (4 * CDIST_D)  # 2 sigma^2 = 4 d: a blob's own pairs near exp(-1/2)
    Xs = ht.array(pts, split=0)
    sp = ht.cluster.Spectral(n_clusters=SPECTRAL_K, gamma=gam, n_lanczos=SPECTRAL_LANCZOS)
    ht.random.seed(6)
    tk.reset_launches()
    Lap = sp._laplacian.construct(Xs)
    rbf_launches = tk.launches["cdist_tile"]  # the rbf route: sqrt=False, float32 out
    assert rbf_launches >= 1, rbf_launches
    V, T = ht.linalg.lanczos(Lap, SPECTRAL_LANCZOS)
    vl, tl = V.larray, T.larray
    lv = Lap.larray @ vl
    rel_lanczos = float((lv - vl @ tl)[:, :-1].abs().max())
    orth_v = float((vl.T @ vl - torch.eye(vl.shape[1], device=dev)).abs().max())
    assert rel_lanczos <= 1e-3 and orth_v <= 1e-3, (rel_lanczos, orth_v)
    del Lap, V, T, vl, tl, lv
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    ht.random.seed(6)
    t0 = time.perf_counter()
    sp.fit(Xs)
    labels = sp.labels_.larray
    torch.cuda.synchronize()
    spectral_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    peak = torch.cuda.max_memory_allocated()
    assert launches["cdist_tile"] >= 1 and launches["kmeans_step"] == sp.n_iter_ >= 1, launches
    table = torch.bincount(torch.as_tensor(truth, device=labels.device) * SPECTRAL_K + labels,
                           minlength=SPECTRAL_K**2).reshape(SPECTRAL_K, SPECTRAL_K)
    agree = float(table.max(1).values.sum()) / CDIST_N
    one_to_one = len(set(table.argmax(1).tolist())) == SPECTRAL_K
    assert agree >= 0.99 and one_to_one, (agree, table.tolist())
    checks["spectral 40000x18"] = {"lanczos_max_abs_LV_minus_VT": rel_lanczos,
                                   "lanczos_max_abs_VtV_minus_I": orth_v, "limits": [1e-3, 1e-3],
                                   "label_agreement_with_blobs": agree,
                                   "clusters_one_to_one": one_to_one}
    out["spectral"] = {"wall_s": spectral_s, "peak_memory_bytes": peak, "launches": launches,
                       "cdist_tile_launches_of_the_laplacian_alone": rbf_launches,
                       "n_iter": sp.n_iter_, "gamma": gam, "n_lanczos": SPECTRAL_LANCZOS}
    del Xs, sp, labels
    torch.cuda.empty_cache()

    # -- Lasso at the lasso benchmark's strong size ----------------------- #
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(LASSO_N, LASSO_D)).astype(np.float32)
    wn = np.zeros(LASSO_D, np.float32)
    wn[:LASSO_D // 4] = rng.normal(size=LASSO_D // 4)
    yn = xn @ wn + 0.01 * rng.normal(size=LASSO_N).astype(np.float32)
    xd, yd = ht.array(xn, split=0), ht.array(yn, split=0)
    del xn, yn
    est = ht.regression.Lasso(lam=LASSO_LAM, max_iter=LASSO_SWEEPS, tol=-1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(xd, yd)
    theta = est.theta.larray.reshape(-1)
    torch.cuda.synchronize()
    lasso_s = time.perf_counter() - t0
    # a plain float64 coordinate descent on the card, the same sweeps
    X64 = torch.cat([torch.ones((LASSO_N, 1), dtype=torch.float64, device=dev),
                     xd.larray.double()], 1)
    y64 = yd.larray.double()
    col = (X64 * X64).sum(0)
    th = torch.zeros(LASSO_D + 1, dtype=torch.float64, device=dev)
    lam_n = LASSO_LAM * LASSO_N
    for _ in range(LASSO_SWEEPS):
        for j in range(LASSO_D + 1):
            rho = X64[:, j] @ (y64 - X64 @ th + X64[:, j] * th[j])
            th[j] = rho / col[j] if j == 0 else \
                torch.sign(rho) * torch.clamp(rho.abs() - lam_n, min=0) / col[j]
    err = float((theta.double() - th).abs().max())
    lasso_tol = 1e-4 * float(th.abs().max())
    assert est.n_iter == LASSO_SWEEPS and err <= lasso_tol, (err, lasso_tol)
    checks["lasso 2^20x64"] = {"max_abs_err_theta_vs_float64": err, "limit": lasso_tol,
                               "limit_is": "1e-4 of max |theta|"}
    out["lasso"] = {"seconds": lasso_s, "seconds_per_sweep": lasso_s / LASSO_SWEEPS,
                    "sweeps": est.n_iter}
    del xd, yd, est, X64, y64, th
    torch.cuda.empty_cache()
    emit({"phase": "linalg_path", "card": smi, "checks": checks, "times_ms": times, **out,
          "comm_stats": dict(ht.get_comm().stats)})
    return launches


# phase 5f sizes: bench.py's out-of-core scenario (:1120-1147: 100M float32
# elements, n x 64, 2^17 rows a chunk, 3 epochs), distance_matrix's strong
# size for the CSV leg (benchmarks/config.json), and the kmeans cell's width
# and k at an eighth of its rows for KMedians and KMedoids
STREAM_ROWS, STREAM_CHUNK, STREAM_EPOCHS = 100_000_000 // N_FEATURES, 2**17, 3
MED_ROWS, MED_ITERS = 2**20, 10
IO_DIR = "chip_smoke_io"  # gitignored; removed when the phase ends


def manhattan64(x, c):
    """(n, k) float64 manhattan distances, one centroid at a time."""
    return np.stack([np.abs(x - cj).sum(axis=1) for cj in c], axis=1)


def label_check(x64, prev, labels, d):
    """Labels of the last step against float64 distances to the centroids it
    started from: a label that differs from the float64 argmin must lie
    within twice a float32 manhattan sum's error bound ((d + 1)·u·D) of it."""
    dist = manhattan64(x64, prev.astype(np.float64))
    best = dist.argmin(axis=1)
    gap = dist[np.arange(len(labels)), labels] - dist.min(axis=1)
    band = 2 * (d + 1) * U32 * dist.max(axis=1)
    differ = labels != best
    return int(differ.sum()), int((differ & (gap > band)).sum())


def io_stream(torch, ht, tk, smi):
    """Phase 5f: file I/O and the out-of-core fit. bench.py's 100M-element
    dataset written by the port's ``save_netcdf`` (and ``save_hdf5`` where
    h5py imports), streamed back by ``load_*(stream=True)`` into
    ``KMeans.fit_stream`` (one ``kmeans_step`` launch a chunk a pass), held
    against the in-memory fit; ``save_csv``/``load_csv`` at 40,000 x 18 on
    the native parser; KMedians and KMedoids at 2^20 x 64, their last step
    checked again in float64. Returns the phase's kernel launches."""

    from heat_tpu_torch import native
    from heat_tpu_torch.core import io as htio

    checks, out, launches = {}, {}, {"cdist_tile": 0, "kmeans_step": 0}
    os.makedirs(IO_DIR, exist_ok=True)
    try:
        # -- bench.py's out-of-core dataset ---------------------------- #
        rng = np.random.default_rng(1120)
        xn = rng.standard_normal((STREAM_ROWS, N_FEATURES), dtype=np.float32)
        seed = ht.array(rng.standard_normal((K, N_FEATURES)).astype(np.float32))
        X = ht.array(xn, split=0)
        legs = {"netcdf": (htio.save_netcdf, htio.load_netcdf, f"{IO_DIR}/stream.nc")}
        if htio.supports_hdf5():
            legs["hdf5"] = (htio.save_hdf5, htio.load_hdf5, f"{IO_DIR}/stream.h5")
        else:
            print("io_stream: h5py does not import here: the HDF5 leg does not run, "
                  "the NetCDF leg does", flush=True)
        for name, (save, _, path) in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(X, path, "data")
            out[f"{name}_save_s"] = time.perf_counter() - t0
        del X
        torch.cuda.empty_cache()
        n_chunks = -(-STREAM_ROWS // STREAM_CHUNK)
        tail = STREAM_ROWS - (n_chunks - 1) * STREAM_CHUNK
        # the geometry pass reads one chunk (explicit init), each epoch and
        # the finalize pass all of them; each chunk of a pass one launch
        want_chunks = 1 + (STREAM_EPOCHS + 1) * n_chunks
        want_launches = (STREAM_EPOCHS + 1) * n_chunks
        chunk_bytes = STREAM_CHUNK * N_FEATURES * 4
        fits = {}
        for name, (_, load, path) in legs.items():
            stream = load(path, "data", stream=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tk.reset_launches()
            t0 = time.perf_counter()
            km = ht.cluster.KMeans(n_clusters=K, init=seed, max_iter=STREAM_EPOCHS,
                                   tol=-1).fit_stream(stream, rows_per_chunk=STREAM_CHUNK)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            got = dict(tk.launches)
            peak = torch.cuda.max_memory_allocated() - base
            launches["kmeans_step"] += got["kmeans_step"]
            assert got["kmeans_step"] == want_launches, (name, got)
            assert stream.chunks_read == want_chunks, (name, stream.chunks_read)
            assert stream.peak_chunk_bytes == chunk_bytes, stream.peak_chunk_bytes
            assert km.labels_ is None and km.n_iter_ == STREAM_EPOCHS
            assert peak < 4 * chunk_bytes + K * N_FEATURES * 4, (name, peak)
            fits[name] = km
            out[name] = {"file_MB": os.path.getsize(path) / 1e6,
                         "backend": "h5py" if name == "hdf5" else htio._NETCDF,
                         "seconds": fit_s,
                         "Mrows_per_s": STREAM_EPOCHS * STREAM_ROWS / fit_s / 1e6,
                         "chunks_read": stream.chunks_read, "chunks_a_pass": n_chunks,
                         "last_chunk_rows": tail, "bytes_read": stream.bytes_read,
                         "peak_chunk_MB": stream.peak_chunk_bytes / 1e6,
                         "peak_device_MB_during_fit": peak / 1e6,
                         "kmeans_step_launches": got["kmeans_step"],
                         "inertia": km.inertia_}
        # the in-memory fit of the same data and seed rows
        X = ht.array(xn, split=0)
        tk.reset_launches()
        ref = ht.cluster.KMeans(n_clusters=K, init=seed, max_iter=STREAM_EPOCHS,
                                tol=-1).fit(X)
        launches["kmeans_step"] += tk.launches["kmeans_step"]
        assert tk.launches["kmeans_step"] == STREAM_EPOCHS, tk.launches
        for name, km in fits.items():
            d_c = float((km.cluster_centers_.larray - ref.cluster_centers_.larray).abs().max())
            d_i = abs(km.inertia_ - ref.inertia_) / abs(ref.inertia_)
            assert d_c <= 1e-3 and d_i <= 1e-4, (name, d_c, d_i)
            checks[f"{name}_stream_vs_in_memory_fit"] = {
                "max_abs_err_centers": d_c, "limit": 1e-3, "inertia_rel_err": d_i,
                "inertia_limit": 1e-4}
        # the kernel at the streamed path's two shapes, unmasked, against
        # its plain version: a full chunk and the last, with the centroids
        # of the finalize pass
        cf = fits["netcdf"].cluster_centers_.larray.contiguous()
        for label, rows in (("full_chunk", slice(0, STREAM_CHUNK)),
                            ("last_chunk", slice(STREAM_ROWS - tail, STREAM_ROWS))):
            xc = torch.from_numpy(xn[rows]).to(cf.device)
            path_call = tk.kmeans_step(xc, cf)
            got = tk.kmeans_step(xc, cf, return_labels=True)
            assert all(torch.equal(a, b) for a, b in zip(path_call, got)), \
                f"kmeans_step {label}: the unlabelled call differs from the labelled one"
            want = tk.kmeans_step_plain(xc, cf, return_labels=True)
            every = torch.ones(xc.shape[0], dtype=torch.bool, device=xc.device)
            checks[f"kmeans_step_{label}_{xc.shape[0]}x{N_FEATURES}_vs_plain"] = \
                check_kmeans_step(torch, xc, cf, every, got, want)
            del xc, path_call, got, want, every
        del X, xn, fits, ref, cf
        torch.cuda.empty_cache()

        # -- CSV at distance_matrix's strong size ---------------------- #
        # the parser is built by g++ at its first use: build it untimed
        t0 = time.perf_counter()
        assert native.available(), "the native CSV parser does not build"
        out["csv_parser_build_s"] = time.perf_counter() - t0
        yn = np.random.default_rng(40000).random((CDIST_N, CDIST_D), dtype=np.float32)
        Yd = ht.array(yn, split=0)
        path = f"{IO_DIR}/y.csv"
        t0 = time.perf_counter()
        ht.save_csv(Yd, path)
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        native_before = htio.csv_routes["native"]
        t0 = time.perf_counter()
        Z = ht.load_csv(path, split=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert htio.csv_routes["native"] == native_before + 1, htio.csv_routes
        assert Z.larray.device == Yd.larray.device and torch.equal(Z.larray, Yd.larray), \
            "load_csv differs"
        out["csv"] = {"shape": [CDIST_N, CDIST_D], "file_MB": mb, "save_s": save_s,
                      "save_MB_per_s": mb / save_s, "load_s": load_s,
                      "load_MB_per_s": mb / load_s, "route": "native", "bitwise_equal": True}
        del Yd, Z

        # -- KMedians and KMedoids at 2^20 x 64 ------------------------ #
        ht.random.seed(3)
        Xm = ht.random.rand(MED_ROWS, N_FEATURES, split=0)
        x32 = Xm.larray.cpu().numpy()
        x64 = x32.astype(np.float64)
        for name in ("KMedians", "KMedoids"):
            kw = {"tol": -1} if name == "KMedians" else {}
            est = getattr(ht.cluster, name)(n_clusters=K, init="kmeans++", max_iter=MED_ITERS,
                                            random_state=0, **kw)
            rec = {"steps_s": []}
            local_step = est._local_step

            def recording(x, c, _step=local_step, _rec=rec):
                _rec.setdefault("seeds", c.clone())
                _rec["prev"] = c.clone()
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = _step(x, c)
                torch.cuda.synchronize()
                _rec["steps_s"].append(time.perf_counter() - t)
                return res

            est._local_step = recording
            tk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.fit(Xm)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            got = dict(tk.launches)
            launches["cdist_tile"] += got["cdist_tile"]
            assert got["cdist_tile"] == K - 1, got  # the k-means++ seeds
            # cdist_tile at the seeding's smallest and largest shapes, as
            # spatial.distance.cdist launches it, against its plain version
            for j in (1, K - 1):
                err, ratio = check_cdist(torch, tk, Xm.larray, rec["seeds"][:j].contiguous(),
                                         sqrt=True)
                checks[f"{name} cdist_tile {MED_ROWS}x{N_FEATURES} vs {j} seeds"] = {
                    "max_abs_err": err, "max_err_over_limit": ratio}
            prev = rec["prev"].cpu().numpy()
            centers = est.cluster_centers_.larray.cpu().numpy()
            labels = est.labels_.larray.cpu().numpy()
            n_differ, n_unexplained = label_check(x64, prev, labels, N_FEATURES)
            assert n_unexplained == 0, (name, n_differ, n_unexplained)
            chk = {"labels_differing_from_float64": n_differ,
                   "labels_differing_not_near_tie": n_unexplained}
            if name == "KMedians":
                want = prev.copy()
                for j in range(K):
                    m = x32[labels == j]
                    if len(m):
                        lo, hi = (len(m) - 1) // 2, len(m) // 2
                        part = np.partition(m, [lo, hi], axis=0)
                        want[j] = (0.5 * (part[lo].astype(np.float64)
                                          + part[hi].astype(np.float64))).astype(np.float32)
                assert np.array_equal(centers, want), "medians differ from float64's"
                chk["medians_equal_float64"] = True
            else:
                xl = Xm.larray
                lab = est.labels_.larray
                onehot = (lab[:, None] == torch.arange(K, device=lab.device)[None, :]).float()
                mean32 = ((onehot.T @ xl) / onehot.sum(0).clamp(min=1)[:, None]).cpu().numpy()
                exact = 0
                for j in range(K):
                    m64 = x64[labels == j]
                    if not len(m64):
                        assert np.array_equal(centers[j], prev[j])
                        continue
                    mean64 = m64.mean(axis=0)
                    dm = np.abs(m64 - mean64).sum(axis=1)
                    is_row = np.all(x32[labels == j] == centers[j], axis=1)
                    assert is_row.any(), f"medoid {j} is no member row"
                    d_med = np.abs(centers[j].astype(np.float64) - mean64).sum()
                    band = (2 * (N_FEATURES + 1) * U32 * dm.max()
                            + 2 * np.abs(mean32[j] - mean64).sum())
                    assert d_med - dm.min() <= band, (j, d_med - dm.min(), band)
                    exact += int(np.array_equal(centers[j], x32[labels == j][dm.argmin()]))
                chk["medoids_member_rows_within_band"] = True
                chk["medoids_equal_float64_argmin_row"] = exact
            checks[f"{name} 2^20x64"] = chk
            steps = rec["steps_s"]
            out[name] = {"rows": MED_ROWS, "reduced": "2^20 rows: an eighth of the kmeans "
                         "cell's 2^23, its width 64 and k 8", "n_iter": est.n_iter_,
                         "fit_s": fit_s, "s_per_iteration": statistics.median(steps),
                         "seeding_and_rest_s": fit_s - sum(steps), "launches": got}
            del est
        del Xm, x32, x64
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(IO_DIR, ignore_errors=True)
    emit({"phase": "io_stream", "card": smi, "checks": checks, **out, "launches": launches,
          "comm_stats": dict(ht.get_comm().stats)})
    return launches


# phase 5g sizes: bench.py's --data-bench (:1217-1290: 10,000,000 rows in 64
# groups, the top 64, the exact median and p99 of a 100,000,000-element
# float32 stream in 2^20-row chunks); a fact table of those 10,000,000 rows
# joined to a dimension table of 2^21 unique keys; examples/data_pipeline.py's
# (station, magnitude) table (make_table, seed 7) at 10,000,000 rows;
# GaussianNB at the kmeans cell's width and k at an eighth of its rows; KNN at
# distance_matrix's strong size (benchmarks/config.json)
ENGINE_ROWS, ENGINE_GROUPS, ENGINE_K = 10_000_000, 64, 64
JOIN_RIGHT = 2**21
QUANT_ELEMS, QUANT_CHUNK, QUANT_Q = 100_000_000, 2**20, (0.5, 0.99)
TABLE_ROWS, TABLE_STATIONS, TABLE_TOPK = 10_000_000, 16, 5
GNB_ROWS = 2**20
KNN_K = 5
PARTIAL_ROWS = 2**16
U64 = 2.0**-53  # float64 unit roundoff


def knn_blobs():
    """Phase 5g's KNN data: 40,000 training points around SPECTRAL_K centres
    with their labels, and 40,000 test points."""
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((SPECTRAL_K, CDIST_D)) * 10
    truth = rng.integers(0, SPECTRAL_K, CDIST_N)
    pts = (centers[truth] + rng.standard_normal((CDIST_N, CDIST_D))).astype(np.float32)
    rng = np.random.default_rng(2)
    tt = rng.integers(0, SPECTRAL_K, CDIST_N)
    test = (centers[tt] + rng.standard_normal((CDIST_N, CDIST_D))).astype(np.float32)
    return pts, truth, test, tt


def make_table(rng, rows, stations, feats, clusters):
    """examples/data_pipeline.py's synthetic readings (its ``make_table``):
    station id, magnitude, and a feature block drawn from ``clusters``
    hidden modes."""
    station = rng.integers(0, stations, rows).astype(np.float64)
    mode = rng.integers(0, clusters, rows)
    centers = rng.normal(0.0, 6.0, size=(clusters, feats))
    x = centers[mode] + rng.normal(0.0, 0.4, size=(rows, feats))
    magnitude = np.abs(rng.standard_normal(rows)) + (mode == 0) * 1.5
    return station, magnitude.astype(np.float64), x.astype(np.float32)


def merge_join(torch, lk, lv, rk, rv):
    """A sort-merge inner join in torch, independent of the engine's hash
    probe: both key columns sorted together (a right row before a left row
    of its key), each left row matched to the last right row at or before
    it; the matches in left-position order (the engine's order at world
    size 1). Right keys unique."""
    nr = rk.numel()
    allk = torch.cat([rk, lk])
    tag = torch.cat([torch.zeros_like(rk), torch.ones_like(lk)])
    order = torch.sort(allk * 2 + tag, stable=True).indices
    is_r = order < nr
    pos = torch.arange(order.numel(), device=lk.device)
    last_r = torch.cummax(torch.where(is_r, pos, torch.full_like(pos, -1)), 0).values
    sk = allk[order]
    ok = ~is_r & (last_r >= 0) & (sk[last_r.clamp(min=0)] == sk)
    li, ri = order[ok] - nr, order[last_r[ok]]
    o = torch.argsort(li)
    li, ri = li[o], ri[o]
    return lk[li], lv[li], rv[ri]


def group_sums64(torch, keys, vals, G):
    """float64 per-group sums, counts and sums of |v|."""
    v = vals.double()
    z = torch.zeros(G, dtype=torch.float64, device=v.device)
    return (z.clone().index_add_(0, keys, v), z.clone().index_add_(0, keys, torch.ones_like(v)),
            z.clone().index_add_(0, keys, v.abs()))


def data_engine(torch, ht, tk, smi, bw):
    """Phase 5g: the data engine and the last estimators at the sizes users
    run them at. groupby, top-k and join on 10M rows, the exact streamed
    quantiles of a 100M-element NetCDF stream, the streamed groupby and
    top-k of data_pipeline.py's table, GaussianNB at 2^20 x 64, KNN at
    40,000^2 x 18 (one ``cdist_tile`` launch, asserted), and, where h5py
    imports, the HDF5 loader; each held against a plain computation on the
    same card tensors. Returns the phase's kernel launches."""

    from heat_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    checks, ops, out = {}, {}, {}
    launches = {"cdist_tile": 0, "kmeans_step": 0}
    comm = ht.get_comm()
    comm.reset_stats()
    stats0 = ht.data.stats()

    def timed(name, fn, rows, nbytes, reps=3):
        """device ms (CUDA events, median of ``reps`` calls after a warm-up)
        and host µs of one call, Mrows/s and the bytes bound."""
        ms = time_ms(torch, fn, reps=reps, inner=1)
        _, us = once_ms_us(torch, fn)
        ops[name] = {"device_ms": ms, "host_us": us, "Mrows_per_s": rows / ms / 1e3,
                     "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes"}

    # -- 1. the engine in memory (bench.py:1217-1241) ----------------- #
    rng = np.random.default_rng(0)
    keys = rng.integers(0, ENGINE_GROUPS, ENGINE_ROWS).astype(np.int64)
    vals = rng.standard_normal(ENGINE_ROWS).astype(np.float32)
    Kd, Vd = ht.array(keys, split=0), ht.array(vals, split=0)
    kl, vl = Kd.larray, Vd.larray
    G = ENGINE_GROUPS
    gb = ht.data.groupby(Kd, G)
    res = {op: gb.agg(op, None if op == "count" else Vd).larray
           for op in ("sum", "mean", "count", "min", "max")}
    s64, n64, a64 = group_sums64(torch, kl, vl, G)
    assert torch.equal(res["count"], torch.bincount(kl, minlength=G)), "groupby count"
    for op in ("min", "max"):
        want = torch.full((G,), float("inf") if op == "min" else float("-inf"),
                          device=vl.device).scatter_reduce(0, kl, vl, "a" + op)
        assert torch.equal(res[op], want), f"groupby {op}"
    # a float32 sum of n terms lies within (n - 1)·u·Σ|v| of the exact sum in
    # any order; the float64 mean within n·2^-53·Σ|v| / n of the float64 one
    err = (res["sum"].double() - s64).abs()
    tol = (n64 - 1) * U32 * a64
    assert bool((err <= tol).all()), "groupby sum beyond its float32 bound"
    err_m = (res["mean"] - s64 / n64).abs()
    tol_m = 2 * n64 * U64 * a64 / n64
    assert res["mean"].dtype == torch.float64 and bool((err_m <= tol_m).all()), "groupby mean"
    checks["groupby_10M_64"] = {"count_min_max_bitwise": True,
                                "sum_max_err_over_bound": float((err / tol).max()),
                                "mean_max_err_over_bound": float((err_m / tol_m).max())}
    for op in ("sum", "mean", "count", "min", "max"):
        timed(f"groupby_{op}", (lambda o=op: gb.agg(o, None if o == "count" else Vd)),
              ENGINE_ROWS, ENGINE_ROWS * (8 + (0 if op == "count" else 4)))
    del res, s64, n64, a64, err, tol, err_m, tol_m

    tv, ti = ht.data.topk(Vd, ENGINE_K)
    srt = torch.sort(vl, descending=True, stable=True)
    assert torch.equal(tv.larray, srt.values[:ENGINE_K]) and \
        torch.equal(ti.larray, srt.indices[:ENGINE_K]), "topk differs from the stable sort"
    checks[f"topk_{ENGINE_K}_of_10M"] = {"values_and_indices_bitwise": True}
    timed("topk_64", lambda: ht.data.topk(Vd, ENGINE_K), ENGINE_ROWS, ENGINE_ROWS * 4)
    ops["topk_64"]["torch.topk_ms"] = time_ms(torch, lambda: torch.topk(vl, ENGINE_K), reps=3,
                                              inner=1)
    del srt, tv, ti

    rk_np = rng.permutation(JOIN_RIGHT).astype(np.int64)
    lk_np = rng.integers(0, JOIN_RIGHT, ENGINE_ROWS).astype(np.int64)
    LK, LV = ht.array(lk_np, split=0), Vd
    RK = ht.array(rk_np, split=0)
    RV = ht.array(rng.standard_normal(JOIN_RIGHT).astype(np.float32), split=0)
    jk, jl, jr = ht.data.join(LK, LV, RK, RV)
    wk, wl, wr = merge_join(torch, LK.larray, LV.larray, RK.larray, RV.larray)
    assert jk.shape == (wk.numel(),) and jk.split == 0, jk.shape
    assert torch.equal(jk.larray, wk) and torch.equal(jl.larray, wl) and \
        torch.equal(jr.larray, wr), "join differs from the sort-merge join"
    checks["join_10M_x_2^21"] = {"rows": int(wk.numel()), "bitwise_vs_sort_merge": True}
    timed("join_10M_x_2^21", lambda: ht.data.join(LK, LV, RK, RV), ENGINE_ROWS,
          ENGINE_ROWS * (8 + 4) + JOIN_RIGHT * (8 + 4) + wk.numel() * (8 + 4 + 4))
    del jk, jl, jr, wk, wl, wr, LK, LV, RK, RV, Kd, Vd, kl, vl, gb, keys, vals, lk_np, rk_np
    torch.cuda.empty_cache()

    os.makedirs(IO_DIR, exist_ok=True)
    try:
        # -- 2. the streamed folds (bench.py:1244-1290) --------------- #
        data = np.random.default_rng(1244).standard_normal(QUANT_ELEMS, dtype=np.float32)
        path = f"{IO_DIR}/quantile.nc"
        D = ht.array(data, split=0)
        t0 = time.perf_counter()
        ht.save_netcdf(D, path, "data")
        out["quantile_file_save_s"] = time.perf_counter() - t0
        del D
        n_chunks = -(-QUANT_ELEMS // QUANT_CHUNK)
        vt = torch.from_numpy(data).to(torch.cuda.current_device()
                                       if torch.cuda.is_available() else "cpu")
        del data
        got = {}
        for interp in ("linear", "lower", "higher"):
            stream = ht.load_netcdf(path, "data", stream=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = ht.data.stream_quantile(stream, list(QUANT_Q), rows_per_chunk=QUANT_CHUNK,
                                        interpolation=interp)
            secs = time.perf_counter() - t0
            passes, rest = divmod(stream.chunks_read - 1, n_chunks)
            assert rest == 0, stream.chunks_read
            got[interp] = q
            out[f"stream_quantile_{interp}"] = {
                "seconds": secs, "passes": passes, "chunks_read": stream.chunks_read,
                "Mrows_per_s": passes * QUANT_ELEMS / secs / 1e6,
                "peak_chunk_MB": stream.peak_chunk_bytes / 1e6, "values": q.tolist()}
        for i, qv in enumerate(QUANT_Q):
            f = (QUANT_ELEMS - 1) * qv
            lo, hi = int(np.floor(f)), int(np.ceil(f))
            a = float(torch.kthvalue(vt, lo + 1).values)
            b = float(torch.kthvalue(vt, hi + 1).values)
            lin = np.float64(a) if lo == hi else \
                np.float64(a) + (np.float64(b) - np.float64(a)) * np.float64(f - lo)
            assert got["lower"][i] == a and got["higher"][i] == b, (qv, got, a, b)
            assert got["linear"][i] == lin, (qv, got["linear"][i], lin)
            checks[f"stream_quantile_q{qv}"] = {
                "order_stats_equal_kthvalue": True, "linear_equals_numpy_rule_float64": True,
                "ranks": [lo, hi]}
        del vt

        rng7 = np.random.default_rng(7)
        station, magnitude, _ = make_table(rng7, TABLE_ROWS, TABLE_STATIONS, 8, 4)
        table = np.stack([station, magnitude], axis=1)
        tpath = f"{IO_DIR}/table.nc"
        ht.save_netcdf(ht.array(table, split=0), tpath, "table")
        del table
        stream = ht.load_netcdf(tpath, "table", dtype=ht.float64, stream=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sg = ht.data.stream_groupby(stream, TABLE_STATIONS, "mean", rows_per_chunk=QUANT_CHUNK)
        torch.cuda.synchronize()
        sg_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv, si = ht.data.stream_topk(stream, TABLE_TOPK, col=1, rows_per_chunk=QUANT_CHUNK)
        torch.cuda.synchronize()
        st_s = time.perf_counter() - t0
        St = ht.array(station.astype(np.int64), split=0)
        Mg = ht.array(magnitude, split=0)
        mg = ht.data.groupby(St, TABLE_STATIONS).mean(Mg).larray
        mv, mi = ht.data.topk(Mg, TABLE_TOPK)
        s64, n64, a64 = group_sums64(torch, St.larray, Mg.larray, TABLE_STATIONS)
        err = (sg.larray - mg).abs()
        tol = 4 * n64 * U64 * a64 / n64  # two float64 sums of the same terms
        assert bool((err <= tol).all()), "stream_groupby mean differs from the in-memory one"
        assert torch.equal(sv.larray, mv.larray) and torch.equal(si.larray, mi.larray), \
            "stream_topk differs from the in-memory topk"
        checks["stream_groupby_mean_vs_in_memory"] = {
            "max_err_over_bound": float((err / tol).max())}
        checks["stream_topk_vs_in_memory"] = {"bitwise": True}
        out["table_stream"] = {"rows": TABLE_ROWS, "chunks_read": stream.chunks_read,
                               "stream_groupby_s": sg_s, "stream_topk_s": st_s,
                               "Mrows_per_s_groupby": TABLE_ROWS / sg_s / 1e6,
                               "Mrows_per_s_topk": TABLE_ROWS / st_s / 1e6,
                               "per_station_mean": sg.larray.tolist()}
        del St, Mg, mg, mv, mi, sg, sv, si, station, magnitude, s64, n64, a64, err, tol

        # -- 5. the HDF5 loader, where h5py imports -------------------- #
        try:
            import h5py
        except ImportError:
            h5py = None
            print("data_engine: h5py does not import here: the PartialH5DataLoaderIter step "
                  "does not run", flush=True)
        if h5py is not None:
            hp = f"{IO_DIR}/partial.h5"
            rows = np.random.default_rng(5).standard_normal((PARTIAL_ROWS, 64)).astype(
                np.float32)
            with h5py.File(hp, "w") as f:
                f.create_dataset("data", data=rows)
            ds = ht.utils.data.PartialH5Dataset(hp, initial_load=2**14, load_length=2**13)
            t0 = time.perf_counter()
            seen = torch.cat([b for b in ht.utils.data.PartialH5DataLoaderIter(
                ds, batch_size=256, seed=0)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            want = torch.from_numpy(rows).to(seen.device)
            assert seen.shape == want.shape and torch.equal(
                torch.sort(seen[:, 0]).values, torch.sort(want[:, 0]).values)
            out["partial_h5"] = {"rows": PARTIAL_ROWS, "seconds": secs, "ran": True}
        else:
            out["partial_h5"] = {"ran": False, "reason": "h5py does not import"}
    finally:
        shutil.rmtree(IO_DIR, ignore_errors=True)

    # -- 3. GaussianNB at 2^20 x 64, 8 blobs ------------------------ #
    rng = np.random.default_rng(20)
    centers = rng.standard_normal((K, N_FEATURES)) * 3
    y = rng.integers(0, K, GNB_ROWS)
    x = (centers[y] + rng.standard_normal((GNB_ROWS, N_FEATURES))).astype(np.float32)
    X, Y = ht.array(x, split=0), ht.array(y, split=0)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    nb = ht.naive_bayes.GaussianNB().fit(X, Y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab = nb.predict(X).larray
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    x64, yl = X.larray.double(), Y.larray
    cnt = torch.bincount(yl, minlength=K)
    assert torch.equal(nb.class_count_.larray, cnt.double()), "GaussianNB class counts"
    eps = 1e-9 * float(x64.var(0, unbiased=False).max())
    theta = torch.stack([x64[yl == j].mean(0) for j in range(K)])
    var = torch.stack([((x64[yl == j] - theta[j]) ** 2).mean(0) for j in range(K)]) + eps
    d_t = float(((nb.theta_.larray - theta).abs() / theta.abs().max()).max())
    d_v = float(((nb.var_.larray - var).abs() / var).max())
    assert d_t <= 1e-10 and d_v <= 1e-10, (d_t, d_v)
    prior = torch.log(cnt.double() / GNB_ROWS)
    jll = torch.stack([prior[j] - 0.5 * torch.log(2 * math.pi * var[j]).sum()
                       - 0.5 * ((x64 - theta[j]) ** 2 / var[j]).sum(1) for j in range(K)], 1)
    top2 = torch.topk(jll, 2, dim=1)
    plain = top2.indices[:, 0]
    near = (top2.values[:, 0] - top2.values[:, 1]) <= 1e-9 * top2.values[:, 0].abs()
    differ = lab != plain
    n_differ, n_unexplained = int(differ.sum()), int((differ & ~near).sum())
    assert n_unexplained == 0, (n_differ, n_unexplained)
    checks["gaussiannb_2^20x64_k8"] = {
        "counts_exact": True, "theta_max_rel_err": d_t, "var_max_rel_err": d_v,
        "limit": 1e-10, "labels_differing_from_float64": n_differ,
        "labels_differing_not_near_tie": n_unexplained}
    out["gaussiannb"] = {"rows": GNB_ROWS, "features": N_FEATURES, "classes": K,
                         "reduced": "2^20 rows: an eighth of the kmeans cell's 2^23, its width "
                                    "64 and k 8", "fit_s": fit_s, "predict_s": pred_s,
                         "peak_device_MB": peak / 1e6}
    del X, Y, nb, x64, yl, theta, var, jll, top2, plain, near, differ, lab, cnt
    torch.cuda.empty_cache()

    # -- 4. KNeighborsClassifier(5) at 40,000^2 x 18 ----------------- #
    pts, truth, test, tt = knn_blobs()
    Xtr, Ytr = ht.array(pts, split=0), ht.array(truth, split=0)
    Xte = ht.array(test, split=0)
    knn = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(Xtr, Ytr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tk.reset_launches()
    t0 = time.perf_counter()
    pred = knn.predict(Xte).larray
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    got = dict(tk.launches)
    peak = torch.cuda.max_memory_allocated() - base
    assert got["cdist_tile"] == 1 and got["kmeans_step"] == 0, got
    launches["cdist_tile"] += got["cdist_tile"]
    # the plain float64 top-5 vote, a stripe of test rows at a time
    a, b = Xte.larray.double(), Xtr.larray.double()
    labels = Ytr.larray
    b2 = (b ** 2).sum(1)[None, :]
    plain = torch.empty_like(pred)
    near = torch.zeros_like(pred, dtype=torch.bool)
    for r in range(0, CDIST_N, 8192):
        ar = a[r:r + 8192]
        d2 = ((ar ** 2).sum(1)[:, None] + b2 - 2.0 * ar @ b.T).clamp_min(0)
        v6, i6 = torch.topk(d2, KNN_K + 1, dim=1, largest=False)
        lab5 = labels[i6[:, :KNN_K]]
        votes = (lab5[:, :, None] == torch.arange(SPECTRAL_K, device=lab5.device)).sum(1)
        plain[r:r + 8192] = votes.argmax(1)
        scale = (ar ** 2).sum(1) + float(b2.max())
        near[r:r + 8192] = (v6[:, KNN_K] - v6[:, KNN_K - 1]) <= 2 * d2_tol(CDIST_D, scale)
        del d2, v6, i6, lab5, votes
    differ = pred != plain
    n_differ, n_unexplained = int(differ.sum()), int((differ & ~near).sum())
    assert n_unexplained == 0, (n_differ, n_unexplained)
    err, ratio = check_cdist(torch, tk, Xte.larray, Xtr.larray, sqrt=True)
    checks["knn_40000x40000x18_k5"] = {
        "cdist_tile_launches": 1, "labels_differing_from_float64": n_differ,
        "labels_differing_not_near_tie": n_unexplained,
        "rows_with_distance_near_tie": int(near.sum()),
        "label_agreement_with_blobs": float((pred.cpu().numpy() == tt).mean())}
    checks["cdist_tile_40000x40000x18_test_vs_train"] = {"max_abs_err": err,
                                                         "max_err_over_limit": ratio}
    out["knn"] = {"train": CDIST_N, "test": CDIST_N, "features": CDIST_D, "k": KNN_K,
                  "seconds": knn_s, "peak_device_MB": peak / 1e6, "launches": got}
    del Xtr, Ytr, Xte, knn, pred, a, b, plain, near, differ, labels
    torch.cuda.empty_cache()

    st = ht.data.stats()
    counters = {k: v for k, v in metrics.counters().items()
                if k.startswith(("io.stream_", "data_engine."))}
    assert st["exchange_fallbacks"] == 0 and st["stream_fallbacks"] == 0, st
    out["data_stats"] = {
        k: v if k == "enabled" else
        {c: n - stats0[k][c] for c, n in v.items()} if isinstance(v, dict) else v - stats0[k]
        for k, v in st.items()}
    out["metrics_counters"] = counters
    emit({"phase": "data_engine", "card": smi, "checks": checks, "ops": ops, **out,
          "launches": launches, "comm_stats": dict(comm.stats),
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def serving_path(torch, ht, tk, dev, smi):
    """The serving main path at the flagship width, through the entry points
    a user calls; returns the figures and the path's launch counts."""
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig

    L, V = FLAGSHIP["n_layers"], FLAGSHIP["vocab"]
    rng = np.random.default_rng(7)
    lens = rng.integers(100, 1001, N_REQ)
    max_new = rng.choice(MAX_NEW_MIX[0], size=N_REQ, p=MAX_NEW_MIX[1])
    prompts = [rng.integers(0, V, int(n)).astype(np.int32) for n in lens]
    gaps = rng.uniform(0.0, GAP_MAX_S, N_REQ)
    i_eos = int(np.nonzero(max_new >= 12)[0][0])
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, compute_dtype=torch.bfloat16))
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # set-up: request i_eos stops at its third greedy token
    eos = int(model.generate(params, prompts[i_eos][None], 3)[0, -1])

    tk.reset_launches()
    toks = torch.randint(0, V, (8, 1024), device=dev, generator=g)
    t0 = time.perf_counter()
    logits = model.logits_fn()(params, toks)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    assert logits.shape == (8, 1024, V) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    gp = torch.randint(0, V, (8, 1000), device=dev, generator=g)
    t0 = time.perf_counter()
    out_gen = model.generate(params, gp, 32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert out_gen.shape == (8, 1032) and torch.equal(out_gen[:, :1000].long(), gp)
    assert int(out_gen.min()) >= 0 and int(out_gen.max()) < V

    eng = ht.serve.serve_transformer(model, params, SEQ_CAP, decode=True, slots=SLOTS)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        n_warm = int(math.log2(eng.S_cap // model.PROMPT_BUCKET_MIN))
        t0 = time.perf_counter()
        futs = []
        for i in range(N_REQ):
            futs.append(eng.submit(prompts[i], int(max_new[i]),
                                   eos_id=eos if i == i_eos else None))
            if gaps[i] > GAP_SLEEP_S:
                time.sleep(float(gaps[i]))
        assert eng.flush(600), "the engine did not answer every request"
        serve_s = time.perf_counter() - t0
        outs = [f.result(0) for f in futs]
        stats = eng.stats()
        launches = dict(tk.launches)
        buckets = sorted({model.prompt_bucket(int(n)) for n in lens})
        prefill_ms = {}
        for sp in buckets:
            times = []
            for _ in range(5):
                t1 = time.perf_counter()
                eng._dispatch_prefill(np.zeros(sp, np.int32), 0, record=False)
                times.append((time.perf_counter() - t1) * 1e3)
            prefill_ms[str(sp)] = statistics.median(times)
        dead = np.zeros(SLOTS, bool)  # all slots dead: full compute, no position moves
        eng._live_dev = None
        shares = {"decode_step": device_share(
                      torch, lambda: eng._dispatch_step(dead, record=False), 20),
                  "prefill_1024": device_share(
                      torch, lambda: eng._dispatch_prefill(np.zeros(1000, np.int32), 0,
                                                           record=False), 5)}
    finally:
        eng.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_gen = []
    for i, out in enumerate(outs):
        s0 = prompts[i].size
        assert out.dtype == np.int32 and np.array_equal(out[:s0], prompts[i])
        new = out[s0:]
        assert 1 <= new.size <= max_new[i] and int(new.min()) >= 0 and int(new.max()) < V
        if i == i_eos:
            assert eos not in new[:-1] and (new.size == max_new[i] or new[-1] == eos)
        else:
            assert new.size == max_new[i], (i, new.size, max_new[i])
        n_gen.append(int(new.size))
    requested = int(max_new.sum())
    eos_cut = int(max_new[i_eos]) - n_gen[i_eos]
    assert stats["tokens_out"] == sum(n_gen) == requested - eos_cut, (stats, n_gen)
    assert stats["decode_steps"] > 0 and stats["prefills"] == N_REQ, stats
    want_flash = L * (n_warm + stats["prefills"] + 1 + 1)
    assert launches["flash_attention"] == want_flash, (launches, want_flash)
    assert launches["probe"] == 1 and launches["cdist_tile"] == launches["kmeans_step"] == 0

    # the near-tie rule against a float32 copy of the model from the same init(0)
    del logits
    torch.cuda.empty_cache()
    model32 = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP))
    params32 = model32.init(0)
    fwd32 = model32.logits_fn()
    ref = fwd32(params32, toks[:1, :128])[0]
    got = model.logits_fn()(params, toks[:1, :128])[0]
    fwd_tol = bf16_logit_tol(ref.std(dim=-1, keepdim=True), ref.abs().amax(dim=-1, keepdim=True),
                             L)
    fwd_ratio = float(((got - ref).abs() / fwd_tol).max())
    assert fwd_ratio <= 1.0, f"bf16 logits beyond bf16_logit_tol of float32: {fwd_ratio}"
    ties = {}
    picks = sorted(range(N_REQ), key=lambda i: -n_gen[i])[:4]
    for i in picks:
        s0, seq = prompts[i].size, torch.from_numpy(outs[i].astype(np.int64)).to(dev)
        z = fwd32(params32, seq[None, :-1])[0, s0 - 1:]
        ties[f"request_{i}"] = near_tie_check(torch, z, seq[s0:], L)
    z = fwd32(params32, out_gen[:1, :-1].long())[0, 999:]
    ties["generate_row_0"] = near_tie_check(torch, z, out_gen[0, 1000:], L)
    del model32, params32, z, ref, got
    torch.cuda.empty_cache()

    ttft = stats["ttft_ms"]
    # every prefill emits one token, every step one per live slot
    occupancy = (stats["tokens_out"] - stats["prefills"]) / (stats["decode_steps"] * SLOTS)
    emit({"phase": "serving_path", "card": smi, "config": FLAGSHIP, "compute_dtype": "bfloat16",
          "launches": launches, "flash_launches_expected": want_flash,
          "warmup_prefills": n_warm, "init_s": init_s, "logits_forward_s": fwd_s,
          "generate_8x1000_plus_32_s": gen_s, "warmup_s": warm_s, "serve_wall_s": serve_s,
          "requests": N_REQ, "slots": SLOTS, "tokens_requested": requested,
          "eos_cut_tokens": eos_cut,
          "serving_tokens_per_s": stats["tokens_out"] / serve_s,
          "mean_occupancy": occupancy,
          "ttft_ms_p50_under_load": ttft["p50"], "ttft_ms_max_under_load": ttft["max"],
          "prefill_ms_per_bucket": prefill_ms, "profiled": shares,
          "peak_memory_gb": peak_gb, "stats": stats,
          "logits_forward_vs_f32_max_err_over_tol": fwd_ratio,
          "near_tie": {k: {"tokens_differing_from_f32_argmax": v[0], "max_gap_over_limit": v[1]}
                       for k, v in ties.items()},
          "near_tie_rule": "f32 logit of each chosen token >= f32 max - 2*bf16_logit_tol"})
    return launches


BWD_PATH_CASE = "train_8x16x1024x64_bf16_causal"
# the flash kernels' sources (each C entry point picks its kernel's
# instantiation by dtype alone)
FWD_SOURCE = "heat_tpu_torch/csrc/flash_fwd_sm90.cu"
DKV_SOURCE = "heat_tpu_torch/csrc/flash_bwd_dkv_sm90.cu"
DQ_SOURCE = "heat_tpu_torch/csrc/flash_bwd_dq_sm90.cu"
# the float32 flash forward's device time: its split pass and its kernel
F32_FWD_KINDS = {"split_pass": ("split_planes",), "kernel": ("flash_fwd",)}
# kernel kinds of a training step, by parts of their names (the split
# passes of the float32 forward and backward together)
TRAIN_KINDS = {"flash_attention_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_bwd_dq",),
               "flash_bwd_dkv": ("flash_bwd_dkv",), "flash_split_f32": ("split_planes",),
               "gemm": ("nvjet", "gemm", "xmma", "cutlass", "gemv"),
               "log_softmax": ("softmax",), "adam": ("adam",)}


def same_bits(torch, a, b):
    """Whether two tensors of one 16- or 32-bit float dtype hold the same
    bits (NaN included, where ``torch.equal`` is False)."""
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def flash_fwd_phase(torch, tk, dev, gen, smi, bw, bf16_tc):
    """Phase 4, the flash forward: the kernel against its plain version
    (``check_flash``) in bf16, float32 and float16, each case bitwise
    repeatable, then the times at the serving path's shapes; returns
    (checks, times). Every dtype runs on the tensor cores
    (csrc/flash_fwd_sm90.cu; float32 after its split pass). Each dtype at the
    serving path's shapes (prefill: one request of 1024 rows, 16 heads of
    64; the logits forward: 8 of them), at a length that is no multiple of
    any tile, at causal Sq > Sk, whose first 100 rows see no key, and at
    Sk = 4096, causal and not, which wraps the key ring many times; float32
    also at head dim 128 (its narrow block of 64 rows and 32-key tiles) and
    with one query against 200 keys; float16 also with q and k of σ 3 (wide
    scores: most probabilities fall below float16's smallest normal,
    6.1e-5)."""
    H, DH = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    fl_checks = {}
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    fl_cases = []
    for tag, dt in (("bf16", bf16), ("f32", fp32), ("f16", fp16)):
        fl_cases += [(f"prefill_1x16x1024x64_{tag}", 1, H, 1024, 1024, DH, dt, True, 1.0),
                     (f"logits_8x16x1024x64_{tag}", 8, H, 1024, 1024, DH, dt, True, 1.0),
                     (f"1x16x1000x64_{tag}", 1, H, 1000, 1000, DH, dt, True, 1.0),
                     (f"1x4x300x64_vs_200_{tag}", 1, 4, 300, 200, DH, dt, True, 1.0),
                     (f"1x4x300_vs_4096x64_{tag}_causal", 1, 4, 300, 4096, DH, dt, True, 1.0),
                     (f"1x4x300_vs_4096x64_{tag}_noncausal", 1, 4, 300, 4096, DH, dt, False,
                      1.0)]
    fl_cases += [("1x16x1024x128_f32", 1, H, 1024, 1024, 128, fp32, True, 1.0),
                 ("1x16x1_vs_200x64_f32", 1, H, 1, 200, DH, fp32, True, 1.0),
                 ("wide_scores_1x16x1024x64_f16", 1, H, 1024, 1024, DH, fp16, True, 3.0)]
    for name, b, h, sq, sk, dh, dt, causal, s_qk in fl_cases:
        q = (torch.randn(b, h, sq, dh, device=dev, generator=gen) * s_qk).to(dt)
        k = (torch.randn(b, h, sk, dh, device=dev, generator=gen) * s_qk).to(dt)
        v = torch.randn(b, h, sk, dh, device=dev, generator=gen).to(dt)
        step = {bf16: 2.0**-7, fp16: 2.0**-10}.get(dt, 0.0)
        got = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
        try:
            err, ratio = check_flash(torch, tk, q, k, v, causal=causal, out_step=step, got=got)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        again = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
        assert same_bits(torch, got[0], again[0]) and same_bits(torch, got[1], again[1]), (
            f"{name}: the flash forward is not bitwise repeatable")
        fl_checks[name] = {"max_abs_err": err, "max_err_over_limit": ratio, "out_step": step,
                           "causal": causal, "head_dim": dh, "sigma_qk": s_qk,
                           "bitwise_repeatable": True}
        if s_qk != 1.0:
            # the share of the first head's visible probabilities below
            # float16's smallest normal
            sc = (q[:, :1].float() @ k[:, :1].float().transpose(-1, -2)) / math.sqrt(dh)
            vis = torch.ones(sq, sk, dtype=torch.bool, device=dev)
            if causal:
                vis = vis.tril(sk - sq)
            p = torch.softmax(sc.masked_fill(~vis, float("-inf")), dim=-1)[..., vis]
            fl_checks[name]["share_p_below_f16_normal"] = float(
                (p < torch.finfo(fp16).tiny).float().mean())
            del sc, vis, p
        if causal and sq > sk:
            out, lse = got
            assert bool(torch.isnan(out[:, :, :sq - sk]).all())
            assert bool(torch.isneginf(lse[:, :, :sq - sk]).all())
            assert not bool(torch.isnan(out[:, :, sq - sk:]).any())
            fl_checks[name]["empty_rows"] = sq - sk
            del out, lse
        del q, k, v, got, again
        torch.cuda.empty_cache()
    fl_times = {}
    for name, b in (("prefill_1x16x1024x64_bf16", 1), ("logits_8x16x1024x64_bf16", 8)):
        q, k, v = (torch.randn(b, H, 1024, DH, device=dev, generator=gen).bfloat16()
                   for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        qh, kh, vh = q.half(), k.half(), v.half()
        fb = flash_bound(b, H, 1024, 1024, DH, True, bw, bf16_tc)
        fb16 = flash_bound(b, H, 1024, 1024, DH, True, bw, bf16_tc,
                           split_passes=F16_PASSES_SPLIT)
        fb32 = flash_bound_f32(b, H, 1024, 1024, DH, True, bw, bf16_tc)

        def sdpa(q_, k_, v_):
            return torch.nn.functional.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

        # the float32 call's device time by kind: its split pass and kernel
        w32 = device_share(torch, lambda: tk.flash_attention(qf, kf, vf, causal=True),
                           200 if b == 1 else 20, kinds=F32_FWD_KINDS)
        by32 = w32.get("device_ms_per_call_by_kind")
        fl_times[name] = {
            "kernel": time_ms(torch, lambda: tk.flash_attention(q, k, v, causal=True)),
            "plain": time_ms(torch, lambda: tk.flash_attention_plain(q, k, v, causal=True)),
            "sdpa": time_ms(torch, lambda: sdpa(q, k, v)),
            "bound": fb[0], "bound_by": fb[1],
            "f32": {
                "kernel": time_ms(torch, lambda: tk.flash_attention(qf, kf, vf, causal=True)),
                "plain": time_ms(torch, lambda: tk.flash_attention_plain(qf, kf, vf,
                                                                         causal=True)),
                "sdpa": time_ms(torch, lambda: sdpa(qf, kf, vf)),
                "bound": fb32[0], "bound_by": fb32[1], "passes_per_product": F32_PASSES_FWD,
                "device_ms_by_kind": by32, "split_pass_share": None if by32 is None else
                by32["split_pass"] / (by32["split_pass"] + by32["kernel"])},
            "f16": {
                "kernel": time_ms(torch, lambda: tk.flash_attention(qh, kh, vh, causal=True)),
                "plain": time_ms(torch, lambda: tk.flash_attention_plain(qh, kh, vh,
                                                                         causal=True)),
                "sdpa": time_ms(torch, lambda: sdpa(qh, kh, vh)),
                "bound": fb16[0], "bound_by": fb16[1],
                "passes_per_split_product": F16_PASSES_SPLIT}}
        if b == 1:
            # one prefill's work fills about one wave of the card, so the
            # CUDA-event time of back-to-back calls may be the wrapper's host
            # pace: the wall time per call of back-to-back calls apart from
            # the call's own device time (torch.profiler; float32: its split
            # pass and kernel); where the card idles over a tenth of the
            # wall, the host sets the pace
            for t, args in ((fl_times[name], (q, k, v)), (fl_times[name]["f16"], (qh, kh, vh)),
                            (fl_times[name]["f32"], None)):
                if args is None:
                    w = w32
                else:
                    w = device_share(torch, lambda: tk.flash_attention(*args, causal=True), 200,
                                     kinds=F32_FWD_KINDS)
                by = w.get("device_ms_per_call_by_kind")
                dev_ms = None if by is None else by["split_pass"] + by["kernel"]
                host_bound = dev_ms is not None and dev_ms < 0.9 * w["host_ms_per_call"]
                t.update(device_ms=dev_ms, host_ms=w["host_ms_per_call"],
                         ms_is=("host-bound: the wrapper's host time per call; the call's "
                                "own is device_ms" if host_bound else "the kernel's time"))
        del q, k, v, qf, kf, vf, qh, kh, vh
        torch.cuda.empty_cache()
    emit({"phase": "kernels_flash", "card": smi, "checks": fl_checks, "timings_ms": fl_times,
          "routes": {"bfloat16, float16, float32": FWD_SOURCE + " (wgmma, TMA; float32 as "
                                                                 "three bf16 planes)"}})
    return fl_checks, fl_times


def flash_bwd_phase(torch, tk, dev, gen, smi, bw, bf16_tc):
    """Phase 4, the flash backward: both kernels against their plain
    versions (``check_flash_bwd``), in bf16, float16 and float32: at the
    training path's shape (causal, no lse cotangent), at lengths that are no
    multiple of any tile with Sq < Sk, causal and a nonzero lse cotangent,
    without the causal mask, at Sk = 4096 with 300 queries, causal and not,
    (float32) at head dim 128, and (float16) with gradients of σ 2^-14, as
    float16 training without loss scaling feeds in, and with v and dO of σ
    128, whose score cotangents dS pass float16's largest value while dK and
    dV stay inside it; each bitwise repeatable; then the times at the path's
    shape."""
    H, DH = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    small, large = (1.0, 1.0, 2.0**-14), (1.0, 128.0, 128.0)  # σ of q and k, of v, of dO and dlse
    cases = ((BWD_PATH_CASE, 8, H, 1024, 1024, DH, bf16, True, False),
             ("train_8x16x1024x64_f32_causal", 8, H, 1024, 1024, DH, fp32, True, False),
             ("train_8x16x1024x64_f16_causal", 8, H, 1024, 1024, DH, fp16, True, False),
             ("1x16x1000_vs_1090x64_f32_causal_dlse", 1, H, 1000, 1090, DH, fp32, True, True),
             ("1x16x1000_vs_1090x64_bf16_causal_dlse", 1, H, 1000, 1090, DH, bf16, True, True),
             ("1x16x1000_vs_1090x64_f16_causal_dlse", 1, H, 1000, 1090, DH, fp16, True, True),
             ("2x16x1024x64_bf16_noncausal_dlse", 2, H, 1024, 1024, DH, bf16, False, True),
             ("2x16x1024x64_f32_noncausal_dlse", 2, H, 1024, 1024, DH, fp32, False, True),
             ("1x4x300_vs_4096x64_bf16_causal_dlse", 1, 4, 300, 4096, DH, bf16, True, True),
             ("1x4x300_vs_4096x64_bf16_noncausal_dlse", 1, 4, 300, 4096, DH, bf16, False, True),
             ("1x4x300_vs_4096x64_f16_causal_dlse", 1, 4, 300, 4096, DH, fp16, True, True),
             ("1x4x300_vs_4096x64_f16_noncausal_dlse", 1, 4, 300, 4096, DH, fp16, False, True),
             ("1x4x300_vs_4096x64_f32_causal_dlse", 1, 4, 300, 4096, DH, fp32, True, True),
             ("1x4x300_vs_4096x64_f32_noncausal_dlse", 1, 4, 300, 4096, DH, fp32, False, True),
             ("1x16x1000_vs_1090x128_f32_causal_dlse", 1, H, 1000, 1090, 128, fp32, True, True),
             ("1x16x1024x64_f16_causal_dlse_small_grad", 1, H, 1024, 1024, DH, fp16, True, small),
             ("1x16x1024x64_f16_causal_dlse_large_ds", 1, H, 1024, 1024, DH, fp16, True, large))
    checks = {}
    for name, b, h, sq, sk, dh, dt, causal, with_dlse in cases:
        s_qk, s_v, s_do = with_dlse if isinstance(with_dlse, tuple) else (1.0, 1.0, 1.0)
        q = (torch.randn(b, h, sq, dh, device=dev, generator=gen) * s_qk).to(dt)
        k = (torch.randn(b, h, sk, dh, device=dev, generator=gen) * s_qk).to(dt)
        v = (torch.randn(b, h, sk, dh, device=dev, generator=gen) * s_v).to(dt)
        out, lse = tk.flash_attention(q, k, v, causal=causal, return_lse=True)
        dout = (torch.randn(q.shape, device=dev, generator=gen) * s_do).to(dt)
        dlse = (torch.randn(lse.shape, device=dev, generator=gen) * s_do if with_dlse
                else None)
        dmb = tk._dmb(out, dout, dlse)
        # float16: the largest score cotangent |dS| of the plain backward
        ds_max = None if dt != fp16 else float(tk._bwd_dense(
            q, k, v, dout, lse, dmb, 1.0 / math.sqrt(dh), causal)[4].abs().nan_to_num(0.0).max())
        if with_dlse is large:
            assert ds_max > torch.finfo(fp16).max, f"{name}: max |dS| {ds_max}"
        step = {bf16: 2.0**-7, fp16: 2.0**-10}.get(dt, 0.0)
        before = dict(tk.launches)
        try:
            res = check_flash_bwd(torch, tk, q, k, v, dout, lse, dmb, causal, out_step=step)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        assert tk.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
        assert tk.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        dk1, dv1 = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
        dk2, dv2 = tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=causal)
        repeatable = (torch.equal(dk1, dk2) and torch.equal(dv1, dv2) and torch.equal(
            tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal),
            tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=causal)))
        assert repeatable, f"{name}: the backward kernels are not bitwise repeatable"
        checks[name] = {"dq_max_abs_err": res["dq"][0],
                        "dk_dv_max_abs_err": max(res["dk"][0], res["dv"][0]),
                        "max_err_over_limit": {g: r for g, (_, r) in res.items()},
                        "out_step": step, "dlse": bool(with_dlse),
                        "sigma_qk_v_dout": [s_qk, s_v, s_do], "max_abs_ds": ds_max,
                        "bitwise_repeatable": True}
        del q, k, v, out, lse, dout, dlse, dmb, dk1, dv1, dk2, dv2
        torch.cuda.empty_cache()

    b, s = 8, 1024
    q, k, v, dout = (torch.randn(b, H, s, DH, device=dev, generator=gen).bfloat16()
                     for _ in range(4))
    out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    dmb = tk._dmb(out, dout, None)
    (b_dkv, by_dkv), (b_dq, by_dq) = flash_bwd_bounds(b, H, s, s, DH, True, bw, bf16_tc)
    # float32 copies for the float32 kernels' times (their split pass
    # included), bounded by the card's tensor cores at float32 accuracy
    # (flash_bwd_bounds_f32); the device time of one call by kernel says
    # what the split pass takes
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    out32, lse32 = tk.flash_attention(q32, k32, v32, causal=True, return_lse=True)
    dmb32 = tk._dmb(out32, do32, None)
    b32_dkv, b32_dq = flash_bwd_bounds_f32(b, H, s, s, DH, True, bw, bf16_tc)
    # float16 copies for the float16 kernels' times, bounded by
    # flash_bwd_bounds' rule at F16_PASSES_SPLIT passes a split product (the
    # float16 tensor-core rate is bf16's)
    q16, k16, v16, do16 = (t.half() for t in (q, k, v, dout))
    out16, lse16 = tk.flash_attention(q16, k16, v16, causal=True, return_lse=True)
    dmb16 = tk._dmb(out16, do16, None)
    b16_dkv, b16_dq = flash_bwd_bounds(b, H, s, s, DH, True, bw, bf16_tc,
                                       split_passes=F16_PASSES_SPLIT)

    def f16_times(fn, plain, b16):
        return {"kernel": time_ms(torch, fn), "plain": time_ms(torch, plain), "bound": b16[0],
                "bound_by": b16[1], "passes_per_split_product": F16_PASSES_SPLIT}

    def f32_times(fn, plain, b32, kernel_part):
        split = device_share(torch, fn, 20, kinds={"split_pass": ("split_planes",),
                                                    "kernel": (kernel_part,)})
        return {"kernel": time_ms(torch, fn), "plain": time_ms(torch, plain),
                "bound": b32[0], "bound_by": b32[1], "passes_per_product": F32_PASSES_BWD,
                "device_ms_by_kind": split.get("device_ms_per_call_by_kind")}

    times = {
        "dkv": {"kernel": time_ms(torch, lambda: tk.flash_bwd_dkv(q, k, v, dout, lse, dmb,
                                                                  causal=True)),
                "plain": time_ms(torch, lambda: tk.flash_bwd_dkv_plain(q, k, v, dout, lse, dmb,
                                                                       causal=True)),
                "bound": b_dkv, "bound_by": by_dkv,
                "f32": f32_times(
                    lambda: tk.flash_bwd_dkv(q32, k32, v32, do32, lse32, dmb32, causal=True),
                    lambda: tk.flash_bwd_dkv_plain(q32, k32, v32, do32, lse32, dmb32,
                                                   causal=True),
                    b32_dkv, "flash_bwd_dkv_sm90"),
                "f16": f16_times(
                    lambda: tk.flash_bwd_dkv(q16, k16, v16, do16, lse16, dmb16, causal=True),
                    lambda: tk.flash_bwd_dkv_plain(q16, k16, v16, do16, lse16, dmb16,
                                                   causal=True), b16_dkv)},
        "dq": {"kernel": time_ms(torch, lambda: tk.flash_bwd_dq(q, k, v, dout, lse, dmb,
                                                                causal=True)),
               "plain": time_ms(torch, lambda: tk.flash_bwd_dq_plain(q, k, v, dout, lse, dmb,
                                                                     causal=True)),
               "bound": b_dq, "bound_by": by_dq,
               "f32": f32_times(
                   lambda: tk.flash_bwd_dq(q32, k32, v32, do32, lse32, dmb32, causal=True),
                   lambda: tk.flash_bwd_dq_plain(q32, k32, v32, do32, lse32, dmb32,
                                                 causal=True),
                   b32_dq, "flash_bwd_dq_sm90"),
               "f16": f16_times(
                   lambda: tk.flash_bwd_dq(q16, k16, v16, do16, lse16, dmb16, causal=True),
                   lambda: tk.flash_bwd_dq_plain(q16, k16, v16, do16, lse16, dmb16,
                                                 causal=True), b16_dq)}}
    # the float32 yardstick: PyTorch's memory-efficient attention backward
    # (aten's flash backward takes no float32), fed by its own forward on
    # the float32 copies; one call computes dq, dk and dv
    scale = 1.0 / math.sqrt(DH)
    fwd32 = torch.ops.aten._scaled_dot_product_efficient_attention(
        q32, k32, v32, None, True, 0.0, True, scale=scale)
    o_e, lse_e, seed_e, offset_e = fwd32[:4]
    times["aten_efficient_backward_f32_dq_dk_dv"] = time_ms(
        torch, lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            do32, q32, k32, v32, None, o_e, lse_e, seed_e, offset_e, 0.0,
            [True, True, True, False], True, scale=scale))
    del q32, k32, v32, do32, out32, lse32, dmb32, fwd32, o_e, lse_e
    # the yardstick: PyTorch's flash-attention backward (behind SDPA), fed
    # by its own forward's outputs; one call computes dq, dk and dv
    for key, (q_, k_, v_, do_) in (("aten_flash_backward_dq_dk_dv", (q, k, v, dout)),
                                   ("aten_flash_backward_f16_dq_dk_dv", (q16, k16, v16, do16))):
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(q_, k_, v_, 0.0, True, False,
                                                                 scale=scale)
        o_a, lse_a, cq, ck, mq, mk, seed, offset = fwd[:8]
        times[key] = time_ms(
            torch, lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do_, q_, k_, v_, o_a, lse_a, cq, ck, mq, mk, 0.0, True, seed, offset,
                scale=scale))
        del fwd, o_a, lse_a
    del q, k, v, dout, out, lse, dmb, q16, k16, v16, do16, out16, lse16, dmb16
    torch.cuda.empty_cache()
    res = {"phase": "kernels_flash_bwd", "card": smi, "checks": checks, "timings_ms": times,
           "routes": {"dkv bfloat16, float16, float32":
                          DKV_SOURCE + " (wgmma, TMA; float16 with dS scaled by a running "
                                       "exponent per key row; float32 as three bf16 planes)",
                      "dq bfloat16, float16, float32":
                          DQ_SOURCE + " (wgmma, TMA; float16 with dS scaled by a running "
                                      "exponent per query row; float32 as three bf16 planes)"},
           "rule": "|dg| <= 1e-4 * (sum of |terms| of g) + (1e-5 + out_step) * |g|, "
                   "NaN at the same places (check_flash_bwd)"}
    emit(res)
    return res


def training_path(torch, ht, tk, smi, bf16_tc):
    """The training main path at the flagship width, through the entry
    points a user calls; returns the launch counts of its timed steps."""
    from heat_tpu_torch.core.tree import tree_flatten
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig
    from heat_tpu_torch.utils.convert import transformer_tree_to_numpy

    L, V, D = FLAGSHIP["n_layers"], FLAGSHIP["vocab"], FLAGSHIP["d_model"]
    B, S = TRAIN_BATCH
    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, compute_dtype=torch.bfloat16))
    # the bench's fixed batch (bench.py:231-232)
    toks = model.shard_batch(np.random.default_rng(0).integers(0, V, (B, S)).astype(np.int32))

    # the end-to-end check: one loss_and_grad_fn of the bf16 model against a
    # float32 copy, both from the same init(0) masters
    model32 = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP))
    params = model.init(0, dtype=torch.float32)
    loss16, g16 = model.loss_and_grad_fn()(params, toks)
    lg32 = model32.loss_and_grad_fn()
    loss32, g32 = lg32(params, toks)
    logits32 = model32.logits_fn()(params, toks)
    loss_tol = bf16_loss_tol(torch, logits32, L)
    del logits32
    loss_ratio = abs(float(loss16) - float(loss32)) / loss_tol
    assert loss_ratio <= 1.0, f"bf16 loss beyond bf16_loss_tol of float32: {loss_ratio}"
    grad_tol = bf16_grad_tol(L)
    h16, h32 = transformer_tree_to_numpy(g16), transformer_tree_to_numpy(g32)
    leaves = [("embed", h16["embed"], h32["embed"]), ("final_ln", h16["final_ln"], h32["final_ln"]),
              ("unembed", h16["unembed"], h32["unembed"])]
    leaves += [(f"stages/{n}", h16["stages"][n], h32["stages"][n]) for n in h16["stages"]]
    grad_ratios = {}
    for name, a, b in leaves:
        assert np.isfinite(a).all(), f"bf16 gradient {name} is not finite"
        grad_ratios[name] = float(np.linalg.norm(a - b) / np.linalg.norm(b)) / grad_tol
    assert max(grad_ratios.values()) <= 1.0, f"bf16 gradients beyond bf16_grad_tol: {grad_ratios}"
    del g16, g32, h16, h32, leaves
    # the float32 reference's device time by kind: the default compute dtype
    # runs the float32 flash forward and both backward kernels 8 + 8 + 8
    # times a call, each on the tensor cores after its split pass
    before = dict(tk.launches)
    lg32(params, toks)
    ref32_launches = {n: tk.launches[n] - before[n] for n in tk.launches}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        assert ref32_launches[name] == L, (name, ref32_launches)
    ref32 = device_share(torch, lambda: lg32(params, toks), 2, kinds=TRAIN_KINDS)
    del lg32, model32
    torch.cuda.empty_cache()

    # the train step: float32 masters through the converter, Adam(1e-3)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    tx = ht.optim.Adam(1e-3)
    opt_state = tx.init(params)
    step = model.make_train_step(tx)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):  # warm-up
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    tk.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    end.record()
    end.synchronize()
    launches = dict(tk.launches)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    per_step = {name: n / TRAIN_STEPS for name, n in launches.items()}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        assert launches[name] == L * TRAIN_STEPS, (name, launches)
    assert launches["cdist_tile"] == launches["kmeans_step"] == launches["probe"] == 0
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), losses
    # near-uniform predictions at init (ln V plus half the logits' variance,
    # ~0.2 here), then the fixed batch is being learnt
    assert abs(losses[0] - math.log(V)) < 1.0, losses[0]
    assert losses[-1] < losses[0] - 0.1, losses

    def profiled_step():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, toks)
        torch.cuda.synchronize()

    share = device_share(torch, profiled_step, 3, kinds=TRAIN_KINDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = B * S
    flops = (6.0 * n_params + 12.0 * L * S * D) * tokens  # bench.py:245
    emit({"phase": "training_path", "card": smi, "config": FLAGSHIP, "compute_dtype": "bfloat16",
          "master_dtype": "float32", "optimizer": "Adam(1e-3)", "batch": [B, S],
          "n_params": n_params, "launches": launches, "launches_per_step": per_step,
          "step_ms": step_ms, "training_tokens_per_s": tokens / (step_ms / 1e3),
          "bench_flops_per_step": flops,
          "approx_mfu_vs_bf16_peak": flops / (step_ms / 1e3) / bf16_tc,
          "losses_per_step": losses, "profiled": share, "peak_memory_gb": peak_gb,
          "bf16_vs_f32": {"loss_bf16": float(loss16), "loss_f32": float(loss32),
                          "loss_err_over_tol": loss_ratio, "loss_tol": loss_tol,
                          "grad_relnorm_over_tol": grad_ratios, "grad_tol": grad_tol},
          "f32_loss_and_grad_launches": ref32_launches, "f32_loss_and_grad_profiled": ref32})
    return launches


# phase 8: the flagship on a grid with every model feature of the slice --
# gpt_parallel.py's --moe-experts 4 (examples/nn/gpt_parallel.py), the
# default capacity factor, two microbatches and remat -- and the schedules
# of a 4-rank sequence grid at the flagship's attention shape
GRID_MOE = dict(moe_experts=4, capacity_factor=1.25, n_micro=2, remat=True)
GRID_WARMUP, GRID_STEPS = 2, 5
RING_RANKS = 4
# examples/nn/mlp_train.py's synthetic data, batch and network widths
MLP_DATA, MLP_BATCH, MLP_WIDTHS = (4096, 64, 10), 512, (128, 64)


def _route_probe(par, forward_calls):
    """A stand-in for ``nn.parallel._route`` that records the bf16 model's
    expert choices of one forward (``forward_calls`` routings: layers x
    microbatches, in the forward's order; the remat recomputations route
    the same inputs again and are not recorded) and their kept shares, then
    replays those choices in the float32 copy, counting the tokens whose
    own float32 argmax differs (the routing flips). The replay builds the
    dispatch and combine of the recorded choices as ``_route`` does (the
    slot from an integer running count, the gate from this copy's softmax).
    Both precisions then route alike, and the rounding rules of phase 7
    apply."""
    import torch

    state = {"mode": "record", "choices": [], "kept": [], "i": 0, "flips": 0, "tokens": 0}
    real = par._route

    def replay(x, router_w, E, C, chosen):
        probs = torch.softmax(x @ router_w, dim=-1)
        gate = probs.gather(-1, chosen[:, None])[:, 0]
        rows = torch.nn.functional.one_hot(chosen, E).t().to(torch.int32)
        slot = rows.cumsum(dim=1).gather(0, chosen[None])[0] - 1
        kept = slot < C
        dispatch = torch.zeros((x.shape[0], E * C), dtype=x.dtype, device=x.device)
        dispatch.scatter_(1, (chosen * C + slot.clamp(max=C - 1))[:, None],
                          kept.to(x.dtype)[:, None])
        dispatch = dispatch.view(x.shape[0], E, C)
        return dispatch, dispatch * gate[:, None, None], kept

    def route(x, router_w, E, C):
        own = torch.argmax(torch.softmax(x @ router_w, dim=-1), dim=-1)
        if state["mode"] == "replay":
            chosen = state["choices"][state["i"] % forward_calls]
            if state["i"] < forward_calls:
                state["flips"] += int((own != chosen).sum())
                state["tokens"] += own.numel()
            state["i"] += 1
            return replay(x, router_w, E, C, chosen)
        out = real(x, router_w, E, C)
        if state["mode"] == "record" and len(state["choices"]) < forward_calls:
            state["choices"].append(own)
            state["kept"].append(float(out[2].float().mean()))
        return out

    return state, route


def _leaf_relnorms(torch, tree_flatten, g16, g32, params):
    """Per leaf name (the layers' leaves together, as phase 7 stacks them),
    ||g16 - g32|| / ||g32||, on the card."""
    sums = {}

    def names(node, prefix):
        if isinstance(node, dict):
            for key, val in node.items():
                yield from names(val, key if prefix in ("", "layers") else prefix)
        elif isinstance(node, (list, tuple)):
            for val in node:
                yield from names(val, prefix)
        else:
            yield prefix

    for name, a, b in zip(names(params, ""), tree_flatten(g16)[0], tree_flatten(g32)[0]):
        assert bool(torch.isfinite(a).all()), f"bf16 gradient {name} is not finite"
        d = float(((a.float() - b.float()) ** 2).sum())
        n = float((b.float() ** 2).sum())
        old = sums.get(name, (0.0, 0.0))
        sums[name] = (old[0] + d, old[1] + n)
    return {name: math.sqrt(d / n) for name, (d, n) in sums.items()}


def _schedule(torch, block, fold, q, k, v, scale, kind):
    """Every rank's per-step block calls of a 4-rank ring (``kind`` "ring":
    blocks of S/4 rows, rank r's queries against the block of rank (r - t)
    mod 4 at step t, causal at step 0, a block from a later rank folded with
    lse = -inf) or zigzag ring (chunks of S/8 rows, rank d holding chunks d
    and 7 - d, heat_tpu's ``_zigzag_core`` order), folded per rank with
    ``fold`` and put back in sequence order. Returns the float32 output,
    the lse, A = the sum over pieces of fold weight x |piece| (the size the
    pieces' roundings move the output by) and the number of block calls."""
    n = RING_RANKS
    B, H, S, D = q.shape
    dev = q.device
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    size = torch.empty_like(out)
    calls = 0
    pieces_of = {}

    def rows(i, w):
        return slice(i * w, (i + 1) * w)

    def run(qs, ks, vs, causal):
        nonlocal calls
        calls += 1
        return block(qs, ks, vs, scale, causal)

    def fold_all(key, pieces):
        acc = torch.zeros(pieces[0][0].shape, dtype=torch.float32, device=dev)
        l = torch.full(pieces[0][1].shape, float("-inf"), dtype=torch.float32, device=dev)
        for o, li in pieces:
            acc, l = fold(acc, l, o, li)
        pieces_of[key] = (pieces, l)
        return acc, l

    if kind == "ring":
        w = S // n
        outs = []
        for r in range(n):
            pieces = []
            for t in range(n):
                src = (r - t) % n
                o, l = run(q[:, :, rows(r, w)], k[:, :, rows(src, w)], v[:, :, rows(src, w)],
                           t == 0)
                if t > 0 and not src < r:
                    l = torch.full_like(l, float("-inf"))
                pieces.append((o, l))
            outs.append((rows(r, w), fold_all(r, pieces)))
    else:
        c = S // (2 * n)
        outs = []
        for d in range(n):
            e, lt = d, 2 * n - 1 - d
            qe, ql = q[:, :, rows(e, c)], q[:, :, rows(lt, c)]
            early, late = [], []
            for t in range(n):
                j = (d - t) % n
                ke, kl = k[:, :, rows(j, c)], k[:, :, rows(2 * n - 1 - j, c)]
                ve, vl = v[:, :, rows(j, c)], v[:, :, rows(2 * n - 1 - j, c)]
                late.append(run(ql, ke, ve, False))
                if t == 0:
                    early.append(run(qe, ke, ve, True))
                    late.append(run(ql, kl, vl, True))
                elif j < d:
                    early.append(run(qe, ke, ve, False))
                else:
                    late.append(run(ql, kl, vl, False))
            outs.append((rows(e, c), fold_all((d, "e"), early)))
            outs.append((rows(lt, c), fold_all((d, "l"), late)))
    for sl, (o, l) in outs:
        out[:, :, sl] = o
        lse[:, :, sl] = l
    for sl, key in zip([sl for sl, _ in outs], pieces_of):
        pieces, l = pieces_of[key]
        a = torch.zeros_like(pieces[0][0], dtype=torch.float32)
        for o, li in pieces:
            wgt = torch.where(torch.isfinite(li), torch.exp(li - l), torch.zeros_like(li))
            a = a + wgt[..., None] * o.detach().float().abs()
        size[:, :, sl] = a
    return out, lse, size, calls


def ring_schedules(torch, tk, dev, gen, smi):
    """Phase 8b: the ring and zigzag schedules' kernel calls at the
    flagship's attention shape, through the port's ``_block_attn`` and
    ``_fold``, held against one causal flash call over the whole sequence
    and against the same schedule on the plain version, outputs and the
    q/k/v gradients of sum(out · dout)."""
    from heat_tpu_torch.nn.attention import _block_attn, _fold

    B, S = TRAIN_BATCH
    H, Dh = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    scale = 1.0 / math.sqrt(Dh)
    q, k, v, dout = (torch.randn(B, H, S, Dh, device=dev, generator=gen).to(torch.bfloat16)
                     for _ in range(4))

    def plain_block(qs, ks, vs, sc, causal):
        o, l = tk.flash_attention_plain(qs.contiguous(), ks.contiguous(), vs.contiguous(), sc,
                                        causal, return_lse=True)
        return o.float(), l

    def grads_of(out):
        return torch.autograd.grad((out * dout.float()).sum(), (qg, kg, vg))

    # the whole sequence in one causal flash call: the reference's output,
    # lse and backward inputs
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    tk.reset_launches()
    whole_out, whole_lse = tk.flash_attention(qg, kg, vg, causal=True, return_lse=True)
    whole_grads = grads_of(whole_out.float())
    whole_out = whole_out.detach()
    dmb = tk._dmb(whole_out, dout, None)
    vmax = float(v.float().abs().max())
    res = {}
    for kind, want_calls in (("ring", RING_RANKS * RING_RANKS),
                             ("zigzag", RING_RANKS * (3 + 2 * (RING_RANKS - 1)))):
        got = {}
        for variant, block in (("kernel", _block_attn), ("plain", plain_block)):
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            tk.reset_launches()
            out, lse, size, calls = _schedule(torch, block, _fold, qg, kg, vg, scale, kind)
            grads = grads_of(out)
            torch.cuda.synchronize()
            launches = dict(tk.launches)
            assert calls == want_calls, (kind, calls)
            want_launches = calls if variant == "kernel" else 0
            for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
                assert launches[name] == want_launches, (kind, variant, launches)
            got[variant] = (out.detach(), lse.detach(), size, grads, launches)
        out, lse, size, grads, launches = got["kernel"]
        checks = {}
        for ref_name, (r_out, r_lse, r_grads) in (
                ("whole_causal_kernel", (whole_out.float(), whole_lse.detach(), whole_grads)),
                ("schedule_plain", got["plain"][:2] + (got["plain"][3],))):
            # each piece rounds to bf16 once (at most U_BF16 of its size, so
            # U_BF16·A over the fold), as does the whole call's output (at most
            # U_BF16·|out| <= U_BF16·A); the kernel's and the plain schedule's
            # pieces each round once from float32 values within 1e-5 of
            # each other: at most 2·U_BF16·A + 1e-5·(max|v| + A) apart either way
            assert bool(torch.isfinite(out).all()), f"{kind}: output not finite"
            err = (out - r_out).abs()
            lim = 1e-5 * vmax + (1e-5 + 2 * U_BF16) * size
            bad = int((err > lim).sum())
            assert bad == 0, f"{kind} vs {ref_name}: {bad} output elements beyond their limit"
            lse_err = (lse - r_lse).abs()
            lse_lim = 1e-5 * (1 + r_lse.abs())
            assert int((lse_err > lse_lim).sum()) == 0, f"{kind} vs {ref_name}: lse"
            g = check_flash_bwd(torch, tk, q, k, v, dout, whole_lse.detach(), dmb, True,
                                out_step=U_BF16, got=grads, want=r_grads, term_step=2.0**-6)
            checks[ref_name] = {"out_max_abs_err": float(err.max()),
                                "out_err_over_limit": float((err / lim).max()),
                                "lse_max_abs_err": float(lse_err.max()),
                                "grad_max_abs_err_over_limit": {n: v_ for n, v_ in g.items()}}
        res[kind] = {"block_calls": calls, "launches": launches, "checks": checks}
    return res


def data_parallel_mlp(torch, ht, dev):
    """Phase 8c: ``DataParallel`` on examples/nn/mlp_train.py's network and
    data, three steps of each optimizer constructor on its first batch."""
    n, d, k = MLP_DATA
    rng = np.random.default_rng(0)
    w = rng.normal(size=(d, k))
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ w, axis=1)
    bx = torch.as_tensor(X[:MLP_BATCH], device=dev)
    by = torch.as_tensor(y[:MLP_BATCH], device=dev)
    res = {}
    for name, tx in (("SGD(0.1)", ht.optim.SGD(0.1)), ("Adam", ht.optim.Adam()),
                     ("AdamW", ht.optim.AdamW()), ("Adagrad", ht.optim.Adagrad()),
                     ("Adadelta", ht.optim.Adadelta()), ("RMSprop", ht.optim.RMSprop())):
        torch.manual_seed(0)
        h1, h2 = MLP_WIDTHS
        net = torch.nn.Sequential(torch.nn.Linear(d, h1), torch.nn.ReLU(), torch.nn.Linear(h1, h2),
                                  torch.nn.ReLU(), torch.nn.Linear(h2, k))
        dp = ht.nn.DataParallel(net, optimizer=ht.optim.DataParallelOptimizer(tx))
        dp.init(bx)
        losses = [dp.step(bx, by) for _ in range(3)]
        assert all(math.isfinite(x) for x in losses), (name, losses)
        assert losses[-1] < losses[0], (name, losses)
        assert next(net.parameters()).device.type == "cuda"
        res[name] = losses
    return res


def grid_path(torch, ht, tk, dev, gen, smi, bf16_tc):
    """Phase 8: the flagship with experts, microbatches and remat through
    the entry points a user calls (grid (1, 1, 1, 1): the card's world is
    one, and NCCL refuses two ranks on one card), then the multi-rank
    schedules' kernel calls and ``DataParallel`` with every optimizer.
    Returns the launch counts of the timed steps."""
    from heat_tpu_torch.core.tree import tree_flatten
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig
    from heat_tpu_torch.nn import parallel as par

    L, V, D = FLAGSHIP["n_layers"], FLAGSHIP["vocab"], FLAGSHIP["d_model"]
    B, S = TRAIN_BATCH
    n_micro = GRID_MOE["n_micro"]
    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, **GRID_MOE,
                                                    compute_dtype=torch.bfloat16))
    toks = model.shard_batch(np.random.default_rng(0).integers(0, V, (B, S)).astype(np.int32))
    params = model.init(0, dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])

    # (a) the bf16 loss_and_grad_fn against a float32 copy on the bf16
    # model's routing
    probe, route = _route_probe(par, L * n_micro)
    real_route = par._route
    par._route = route
    try:
        loss16, g16 = model.loss_and_grad_fn()(params, toks)
        probe["mode"] = "replay"
        model32 = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP,
                                                          **dict(GRID_MOE, remat=False)))
        loss32, g32 = model32.loss_and_grad_fn()(params, toks)
        flips, routed = probe["flips"], probe["tokens"]
        probe["i"] = forward_calls = L * n_micro
        logits32 = model32.logits_fn()(params, toks)
    finally:
        par._route = real_route
    assert probe["i"] == 2 * forward_calls
    loss_tol = bf16_loss_tol(torch, logits32, L)
    del logits32
    loss_ratio = abs(float(loss16) - float(loss32)) / loss_tol
    assert loss_ratio <= 1.0, f"bf16 loss beyond bf16_loss_tol of float32: {loss_ratio}"
    grad_tol = bf16_grad_tol(L)
    grad_ratios = {name: r / grad_tol
                   for name, r in _leaf_relnorms(torch, tree_flatten, g16, g32, params).items()}
    assert max(grad_ratios.values()) <= 1.0, f"bf16 gradients beyond bf16_grad_tol: {grad_ratios}"
    drop_share = 1.0 - sum(probe["kept"]) / len(probe["kept"])
    del g16, g32, model32
    torch.cuda.empty_cache()

    # the train step: float32 masters, AdamW(1e-3)
    tx = ht.optim.AdamW(1e-3)
    opt_state = tx.init(params)
    step = model.make_train_step(tx)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(GRID_WARMUP):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    tk.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRID_STEPS):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    end.record()
    end.synchronize()
    launches = dict(tk.launches)
    step_ms = start.elapsed_time(end) / GRID_STEPS
    peak_remat = torch.cuda.max_memory_allocated() / 1e9
    # remat: each layer's forward runs twice a step (the pass and its
    # recomputation in the backward), its backward once; per microbatch
    want = {"flash_attention": 2 * L * n_micro, "flash_bwd_dkv": L * n_micro,
            "flash_bwd_dq": L * n_micro}
    for name, per_step in want.items():
        assert launches[name] == per_step * GRID_STEPS, (name, launches)
    assert launches["cdist_tile"] == launches["kmeans_step"] == launches["probe"] == 0
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses

    def profiled_step():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, toks)
        torch.cuda.synchronize()

    share = device_share(torch, profiled_step, 2, kinds=TRAIN_KINDS)
    # the same step without remat: its peak
    model_nr = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, **dict(GRID_MOE, remat=False),
                                                       compute_dtype=torch.bfloat16))
    step_nr = model_nr.make_train_step(tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    params, opt_state, loss_nr = step_nr(params, opt_state, toks)
    end.record()
    end.synchronize()
    step_nr_ms = start.elapsed_time(end)
    peak_plain = torch.cuda.max_memory_allocated() / 1e9
    assert peak_remat < peak_plain, (peak_remat, peak_plain)
    assert math.isfinite(float(loss_nr))
    del params, opt_state, step, step_nr, model, model_nr
    torch.cuda.empty_cache()

    # (b) the multi-rank schedules' kernel calls; (c) DataParallel
    rings = ring_schedules(torch, tk, dev, gen, smi)
    torch.cuda.empty_cache()
    mlp = data_parallel_mlp(torch, ht, dev)
    tokens = B * S
    emit({"phase": "grid_path", "card": smi, "config": dict(FLAGSHIP, **GRID_MOE),
          "grid": [1, 1, 1, 1], "compute_dtype": "bfloat16", "master_dtype": "float32",
          "optimizer": "AdamW(1e-3)", "batch": [B, S], "n_params": n_params,
          "launches": launches, "launches_per_step": {n: c / GRID_STEPS
                                                      for n, c in launches.items()},
          "launches_per_step_expected": want, "step_ms": step_ms,
          "training_tokens_per_s": tokens / (step_ms / 1e3), "losses_per_step": losses,
          "moe_drop_share": drop_share, "peak_memory_gb_remat": peak_remat,
          "peak_memory_gb_no_remat": peak_plain, "step_ms_no_remat_one_step": step_nr_ms,
          "profiled": share,
          "bf16_vs_f32": {"loss_bf16": float(loss16), "loss_f32": float(loss32),
                          "loss_err_over_tol": loss_ratio, "loss_tol": loss_tol,
                          "grad_relnorm_over_tol": grad_ratios, "grad_tol": grad_tol,
                          "routing": "float32 copy on the bf16 model's expert choices",
                          "routing_flips": flips, "tokens_routed": routed},
          "ring_schedules": rings, "data_parallel_mlp_losses": mlp})
    return launches


# phase 9 sizes: the flagship (FLAGSHIP, bf16 compute, float32 masters) on the
# training bench's (8, 1024) batch (bench.py:204-250) for 4 steps with a crash
# after step 3's save; logits requests of one 1024-token row at buckets 1-8;
# an open loop of 10 s with two tenants at 0.5 and 0.3 of the estimated
# capacity; the estimators of phases 5 (KMeans 2^23 x 64, k = 8) and 5g
# (KNeighborsClassifier(5), 40,000 x 18) with requests of 1-4096 rows; a
# decode wave of SLOTS requests at temperature 0.8
RECOVER_STEPS, RECOVER_CRASH = 4, 3
SERVE_SEQ, SERVE_BUCKETS = 1024, range(1, 9)
LOOP_S, LOOP_SHARES, CAPACITY_N = 10.0, (0.5, 0.3), 32
EST_REQS, EST_MAX_ROWS, EST_MAX_BATCH = 32, 4096, 4
DECODE_T, DECODE_NEW = 0.8, 16
CKPT_DIR = "chip_smoke_ckpt"  # gitignored; removed when the phase ends


def _dir_bytes(path):

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _served(torch, ex, reqs, timeout=600):
    """Every request of ``reqs`` submitted at once, then the answers and the
    wall seconds."""
    t0 = time.perf_counter()
    futs = [ex.submit(r) for r in reqs]
    got = [f.result(timeout) for f in futs]
    return got, time.perf_counter() - t0


def _label_near_ties(torch, x, centers, got, want):
    """Rows where two label vectors of a nearest-centroid assignment differ,
    and those of them whose two centroids are not a float64 near tie
    (``2 d2_tol``, as phase 5 holds ``predict``)."""
    differ = (got != want).nonzero().squeeze(1)
    if differ.numel() == 0:
        return 0, 0
    xd, cd = x[differ].double(), centers.double()
    d2 = (xd ** 2).sum(1)[:, None] + (cd ** 2).sum(1)[None, :] - 2.0 * xd @ cd.T
    gap = (d2.gather(1, got[differ][:, None]) - d2.gather(1, want[differ][:, None])).abs()[:, 0]
    scale = (xd ** 2).sum(1) + float((cd ** 2).sum(1).max())
    return int(differ.numel()), int((gap > 2 * d2_tol(x.shape[1], scale)).sum())


def serving_executor(torch, ht, tk, dev, smi, km):
    """Phase 9: train the flagship with checkpoints through a crash, serve
    the restored weights through the batching executor under per-tenant
    admission, serve phase 5's KMeans and phase 5g's KNN, and decode with
    heat_tpu's Threefry sampling. Returns the kernel launches of the
    phase's main path (recovery steps, executor batches, decode engines)."""
    import resource
    import threading

    from heat_tpu_torch.core import random as trandom
    from heat_tpu_torch.core.tree import tree_flatten
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig
    from heat_tpu_torch.serve import ServeConfig, TenantLoad, estimate_capacity, run_open_loop
    from heat_tpu_torch.serve.executor import _to_host
    from heat_tpu_torch.utils import checkpointing as ck
    from heat_tpu_torch.utils import faults, metrics

    t_phase = time.perf_counter()
    L, V = FLAGSHIP["n_layers"], FLAGSHIP["vocab"]
    B, S = TRAIN_BATCH
    checks, out = {}, {}
    launches = dict.fromkeys(tk.launches, 0)

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    def counter(name):
        return metrics.counters().get(name, 0)

    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, compute_dtype=torch.bfloat16))
    toks = model.shard_batch(np.random.default_rng(0).integers(0, V, (B, S)).astype(np.int32))
    tx = ht.optim.Adam(1e-3)
    step = model.make_train_step(tx)
    crashed = []

    def fresh():
        params = model.init(0, dtype=torch.float32)
        return {"params": params, "opt": tx.init(params)}

    def train(state, start, save, crash=False):
        params, opt = state["params"], state["opt"]
        for i in range(start, RECOVER_STEPS):
            params, opt, _ = step(params, opt, toks)
            save(i + 1, {"params": params, "opt": opt})
            if crash and i + 1 == RECOVER_CRASH and not crashed:
                crashed.append(i + 1)
                raise RuntimeError("crash after the save of step 3")
        return {"params": params, "opt": opt}

    # -- 9a. recover: two uninterrupted runs, then the crashed one ------- #
    runs = [tree_flatten(train(fresh(), 0, lambda *a: None)["params"])[0] for _ in range(2)]
    torch.cuda.empty_cache()
    repeatable = all(torch.equal(a, b) for a, b in zip(*runs))
    spread = 0.0 if repeatable else max(float((a - b).abs().max()) for a, b in zip(*runs))
    ref = runs[0]
    del runs
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    saves = []
    try:
        mgr = ck.CheckpointManager(CKPT_DIR, every_steps=1, keep=2)

        def timed_save(step_, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wrote = mgr.save(step_, state)
            saves.append({"step": step_, "seconds": time.perf_counter() - t0,
                          "bytes": _dir_bytes(mgr._path(step_))})
            return wrote

        r0, w0 = counter("checkpoint.recovery_restarts"), counter("checkpoint.write_retries")
        tk.reset_launches()
        t0 = time.perf_counter()
        with faults.inject("checkpoint.leaf.write=once"):
            rec = ck.run_with_recovery(lambda st, s, _save: train(st, s, timed_save, crash=True),
                                       mgr, fresh(), backoff_s=0.0)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        rec_launches = dict(tk.launches)
        add(rec_launches)
        restarts = int(counter("checkpoint.recovery_restarts") - r0)
        retries = int(counter("checkpoint.write_retries") - w0)
        assert crashed == [RECOVER_CRASH] and restarts == 1 and retries == 1, \
            (crashed, restarts, retries)
        assert [s["step"] for s in saves] == [1, 2, 3, 4] and mgr.all_steps() == [3, 4], \
            (saves, mgr.all_steps())
        for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
            assert rec_launches[name] == L * RECOVER_STEPS, rec_launches
        got = tree_flatten(rec["params"])[0]
        if repeatable:
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                "the recovered parameters differ from the uninterrupted run's"
            rec_err = 0.0
        else:
            rec_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            assert rec_err <= spread, (rec_err, spread)
        checks["recover"] = {"uninterrupted_runs_bitwise_equal": repeatable,
                             "uninterrupted_runs_max_abs_diff": spread,
                             "recovered_vs_uninterrupted_max_abs_diff": rec_err,
                             "recovered_bitwise_equal": repeatable and rec_err == 0.0,
                             "restarts": restarts, "write_retries": retries}
        out["recover"] = {"steps": RECOVER_STEPS, "crash_after_step": RECOVER_CRASH,
                          "seconds": recover_s, "saves": saves,
                          "seconds_per_save": statistics.median(s["seconds"] for s in saves),
                          "bytes_per_save": saves[-1]["bytes"], "launches": rec_launches}
        del ref, rec["opt"]

        # -- 9b. serve the restored weights --------------------------- #
        t0 = time.perf_counter()
        restored = ck.load_checkpoint(mgr._path(RECOVER_STEPS))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert restored["__step__"] == RECOVER_STEPS
        rparams = restored.pop("params")
        del restored
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(rparams)[0], got))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    retries0 = counter("serve.batch_retries")
    torch.cuda.reset_peak_memory_stats()
    ex = ht.serve.serve_transformer(model, rparams, SERVE_SEQ,
                                    config=ServeConfig(max_batch=8, queue_limit=64))
    try:
        t0 = time.perf_counter()
        warm = ex.warmup(feat_shape=(SERVE_SEQ,), dtype=np.int32, rows=SERVE_BUCKETS)
        warm_s = time.perf_counter() - t0
        assert warm["compiles"] == 4 and warm["misses"] == 4, warm
        wave = np.random.default_rng(9).integers(0, V, (8, SERVE_SEQ)).astype(np.int32)
        b0 = ex.stats()["batches"]
        tk.reset_launches()
        seen = []  # (thread, stream) of every launch of the wave
        real_launch = tk._launch

        def spy(name, index, *args):
            seen.append((threading.get_ident(), torch._C._cuda_getCurrentRawStream(index)))
            return real_launch(name, index, *args)

        tk._launch = spy
        try:
            ex.pause()
            futs = [ex.submit(wave[i:i + 1]) for i in range(8)]
            ex.resume()
            answers = [f.result(600) for f in futs]
        finally:
            tk._launch = real_launch
        assert ex.flush(60)
        st = ex.stats()
        wave_launches = dict(tk.launches)
        add(wave_launches)
        assert st["batches"] - b0 == 1 and st["batch_occupancy"]["last"] == 1.0, st
        assert wave_launches["flash_attention"] == L, wave_launches
        assert len(seen) == L and {t for t, _ in seen} == {ex._worker.ident}, seen
        worker_stream = getattr(ex.stream, "cuda_stream", 0)
        assert {s for _, s in seen} == {worker_stream}, (seen, worker_stream)
        # the restored weights' logits are the in-memory ones', bitwise
        direct = model.logits_fn()(rec["params"], torch.from_numpy(wave).to(dev))
        for i, a in enumerate(answers):
            assert a.shape == (1, SERVE_SEQ, V) and a.dtype == np.float32
            assert torch.equal(torch.from_numpy(a).to(dev)[0], direct[i]), i
        del direct
        # each request's argmax against a float32 copy (the near-tie rule),
        # and the first request served alone within bf16_logit_tol
        model32 = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP))
        fwd32 = model32.logits_fn()
        ties, alone_ratio = {}, None
        for i in range(8):
            z32 = fwd32(rparams, torch.from_numpy(wave[i:i + 1]).to(dev))[0]
            a = torch.from_numpy(answers[i]).to(dev)[0]
            ties[f"request_{i}"] = near_tie_check(torch, z32, a.argmax(dim=-1), L)
            if i == 0:
                alone = torch.from_numpy(ex.predict(wave[:1], timeout=600)).to(dev)[0]
                tol = bf16_logit_tol(z32.std(dim=-1, keepdim=True),
                                     z32.abs().amax(dim=-1, keepdim=True), L)
                alone_ratio = float(((alone - a).abs() / tol).max())
                assert alone_ratio <= 1.0, alone_ratio
                del alone, tol
            answers[i] = None  # 128 MiB of logits a row: dropped once checked
            del z32, a
        del model32, fwd32, answers
        torch.cuda.empty_cache()
        checks["served_wave"] = {
            "requests": 8, "batches": 1, "bucket": 8, "flash_launches": wave_launches[
                "flash_attention"], "launch_stream_is_worker_stream": True,
            "restored_logits_bitwise_in_memory": True,
            "near_tie": {k: {"tokens_differing_from_f32_argmax": v[0], "max_gap_over_limit": v[1]}
                         for k, v in ties.items()},
            "alone_vs_batch_max_err_over_bf16_logit_tol": alone_ratio}

        # where a batch's time goes, at bucket 8: the payload's copy to the
        # card, the forward, the fetch of the logits and the per-request copies
        prog = ex.program_cache.get(ex.model_fn, (8, SERVE_SEQ), np.int32, ex.cache_token,
                                    device=ex.device)
        parts = {"payload_copy": [], "forward": [], "fetch": [], "row_copies": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = torch.from_numpy(wave)
            x = (x.pin_memory() if dev.type == "cuda" else x).to(dev, non_blocking=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                y = ex.model_fn(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            h = _to_host(y)
            t3 = time.perf_counter()
            rows = [h[i:i + 1].copy() for i in range(8)]
            t4 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(v * 1e3)
            del x, y, h, rows
        batch_ms = {k: statistics.median(v) for k, v in parts.items()}
        share = device_share(torch, lambda: _to_host(prog(wave)), 3)
        del prog
        torch.cuda.empty_cache()

        # the open loop: two tenants at 0.5 and 0.3 of the capacity
        cap = estimate_capacity(ex, (SERVE_SEQ,), rows=1, dtype=np.int32, n=CAPACITY_N, seed=1)
        ex.register_tenant("bulk", priority=0)
        ex.register_tenant("interactive", priority=1)
        s0 = ex.stats()
        tk.reset_launches()
        loads = [TenantLoad("bulk", LOOP_SHARES[0] * cap, rows_mix=(1,)),
                 TenantLoad("interactive", LOOP_SHARES[1] * cap, rows_mix=(1,))]
        rep = run_open_loop(ex, loads, LOOP_S, (SERVE_SEQ,), dtype=np.int32, seed=3,
                            drain_timeout_s=120.0)
        assert ex.flush(120)
        s1 = ex.stats()
        loop_launches = dict(tk.launches)
        add(loop_launches)
        batches = s1["batches"] - s0["batches"]
        assert loop_launches["flash_attention"] == L * batches, (loop_launches, batches)
        assert s1["program_cache"]["compiles"] == 4, s1["program_cache"]  # none after warmup
        assert rep["totals"]["untyped"] == 0, rep["totals"]
        assert rep["totals"]["answered"] == rep["totals"]["offered"], rep["totals"]
        tenants = ex.tenant_stats()
    finally:
        ex.close()
    batch_retries = int(counter("serve.batch_retries") - retries0)
    assert batch_retries == 0, batch_retries
    out["serve"] = {
        "config": dict(FLAGSHIP, compute_dtype="bfloat16", params="float32 restored"),
        "load_checkpoint_s": load_s, "warmup_s": warm_s, "warmup": warm,
        "batch_ms_at_bucket_8": batch_ms, "batch_profiled": share,
        "capacity_rps": cap, "open_loop_s": LOOP_S,
        "offered_rps": {ld.key: ld.rate_rps for ld in loads},
        # a p99 of fewer than 100 latencies is only their largest: it is
        # quoted from 100 on, and the count and the largest stand beside it
        "latency_ms": {k: {"count": v["latency_ms"]["count"], "p50": v["latency_ms"].get("p50"),
                           "p99": (v["latency_ms"].get("p99")
                                   if v["latency_ms"]["count"] >= 100 else None),
                           "max": v["latency_ms"].get("max")}
                       for k, v in rep["tenants"].items()},
        "outcomes": {k: v["outcomes"] for k, v in rep["tenants"].items()},
        "completed": rep["totals"]["outcomes"]["ok"], "shed": rep["totals"]["shed"],
        "rate_limited": rep["totals"]["outcomes"]["rate_limited"],
        "rows_per_s": (s1["rows"] - s0["rows"]) / rep["wall_s"], "batches": batches,
        "mean_occupancy": s1["batch_occupancy"]["mean"],
        "flash_launches_per_batch": loop_launches["flash_attention"] / max(1, batches),
        "program_compiles_after_warmup": s1["program_cache"]["compiles"] - warm["compiles"],
        "batch_retries": batch_retries, "tenants": tenants,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "peak_host_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}
    del rec
    torch.cuda.empty_cache()

    # -- 9c. the estimators ------------------------------------------- #
    rng = np.random.default_rng(10)
    ht.random.seed(0)  # phase 5's points, bit for bit
    X = ht.random.rand(N_POINTS, N_FEATURES, split=0)
    xl = X.larray
    sizes = rng.integers(1, EST_MAX_ROWS + 1, EST_REQS)
    starts = rng.integers(0, N_POINTS - EST_MAX_ROWS, EST_REQS)
    reqs = [xl[s:s + n].cpu().numpy() for s, n in zip(starts, sizes)]
    est = {}
    with ht.serve.serve_estimator(km, config=ServeConfig(max_batch=EST_MAX_BATCH)) as ex:
        ex.warmup(feat_shape=(N_FEATURES,), rows=[1 << i for i in range(15)])
        tk.reset_launches()
        labs, wall = _served(torch, ex, reqs)
        add(dict(tk.launches))
        assert all(v == 0 for v in tk.launches.values()), tk.launches  # matmul form
        est["kmeans"] = {"requests": EST_REQS, "rows": int(sizes.sum()), "seconds": wall,
                         "rows_per_s": int(sizes.sum()) / wall, "stats": {
                             k: ex.stats()[k] for k in ("batches", "rows", "padded_rows")}}
    rows_t = torch.cat([xl[s:s + n] for s, n in zip(starts, sizes)])
    got = torch.from_numpy(np.concatenate(labs)).to(dev)
    want = km.predict(ht.array(rows_t)).larray
    n_diff, n_bad = _label_near_ties(torch, rows_t, km.cluster_centers_.larray, got, want)
    assert n_bad == 0, (n_diff, n_bad)
    checks["kmeans_labels"] = {"differing_from_predict": n_diff, "not_near_tie": n_bad}
    del X, xl, reqs, rows_t, got, want, labs
    torch.cuda.empty_cache()

    pts, truth, test, _ = knn_blobs()
    knn = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(
        ht.array(pts, split=0), ht.array(truth, split=0))
    sizes = rng.integers(1, EST_MAX_ROWS + 1, EST_REQS)
    starts = rng.integers(0, CDIST_N - EST_MAX_ROWS, EST_REQS)
    reqs = [test[s:s + n] for s, n in zip(starts, sizes)]
    with ht.serve.serve_estimator(knn, config=ServeConfig(max_batch=EST_MAX_BATCH)) as ex:
        ex.warmup(feat_shape=(CDIST_D,), rows=[1 << i for i in range(15)])
        tk.reset_launches()
        labs, wall = _served(torch, ex, reqs)
        add(dict(tk.launches))
        est["knn"] = {"requests": EST_REQS, "rows": int(sizes.sum()), "seconds": wall,
                      "rows_per_s": int(sizes.sum()) / wall, "stats": {
                          k: ex.stats()[k] for k in ("batches", "rows", "padded_rows")}}
    q = torch.from_numpy(np.concatenate(reqs)).to(dev)
    got = torch.from_numpy(np.concatenate(labs)).to(dev)
    want = knn.predict(ht.array(q)).larray
    differ = (got != want).nonzero().squeeze(1)
    n_bad = 0
    if differ.numel():
        a, b = q[differ].double(), knn.x.larray.double()
        d2 = ((a ** 2).sum(1)[:, None] + (b ** 2).sum(1)[None, :] - 2.0 * a @ b.T).clamp_min(0)
        v6 = torch.topk(d2, KNN_K + 1, dim=1, largest=False).values
        scale = (a ** 2).sum(1) + float((b ** 2).sum(1).max())
        n_bad = int(((v6[:, KNN_K] - v6[:, KNN_K - 1]) > 2 * d2_tol(CDIST_D, scale)).sum())
    assert n_bad == 0, (int(differ.numel()), n_bad)
    checks["knn_labels"] = {"differing_from_predict": int(differ.numel()), "not_near_tie": n_bad}
    out["estimators"] = est
    del knn, q, got, want, reqs, labs
    torch.cuda.empty_cache()

    # -- 9d. decode with heat_tpu's sampling ---------------------------- #
    leaves, unflatten = tree_flatten(rparams)
    sparams = unflatten([t.to(torch.bfloat16) for t in leaves])
    del rparams, leaves
    rng = np.random.default_rng(11)
    # prompts of 102-1024 tokens (buckets 128-1024), as phase 6's
    lens = rng.integers(SEQ_CAP // 20, SEQ_CAP // 2 + 1, SLOTS)
    prompts = [rng.integers(0, V, int(n)).astype(np.int32) for n in lens]

    def decode_wave():
        eng = ht.serve.serve_transformer(model, sparams, SEQ_CAP, decode=True, slots=SLOTS,
                                         temperature=DECODE_T, seed=0)
        try:
            eng.register_tenant("interactive", priority=1)
            eng.register_tenant("bulk")
            eng.warmup()
            eng.pause()
            futs = [eng.submit(p, DECODE_NEW, tenant="interactive" if i % 2 else "bulk")
                    for i, p in enumerate(prompts)]
            t0 = time.perf_counter()
            eng.resume()
            toks_out = [f.result(600) for f in futs]
            wall = time.perf_counter() - t0
            return toks_out, eng.stats(), ht.runtime_stats()["serve"], wall
        finally:
            eng.close()

    tk.reset_launches()
    first, dstats, rstats, dwall = decode_wave()
    dec_launches = dict(tk.launches)
    add(dec_launches)
    second, _, _, _ = decode_wave()
    assert all(np.array_equal(a, b) for a, b in zip(first, second)), "sampling is not repeatable"
    for p, o in zip(prompts, first):
        assert o.size == p.size + DECODE_NEW and np.array_equal(o[:p.size], p)
        assert int(o.min()) >= 0 and int(o.max()) < V
    n_warm = int(math.log2(SEQ_CAP // model.PROMPT_BUCKET_MIN))
    assert dec_launches["flash_attention"] == L * (n_warm + SLOTS), dec_launches
    assert dec_launches["probe"] == 1, dec_launches
    assert dstats["tenants"]["interactive"]["completed"] == SLOTS // 2
    # one step's uniform bits on the card: the CPU's, bitwise
    skey = trandom._fold_in(trandom._base_key(0), 2 * 2)
    keys = [trandom._fold_in(skey, s) for s in range(SLOTS)]
    kt = [[trandom._signed32(a) for a in k] for k in keys]
    bits = []
    for where in (dev, torch.device("cpu")):
        x0, x1 = trandom._threefry_keyed(torch.tensor(kt, dtype=torch.int32, device=where),
                                         torch.arange(V, dtype=torch.int32, device=where))
        w = x0 ^ x1
        bits.append((w.cpu(), trandom._uniform_tiny(w).cpu(),
                     trandom._words(keys[3], torch.arange(V, device=where), False).cpu()))
    assert all(torch.equal(a, b) for a, b in zip(*bits)), "the card's sampling bits differ"
    assert torch.equal(bits[1][0][3], bits[1][2])
    checks["decode_sampling"] = {"tokens_repeat_bitwise": True, "uniform_bits_card_eq_cpu": True,
                                 "temperature": DECODE_T}
    out["decode"] = {"requests": SLOTS, "new_tokens": DECODE_NEW, "wall_s": dwall,
                     "tokens_per_s": SLOTS * DECODE_NEW / dwall, "stats": dstats,
                     "runtime_stats_serve": rstats, "launches": dec_launches}
    del sparams, model
    torch.cuda.empty_cache()
    emit({"phase": "serving_executor", "card": smi, "checks": checks, **out,
          "launches": launches, "phase_seconds": time.perf_counter() - t_phase})
    return launches


# phase 10: the fusion engine's whole-step programs as CUDA graphs -------
TRACE_DIR = "chip_smoke_trace"  # gitignored; removed when the phase ends
FUSED_STEPS, FUSED_WARMUP = 10, 2


def _first_difference(torch, names, a, b):
    """The first pair of ``a`` and ``b`` (lists of tensors) that differs in
    a bit, as (name, max abs difference, max abs value), or None."""
    for name, x, y in zip(names, a, b):
        if not same_bits(torch, x, y):
            return name, float((x.float() - y.float()).abs().max()), float(y.float().abs().max())
    return None


# each wrapper's kernel in a profiler trace: the flash wrappers launch one
# kernel each, kmeans_step its partial (or streaming) pass and one reduce
TRACE_SYMBOLS = {"flash_attention": "flash_fwd_sm90_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_sm90_kernel",
                 "kmeans_step": "kmeans_reduce_kernel"}


def traced_kernels(torch, fn):
    """Runs ``fn`` under ``utils.profiling.trace`` and returns how many
    kernel events of the written trace name each symbol of
    :data:`TRACE_SYMBOLS` (the card's own record of what ran, independent of
    the wrappers' counts), the user spans' names, and the trace's totals:
    files, kernel events and ``cudaGraphLaunch`` calls."""
    from heat_tpu_torch.utils import profiling

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    try:
        with profiling.trace(TRACE_DIR):
            fn()
            torch.cuda.synchronize()
        files = [os.path.join(TRACE_DIR, f) for f in os.listdir(TRACE_DIR)]
        assert files, "profiling.trace wrote no file"
        counts = dict.fromkeys(TRACE_SYMBOLS, 0)
        spans = set()
        totals = {"files": len(files), "kernel_events": 0, "graph_launches": 0}
        for f in files:
            with open(f) as fh:
                events = json.load(fh).get("traceEvents", [])
            for ev in events:
                if ev.get("cat") == "kernel":
                    totals["kernel_events"] += 1
                    for name, sym in TRACE_SYMBOLS.items():
                        counts[name] += sym in ev.get("name", "")
                elif ev.get("cat") == "user_annotation":
                    spans.add(ev.get("name"))
                elif ev.get("name") == "cudaGraphLaunch":
                    totals["graph_launches"] += 1
    finally:
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    return counts, spans, totals


def fused_steps(torch, ht, tk, dev, smi):
    """Phase 10: the flagship's training step, the Lloyd fit, the optimizer
    update and a profiler trace through the fusion engine's programs, each
    held bitwise against its eager run from the same start; returns the
    launch counts of the graphed runs."""
    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core.tree import tree_flatten
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig
    from heat_tpu_torch.utils import profiling

    assert ht.pallas_enabled()
    assert fusion.step_enabled() and fusion.fit_enabled()
    # phases 5-9 ran their steps and fits as programs too: none fell back
    earlier = fusion.stats()
    assert earlier["step_fallbacks"] == earlier["fit_step_fallbacks"] == 0, earlier
    fusion.reset()  # the programs of the earlier phases, and their graphs
    torch.cuda.empty_cache()
    out = {"phase": "fused_steps", "card": smi,
           "earlier_phases": {k: earlier[k] for k in (
               "step_flushes", "step_fallbacks", "fit_step_flushes", "fit_step_fallbacks",
               "program_cache")}}
    graphed_launches = dict.fromkeys(tk.launches, 0)
    L, V = FLAGSHIP["n_layers"], FLAGSHIP["vocab"]
    B, S = TRAIN_BATCH

    # (10a) the flagship's training step as one graph
    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model = TransformerLM(grid, TransformerLMConfig(**FLAGSHIP, compute_dtype=torch.bfloat16))
    toks = model.shard_batch(np.random.default_rng(0).integers(0, V, (B, S)).astype(np.int32))

    def train(graphed):
        params = model.init(0, dtype=torch.float32)
        tx = ht.optim.Adam(1e-3)
        opt_state = tx.init(params)
        step = model.make_train_step(tx)
        losses = []
        before = fusion.stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with fusion.step_override(graphed):
            for _ in range(FUSED_WARMUP):
                params, opt_state, loss = step(params, opt_state, toks)
                losses.append(loss)
            torch.cuda.synchronize()
            tk.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(FUSED_STEPS):
                params, opt_state, loss = step(params, opt_state, toks)
                losses.append(loss)
            end.record()
            host_us = (time.perf_counter() - t0) * 1e6 / FUSED_STEPS
            end.synchronize()
            launches = dict(tk.launches)

            def one():
                nonlocal params, opt_state
                params, opt_state, _ = step(params, opt_state, toks)
                torch.cuda.synchronize()

            share = device_share(torch, one, 3, kinds=TRAIN_KINDS)
        after = fusion.stats()
        progs = list(step.program_cache._programs.values())
        res = {"step_ms": start.elapsed_time(end) / FUSED_STEPS, "host_us_per_step": host_us,
               "launches_per_step": {n: c / FUSED_STEPS for n, c in launches.items()},
               "profiled": share, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "step_flushes": after["step_flushes"] - before["step_flushes"],
               "step_fallbacks": after["step_fallbacks"] - before["step_fallbacks"],
               "builds": step.program_cache.stats()["compiles"],
               "captures": [p.captures for p in progs]}
        return res, launches, [float(x) for x in losses], params

    eager, e_launch, e_losses, e_params = train(False)
    torch.cuda.empty_cache()
    graph, g_launch, g_losses, g_params = train(True)
    leaves_e = tree_flatten(e_params)[0]
    leaves_g = tree_flatten(g_params)[0]
    names = [f"leaf{i}{tuple(t.shape)}" for i, t in enumerate(leaves_e)]
    diff = _first_difference(torch, names, leaves_g, leaves_e)
    loss_bits = e_losses == g_losses
    assert eager["builds"] == 0 and eager["step_flushes"] == 0, eager
    assert graph["builds"] == 1 and graph["captures"] == [1], graph
    assert graph["step_fallbacks"] == 0 and eager["step_fallbacks"] == 0
    # the warm-up, the timed steps and device_share's 1 + 3 + 3
    assert graph["step_flushes"] == FUSED_WARMUP + FUSED_STEPS + 7, graph
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        assert g_launch[name] == e_launch[name] == L * FUSED_STEPS, (name, g_launch, e_launch)
        graphed_launches[name] += g_launch[name]
    out["train_step"] = {"config": FLAGSHIP, "batch": [B, S], "optimizer": "Adam(1e-3)",
                         "eager": eager, "graphed": graph, "losses_bitwise_equal": loss_bits,
                         "params_bitwise_equal": diff is None, "first_differing_leaf": diff,
                         "losses": g_losses}
    if not loss_bits or diff is not None:
        # cuBLAS may take another algorithm under capture: then phase 7's
        # loss tolerance (a few bf16 roundings of the loss) holds
        rel = max(abs(a - b) / abs(b) for a, b in zip(g_losses, e_losses))
        out["train_step"]["max_loss_rel_diff"] = rel
        assert rel <= 2.0**-8, rel
    del e_params, g_params, leaves_e, leaves_g
    torch.cuda.empty_cache()

    # (10c) DataParallelOptimizer.apply_gradients at the flagship's tree
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    base, unflatten = tree_flatten(model.init(0, dtype=torch.float32))
    grads = [unflatten([torch.randn(t.shape, device=dev, generator=gen) * 1e-3 for t in base])
             for _ in range(3)]

    def update(graphed):
        params = unflatten([t.clone() for t in base])
        opt = ht.optim.DataParallelOptimizer(ht.optim.Adam(1e-3))
        before = fusion.stats()["step_flushes"]
        with fusion.step_override(graphed):
            for g in grads:
                params = opt.apply_gradients(params, g)
        torch.cuda.synchronize()
        return tree_flatten(params)[0], fusion.stats()["step_flushes"] - before

    p_e, f_e = update(False)
    p_g, f_g = update(True)
    d_upd = _first_difference(torch, [f"leaf{i}" for i in range(len(base))], p_g, p_e)
    assert f_e == 0 and f_g == len(grads), (f_e, f_g)
    assert d_upd is None, d_upd
    out["apply_gradients"] = {"leaves": len(base), "calls": len(grads), "flushes": f_g,
                              "bitwise_equal": True}
    del p_e, p_g, grads, base
    torch.cuda.empty_cache()

    # (10d) a profiler trace around two graphed steps: the card ran each
    # flash kernel as often as the graph's tally says
    tx = ht.optim.Adam(1e-3)
    params = model.init(0, dtype=torch.float32)
    opt_state = tx.init(params)
    step = model.make_train_step(tx)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, toks)
    torch.cuda.synchronize()
    prog = next(iter(step.program_cache._programs.values()))
    tally = dict(prog._tally["launches"])

    def two_steps():
        nonlocal params, opt_state
        for _ in range(2):
            with profiling.annotate("fused_train_step"):
                params, opt_state, _ = step(params, opt_state, toks)

    tk.reset_launches()
    seen, spans, totals = traced_kernels(torch, two_steps)
    flash = ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq")
    out["trace"] = {**totals, "spans": sorted(s for s in spans if s),
                    "tally_per_replay": tally, "kernel_events_by_wrapper": seen,
                    "launches_counted": dict(tk.launches), "captures": prog.captures}
    assert prog.captures == 1, out["trace"]
    for name in flash:
        assert seen[name] == 2 * tally[name] == 2 * L == tk.launches[name], (name, out["trace"])
    assert "fused_train_step" in spans, spans
    del params, opt_state, step, model, prog
    torch.cuda.empty_cache()

    # (10b) the Lloyd fit through fit_step_call, graphed and eager
    ht.random.seed(0)
    X = ht.random.rand(N_POINTS, N_FEATURES, split=0)
    init = ht.array(X.larray[:: N_POINTS // K][:K].clone(), split=None)
    fits = {}
    for graphed in (False, True):
        before = fusion.stats()
        tk.reset_launches()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        with fusion.fit_override(graphed):
            km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1).fit(X)
            torch.cuda.synchronize()
            launches = dict(tk.launches)
            grown = torch.cuda.memory_allocated() - mem0
            step = km._lloyd_step(X.comm, 0)
            c0 = init.larray.clone()
            km._run_lloyd(step, X.larray, c0)  # warm-up and capture
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            km._run_lloyd(step, X.larray, c0)
            end.record()
            end.synchronize()
        after = fusion.stats()
        fits[graphed] = {"centers": km.cluster_centers_.larray.clone(), "inertia": km.inertia_,
                         "kmeans_step_launches": launches["kmeans_step"],
                         "fit_step_flushes": after["fit_step_flushes"] - before["fit_step_flushes"],
                         "fit_step_fallbacks": after["fit_step_fallbacks"]
                         - before["fit_step_fallbacks"],
                         "memory_grown_gb": grown / 1e9,
                         "lloyd_iterations_per_second": ITERS / (start.elapsed_time(end) / 1e3)}
    prog = next(p for k, p in fusion.program_cache()._programs.items()
                if k[:2] == ("fit", "kmeans.lloyd"))
    # two more graphed Lloyd steps under the profiler, recorded beside the
    # graph's tally: a whole script's trace has held none of these replays'
    # kernels where this phase alone held both (PERF.md), so only 10d's
    # trace of the flagship step is held to its tally
    captures = prog.captures
    c_tr = init.larray.clone()

    def two_lloyd_steps():
        nonlocal c_tr
        for _ in range(2):
            c_tr, _, _ = step(X.larray, c_tr)

    tk.reset_launches()
    seen_l, _, totals_l = traced_kernels(torch, two_lloyd_steps)
    lloyd_trace = {**totals_l, "tally_per_replay": dict(prog._tally["launches"]),
                   "kernel_events_by_wrapper": seen_l, "launches_counted": dict(tk.launches)}
    assert prog.captures == captures, (prog.captures, captures)
    assert prog._tally["launches"]["kmeans_step"] == 1 and tk.launches["kmeans_step"] == 2, \
        lloyd_trace
    e, g = fits[False], fits[True]
    assert e["kmeans_step_launches"] == g["kmeans_step_launches"] == ITERS, (e, g)
    assert e["fit_step_flushes"] == 0 and g["fit_step_flushes"] == 3 * ITERS, (e, g)
    assert g["fit_step_fallbacks"] == 0 and e["fit_step_fallbacks"] == 0
    assert torch.equal(e["centers"], g["centers"]) and e["inertia"] == g["inertia"], (e, g)
    # x is bound by reference: no copy of it at a replay, no buffer of its size
    x_gb = X.larray.numel() * 4 / 1e9
    assert prog._owned[0] is None and g["memory_grown_gb"] < x_gb, (g, x_gb)
    graphed_launches["kmeans_step"] += g["kmeans_step_launches"]
    out["lloyd"] = {"points": [N_POINTS, N_FEATURES], "k": K, "iterations": ITERS,
                    "bitwise_equal": True, "x_gb": x_gb, "captures": prog.captures,
                    "trace": lloyd_trace,
                    **{("graphed" if k else "eager"): {n: v for n, v in r.items() if n != "centers"}
                       for k, r in fits.items()}}
    del X, init, km, fits, e, g, prog, step, c_tr
    fusion.reset()
    torch.cuda.empty_cache()
    out["fusion_stats"] = fusion.stats()
    emit(out)
    return graphed_launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster.kmeans import _finish_update
    from heat_tpu_torch.core import _build
    from heat_tpu_torch.core import kernels as tk

    # 1. card ----------------------------------------------------------- #
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_name, (bw, f32, _f64, bf16_tc) = peaks(kind)
    emit({"phase": "card", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "peaks_of": peak_name,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off"
    # every card tensor goes to the hand-written kernels (set_pallas off is
    # an A/B request only)
    assert ht.pallas_enabled()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build ---------------------------------------------------------- #
    _build.library()
    info = _build.build_info()
    clean = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    spills = [ln.strip() for ln in info["log"].splitlines()
              if "bytes stack frame" in ln and ln.strip() != clean]
    # ptxas's lines for the tensor-core kernels (keyed by name and mangled
    # template arguments, e.g. ILi64E6__halfE): registers at the launch
    # value (the consumers raise theirs with setmaxnreg), stack and spills
    sm90, entry = {}, None
    for ln in info["log"].splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_[a-z_]+_sm90_kernelI.*?E)Ev", ln)
        if m:
            entry = m.group(1)
        elif "Compiling entry function" in ln:
            entry = None
        elif entry and ("bytes stack frame" in ln or "Used" in ln):
            sm90.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library": info["path"], "ptxas_nonzero_stack_or_spill": spills,
          "ptxas_sm90": sm90,
          "probe_launches_at_load": tk.launches["probe"]})
    assert tk.launches["probe"] == 1, tk.launches

    # 3. probe ---------------------------------------------------------- #
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xp = torch.randn(8, 128, device=dev, generator=gen)
    got_p = tk.probe(xp)
    torch.cuda.synchronize()
    assert torch.equal(got_p, tk.probe_plain(xp)), "probe differs from x + 1"
    ms_probe = time_ms(torch, lambda: tk.probe(xp))
    plain_probe = time_ms(torch, lambda: tk.probe_plain(xp))
    lib_probe = time_ms(torch, lambda: torch.add(xp, 1.0))
    b_probe = bound(2 * xp.numel() * 4, xp.numel(), bw, f32)
    host = host_breakdown(torch, tk, _build.library(), dev, gen)
    emit({"phase": "probe", "card": smi, "bitwise_equal": True, "ms": ms_probe,
          "plain_ms": plain_probe, "torch.add_ms": lib_probe, "bound_ms": b_probe[0]})
    emit({"phase": "host_breakdown", "card": smi, "host_us_per_call": host})

    # 4. kernels against their plain versions, at the main paths' shapes - #
    x = torch.rand(N_POINTS, N_FEATURES, device=dev, generator=gen)
    c = x[torch.randint(0, N_POINTS, (K,), device=dev, generator=gen)].clone()
    y = torch.rand(CDIST_N, CDIST_D, device=dev, generator=gen)

    cd_checks = {}
    for name, a, b in (("2^23x64_vs_8", x, c), ("40000x18_self", y, y)):
        for sqrt in (True, False):
            err, ratio = check_cdist(torch, tk, a, b, sqrt=sqrt)
            cd_checks[f"{name}_{'sqrt' if sqrt else 'sq'}"] = {
                "max_abs_err": err, "max_err_over_limit": ratio}
            torch.cuda.empty_cache()
    err_pp = cd_checks["2^23x64_vs_8_sqrt"]["max_abs_err"]
    err_40k = cd_checks["40000x18_self_sqrt"]["max_abs_err"]
    xb, cb = x.bfloat16(), c.bfloat16()
    err_bf, ratio_bf = check_cdist(torch, tk, xb, cb, sqrt=True, rtol=2.0**-7)
    cd_checks["bf16_in_bf16_out_sqrt"] = {"max_abs_err": err_bf, "max_err_over_limit": ratio_bf,
                                          "rtol": 2.0**-7}
    assert tk.cdist_tile(xb, cb, out_dtype=torch.float32).dtype == torch.float32
    del xb, cb

    ms_40k = time_ms(torch, lambda: tk.cdist_tile(y, y))
    plain_40k = time_ms(torch, lambda: tk.cdist_tile_plain(y, y))
    lib_40k = time_ms(torch, lambda: torch.cdist(y, y))
    b_40k = cdist_bound(CDIST_N, CDIST_N, CDIST_D, 4, 4, bw, f32)
    ms_pp = time_ms(torch, lambda: tk.cdist_tile(x, c))
    plain_pp = time_ms(torch, lambda: tk.cdist_tile_plain(x, c))
    lib_pp = time_ms(torch, lambda: torch.cdist(x, c))
    b_pp = cdist_bound(N_POINTS, K, N_FEATURES, 4, 4, bw, f32)
    torch.cuda.empty_cache()

    # kmeans_step, f32, with the last rows masked off
    n_masked = 12345
    mask = torch.arange(N_POINTS, device=dev) < N_POINTS - n_masked
    got = tk.kmeans_step(x, c, mask, return_labels=True)
    again = tk.kmeans_step(x, c, mask, return_labels=True)
    want = tk.kmeans_step_plain(x, c, mask, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "kmeans_step not repeatable"
    assert float(got[1].sum()) == N_POINTS - n_masked, float(got[1].sum())
    km_check = check_kmeans_step(torch, x, c, mask, got, want)
    d_sums = km_check["max_abs_err_sums_vs_plain"]
    torch.cuda.empty_cache()
    ms_km = time_ms(torch, lambda: tk.kmeans_step(x, c))
    plain_km = time_ms(torch, lambda: tk.kmeans_step_plain(x, c))
    b_km = kmeans_bound(N_POINTS, N_FEATURES, K, bw, f32, bf16_tc)
    del mask, got, again, want
    torch.cuda.empty_cache()
    # k*d past what a block's shared memory holds: the streaming path
    # (centroid chunks, each block's sums in its workspace row), planned by
    # shape alone
    km_large = {}
    for name, n, d, k in (("2^20x64_k128", 2**20, 64, 128), ("2^17x1024_k64", 2**17, 1024, 64)):
        xl = torch.rand(n, d, device=dev, generator=gen)
        cl = xl[torch.randint(0, n, (k,), device=dev, generator=gen)].clone()
        ml = torch.arange(n, device=dev) < n - 1234
        got = tk.kmeans_step(xl, cl, ml, return_labels=True)
        again = tk.kmeans_step(xl, cl, ml, return_labels=True)
        want = tk.kmeans_step_plain(xl, cl, ml, return_labels=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"kmeans_step {name}"
        chk = check_kmeans_step(torch, xl, cl, ml, got, want)
        del got, again, want
        torch.cuda.empty_cache()
        b_l = kmeans_bound(n, d, k, bw, f32, bf16_tc)
        ms_l = time_ms(torch, lambda: tk.kmeans_step(xl, cl))
        km_large[name] = {"check": chk, "kernel": ms_l,
                          "plain": time_ms(torch, lambda: tk.kmeans_step_plain(xl, cl)),
                          "bound": b_l[0], "bound_by": b_l[1],
                          **reach(kmeans_bytes(n, d, k), ms_l, b_l[0])}
        del xl, cl, ml
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": smi, "checks": {
        "cdist_tile": cd_checks, "kmeans_step_2^23x64_k8_masked": km_check,
        **{f"kmeans_step_{name}_masked": r["check"] for name, r in km_large.items()}},
        "timings_ms": {
            "cdist_tile_40000x40000x18": {
                "kernel": ms_40k, "plain": plain_40k, "torch.cdist": lib_40k, "bound": b_40k[0],
                **reach(cdist_bytes(CDIST_N, CDIST_N, CDIST_D, 4, 4), ms_40k, b_40k[0])},
            "cdist_tile_2^23x64_vs_8": {
                "kernel": ms_pp, "plain": plain_pp, "torch.cdist": lib_pp, "bound": b_pp[0],
                **reach(cdist_bytes(N_POINTS, K, N_FEATURES, 4, 4), ms_pp, b_pp[0])},
            "kmeans_step_2^23x64_k8": {
                "kernel": ms_km, "plain": plain_km, "bound": b_km[0],
                **reach(kmeans_bytes(N_POINTS, N_FEATURES, K), ms_km, b_km[0])},
            **{f"kmeans_step_{name}": {key: r[key] for key in (
                "kernel", "plain", "bound", "bound_by", "achieved_TB_per_s", "bound_over_ms")}
               for name, r in km_large.items()}}})
    del c
    torch.cuda.empty_cache()

    fl_checks, fl_times = flash_fwd_phase(torch, tk, dev, gen, smi, bw, bf16_tc)
    bwd = flash_bwd_phase(torch, tk, dev, gen, smi, bw, bf16_tc)

    # 5. the KMeans path, through the entry points a user calls ---------- #
    del x, y
    torch.cuda.empty_cache()
    comm = ht.get_comm()
    tk.reset_launches()
    comm.reset_stats()
    t0 = time.perf_counter()
    ht.random.seed(0)
    X = ht.random.rand(N_POINTS, N_FEATURES, split=0)
    km = ht.cluster.KMeans(n_clusters=K, init="kmeans++", max_iter=ITERS, tol=-1,
                           random_state=0).fit(X)
    labels = km.predict(X)
    Y = ht.random.rand(CDIST_N, CDIST_D, split=0)
    D = ht.spatial.cdist(Y, quadratic_expansion=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tk.launches)
    packed = comm.stats.get("packed_all_reduce", {}).get("calls", 0)
    assert launches["kmeans_step"] == ITERS, launches
    assert launches["cdist_tile"] >= K, launches  # 7 seeding calls, predict, cdist
    assert packed == 0 and comm.size == 1, (packed, comm.size)

    # the fit against a plain Lloyd loop from the same seeding
    xl = X.larray
    seeded = ht.cluster.KMeans(n_clusters=K, init="kmeans++", random_state=0)
    seeded._initialize_cluster_centers(X)
    c0 = seeded.cluster_centers_.larray.clone()
    cp = c0.clone()
    for _ in range(ITERS):
        s, n_, _ = tk.kmeans_step_plain(xl, cp)
        cp, _ = _finish_update(s, n_, cp)
    centers = km.cluster_centers_.larray
    d_centers = float((centers - cp).abs().max())
    # near-tie rows move a centroid by about |x - c| / count (~1e-6 here)
    assert d_centers <= 1e-3, d_centers
    assert km.n_iter_ == ITERS and torch.isfinite(torch.tensor(km.inertia_))

    lab = labels.larray
    assert lab.shape == (N_POINTS,) and int(lab.min()) >= 0 and int(lab.max()) < K
    d2 = tk.cdist_tile_plain(xl, centers, sqrt=False)
    top2 = torch.topk(d2, 2, dim=1, largest=False)
    plain_lab = top2.indices[:, 0]
    # predict takes the argmin of rounded square roots: twice the band
    scale = (xl ** 2).sum(1) + float((centers ** 2).sum(1).max())
    near = (top2.values[:, 1] - top2.values[:, 0]) <= 2 * d2_tol(N_FEATURES, scale)
    differ = lab != plain_lab
    n_differ, n_unexplained = int(differ.sum()), int((differ & ~near).sum())
    assert n_unexplained == 0, (n_differ, n_unexplained)
    del d2, top2, plain_lab, near, differ

    dl = D.larray
    assert D.shape == (CDIST_N, CDIST_N) and bool(torch.isfinite(dl).all())
    err_d, ratio_d = check_cdist(torch, tk, Y.larray, Y.larray, sqrt=True, got=dl)
    diag_tol = d2_tol(CDIST_D, 2 * float((Y.larray ** 2).sum(1).max())) ** 0.5
    assert float(dl.diagonal().abs().max()) <= diag_tol
    del dl, D

    # Lloyd iterations per second over the 20 steps of the same fit
    step = km._lloyd_step(comm, 0)
    lloyd = ht.cluster.KMeans(n_clusters=K, max_iter=ITERS, tol=-1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lloyd._run_lloyd(step, xl, c0.clone())
    end.record()
    end.synchronize()
    lloyd_ms = start.elapsed_time(end)
    emit({"phase": "kmeans_path", "card": smi, "wall_s": wall, "launches": launches,
          "packed_all_reduce": packed, "n_iter": km.n_iter_, "inertia": km.inertia_,
          "max_abs_err_centers_vs_plain_lloyd": d_centers,
          "predict_rows_differing_from_plain": n_differ,
          "predict_rows_differing_not_near_tie": n_unexplained,
          "cdist_max_abs_err": err_d, "cdist_max_err_over_limit": ratio_d,
          "lloyd_ms_20_steps": lloyd_ms,
          "kmeans_lloyd_iterations_per_second": ITERS / (lloyd_ms / 1e3)})
    del X, Y, xl, lab, labels, seeded, lloyd, step, c0, cp, centers
    torch.cuda.empty_cache()  # km stays: phase 9 serves it

    # 5b. the array path: operators, moments, cumsum, resplit, standardize
    array_path(torch, ht, tk, smi, bw)
    torch.cuda.empty_cache()

    # 5c. the array tour: masks, keys, manipulations, factories, filter-fit
    array_tour(torch, ht, tk, smi, bw)
    torch.cuda.empty_cache()

    # 5d. order statistics: sort, percentiles, unique, topk, set operations,
    # counts, searches, calculus, then the p90 filter-fit-median flow
    order_stats(torch, ht, tk, smi, bw)
    torch.cuda.empty_cache()

    # 5e. the linear algebra path: @, cov, qr, svd, the solvers, Spectral,
    # Lasso and the Threefry draw
    spectral_launches = linalg_path(torch, ht, tk, smi, bw, f32, bf16_tc)
    torch.cuda.empty_cache()

    # 5f. file I/O and the out-of-core fit, KMedians and KMedoids
    io_launches = io_stream(torch, ht, tk, smi)
    torch.cuda.empty_cache()

    # 5g. the data engine, its streamed folds, GaussianNB and KNN
    data_launches = data_engine(torch, ht, tk, smi, bw)
    torch.cuda.empty_cache()

    # 6. the serving path, through the entry points a user calls -------- #
    serve_launches = serving_path(torch, ht, tk, dev, smi)
    fp, fl = fl_times["prefill_1x16x1024x64_bf16"], fl_times["logits_8x16x1024x64_bf16"]
    torch.cuda.empty_cache()

    # 7. the training path, through the entry points a user calls ------- #
    train_launches = training_path(torch, ht, tk, smi, bf16_tc)
    bt = bwd["timings_ms"]
    torch.cuda.empty_cache()

    # 8. the flagship on a grid: experts, microbatches, remat; the ring
    # schedules' kernel calls; DataParallel ---------------------------- #
    grid_launches = grid_path(torch, ht, tk, dev, gen, smi, bf16_tc)
    torch.cuda.empty_cache()

    # 9. checkpoint-and-recover training, then the batching executor on the
    # restored weights, the estimators and decode with heat_tpu's sampling
    exec_launches = serving_executor(torch, ht, tk, dev, smi, km)
    torch.cuda.empty_cache()

    # 10. the fusion engine's whole-step programs as CUDA graphs -------- #
    fused_launches = fused_steps(torch, ht, tk, dev, smi)

    emit({"kernels": [
        {"name": "cdist_tile", "route": "cuda", "source": "heat_tpu_torch/csrc/cdist_tile.cu",
         "replaces": "heat_tpu/core/pallas_kernels.py:189",
         "launches": (launches["cdist_tile"] + spectral_launches["cdist_tile"]
                      + io_launches["cdist_tile"] + data_launches["cdist_tile"]
                      + exec_launches["cdist_tile"]),
         "launches_by_path": {"kmeans": launches["cdist_tile"],
                              "spectral": spectral_launches["cdist_tile"],
                              "io_stream": io_launches["cdist_tile"],
                              "data_engine": data_launches["cdist_tile"],
                              "serving_executor": exec_launches["cdist_tile"]},
         "max_abs_err": err_40k, "ms": ms_40k, "plain_ms": plain_40k, "bound_ms": b_40k[0],
         "bound_by": b_40k[1], "library_ms": lib_40k, "shape": "40000x40000x18 f32, sqrt",
         "variants": [{"shape": "2^23x64 vs 8 f32, sqrt", "max_abs_err": err_pp,
                       "ms": ms_pp, "plain_ms": plain_pp, "bound_ms": b_pp[0],
                       "bound_by": b_pp[1], "library_ms": lib_pp}]},
        {"name": "kmeans_step", "route": "cuda", "source": "heat_tpu_torch/csrc/kmeans_step.cu",
         "replaces": "heat_tpu/core/pallas_kernels.py:858",
         "launches": (launches["kmeans_step"] + spectral_launches["kmeans_step"]
                      + io_launches["kmeans_step"] + data_launches["kmeans_step"]
                      + exec_launches["kmeans_step"] + fused_launches["kmeans_step"]),
         "launches_by_path": {"kmeans": launches["kmeans_step"],
                              "spectral": spectral_launches["kmeans_step"],
                              "io_stream": io_launches["kmeans_step"],
                              "data_engine": data_launches["kmeans_step"],
                              "serving_executor": exec_launches["kmeans_step"],
                              "fused_steps": fused_launches["kmeans_step"]},
         "max_abs_err": d_sums, "ms": ms_km, "plain_ms": plain_km, "bound_ms": b_km[0],
         "bound_by": b_km[1], "library_ms": None, "shape": "2^23x64 f32, k=8",
         "variants": [{"shape": f"{name} f32 (streaming path)",
                       "max_abs_err": r["check"]["max_abs_err_sums_vs_plain"],
                       "ms": r["kernel"], "plain_ms": r["plain"], "bound_ms": r["bound"],
                       "bound_by": r["bound_by"], "library_ms": None}
                      for name, r in km_large.items()]},
        {"name": "flash_attention", "route": "cuda", "source": FWD_SOURCE,
         "replaces": "heat_tpu/core/pallas_kernels.py:348",
         "launches": (serve_launches["flash_attention"] + train_launches["flash_attention"]
                      + grid_launches["flash_attention"] + exec_launches["flash_attention"]
                      + fused_launches["flash_attention"]),
         "launches_by_path": {"serving": serve_launches["flash_attention"],
                              "training": train_launches["flash_attention"],
                              "grid_path": grid_launches["flash_attention"],
                              "serving_executor": exec_launches["flash_attention"],
                              "fused_steps": fused_launches["flash_attention"]},
         "max_abs_err": fl_checks["prefill_1x16x1024x64_bf16"]["max_abs_err"],
         "ms": fp["kernel"], "plain_ms": fp["plain"], "bound_ms": fp["bound"],
         "bound_by": fp["bound_by"], "library_ms": fp["sdpa"],
         "shape": "1x16x1024x64 bf16, causal (prefill)",
         "device_ms": fp["device_ms"], "host_ms": fp["host_ms"], "ms_is": fp["ms_is"],
         "variants": [
             {"shape": "8x16x1024x64 bf16, causal (logits forward)",
              "max_abs_err": fl_checks["logits_8x16x1024x64_bf16"]["max_abs_err"],
              "ms": fl["kernel"], "plain_ms": fl["plain"], "bound_ms": fl["bound"],
              "bound_by": fl["bound_by"], "library_ms": fl["sdpa"]}] + [
             {"source": FWD_SOURCE, "dtype": "float32",
              "shape": f"{shape} float32, causal",
              "max_abs_err": fl_checks[f"{key}_f32"]["max_abs_err"],
              "ms": t["f32"]["kernel"], "plain_ms": t["f32"]["plain"],
              "bound_ms": t["f32"]["bound"], "bound_by": t["f32"]["bound_by"],
              "library_ms": t["f32"]["sdpa"],
              **{x: t["f32"][x] for x in ("passes_per_product", "device_ms_by_kind",
                                          "split_pass_share", "device_ms", "host_ms", "ms_is")
                 if x in t["f32"]}}
             for key, shape, t in (("prefill_1x16x1024x64", "1x16x1024x64", fp),
                                   ("logits_8x16x1024x64", "8x16x1024x64", fl))] + [
             {"source": FWD_SOURCE, "dtype": "float16",
              "shape": f"{shape} float16, causal",
              "max_abs_err": fl_checks[f"{key}_f16"]["max_abs_err"],
              "ms": t["f16"]["kernel"], "plain_ms": t["f16"]["plain"],
              "bound_ms": t["f16"]["bound"], "bound_by": t["f16"]["bound_by"],
              "library_ms": t["f16"]["sdpa"],
              **{x: t["f16"][x] for x in ("device_ms", "host_ms", "ms_is") if x in t["f16"]}}
             for key, shape, t in (("prefill_1x16x1024x64", "1x16x1024x64", fp),
                                   ("logits_8x16x1024x64", "8x16x1024x64", fl))]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": DKV_SOURCE,
         "replaces": "heat_tpu/core/pallas_kernels.py:412",
         "launches": (train_launches["flash_bwd_dkv"] + grid_launches["flash_bwd_dkv"]
                      + exec_launches["flash_bwd_dkv"] + fused_launches["flash_bwd_dkv"]),
         "launches_by_path": {"training": train_launches["flash_bwd_dkv"],
                              "grid_path": grid_launches["flash_bwd_dkv"],
                              "serving_executor": exec_launches["flash_bwd_dkv"],
                              "fused_steps": fused_launches["flash_bwd_dkv"]},
         "max_abs_err": bwd["checks"][BWD_PATH_CASE]["dk_dv_max_abs_err"],
         "ms": bt["dkv"]["kernel"], "plain_ms": bt["dkv"]["plain"], "bound_ms": bt["dkv"]["bound"],
         "bound_by": bt["dkv"]["bound_by"], "library_ms": bt["aten_flash_backward_dq_dk_dv"],
         "library_covers": "dq, dk and dv together",
         "shape": "8x16x1024x64 bf16, causal (training step)",
         "variants": [{"source": DKV_SOURCE, "dtype": "float32",
                       "shape": "8x16x1024x64 float32, causal",
                       "max_abs_err": bwd["checks"]["train_8x16x1024x64_f32_causal"][
                           "dk_dv_max_abs_err"],
                       "ms": bt["dkv"]["f32"]["kernel"],
                       "plain_ms": bt["dkv"]["f32"]["plain"],
                       "bound_ms": bt["dkv"]["f32"]["bound"],
                       "bound_by": bt["dkv"]["f32"]["bound_by"],
                       "passes_per_product": bt["dkv"]["f32"]["passes_per_product"],
                       "device_ms_by_kind": bt["dkv"]["f32"]["device_ms_by_kind"],
                       "library_ms": bt["aten_efficient_backward_f32_dq_dk_dv"],
                       "library_covers": "dq, dk and dv together"},
                      {"source": DKV_SOURCE, "dtype": "float16",
                       "shape": "8x16x1024x64 float16, causal",
                       "max_abs_err": bwd["checks"]["train_8x16x1024x64_f16_causal"][
                           "dk_dv_max_abs_err"],
                       "ms": bt["dkv"]["f16"]["kernel"],
                       "plain_ms": bt["dkv"]["f16"]["plain"],
                       "bound_ms": bt["dkv"]["f16"]["bound"],
                       "bound_by": bt["dkv"]["f16"]["bound_by"],
                       "passes_per_split_product": F16_PASSES_SPLIT,
                       "library_ms": bt["aten_flash_backward_f16_dq_dk_dv"],
                       "library_covers": "dq, dk and dv together"}]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": DQ_SOURCE,
         "replaces": "heat_tpu/core/pallas_kernels.py:488",
         "launches": (train_launches["flash_bwd_dq"] + grid_launches["flash_bwd_dq"]
                      + exec_launches["flash_bwd_dq"] + fused_launches["flash_bwd_dq"]),
         "launches_by_path": {"training": train_launches["flash_bwd_dq"],
                              "grid_path": grid_launches["flash_bwd_dq"],
                              "serving_executor": exec_launches["flash_bwd_dq"],
                              "fused_steps": fused_launches["flash_bwd_dq"]},
         "max_abs_err": bwd["checks"][BWD_PATH_CASE]["dq_max_abs_err"],
         "ms": bt["dq"]["kernel"], "plain_ms": bt["dq"]["plain"], "bound_ms": bt["dq"]["bound"],
         "bound_by": bt["dq"]["bound_by"], "library_ms": bt["aten_flash_backward_dq_dk_dv"],
         "library_covers": "dq, dk and dv together",
         "shape": "8x16x1024x64 bf16, causal (training step)",
         "variants": [{"source": DQ_SOURCE, "dtype": "float32",
                       "shape": "8x16x1024x64 float32, causal",
                       "max_abs_err": bwd["checks"]["train_8x16x1024x64_f32_causal"][
                           "dq_max_abs_err"],
                       "ms": bt["dq"]["f32"]["kernel"],
                       "plain_ms": bt["dq"]["f32"]["plain"],
                       "bound_ms": bt["dq"]["f32"]["bound"],
                       "bound_by": bt["dq"]["f32"]["bound_by"],
                       "passes_per_product": bt["dq"]["f32"]["passes_per_product"],
                       "device_ms_by_kind": bt["dq"]["f32"]["device_ms_by_kind"],
                       "library_ms": bt["aten_efficient_backward_f32_dq_dk_dv"],
                       "library_covers": "dq, dk and dv together"},
                      {"source": DQ_SOURCE, "dtype": "float16",
                       "shape": "8x16x1024x64 float16, causal",
                       "max_abs_err": bwd["checks"]["train_8x16x1024x64_f16_causal"][
                           "dq_max_abs_err"],
                       "ms": bt["dq"]["f16"]["kernel"],
                       "plain_ms": bt["dq"]["f16"]["plain"],
                       "bound_ms": bt["dq"]["f16"]["bound"],
                       "bound_by": bt["dq"]["f16"]["bound_by"],
                       "passes_per_split_product": F16_PASSES_SPLIT,
                       "library_ms": bt["aten_flash_backward_f16_dq_dk_dv"],
                       "library_covers": "dq, dk and dv together"}]},
        {"name": "probe", "route": "cuda", "source": "heat_tpu_torch/csrc/probe.cu",
         "replaces": "heat_tpu/core/pallas_kernels.py:85",
         "launches": serve_launches["probe"] + exec_launches["probe"],
         "launches_by_path": {"serving": serve_launches["probe"],
                              "serving_executor": exec_launches["probe"]},
         "max_abs_err": 0.0, "ms": ms_probe, "plain_ms": plain_probe, "bound_ms": b_probe[0],
         "bound_by": b_probe[1], "library_ms": lib_probe, "shape": "8x128 f32",
         "host_ms": host["probe_8x128_f32"]["wrapper"] / 1e3,
         "host_us_per_call": host["probe_8x128_f32"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
