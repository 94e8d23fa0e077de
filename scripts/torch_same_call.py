#!/usr/bin/env python3
"""Time the heat_tpu_torch of one checkout on one CUDA card, to compare
checkouts in one call.

    python3 scripts/torch_same_call.py DIR

imports ``heat_tpu_torch`` from checkout ``DIR`` and prints one JSON line:
the times of the flash backward pair in float32, bf16 and float16 at the
training shape (8 x 16 heads of 64, 1024 rows, causal), the forward there
in each, the float32 forward's device time by kind (its split pass, where
it has one, and its kernel), ``kmeans_step`` at ``chip_smoke.py``'s three
phase-4 shapes (2^23 x 64, k = 8; 2^20 x 64, k = 128; 2^17 x 1024, k = 64),
``cdist_tile`` at its two (2^23 x 64 against 8 centroids, 40,000^2 x 18),
the host µs a call of both wrappers at a small shape, the Lloyd iterations
per second of phase 5 (20 steps from k-means++ centroids), a digest of each
``cdist_tile`` output (the sum of its float32 bit patterns, to show two
checkouts give the same bits), and the device time by kind of one float32
``loss_and_grad_fn`` of the flagship model, all with ``chip_smoke.py``'s
timers and shapes. Run it for two checkouts in turns (parent, change,
change, parent) within one call: times on one card are only comparable
within one call.
"""

import os
import subprocess
import sys

import numpy as np


def main(root):
    import torch

    if not torch.cuda.is_available():
        print("torch_same_call: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(root))
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import _build
    from heat_tpu_torch.core import kernels as tk
    from heat_tpu_torch.nn import TransformerLM, TransformerLMConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    H, DH = cs.FLAGSHIP["n_heads"], cs.FLAGSHIP["d_model"] // cs.FLAGSHIP["n_heads"]
    res = {"root": root, "port": os.path.dirname(ht.__file__), "card": smi, "ms": {}}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, dout = (torch.randn(8, H, 1024, DH, device=dev, generator=gen).to(dt)
                         for _ in range(4))
        out, lse = tk.flash_attention(q, k, v, causal=True, return_lse=True)
        dmb = tk._dmb(out, dout, None)
        name = str(dt).split(".")[-1]
        res["ms"][f"flash_bwd_dkv_{name}"] = cs.time_ms(
            torch, lambda: tk.flash_bwd_dkv(q, k, v, dout, lse, dmb, causal=True))
        res["ms"][f"flash_bwd_dq_{name}"] = cs.time_ms(
            torch, lambda: tk.flash_bwd_dq(q, k, v, dout, lse, dmb, causal=True))
        res["ms"][f"flash_attention_{name}"] = cs.time_ms(
            torch, lambda: tk.flash_attention(q, k, v, causal=True))
        if dt == torch.float32:
            res["flash_attention_float32_device_ms_by_kind"] = cs.device_share(
                torch, lambda: tk.flash_attention(q, k, v, causal=True), 20,
                kinds=cs.F32_FWD_KINDS).get("device_ms_per_call_by_kind")
        del q, k, v, dout, out, lse, dmb
    x = torch.rand(cs.N_POINTS, cs.N_FEATURES, device=dev, generator=gen)
    c = x[torch.randint(0, cs.N_POINTS, (cs.K,), device=dev, generator=gen)].clone()
    y = torch.rand(cs.CDIST_N, cs.CDIST_D, device=dev, generator=gen)
    res["ms"]["kmeans_step_2^23x64_k8"] = cs.time_ms(torch, lambda: tk.kmeans_step(x, c))
    res["digest"] = {}
    for name, a, b in (("cdist_tile_2^23x64_vs_8", x, c), ("cdist_tile_40000x40000x18", y, y)):
        res["ms"][name] = cs.time_ms(torch, lambda: tk.cdist_tile(a, b))
        res["digest"][name] = int(tk.cdist_tile(a, b).view(torch.int32).sum(dtype=torch.int64))
    del x, c, y
    torch.cuda.empty_cache()
    for name, n, d, k in (("2^20x64_k128", 2**20, 64, 128), ("2^17x1024_k64", 2**17, 1024, 64)):
        xl = torch.rand(n, d, device=dev, generator=gen)
        cl = xl[torch.randint(0, n, (k,), device=dev, generator=gen)].clone()
        res["ms"][f"kmeans_step_{name}"] = cs.time_ms(torch, lambda: tk.kmeans_step(xl, cl))
        del xl, cl
    xs = torch.rand(4096, 64, device=dev, generator=gen)
    res["host_us_per_call"] = {
        "kmeans_step_4096x64_k8": cs.host_us(torch, lambda: tk.kmeans_step(xs, xs[:8])),
        "cdist_tile_4096x64_vs_8": cs.host_us(torch, lambda: tk.cdist_tile(xs, xs[:8]))}
    # phase 5's Lloyd iterations per second: 20 steps from k-means++ centroids
    ht.random.seed(0)
    X = ht.random.rand(cs.N_POINTS, cs.N_FEATURES, split=0)
    seeded = ht.cluster.KMeans(n_clusters=cs.K, init="kmeans++", random_state=0)
    seeded._initialize_cluster_centers(X)
    c0 = seeded.cluster_centers_.larray.clone()
    lloyd = ht.cluster.KMeans(n_clusters=cs.K, max_iter=cs.ITERS, tol=-1)
    step = lloyd._lloyd_step(ht.get_comm(), 0)
    lloyd._run_lloyd(step, X.larray, c0.clone())  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lloyd._run_lloyd(step, X.larray, c0.clone())
    end.record()
    end.synchronize()
    res["kmeans_lloyd_iterations_per_second"] = cs.ITERS / (start.elapsed_time(end) / 1e3)
    del X, seeded, lloyd, step, c0, xs
    torch.cuda.empty_cache()
    grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
    model32 = TransformerLM(grid, TransformerLMConfig(**cs.FLAGSHIP))
    params = model32.init(0, dtype=torch.float32)
    toks = model32.shard_batch(np.random.default_rng(0).integers(
        0, cs.FLAGSHIP["vocab"], cs.TRAIN_BATCH).astype(np.int32))
    lg32 = model32.loss_and_grad_fn()
    res["f32_loss_and_grad_profiled"] = cs.device_share(torch, lambda: lg32(params, toks), 2,
                                                        kinds=cs.TRAIN_KINDS)
    cs.emit(res)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
