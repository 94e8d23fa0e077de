"""Profiler traces of the graphed Lloyd step on a card: whether a
`utils.profiling` trace records the kernels of a CUDA graph's replays.

Fits KMeans at 2^23 x 64 float32, k = 8 (`chip_smoke.py`'s KMeans cell)
with its Lloyd steps as CUDA graphs, then prints, for 6 trials of 2 and of 20
replayed steps, the `kmeans_reduce_kernel` events of the trace (one a
`kmeans_step` launch), all kernel events and `cudaGraphLaunch` calls; then
the same for 4 steps of a fresh program that warms up and captures inside
the trace window, and for 2 eager steps. Needs one CUDA card; run from the
root of the repository: `python scripts/torch_lloyd_trace_probe.py`.
"""
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import fusion, kernels as tk  # noqa: E402

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
ht.random.seed(0)
X = ht.random.rand(cs.N_POINTS, cs.N_FEATURES, split=0)
init = ht.array(X.larray[:: cs.N_POINTS // cs.K][:cs.K].clone(), split=None)
km = ht.cluster.KMeans(n_clusters=cs.K, init=init, max_iter=cs.ITERS, tol=-1).fit(X)
step = km._lloyd_step(X.comm, 0)
torch.cuda.synchronize()
res = []
for trial in range(6):
    for n in (2, 20):
        c = [init.larray.clone()]

        def run():
            for _ in range(n):
                c[0], _, _ = step(X.larray, c[0])

        tk.reset_launches()
        seen, _, tot = cs.traced_kernels(torch, run)
        res.append({"trial": trial, "steps": n, "kmeans": seen["kmeans_step"], **tot,
                    "counted": tk.launches["kmeans_step"]})
        print(res[-1], flush=True)
# in-window capture: a fresh program warmed up, captured and replayed in the trace
fusion.reset()
step2 = km._lloyd_step(X.comm, 0)
c = [init.larray.clone()]


def run4():
    for _ in range(4):
        c[0], _, _ = step2(X.larray, c[0])


tk.reset_launches()
seen, _, tot = cs.traced_kernels(torch, run4)
print("in_window", seen["kmeans_step"], tot, tk.launches["kmeans_step"], flush=True)
# the eager step, no graph
with fusion.fit_override(False):
    step3 = km._lloyd_step(X.comm, 0)
c = [init.larray.clone()]


def run_e():
    for _ in range(2):
        c[0], _, _ = step3(X.larray, c[0])


seen, _, tot = cs.traced_kernels(torch, run_e)
print("eager", seen["kmeans_step"], tot, flush=True)
