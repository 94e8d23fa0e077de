"""One spawned gloo world of the port for a test module, and the packing of
results that the world-p and heat_tpu sides are compared by.

A module hands :func:`start_world` its case table (name -> expression), its
inputs and the source of the functions its expressions need (at least a
``_build_env(lib, spec)`` returning the evaluation namespace with ``lib``
bound to the port); every rank evaluates every case with ``comm.stats``
reset before it and read after it, and rank 0 writes ``(packed result,
{collective: calls})`` per case. The ranks run while the module's
in-process tests do; :func:`finish_world` collects them.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r'''
import os, pickle, sys, traceback
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
import heat_tpu_torch as ht

world, port, spec_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
pids = []
for rank in range(world):
    pid = os.fork()
    if pid == 0:
        break
    pids.append(pid)
else:
    codes = [os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) for pid in pids]
    sys.exit(1 if any(codes) else 0)
code = 1
try:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    ht.use_device("cpu")
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    exec(spec["src"])
    comm = ht.get_comm()
    res = {}
    for name, expr in spec["cases"].items():
        env = _build_env(ht, spec)
        comm.reset_stats()
        r = eval(expr, env)
        stats = {k: v["calls"] for k, v in comm.stats.items()}
        res[name] = (pack(r), stats)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()
    code = 0
except BaseException:
    traceback.print_exc()
finally:
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
'''


def pack(x):
    """A result as plain data: a DNDarray of either package as its values
    (float32 for bfloat16), type name, gshape, split and lshape_map; tuples
    and lists element by element; tensors and scalars as numpy values."""
    if hasattr(x, "gshape") and hasattr(x, "lshape_map"):
        values = np.asarray(x.numpy())
        if values.dtype.name == "bfloat16":
            values = values.astype(np.float32)
        return {"values": values, "dtype": x.dtype.__name__, "gshape": tuple(x.gshape),
                "split": x.split, "lshape_map": np.asarray(x.lshape_map)}
    if isinstance(x, (tuple, list)):
        return tuple(pack(v) for v in x)
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(tmp, spec, world, funcs):
    """Start the worker on ``world`` gloo ranks; ``funcs`` are the functions
    whose source the cases need (``_build_env`` among them). One process
    imports torch and the port once and forks the ranks, each of which
    joins the gloo world."""
    import inspect

    src = "\n".join(inspect.getsource(f) for f in (pack,) + tuple(funcs))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(dict(spec, src=src), f)
    (tmp / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(world), port,
                             str(tmp / "spec.pkl"), str(tmp / "out.pkl")],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    return tmp, [proc]


def _kill_session(proc):
    """Kill a process started in a session of its own and the children it
    forked, unless it has been reaped (it waits for its children)."""
    import signal

    if proc.returncode is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def stop_world(started):
    for p in started[1]:
        _kill_session(p)


def finish_world(started, timeout=240):
    """The ranks' results; a rank that dies or hangs fails the caller."""
    tmp, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        stop_world(started)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


_REF_WORKER = r"""
import os, pickle, sys, traceback
sys.path.insert(0, sys.argv[1])
T = __import__(sys.argv[2])
with open(sys.argv[3], "rb") as f:
    jobs = pickle.load(f)


def run(comm_name, names, out):
    res = {name: T._heat_tpu(name, getattr(T, comm_name)) for name in names}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if not hasattr(T, "_preload"):
    for job in jobs:
        run(*job)
    sys.exit(0)
T._preload()
pids = []
for job in jobs:
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            run(*job)
            code = 0
        except BaseException:
            traceback.print_exc()
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
    pids.append(pid)
codes = [os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) for pid in pids]
sys.exit(1 if any(codes) else 0)
"""


def start_refs(tmp, module, jobs):
    """heat_tpu's results, computed beside the module's tests (jax's tracing
    holds the GIL, and heat_tpu's random state is global to a process):
    ``jobs`` is a list of ``(comm name, case names)``, each a process of
    its own that calls the module's ``_heat_tpu(name, comm)`` case by case.
    A module with a ``_preload()`` (its imports of jax and heat_tpu, which
    start no jax backend) runs it once in one process, which then forks
    the jobs; a module without one (its import may start a backend, and a
    process must not fork after that) gets a fresh process a job."""
    import importlib

    (tmp / "refs.py").write_text(_REF_WORKER)
    outs = [(comm_name, str(tmp / f"refs{k}.pkl"), list(names))
            for k, (comm_name, names) in enumerate(jobs)]
    groups = [outs] if hasattr(importlib.import_module(module), "_preload") else \
        [[o] for o in outs]
    procs = []
    for k, group in enumerate(groups):
        with open(tmp / f"jobs{k}.pkl", "wb") as f:
            pickle.dump([(c, names, out) for c, out, names in group], f)
        proc = subprocess.Popen(
            [sys.executable, str(tmp / "refs.py"), str(REPO / "tests"), module,
             str(tmp / f"jobs{k}.pkl")], cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        procs.append((proc, [(c, out) for c, out, _ in group]))
    return {"procs": procs}


def reference(refs, comm_name, name, timeout=400):
    """One reference result; the first call waits for all jobs."""
    if "results" not in refs:
        got = {}
        try:
            for proc, outs in refs["procs"]:
                log = proc.communicate(timeout=timeout)[0]
                assert proc.returncode == 0, log
                for cname, out in outs:
                    with open(out, "rb") as f:
                        got.update({(cname, k): v for k, v in pickle.load(f).items()})
        finally:
            stop_refs(refs)
        refs["results"] = got
    return refs["results"][comm_name, name]


def stop_refs(refs):
    for proc, _ in refs["procs"]:
        _kill_session(proc)
