"""The case table of ``test_torch_dp.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu. The data: 32 rows of 8 features and labels of 4
classes (``X``, ``Y``), an MLP of ``Dense(16)``, ReLU, ``Dense(4)`` with
initial weights drawn here and carried into both packages (flax's
``{"params": {"Dense_i": {"kernel", "bias"}}}`` layout, which
``dense_stack_state_from_numpy`` loads into the torch module), and DASO's
diverged parameters (``W``, ``B``: node ``d``'s replica shifted by
``0.25 d``).
"""

import numpy as np

STEPS = 5
LR = 0.5
WORLD = 4
REF = "REF"  # the reference jobs' communicator name


def _spec():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, 4))
    x = rng.normal(size=(32, 8)).astype(np.float32)
    init = {"params": {
        "Dense_0": {"kernel": (rng.normal(size=(8, 16)) / 8 ** 0.5).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=16)).astype(np.float32)},
        "Dense_1": {"kernel": (rng.normal(size=(16, 4)) / 4.0).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=4)).astype(np.float32)}}}
    return {"X": x, "Y": np.argmax(x @ w, axis=1).astype(np.int32), "INIT": init,
            "W": np.ones((4, 3), np.float32), "B": np.zeros((3,), np.float32),
            "STEPS": STEPS, "LR": LR}


def _build_env(lib, spec):
    """The port's side: ``dp_case(name)``, ``multi_case()`` and
    ``daso_case(name)``, bound to ``lib``, the port."""
    import torch

    from heat_tpu_torch.utils.convert import dense_stack_state_from_numpy

    comm = lib.get_comm()
    r, n = comm.rank, comm.size
    steps, lr = spec["STEPS"], spec["LR"]

    def mlp():
        net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
        net.load_state_dict(dense_stack_state_from_numpy(spec["INIT"], net))
        return net

    def rows(a, parts=n, i=None):
        i = r if i is None else i
        b = a.shape[0] // parts
        return torch.as_tensor(a[i * b:(i + 1) * b])

    def state(net):
        return {k: v.detach().numpy() for k, v in net.state_dict().items()}

    def dp_case(name):
        net = mlp()
        opt = lib.optim.DataParallelOptimizer(lib.optim.SGD(lr))
        if name == "dp_packed":
            trainer = lib.nn.DataParallel(net, optimizer=opt)
            x, y = lib.array(spec["X"], split=0), lib.array(spec["Y"], split=0)
        else:  # a summed loss: the exact per-parameter form
            def loss_fn(logits, y):
                return lib.nn.F.cross_entropy(logits, y) * logits.shape[0]

            trainer = lib.nn.DataParallel(net, optimizer=opt, loss_fn=loss_fn)
            x, y = rows(spec["X"]), rows(spec["Y"])
        trainer.init(x)
        comm.reset_stats()
        losses = [trainer.step(x, y) for _ in range(steps)]
        counts = {k: v["calls"] for k, v in comm.stats.items()}
        out = trainer(x)
        return {"losses": losses, "state": state(net), "counts": counts,
                "out_split": getattr(out, "split", None)}

    def multi_case():
        daso = lib.optim.DASO(lib.optim.SGD(0.05), total_epochs=3, local_size=2,
                              warmup_epochs=1, cooldown_epochs=1)
        net = mlp()
        trainer = lib.nn.DataParallelMultiGPU(net, daso)
        x, y = rows(spec["X"]), rows(spec["Y"])
        trainer.init(x)
        daso.grid.reset_stats()
        losses = []
        dcn = daso.grid.axis("dcn")
        for _ in range(steps):
            node = trainer.step(x, y)
            losses.append(node)
        counts = daso.grid.stats()
        # the mean of the nodes' losses (heat_tpu's return value) and both
        # nodes' replicas, for the comparison
        mean = [float(v) / daso.slow_size for v in
                dcn.Allreduce(torch.tensor(losses, dtype=torch.float64))]
        reps = {k: dcn.Allgather(v.detach()[None], axis=0).numpy()
                for k, v in net.state_dict().items()}
        return {"losses": mean, "replicas": reps, "counts": counts}

    def daso_case(name):
        daso = lib.optim.DASO(lib.optim.SGD(0.1), total_epochs=4, local_size=2)
        d = daso.grid.coord("dcn")
        params = daso.replicate({"w": torch.as_tensor(spec["W"]) + 0.25 * d,
                                 "b": torch.as_tensor(spec["B"]) + 0.25 * d})
        daso.grid.reset_stats()
        seen = []
        if name == "daso_sync":
            daso._global_sync(params)
            seen.append({k: v.clone() for k, v in params.items()})
        else:  # the delayed schedule: skip 2, wait 1, three batches
            daso.global_skip, daso.batches_to_wait = 2, 1
            for _ in range(3):
                daso.step(params)
                seen.append({k: v.clone() for k, v in params.items()})
        counts = daso.grid.stats()
        dcn = daso.grid.axis("dcn")
        gathered = [{k: dcn.Allgather(v[None], axis=0).numpy() for k, v in s.items()}
                    for s in seen]
        return {"params": gathered, "counts": counts, "slow": daso.slow_size,
                "fast": daso.fast_size}

    return {"dp_case": dp_case, "multi_case": multi_case, "daso_case": daso_case}


def _preload():
    """flax, optax and heat_tpu, imported once before the reference jobs
    fork (no backend is started)."""
    import os

    # the suite's 8-device CPU mesh (tests/conftest.py) when run on its own
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import flax.linen  # noqa: F401
    import optax  # noqa: F401

    import heat_tpu  # noqa: F401


def _heat_tpu(case, comm):
    """heat_tpu's result of ``case`` on the first four CPU devices."""
    _preload()
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    import heat_tpu as hj
    from heat_tpu.core.communication import TPUCommunication

    spec = _spec()
    world = TPUCommunication(jax.devices()[:WORLD])

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(fnn.Dense(16)(x))
            return fnn.Dense(4)(x)

    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    init = jax.tree.map(jnp.asarray, spec["INIT"])
    if case in ("dp_packed", "dp_exact"):
        opt = hj.optim.DataParallelOptimizer(optax.sgd(LR))
        if case == "dp_packed":
            net = hj.nn.DataParallel(MLP(), comm=world, optimizer=opt)
        else:
            def loss_fn(logits, y):
                return hj.nn.functional.cross_entropy(logits, y) * logits.shape[0]

            net = hj.nn.DataParallel(MLP(), comm=world, optimizer=opt, loss_fn=loss_fn)
        x = hj.array(spec["X"], split=0, comm=world)
        y = hj.array(spec["Y"], split=0, comm=world)
        net.init(x)
        net.params = init
        opt.reset_state(init)
        losses = [net.step(x, y) for _ in range(STEPS)]
        return {"losses": losses, "params": host(net.params)}
    if case == "multi":
        daso = hj.optim.DASO(optax.sgd(0.05), total_epochs=3, comm=world, local_size=2,
                             warmup_epochs=1, cooldown_epochs=1)
        net = hj.nn.DataParallelMultiGPU(MLP(), daso, comm=world)
        net.init(jnp.asarray(spec["X"][:1]))
        net.params = daso.replicate(init)
        net.optimizer.opt_state = jax.vmap(net.optimizer.tx.init)(net.params)
        losses = [net.step(spec["X"], spec["Y"]) for _ in range(STEPS)]
        return {"losses": losses, "params": host(net.params)}
    daso = hj.optim.DASO(optax.sgd(0.1), total_epochs=4, comm=world, local_size=2)
    rep = daso.replicate({"w": jnp.asarray(spec["W"]), "b": jnp.asarray(spec["B"])})
    slow = daso.slow_size

    def shift(p):
        return p + (jnp.arange(slow, dtype=jnp.float32) * 0.25).reshape(
            (slow,) + (1,) * (p.ndim - 1))

    params = jax.tree.map(shift, rep)
    seen = []
    if case == "daso_sync":
        seen.append(host(daso._global_sync(params)))
    else:
        daso.global_skip, daso.batches_to_wait = 2, 1
        for _ in range(3):
            params = daso.step(params)
            seen.append(host(params))
    return {"params": seen}
