"""The case table of ``test_torch_parallel.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu, so the processes computing heat_tpu's references start
quickly. A grid case trains the tiny transformer (``TINY``) on one grid of
the ``("dp", "pp", "tp", "sp")`` axes from ``init(0)`` float32 masters on
the ``(4, 16)`` token batch ``TOKS``: the loss and every gradient leaf of
one ``loss_and_grad_fn`` call, the logits, and three ``make_train_step``
steps of SGD(0.5) (their losses and the parameters after them). The
``parts`` cases hold each ``nn/parallel`` function and the public attention
entry points alone, values and gradients, on a grid of their own.
"""

import numpy as np

TINY = dict(vocab=32, d_model=16, n_heads=4, n_layers=2, d_ff=32)
AXES = ("dp", "pp", "tp", "sp")
LR = 0.5
STEPS = 3

# name -> (grid shape, config overrides); the world is the grid's size
GRIDS = {
    "w1_moe_micro2_remat": ((1, 1, 1, 1), dict(moe_experts=4, n_micro=2, remat=True)),
    "w2_moe_dp2": ((2, 1, 1, 1), dict(moe_experts=4)),
    "w2_ulysses_sp2": ((1, 1, 1, 2), dict(attn_schedule="ulysses")),
    "w2_pp2_micro1": ((1, 2, 1, 1), dict()),
    "ring_sp4": ((1, 1, 1, 4), dict()),
    "zigzag_sp4": ((1, 1, 1, 4), dict(attn_schedule="zigzag")),
    "ulysses_sp4": ((1, 1, 1, 4), dict(attn_schedule="ulysses")),
    "dense_dp4": ((4, 1, 1, 1), dict()),
    "moe_dp4": ((4, 1, 1, 1), dict(moe_experts=4)),
    "pp2_tp2_micro2": ((1, 2, 2, 1), dict(n_micro=2)),
    "pp2_tp2_micro2_remat": ((1, 2, 2, 1), dict(n_micro=2, remat=True)),
    "moe_dp2_tp2": ((2, 1, 2, 1), dict(moe_experts=4)),
    "tp2_sp2": ((1, 1, 2, 2), dict()),
    "tp2_sp2_remat": ((1, 1, 2, 2), dict(remat=True)),
}

# the world-4 remat grids are held against heat_tpu's run of the same grid
# without remat (jax.checkpoint recomputes the same arithmetic); heat_tpu's
# own remat is held by the world-1 case
REF_OF = {"pp2_tp2_micro2_remat": "pp2_tp2_micro2", "tp2_sp2_remat": "tp2_sp2"}

# packed grids whose heat_tpu train step is audited for its all-reduces
AUDITED = ("dense_dp4",)

# the function-alone cases, world 4: name -> the grid they run on
PARTS = {
    "tp_mlp": (1, 1, 4, 1),
    "tp_attention": (1, 1, 4, 1),
    "column_gather": (1, 1, 4, 1),
    "switch_moe": (4, 1, 1, 1),
    "pipeline_micro2": (1, 4, 1, 1),
    "ring_attention": (1, 1, 1, 4),
    "ring_attention_noncausal": (1, 1, 1, 4),
    "zigzag_attention": (1, 1, 1, 4),
    "ulysses_attention": (1, 1, 1, 4),
    "generate_dp2_tp2": (2, 1, 2, 1),
}


def world_of(name):
    shape = GRIDS[name][0] if name in GRIDS else PARTS[name]
    return int(np.prod(shape))


def _spec():
    rng = np.random.default_rng(0)
    prng = np.random.default_rng(5)
    return {
        "TOKS": rng.integers(0, TINY["vocab"], (4, 16)),
        # the parts cases' inputs
        "X": prng.standard_normal((6, 8)).astype(np.float32),
        "WUP": (0.3 * prng.standard_normal((8, 16))).astype(np.float32),
        "WDOWN": (0.3 * prng.standard_normal((16, 8))).astype(np.float32),
        "WQKV": (0.3 * prng.standard_normal((8, 3 * 4 * 2))).astype(np.float32),
        "WPROJ": (0.3 * prng.standard_normal((4 * 2, 8))).astype(np.float32),
        "DOUT": prng.standard_normal((6, 8)).astype(np.float32),
        "MX": prng.standard_normal((4 * 10, 8)).astype(np.float32),   # 10 tokens a rank
        "ROUTER": prng.standard_normal((8, 4)).astype(np.float32),
        "EUP": (0.3 * prng.standard_normal((4, 8, 12))).astype(np.float32),
        "EDOWN": (0.3 * prng.standard_normal((4, 12, 8))).astype(np.float32),
        "MDOUT": prng.standard_normal((4 * 10, 8)).astype(np.float32),
        "PX": prng.standard_normal((2, 3, 8)).astype(np.float32),     # (n_micro, mb, D)
        "PW": (0.5 * prng.standard_normal((4, 8, 8))).astype(np.float32),
        "PDOUT": prng.standard_normal((2, 3, 8)).astype(np.float32),
        "Q": prng.standard_normal((2, 16, 4, 8)).astype(np.float32),  # (B, S, H, D)
        "K": prng.standard_normal((2, 16, 4, 8)).astype(np.float32),
        "V": prng.standard_normal((2, 16, 4, 8)).astype(np.float32),
        "ADOUT": prng.standard_normal((2, 16, 4, 8)).astype(np.float32),
        "GRIDS": GRIDS, "PARTS": PARTS, "TINY": TINY, "AXES": AXES, "LR": LR, "STEPS": STEPS,
    }


def _build_env(lib, spec):
    """The port's side: ``grid_case(name)`` and ``part_case(name)`` bound to
    ``lib``, the port."""
    import torch

    from heat_tpu_torch.core.tree import tree_flatten
    from heat_tpu_torch.nn import parallel as par
    from heat_tpu_torch.nn.attention import ring_attention, ulysses_attention
    from heat_tpu_torch.utils.convert import transformer_tree_to_numpy

    GRIDS, PARTS, TINY, AXES = spec["GRIDS"], spec["PARTS"], spec["TINY"], spec["AXES"]
    LR, STEPS = spec["LR"], spec["STEPS"]

    def grid_case(name):
        shape, over = GRIDS[name]
        grid = lib.MeshGrid(shape, AXES, device="cpu")
        model = lib.nn.TransformerLM(grid, lib.nn.TransformerLMConfig(**TINY, **over))
        toks = model.shard_batch(spec["TOKS"])
        params = model.init(0, dtype=torch.float32)
        grid.reset_stats()
        loss, grads = model.loss_and_grad_fn()(params, toks)
        lg_counts = grid.stats()
        grads = transformer_tree_to_numpy(grads, model)
        logits = model.logits_fn()(params, toks)
        tx = lib.optim.SGD(LR)
        opt = tx.init(params)
        step = model.make_train_step(tx)
        losses = []
        for i in range(STEPS):
            grid.reset_stats()
            params, opt, l = step(params, opt, toks)
            losses.append(float(l))
        step_counts = grid.stats()
        return {"loss": float(loss), "grads": grads, "logits": logits.numpy(),
                "losses": losses, "params": transformer_tree_to_numpy(params, model),
                "counts": {"loss_and_grad": lg_counts, "step": step_counts},
                "groups_created": grid.groups_created}

    def grads_of(fn, *inputs, dout):
        live = [torch.tensor(a, requires_grad=True) for a in inputs]
        out = fn(*live)
        g = torch.autograd.grad(out, live, torch.as_tensor(dout))
        return out.detach().numpy(), [x.numpy() for x in g]

    def part_case(name):
        grid = lib.MeshGrid(PARTS[name], AXES, device="cpu")
        dp, pp, tp, sp = (grid.axis(a) for a in AXES)
        grid.reset_stats()
        if name == "generate_dp2_tp2":
            # greedy decode of 6 tokens after the batch's first 5, serving
            # weights (float32 compute)
            model = lib.nn.TransformerLM(grid, lib.nn.TransformerLMConfig(**TINY))
            out = model.generate(model.init(0), spec["TOKS"][:, :5], 6)
            return {"out": out.numpy(), "grads": [], "counts": grid.stats()}
        if name in ("tp_mlp", "tp_attention", "column_gather"):
            n, r = tp.size, tp.rank
            up = spec["WUP"][:, r * 4:(r + 1) * 4]
            down = spec["WDOWN"][r * 4:(r + 1) * 4]
            if name == "tp_mlp":
                out = grads_of(lambda x, u, d: par.tp_mlp(x, u, d, axis=tp),
                               spec["X"], up, down, dout=spec["DOUT"])
            elif name == "column_gather":
                out = grads_of(lambda x, u: par.column_parallel_dense(
                    x, u, axis=tp, gather_output=True), spec["X"], up,
                    dout=spec["DOUT"] @ spec["WDOWN"].T)
            else:
                cols = spec["WQKV"].reshape(8, 3, 4, 2)[:, :, r].reshape(8, -1)
                rows = spec["WPROJ"].reshape(4, 2, 8)[r].reshape(2, 8)

                def att(x, wq, wp):
                    q, k, v = par.tp_attention_qkv(x, wq, 1, axis=tp)
                    a = torch.softmax(torch.einsum("shd,thd->hst", q, k), -1)
                    o = torch.einsum("hst,thd->shd", a, v)
                    return par.tp_attention_out(o, wp, axis=tp)

                out = grads_of(att, spec["X"], cols, rows, dout=spec["DOUT"])
        elif name == "switch_moe":
            r = dp.rank
            rows = slice(r * 10, (r + 1) * 10)
            out = grads_of(lambda x, w, u, d: par.switch_moe(x, w, u, d, axis=dp),
                           spec["MX"][rows], spec["ROUTER"], spec["EUP"][r:r + 1],
                           spec["EDOWN"][r:r + 1], dout=spec["MDOUT"][rows])
            counts = grid.stats()
            # the replicated router's gradient: the sum of the ranks' parts,
            # as the transformer's data-axis reduction takes it
            out[1][1] = dp.Allreduce(torch.as_tensor(out[1][1])).numpy()
            return {"out": out[0], "grads": out[1], "counts": counts}
        elif name == "pipeline_micro2":
            def stage(w, x):
                return torch.tanh(x @ w)

            out = grads_of(lambda x, w: par.pipeline_apply(stage, w, x, axis=pp), spec["PX"],
                           spec["PW"][pp.rank], dout=spec["PDOUT"])
        else:
            s = 16 // sp.size
            blk = slice(sp.rank * s, (sp.rank + 1) * s)
            q, k, v, d = (spec[n][:, blk] for n in ("Q", "K", "V", "ADOUT"))
            if name == "ulysses_attention":
                def fn(q, k, v):
                    return ulysses_attention(q, k, v, comm=sp, causal=True)
            else:
                causal = name != "ring_attention_noncausal"
                sched = "zigzag" if name == "zigzag_attention" else "ring"

                def fn(q, k, v):
                    return ring_attention(q, k, v, comm=sp, causal=causal, schedule=sched)

            out = grads_of(fn, q, k, v, dout=d)
        counts = grid.stats()
        vals, grads = out
        return {"out": vals, "grads": grads, "counts": counts}

    return {"grid_case": grid_case, "part_case": part_case, "ht": lib, "tree_flatten": tree_flatten}


def _preload():
    """jax, optax and the heat_tpu modules the references use, imported
    once before the reference jobs fork (no backend is started)."""
    import os

    # the suite's 8-device CPU mesh (tests/conftest.py) when run on its own
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import optax  # noqa: F401

    import heat_tpu.core._compat  # noqa: F401
    import heat_tpu.nn.attention  # noqa: F401
    import heat_tpu.nn.parallel  # noqa: F401
    import heat_tpu.nn.transformer  # noqa: F401
    import heat_tpu.utils.hlo_audit  # noqa: F401


def _heat_tpu(case, comm):
    """heat_tpu's result of ``case`` on as many CPU devices as its world
    (``comm`` names the reference job only): the same fields as the port's,
    gathered whole. The three steps are heat_tpu's
    ``make_train_step`` body (its ``loss_and_grad_fn``, then ``optax.sgd``'s
    update), run on the one compiled ``loss_and_grad_fn`` program; the
    ``AUDITED`` packed grids also report the all-reduces of
    ``make_train_step``'s compiled program
    (``hlo_audit.communicating_collective_stats``)."""
    _preload()
    import jax
    import optax

    import heat_tpu as hj
    from heat_tpu.nn.transformer import TransformerLM, TransformerLMConfig

    spec = _spec()
    devices = jax.devices()[:world_of(case)]
    if case in GRIDS:
        shape, over = GRIDS[case]
        grid = hj.MeshGrid(shape, AXES, devices=devices)
        model = TransformerLM(grid, TransformerLMConfig(**TINY, **over))
        toks = model.shard_batch(spec["TOKS"])
        lg = model.loss_and_grad_fn()
        params = model.init(0)
        loss, grads = lg(params, toks)
        logits = model.logits_fn()(params, toks)
        allreduce = None
        if case in AUDITED:
            from heat_tpu.utils import hlo_audit

            step = model.make_train_step(optax.sgd(LR))
            hlo = step.lower(params, optax.sgd(LR).init(params), toks).compile().as_text()
            allreduce = hlo_audit.communicating_collective_stats(hlo).get(
                "all-reduce", {}).get("count", 0)
        # the body of make_train_step, on the program loss_and_grad_fn compiled
        tx = optax.sgd(LR)
        opt = tx.init(params)

        @jax.jit
        def update(params, opt, g):
            updates, opt = tx.update(g, opt, params)
            return optax.apply_updates(params, updates), opt

        losses = []
        for _ in range(STEPS):
            l, g = lg(params, toks)
            params, opt = update(params, opt, g)
            losses.append(float(l))
        host = jax.tree.map(np.asarray, {"grads": grads, "params": params})
        return {"loss": float(loss), "grads": host["grads"], "logits": np.asarray(logits),
                "losses": losses, "params": host["params"], "step_all_reduces": allreduce}
    return _heat_tpu_part(case, devices, spec)


def _heat_tpu_part(case, devices, spec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from heat_tpu.core._compat import shard_map
    from heat_tpu.nn import parallel as par
    from heat_tpu.nn.attention import ring_attention, ulysses_attention

    def value_and_grads(fn, inputs, dout):
        def both(args, d):
            out, vjp = jax.vjp(fn, *args)
            return out, vjp(d)

        out, g = jax.jit(both)(tuple(jnp.asarray(a) for a in inputs), jnp.asarray(dout))
        return np.asarray(out), [np.asarray(x) for x in g]

    if case in ("tp_mlp", "tp_attention", "column_gather"):
        mesh = Mesh(np.asarray(devices), ("tp",))
        if case == "tp_mlp":
            fn = shard_map(lambda x, u, d: par.tp_mlp(x, u, d, axis="tp"), mesh=mesh,
                           in_specs=(P(), P(None, "tp"), P("tp", None)), out_specs=P())
            out, g = value_and_grads(fn, (spec["X"], spec["WUP"], spec["WDOWN"]),
                                     spec["DOUT"])
            return {"out": out, "grads": g}
        if case == "column_gather":
            # under shard_map's replication typing heat_tpu's gathered output
            # is tp-varying and cannot leave as replicated: the reference is
            # the unsharded product, whose value and gradients the gather
            # must give
            out, g = value_and_grads(lambda x, u: x @ u, (spec["X"], spec["WUP"]),
                                     spec["DOUT"] @ spec["WDOWN"].T)
            return {"out": out, "grads": g}

        def att(x, wq, wp):
            q, k, v = par.tp_attention_qkv(x, wq, 1)
            a = jax.nn.softmax(jnp.einsum("shd,thd->hst", q, k), -1)
            o = jnp.einsum("hst,thd->shd", a, v)
            return par.tp_attention_out(o, wp, axis="tp")

        # the columns of head h for q, k and v side by side, per device
        wq = spec["WQKV"].reshape(8, 3, 4, 2).transpose(0, 2, 1, 3).reshape(8, -1)
        fn = shard_map(att, mesh=mesh, in_specs=(P(), P(None, "tp"), P("tp", None)),
                       out_specs=P())
        out, g = value_and_grads(fn, (spec["X"], wq, spec["WPROJ"]), spec["DOUT"])
        g[1] = g[1].reshape(8, 4, 3, 2).transpose(0, 2, 1, 3).reshape(8, -1)
        return {"out": out, "grads": g}
    if case == "switch_moe":
        mesh = Mesh(np.asarray(devices), ("dp",))
        fn = shard_map(lambda x, w, u, d: par.switch_moe(x, w, u, d, axis="dp"), mesh=mesh,
                       in_specs=(P("dp"), P(), P("dp"), P("dp")), out_specs=P("dp"))
        out, g = value_and_grads(fn, (spec["MX"], spec["ROUTER"], spec["EUP"], spec["EDOWN"]),
                                 spec["MDOUT"])
        return {"out": out, "grads": g}
    if case == "generate_dp2_tp2":
        import heat_tpu as hj
        from heat_tpu.nn.transformer import TransformerLM, TransformerLMConfig

        grid = hj.MeshGrid(PARTS[case], AXES, devices=devices)
        model = TransformerLM(grid, TransformerLMConfig(**TINY))
        return {"out": np.asarray(model.generate(model.init(0), spec["TOKS"][:, :5], 6)),
                "grads": []}
    if case == "pipeline_micro2":
        mesh = Mesh(np.asarray(devices), ("pp",))

        def body(x, w):
            return par.pipeline_apply(lambda w, x: jnp.tanh(x @ w), w[0], x, axis="pp")

        fn = shard_map(body, mesh=mesh, in_specs=(P(), P("pp")), out_specs=P())
        out, g = value_and_grads(fn, (spec["PX"], spec["PW"]), spec["PDOUT"])
        return {"out": out, "grads": g}
    comm = hj_comm(devices)
    q, k, v = (jnp.asarray(spec[n]) for n in ("Q", "K", "V"))
    if case == "ulysses_attention":
        def fn(q, k, v):
            return ulysses_attention(q, k, v, comm=comm, causal=True)
    else:
        causal = case != "ring_attention_noncausal"
        sched = "zigzag" if case == "zigzag_attention" else "ring"

        def fn(q, k, v):
            return ring_attention(q, k, v, comm=comm, causal=causal, schedule=sched)

    out, g = value_and_grads(fn, (spec["Q"], spec["K"], spec["V"]), spec["ADOUT"])
    return {"out": out, "grads": g}


def hj_comm(devices):
    from heat_tpu.core.communication import TPUCommunication

    return TPUCommunication(devices)


REF = "REF"  # the reference jobs' communicator name
