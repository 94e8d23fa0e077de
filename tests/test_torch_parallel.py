"""The flagship transformer across a dp x pp x tp x sp grid, and the
``nn/parallel`` functions and attention entry points it is built of,
against heat_tpu on the same numpy inputs.

One spawned gloo world of 4 ranks and one of 2 run the cases of
``torch_parallel_cases.py`` (world-1 cases run in process), while heat_tpu
computes its references on 1, 2 and 4 CPU devices in processes of their own.
A grid case trains the tiny model (vocab 32, d_model 16, 4 heads, 2 layers,
d_ff 32) from ``init(0)`` float32 masters on a (4, 16) batch: the loss and
every gradient leaf of ``loss_and_grad_fn``, the logits, and three
``make_train_step`` steps of SGD(0.5), whose losses and final parameters
are held too. Grids: (1,1,1,4) with the ring, zigzag and Ulysses schedules;
(4,1,1,1) dense and with 4 experts; (1,2,2,1) with ``n_micro`` 2, remat off
and on; (2,1,2,1) with 4 experts; (1,1,2,2), remat off and on; at world 2
(2,1,1,1) with 4 experts, (1,1,1,2) Ulysses and (1,2,1,1) with one
microbatch for two stages; at world 1 experts with ``n_micro`` 2 and remat.
The world-4 remat grids are held against heat_tpu's run of the grid without
remat (``jax.checkpoint`` recomputes the same arithmetic); the world-1 case
holds the port's remat against heat_tpu's remat itself.

Tolerances: losses at rtol 1e-5; gradients, logits and parameters within
1e-5 of each leaf's largest magnitude (the same float32 products and sums,
taken in another order: heat_tpu's CPU rings are its dense online softmax,
the port's the flash kernels' plain versions folded by lse; measured below
5e-7). The experts' routing is an argmax: the world-1 MoE case checks that
every token's top two router probabilities differ by more than the 1e-5
tolerance at every layer and step (measured: 3.4e-5 at least), some 300
times the rounding differences of the probabilities (~1e-7), so no token
changes expert between the packages.

Collectives per ``loss_and_grad_fn`` call and per train step, by grid axis
(``grid.stats()``), are pinned in ``COUNTS``; subgroup creation is counted
apart (``grid.groups_created``). Packed grids (pp = tp = 1, dense) do
exactly ONE all-reduce a step, as heat_tpu's compiled step does (its HLO is
audited on two of them). With ``remat`` the backward recomputes each layer
and re-issues its collectives, and they are counted as they run:
``torch.utils.checkpoint`` stops recomputing a layer once it has every
tensor the backward needs, so the layer's last tp all-reduce (the MLP's,
whose backward needs nothing) is not re-issued.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
import torch_parallel_cases as C  # noqa: E402
from torch_world import (finish_world, pack, reference, start_refs, start_world,  # noqa: E402
                         stop_refs, stop_world)

F32 = 1e-5
W1 = [n for n in C.GRIDS if C.world_of(n) == 1]
W2 = [n for n in C.GRIDS if C.world_of(n) == 2]
W4 = [n for n in C.GRIDS if C.world_of(n) == 4]
PARTS = list(C.PARTS)

_PACKED = {"dp+sp": {"packed_all_reduce": 1}}
# per loss_and_grad_fn call and per train step (equal), L = 2 layers:
# sp ring: 2 (K, V) x (sp - 1) ring steps a layer forward, as many back;
# zigzag: the same, plus 2 + 2 layout permutes forward and 4 back; Ulysses:
# 4 all-to-alls a layer forward, 4 back; sp > 1: 1 permute of the targets;
# tp: 2 all-reduces a layer and microbatch forward, 2 back (3 with MoE:
# the expert inputs and the gates), remat 1 more (see the docstring); pp:
# n_micro + pp - 2 permute rounds forward and as many back, a broadcast
# each way; MoE over dp: 2 all-to-alls a layer forward, 2 back.
COUNTS = {
    "w1_moe_micro2_remat": {},
    "w2_moe_dp2": {"dp": {"all_to_all": 8}, **_PACKED},
    "w2_ulysses_sp2": {"sp": {"all_to_all": 16, "permute": 1}, **_PACKED},
    "w2_pp2_micro1": {"pp": {"permute": 2, "broadcast": 2}},
    "ring_sp4": {"sp": {"ring_step": 24, "permute": 1}, **_PACKED},
    "zigzag_sp4": {"sp": {"ring_step": 24, "permute": 9}, **_PACKED},
    "ulysses_sp4": {"sp": {"all_to_all": 16, "permute": 1}, **_PACKED},
    "dense_dp4": _PACKED,
    "moe_dp4": {"dp": {"all_to_all": 8}, **_PACKED},
    "pp2_tp2_micro2": {"pp": {"permute": 4, "broadcast": 2}, "tp": {"all_reduce": 8}},
    "pp2_tp2_micro2_remat": {"pp": {"permute": 4, "broadcast": 2}, "tp": {"all_reduce": 10}},
    "moe_dp2_tp2": {"dp": {"all_to_all": 8}, "tp": {"all_reduce": 10}, **_PACKED},
    "tp2_sp2": {"tp": {"all_reduce": 8}, "sp": {"ring_step": 8, "permute": 1}, **_PACKED},
    "tp2_sp2_remat": {"tp": {"all_reduce": 10}, "sp": {"ring_step": 12, "permute": 1},
                      **_PACKED},
}
# the parts alone, forward and backward once
PART_COUNTS = {
    "tp_mlp": {"tp": {"all_reduce": 2}},
    "tp_attention": {"tp": {"all_reduce": 2}},
    "column_gather": {"tp": {"all_gather": 1, "all_reduce": 1}},
    "switch_moe": {"dp": {"all_to_all": 4}},
    "pipeline_micro2": {"pp": {"permute": 8, "broadcast": 2}},  # T = 2 + 4 - 1 ticks
    "ring_attention": {"sp": {"ring_step": 12}},
    "ring_attention_noncausal": {"sp": {"ring_step": 12}},
    "zigzag_attention": {"sp": {"ring_step": 12, "permute": 16}},
    "ulysses_attention": {"sp": {"all_to_all": 8}},
    # prefill and 5 cached steps (the first token comes from the prefill),
    # 2 tp all-reduces a layer each, 2 layers; the dp all-gather of the rows
    "generate_dp2_tp2": {"tp": {"all_reduce": 24}, "dp": {"all_gather": 1}},
}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


_REFS: dict = {}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """heat_tpu's results in six jobs forked from one process (its own
    imports done once), started with the module; the in-process torch work
    of this module runs on one thread. The zigzag grid, the costliest
    reference, is a job of its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jobs = [["zigzag_sp4"],
            ["dense_dp4", "moe_dp4", "w2_ulysses_sp2"],
            ["ring_sp4", "tp2_sp2", "w2_pp2_micro1"],
            ["moe_dp2_tp2", "w2_moe_dp2", "pp2_tp2_micro2"],
            W1 + ["ulysses_sp4", "zigzag_attention", "generate_dp2_tp2"],
            [p for p in PARTS if p not in ("zigzag_attention", "generate_dp2_tp2")]]
    refs = start_refs(tmp_path_factory.mktemp("parallel_refs"), "torch_parallel_cases",
                      [("REF", names) for names in jobs])
    _REFS["refs"] = refs
    yield
    stop_refs(refs)
    _REFS.clear()
    torch.set_num_threads(threads)


def _expr(name):
    return f"grid_case({name!r})" if name in C.GRIDS else f"part_case({name!r})"


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    handles = {}
    for world, names in ((4, W4 + PARTS), (2, W2)):
        spec = dict(C._spec(), cases={n: _expr(n) for n in names})
        handles[world] = start_world(tmp_path_factory.mktemp(f"parallel_world{world}"), spec,
                                     world, (C._build_env,))
    yield handles
    for h in handles.values():
        stop_world(h)


@pytest.fixture(scope="module")
def worlds(started):
    return {world: finish_world(h, timeout=400) for world, h in started.items()}


@pytest.fixture(scope="module", autouse=True)
def _start_early(references, started):
    """The references and the spawned worlds start before the module's
    first test, whichever it is."""


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32 * scale, err_msg=what)


def _trees_close(got, want, what):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for path in w:
        _close(g[path], w[path], f"{what}{path}")


def _check_grid(got, want, name):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32)
    _trees_close(got["grads"], want["grads"], "grads")
    _close(got["logits"], want["logits"], "logits")
    _trees_close(got["params"], want["params"], "params")


def _groups(shape):
    """The subgroups a (dp, pp, tp, sp) grid creates: every line of each
    axis above 1 and below the world, then of dp x sp together."""
    world = int(np.prod(shape))
    sizes = list(shape) + [shape[0] * shape[3]]
    return sum(world // s for s in sizes if 1 < s < world)


def test_grid_config_checks():
    """heat_tpu's refusals: a schedule it does not know, experts that do
    not divide over dp, Ulysses with local heads not dividing over sp, a
    local batch that does not divide into the microbatches, and decoding on
    a grid with experts."""
    with pytest.raises(ValueError, match="attn_schedule"):
        ht.nn.TransformerLMConfig(**C.TINY, attn_schedule="spiral")
    grid = ht.MeshGrid((1, 1, 1, 1), C.AXES, device="cpu")
    model = ht.nn.TransformerLM(grid, ht.nn.TransformerLMConfig(**C.TINY, moe_experts=4,
                                                               n_micro=3))
    with pytest.raises(ValueError, match="n_micro"):
        model.loss_and_grad_fn()(model.init(0, dtype=torch.float32),
                                 model.shard_batch(C._spec()["TOKS"]))
    with pytest.raises(NotImplementedError, match="dense"):
        model.generate(model.init(0), C._spec()["TOKS"][:, :4], 2)
    cfg = ht.nn.TransformerLMConfig(**C.TINY)
    assert (cfg.capacity_factor, cfg.n_micro, cfg.attn_schedule, cfg.remat) == \
        (1.25, 1, "ring", False)


def test_grid_group_needs_grid_order():
    """A view over several axes numbers its ranks row-major over them, as
    its ``torch.distributed`` group does (ascending world rank) only when
    the axes are in the grid's order: another order, or an axis twice, is
    refused."""
    grid = ht.MeshGrid((1, 1, 1, 1), C.AXES, device="cpu")
    view = grid.group(("dp", "sp"))
    assert (view.size, view.rank, view.axis_name) == (1, 0, "dp+sp")
    for names in (("sp", "dp"), ("tp", "pp"), ("dp", "dp")):
        with pytest.raises(ValueError, match="grid's order"):
            grid.group(names)
    assert grid.groups_created == 0


def test_ring_attention_world1_is_one_flash_call():
    """At one rank every schedule is plain causal attention, and a split-1
    DNDarray comes back as one."""
    spec = C._spec()
    q, k, v = (torch.as_tensor(spec[n]) for n in ("Q", "K", "V"))
    want = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k) / 8 ** 0.5
                         + torch.full((16, 16), float("-inf")).triu(1), -1)
    want = torch.einsum("bhst,bthd->bshd", want, v)
    from heat_tpu_torch.nn.attention import ring_attention, ulysses_attention

    for sched in ("ring", "zigzag"):
        got = ring_attention(q, k, v, causal=True, schedule=sched)
        torch.testing.assert_close(got, want, rtol=F32, atol=F32)
    torch.testing.assert_close(ulysses_attention(q, k, v, causal=True), want, rtol=F32,
                               atol=F32)
    qd = ht.array(spec["Q"], split=1)
    out = ring_attention(qd, ht.array(spec["K"], split=1), ht.array(spec["V"], split=1),
                         causal=True)
    assert out.split == 1 and out.gshape == (2, 16, 4, 8)
    torch.testing.assert_close(out.larray, want, rtol=F32, atol=F32)
    with pytest.raises(ValueError, match="zigzag"):
        ring_attention(q, k, v, schedule="zigzag")


@pytest.mark.parametrize("case", W1)
def test_world1_grid_matches_heat_tpu(references, started, case):
    """(``started``: the spawned worlds run beside these tests.) The MoE
    routing is decided by more than the tolerance: at every layer,
    microbatch and step (the loss_and_grad call, the logits and three
    steps), each token's top two router probabilities differ by more than
    the float32 tolerance."""
    from heat_tpu_torch.nn import parallel as par

    margins = []
    real = par._route

    def spy(x, router_w, E, C_):
        top = torch.topk(torch.softmax(x.detach() @ router_w.detach(), -1), 2).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        return real(x, router_w, E, C_)

    par._route = spy
    try:
        got = pack(C._build_env(ht, C._spec())["grid_case"](case))
    finally:
        par._route = real
    assert margins and min(margins) > F32, min(margins)
    want = reference(_REFS["refs"], "REF", case)
    _check_grid(got, want, case)
    assert got["counts"] == {"loss_and_grad": {}, "step": {}}
    assert got["groups_created"] == 0


@pytest.mark.parametrize("case", W4 + W2)
def test_grid_matches_heat_tpu(references, worlds, case):
    got, _ = worlds[C.world_of(case)][case]
    want = reference(_REFS["refs"], "REF", C.REF_OF.get(case, case))
    _check_grid(got, want, case)
    assert got["counts"] == {"loss_and_grad": COUNTS[case], "step": COUNTS[case]}, got["counts"]
    assert got["groups_created"] == _groups(C.GRIDS[case][0])
    if case in C.AUDITED:
        # heat_tpu's compiled packed step: one all-reduce, as the port's
        assert want["step_all_reduces"] == 1


def _rank0(name, want):
    """heat_tpu's whole result cut to rank 0's shard, which the port's
    worker reports."""
    out, g = want["out"], list(want["grads"])
    if name in ("tp_mlp", "column_gather"):
        g[1] = g[1][:, :4]
        if name == "tp_mlp":
            g[2] = g[2][:4]
    elif name == "tp_attention":
        g[1] = g[1].reshape(8, 3, 4, 2)[:, :, 0].reshape(8, -1)
        g[2] = g[2][:2]
    elif name == "switch_moe":
        out, g = out[:10], [g[0][:10], g[1], g[2][:1], g[3][:1]]
    elif name.endswith("attention") or name.endswith("noncausal"):
        out, g = out[:, :4], [x[:, :4] for x in g]
    elif name == "pipeline_micro2":
        g[1] = g[1][0]
    return out, g  # generate: the whole batch on every rank


@pytest.mark.parametrize("case", PARTS)
def test_part_matches_heat_tpu(references, worlds, case):
    got, _ = worlds[4][case]
    out, grads = _rank0(case, reference(_REFS["refs"], "REF", case))
    if case == "generate_dp2_tp2":
        np.testing.assert_array_equal(got["out"], out)  # greedy tokens
    _close(got["out"], out, "out")
    assert len(got["grads"]) == len(grads)
    for i, (a, b) in enumerate(zip(got["grads"], grads)):
        _close(a, b, f"grad {i}")
    assert got["counts"] == PART_COUNTS[case], got["counts"]
