"""The flagship transformer LM over a dp x pp x tp x sp grid (heat_tpu
``nn/transformer.py``).

heat_tpu's ``TransformerLM`` on a :class:`MeshGrid` of axes ``("dp", "pp",
"tp", "sp")``, one process per grid point:

* **dp**: the batch rows are sharded over ``dp``; with ``moe_experts`` the
  experts are too (:func:`~heat_tpu_torch.nn.parallel.switch_moe`).
* **pp**: the layers are split into stages over ``pp``
  (:func:`~heat_tpu_torch.nn.parallel.pipeline_apply`, GPipe with
  ``n_micro`` microbatches).
* **tp**: heads and MLP (or expert) features are Megatron-sharded over
  ``tp``: one all-reduce a block forward, one backward.
* **sp**: the sequence is sharded over ``sp`` end to end, with global RoPE
  positions per rank; attention runs the causal ring, the zigzag ring or
  Ulysses (``attn_schedule``) on the flash kernels.
* ``remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``, non-reentrant), its collectives included.

Every attention over a prompt or a sequence runs the flash kernel
(``csrc/flash_fwd_sm90.cu``), and a training step its backward kernels
(dK/dV: ``csrc/flash_bwd_dkv_sm90.cu``, dQ: ``csrc/flash_bwd_dq_sm90.cu``);
the cached decode attention stays dense PyTorch, as it is dense ``jnp`` in
heat_tpu.

Gradients are those of the global loss with respect to each rank's shard,
as heat_tpu's under ``check_vma`` are: the tp and pp collectives carry their
transposes, the loss is computed alike on every tp and pp rank and counted
once, and the gradients of what is replicated over the data axes are summed
there. On packed grids (pp = tp = 1, dense) a step does exactly ONE
all-reduce: the flattened gradients and the loss over the dp x sp group.
Other grids do that one too, one more over sp for the experts' gradients
when MoE runs with sp > 1, and the tp and pp collectives of their layers.
heat_tpu's ``"dcn"`` tier and its quantized, chunked and hierarchical wire
codecs (``fusion.packed_psum``) are not ported: the wire is the exact flat
one.

Parameters are a plain dictionary, this rank's shard of heat_tpu's tree
(see :func:`heat_tpu_torch.utils.convert.transformer_params_from_numpy`).
Every use casts them to ``compute_dtype``, as heat_tpu's ``_cast_params``
does, inside autograd: training keeps float32 masters
(``model.init(seed, dtype=torch.float32)``) and their gradients reach the
float32 leaves, while serving parameters are made in ``compute_dtype``
already (``model.init(seed)``), where the cast returns the tensor itself.
``init`` draws the same numpy values as heat_tpu's ``init``, so both
packages start from identical weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..core import fusion
from ..core import random as _random
from ..core.communication import copy_to, psum
from ..core.tree import tree_flatten
from .attention import (_ring_body, _ulysses_core, _zigzag_core, local_attention,
                        zigzag_layout, zigzag_unlayout)
from .parallel import pipeline_apply, switch_moe

__all__ = ["TransformerLM", "TransformerLMConfig", "rope_apply"]


@dataclass
class TransformerLMConfig:
    """heat_tpu's ``TransformerLMConfig`` (``transformer.py:58``), with
    ``compute_dtype`` a torch dtype."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 8
    n_layers: int = 2
    d_ff: Optional[int] = None          # default 4 * d_model
    moe_experts: int = 0                # 0 = dense MLP; > 0 = Switch-MoE
    capacity_factor: float = 1.25
    n_micro: int = 1                    # microbatches of the pp schedule
    compute_dtype: Any = torch.float32  # bfloat16 on the card
    init_scale: float = 0.02
    attn_schedule: str = "ring"         # "ring" | "zigzag" | "ulysses"
    rope: bool = True
    rope_theta: float = 10000.0
    remat: bool = False                 # recompute each layer in the backward

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.attn_schedule not in ("ring", "zigzag", "ulysses"):
            raise ValueError(f"attn_schedule must be 'ring', 'zigzag' or 'ulysses', got "
                             f"{self.attn_schedule!r}")
        if self.rope and self.head_dim % 2:
            raise ValueError(f"rope needs an even head_dim, got {self.head_dim}")
        if not (isinstance(self.compute_dtype, torch.dtype)
                and self.compute_dtype.is_floating_point):
            raise ValueError(f"compute_dtype must be a floating torch dtype, got "
                             f"{self.compute_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rmsnorm(x, scale):
    """heat_tpu ``transformer.py:95``: the variance in float32, cast back to
    ``x``'s dtype before the scale multiplies."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def rope_apply(x, pos, theta: float = 10000.0):
    """Rotary position embedding, half-split convention (heat_tpu
    ``transformer.py:100``), on ``(mb, S, H, Dh)`` with positions ``pos`` of
    shape ``(S,)`` or ``(mb, S)``; computed in float32, cast back."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[..., None] * freq
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class TransformerLM(torch.nn.Module):
    """Causal LM over a ``("dp", "pp", "tp", "sp")`` :class:`MeshGrid`
    (heat_tpu ``transformer.py:120``), any sizes whose product is the
    world; ``model(params, toks)`` is the logits forward of this rank's
    token shard. Building it is collective: it creates the grid's dp x sp
    group."""

    AXES = ("dp", "pp", "tp", "sp")
    PROMPT_BUCKET_MIN = 8

    def __init__(self, grid, config: TransformerLMConfig):
        super().__init__()
        if tuple(grid.axis_names) != self.AXES:
            raise ValueError(f"grid axes must be {self.AXES}, got {grid.axis_names}")
        self.grid = grid
        self.cfg = config
        c = config
        sizes = grid.sizes
        self.dp, self.pp, self.tp, self.sp = (sizes[a] for a in self.AXES)
        if c.n_layers % self.pp:
            raise ValueError(f"n_layers ({c.n_layers}) must divide over pp ({self.pp})")
        if c.n_heads % self.tp:
            raise ValueError(f"n_heads ({c.n_heads}) must divide over tp ({self.tp})")
        if c.d_ff % self.tp:
            raise ValueError(f"d_ff ({c.d_ff}) must divide over tp ({self.tp})")
        if c.moe_experts and c.moe_experts % self.dp:
            raise ValueError(f"moe_experts ({c.moe_experts}) must divide over dp ({self.dp}) "
                             "(experts are sharded over the dp axis)")
        if (c.attn_schedule == "ulysses" and self.sp > 1
                and (c.n_heads // self.tp) % self.sp):
            raise ValueError(f"ulysses schedule needs local heads ({c.n_heads}//{self.tp}"
                             f"={c.n_heads // self.tp}) divisible by sp ({self.sp})")
        self.layers_per_stage = c.n_layers // self.pp
        # the data axes: the loss and the gradients of what they replicate
        # are summed over this group
        self._data = grid.group(("dp", "sp"))

    @property
    def dp_world(self) -> int:
        return self.dp

    @property
    def device(self) -> torch.device:
        return self.grid.torch_device

    # ------------------------------------------------------------- #
    # parameters                                                    #
    # ------------------------------------------------------------- #

    def param_specs(self) -> Dict[str, Any]:
        """heat_tpu's ``param_specs`` (``transformer.py:185``): for each
        leaf of the host tree, the grid axis each dimension is sharded over
        (None: replicated). Stage leaves lead with ``(pp, Ls)``."""
        c = self.cfg
        stages = {"ln1": ("pp", None, None),
                  "wqkv": ("pp", None, None, None, "tp", None),   # (pp, Ls, D, 3, H, Dh)
                  "wproj": ("pp", None, "tp", None, None),        # (pp, Ls, H, Dh, D)
                  "ln2": ("pp", None, None)}
        if c.moe_experts:
            stages.update({"router": ("pp", None, None, None),    # (pp, Ls, D, E)
                           "w_up": ("pp", None, "dp", None, "tp"),   # (pp, Ls, E, D, F)
                           "w_down": ("pp", None, "dp", "tp", None)})  # (pp, Ls, E, F, D)
        else:
            stages.update({"w_up": ("pp", None, None, "tp"),      # (pp, Ls, D, F)
                           "w_down": ("pp", None, "tp", None)})   # (pp, Ls, F, D)
        return {"embed": (None, None), "final_ln": (None,), "unembed": (None, None),
                "stages": stages}

    def host_init(self, seed: int = 0) -> Dict[str, Any]:
        """heat_tpu's parameter tree as float32 numpy arrays, drawn exactly as
        heat_tpu's ``init`` draws them (``transformer.py:227-256``)."""
        c, Ls, pp = self.cfg, self.layers_per_stage, self.pp
        H, Dh, D, Fd, V = c.n_heads, c.head_dim, c.d_model, c.d_ff, c.vocab
        rng = np.random.default_rng(seed)
        s = c.init_scale

        def norm(*shape):
            return (s * rng.standard_normal(shape)).astype(np.float32)

        stages = {
            "ln1": np.ones((pp, Ls, D), np.float32),
            "wqkv": norm(pp, Ls, D, 3, H, Dh),
            "wproj": norm(pp, Ls, H, Dh, D),
            "ln2": np.ones((pp, Ls, D), np.float32),
        }
        if c.moe_experts:
            E = c.moe_experts
            stages["router"] = norm(pp, Ls, D, E)
            stages["w_up"] = norm(pp, Ls, E, D, Fd)
            stages["w_down"] = norm(pp, Ls, E, Fd, D)
        else:
            stages["w_up"] = norm(pp, Ls, D, Fd)
            stages["w_down"] = norm(pp, Ls, Fd, D)
        return {"embed": norm(V, D), "final_ln": np.ones((D,), np.float32),
                "unembed": norm(D, V), "stages": stages}

    def shard_params(self, tree, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """This rank's parameters from heat_tpu's host tree (heat_tpu
        ``transformer.py:216``), in ``dtype`` (``compute_dtype`` by
        default)."""
        from ..utils.convert import transformer_params_from_numpy

        return transformer_params_from_numpy(tree, self.cfg, device=self.device, dtype=dtype,
                                             model=self)

    def init(self, seed: int = 0, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """This rank's parameters on the grid's device, in ``dtype``:
        ``compute_dtype`` by default (serving), ``torch.float32`` for
        training masters."""
        return self.shard_params(self.host_init(seed), dtype=dtype)

    # ------------------------------------------------------------- #
    # layer math, shared by training, the prefill and decode        #
    # ------------------------------------------------------------- #

    def _cast_params(self, p):
        """Mixed precision (heat_tpu ``transformer.py:305``): one layer's
        parameters in ``compute_dtype``, cast per use inside autograd, so
        float32 masters get float32 gradients; parameters in
        ``compute_dtype`` already come back as they are, dictionary and
        all (serving calls this per layer and step)."""
        cd = self.cfg.compute_dtype
        if all(a.dtype == cd for a in p.values()):
            return p
        return {name: a.to(cd) for name, a in p.items()}

    def _embed(self, params, toks):
        """The token embedding: gather, then cast (heat_tpu ``:386``)."""
        return params["embed"][toks].to(self.cfg.compute_dtype)

    def _qkv(self, p, x, pos):
        """Pre-norm qkv projection for the local heads, with rotary rotation
        by the global positions ``pos``; the normed input enters the
        tp-sharded product through ``copy_to``."""
        c = self.cfg
        B, S, D = x.shape
        a_in = copy_to(_rmsnorm(x, p["ln1"]), self.grid.axis("tp"))
        qkv = (a_in @ p["wqkv"].reshape(D, -1)).reshape(B, S, 3, c.n_heads // self.tp,
                                                        c.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.rope:
            q = rope_apply(q, pos, c.rope_theta)
            k = rope_apply(k, pos, c.rope_theta)
        return q, k, v

    def _psum_tp(self, x):
        """The Megatron block's tp reduction (heat_tpu ``transformer.py:329``):
        one all-reduce forward, none backward; the identity at tp = 1."""
        return psum(x, self.grid.axis("tp"))

    def _attn_residual(self, p, x, attn):
        """Row-parallel output projection (one tp all-reduce) + residual."""
        B, S, _ = x.shape
        w = p["wproj"]
        return x + self._psum_tp(attn.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1]))

    def _dense_mlp_residual(self, p, x, m_in):
        m_in = copy_to(m_in, self.grid.axis("tp"))
        h = F.gelu(m_in @ p["w_up"], approximate="tanh")  # jax.nn.gelu's default
        return x + self._psum_tp(h @ p["w_down"])

    def _head(self, params, h):
        """Final norm + unembed; logits upcast to float32 after the GEMM."""
        cd = self.cfg.compute_dtype
        h = _rmsnorm(h, params["final_ln"].to(cd))
        return (h @ params["unembed"].to(cd)).float()

    def _attention(self, q, k, v, sp_comm):
        """The schedule of ``attn_schedule`` over the sp ranks (heat_tpu
        ``transformer.py:273-286``); the zigzag one on tokens that are in
        zigzag layout already."""
        c = self.cfg
        scale = 1.0 / math.sqrt(c.head_dim)
        if c.attn_schedule == "zigzag" and sp_comm.size > 1:
            return _zigzag_core(q, k, v, comm=sp_comm, scale=scale)
        if c.attn_schedule == "ulysses" and sp_comm.size > 1:
            return _ulysses_core(q, k, v, comm=sp_comm, scale=scale, causal=True)
        return _ring_body(q, k, v, comm=sp_comm, scale=scale, causal=True)

    def _block(self, p, x, sp_comm, pos):
        """One layer on a local microbatch ``(mb, S_local, D)`` (heat_tpu
        ``transformer.py:262``)."""
        c = self.cfg
        p = self._cast_params(p)
        q, k, v = self._qkv(p, x, pos)
        x = self._attn_residual(p, x, self._attention(q, k, v, sp_comm))
        m_in = _rmsnorm(x, p["ln2"])
        if c.moe_experts:
            mb, S_local, D = x.shape
            moe_out = switch_moe(m_in.reshape(mb * S_local, D), p["router"], p["w_up"],
                                 p["w_down"], axis=self.grid.axis("dp"),
                                 capacity_factor=c.capacity_factor,
                                 tp_axis=self.grid.axis("tp"))
            return x + self._psum_tp(moe_out).reshape(mb, S_local, D)
        return self._dense_mlp_residual(p, x, m_in)

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks) if not torch.is_tensor(toks) else toks,
                               device=self.device).long()

    def _zigzag(self) -> bool:
        return self.cfg.attn_schedule == "zigzag" and self.sp > 1

    def _forward_device(self, params, toks):
        """This rank's tokens ``(B_local, S_local)`` -> float32 logits
        ``(B_local, S_local, vocab)`` (heat_tpu ``transformer.py:374``):
        the embedding, the layers of this stage under the pipeline schedule
        and the head (computed alike on every pp and tp rank)."""
        c = self.cfg
        toks = self._tokens(toks)
        sp_comm = self.grid.axis("sp")
        B_local, S_local = toks.shape
        if B_local % c.n_micro:
            raise ValueError(f"local batch ({B_local}) must divide into n_micro ({c.n_micro})")
        mb = B_local // c.n_micro
        x = self._embed(params, toks)
        sp_idx = self.grid.coord("sp")
        dev = x.device
        if self._zigzag():
            # one layout round trip per forward: into zigzag here, back before
            # the head; every layer in between is positionwise or zigzag-aware
            x = zigzag_layout(x, sp_comm)
            half, n = S_local // 2, self.sp
            pos = torch.cat([sp_idx * half + torch.arange(half, device=dev),
                             (2 * n - 1 - sp_idx) * half + torch.arange(half, device=dev)])
        else:
            pos = sp_idx * S_local + torch.arange(S_local, device=dev)
        x_micro = x.reshape(c.n_micro, mb, S_local, c.d_model)

        def block(p_l, xm):
            if c.remat:
                return checkpoint(self._block, p_l, xm, sp_comm, pos, use_reentrant=False)
            return self._block(p_l, xm, sp_comm, pos)

        def stage_fn(layers, xm):
            for p_l in layers:
                xm = block(p_l, xm)
            return xm

        # the compute-dtype copies once a forward, not once a microbatch
        # and recomputation
        layers = [self._cast_params(p_l) for p_l in params["layers"]]
        out = pipeline_apply(stage_fn, layers, x_micro, axis=self.grid.axis("pp"))
        h = out.reshape(B_local, S_local, c.d_model)
        if self._zigzag():
            h = zigzag_unlayout(h, sp_comm)
        return self._head(params, h)

    def forward(self, params, toks):
        return self._forward_device(params, toks)

    @torch.no_grad()
    def _serving_forward(self, params, toks):
        """The logits of the whole batch on every rank: this rank's shard,
        all-gathered over sp (the sequence) and dp (the rows)."""
        logits = self._forward_device(params, toks)
        logits = self.grid.axis("sp").Allgather(logits, axis=1)
        return self.grid.axis("dp").Allgather(logits, axis=0)

    def logits_fn(self):
        """``(params, toks) -> (B, S, vocab)`` float32 logits (heat_tpu
        ``transformer.py:616``): ``toks`` is this rank's shard
        (:meth:`shard_batch`), the result the whole batch's logits on every
        rank (one all-gather over sp and one over dp where they are above
        1). It records no autograd graph, whatever ``params`` require."""
        return self._serving_forward

    # ------------------------------------------------------------- #
    # training                                                      #
    # ------------------------------------------------------------- #

    def _local_loss_device(self, params, toks):
        """This rank's share of the global next-token NLL (heat_tpu
        ``transformer.py:433``): float32 log-softmax over the logits, the
        targets shifted left with the next sp rank's first token (one
        ``permute`` round at sp > 1), the global last position masked,
        summed and divided by the static count ``B_local * dp * (S_local *
        sp - 1)``. The shares summed over dp and sp are the global loss."""
        toks = self._tokens(toks)
        B_local, S_local = toks.shape
        logits = self._forward_device(params, toks)
        sp, sp_comm = self.sp, self.grid.axis("sp")
        first = toks[:, :1].contiguous()
        if sp > 1:
            first = sp_comm.Permute(first, [(i, (i - 1) % sp) for i in range(sp)], first.shape)
        targets = torch.cat([toks[:, 1:], first], dim=1)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        mask = torch.ones(S_local, dtype=nll.dtype, device=nll.device)
        if self.grid.coord("sp") == sp - 1:
            mask[-1:].zero_()  # on the device: no host copy inside a captured step
        count = B_local * self.dp_world * (S_local * sp - 1)
        return (nll * mask).sum() / count

    def shard_batch(self, toks) -> torch.Tensor:
        """This rank's shard of a global ``(B, S)`` int token batch, on the
        model's device (heat_tpu ``transformer.py:491``): rows over dp, the
        sequence over sp."""
        toks = self._tokens(toks)
        B, S = toks.shape
        if B % self.dp or S % self.sp:
            raise ValueError(f"batch {tuple(toks.shape)} must divide over dp ({self.dp}) rows "
                             f"and sp ({self.sp}) positions")
        b, s = B // self.dp, S // self.sp
        i, j = self.grid.coord("dp"), self.grid.coord("sp")
        return toks[i * b:(i + 1) * b, j * s:(j + 1) * s].contiguous()

    @property
    def packed_step_supported(self) -> bool:
        """Whether heat_tpu's packed-collective train step applies: pp = tp
        = 1 and a dense MLP (heat_tpu ``transformer.py:498``). There the
        step's only all-reduce is the packed one."""
        return self.pp == 1 and self.tp == 1 and not self.cfg.moe_experts

    def _expert_leaves(self, params) -> List[bool]:
        """Per leaf of ``params`` (in ``tree_flatten`` order), whether it
        holds experts: those are sharded over dp and replicated over sp."""
        flags = []

        def walk(node, expert):
            if isinstance(node, dict):
                for key, val in node.items():
                    walk(val, expert or (self.cfg.moe_experts and key in ("w_up", "w_down")))
            elif isinstance(node, (list, tuple)):
                for val in node:
                    walk(val, expert)
            else:
                flags.append(bool(expert))

        walk(params, False)
        return flags

    def _reduce(self, params, grads, loss):
        """The data-axis sums of the gradients and the loss: one packed
        all-reduce over dp x sp of every non-expert gradient and the loss
        (heat_tpu ``_packed_loss_and_grad_body``), one over sp of the
        experts' gradients."""
        data, sp_comm = self._data, self.grid.axis("sp")
        flags = self._expert_leaves(params)
        rest = [g for g, e in zip(grads, flags) if not e]
        experts = [g for g, e in zip(grads, flags) if e]
        if data.size > 1:
            *rest, loss = fusion.packed_psum(rest + [loss.reshape(1)], data)
            loss = loss.reshape(())
        if experts and sp_comm.size > 1:
            experts = fusion.packed_psum(experts, sp_comm)
        it_r, it_e = iter(rest), iter(experts)
        return [next(it_e) if e else next(it_r) for e in flags], loss

    def loss_and_grad_fn(self):
        """``(params, toks) -> (loss, grads)`` (heat_tpu
        ``transformer.py:551``): ``toks`` is this rank's shard
        (:meth:`shard_batch`); the 0-d global loss on every rank and the
        gradients of this rank's shard as a dictionary shaped like
        ``params``, in the parameters' dtypes. ``params`` need not require
        grad: the gradients are taken through aliases of its tensors, which
        stay untouched. Collectives per call: see the module's docstring;
        at world size 1 none."""

        def fn(params, toks):
            toks = self._tokens(toks)
            leaves, unflatten = tree_flatten(params)
            with torch.enable_grad():
                live = [t.detach().requires_grad_(True) for t in leaves]
                loss = self._local_loss_device(unflatten(live), toks)
                grads = list(torch.autograd.grad(loss, live))
            grads, loss = self._reduce(params, grads, loss.detach())
            return loss, unflatten(grads)

        return fn

    def make_train_step(self, tx):
        """``(params, opt_state, toks) -> (params, opt_state, loss)``
        (heat_tpu ``transformer.py:636``) with a transform ``tx`` of
        :mod:`heat_tpu_torch.optim` and ``opt_state = tx.init(params)``.

        The parameters and the optimizer state are updated in place (the
        counterpart of heat_tpu's donation) and come back as the same
        objects; the loss is a 0-d tensor on the model's device, so a step
        makes no host sync.

        On packed grids (:attr:`packed_step_supported`) and with
        ``fusion.step_enabled()``, read at each call, the whole step
        (forward, backward, the packed gradient all-reduce and the update)
        is ONE program per signature of the parameters and the token batch
        (:class:`heat_tpu_torch.core.fusion._Program`: on a card a CUDA graph
        whose bound inputs are the caller's own parameters, so a replay
        copies none), each call counted in ``op_engine.fusion_step_flushes``
        (:func:`heat_tpu_torch.core.fusion.dispatch`, no eager fallback);
        ``step.program_cache`` holds the programs. Otherwise the step runs
        eagerly, as with the switch off."""
        from ..utils.program_cache import ProgramCache

        lg = self.loss_and_grad_fn()
        programs = ProgramCache("train_step", aot=False, counter_prefix="nn.train_step")

        def eager(params, opt_state, toks):
            loss, grads = lg(params, toks)
            tx.update(grads, opt_state, params)
            return params, opt_state, loss

        def step(params, opt_state, toks):
            if not (self.packed_step_supported and fusion.step_enabled()):
                return eager(params, opt_state, toks)
            toks = self._tokens(toks)
            leaves, unflatten = tree_flatten(params)
            key = (id(opt_state), tuple((tuple(t.shape), t.dtype, str(t.device)) for t in leaves),
                   tuple(toks.shape), str(toks.device))
            loss = fusion.dispatch(
                programs, key,
                lambda *codecs: lambda *args: eager(unflatten(args[:-1]), opt_state, args[-1])[2],
                (*leaves, toks), flush_counter="op_engine.fusion_step_flushes")
            return params, opt_state, loss

        step.program_cache = programs
        return step

    # ------------------------------------------------------------- #
    # generation (KV-cached autoregressive decode)                  #
    # ------------------------------------------------------------- #

    @classmethod
    def prompt_bucket(cls, s0: int) -> int:
        """The prompt-length bucket: the smallest power of two >= ``s0``,
        at least :data:`PROMPT_BUCKET_MIN` (heat_tpu ``transformer.py:718``)."""
        s0 = int(s0)
        if s0 < 1:
            raise ValueError(f"prompt length must be >= 1, got {s0}")
        return max(cls.PROMPT_BUCKET_MIN, 1 << (s0 - 1).bit_length())

    def check_decode_grid(self) -> None:
        """Decode is token-recurrent: pp = sp = 1 and a dense MLP (heat_tpu
        ``transformer.py:729``)."""
        if self.pp != 1 or self.sp != 1:
            raise ValueError(
                "generate requires a pp=1, sp=1 grid (token-recurrent decode); use "
                "dp x tp for inference")
        if self.cfg.moe_experts:
            raise NotImplementedError("generate supports the dense MLP only")

    def _attn_from_cache(self, q, ck, cv, upto):
        """``q (Bl, 1, H, Dh)`` against the cached rows ``< upto`` (a scalar,
        or ``(Bl,)`` when every row is at its own depth); dense, in float32."""
        s = torch.einsum("bqhd,bshd->bhqs", q.float(), ck.float()) / math.sqrt(self.cfg.head_dim)
        col = torch.arange(ck.shape[1], device=ck.device)[None, None, None, :]
        lim = upto if not torch.is_tensor(upto) or upto.ndim == 0 else upto[:, None, None, None]
        s = s.masked_fill(~(col < lim), float("-inf"))
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", w, cv.float())
        return out.to(q.dtype)

    def _cache_layer_step(self, p_l, x, ck, cv, pos):
        """One layer on a single-token batch ``(Bl, 1, D)``: write this
        token's K/V into ``ck``/``cv`` (``(Bl, S, H, Dh)`` views of the cache,
        updated in place) at each row's position ``pos`` ``(Bl,)`` and attend
        to the rows ``< pos + 1``. Rows the caller does not advance (dead
        slots) overwrite the same masked row."""
        Bl = x.shape[0]
        p_l = self._cast_params(p_l)
        q, k, v = self._qkv(p_l, x, pos[:, None])
        rows = torch.arange(Bl, device=x.device)
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        x = self._attn_residual(p_l, x, self._attn_from_cache(q, ck, cv, pos + 1))
        x = self._dense_mlp_residual(p_l, x, _rmsnorm(x, p_l["ln2"]))
        return x, ck, cv

    def _prompt_kv_logits(self, params, toks, n_valid: int):
        """Padded-prompt prefill (heat_tpu ``transformer.py:771``): ``toks``
        ``(Bl, Sp)`` with the rows from ``n_valid`` on padding. Returns the
        per-layer K and V ``(Bl, Sp, H, Dh)`` (after RoPE) and the float32
        logits at position ``n_valid - 1``. Causal attention never reads a
        later column, so the valid rows are the unpadded forward's; padded
        rows hold values the caller keeps masked until decode overwrites
        them."""
        Sp = toks.shape[1]
        x = self._embed(params, toks)
        pos0 = torch.arange(Sp, device=x.device)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for p_l in params["layers"]:
            p_l = self._cast_params(p_l)
            q, k, v = self._qkv(p_l, x, pos0)
            ks.append(k)
            vs.append(v)
            attn = local_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True).transpose(1, 2)
            x = self._attn_residual(p_l, x, attn)
            x = self._dense_mlp_residual(p_l, x, _rmsnorm(x, p_l["ln2"]))
        h_last = x[:, n_valid - 1:n_valid]
        return ks, vs, self._head(params, h_last)[:, 0]

    @staticmethod
    def _sample(logits, temperature: float, key):
        """Greedy at ``temperature = 0``; otherwise heat_tpu's draw
        ``jax.random.categorical(key, logits / temperature, axis=-1)``
        over the ``(B, V)`` float32 logits, its Threefry noise computed on
        the logits' device (``core/random.py``)."""
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        return _random._categorical(key, logits, temperature)

    @torch.inference_mode()
    def generate(self, params, prompts, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """Autoregressive decode with a per-layer KV cache (heat_tpu
        ``transformer.py:802``).

        ``prompts``: ``(B, S0)`` int tokens, the whole batch on every rank;
        returns the ``(B, S0 + max_new_tokens)`` int32 tokens (prompt
        included) on the model's device, on every rank. Each dp rank decodes
        its ``B / dp`` rows (heads and features sharded over tp, one tp
        all-reduce a block) and one all-gather over dp joins them.
        ``temperature = 0`` is greedy; otherwise heat_tpu's draws, bit for
        bit: the key ``fold_in(key(seed), dp rank)`` split into the first
        token's key and one key a later step (``jax.random.split(key,
        max_new_tokens)[1:]``), each token ``categorical(key, logits / T)``. The prompt pads to its bucket
        (:meth:`prompt_bucket`) and runs one causal prefill; then one cached
        step per new token. K/V are cached after RoPE, each row rotated by
        its own position."""
        c = self.cfg
        self.check_decode_grid()
        prompts = self._tokens(prompts)
        B, S0 = prompts.shape
        if B % self.dp_world:
            raise ValueError(f"prompt batch ({B}) must divide over the data-parallel "
                             f"world ({self.dp_world})")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        Sb = self.prompt_bucket(S0)
        S_max = Sb + max_new_tokens
        dev = self.device
        full = prompts
        b, dp_idx = B // self.dp, self.grid.coord("dp")
        prompts = prompts[dp_idx * b:(dp_idx + 1) * b]
        B = b
        padded = torch.zeros((B, Sb), dtype=torch.long, device=dev)
        padded[:, :S0] = prompts
        ks, vs, logits0 = self._prompt_kv_logits(params, padded, S0)
        shape = (c.n_layers, B, S_max, c.n_heads // self.tp, c.head_dim)
        ck = torch.zeros(shape, dtype=c.compute_dtype, device=dev)
        cv = torch.zeros_like(ck)
        for l in range(c.n_layers):
            ck[l, :, :Sb] = ks[l]
            cv[l, :, :Sb] = vs[l]
        del ks, vs
        # heat_tpu's keys (transformer.py:848, :862-893)
        key = _random._fold_in(_random._base_key(seed), dp_idx)
        key0, key = _random._split(key)
        tok = self._sample(logits0, temperature, key0)
        out = [tok]
        for i, t in enumerate(range(S0, S0 + max_new_tokens - 1)):
            x = self._embed(params, tok)[:, None, :]
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            for l, p_l in enumerate(params["layers"]):
                x, _, _ = self._cache_layer_step(p_l, x, ck[l], cv[l], pos)
            tok = self._sample(self._head(params, x)[:, 0], temperature,
                               _random._threefry_host(key, 0, i + 1))
            out.append(tok)
        new = self.grid.axis("dp").Allgather(torch.stack(out, dim=1), axis=0)
        return torch.cat([full, new], dim=1).to(torch.int32)
