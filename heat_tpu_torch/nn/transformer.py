"""The flagship transformer LM on one card (heat_tpu ``nn/transformer.py``).

heat_tpu's ``TransformerLM`` on a ``(1, 1, 1, 1)`` grid: its configuration,
the layer math (``_rmsnorm``, ``rope_apply``, ``_qkv``, the residual blocks
and the head), training (``loss_and_grad_fn``, ``make_train_step``), the
logits forward (``logits_fn``) and KV-cached decode (``generate``, plus the
prefill and cached-step bodies that the continuous-batching
:class:`~heat_tpu_torch.serve.DecodeEngine` shares). Every attention over a
prompt or a sequence runs the flash kernel (``csrc/flash_fwd_sm90.cu``),
and a training step its backward kernels (dK/dV:
``csrc/flash_bwd_dkv_sm90.cu``, dQ: ``csrc/flash_bwd_dq_sm90.cu``); the cached
decode attention stays dense PyTorch, as it is dense ``jnp`` in heat_tpu.

Parameters are a plain dictionary (see
:func:`heat_tpu_torch.utils.convert.transformer_params_from_numpy`).
Every use casts them to ``compute_dtype``, as heat_tpu's ``_cast_params``
does, inside autograd: training keeps float32 masters
(``model.init(seed, dtype=torch.float32)``) and their gradients reach the
float32 leaves, while serving parameters are made in ``compute_dtype``
already (``model.init(seed)``), where the cast returns the tensor itself.
``init`` draws the same numpy values as heat_tpu's ``init``, so both
packages start from identical weights.

At world size 1 heat_tpu's packed gradient all-reduce has no axis to reduce
over, and none runs here either. MoE, remat and grids with dp, pp, tp or sp
above 1 come with later slices (ROADMAP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tree import tree_flatten
from .attention import _ring_body, local_attention

__all__ = ["TransformerLM", "TransformerLMConfig", "rope_apply"]


@dataclass
class TransformerLMConfig:
    """heat_tpu's ``TransformerLMConfig`` (``transformer.py:58``), with
    ``compute_dtype`` a torch dtype. The fields of the dense single-card
    model are ported: ``capacity_factor``, ``n_micro``, ``attn_schedule``
    and ``remat`` come with the slices that run MoE, pipelines, multi-card
    rings and rematerialisation."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 8
    n_layers: int = 2
    d_ff: Optional[int] = None          # default 4 * d_model
    moe_experts: int = 0                # 0 = dense MLP (the only kind ported)
    compute_dtype: Any = torch.float32  # bfloat16 on the card
    init_scale: float = 0.02
    rope: bool = True
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
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
    (heat_tpu ``transformer.py:120``); ``model(params, toks)`` is the
    logits forward."""

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
        if c.moe_experts:
            raise NotImplementedError("the port runs the dense MLP only; MoE is a later slice")
        self.layers_per_stage = c.n_layers // self.pp

    @property
    def dp_world(self) -> int:
        return self.dp

    @property
    def device(self) -> torch.device:
        return self.grid.torch_device

    # ------------------------------------------------------------- #
    # parameters                                                    #
    # ------------------------------------------------------------- #

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
            "w_up": norm(pp, Ls, D, Fd),
            "w_down": norm(pp, Ls, Fd, D),
        }
        return {"embed": norm(V, D), "final_ln": np.ones((D,), np.float32),
                "unembed": norm(D, V), "stages": stages}

    def init(self, seed: int = 0, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The parameters on the grid's device, in ``dtype``: ``compute_dtype``
        by default (serving), ``torch.float32`` for training masters."""
        from ..utils.convert import transformer_params_from_numpy

        return transformer_params_from_numpy(self.host_init(seed), self.cfg,
                                             device=self.device, dtype=dtype)

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
        """Pre-norm qkv projection with rotary rotation by positions ``pos``."""
        c = self.cfg
        B, S, D = x.shape
        a_in = _rmsnorm(x, p["ln1"])
        qkv = (a_in @ p["wqkv"].reshape(D, -1)).reshape(B, S, 3, c.n_heads // self.tp,
                                                        c.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.rope:
            q = rope_apply(q, pos, c.rope_theta)
            k = rope_apply(k, pos, c.rope_theta)
        return q, k, v

    def _attn_residual(self, p, x, attn):
        """Output projection + residual (the tp psum is the identity at tp = 1)."""
        B, S, _ = x.shape
        w = p["wproj"]
        return x + attn.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])

    def _dense_mlp_residual(self, p, x, m_in):
        h = F.gelu(m_in @ p["w_up"], approximate="tanh")  # jax.nn.gelu's default
        return x + h @ p["w_down"]

    def _head(self, params, h):
        """Final norm + unembed; logits upcast to float32 after the GEMM."""
        cd = self.cfg.compute_dtype
        h = _rmsnorm(h, params["final_ln"].to(cd))
        return (h @ params["unembed"].to(cd)).float()

    def _block(self, p, x, sp_comm, pos):
        """One layer on a local microbatch ``(mb, S, D)``."""
        p = self._cast_params(p)
        q, k, v = self._qkv(p, x, pos)
        attn = _ring_body(q, k, v, comm=sp_comm, scale=1.0 / math.sqrt(self.cfg.head_dim),
                          causal=True)
        x = self._attn_residual(p, x, attn)
        return self._dense_mlp_residual(p, x, _rmsnorm(x, p["ln2"]))

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks) if not torch.is_tensor(toks) else toks,
                               device=self.device).long()

    def _forward_device(self, params, toks):
        """``toks (B, S) -> (B, S, vocab)`` float32 logits (heat_tpu
        ``transformer.py:374``); the pipeline is trivial at pp = 1, so the
        layers run in turn."""
        toks = self._tokens(toks)
        sp_comm = self.grid.axis("sp")
        x = self._embed(params, toks)
        pos = torch.arange(toks.shape[1], device=x.device)
        for p_l in params["layers"]:
            x = self._block(p_l, x, sp_comm, pos)
        return self._head(params, x)

    def forward(self, params, toks):
        return self._forward_device(params, toks)

    @torch.no_grad()
    def _serving_forward(self, params, toks):
        return self._forward_device(params, toks)

    def logits_fn(self):
        """``(params, toks) -> (B, S, vocab)`` float32 logits, the serving
        forward (heat_tpu ``transformer.py:616``); it records no autograd
        graph, whatever ``params`` require."""
        return self._serving_forward

    # ------------------------------------------------------------- #
    # training                                                      #
    # ------------------------------------------------------------- #

    def _local_loss_device(self, params, toks):
        """The next-token NLL (heat_tpu ``transformer.py:433``): float32
        log-softmax over the logits, the global last position masked, summed
        and divided by the static count ``B * dp_world * (S * sp - 1)``. At
        sp = 1 the targets shift left and wrap the first column onto the
        last position, which the mask drops. At world size 1 this share is
        the global loss (heat_tpu's ``_loss_device``, ``:475``, sums the
        shares over the data axes)."""
        B, S = toks.shape
        logits = self._forward_device(params, toks)
        targets = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        mask = (torch.arange(S, device=nll.device) < S - 1).to(nll.dtype)
        count = B * self.dp_world * (S * self.sp - 1)
        return (nll * mask).sum() / count

    def shard_batch(self, toks) -> torch.Tensor:
        """A ``(B, S)`` int token batch on the model's device (heat_tpu
        ``transformer.py:491``; one card holds the whole batch)."""
        return self._tokens(toks)

    @property
    def packed_step_supported(self) -> bool:
        """Whether heat_tpu's packed-collective train step applies: pp = tp
        = 1 and a dense MLP (heat_tpu ``transformer.py:498``)."""
        return self.pp == 1 and self.tp == 1 and not self.cfg.moe_experts

    def loss_and_grad_fn(self):
        """``(params, toks) -> (loss, grads)`` (heat_tpu
        ``transformer.py:551``): the 0-d loss on the model's device and the
        gradients as a dictionary shaped like ``params``, in the parameters'
        dtypes (float32 for float32 masters). ``params`` need not require
        grad: the gradients are taken through aliases of its tensors, which
        stay untouched. At world size 1 no collective runs."""

        def fn(params, toks):
            toks = self._tokens(toks)
            leaves, unflatten = tree_flatten(params)
            with torch.enable_grad():
                live = [t.detach().requires_grad_(True) for t in leaves]
                loss = self._local_loss_device(unflatten(live), toks)
                grads = torch.autograd.grad(loss, live)
            return loss.detach(), unflatten(list(grads))

        return fn

    def make_train_step(self, tx):
        """``(params, opt_state, toks) -> (params, opt_state, loss)``
        (heat_tpu ``transformer.py:636``) with a transform ``tx`` of
        :mod:`heat_tpu_torch.optim` and ``opt_state = tx.init(params)``.

        The parameters and the optimizer state are updated in place (the
        counterpart of heat_tpu's donation) and come back as the same
        objects; the loss is a 0-d tensor on the model's device, so a step
        makes no host sync."""
        lg = self.loss_and_grad_fn()

        def step(params, opt_state, toks):
            loss, grads = lg(params, toks)
            tx.update(grads, opt_state, params)
            return params, opt_state, loss

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
        """Decode is token-recurrent: pp = sp = 1 (the model refuses MoE at
        construction already)."""
        if self.pp != 1 or self.sp != 1:
            raise ValueError(
                "generate requires a pp=1, sp=1 grid (token-recurrent decode); use "
                "dp x tp for inference")

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
    def _sample(logits, temperature: float, gen: Optional[torch.Generator]):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, params, prompts, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """Autoregressive decode with a per-layer KV cache (heat_tpu
        ``transformer.py:802``).

        ``prompts``: ``(B, S0)`` int tokens; returns the ``(B, S0 +
        max_new_tokens)`` int32 tokens (prompt included) on the model's
        device. ``temperature = 0`` is greedy; otherwise softmax sampling
        from a ``torch.Generator`` seeded with ``seed`` (not heat_tpu's
        Threefry draws). The prompt pads to its bucket
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
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        tok = self._sample(logits0, temperature, gen)
        out = [tok]
        for t in range(S0, S0 + max_new_tokens - 1):
            x = self._embed(params, tok)[:, None, :]
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            for l, p_l in enumerate(params["layers"]):
                x, _, _ = self._cache_layer_step(p_l, x, ck[l], cv[l], pos)
            tok = self._sample(self._head(params, x)[:, 0], temperature, gen)
            out.append(tok)
        return torch.cat([prompts, torch.stack(out, dim=1)], dim=1).to(torch.int32)
