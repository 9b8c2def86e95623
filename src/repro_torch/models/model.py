"""Model assembly of the port (counterpart of ``repro.models.model``):

* dense / moe / vlm / audio — stacked transformer blocks; the MoE
  family's FFN is ``models.moe.moe_ffn`` (dropless at decode, and at
  prefill under ``ModelRuntime.moe_dropless``); the vlm (M-RoPE over
  ``(3, B, S)`` positions) and audio (an encoder: non-causal, no decode)
  families take ``batch['embeds']`` from their stubbed front-ends in
  place of tokens, as the reference does;
* ssm — stacked Mamba-2 blocks (``models.ssm``) with a ``{conv, ssm}``
  state cache instead of K/V;
* hybrid (Zamba2) — the Mamba-2 stack, with a *shared* attention + FFN
  block after every ``shared_attn_period`` layers, alternating between
  ``n_shared_attn_blocks`` physical blocks; its cache holds the state of
  every layer and the K/V of every group.

Training takes :func:`loss_fn` (cross-entropy plus the MoE aux loss) by
autograd through :func:`forward`; ``ModelRuntime.remat`` checkpoints
each block's activations while a gradient is taken.

Parameters are a nested dict of tensors with the reference's tree: f32
master weights, per-layer weights stacked on a leading ``layers`` axis,
projections stored ``(in, out)``. :func:`cast_params` casts the matmul
weights and the embedding to ``rt.dtype`` once, when a runtime is set up
(the reference casts before every matmul; the numbers are the same).
The leaves the reference reads from their f32 masters stay f32 (norm
scales, the router and shared-expert gate, ``A_log`` and ``dt_bias``):
a bf16 router would route differently. Activations run in ``rt.dtype``.

The decode cache is updated in place where the reference returns a new
array from ``.at[].set``: that keeps one copy of the cache instead of
two. :func:`prefill` returns a fresh cache; :func:`decode_step` and
:func:`decode_step_paged` write into the cache they are given and return
it. The paged cache (a pool of pages per layer plus per-slot page
tables, ``paged_cache_spec``) serves :class:`~repro_torch.serve.paged.
PagedServeEngine`. ``ModelRuntime.kv_dtype='int8'`` stores either cache
quantized per (token, kv head), with bf16 scale side-bands ``ks``/``vs``.

Under a mesh (``dist.sharding.use_mesh`` + ``axis_rules``, as the
sharded engines run) :func:`forward`, :func:`prefill`,
:func:`decode_step` and :func:`decode_step_paged` take their
tensor-parallel forms, Megatron-style, on this rank's blocks of the
parameters (``dist.sharding.Placement``): ``wq``/``wk``/``wv``/``wg``/
``wi`` split by columns, ``wo``/``wo2`` by rows and summed over
``model`` after; an embedding split over the vocabulary looks up its
rows masked and sums over ``model``, and the unembedding gathers the
vocabulary. The cache specs give this rank's block (its K/V heads, its
slots over ``data``). With no mesh every function runs its one-device
form: the same launches and the same bits.

Under autograd (the sharded train step) every collective has its
gradient: each sum over ``model`` (g) is the identity backward; an f
(``Placement.enter_model``) stands exactly where a g does, on the
replicated tensor a column-split product reads (the normed ``h`` before
``wq``/``wk``/``wv``, ``h2`` before ``wg``/``wi``, ``x`` before a
vocabulary-split unembedding) and on the qk-norm scales, so each
input's gradient is summed over ``model`` once; ``wk``/``wv`` enter
through an f over the ranks that hold the same K/V heads. Where the
attention stays whole on every rank there is neither. Under a recipe
that splits ``embed`` over ``data`` (IS, ``*+zero3``) each leaf split
over ``data`` is gathered whole just before its layer runs, inside the
remat region, one layer at a time (the hybrid's shared block at each
use); the gather's backward sums over ``data``. The serving forms
gather the same way, each decode step's blocks one at a time and the
embedding and the head each just before its use, so their logits equal
the recipe's without the ``data`` split bit for bit (a gather is a
concatenation).

The MoE layer (``models.moe``) runs this rank's experts, or every
expert's columns, and the Mamba-2 mixer (``models.ssm``) this rank's SSD
heads; both sum their partial outputs over ``model``. :func:`forward`
and :func:`loss_fn` take this ``data`` rank's rows of the global batch
(the train step's ``make_global_batch``), so the MoE keeps its capacity,
slot order and aux loss global over ``data``; :func:`prefill` takes the
whole batch on every rank.
"""
from __future__ import annotations

import re
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import Placement, active_placement
from repro_torch.kernels.dispatch import KernelPolicy, dispatch
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (ParamDef, gelu, norm, norm_defs,
                                       swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} not supported; "
                         f"available: {sorted(_DTYPES)}") from None


def kv_torch_dtype(name: str) -> torch.dtype:
    """Storage dtype of a KV cache: an activation dtype or ``int8``."""
    return torch.int8 if name == "int8" else torch_dtype(name)


@dataclass(frozen=True)
class ModelRuntime:
    """Training/serving-time knobs (not part of the architecture).

    ``use_kernels`` defaults to True here (the reference defaults to
    False): the port's entry points run the hand-written kernels on the
    card. ``kernels`` overrides the bool with an explicit policy.
    ``kv_dtype`` is the KV cache's storage precision: None stores it at
    ``dtype``, a float dtype casts, ``int8`` quantizes each (token, kv
    head) row at write time with a bf16 scale side-band.
    ``moe_dropless`` runs the MoE prefill without capacity drops (as
    decode always does); ``moe_chunk`` is the GShard token-group size of
    the capacity path (0: one group). ``remat`` checkpoints each block's
    activations while a gradient is taken (:func:`_remat`: ``none``,
    ``dots`` — the reference's default — or ``full``); under
    ``torch.no_grad()`` (serving) nothing is checkpointed.
    """

    dtype: str = "bfloat16"
    remat: str = "dots"
    attn_chunk: int = 512
    use_kernels: bool = True
    kernels: Optional[KernelPolicy] = None
    device: str = "cuda"
    kv_dtype: Optional[str] = None
    moe_dropless: bool = False
    moe_chunk: int = 0

    def kernel_policy(self) -> KernelPolicy:
        if self.kernels is not None:
            return self.kernels
        return KernelPolicy.from_flag(self.use_kernels)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


#: Families the port runs: every family of the reference registry.
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

#: Leaves kept f32 by :func:`cast_params`: each is read from its f32
#: master by the reference.
F32_LEAVES = ("ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "norm",
              "router", "shared_gate", "A_log", "dt_bias")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not one the port "
            f"runs: {PORTED_FAMILIES}")


def check_device(device) -> torch.device:
    """The runtime's device; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


# ===========================================================================
# Parameter definitions
# ===========================================================================
def _attn_defs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s, sx = (n,), ("layers",)

    def stacked(defs):
        return {k: ParamDef(s + v.shape, v.init, v.scale, sx + v.axes)
                for k, v in defs.items()}

    defs: Dict[str, Any] = {
        "ln1": stacked(norm_defs(d, cfg.norm)),
        "wq": ParamDef(s + (d, nq * hd), axes=sx + ("embed", "heads")),
        "wk": ParamDef(s + (d, nkv * hd), axes=sx + ("embed", "kv_heads")),
        "wv": ParamDef(s + (d, nkv * hd), axes=sx + ("embed", "kv_heads")),
        "wo": ParamDef(s + (nq * hd, d), axes=sx + ("heads", "embed")),
        "ln2": stacked(norm_defs(d, cfg.norm)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(s + (hd,), "ones", axes=sx + (None,))
        defs["k_norm"] = ParamDef(s + (hd,), "ones", axes=sx + (None,))
    if cfg.moe is not None:
        defs["moe"] = MOE.moe_defs(cfg, stack=s)
    elif cfg.d_ff:
        if cfg.mlp == "swiglu":
            defs["wg"] = ParamDef(s + (d, cfg.d_ff),
                                  axes=sx + ("embed", "ffn"))
        defs["wi"] = ParamDef(s + (d, cfg.d_ff), axes=sx + ("embed", "ffn"))
        defs["wo2"] = ParamDef(s + (cfg.d_ff, d), axes=sx + ("ffn", "embed"))
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), "embed", axes=("vocab", "embed")),
        "final_norm": norm_defs(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), axes=("embed", "vocab"))
    if cfg.family in ("ssm", "hybrid"):
        n = (cfg.n_layers,)
        defs["blocks"] = {
            "ssm": SSM.ssm_defs(cfg, stack=n),
            "ln": {k: ParamDef(n + p.shape, p.init,
                               axes=("layers",) + p.axes)
                   for k, p in norm_defs(d, cfg.norm).items()},
        }
        if cfg.family == "hybrid":
            defs["shared"] = _attn_defs(cfg, cfg.n_shared_attn_blocks)
    else:
        defs["blocks"] = _attn_defs(cfg, cfg.n_layers)
    return defs


def axes_tree(cfg: ModelConfig):
    """Every parameter's logical axes, in the parameter tree's shape (the
    reference's ``axes_tree``): what a sharding recipe maps onto a
    mesh."""
    return L.axes_from_defs(param_defs(cfg))


def leaf_dtype(path, rt: ModelRuntime) -> torch.dtype:
    """The dtype :func:`cast_params` gives the leaf at ``path`` (its keys,
    or a ``"['a']['b']"`` string): f32 for the :data:`F32_LEAVES`, else
    ``rt.dtype``."""
    if isinstance(path, str):
        path = re.findall(r"\['([^']*)'\]", path)
    keep = any(p in F32_LEAVES for p in path)
    return torch.float32 if keep else rt.torch_dtype


def _cast_leaf(path, leaf: torch.Tensor, rt: ModelRuntime) -> torch.Tensor:
    return leaf.to(device=check_device(rt.device),
                   dtype=leaf_dtype(path, rt))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                rt: Optional[ModelRuntime] = None):
    """Seeded f32 master weights on ``device`` (CUDA unless asked). With
    ``rt``, each leaf is cast as :func:`cast_params` casts it right after
    it is drawn, so the f32 masters of a large model never coexist with
    its cast copy (full-width qwen2-moe: 57 GB of f32 masters against
    28.6 GB of bf16 weights)."""
    cast = None
    if rt is not None:
        def cast(path, leaf):
            return _cast_leaf(path, leaf, rt)
    return L.init_from_defs(param_defs(cfg), seed, check_device(device),
                            cast=cast)


def cast_params(params, rt: ModelRuntime):
    """Weights in ``rt.dtype`` on ``rt.device``, except the
    :data:`F32_LEAVES`, which stay f32. A leaf already in place is not
    copied."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return _cast_leaf(path, tree, rt)

    return walk(params)


def _layers(blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's weights as views into the stacked tensors, one
    ``unbind`` a leaf: under autograd its backward stacks the layers'
    gradients once, where a view ``v[i]`` a layer would add a full-size
    gradient each."""
    split = {k: (_layers(v) if isinstance(v, dict) else v.unbind(0))
             for k, v in blocks.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _schedule(params, cfg: ModelConfig) -> List[Tuple[str, int, Dict]]:
    """Every block in execution order as ``(kind, i, weights)``: kind
    ``mamba`` for Mamba-2 layer i, ``attn`` for attention block i, which
    for the hybrid is the shared block run after group i (``period``
    Mamba-2 layers), physical block ``i % n_shared_attn_blocks``. i
    indexes the cache leaves of its kind."""
    if cfg.family == "ssm":
        return [("mamba", i, p)
                for i, p in enumerate(_layers(params["blocks"]))]
    if cfg.family != "hybrid":
        return [("attn", i, p)
                for i, p in enumerate(_layers(params["blocks"]))]
    period = cfg.shared_attn_period
    shared = _layers(params["shared"])
    out = []
    for i, p in enumerate(_layers(params["blocks"])):
        out.append(("mamba", i, p))
        if (i + 1) % period == 0:
            g = i // period
            out.append(("attn", g, shared[g % len(shared)]))
    return out


def _kv_layers(cfg: ModelConfig) -> int:
    """Attention blocks whose K/V a cache holds: one per layer, or one
    per group of the hybrid (its shared blocks run once a group)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_period
    return cfg.n_layers


# ===========================================================================
# Blocks
# ===========================================================================
def _row_parallel(h: torch.Tensor, w: torch.Tensor, pl: Optional[Placement],
                  split: bool) -> torch.Tensor:
    """``h @ w``, summed over ``model`` where ``w`` is split by rows
    (``layers.row_parallel``; one device: the product as it is)."""
    return L.row_parallel(h, w, pl if pl is not None and split else None)


def _mlp(p: Dict[str, torch.Tensor], h: torch.Tensor,
         cfg: ModelConfig, pl: Optional[Placement] = None) -> torch.Tensor:
    if pl is not None and pl.ffn_split:
        h = pl.enter_model(h)
    if cfg.mlp == "swiglu":
        z = swiglu(h @ p["wg"].to(h.dtype), h @ p["wi"].to(h.dtype))
    else:
        z = gelu(h @ p["wi"].to(h.dtype))
    return _row_parallel(z, p["wo2"], pl, pl is not None and pl.ffn_split)


def _attn_proj(p, h, cfg: ModelConfig, policy=None,
               pl: Optional[Placement] = None):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd): the head counts are
    the weights' own (a rank's heads under a mesh)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    wk, wv = p["wk"], p["wv"]
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if pl is not None and pl.heads_split:
        h = pl.enter_model(h)
        wk, wv = pl.enter_kv(wk), pl.enter_kv(wv)
        if cfg.qk_norm:
            qn, kn = pl.enter_model(qn), pl.enter_model(kn)
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, -1, hd)
    k = (h @ wk.to(h.dtype)).reshape(B, S, -1, hd)
    v = (h @ wv.to(h.dtype)).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, qn, policy=policy)
        k = L.rmsnorm(k, kn, policy=policy)
    return q, k, v


def _ffn(p, h: torch.Tensor, cfg: ModelConfig, pol, dropless: bool,
         token_chunk: int = 0, pl: Optional[Placement] = None,
         rows_split: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on (B, S, d): the MoE layer (with its aux loss) or
    the dense MLP (aux None). ``rows_split``: h holds this ``data``
    rank's rows of the global batch (the MoE's semantics stay global)."""
    if cfg.moe is not None:
        return MOE.moe_ffn(p["moe"], h, cfg, dropless=dropless,
                           token_chunk=token_chunk, policy=pol, pl=pl,
                           rows_split=rows_split)
    return _mlp(p, h, cfg, pl), None


def _attn_out(o: torch.Tensor, p, x: torch.Tensor,
              pl: Optional[Placement]) -> torch.Tensor:
    """The attention output projection, summed over ``model`` where the
    heads are split."""
    return _row_parallel(o, p["wo"], pl, pl is not None and pl.heads_split)


def attn_block(p: Dict[str, Any], x: torch.Tensor, rope,
               cfg: ModelConfig, rt: ModelRuntime,
               pl: Optional[Placement] = None, rows_split: bool = False):
    """Pre-norm attention + FFN block. Returns (x, aux or None, (k, v));
    k/v are post-RoPE, exactly what the decode cache stores."""
    pol = rt.kernel_policy()
    h = norm(x, p["ln1"], cfg.norm, policy=pol)
    q, k, v = _attn_proj(p, h, cfg, policy=pol, pl=pl)
    q, k = L.apply_rope(q, k, rope, cfg)
    o = dispatch("prefill_attention", pol, q, k, v, causal=cfg.causal,
                 window=cfg.sliding_window, chunk=rt.attn_chunk)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    x = x + _attn_out(o, p, x, pl)
    h2 = norm(x, p["ln2"], cfg.norm, policy=pol)
    y, aux = _ffn(p, h2, cfg, pol, rt.moe_dropless, rt.moe_chunk, pl,
                  rows_split)
    return x + y, aux, (k, v)


def mamba_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                rt: ModelRuntime, pl: Optional[Placement] = None):
    """Pre-norm Mamba-2 block. Returns (x, {'conv', 'ssm'} final states
    for the prefill handoff; this rank's heads under a mesh)."""
    pol = rt.kernel_policy()
    h = norm(x, p["ln"], cfg.norm, policy=pol)
    y, state = SSM.ssm_block(p["ssm"], h, cfg, policy=pol, pl=pl)
    return x + y, state


# ===========================================================================
# Forward
# ===========================================================================
def _default_positions(cfg: ModelConfig, B: int, S: int,
                       device) -> torch.Tensor:
    """(B, S) positions 0..S-1, broadcast to (3, B, S) for M-RoPE."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    if cfg.rope == "mrope":
        return pos[None].expand(3, B, S)
    return pos.expand(B, S)


def _positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor], B: int,
               S: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        return _default_positions(cfg, B, S, device)
    return positions


def _lookup(params, tokens: torch.Tensor, rt: ModelRuntime,
            pl: Optional[Placement] = None) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``rt.dtype``. Split over the
    vocabulary, each rank looks up the tokens its rows hold (zeros
    elsewhere) and the ranks' rows are summed over ``model``: exactly one
    is non-zero, so the sum is exact."""
    emb = params["embed"].to(rt.torch_dtype)
    if pl is None or not pl.vocab_split:
        return emb[tokens.long()]
    t = tokens.long() - pl.vocab_start
    hit = (t >= 0) & (t < emb.shape[0])
    x = emb[t.clamp(0, emb.shape[0] - 1)] * hit[..., None].to(emb.dtype)
    return pl.reduce_model(x)


def _embed_in(params, batch: Dict[str, torch.Tensor],
              rt: ModelRuntime, pl: Optional[Placement] = None
              ) -> torch.Tensor:
    """The token embedding, or ``batch['embeds']`` (B, S, d) from a
    stubbed patch or frame front-end, in ``rt.dtype``."""
    if "embeds" in batch:
        return batch["embeds"].to(rt.torch_dtype)
    return _lookup(params, batch["tokens"], rt, pl)


def _serve_lookup(params, cfg: ModelConfig, tokens: torch.Tensor,
                  rt: ModelRuntime, pl: Optional[Placement]) -> torch.Tensor:
    """:func:`_lookup` for the serving forms, whose blocks stay this
    rank's: where the recipe splits the embedding over ``data`` the
    table is gathered whole for the lookup and dropped after it. The
    table, not the looked-up rows: each ``data`` rank decodes other
    slots, so gathering rows would need every rank's tokens first, and
    a tied head gathers the table at the end of the step anyway. Both
    are exact."""
    return _lookup(_outer(params, cfg, pl, ("embed",)), tokens, rt, pl)


def _unembed(params, cfg: ModelConfig, x: torch.Tensor,
             pl: Optional[Placement] = None) -> torch.Tensor:
    """Logits over the whole vocabulary: a rank's columns, gathered over
    ``model`` where the vocabulary is split."""
    if pl is not None and pl.vocab_split:
        x = pl.enter_model(x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).t()
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if pl is not None and pl.vocab_split:
        logits = pl.gather_model(logits, -1)
    return logits


def _save_dots(ctx, op, *args, **kwargs):
    """``dots``: keep the outputs of matmuls without batch dims (the
    reference's ``checkpoint_dots_with_no_batch_dims``), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, rt: ModelRuntime):
    """``fn`` (one block) under ``rt.remat`` while a gradient is taken:
    ``full`` saves only the block's inputs and recomputes the rest in
    the backward pass, ``dots`` also saves the matmul outputs. The
    gradients are the same either way."""
    if rt.remat == "none" or not torch.is_grad_enabled():
        return fn
    if rt.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if rt.remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_dots))
    raise ValueError(f"remat {rt.remat!r} not supported; available: "
                     f"none, dots, full")


#: :func:`data_dims` of each live placement (a mesh keeps its placements).
_DATA_DIMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def data_dims(cfg: ModelConfig, pl: Placement):
    """Every parameter's dim split over ``data`` under ``pl`` (None where
    the leaf is whole over ``data``), in the parameter tree's shape."""
    if pl not in _DATA_DIMS:
        def walk(d):
            if isinstance(d, dict):
                return {k: walk(v) for k, v in d.items()}
            return pl.split_dim(d.axes, d.shape)
        _DATA_DIMS[pl] = walk(param_defs(cfg))
    return _DATA_DIMS[pl]


def _gather_data(p, dims, pl: Optional[Placement], stacked: bool = True):
    """``p`` with every leaf that is split over ``data`` gathered whole
    (IS); ``stacked=False`` for one layer's leaves, whose stacked
    ``layers`` dim is gone. One device: ``p`` as it is."""
    if pl is None:
        return p
    out = {}
    for k, v in p.items():
        d = dims[k]
        if isinstance(v, dict):
            out[k] = _gather_data(v, d, pl, stacked)
        else:
            out[k] = v if d is None else pl.gather_data(
                v, d if stacked else d - 1)
    return out


def _layer_dims(cfg: ModelConfig, pl: Optional[Placement]):
    """:func:`data_dims` of one block of each :func:`_schedule` kind:
    ``attn`` (the hybrid's shared blocks) and ``mamba``; None on one
    device."""
    if pl is None:
        return None
    dims = data_dims(cfg, pl)
    return {"attn": dims["shared" if cfg.family == "hybrid" else "blocks"],
            "mamba": dims["blocks"]}


def _outer(params, cfg: ModelConfig, pl: Optional[Placement],
           keys: Optional[Tuple[str, ...]] = None):
    """``params`` with its leaves outside the blocks (``keys`` of them,
    default all) gathered whole over ``data`` where the recipe splits
    them (IS, ``*+zero3``); the blocks stay this rank's. One device:
    ``params`` as it is."""
    if pl is None:
        return params
    keys = [k for k in params if k not in ("blocks", "shared")
            and (keys is None or k in keys)]
    return dict(params, **_gather_data({k: params[k] for k in keys},
                                       data_dims(cfg, pl), pl))


def _head_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The leaves the final norm and the unembedding read."""
    return ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")


def _run_blocks(params, cfg: ModelConfig, x, positions, rt: ModelRuntime,
                on_layer=None, pl: Optional[Placement] = None,
                rows_split: bool = False):
    """Every block in :func:`_schedule`'s order, each under ``rt.remat``
    (the reference remats a hybrid group whole; the gradients are the
    same); ``on_layer(i, material)`` receives each block's cache
    material: ``(k, v)`` for attention block i, the ``{conv, ssm}`` final
    states for Mamba-2 layer i. Returns (x, summed aux loss f32). Under
    a recipe that splits weights over ``data`` each block gathers its
    layer's leaves first, inside its remat region (the hybrid's shared
    block at each of its uses). ``rows_split``: x holds this ``data``
    rank's rows of the global batch."""
    aux = torch.zeros((), device=x.device)
    rope = None if cfg.family == "ssm" else L.rope_tables(positions, cfg)
    dims = _layer_dims(cfg, pl)

    def attn(p, x_):
        p = _gather_data(p, dims and dims["attn"], pl, stacked=False)
        x_, a, kv = attn_block(p, x_, rope, cfg, rt, pl, rows_split)
        return x_, kv, a

    def mamba(p, x_):
        p = _gather_data(p, dims and dims["mamba"], pl, stacked=False)
        return mamba_block(p, x_, cfg, rt, pl) + (None,)

    blocks = {"attn": _remat(attn, rt), "mamba": _remat(mamba, rt)}
    for kind, i, p in _schedule(params, cfg):
        x, material, a = blocks[kind](p, x)
        if a is not None:
            aux = aux + a
        if on_layer is not None:
            on_layer(i, material)
    return x, aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rt: ModelRuntime = ModelRuntime()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batch``: ``tokens`` (B, S), or ``embeds`` (B, S, d) for a patch
    or frame front-end; ``positions`` (B, S), or (3, B, S) under M-RoPE,
    default 0..S-1. -> (logits (B, S, V) in rt.dtype, aux_loss scalar
    f32: the MoE layers' summed load-balancing loss, else 0)."""
    _require_ported(cfg)
    pl = active_placement(cfg)
    params = _outer(params, cfg, pl)   # the embedding, final norm and head
    x = _embed_in(params, batch, rt, pl)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    x, aux = _run_blocks(params, cfg, x, positions, rt, pl=pl,
                         rows_split=pl is not None and pl.batch_split)
    x = norm(x, params["final_norm"], cfg.norm, policy=rt.kernel_policy())
    return _unembed(params, cfg, x, pl), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rt: ModelRuntime = ModelRuntime()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss: token cross-entropy of ``batch['labels']`` plus the
    MoE aux loss -> (ce + aux, {'ce', 'aux'})."""
    logits, aux = forward(params, cfg, batch, rt)
    ce = L.cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def _fill_kv_window(out: torch.Tensor, k_full: torch.Tensor) -> None:
    """Place (B, S, Hkv, hd) prefill keys into the zeroed W-slot circular
    cache ``out`` (B, W, Hkv, hd), in place: the key at absolute position
    p lives in slot p % W (the last W are kept)."""
    W = out.shape[1]
    S = k_full.shape[1]
    if S <= W:
        out[:, :S] = k_full
        return
    idx = torch.arange(S - W, S, device=out.device) % W
    out[:, idx] = k_full[:, -W:]


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int, rt: ModelRuntime = ModelRuntime(),
            lengths: Optional[torch.Tensor] = None,
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One-pass prefill: returns (primed cache, last-token logits (B, V)).

    ``batch`` holds ``tokens`` (or ``embeds``) and, optionally,
    ``positions``, as :func:`forward` takes them. ``lengths`` (B,) marks
    each row's real prompt length when the batch is right-padded to a
    bucketed length: the cache position is set to the real length and
    the logits are gathered at ``lengths - 1``. The pad keys land at cache rows ``>= length``,
    where the decode mask hides them until they are overwritten. A
    recurrent state would absorb pad tokens, so the ``ssm`` and
    ``hybrid`` families take exact-length rows (the scheduler's chunk
    mode). Under a mesh every rank prefills every row (the batch stays
    whole: the engine splices each row into the rank that holds its
    slot) on its own heads.
    """
    _require_ported(cfg)
    pl = active_placement(cfg)
    x = (_embed_in(params, batch, rt, pl) if "embeds" in batch
         else _serve_lookup(params, cfg, batch["tokens"], rt, pl))
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    cache = init_cache(cfg, B, max_len, rt.dtype, rt.kv_dtype,
                       device=x.device, whole_batch=True)
    quant = "ks" in cache

    def on_layer(i, material):
        if isinstance(material, dict):   # conv in rt.dtype, ssm in f32
            cache["conv"][i] = material["conv"]
            cache["ssm"][i] = material["ssm"]
            return
        k, v = material
        if quant:        # quantize at write time, as the reference does
            k, ks = quantize_rows(k)
            v, vs = quantize_rows(v)
            _fill_kv_window(cache["ks"][i], ks)
            _fill_kv_window(cache["vs"][i], vs)
        _fill_kv_window(cache["k"][i], k)
        _fill_kv_window(cache["v"][i], v)

    x, _ = _run_blocks(params, cfg, x, positions, rt, on_layer, pl)
    if lengths is None:
        cache["pos"].fill_(S)
    else:
        cache["pos"].copy_(torch.as_tensor(lengths, dtype=torch.int32))
    # a gather, not a slice: the kernels take contiguous rows only
    idx = torch.clamp(cache["pos"].long() - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx][:, None, :]
    head = _outer(params, cfg, pl, _head_keys(cfg))
    x = norm(x_last, head["final_norm"], cfg.norm,
             policy=rt.kernel_policy())
    return cache, _unembed(head, cfg, x, pl)[:, 0]


# ===========================================================================
# Decode (KV caches)
# ===========================================================================
def _cache_window(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def cache_token_budget(cfg: ModelConfig, max_len: int,
                       prompt_len: int) -> int:
    """How many *new* tokens a sequence of ``prompt_len`` may decode
    before its cache positions exceed ``max_len``; a non-positive return
    means the prompt itself cannot be admitted. :func:`decode_step`
    writes at ``pos % W``, so a write past ``max_len`` would wrap onto
    live context: serving callers must never decode past this budget."""
    return max_len - prompt_len


def _kv_spec(shape: Tuple[int, ...], kvd: str):
    """K/V leaves of ``shape`` stored as ``kvd``, plus the bf16 scale
    side-bands (the shape without head_dim) under int8."""
    spec = {"k": (shape, kv_torch_dtype(kvd)),
            "v": (shape, kv_torch_dtype(kvd))}
    if kvd == "int8":
        spec["ks"] = (shape[:-1], torch.bfloat16)
        spec["vs"] = (shape[:-1], torch.bfloat16)
    return spec


def _placed(cfg: ModelConfig, spec, axes, whole_batch: bool = False):
    """``spec`` at this rank's block shapes under the ambient mesh (as it
    is on one device); ``whole_batch`` keeps the batch dim whole."""
    pl = active_placement(cfg)
    if pl is None:
        return spec
    return pl.local_spec(spec, axes, ("batch",) if whole_batch else ())


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", kv_dtype: Optional[str] = None,
               whole_batch: bool = False
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the contiguous decode cache: K/V for the
    attention blocks (``kv_dtype`` overrides their storage dtype, default
    ``dtype``; the hybrid's one per group), the recurrent state for the
    ``ssm`` and ``hybrid`` families (``conv`` in ``dtype``, ``ssm`` in
    f32). Under a mesh, this rank's block of each leaf (its K/V heads,
    and its slots unless ``whole_batch``)."""
    _require_ported(cfg)
    spec = {"pos": ((batch,), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        spec.update(_state_spec(cfg, batch, dtype))
    if cfg.family != "ssm":
        W = _cache_window(cfg, max_len)
        kv = (_kv_layers(cfg), batch, W, cfg.n_kv_heads, cfg.head_dim)
        spec.update(_kv_spec(kv, kv_dtype or dtype))
    return _placed(cfg, spec, CACHE_AXES, whole_batch)


def _state_spec(cfg: ModelConfig, batch: int, dtype: str):
    cs = SSM.ssm_cache_shapes(cfg, batch)
    return {"conv": ((cfg.n_layers,) + cs["conv"], torch_dtype(dtype)),
            "ssm": ((cfg.n_layers,) + cs["ssm"], torch.float32)}


#: Declared logical axes of every cache leaf; the serving engine splices
#: by the ``batch`` axis named here, never by shape.
CACHE_AXES = {
    "pos": ("batch",),
    "k": (None, "batch", "kv_seq", "kv_heads", None),
    "v": (None, "batch", "kv_seq", "kv_heads", None),
    "ks": (None, "batch", "kv_seq", "kv_heads"),
    "vs": (None, "batch", "kv_seq", "kv_heads"),
    "conv": (None, "batch", None, "ssm_inner"),
    "ssm": (None, "batch", "ssm_heads", None, None),
}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", kv_dtype: Optional[str] = None,
               device="cuda", whole_batch: bool = False):
    dev = check_device(device)
    return {k: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in cache_spec(cfg, batch, max_len, dtype,
                                        kv_dtype, whole_batch).items()}


def _store_kv(kv, idx, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write each sequence's new K/V row at ``idx`` (a tuple of index
    tensors) of one layer's cache ``kv = (k, v, ks, vs)``, in place. An
    int8 cache (``ks`` not None) quantizes the rows here, once."""
    kc, vc, ksc, vsc = kv
    if ksc is None:
        kc[idx] = k.to(kc.dtype)
        vc[idx] = v.to(vc.dtype)
        return
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    kc[idx], vc[idx] = kq, vq
    ksc[idx], vsc[idx] = ks.to(ksc.dtype), vs.to(vsc.dtype)


def _attn_decode_one(p, x, kv, idx, attend, rope, cfg: ModelConfig,
                     rt: ModelRuntime, pl: Optional[Placement] = None,
                     rows=None):
    """One-layer attention for one token. x: (B, d). The new K/V row is
    written in place at ``idx`` of the layer's cache ``kv`` *before*
    attention; ``attend(q, kv)`` is the attention over that cache.
    ``rows``, when given, maps the new K/V rows to the rows ``idx``
    addresses (a pool every rank over ``data`` holds whole takes every
    rank's rows)."""
    B = x.shape[0]
    pol = rt.kernel_policy()
    h = norm(x, p["ln1"], cfg.norm, policy=pol)[:, None, :]   # (B,1,d)
    q, k, v = _attn_proj(p, h, cfg, policy=pol, pl=pl)
    q, k = L.apply_rope(q, k, rope, cfg)
    k, v = k[:, 0], v[:, 0]
    if rows is not None:
        k, v = rows(k), rows(v)
    _store_kv(kv, idx, k, v)
    o = attend(q[:, 0], kv)
    x = x + _attn_out(o.reshape(B, -1), p, x, pl)
    h2 = norm(x, p["ln2"], cfg.norm, policy=pol)
    return x + _ffn(p, h2[:, None, :], cfg, pol, dropless=True,
                    pl=pl)[0][:, 0]


def _mamba_decode_one(p, x, cache, i: int, cfg: ModelConfig, pol,
                      pl: Optional[Placement] = None):
    """One Mamba-2 layer for one token; layer i's state is written back
    into the cache in place."""
    h = norm(x, p["ln"], cfg.norm, policy=pol)
    y, st = SSM.ssm_decode_step(p["ssm"], h, {
        "conv": cache["conv"][i], "ssm": cache["ssm"][i]}, cfg, policy=pol,
        pl=pl)
    cache["conv"][i] = st["conv"]
    cache["ssm"][i] = st["ssm"]
    return x + y


def _decode_blocks(params, cfg: ModelConfig, cache, x, rt: ModelRuntime,
                   names=(), pos=None, idx=None, op: str = "",
                   tail=(), pl: Optional[Placement] = None,
                   rows=None) -> torch.Tensor:
    """Every block for one token in :func:`_schedule`'s order, then the
    final norm and the unembedding. Mamba-2 layer i updates its state in
    the cache; attention block i's cache is ``cache[n][i]`` for the
    leaves ``names = (k, v, ks, vs)`` (the scales absent from a float
    cache), its new row written at ``idx``, and attention is the
    dispatch op ``op`` on the query, the cache leaves present, then
    ``tail`` (the mask, after the page table if paged).

    Under a recipe that splits weights over ``data`` (IS, ``*+zero3``)
    each block's leaves are gathered whole just before it runs and
    dropped after it (the hybrid's shared block at each of its uses),
    then the final norm and the head: a rank holds its resident blocks
    plus one gathered layer, never the whole tree. Every rank makes the
    same gathers in the same order: the sharded engines run each decode
    step on every rank at once (lockstep), and a rank that skipped a
    gather would hang the mesh."""
    pol = rt.kernel_policy()
    dims = _layer_dims(cfg, pl)

    def attend(q, kv):
        return dispatch(op, pol, q, *(t for t in kv if t is not None), *tail)

    rope = None
    if cfg.family != "ssm":
        posv = pos[:, None]                                  # (B, 1)
        if cfg.rope == "mrope":
            posv = posv[None].expand(3, -1, -1)              # (3, B, 1)
        rope = L.rope_tables(posv, cfg)
    for kind, i, p in _schedule(params, cfg):
        p = _gather_data(p, dims and dims[kind], pl, stacked=False)
        if kind == "mamba":
            x = _mamba_decode_one(p, x, cache, i, cfg, pol, pl)
            continue
        kv = tuple(cache[n][i] if n in cache else None for n in names)
        x = _attn_decode_one(p, x, kv, idx, attend, rope, cfg, rt, pl, rows)
    del p                                # the last gathered layer
    head = _outer(params, cfg, pl, _head_keys(cfg))
    x = norm(x[:, None, :], head["final_norm"], cfg.norm, policy=pol)
    return _unembed(head, cfg, x, pl)[:, 0]


def decode_step(params, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, rt: ModelRuntime = ModelRuntime(),
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """tokens: (B,) -> (cache, logits (B, V)). The cache is updated in
    place (K/V rows and the recurrent state, and ``pos + 1``) and
    returned. Under a mesh: this rank's slots and heads."""
    _require_ported(cfg)
    pl = active_placement(cfg)
    pos = cache["pos"]
    x = _serve_lookup(params, cfg, tokens, rt, pl)               # (B, d)
    if cfg.family == "ssm":
        logits = _decode_blocks(params, cfg, cache, x, rt, pl=pl)
        pos += 1
        return cache, logits
    W = cache["k"].shape[2]
    idx = (torch.arange(x.shape[0], device=pos.device), (pos % W).long())
    mask = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    op = "quant_decode_attention" if "ks" in cache else "decode_attention"
    logits = _decode_blocks(params, cfg, cache, x, rt,
                            ("k", "v", "ks", "vs"), pos, idx, op, (mask,),
                            pl)
    pos += 1
    return cache, logits


# ---------------------------------------------------------------------------
# Paged cache (a pool of pages per layer + per-slot page tables)
# ---------------------------------------------------------------------------
def page_count(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache rows (ceil division)."""
    return -(-int(tokens) // int(page_size))


def paged_cache_spec(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, max_len: int, dtype: str = "bfloat16",
                     kv_dtype: Optional[str] = None
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the paged decode cache: ``kp``/``vp``
    ``(L, n_pages, page_size, Hkv, hd)`` pools addressed through per-slot
    page tables ``pt (n_slots, ceil(W / page_size))``, and under int8 the
    pooled scales ``ks``/``vs (L, n_pages, page_size, Hkv)``; L counts
    the attention blocks (the hybrid's groups). Under a mesh, this
    rank's block (its K/V heads of every page, its slots' tables). Physical page 0 is the
    null page: unowned table entries point at it and retired slots write
    their masked decode rows into it. Recurrent state (``ssm``,
    ``hybrid``) stays contiguous per slot; the ``ssm`` family has no KV
    to page (the table rides along unused)."""
    _require_ported(cfg)
    W = _cache_window(cfg, max_len)
    spec = {"pos": ((n_slots,), torch.int32),
            "pt": ((n_slots, page_count(W, page_size)), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        spec.update(_state_spec(cfg, n_slots, dtype))
    if cfg.family == "ssm":
        return _placed(cfg, spec, PAGED_CACHE_AXES)
    shape = (_kv_layers(cfg), n_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    kv = _kv_spec(shape, kv_dtype or dtype)
    spec = dict(spec, kp=kv["k"], vp=kv["v"],
                **{n: kv[n] for n in ("ks", "vs") if n in kv})
    return _placed(cfg, spec, PAGED_CACHE_AXES)


#: Logical axes of the paged cache: the pools have no batch axis (the
#: slots share them through their tables).
PAGED_CACHE_AXES = {
    "pos": ("batch",),
    "pt": ("batch", None),
    "kp": (None, None, None, "kv_heads", None),
    "vp": (None, None, None, "kv_heads", None),
    "ks": (None, None, None, "kv_heads"),
    "vs": (None, None, None, "kv_heads"),
    "conv": CACHE_AXES["conv"],
    "ssm": CACHE_AXES["ssm"],
}


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, max_len: int, dtype: str = "bfloat16",
                     kv_dtype: Optional[str] = None, device="cuda"):
    dev = check_device(device)
    return {k: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in paged_cache_spec(
                cfg, n_slots, n_pages, page_size, max_len, dtype,
                kv_dtype).items()}


def _scatter_rows_to_pages(pool: torch.Tensor, rows: torch.Tensor,
                           page_ids: torch.Tensor, page_size: int) -> None:
    """Write (L, width, S, ...) contiguous rows into an (L, n_pages,
    page_size, ...) pool at ``page_ids (width, n_write)``, in place: row r
    of a sequence lands in its page ``r // page_size``. Pad entries of
    ``page_ids`` repeat the null page; which of their writes lands there
    is unspecified, and nothing reads it."""
    L_, width, S = rows.shape[:3]
    n_write = page_ids.shape[1]
    need = n_write * page_size
    if need > S:
        rows = torch.cat([rows, rows.new_zeros(
            (L_, width, need - S) + tuple(rows.shape[3:]))], dim=2)
    blocks = rows[:, :, :need].reshape(
        (L_, width * n_write, page_size) + tuple(rows.shape[3:]))
    pool[:, page_ids.reshape(-1).long()] = blocks.to(pool.dtype)


def write_prefill_pages(kp, vp, k, v, page_ids, *, page_size: int) -> None:
    """Scatter the prefill cache's (L, width, W, Hkv, hd) K/V rows into the
    page pools through ``page_ids (width, n_write)``, in place."""
    _scatter_rows_to_pages(kp, k, page_ids, page_size)
    _scatter_rows_to_pages(vp, v, page_ids, page_size)


def write_prefill_pages_quant(kp, vp, ks_pool, vs_pool, k, v, ks, vs,
                              page_ids, *, page_size: int) -> None:
    """int8 twin of :func:`write_prefill_pages`: the already quantized
    payload rows and their (L, width, W, Hkv) scales."""
    write_prefill_pages(kp, vp, k, v, page_ids, page_size=page_size)
    _scatter_rows_to_pages(ks_pool, ks, page_ids, page_size)
    _scatter_rows_to_pages(vs_pool, vs, page_ids, page_size)


def decode_step_paged(params, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      rt: ModelRuntime, *, page_size: int, window: int,
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Paged twin of :func:`decode_step`: each new K/V row is written
    through the page table at physical page ``pt[b, (pos % W) // ps]``,
    row ``(pos % W) % ps``, and attention reads the pools through the
    table (``paged_decode_attention``, or ``quant_paged_decode_attention``
    under int8); the hybrid's Mamba-2 layers update their contiguous
    state as :func:`decode_step` does. Updated in place and returned.
    The ``ssm`` family has no pages: it decodes as :func:`decode_step`
    does. Under a mesh the pools are whole over ``data`` while the slots
    split: each step's new K/V rows (and their addresses) are gathered
    over ``data`` and written into every rank's pool, so the pools stay
    equal and a shared prefix page reads the same rows everywhere."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return decode_step(params, cfg, cache, tokens, rt)
    pl = active_placement(cfg)
    pos, pt = cache["pos"], cache["pt"]
    x = _serve_lookup(params, cfg, tokens, rt, pl)               # (B, d)
    W, ps = window, page_size
    row = (pos % W).long()
    phys = torch.gather(pt, 1, (row // ps)[:, None])[:, 0].long()
    ar = torch.arange(pt.shape[1] * ps, device=pos.device)[None, :]
    mask = (ar <= pos[:, None]) & (ar < W)
    op = ("quant_paged_decode_attention" if "ks" in cache
          else "paged_decode_attention")
    idx, rows = (phys, row % ps), None
    if pl is not None and pl.batch_split:
        idx = (pl.gather_batch(phys), pl.gather_batch(row % ps))
        rows = pl.gather_batch
    logits = _decode_blocks(params, cfg, cache, x, rt,
                            ("kp", "vp", "ks", "vs"), pos, idx,
                            op, (pt, mask), pl, rows)
    pos += 1
    return cache, logits
