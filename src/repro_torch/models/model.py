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
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
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
    s = (n,)

    def stacked(defs):
        return {k: ParamDef(s + v.shape, v.init, v.scale)
                for k, v in defs.items()}

    defs: Dict[str, Any] = {
        "ln1": stacked(norm_defs(d, cfg.norm)),
        "wq": ParamDef(s + (d, nq * hd)),
        "wk": ParamDef(s + (d, nkv * hd)),
        "wv": ParamDef(s + (d, nkv * hd)),
        "wo": ParamDef(s + (nq * hd, d)),
        "ln2": stacked(norm_defs(d, cfg.norm)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(s + (hd,), "ones")
        defs["k_norm"] = ParamDef(s + (hd,), "ones")
    if cfg.moe is not None:
        defs["moe"] = MOE.moe_defs(cfg, stack=s)
    elif cfg.d_ff:
        if cfg.mlp == "swiglu":
            defs["wg"] = ParamDef(s + (d, cfg.d_ff))
        defs["wi"] = ParamDef(s + (d, cfg.d_ff))
        defs["wo2"] = ParamDef(s + (cfg.d_ff, d))
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), "embed"),
        "final_norm": norm_defs(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v))
    if cfg.family in ("ssm", "hybrid"):
        n = (cfg.n_layers,)
        defs["blocks"] = {
            "ssm": SSM.ssm_defs(cfg, stack=n),
            "ln": {k: ParamDef(n + p.shape, p.init)
                   for k, p in norm_defs(d, cfg.norm).items()},
        }
        if cfg.family == "hybrid":
            defs["shared"] = _attn_defs(cfg, cfg.n_shared_attn_blocks)
    else:
        defs["blocks"] = _attn_defs(cfg, cfg.n_layers)
    return defs


def _cast_leaf(path, leaf: torch.Tensor, rt: ModelRuntime) -> torch.Tensor:
    keep = any(p in F32_LEAVES for p in path)
    return leaf.to(device=check_device(rt.device),
                   dtype=torch.float32 if keep else rt.torch_dtype)


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
            return _cast_leaf(re.findall(r"\['([^']*)'\]", path), leaf, rt)
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
def _mlp(p: Dict[str, torch.Tensor], h: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        z = swiglu(h @ p["wg"].to(h.dtype), h @ p["wi"].to(h.dtype))
    else:
        z = gelu(h @ p["wi"].to(h.dtype))
    return z @ p["wo2"].to(h.dtype)


def _attn_proj(p, h, cfg: ModelConfig, policy=None):
    B, S, _ = h.shape
    hd = cfg.head_dim
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], policy=policy)
        k = L.rmsnorm(k, p["k_norm"], policy=policy)
    return q, k, v


def _ffn(p, h: torch.Tensor, cfg: ModelConfig, pol, dropless: bool,
         token_chunk: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on (B, S, d): the MoE layer (with its aux loss) or
    the dense MLP (aux None)."""
    if cfg.moe is not None:
        return MOE.moe_ffn(p["moe"], h, cfg, dropless=dropless,
                           token_chunk=token_chunk, policy=pol)
    return _mlp(p, h, cfg), None


def attn_block(p: Dict[str, Any], x: torch.Tensor, rope,
               cfg: ModelConfig, rt: ModelRuntime):
    """Pre-norm attention + FFN block. Returns (x, aux or None, (k, v));
    k/v are post-RoPE, exactly what the decode cache stores."""
    pol = rt.kernel_policy()
    h = norm(x, p["ln1"], cfg.norm, policy=pol)
    q, k, v = _attn_proj(p, h, cfg, policy=pol)
    q, k = L.apply_rope(q, k, rope, cfg)
    o = dispatch("prefill_attention", pol, q, k, v, causal=cfg.causal,
                 window=cfg.sliding_window, chunk=rt.attn_chunk)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    x = x + o @ p["wo"].to(x.dtype)
    h2 = norm(x, p["ln2"], cfg.norm, policy=pol)
    y, aux = _ffn(p, h2, cfg, pol, rt.moe_dropless, rt.moe_chunk)
    return x + y, aux, (k, v)


def mamba_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                rt: ModelRuntime):
    """Pre-norm Mamba-2 block. Returns (x, {'conv', 'ssm'} final states
    for the prefill handoff)."""
    pol = rt.kernel_policy()
    h = norm(x, p["ln"], cfg.norm, policy=pol)
    y, state = SSM.ssm_block(p["ssm"], h, cfg, policy=pol)
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


def _embed_in(params, batch: Dict[str, torch.Tensor],
              rt: ModelRuntime) -> torch.Tensor:
    """The token embedding, or ``batch['embeds']`` (B, S, d) from a
    stubbed patch or frame front-end, in ``rt.dtype``."""
    if "embeds" in batch:
        return batch["embeds"].to(rt.torch_dtype)
    return params["embed"].to(rt.torch_dtype)[batch["tokens"].long()]


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).t()
    return x @ params["lm_head"].to(x.dtype)


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


def _run_blocks(params, cfg: ModelConfig, x, positions, rt: ModelRuntime,
                on_layer=None):
    """Every block in :func:`_schedule`'s order, each under ``rt.remat``
    (the reference remats a hybrid group whole; the gradients are the
    same); ``on_layer(i, material)`` receives each block's cache
    material: ``(k, v)`` for attention block i, the ``{conv, ssm}`` final
    states for Mamba-2 layer i. Returns (x, summed aux loss f32)."""
    aux = torch.zeros((), device=x.device)
    rope = None if cfg.family == "ssm" else L.rope_tables(positions, cfg)

    def attn(p, x_):
        x_, a, kv = attn_block(p, x_, rope, cfg, rt)
        return x_, kv, a

    def mamba(p, x_):
        return mamba_block(p, x_, cfg, rt) + (None,)

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
    x = _embed_in(params, batch, rt)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    x, aux = _run_blocks(params, cfg, x, positions, rt)
    x = norm(x, params["final_norm"], cfg.norm, policy=rt.kernel_policy())
    return _unembed(params, cfg, x), aux


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
    mode).
    """
    _require_ported(cfg)
    x = _embed_in(params, batch, rt)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    cache = init_cache(cfg, B, max_len, rt.dtype, rt.kv_dtype,
                       device=x.device)
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

    x, _ = _run_blocks(params, cfg, x, positions, rt, on_layer)
    if lengths is None:
        cache["pos"].fill_(S)
    else:
        cache["pos"].copy_(torch.as_tensor(lengths, dtype=torch.int32))
    # a gather, not a slice: the kernels take contiguous rows only
    idx = torch.clamp(cache["pos"].long() - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx][:, None, :]
    x = norm(x_last, params["final_norm"], cfg.norm,
             policy=rt.kernel_policy())
    return cache, _unembed(params, cfg, x)[:, 0]


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


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", kv_dtype: Optional[str] = None
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the contiguous decode cache: K/V for the
    attention blocks (``kv_dtype`` overrides their storage dtype, default
    ``dtype``; the hybrid's one per group), the recurrent state for the
    ``ssm`` and ``hybrid`` families (``conv`` in ``dtype``, ``ssm`` in
    f32)."""
    _require_ported(cfg)
    spec = {"pos": ((batch,), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        spec.update(_state_spec(cfg, batch, dtype))
    if cfg.family == "ssm":
        return spec
    W = _cache_window(cfg, max_len)
    kv = (_kv_layers(cfg), batch, W, cfg.n_kv_heads, cfg.head_dim)
    return dict(spec, **_kv_spec(kv, kv_dtype or dtype))


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
               device="cuda"):
    dev = check_device(device)
    return {k: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in cache_spec(cfg, batch, max_len, dtype,
                                        kv_dtype).items()}


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
                     rt: ModelRuntime):
    """One-layer attention for one token. x: (B, d). The new K/V row is
    written in place at ``idx`` of the layer's cache ``kv`` *before*
    attention; ``attend(q, kv)`` is the attention over that cache."""
    B = x.shape[0]
    pol = rt.kernel_policy()
    h = norm(x, p["ln1"], cfg.norm, policy=pol)[:, None, :]   # (B,1,d)
    q, k, v = _attn_proj(p, h, cfg, policy=pol)
    q, k = L.apply_rope(q, k, rope, cfg)
    _store_kv(kv, idx, k[:, 0], v[:, 0])
    o = attend(q[:, 0], kv)
    x = x + o.reshape(B, -1) @ p["wo"].to(x.dtype)
    h2 = norm(x, p["ln2"], cfg.norm, policy=pol)
    return x + _ffn(p, h2[:, None, :], cfg, pol, dropless=True)[0][:, 0]


def _mamba_decode_one(p, x, cache, i: int, cfg: ModelConfig, pol):
    """One Mamba-2 layer for one token; layer i's state is written back
    into the cache in place."""
    h = norm(x, p["ln"], cfg.norm, policy=pol)
    y, st = SSM.ssm_decode_step(p["ssm"], h, {
        "conv": cache["conv"][i], "ssm": cache["ssm"][i]}, cfg, policy=pol)
    cache["conv"][i] = st["conv"]
    cache["ssm"][i] = st["ssm"]
    return x + y


def _decode_blocks(params, cfg: ModelConfig, cache, x, rt: ModelRuntime,
                   names=(), pos=None, idx=None, op: str = "",
                   tail=()) -> torch.Tensor:
    """Every block for one token in :func:`_schedule`'s order, then the
    final norm and the unembedding. Mamba-2 layer i updates its state in
    the cache; attention block i's cache is ``cache[n][i]`` for the
    leaves ``names = (k, v, ks, vs)`` (the scales absent from a float
    cache), its new row written at ``idx``, and attention is the
    dispatch op ``op`` on the query, the cache leaves present, then
    ``tail`` (the mask, after the page table if paged)."""
    pol = rt.kernel_policy()

    def attend(q, kv):
        return dispatch(op, pol, q, *(t for t in kv if t is not None), *tail)

    rope = None
    if cfg.family != "ssm":
        posv = pos[:, None]                                  # (B, 1)
        if cfg.rope == "mrope":
            posv = posv[None].expand(3, -1, -1)              # (3, B, 1)
        rope = L.rope_tables(posv, cfg)
    for kind, i, p in _schedule(params, cfg):
        if kind == "mamba":
            x = _mamba_decode_one(p, x, cache, i, cfg, pol)
            continue
        kv = tuple(cache[n][i] if n in cache else None for n in names)
        x = _attn_decode_one(p, x, kv, idx, attend, rope, cfg, rt)
    x = norm(x[:, None, :], params["final_norm"], cfg.norm, policy=pol)
    return _unembed(params, cfg, x)[:, 0]


def decode_step(params, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, rt: ModelRuntime = ModelRuntime(),
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """tokens: (B,) -> (cache, logits (B, V)). The cache is updated in
    place (K/V rows and the recurrent state, and ``pos + 1``) and
    returned."""
    _require_ported(cfg)
    pos = cache["pos"]
    x = params["embed"].to(rt.torch_dtype)[tokens.long()]      # (B, d)
    if cfg.family == "ssm":
        logits = _decode_blocks(params, cfg, cache, x, rt)
        pos += 1
        return cache, logits
    W = cache["k"].shape[2]
    idx = (torch.arange(x.shape[0], device=pos.device), (pos % W).long())
    mask = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    op = "quant_decode_attention" if "ks" in cache else "decode_attention"
    logits = _decode_blocks(params, cfg, cache, x, rt,
                            ("k", "v", "ks", "vs"), pos, idx, op, (mask,))
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
    the attention blocks (the hybrid's groups). Physical page 0 is the
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
        return spec
    shape = (_kv_layers(cfg), n_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    kv = _kv_spec(shape, kv_dtype or dtype)
    return dict(spec, kp=kv["k"], vp=kv["v"],
                **{n: kv[n] for n in ("ks", "vs") if n in kv})


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
    does."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return decode_step(params, cfg, cache, tokens, rt)
    pos, pt = cache["pos"], cache["pt"]
    x = params["embed"].to(rt.torch_dtype)[tokens.long()]      # (B, d)
    W, ps = window, page_size
    row = (pos % W).long()
    phys = torch.gather(pt, 1, (row // ps)[:, None])[:, 0].long()
    ar = torch.arange(pt.shape[1] * ps, device=pos.device)[None, :]
    mask = (ar <= pos[:, None]) & (ar < W)
    op = ("quant_paged_decode_attention" if "ks" in cache
          else "paged_decode_attention")
    logits = _decode_blocks(params, cfg, cache, x, rt,
                            ("kp", "vp", "ks", "vs"), pos, (phys, row % ps),
                            op, (pt, mask))
    pos += 1
    return cache, logits
