"""Decoder-only transformer LM: the dense family (qwen3 / olmo-style
backbones), the MoE family (Mixtral; DeepSeek-V2 with MLA and
``first_k_dense``) and the InternVL2 VLM fusion.

Mirrors ``repro/models/transformer.py``. The reference
scans stacked layer parameters (an MoE model keeps its ``first_k_dense``
leading dense layers in a second stack, ``dense_layers``); here
``params["layers"]`` is one list of per-layer dicts, the dense layers
first, and the forward is a Python loop over it. A layer is an MoE layer
when it holds ``moe`` parameters (else ``mlp``). The decode cache keeps
the reference's stacked GQA layout, ``cache["layers"][name]`` with a
leading dimension over all layers, and each layer updates its slice in
place. MoE layers add their router's auxiliary loss to ``hidden_states``
and ``loss``.

``attention_type="mla"`` swaps each layer's attention for MLA (the
expanded form over a full sequence, the absorbed form in decode, a latent
cache ``{c, k_rope, pos}``); MLA has no ring path, as in the reference.
The ``vlm`` family adds a ``projector`` (a norm at ``vit_dim``, two
products around a tanh GELU) whose output overwrites the leading
positions of the token embeddings when ``patch_embeds`` [B, P, vit_dim]
are given; decode takes no patches.

``n_pe`` is the size of the emulated systolic ring (0: none). With
``cfg.systolic_mode`` set to a link mode the full-sequence FFN runs as the
systolic SwiGLU (AG ring in, RS ring out) and the attention sublayer
routes through the ring schedules (``models/attention``), in the training
forward as in prefill. Their kernels' backward is the plain twin's
gradient (the wrappers' ``autograd.Function``s).

While gradients are recorded, each block runs under ``cfg.remat`` (the
reference's ``_remat``): ``none``; ``full``, ``torch.utils.checkpoint``
per block, which recomputes the block (and launches its ring kernels
again) in the backward; ``selective``, the same but keeping the outputs of
the plain 2-D products (``aten.mm``/``addmm``: the counterpart of
``dots_with_no_batch_dims_saveable``). The ring kernels are not aten ops,
so under ``selective`` they are recomputed as under ``full``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    adtype,
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_norm,
    lm_logits,
    lm_loss_chunked,
    param,
    pdtype,
    resolve_device,
)

REMATS = ("none", "full", "selective")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg: ModelConfig, keep_products: bool = True):
    """``fn`` under ``cfg.remat`` while gradients are recorded (else ``fn``
    itself). ``keep_products=False`` runs ``selective`` as ``full``, as the
    reference's Zamba2 does."""
    if not torch.is_grad_enabled():
        return fn
    if cfg.remat not in REMATS:
        raise ValueError(f"unknown remat {cfg.remat!r}; expected one of "
                         f"{REMATS}")
    if cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat == "selective" and keep_products:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kwargs)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, moe_layer: bool = False):
    p = {
        "norm1": init_norm(gen, cfg),
        "norm2": init_norm(gen, cfg),
        "attn": (attn.init_mla(gen, cfg) if cfg.attention_type == "mla"
                 else attn.init_gqa(gen, cfg)),
    }
    if moe_layer:
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        d_ff = cfg.d_ff_dense if (cfg.family == "moe" and cfg.d_ff_dense) \
            else cfg.d_ff
        p["mlp"] = init_mlp(gen, cfg, d_ff=d_ff)
    return p


def _maybe_systolic_mlp(lp_mlp, h, cfg: ModelConfig, n_pe: int):
    """Route the FFN through the paper's ring schedules when enabled and
    the shapes divide; otherwise the plain SwiGLU."""
    n = attn.ring_size(cfg, n_pe)
    if n and cfg.mlp_kind == "swiglu":
        from repro_torch.core import collective_matmul as cm
        if cm.ffn_applicable(h, lp_mlp["w_gate"].shape[-1], n):
            dt = adtype(cfg)
            return cm.systolic_ffn(
                h.to(dt), lp_mlp["w_gate"].to(dt), lp_mlp["w_up"].to(dt),
                lp_mlp["w_down"].to(dt), n, cfg.systolic_mode)
    return apply_mlp(lp_mlp, h, cfg)


def _ffn(lp, h, cfg: ModelConfig, n_pe: int, *, full_seq: bool):
    """The block's FFN sublayer: the MoE (with its aux loss) in an MoE
    layer, else the SwiGLU, over the ring schedules for a full sequence.
    Returns (y, aux)."""
    if "moe" in lp:
        return moe_lib.apply_moe(lp["moe"], h, cfg, n_pe)
    y = _maybe_systolic_mlp(lp["mlp"], h, cfg, n_pe) if full_seq \
        else apply_mlp(lp["mlp"], h, cfg)
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


def _block(lp, x, cfg: ModelConfig, n_pe: int):
    """One block over a full sequence -> (x, aux, (k, v)); MLA returns no
    K/V (None)."""
    h = apply_norm(lp["norm1"], x, cfg)
    if cfg.attention_type == "mla":
        a, kv = attn.mla_forward(lp["attn"], h, cfg), None
    else:
        a, kv = attn.gqa_forward(lp["attn"], h, cfg, return_kv=True,
                                 n_pe=n_pe)
    x = x + a
    h = apply_norm(lp["norm2"], x, cfg)
    y, aux = _ffn(lp, h, cfg, n_pe, full_seq=True)
    return x + y, aux, kv


def block_forward(lp, x, cfg: ModelConfig, n_pe: int = 0):
    """One block over a full sequence. Returns (x, aux_loss): the MoE's
    router loss in an MoE layer, else a zero."""
    x, aux, _ = _block(lp, x, cfg, n_pe)
    return x, aux


def block_prefill(lp, x, cfg: ModelConfig, n_pe: int = 0):
    """One block over a full sequence; also returns the post-rope K/V of
    the attention sublayer, for seeding a decode cache."""
    x, _, kv = _block(lp, x, cfg, n_pe)
    return x, kv


def block_decode(lp, x, cache, cfg: ModelConfig, active=None, n_pe: int = 0):
    """One-token decode of a block; an MoE layer takes the dense dispatch
    (one token does not divide the ring), as in the reference."""
    h = apply_norm(lp["norm1"], x, cfg)
    if cfg.attention_type == "mla":
        a, cache = attn.mla_decode(lp["attn"], h, cache, cfg, active=active)
    else:
        a, cache = attn.gqa_decode(lp["attn"], h, cache, cfg, active=active,
                                   n_pe=n_pe)
    x = x + a
    h = apply_norm(lp["norm2"], x, cfg)
    y, _ = _ffn(lp, h, cfg, n_pe, full_seq=False)
    return x + y, cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class TransformerLM:
    """Dense, MoE or VLM decoder LM (GQA or MLA) over an emulated ring of
    ``n_pe`` PEs."""

    def __init__(self, cfg: ModelConfig, n_pe: int = 0):
        if cfg.family not in ("dense", "moe", "vlm") \
                or cfg.attention_type not in ("gqa", "mla"):
            raise NotImplementedError(
                f"{cfg.name}: TransformerLM takes the dense, moe and vlm "
                f"families with gqa or mla attention, got {cfg.family!r} "
                f"with {cfg.attention_type!r}")
        self.cfg = cfg
        self.n_pe = n_pe
        self.moe = cfg.family == "moe"

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``: the
        ``first_k_dense`` dense layers first, then the rest (MoE layers in
        the MoE family)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        dense = cfg.first_k_dense
        p = {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "head": init_lm_head(gen, cfg),
            "layers": [init_block(gen, cfg, moe_layer=self.moe and i >= dense)
                       for i in range(cfg.num_layers)],
        }
        if cfg.family == "vlm":
            p["projector"] = {
                "w1": param(gen, (cfg.vit_dim, cfg.d_model), pdtype(cfg)),
                "w2": param(gen, (cfg.d_model, cfg.d_model), pdtype(cfg)),
                "norm": init_norm(gen, cfg, d=cfg.vit_dim),
            }
        return p

    # ------------------------------------------------------------- forward
    def _embed_inputs(self, params, tokens, patch_embeds=None):
        """Token embeddings; in the vlm family with ``patch_embeds``
        [B,P,vit_dim], the projected patches overwrite the first min(P, S)
        positions (image tokens occupy the sequence prefix)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        if cfg.family != "vlm" or patch_embeds is None:
            return x
        dt = adtype(cfg)
        proj = params["projector"]
        pe = apply_norm(proj["norm"], patch_embeds.to(dt), cfg)
        pe = torch.matmul(pe, proj["w1"].to(dt))
        pe = F.gelu(pe, approximate="tanh")
        pe = torch.matmul(pe, proj["w2"].to(dt))
        n = min(pe.shape[1], x.shape[1])
        return torch.cat([pe[:, :n], x[:, n:]], dim=1)

    def hidden_states(self, params, tokens, patch_embeds=None):
        """tokens [B,S] (and, in the vlm family, optional ``patch_embeds``
        [B,P,vit_dim]) -> (final-norm hidden states [B,S,D], aux loss).
        Blocks run under ``cfg.remat`` while gradients are recorded."""
        cfg = self.cfg
        body = remat(functools.partial(block_forward, cfg=cfg,
                                       n_pe=self.n_pe), cfg)
        x = self._embed_inputs(params, tokens, patch_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            x, aux = body(lp, x)
            aux_total = aux_total + aux
        return apply_norm(params["final_norm"], x, cfg), aux_total

    def loss(self, params, batch):
        """Training loss: ``batch`` holds ``tokens`` and ``targets`` [B,S]
        and optionally a ``mask`` [B,S] (and ``patch_embeds`` in the vlm
        family). Returns (loss, {"ce", "aux"})."""
        x, aux = self.hidden_states(params, batch["tokens"],
                                    batch.get("patch_embeds"))
        ce = lm_loss_chunked(params["head"], params["embed"], x,
                             batch["targets"], self.cfg,
                             mask=batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, patch_embeds=None):
        """Forward pass returning last-position logits [B, V]."""
        x, _ = self.hidden_states(params, tokens, patch_embeds)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        dev = resolve_device(device)
        init = attn.init_mla_cache if self.cfg.attention_type == "mla" \
            else attn.init_gqa_cache
        one = init(self.cfg, batch, seq_len, dev)
        layers = self.cfg.num_layers
        return {"layers": {name: t.unsqueeze(0).repeat(
            layers, *([1] * t.dim())) for name, t in one.items()}}

    def cache_axes(self):
        """Logical axes of every cache leaf: GQA's or MLA's, behind the
        layer dimension."""
        axes = attn.MLA_CACHE_AXES if self.cfg.attention_type == "mla" \
            else attn.GQA_CACHE_AXES
        return {"layers": {k: (None,) + v for k, v in axes.items()}}

    @staticmethod
    def _layer_cache(cache, i: int):
        return {name: t[i] for name, t in cache["layers"].items()}

    def prefill_into_cache(self, params, cache, tokens, row: int,
                           length: int):
        """Batched prefill of one slot: run the full-sequence forward over
        ``tokens`` [C] and write the post-rope K/V of positions [0, C) into
        cache row ``row``, setting its position to ``length``.

        As in the reference, the forward runs at the cache's full
        slot-batch width with the same tokens in every row (so the ring
        schedules see the serving batch) and only ``row`` is written. Pad
        positions past ``length`` are computed but never read before the
        decode loop overwrites them (slot validity is ``slot <= pos``).
        The cache is updated in place. Returns (logits [V] at position
        length-1, cache).
        """
        cfg = self.cfg
        if cfg.sliding_window or cfg.attention_type != "gqa":
            raise NotImplementedError("prefill_into_cache needs full "
                                      "GQA attention caches")
        c = tokens.shape[0]
        layers = cache["layers"]
        b = layers["pos"].shape[1]
        x = embed(params["embed"], tokens[None].expand(b, c), cfg)  # [B,C,D]
        for i, lp in enumerate(params["layers"]):
            x, (k, v) = block_prefill(lp, x, cfg, self.n_pe)
            layers["k"][i, row, :c] = k[0].to(layers["k"].dtype)
            layers["v"][i, row, :c] = v[0].to(layers["v"].dtype)
        layers["pos"][:, row] = length
        # only row 0 at position length-1 is needed: the logits of other
        # rows and positions are never read
        x = apply_norm(params["final_norm"], x[0, length - 1], cfg)
        return lm_logits(params["head"], params["embed"], x, cfg), cache

    def decode_step(self, params, cache, tokens, active=None):
        """tokens: [B,1] -> (logits [B,V], cache). ``active`` [B] bool masks
        rows that should not consume a step (continuous batching)."""
        x = embed(params["embed"], tokens, self.cfg)
        for i, lp in enumerate(params["layers"]):
            x, _ = block_decode(lp, x, self._layer_cache(cache, i), self.cfg,
                                active=active, n_pe=self.n_pe)
        x = apply_norm(params["final_norm"], x, self.cfg)
        logits = lm_logits(params["head"], params["embed"], x, self.cfg)
        return logits[:, 0], cache
