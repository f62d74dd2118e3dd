"""Whisper encoder-decoder (whisper-tiny). Mirrors ``repro/models/whisper.py``.

The conv/mel audio frontend is a stub, as in the reference: the model
takes precomputed frame embeddings [B, T, d_model] and owns the
sinusoidal positions, the encoder stack, and the decoder with self- and
cross-attention and learned positions.

Parameters are nested dicts and lists of tensors: ``enc_layers`` and
``dec_layers`` are lists of per-layer dicts (the reference stacks them),
beside ``embed``, the untied ``head``, ``enc_norm``, ``dec_norm`` and
``dec_pos`` [max_target_positions, D]. The decode cache is the
reference's, ``{"self": {k, v, pos} [L, B, ...], "cross_k", "cross_v"
[L, B, T, Kv, hd]}``, updated in place (``fill_cross_cache`` writes the
cross K/V once a request, ``decode_step`` the self-attention rows).

``WhisperModel(cfg, n_pe)`` runs the attention projections over the
emulated ring as the GQA models do: with ``cfg.systolic_mode`` a link
mode, the encoder's QKV projections take the QKV ring (``tile_matmul``)
where the heads divide the ring, and the decoder's self-attention the QKV
ring and ring attention (``flash_carry``); the encoder's bidirectional
attention, cross-attention and the GELU MLP stay off the ring, as in the
reference. While gradients are recorded, ``cfg.remat`` other than
``none`` recomputes each encoder and decoder layer in the backward (the
reference's ``_remat`` takes ``selective`` as ``full``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    adtype,
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    lm_logits,
    lm_loss_chunked,
    param,
    pdtype,
    resolve_device,
    sinusoidal_positions,
)
from repro_torch.models.transformer import remat


def init_enc_block(gen, cfg: ModelConfig):
    return {
        "norm1": init_norm(gen, cfg),
        "attn": attn.init_gqa(gen, cfg),
        "norm2": init_norm(gen, cfg),
        "mlp": init_mlp(gen, cfg),
    }


def init_dec_block(gen, cfg: ModelConfig):
    return {
        "norm1": init_norm(gen, cfg),
        "self_attn": attn.init_gqa(gen, cfg),
        "norm_x": init_norm(gen, cfg),
        "cross_attn": attn.init_cross_attention(gen, cfg),
        "norm2": init_norm(gen, cfg),
        "mlp": init_mlp(gen, cfg),
    }


def enc_block(lp, x, cfg: ModelConfig, n_pe: int = 0):
    """One encoder layer: bidirectional attention through GQA's
    projections (no positions: no RoPE), then the GELU MLP."""
    h = apply_norm(lp["norm1"], x, cfg)
    q, k, v = attn._qkv(lp["attn"], h, cfg, None, n_pe)
    o = attn.plain_attention(q, k, v, causal=False)
    x = x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype),
                         lp["attn"]["wo"].to(x.dtype))
    h = apply_norm(lp["norm2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, cfg)


def dec_block(lp, x, memory, cfg: ModelConfig, n_pe: int = 0):
    """One decoder layer over a full sequence: causal self-attention,
    cross-attention to ``memory`` [B,T,D], the GELU MLP."""
    h = apply_norm(lp["norm1"], x, cfg)
    x = x + attn.gqa_forward(lp["self_attn"], h, cfg, n_pe=n_pe)
    h = apply_norm(lp["norm_x"], x, cfg)
    k, v = attn.cross_kv(lp["cross_attn"], memory, cfg)
    x = x + attn.cross_attend(lp["cross_attn"], h, k, v, cfg)
    h = apply_norm(lp["norm2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, cfg)


class WhisperModel:
    """Whisper over an emulated ring of ``n_pe`` PEs (0: none)."""

    def __init__(self, cfg: ModelConfig, n_pe: int = 0):
        if cfg.family != "encdec":
            raise NotImplementedError(f"{cfg.name}: WhisperModel takes the "
                                      f"encdec family, got {cfg.family!r}")
        self.cfg = cfg
        self.n_pe = n_pe

    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg),            # decoder tokens
            "head": {"w": param(gen, (cfg.d_model, cfg.vocab_size),
                                pdtype(cfg))},
            "enc_layers": [init_enc_block(gen, cfg)
                           for _ in range(cfg.enc_layers)],
            "enc_norm": init_norm(gen, cfg),
            "dec_layers": [init_dec_block(gen, cfg)
                           for _ in range(cfg.num_layers)],
            "dec_norm": init_norm(gen, cfg),
            "dec_pos": param(gen, (cfg.max_target_positions, cfg.d_model),
                             pdtype(cfg), scale=0.02),
        }

    # -------------------------------------------------------------- encoder
    def encode(self, params, frames):
        """frames [B,T,D] -> encoder output [B,T,D] (the activation type)."""
        cfg = self.cfg
        x = frames.to(adtype(cfg))
        pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        x = x + pos.to(x.dtype)[None]
        body = remat(functools.partial(enc_block, cfg=cfg, n_pe=self.n_pe),
                     cfg, keep_products=False)
        for lp in params["enc_layers"]:
            x = body(lp, x)
        return apply_norm(params["enc_norm"], x, cfg)

    # -------------------------------------------------------------- decoder
    def _dec_embed(self, params, tokens, pos_offset=None):
        """Token embeddings plus learned positions modulo
        ``max_target_positions``: from 0, or from per-row offsets
        ``pos_offset`` [B] (decode)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        steps = torch.arange(tokens.shape[1], device=x.device)
        table = params["dec_pos"].to(x.dtype)
        if pos_offset is None:
            return x + table[steps % cfg.max_target_positions][None]
        idx = (pos_offset.long()[:, None] + steps[None]) \
            % cfg.max_target_positions
        return x + table[idx]

    def decode_stack(self, params, tokens, memory):
        """tokens [B,S] against ``memory`` [B,T,D] -> final-norm hidden
        states [B,S,D]."""
        cfg = self.cfg
        body = remat(functools.partial(dec_block, cfg=cfg, n_pe=self.n_pe),
                     cfg, keep_products=False)
        x = self._dec_embed(params, tokens)
        for lp in params["dec_layers"]:
            x = body(lp, x, memory)
        return apply_norm(params["dec_norm"], x, cfg)

    # ------------------------------------------------------------- training
    def loss(self, params, batch):
        """Training loss of ``batch`` (``frames`` [B,T,D], ``tokens`` and
        ``targets`` [B,S], optionally ``mask``). Returns (loss, {"ce"})."""
        memory = self.encode(params, batch["frames"])
        x = self.decode_stack(params, batch["tokens"], memory)
        ce = lm_loss_chunked(params["head"], params["embed"], x,
                             batch["targets"], self.cfg,
                             mask=batch.get("mask"))
        return ce, {"ce": ce}

    def prefill(self, params, batch):
        """``batch`` {frames, tokens} -> last-position logits [B, V]."""
        memory = self.encode(params, batch["frames"])
        x = self.decode_stack(params, batch["tokens"], memory)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        """Per-layer self-attention caches and zeroed cross K/V for
        ``enc_frames`` encoder positions."""
        cfg = self.cfg
        dev = resolve_device(device)
        one = attn.init_gqa_cache(cfg, batch, seq_len, dev)
        cross = (cfg.num_layers, batch, cfg.enc_frames, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "self": {name: t.expand(cfg.num_layers, *t.shape).clone()
                     for name, t in one.items()},
            "cross_k": torch.zeros(cross, dtype=adtype(cfg), device=dev),
            "cross_v": torch.zeros(cross, dtype=adtype(cfg), device=dev),
        }

    def cache_axes(self):
        cross = (None, "cache_batch", "frames", "kv_heads", "head_dim")
        return {"self": {k: (None,) + v
                         for k, v in attn.GQA_CACHE_AXES.items()},
                "cross_k": cross, "cross_v": cross}

    def fill_cross_cache(self, params, cache, memory):
        """Write every decoder layer's cross K/V of the encoder output
        ``memory`` [B, enc_frames, D] into the cache (once a request), in
        place. Returns the cache."""
        for i, lp in enumerate(params["dec_layers"]):
            k, v = attn.cross_kv(lp["cross_attn"], memory, self.cfg)
            cache["cross_k"][i] = k
            cache["cross_v"][i] = v
        return cache

    def decode_step(self, params, cache, tokens, active=None):
        """tokens: [B,1] -> (logits [B,V], cache). Rows with ``active``
        False neither write the cache nor advance. The cache is updated in
        place."""
        cfg = self.cfg
        self_cache = cache["self"]
        x = self._dec_embed(params, tokens, pos_offset=self_cache["pos"][0])
        for i, lp in enumerate(params["dec_layers"]):
            h = apply_norm(lp["norm1"], x, cfg)
            a, _ = attn.gqa_decode(lp["self_attn"], h,
                                   {k: v[i] for k, v in self_cache.items()},
                                   cfg, active=active, n_pe=self.n_pe)
            x = x + a
            h = apply_norm(lp["norm_x"], x, cfg)
            x = x + attn.cross_attend(lp["cross_attn"], h, cache["cross_k"][i],
                                      cache["cross_v"][i], cfg)
            h = apply_norm(lp["norm2"], x, cfg)
            x = x + apply_mlp(lp["mlp"], h, cfg)
        x = apply_norm(params["dec_norm"], x, cfg)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        return logits[:, 0], cache
