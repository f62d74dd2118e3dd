"""Mamba2 LM (mamba2-1.3b), the Zamba2 hybrid (zamba2-1.2b), mirroring
``repro/models/zamba.py``, and the published Zamba2 layer (zamba2-7b),
which the reference lacks.

Parameters are nested dicts and lists of tensors, and the forward passes
are Python loops over them:

* ``MambaLM``: ``params["layers"]``, a list of per-layer ``{norm, mixer}``;
  its decode cache keeps the reference's stacked layout, ``{"layers":
  {"conv": [L,B,K-1,C], "state": [L,B,H,P,N]}, "pos"}``.
* ``ZambaLM``: a Mamba2 backbone of ``num_layers`` blocks where ONE shared
  transformer block (``shared``: full MHA and a GELU MLP, its parameters
  reused by every call) runs before every ``attn_every`` Mamba2 layers,
  modulated by a small low-rank adapter per call. ``adapters`` is a list
  of ``n_super = n_shared_attn`` dicts, ``mamba`` a list of ``n_super``
  lists of ``attn_every`` Mamba2 blocks, and ``tail`` the remaining
  blocks. Its cache is the reference's, ``{"mamba": {conv, state}
  [n_super, inner, B, ...], "attn": {k, v, pos} [n_super, B, ...],
  "tail": {conv, state} [n_tail, B, ...]}``.
* ``Zamba2LM``: the published Zamba2 (``transformers``' ``Zamba2Model``):
  ``layers``, a list of ``num_layers`` Mamba2 blocks; the layers in
  ``hybrid_layer_ids`` first call one of the ``num_mem_blocks`` blocks in
  ``shared`` (in turn: call c takes block c mod num_mem_blocks) on the
  state and the token embedding concatenated, with no residual inside the
  block, and the call's output, through the layer's own ``linears[c]``,
  is added to that layer's Mamba2 input before its norm. Each call has its
  own gate/up adapter (``adapters[c]``). Training and prefill only: it has
  no decode cache.

Both update their caches in place, and ``cache_axes()`` names every cache
leaf's axes, so a serving backend finds a slot's row by its
``cache_batch`` axis.

Prefill runs each Mamba2 layer's SSD scan through the ``ssd_chunks``
kernel (one launch per layer). ``ZambaLM(cfg, n_pe)`` runs the shared
block's attention over the emulated ring: the QKV ring and ring attention
in prefill and training, ring decode attention in decode. The GELU MLP
stays off the ring, as in the reference. Neither model has a block prefill
into a cache (``prefill_into_cache``), so a serving engine streams prompts
through ``decode_step``, as the reference does.

While gradients are recorded, ``cfg.remat`` other than ``none``
recomputes each Mamba2 layer, and each Zamba super-block (the shared
block and its Mamba2 layers), in the backward, as the reference's
``jax.checkpoint`` wraps them (``transformer.remat``, which refuses an
unknown value); ``selective`` is ``full`` here, as there. ``Zamba2LM``
checkpoints each Mamba2 layer and each shared-block call on its own, with
no nesting, so a step recomputes each once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
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
from repro_torch.models.transformer import remat
from repro_torch.obs import trace


def _stacked(one: dict, *lead: int) -> dict:
    """Each leaf of ``one`` repeated behind leading dimensions ``lead``."""
    return {name: t.expand(*lead, *t.shape).clone()
            for name, t in one.items()}


def _lm_loss(cfg: ModelConfig, params, x, batch):
    ce = lm_loss_chunked(params["head"], params["embed"], x,
                         batch["targets"], cfg, mask=batch.get("mask"))
    return ce, {"ce": ce}


# ---------------------------------------------------------------------------
# Pure Mamba2 LM
# ---------------------------------------------------------------------------


def init_mamba_block(gen, cfg: ModelConfig):
    return {"norm": init_norm(gen, cfg), "mixer": ssm.init_mamba2(gen, cfg)}


def mamba_block(lp, x, cfg: ModelConfig, tau=None):
    """One pre-norm Mamba2 block over a full sequence (the span
    ``mamba2.block``, opened again by remat's recompute); ``tau``, a
    shared block's output, joins the norm's input only (the published
    Zamba2's hybrid layer)."""
    with trace.span("mamba2.block"):
        h = x if tau is None else x + tau
        return x + ssm.mamba2_forward(lp["mixer"],
                                      apply_norm(lp["norm"], h, cfg), cfg)


def _mamba_step(lp, x, cache, cfg: ModelConfig, active):
    """One-token Mamba2 block -> (x, new conv/state)."""
    y, new = ssm.mamba2_decode(lp["mixer"], apply_norm(lp["norm"], x, cfg),
                               cache, cfg, active=active)
    return x + y, new


class MambaLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm":
            raise NotImplementedError(f"{cfg.name}: MambaLM takes the ssm "
                                      f"family, got {cfg.family!r}")
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "head": init_lm_head(gen, cfg),
            "layers": [init_mamba_block(gen, cfg)
                       for _ in range(cfg.num_layers)],
        }

    def hidden_states(self, params, tokens):
        """tokens [B,S] -> final-norm hidden states [B,S,D]."""
        cfg = self.cfg
        body = remat(functools.partial(mamba_block, cfg=cfg), cfg,
                     keep_products=False)
        x = embed(params["embed"], tokens, cfg)
        for lp in params["layers"]:
            x = body(lp, x)
        return apply_norm(params["final_norm"], x, cfg)

    def loss(self, params, batch):
        """Training loss of ``batch`` (``tokens``, ``targets``, optionally
        ``mask``). Returns (loss, {"ce"})."""
        x = self.hidden_states(params, batch["tokens"])
        return _lm_loss(self.cfg, params, x, batch)

    def prefill(self, params, tokens):
        """Forward pass returning last-position logits [B, V]."""
        x = self.hidden_states(params, tokens)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        """Per-layer conv window and SSM state (``seq_len`` is unused: the
        state does not grow with the sequence)."""
        dev = resolve_device(device)
        one = ssm.init_mamba2_cache(self.cfg, batch, dev)
        return {"layers": _stacked(one, self.cfg.num_layers),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def cache_axes(self):
        return {"layers": {k: (None,) + v
                           for k, v in ssm.MAMBA2_CACHE_AXES.items()},
                "pos": ()}

    def decode_step(self, params, cache, tokens, active=None):
        """tokens: [B,1] -> (logits [B,V], cache). Rows with ``active``
        False keep their state. The cache is updated in place."""
        cfg = self.cfg
        layers = cache["layers"]
        x = embed(params["embed"], tokens, cfg)
        for i, lp in enumerate(params["layers"]):
            x, new = _mamba_step(lp, x, {k: v[i] for k, v in layers.items()},
                                 cfg, active)
            for k, v in new.items():
                layers[k][i] = v
        x = apply_norm(params["final_norm"], x, cfg)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        cache["pos"] += 1
        return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------


def init_shared_block(gen, cfg: ModelConfig):
    return {
        "norm1": init_norm(gen, cfg),
        "attn": attn.init_gqa(gen, cfg),
        "norm2": init_norm(gen, cfg),
        "mlp": init_mlp(gen, cfg),
    }


def init_adapter(gen, cfg: ModelConfig, rank: int = 64):
    return {"a": param(gen, (cfg.d_model, rank), pdtype(cfg)),
            "b": param(gen, (rank, cfg.d_model), pdtype(cfg), "zeros")}


def _modulate(shared, adapter, x, cfg: ModelConfig):
    """The shared block's input: norm1, then the call's low-rank
    modulation ``h + (h a) b``."""
    dt = adtype(cfg)
    h = apply_norm(shared["norm1"], x, cfg)
    mod = torch.matmul(h.to(dt), adapter["a"].to(dt))
    return h + torch.matmul(mod, adapter["b"].to(dt))


class ZambaLM:
    """Zamba2 over an emulated ring of ``n_pe`` PEs (0: none)."""

    def __init__(self, cfg: ModelConfig, n_pe: int = 0):
        if cfg.family != "hybrid":
            raise NotImplementedError(f"{cfg.name}: ZambaLM takes the "
                                      f"hybrid family, got {cfg.family!r}")
        self.cfg = cfg
        self.n_pe = n_pe
        self.n_super = cfg.n_shared_attn
        self.inner = cfg.attn_every
        self.n_tail = cfg.num_layers - self.n_super * self.inner
        if self.n_tail < 0:
            raise ValueError("num_layers < n_shared_attn * attn_every")

    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        p = {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "head": init_lm_head(gen, cfg),
            "shared": init_shared_block(gen, cfg),
            "adapters": [init_adapter(gen, cfg)
                         for _ in range(self.n_super)],
            "mamba": [[init_mamba_block(gen, cfg) for _ in range(self.inner)]
                      for _ in range(self.n_super)],
        }
        if self.n_tail:
            p["tail"] = [init_mamba_block(gen, cfg)
                         for _ in range(self.n_tail)]
        return p

    def _shared_attn(self, shared, adapter, x):
        cfg = self.cfg
        h = _modulate(shared, adapter, x, cfg)
        x = x + attn.gqa_forward(shared["attn"], h, cfg, n_pe=self.n_pe)
        h = apply_norm(shared["norm2"], x, cfg)
        return x + apply_mlp(shared["mlp"], h, cfg)

    def hidden_states(self, params, tokens):
        """tokens [B,S] -> final-norm hidden states [B,S,D]."""
        cfg = self.cfg
        mamba_body = remat(functools.partial(mamba_block, cfg=cfg), cfg,
                           keep_products=False)

        def super_body(shared, adapter, stack, x):
            x = self._shared_attn(shared, adapter, x)
            for lp in stack:
                x = mamba_body(lp, x)
            return x

        super_body = remat(super_body, cfg, keep_products=False)
        x = embed(params["embed"], tokens, cfg)
        for adapter, stack in zip(params["adapters"], params["mamba"]):
            x = super_body(params["shared"], adapter, stack, x)
        for lp in params.get("tail", []):
            x = mamba_body(lp, x)
        return apply_norm(params["final_norm"], x, cfg)

    def loss(self, params, batch):
        """Training loss of ``batch`` (``tokens``, ``targets``, optionally
        ``mask``). Returns (loss, {"ce"})."""
        x = self.hidden_states(params, batch["tokens"])
        return _lm_loss(self.cfg, params, x, batch)

    def prefill(self, params, tokens):
        """Forward pass returning last-position logits [B, V]."""
        x = self.hidden_states(params, tokens)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        dev = resolve_device(device)
        m_one = ssm.init_mamba2_cache(self.cfg, batch, dev)
        cache = {
            "mamba": _stacked(m_one, self.n_super, self.inner),
            "attn": _stacked(attn.init_gqa_cache(self.cfg, batch, seq_len,
                                                 dev), self.n_super),
        }
        if self.n_tail:
            cache["tail"] = _stacked(m_one, self.n_tail)
        return cache

    def cache_axes(self):
        out = {"mamba": {k: (None, None) + v
                         for k, v in ssm.MAMBA2_CACHE_AXES.items()},
               "attn": {k: (None,) + v
                        for k, v in attn.GQA_CACHE_AXES.items()}}
        if self.n_tail:
            out["tail"] = {k: (None,) + v
                           for k, v in ssm.MAMBA2_CACHE_AXES.items()}
        return out

    def decode_step(self, params, cache, tokens, active=None):
        """tokens: [B,1] -> (logits [B,V], cache). Rows with ``active``
        False keep their state and positions. The cache is updated in
        place."""
        cfg = self.cfg
        shared = params["shared"]
        x = embed(params["embed"], tokens, cfg)
        m_cache, a_cache = cache["mamba"], cache["attn"]
        for i, (adapter, stack) in enumerate(zip(params["adapters"],
                                                 params["mamba"])):
            h = _modulate(shared, adapter, x, cfg)
            a, _ = attn.gqa_decode(shared["attn"], h,
                                   {k: v[i] for k, v in a_cache.items()},
                                   cfg, active=active, n_pe=self.n_pe)
            x = x + a
            h = apply_norm(shared["norm2"], x, cfg)
            x = x + apply_mlp(shared["mlp"], h, cfg)
            for j, lp in enumerate(stack):
                x, new = _mamba_step(lp, x, {k: v[i, j] for k, v in
                                             m_cache.items()}, cfg, active)
                for k, v in new.items():
                    m_cache[k][i, j] = v
        for j, lp in enumerate(params.get("tail", [])):
            x, new = _mamba_step(lp, x, {k: v[j] for k, v in
                                         cache["tail"].items()}, cfg, active)
            for k, v in new.items():
                cache["tail"][k][j] = v
        x = apply_norm(params["final_norm"], x, cfg)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Published Zamba2 (Zamba2-7B-Instruct's layer)
# ---------------------------------------------------------------------------


def init_zamba2_shared(gen, cfg: ModelConfig):
    """One shared block: RMSNorm over 2 d_model, MHA reading that width,
    RMSNorm, the gated-GELU MLP."""
    return {"norm1": init_norm(gen, cfg, d=2 * cfg.d_model),
            "attn": attn.init_gqa(gen, cfg, d_in=2 * cfg.d_model),
            "norm2": init_norm(gen, cfg),
            "mlp": init_mlp(gen, cfg)}


def init_mlp_adapter(gen, cfg: ModelConfig):
    """A call's low-rank term of the shared MLP's gate/up product."""
    r = cfg.adapter_rank
    return {"a": param(gen, (cfg.d_model, r), pdtype(cfg)),
            "b": param(gen, (r, 2 * cfg.d_ff), pdtype(cfg),
                       scale=0.1 / r ** 0.5)}


class Zamba2LM:
    """The published Zamba2 over an emulated ring of ``n_pe`` PEs (0:
    none): the shared blocks' QKV ring and ring attention, as
    ``gqa_forward`` runs them."""

    def __init__(self, cfg: ModelConfig, n_pe: int = 0):
        if cfg.family != "zamba2":
            raise NotImplementedError(f"{cfg.name}: Zamba2LM takes the "
                                      f"zamba2 family, got {cfg.family!r}")
        if cfg.num_mem_blocks < 1 or cfg.adapter_rank < 1:
            raise ValueError(f"{cfg.name}: num_mem_blocks and adapter_rank "
                             "must be positive")
        self.cfg = cfg
        self.n_pe = n_pe
        self.hybrid = [i for i in cfg.hybrid_layer_ids if i < cfg.num_layers]

    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "head": init_lm_head(gen, cfg),
            "shared": [init_zamba2_shared(gen, cfg)
                       for _ in range(cfg.num_mem_blocks)],
            "adapters": [init_mlp_adapter(gen, cfg) for _ in self.hybrid],
            "linears": [{"w": param(gen, (d, d), pdtype(cfg))}
                        for _ in self.hybrid],
            "layers": [init_mamba_block(gen, cfg)
                       for _ in range(cfg.num_layers)],
        }

    def shared_call(self, shared, adapter, linear, x, e):
        """A hybrid layer's call of a shared block on the state ``x`` and
        the embedding ``e`` [B,S,D]: its output through the layer's
        ``linear`` (the span ``zamba2.shared``, its attention and MLP in
        ``zamba2.attn`` and ``zamba2.mlp``)."""
        cfg = self.cfg
        with trace.span("zamba2.shared"):
            with trace.span("zamba2.attn"):
                h = apply_norm(shared["norm1"], torch.cat([x, e], dim=-1),
                               cfg)
                h = attn.gqa_forward(shared["attn"], h, cfg, n_pe=self.n_pe)
            with trace.span("zamba2.mlp"):
                h = apply_norm(shared["norm2"], h, cfg)
                h = apply_mlp(shared["mlp"], h, cfg, adapter=adapter)
            return torch.matmul(h, linear["w"].to(adtype(cfg)))

    def hidden_states(self, params, tokens):
        """tokens [B,S] -> final-norm hidden states [B,S,D]."""
        cfg = self.cfg
        mamba_body = remat(functools.partial(mamba_block, cfg=cfg), cfg,
                           keep_products=False)
        shared_body = remat(self.shared_call, cfg, keep_products=False)
        call = {layer: c for c, layer in enumerate(self.hybrid)}
        e = embed(params["embed"], tokens, cfg)
        x = e
        for i, lp in enumerate(params["layers"]):
            c = call.get(i)
            tau = None if c is None else shared_body(
                params["shared"][c % cfg.num_mem_blocks],
                params["adapters"][c], params["linears"][c], x, e)
            x = mamba_body(lp, x, tau=tau)
        return apply_norm(params["final_norm"], x, cfg)

    def loss(self, params, batch):
        """Training loss of ``batch`` (``tokens``, ``targets``, optionally
        ``mask``). Returns (loss, {"ce"})."""
        x = self.hidden_states(params, batch["tokens"])
        return _lm_loss(self.cfg, params, x, batch)

    def prefill(self, params, tokens):
        """Forward pass returning last-position logits [B, V]."""
        x = self.hidden_states(params, tokens)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    def _no_cache(self, *args, **kwargs):
        raise NotImplementedError(f"{self.cfg.name}: Zamba2LM has no decode "
                                  "cache (training and prefill only)")

    init_cache = cache_axes = decode_step = _no_cache
