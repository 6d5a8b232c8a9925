"""Model assembly: embeddings -> stacked blocks -> head, for all families
(dense / moe / ssm / vlm / audio / hybrid), with train, prefill and decode
entry points.

The counterpart of ``repro.models.lm``.  Parameters are a nested dict of
tensors with the reference's keys and shapes: layer parameters are
stacked along a leading "layers" axis (and "groups" for the hybrid), and
``init_params`` returns the reference's logical-axes pytree beside them.
Both values of ``cfg.scan_layers`` run a Python loop over the layers.
KV caches and SSM states are stacked the same way, allocated once by
``init_cache`` and written in place by ``decode_step``.

``LanguageModel`` is a thin ``nn.Module`` over the same tensors, so that
``.to()``, ``state_dict()`` and ``torch.optim`` see them.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..api import resolve_device
from ..configs.base import ArchConfig
from ..dist.api import (ambient, along, constrain, gathered, get_option,
                        local_apply, replicated)
from .attention import attn_decode, attn_forward, init_attn
from .layers import dense_init, rms_norm, sq_relu_ffn, swiglu
from .moe import init_moe, moe_ffn
from .ssm import init_ssm, ssd_decode, ssd_forward

PyTree = Any


def _device(device) -> torch.device:
    """``device`` resolved as the port resolves it (a CUDA device that
    exists, or the CPU; no card raises), or the meta device, on which
    ``init_params`` gives shapes and dtypes without values."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: what the "dots" remat policy saves: the outputs of the 2-D products
#: (the weight projections, ``x @ W`` folded to ``mm``); batched products
#: (attention's ``bmm``s, the experts') are recomputed, as JAX's
#: ``dots_with_no_batch_dims_saveable`` does
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ckpt(f, cfg):
    """Recompute ``f`` in the backward pass when ``cfg.remat`` asks for
    it and autograd records: all but the 2-D products' outputs
    (``remat_policy="dots"``) or, as the reference does for any other
    policy, everything.  Under ``torch.inference_mode`` or ``no_grad``
    (serving) ``f`` runs as it is."""
    if not cfg.remat:
        return f
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        # the recomputation runs in the backward pass, on the card on
        # autograd's own thread: it must see the forward's mesh and
        # options, which are this thread's
        scope = ambient()

        def g(*a):
            with scope():
                return f(*a)
        return checkpoint(g, *args, use_reentrant=False, **kw)
    return run


def _cx(x):
    """Residual-stream constraint at block boundaries (sequence-parallel
    layout with the ``seq_parallel`` option)."""
    if get_option("seq_parallel") and x.ndim == 3:
        return constrain(x, "batch", "model", None)
    return constrain(x, "batch", None, None)


def _cxd(x):
    """The residual stream of one token, laid out by batch (under a mesh
    each branch's partial sums are reduced here, as ``_cx`` does
    in ``_block_fwd``)."""
    return constrain(x, "batch", None, None)


def _prefix_axes(ax, name: str):
    if isinstance(ax, dict):
        return {k: _prefix_axes(v, name) for k, v in ax.items()}
    return (name,) + ax


# ---------------------------------------------------------------------
# init
# ---------------------------------------------------------------------

def _init_ffn(gen, cfg, dtype, device, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    if cfg.act == "sq_relu":
        p = {"w_up": dense_init(gen, lead + (d, f), dtype, device),
             "w_down": dense_init(gen, lead + (f, d), dtype, device)}
        ax = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    else:
        p = {"w_gate": dense_init(gen, lead + (d, f), dtype, device),
             "w_up": dense_init(gen, lead + (d, f), dtype, device),
             "w_down": dense_init(gen, lead + (f, d), dtype, device)}
        ax = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
              "w_down": ("ffn", "embed")}
    return p, ax


def _init_block(gen, cfg, dtype, device, lead=()):
    """One transformer block (dense or MoE)."""
    lead = tuple(lead)
    attn_p, attn_ax = init_attn(gen, cfg, dtype, device, lead)
    init_f = init_moe if cfg.moe_experts else _init_ffn
    ffn_p, ffn_ax = init_f(gen, cfg, dtype, device, lead)
    p = {"attn": attn_p, "ffn": ffn_p,
         "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
         "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    ax = {"attn": attn_ax, "ffn": ffn_ax,
          "ln1": ("embed",), "ln2": ("embed",)}
    return p, ax


def _init_ssm_block(gen, cfg, dtype, device, lead=()):
    p_ssm, ax_ssm = init_ssm(gen, cfg, dtype, device, lead)
    p = {"ssm": p_ssm,
         "ln": torch.ones(tuple(lead) + (cfg.d_model,), dtype=dtype,
                          device=device)}
    ax = {"ssm": ax_ssm, "ln": ("embed",)}
    return p, ax


def _stack_init(fn, gen, n, cfg, dtype, device):
    """``n`` layers of ``fn``'s params, drawn stacked along a leading
    "layers" axis."""
    ps, ax = fn(gen, cfg, dtype, device, (n,))
    return ps, _prefix_axes(ax, "layers")


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                *, device="cuda") -> tuple[PyTree, PyTree]:
    """``(params, axes)`` for ``cfg``: float32 normals x 0.02 (0.1 for
    the SSM conv) cast to ``cfg.dtype``, norms at one, biases at zero,
    drawn on ``device`` from ``generator`` (a ``torch.Generator`` on that
    device; by default one seeded with 0).  The keys, shapes, dtypes and
    axes are the reference's; the values are not (the reference draws
    from ``jax.random``; ``models.convert`` carries its values across).
    The default device is the card: without one this raises."""
    dev = _device(device)
    dtype = _dtype(cfg)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(dev).manual_seed(0)
    params: dict = {}
    axes: dict = {}
    # embeddings
    if cfg.input_kind == "codes":
        params["embed"] = dense_init(gen, (cfg.n_codebooks, cfg.vocab,
                                           cfg.d_model), dtype, dev)
        axes["embed"] = (None, "vocab", "embed")
        params["head"] = dense_init(gen, (cfg.n_codebooks, cfg.d_model,
                                          cfg.vocab), dtype, dev)
        axes["head"] = (None, "embed", "vocab")
    else:
        params["embed"] = dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                     dev)
        axes["embed"] = ("vocab", "embed")
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype, dev)
        axes["head"] = ("embed", "vocab")
    params["ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    axes["ln_f"] = ("embed",)

    if cfg.family == "ssm":
        params["blocks"], axes["blocks"] = _stack_init(
            _init_ssm_block, gen, cfg.n_layers, cfg, dtype, dev)
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        n_tail = cfg.n_layers - n_groups * every
        params["groups"], ax_in = _init_ssm_block(
            gen, cfg, dtype, dev, (n_groups, every))
        axes["groups"] = _prefix_axes(_prefix_axes(ax_in, "layers"),
                                      "groups")
        if n_tail:
            params["tail"], axes["tail"] = _stack_init(
                _init_ssm_block, gen, n_tail, cfg, dtype, dev)
        params["shared"], axes["shared"] = _init_block(gen, cfg, dtype, dev)
    else:
        params["blocks"], axes["blocks"] = _stack_init(
            _init_block, gen, cfg.n_layers, cfg, dtype, dev)
    return params, axes


def params_device(params) -> torch.device:
    """The device of a params tree (that of its first tensor)."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


# ---------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------

def _ffn(p, z, cfg):
    if cfg.moe_experts:
        B, S, d = z.shape
        return moe_ffn(p, z.reshape(B * S, d), cfg).reshape(B, S, d)
    if cfg.act == "sq_relu":
        return sq_relu_ffn(z, p["w_up"], p["w_down"])
    return swiglu(z, p["w_gate"], p["w_up"], p["w_down"])


def _block_fwd(p, x, cfg, positions, q_block, kv_block):
    p = gathered(p)
    x = _cx(x)
    h, _ = attn_forward(p["attn"], rms_norm(x, p["ln1"]), cfg, positions,
                        q_block=q_block, kv_block=kv_block)
    # each branch laid out as the residual before it is added: under a
    # mesh its partial sums over the model axis are reduced here, and
    # so are their gradients (else DTensor keeps the sum partial and
    # runs the next products on whole weights)
    x = x + _cx(h)
    y = _ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg)
    return _cx(x + _cx(y))


def _ssm_block_fwd(p, x, cfg):
    p = gathered(p)
    x = _cx(x)
    h, st, conv = ssd_forward(p["ssm"], rms_norm(x, p["ln"]), cfg)
    return _cx(x + _cx(h)), st, conv


def _as_tensor(a, device, dtype=None):
    return torch.as_tensor(a, dtype=dtype, device=device)


def _lookup(table, toks, cfg):
    if cfg.input_kind == "codes":
        outs = [table[q][toks[..., q]]                 # toks (B, S, nq)
                for q in range(cfg.n_codebooks)]
        return sum(outs)
    return table[toks]


def _embed(params, cfg, batch):
    dev = params["embed"].device
    if cfg.input_kind == "embeds":
        return _as_tensor(batch["embeds"], dev)
    toks = _as_tensor(batch["tokens"], dev).long()
    # under a mesh: each rank looks its batch shard up in the whole table
    # (DTensor lays an index into a sharded table out as a scatter of its
    # gradient, which not every torch release can)
    tok_axes = ("batch",) + (None,) * (toks.ndim - 1)
    return local_apply(lambda t, i: _lookup(t, i, cfg),
                       (params["embed"], toks),
                       [(None,) * params["embed"].ndim, tok_axes],
                       tok_axes + (None,))


def _positions(cfg, batch, x):
    B, S, _ = x.shape
    if cfg.rope == "mrope" and "positions" in batch:
        return _as_tensor(batch["positions"], x.device)
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    return replicated(ar.expand(3, B, S) if cfg.rope == "mrope"
                      else ar.expand(B, S), x)


def _unstack(tree) -> list:
    """Every layer's slice of the stacked tensors of ``tree``, taken with
    one ``unbind`` a tensor: its backward is one ``stack``, where slicing
    ``tensor[i]`` layer by layer would zero-fill a gradient the size of
    the whole stack for every layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _layers(f, x, stacked):
    for p in _unstack(stacked):
        x = f(x, p)
    return x


def forward(params, cfg: ArchConfig, batch, *, q_block=512, kv_block=512,
            return_hidden: bool = False):
    """Full-sequence forward -> logits (B, S, V[, nq])."""
    x = _embed(params, cfg, batch)
    positions = _positions(cfg, batch, x)

    if cfg.family == "ssm":
        f = _ckpt(lambda xc, p: _ssm_block_fwd(p, xc, cfg)[0], cfg)
        x = _layers(f, x, params["blocks"])
    elif cfg.family == "hybrid":
        def inner(xc, p):
            return _ssm_block_fwd(p, xc, cfg)[0]

        def group(xc, pg):
            xc = _layers(inner, xc, pg)
            return _block_fwd(params["shared"], xc, cfg, positions,
                              q_block, kv_block)
        x = _layers(_ckpt(group, cfg), x, params["groups"])
        if "tail" in params:
            x = _layers(_ckpt(inner, cfg), x, params["tail"])
    else:
        f = _ckpt(lambda xc, p: _block_fwd(p, xc, cfg, positions, q_block,
                                           kv_block), cfg)
        x = _layers(f, x, params["blocks"])

    x = rms_norm(x, params["ln_f"])
    if return_hidden:
        return x
    return apply_head(params, cfg, x)


def apply_head(params, cfg: ArchConfig, x):
    head = gathered(params["head"])
    if cfg.input_kind == "codes":
        # one product a codebook (the reference's einsum "...d,qdv->...qv",
        # bit for bit): DTensor cannot lay a vocab-sharded head through
        # the einsum's reshaped batched product
        return torch.stack([x @ head[q] for q in range(cfg.n_codebooks)],
                           dim=-2)
    return x @ head


def loss_fn(params, cfg: ArchConfig, batch, *, q_block=512, kv_block=512):
    """Cross entropy with the gold logit taken by an iota-compare masked
    sum, as the reference takes it; padded vocab columns
    (``cfg.vocab_real``) are masked out of the logsumexp."""
    logits = forward(params, cfg, batch, q_block=q_block, kv_block=kv_block)
    labels = _as_tensor(batch["labels"], logits.device)
    # under a mesh the logits stay sharded by batch and vocab, and each
    # reduction over the vocab is laid out by batch, gradients included
    tok_axes = ("batch",) + (None,) * (logits.ndim - 2)
    lf = constrain(logits.float(), *tok_axes, "model")
    iota_v = along(torch.arange(lf.shape[-1], device=lf.device), lf, -1)
    if getattr(cfg, "vocab_real", 0) and cfg.vocab_real < cfg.vocab:
        lf = torch.where(iota_v < cfg.vocab_real, lf, -1e30)
    m = lf.amax(dim=-1)
    lse = m + torch.log(constrain(torch.sum(torch.exp(lf - m[..., None]),
                                            dim=-1), *tok_axes))
    # the compare per rank on its batch and vocab shards: laid out by
    # DTensor, a compare broadcast over the labels' unit dim may come out
    # whole over the vocab, with every op after it (the vocab is whole
    # where the batch takes the model axis too)
    v_ax = None if get_option("dp_all") else "model"
    is_gold = local_apply(lambda iv, lb: iv == lb[..., None].long(),
                          (iota_v, labels), [(v_ax,), tok_axes],
                          tok_axes + (v_ax,))
    gold = constrain(torch.sum(torch.where(is_gold, lf, 0.0), dim=-1),
                     *tok_axes)
    return torch.mean(constrain(lse - gold, *tok_axes))


# ---------------------------------------------------------------------
# serving: prefill + decode with static-shape caches
# ---------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, dtype=None,
               *, device="cuda"):
    """Static-geometry cache (paper §3.2: allocate once, reuse), zeroed,
    on ``device`` (the card by default; without one this raises)."""
    dev = _device(device)
    dtype = dtype or _dtype(cfg)
    f32 = torch.float32
    KH, hd = cfg.n_kv_heads, cfg.head_dim

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        H = d_in // cfg.ssm_headdim
        ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
        st = (batch_size, H, cfg.ssm_state, cfg.ssm_headdim)
        cv = (batch_size, cfg.ssm_conv - 1, ch)
    if cfg.family == "ssm":
        return {"state": z((cfg.n_layers,) + st, f32),
                "conv": z((cfg.n_layers,) + cv)}
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        n_tail = cfg.n_layers - n_groups * every
        cache = {
            "state": z((n_groups, every) + st, f32),
            "conv": z((n_groups, every) + cv),
            "k": z((n_groups, batch_size, max_seq, KH, hd)),
            "v": z((n_groups, batch_size, max_seq, KH, hd)),
        }
        if n_tail:
            cache["state_tail"] = z((n_tail,) + st, f32)
            cache["conv_tail"] = z((n_tail,) + cv)
        return cache
    return {"k": z((cfg.n_layers, batch_size, max_seq, KH, hd)),
            "v": z((cfg.n_layers, batch_size, max_seq, KH, hd))}


def _ssm_decode_layers(blocks, x, state, conv, cfg):
    """Decode one token through stacked SSM blocks, writing each layer's
    new state and conv window into ``state[i]`` / ``conv[i]``."""
    for i, p in enumerate(_unstack(blocks)):
        p = gathered(p)
        x = _cxd(x)
        h, st2, conv2 = ssd_decode(p["ssm"], rms_norm(x, p["ln"]),
                                   state[i], conv[i], cfg)
        state[i] = st2
        conv[i] = conv2
        x = _cxd(x + _cxd(h))
    return x


def _attn_decode_block(p, x, ck, cv, pos, cfg):
    p = gathered(p)
    x = _cxd(x)
    h, _, _ = attn_decode(p["attn"], rms_norm(x, p["ln1"]), ck, cv, pos, cfg)
    x = x + _cxd(h)
    return _cxd(x + _cxd(_ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg)))


def decode_step(params, cfg: ArchConfig, cache, batch, pos: int):
    """One token for the whole batch. batch: tokens (B,1[,nq]) or embeds
    (B,1,d); pos: the current position (int).  Returns (logits, cache):
    the cache is the one given, updated in place."""
    x = _embed(params, cfg, batch)

    if cfg.family == "ssm":
        x = _ssm_decode_layers(params["blocks"], x, cache["state"],
                               cache["conv"], cfg)
    elif cfg.family == "hybrid":
        for g, pg in enumerate(_unstack(params["groups"])):
            x = _ssm_decode_layers(pg, x, cache["state"][g],
                                   cache["conv"][g], cfg)
            x = _attn_decode_block(params["shared"], x, cache["k"][g],
                                   cache["v"][g], pos, cfg)
        if "tail" in params:
            x = _ssm_decode_layers(params["tail"], x, cache["state_tail"],
                                   cache["conv_tail"], cfg)
    else:
        for i, p in enumerate(_unstack(params["blocks"])):
            x = _attn_decode_block(p, x, cache["k"][i], cache["v"][i], pos,
                                   cfg)

    x = rms_norm(x, params["ln_f"])
    return apply_head(params, cfg, x), cache


# ---------------------------------------------------------------------
# nn.Module view
# ---------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested params dict as nested modules whose leaves are
    ``nn.Parameter``s, so ``state_dict()`` keys are the dotted paths."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = v.tree() if isinstance(v, _Tree) else v
        return out


class LanguageModel(nn.Module):
    """``cfg``'s params as an ``nn.Module``.  ``params`` is the nested
    dict the functions of this module take, holding the module's own
    parameters; ``axes`` is the logical-axes pytree.  Initialised as
    ``init_params`` does, on the card unless ``device`` says otherwise
    (no card: raises)."""

    def __init__(self, cfg: ArchConfig, generator=None, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        params, self.axes = init_params(cfg, generator, device=device)
        self.tree = _Tree(params)

    @property
    def params(self) -> dict:
        return self.tree.tree()

    def forward(self, batch, **kw):
        return forward(self.params, self.cfg, batch, **kw)

    def loss(self, batch, **kw):
        return loss_fn(self.params, self.cfg, batch, **kw)
