"""Parameter specification of the LM substrate, and random initialisation.

Each parameter is declared once as a :class:`ParamSpec` — shape, *logical*
sharding axes and initialiser — as in ``repro.models.params``, whose spec
trees this copies for every family (they are data: `param_count` walks
them). Per-layer parameters are stacked along a leading "layers" axis, so
a layer is a slice. The parameters are a nested dict of tensors with the
reference's keys, so converting its weights is a copy
(`repro_torch.convert.lm_params_from_reference`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


# ----------------------------------------------------------------------------
# spec trees per architecture family
# ----------------------------------------------------------------------------

def _attention_specs(cfg: ModelConfig, L: int) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "wq": ParamSpec((L, d, qd), ("layers", "embed", "qdim")),
        "wk": ParamSpec((L, d, kvd), ("layers", "embed", "kvdim")),
        "wv": ParamSpec((L, d, kvd), ("layers", "embed", "kvdim")),
        "wo": ParamSpec((L, qd, d), ("layers", "qdim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((L, qd), ("layers", "qdim"), init="zeros")
        s["bk"] = ParamSpec((L, kvd), ("layers", "kvdim"), init="zeros")
        s["bv"] = ParamSpec((L, kvd), ("layers", "kvdim"), init="zeros")
    return s


def _mlp_specs(cfg: ModelConfig, L: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "w_in": ParamSpec((L, d, f), ("layers", "embed", "mlp")),
        "w_out": ParamSpec((L, f, d), ("layers", "mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        s["w_gate"] = ParamSpec((L, d, f), ("layers", "embed", "mlp"))
    return s


def _moe_specs(cfg: ModelConfig, L: int) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": ParamSpec((L, d, E), ("layers", "embed", None), scale=0.1),
        "we_in": ParamSpec((L, E, d, f), ("layers", "expert", "embed", "mlp")),
        "we_out": ParamSpec((L, E, f, d), ("layers", "expert", "mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        s["we_gate"] = ParamSpec((L, E, d, f), ("layers", "expert", "embed", "mlp"))
    if cfg.shared_expert:
        s.update({f"shared_{k}": v for k, v in _mlp_specs(cfg, L).items()})
    return s


def _ssm_specs(cfg: ModelConfig, L: int) -> dict:
    """Mamba-style selective SSM (used standalone or as hymba's parallel head)."""
    d, di, st, dtr = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_dt_rank
    return {
        "in_proj": ParamSpec((L, d, 2 * di), ("layers", "embed", "ssm_inner")),
        "conv_w": ParamSpec((L, cfg.ssm_conv, di), ("layers", "conv", "ssm_inner"), scale=0.5),
        "x_proj": ParamSpec((L, di, dtr + 2 * st), ("layers", "ssm_inner", None)),
        "dt_proj": ParamSpec((L, dtr, di), ("layers", "dt", "ssm_inner")),
        "dt_bias": ParamSpec((L, di), ("layers", "ssm_inner"), init="zeros"),
        "a_log": ParamSpec((L, di, st), ("layers", "ssm_inner", "state"), init="ones"),
        "d_skip": ParamSpec((L, di), ("layers", "ssm_inner"), init="ones"),
        "out_proj": ParamSpec((L, di, d), ("layers", "ssm_inner", "embed")),
    }


def _rwkv_specs(cfg: ModelConfig, L: int) -> dict:
    """RWKV6 "Finch": data-dependent decay time-mix + squared-relu channel-mix."""
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    lora = cfg.rwkv_decay_lora
    fk = cfg.d_ff  # channel-mix hidden (3.5·d for rwkv6-3b)
    return {
        # time-mix interpolation coefficients (token shift)
        "mu_r": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "mu_k": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "mu_v": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "mu_g": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "mu_w": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "wr": ParamSpec((L, d, d), ("layers", "embed", "qdim")),
        "wk_": ParamSpec((L, d, d), ("layers", "embed", "kvdim")),
        "wv_": ParamSpec((L, d, d), ("layers", "embed", "kvdim")),
        "wg": ParamSpec((L, d, d), ("layers", "embed", "qdim")),
        "w_out": ParamSpec((L, d, d), ("layers", "qdim", "embed")),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x W1) W2))
        "decay_w0": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "decay_w1": ParamSpec((L, d, lora), ("layers", "embed", None), scale=0.1),
        "decay_w2": ParamSpec((L, lora, d), ("layers", None, "embed"), scale=0.1),
        "bonus_u": ParamSpec((L, H, cfg.rwkv_head_dim), ("layers", "heads", None), init="zeros"),
        "ln_x": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        # channel-mix
        "cm_mu_k": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "cm_mu_r": ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5),
        "cm_wk": ParamSpec((L, d, fk), ("layers", "embed", "mlp")),
        "cm_wv": ParamSpec((L, fk, d), ("layers", "mlp", "embed")),
        "cm_wr": ParamSpec((L, d, d), ("layers", "embed", "qdim")),
    }


def _block_specs(cfg: ModelConfig, L: int, cross_attention: bool = False) -> dict:
    """One stack of transformer blocks (stacked over L layers)."""
    d = cfg.d_model
    s: dict = {"ln1": ParamSpec((L, d), ("layers", "embed"), init="ones")}
    if cfg.rwkv:
        s.update(_rwkv_specs(cfg, L))
        s["ln2"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
        return s
    if not cfg.attention_free:
        s["attn"] = _attention_specs(cfg, L)  # type: ignore[assignment]
    if cfg.hybrid_ssm or cfg.family == "ssm":
        s["ssm"] = _ssm_specs(cfg, L)  # type: ignore[assignment]
        if cfg.hybrid_ssm:
            # Hymba: learned per-channel mixing of the parallel heads
            s["mix_attn"] = ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5)
            s["mix_ssm"] = ParamSpec((L, d), ("layers", "embed"), init="ones", scale=0.5)
    s["ln2"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
    if cross_attention:
        s["xattn"] = _attention_specs(cfg, L)  # type: ignore[assignment]
        s["ln_x"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
    if cfg.num_experts > 0 and cfg.moe_every == 1:
        s["moe"] = _moe_specs(cfg, L)  # type: ignore[assignment]
    elif cfg.num_experts > 0:
        # interleaved: scan unit = (dense layer, moe layer) pairs
        s["mlp"] = _mlp_specs(cfg, L)  # type: ignore[assignment]
        s["moe"] = _moe_specs(cfg, L)  # type: ignore[assignment]
        s["ln3"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
        s["ln4"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
        s["attn2"] = _attention_specs(cfg, L)  # type: ignore[assignment]
    else:
        s["mlp"] = _mlp_specs(cfg, L)  # type: ignore[assignment]
    return s


def param_specs(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    tree: dict = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed"),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        tree["head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.encoder_layers > 0:
        tree["enc_blocks"] = _block_specs(cfg, cfg.encoder_layers)
        tree["dec_blocks"] = _block_specs(cfg, cfg.decoder_layers, cross_attention=True)
        tree["ln_enc"] = ParamSpec((d,), ("embed",), init="ones")
        tree["enc_pos"] = ParamSpec((cfg.max_source_len, d), (None, "embed"), init="embed")
    else:
        L = cfg.num_layers
        if cfg.num_experts > 0 and cfg.moe_every == 2:
            L = cfg.num_layers // 2  # scan over (dense, moe) pairs
        tree["blocks"] = _block_specs(cfg, L)
    if cfg.frontend in ("patches", "frames"):
        # stub frontend: a single linear adapter from precomputed embeddings
        tree["frontend_proj"] = ParamSpec((d, d), ("embed", "qdim"))
    return tree


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], ParamSpec]]:
    """(path, spec) of every leaf, keys in sorted order (JAX's flattening
    order of a dict)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, ParamSpec):
            yield path + (k,), v
        else:
            yield from _leaves(v, path + (k,))


def is_expert_param(path) -> bool:
    return any(str(n).startswith("we_") for n in path)


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    """Parameters of ``cfg``; with ``active``, per token (an MoE layer's
    experts count as ``experts_per_token`` of ``num_experts``)."""
    total = 0
    for path, s in _leaves(param_specs(cfg)):
        numel = int(np.prod(s.shape))
        if active and is_expert_param(path) and cfg.num_experts > 0:
            numel = numel * max(cfg.experts_per_token, 1) // cfg.num_experts
        total += numel
    return total


def _init_tensor(spec: ParamSpec, gen: torch.Generator, dev) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=torch.float32, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=torch.float32, device=dev)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / np.sqrt(max(fan_in, 1))
    if spec.init == "embed":
        std = spec.scale * 0.02
    return torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=dev) * float(std)


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> dict:
    """``param_specs(cfg)`` as ``dtype`` tensors on the ``meta`` device:
    every leaf's shape and dtype and no storage, the structure a checkpoint
    restores into (`repro_torch.train.checkpoint.restore`)."""
    def walk(tree):
        return {k: torch.empty(v.shape, dtype=dtype, device="meta")
                if isinstance(v, ParamSpec) else walk(v) for k, v in tree.items()}
    return walk(param_specs(cfg))


def init_params(cfg: ModelConfig, seed: int, device: D.DeviceLike = None) -> dict:
    """Random parameters of ``cfg`` from ``seed``: normal with std
    scale/√fan_in (embeddings 0.02·scale), zeros and ones as the specs say,
    all float32 whatever ``cfg.dtype`` says, as the reference draws them.
    The draws come from one `torch.Generator` on the target device, leaf by
    leaf in sorted-key order, so they differ between devices and from
    JAX's; the tests share weights through `convert`."""
    dev = D.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out: dict = {}
    for path, spec in _leaves(param_specs(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_tensor(spec, gen, dev)
    return out
