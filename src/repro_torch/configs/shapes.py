"""Input-shape specs for the (architecture × shape) grid of the LM
substrate, as the JAX package's ``repro.configs.shapes`` gives them.

Four shapes per architecture:
  train_4k     seq 4096  × global_batch 256   → a training step
  prefill_32k  seq 32768 × global_batch 32    → prefill
  decode_32k   one token, KV cache 32768, batch 128 → a decode step
  long_500k    one token, KV cache 524288, batch 1  → a decode step
               (sub-quadratic architectures only: ssm / hybrid / linear
               attention)

`input_specs` returns ``torch.empty(..., device="meta")`` stand-ins for
every model input — the shapes and dtypes of the reference's
``ShapeDtypeStruct``s, with no memory behind them — and
`decode_cache_specs` builds the decode cache on the meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: whisper decoder length for train/prefill cells (seq_len is the encoder
#: frame count; the decoder runs the standard 448-token transcript window).
WHISPER_DECODER_LEN = 448


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason). long_500k only runs for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: full quadratic attention"
    return True, ""


def _spec(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for one (arch × shape) cell's inputs."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        if cfg.encoder_layers > 0:  # whisper: frames in, transcript out
            return {
                "frames": _spec((B, S, cfg.d_model), act),
                "target_tokens": _spec((B, WHISPER_DECODER_LEN)),
                "target_labels": _spec((B, WHISPER_DECODER_LEN)),
            }
        specs = {"tokens": _spec((B, S)), "labels": _spec((B, S))}
        if cfg.frontend == "patches" and cfg.num_prefix_embeds > 0:
            specs["prefix_embeds"] = _spec(
                (B, cfg.num_prefix_embeds, cfg.d_model), act)
        return specs
    if shape.kind == "prefill":
        if cfg.encoder_layers > 0:
            return {
                "frames": _spec((B, min(S, cfg.max_source_len), cfg.d_model),
                                act),
                "tokens": _spec((B, WHISPER_DECODER_LEN)),
            }
        specs = {"tokens": _spec((B, S))}
        if cfg.frontend == "patches" and cfg.num_prefix_embeds > 0:
            specs["prefix_embeds"] = _spec(
                (B, cfg.num_prefix_embeds, cfg.d_model), act)
        return specs
    # decode: one new token against a cache of length S
    return {"tokens": _spec((B, 1))}


def decode_cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(the decode cache of a decode cell on the meta device — shapes and
    dtypes, nothing allocated —, the config it was built for: whisper's
    cross-attention source length cut to min(4096, S))."""
    from repro_torch.models.transformer import make_decode_cache
    B, S = shape.global_batch, shape.seq_len
    cfg_d = cfg
    if cfg.encoder_layers > 0:
        cfg_d = dataclasses.replace(cfg, max_source_len=min(4096, S))
    return make_decode_cache(cfg_d, B, max_len=S, device="meta"), cfg_d
