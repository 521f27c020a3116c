"""The port's shape grid and architecture modules against the JAX
package's: `SHAPES`, `WHISPER_DECODER_LEN`, `cell_is_runnable` and
`input_specs` (meta tensors of the reference's ``ShapeDtypeStruct``
shapes and dtypes) for the ten configs × four shapes, `decode_cache_specs`
layer by layer, and each ``configs/<arch>.py`` module's ``CONFIG`` and
``SMOKE`` field by field."""
import dataclasses
import importlib

import pytest

from repro.configs import registry as JR
from repro.configs import shapes as JS
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TS

ARCH_MODULES = ("grok1_314b", "hymba_1_5b", "llama4_maverick_400b",
                "llava_next_mistral_7b", "phi3_mini_3_8b", "qwen15_0_5b",
                "rwkv6_3b", "starcoder2_15b", "tinyllama_1_1b", "whisper_small")


def _configs():
    return [(name, TR.get_config(name), JR.get_config(name))
            for name in JR.ARCHS]


def _dtype(x) -> str:
    return str(x).replace("torch.", "")


def test_shape_grid_matches_reference():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, spec in TS.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(JS.SHAPES[name])
    assert TS.WHISPER_DECODER_LEN == JS.WHISPER_DECODER_LEN
    assert len(_configs()) == 10


@pytest.mark.parametrize("shape", list(JS.SHAPES))
def test_input_specs_match_reference(shape):
    """For every config: runnable or not (and why) as the reference says,
    and each input's name, shape and dtype; the port's inputs are meta
    tensors (no memory)."""
    for name, tcfg, jcfg in _configs():
        assert TS.cell_is_runnable(tcfg, TS.SHAPES[shape]) == \
            JS.cell_is_runnable(jcfg, JS.SHAPES[shape])
        got = TS.input_specs(tcfg, TS.SHAPES[shape])
        want = JS.input_specs(jcfg, JS.SHAPES[shape])
        assert list(got) == list(want), name
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "meta"
            assert (tuple(g.shape), _dtype(g.dtype)) == \
                (tuple(w.shape), str(w.dtype)), (name, k)


def _layers(cache):
    """(layer, field, shape, dtype) of a decode cache, a stacked layer
    cache split into its layers."""
    layers = cache.layers
    out = []
    fields = ("k", "v", "kpos", "k2", "v2", "kpos2", "ssm_h", "ssm_tail",
              "rwkv_s", "rwkv_prev_tm", "rwkv_prev_cm", "xk", "xv")
    if isinstance(layers, (tuple, list)):
        for li, c in enumerate(layers):
            out += [(li, f, tuple(getattr(c, f).shape),
                     _dtype(getattr(c, f).dtype))
                    for f in fields if getattr(c, f) is not None]
        return sorted(out)
    for f in fields:
        t = getattr(layers, f)
        if t is not None:
            out += [(li, f, tuple(t.shape[1:]), _dtype(t.dtype))
                    for li in range(t.shape[0])]
    return sorted(out)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_cache_specs_match_reference(shape):
    """Every runnable decode cell's cache: each layer's fields with the
    reference's shapes and dtypes, on the meta device."""
    for name, tcfg, jcfg in _configs():
        if not JS.cell_is_runnable(jcfg, JS.SHAPES[shape])[0]:
            continue
        got, tcfg_d = TS.decode_cache_specs(tcfg, TS.SHAPES[shape])
        want, jcfg_d = JS.decode_cache_specs(jcfg, JS.SHAPES[shape])
        assert dataclasses.asdict(tcfg_d) == dataclasses.asdict(jcfg_d)
        assert _layers(got) == _layers(want), name
        leaves = [t for _, t in (got.layers.tensors() if not isinstance(
            got.layers, tuple) else [x for c in got.layers for x in c.tensors()])]
        assert all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_arch_modules_match_reference(module):
    tm = importlib.import_module(f"repro_torch.configs.{module}")
    jm = importlib.import_module(f"repro.configs.{module}")
    for attr in ("CONFIG", "SMOKE"):
        got, want = getattr(tm, attr), getattr(jm, attr)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), (attr, f.name)
    assert tm.CONFIG == TR.get_config(tm.CONFIG.name)
