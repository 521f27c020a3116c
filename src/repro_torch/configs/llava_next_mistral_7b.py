"""Config module for --arch (see registry for the exact published spec)."""
from repro_torch.configs.registry import LLAVA_NEXT_MISTRAL_7B as CONFIG  # noqa: F401
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
