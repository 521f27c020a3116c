"""Config module for --arch (see registry for the exact published spec)."""
from repro_torch.configs.registry import HYMBA_1_5B as CONFIG  # noqa: F401
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
