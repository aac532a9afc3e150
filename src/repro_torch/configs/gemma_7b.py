"""gemma-7b: assigned architecture config (see registry.py for the
source-annotated definition). Exposes CONFIG / SMOKE / SHAPES / SKIPS."""
from .registry import get as _get

_E = _get("gemma-7b")
CONFIG = _E.config
SMOKE = _E.smoke
SHAPES = _E.shapes
SHAPE_OVERRIDES = _E.shape_overrides
SKIPS = _E.skips
