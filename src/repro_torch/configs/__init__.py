"""Architecture configs of the port: the LM registry (the same entries as
the JAX package's), the input shapes, and the paper's CNN."""
from .registry import REGISTRY, ArchEntry, cells, config_for, get
from .shapes import SHAPES, ShapeSpec, input_specs
