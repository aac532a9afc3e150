"""Architecture configs of the port: the LM registry (the same entries as
the JAX package's) and the paper's CNN."""
from .registry import REGISTRY, ArchEntry, cells, config_for, get
