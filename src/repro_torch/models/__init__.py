"""Model zoo of the port: the paper's CNN and the transformer LM family
(``lm_config``, ``layers``, ``moe``, ``frontends``, ``transformer``)."""
from . import cnn
