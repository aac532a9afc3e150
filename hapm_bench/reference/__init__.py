"""The benchmark's plain reference: the network, its prunings and its
training step in plain PyTorch, written from the paper's definitions. It
imports neither the program (``repro_torch``) nor JAX nor the JAX package,
and takes nothing the program made: it starts from the raw weights and
frames the benchmark draws from the seed."""
