"""Modality frontend STUBS: the backbone is the deliverable, and these
feed it precomputed frame/patch embeddings.

They exist so the examples can exercise the full input path: a frozen
random patch/frame projector with the right output geometry. They are NOT
trained vision/audio towers.

The frozen projection and tables are drawn from a ``torch.Generator`` (or
an int seed) on the input's device; either function also takes them as a
keyword, so a caller can pass its own (a parity test passes the JAX
package's draw).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .lm_config import LMConfig


def _generator(gen: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def siglip_stub_embed(gen, images: torch.Tensor, cfg: LMConfig, *,
                      weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, 3) -> (B, num_prefix_tokens, d_model): patchify + frozen
    random projection (SigLIP-so400m geometry: 16x16 grid = 256 tokens).
    ``weight`` (patch*patch*3, d_model) replaces the drawn projection."""
    B = images.shape[0]
    g = max(int(np.ceil(np.sqrt(cfg.num_prefix_tokens))), 1)
    patch = max(images.shape[1] // g, 1)
    x = images[:, :g * patch, :g * patch]
    x = x.reshape(B, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, patch * patch * 3)
    x = x[:, :cfg.num_prefix_tokens]
    if x.shape[1] < cfg.num_prefix_tokens:
        x = F.pad(x, (0, 0, 0, cfg.num_prefix_tokens - x.shape[1]))
    if weight is None:
        gen = _generator(gen, images.device)
        weight = torch.randn((x.shape[-1], cfg.d_model), generator=gen,
                             device=gen.device).to(images.device) / math.sqrt(x.shape[-1])
    return (x @ weight).to(getattr(torch, cfg.dtype))


def encodec_stub_embed(gen, codes: torch.Tensor, cfg: LMConfig, *,
                       tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, n_codebooks) EnCodec token codes -> (B, S, d_model): summed
    frozen codebook embeddings (MusicGen's delay-pattern input, stubbed).
    ``tables`` (n_codebooks, 2048, d_model) replaces the drawn tables."""
    B, S, nq = codes.shape
    if tables is None:
        gen = _generator(gen, codes.device)
        tables = torch.randn((nq, 2048, cfg.d_model), generator=gen,
                             device=gen.device).to(codes.device) * 0.02
    embs = sum(tables[q][codes[:, :, q].long()] for q in range(nq))
    return embs.to(getattr(torch, cfg.dtype))
