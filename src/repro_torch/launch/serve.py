"""Serving launcher: batched prefill + decode against any registered arch.

The twin of the JAX package's ``launch/serve.py``: the same
``lm.prefill`` / ``lm.decode_step`` entry points, the same flags and
lines, run eagerly on the card (``--device cpu`` asks for the CPU). Its
loop is :func:`generate`, which ``chip_smoke.py`` times on the card. A draw
at ``--temperature`` > 0 comes from a ``torch.Generator`` seeded with
``--seed`` (not the JAX package's ``jax.random`` stream).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --no-smoke
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from ..configs import registry
from ..models import lm
from ..models.cnn import resolve_device


def sample(logits: torch.Tensor, temperature: float = 0.0,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: the argmax at temperature <= 0,
    else a draw from softmax(logits / temperature) with ``gen``."""
    if temperature <= 0:
        return torch.argmax(logits, -1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(params, cfg, prompts: torch.Tensor, max_new: int, *,
             temperature: float = 0.0, gen: Optional[torch.Generator] = None,
             mark: Optional[Callable[[str], None]] = None):
    """Prefill ``prompts`` ((B, P) tokens) into caches of ``P + max_new``
    positions, then ``max_new - 1`` decode steps, each fed the token drawn
    from the step before. ``mark(phase)`` is called at ``"start"``, after the
    prefill is issued (``"prefill"``) and after the last step is issued
    (``"decode"``), to time the phases. Returns (tokens (B, max_new) int32,
    the caches after the last step)."""
    mark = mark or (lambda phase: None)
    B, P = prompts.shape
    mark("start")
    logits, caches = lm.prefill(params, {"tokens": prompts}, cfg, max_len=P + max_new)
    mark("prefill")
    tok = sample(logits, temperature, gen)
    out = [tok]
    for i in range(max_new - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=prompts.device)
        logits, caches = lm.decode_step(params, caches, tok, pos, cfg)
        tok = sample(logits, temperature, gen)
        out.append(tok)
    mark("decode")
    return torch.stack(out, 1), caches


def host_clock(device: torch.device) -> tuple:
    """(a ``mark`` for :func:`generate` that waits for ``device`` and reads
    the host clock, the dict of times it fills)."""
    times = {}

    def mark(phase: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[phase] = time.perf_counter()

    return mark, times


def main(argv=None):
    ap = argparse.ArgumentParser(description="LM serving launcher")
    ap.add_argument("--arch", required=True)
    # BooleanOptionalAction so --no-smoke can actually select the full config
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; \"cpu\" asks for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.config_for(args.arch, smoke=args.smoke)
    params = lm.init(0, cfg, device=dev)
    B, P, T = args.batch, args.prompt_len, args.max_new

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    mark, t = host_clock(dev)
    tokens, _ = generate(params, cfg, prompts, T, temperature=args.temperature, gen=gen,
                         mark=mark)
    print(f"[prefill] {B}x{P} in {t['prefill'] - t['start']:.2f}s")
    dt = t["decode"] - t["prefill"]
    print(f"[decode] {B * (T - 1)} tokens in {dt:.2f}s "
          f"({B * (T - 1) / max(dt, 1e-9):.1f} tok/s)")
    print("first row:", tokens[0][:24].tolist())
    return tokens


if __name__ == "__main__":
    main()
