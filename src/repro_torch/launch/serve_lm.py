"""Serving example: batched prefill + decode loop with caches, greedy
sampling, and per-phase token accounting — the ``serve_step`` of the
decode_32k / long_500k shapes, at host scale. The twin of the JAX
package's ``examples/serve_lm.py``, with its consistency check: the greedy
tokens against the argmax of the teacher-forced forward.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch gemma2-9b] [--tokens 32]

(the arch resolves to its reduced smoke config; ``--no-smoke`` for the full
one). Without ``--device`` it runs on the GPU and raises when there is none.
"""
import argparse

import torch

from ..configs import registry
from ..models import lm
from ..models.cnn import resolve_device
from .serve import generate, host_clock


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    # BooleanOptionalAction: --no-smoke selects the full config
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; \"cpu\" asks for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.config_for(args.arch, smoke=args.smoke)
    params = lm.init(0, cfg, device=dev)
    label = "smoke" if args.smoke else "full"
    print(f"serving {args.arch} ({label} config: {cfg.num_layers}L d={cfg.d_model})")

    B, P, T = args.batch, args.prompt_len, args.tokens
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    mark, t = host_clock(dev)
    gen_toks, _ = generate(params, cfg, prompts, T, mark=mark)
    t_prefill, t_dec = t["prefill"] - t["start"], t["decode"] - t["prefill"]
    print(f"prefill: {B}×{P} tokens in {t_prefill*1e3:.0f} ms "
          f"({B*P/t_prefill:.0f} tok/s)")
    print(f"decode: {B}×{T-1} tokens in {t_dec*1e3:.0f} ms "
          f"({B*(T-1)/max(t_dec,1e-9):.0f} tok/s)")
    print(f"sample continuation (row 0): {gen_toks[0][:16].tolist()}")

    # consistency: decode path reproduces teacher-forced forward
    full = torch.cat([prompts, gen_toks[:, :-1]], dim=1)
    with torch.no_grad():
        ref_logits, _, _ = lm.forward(params, {"tokens": full}, cfg)
    ref_tok = torch.argmax(ref_logits[:, P - 1:], -1)
    agree = float((ref_tok[:, :gen_toks.shape[1]] == gen_toks).float().mean())
    print(f"greedy-path agreement with teacher-forced forward: {agree:.2%}")
    return agree


if __name__ == "__main__":
    main()
