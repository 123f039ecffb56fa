"""Serving launcher — batched autoregressive decode with a KV cache.

The prompt and the generation both run through ``decode_step`` (one token
a step against ring-buffer caches for windowed layers), as the reference's
demo does; tokens are picked greedily or drawn from a seeded generator.
By default the model is the arch's smoke config with random weights on the
card; ``cfg`` and ``params`` override them (``chip_smoke.py`` serves
Gemma-2-9B, Mixtral-8x22B and DBRX at full width through this entry
point).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --batch 4 --prompt-len 16 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T

__all__ = ["LM_ARCHS", "serve_demo", "main"]

# the LMs of the registry: dense and mixture-of-experts
LM_ARCHS = {k: m for k, m in ARCHS.items() if m.FAMILY == "lm"}


def serve_demo(arch_id: str, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
               greedy: bool = True, device=None, cfg: Optional[T.TransformerConfig] = None,
               params: Optional[Dict] = None) -> Dict:
    """Serve one batch of random prompts: ``prompt_len`` prompt tokens then
    ``gen`` generated ones, a decode step each.  Returns {"tokens": (batch,
    gen) int32 generated, "prompts": (batch, prompt_len), "logits": (batch,
    prompt_len + gen - 1, V) of every step, "step_ms": the host time of each
    step, the card synchronised after it}; the reference returns the
    generated tokens alone."""
    if arch_id not in LM_ARCHS:
        raise SystemExit(f"{arch_id} is not an LM; serve supports {sorted(LM_ARCHS)}")
    device = resolve_device(device)
    cfg = cfg or get_arch(arch_id).smoke_config()
    gen_ = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = T.init_params(gen_, cfg, device=device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen_, device=device,
                            dtype=torch.int32)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    max_len = prompt_len + gen
    cache = T.init_cache(cfg, batch, max_len, device=device)
    toks = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    toks[:, :prompt_len] = prompts
    logits, step_ms = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(max_len - 1):
            ts = time.perf_counter()
            lg, cache = T.decode_step(params, cache, toks[:, t:t + 1], cfg)
            if t >= prompt_len - 1:
                if greedy:
                    nxt = torch.argmax(lg[:, 0], dim=-1)
                else:
                    probs = torch.softmax(lg[:, 0].to(torch.float32), dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=gen_)[:, 0]
                toks[:, t + 1] = nxt.to(torch.int32)
            logits.append(lg[:, 0])
            sync()
            step_ms.append((time.perf_counter() - ts) * 1e3)
    dt = time.perf_counter() - t0
    print(f"generated ({batch}, {gen}) in {dt:.2f}s  ({batch * gen / dt:.1f} tok/s incl. "
          f"prompt steps) on {device.type}")
    return {"tokens": toks[:, prompt_len:], "prompts": prompts,
            "logits": torch.stack(logits, dim=1), "step_ms": step_ms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    out = serve_demo(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                     seed=args.seed, device=args.device)
    print("tokens", out["tokens"].cpu().tolist())


if __name__ == "__main__":
    main()
