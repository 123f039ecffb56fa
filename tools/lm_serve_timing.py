"""Time gemma2-9b serving on the card as ``chip_smoke.py`` phase 3e serves
it, to hold one checkout's model path against another's in one call.

    python tools/lm_serve_timing.py [--src PATH] [--label NAME] [--seed 0]

The full config (42 layers, bf16 random weights from ``--seed``), then
``prefill_8k`` (1 × 8,192 tokens from ``lm_batch``, the last logits copied
back to the host: 1 warm and 5 timed requests) and ``generate``
(``launch/serve.serve_demo``, batch 4, 16 prompt + 16 greedy tokens, a
decode step each: 1 warm and 3 timed runs), all on the host's clock with
the card synchronised.  ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: this checkout's), so two checkouts
can be timed in turns on one card (parent, change, change, parent).
Prints one JSON line: the card's name and power limit, each request's ms,
their medians, and each generate run's median step ms.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    from repro_torch.configs import gemma2_9b
    from repro_torch.data import lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        print("lm_serve_timing: torch sees no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = gemma2_9b.full_config()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(args.seed + 9), cfg,
                           device="cuda")
    tokens = lm_batch(0, batch=1, seq=8192, vocab=cfg.vocab, seed=args.seed,
                      device="cpu")["tokens"]

    def request() -> float:  # a prompt from the host, the last logits back to it
        t0 = time.perf_counter()
        with torch.inference_mode():
            T.prefill(params, tokens.to("cuda"), cfg).cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill = [request() for _ in range(6)][1:]
    generate = []
    for _ in range(4):
        res = serve.serve_demo(gemma2_9b.ARCH_ID, seed=args.seed, device="cuda", cfg=cfg,
                               params=params, batch=4, prompt_len=16, gen=16)
        generate.append(statistics.median(res["step_ms"][1:]))
    out = {"label": args.label, "src": args.src, "card": smi, "torch": torch.__version__,
           "prefill_8k_ms": prefill, "prefill_8k_median_ms": statistics.median(prefill),
           "generate_step_ms": generate[1:],
           "generate_median_step_ms": statistics.median(generate[1:])}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
