"""How many device events a ``torch.profiler`` session records as the
process ages, on the card.

    PYTHONPATH=src python tools/profiler_session_probe.py [--steps 6] [--busy-s 90]

One fixed call, a DLRM-RM2 forward at its published widths (512 rows,
embedding lookup on B4), runs under ``--sessions`` profiler sessions in a
row; then the card multiplies 4,096² matrices for ``--busy-s`` seconds, as
a long run keeps it busy, and the sessions repeat, ``--steps`` times.  Each
line prints the process's age, the device events each session recorded and
in how many the B4 kernel appears.  The profiler loses records, it never
adds them: a session that records fewer events than another of the same
call lost some.  ``chip_smoke.py``'s ``on_card`` keeps the fullest of its
sessions because of what this prints.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import dlrm_rm2
from repro_torch.data import dlrm_batch
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.models import dlrm


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--busy-s", type=float, default=90.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_session_probe: torch sees no CUDA card")
    t_start = time.time()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    eb_kernel.build()
    cfg = dlrm_rm2.full_config()
    params = dlrm.init_params(torch.Generator(device="cuda").manual_seed(8), cfg, device="cuda")
    batch = dlrm_batch(1, batch=512, vocab=cfg.vocab_size, device="cuda")
    dense, sparse = batch["dense"].to("cuda"), batch["sparse"].to("cuda")

    def session():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                dlrm.forward(params, dense, sparse, cfg)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return sum(e.count for e in events), any("embedding_bag_kernel" in e.key for e in events)

    x = torch.randn(4096, 4096, device="cuda")
    for _ in range(args.steps):
        got = [session() for _ in range(args.sessions)]
        print(f"age {time.time() - t_start:.0f} s: device events {[n for n, _ in got]}, "
              f"B4 kernel in {sum(b for _, b in got)} of {len(got)}", flush=True)
        t0 = time.time()
        while time.time() - t0 < args.busy_s:
            x = (x @ x).clamp_(-1, 1)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
