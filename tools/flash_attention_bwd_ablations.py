"""Where B6's backward time goes: ``bwd_sm90`` timed with one part taken out.

    PYTHONPATH=src python tools/flash_attention_bwd_ablations.py [--reps 10]
        [--shape "train_4k layer"] [--against path/to/other/flash_attention_bwd_sm90.cu]

Needs one CUDA card and ``nvcc``.  Each variant is
``csrc/flash_attention_bwd_sm90.cu`` with one part removed by a text
substitution (a substitution that no longer finds its text raises: update
``CUTS`` with the kernel), built with ``nvcc`` into ``build/kernels/ablations/``
(all builds at once) and timed by the card's own clock (``torch.profiler``),
kernel by kernel, in turns (the variants in order, then in reverse), at
one of ``chip_smoke.py``'s phase 5 shapes (``SHAPES``): q (1, S, 16, 256),
k and v (1, S, 8, 256) bf16, q and k of std 0.3, cap 50, causal, after the
``sm90`` forward (its output and row log-sum-exp):

* ``base``: the kernel as it ships;
* ``no_mufu``: the softcap's and P's ex2/rcp replaced by plain arithmetic
  (both kernels);
* ``no_sdp_b``, ``no_sdp_c``: (b)'s or (c)'s S and dP products not issued;
* ``no_g2_b``: (b)'s dV and dK products not issued;
* ``no_dq_c``: (c)'s dQ product not issued;
* ``no_bars_b``: (b) without its two named barriers (P^T and dS^T are
  read while being written);
* ``no_lse_b``: (b) without its loads of each step's lse and D_i rows
  (constants instead); ``no_sdp_lse_b``: that and ``no_sdp_b`` together;
* ``no_pwrite_b``: (b)'s P^T and dS^T not written to shared memory;
* ``no_products_b``: (b) with none of its four products; ``skeleton_b``:
  (b) with no products, MUFU work, lse loads or P^T writes: what is left
  is its copies, barriers and control;
* ``no_loads_b``, ``no_loads_c``: Q and dO (b), or K and V (c), loaded for
  the first ring stages only, every later step reusing them;
* ``against`` (with ``--against``): another version of the source, e.g.
  the parent commit's, whose gradients must equal ``base``'s within the
  bf16 tolerance.

Outputs of the ablated variants are wrong by design; only their times
mean anything.  Prints one JSON object with each variant's mean own ms by
kernel (dkdv, dq, preprocess) over its two turns, beside the card's name and
power limit.  The removal of a part that binds a kernel shortens it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402

_SKIP = "if (p.sq < 0) "  # false at run time: the product is compiled, never issued
_Q_LOADS = ("          mbar_expect_tx(full(s), 2 * kTileBytes);\n"
            "          for (int c = 0; c < kBoxes; ++c) {\n")
_Q_FIRST = ("          mbar_expect_tx(full(s), j < kStagesB ? 2 * kTileBytes : 0);\n"
            "          for (int c = 0; c < (j < kStagesB ? kBoxes : 0); ++c) {\n")
_KV_LOADS = ("        mbar_expect_tx({b}_full(s), kKBytes);\n"
             "        for (int c = 0; c < kBoxes; ++c) {{\n")
_KV_FIRST = ("        mbar_expect_tx({b}_full(s), j < kStagesC ? kKBytes : 0);\n"
             "        for (int c = 0; c < (j < kStagesC ? kBoxes : 0); ++c) {{\n")
_NO_LSE = [("          const float l = in ? p.lse[row_base + i] * kLog2e : 0.0f;",
            "          const float l = in ? 1.0f : 0.0f;"),
           ("          dl[n * 2 + e] = in ? p.delta[row_base + i] : 0.0f;",
            "          dl[n * 2 + e] = in ? 0.5f : 0.0f;")]
CUTS = {
    "base": [],
    "no_mufu": [("      const float r = rcp(1.0f + ex2(s[i] * c_in));",
                 "      const float r = s[i] * c_in;"),
                ("      s[i] = ex2(fmaf(c_neg, r, c_out) - lse2[i]);",
                 "      s[i] = fmaf(c_neg, r, c_out) - lse2[i];"),
                ("      s[i] = ex2(s[i] * p.score_scale - lse2[i]);",
                 "      s[i] = s[i] * p.score_scale - lse2[i];")],
    "no_sdp_b": [("      float st[16], dpt[16];", "      float st[16] = {}, dpt[16] = {};"),
                 ("        wgmma_ss_n32(st, ", f"        {_SKIP}wgmma_ss_n32(st, "),
                 ("        wgmma_ss_n32(dpt, ", f"        {_SKIP}wgmma_ss_n32(dpt, ")],
    "no_sdp_c": [("    float sc[16], dp[16];", "    float sc[16] = {}, dp[16] = {};"),
                 ("      wgmma_ss_n32(sc, ", f"      {_SKIP}wgmma_ss_n32(sc, "),
                 ("      wgmma_ss_n32(dp, ", f"      {_SKIP}wgmma_ss_n32(dp, ")],
    "no_g2_b": [("          wgmma_sst<DP>(acc, ", f"          {_SKIP}wgmma_sst<DP>(acc, ")],
    "no_dq_c": [("      wgmma_rs<DP>(dq, da[kk]", f"      {_SKIP}wgmma_rs<DP>(dq, da[kk]")],
    "no_bars_b": [("      bar_sync(kPBar, 256);\n", "\n"),
                  ("        bar_arrive(kDsBar, 256);\n", "\n"),
                  ("        bar_sync(kDsBar, 256);\n", "\n")],
    "no_lse_b": _NO_LSE,
    "no_sdp_lse_b": None,  # no_sdp_b and no_lse_b together (filled in below)
    "no_pwrite_b": [(f"        *reinterpret_cast<uint32_t*>({b} + woff[n]",
                     f"        {_SKIP}*reinterpret_cast<uint32_t*>({b} + woff[n]")
                    for b in ("pt", "dst")],
    "no_loads_b": [(_Q_LOADS, _Q_FIRST)],
    "no_loads_c": [(_KV_LOADS.format(b=b), _KV_FIRST.format(b=b)) for b in ("k", "v")],
}
CUTS["no_sdp_lse_b"] = CUTS["no_sdp_b"] + _NO_LSE
CUTS["no_products_b"] = CUTS["no_sdp_b"] + CUTS["no_g2_b"]
CUTS["skeleton_b"] = CUTS["no_products_b"] + CUTS["no_mufu"] + _NO_LSE + CUTS["no_pwrite_b"]
SHAPES = {"train_4k layer": (4096, 4096), "prefill_8k local layer": (8192, 4096),
          "prefill_8k global layer": (8192, None)}  # (S, window)
KERNELS = {"dkdv": "flash_attention_bwd_dkdv_sm90", "dq": "flash_attention_bwd_dq_sm90",
           "preprocess": "flash_attention_bwd_preprocess"}
TOL = 2e-2


def _source(cuts) -> str:
    text = kernel.SOURCE_BWD_SM90.read_text()
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"the kernel source no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    return text


def _build_variant(item) -> ctypes.CDLL:
    name, text = item
    out = _build.BUILD_DIR / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"bwd_sm90_{name}.cu", out / f"libbwd_sm90_{name}.so"
    src.write_text(text)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    kernel._declare_bwd_sm90(handle)
    return handle


def _own_ms(fn, reps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part, name in KERNELS.items():
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in hits)
        out[part] = (sum(e.self_device_time_total for e in hits) / 1e3 / count
                     if count else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shape", default="train_4k layer", choices=list(SHAPES))
    ap.add_argument("--against", default=None, help="another flash_attention_bwd_sm90.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablations: torch sees no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    texts = {name: _source(cuts) for name, cuts in CUTS.items()}
    if args.against:
        texts["against"] = Path(args.against).read_text()
    kernel.build_sm90()
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(_build_variant, texts.items())))
    s, window = SHAPES[args.shape]
    gen = torch.Generator(device="cuda").manual_seed(19)
    q = (torch.randn((1, s, 16, 256), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    k = (torch.randn((1, s, 8, 256), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    v = torch.randn((1, s, 8, 256), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(causal=True, window=window, cap=50.0, q_offset=0)
    o, lse, forward = ops._forward(q, k, v, kw, want_lse=True)
    grads = {name: tuple(torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in (q, k, v))
             for name in libs}
    delta = torch.empty(lse.shape, dtype=torch.float32, device="cuda")
    saved = kernel.LIBRARY_BWD_SM90._lib

    def call(name):
        kernel.LIBRARY_BWD_SM90._lib = libs[name]
        kernel.launch_flash_attention_bwd(q, k, v, o, lse, do, delta, *grads[name],
                                          variant="bwd_sm90", forward=forward, **kw)

    row = {"shape": args.shape, "S": s, "window": window, "card": smi, "own_ms": {}}
    try:
        for name in libs:
            call(name)
        torch.cuda.synchronize()
        if "against" in libs:
            row["against_share_of_tol"] = max(
                float((a.float() - b.float()).abs().max() / (TOL * b.float().abs().max()))
                for a, b in zip(grads["against"], grads["base"]))
            row["against_bitwise"] = all(a.equal(b) for a, b in zip(grads["against"],
                                                                    grads["base"]))
        turns = {name: [] for name in libs}
        for name in [*libs, *reversed(libs)]:
            turns[name].append(_own_ms(lambda: call(name), args.reps))
    finally:
        kernel.LIBRARY_BWD_SM90._lib = saved
    for name, ts in turns.items():
        row["own_ms"][name] = {part: (sum(t[part] for t in ts) / len(ts)
                                      if all(t[part] is not None for t in ts) else None)
                               for part in KERNELS}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
