"""Train a ~100M-parameter LM with checkpoints and a restart mid-run, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

The port's twin of ``examples/train_lm.py``: the same ``lm100m`` config
(12 layers, d 768, 12 query and 4 KV heads of 64, d_ff 2048, vocab 32,768,
Gemma-2's features: post-norms, softcaps, local/global layers with a 256
window, tied embeddings; f32), synthetic step-addressed batches of 2 x 128
tokens, AdamW, a ``TrainController`` checkpointing every ``--ckpt-every``
steps and a failure injected at ``steps // 2 + 1``, after which the loop
resumes from the last checkpoint; over a run of at least ``IMPROVE_AFTER``
steps the loss must improve (on these uniform random tokens it first rises
for some 10 to 20 steps while AdamW warms up).  On the card (the
default) every layer's attention runs B6 forward and B6's backward
kernels; ``--device cpu`` runs their plain versions.  With
``--check-restart`` an unbroken run from the same start follows, and the
broken run's parameters and its losses after the replay must equal it bit
for bit.  Ends with ``OK``.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_batch
from repro_torch.ft import FailureInjector, TrainController
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.train import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.optim.tree import leaves

BATCH, SEQ = 2, 128  # the reference example's scale
IMPROVE_AFTER = 40  # steps after which the last loss must lie below the first

# ~100M params: 12L, d=768, 12H/4KV, ff=2048, vocab=32768
CFG = T.TransformerConfig(
    name="lm100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
    d_ff=2048, vocab=32768, pattern=("local", "global"), window=256,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True, scale_embed=True,
    tie_embeddings=True, dtype=torch.float32, loss_chunk=128, attn_impl="direct",
)


def train(cfg, steps: int, ckpt_every: int, fail_at, device):
    """(final (params, opt) state, losses of every step run, replays included)."""
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)

    def loss(p, b):
        return T.loss_fn(p, b["tokens"], b["labels"], cfg)

    def batch_fn(step):
        return lm_batch(step, batch=BATCH, seq=SEQ, vocab=cfg.vocab, device=device)

    step_fn = make_train_step(loss, batch_fn, opt_cfg)
    losses = []

    def log(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 20 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}",
                  flush=True)

    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_torch_")
    try:
        ctrl = TrainController(CheckpointManager(ckpt_dir, keep=2), step_fn,
                               ckpt_every=ckpt_every)
        state = ctrl.run((params, init_state(params)), steps,
                         injector=FailureInjector(fail_at) if fail_at else None, log=log)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return state, losses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)  # "few hundred" on a card; ~8-20 on a CPU
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--check-restart", action="store_true",
                    help="also train unbroken and require the same bits")
    args = ap.parse_args()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"model: {CFG.n_params / 1e6:.1f}M params on {device}")

    fail_at = args.steps // 2 + 1
    fa_ops.reset_launches()
    state, losses = train(CFG, args.steps, args.ckpt_every, [fail_at], device)
    b6 = (fa_ops.launches[fa_ops.FLASH_ATTENTION], fa_ops.launches[fa_ops.FLASH_ATTENTION_BWD])
    print(f"\ninitial loss {losses[0]:.4f} → final {losses[-1]:.4f} "
          f"(survived 1 injected failure, {len(losses)} total steps incl. replay)")
    if device.type == "cuda":
        print(f"B6 launches: {b6[0]} forward, {b6[1]} backward")
        assert b6[1] >= len(losses) * CFG.n_layers, "every layer's backward ran B6's kernels"
    if args.steps >= IMPROVE_AFTER:
        assert losses[-1] < losses[0], "loss did not improve"
    if args.check_restart:
        whole, whole_losses = train(CFG, args.steps, args.ckpt_every, [], device)
        replayed = len(losses) - args.steps  # steps run twice: from the last checkpoint
        assert losses == whole_losses[:fail_at] + whole_losses[fail_at - replayed:], \
            "every step's loss, the replayed ones included, equals the unbroken run's"
        assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(whole))), \
            "the restarted run's parameters and moments equal the unbroken run's bit for bit"
        print(f"restart: bitwise the unbroken run ({replayed} steps replayed)")
    print("OK")


if __name__ == "__main__":
    main()
