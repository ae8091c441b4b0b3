"""End-to-end training driver on the port: a ~100M-parameter qwen3-family
model with the production trainer — instrumented profiling,
checkpoint/restart, straggler watchdog, LR schedule, phased synthetic
corpus.  Training runs the chunked attention (the kernels have no backward).

Default arguments take a few minutes on the CPU; pass --steps 300
--seq-len 512 for the full run on the card.

    PYTHONPATH=src python examples_torch/train_100m.py --steps 30 [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ArchConfig, AttnConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.schedule import linear_warmup_cosine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

# ~100M params: 12L, d=768, 12 heads, d_ff 2048, 32k vocab
CFG_100M = ArchConfig(
    name="qwen3-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    d_ff=2048,
    vocab_size=32768,
    attn=AttnConfig(n_heads=12, n_kv_heads=4, head_dim=64, qk_norm=True),
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    attention_impl="chunked",
    ssm_impl="chunked",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts/ck_100m_torch")
    ap.add_argument("--profile-out", default="artifacts/prof_100m_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    print(f"model: {CFG_100M.name}  params≈{CFG_100M.param_count()/1e6:.0f}M")
    tr = Trainer(CFG_100M, seq_len=args.seq_len, batch=args.batch,
                 opt=AdamWConfig(lr=3e-4),
                 lr_fn=linear_warmup_cosine(3e-4, args.steps // 10 + 1,
                                            args.steps),
                 microbatch=args.microbatch,
                 ckpt_dir=args.ckpt_dir, ckpt_every=10,
                 interval_steps=2.0, device=args.device)
    tr.run(args.steps, log_every=5)   # resumes automatically
    rep = tr.watchdog_report()
    print(json.dumps({
        "final_loss": tr.metrics_history[-1]["loss"],
        "first_loss": tr.metrics_history[0]["loss"],
        "mean_step_ms": 1e3 * sum(tr.step_times[1:]) / max(len(tr.step_times) - 1, 1),
        "stragglers": rep.slow_steps,
        "resume": "delete %s to restart from scratch" % args.ckpt_dir,
    }, indent=1))
    if tr.builder is not None:
        from repro_torch.core import save_profile
        os.makedirs(args.profile_out, exist_ok=True)
        save_profile(args.profile_out, tr.profile())
        print("interval profile ->", args.profile_out)


if __name__ == "__main__":
    main()
