"""Paper §V-B on the port: nugget-sized programs as organic microbenchmarks
that localize where the backend diverges from the portable-IR view.

For each of three architectures the ATen graph of the loss (the portable IR,
traced on meta tensors) is counted op by op, and set against what one call
actually runs: on the card, the kernels that torch.profiler records
(`kernel_histogram`); on the CPU, the top-level ATen ops of a CPU profile
(the CPU has no kernels to count).  The largest differences are the
"microcoding" view: N IR ops fused into one kernel, a product that is one
library call, the IR's plain attention where the card runs the port's own
kernel.  The block labels then place kernels in their blocks.

    PYTHONPATH=src python examples_torch/model_accuracy.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.core import hlo_analysis as H  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCHS = ("qwen3-1.7b", "mamba2-780m", "olmoe-1b-7b")
LABELS = {"qwen3-1.7b": ("nugget_block_attn", "nugget_block_mlp"),
          "mamba2-780m": ("nugget_block_mamba",),
          "olmoe-1b-7b": ("nugget_block_attn", "nugget_block_moe")}


def _meta_params(model):
    return L.map_specs(lambda s: torch.empty(
        L.stored_shape(s), dtype=L.spec_dtype(s) or torch.float32,
        device="meta"), model.specs())


def study(arch: str, device: str, batch: int, seq_len: int) -> dict:
    cfg = reduced(get_config(arch))
    meta = build_model(cfg, device="meta")
    shape = ShapeConfig("accuracy", "train", seq_len, batch)
    ir = H.ir_histogram(lambda p, b: meta.loss(p, b)[0], _meta_params(meta),
                        meta.input_specs(shape))

    model = build_model(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=torch.Generator().manual_seed(1)
                         ).to(model.device)
    data = {"tokens": toks, "labels": toks}

    @torch.no_grad()
    def loss():
        return model.loss(params, data)[0]

    on_card = model.device.type == "cuda"
    if on_card:
        compiled = H.kernel_histogram(loss)
        what = "kernels on the card"
        prof = H.profile_call(loss, cuda=True)
    else:
        loss()
        prof = H.profile_call(loss, cuda=False)
        compiled = H.cpu_op_histogram(prof)
        what = "top-level ATen ops of a CPU profile (no card: no kernels)"
    n_ir, n_c = sum(ir.values()), sum(compiled.values())
    print(f"\n== {arch}: portable-IR ops {n_ir} vs {what} {n_c} "
          f"(ratio {n_ir / max(n_c, 1):.2f}x)")
    print("   top microcoding deltas (op, IR count, compiled count):")
    for op, a, b in H.histogram_delta(ir, compiled)[:6]:
        print(f"     {op[:48]:48s} {a:6d} {b:6d}")
    for label in LABELS[arch]:
        found = H.find_scope_labels(prof, label)
        top = sorted(set(found), key=found.count, reverse=True)[:3]
        print(f"   {label}: {len(found)} ops, most {top}")
    return {"ir": ir, "compiled": compiled, "on_card": on_card}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    args = ap.parse_args(argv)
    return {arch: study(arch, args.device, args.batch, args.seq_len)
            for arch in ARCHS}


if __name__ == "__main__":
    main()
