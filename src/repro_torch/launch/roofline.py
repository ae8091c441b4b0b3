# Counterpart of src/repro/launch/roofline.py; stdlib only, as there.
# `model_flops`, `analytic_hbm_bytes`, `_tp_ar_per_layer`,
# `analytic_collective_bytes`, `LEVERS`, `load_cells` and `markdown_table`
# are the reference's, copied byte for byte, so that both packages price one
# cell dict alike.  `analyze_cell` divides by one NVIDIA H100 SXM's
# datasheet figures in place of the v5e constants; `main` is the reference's
# too (pass the port's dry-run directory, `--dir artifacts/dryrun_torch`),
# and the module's entry point first says that the figures are a
# datasheet's.  Nothing of the module is left unported.
"""Roofline analysis from dry-run artifacts (EXPERIMENTS.md §Roofline).

Method (the reference's; ``cost_analysis`` there is per partition, and the
port's per-rank program is too):

- **compute term**: executed FLOPs of the step at global shapes
  (``trace_flops_global``), divided by the cell's *effective* devices
  (replicated-compute archs don't get credit for idle axes), over one H100's
  dense bf16 peak.
- **memory term**: analytic minimal HBM traffic per device per step
  (weights×microbatch passes, optimizer read+write, activation stash
  save+restore under remat, KV-cache traffic, logits) over HBM3's rate.
- **collective term**: analytic per-device collective bytes from the sharding
  plan (TP all-reduces per layer fwd+bwd, FSDP all-gathers per microbatch,
  gradient reduce-scatter, pod-axis gradient all-reduce), beside the
  recorded per-rank program's collective set, over NVLink within a pod and
  one InfiniBand link between pods.

The constants are specification figures of the H100 SXM datasheet, not
measurements; the entry point prints that above the table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

# NVIDIA H100 SXM datasheet (dense rates, no sparsity)
H100_FLOPS = 989e12          # bf16 tensor cores
H100_HBM = 3.35e12           # HBM3, bytes/s
H100_NVLINK = 450e9          # NVLink 4, bytes/s per direction per GPU
H100_POD = 50e9              # one 400 Gb/s NDR InfiniBand link per GPU
NVLINK_DOMAIN = 8            # GPUs that one NVLink switch joins (HGX H100)

SPEC_NOTE = ("roofline priced with NVIDIA H100 SXM datasheet figures "
             "(989 TFLOP/s bf16, 3.35 TB/s HBM3, 450 GB/s NVLink per "
             "direction, 50 GB/s NDR between pods): specification figures, "
             "not measurements")
NVLINK_NOTE = ("the 16-wide model axis spans two 8-GPU NVLink domains, so "
               "the NVLink rate of the collective term is optimistic")


def model_flops(cell: Dict[str, Any]) -> float:
    n = cell["active_param_count"]
    t = cell["tokens"]
    if cell["kind"] == "train":
        return 6.0 * n * t
    return 2.0 * n * t


def analytic_hbm_bytes(cell: Dict[str, Any]) -> float:
    """Per-device minimal HBM traffic per step (bytes)."""
    tp = max(cell.get("tp", 1), 1)
    dp = max(cell.get("dp", 1), 1)
    L = cell["n_layers"]
    d = cell["d_model"]
    kind = cell["kind"]
    mb = cell.get("microbatch", 1)
    n_params = cell["param_count"]
    bpp = cell.get("bytes_per_param", 2.0)
    p_c = bpp * n_params / tp               # compute-visible weights/dev

    if kind == "train":
        tokens_dev = cell["tokens"] / dp
        t_mb = tokens_dev / mb
        weights = 3.0 * p_c * mb             # fwd read + bwd read + grad write
        opt = 2.0 * 12.0 * n_params / (tp * dp)   # m,v,master read+write f32
        stash = 2.0 * tokens_dev * d * 2.0 * L    # save+restore layer inputs
        logits = 0.0                              # fused into loss (z-loss fwd)
        return weights + opt + stash + logits
    if kind == "prefill":
        tokens_dev = cell["tokens"] / dp
        act = 2.0 * tokens_dev * d * 2.0 * L
        cache = cell.get("cache_bytes_per_device", 0.0)
        return p_c + act + cache
    # decode: weights + cache read dominate
    cache = cell.get("cache_bytes_per_device", 0.0)
    return p_c + cache


def _tp_ar_per_layer(cell: Dict[str, Any]) -> float:
    """Forward TP all-reduces per layer, by family:
    dense/moe/vlm/encdec: 2 (attention out-proj + mlp/moe out) — 1 with
    parallel blocks (all-reduce reassociation); ssm: 1 (in_proj is
    column-parallel, only out_proj contracts a sharded dim); hybrid
    (zamba2): 1 per mamba layer + 2 per shared-attn application
    (every 6 layers) ≈ 1.33."""
    if cell.get("parallel_block"):
        return 1.0
    fam = cell.get("family", "dense")
    if fam == "ssm":
        return 1.0
    if fam == "hybrid":
        return 1.0 + 2.0 / 6.0
    return 2.0


def analytic_collective_bytes(cell: Dict[str, Any]) -> Dict[str, float]:
    """Per-device collective payload per step, split by fabric:
    {"ici": bytes over intra-pod torus axes, "pod": bytes over the pod axis}.
    """
    tp = max(cell.get("tp", 1), 1)
    dp = max(cell.get("dp", 1), 1)
    L = cell["n_layers"]
    d = cell["d_model"]
    kind = cell["kind"]
    mb = cell.get("microbatch", 1)
    n_params = cell["param_count"]
    bpp = cell.get("bytes_per_param", 2.0)
    p_c = bpp * n_params / tp
    multi_pod = cell.get("mesh") == "multi"
    grad_rs_bytes = cell.get("grad_rs_bytes", 4.0)   # f32 RS (perf lever: 2.0)
    tp_ar_per_layer = _tp_ar_per_layer(cell)          # fwd ARs per layer

    ici = 0.0
    pod = 0.0
    if kind == "train":
        tokens_dev = cell["tokens"] / dp
        if tp > 1:
            # tp_ar_per_layer fwd + same again bwd, [t_mb, d] bf16 payloads;
            # ring all-reduce moves 2(tp-1)/tp of the payload.
            ar_payload = (tokens_dev / mb) * d * 2.0
            ici += (2 * tp_ar_per_layer) * L * mb * ar_payload \
                * 2.0 * (tp - 1) / tp
        if cell.get("fsdp"):
            ici += 2.0 * p_c * mb * (dp - 1) / dp          # re-gather fwd+bwd
            ici += grad_rs_bytes * n_params / tp * (dp - 1) / dp   # grad RS
        if multi_pod:
            pod += 2.0 * grad_rs_bytes * n_params / (tp * dp)      # pod grad AR
        return {"ici": ici, "pod": pod}
    if kind == "prefill":
        tokens_dev = cell["tokens"] / dp
        if tp > 1:
            ici += tp_ar_per_layer * L * tokens_dev * d * 2.0 \
                * 2.0 * (tp - 1) / tp
        if cell.get("fsdp"):
            ici += p_c * (dp - 1) / dp
        return {"ici": ici, "pod": pod}
    # decode
    b_dev = cell["tokens"] / dp
    if tp > 1:
        ici += tp_ar_per_layer * L * b_dev * d * 2.0 * 2.0 * (tp - 1) / tp
    if cell.get("fsdp"):
        ici += p_c * (dp - 1) / dp
    return {"ici": ici, "pod": pod}


LEVERS = {
    "compute": ("raise per-device arithmetic efficiency: causal-skip "
                "attention schedule, drop remat recompute (selective "
                "policy), or reduce head/vocab padding waste"),
    "memory": ("cut HBM traffic: larger microbatch (fewer weight passes), "
               "selective remat (smaller stash), bf16 optimizer reads, or "
               "fuse logits into the loss"),
    "collective": ("cut ICI bytes: fewer/coarser TP all-reduces (merge "
                   "attn+mlp), int8 gradient compression, keep FSDP "
                   "gathers off the pod axis, overlap with compute via "
                   "latency-hiding scheduler"),
}


def analyze_cell(cell: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if cell.get("status") != "ok":
        return None
    eff = max(cell.get("eff_devices", cell["devices"]), 1)
    tf = cell.get("trace_flops_global", 0.0)
    compute_s = tf / eff / H100_FLOPS
    hbm = analytic_hbm_bytes(cell)
    memory_s = hbm / H100_HBM
    coll_parts = analytic_collective_bytes(cell)
    coll = coll_parts["ici"] + coll_parts["pod"]
    collective_s = coll_parts["ici"] / H100_NVLINK \
        + coll_parts["pod"] / H100_POD
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cell)
    bound = max(terms.values())
    roofline_frac = compute_s / bound if bound > 0 else 0.0
    return {
        "cell": cell["cell"],
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": tf,
        "useful_ratio": mf / tf if tf else 0.0,
        "roofline_fraction": roofline_frac,
        "hbm_bytes_dev": hbm,
        "collective_bytes_dev": coll,
        "hlo_collective_bytes_periter": cell.get("collective_bytes", 0.0),
        "lever": LEVERS[dominant],
        **({"note": NVLINK_NOTE} if cell.get("tp", 1) > NVLINK_DOMAIN else {}),
    }


def load_cells(dirpath: str) -> List[Dict[str, Any]]:
    out = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def markdown_table(rows: List[Dict[str, Any]], skipped: List[Dict]) -> str:
    hdr = ("| cell | compute s | memory s | collective s | dominant | "
           "MODEL/HLO flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['cell']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |")
    for s in skipped:
        lines.append(f"| {s['cell']} | — | — | — | "
                     f"{s['status']} | — | — |")
    return hdr + "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--json-out", default="artifacts/roofline.json")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    rows, skipped = [], []
    for c in cells:
        if c.get("status", "").startswith("skipped"):
            skipped.append(c)
            continue
        r = analyze_cell(c)
        if r:
            rows.append(r)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(markdown_table(rows, skipped))
    for r in rows:
        print(f"{r['cell']}: dominant={r['dominant']}; lever: {r['lever']}")


if __name__ == "__main__":
    print(SPEC_NOTE)
    main()
