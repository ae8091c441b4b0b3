"""The full research workflow the paper enables (§IV-B + §V-A), driven by
the port's artifact pipeline (``repro_torch.pipeline``):

1. instrumented run -> interval profile (ProfileStage, cached),
2. two selection methodologies (Random / K-means+silhouette),
3. nugget creation with markers (MarkStage) + LOW-OVERHEAD marker search,
4. native validation on TWO platforms (f32 vs bf16 execution),
5. cross-platform consistency: speedup-prediction error + per-nugget
   variability — 'consistent error across platforms beats low error on one'.

Both selector runs share one artifact store, so the second run reuses the
cached profile and baselines and re-runs only select/mark/replay/validate.

    PYTHONPATH=src python examples_torch/nugget_workflow.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import load_profile, plan_markers  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.pipeline import Pipeline, PipelineConfig  # noqa: E402

N_STEPS = 32


def run_method(store: str, selector: str, selector_args: dict, device: str):
    cfg = PipelineConfig(arch="olmoe-1b-7b", platforms=("f32", "bf16"),
                         selector=selector, selector_args=selector_args,
                         steps=N_STEPS, seq_len=32, batch=4,
                         interval_steps=2.5, seed=0, device=device)
    return Pipeline(cfg, store).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--store", default=None,
                    help="artifact store (default: a new temporary one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)           # no card and no --device cpu: raise
    store = args.store or tempfile.mkdtemp(prefix="nugget-store-")
    print(f"== artifact store: {store}")
    manifests = {}
    for mname, sargs in (("random", {"n_samples": 6, "seed": 0}),
                         ("kmeans", {"seed": 0})):
        manifests[mname] = run_method(store, mname, sargs, args.device)
        hits = manifests[mname]["cache_hits"]
        print(f"== {mname}: {hits} cache hits / "
              f"{manifests[mname]['cache_misses']} misses")

    # the profile is an inspectable artifact: load it back from the store
    prof_entry = next(s for s in manifests["random"]["stages"]
                      if s["kind"] == "profile")
    profile = load_profile(os.path.join(prof_entry["path"], "profile"))
    print(f"== {profile.n_intervals} intervals "
          f"(profile artifact {prof_entry['key'][:12]})")

    # marker study: true end marker vs low-overhead search
    plain = plan_markers(profile, 2, search_distance=0.0)
    cheap = plan_markers(profile, 2,
                         search_distance=0.4 * profile.step_uow)
    print(f"== markers for interval 2: end block "
          f"{profile.table.names[plain.end.block]} "
          f"(hook fraction {plain.hook_fraction:.3f}) vs low-overhead "
          f"{profile.table.names[cheap.end.block]} "
          f"(fraction {cheap.hook_fraction:.3f}, "
          f"precision loss {cheap.precision_loss_uow:.0f} uow)")

    for mname, manifest in manifests.items():
        m = manifest["metrics"]
        print(f"\n== {mname}: per-platform prediction error:",
              {p: f"{v['error']:+.1%}" for p, v in m["platforms"].items()})
        for e in m["speedup_errors"]:
            print(f"   speedup {e['pair']}: true {e['true_speedup']:.3f} "
                  f"pred {e['pred_speedup']:.3f} "
                  f"err {e['abs_speedup_error']:.1%}")
        rep = m["consistency"]
        print(f"   consistency: spread={rep['error_spread']:.3f} "
              f"=> {'TRUSTWORTHY' if rep['consistent'] else 'SUSPECT'}")
        worst = m["nugget_variability"][0]
        print(f"   most platform-sensitive nugget: id {worst['nugget_id']} "
              f"(rel-cost spread {worst['rel_cost_spread']:.3f})")


if __name__ == "__main__":
    main()
