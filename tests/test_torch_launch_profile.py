"""The port's train and serve launchers persist their run's profile with the
three flags of the JAX launchers (`--profile-out`, `--profile-cache`,
`--store`), through the port's `persist_profile_cli`; and `repro_torch.core`
exports the public names of `repro.core` but for the ones still to port."""
import json
import os

import numpy as np
import pytest

from repro_torch.core.profile_store import load_profile
from repro_torch.pipeline import ArtifactStore

TRAIN = ["--arch", "mamba2-780m", "--reduced", "--steps", "4", "--seq-len",
         "16", "--batch", "2", "--interval-steps", "2", "--device", "cpu"]
SERVE = ["--arch", "qwen3-1.7b", "--reduced", "--requests", "3", "--batch",
         "2", "--max-seq", "40", "--prefill-len", "8", "--device", "cpu"]


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr()


@pytest.mark.parametrize("which", ["train", "serve"])
def test_launcher_writes_and_reads_back_its_profile(which, tmp_path, capsys):
    from repro_torch.launch import serve, train
    main, base = (train.main, TRAIN) if which == "train" else \
        (serve.main, SERVE)
    out, store, cache = (str(tmp_path / n) for n in ("prof", "store", "cache"))
    argv = [*base, "--profile-out", out, "--store", store,
            "--profile-cache", cache]
    first = _run(main, argv, capsys)
    prof = load_profile(out)
    assert prof.n_intervals >= 1 and prof.n_steps > 0
    assert "profile_cache" in first.err and "hit=False" in first.err

    # --store: one committed profile artifact whose spec names the backend,
    # the device and the run, and whose payload is the same profile
    s = ArtifactStore(store)
    (key,) = os.listdir(os.path.join(store, "profile"))
    with open(os.path.join(store, "profile", key, "spec.json")) as f:
        doc = json.load(f)
    spec = doc["spec"]
    assert (spec["kind"], spec["backend"], spec["device"]) == \
        (which, "torch", "cpu")
    art = s.resolve("profile", spec)
    assert art.key == key and s.exists(art)
    stored = s.read_profile(art)
    np.testing.assert_array_equal(stored.bbv_matrix(), prof.bbv_matrix())
    assert [(i.start_step, i.end_step) for i in stored.intervals] == \
        [(i.start_step, i.end_step) for i in prof.intervals]

    # --profile-cache: the same run again is a hit on the cache
    again = _run(main, argv, capsys)
    assert "profile_cache" in again.err and "hit=True" in again.err


def test_core_exports_the_jax_core_names_but_the_unported():
    import repro.core as jx_core
    import repro_torch.core as pt_core

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    unported = {"jaxpr_cost"}       # `graph_cost` is its counterpart
    assert public(jx_core) - public(pt_core) == unported
    # jaxpr_cost's counterpart on the ATen graph
    assert public(pt_core) - public(jx_core) == {"graph_cost"}
    from repro_torch.core import read_meter, ReplayEngine, save_profile  # noqa: F401
