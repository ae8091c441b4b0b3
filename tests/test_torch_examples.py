"""The port's examples (`examples_torch/`, the five of `examples/` under the
same names, over the port's API) on the CPU at the reduced size:
`model_accuracy.py` and `serve_batched.py` run to their end with
``--device cpu``.  On the CPU the compiled side of the §V-B study is the top
level of a CPU profile's ATen ops (`hlo_analysis.cpu_op_histogram`), labelled
so in the output, never `kernel_histogram`, which raises without a card.
Their import check is tests/test_torch_imports.py's."""
import importlib.util
import pathlib

import pytest

from repro_torch.core import hlo_analysis as H

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_accuracy_runs_on_the_cpu(monkeypatch, capsys):
    mod = _load("model_accuracy")

    def refuse(*a, **kw):
        raise AssertionError("kernel_histogram called on the CPU")
    monkeypatch.setattr(H, "kernel_histogram", refuse)
    out = mod.main(["--device", "cpu", "--seq-len", "16"])
    text = capsys.readouterr().out
    assert set(out) == set(mod.ARCHS)
    for arch, res in out.items():
        assert not res["on_card"]
        assert sum(res["ir"].values()) > 0 and sum(res["compiled"].values())
        assert all(not k.startswith("aten::") for k in res["compiled"])
    assert text.count("top-level ATen ops of a CPU profile") == 3
    assert "kernels on the card" not in text
    for label in ("nugget_block_attn", "nugget_block_mlp",
                  "nugget_block_moe", "nugget_block_mamba"):
        assert f"{label}: " in text and f"{label}: 0 ops" not in text


def test_serve_batched_runs_on_the_cpu(capsys):
    stats, profile, sel = _load("serve_batched").main(["--device", "cpu"])
    assert stats["requests"] == 12
    assert profile.n_intervals >= 2 and len(sel.interval_ids) >= 1
    assert "k-means picked" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["model_accuracy", "serve_batched",
                                  "quickstart", "nugget_workflow",
                                  "train_100m"])
def test_examples_default_to_the_card(name):
    """Each takes ``--device``; without it, it asks for the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
