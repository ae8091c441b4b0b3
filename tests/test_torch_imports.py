"""The port stands alone: no module of it, of its examples
(`examples_torch/`) or `chip_smoke.py` imports jax, the JAX package or its
benchmarks, every module imports with no GPU, no nvcc and no triton, and an
entry point that is not asked for the CPU raises where there is no card."""
import ast
import importlib
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "benchmarks", "triton"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ""


def _module_level(tree_path):
    tree = ast.parse(tree_path.read_text())
    return {id(n) for stmt in tree.body for n in ast.walk(stmt)
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    for node, name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN - {"triton"}, \
            f"{path}:{node.lineno} imports {name}"


def test_sources_were_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "flash_attention.py", "flash_decode.py", "build.py",
            "chip_smoke.py", "convert.py", "ssd.py", "ssm.py", "adamw.py",
            "schedule.py", "meter.py", "replay.py", "synthetic.py",
            "checkpointer.py", "state.py", "trainer.py", "train.py",
            "kmeans.py", "select.py", "markers.py", "nugget.py",
            "profile_store.py", "validate.py", "faults.py", "store.py",
            "journal.py", "scheduler.py", "stages.py", "runtime.py",
            "pipeline.py", "obs.py", "moe.py", "encdec.py", "packing.py",
            "loader.py", "sharding.py", "mesh.py", "grad_compress.py",
            "dryrun.py", "roofline.py", "hlo_analysis.py"} <= names
    for rel in ("distributed/__init__.py", "distributed/sharding.py",
                "distributed/pipeline.py", "distributed/faults.py",
                "launch/mesh.py", "optim/grad_compress.py"):
        assert (PKG / rel).exists(), rel
    assert (PKG / "kernels" / "csrc" / "flash_attention.cu").exists()
    assert (PKG / "kernels" / "csrc" / "flash_attention_tc.cu").exists()
    assert (PKG / "kernels" / "csrc" / "flash_decode.cu").exists()
    assert (PKG / "kernels" / "csrc" / "ssd.cu").exists()
    assert (PKG / "kernels" / "csrc" / "ssd_tc.cu").exists()
    # the five examples of the JAX package, under the same names
    assert [p.name for p in EXAMPLES] == sorted(
        p.name for p in (ROOT / "examples").glob("*.py"))


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


@pytest.mark.parametrize("name", list(_module_names()))
def test_every_module_imports_without_a_gpu(name):
    assert not torch.cuda.is_available() or True
    mod = importlib.import_module(name)
    assert mod.__name__ == name
    assert "triton" not in sys.modules


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine
    cfg = reduced(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(2, 1, 8, 1, 16, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(reduced(get_config("olmoe-1b-7b")))
    for arch in ("whisper-tiny", "internvl2-76b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(reduced(get_config(arch)))
    assert ServeEngine(cfg, device="cpu", instrument=False).device.type == "cpu"


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced", "--requests", "1"])


def test_pipeline_launcher_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.launch import pipeline
    with pytest.raises(RuntimeError, match="--device cpu"):
        pipeline.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2",
                       "--store", str(tmp_path)])
    assert not (tmp_path / "profile").exists()


def test_train_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.train import Trainer
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              attention_impl="chunked", ssm_impl="chunked")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, instrument=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_dryrun_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("qwen3-1.7b", "decode_32k", "single")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                     "--out", str(tmp_path / "cells")])
    assert not dist.is_initialized()        # no fake group was made
    assert not (tmp_path / "cells").exists()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler here: the one place that builds says so, by name."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is present")
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert len(build.source_hash()) == 16


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import subprocess
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
