"""The dry-run's memory analysis (`hlo_analysis.LiveBytes`, the reference's
``compiled.memory_analysis()``) and ``hlo_bytes``, on the CPU: a
hand-counted program, then a train, a decode and a prefill cell at the
reduced size on a one-rank gloo mesh, each in a process of its own (a
process takes one process group for good).  A cell's arguments are its own
``*_bytes_per_device`` plus the batch; what a step writes in place (the
cache, the train state) is alias; the tracker leaves the recorded program,
so its FLOPs, bytes and collectives, as a recording that keeps every
tensor has them; and the cell's numbers equal those of the same tracker
over the port's plain program on real CPU tensors."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_port import run_ranks
from repro_torch.core.hlo_analysis import ProgramRecorder, program_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"
# the cells' shapes, small: (kind, seq_len, global batch)
SHAPES = {"train": (32, 4), "decode": (64, 4), "prefill": (32, 1)}


def _program(x):
    a = x + 1                       # 1 KiB
    b = torch.ones(512)             # 2 KiB: 3 KiB live
    del a                           # 2 KiB live
    c = b * 2                       # 2 KiB: 4 KiB live, the peak
    x.add_(c[:256])                 # in place, through a view: nothing new
    return c, x                     # b goes: 2 KiB live


@pytest.mark.parametrize("fake", [False, True])
def test_hand_counted_program(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with (FakeTensorMode() if fake else torch.no_grad()):
        x = torch.zeros(256)        # the argument: 1 KiB
        rec = ProgramRecorder()
        rec.memory.add_arguments(x)
        with rec:
            out = _program(x)
        got = rec.memory.summary(out)
    assert got == {"mem_argument_size_in_bytes": 1024,
                   "mem_output_size_in_bytes": 2048,
                   "mem_temp_size_in_bytes": 4096,
                   "mem_alias_size_in_bytes": 1024}
    assert rec.memory.live == 2048  # c alone
    del out
    assert rec.memory.live == 0
    # the program's text: one line per recorded call
    assert program_text(rec.ops) == "".join(
        op.target.__name__.split(".")[0] + "\n" for op in rec.ops)


def _config():
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config(ARCH), n_layers=2), attention_impl="chunked",
        ssm_impl="chunked")


def _costs(parts):
    from repro_torch.core import hlo_analysis as H
    from repro_torch.core.unit_of_work import graph_cost
    out = {"flops": 0.0, "bytes": 0.0, "ops": 0.0, "collectives": {},
           "histogram": {}, "hlo_bytes": 0}
    for ops, reps in parts:
        c = graph_cost(ops).scale(reps)
        out["flops"] += c.flops
        out["bytes"] += c.bytes
        out["ops"] += c.ops
        for k, v in H.collective_stats(ops).items():
            out["collectives"][k] = out["collectives"].get(k, 0) + \
                v["bytes"] * reps
        for k, n in H.op_histogram(ops).items():
            out["histogram"][k] = out["histogram"].get(k, 0) + n * reps
        out["hlo_bytes"] += len(program_text(ops).encode())
    return out


def _cell_on_one_rank(rank, world, init_file, kind):
    """One reduced cell of ``kind`` priced on a (1, 1) gloo mesh; its
    program recorded again by a recorder that keeps every tensor (the
    recording before the tracker); and the tracker over the port's plain
    step on real CPU tensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import hlo_analysis as H
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step

    cfg = _config()
    D.configure = lambda arch, **kw: dataclasses.replace(
        cfg, **({"remat": kw["remat"]} if kw.get("remat") else {}))
    seq, b = SHAPES[kind]
    shape = ShapeConfig(kind, kind, seq, b)
    knobs = {"remat": "full", "microbatch_override": 1} \
        if kind == "train" else {}
    init_process_group(init_file, 0, 1, device="cpu", timeout_s=60)
    mesh = make_host_mesh(model=1, device="cpu")
    cell = D.run_cell(ARCH, shape, "host", mesh=mesh, device="cpu", **knobs)

    class KeepAll(H.ProgramRecorder):
        """The recorder as it was before the tracker: every tensor that a
        recorded call takes or returns kept alive."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not self._paused and \
                    getattr(func, "namespace", "") in H.RECORDED:
                self.ops.append(H.RecordedOp(func, args, out))
                self.kept.append((args, out))
            return out

        def __init__(self):
            super().__init__()
            self.kept = []
    lay = D.layout_cell(ARCH, shape, "host", mesh=mesh, **knobs)
    tracked = _costs(D._record_program(lay, mesh, torch.device("cpu"),
                                       True)[0])
    real = H.ProgramRecorder
    H.ProgramRecorder = KeepAll
    try:
        lay = D.layout_cell(ARCH, shape, "host", mesh=mesh, **knobs)
        kept = _costs(D._record_program(lay, mesh, torch.device("cpu"),
                                        True)[0])
    finally:
        H.ProgramRecorder = real

    # the plain program on real tensors, under the same tracker
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rec = ProgramRecorder()
    if kind == "train":
        table = build_block_table(model, shape)
        opt = AdamWConfig()
        state = init_train_state(model, gen, opt, table)
        step = make_train_step(model, opt, constant(1e-4), table=table)
        toks = torch.randint(0, cfg.vocab_size, (b, seq), generator=gen,
                             dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        rec.memory.add_arguments((state, batch))
        with rec:
            out = step(state, batch)
    else:
        params = model.init(gen)
        cache = model.init_cache(b, seq)
        if kind == "decode":
            batch = {"token": torch.zeros((b, 1), dtype=torch.int32)}
            rec.memory.add_arguments((params, batch, cache))
            with rec:
                out = model.decode_step(params, batch["token"], cache)
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, seq),
                                             generator=gen,
                                             dtype=torch.int32)}
            rec.memory.add_arguments((params, batch, cache))
            with rec:
                out = model.prefill(params, batch, cache)
    plain = rec.memory.summary(out)
    return {"cell": {k: v for k, v in cell.items()
                     if k != "op_histogram_top"},
            "tracked": tracked, "kept": kept, "plain": plain,
            "batch_bytes": sum(v.numel() * v.element_size()
                               for v in batch.values())}


@pytest.fixture(scope="module", params=list(SHAPES))
def cell(request):
    (res,) = run_ranks(_cell_on_one_rank, 1, request.param, timeout=240)
    return request.param, res


def test_arguments_are_the_cells_bytes_and_the_batch(cell):
    kind, res = cell
    c = res["cell"]
    assert c["status"] == "ok"
    own = (c["state_bytes_per_device"] if kind == "train" else
           c["params_bytes_per_device"] + c["cache_bytes_per_device"])
    assert c["mem_argument_size_in_bytes"] == own + res["batch_bytes"]


def test_what_is_written_in_place_is_alias(cell):
    """The decode and prefill caches, and the train state (AdamW updates
    it in place): the reference's donated arguments."""
    kind, res = cell
    c = res["cell"]
    own = (c["state_bytes_per_device"] if kind == "train" else
           c["cache_bytes_per_device"])
    assert c["mem_alias_size_in_bytes"] == own
    assert 0 < c["mem_output_size_in_bytes"] <= c["mem_temp_size_in_bytes"]


def test_the_tracker_leaves_the_program_as_it_was(cell):
    """FLOPs, bytes accessed, collectives and every op count of the
    recording with the tracker equal the recording that keeps every
    tensor; ``hlo_bytes`` is the text of that program."""
    kind, res = cell
    assert res["tracked"] == res["kept"]
    c = res["cell"]
    assert c["flops"] == res["kept"]["flops"]
    assert c["bytes_accessed"] == res["kept"]["bytes"]
    assert c["hlo_bytes"] == res["kept"]["hlo_bytes"]
    assert {k: v["bytes"] for k, v in c["collectives"].items()} == \
        res["kept"]["collectives"]


def test_the_cell_equals_the_plain_program_on_real_tensors(cell):
    """The per-rank program on fake DTensors at one rank holds and frees
    what the plain program does on real CPU tensors, to the byte."""
    kind, res = cell
    c = res["cell"]
    assert {k: c[k] for k in res["plain"]} == res["plain"]


def test_the_cli_reports_the_memory_analysis(tmp_path):
    """Every ok cell of the CLI carries the reference's ``mem_*`` fields
    and ``hlo_bytes``; ``--dump-hlo`` is accepted (and, as in the
    reference, read by nothing)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--device", "cpu", "--dump-hlo", "--out", str(tmp_path)],
        check=True, env=env, cwd=ROOT, capture_output=True, timeout=300)
    with open(tmp_path / "whisper-tiny__decode_32k__single.json") as f:
        c = json.load(f)
    assert c["status"] == "ok"
    for k in ("mem_argument_size_in_bytes", "mem_output_size_in_bytes",
              "mem_temp_size_in_bytes", "mem_alias_size_in_bytes",
              "hlo_bytes"):
        assert isinstance(c[k], int) and c[k] > 0, k
    token = 128 // c["dp"] * 4               # the decode batch, int32
    assert c["mem_argument_size_in_bytes"] == \
        c["params_bytes_per_device"] + c["cache_bytes_per_device"] + token
    assert c["mem_alias_size_in_bytes"] == c["cache_bytes_per_device"]
