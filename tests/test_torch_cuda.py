"""The CUDA kernels (K1, K2, K3, the grouped MoE products) against their
plain versions, on the card.
These tests need a CUDA device and nvcc; without one they skip (decided
inside the fixture, never at import).  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

`chip_smoke.py` runs the same sweeps as part of its `kernels` phase."""
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_flash_attention_kernel_sweep(smoke):
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = smoke.sweep_flash_attention(gen)
    assert res["cases"] >= 100


@pytest.mark.cuda
def test_flash_decode_kernel_sweep(smoke):
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = smoke.sweep_flash_decode(gen)
    assert res["cases"] >= 43


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(smoke):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    q = torch.zeros((1, 8, 2, 16), device="cuda")
    k = torch.zeros((1, 8, 1, 16), device="cuda")
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half(), group=2)
    with pytest.raises(ValueError):
        flash_attention(q[..., :8], k[..., :8], k[..., :8], group=2)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, k, group=2)
    with pytest.raises(ValueError):
        flash_decode(q[:, :1], k, k, torch.ones(1, device="cuda"), group=2)
    with pytest.raises(TypeError):
        flash_attention(q, k, k, group=2,
                        window=torch.tensor(4, device="cuda"))


@pytest.mark.cuda
def test_ssd_intra_kernel_sweep(smoke):
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = smoke.sweep_ssd(gen)
    assert res["cases"] >= 22
    assert res["max_rel_err"]["slow_far_min_decay"] > 1e-3


@pytest.mark.cuda
def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(smoke):
    from repro_torch.kernels.ssd import ssd_intra
    x = torch.zeros((1, 8, 2, 16), device="cuda")
    dt = torch.zeros((1, 8, 2), device="cuda")
    A = -torch.ones(2, device="cuda")
    b = torch.zeros((1, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        ssd_intra(x.half(), dt, A, b.half(), b.half(), 16)
    with pytest.raises(TypeError):
        ssd_intra(x, dt.bfloat16(), A, b, b, 16)
    with pytest.raises(ValueError):                   # head_dim 8
        ssd_intra(x[..., :8].contiguous(), dt, A, b, b, 16)
    with pytest.raises(ValueError):                   # d_state not 4k
        ssd_intra(x, dt, A, b[..., :6].contiguous(), b[..., :6].contiguous(),
                  16)
    with pytest.raises(ValueError):                   # not contiguous
        ssd_intra(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, b,
                  b, 16)


@pytest.mark.cuda
def test_grouped_mlp_kernel_sweep(smoke):
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = smoke.sweep_grouped_mlp(gen)
    assert res["cases"] >= 7


@pytest.mark.cuda
def test_grouped_mlp_wrapper_raises_on_what_the_kernel_does_not_take(smoke):
    from repro_torch.kernels.moe_grouped import grouped_mlp
    x = torch.zeros((1, 64), device="cuda", dtype=torch.bfloat16)
    w = torch.zeros((1, 64, 64), device="cuda", dtype=torch.bfloat16)
    idx = smoke._one_entry()
    with pytest.raises(ValueError):                   # f32
        grouped_mlp(x.float(), w.float(), w.float(), w.float(), *idx,
                    top_k=1)
    with pytest.raises(ValueError):                   # width 48
        grouped_mlp(x[:, :48].contiguous(), w[:, :48].contiguous(),
                    w[:, :48].contiguous(), w[:, :, :48].contiguous(), *idx,
                    top_k=1)
    with pytest.raises(ValueError):                   # not contiguous
        grouped_mlp(x, w.transpose(1, 2), w, w, *idx, top_k=1)
    with pytest.raises(ValueError):                   # int32 order
        grouped_mlp(x, w, w, w, idx[0].int(), *idx[1:], top_k=1)


@pytest.mark.cuda
def test_kernels_refuse_tensors_that_require_grad(smoke):
    """On the card each kernel wrapper raises under grad mode on a tensor
    that requires grad (its output would have no grad_fn), and so does
    `Model.loss` through `attention_impl="cuda"`; nothing launches."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model_zoo import build_model
    cfg = reduced(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    from repro_torch.models.layers import tree_leaves
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.zeros((1, 16), dtype=torch.int64, device="cuda")
    out = smoke.kernels_refuse_grad(dataclasses.replace(
        cfg, attention_impl="chunked"), params,
        {"tokens": toks, "labels": toks})
    assert set(out) == {"flash_attention", "flash_decode", "ssd_intra",
                        "grouped_mlp", "model_loss_cuda"}


@pytest.mark.cuda
def test_kernels_refuse_cuda_dtensors(smoke, tmp_path):
    """A CUDA DTensor passes the wrappers' device check; each wrapper raises,
    by name, before it reads a pointer, and nothing launches (an NCCL group
    of one rank)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    assert init_process_group(str(tmp_path / "store"), 0, 1) == "nccl"
    try:
        out = smoke.kernels_refuse_dtensor(make_host_mesh())
    finally:
        dist.destroy_process_group()
    assert set(out) == {"flash_attention", "flash_decode", "ssd_intra",
                        "grouped_mlp"}
    for name, msg in out.items():
        assert name in msg and "DTensor" in msg


@pytest.mark.cuda
def test_moe_serving_path_runs_the_attention_kernels(smoke):
    """A small MoE (olmoe-1b-7b reduced, head_dim 64, f32) served on the
    card: every prefill runs K1 and every decode step K2 in each layer, by
    the launch counters, and the greedy tokens are those of the plain path
    (`attention_impl="reference"`)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import ServeEngine, SyntheticRequests
    cfg = reduced(get_config("olmoe-1b-7b"))
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                            head_dim=64))
    gen = SyntheticRequests(cfg.vocab_size, prompt_len=12, mean_new=6, seed=0)
    outs = {}
    for impl in ("cuda", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        eng = ServeEngine(c, batch=2, max_seq=64, prefill_len=16,
                          instrument=False)
        params = eng.model.init(torch.Generator().manual_seed(0))
        smoke.reset_counters()
        eng.run(params, [gen.request(i) for i in range(4)])
        launches = smoke.read_counters()
        outs[impl] = {r.req_id: r.output for r in eng.done}
        if impl == "cuda":
            want = smoke.expected_launches(
                c, eng.kinds_log.count("prefill"),
                eng.kinds_log.count("decode"))
            assert launches == want and want["flash_decode"] > 0, launches
        else:
            assert launches == {k: 0 for k in smoke.KERNELS}, launches
    assert outs["cuda"] == outs["reference"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["whisper-tiny", "internvl2-76b",
                                  "qwen3-1.7b/int8"])
def test_enc_dec_vlm_and_int8_paths_run_the_attention_kernels(smoke, path):
    """The enc-dec, VLM and int8 serving paths, reduced (head_dim 64, f32),
    on the card: K1 in every prefill layer (the enc-dec encoder's layers,
    not causal, included), K2 in every decode layer (on the int8 path over
    the dequantized cache), K3 never, by the launch counters; the greedy
    tokens are those of the plain path (`attention_impl="reference"`)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.layers import quantize_params
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine, SyntheticRequests
    arch, _, variant = path.partition("/")
    base = reduced(get_config(arch))
    base = dataclasses.replace(base, attn=dataclasses.replace(base.attn,
                                                              head_dim=64))
    model = build_model(base)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = base
    if variant:
        cfg = dataclasses.replace(base, **smoke.VARIANTS[variant])
        params = quantize_params(params, model.axes())
    gen = SyntheticRequests(cfg.vocab_size, prompt_len=12, mean_new=6, seed=0)
    outs = {}
    for impl in ("cuda", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        eng = ServeEngine(c, batch=2, max_seq=64, prefill_len=16,
                          instrument=False)
        smoke.reset_counters()
        eng.run(params, [gen.request(i) for i in range(4)])
        launches = smoke.read_counters()
        outs[impl] = {r.req_id: r.output for r in eng.done}
        if impl == "cuda":
            want = smoke.expected_launches(
                c, eng.kinds_log.count("prefill"),
                eng.kinds_log.count("decode"))
            assert launches == want and want["flash_decode"] > 0, launches
            assert want["ssd_intra"] == 0
        else:
            assert launches == {k: 0 for k in smoke.KERNELS}, launches
    assert outs["cuda"] == outs["reference"]
