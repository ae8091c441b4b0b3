"""Latent attention's kernels on the card against their plain versions: the
latent-decode kernel (``kernels/mla_decode.py``) and K1 at qk 192 / v 128
(latent attention's expanded prefill).  These tests need a CUDA device and
nvcc; without one they skip (decided inside the fixture, never at import).
Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mla.py

Limits: bf16 inputs, f32 sums; each kernel rounds P to bf16 before its
second product (at most about 2^-8 of the largest value summed) and its
output once, so 2e-2 of the output's scale, as the other kernels' checks."""
import pytest
import torch

LIMIT = 2e-2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(29)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,lens", [
    (1, 16, 64, [1]),                       # one key
    (3, 16, 200, [64, 65, 200]),            # a tile's edge, the whole cache
    (4, 32, 1000, [999, 1, 300, 1500]),     # two head tiles; past the cache
    (56, 16, 4096, None),                   # the cell's rows, split keys
])
def test_mla_decode_kernel_matches_its_plain_version(cuda, b, h, s, lens):
    from repro_torch.kernels import mla_decode as MD
    q = torch.randn((b, h, 576), generator=cuda, device="cuda").bfloat16()
    cache = torch.randn((b, s, 576), generator=cuda, device="cuda").bfloat16()
    if lens is None:
        lens = [s - 37 * i for i in range(b)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = MD.mla_decode_plain(q, cache, lengths, scale=0.1147)
    got = MD.mla_decode(q, cache, lengths, scale=0.1147)
    assert _rel_err(got, want) < LIMIT
    for n_splits in (1, 3):                 # one block a row; a merge
        chunk = -(-s // n_splits // MD.KEY_TILE) * MD.KEY_TILE
        got = MD.launch_with_split(q, cache, lengths, scale=0.1147,
                                   n_splits=-(-s // chunk), chunk=chunk)
        assert _rel_err(got, want) < LIMIT
    # the split counters are left at 0 for the next launch
    assert MD.mla_decode(q, cache, lengths, scale=0.1147).equal(
        MD.mla_decode(q, cache, lengths, scale=0.1147))


@pytest.mark.cuda
def test_mla_decode_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.mla_decode import mla_decode
    q = torch.zeros((2, 16, 576), device="cuda", dtype=torch.bfloat16)
    c = torch.zeros((2, 8, 576), device="cuda", dtype=torch.bfloat16)
    n = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        mla_decode(q.float(), c.float(), n, scale=1.0)
    with pytest.raises(ValueError):
        mla_decode(q[:, :8], c, n, scale=1.0)
    with pytest.raises(ValueError):
        mla_decode(q, c, n.long(), scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [5, 100, 256, 1000, 4096])
def test_k1_with_narrower_values_matches_its_plain_version(cuda, s):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, s, 16, 192), generator=cuda, device="cuda").bfloat16()
    k = torch.randn((1, s, 16, 192), generator=cuda, device="cuda").bfloat16()
    v = torch.randn((1, s, 16, 128), generator=cuda, device="cuda").bfloat16()
    want = fa.flash_attention_plain(q, k, v, group=1, scale=0.1147)
    assert _rel_err(fa.flash_attention(q, k, v, group=1, scale=0.1147),
                    want) < LIMIT
    for rows in (8, 4, 2):                  # every tiling the plan may take
        plan = fa.bf16_plan(1, s, 16, 192, rows, dv=128)
        got = fa.launch_with_plan(q, k, v, plan, causal=True, window=-1,
                                  cap=0.0, scale=0.1147)
        assert got.shape == (1, s, 16, 128)
        assert _rel_err(got, want) < LIMIT


@pytest.mark.cuda
def test_latent_attention_serves_through_both_kernels(cuda):
    """A reduced DeepSeek-V2-Lite (its widths, 3 layers, 8 experts) through
    the engine: every prefill runs K1 a layer, every decode step the latent
    kernel a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite"), n_layers=3, vocab_size=1024,
        moe=dataclasses.replace(get_config("deepseek-v2-lite").moe,
                                n_experts=8))
    eng = ServeEngine(cfg, batch=4, max_seq=96, prefill_len=64,
                      instrument=True, device="cuda")
    params = eng.model.init(torch.Generator(device="cuda").manual_seed(0))
    before = build.launches()
    out = eng.run(params, [Request(i, torch.randint(0, 1024, (64,)).numpy(), 5)
                           for i in range(4)])
    assert out["requests"] == 4
    after = build.launches()
    assert after["flash_attention"] - before["flash_attention"] == 4 * 3
    assert after["mla_decode"] - before["mla_decode"] == \
        3 * (eng.kinds_log.count("decode"))
