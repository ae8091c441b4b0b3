"""The slice as a whole: the port's ServeEngine against the JAX package's
(``attention_impl="pallas"``, interpret mode) on the same converted
parameters and the same synthetic requests — greedy tokens equal request by
request — plus the four cases of tests/test_serve.py on the port and the
idle-slot-past-``max_seq`` case."""
import numpy as np
import pytest
import torch

from _torch_port import SSM_ARCHS, model_pair
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import Request, ServeEngine, SyntheticRequests
from repro_torch.serve.sampler import greedy, sample


@pytest.fixture(scope="module")
def setup():
    return model_pair("qwen3-1.7b")


@pytest.fixture(scope="module", params=list(SSM_ARCHS))
def ssm_setup(request):
    return model_pair(request.param, **SSM_ARCHS[request.param])


def _outputs(eng):
    return {r.req_id: tuple(r.output) for r in eng.done}


def test_requests_streams_are_the_same():
    a = JRequests(256, prompt_len=9, mean_new=7, seed=3)
    b = SyntheticRequests(256, prompt_len=9, mean_new=7, seed=3)
    for i in range(5):
        ra, rb = a.request(i), b.request(i)
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
        assert ra.max_new_tokens == rb.max_new_tokens


def test_engine_matches_the_jax_engine(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    kw = dict(batch=3, max_seq=64, prefill_len=12, instrument=False)
    jeng = JEngine(jcfg, **kw)
    peng = ServeEngine(pcfg, device="cpu", **kw)
    jgen = JRequests(jcfg.vocab_size, prompt_len=10, mean_new=8, seed=0)
    pgen = SyntheticRequests(pcfg.vocab_size, prompt_len=10, mean_new=8, seed=0)
    jstats = jeng.run(jp, [jgen.request(i) for i in range(7)])
    pstats = peng.run(pp, [pgen.request(i) for i in range(7)])
    assert _outputs(peng) == _outputs(jeng)
    assert pstats["iterations"] == jstats["iterations"]
    assert peng.kinds_log == jeng.kinds_log
    assert set(pstats) == set(jstats)
    assert pstats["tokens"] == jstats["tokens"]


def test_ssm_engine_matches_the_jax_engine(ssm_setup):
    """Prompts of 20 steps: two SSD chunks of 16, the last ragged, so the
    inter-chunk carry and the copy of every cache key into the slot are on
    the path."""
    jcfg, jm, jp, pcfg, pm, pp = ssm_setup
    kw = dict(batch=3, max_seq=64, prefill_len=20, instrument=False)
    jeng = JEngine(jcfg, **kw)
    peng = ServeEngine(pcfg, device="cpu", **kw)
    jgen = JRequests(jcfg.vocab_size, prompt_len=18, mean_new=8, seed=0)
    pgen = SyntheticRequests(pcfg.vocab_size, prompt_len=18, mean_new=8, seed=0)
    jstats = jeng.run(jp, [jgen.request(i) for i in range(6)])
    pstats = peng.run(pp, [pgen.request(i) for i in range(6)])
    assert _outputs(peng) == _outputs(jeng)
    assert pstats["iterations"] == jstats["iterations"]
    assert peng.kinds_log == jeng.kinds_log
    assert pstats["tokens"] == jstats["tokens"]


def test_hybrid_idle_slot_counts_past_max_seq():
    jcfg, jm, jp, pcfg, pm, pp = model_pair("zamba2-1.2b",
                                            **SSM_ARCHS["zamba2-1.2b"])
    _idle_slot_counts_past_max_seq(jcfg, jp, pcfg, pp)


def test_idle_slot_counts_past_max_seq(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    _idle_slot_counts_past_max_seq(jcfg, jp, pcfg, pp)


def _idle_slot_counts_past_max_seq(jcfg, jp, pcfg, pp):
    """A finished slot's length keeps growing past the cache: its writes are
    dropped (no out-of-range index) and the other rows still match."""
    kw = dict(batch=2, max_seq=24, prefill_len=8, instrument=False)
    prompts = [np.arange(1, 9, dtype=np.int32) * (i + 3) % 256
               for i in range(3)]
    news = (40, 3, 40)
    jeng, peng = JEngine(jcfg, **kw), ServeEngine(pcfg, device="cpu", **kw)
    from repro.serve import Request as JRequest
    jeng.run(jp, [JRequest(i, prompts[i], news[i]) for i in range(3)])
    peng.run(pp, [Request(i, prompts[i], news[i]) for i in range(3)])
    assert int(peng.cache["length"].max()) > kw["max_seq"]
    np.testing.assert_array_equal(peng.cache["length"].numpy(),
                                  np.asarray(jeng.cache["length"]))
    assert _outputs(peng) == _outputs(jeng)
    np.testing.assert_array_equal(peng.lengths, peng.cache["length"].numpy())


def test_engine_completes_all_requests(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    eng = ServeEngine(pcfg, batch=3, max_seq=96, prefill_len=16,
                      instrument=False, device="cpu")
    gen = SyntheticRequests(pcfg.vocab_size, prompt_len=12, mean_new=8, seed=0)
    stats = eng.run(pp, [gen.request(i) for i in range(7)])
    assert stats["requests"] == 7
    assert stats["tokens"] > 7
    assert stats["tokens_per_s"] > 0
    for r in eng.done:
        assert len(r.output) >= 2


def test_greedy_decoding_deterministic(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    outs = []
    for _ in range(2):
        eng = ServeEngine(pcfg, batch=2, max_seq=64, prefill_len=8,
                          instrument=False, device="cpu")
        gen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=6,
                                seed=1)
        eng.run(pp, [gen.request(i) for i in range(3)])
        outs.append([tuple(r.output) for r in
                     sorted(eng.done, key=lambda r: r.req_id)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("defer", [True, False])
def test_profile_mixes_kinds(setup, defer):
    jcfg, jm, jp, pcfg, pm, pp = setup
    eng = ServeEngine(pcfg, batch=2, max_seq=64, prefill_len=8,
                      interval_steps=2.0, defer_analysis=defer, device="cpu")
    gen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=6, seed=0)
    eng.run(pp, [gen.request(i) for i in range(4)])
    assert "prefill" in eng.kinds_log and "decode" in eng.kinds_log
    prof = eng.profile()
    assert prof.n_intervals >= 1
    names = prof.table.names
    assert any(n.startswith("prefill/") for n in names)
    assert any(n.startswith("decode/") for n in names)


def test_snapshot_restore_resumes_identically(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    gen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=10, seed=2)
    reqs = [gen.request(i) for i in range(2)]
    kw = dict(batch=2, max_seq=64, prefill_len=8, instrument=False,
              device="cpu")
    eng = ServeEngine(pcfg, **kw)
    for r in reqs:
        eng.submit(r)
    for _ in range(5):
        eng.step(pp)
    snap = eng.snapshot()
    for _ in range(3):
        eng.step(pp)
    after_direct = eng.last_token.numpy().copy()

    eng2 = ServeEngine(pcfg, **kw)
    for r in reqs:
        eng2.submit(r)
    for _ in range(5):
        eng2.step(pp)
    eng2.restore(snap)
    for _ in range(3):
        eng2.step(pp)
    np.testing.assert_array_equal(after_direct, eng2.last_token.numpy())


def test_samplers():
    logits = torch.tensor([[[0.0, 3.0, 1.0]], [[5.0, 0.0, 1.0]]])
    assert greedy(logits).tolist() == [[1], [0]]
    assert greedy(logits).dtype == torch.int32
    assert sample(logits, None, temperature=0.0).tolist() == [[1], [0]]
    g = torch.Generator().manual_seed(0)
    a = sample(logits, g, temperature=1.0, top_k=1)
    assert a.tolist() == [[1], [0]] and a.shape == (2, 1)
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    assert torch.equal(sample(logits, g1, temperature=0.7),
                       sample(logits, g2, temperature=0.7))


def test_sampling_engine_runs(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    eng = ServeEngine(pcfg, batch=2, max_seq=48, prefill_len=8,
                      instrument=False, temperature=0.8, seed=3, device="cpu")
    gen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=4, seed=0)
    stats = eng.run(pp, [gen.request(i) for i in range(2)])
    assert stats["requests"] == 2
    for r in eng.done:
        assert all(0 <= t < pcfg.vocab_size for t in r.output)


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
def test_launcher_serves_the_ssm_families_on_cpu(arch, capsys):
    stats = serve_cli.main(["--arch", arch, "--reduced", "--requests", "2",
                            "--batch", "2", "--max-seq", "48",
                            "--prefill-len", "20", "--device", "cpu"])
    assert stats["requests"] == 2
    assert '"tokens_per_s"' in capsys.readouterr().out


def test_launcher_on_cpu(capsys):
    stats = serve_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--requests",
                            "2", "--batch", "2", "--max-seq", "48",
                            "--prefill-len", "8", "--device", "cpu"])
    assert stats["requests"] == 2
    assert '"tokens_per_s"' in capsys.readouterr().out
