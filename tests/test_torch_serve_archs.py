"""The four architectures that had run only in parity tests of their parts,
served whole: the port's ServeEngine against the JAX package's
(``attention_impl="pallas"``, interpret mode) on the CPU in f32 at the
reduced size, on parameters converted by ``convert.params_from_numpy`` and
the same synthetic requests.  Greedy tokens equal request by request, and
every prefill's and every decode step's logits within 2e-4, the
reference's own cross-implementation tolerance (tests/test_models.py).

gemma3-4b runs 6 layers (window 16; layer 5, the sixth, is global) with
prompts of 24 tokens and a ``max_seq`` of 64, so that every prefill and
every decode step reaches past the window; qwen2.5-14b has its QKV bias,
llama4-scout-17b-a16e top-1 routing with a shared expert, mistral-large-123b
its GQA."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_port import model_pair, to_np
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.serve import ServeEngine, SyntheticRequests

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = {"gemma3-4b": dict(n_layers=6), "qwen2.5-14b": {},
         "llama4-scout-17b-a16e": {}, "mistral-large-123b": {}}
ENGINE = dict(batch=3, max_seq=64, prefill_len=24, instrument=False)
PROMPT, MEAN_NEW, REQUESTS = 24, 8, 6


def _spy(fn, log):
    """``fn`` that also logs its logits (its first output) as numpy."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        log.append(to_np(out[0]))
        return out
    return call


def _serve(jcfg, jp, pcfg, pp):
    """Both engines over the same requests: (outputs, logits by kind,
    kinds log, stats) of each."""
    jeng = JEngine(jcfg, **ENGINE)
    peng = ServeEngine(pcfg, device="cpu", **ENGINE)
    logs = {"jax": {"prefill": [], "decode": []},
            "port": {"prefill": [], "decode": []}}
    jeng._prefill = _spy(jeng._prefill, logs["jax"]["prefill"])
    jeng._decode = _spy(jeng._decode, logs["jax"]["decode"])
    peng.model.prefill = _spy(peng.model.prefill, logs["port"]["prefill"])
    peng.model.decode_step = _spy(peng.model.decode_step,
                                  logs["port"]["decode"])
    out = {}
    for name, eng, gen in (
            ("jax", jeng, JRequests(jcfg.vocab_size, prompt_len=PROMPT,
                                    mean_new=MEAN_NEW, seed=0)),
            ("port", peng, SyntheticRequests(pcfg.vocab_size,
                                             prompt_len=PROMPT,
                                             mean_new=MEAN_NEW, seed=0))):
        stats = eng.run(jp if name == "jax" else pp,
                        [gen.request(i) for i in range(REQUESTS)])
        out[name] = {"outputs": {r.req_id: tuple(r.output)
                                 for r in eng.done},
                     "logits": logs[name], "kinds": list(eng.kinds_log),
                     "stats": stats,
                     "lengths": np.asarray(eng.cache["length"]).copy()}
    return out


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return model_pair(arch, **ARCHS[arch])


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    pair = _pair(request.param)
    return request.param, pair, _serve(*pair[:1], pair[2], pair[3], pair[5])


def test_greedy_tokens_equal(served):
    arch, _, out = served
    assert len(out["port"]["outputs"]) == REQUESTS
    assert out["port"]["outputs"] == out["jax"]["outputs"]
    assert out["port"]["kinds"] == out["jax"]["kinds"]
    assert out["port"]["stats"]["tokens"] == out["jax"]["stats"]["tokens"]
    np.testing.assert_array_equal(out["port"]["lengths"],
                                  out["jax"]["lengths"])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_logits_within_tolerance(served, kind):
    arch, _, out = served
    got, want = out["port"]["logits"][kind], out["jax"]["logits"][kind]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_gemma3_prefill_and_decode_cross_the_window():
    """Layers 0-4 keep a window of 16 and layer 5 is global; every prompt
    is longer than the window, so every decode step is too, and removing
    the window moves the port's logits far past the tolerance."""
    jcfg, _, _, pcfg, pm, pp = _pair("gemma3-4b")
    assert pcfg.layer_windows() == (16,) * 5 + (-1,)
    assert jcfg.layer_windows() == pcfg.layer_windows()
    assert PROMPT > 16 and ENGINE["prefill_len"] > 16
    from repro_torch.models.model_zoo import build_model
    glob = build_model(dataclasses.replace(pcfg, attn=dataclasses.replace(
        pcfg.attn, local_window=0)), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, pcfg.vocab_size, (2, PROMPT)).astype(np.int32))
    moved = {}
    for name, m in (("windowed", pm), ("global", glob)):
        cache = m.init_cache(2, ENGINE["max_seq"])
        pre = m.prefill(pp, {"tokens": toks}, cache)[0]
        dec = m.decode_step(pp, toks[:, :1], cache)[0]
        moved[name] = (to_np(pre), to_np(dec))
    for a, b in zip(moved["windowed"], moved["global"]):
        assert np.abs(a - b).max() > 100 * TOL["atol"]
