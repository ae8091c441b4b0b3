"""int8 weights and the int8 KV cache of the port against the JAX package's,
on the CPU at the reduced size (f32).  `quantize_params` and `quantize_kv` /
`dequantize_kv` must give the JAX package's bytes (same f32 arithmetic,
round half to even); the quantized model's forward, prefill and decode agree
within 2e-4 (the reference's cross-implementation tolerance,
tests/test_models.py); and the port meets the reference's own two rules
(tests/test_perf_features.py): the int8-weight logits within a mean
relative difference of 0.08 of the float weights', and prefill + decode on
int8 weights within 2e-4 of teacher forcing.  The JAX side runs
``attention_impl="pallas"`` (interpret mode), the port ``"cuda"`` (on CPU
tensors the kernels' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_pair, to_np
from test_torch_train import _flat
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models.model_zoo import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import kvcache as PK
from repro_torch.models import layers as PL
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine, SyntheticRequests

TOL = 2e-4
INT8 = dict(weight_quant="int8", cache_quant="int8")


def _rel(got, want) -> float:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def qpair():
    """(JAX cfg, model, params; port cfg, model, params), int8 weights and
    cache, from qwen3-1.7b's converted float parameters quantized by each
    package."""
    jcfg, jm, jp, pcfg, pm, pp = model_pair("qwen3-1.7b")
    jcq, pcq = (dataclasses.replace(c, **INT8) for c in (jcfg, pcfg))
    jq = JL.quantize_params(jp, jm.axes())
    pq = PL.quantize_params(pp, pm.axes())
    return jcq, jbuild(jcq), jq, pcq, build_model(pcq, device="cpu"), pq


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "whisper-tiny",
                                  "internvl2-76b"])
def test_quantize_params_is_bit_equal(arch):
    """Every leaf's bytes and dtype: int8 payloads, f32 scales (stacked 3-D
    attention kernels: scale [L, h, k]), untouched other leaves."""
    jcfg, jm, jp, pcfg, pm, pp = model_pair(arch)
    want = _flat(jax.tree.map(np.asarray, JL.quantize_params(jp, jm.axes())))
    got = _flat(PL.quantize_params(pp, pm.axes()))
    assert sorted(got) == sorted(want)
    n_q = 0
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key
        n_q += key.endswith("kernel_q")
    assert n_q >= 5
    wq = got["/layers/attn/wq/kernel_q" if arch != "whisper-tiny"
             else "/dec_layers/attn/wq/kernel_q"]
    assert wq.dtype == torch.int8 and int(wq.abs().max()) == 127


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "whisper-tiny"])
@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_quantize_specs_match_the_reference(arch, qdtype):
    """Shapes, logical axes, inits and dtype overrides of the quantized
    ParamSpec tree, and the axes tree of `Model.axes`."""
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    jm = jbuild(jreduced(jget(arch)))
    pm = build_model(reduced(get_config(arch)), device="cpu")
    js = jax.tree_util.tree_flatten_with_path(
        JL.quantize_specs(jm.specs(), qdtype),
        is_leaf=lambda x: isinstance(x, JL.ParamSpec))[0]
    ps = _flat(PL.quantize_specs(pm.specs(), qdtype))
    want = {"/" + "/".join(k.key for k in path): s for path, s in js}
    assert sorted(ps) == sorted(want)
    for key, w in want.items():
        p = ps[key]
        assert (p.shape, p.axes, p.init, p.dtype) == \
            (w.shape, w.axes, w.init, w.dtype), key
    assert _flat(pm.axes()) == {
        "/" + "/".join(k.key for k in path): a for path, a in
        jax.tree_util.tree_flatten_with_path(
            jm.axes(), is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_quantized_init_takes_the_spec_dtypes():
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), **INT8)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    wq = p["layers"]["attn"]["wq"]
    assert wq["kernel_q"].dtype == torch.int8
    assert wq["kernel_scale"].dtype == torch.float32
    assert tuple(wq["kernel_scale"].shape) == tuple(wq["kernel_q"].shape[:1]
                                                    + wq["kernel_q"].shape[2:])
    float_specs = build_model(reduced(get_config("qwen3-1.7b")),
                              device="cpu").specs()
    spec = PL.quantize_specs(float_specs, "int4")["layers"]["attn"]["wq"][
        "kernel_q"]
    packed = spec.instantiate(torch.Generator(), torch.float32, "cpu")
    assert packed.dtype == torch.uint8 and not packed.any()
    assert tuple(packed.shape) == PL.stored_shape(spec)


@pytest.mark.parametrize("shape,scale", [((3, 5, 4, 16), 3.0),
                                         ((2, 7, 2, 64), 1e-3)])
def test_quantize_kv_is_bit_equal(shape, scale):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x *= scale
    x[0, 0, 0] = 0.0                          # a zero row: the 1e-8 floor
    x[0, 1, 0, :4] = [0.5, -0.5, 1.5, 2.5]    # ties round to even
    qj, sj = JK.quantize_kv(jnp.asarray(x))
    qp, sp = PK.quantize_kv(torch.from_numpy(x))
    assert qp.dtype == torch.int8 and sp.dtype == torch.bfloat16
    assert np.asarray(qj).tobytes() == qp.numpy().tobytes()
    assert np.asarray(sj.astype(jnp.float32)).tobytes() == \
        sp.float().numpy().tobytes()
    for jd, pd in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        dj = JK.dequantize_kv(qj, sj, jd).astype(jnp.float32)
        dp = PK.dequantize_kv(qp, sp, pd).float()
        assert np.asarray(dj).tobytes() == dp.numpy().tobytes()


def test_get_kernel_dequantizes_on_use():
    q = np.random.default_rng(2).integers(-127, 128, size=(6, 3, 4)
                                          ).astype(np.int8)
    s = np.random.default_rng(3).random((3, 4)).astype(np.float32)
    want = JL.get_kernel({"kernel_q": jnp.asarray(q),
                          "kernel_scale": jnp.asarray(s)}, jnp.float32)
    got = PL.get_kernel({"kernel_q": torch.from_numpy(q),
                         "kernel_scale": torch.from_numpy(s)}, torch.float32)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_int8_params_convert_keeping_their_dtypes(qpair):
    jcq, jm, jq, pcq, pm, pq = qpair
    conv = _flat(params_from_numpy(jax.tree.map(np.asarray, jq), pcq,
                                   device="cpu", dtype=torch.bfloat16))
    for key, t in _flat(pq).items():
        if key.endswith("kernel_q"):
            assert conv[key].dtype == torch.int8, key
            assert torch.equal(conv[key], t), key
        elif key.endswith("kernel_scale"):
            assert conv[key].dtype == torch.float32, key
            assert torch.equal(conv[key], t), key
        else:
            assert conv[key].dtype == torch.bfloat16, key


def test_int8_weight_forward_matches(qpair):
    jcq, jm, jq, pcq, pm, pq = qpair
    toks = _tokens(pcq, 2, 16)
    want, _ = jm.forward(jq, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pq, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= TOL


def test_int8_cache_prefill_and_decode_match(qpair):
    """The int8 cache's payloads and scales after the prefill and after each
    decode step, and the logits, with one row behind and one idle row past
    the cache."""
    jcq, jm, jq, pcq, pm, pq = qpair
    b, s, max_seq = 3, 8, 24
    toks = _tokens(pcq, b, s, seed=1)
    jc, pc = jm.init_cache(b, max_seq), pm.init_cache(b, max_seq)
    assert set(pc) == set(jc) == {"length", "k", "v", "k_scale", "v_scale"}
    assert pc["k"].dtype == torch.int8 and pc["k_scale"].dtype == torch.bfloat16
    want, jc, _ = jm.prefill(jq, {"tokens": jnp.asarray(toks)}, jc)
    got, pc, _ = pm.prefill(pq, {"tokens": torch.from_numpy(toks)}, pc)
    assert _rel(got, want) <= TOL
    for key in jc:
        assert _rel(pc[key], jc[key]) <= TOL, key
    lens = np.asarray([s, 3, max_seq + 2], np.int32)
    jc["length"] = jnp.asarray(lens)
    pc["length"].copy_(torch.from_numpy(lens))
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, pcq.vocab_size, size=(b, 1)).astype(np.int32)
        want, jc, _ = jm.decode_step(jq, jnp.asarray(tok), jc)
        got, pc, _ = pm.decode_step(pq, torch.from_numpy(tok), pc)
        assert _rel(got, want) <= TOL, step
        for key in jc:
            assert _rel(pc[key], jc[key]) <= TOL, (step, key)


def test_the_reference_rules_on_the_port():
    """tests/test_perf_features.py's two rules: int8 weights move the
    logits by a mean relative difference < 0.08; prefill + decode on int8
    weights stays within 2e-4 of the int8 forward (teacher forcing)."""
    cfg = reduced(get_config("qwen3-1.7b"))
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    cfg_q = dataclasses.replace(cfg, weight_quant="int8")
    m_q = build_model(cfg_q, device="cpu")
    pq = PL.quantize_params(params, m.axes())
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    lg, _ = m.forward(params, {"tokens": toks})
    lq, _ = m_q.forward(pq, {"tokens": toks})
    rel = (lg - lq).abs().mean() / lg.abs().mean()
    assert 0 < float(rel) < 0.08, float(rel)
    cache = m_q.init_cache(2, 24)
    out, cache, _ = m_q.prefill(pq, {"tokens": toks[:, :8]}, cache)
    err = [float((out[:, 0] - lq[:, 7]).abs().max())]
    for t in range(8, 16):
        out, cache, _ = m_q.decode_step(pq, toks[:, t:t + 1], cache)
        err.append(float((out[:, 0] - lq[:, t]).abs().max()))
    assert max(err) < 2e-4, err


def test_int8_engine_matches_the_jax_engine(qpair):
    jcq, jm, jq, pcq, pm, pq = qpair
    kw = dict(batch=3, max_seq=40, prefill_len=10, instrument=False)
    jeng = JEngine(jcq, **kw)
    peng = ServeEngine(pcq, device="cpu", **kw)
    jgen = JRequests(jcq.vocab_size, prompt_len=8, mean_new=6, seed=0)
    pgen = SyntheticRequests(pcq.vocab_size, prompt_len=8, mean_new=6,
                             seed=0)
    jeng.run(jq, [jgen.request(i) for i in range(5)])
    peng.run(pq, [pgen.request(i) for i in range(5)])
    assert {r.req_id: r.output for r in peng.done} == \
        {r.req_id: r.output for r in jeng.done}


def test_int4_weights_are_refused():
    """int4 weights serve (tests/test_torch_int4.py); a train step refuses
    them, as it refuses int8's: an integer payload has no gradient (the
    reference's value_and_grad refuses integer leaves too)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    for quant in ("int4", "int8"):
        cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                                  weight_quant=quant)
        m = build_model(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="integer payload"):
            init_train_state(m, torch.Generator().manual_seed(0),
                             AdamWConfig())


def test_int8_cache_on_an_ssm_family_raises_as_the_reference():
    cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")),
                              cache_quant="int8")
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    cache = m.init_cache(1, 16)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decoder-LM"):
        m.decode_step(params, tok, cache)


def test_update_layer_kv_and_l2norm_match():
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 10, 3, 8)).astype(np.float32)
    new = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    for index in (0, 3, 8):                   # 8: the start is clamped to 6
        jk, jv = JK.update_layer_kv(jnp.asarray(k), jnp.asarray(k),
                                    jnp.asarray(new), jnp.asarray(new), index)
        pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(k.copy())
        PK.update_layer_kv(pk, pv, torch.from_numpy(new),
                           torch.from_numpy(new), index)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 7
    np.testing.assert_allclose(PL.l2norm(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.l2norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
