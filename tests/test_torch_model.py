"""The port's decoder LMs (dense, SSM, hybrid) against the JAX package's on
converted parameters (reduced size, f32, CPU): full-sequence logits, prefill
logits and cache, decode steps with unequal row lengths.  The JAX side runs
with ``attention_impl="pallas"`` (interpret mode) and its default
``ssm_impl="chunked"``, the port with ``"cuda"`` for both, which on CPU
tensors is the kernels' plain versions.  Tolerance 2e-4, the reference's own
cross-implementation tolerance (tests/test_models.py); the SSM state is held
to 2e-4 of its largest magnitude, which reaches 3e3 here: its f32 rounding
(exp of differences of cumulative sums) grows with it, and the reference's
own chunked and step-by-step SSDs differ by 6e-6 of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SSM_ARCHS, assert_close_to_scale, model_pair, to_np
from repro_torch.configs import get_config, reduced, reference_archs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model_zoo import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen3-1.7b", "qwen2.5-14b", "gemma3-4b", "mistral-large-123b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param)


@pytest.fixture(scope="module", params=list(SSM_ARCHS))
def ssm_pair(request):
    return model_pair(request.param, **SSM_ARCHS[request.param])


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_lm_forward_logits(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks = _tokens(pcfg, 2, 24)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_prefill_and_decode_steps(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    b, s, max_seq = 3, 10, 32
    toks = _tokens(pcfg, b, s, seed=1)
    jc = jm.init_cache(b, max_seq)
    pc = pm.init_cache(b, max_seq)
    want, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, pc2, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, pc)
    assert pc2 is pc                              # updated in place
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[key]), to_np(jc[key]), **TOL)
    np.testing.assert_array_equal(to_np(pc["length"]), to_np(jc["length"]))

    # unequal row lengths, as continuous batching leaves them: one row far
    # behind, one beyond the cache (an idle slot: its write is dropped)
    lens = np.asarray([s, 4, max_seq + 2], np.int32)
    jc["length"] = jnp.asarray(lens)
    pc["length"].copy_(torch.from_numpy(lens))
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, pcfg.vocab_size, size=(b, 1)).astype(np.int32)
        want, jc, _ = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, pc, _ = pm.decode_step(pp, torch.from_numpy(tok), pc)
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
        np.testing.assert_array_equal(to_np(pc["length"]), lens + step + 1)
        for key in ("k", "v"):
            np.testing.assert_allclose(to_np(pc[key]), to_np(jc[key]), **TOL)


def test_ssm_lm_forward_logits(ssm_pair):
    jcfg, jm, jp, pcfg, pm, pp = ssm_pair
    toks = _tokens(pcfg, 2, 40)       # three SSD chunks of 16, the last ragged
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_ssm_prefill_and_decode_steps(ssm_pair):
    jcfg, jm, jp, pcfg, pm, pp = ssm_pair
    b, s, max_seq = 3, 40, 64
    toks = _tokens(pcfg, b, s, seed=1)
    jc = jm.init_cache(b, max_seq)
    pc = pm.init_cache(b, max_seq)
    assert set(pc) == set(jc)
    for key in jc:
        assert tuple(pc[key].shape) == tuple(jc[key].shape), key
    assert pc["ssm"].dtype == torch.float32
    want, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, pc2, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, pc)
    assert pc2 is pc                              # updated in place
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    _check_cache(pc, jc)

    # unequal row lengths; one beyond the cache (an idle slot: its kv write
    # is dropped).  Lengths reach only the hybrid's shared attention.
    lens = np.asarray([s, 4, max_seq + 2], np.int32)
    jc["length"] = jnp.asarray(lens)
    pc["length"].copy_(torch.from_numpy(lens))
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, pcfg.vocab_size, size=(b, 1)).astype(np.int32)
        want, jc, _ = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, pc, _ = pm.decode_step(pp, torch.from_numpy(tok), pc)
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
        np.testing.assert_array_equal(to_np(pc["length"]), lens + step + 1)
        _check_cache(pc, jc)


def _check_cache(pc, jc):
    assert set(pc) == set(jc)
    for key in jc:
        if key == "ssm":
            assert_close_to_scale(pc[key], jc[key])
        else:
            np.testing.assert_allclose(to_np(pc[key]), to_np(jc[key]), **TOL)


def test_parallel_block_matches():
    jcfg, jm, jp, pcfg, pm, pp = model_pair("qwen3-1.7b")
    import dataclasses
    from repro.models.model_zoo import build_model as jbuild
    jm = jbuild(dataclasses.replace(jcfg, parallel_block=True))
    pm = build_model(dataclasses.replace(pcfg, parallel_block=True),
                     device="cpu")
    toks = _tokens(pcfg, 2, 12)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_params_round_trip_and_unknown_leaf(pair):
    _check_round_trip(pair)


def test_ssm_params_round_trip_and_unknown_leaf(ssm_pair):
    _check_round_trip(ssm_pair)


def _check_round_trip(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(pp)
    flat_a = jax.tree.leaves(tree)
    flat_b = jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)

    bad = dict(tree, surprise=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="surprise"):
        params_from_numpy(bad, pcfg, device="cpu")
    bad = dict(tree)
    bad["final_norm"] = {"scale": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_numpy(bad, pcfg, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "embed"}
    with pytest.raises(KeyError, match="embed"):
        params_from_numpy(bad, pcfg, device="cpu")


def test_bf16_leaves_convert_exactly():
    jcfg, jm, jp, pcfg, pm, pp = model_pair("qwen3-1.7b")
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    got = params_from_numpy(tree, pcfg, device="cpu", dtype=torch.bfloat16)
    leaf = got["layers"]["attn"]["wq"]["kernel"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(tree["layers"]["attn"]["wq"]["kernel"], np.float32))


@pytest.mark.parametrize("arch", reference_archs())
def test_configs_match_the_reference(arch):
    """Every field the two packages share is equal; the port's own fields
    hold the values that keep the reference's behaviour (`config_dict`
    drops them only there)."""
    import dataclasses
    from repro.configs import get_config as jget, reduced as jreduced
    from repro_torch.configs.base import config_dict
    for a, b in ((jget(arch), get_config(arch)),
                 (jreduced(jget(arch)), reduced(get_config(arch)))):
        da, db = dataclasses.asdict(a), config_dict(b)
        assert da.pop("attention_impl") == "chunked"
        assert db.pop("attention_impl") == "cuda"
        assert da.pop("ssm_impl") == "chunked"
        assert db.pop("ssm_impl") == "cuda"
        assert da == db
        assert a.layer_windows() == b.layer_windows()
        assert a.param_count() == b.param_count()


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_families_outside_the_slice_raise(arch):
    """Every family is ported, int4 weights too; what the port still
    refuses, naming where ROADMAP.md says why: the enc-dec family with an
    int8 cache (a fault of the reference) and a family it has not."""
    import dataclasses
    cfg = reduced(get_config(arch))
    build_model(cfg, device="cpu")
    build_model(dataclasses.replace(cfg, weight_quant="int4"), device="cpu")
    bad = (dataclasses.replace(cfg, cache_quant="int8")
           if cfg.family == "encdec"
           else dataclasses.replace(cfg, family="rnn"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(bad, device="cpu")


def test_init_shapes_match_the_reference_layout(pair):
    _check_init_shapes(pair)


def test_ssm_init_shapes_match_the_reference_layout(ssm_pair):
    _check_init_shapes(ssm_pair)


def _check_init_shapes(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    fresh = pm.init(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda a: tuple(a.shape), fresh)
    assert want == got
    assert pm.param_count(fresh) == jm.param_count(jp)
