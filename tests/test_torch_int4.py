"""int4 weights of the port against the JAX package's, on the CPU at the
reduced size (f32).  The reference has no int4 quantizer (its int4 specs
initialise to zeros), so both packages get the same random int4 payloads in
[-8, 7] and random positive scales, set in the JAX parameters and converted.
torch has no int4 storage: the port packs two values a byte along the
kernel's "embed" axis (`layers.pack_int4`) and unpacks them to the compute
dtype on use.  Tolerance 2e-4 of the largest logit (the reference's
cross-implementation tolerance, tests/test_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_pair
from test_torch_train import _flat
from repro.models import layers as JL
from repro.models.model_zoo import build_model as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as PL
from repro_torch.models.model_zoo import build_model

TOL = 2e-4


def _rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _random_int4(jparams, seed: int):
    """The JAX parameters with every int4 payload drawn in [-8, 7] and every
    scale positive, about 1 / (4.6 sqrt(fan-in)) so that activations stay
    O(1) (4.6 is the spread of a uniform nibble)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "kernel_q" in node:
            q = node["kernel_q"]
            vals = rng.integers(-8, 8, size=q.shape).astype(np.int8)
            out["kernel_q"] = jnp.asarray(vals).astype(jnp.int4)
            s = node["kernel_scale"]
            fan_in = q.shape[-2] if q.ndim >= 2 else 1
            out["kernel_scale"] = jnp.asarray(
                rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
                / (4.6 * np.sqrt(fan_in)))
        return out
    return walk(jparams)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "olmoe-1b-7b"])
def int4_pair(request):
    """(JAX cfg, model, params; port cfg, model, params) with int4 weights,
    the payloads and scales random, the port's converted."""
    jcfg, _, jp, pcfg, _, _ = model_pair(request.param)
    jcfg, pcfg = (dataclasses.replace(c, weight_quant="int4")
                  for c in (jcfg, pcfg))
    jm = jbuild(jcfg)
    jq = _random_int4(jm.init(jax.random.PRNGKey(0)), seed=3)
    pq = params_from_numpy(jax.tree.map(np.asarray, jq), pcfg, device="cpu")
    return jcfg, jm, jq, pcfg, build_model(pcfg, device="cpu"), pq


@pytest.mark.parametrize("shape,axis", [((6, 4, 8), 0), ((4, 8, 6), 2),
                                        ((3, 2, 10), 2), ((16,), 0)])
def test_pack_unpack_round_trips_bit_exactly(shape, axis):
    rng = np.random.default_rng(7)
    vals = rng.integers(-8, 8, size=shape).astype(np.int8)
    vals.reshape(-1)[:16] = np.arange(-8, 8)          # every nibble value
    packed = PL.pack_int4(torch.from_numpy(vals), axis)
    assert packed.dtype == torch.uint8
    want_shape = list(shape)
    want_shape[axis] //= 2
    assert tuple(packed.shape) == tuple(want_shape)
    back = PL.unpack_int4(packed, axis)
    assert back.dtype == torch.int8
    assert back.numpy().tobytes() == vals.tobytes()
    # packing the unpacked bytes gives the same bytes
    assert torch.equal(PL.pack_int4(back, axis), packed)


def test_pack_keeps_shards_whole():
    """Byte ``i`` holds values ``2i`` and ``2i + 1``: any contiguous shard of
    the bytes unpacks to the matching shard of the values."""
    vals = torch.arange(-8, 8, dtype=torch.int8).repeat(4).reshape(8, 8)
    packed = PL.pack_int4(vals, 0)
    for lo in range(0, 4, 2):
        assert torch.equal(PL.unpack_int4(packed[lo:lo + 2], 0),
                           vals[2 * lo:2 * lo + 4])


def test_int4_specs_store_packed_uint8():
    from repro_torch.configs import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              weight_quant="int4")
    m = build_model(cfg, device="cpu")
    specs = m.specs()
    p = m.init(torch.Generator().manual_seed(0))
    for key, spec in _flat(specs).items():
        t = _flat(p)[key]
        assert tuple(t.shape) == PL.stored_shape(spec), key
        if spec.dtype == "int4":
            assert t.dtype == torch.uint8 and not t.any(), key
            axis = PL.int4_axis(spec.axes)
            assert spec.axes[axis] == "embed", key
            assert t.shape[axis] * 2 == spec.shape[axis], key
            assert t.numel() * 2 == np.prod(spec.shape), key
    wo = _flat(p)["/layers/attn/wo/kernel_q"]
    assert wo.shape[-1] * 2 == cfg.d_model                # packed on its output


def test_int4_params_convert_to_the_jax_values(int4_pair):
    jcfg, jm, jq, pcfg, pm, pq = int4_pair
    want = _flat(jax.tree.map(np.asarray, jq))
    specs = _flat(pm.specs())
    got = _flat(pq)
    assert sorted(got) == sorted(want)
    n = 0
    for key, w in want.items():
        if key.endswith("kernel_q"):
            axis = PL.int4_axis(specs[key].axes)
            vals = PL.unpack_int4(got[key], axis).numpy()
            assert vals.tobytes() == w.astype(np.int8).tobytes(), key
            n += 1
    assert n >= 5


def test_get_kernel_unpacks_on_use():
    rng = np.random.default_rng(2)
    for shape, axis in (((6, 3, 4), 0), ((3, 4, 6), 2)):
        q = rng.integers(-8, 8, size=shape).astype(np.int8)
        s = rng.random(shape[1:]).astype(np.float32)
        want = JL.get_kernel({"kernel_q": jnp.asarray(q).astype(jnp.int4),
                              "kernel_scale": jnp.asarray(s)}, jnp.float32)
        got = PL.get_kernel({"kernel_q": PL.pack_int4(torch.from_numpy(q),
                                                      axis),
                             "kernel_scale": torch.from_numpy(s)},
                            torch.float32)
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_int4_prefill_and_greedy_decode_match(int4_pair):
    """Prefill logits, then 3 greedy decode steps (each package feeds back
    its own argmax; they agree), within 2e-4."""
    jcfg, jm, jq, pcfg, pm, pq = int4_pair
    b, s, max_seq = 2, 8, 24
    toks = np.random.default_rng(1).integers(
        0, pcfg.vocab_size, size=(b, s)).astype(np.int32)
    jc, pc = jm.init_cache(b, max_seq), pm.init_cache(b, max_seq)
    want, jc, _ = jm.prefill(jq, {"tokens": jnp.asarray(toks)}, jc)
    got, pc, _ = pm.prefill(pq, {"tokens": torch.from_numpy(toks)}, pc)
    assert _rel(got, want) <= TOL
    for step in range(3):
        jt = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
        pt = got[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(np.asarray(jt), pt.numpy()), step
        want, jc, _ = jm.decode_step(jq, jt, jc)
        got, pc, _ = pm.decode_step(pq, pt, pc)
        assert _rel(got, want) <= TOL, step
