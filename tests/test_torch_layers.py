"""Elementary layers of the port against the JAX package's, on the same numpy
inputs (f32, CPU).  Tolerance 2e-5: the same f32 arithmetic in another
library, sums in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_np
from repro.models import layers as JL
from repro_torch.models import layers as PL

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(11)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(plus_one):
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = RNG.standard_normal(64).astype(np.float32)
    jx, px = _both(x)
    js, ps = _both(scale)
    want = JL.rmsnorm({"scale": js}, jx, 1e-6, plus_one=plus_one)
    got = PL.rmsnorm({"scale": ps}, px, 1e-6, plus_one=plus_one)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_rmsnorm_bf16_casts_back_at_the_end():
    x = torch.from_numpy(RNG.standard_normal((2, 64)).astype(np.float32))
    out = PL.rmsnorm({"scale": torch.ones(64, dtype=torch.bfloat16)},
                     x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = JL.rmsnorm({"scale": jnp.ones(64, jnp.bfloat16)},
                      jnp.asarray(x.numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(to_np(out), to_np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_split_halves(theta):
    x = RNG.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = RNG.integers(0, 500, size=(2, 7)).astype(np.int32)
    jx, px = _both(x)
    jp, pp = _both(pos)
    want = JL.apply_rope(jx, jp, theta)
    got = PL.apply_rope(px, pp, theta)
    # angles up to ~500 rad: f32 sin/cos of the two libraries differ by ulps
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=5e-5)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
def test_mlp(act, glu):
    d, f = 32, 48
    params = {"wi": {"kernel": RNG.standard_normal((d, f)).astype(np.float32) / 6},
              "wo": {"kernel": RNG.standard_normal((f, d)).astype(np.float32) / 7}}
    if glu:
        params["wg"] = {"kernel": RNG.standard_normal((d, f)).astype(np.float32) / 6}
    x = RNG.standard_normal((2, 5, d)).astype(np.float32)
    want = JL.mlp(_tree(jnp.asarray, params), jnp.asarray(x), act, jnp.float32)
    got = PL.mlp(_tree(torch.from_numpy, params), torch.from_numpy(x), act,
                 torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    want = 0.5 * x * (1 + torch.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
    np.testing.assert_allclose(to_np(PL.ACTS["gelu"](x)), to_np(want),
                               rtol=1e-6, atol=1e-6)


def test_dense_bias_embed_unembed_softcap():
    w = RNG.standard_normal((16, 24)).astype(np.float32)
    b = RNG.standard_normal(24).astype(np.float32)
    x = RNG.standard_normal((3, 16)).astype(np.float32)
    want = JL.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x))
    got = PL.dense({"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                   torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)

    emb = RNG.standard_normal((50, 16)).astype(np.float32)
    toks = RNG.integers(0, 50, size=(2, 6)).astype(np.int32)
    want = JL.embed_lookup({"embedding": jnp.asarray(emb)}, jnp.asarray(toks),
                           jnp.float32)
    got = PL.embed_lookup({"embedding": torch.from_numpy(emb)},
                          torch.from_numpy(toks), torch.float32)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    want = JL.unembed({"embedding": jnp.asarray(emb)}, jnp.asarray(x),
                      jnp.float32)
    got = PL.unembed({"embedding": torch.from_numpy(emb)}, torch.from_numpy(x),
                     torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)

    s = RNG.standard_normal((4, 9)).astype(np.float32) * 30
    for cap in (0.0, 20.0):
        np.testing.assert_allclose(
            to_np(PL.softcap(torch.from_numpy(s), cap)),
            to_np(JL.softcap(jnp.asarray(s), cap)), **TOL)


def test_init_tree_is_seeded_and_shaped():
    specs = {"a": PL.dense_specs(8, 4, ("embed", "mlp"), bias=True),
             "n": PL.rmsnorm_specs(8)}
    stacked = PL.stack_specs(specs, 3)
    p1 = PL.init_tree(torch.Generator().manual_seed(5), stacked,
                      torch.float32, "cpu")
    p2 = PL.init_tree(torch.Generator().manual_seed(5), stacked,
                      torch.float32, "cpu")
    assert p1["a"]["kernel"].shape == (3, 8, 4)
    assert torch.equal(p1["a"]["kernel"], p2["a"]["kernel"])
    assert torch.equal(p1["a"]["bias"], torch.zeros(3, 4))
    assert torch.equal(p1["n"]["scale"], torch.ones(3, 8))
    assert PL.param_count(p1) == 3 * (8 * 4 + 4 + 8)
    assert PL.tree_index(p1, 1)["a"]["kernel"].shape == (8, 4)
