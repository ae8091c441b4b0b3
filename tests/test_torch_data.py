"""The port's synthetic corpus (a copy of `src/repro/data/synthetic.py`)
gives byte-equal batches to the JAX package's."""
import numpy as np
import pytest

from repro.data import synthetic as JD
from repro_torch.data import synthetic as PD


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 32, 4, 3),
                                                  (151936, 64, 2, 0)])
def test_batches_are_byte_equal(vocab, seq, batch, seed):
    jc = JD.SyntheticCorpus(vocab, seq, batch, seed=seed)
    pc = PD.SyntheticCorpus(vocab, seq, batch, seed=seed)
    for step in (0, 5, 30, 101):
        jb, pb = jc.batch_at(step), pc.batch_at(step)
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype
            assert jb[k].tobytes() == pb[k].tobytes(), (step, k)
        assert jc.token_stats(step) == pc.token_stats(step)


def test_schedule_and_domains_are_the_reference_ones():
    assert PD.DEFAULT_DOMAINS == tuple(
        PD.Domain(*[getattr(d, f) for f in ("name", "vocab_lo", "vocab_hi",
                                            "zipf_a", "mean_len")])
        for d in JD.DEFAULT_DOMAINS)
    js, ps = JD.default_schedule(), PD.default_schedule()
    assert js.spans == ps.spans and js.cycle == ps.cycle
    for step in range(0, 200, 7):
        assert js.mix_at(step) == ps.mix_at(step)


def test_labels_are_shifted_tokens():
    b = PD.SyntheticCorpus(1000, 32, 2, seed=0).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# packing and the prefetch loader (copies of src/repro/data/{packing,loader})
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,seed", [(64, 0), (16, 1), (200, 2)])
def test_pack_documents_is_byte_equal(seq_len, seed):
    """Documents longer and shorter than a row (longer ones are cut)."""
    from repro.data import packing as JP
    from repro_torch.data import packing as PP
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, size=rng.integers(1, 90)) for _ in range(30)]
    jp, pp = JP.pack_documents(docs, seq_len), PP.pack_documents(docs, seq_len)
    assert sorted(jp) == sorted(pp)
    for k in jp:
        assert jp[k].dtype == pp[k].dtype and jp[k].shape == pp[k].shape, k
        assert jp[k].tobytes() == pp[k].tobytes(), k
    assert JP.packing_efficiency(jp) == PP.packing_efficiency(pp)
    total = sum(min(len(d), seq_len) for d in docs)
    assert int((pp["segment_ids"] > 0).sum()) == total


def test_prefetch_loader_in_order_and_reset():
    """tests/test_data.py's case on the port's loader, with a `put_fn` that
    makes tensors, as a caller moving batches to the card does."""
    import torch
    from repro_torch.data import PrefetchLoader
    c = PD.SyntheticCorpus(1000, 16, 2, seed=0)
    ld = PrefetchLoader(c.batch_at, depth=2)
    try:
        b0, b1 = ld.get(0), ld.get(1)
        np.testing.assert_array_equal(b0["tokens"], c.batch_at(0)["tokens"])
        np.testing.assert_array_equal(b1["tokens"], c.batch_at(1)["tokens"])
        ld.reset(10)
        np.testing.assert_array_equal(ld.get(10)["tokens"],
                                      c.batch_at(10)["tokens"])
        with pytest.raises(RuntimeError, match="out of sync"):
            ld.get(99)
    finally:
        ld.stop()
    assert not ld._thread.is_alive()

    def put(b):
        return {k: torch.from_numpy(v) for k, v in b.items() if k != "domains"}
    ld = PrefetchLoader(c.batch_at, start_step=3, depth=1, put_fn=put)
    try:
        got = ld.get(3)
        assert isinstance(got["tokens"], torch.Tensor)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      c.batch_at(3)["tokens"])
    finally:
        ld.stop()


def test_loader_surfaces_errors_and_host_slice_is_the_reference():
    from repro.data import loader as JL
    from repro_torch.data import PrefetchLoader, host_slice

    def bad(step):
        raise ValueError(f"no batch {step}")
    ld = PrefetchLoader(bad, depth=1)
    try:
        with pytest.raises(ValueError, match="no batch 0"):
            ld.get()
    finally:
        ld.stop()
    for gb, n, i in [(8, 2, 1), (12, 3, 0), (7, 2, 1)]:
        assert host_slice(gb, n, i) == JL.host_slice(gb, n, i)


def test_corpus_frames_and_patches_are_byte_equal():
    """The stub inputs of the enc-dec and VLM families, as `Trainer`'s
    default corpus asks for them."""
    kw = dict(seed=1, n_frames=6, d_model=8, n_patches=3)
    jb = JD.SyntheticCorpus(500, 16, 2, **kw).batch_at(4)
    pb = PD.SyntheticCorpus(500, 16, 2, **kw).batch_at(4)
    for k in ("frames", "patches"):
        assert jb[k].tobytes() == pb[k].tobytes(), k
