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
