"""The traffic generator: the same seed gives the same inputs; another seed
the same work (lengths and gaps) in another order, with other prompts."""
import json
from collections import Counter

import numpy as np
import pytest

from portbench.harness import traffic
from portbench.harness.spec import BENCH_DIR

MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))
BIG = 2 ** 31 + 12345                   # seeds go past 32 signed bits


def mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule(name):
    t = mix(name)
    a = traffic.schedule(t, BIG, 1000, 300)
    b = traffic.schedule(t, BIG, 1000, 300)
    assert [(x.due_s, x.max_new_tokens) for x in a] == \
        [(x.due_s, x.max_new_tokens) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_schedule_other_prompts(name):
    """The schedule is the mix's (a replayed trace); the seed draws the
    prompts."""
    t = mix(name)
    n = t["pool"]
    a = traffic.schedule(t, BIG, 1000, n)
    b = traffic.schedule(t, BIG + 1, 1000, n)
    assert [(x.due_s, x.max_new_tokens) for x in a] == \
        [(x.due_s, x.max_new_tokens) for x in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    assert Counter(x.max_new_tokens for x in a) == Counter(
        traffic.output_lengths(t, n).tolist())
    pool = np.round(traffic.gaps(t, n), 9)
    g = np.round(np.diff([x.due_s for x in a]), 9)     # the pool less one gap
    assert len(g) == n - 1 and np.isin(g, pool).all()
    other = dict(t, schedule_seed=t["schedule_seed"] + 1)
    c = traffic.schedule(other, BIG, 1000, n)
    assert [x.max_new_tokens for x in c] != [x.max_new_tokens for x in a]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_and_rate_follow_the_mix(name):
    t = mix(name)
    n = t["pool"]
    s = traffic.schedule(t, 7, 1000, n)
    lens = np.array([x.max_new_tokens for x in s])
    o = t["output"]
    assert lens.min() >= o["lo"] and lens.max() <= o["hi"]
    if o["dist"] == "lognormal":
        assert abs(np.median(lens) - o["median"]) <= 1
    span = s[-1].due_s
    assert abs((n - 1) / span - t["rate_per_s"]) / t["rate_per_s"] < 0.1
    assert all(len(x.prompt) == t["prompt_len"] for x in s)
    assert all(0 <= x.prompt.min() and x.prompt.max() < 1000 for x in s)


def test_enough_arrivals_for_the_window():
    t = mix("chat")
    n = traffic.arrivals_needed(t, 45)
    s = traffic.schedule(t, 3, 1000, n)
    assert s[-1].due_s > t["preroll_s"] + 45
