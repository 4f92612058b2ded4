"""The traffic generator: one seed, one set of requests; every seed the
same sizes a block; lengths inside each mix's limits and its context."""

import os

import pytest

from portbench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "traffic")) if f.endswith(".json"))
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = traffic.load(name, HERE)
    a = traffic.requests(mix, SEED, 50277, 40)
    b = traffic.requests(mix, SEED, 50277, 40)
    assert [(r.prompt, r.n_predict, r.sampling, r.seed) for r in a] == \
           [(r.prompt, r.n_predict, r.sampling, r.seed) for r in b]
    c = traffic.requests(mix, SEED + 1, 50277, 40)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_inside_the_limits(name):
    mix = traffic.load(name, HERE)
    reqs = traffic.requests(mix, SEED, 50432, 200)
    p, o = mix["prompt"], mix["output"]
    for r in reqs:
        assert p["min"] <= len(r.prompt) <= p["max"]
        assert o["min"] <= r.n_predict <= o["max"]
        assert len(r.prompt) + r.n_predict < mix["n_ctx"]
        assert all(0 <= t < 50432 for t in r.prompt)
    assert traffic.bounds(mix)[1] < mix["n_ctx"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_the_same_schedule(name):
    """Every seed sends the same sizes in the same order, each block the same
    stratified set of them."""
    mix = traffic.load(name, HERE)
    block = mix.get("block", mix["clients"])
    runs = [traffic.requests(mix, seed, 1000, 3 * block) for seed in (1, 2, 2 ** 33 + 5)]
    sched = [[(len(r.prompt), r.n_predict, r.greedy) for r in reqs] for reqs in runs]
    assert sched[0] == sched[1] == sched[2]
    blocks = [sched[0][j * block:(j + 1) * block] for j in range(3)]
    assert len({tuple(sorted(p for p, _, _ in b)) for b in blocks}) == 1
    assert len({tuple(sorted(o for _, o, _ in b)) for b in blocks}) == 1
    assert len({sum(g for _, _, g in b) for b in blocks}) == 1
    assert blocks[0] != blocks[1]  # each block in an order of its own


def test_greedy_requests_take_the_argmax():
    mix = traffic.load("chat32", HERE)
    reqs = traffic.requests(mix, SEED, 1000, 64)
    greedy = [r for r in reqs if r.greedy]
    assert len(greedy) == 16
    for r in greedy:
        assert r.sampling["temp"] == 0.0 and r.sampling["repeat_penalty"] == 1.0
    for r in reqs:
        if not r.greedy:
            assert r.sampling == mix["sampling"]
    assert len({r.seed for r in reqs}) == len(reqs)


def test_lognormal_quantiles_keep_the_median():
    q = traffic.quantiles({"dist": "lognormal", "median": 384, "sigma": 0.7, "min": 32,
                           "max": 1536}, 33)
    assert q == sorted(q) and q[16] == pytest.approx(384, rel=0.03)
    assert traffic.quantiles({"dist": "uniform", "min": 64, "max": 256}, 4) == [88, 136, 184, 232]
