"""The one generator of every traffic mix: a mix is a data file
(``traffic/<mix>.json``) of parameters, and this turns it and a seed into
the run's requests and their arrivals.  A mix that needs more than the
parameters say is a module (``traffic/<mix>.py``) whose ``MIX`` holds its
parameters and which may bring its own ``requests(mix, seed, n_vocab,
count)``, ``bounds(mix)`` and client loop (``Server``: the surface of
``harness.EngineServer``); what it leaves out is this module's.

Every seed gets the same schedule of sizes.  The requests come in blocks
of ``block`` (default: the number of clients); each block holds the same
stratified set of prompt and output lengths (the distribution's quantiles
at (i + 1/2) / block, of a truncated log-normal or a uniform range) in an
order of its own, and the same number of greedy requests; that schedule is
the mix's (drawn from its ``order`` number, 0 by default), not the seed's,
since the order of the sizes moves what a window holds (which requests
queue together, which finish inside it) by more than anything else.  The
seed draws the token ids (uniform over the vocabulary, no prefix shared)
and every request's own sampling seed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import statistics
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
# a greedy request: the argmax of the program's logits, nothing penalised,
# so that its tokens can be held against the reference's logits
GREEDY = {"temp": 0.0, "repeat_penalty": 1.0, "frequency_penalty": 0.0,
          "presence_penalty": 0.0}


@dataclass
class Req:
    index: int
    prompt: list
    n_predict: int
    sampling: dict
    seed: int
    greedy: bool
    sent: float = -1.0  # host clock: when the client sent it
    times: list = field(default_factory=list)  # host clock of each token received
    tokens: list = field(default_factory=list)
    done: float = -1.0
    client: int = -1


def load(name: str, root: str = HERE) -> dict:
    """The mix by name: ``traffic/<name>.json``, or the ``MIX`` of
    ``traffic/<name>.py`` with the module under the key ``module``."""
    base = os.path.join(root, "traffic", name)
    if os.path.exists(base + ".json"):
        with open(base + ".json") as f:
            return json.load(f)
    spec = importlib.util.spec_from_file_location(f"portbench_mix_{name}", base + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.MIX, module=mod)


def own(mix: dict, name: str):
    """What a .py mix brings of its own under that name, or None."""
    return getattr(mix.get("module"), name, None)


def quantiles(dist: dict, n: int) -> list[int]:
    """The n stratified lengths of a length distribution: {"dist":
    "lognormal", "median", "sigma", "min", "max"} (truncated to [min, max]
    by its quantiles) or {"dist": "uniform", "min", "max"}."""
    lo, hi = dist["min"], dist["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "uniform":
            v = lo + u * (hi - lo)
        elif dist["dist"] == "lognormal":
            nd = statistics.NormalDist(math.log(dist["median"]), dist["sigma"])
            a, b = nd.cdf(math.log(lo)), nd.cdf(math.log(hi))
            v = math.exp(nd.inv_cdf(a + u * (b - a)))
        else:
            raise ValueError(f"unknown length distribution {dist['dist']}")
        out.append(min(hi, max(lo, int(round(v)))))
    return out


def requests(mix: dict, seed: int, n_vocab: int, count: int) -> list[Req]:
    """The first count requests of the mix under seed."""
    fn = own(mix, "requests") or stratified
    return fn(mix, seed, n_vocab, count)


def shared_prefix(mix: dict, seed: int, n_vocab: int) -> list:
    """The prefix that starts every prompt of the mix under seed (empty
    without ``shared_prefix``)."""
    rng = random.Random(f"{seed}/prefix")
    return [rng.randrange(n_vocab) for _ in range(mix.get("shared_prefix", 0))]


def stratified(mix: dict, seed: int, n_vocab: int, count: int) -> list[Req]:
    """The first count requests of the mix's stratified schedule under seed."""
    block = mix.get("block", mix["clients"])
    schedule = random.Random(f"order {mix.get('order', 0)}")
    content = random.Random(f"{seed}")
    prefix = shared_prefix(mix, seed, n_vocab)
    prompts = quantiles(mix["prompt"], block)
    outputs = quantiles(mix["output"], block)
    n_greedy = max(1, round(block * mix["greedy_share"]))
    out = []
    while len(out) < count:
        p, o = prompts[:], outputs[:]
        schedule.shuffle(p)
        schedule.shuffle(o)
        greedy = set(schedule.sample(range(block), n_greedy))
        for j in range(block):
            if len(out) == count:
                break
            g = j in greedy
            sampling = dict(mix["sampling"], **(GREEDY if g else {}))
            prompt = prefix + [content.randrange(n_vocab) for _ in range(p[j])]
            out.append(Req(len(out), prompt, o[j], sampling, content.randrange(1 << 31), g))
    return out


def arrival_times(mix: dict, count: int) -> list | None:
    """Seconds from the window's open at which the first count requests are
    sent, the same for every seed; None for a closed loop."""
    arr = mix.get("arrivals")
    if not arr:
        return None
    rng = random.Random(f"arrivals {mix.get('order', 0)}")
    out, t = [], 0.0
    while len(out) < count:
        if arr["process"] == "poisson":
            out.append(t)
            t += rng.expovariate(arr["rate_per_s"])
        elif arr["process"] == "bursts":
            out.extend([t] * rng.randint(*arr["size"]))
            t += rng.uniform(*arr["every_s"])
        else:
            raise ValueError(f"unknown arrival process {arr['process']}")
    return out[:count]


def bounds(mix: dict) -> tuple[int, int]:
    """(longest prompt, longest prompt plus output) the mix can send."""
    fn = own(mix, "bounds")
    if fn:
        return fn(mix)
    longest = mix.get("shared_prefix", 0) + mix["prompt"]["max"]
    return longest, longest + mix["output"]["max"]
