"""engine.tokens_per_tick: the tokens the engine emitted in the window over
its ticks there (the changes in ``stats()``'s ``n_tokens_out`` and
``n_ticks``): occupancy times the tokens a row gains a tick."""


def read(r):
    if not r.counters or r.counters["n_ticks"] <= 0:
        return None
    return r.counters["n_tokens_out"] / r.counters["n_ticks"]
