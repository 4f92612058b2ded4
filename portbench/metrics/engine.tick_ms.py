"""engine.tick_ms: the window's milliseconds over the engine's ticks in it
(the change in ``stats()["n_ticks"]``); an RWKV tick is its chunk of
speculative rounds."""


def read(r):
    if not r.counters or r.counters["n_ticks"] <= 0:
        return None
    return r.window_s * 1e3 / r.counters["n_ticks"]
