"""context.prefill_ms_per_ktok: the benchmark's own span around each
prompt's ``Context.eval`` (which ends in the copy of its logits to the
host), in milliseconds per 1,000 prompt tokens, over the window's prompts."""


def read(r):
    spans = [s for s in r.spans if s[0] == "prefill"]
    tokens = sum(s[3] for s in spans)
    if not tokens:
        return None
    return sum(s[2] - s[1] for s in spans) * 1e3 / tokens * 1000
