"""Where chip_smoke.py's time goes: its run (every phase, or --phases ...)
with each module-level function of the script wrapped in an inclusive timer,
then one ``PROFILE <seconds> <calls> <function>`` line a function, the
costliest first.  Inclusive times nest (a phase holds its helpers).

Run from the root of a checkout on the card's machine, as chip_smoke.py:
    python3 scripts/smoke_profile.py [--phases ...]
The parallel phase's ranks run chip_smoke.py itself, unwrapped."""

import functools
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

totals: dict[str, float] = {}
calls: dict[str, int] = {}


def _timed(name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = calls.get(name, 0) + 1
    return run


def main() -> int:
    for name, obj in list(vars(chip_smoke).items()):
        if (isinstance(obj, types.FunctionType) and obj.__module__ == chip_smoke.__name__
                and name not in ("main", "fail")):
            setattr(chip_smoke, name, _timed(name, obj))
    try:
        return chip_smoke.main(sys.argv[1:])
    finally:
        for name, t in sorted(totals.items(), key=lambda kv: -kv[1])[:90]:
            print(f"PROFILE {t:9.2f} {calls[name]:5d} {name}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
