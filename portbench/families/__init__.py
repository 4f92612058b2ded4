"""One module a model family, found by the configuration's ``family``."""

from __future__ import annotations

import importlib


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")
