"""The plain references: one module a family (``<family>.logits_at``), plain
PyTorch that imports nothing of the program, and the control's lower
precision."""

from __future__ import annotations

import importlib

import torch

FP8_MAX = 448.0  # the largest float8_e4m3fn value


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (its largest magnitude
    at the format's largest value): the control, one step below the bf16
    activations the configuration states."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
