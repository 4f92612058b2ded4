"""Rewrite an older container as current ggjt, llama_model_update
(llama.cpp:2211-2244) and the families' update tools: the tensor bytes pass
through unchanged (no requantization), the vocabulary and hyperparameters
are kept, the output is mmap-aligned ggjt (v3 for llama, v1 for the other
families, as ``GGJTWriter`` writes them).  The JAX package's
``formats/update.py``."""

from __future__ import annotations

from .ggjt import GGJTWriter, detect_arch, read_ggjt


def update_model(fname_inp: str, fname_out: str, arch: str | None = None,
                 progress=None) -> dict:
    """progress(name, i, n) after each tensor, if given.  Returns the arch,
    the tensor count, the ftype and the input's file version."""
    arch = arch or detect_arch(fname_inp)
    gf = read_ggjt(fname_inp, arch)
    n = 0
    with GGJTWriter(fname_out, arch, gf.hparams, gf.ftype, gf.vocab, qk_k=gf.qk_k) as w:
        for name, t in gf.tensors.items():
            w.write_tensor(name, t.qtype, t.ne, gf.tensor_bytes(name))
            n += 1
            if progress:
                progress(name, n, len(gf.tensors))
    return {"arch": arch, "tensors": n, "ftype": gf.ftype, "from_version": gf.file_version}
