"""Training checkpoint save/resume (model and optimizer state).

The reference trainer serializes the model weights and the whole ggml_opt
state (Adam moments, L-BFGS history) into its checkpoint so that training
resumes deterministically (save_checkpoint / load_checkpoint,
train-text-from-scratch.cpp).  The file is the JAX package's: a zip of
``meta.json`` (the ModelConfig, the step, ``has_opt`` and the caller's extra)
and ``arrays.npz``, every leaf under its JAX tree path (``params.blocks[0].wq``,
``opt[1][0].mu.output``; None leaves absent), so that a checkpoint written by
either package resumes in the other.  The arrays are written and read one
at a time, so that the host never holds more than one leaf of the state at
once."""

from __future__ import annotations

import dataclasses
import json
import zipfile

import numpy as np
import torch

from ..models.config import ModelConfig
from .tree import flatten_with_path, map_with_path


def save_checkpoint(path: str, cfg: ModelConfig, params, opt_state=None, step: int = 0,
                    extra: dict | None = None, *, mesh=None) -> None:
    """mesh: params and opt_state are this rank's slices
    (training/train.py's step over a mesh); every rank of the mesh calls
    it, each leaf is gathered whole (parallel/shard.py ``gather_params``,
    one leaf at a time) and the primary rank writes the file JAX writes from
    sharded arrays; the ranks leave together (``sync_hosts``)."""
    items = flatten_with_path(params, "params")
    if opt_state is not None:
        items += flatten_with_path(opt_state, "opt")
    meta = {"config": dataclasses.asdict(cfg), "step": step,
            "has_opt": opt_state is not None, "extra": extra or {}}
    if mesh is None:
        _write(path, meta, items)
        return
    from ..parallel.distributed import is_primary, sync_hosts
    from ..parallel.shard import gather_leaf, leaf_spec

    whole = ((key, gather_leaf(leaf, leaf_spec(key, leaf), mesh)) for key, leaf in items)
    if is_primary():
        _write(path, meta, whole)
    else:
        for _ in whole:
            pass
    sync_hosts("checkpoint", mesh=mesh)


def _write(path: str, meta: dict, items) -> None:
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        # np.savez's layout (one stored .npy entry per key), streamed
        with z.open("arrays.npz", "w", force_zip64=True) as f, \
                zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as npz:
            for key, leaf in items:
                with npz.open(key + ".npy", "w", force_zip64=True) as out:
                    np.lib.format.write_array(out, leaf.detach().cpu().numpy(),
                                              allow_pickle=False)


def _data_start(f, header_offset: int) -> int:
    """Where a zip member's data begins: after its local header, whose name
    and extra field may differ in length from the central directory's."""
    f.seek(header_offset + 26)
    head = f.read(4)
    return header_offset + 30 + int.from_bytes(head[:2], "little") + int.from_bytes(
        head[2:], "little")


class _Window:
    """A read-only file view of [base, base + size) of f (the stored npz
    inside the checkpoint zip), for zipfile to read its directory."""

    def __init__(self, f, base: int, size: int):
        self.f, self.base, self.size, self.pos = f, base, size, 0

    def seek(self, pos: int, whence: int = 0) -> int:
        self.pos = {0: pos, 1: self.pos + pos, 2: self.size + pos}[whence]
        return self.pos

    def tell(self) -> int:
        return self.pos

    def read(self, n: int = -1) -> bytes:
        n = self.size - self.pos if n is None or n < 0 else min(n, self.size - self.pos)
        self.f.seek(self.base + self.pos)
        self.pos += n
        return self.f.read(n)


_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _index(path: str, f, z: zipfile.ZipFile) -> dict:
    """{key: (dtype, shape, data offset)} of the arrays in ``arrays.npz``.
    Both packages store it and its C-ordered .npy members uncompressed
    (np.savez), so each array is read straight from its place in the file:
    np.load through zipfile would seek inside the entry by reading it
    again from its start, which cost ~10x the time on a 7.45 GiB file."""
    outer = z.getinfo("arrays.npz")
    if outer.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: arrays.npz is compressed; checkpoints store it")
    base = _data_start(f, outer.header_offset)
    with zipfile.ZipFile(_Window(f, base, outer.file_size)) as inner:
        infos = inner.infolist()
    out = {}
    for info in infos:
        f.seek(_data_start(f, base + info.header_offset))
        version = np.lib.format.read_magic(f)
        if info.compress_type == zipfile.ZIP_STORED and version in _NPY_HEADERS:
            shape, fortran, dtype = _NPY_HEADERS[version](f)
            if not fortran:
                out[info.filename.removesuffix(".npy")] = (dtype, shape, f.tell())
                continue
        raise ValueError(f"{path}: {info.filename} is not a stored C-ordered .npy")
    return out


def load_checkpoint(path: str, params_like, opt_state_like=None):
    """Returns (cfg, params, opt_state, step).  The *_like trees give the
    structure (init_transformer / tx.init); each leaf comes back on its
    like's device, in the file's dtype.  A compressed ``arrays.npz`` is
    refused."""
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        meta = json.loads(z.read("meta.json"))
        index = _index(path, f, z)

        def take(prefix):
            def leaf(key, like):
                dtype, shape, offset = index[prefix + key]
                arr = np.empty(shape, dtype)
                f.seek(offset)
                f.readinto(memoryview(arr.reshape(-1)).cast("B"))
                return torch.from_numpy(arr).to(like.device)
            return leaf

        cfg = ModelConfig(**meta["config"])
        params = map_with_path(take("params"), params_like)
        opt_state = None
        if meta["has_opt"] and opt_state_like is not None:
            opt_state = map_with_path(take("opt"), opt_state_like)
    return cfg, params, opt_state, meta["step"]
