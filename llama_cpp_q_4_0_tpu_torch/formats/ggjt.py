"""GGJT model-file IO — the reference's on-disk contract.

Reads and writes the ggjt v3 container (and the older ggml/ggmf variants).
Header schemas per architecture:

  llama   n_vocab n_embd n_mult n_head n_layer n_rot ftype
  gptneox n_vocab n_ctx n_embd n_head n_layer n_rot use_parallel_residual ftype
  falcon  n_vocab n_embd n_head n_layer parallel_attn ftype
  rwkv    n_vocab n_ctx n_embd n_layer rescale_every ftype
  bonsai  n_vocab n_embd n_head n_layer parallel_attn ftype

Vocab: n_vocab x {u32 len, bytes, f32 score}.  Tensors: {u32 n_dims, u32
name_len, u32 type, u32 ne[n_dims], name, pad-to-32, data}; ne[0] is the
fastest-varying (K) dim, so a 2-D tensor's numpy shape is (ne[1], ne[0]).
Tensor data is exposed as zero-copy np.memmap views.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..quant.types import K_QUANTS, GGMLType, row_size_bytes, type_traits

MAGIC_GGML = 0x67676D6C  # 'ggml' — legacy, unversioned, no vocab scores
MAGIC_GGMF = 0x67676D66  # 'ggmf' v1
MAGIC_GGJT = 0x67676A74  # 'ggjt' v1/2/3 (mmap-aligned)

FILE_VERSION_GGML = 0
FILE_VERSION_GGMF_V1 = 1
FILE_VERSION_GGJT_V1 = 2

HEADER_FIELDS: dict[str, list[str]] = {
    "llama": ["n_vocab", "n_embd", "n_mult", "n_head", "n_layer", "n_rot"],
    "gptneox": ["n_vocab", "n_ctx", "n_embd", "n_head", "n_layer", "n_rot",
                "use_parallel_residual"],
    "falcon": ["n_vocab", "n_embd", "n_head", "n_layer", "parallel_attn"],
    "rwkv": ["n_vocab", "n_ctx", "n_embd", "n_layer", "rescale_every"],
    "bonsai": ["n_vocab", "n_embd", "n_head", "n_layer", "parallel_attn"],
}


@dataclass
class TensorEntry:
    name: str
    qtype: GGMLType
    ne: tuple[int, ...]  # ggml order: ne[0] = fastest (K)
    file_off: int
    size: int

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy (row-major) shape."""
        return tuple(reversed(self.ne))


@dataclass
class GGJTFile:
    path: str
    file_version: int
    arch: str
    hparams: dict[str, int]
    ftype: int
    vocab: list[tuple[bytes, float]]
    tensors: dict[str, TensorEntry]
    _mmap: np.memmap = field(repr=False, default=None)

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's raw block data."""
        t = self.tensors[name]
        return self._mmap[t.file_off: t.file_off + t.size]

    def tensor_blocks(self, name: str) -> np.ndarray:
        """Structured block-dtype view of a quantized tensor (zero-copy)."""
        t = self.tensors[name]
        dt = type_traits(t.qtype).block_dtype
        if dt is None:
            raise NotImplementedError(f"{name}: {t.qtype.name} blocks are not "
                                      "read by the port")
        return self.tensor_bytes(name).view(dt)

    def tensor_f32(self, name: str) -> np.ndarray:
        """A tensor as float32 in numpy shape, dequantized on the host."""
        from ..quant.registry import dequantize

        t = self.tensors[name]
        raw = self.tensor_bytes(name)
        if t.qtype == GGMLType.F32:
            return np.array(raw.view("<f4").reshape(t.shape), dtype=np.float32)
        if t.qtype == GGMLType.F16:
            return raw.view("<f2").reshape(t.shape).astype(np.float32)
        return dequantize(self.tensor_blocks(name), t.qtype).reshape(t.shape)


def _read_header(f, arch: str):
    fields = HEADER_FIELDS[arch]
    vals = struct.unpack(f"<{len(fields)}I", f.read(4 * len(fields)))
    (ftype,) = struct.unpack("<I", f.read(4))
    return dict(zip(fields, vals)), ftype


def read_ggjt(path: str | Path, arch: str = "llama") -> GGJTFile:
    """Parse a ggml/ggmf/ggjt file (k-quant tensors in their QK_K=256 form)."""
    path = str(path)
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic == MAGIC_GGML:
            file_version = FILE_VERSION_GGML
        else:
            (version,) = struct.unpack("<I", f.read(4))
            if magic == MAGIC_GGMF and version == 1:
                file_version = FILE_VERSION_GGMF_V1
            elif magic == MAGIC_GGJT and version in (1, 2, 3):
                file_version = FILE_VERSION_GGJT_V1 + version - 1
            else:
                raise ValueError(f"unknown (magic, version): {magic:08x}, "
                                 "is this a GGML file?")
        hparams, ftype = _read_header(f, arch)
        n_vocab = hparams["n_vocab"]
        if not (0 < n_vocab < 10_000_000):
            raise ValueError(f"implausible n_vocab={n_vocab}; wrong arch schema?")
        vocab = []
        has_scores = arch != "rwkv" and file_version >= FILE_VERSION_GGMF_V1
        for _ in range(n_vocab):
            (ln,) = struct.unpack("<I", f.read(4))
            word = f.read(ln)
            score = 0.0
            if has_scores:
                (score,) = struct.unpack("<f", f.read(4))
            vocab.append((word, score))

        file_size = Path(path).stat().st_size
        tensors: dict[str, TensorEntry] = {}
        try:
            _read_tensors(f, file_version, file_size, tensors)
        except (ValueError, struct.error, UnicodeDecodeError) as e:
            # the container carries no QK_K marker: 64-element k-quant
            # super-blocks have other byte sizes and derail the offsets
            if any(t.qtype in K_QUANTS for t in tensors.values()):
                raise NotImplementedError(
                    f"{path}: its k-quant tensors do not parse as QK_K=256 "
                    f"blocks ({e}); files written with 64-element super-blocks "
                    "(GGML_QKK_64) are not ported") from e
            raise

    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return GGJTFile(path, file_version, arch, hparams, ftype, vocab, tensors, mm)


def _read_tensors(f, file_version: int, file_size: int, tensors: dict):
    while f.tell() < file_size:
        hdr = f.read(12)
        if len(hdr) < 12:
            raise ValueError("truncated tensor header")
        n_dims, name_len, ttype = struct.unpack("<3I", hdr)
        if not (1 <= n_dims <= 4) or name_len > 4096:
            raise ValueError("implausible tensor header")
        ne = struct.unpack(f"<{n_dims}I", f.read(4 * n_dims))
        name = f.read(name_len).decode("utf-8")
        qtype = GGMLType(ttype)
        if file_version >= FILE_VERSION_GGJT_V1:
            f.seek(-f.tell() & 31, 1)  # align to 32
        size = row_size_bytes(qtype, int(np.prod(ne)))
        off = f.tell()
        tensors[name] = TensorEntry(name, qtype, tuple(ne), off, size)
        f.seek(size, 1)
    if f.tell() != file_size:
        raise ValueError("tensor data overruns file")


def detect_arch(path: str | Path) -> str:
    """Guess the architecture from header plausibility and tensor names
    (falcon and bonsai files are byte-compatible: this returns "falcon")."""
    markers = {
        "llama": ("tok_embeddings.weight", "layers.0.attention.wq.weight"),
        "gptneox": ("gpt_neox.embed_in.weight",),
        "falcon": ("transformer.word_embeddings.weight",),
        "rwkv": ("rwkv.embeddings.weight",),
        "bonsai": ("transformer.wte.weight", "model.embed_tokens.weight"),
    }
    for arch in HEADER_FIELDS:
        try:
            gf = read_ggjt(path, arch)
        except (ValueError, struct.error, UnicodeDecodeError, OSError):
            continue
        if any(m in gf.tensors for m in markers[arch]):
            return arch
    raise ValueError(f"cannot detect architecture of {path}")


class GGJTWriter:
    """Streaming ggjt writer (llama files are ggjt v3, the other families v1)."""

    def __init__(self, path: str | Path, arch: str, hparams: dict[str, int],
                 ftype: int, vocab: list[tuple[bytes, float]],
                 version: int | None = None):
        if version is None:
            version = 3 if arch == "llama" else 1
        self.f = open(path, "wb")
        self.arch = arch
        self.f.write(struct.pack("<II", MAGIC_GGJT, version))
        fields = HEADER_FIELDS[arch]
        self.f.write(struct.pack(f"<{len(fields)}I", *[hparams[k] for k in fields]))
        self.f.write(struct.pack("<I", ftype))
        for word, score in vocab:
            if isinstance(word, str):
                word = word.encode("utf-8")
            self.f.write(struct.pack("<I", len(word)))
            self.f.write(word)
            if arch != "rwkv":  # rwkv vocab has no scores
                self.f.write(struct.pack("<f", score))

    def write_tensor(self, name: str, qtype: GGMLType, ne: tuple[int, ...],
                     data):
        """``data``: any C-contiguous buffer (bytes, numpy array)."""
        size = memoryview(data).nbytes
        if size != row_size_bytes(qtype, int(np.prod(ne))):
            raise ValueError(f"{name}: {size} bytes for {qtype.name} {ne}")
        nb = name.encode("utf-8")
        self.f.write(struct.pack("<3I", len(ne), len(nb), int(qtype)))
        self.f.write(struct.pack(f"<{len(ne)}I", *ne))
        self.f.write(nb)
        self.f.write(b"\x00" * (-self.f.tell() & 31))
        self.f.write(data)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
