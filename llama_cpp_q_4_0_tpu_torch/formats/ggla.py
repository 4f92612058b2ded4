"""ggla v1 LoRA adapter files (convert-lora-to-ggml.py:49-74, read by
llama.cpp:2726-2873), byte for byte the JAX package's ``formats/ggla.py``.

Layout: uint32 magic 0x67676C61 'ggla', uint32 version 1, int32 r, int32
alpha, then tensor records {int32 n_dims, int32 name_len, int32 ftype (0 f32,
1 f16), int32 dims[n_dims] (ne order, fastest first), name, padding to 32
bytes, raw data}.

Stored layouts (convert-lora-to-ggml.py:119-124): ``<base>.loraA`` is PEFT's
lora_A transposed, numpy [K, r]; ``<base>.loraB`` is lora_B, [N, r]; the
weight delta is (alpha/r) * B @ A_stored^T, [N, K].
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

GGLA_MAGIC = 0x67676C61
GGLA_VERSION = 1


@dataclass
class GglaFile:
    r: int
    alpha: int
    tensors: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.r)

    def pairs(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """{base_name: (A_stored [K, r], B [N, r])} of the complete A/B
        pairs (llama.cpp:2875-2877)."""
        out = {}
        for name in self.tensors:
            if name.endswith(".loraA"):
                base = name[: -len(".loraA")]
                if base + ".loraB" in self.tensors:
                    out[base] = (self.tensors[name], self.tensors[base + ".loraB"])
        return out

    def delta(self, base_name: str) -> np.ndarray:
        """The scaled weight delta (alpha/r) * BA [N, K] (llama.cpp:2935-2951)."""
        a, b = self.pairs()[base_name]
        return self.scaling * (b.astype(np.float32) @ a.astype(np.float32).T)


def read_ggla(path: str) -> GglaFile:
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGLA_MAGIC:
            raise ValueError(f"{path}: bad ggla magic {magic:#x}")
        if version != GGLA_VERSION:
            raise ValueError(f"{path}: unsupported ggla version {version}")
        r, alpha = struct.unpack("<ii", f.read(8))
        gf = GglaFile(r=r, alpha=alpha)
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ftype = struct.unpack("<iii", head)
            ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
            name = f.read(name_len).decode("utf-8")
            f.seek((f.tell() + 31) & -32)
            shape = tuple(reversed(ne))  # ne -> numpy shape
            dtype = np.float32 if ftype == 0 else np.float16
            data = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
            gf.tensors[name] = data.reshape(shape).astype(np.float32)
    return gf


def write_ggla(path: str, r: int, alpha: int, tensors: dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<IIii", GGLA_MAGIC, GGLA_VERSION, r, alpha))
        for name, arr in tensors.items():
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            sname = name.encode("utf-8")
            f.write(struct.pack("<iii", arr.ndim, len(sname), 0))
            f.write(struct.pack(f"<{arr.ndim}i", *reversed(arr.shape)))
            f.write(sname)
            f.seek((f.tell() + 31) & -32)
            arr.tofile(f)
