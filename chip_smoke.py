#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit; build every CUDA kernel from csrc/
     (qmm_q4_0.cu, qmm_int8.cu, flash_prefill.cu, qmm_q8x.cu, mha_decode.cu,
     stream.cu, one nvcc each, in parallel; qmm_q4_0.cu and qmm_int8.cu
     include the prefill tile, qmm_tile.cuh).
  2. kernel checks at LLaMA-7B shapes: each kernel against its plain PyTorch
     version on the same inputs, with times (kernel, plain, one PyTorch
     library call) and the least time the card could take (bound): K2 and
     K3 on q4_0 weights; the prefill tile (K1 on q4_0, K5 on q4_K, K6 on
     q6_K, K6b on q5_K) timed at b=128 and 512 and checked at b=33, 64 and
     2048, two launches bit-identical; K5, K6, K6b's decode form at b=1;
     for agreement only, K5 on q2_K (16-groups) and K6 on q8_0 (32-groups)
     at b=1, 33, 64, 512, 2048; the fused affine seed of K5 and K6b alone
     against an f64 seed; ptxas's registers, shared memory and spills of the
     tile's kernels.
     K7 (int8 activations) on the q4_0 shapes at b=1, 128 and 512, its
     quantizer bit for bit; K4 (decode attention) at T=1 and 8 over windows
     of 256 and 2048 on int8 and bf16 caches, and for agreement on an f32
     cache, GQA, head widths 64 and 256, a strided B=2 window with an empty
     row; K8 (read stream) over 2 GiB of ones, its checksum exact.
  3. end to end, one path after another, the launch counts set to 0 just
     before each and read just after: synthetic LLaMA-7B q4_0 and LLaMA-7B
     Q4_K_M (32 layers, full width) built on the card, each a Context prefill
     of 512 tokens and 64 greedy decode steps through generate, then the
     bench.py instruments (prefill-512 ms, median decode ms/token at
     kv_window 256) and a profiled decode step; LLaMA-7B Q5_K_M (the path
     of K6b), a 128-token prefill and 16 decode steps.  2-layer models at
     the same width (q4_0, Q4_K_M) held against the plain versions on the
     CPU.  7B q4_0 in the int8 configuration (QMM_Q8X=1, FUSED_ATTN=1, q8
     cache): the same prefill and decode, 129 K7 and 32 K4 launches per
     token checked, decode ms/token at windows 256 and 2048 with each switch
     on and off; a 2-layer model in that configuration against the CPU.
  4. the `main` CLI answers prompts from GGJT files at 7B width (2 layers,
     32000-entry vocab) written by the port's own GGJTWriter: q4_0 (also in
     the int8 configuration), and Q4_K_M from random k-quant blocks;
     `benchmark-matmult` (default, QMM_Q8X=1, --vdot, --stream,
     --stream-sweep).
  5. a JSON line of per-kernel numbers, then the contract line
     {"ok": true, "device": {...}}.
``--phases kernels,e2e,cli`` runs a subset (for debugging: a subset prints
no result lines; with no arguments every phase runs).  Run without CUDA, or
without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16 = 989e12  # dense tensor-core bf16
PEAK_F32 = 67e12  # f32 outside the tensor cores
PEAK_INT8 = 1979e12  # dense tensor-core int8
# (name, N, K) of the 7B matmuls: fused QKV, attention output, fused
# gate/up, FFN down, output head
SHAPES = [("wqkv", 12288, 4096), ("wo", 4096, 4096), ("w_gateup", 22016, 4096),
          ("w_down", 4096, 11008), ("output", 32000, 4096)]
# each matmul kernel (by its launch-count name): its wrapper in ops/qmm.py,
# the format of its weights and its 7B shapes.  K1 and K2 run all five q4_0
# shapes; in Q4_K_M, K5 (q4_K) runs wqkv, wo, gate/up and w2 of the q4_K
# layers and wq, wk, wo, gate/up of the others (the 4096x4096 row stands for
# wq, wk and wo), K6 (q6_K) runs wv and w2 of half the layers and the head;
# K6b (q5_K) is checked on one shape
KERNEL_SHAPES = {
    "qmm_q4_0": ("qmm_packed", "Q4_0", SHAPES),
    "qmm_q4_0_kfold": ("qmm_packed_kfold", "Q4_0", SHAPES),
    "qmm_packed_bias": ("qmm_packed_bias", "Q4_K", SHAPES[:4]),
    "qmm_int8": ("qmm_int8", "Q6_K", [("wv", 4096, 4096), ("w_down", 4096, 11008),
                                      ("output", 32000, 4096)]),
    "qmm_int8_bias": ("qmm_int8_bias", "Q5_K", [("wo", 4096, 4096)]),
    "qmm_q8x": ("qmm_packed_q8x", "Q4_0", SHAPES),
}
# agreement limits of the matmul kernels against their plain versions, as a
# fraction of the output scale: bf16 operands summed in another order (1e-3);
# K7's group dots are exact integers, so only the f32 order of the scaled
# group terms differs (1e-4)
QMM_TOL = {"qmm_q8x": 1e-4}
# the operation peak each matmul kernel's bound takes: K7 runs int8 products
QMM_PEAK = {"qmm_q8x": PEAK_INT8}
# the kernels' other compiled forms, checked for agreement only (not timed):
# K5 on 16-groups (q2_K), K6 on 32-groups (q5_0, q8_0)
OTHER_FORMS = {"qmm_packed_bias": ("Q2_K", [("wo", 4096, 4096)]),
               "qmm_int8": ("Q8_0", [("wo", 4096, 4096)])}
# (packed, group size, bias planes) of each format's device layout
FORMATS = {"Q4_0": (True, 32, False), "Q4_K": (True, 32, True),
           "Q2_K": (True, 16, True), "Q6_K": (False, 16, False),
           "Q8_0": (False, 32, False), "Q5_K": (False, 32, True)}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


class Timer:
    """Device time of one call: the call is captured in a CUDA graph so the
    replay excludes Python launch overhead, and before each replay a
    read-only sweep of 96 MB evicts the 50 MB L2 (the decode caller finds
    the weights cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.max()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps


def qmm_bytes(b, n, k, fmt="Q4_0"):
    """Bytes x [b, k] @ W [k, n] in format fmt must move: x read once; the
    weight's levels (K/2 packed rows or K int8 rows, not the padding up to
    K2P), its K/g f32 scale rows and, for an affine format, as many f32 bias
    rows; the f32 output written once."""
    packed, g, bias = FORMATS[fmt]
    levels = (k // 2) * n if packed else k * n
    planes = (k // g) * n * 4 * (2 if bias else 1)
    return 4 * b * k + levels + planes + 4 * b * n


def qmm_bound(b, n, k, fmt="Q4_0", peak=PEAK_BF16):
    """(least ms, what bounds it) for x [b, k] @ W: qmm_bytes at the memory
    rate against 2*b*n*k operations at the peak (bf16 unless named)."""
    t_bytes = qmm_bytes(b, n, k, fmt) / HBM_BYTES_PER_S
    t_ops = 2 * b * n * k / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(b, t, h, g, d):
    """(least ms, what bounds it) for causal attention over T tokens: q, k, v
    read once and out written once, against the 4*D multiply-add operations of
    each of the T(T+1)/2 causal (query, key) pairs at the f32 peak."""
    nbytes = 4 * b * t * d * (2 * h + 2 * g)
    ops = 4 * d * b * h * t * (t + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def model_bounds(label, params, n_layer, t=512):
    """The decode and prefill-t bounds of a model's matmuls, from its own
    weights: every layer matmul and the head at b=1 per decode token; the
    layer matmuls at b=t, the head at b=1 and K3 in every layer for one
    prefill.  Returns the decode bound in ms."""
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor

    def mm(w):
        return (w.qtype.name, w.n_out, w.n_in)

    layer = [mm(getattr(blk, f)) for blk in params.blocks
             for f in ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate",
                       "w_up", "w_down") if isinstance(getattr(blk, f), QTensor)]
    head = mm(params.output)
    dec_bytes = sum(qmm_bytes(1, n, k, f) for f, n, k in layer + [head])
    dec_ms = sum(qmm_bound(1, n, k, f)[0] for f, n, k in layer + [head])
    pre_ms = (sum(qmm_bound(t, n, k, f)[0] for f, n, k in layer)
              + qmm_bound(1, *head[1:], head[0])[0]
              + n_layer * flash_bound(1, t, 32, 32, 128)[0])
    print(f"bound: {label} decode token {dec_bytes} bytes through "
          f"{len(layer) + 1} matmuls, {dec_ms:.4f} ms; prefill-{t} "
          f"{pre_ms:.4f} ms", flush=True)
    return dec_ms


def check_qmm(torch, timer, name: str, b: int, rec: dict | None,
              other_form: bool = False, time_it: bool = True):
    """A matmul kernel at its 7B shapes (KERNEL_SHAPES) against its plain
    version, on synthetic weights of its format, at b rows; two launches on
    the same inputs must give bit-identical outputs.  The error, times and
    bounds summed over the shapes go into rec, and the sums print on a line
    of their own.  other_form: the format and shape of OTHER_FORMS instead;
    time_it False: agreement only (the error goes into rec, no times)."""
    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    wrapper, fmt, shapes = KERNEL_SHAPES[name]
    if other_form:
        fmt, shapes = OTHER_FORMS[name]
        time_it = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(100 + b)
    ok = True
    sums = {}

    def call(fn, x, w):
        planes = [w.gscale_t] + ([w.gbias_t] if w.gbias_t is not None else [])
        kw = {"gsize": w.gsize}
        if w.packed:
            kw["zero"] = w.pack_zero
        return fn(x, w.levels_t, *planes, **kw)

    kern, plain = getattr(qmm, wrapper), getattr(qmm, wrapper + "_plain")
    for label, n, k in shapes:
        w = synth_qtensor(gen, n, k, "cuda", GGMLType[fmt])
        x = torch.randn((b, k), generator=gen, device="cuda")
        got, again, ref = call(kern, x, w), call(kern, x, w), call(plain, x, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = QMM_TOL.get(name, 1e-3) * ref.abs().max().item()
        same = torch.equal(got, again)
        good = bool(torch.isfinite(got).all()) and err <= tol and same
        ok &= good
        head = (f"kernel {name} {fmt} {label} b={b} N={n} K={k}"
                f"{f' (g={w.gsize})' if other_form else ''}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) bit-identical={same}")
        if rec is not None:
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if not time_it:
            print(f"{head} {'ok' if good else 'MISMATCH'}", flush=True)
            del w, x, got, again, ref
            continue
        deq = w.dequantize_t(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        k_ms = timer.ms(lambda: call(kern, x, w))
        p_ms = timer.ms(lambda: call(plain, x, w), reps=3)
        l_ms = timer.ms(lambda: torch.matmul(xb, deq))
        bnd, by = qmm_bound(b, n, k, fmt, QMM_PEAK.get(name, PEAK_BF16))
        print(f"{head} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bnd:.4f} bound_by={by} {'ok' if good else 'MISMATCH'}", flush=True)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bnd)):
            sums[key] = sums.get(key, 0.0) + v
        sums["bound_by"] = by
        del w, x, got, again, ref, deq, xb
    if sums:
        print(f"kernel {name} {fmt} b={b} sum over {len(shapes)} shapes: "
              f"kernel_ms={sums['ms']:.4f} plain_ms={sums['plain_ms']:.4f} "
              f"library_ms={sums['library_ms']:.4f} bound_ms={sums['bound_ms']:.4f}",
              flush=True)
        if rec is not None:
            rec.update(sums)
    return ok


def check_seed(torch) -> bool:
    """The fused affine seed alone, against an f64 seed: with every scale 0
    the weight products vanish (bf16(level * 0) = 0), so K5 and K6b return
    the seed xg . gbias they computed on the tensor cores from bf16 hi/lo
    parts.  One q4_K and one q5_K 7B shape, at b=33 (K split) and b=512;
    limit 1e-3 of the seed's scale, as every kernel check."""
    import dataclasses

    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    ok = True
    for name, fmt, n, k in (("qmm_packed_bias", "Q4_K", 4096, 11008),
                            ("qmm_int8_bias", "Q5_K", 4096, 4096)):
        w = synth_qtensor(gen, n, k, "cuda", GGMLType[fmt])
        w = dataclasses.replace(w, gscale_t=torch.zeros_like(w.gscale_t))
        for b in (33, 512):
            x = torch.randn((b, k), generator=gen, device="cuda")
            kw = {"gsize": w.gsize, **({"zero": w.pack_zero} if w.packed else {})}
            got = getattr(qmm, name)(x, w.levels_t, w.gscale_t, w.gbias_t, **kw)
            xd, bd = x.double(), w.gbias_t.double()
            if w.packed:
                k2, g2 = k // 2, k // 2 // w.gsize
                ref = (xd[:, :k2].reshape(b, g2, -1).sum(-1) @ bd[0, :g2]
                       + xd[:, k2:].reshape(b, g2, -1).sum(-1) @ bd[1, :g2])
            else:
                ref = xd.reshape(b, k // w.gsize, -1).sum(-1) @ bd
            torch.cuda.synchronize()
            err = (got.double() - ref).abs().max().item()
            scale = ref.abs().max().item()
            good = bool(torch.isfinite(got).all()) and err <= 1e-3 * scale
            ok &= good
            print(f"kernel {name} fused seed {fmt} b={b} N={n} K={k} (g={w.gsize}): "
                  f"max_abs_err vs f64 seed={err:.3e} ({err / scale:.2e} of the seed's "
                  f"scale {scale:.3e}) {'ok' if good else 'MISMATCH'}", flush=True)
    return ok


def ptxas_report(build) -> None:
    """ptxas's registers, shared memory and spills of every function of the
    prefill tile (tile_kernel, prep_kernel, gemv_reduce_kernel) and its
    warnings, one line each."""
    import re

    for lib, log in build.build_log.items():
        fn, props = None, {}
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            if "warning" in line.lower():
                print(f"build: {lib}: {line.strip()}", flush=True)
            if fn and fn.startswith("_ZN3qmm4tile") and ("spill" in line or "registers" in line):
                props.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
        for fn, lines in props.items():
            m = re.search(r"tile_kernelILi(\d+)E.*?(PackedDeq|Int8Deq)ILi(\d+)E(?:Lb(\d))?", fn)
            if m:
                flag = f", {'true' if m.group(4) == '1' else 'false'}" if m.group(4) else ""
                fn = f"tile_kernel<{m.group(1)}, {m.group(2)}<{m.group(3)}{flag}>>"
            elif "prep_kernel" in fn:
                fn = "prep_kernel"
            print(f"build: {lib} {fn}: {'; '.join(dict.fromkeys(lines))}", flush=True)
    from llama_cpp_q_4_0_tpu_torch.ops import qmm

    lib = qmm._lib("qmm_q4_0")
    print("build: tile_kernel dynamic shared memory (bytes): " + ", ".join(
        f"bm={bm} {lib.qmm_tile_smem(bm)}" for bm in qmm.TILE_ROWS), flush=True)


def check_flash(torch, timer, rec: dict):
    import torch.nn.functional as F

    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import (
        flash_prefill, flash_prefill_plain)

    b, t, h, d = 1, 512, 32, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
               for _ in range(3))
    scale = d ** -0.5
    got = flash_prefill(q, k, v, scale)
    ref = flash_prefill_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()  # f32 operands, f32 sums: order noise
    good = bool(torch.isfinite(got).all()) and err <= tol
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    k_ms = timer.ms(lambda: flash_prefill(q, k, v, scale))
    p_ms = timer.ms(lambda: flash_prefill_plain(q, k, v, scale), reps=3)
    l_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, scale=scale))
    bnd, by = flash_bound(b, t, h, h, d)
    print(f"kernel flash_prefill B={b} T={t} H={h} D={d}: max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms={l_ms:.4f} bound_ms={bnd:.4f} bound_by={by} "
          f"{'ok' if good else 'MISMATCH'}", flush=True)
    rec.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=bnd, bound_by=by)
    # correctness only: grouped KV heads, and the other compiled head width
    for b, t, h, g, d in ((1, 512, 32, 8, 128), (2, 256, 16, 4, 256)):
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, t, g, d), generator=gen, device="cuda")
                for _ in range(2))
        got = flash_prefill(q, k, v, d ** -0.5)
        ref = flash_prefill_plain(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        lim = 1e-4 * ref.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and e <= lim
        good &= ok
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        print(f"kernel flash_prefill B={b} T={t} H={h} G={g} D={d}: "
              f"max_abs_err={e:.3e} (tol {lim:.3e}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
    return good


def check_q8x_quantizer(torch) -> bool:
    """K7's activation quantizer on the card, bit for bit against
    quantize_q8x_plain (IEEE division, C roundf, fp16-rounded d) at the
    decode and prefill row counts of the 7B widths."""
    from llama_cpp_q_4_0_tpu_torch.ops import qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    ok = True
    for b, k in ((1, 4096), (128, 11008), (512, 4096)):
        x = torch.randn((b, k), generator=gen, device="cuda")
        x[0, :32] = 0.0  # a group of zeros: d = 0, q = 0
        xq, d = qmm.quantize_q8x(x)
        pq, pd = qmm.quantize_q8x_plain(x)
        torch.cuda.synchronize()
        same = torch.equal(xq, pq) and torch.equal(d.view(torch.int32), pd.view(torch.int32))
        ok &= same
        print(f"kernel qmm_q8x quantizer b={b} K={k}: bit-identical={same}", flush=True)
    return ok


def mha_bound(b, t, h, g, d, n_slots, itemsize):
    """(least ms, what bounds it) for decode attention over n_slots valid
    cache slots: the K/V levels and (int8) their f32 scales, q and out once,
    against 4*D operations per (query head, slot) at the f32 peak."""
    nbytes = (2 * b * n_slots * g * d * itemsize + (8 * b * n_slots * g if itemsize == 1
                                                     else 0) + 8 * b * t * h * d)
    ops = 4 * b * t * h * d * n_slots
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _mha_inputs(torch, gen, cache, b, t, h, g, d, s, n_past, n_ctx=2048):
    """q and a [:, :s] window of an n_ctx cache of the given type, positions
    n_past.. and the mask of the first n_past + t slots, as transformer.forward
    hands them to attention."""
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import quantize_kv

    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    k = torch.randn((b, n_ctx, g, d), generator=gen, device="cuda")
    v = torch.randn((b, n_ctx, g, d), generator=gen, device="cuda")
    if cache == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        kv = (kq[:, :s], ks[:, :s], vq[:, :s], vs[:, :s])
    else:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[cache]
        kv = (k.to(dt)[:, :s], None, v.to(dt)[:, :s], None)
    pos = (n_past + torch.arange(t, device="cuda"))[None].expand(b, t)
    mask = (torch.arange(s, device="cuda") < n_past + t)[None].expand(b, s)
    return q, kv, pos, mask


def check_mha(torch, timer, rec: dict) -> bool:
    """K4 against its plain version: timed at T = 1 and 8, S = 256 and 2048,
    int8 and bf16 caches (B = 1, H = G = 32, D = 128, the window nearly
    full); for agreement only, an f32 cache, GQA, D = 64 and 256, and B = 2
    over a strided window whose second row has no valid slot.  rec takes the
    main path's case: T = 1 over the int8 window of 2048.  Also timed: the
    port's default attention (FUSED_ATTN unset) on the same window."""
    import torch.nn.functional as F

    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV
    from llama_cpp_q_4_0_tpu_torch.ops.layers import attention
    from llama_cpp_q_4_0_tpu_torch.ops.mha_decode import mha_decode, mha_decode_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    ok = True
    timed = [(c, t, s) for c in ("int8", "bf16") for t in (1, 8) for s in (256, 2048)]
    only = [("f32", 2, 8, 32, 32, 128, 256, 200), ("int8", 1, 1, 32, 8, 128, 2048, 1900),
            ("bf16", 1, 8, 32, 8, 64, 512, 400), ("int8", 1, 16, 16, 4, 256, 256, 100),
            ("int8", 2, 1, 32, 32, 128, 1024, 700)]
    cases = [(c, 1, t, 32, 32, 128, s, s - t - 40, True) for c, t, s in timed]
    cases += [(*o, False) for o in only]
    for cache, b, t, h, g, d, s, n_past, time_it in cases:
        q, (kd, ks, vd, vs), pos, mask = _mha_inputs(torch, gen, cache, b, t, h, g, d, s,
                                                     n_past)
        if b == 2:
            mask = mask.clone()
            mask[1] = False  # a row with no valid slot: both give 0
        scale = d ** -0.5
        args = (q, kd, ks, vd, vs, pos, mask, scale)
        got, ref = mha_decode(*args), mha_decode_plain(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()  # f32 chain, f32 summation order
        good = bool(torch.isfinite(got).all()) and err <= tol
        if b == 2:
            good &= bool((got[1] == 0).all())
        ok &= good
        head = (f"kernel mha_decode {cache} B={b} T={t} H={h} G={g} D={d} S={s} "
                f"n_past={n_past}: max_abs_err={err:.3e} (tol {tol:.3e})")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if not time_it:
            print(f"{head} {'ok' if good else 'MISMATCH'}", flush=True)
            continue
        # library: SDPA over the dequantized f32 window, timed only
        kf = kd.float() * (ks[..., None] if ks is not None else 1.0)
        vf = vd.float() * (vs[..., None] if vs is not None else 1.0)
        slot = torch.arange(s, device="cuda")
        amask = (mask[:, None, :] & (slot[None, None, :] <= pos[:, :, None]))[:, None]
        qh, kh, vh = q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
        k_ms = timer.ms(lambda: mha_decode(*args))
        p_ms = timer.ms(lambda: mha_decode_plain(*args), reps=3)
        # the port's default attention on the same window (FUSED_ATTN unset)
        kc, vc = ((QuantKV(kd, ks), QuantKV(vd, vs)) if ks is not None else (kd, vd))
        with env(FUSED_ATTN=""):
            a_ms = timer.ms(lambda: attention(q, kc, vc, pos, mask, scale), reps=3)
        l_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask, scale=scale))
        bnd, by = mha_bound(b, t, h, g, d, n_past + t, kd.element_size())
        print(f"{head} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"default_attention_ms={a_ms:.4f} bound_ms={bnd:.4f} bound_by={by} "
              f"{'ok' if good else 'MISMATCH'}", flush=True)
        if (cache, t, s) == ("int8", 1, 2048):
            rec.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by)
        del kf, vf, qh, kh, vh
    return ok


def check_stream(torch, timer, rec: dict) -> bool:
    """K8 over 2 GiB of ones in 4 MiB tiles: the checksum (every byte) and
    the TPU kernel's corner sums exact; GB/s, and the bound (the buffer at the
    memory rate).  Library: torch.sum of the buffer as int64."""
    from llama_cpp_q_4_0_tpu_torch.ops import stream

    rows, tile_rows = stream.stream_shape(2.0, 4)
    buf = torch.ones((rows, stream.LANES), dtype=torch.uint8, device="cuda")
    (cs, corner), (pcs, pcorner) = (stream.hbm_stream(buf, tile_rows),
                                    stream.hbm_stream_plain(buf, tile_rows))
    torch.cuda.synchronize()
    nbytes = rows * stream.LANES
    ok = (int(cs) == nbytes == int(pcs) and torch.equal(corner, pcorner)
          and bool((corner == rows // tile_rows).all()))
    k_ms = timer.ms(lambda: stream.hbm_stream(buf, tile_rows))
    p_ms = timer.ms(lambda: stream.hbm_stream_plain(buf, tile_rows), reps=3)
    l_ms = timer.ms(lambda: torch.sum(buf, dtype=torch.int64))
    bnd = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel hbm_stream {nbytes} bytes, tiles of {tile_rows} rows: checksum "
          f"{int(cs)} corner {corner[0, 0].item():.0f} (exact={ok}) kernel_ms={k_ms:.4f} "
          f"({nbytes / k_ms / 1e6:.1f} GB/s) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
          f"bound_ms={bnd:.4f} bound_by=bytes {'ok' if ok else 'MISMATCH'}", flush=True)
    rec.update(max_abs_err=float(abs(int(cs) - nbytes)), ms=k_ms, plain_ms=p_ms,
               library_ms=l_ms, bound_ms=bnd, bound_by="bytes")
    del buf
    return ok


class env:
    """Environment variables set for a with-block and restored after it."""

    def __init__(self, **kw):
        self.kw, self.saved = kw, {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


INT8 = {"QMM_Q8X": "1", "FUSED_ATTN": "1"}


def _zero(counters):
    for c in counters:
        for key in c:
            c[key] = 0


def _read(counters):
    return {k: v for c in counters for k, v in c.items()}


# the kernels each synthetic path must launch
PATH_KERNELS = {"q4_0": ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill"),
                # QMM_Q8X=1, FUSED_ATTN=1, q8 cache: K1 above the 128-row cap
                # (the 512-row prefill), K7 for the rest, K4 in every decode step
                "q4_0_int8": ("qmm_q4_0", "qmm_q8x", "flash_prefill", "mha_decode"),
                "q4_K_M": ("qmm_packed_bias", "qmm_int8", "flash_prefill"),
                "q5_K_M": ("qmm_int8_bias", "qmm_int8", "flash_prefill")}


def end_to_end(torch, counters, ftype="q4_0", n_prompt=512, n_decode=64, *,
               path=None, cache_dtype=None):
    """Full-depth 7B in file type ftype: a Context prefill of n_prompt tokens
    and n_decode greedy decode steps through generate, the launch counts set
    to 0 just before and read just after; then one more decode step counted
    alone (the launches per token).  path names the run (default ftype) and
    cache_dtype the KV cache (default bf16)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context, Timings
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import (GenerateParams,
                                                             generate)
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    path = path or ftype
    t0 = time.perf_counter()
    cfg, params = build_llama(device="cuda", seed=0, ftype=ftype)
    torch.cuda.synchronize()
    print(f"e2e: synthetic LLaMA-7B {ftype} built on the card in "
          f"{time.perf_counter() - t0:.1f} s (n_layer={cfg.n_layer} "
          f"n_embd={cfg.n_embd} n_ff={cfg.n_ff} n_vocab={cfg.n_vocab}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)",
          flush=True)
    rng = np.random.default_rng(0)
    prompt = [1] + rng.integers(3, cfg.n_vocab, n_prompt - 1).tolist()
    ctx = Context(cfg, params, n_ctx=2048, device="cuda",
                  cache_dtype=cache_dtype or torch.bfloat16)
    ctx.eval(prompt)  # warm-up (allocator, library handles)
    ctx.reset()
    ctx.timings = Timings()

    _zero(counters)
    gp = GenerateParams(n_predict=n_decode, ignore_eos=True,
                        sampling=SamplingParams(temp=0.0))
    toks = list(generate(ctx, prompt, gp))
    torch.cuda.synchronize()
    launches = _read(counters)
    tm = ctx.timings
    finite = bool(np.isfinite(ctx.logits).all())
    _zero(counters)
    ctx.eval([[toks[-1]]])
    torch.cuda.synchronize()
    per_token = {k: v for k, v in _read(counters).items() if v}
    print(f"e2e: {path} Context prefill {tm.n_prompt} tokens "
          f"{tm.t_prompt_ms:.2f} ms; {tm.n_eval} decode evals "
          f"{tm.t_eval_ms / max(1, tm.n_eval):.3f} ms/token (host clock); "
          f"{len(toks)} tokens; logits finite={finite}", flush=True)
    print(f"e2e: {path} launches on the main path {json.dumps(launches)}; "
          f"per decode token {json.dumps(per_token)}", flush=True)
    ok = finite and len(toks) == n_decode and all(
        launches[k] > 0 for k in PATH_KERNELS[path])
    del ctx
    return ok, launches, per_token, cfg, params


def bench_instruments(torch, cfg, params, label="q4_0"):
    """bench.py's instruments: prefill-512 (groups of 4, median of 5) and
    decode ms/token at kv_window 256 (median of 5 passes of 64 tokens)."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import flash_prefill

    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, device="cuda")
    toks = torch.zeros((1, 512), dtype=torch.int64, device="cuda")
    pre = []
    transformer.forward(cfg, params, toks, 0, ck, cv, last_only=True,
                        kv_window=512, attention_fn=flash_prefill)
    torch.cuda.synchronize()
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            transformer.forward(cfg, params, toks, 0, ck, cv, last_only=True,
                                kv_window=512, attention_fn=flash_prefill)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) / 4 * 1e3)
    med, dec = decode_ms(torch, cfg, params, ck, cv, 65, 256, n_tok=64, passes=5)
    print(f"bench: {label} prefill_512_ms median={statistics.median(pre):.3f} "
          f"min={min(pre):.3f} runs={[round(v, 3) for v in pre]}", flush=True)
    print(f"bench: {label} decode_ms_per_token (kv_window 256) "
          f"median={med:.3f} min={min(dec):.3f} "
          f"runs={[round(v, 3) for v in dec]}", flush=True)
    trace_decode(torch, cfg, params, ck, cv, med)
    return statistics.median(pre), med


def decode_ms(torch, cfg, params, ck, cv, n_past: int, window: int, n_tok=32, passes=3):
    """Median decode ms/token (host clock, synchronised) of passes of n_tok
    one-token forwards from slot n_past on, attention over kv_window."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    tok = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    transformer.forward(cfg, params, tok, n_past, ck, cv, last_only=True,
                        kv_window=window)
    torch.cuda.synchronize()
    runs = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for i in range(n_tok):
            logits = transformer.forward(cfg, params, tok, n_past + i, ck, cv,
                                         last_only=True, kv_window=window)
        logits.cpu()
        runs.append((time.perf_counter() - t0) / n_tok * 1e3)
    return statistics.median(runs), runs


def int8_instruments(torch, cfg, params):
    """Decode ms/token of 7B q4_0 on a q8 cache at kv_window 256 (n_past 65)
    and 2048 (n_past 1900): with QMM_Q8X=1 and FUSED_ATTN=1, then with each
    switched off alone.  Printed, not gated.  Then a profiled decode step of
    the int8 configuration at window 256."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, dtype=torch.int8, device="cuda")
    for window, n_past in ((256, 65), (2048, 1900)):
        for label, switches in (("QMM_Q8X=1 FUSED_ATTN=1", INT8),
                                ("QMM_Q8X=1 FUSED_ATTN off", {"QMM_Q8X": "1", "FUSED_ATTN": ""}),
                                ("QMM_Q8X off FUSED_ATTN=1", {"QMM_Q8X": "", "FUSED_ATTN": "1"})):
            with env(**switches):
                med, runs = decode_ms(torch, cfg, params, ck, cv, n_past, window)
            print(f"bench: q4_0 q8-cache decode_ms_per_token (kv_window {window}, n_past "
                  f"{n_past}, {label}) median={med:.3f} runs={[round(v, 3) for v in runs]}",
                  flush=True)
    with env(**INT8):
        med, _ = decode_ms(torch, cfg, params, ck, cv, 65, 256)
        trace_decode(torch, cfg, params, ck, cv, med)


def trace_decode(torch, cfg, params, ck, cv, step_ms: float):
    """torch.profiler over 8 decode steps at kv_window 256: the device-busy
    time per step (sum of kernel times) against the unprofiled step time,
    and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_q_4_0_tpu_torch.models import transformer

    tok = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            transformer.forward(cfg, params, tok, 65 + i, ck, cv,
                                last_only=True, kv_window=256)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # operator rows would count their kernels twice
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        rows.append((dev / 1e3 / 8, ev.count // 8, ev.key))
    if not rows:
        print("trace: the profiler recorded no kernel time (not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"trace: decode step (kv_window 256): device busy {busy:.3f} ms of "
          f"{step_ms:.3f} ms unprofiled ({100 * busy / step_ms:.1f}%), "
          f"{sum(r[1] for r in rows)} kernels per step", flush=True)
    for ms, n, key in rows[:8]:
        print(f"trace:   {ms:8.4f} ms/step  x{n:<4d} {key[:90]}", flush=True)


def two_layer_vs_cpu(torch, ftype="q4_0", counters=None) -> bool:
    """7B width, 2 layers: prefill 128 (prefill kernels, flash, decode-form
    head) and decode steps on the card against the plain versions on the
    CPU from the same weights, the card's greedy tokens fed to both.  In
    Q4_K_M layer 1 takes q6_K for wv and w2 (use_more_bits(1, 2)), so K5 and
    K6 both run.  With counters: the int8 configuration (QMM_Q8X=1,
    FUSED_ATTN=1) on an f32 cache, so that K7 (b=128, b=1), K3 and K4 (3
    decode steps past slot 128, window 256) run on the card and K7's plain
    version and the f32 attention chain on the CPU; each must launch."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    int8 = counters is not None
    label = f"{ftype}{' int8 config' if int8 else ''}"
    cfg, params = build_llama(n_layer=2, device="cuda", seed=1, ftype=ftype)
    cpu = _params_to(params, "cpu")
    prompt = [1] + np.random.default_rng(1).integers(3, 32000, 127).tolist()
    ok, outs, toks = True, {}, []
    with env(**(INT8 if int8 else {})):
        for dev, p in (("cuda", params), ("cpu", cpu)):
            if int8 and dev == "cuda":
                _zero(counters)
            ctx = Context(cfg, p, n_ctx=256, device=dev,
                          cache_dtype=torch.float32 if int8 else torch.bfloat16)
            outs[dev] = [ctx.eval(prompt)]
            for i in range(3 if int8 else 1):
                if dev == "cuda":
                    toks.append(int(np.argmax(outs[dev][-1][0, -1])))
                outs[dev].append(ctx.eval([[toks[i]]]))
            if int8 and dev == "cuda":
                torch.cuda.synchronize()
                launched = _read(counters)
    if int8:
        print(f"e2e: 2-layer {label} launches on the card {json.dumps(launched)}",
              flush=True)
        ok &= all(launched[k] > 0 for k in ("qmm_q8x", "mha_decode", "flash_prefill"))
    # bf16: the rounding of activations can flip at one ulp when sums differ
    # in order, well under 2% of the logits through 2 layers; int8: the f32
    # chain, where only a q8 roundf tie that an ulp moves can flip (1e-3)
    frac = 1e-3 if int8 else 2e-2
    for i, (g, r) in enumerate(zip(outs["cuda"], outs["cpu"])):
        err = float(np.abs(g - r).max())
        tol = frac * float(np.abs(r).max())
        good = err <= tol and np.isfinite(g).all()
        ok &= bool(good)
        print(f"e2e: 2-layer 7B-width {label} {'prefill-128' if i == 0 else 'decode'} "
              f"card vs CPU plain: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"{'ok' if good else 'MISMATCH'}", flush=True)
    return ok


def _params_to(params, device):
    import dataclasses

    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor

    def mv(v):
        if isinstance(v, QTensor):
            return v.to(device)
        return v.to(device) if v is not None else None

    blocks = tuple(dataclasses.replace(
        blk, **{f.name: mv(getattr(blk, f.name))
                for f in dataclasses.fields(blk)}) for blk in params.blocks)
    return dataclasses.replace(
        params, blocks=blocks, tok_embeddings=mv(params.tok_embeddings),
        out_norm_w=mv(params.out_norm_w), output=mv(params.output))


def write_ggjt_7b_width(path: str, ftype: str = "q4_0"):
    """GGJT file at 7B width, 2 layers: random block bytes with small finite
    fp16 scales, f32 norms of one, a 32000-entry vocab.  q4_0: every 2-D
    weight q4_0.  Q4_K_M: q4_K blocks, q6_K for the output head and for wv
    and w2 of layer 1 (use_more_bits(1, 2))."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import GGJTWriter
    from llama_cpp_q_4_0_tpu_torch.quant.types import (BLOCK_Q4_0, BLOCK_Q4_K,
                                                       BLOCK_Q6_K, GGMLType,
                                                       LlamaFType)

    n_vocab, e, n_ff, n_head, n_layer = 32000, 4096, 11008, 32, 2
    rng = np.random.default_rng(3)
    kq = ftype == "Q4_K_M"

    def q4_k(n, k):
        blk = np.empty(n * k // 256, BLOCK_Q4_K)
        blk["d"] = rng.uniform(0.5e-4, 1.5e-4, blk.shape).astype(np.float16)
        blk["dmin"] = rng.uniform(0.5e-4, 1.5e-4, blk.shape).astype(np.float16)
        blk["scales"] = rng.integers(0, 256, (blk.shape[0], 12), dtype=np.uint8)
        blk["qs"] = rng.integers(0, 256, (blk.shape[0], 128), dtype=np.uint8)
        return blk

    def q6_k(n, k):
        blk = np.empty(n * k // 256, BLOCK_Q6_K)
        blk["d"] = rng.uniform(2.5e-5, 7.5e-5, blk.shape).astype(np.float16)
        blk["scales"] = rng.integers(1, 64, (blk.shape[0], 16), dtype=np.int8)
        blk["ql"] = rng.integers(0, 256, (blk.shape[0], 128), dtype=np.uint8)
        blk["qh"] = rng.integers(0, 256, (blk.shape[0], 64), dtype=np.uint8)
        return blk
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([i]) if 32 <= i < 127 else f"<0x{i:02X}>".encode(), 0.0)
              for i in range(256)]
    vocab += [(f" tok{i}".encode(), -float(i)) for i in range(len(vocab), n_vocab)]
    hp = {"n_vocab": n_vocab, "n_embd": e, "n_mult": 256, "n_head": n_head,
          "n_layer": n_layer, "n_rot": e // n_head}

    def q4(n, k):
        blk = np.empty(n * k // 32, BLOCK_Q4_0)
        blk["d"] = rng.uniform(0.005, 0.015, blk.shape).astype(np.float16)
        blk["qs"] = rng.integers(0, 256, (blk.shape[0], 16), dtype=np.uint8)
        return blk

    file_type = LlamaFType.MOSTLY_Q4_K_M if kq else LlamaFType.MOSTLY_Q4_0
    with GGJTWriter(path, "llama", hp, int(file_type), vocab) as w:
        def emit(name, n, k):
            if not kq:
                w.write_tensor(name, GGMLType.Q4_0, (k, n), q4(n, k))
            elif name == "output.weight" or name in (
                    "layers.1.attention.wv.weight", "layers.1.feed_forward.w2.weight"):
                w.write_tensor(name, GGMLType.Q6_K, (k, n), q6_k(n, k))
            else:
                w.write_tensor(name, GGMLType.Q4_K, (k, n), q4_k(n, k))

        def ones(name):
            w.write_tensor(name, GGMLType.F32, (e,), np.ones(e, np.float32))

        emit("tok_embeddings.weight", n_vocab, e)
        ones("norm.weight")
        emit("output.weight", n_vocab, e)
        for i in range(n_layer):
            p = f"layers.{i}."
            ones(p + "attention_norm.weight")
            for nm in ("wq", "wk", "wv", "wo"):
                emit(p + f"attention.{nm}.weight", e, e)
            ones(p + "ffn_norm.weight")
            emit(p + "feed_forward.w1.weight", n_ff, e)
            emit(p + "feed_forward.w2.weight", e, n_ff)
            emit(p + "feed_forward.w3.weight", n_ff, e)


def cli_phase(ftype: str, prompts, counters=None) -> bool:
    """`main` on a 2-layer 7B-width GGJT file of ftype; each run's stderr
    (the load line with the ftype, the load time, the timings) passes
    through to this script's stderr.  With counters, one more run in the int8
    configuration (QMM_Q8X=1, FUSED_ATTN=1, --cache-type q8) of 80 tokens,
    so that decode passes slot 64 into windows of 128 and K4 runs; K7 and K4
    must launch in it."""
    from llama_cpp_q_4_0_tpu_torch.cli import main as main_cli
    from llama_cpp_q_4_0_tpu_torch.kernels.build import BUILD_DIR

    tmp = os.path.join(BUILD_DIR, "smoke")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, f"llama7b-width-2layer-{ftype}.ggjt")
    try:
        t0 = time.perf_counter()
        write_ggjt_7b_width(path, ftype)
        print(f"cli: wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok = True
        for prompt in prompts:
            t0 = time.perf_counter()
            print(f"cli: {ftype} main -p {prompt!r}: ", end="", flush=True)
            rc = main_cli.main(["-m", path, "-p", prompt, "-n", "16",
                                "--temp", "0", "-c", "256", "--device", "cuda"])
            print(f"\ncli: {ftype} main rc={rc} in {time.perf_counter() - t0:.1f} s "
                  "(load time: the stderr report)", flush=True)
            ok &= rc == 0
        if counters is not None:
            prompt = prompts[-1]
            print(f"cli: {ftype} main --cache-type q8 QMM_Q8X=1 FUSED_ATTN=1 -n 80 -p "
                  f"{prompt!r}: ", end="", flush=True)
            with env(**INT8):
                _zero(counters)
                rc = main_cli.main(["-m", path, "-p", prompt, "-n", "80", "--temp", "0",
                                    "-c", "256", "--cache-type", "q8", "--device", "cuda"])
                launched = {k: v for k, v in _read(counters).items() if v}
            print(f"\ncli: {ftype} int8 main rc={rc}; launches {json.dumps(launched)}",
                  flush=True)
            ok &= rc == 0 and launched.get("qmm_q8x", 0) > 0 \
                and launched.get("mha_decode", 0) > 0
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def benchmark_phase(counters):
    """`benchmark-matmult` on the card: the default run (11008 x 4096 x 128)
    with and without QMM_Q8X=1, --vdot, the 2 GiB read stream (the path of
    K8: its launches are counted) and the tile sweep.  Returns (ok, the
    stream run's launches)."""
    from llama_cpp_q_4_0_tpu_torch.cli import dispatch

    ok = True
    for label, args, switches in (
            ("default", [], {}), ("QMM_Q8X=1", [], {"QMM_Q8X": "1"}),
            ("--vdot", ["--vdot"], {}), ("--stream", ["--stream", "--stream-gib", "2"], {}),
            ("--stream-sweep", ["--stream-sweep"], {})):
        print(f"cli: benchmark-matmult {label}", flush=True)
        t0 = time.perf_counter()
        with env(**switches):
            _zero(counters)
            rc = dispatch(["benchmark-matmult", *args])
            launched = _read(counters)
        print(f"cli: benchmark-matmult {label} rc={rc} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ok &= rc == 0
        if label == "--stream":
            stream_launches = launched["hbm_stream"]
    return ok and stream_launches > 0, stream_launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,e2e,cli",
                    help="comma-separated subset of kernels,e2e,cli; the "
                         "result lines print only for the full run")
    phases = set(ap.parse_args(argv).phases.split(","))
    full = phases == {"kernels", "e2e", "cli"}
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this smoke run needs the card")
    sys.path.insert(0, ROOT)
    try:
        from llama_cpp_q_4_0_tpu_torch.kernels import build
        from llama_cpp_q_4_0_tpu_torch.ops import flash_prefill as fp
        from llama_cpp_q_4_0_tpu_torch.ops import mha_decode as md
        from llama_cpp_q_4_0_tpu_torch.ops import qmm
        from llama_cpp_q_4_0_tpu_torch.ops import stream as st
    except ImportError as e:
        return fail(f"the port is not beside this script: {e}")

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas_report(build)

    recs = {k: {} for k in ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill",
                            "qmm_packed_bias", "qmm_int8", "qmm_int8_bias",
                            "qmm_q8x", "mha_decode", "hbm_stream")}
    if "kernels" in phases:
        timer = Timer(torch)
        # K1 runs above 32 rows, K2 at 32 or fewer; K5, K6 and K6b at both.
        # The prefill tile (K1, K5, K6, K6b) is timed at b=128 and 512 and
        # checked at b=33 (the ragged row), 64 and 2048 (the smallest and
        # largest prefill buckets), on both group sizes (OTHER_FORMS)
        ok = check_qmm(torch, timer, "qmm_q4_0_kfold", 1, recs["qmm_q4_0_kfold"])
        ok &= check_qmm(torch, timer, "qmm_q4_0_kfold", 8, None)
        ok &= check_flash(torch, timer, recs["flash_prefill"])
        for name in ("qmm_q4_0", "qmm_packed_bias", "qmm_int8", "qmm_int8_bias"):
            if name != "qmm_q4_0":
                ok &= check_qmm(torch, timer, name, 1, recs[name])
            for b in (128, 512):  # the JSON line keeps the b=512 sums
                big = {}
                ok &= check_qmm(torch, timer, name, b, big)
                err = max(recs[name].get("max_abs_err", 0.0), big["max_abs_err"])
                if b == 512:
                    recs[name].update(big)
                recs[name]["max_abs_err"] = err
            for b in (33, 64, 2048):
                ok &= check_qmm(torch, timer, name, b, recs[name], time_it=False)
            if name in OTHER_FORMS:
                for b in (1, 33, 64, 512, 2048):
                    ok &= check_qmm(torch, timer, name, b, recs[name], other_form=True)
        ok &= check_seed(torch)
        # K7: b=1 (decode; beside K2 above), b=128 (the cap; beside K1 at
        # b=128) and b=512 (only under QMM_Q8X_MAX_B=512; beside K1 above)
        ok &= check_q8x_quantizer(torch)
        ok &= check_qmm(torch, timer, "qmm_q8x", 1, recs["qmm_q8x"])
        for b in (128, 512):
            big = {}
            ok &= check_qmm(torch, timer, "qmm_q8x", b, big)
            recs["qmm_q8x"]["max_abs_err"] = max(recs["qmm_q8x"]["max_abs_err"],
                                                 big["max_abs_err"])
        ok &= check_mha(torch, timer, recs["mha_decode"])
        ok &= check_stream(torch, timer, recs["hbm_stream"])
        if not ok:
            return fail("a kernel disagrees with its plain version")
        del timer
        torch.cuda.empty_cache()

    counters = [qmm.launches, fp.launches, md.launches, st.launches]
    launches = {}
    if "e2e" in phases:
        for ftype in ("q4_0", "q4_K_M"):
            ok, path_launches, per_token, cfg, params = end_to_end(
                torch, counters, ftype)
            if not ok:
                return fail(f"{ftype} end-to-end run: non-finite logits or a "
                            "kernel of the path never launched")
            for k in PATH_KERNELS[ftype]:
                launches.setdefault(k, path_launches[k])
            want = ({"qmm_packed_bias": 128, "qmm_int8": 33} if ftype == "q4_K_M"
                    else {"qmm_q4_0_kfold": 129})
            if per_token != want:
                return fail(f"{ftype} decode launches {per_token} != {want}")
            model_bounds(f"LLaMA-7B {ftype}", params, cfg.n_layer)
            bench_instruments(torch, cfg, params, ftype)
            del params
            torch.cuda.empty_cache()
        # the int8 configuration: K7 for every matmul of at most 128 rows, K4
        # over the q8 cache in every decode step
        with env(**INT8):
            ok, path_launches, per_token, cfg, params = end_to_end(
                torch, counters, "q4_0", path="q4_0_int8", cache_dtype=torch.int8)
        if not ok:
            return fail("q4_0 int8-configuration run: non-finite logits or a kernel "
                        "of the path never launched")
        want = {"qmm_q8x": 129, "mha_decode": 32}
        if per_token != want:
            return fail(f"int8-configuration decode launches {per_token} != {want}")
        for k in ("qmm_q8x", "mha_decode"):
            launches[k] = path_launches[k]
        int8_instruments(torch, cfg, params)
        del params
        torch.cuda.empty_cache()
        # the path of K6b: Q5_K_M (q5_K everywhere but the q6_K head, wv, w2)
        ok, path_launches, _, cfg, params = end_to_end(
            torch, counters, "q5_K_M", n_prompt=128, n_decode=16)
        if not ok:
            return fail("q5_K_M end-to-end run: non-finite logits or a kernel "
                        "of the path never launched")
        launches["qmm_int8_bias"] = path_launches["qmm_int8_bias"]
        del params
        torch.cuda.empty_cache()
        for ftype in ("q4_0", "q4_K_M"):
            if not two_layer_vs_cpu(torch, ftype):
                return fail(f"2-layer {ftype} model on the card disagrees with "
                            "the CPU plain path")
            torch.cuda.empty_cache()
        if not two_layer_vs_cpu(torch, "q4_0", counters):
            return fail("2-layer q4_0 int8 configuration on the card disagrees with "
                        "the CPU, or K7/K4 never launched")
        torch.cuda.empty_cache()
    if "cli" in phases:
        if not cli_phase("q4_0", ("Hello", "The capital of France is",
                                  "Once upon a time"), counters):
            return fail("the main CLI failed on the q4_0 file")
        ok, launches["hbm_stream"] = benchmark_phase(counters)
        if not ok:
            return fail("benchmark-matmult failed on the card")
        if not cli_phase("Q4_K_M", ("Hello", "Once upon a time")):
            return fail("the main CLI failed on the Q4_K_M file")
    if not full:
        print("partial run: no result lines", flush=True)
        return 0

    meta = {
        "qmm_q4_0": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_q4_0.cu",
                     "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:107"),
        "qmm_q4_0_kfold": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_q4_0.cu",
                           "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:169"),
        "flash_prefill": ("llama_cpp_q_4_0_tpu_torch/csrc/flash_prefill.cu",
                          "llama_cpp_q_4_0_tpu/ops/layers.py:175"),
        "qmm_packed_bias": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_q4_0.cu",
                            "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:218"),
        "qmm_int8": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_int8.cu",
                     "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:66"),
        "qmm_int8_bias": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_int8.cu",
                          "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:83"),
        "qmm_q8x": ("llama_cpp_q_4_0_tpu_torch/csrc/qmm_q8x.cu",
                    "llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:254"),
        "mha_decode": ("llama_cpp_q_4_0_tpu_torch/csrc/mha_decode.cu",
                       "llama_cpp_q_4_0_tpu/ops/pallas/attention.py:41"),
        "hbm_stream": ("llama_cpp_q_4_0_tpu_torch/csrc/stream.cu",
                       "llama_cpp_q_4_0_tpu/cli/benchmark.py:63"),
    }
    kernels = []
    for name, (src, repl) in meta.items():
        r = recs[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
