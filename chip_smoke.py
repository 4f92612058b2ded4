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
     the decode forms of one GEMV skeleton (K2, K5, K6, K6b, and K7 on q4_0
     and q3_K: one launch a call, the K splits reduced inside a thread-block
     cluster) at b=1, 3, 8, 17 and 32 at their 7B shapes, a ragged N=4224
     and K=11008, each within tolerance, two launches bit-identical, 10
     replays of a CUDA graph of one launch bit-identical to it, and on 2-byte
     planes equal to its f32 twin; K7 also on an odd pack zero and on
     single-group tie rows, equal to its plain version bit for bit
     (check_gemv);
     for agreement only, K5 on q2_K (16-groups) and K6 on q8_0 (32-groups)
     at b=1, 33, 64, 512, 2048; the fused affine seed of K5 and K6b alone
     against an f64 seed; ptxas's registers, shared memory and spills of the
     tile's kernels (K7's q8 mode included) and of K3.
     K3 (3xTF32 on the tensor cores) timed at T=512 and 2048 and checked at
     T=128, 512, 2048, with GQA and at head width 256, two launches
     bit-identical.  K7 (int8 activations) on the q4_0 shapes: its decode
     form at b=1, its tile (the shared tile's q8 mode) timed at b=128 and 512
     and checked at b=33, 64 and 2048, two launches bit-identical; its
     quantizer bit for bit.  K1, K2 and K7 on the q3_K layout (pack zero 4,
     16-groups) at the shapes Q3_K_M runs them on (wq/wk 4096x4096, the
     fused gate/up 22016x4096): K2 and K7 timed at b=1, K1 and K7's tile at
     b=128 and 512 and checked at b=33, 64 and 2048, K7's quantizer at
     16-groups bit for bit; for agreement only, the three on an odd pack
     zero at each group size (3 at 16, 7 at 32).  K7's tile at b=512 and 2048
     on both layouts launched 21 times, every output bit-identical to the
     first and within tolerance.  The q8 KV cache's
     quantize_kv on the card
     against the CPU bit for bit.  K4 (decode attention, one cluster launch)
     at T=1 and 8 over windows of 256 and 2048 on int8, bf16 and e4m3 (the
     f8 cache) caches, and
     for agreement on an f32 cache, GQA, head widths 64 and 256, a strided
     B=2 window with an empty row, every case bit-identical over two
     launches and 10 graph replays; K8 (read stream) over 2 GiB of ones, its
     checksum exact.
     The six matmul kernels on 2-byte scale planes (PLANE_FORMS): f16 on
     q4_0 (K1, K2, K7, and K5 on the zero folded into an f16 bias plane),
     q5_0 (K6) and q5_1 (K6b); bf16 on q3_K (K1, K2, K7), q4_K (K5), q6_K
     (K6) and q5_K (K6b); each at its 7B shapes, timed beside the same kernel
     on f32 planes holding the same values, whose output it must equal bit
     for bit, with its bound from the 2-byte plane bytes.
  3. end to end, one path after another, the launch counts set to 0 just
     before each and read just after: synthetic LLaMA-7B q4_0 and LLaMA-7B
     Q4_K_M and LLaMA-7B Q3_K_M (32 layers, full width) built on the card,
     each a Context prefill of 512 tokens and 64 greedy decode steps through
     generate, then the bench.py instruments (prefill-512 ms, median decode
     ms/token at kv_window 256) and a profiled decode step; Q3_K_M's launches
     checked (per decode token 96 K2 + 96 K5 + 1 K6, per prefill 96 K1 + 96
     K5 tile launches and 32 K3), and again in the int8 configuration (a
     128-token prefill through K7's tile and 16 decode steps, 96 K7 + 32 K4
     per token); LLaMA-7B Q5_K_M (the path of K6b), a 128-token prefill and
     16 decode steps.  2-layer models at the same width (q4_0, Q4_K_M,
     Q3_K_M) held against the plain versions on the CPU, and a 2-layer
     Q3_K_M with a 32001-entry vocabulary and n_ff 8640, whose head and w2
     lie outside the kernels' gate and take the bf16 product (checked: no
     kernel launch for them).  7B q4_0 in the int8 configuration (QMM_Q8X=1, FUSED_ATTN=1, q8
     cache): the same prefill and decode, 129 K7 and 32 K4 launches per
     token checked, decode ms/token at windows 256 and 2048 with each switch
     on and off, and prefill-128 ms (median of 5 groups of 4; the launches of
     one call printed: 128 K7 tile launches + 1 head, 32 K3); a 2-layer model
     in that configuration against the CPU.  On the q4_0 weights, cast by
     the Context: QMM_F16_SCALES=1 (greedy tokens equal to the f32-plane
     run's; 128 K1 a prefill, 129 K2 a token), with QMM_ZERO_FOLD=1 also
     (129 K5 a token on the folded view, K1 on the raw one), and the int8
     configuration on f16 planes (129 K7 a token); Q3_K_M after
     cast_scales_bf16 (128 + 16, launches checked); decode bounds from the
     2-byte plane bytes and profiled decode steps of each beside its f32
     weights'.  2-layer q4_1, q5_0, q5_1 and q8_0 models on f16 planes, and
     Q3_K_M (int8 configuration) and Q5_K_M on bf16 planes, against the CPU.
     Every Context step on the card is a CUDA graph replayed per key (the
     first call of a key runs eagerly and captures it): each run prints the
     graphs it captured, their capture ms and the pool's bytes, and
     bench_instruments and int8_instruments print the replayed step's
     prefill-512 and decode ms/token (windows 256, and 2048 in the int8
     configuration) beside the eager figures, with a profiled replayed step
     (device busy, host step, idle share).
  4. graphs: LLaMA-7B q4_0, 512 + 64 greedy tokens through Context +
     generate on a bf16 cache, and the int8 configuration 128 + 16 on a q8
     cache: every step's logits equal to an eager transformer.forward of the
     same inputs on a twin cache bit for bit, the same greedy tokens, the
     caches equal after the run, each replay's launches equal to the eager
     step's (129 K2; 129 K7 + 32 K4 a token); a replayed Context.embed and
     Context.eval_embd against their eager twins.
  5. ondevice: on-device decode (runtime/device_sample.py) on LLaMA-7B q4_0,
     each chunk a run of replays of one captured decode-and-sample graph:
     generate_ondevice greedy and sampled (temp 0.8, top-k 40, top-p 0.95,
     repeat penalty 1.1) 512 + 64 at chunk 16 and the int8 configuration
     128 + 16 at chunk 8, every chunk's tokens, key, recent window, mu and
     n_past equal to the eager decode_chunk on a twin cache bit for bit, the
     caches after the run too, launches a token (129 K2; 129 K7 + 32 K4),
     the same key giving the same tokens, the path's launches read after a
     run from 0; greedy agreement with the host loop printed; a B=2 chunk at
     n_past [100, 140] with a greedy SamplingVec banning a token in one row
     (replays equal eager, the token absent, the first step's logits against
     each row alone); the out-of-range per-row insert (no device assert, the
     insert equal to the CPU's bit for bit); bench lines of on-device against
     host-loop ms/token (greedy, sampled; with Timings.t_sample_ms) and the
     profiler over one chunk of each.
  6. session: the session slice on 7B q4_0 (the e2e phase's weights, n_ctx
     1024): perplexity of 4 x 512 token ids drawn from --seed, through the
     host loop at -b 512 and -b 256, under FLASH_PREFILL=0 and through the
     on-device loop (one graph a chunk), each with ms a chunk and K1/K3
     launches a chunk checked, the on-device value held to the host one on
     the same attention (|d ln ppl| <= 1e-4); the 2-layer 7B-width model's
     perplexity on the card against the CPU (2 x two_layer_vs_cpu's logit
     limit); 512 + 32 greedy tokens, then get_state / state_to_bytes /
     set_state into a fresh Context and into the same one (graphs captured,
     cache addresses unchanged), a zip session and a .ggsn session: each
     continues bit for bit like the uninterrupted run (the .ggsn cache equal
     to the saved one cast through f16); shift_kv_cache(32, 256) against a
     fresh eval of the surviving prompt (layer 0, bf16 and f32 caches) and 16
     more tokens; the f8 cache through generate with and without FUSED_ATTN=1
     (129 K2, + 32 K4 a token, checked), replayed ms/token beside bf16 and
     its perplexity; the tools on a 2-layer 7B-width GGJT: main
     --prompt-cache (zip, .ggsn) twice, main -i card vs CPU, main -f --n-keep
     with context swaps, perplexity (host and --on-device), save-load-state.
  7. spec: speculative decoding and LoRA on 7B q4_0 (the e2e phase's weights,
     n_ctx 1024, bf16 cache; a 512-token prompt of a 64-token pattern from
     --seed, 128 greedy tokens): the plain on-device chunk (the reference
     tokens) and the replayed step, then the host loop generate_speculative,
     generate_ondevice_spec (k 7, n_steps 8), generate_ondevice_spec_draft
     with the target as its own draft, with its first 2 blocks as the draft
     and with a 2-layer model of other weights (32 tokens; every draft
     rejected); every verify or round against its eager twin on twin caches
     bit for bit, the caches after the run equal and never rebound, each
     verify round's launches exact (129 K2 at 8 rows; 1,161 a self-draft
     round, 201 a 2-layer-draft round), the greedy tokens equal to the plain
     chunk's or parting at a near-tie (the plain logits' top-2 margin below
     the largest verify-decode difference there), ms per emitted token and
     tokens per verify, a verify round and a decode step under the profiler;
     the int8 configuration 128 + 64 through generate_ondevice_spec (129 K7 +
     32 K4 a round); an unmerged rank-16 adapter on wq, wk, wv and wo of the
     32 blocks (replayed decode ms/token with it and without, 193 K2 a token,
     the bases untouched); on the tools phase's 2-layer 7B-width GGJT `main
     --lora` merged and --lora-unmerged, card against CPU (the CPU runs in
     child processes meanwhile), and EmbdInput over the adapter card against
     CPU.
  8. families: the GPT-NeoX, Falcon and Bonsai families (synthetic q4_0,
     every step a replayed graph held against its eager twin bit for bit,
     512 + 64 on a bf16 cache and 128 + 16 in the int8 configuration): GPT-NeoX
     at StableLM-Base-Alpha-7B widths, 16 layers (65 K2 a token, 64 K1 + 16
     K3 a 512-prefill; 65 K7 + 16 K4 a token in the int8 configuration;
     checked), with a generate_ondevice run, Context.embed and eval_embd and
     the bench and trace lines; Falcon-7B widths, 16 layers, every matmul off
     the kernels' gate (the bf16 product, no matmul kernel; 16 K4 a token at
     71 query heads over one KV head in the int8 configuration, also through
     generate_ondevice), bench and trace lines; a 2-layer Bonsai inside the
     gate, replayed and against the CPU; K4 at H=71, G=1, D=64 (T=1 and 8, S=256
     and 2048, int8 and bf16 caches) against its plain version; `main --arch
     bonsai` and `embedding` on a Bonsai file of formats/fixtures.py, card
     against CPU.
  9. q8chaos (printed, not gated): the 2-layer q8_0 model of the e2e phase,
     each op of a 128-token prefill and a decode step on the card and on the
     CPU's f32 plain path, against an f64 forward of the same weights.
  10. the `main` CLI answers prompts from GGJT files at 7B width (2 layers,
     32000-entry vocab) written by the port's own GGJTWriter: q4_0 (also in
     the int8 configuration, and the `embedding` tool), Q4_K_M and Q3_K_M
     from random k-quant blocks; `benchmark-matmult` (default, QMM_Q8X=1,
     --vdot, --stream, --stream-sweep).
  11. serve: the serving engine (runtime/batch_engine.py) on the e2e
     phase's 7B q4_0 weights at 16 slots x 2048, bf16 cache: 20 requests
     (batched, per-slot and lane admissions) through host ticks and chunk-16
     ticks two in flight, every tick held against its eager twin (the first
     few bit for bit, the caches too), 129 K2 a tick step and the admissions'
     K1/K2/K3 counts by route, each request's greedy tokens against a single
     session (partings only at near ties); tokens/s and ms a tick at
     occupancy 1-16, a traced tick, time to first token; speculative ticks
     at 4 slots (k = 7, chunk 4) behind a registered prefix; the int8
     configuration at 8 slots, chunk 16 (129 K7 + 32 K4 a step); the memory
     estimate against the card's peak; `server --parallel 4 --parallel-chunk
     8` on a 2-layer 7B-width GGJT against the single-session server.
  12. a JSON line of per-kernel numbers (launches: the e2e paths', the
     families', the session, spec and serve phases'), then the contract line
     {"ok": true, "device": {...}}.
``--phases kernels,e2e,graphs,ondevice,session,spec,serve,families,q8chaos,cli`` runs a subset
(for debugging: a subset prints no result lines; with no arguments every phase runs).  Phases that run only
when named: ``sass`` (instruction counts of K7's and K3's kernels and of
the decode GEMV's and K4's instances), ``gemv`` (check_gemv alone),
``busy`` (device busy and kernels a 7B decode step on the q4_0, Q4_K_M,
Q3_K_M and Q5_K_M paths, and the int8 configuration at windows 256 and
2048), ``attn`` (K4's timed cases alone), ``splits`` (each decode form timed
at every K split count), ``k7k3``
(K3's and K7's tile checks and times alone), ``k7repeat`` (K7's repeated
tile launches alone), ``int8prefill`` (the int8 configuration's
prefill-128 instrument), ``planes`` (the 2-byte plane forms' kernel
checks alone) and ``tiles`` (TILE_AB: the matmul kernels' f32-plane times
and the decode forms' at b=1 and 8 on f32 and 2-byte planes, alone); a copy
of this script placed beside
an older checkout's package measures that one.  Run without CUDA, or
without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16 = 989e12  # dense tensor-core bf16
PEAK_F32 = 67e12  # f32 outside the tensor cores
PEAK_TF32 = 494.7e12  # dense tensor-core TF32
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
# (Q3_K_M runs K1, K2 and K7 on q3_K at wq and wk, 4096x4096, and the fused
# gate/up, 22016x4096; the "/q3_K" entries: the same kernels in that form)
Q3K_SHAPES = [("wq", 4096, 4096), ("w_gateup", 22016, 4096)]
# the GPT-NeoX path's matmuls at StableLM-Base-Alpha-7B widths: fused QKV,
# attention output, up, down (K = 24576) and the head; K1 runs the first
# four in a prefill, K2 and K7 all five (the "/gptneox" entries)
NEOX_SHAPES = [("wqkv", 18432, 6144), ("wo", 6144, 6144), ("w_up", 24576, 6144),
               ("w_down", 6144, 24576), ("output", 50688, 6144)]
KERNEL_SHAPES = {
    "qmm_q4_0": ("qmm_packed", "Q4_0", SHAPES),
    "qmm_q4_0_kfold": ("qmm_packed_kfold", "Q4_0", SHAPES),
    "qmm_packed_bias": ("qmm_packed_bias", "Q4_K", SHAPES[:4]),
    "qmm_int8": ("qmm_int8", "Q6_K", [("wv", 4096, 4096), ("w_down", 4096, 11008),
                                      ("output", 32000, 4096)]),
    "qmm_int8_bias": ("qmm_int8_bias", "Q5_K", [("wo", 4096, 4096)]),
    "qmm_q8x": ("qmm_packed_q8x", "Q4_0", SHAPES),
    "qmm_q4_0/q3_K": ("qmm_packed", "Q3_K", Q3K_SHAPES),
    "qmm_q4_0_kfold/q3_K": ("qmm_packed_kfold", "Q3_K", Q3K_SHAPES),
    "qmm_q8x/q3_K": ("qmm_packed_q8x", "Q3_K", Q3K_SHAPES),
    "qmm_q4_0/gptneox": ("qmm_packed", "Q4_0", NEOX_SHAPES[:4]),
    "qmm_q4_0_kfold/gptneox": ("qmm_packed_kfold", "Q4_0", NEOX_SHAPES),
    "qmm_q8x/gptneox": ("qmm_packed_q8x", "Q4_0", NEOX_SHAPES),
}
# agreement limits of the matmul kernels against their plain versions, as a
# fraction of the output scale: bf16 operands summed in another order (1e-3);
# K7's group dots are exact integers, so only the f32 order of the scaled
# group terms differs (1e-4).  Keyed by kernel, whatever its form
QMM_TOL = {"qmm_q8x": 1e-4}
# the operation peak each matmul kernel's bound takes: K7 runs int8 products
QMM_PEAK = {"qmm_q8x": PEAK_INT8}
# the kernels' other compiled forms, checked for agreement only (not timed):
# K5 on 16-groups (q2_K), K6 on 32-groups (q5_0, q8_0); K1, K2 and K7 on an
# odd pack zero at each group size (3 on q3_K's 16-groups, 7 on q4_0's
# 32-groups), as (format, shapes, pack zero or None)
OTHER_FORMS = {"qmm_packed_bias": [("Q2_K", [("wo", 4096, 4096)], None)],
               "qmm_int8": [("Q8_0", [("wo", 4096, 4096)], None)]}
for _name in ("qmm_q4_0", "qmm_q4_0_kfold", "qmm_q8x"):
    OTHER_FORMS[_name] = [("Q3_K", [("wo", 4096, 4096)], 3), ("Q4_0", [("wo", 4096, 4096)], 7)]
# (packed, group size, bias planes) of each format's device layout
FORMATS = {"Q4_0": (True, 32, False), "Q3_K": (True, 16, False), "Q4_K": (True, 32, True),
           "Q2_K": (True, 16, True), "Q6_K": (False, 16, False),
           "Q8_0": (False, 32, False), "Q5_K": (False, 32, True), "Q4_1": (True, 32, True),
           "Q5_0": (False, 32, False), "Q5_1": (False, 32, True)}
# The 2-byte plane forms of the six matmul kernels ("kernel/f16", "/bf16"):
# (wrapper, format, shapes, plane dtype, fold), f16 on a block format whose
# scales it holds exactly, bf16 (cast_scales_bf16) on a k-quant; fold: the
# q4_0 zero folded into an f16 bias plane (QMM_ZERO_FOLD), K5's q4_0 form.
# Each is held bit for bit against the same kernel on f32 planes of the same
# values, at the rows of PLANE_ROWS (timed, checked).
K6_SHAPES = [("wv", 4096, 4096), ("w_down", 4096, 11008), ("output", 32000, 4096)]
PLANE_FORMS = {
    "qmm_q4_0/f16": ("qmm_packed", "Q4_0", SHAPES, "float16", False),
    "qmm_q4_0/bf16": ("qmm_packed", "Q3_K", Q3K_SHAPES, "bfloat16", False),
    "qmm_q4_0_kfold/f16": ("qmm_packed_kfold", "Q4_0", SHAPES, "float16", False),
    "qmm_q4_0_kfold/bf16": ("qmm_packed_kfold", "Q3_K", Q3K_SHAPES, "bfloat16", False),
    "qmm_packed_bias/f16": ("qmm_packed_bias", "Q4_0", SHAPES, "float16", True),
    "qmm_packed_bias/bf16": ("qmm_packed_bias", "Q4_K", SHAPES[:4], "bfloat16", False),
    "qmm_int8/f16": ("qmm_int8", "Q5_0", K6_SHAPES, "float16", False),
    "qmm_int8/bf16": ("qmm_int8", "Q6_K", K6_SHAPES, "bfloat16", False),
    "qmm_int8_bias/f16": ("qmm_int8_bias", "Q5_1", [("wo", 4096, 4096)], "float16", False),
    "qmm_int8_bias/bf16": ("qmm_int8_bias", "Q5_K", [("wo", 4096, 4096)], "bfloat16", False),
    "qmm_q8x/f16": ("qmm_packed_q8x", "Q4_0", SHAPES, "float16", False),
    "qmm_q8x/bf16": ("qmm_packed_q8x", "Q3_K", Q3K_SHAPES, "bfloat16", False),
}
# the forms the ``tiles`` phase times alone, for an A/B of this script beside
# two checkouts' packages: the matmul kernels on f32 planes, and the five
# decode forms at b=1 and 8 on f32 and 2-byte planes (K7's on q3_K too)
TILE_AB = (("qmm_q4_0", 512), ("qmm_q4_0", 128), ("qmm_q4_0_kfold", 1),
           ("qmm_packed_bias", 512), ("qmm_packed_bias", 1), ("qmm_int8", 512),
           ("qmm_int8", 1), ("qmm_q8x", 512), ("qmm_q8x", 1), ("qmm_int8_bias", 1),
           ("qmm_q4_0_kfold", 8), ("qmm_packed_bias", 8), ("qmm_int8", 8),
           ("qmm_int8_bias", 8), ("qmm_q4_0_kfold/f16", 1), ("qmm_packed_bias/bf16", 1),
           ("qmm_int8/bf16", 1), ("qmm_int8_bias/bf16", 1), ("qmm_q4_0_kfold/f16", 8),
           ("qmm_packed_bias/bf16", 8), ("qmm_int8/bf16", 8), ("qmm_int8_bias/bf16", 8),
           ("qmm_q8x", 8), ("qmm_q8x/q3_K", 1), ("qmm_q8x/f16", 1), ("qmm_q8x/bf16", 1),
           ("qmm_q8x/f16", 8), ("qmm_q8x/bf16", 8))
# (timed rows, checked rows) of each kernel's 2-byte forms; the JSON line
# keeps the first timed row (K2 and K7 b=1, the others b=512)
PLANE_ROWS = {"qmm_q4_0": ((512,), (33, 2048)), "qmm_q4_0_kfold": ((1,), (8,)),
              "qmm_packed_bias": ((512, 1), (8, 33)), "qmm_int8": ((512, 1), (8, 33)),
              "qmm_int8_bias": ((512, 1), (8, 33)), "qmm_q8x": ((1, 512), (8, 33))}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


class Clocks:
    """nvidia-smi sampling the card's SM and memory clocks and power draw
    every 100 ms while a with-block runs; str() gives their ranges."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.rows = []
        for line in out.splitlines():
            try:
                self.rows.append([float(v) for v in line.split(",")])
            except ValueError:
                pass

    def __str__(self):
        if not self.rows:
            return "clocks not read"
        cols = list(zip(*self.rows))
        span = [f"{min(c):.0f}-{max(c):.0f}" if min(c) != max(c) else f"{min(c):.0f}"
                for c in cols[:2]]
        return (f"SM {span[0]} MHz, memory {span[1]} MHz, power {min(cols[2]):.0f}-"
                f"{max(cols[2]):.0f} W over {len(self.rows)} samples")


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


def qmm_bytes(b, n, k, fmt="Q4_0", es=4, bias=None):
    """Bytes x [b, k] @ W [k, n] in format fmt must move: x read once; the
    weight's levels (K/2 packed rows or K int8 rows, not the padding up to
    K2P), its K/g scale rows of es bytes a value (4: f32, 2: f16 or bf16)
    and, for an affine format (or a folded one: bias True), as many bias
    rows; the f32 output written once."""
    packed, g, affine = FORMATS[fmt]
    levels = (k // 2) * n if packed else k * n
    planes = (k // g) * n * es * (2 if (affine if bias is None else bias) else 1)
    return 4 * b * k + levels + planes + 4 * b * n


def qmm_bound(b, n, k, fmt="Q4_0", peak=PEAK_BF16, es=4, bias=None):
    """(least ms, what bounds it) for x [b, k] @ W: qmm_bytes at the memory
    rate against 2*b*n*k operations at the peak (bf16 unless named)."""
    t_bytes = qmm_bytes(b, n, k, fmt, es, bias) / HBM_BYTES_PER_S
    t_ops = 2 * b * n * k / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(b, t, h, g, d):
    """(least ms, what bounds it) for causal attention over T tokens by K3's
    route, 3xTF32 on the tensor cores: q, k, v read once and out written once,
    against three TF32 products of the 4*D operations of each of the
    T(T+1)/2 causal (query, key) pairs at the TF32 peak."""
    nbytes = 4 * b * t * d * (2 * h + 2 * g)
    ops = 3 * 4 * d * b * h * t * (t + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_TF32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def model_bounds(label, params, n_layer, t=512, heads=(32, 32, 128)):
    """The decode and prefill-t bounds of a model's matmuls, from its own
    weights (their planes' bytes a value and bias planes included): every
    layer matmul and the head at b=1 per decode token; the layer matmuls at
    b=t, the head at b=1 and K3's bound in every layer for one prefill
    (heads: the query heads, KV heads and head width).  Returns the decode
    bound in ms."""
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor

    def mm(w):  # qmm_bound's (n, k, fmt, peak, es, bias)
        return (w.n_out, w.n_in, w.qtype.name, PEAK_BF16, w.gscale_t.element_size(),
                w.gbias_t is not None)

    layer = [mm(getattr(blk, f)) for blk in params.blocks
             for f in ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate",
                       "w_up", "w_down") if isinstance(getattr(blk, f), QTensor)]
    head = mm(params.output)
    dec_bytes = sum(qmm_bytes(1, n, k, f, es, bias)
                    for n, k, f, _, es, bias in layer + [head])
    dec_ms = sum(qmm_bound(1, *a)[0] for a in layer + [head])
    pre_ms = (sum(qmm_bound(t, *a)[0] for a in layer) + qmm_bound(1, *head)[0]
              + n_layer * flash_bound(1, t, *heads)[0])
    print(f"bound: {label} decode token {dec_bytes} bytes through "
          f"{len(layer) + 1} matmuls, {dec_ms:.4f} ms; prefill-{t} "
          f"{pre_ms:.4f} ms", flush=True)
    return dec_ms


def f32_planes(w):
    """A QTensor with its planes widened to f32: the same values."""
    import dataclasses

    return dataclasses.replace(w, gscale_t=w.gscale_t.float(), gbias_t=None
                               if w.gbias_t is None else w.gbias_t.float())


def check_qmm(torch, timer, name: str, b: int, rec: dict | None,
              other_form: tuple | None = None, time_it: bool = True):
    """A matmul kernel (or one of its forms, "kernel/form") at its 7B shapes
    (KERNEL_SHAPES) against its plain version, on synthetic weights of its
    format, at b rows; two launches on the same inputs must give
    bit-identical outputs.  The error, times and bounds summed over the
    shapes go into rec, and the sums print on a line of their own.
    other_form: an entry of OTHER_FORMS (format, shapes, pack zero) instead,
    agreement only; time_it False: agreement only (the error goes into rec,
    no times).  A 2-byte form (PLANE_FORMS) casts the planes of each weight
    (and folds its zero where the form says), and also launches the kernel on
    f32 planes holding the same values: its output must equal the 2-byte
    form's bit for bit, and its time prints beside."""
    import dataclasses

    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    wrapper, fmt, shapes, dtype, fold = (PLANE_FORMS[name] if name in PLANE_FORMS
                                         else (*KERNEL_SHAPES[name], None, False))
    if dtype:  # (imported here: a package without 2-byte planes runs the rest)
        from llama_cpp_q_4_0_tpu_torch.ops.qtensor import (cast_scales_bf16,
                                                           cast_scales_f16,
                                                           fold_zero_points)
    kernel = name.split("/")[0]
    zero = None
    if other_form:
        fmt, shapes, zero = other_form
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
        if zero is not None:
            w = dataclasses.replace(w, pack_zero=zero)
        w32 = None
        if dtype:
            w = (cast_scales_f16 if dtype == "float16" else cast_scales_bf16)(w)
            w = fold_zero_points(w) if fold else w
            w32 = f32_planes(w)
        x = torch.randn((b, k), generator=gen, device="cuda")
        got, again, ref = call(kern, x, w), call(kern, x, w), call(plain, x, w)
        same_f32 = torch.equal(got, call(kern, x, w32)) if dtype else True
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = QMM_TOL.get(kernel, 1e-3) * ref.abs().max().item()
        same = torch.equal(got, again)
        good = bool(torch.isfinite(got).all()) and err <= tol and same and same_f32
        ok &= good
        form = f" (g={w.gsize}{f', zero={zero}' if zero is not None else ''})"
        planes = (f" {dtype} planes{' (zero folded)' if fold else ''}, equal to f32 "
                  f"planes={same_f32}" if dtype else "")
        head = (f"kernel {kernel} {fmt} {label} b={b} N={n} K={k}"
                f"{form if other_form else ''}{planes}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) bit-identical={same}")
        if rec is not None:
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if not time_it:
            print(f"{head} {'ok' if good else 'MISMATCH'}", flush=True)
            del w, w32, x, got, again, ref
            continue
        deq = w.dequantize_t(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        k_ms = timer.ms(lambda: call(kern, x, w))
        f32_ms = timer.ms(lambda: call(kern, x, w32)) if dtype else k_ms
        p_ms = timer.ms(lambda: call(plain, x, w), reps=3)
        l_ms = timer.ms(lambda: torch.matmul(xb, deq))
        bnd, by = qmm_bound(b, n, k, fmt, QMM_PEAK.get(kernel, PEAK_BF16),
                            w.gscale_t.element_size(), w.gbias_t is not None)
        f32_note = f" f32_planes_ms={f32_ms:.4f}" if dtype else ""
        print(f"{head} kernel_ms={k_ms:.4f}{f32_note} plain_ms={p_ms:.4f} "
              f"library_ms={l_ms:.4f} bound_ms={bnd:.4f} bound_by={by} "
              f"{'ok' if good else 'MISMATCH'}", flush=True)
        for key, v in (("ms", k_ms), ("f32_planes_ms", f32_ms), ("plain_ms", p_ms),
                       ("library_ms", l_ms), ("bound_ms", bnd)):
            sums[key] = sums.get(key, 0.0) + v
        sums["bound_by"] = by
        del w, w32, x, got, again, ref, deq, xb
    if sums:
        f32_note = f" f32_planes_ms={sums['f32_planes_ms']:.4f}" if dtype else ""
        print(f"kernel {kernel} {fmt}{f' {dtype} planes' if dtype else ''} b={b} sum over "
              f"{len(shapes)} shapes: kernel_ms={sums['ms']:.4f}{f32_note} "
              f"plain_ms={sums['plain_ms']:.4f} library_ms={sums['library_ms']:.4f} "
              f"bound_ms={sums['bound_ms']:.4f}", flush=True)
        if rec is not None:
            rec.update(sums)
    return ok


# the row counts at which each kernel's other forms are checked: K1 above 32
# rows, K2 at 32 or fewer, K7 in both of its forms
FORM_ROWS = {"qmm_q4_0": (33, 512, 2048), "qmm_q4_0_kfold": (1, 8),
             "qmm_q8x": (1, 8, 33, 512)}


def check_q3k(torch, timer, recs: dict) -> bool:
    """K1, K2 and K7 on the q3_K layout (pack zero 4, 16-groups) at the
    shapes Q3_K_M runs them on (Q3K_SHAPES): K2 and K7 timed at b=1 (recs
    keep these), K2 checked at b=8, K1 and K7's tile timed at b=128 and 512
    (K1's rec keeps b=512) and checked at b=33, 64 and 2048; K7's quantizer
    at 16-groups bit for bit."""
    ok = check_q8x_quantizer(torch, 16)
    ok &= check_qmm(torch, timer, "qmm_q4_0_kfold/q3_K", 1, recs["qmm_q4_0_kfold/q3_K"])
    ok &= check_qmm(torch, timer, "qmm_q4_0_kfold/q3_K", 8, None, time_it=False)
    for name in ("qmm_q4_0/q3_K", "qmm_q8x/q3_K"):
        if name == "qmm_q8x/q3_K":
            ok &= check_qmm(torch, timer, name, 1, recs[name])
        for b in (128, 512):
            big = {}
            ok &= check_qmm(torch, timer, name, b, big)
            err = max(recs[name].get("max_abs_err", 0.0), big["max_abs_err"])
            if b == 512 and name == "qmm_q4_0/q3_K":
                recs[name].update(big)
            recs[name]["max_abs_err"] = err
        for b in (33, 64, 2048):
            ok &= check_qmm(torch, timer, name, b, recs[name], time_it=False)
    return ok


def check_planes(torch, timer, recs: dict) -> bool:
    """Every 2-byte plane form of PLANE_FORMS at its 7B shapes: timed (with
    its f32-plane twin and its bound from 2-byte planes) and checked at the
    rows of PLANE_ROWS; recs[form] keeps the first timed row's sums."""
    ok = True
    for name in PLANE_FORMS:
        timed, checked = PLANE_ROWS[name.split("/")[0]]
        for i, b in enumerate(timed):
            rec = {}
            ok &= check_qmm(torch, timer, name, b, rec)
            if i == 0:
                recs[name] = rec
            else:
                recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], rec["max_abs_err"])
        for b in checked:
            ok &= check_qmm(torch, timer, name, b, recs[name], time_it=False)
    return ok


# The decode forms of one skeleton (csrc/qmm_common.cuh gemv_kernel): K2, K5,
# K6, K6b and K7 on q4_0 and q3_K, each with the 2-byte plane
# form it is held against its f32 twin in; K7 also on an odd pack zero
# (GEMV_ODD_ZERO) and on single-group tie rows (q8x_tie_rows).  The rows and
# extra shapes check_gemv takes them at: a ragged N = 4224 (33 x 128
# columns: inside the JAX kernel gate, half a 256-column tile) and K = 11008
# (uneven splits: 344 int8 or 172 packed steps)
GEMV_FORMS = {"qmm_q4_0_kfold": "qmm_q4_0_kfold/f16", "qmm_packed_bias": "qmm_packed_bias/bf16",
              "qmm_int8": "qmm_int8/bf16", "qmm_int8_bias": "qmm_int8_bias/bf16",
              "qmm_q8x": "qmm_q8x/f16", "qmm_q8x/q3_K": "qmm_q8x/bf16"}
GEMV_ODD_ZERO = {"qmm_q8x": 7, "qmm_q8x/q3_K": 3}
GEMV_ROWS = (1, 3, 8, 17, 32)
GEMV_EXTRA = [("ragged", 4224, 4096), ("w_down", 4096, 11008)]
# K2 and K7 at the GPT-NeoX shapes (the families phase)
NEOX_GEMV = {"qmm_q4_0_kfold/gptneox": "qmm_q4_0_kfold/f16", "qmm_q8x/gptneox": "qmm_q8x/f16"}


def q8x_tie_rows(torch, b: int, k: int, gsize: int, gen):
    """x [b, k] whose row i is zero but for one gsize-group (group 7 i + 3,
    so the rows cover both panels): 127 and half-integers in (-127, 127).
    The group's d is 127 / 127 = 1 exactly (fp16 too) and every other value
    sits on a roundf tie, which C's roundf takes away from zero and
    round-half-even would not; every other group quantizes to 0 with d = 0.
    So each output column of K7 is one f32 term, (dot * d_x) * d_w, in the
    same order in the kernel and the plain version: equal bit for bit."""
    x = torch.zeros((b, k), device="cuda")
    n_groups = k // gsize
    for i in range(b):
        g = (7 * i + 3) % n_groups
        vals = torch.randint(-127, 127, (gsize,), generator=gen, device="cuda").float() + 0.5
        vals[i % gsize] = 127.0
        x[i, g * gsize:(g + 1) * gsize] = vals
    return x


def check_gemv(torch, forms=GEMV_FORMS, extra_shapes=GEMV_EXTRA) -> bool:
    """Each decode form of forms at its shapes and extra_shapes, at
    every b of GEMV_ROWS: within QMM_TOL of its plain version; two launches
    bit-identical; one launch captured in a CUDA graph and replayed 10 times
    bit-identical to the eager launch (the in-kernel reduce leaves no state
    behind); and on its planes cast to 2 bytes, equal bit for bit to the
    same kernel on f32 planes of the same values.  K7's forms also on
    GEMV_ODD_ZERO's pack zero, and on q8x_tie_rows equal to the plain version
    bit for bit.  One line a form, zero and shape."""
    import dataclasses

    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import cast_scales_bf16, cast_scales_f16
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    def call(fn, x, w):
        planes = [w.gscale_t] + ([w.gbias_t] if w.gbias_t is not None else [])
        kw = {"gsize": w.gsize}
        if w.packed:
            kw["zero"] = w.pack_zero
        return fn(x, w.levels_t, *planes, **kw)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    ok = True
    for name, form in forms.items():
        wrapper, fmt, shapes = KERNEL_SHAPES[name]
        kernel = name.split("/")[0]
        dtype = PLANE_FORMS[form][3]
        kern, plain = getattr(qmm, wrapper), getattr(qmm, wrapper + "_plain")
        extra = [e for e in extra_shapes if (e[1], e[2]) not in {(n, k) for _, n, k in shapes}]
        for zero in (None, GEMV_ODD_ZERO[name]) if name in GEMV_ODD_ZERO else (None,):
            for label, n, k in shapes + extra:
                if zero is not None and label not in ("wo", "wq", "ragged"):
                    continue  # the odd zero on one square shape and the ragged N
                w = synth_qtensor(gen, n, k, "cuda", GGMLType[fmt])
                if zero is not None:
                    w = dataclasses.replace(w, pack_zero=zero)
                w2 = (cast_scales_f16 if dtype == "float16" else cast_scales_bf16)(w)
                w2f = f32_planes(w2)
                worst, same, graph_same, twin, ties = 0.0, True, True, True, True
                for b in GEMV_ROWS:
                    x = torch.randn((b, k), generator=gen, device="cuda")
                    got, again, ref = call(kern, x, w), call(kern, x, w), call(plain, x, w)
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        gout = call(kern, x, w)
                    replays = []
                    for _ in range(10):
                        g.replay()
                        replays.append(torch.equal(gout, got))
                    two, two_f32 = call(kern, x, w2), call(kern, x, w2f)
                    if kernel == "qmm_q8x":
                        xt = q8x_tie_rows(torch, b, k, w.gsize, gen)
                        ties &= torch.equal(call(kern, xt, w), call(plain, xt, w))
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    tol = QMM_TOL.get(kernel, 1e-3) * ref.abs().max().item()
                    worst = max(worst, err / tol)
                    same &= torch.equal(got, again) and bool(torch.isfinite(got).all())
                    graph_same &= all(replays)
                    twin &= torch.equal(two, two_f32)
                    del g, gout, got, again, ref, two, two_f32, x
                good = worst <= 1.0 and same and graph_same and twin and ties
                ok &= good
                tie_note = f" tie_rows_bit_identical={ties}" if kernel == "qmm_q8x" else ""
                zero_note = f" zero={zero}" if zero is not None else ""
                print(f"gemv {name} {fmt}{zero_note} {label} N={n} K={k} "
                      f"b={','.join(map(str, GEMV_ROWS))}: max err/tol={worst:.3e} "
                      f"bit-identical={same} graph_replays_identical={graph_same} "
                      f"{dtype}_equal_f32={twin}{tie_note} {'ok' if good else 'MISMATCH'}",
                      flush=True)
                del w, w2, w2f
    return ok


def check_q8x_repeats(torch, reps: int = 20) -> bool:
    """K7's tile launched 1 + reps times at b=512 and 2048 (128-row units,
    several a block) on the q3_K and q4_0 layouts at Q3K_SHAPES: every output
    bit-identical to the first and within QMM_TOL of the plain version.  Its
    consumer warps read each B slot's d_w rows with their own loads, so a
    slot freed before every warp is done shows only now and then: two
    launches do not see it."""
    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ok = True
    for fmt in ("Q3_K", "Q4_0"):
        for label, n, k in Q3K_SHAPES:
            w = synth_qtensor(gen, n, k, "cuda", GGMLType[fmt])
            args, kw = (w.levels_t, w.gscale_t), {"zero": w.pack_zero, "gsize": w.gsize}
            for b in (512, 2048):
                x = torch.randn((b, k), generator=gen, device="cuda")
                ref = qmm.qmm_packed_q8x_plain(x, *args, **kw)
                tol = QMM_TOL["qmm_q8x"] * ref.abs().max().item()
                first = qmm.qmm_packed_q8x(x, *args, **kw)
                worst, differ, over = (first - ref).abs().max().item(), 0, 0
                for _ in range(reps):
                    out = qmm.qmm_packed_q8x(x, *args, **kw)
                    err = (out - ref).abs().max().item()
                    worst = max(worst, err)
                    differ += not torch.equal(out, first)
                    over += err > tol
                good = differ == 0 and worst <= tol
                ok &= good
                print(f"kernel qmm_q8x {fmt} {label} b={b} N={n} K={k} tile x{reps + 1}: "
                      f"differ-from-first={differ} over-tol={over} max_abs_err={worst:.3e} "
                      f"(tol {tol:.3e}) {'ok' if good else 'MISMATCH'}", flush=True)
            del w
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
    prefill tile (tile_kernel in each mode, prep_kernel, gemv_reduce_kernel)
    and of K3 (flash_prefill_kernel), and the warnings, one line each."""

    for lib, log in build.build_log.items():
        fn, props = None, {}
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            if "warning" in line.lower():
                print(f"build: {lib}: {line.strip()}", flush=True)
            if fn and (fn.startswith("_ZN3qmm4tile") or "flash_prefill_kernel" in fn
                       or "gemv_kernel" in fn or "mha_decode_kernel" in fn) and (
                    "spill" in line or "registers" in line):
                props.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
        for fn, lines in props.items():
            m = re.search(r"tile_kernelILi(\d+)E.*?(PackedDeq|Int8Deq)ILi(\d+)E(?:Lb(\d))?", fn)
            mq = re.search(r"tile_kernelILi(\d+)E.*?Q8DeqILi(\d+)E", fn)
            mf = re.search(r"flash_prefill_kernelILi(\d+)E", fn)
            if m:
                flag = f", {'true' if m.group(4) == '1' else 'false'}" if m.group(4) else ""
                fn = f"tile_kernel<{m.group(1)}, {m.group(2)}<{m.group(3)}{flag}>>"
            elif mq:
                fn = f"tile_kernel<{mq.group(1)}, Q8Deq<{mq.group(2)}>> (K7)"
            elif mf:
                fn = f"flash_prefill_kernel<{mf.group(1)}> (K3)"
            elif "prep_kernel" in fn:
                fn = "prep_kernel"
            elif "gemv_kernel" in fn or "mha_decode_kernel" in fn:
                fn = kernel_label(fn)
            print(f"build: {lib} {fn}: {'; '.join(dict.fromkeys(lines))}", flush=True)
    from llama_cpp_q_4_0_tpu_torch.ops import flash_prefill as fp
    from llama_cpp_q_4_0_tpu_torch.ops import qmm

    lib, q8 = qmm._lib("qmm_q4_0"), qmm._lib("qmm_q8x")
    print("build: tile_kernel dynamic shared memory (bytes): " + ", ".join(
        f"bm={bm} {lib.qmm_tile_smem(bm)}" for bm in qmm.TILE_ROWS) + "; q8 mode " + ", ".join(
        f"bm={bm} g={g} {q8.qmm_q8x_tile_smem(bm, g)}" for g in (32, 16)
        for bm in qmm.TILE_ROWS_Q8), flush=True)
    fl = build.load("flash_prefill", fp._SIGNATURES)
    print("build: flash_prefill_kernel dynamic shared memory (bytes): " + ", ".join(
        f"D={d} {fl.flash_prefill_smem(d)}" for d in fp.HEAD_DIMS), flush=True)


GEMV_OPS = ("LDG", "PRMT", "FADD", "FMUL", "F2F", "FFMA", "SHFL", "HMUL2", "IDP", "LOP3", "LDS",
            "I2F")
MHA_OPS = ("LDGSTS", "LDG", "LDS", "FFMA", "FMUL", "PRMT", "SHFL", "MUFU", "BAR", "ALL")
MHA_TYPES = {"a": "int8", "13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32",
             "13__nv_fp8_e4m3": "e4m3"}


def kernel_label(fn: str) -> str:
    """A readable name for a mangled decode GEMV or K4 instance."""
    m = re.search(r"(Int8Gemv|PackedGemv)ILi(\d+)ELb(\d)EEELi(\d+)E", fn)
    if m:
        return (f"gemv_kernel<{m.group(1)}<{m.group(2)}, "
                f"{'true' if m.group(3) == '1' else 'false'}>, {m.group(4)}>")
    m = re.search(r"Q8GemvILi(\d+)EEELi(\d+)E", fn)
    if m:
        return f"gemv_kernel<Q8Gemv<{m.group(1)}>, {m.group(2)}> (K7)"
    m = re.search(r"mha_decode_kernelI(a|13__nv_bfloat16|6__half|f|13__nv_fp8_e4m3)Li(\d+)ELi(\d+)E",
                  fn)
    if m:
        return f"mha_decode_kernel<{MHA_TYPES[m.group(1)]}, {m.group(2)}, {m.group(3)}> (K4)"
    return fn[:90]


def sass_counts(build) -> None:
    """Instruction counts in the SASS (cuobjdump -sass) of the kernels as
    built from this checkout, one line per kernel: K7's and K3's tensor-core
    ops (IMMA, HGMMA), int-to-float conversions (I2F*), FMUL and FFMA; and
    every instance of the decode GEMV of K2, K5, K6 and K6b (gemv_kernel):
    LDG, PRMT, FADD, FMUL, F2F (F2FP included), FFMA, SHFL and HMUL2, with
    its instructions per weight byte: all its instructions over the bytes its
    8-byte level loads (LDG.64) cover, so the prologue, x staging and
    reduce count against the inlined chunk bodies (an upper bound)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    for lib in ("qmm_q8x", "flash_prefill", "qmm_q4_0", "qmm_int8", "mha_decode"):
        sass = subprocess.run([cuobjdump, "-sass", build._so_path(lib)], capture_output=True,
                              text=True, timeout=300).stdout
        fn, counts = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = dict.fromkeys(("IMMA", "HGMMA", "ALL", "LDG64") + GEMV_OPS
                                           + MHA_OPS, 0)
                continue
            text = line.split("*/", 1)[-1].strip() if fn else ""
            if not fn or not line.strip().startswith("/*") or not text or text.startswith("/*"):
                continue
            words = text.split()
            full = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            op = full.split(".")[0]
            key = ("I2F" if op.startswith("I2F") else "F2F" if op.startswith("F2F")
                   else "IDP" if op.startswith("IDP") else op)
            counts[fn]["ALL"] += 1
            if op == "LDG" and ".64" in full:
                counts[fn]["LDG64"] += 1
            if key in counts[fn]:
                counts[fn][key] += 1
        for fn, c in counts.items():
            if "mha_decode_kernel" in fn:
                print(f"sass: {lib} {kernel_label(fn)}: "
                      f"{json.dumps({k: c[k] for k in MHA_OPS})}", flush=True)
            elif "gemv_kernel" in fn:
                name = kernel_label(fn)
                per_byte = c["ALL"] / (8 * c["LDG64"]) if c["LDG64"] else float("nan")
                ops = {k: c[k] for k in GEMV_OPS}
                print(f"sass: {lib} {name}: {json.dumps(ops)} all={c['ALL']} "
                      f"instructions_per_weight_byte={per_byte:.2f}", flush=True)
            elif c["IMMA"] or c["HGMMA"]:
                print(f"sass: {lib} {fn[:90]}: "
                      f"{json.dumps({k: c[k] for k in ('IMMA', 'HGMMA', 'I2F', 'FMUL', 'FFMA')})}",
                      flush=True)


# (B, T, H, G, D, timed) of K3's checks: timed at T=512 and 2048 (B=1, H=32,
# D=128), checked at T=128, with GQA 32/8, at head width 256 (T=200: the
# ragged edge) and at the serving engine's batched admission of 4 prompts
FLASH_CASES = ((1, 512, 32, 32, 128, True), (1, 2048, 32, 32, 128, True),
               (1, 128, 32, 32, 128, False), (1, 512, 32, 8, 128, False),
               (1, 2048, 32, 8, 128, False), (2, 256, 16, 4, 256, False),
               (1, 200, 16, 16, 256, False), (4, 512, 32, 32, 128, False))
# the families' prefills: GPT-NeoX's 48 heads of 128 at 512 and 128 tokens,
# Bonsai's 16 heads over one KV head
FAMILY_FLASH = ((1, 512, 48, 48, 128, True), (1, 128, 48, 48, 128, False),
                (1, 512, 16, 1, 128, False))


def check_flash(torch, timer, rec: dict, cases=FLASH_CASES):
    """K3 against its f32 plain version (limit 1e-4 of the output scale: the
    3xTF32 products carry ~2^-21 relative error, the rest is f32 order), two
    launches bit-identical, at each of cases; rec keeps the error and the
    times of the T=512 case."""
    import torch.nn.functional as F

    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import (
        flash_prefill, flash_prefill_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    good = True
    for b, t, h, g, d, time_it in cases:
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, t, g, d), generator=gen, device="cuda") for _ in range(2))
        scale = d ** -0.5
        got, again = flash_prefill(q, k, v, scale), flash_prefill(q, k, v, scale)
        ref = flash_prefill_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        same = torch.equal(got, again)
        ok = bool(torch.isfinite(got).all()) and err <= tol and same
        good &= ok
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        head = (f"kernel flash_prefill B={b} T={t} H={h} G={g} D={d}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) bit-identical={same}")
        if not time_it:
            print(f"{head} {'ok' if ok else 'MISMATCH'}", flush=True)
            continue
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        k_ms = timer.ms(lambda: flash_prefill(q, k, v, scale))
        p_ms = timer.ms(lambda: flash_prefill_plain(q, k, v, scale), reps=3)
        l_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=scale))
        bnd, by = flash_bound(b, t, h, g, d)
        print(f"{head} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bnd:.4f} bound_by={by} (3xTF32 tensor cores) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if t == 512:
            rec.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by)
        del qh, kh, vh
    return good


def check_quantize_kv(torch) -> bool:
    """The q8 KV cache's quantize_kv on the card against the CPU, bit for bit,
    on K vectors of the 7B layout whose amax makes a reciprocal multiply by
    1/127 an ulp off the correctly rounded division."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import quantize_kv

    rng = np.random.default_rng(19)
    amax = rng.uniform(0.0, 10.0, 600000).astype(np.float32)
    amax = amax[amax * np.float32(1 / 127) != amax / np.float32(127)][:32 * 512]
    v = rng.uniform(-0.9, 0.9, (1, 512, 32, 128)).astype(np.float32) * amax.reshape(
        1, 512, 32, 1)
    v[..., 5] = amax.reshape(1, 512, 32)
    cpu = torch.from_numpy(v)
    (cq, cs), (gq, gs) = quantize_kv(cpu), quantize_kv(cpu.cuda())
    torch.cuda.synchronize()
    same = torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu().view(torch.int32),
                                                     cs.view(torch.int32))
    recip = bool((cs != torch.from_numpy(amax.reshape(1, 512, 32) * np.float32(1 / 127))).all())
    print(f"kernel quantize_kv (q8 KV cache) 1x512x32x128 card vs CPU: bit-identical={same} "
          f"(a reciprocal multiply differs in every scale: {recip})", flush=True)
    return same and recip


def check_q8x_quantizer(torch, gsize: int = 32) -> bool:
    """K7's activation quantizer on the card at gsize-groups, bit for bit
    against quantize_q8x_plain (IEEE division, C roundf, fp16-rounded d) at
    the decode and prefill row counts of the 7B widths."""
    from llama_cpp_q_4_0_tpu_torch.ops import qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    ok = True
    for b, k in ((1, 4096), (128, 11008), (512, 4096)):
        x = torch.randn((b, k), generator=gen, device="cuda")
        x[0, :gsize] = 0.0  # a group of zeros: d = 0, q = 0
        xq, d = qmm.quantize_q8x(x, gsize)
        pq, pd = qmm.quantize_q8x_plain(x, gsize)
        torch.cuda.synchronize()
        same = torch.equal(xq, pq) and torch.equal(d.view(torch.int32), pd.view(torch.int32))
        ok &= same
        print(f"kernel qmm_q8x quantizer g={gsize} b={b} K={k}: bit-identical={same}",
              flush=True)
    return ok


def mha_bound(b, t, h, g, d, n_slots, itemsize, scaled=None):
    """(least ms, what bounds it) for decode attention over n_slots valid
    cache slots: the K/V levels and (int8, scaled: default for 1-byte
    values) their f32 scales, q and out once, against 4*D operations per
    (query head, slot) at the f32 peak.  An e4m3 cache has 1-byte values and
    no scales."""
    scaled = itemsize == 1 if scaled is None else scaled
    nbytes = (2 * b * n_slots * g * d * itemsize + (8 * b * n_slots * g if scaled else 0)
              + 8 * b * t * h * d)
    ops = 4 * b * t * h * d * n_slots
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _mha_inputs(torch, gen, cache, b, t, h, g, d, s, n_past, n_ctx=2048):
    """q and a [:, :s] window of an n_ctx cache of the given type, positions
    n_past.. and the mask of the first n_past + t slots, as transformer.forward
    hands them to attention."""
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import quantize_kv, to_f8

    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    k = torch.randn((b, n_ctx, g, d), generator=gen, device="cuda")
    v = torch.randn((b, n_ctx, g, d), generator=gen, device="cuda")
    if cache == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        kv = (kq[:, :s], ks[:, :s], vq[:, :s], vs[:, :s])
    elif cache == "f8":
        kv = (to_f8(k)[:, :s], None, to_f8(v)[:, :s], None)
    else:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[cache]
        kv = (k.to(dt)[:, :s], None, v.to(dt)[:, :s], None)
    pos = (n_past + torch.arange(t, device="cuda"))[None].expand(b, t)
    mask = (torch.arange(s, device="cuda") < n_past + t)[None].expand(b, s)
    return q, kv, pos, mask


# K4 at Falcon-7B's attention: 71 query heads over one KV head of 64, T = 1
# and 8 (5 row blocks of 16, the last holding 7 rows; 568 rows at T = 8)
FALCON_MHA = [(c, 1, t, 71, 1, 64, s, s - t - 40, True)
              for c in ("int8", "bf16") for t in (1, 8) for s in (256, 2048)]


def check_mha(torch, timer, rec: dict, ab: bool = False, cases=None) -> bool:
    """K4 against its plain version: timed at T = 1 and 8, S = 256 and 2048,
    int8, bf16 and e4m3 (the f8 cache) caches (B = 1, H = G = 32, D = 128,
    the window nearly full); for agreement only, an f32 cache, GQA, D = 64 and 256, and B = 2
    over a strided window whose second row has no valid slot.  Every case:
    two launches bit-identical, and one launch captured in a CUDA graph and
    replayed 10 times bit-identical to it (no state left behind).  rec takes
    the main path's case: T = 1 over the int8 window of 2048.  Also timed:
    the port's default attention (FUSED_ATTN unset) on the same window.
    ab: the timed cases alone, with the kernel's time, the library's and the
    bound only (the ``attn`` phase, for an A/B beside another checkout).
    cases: these (cache, B, T, H, G, D, S, n_past, timed) instead, each held
    and timed the same way (FALCON_MHA)."""
    import torch.nn.functional as F

    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV
    from llama_cpp_q_4_0_tpu_torch.ops.layers import attention
    from llama_cpp_q_4_0_tpu_torch.ops.mha_decode import mha_decode, mha_decode_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    ok = True
    timed = [(c, t, s) for c in ("int8", "bf16", "f8") for t in (1, 8) for s in (256, 2048)]
    only = [("f32", 2, 8, 32, 32, 128, 256, 200), ("int8", 1, 1, 32, 8, 128, 2048, 1900),
            ("bf16", 1, 8, 32, 8, 64, 512, 400), ("int8", 1, 16, 16, 4, 256, 256, 100),
            ("int8", 2, 1, 32, 32, 128, 1024, 700), ("int8", 8, 1, 32, 32, 128, 2048, 1500)]
    if cases is None:
        cases = [(c, 1, t, 32, 32, 128, s, s - t - 40, True) for c, t, s in timed]
        cases += [] if ab else [(*o, False) for o in only]
    for cache, b, t, h, g, d, s, n_past, time_it in cases:
        q, (kd, ks, vd, vs), pos, mask = _mha_inputs(torch, gen, cache, b, t, h, g, d, s,
                                                     n_past)
        if b == 2:
            mask = mask.clone()
            mask[1] = False  # a row with no valid slot: both give 0
        scale = d ** -0.5
        args = (q, kd, ks, vd, vs, pos, mask, scale)
        got, again, ref = mha_decode(*args), mha_decode(*args), mha_decode_plain(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gout = mha_decode(*args)
        replays = []
        for _ in range(10):
            graph.replay()
            replays.append(torch.equal(gout, got))
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()  # f32 chain, f32 summation order
        same, graph_same = torch.equal(got, again), all(replays)
        good = bool(torch.isfinite(got).all()) and err <= tol and same and graph_same
        if b == 2:
            good &= bool((got[1] == 0).all())
        ok &= good
        del graph, gout
        head = (f"kernel mha_decode {cache} B={b} T={t} H={h} G={g} D={d} S={s} "
                f"n_past={n_past}: max_abs_err={err:.3e} (tol {tol:.3e}) bit-identical={same} "
                f"graph_replays_identical={graph_same}")
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
        if g != h:  # the library call takes K/V for every query head
            kh, vh = kh.repeat_interleave(h // g, dim=1), vh.repeat_interleave(h // g, dim=1)
        k_ms = timer.ms(lambda: mha_decode(*args))
        l_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask, scale=scale))
        bnd, by = mha_bound(b, t, h, g, d, n_past + t, kd.element_size(), ks is not None)
        p_ms = a_ms = float("nan")
        if not ab:
            p_ms = timer.ms(lambda: mha_decode_plain(*args), reps=3)
            # the port's default attention on the same window (FUSED_ATTN unset)
            kc, vc = ((QuantKV(kd, ks), QuantKV(vd, vs)) if ks is not None else (kd, vd))
            with env(FUSED_ATTN=""):
                a_ms = timer.ms(lambda: attention(q, kc, vc, pos, mask, scale), reps=3)
        print(f"{head} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"default_attention_ms={a_ms:.4f} bound_ms={bnd:.4f} bound_by={by} "
              f"{'ok' if good else 'MISMATCH'}", flush=True)
        if (cache, t, h, s) == ("int8", 1, 32, 2048):
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
# Why the 2-layer q8_0 model is held against its own f32 planes and its CPU
# agreement only printed: its synthetic weights (levels uniform over +-127,
# d 0.0005-0.0015, 1.6 times the other formats' weight scale) make a model
# that turns small differences into logit changes past the 2e-2 limit on f32
# planes as well, while K6 on q8_0 agrees with its plain version to ~5e-6 of
# its output at every shape (the kernel checks).  q8chaos_phase localizes
# it: the CPU departs from an f64 forward 2-5x more than the card from the
# first attention on (its bf16-rounded q and probabilities against K3's f32).
Q8_0_CHAOS = "its synthetic model amplifies summation order past the limit on f32 planes too"
# the launches of one 7B Q3_K_M decode token: K2 for wq, wk and gate/up, K5
# for wv, wo and w2 in each of 32 layers, K6 for the head
Q3KM_PER_TOKEN = {"qmm_q4_0_kfold": 96, "qmm_packed_bias": 96, "qmm_int8": 1}


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
                # q3_K (wq, wk, gate/up): K1 above 32 rows, K2 at 32 or fewer;
                # q4_K (wv, wo, w2): K5; the q6_K head: K6
                "q3_K_M": ("qmm_q4_0", "qmm_q4_0_kfold", "qmm_packed_bias", "qmm_int8",
                           "flash_prefill"),
                # QMM_Q8X=1, FUSED_ATTN=1, q8 cache, a 128-token prompt: K7 for
                # every q3_K matmul (its tile in the prefill)
                "q3_K_M_int8": ("qmm_q8x", "qmm_packed_bias", "qmm_int8",
                                "flash_prefill", "mha_decode"),
                "q5_K_M": ("qmm_int8_bias", "qmm_int8", "flash_prefill"),
                # QMM_F16_SCALES=1: q4_0's path on f16 planes; with
                # QMM_ZERO_FOLD=1 also, decode takes K5 on the folded view and
                # the 128-token prefill K1 on the raw one
                "q4_0_f16": ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill"),
                "q4_0_f16_fold": ("qmm_q4_0", "qmm_packed_bias", "flash_prefill"),
                # QMM_F16_SCALES=1 in the int8 configuration, a 128-token prompt
                "q4_0_int8_f16": ("qmm_q8x", "flash_prefill", "mha_decode"),
                # after cast_scales_bf16
                "q3_K_M_bf16": ("qmm_q4_0", "qmm_q4_0_kfold", "qmm_packed_bias", "qmm_int8",
                                "flash_prefill"),
                # --cache-type f8: q4_0's path over an e4m3 cache, and with
                # FUSED_ATTN=1 K4 reading it in every decode step
                "q4_0_f8": ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill"),
                "q4_0_f8_fused": ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill", "mha_decode")}


def end_to_end(torch, counters, ftype="q4_0", n_prompt=512, n_decode=64, *,
               path=None, cache_dtype=None, built=None):
    """Full-depth 7B in file type ftype: a Context prefill of n_prompt tokens
    and n_decode greedy decode steps through generate, the launch counts set
    to 0 just before and read just after; then one more decode step counted
    alone (the launches per token).  path names the run (default ftype) and
    cache_dtype the KV cache (default bf16); built: the (cfg, params) of an
    earlier run to take again instead of building.  Returns (ok, launches,
    per-token launches, cfg, params, greedy tokens)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context, Timings
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import (GenerateParams,
                                                             generate)
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    path = path or ftype
    t0 = time.perf_counter()
    cfg, params = built or build_llama(device="cuda", seed=0, ftype=ftype)
    torch.cuda.synchronize()
    if not built:
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
    print(f"e2e: {path} {graph_summary(ctx)}", flush=True)
    ok = finite and len(toks) == n_decode and all(
        launches[k] > 0 for k in PATH_KERNELS[path])
    del ctx
    return ok, launches, per_token, cfg, params, toks


def bench_instruments(torch, cfg, params, label="q4_0", passes=5, n_tok=64):
    """bench.py's instruments: prefill-512 (median of passes groups of 4)
    and decode ms/token at kv_window 256, eager (transformer.forward; median
    of at most 3 passes of 16 tokens) and profiled; then the same through the
    Context's replayed step (graph_instruments; median of passes of n_tok
    tokens, default 5 of 64).
    The eager prefill takes K3 where a Context would (use_flash_prefill)."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import flash_prefill
    from llama_cpp_q_4_0_tpu_torch.ops.layers import use_flash_prefill

    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, device="cuda")
    toks = torch.zeros((1, 512), dtype=torch.int64, device="cuda")
    attn = flash_prefill if use_flash_prefill(512, cfg.head_dim, toks.device) else None
    pre = []
    transformer.forward(cfg, params, toks, 0, ck, cv, last_only=True,
                        kv_window=512, attention_fn=attn)
    torch.cuda.synchronize()
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(4):
            transformer.forward(cfg, params, toks, 0, ck, cv, last_only=True,
                                kv_window=512, attention_fn=attn)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) / 4 * 1e3)
    # the eager step (~60 ms a token) is only the replayed step's reference
    # point: at most 3 passes of 16 tokens, to keep the whole run in its time
    med, dec = decode_ms(torch, cfg, params, ck, cv, 65, 256, n_tok=min(n_tok, 16),
                         passes=min(passes, 3))
    print(f"bench: {label} prefill_512_ms median={statistics.median(pre):.3f} "
          f"min={min(pre):.3f} runs={[round(v, 3) for v in pre]}", flush=True)
    print(f"bench: {label} decode_ms_per_token (kv_window 256) "
          f"median={med:.3f} min={min(dec):.3f} "
          f"runs={[round(v, 3) for v in dec]}", flush=True)
    trace_decode(torch, cfg, params, ck, cv, med, label)
    del ck, cv
    graph_instruments(torch, cfg, params, label, statistics.median(pre), {256: med},
                      passes=passes, n_tok=n_tok)
    return statistics.median(pre), med


def decode_ms(torch, cfg, params, ck, cv, n_past: int, window: int, n_tok=16, passes=3):
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
    the int8 configuration at windows 256 and 2048, eager and replayed
    through the Context (graph_instruments)."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, dtype=torch.int8, device="cuda")
    eager = {}
    for window, n_past in ((256, 65), (2048, 1900)):
        for label, switches in (("QMM_Q8X=1 FUSED_ATTN=1", INT8),
                                ("QMM_Q8X=1 FUSED_ATTN off", {"QMM_Q8X": "1", "FUSED_ATTN": ""}),
                                ("QMM_Q8X off FUSED_ATTN=1", {"QMM_Q8X": "", "FUSED_ATTN": "1"})):
            with env(**switches):
                med, runs = decode_ms(torch, cfg, params, ck, cv, n_past, window)
            eager.setdefault(window, med)
            print(f"bench: q4_0 q8-cache decode_ms_per_token (kv_window {window}, n_past "
                  f"{n_past}, {label}) median={med:.3f} runs={[round(v, 3) for v in runs]}",
                  flush=True)
    int8_prefill_128(torch, cfg, params, ck, cv)
    with env(**INT8):
        med, _ = decode_ms(torch, cfg, params, ck, cv, 65, 256)
        trace_decode(torch, cfg, params, ck, cv, med, "q4_0 int8-config")
        trace_decode(torch, cfg, params, ck, cv, eager[2048], "q4_0 int8-config", 2048, 1900)
        del ck, cv
        graph_instruments(torch, cfg, params, "q4_0 int8-config", None, eager,
                          windows=((256, 128), (2048, 1900)), cache_dtype=torch.int8)


def int8_prefill_128(torch, cfg, params, ck, cv, counters=None):
    """7B q4_0 in the int8 configuration (QMM_Q8X=1, FUSED_ATTN=1, q8 cache):
    prefill-128 ms (one 128-token forward, groups of 4, median of 5; host
    clock, synchronised) and the device-busy time of one call (the sum of its
    kernel times under torch.profiler, and the shares of all K7's passes and
    of K3).  Its
    matmuls of 128 rows take K7's tile and its attention K3; the launches of
    one call are printed (128 K7 tile launches + 1 for the head's last row,
    32 K3).  Printed, not gated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops import flash_prefill as fp
    from llama_cpp_q_4_0_tpu_torch.ops import qmm

    counters = counters or [qmm.launches, fp.launches]
    toks = torch.zeros((1, 128), dtype=torch.int64, device="cuda")

    def call():
        transformer.forward(cfg, params, toks, 0, ck, cv, last_only=True, kv_window=128,
                            attention_fn=fp.flash_prefill)

    with env(**INT8):
        call()
        torch.cuda.synchronize()
        _zero(counters)
        call()
        torch.cuda.synchronize()
        launched = {k: v for k, v in _read(counters).items() if v}
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                call()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / 4 * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    busy = {"all": 0.0, "K7": 0.0, "K3": 0.0}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        dev = (getattr(ev, "self_cuda_time_total", 0) if dev is None else dev) / 1e3
        busy["all"] += dev
        if any(n in ev.key for n in ("Q8Deq", "Q8Gemv", "q8x_", "gemv_reduce")):
            busy["K7"] += dev  # every K7 pass: prep, tile, reduce; the head's GEMV
        elif "flash_prefill" in ev.key:
            busy["K3"] += dev
    print(f"bench: q4_0 int8-config prefill_128_ms median={statistics.median(runs):.3f} "
          f"min={min(runs):.3f} runs={[round(v, 3) for v in runs]}; device busy of one call "
          f"{busy['all']:.3f} ms (K7 {busy['K7']:.3f}, K3 {busy['K3']:.3f}); "
          f"launches of one call {json.dumps(launched)}", flush=True)


def trace_decode(torch, cfg, params, ck, cv, step_ms: float | None, label: str,
                 window: int = 256, n_past: int = 65):
    """torch.profiler over 8 decode steps from slot n_past on at kv_window
    window: the device-busy time per step (sum of kernel times) against the
    unprofiled step time (when step_ms is given), and the kernels that take
    it."""
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_q_4_0_tpu_torch.models import transformer

    tok = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            transformer.forward(cfg, params, tok, n_past + i, ck, cv,
                                last_only=True, kv_window=window)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, 8)
    if not rows:
        print("trace: the profiler recorded no kernel time (not measured)")
        return
    busy = sum(r[0] for r in rows)
    share = (f" of {step_ms:.3f} ms unprofiled ({100 * busy / step_ms:.1f}%)"
             if step_ms else "")
    print(f"trace: {label} decode step (kv_window {window}): device busy {busy:.3f} ms"
          f"{share}, {sum(r[1] for r in rows)} kernels per step", flush=True)
    for ms, n, key in rows[:8]:
        print(f"trace:   {ms:8.4f} ms/step  x{n:<4d} {key[:90]}", flush=True)


def _kernel_rows(prof, n: int):
    """(ms a call, kernels a call, name) of each kernel under the profiler,
    over n calls; operator rows would count their kernels twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        rows.append((dev / 1e3 / n, ev.count // n, ev.key))
    return sorted(rows, reverse=True)


def graph_summary(ctx) -> str:
    """The graphs a Context captured: kind, T and window of each with its
    capture ms, and the shared pool's growth."""
    graphs = ctx.graphs()
    each = ", ".join(f"{g['key'][0]} T={g['key'][1]} window={g['key'][2]} "
                     f"{g['capture_ms']:.1f} ms" for g in graphs)
    pool = sum(g["pool_bytes"] for g in graphs)
    return (f"{len(graphs)} graphs captured ({each}); pool {pool} bytes "
            f"({pool / 2**20:.1f} MiB)")


def trace_replayed(torch, fn, n: int, host_ms: float, label: str) -> None:
    """torch.profiler over n calls of fn, each a replayed Context step: the
    device-busy time a call (the sum of its kernel times) against the
    unprofiled host time of a call (host_ms), the idle share, and the
    kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, n)
    if not rows:
        print(f"trace: {label} replayed: the profiler recorded no kernel time (not measured)",
              flush=True)
        return
    busy = sum(r[0] for r in rows)
    print(f"trace: {label} replayed: device busy {busy:.3f} ms of {host_ms:.3f} ms host "
          f"step (idle {100 * (1 - busy / host_ms):.1f}%), {sum(r[1] for r in rows)} "
          f"kernels per step", flush=True)
    for ms, k, key in rows[:8]:
        print(f"trace:   {ms:8.4f} ms/step  x{k:<4d} {key[:90]}", flush=True)


def graph_instruments(torch, cfg, params, label, eager_prefill, eager_decode: dict,
                      windows=((256, 128),), cache_dtype=None, passes=5, n_tok=64) -> None:
    """The replayed step through Context.eval, every call's logits copied
    to the host as Context.eval does: prefill-512 (median of passes groups
    of 4, n_past set back to 0 before each call; skipped when eager_prefill
    is None) and decode ms/token at each (kv_window, n_past) of windows
    (median of passes of n_tok tokens from n_past on, default 5 of 64: Context takes
    the bucket of n_past + 1 as its window, so n_past 128 gives window 256),
    beside the eager figures of the same run (eager_decode by window); then
    the profiled replayed steps (trace_replayed)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    ctx = Context(cfg, params, n_ctx=cfg.n_ctx, device="cuda",
                  cache_dtype=cache_dtype or torch.bfloat16)
    if eager_prefill is not None:
        prompt = [[0] * 512]

        def prefill():
            ctx.n_past = 0
            ctx.eval(prompt)

        prefill()  # the eager first call, then the capture
        runs = []
        for _ in range(passes):
            t0 = time.perf_counter()
            for _ in range(4):
                prefill()
            runs.append((time.perf_counter() - t0) / 4 * 1e3)
        med = statistics.median(runs)
        print(f"bench: {label} replayed prefill_512_ms median={med:.3f} min={min(runs):.3f} "
              f"runs={[round(v, 3) for v in runs]} (eager median {eager_prefill:.3f})",
              flush=True)
        trace_replayed(torch, prefill, 1, med, f"{label} prefill-512")
    for window, n_past in windows:
        def step():
            ctx.eval([[0]])

        ctx.n_past = n_past
        step()
        if ctx.last_call.kv_window != window:
            raise RuntimeError(f"n_past {n_past} gave window {ctx.last_call.kv_window}")
        runs = []
        for _ in range(passes):
            ctx.n_past = n_past
            t0 = time.perf_counter()
            for _ in range(n_tok):
                step()
            runs.append((time.perf_counter() - t0) / n_tok * 1e3)
        med = statistics.median(runs)
        print(f"bench: {label} replayed decode_ms_per_token (kv_window {window}, n_past "
              f"{n_past}) median={med:.3f} min={min(runs):.3f} "
              f"runs={[round(v, 3) for v in runs]} (eager median {eager_decode[window]:.3f})",
              flush=True)
        ctx.n_past = n_past
        trace_replayed(torch, step, 8, med, f"{label} decode step (kv_window {window})")
    print(f"graphs: {label} {graph_summary(ctx)}", flush=True)


def _flat_cache(caches):
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV

    return [a for c in caches for a in ((c.data, c.scale) if isinstance(c, QuantKV) else (c,))]


def eager_step(torch, cfg, call, ck, cv):
    """transformer.forward of a Context step's inputs (ctx.last_call),
    eagerly, on the caches ck, cv: the step's reference."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    return transformer.forward(
        cfg, call.params, torch.from_numpy(call.x).cuda(), call.n_past, ck, cv,
        last_only=call.last_only, kv_window=call.kv_window, last_index=call.last_index,
        attention_fn=call.attention_fn, with_embedding=call.kind == "embed")


def graph_run(torch, counters, cfg, params, label, n_prompt, n_decode, cache_dtype,
              want_per_token, want_prefill=None, totals=None) -> bool:
    """A prefill of n_prompt tokens and n_decode greedy tokens through Context
    and generate on the card (the steps replayed from graphs), each step
    checked against an eager transformer.forward of the same inputs on a twin
    cache: logits equal bit for bit, the twin's greedy tokens equal, the
    launches of each replayed step equal the eager step's (and a decode
    token's equal want_per_token, the prefill's want_prefill when given), and
    the two caches equal after the run.  totals (a dict) gains the launches
    of the run's own steps, the twin's apart."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import Sampler, SamplingParams

    ctx = Context(cfg, params, n_ctx=2048, device="cuda", cache_dtype=cache_dtype)
    ck, cv = transformer.init_cache(cfg, 1, 2048, cache_dtype, "cuda")
    prompt = [1] + np.random.default_rng(0).integers(3, cfg.n_vocab, n_prompt - 1).tolist()
    gp = GenerateParams(n_predict=n_decode, ignore_eos=True, sampling=SamplingParams(temp=0.0))
    # the twin's tokens: generate's sampler on the eager logits
    sampler = Sampler(gp.sampling, cfg.n_vocab, gp.seed)
    log = {"steps": 0, "equal": 0, "replayed": 0, "launches_equal": 0, "per_token": {},
           "prefill": None, "twin_tokens": list(prompt)}
    run_eval = ctx.eval

    def checked(tokens, *, logits_all=False):
        captured = len(ctx.graphs())
        _zero(counters)
        got = run_eval(tokens, logits_all=logits_all)
        torch.cuda.synchronize()
        replay = {k: v for k, v in _read(counters).items() if v}
        for k, v in replay.items():
            if totals is not None:
                totals[k] = totals.get(k, 0) + v
        _zero(counters)
        want = eager_step(torch, cfg, ctx.last_call, ck, cv)
        t = np.atleast_2d(tokens).shape[1]
        if log["prefill"] is None:
            log["prefill"] = replay
        want = (want[:, :t] if want.shape[1] > 1 else want).float().cpu().numpy()
        eager = {k: v for k, v in _read(counters).items() if v}
        log["steps"] += 1
        log["equal"] += bool(np.array_equal(got, want))
        if len(ctx.graphs()) == captured:  # this call replayed a graph
            log["replayed"] += 1
            log["launches_equal"] += replay == eager
            if t == 1:
                log["per_token"] = replay
        log["twin_tokens"].append(sampler.sample(want[0, -1], log["twin_tokens"]))
        return got

    ctx.eval = checked
    t0 = time.perf_counter()
    toks = list(generate(ctx, prompt, gp))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del ctx.eval
    same_cache = all(torch.equal(a, b) for a, b in zip(_flat_cache(ctx.cache_k + ctx.cache_v),
                                                       _flat_cache(ck + cv)))
    same_toks = toks == log["twin_tokens"][n_prompt:n_prompt + n_decode] \
        and len(toks) == n_decode
    ok = (log["steps"] == n_decode + 1 and log["equal"] == log["steps"]
          and log["launches_equal"] == log["replayed"] > 0 and same_toks and same_cache
          and log["per_token"] == want_per_token
          and want_prefill in (None, log["prefill"]))
    print(f"graphs: {label} {n_prompt} + {n_decode} through Context + generate ({seconds:.1f} s "
          f"with the eager twin): {log['steps']} steps, {log['replayed']} replayed; logits "
          f"equal to eager forward bit for bit at {log['equal']} of {log['steps']}; greedy "
          f"tokens identical {same_toks}; caches identical {same_cache}; launches equal to "
          f"eager at {log['launches_equal']} of {log['replayed']} replays; a replayed decode "
          f"token {json.dumps(log['per_token'])} (want {json.dumps(want_per_token)}); the "
          f"prefill {json.dumps(log['prefill'])}"
          f"{'' if want_prefill is None else f' (want {json.dumps(want_prefill)})'} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    print(f"graphs: {label} {graph_summary(ctx)}", flush=True)
    return ok


def graph_embed(torch, cfg, params) -> bool:
    """Context.embed of a 100-token prompt and Context.eval_embd of the
    model's own embedding rows of 16 tokens on the card, each replayed (a
    first call captures, reset() zeroes the cache in place), against an
    eager transformer.forward of the same inputs on a zeroed twin cache: the
    hidden state and the logits bit for bit."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    ctx = Context(cfg, params, n_ctx=2048, device="cuda")
    ck, cv = transformer.init_cache(cfg, 1, 2048, device="cuda")
    prompt = [1] + np.random.default_rng(2).integers(3, cfg.n_vocab, 99).tolist()
    ctx.embed(prompt)
    ctx.reset()
    emb = ctx.embed(prompt)
    logits, x = eager_step(torch, cfg, ctx.last_call, ck, cv)
    same = (np.array_equal(emb, x[:, len(prompt) - 1].float().cpu().numpy())
            and np.array_equal(ctx.logits, logits[:, :len(prompt)].float().cpu().numpy())
            and bool(np.isfinite(emb).all()))
    rows = transformer._embed(params, torch.tensor([prompt[:16]], device="cuda")).cpu().numpy()
    for c in _flat_cache(ck + cv):
        c.zero_()
    for _ in range(2):
        ctx.reset()
        got = ctx.eval_embd(rows)
    want = eager_step(torch, cfg, ctx.last_call, ck, cv).float().cpu().numpy()
    same_embd = np.array_equal(got, want) and bool(np.isfinite(got).all())
    graphs = ctx.graphs()
    replayed = [g["key"][0] for g in graphs if g["replays"] == 1] == ["embed", "eval_embd"]
    print(f"graphs: Context.embed of {len(prompt)} tokens and eval_embd of 16 embedding rows, "
          f"each replayed ({replayed}): embed's hidden state [{emb.shape[0]}, {emb.shape[1]}] "
          f"and logits equal to eager forward bit for bit {same}; eval_embd's logits {same_embd}; "
          f"{graph_summary(ctx)}", flush=True)
    return replayed and same and same_embd


def graphs_phase(torch, counters, built=None) -> bool:
    """The compiled step on the card, LLaMA-7B q4_0 (32 layers, built from
    seed 0 unless built gives the weights): 512 + 64 on a bf16 cache (129 K2
    a replayed token), the int8 configuration 128 + 16 on a q8 cache (129 K7
    + 32 K4), and Context.embed and eval_embd (graph_run, graph_embed)."""
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    cfg, params = built or build_llama(device="cuda", seed=0, ftype="q4_0")
    ok = graph_run(torch, counters, cfg, params, "q4_0", 512, 64, torch.bfloat16,
                   {"qmm_q4_0_kfold": 129})
    torch.cuda.empty_cache()
    with env(**INT8):
        ok &= graph_run(torch, counters, cfg, params, "q4_0 int8-config", 128, 16, torch.int8,
                        {"qmm_q8x": 129, "mha_decode": 32})
    torch.cuda.empty_cache()
    ok &= graph_embed(torch, cfg, params)
    torch.cuda.empty_cache()
    return ok


def splits_phase(torch) -> None:
    """The card's clusters at once for each split count (the plan's input),
    then each decode form of GEMV_FORMS at b=1 on each of its 7B shapes,
    timed at every split count 1..8 (the plan forced for the call), beside
    the split count ops/qmm.py::gemv_plan picks: the sweep the plan's choices
    are checked against (tests/test_torch_gemv.py)."""
    from llama_cpp_q_4_0_tpu_torch.ops import qmm
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
    from llama_cpp_q_4_0_tpu_torch.synth import synth_qtensor

    for source in ("qmm_q4_0", "qmm_int8", "qmm_q8x"):
        for rows in (1, 8):
            print(f"splits: {source} rows={rows} clusters at once by split count "
                  f"{json.dumps(qmm._gemv_clusters(source, 0, rows))} "
                  f"(ops/qmm.py H100_GEMV_CLUSTERS {json.dumps(qmm.H100_GEMV_CLUSTERS)}, "
                  f"H100_Q8X_GEMV_CLUSTERS {json.dumps(qmm.H100_Q8X_GEMV_CLUSTERS)})",
                  flush=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    planner = qmm.gemv_plan
    try:
        for name in GEMV_FORMS:
            wrapper, fmt, shapes = KERNEL_SHAPES[name]
            kern = getattr(qmm, wrapper)
            for label, n, k in shapes:
                w = synth_qtensor(gen, n, k, "cuda", GGMLType[fmt])
                x = torch.randn((1, k), generator=gen, device="cuda")
                planes = [w.gscale_t] + ([w.gbias_t] if w.gbias_t is not None else [])
                kw = {"gsize": w.gsize, **({"zero": w.pack_zero} if w.packed else {})}
                row = {}
                for s in range(1, qmm.GEMV_MAX_SPLITS + 1):
                    qmm.gemv_plan = lambda k_, n_, p_, s=s, **_: qmm.GemvPlan(
                        s, k_ // (2 * qmm.GEMV_STEP) if p_ else k_ // qmm.GEMV_STEP)
                    row[s] = round(timer.ms(lambda: kern(x, w.levels_t, *planes, **kw)), 5)
                qmm.gemv_plan = planner
                pick = qmm._gemv_plan(x, n, w.packed, "qmm_q8x" if name.startswith("qmm_q8x")
                                      else None).splits
                print(f"splits: {name} {fmt} {label} N={n} K={k} b=1 ms by splits "
                      f"{json.dumps(row)} fastest={min(row, key=row.get)} plan={pick}",
                      flush=True)
    finally:
        qmm.gemv_plan = planner


# the decode paths whose device-busy step the ``busy`` phase profiles, as
# (file type, int8 configuration: QMM_Q8X=1 FUSED_ATTN=1 on a q8 cache)
BUSY_PATHS = (("q4_0", False), ("q4_K_M", False), ("q3_K_M", False), ("q5_K_M", False),
              ("q4_0", True))
# (kv_window, n_past) of each profiled step: the int8 configuration also at
# the long window, where K4 reads 1,900 slots a layer
BUSY_WINDOWS = {False: ((256, 65),), True: ((256, 65), (2048, 1900))}


def busy_phase(torch) -> None:
    """Each of BUSY_PATHS at LLaMA-7B (32 layers, synthetic weights from seed
    0): decode ms/token (median of 3 passes of 16 tokens) and one profiled
    decode step (trace_decode: device busy and kernels a step) at each of
    its BUSY_WINDOWS.  A copy of this script beside an older checkout's
    package measures that one, for an A/B of the decode forms in one call."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    for ftype, int8 in BUSY_PATHS:
        cfg, params = build_llama(device="cuda", seed=0, ftype=ftype)
        ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, device="cuda",
                                        **({"dtype": torch.int8} if int8 else {}))
        label = f"LLaMA-7B {ftype}{' int8-config' if int8 else ''}"
        with env(**(INT8 if int8 else {})):
            for window, n_past in BUSY_WINDOWS[int8]:
                med, _ = decode_ms(torch, cfg, params, ck, cv, n_past, window, n_tok=16,
                                   passes=3)
                trace_decode(torch, cfg, params, ck, cv, med, label, window, n_past)
        del params, ck, cv
        torch.cuda.empty_cache()


def two_layer_vs_cpu(torch, counters, ftype="q4_0", *, int8=False, want_per_token=None,
                     planes=None, gate_cpu=True, build=None, frac=None, probe=False,
                     **widths):
    """7B width, 2 layers: prefill 128 (prefill kernels, flash, decode-form
    head) and decode steps on the card against the plain versions on the
    CPU from the same weights, the card's greedy tokens fed to both; the
    card's launches of the run and of its last decode step print.  In Q4_K_M
    layer 1 takes q6_K for wv and w2 (use_more_bits(1, 2)), so K5 and K6
    both run.  int8: the int8 configuration (QMM_Q8X=1, FUSED_ATTN=1) on an
    f32 cache, so that K7 (b=128, b=1), K3 and K4 (3 decode steps past slot
    128, window 256) run on the card and K7's plain version and the f32
    attention chain on the CPU; each must launch.  widths: other build_llama
    widths (n_vocab, n_ff); want_per_token: the launches the last decode step
    must make.  planes: "f16" runs both sides under QMM_F16_SCALES=1 (the
    Context casts), "bf16" gives both cast_scales_bf16's weights; the card
    then also runs the weights on f32 planes of the same values, whose
    logits must equal the 2-byte planes' bit for bit.  gate_cpu False: the
    CPU agreement is printed, not held (Q8_0_CHAOS).  build: another
    family's synth builder (default build_llama).  frac: the limit as a
    fraction of the CPU's logit scale (default below).  probe: the CPU also
    runs with every layer's attention-norm weight moved by 1e-6 of its value
    (seeded), and that run's departure from the CPU's prints beside the
    card's: how far the model itself carries a difference of an ulp or so.
    Returns (ok, the card's launches of the run)."""
    import dataclasses

    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import _map_qtensors, cast_scales_bf16
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    label = f"{ftype}{' int8 config' if int8 else ''}{f' {planes} planes' if planes else ''}" \
        + "".join(f" {k}={v}" for k, v in widths.items())
    cfg, params = (build or build_llama)(n_layer=2, device="cuda", seed=1, ftype=ftype,
                                         **widths)
    if build is not None:
        label = f"{cfg.arch} {label}"
    f32 = params  # synth's block-format planes are fp16 values already
    if planes == "bf16":
        params = cast_scales_bf16(params)
        f32 = _map_qtensors(params, f32_planes)
    cpu = _params_to(params, "cpu")
    prompt = [1] + np.random.default_rng(1).integers(3, 32000, 127).tolist()
    steps = 3 if int8 else 1
    ok, outs, toks = True, {}, []
    switches = INT8 if int8 else {}
    runs = [("cuda", params, {**switches, **({"QMM_F16_SCALES": "1"} if planes == "f16"
                                             else {})})]
    runs.append(("cpu", cpu, runs[0][2]))
    if probe:
        gen = torch.Generator().manual_seed(3)
        moved = tuple(dataclasses.replace(blk, attn_norm_w=blk.attn_norm_w * (
            1 + 1e-6 * torch.randn(blk.attn_norm_w.shape, generator=gen)))
            for blk in cpu.blocks)
        runs.append(("cpu moved", dataclasses.replace(cpu, blocks=moved), runs[0][2]))
    if planes:
        runs.append(("cuda f32 planes", f32, switches))
    for run, p, sw in runs:
        dev = run.split()[0]
        with env(**sw):
            if run == "cuda":
                _zero(counters)
            ctx = Context(cfg, p, n_ctx=256, device=dev,
                          cache_dtype=torch.float32 if int8 else torch.bfloat16)
            outs[run] = [ctx.eval(prompt)]
            for i in range(steps):
                if run == "cuda":
                    toks.append(int(np.argmax(outs[run][-1][0, -1])))
                    if i == steps - 1:  # the last decode step counted alone
                        torch.cuda.synchronize()
                        launched = _read(counters)
                        _zero(counters)
                outs[run].append(ctx.eval([[toks[i]]]))
            if run == "cuda":
                torch.cuda.synchronize()
                per_token = {k: v for k, v in _read(counters).items() if v}
                launched = {k: v + per_token.get(k, 0) for k, v in launched.items() if
                            v + per_token.get(k, 0)}
    print(f"e2e: 2-layer {label} launches on the card {json.dumps(launched)}; last decode "
          f"step {json.dumps(per_token)}", flush=True)
    if planes:
        same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cuda f32 planes"]))
        ok &= same
        print(f"e2e: 2-layer {label} logits on the card equal to f32 planes of the same "
              f"values: {same}", flush=True)
    if int8:
        ok &= all(launched.get(k, 0) > 0 for k in ("qmm_q8x", "mha_decode", "flash_prefill"))
    if want_per_token is not None and per_token != want_per_token:
        print(f"e2e: 2-layer {label} decode launches {per_token} != {want_per_token}",
              flush=True)
        ok = False
    # bf16: the rounding of activations can flip at one ulp when sums differ
    # in order, well under 2% of the logits through 2 layers; int8 on q4_0:
    # the f32 chain, where only a q8 roundf tie that an ulp moves can flip
    # (1e-3); int8 on a k-quant mix keeps K5 and K6's bf16 products (2e-2)
    if frac is None:
        frac = 1e-3 if int8 and ftype == "q4_0" else 2e-2
    for i, (g, r) in enumerate(zip(outs["cuda"], outs["cpu"])):
        err = float(np.abs(g - r).max())
        tol = frac * float(np.abs(r).max())
        good = err <= tol and np.isfinite(g).all()
        if gate_cpu:
            ok &= bool(good)
            verdict = "ok" if good else "MISMATCH"
        else:
            ok &= bool(np.isfinite(g).all())
            verdict = f"printed, not held: {Q8_0_CHAOS}"
        width = "" if build else "7B-width "
        moved = (f"; the CPU with its norm weights moved by 1e-6 vs the CPU: "
                 f"{float(np.abs(outs['cpu moved'][i] - r).max()):.3e}" if probe else "")
        print(f"e2e: 2-layer {width}{label} {'prefill-128' if i == 0 else 'decode'} "
              f"card vs CPU plain: max_abs_err={err:.3e} (tol {tol:.3e}){moved} {verdict}",
              flush=True)
    return ok, launched


def q4_0_planes(torch, counters, cfg, params, toks32, launches) -> str | None:
    """7B q4_0 on 2-byte planes, on the weights of the f32-plane run (its
    synthetic scales are fp16 values, as a file's), the Context casting them:
    under QMM_F16_SCALES=1 a 512-token prefill (128 K1 launches) and 64
    greedy decode steps (129 K2 a token) whose tokens must equal toks32, the
    f32-plane run's; with QMM_ZERO_FOLD=1 also, a 128-token prefill on the
    raw view (128 K1) and 16 steps on the folded one (129 K5 a token); in the
    int8 configuration on f16 planes, 128 + 16 (129 K7 and 32 K4 a token).
    Each prints its decode bound from its own plane bytes, and the f32, f16
    and folded f16 weights' decode steps are profiled in turn (device busy)
    with the f16 host-clock median beside.  Returns a failure, or None."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import cast_scales_f16, fold_zero_points

    f16 = {"QMM_F16_SCALES": "1"}
    with env(**f16):
        ok, path, per_token, *_, toks = end_to_end(torch, counters, "q4_0", path="q4_0_f16",
                                                   built=(cfg, params))
    if not ok or per_token != {"qmm_q4_0_kfold": 129} or path["qmm_q4_0"] != 128:
        return (f"q4_0 on f16 planes: non-finite logits, a kernel of the path never "
                f"launched, or launches {path} (per decode token {per_token})")
    same = sum(a == b for a, b in zip(toks, toks32))
    print(f"e2e: q4_0_f16 greedy tokens equal to the f32-plane run's: {same} of "
          f"{len(toks32)}", flush=True)
    if toks != toks32:
        return "q4_0 on f16 planes: greedy tokens differ from the f32-plane run's"
    launches["qmm_q4_0/f16"] = path["qmm_q4_0"]
    launches["qmm_q4_0_kfold/f16"] = path["qmm_q4_0_kfold"]
    with env(**f16, QMM_ZERO_FOLD="1"):
        ok, path, per_token, *_ = end_to_end(torch, counters, "q4_0", n_prompt=128,
                                             n_decode=16, path="q4_0_f16_fold",
                                             built=(cfg, params))
    if not ok or per_token != {"qmm_packed_bias": 129} or path["qmm_q4_0"] != 128:
        return (f"q4_0 on folded f16 planes: non-finite logits, a kernel of the path "
                f"never launched, or launches {path} (per decode token {per_token})")
    launches["qmm_packed_bias/f16"] = path["qmm_packed_bias"]
    with env(**INT8, **f16):
        ok, path, per_token, *_ = end_to_end(torch, counters, "q4_0", n_prompt=128,
                                             n_decode=16, path="q4_0_int8_f16",
                                             cache_dtype=torch.int8, built=(cfg, params))
    if not ok or per_token != {"qmm_q8x": 129, "mha_decode": 32}:
        return (f"q4_0 int8 configuration on f16 planes: non-finite logits, a kernel of "
                f"the path never launched, or decode launches {per_token}")
    launches["qmm_q8x/f16"] = path["qmm_q8x"]
    p16 = cast_scales_f16(params)
    folded = fold_zero_points(p16)
    model_bounds("LLaMA-7B q4_0 f16 planes", p16, cfg.n_layer)
    model_bounds("LLaMA-7B q4_0 folded f16 planes", folded, cfg.n_layer)
    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, device="cuda")
    med, runs = decode_ms(torch, cfg, p16, ck, cv, 65, 256)
    print(f"bench: q4_0 f16 planes decode_ms_per_token (kv_window 256) median={med:.3f} "
          f"runs={[round(v, 3) for v in runs]}", flush=True)
    for label, p in (("q4_0 f32 planes", params), ("q4_0 f16 planes", p16),
                     ("q4_0 folded f16 planes", folded)):
        trace_decode(torch, cfg, p, ck, cv, med if p is p16 else None, label)
    return None


def q3_k_m_bf16(torch, counters, cfg, params, launches) -> str | None:
    """7B Q3_K_M after cast_scales_bf16 (every plane bf16, not exact): a
    128-token prefill (96 K1 and 96 K5 tile launches) and 16 decode steps (96
    K2 + 96 K5 + 1 K6 a token), its decode bound from bf16 plane bytes, and
    the f32 and bf16 weights' decode steps profiled in turn beside the bf16
    host-clock median.  Returns a failure, or None."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import cast_scales_bf16

    pb = cast_scales_bf16(params)
    ok, path, per_token, *_ = end_to_end(torch, counters, "q3_K_M", n_prompt=128,
                                         n_decode=16, path="q3_K_M_bf16", built=(cfg, pb))
    if not ok or per_token != Q3KM_PER_TOKEN or path["qmm_q4_0"] != 96:
        return (f"q3_K_M on bf16 planes: non-finite logits, a kernel of the path never "
                f"launched, or launches {path} (per decode token {per_token})")
    for form, kernel in (("qmm_q4_0/bf16", "qmm_q4_0"),
                         ("qmm_q4_0_kfold/bf16", "qmm_q4_0_kfold"),
                         ("qmm_packed_bias/bf16", "qmm_packed_bias"),
                         ("qmm_int8/bf16", "qmm_int8")):
        launches[form] = path[kernel]
    model_bounds("LLaMA-7B q3_K_M bf16 planes", pb, cfg.n_layer)
    ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, device="cuda")
    med, runs = decode_ms(torch, cfg, pb, ck, cv, 65, 256)
    print(f"bench: q3_K_M bf16 planes decode_ms_per_token (kv_window 256) median={med:.3f} "
          f"runs={[round(v, 3) for v in runs]}", flush=True)
    for label, p in (("q3_K_M f32 planes", params), ("q3_K_M bf16 planes", pb)):
        trace_decode(torch, cfg, p, ck, cv, med if p is pb else None, label)
    return None


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
        out_norm_w=mv(params.out_norm_w), out_norm_b=mv(params.out_norm_b),
        output=mv(params.output))


def write_ggjt_7b_width(path: str, ftype: str = "q4_0"):
    """GGJT file at 7B width, 2 layers: random block bytes with small finite
    fp16 scales, f32 norms of one, a 32000-entry vocab.  q4_0: every 2-D
    weight q4_0.  Q4_K_M: q4_K blocks, q6_K for the output head and for wv
    and w2 of layer 1 (use_more_bits(1, 2)).  Q3_K_M: q3_K blocks for the
    token embeddings, wq, wk, w1 and w3, q4_K for wv, wo and w2, q6_K for the
    output head."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import GGJTWriter
    from llama_cpp_q_4_0_tpu_torch.quant.types import (BLOCK_Q3_K, BLOCK_Q4_0,
                                                       BLOCK_Q4_K, BLOCK_Q6_K,
                                                       GGMLType, LlamaFType)

    n_vocab, e, n_ff, n_head, n_layer = 32000, 4096, 11008, 32, 2
    rng = np.random.default_rng(3)

    def q3_k(n, k):
        blk = np.empty(n * k // 256, BLOCK_Q3_K)
        blk["d"] = rng.uniform(0.5e-4, 1.5e-4, blk.shape).astype(np.float16)
        blk["hmask"] = rng.integers(0, 256, (blk.shape[0], 32), dtype=np.uint8)
        blk["qs"] = rng.integers(0, 256, (blk.shape[0], 64), dtype=np.uint8)
        blk["scales"] = rng.integers(0, 256, (blk.shape[0], 12), dtype=np.uint8)
        return blk

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

    def qtype_of(name):
        if ftype == "q4_0":
            return GGMLType.Q4_0
        if name == "output.weight":
            return GGMLType.Q6_K
        if ftype == "Q4_K_M":
            return (GGMLType.Q6_K if name in ("layers.1.attention.wv.weight",
                                              "layers.1.feed_forward.w2.weight")
                    else GGMLType.Q4_K)
        return (GGMLType.Q4_K if any(f in name for f in ("attention.wv", "attention.wo",
                                                        "feed_forward.w2"))
                else GGMLType.Q3_K)

    blocks = {GGMLType.Q4_0: q4, GGMLType.Q3_K: q3_k, GGMLType.Q4_K: q4_k,
              GGMLType.Q6_K: q6_k}
    file_type = {"q4_0": LlamaFType.MOSTLY_Q4_0, "Q4_K_M": LlamaFType.MOSTLY_Q4_K_M,
                 "Q3_K_M": LlamaFType.MOSTLY_Q3_K_M}[ftype]
    with GGJTWriter(path, "llama", hp, int(file_type), vocab) as w:
        def emit(name, n, k):
            qt = qtype_of(name)
            w.write_tensor(name, qt, (k, n), blocks[qt](n, k))

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
            ok &= embedding_cli(path, prompt, counters)
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def embedding_cli(path: str, prompt: str, counters) -> bool:
    """The `embedding` tool on the file: one line of n_embd finite values
    (summarised here; the line itself is 4096 numbers), its decode-shaped
    step replayed from a graph must launch K2."""
    import contextlib
    import io

    from llama_cpp_q_4_0_tpu_torch.cli import embedding as embedding_cli_mod

    out = io.StringIO()
    _zero(counters)
    with contextlib.redirect_stdout(out):
        rc = embedding_cli_mod.main(["-m", path, "-p", prompt, "-c", "256",
                                     "--device", "cuda"])
    launched = {k: v for k, v in _read(counters).items() if v}
    vals = [float(v) for v in out.getvalue().splitlines()[0].split()] if rc == 0 else []
    ok = (rc == 0 and len(vals) == 4096 and all(v == v and abs(v) != float("inf")
                                                 for v in vals)
          and launched.get("qmm_q4_0_kfold", 0) > 0)
    print(f"cli: embedding -p {prompt!r}: rc={rc}, {len(vals)} values, first "
          f"{[round(v, 6) for v in vals[:4]]}; launches {json.dumps(launched)} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


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


def _traced_forward(torch, cfg, params, tokens, n_past, ck, cv, window, attention_fn, rec):
    """transformer.forward's LLaMA body for a last_only call (fused wqkv and
    gate/up), the same ops in the same order, each op's output kept in rec
    as f64 on the CPU."""
    import math

    from llama_cpp_q_4_0_tpu_torch.models import transformer as tf
    from llama_cpp_q_4_0_tpu_torch.ops.layers import attention, rms_norm, rope, silu

    def keep(name, v):
        rec[name] = v.double().cpu()
        return v

    b, t = tokens.shape
    dev = tokens.device
    n = torch.full((), n_past, dtype=torch.int64, device=dev)
    pos = (n + torch.arange(t, device=dev, dtype=torch.int64))[None, :].expand(b, t)
    kv_mask = (torch.arange(window, device=dev) < n + t)[None, :].expand(b, window)
    slots = tf._insert_slots(n, ck[0].shape[1], t)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = keep("embed", tf._embed(params, tokens))
    for i, blk in enumerate(params.blocks):
        h = keep(f"L{i} attn_norm", rms_norm(x, blk.attn_norm_w, cfg.norm_eps))
        q, k, v = tf._qkv(cfg, blk, h, b, t)
        keep(f"L{i} v", v)
        q = keep(f"L{i} q roped", rope(q, pos, cfg.n_rot, neox=cfg.rope_neox,
                                       base=cfg.rope_base))
        k = keep(f"L{i} k roped", rope(k, pos, cfg.n_rot, neox=cfg.rope_neox,
                                       base=cfg.rope_base))
        tf._cache_insert(ck[i], k, slots)
        tf._cache_insert(cv[i], v, slots)
        if attention_fn is not None:
            a = attention_fn(q.contiguous(), tf._roundtrip(ck[i], k),
                             tf._roundtrip(cv[i], v), scale)
        else:
            a = attention(q, tf._kv_view(ck[i], window), tf._kv_view(cv[i], window), pos,
                          kv_mask, scale)
        keep(f"L{i} attention", a)
        o = keep(f"L{i} wo", tf._mm(a.reshape(b, t, cfg.n_embd), blk.wo, cfg))
        x = keep(f"L{i} x+attn", x + o)
        h = keep(f"L{i} ffn_norm", rms_norm(x, blk.ffn_norm_w, cfg.norm_eps))
        gu = keep(f"L{i} gate/up", tf._mm(h, blk.w_gateup, cfg))
        f = gu.shape[-1] // 2
        inner = keep(f"L{i} silu*up", silu(gu[..., :f]) * gu[..., f:])
        x = keep(f"L{i} x+ffn", x + keep(f"L{i} w2", tf._mm(inner, blk.w_down, cfg)))
    x = keep("out_norm", rms_norm(x[:, -1:], params.out_norm_w, cfg.norm_eps))
    return keep("logits", tf._mm(x, params.output, cfg))


def _f64_forward(torch, cfg, params, tokens, n_past, kc, vc, rec):
    """The same LLaMA in f64 on the CPU from the same weights (params on the
    CPU; kc, vc f64 caches): the roundings of the bf16 compute kept (x and
    the dequantized weight rounded to bf16 before each product, K/V stored
    as bf16), every sum, norm, rotation and softmax in f64, attention exact
    (q and the probabilities not rounded, as the card's K3 keeps them f32)."""
    import math

    f64 = torch.float64

    def bf(a):
        return a.to(torch.bfloat16).to(f64)

    def keep(name, v):
        rec[name] = v
        return v

    def mm(x, w):
        n, k = w.shape
        deq = (w.levels_full().float().reshape(-1, w.gsize, n)
               * w.gscale_full()[:, None, :]).reshape(k, n)
        out = bf(x) @ bf(deq)
        gb = w.gbias_full()
        if gb is not None:
            out = out + x.reshape(*x.shape[:-1], -1, w.gsize).sum(-1) @ gb.double()
        return out

    def norm(x, w):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps) * w.double()

    def rope(x, pos):  # adjacent pairs over the whole head (LLaMA)
        half = cfg.n_rot // 2
        freqs = cfg.rope_base ** (-torch.arange(half, dtype=f64) * 2.0 / cfg.n_rot)
        th = pos.double()[..., None, None] * freqs
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * th.cos() - x1 * th.sin(), x0 * th.sin() + x1 * th.cos()],
                           dim=-1).reshape(x.shape)

    if cfg.rope_neox or cfg.n_rot != cfg.head_dim:
        raise NotImplementedError("the f64 forward rotates adjacent pairs over whole heads")
    b, t = tokens.shape
    hq, g, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    pos = (n_past + torch.arange(t))[None, :].expand(b, t)
    s = n_past + t
    causal = torch.arange(s)[None, :] <= pos[0][:, None]  # [t, s]
    x = keep("embed", params.tok_embeddings.rows(tokens).double())
    for i, blk in enumerate(params.blocks):
        h = keep(f"L{i} attn_norm", norm(x, blk.attn_norm_w))
        qkv = mm(h, blk.wqkv)
        e, kvd = hq * hd, g * hd
        q = qkv[..., :e].reshape(b, t, hq, hd)
        k = qkv[..., e:e + kvd].reshape(b, t, g, hd)
        v = keep(f"L{i} v", qkv[..., e + kvd:].reshape(b, t, g, hd))
        q = keep(f"L{i} q roped", rope(q, pos))
        k = keep(f"L{i} k roped", rope(k, pos))
        kc[i][:, n_past:s] = bf(k)
        vc[i][:, n_past:s] = bf(v)
        qg = q.reshape(b, t, g, hq // g, hd)
        sc = torch.einsum("btgrd,bsgd->bgrts", qg, kc[i][:, :s]) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
        a = keep(f"L{i} attention", torch.einsum("bgrts,bsgd->btgrd", p, vc[i][:, :s])
                 .reshape(b, t, hq, hd))
        x = keep(f"L{i} x+attn", x + keep(f"L{i} wo", mm(a.reshape(b, t, e), blk.wo)))
        h = keep(f"L{i} ffn_norm", norm(x, blk.ffn_norm_w))
        gu = keep(f"L{i} gate/up", mm(h, blk.w_gateup))
        f = gu.shape[-1] // 2
        inner = keep(f"L{i} silu*up", gu[..., :f] * torch.sigmoid(gu[..., :f]) * gu[..., f:])
        x = keep(f"L{i} x+ffn", x + keep(f"L{i} w2", mm(inner, blk.w_down)))
    x = keep("out_norm", norm(x[:, -1:], params.out_norm_w))
    return keep("logits", mm(x, params.output))


def q8chaos_phase(torch) -> None:
    """Where the 2-layer q8_0 model's card-vs-CPU gap comes from (ROADMAP
    queue 3): its model, seed, prompt and 2e-2 limit as two_layer_vs_cpu
    runs it (on f32 planes, whose logits the run's f16 planes equal bit for
    bit), a 128-token prefill and one decode step (the card's greedy token),
    run three times: on the card and in the CPU's plain f32 path (each
    through _traced_forward, whose card logits must equal forward's bit for
    bit), and in f64 on the CPU (_f64_forward).  Each op's largest departure
    of the card and of the CPU from f64 is printed, with the card's from the
    CPU, beside the op's f64 scale.  Printed, not gated."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import flash_prefill
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    cfg, params = build_llama(n_layer=2, device="cuda", seed=1, ftype="q8_0")
    cpu = _params_to(params, "cpu")
    prompt = [1] + np.random.default_rng(1).integers(3, 32000, 127).tolist()
    n_ctx, hd = 256, cfg.head_dim
    ck, cv = transformer.init_cache(cfg, 1, n_ctx, device="cuda")
    cpu_k, cpu_v = transformer.init_cache(cfg, 1, n_ctx, device="cpu")
    ref_k, ref_v = transformer.init_cache(cfg, 1, n_ctx, device="cuda")
    f64_k = [torch.zeros((1, n_ctx, cfg.kv_heads, hd), dtype=torch.float64)
             for _ in range(cfg.n_layer)]
    f64_v = [torch.zeros_like(c) for c in f64_k]
    steps = {}
    tok = None
    for step, toks, n_past, window in (("prefill-128", prompt, 0, 128),
                                       ("decode", None, 128, 256)):
        toks = toks or [tok]
        card, cpu32, exact = {}, {}, {}
        x = torch.tensor([toks])
        got = _traced_forward(torch, cfg, params, x.cuda(), n_past, ck, cv, window,
                              flash_prefill if n_past == 0 else None, card)
        want = transformer.forward(cfg, params, x.cuda(), n_past, ref_k, ref_v,
                                   last_only=True, kv_window=window,
                                   attention_fn=flash_prefill if n_past == 0 else None)
        _traced_forward(torch, cfg, cpu, x, n_past, cpu_k, cpu_v, window, None, cpu32)
        _f64_forward(torch, cfg, cpu, x, n_past, f64_k, f64_v, exact)
        tok = int(got[0, -1].argmax())
        steps[step] = (card, cpu32, exact)
        lg, lc = card["logits"], cpu32["logits"]
        print(f"q8chaos: {step} traced card logits equal to forward's bit for bit: "
              f"{torch.equal(got, want)}; card vs CPU max_abs_err "
              f"{float((lg - lc).abs().max()):.3e} (limit 2e-2 of the CPU's scale, "
              f"{2e-2 * float(lc.abs().max()):.3e})", flush=True)
    for step, (card, cpu32, exact) in steps.items():
        louder = []
        for op, ref in exact.items():
            a = float((card[op] - ref).abs().max())
            c = float((cpu32[op] - ref).abs().max())
            d = float((card[op] - cpu32[op]).abs().max())
            m = float(ref.abs().max())
            if a > 2 * c and a > 1e-6 * m:
                louder.append(f"{op} ({a / m:.1e} of its scale)")
            print(f"q8chaos: {step:11s} {op:14s} card-f64 {a:.3e}  cpu32-f64 {c:.3e}  "
                  f"card-cpu32 {d:.3e}  |f64| {m:.3e}", flush=True)
        print(f"q8chaos: {step} ops where the card departs from f64 by more than twice the "
              f"CPU's: {louder or 'none'} (the matmul kernels' limit against their plain "
              f"versions: 1e-3 of the output scale)", flush=True)
    del params, cpu, ck, cv, ref_k, ref_v
    torch.cuda.empty_cache()


# ------------------------------------------------------------ on-device decode

GREEDY_DS = dict(temp=-1.0)
SAMPLED_DS = dict(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1)


def _host_sampling(ds):
    """The host Sampler's settings for a DeviceSampling (no penalty unless
    the DeviceSampling has one)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    return SamplingParams(temp=ds.temp, top_k=ds.top_k, top_p=ds.top_p,
                          repeat_penalty=ds.repeat_penalty,
                          repeat_last_n=ds.repeat_last_n,
                          frequency_penalty=ds.frequency_penalty,
                          presence_penalty=ds.presence_penalty)


def checked_chunks(torch, counters, ctx, ck, cv, log):
    """Wrap ctx.decode_chunk: every chunk is also run by the eager
    device_sample.decode_chunk on the twin caches ck, cv from the same
    inputs (the twin takes the Context's caches at the first chunk, after
    the prefill); tokens, key, recent window, mu and the chunk's final
    n_past must equal bit for bit, and the caches after the run (the caller
    compares them).  The launches of each chunk are counted alone, the
    twin's apart.  Returns the function that takes the wrapper off."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime import device_sample

    real = ctx.decode_chunk

    def checked(tok, n_past, key, **kw):
        if log["chunks"] == 0:
            for a, b in zip(_flat_cache(ck + cv), _flat_cache(ctx.cache_k + ctx.cache_v)):
                a.copy_(b)
        captured = len(ctx.graphs())
        _zero(counters)
        got = real(tok, n_past, key, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _read(counters).items() if v}
        _zero(counters)
        want = device_sample.decode_chunk(ctx.cfg, ctx.params, tok, n_past, ck, cv, key, **kw)
        torch.cuda.synchronize()
        n_end = torch.as_tensor(n_past, device="cuda") + kw["n_steps"]
        same = (np.array_equal(got[0], want[0].cpu().numpy())
                and all(torch.equal(a, b) for a, b in zip(got[1:], want[3:]))
                and torch.equal(ctx.last_chunk.n_past, n_end))
        log["chunks"] += 1
        log["equal"] += same
        log["replayed"] += len(ctx.graphs()) == captured
        log["per_token"] = {k: v // kw["n_steps"] for k, v in launched.items()}
        log["whole"] &= all(v % kw["n_steps"] == 0 for v in launched.values())
        log["windows"].add(kw["kv_window"])
        return got

    ctx.decode_chunk = checked

    def off():
        del ctx.decode_chunk

    return off


def ondevice_run(torch, counters, cfg, params, label, ds_kw, n_prompt, n_decode, chunk,
                 cache_dtype, want_per_token, path_kernels, seed=0, host=False):
    """generate_ondevice on a 7B-class model (Context on the card, n_ctx 2048): a
    prefill of n_prompt tokens, then chunks of chunk tokens, each replayed
    chunk against its eager twin (checked_chunks), the caches equal after
    the run and launches a token want_per_token.  Then the same call again
    with the launch counts set to 0 just before and read just after (the
    path's own run: each of path_kernels must launch), whose tokens must
    equal the first run's (the same key).  host: print how many greedy
    tokens agree with the host loop (generate) before the first difference.
    Returns (ok, tokens)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import (DeviceSampling,
                                                                 generate_ondevice)
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate

    ds = DeviceSampling(**ds_kw)
    ctx = Context(cfg, params, n_ctx=2048, device="cuda", cache_dtype=cache_dtype)
    ck, cv = transformer.init_cache(cfg, 1, 2048, cache_dtype, "cuda")
    prompt = [1] + np.random.default_rng(0).integers(3, cfg.n_vocab, n_prompt - 1).tolist()
    log = {"chunks": 0, "equal": 0, "replayed": 0, "per_token": {}, "whole": True,
           "windows": set()}
    off = checked_chunks(torch, counters, ctx, ck, cv, log)
    t0 = time.perf_counter()
    toks = generate_ondevice(ctx, prompt, n_decode, sampling=ds, seed=seed, chunk=chunk,
                             eos_token=-1)
    seconds = time.perf_counter() - t0
    off()
    same_cache = all(torch.equal(a, b) for a, b in zip(_flat_cache(ctx.cache_k + ctx.cache_v),
                                                       _flat_cache(ck + cv)))
    del ck, cv
    n_past = ctx.n_past
    ctx.reset()
    _zero(counters)
    again = generate_ondevice(ctx, prompt, n_decode, sampling=ds, seed=seed, chunk=chunk,
                              eos_token=-1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read(counters).items() if v}
    ok = (len(toks) == n_decode and log["equal"] == log["chunks"] > 0
          and log["replayed"] > 0 and log["whole"] and same_cache
          and log["per_token"] == want_per_token and again == toks
          and n_past == ctx.n_past == n_prompt + (n_decode - 1 + chunk - 1) // chunk * chunk
          and all(launches.get(k, 0) > 0 for k in path_kernels))
    print(f"ondevice: {label} generate_ondevice {n_prompt} + {n_decode} (chunk {chunk}, kv_window "
          f"{sorted(log['windows'])}; {seconds:.1f} s with the eager twin): {log['chunks']} "
          f"chunks, {log['replayed']} replayed whole; tokens, key, recent, mu and n_past equal to "
          f"the eager decode_chunk bit for bit at {log['equal']} of {log['chunks']}; caches "
          f"identical {same_cache}; a token's launches {json.dumps(log['per_token'])} (want "
          f"{json.dumps(want_per_token)}); the same key again gives the same tokens "
          f"{again == toks}; the path's launches {json.dumps(launches)} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if host:
        ctx.reset()
        gp = GenerateParams(n_predict=n_decode, ignore_eos=True, sampling=_host_sampling(ds))
        ref = list(generate(ctx, prompt, gp))
        agree = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b), len(toks))
        print(f"ondevice: {label} greedy tokens agreeing with the host loop (generate, window "
              f"of each token's own bucket) before the first difference: {agree} of "
              f"{len(toks)}", flush=True)
    print(f"ondevice: {label} {graph_summary(ctx)}", flush=True)
    del ctx
    torch.cuda.empty_cache()
    return ok, toks


def ondevice_rows(torch, cfg, params) -> bool:
    """B=2 at n_past [100, 140] (each row's prompt prefilled alone at B=1,
    the two caches copied into the rows of a B=2 Context), greedy rows of a
    SamplingVec, row 1 banning the token it would pick first: a chunk of 16
    on the card (replays) against the eager decode_chunk on a twin, tokens
    and caches bit for bit; the banned token never appears; the first step's
    logits of each row (a per-row forward at window 256) against that row
    alone at B=1 at the same window, also with FUSED_ATTN=1 (K4 at the rows'
    own positions, one launch a layer): the largest differences printed and
    held under 2e-2 of the logit scale, the first tokens equal to the alone
    rows' greedy picks."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops import mha_decode as md
    from llama_cpp_q_4_0_tpu_torch.runtime import device_sample as dsm
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    rng = np.random.default_rng(3)
    starts = (100, 140)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, n - 1).tolist() for n in starts]
    ctx = Context(cfg, params, n_ctx=512, batch=2, device="cuda")
    firsts = []
    for r, prompt in enumerate(prompts):
        solo = Context(cfg, params, n_ctx=512, device="cuda")
        firsts.append(int(np.argmax(solo.eval(prompt)[0, -1])))
        for a, b in zip(_flat_cache(ctx.cache_k + ctx.cache_v),
                        _flat_cache(solo.cache_k + solo.cache_v)):
            a[r].copy_(b[0])
        del solo
    tok = torch.tensor(firsts, device="cuda")
    n_past = torch.tensor(starts, device="cuda")
    window = 256
    # the first step's logits: a per-row forward against each row alone
    twin = [[c.clone() for c in cs] for cs in (ctx.cache_k, ctx.cache_v)]
    both = transformer.forward(cfg, ctx.params, tok[:, None], n_past, *twin, last_only=True,
                               kv_window=window)[:, -1].float()
    alone = []
    for r in range(2):
        rows = [[c[r:r + 1].clone() for c in cs] for cs in (ctx.cache_k, ctx.cache_v)]
        alone.append(transformer.forward(cfg, ctx.params, tok[r:r + 1, None], starts[r], *rows,
                                         last_only=True, kv_window=window)[0, -1].float())
    alone = torch.stack(alone)
    diff = float((both - alone).abs().max())
    scale = float(alone.abs().max())
    # the same under FUSED_ATTN=1: K4 takes the two rows' own positions
    with env(FUSED_ATTN="1"):
        md.launches["mha_decode"] = 0
        both4 = transformer.forward(cfg, ctx.params, tok[:, None], n_past,
                                    *[[c.clone() for c in cs] for cs in (ctx.cache_k, ctx.cache_v)],
                                    last_only=True, kv_window=window)[:, -1].float()
        k4 = md.launches["mha_decode"]
        alone4 = torch.stack([transformer.forward(
            cfg, ctx.params, tok[r:r + 1, None], starts[r],
            *[[c[r:r + 1].clone() for c in cs] for cs in (ctx.cache_k, ctx.cache_v)],
            last_only=True, kv_window=window)[0, -1].float() for r in range(2)])
    diff4 = float((both4 - alone4).abs().max())
    banned = int(alone[1].argmax())
    second = alone[1].clone()
    second[banned] = float("-inf")
    want_first = [int(alone[0].argmax()), int(second.argmax())]
    neutral = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    ban = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0,
                         logit_bias={banned: float("-inf")})
    sv = dsm.make_sampling_vec([neutral, ban], device="cuda")
    recent = dsm.make_recent([p + [f] for p, f in zip(prompts, firsts)], dsm.VEC_WINDOW,
                             cfg.n_vocab, device="cuda")
    ds = dsm.DeviceSampling(temp=-1.0)
    key = dsm.prng_key(5, "cuda")
    twin = [[c.clone() for c in cs] for cs in (ctx.cache_k, ctx.cache_v)]
    kw = dict(n_steps=16, ds=ds, kv_window=window, recent=recent, sv=sv)
    got, key2, rec2, _ = ctx.decode_chunk(tok, n_past, key, **kw)
    want = dsm.decode_chunk(cfg, ctx.params, tok, n_past, *twin, key, **kw)
    same = (np.array_equal(got, want[0].cpu().numpy()) and torch.equal(key2, want[3])
            and torch.equal(rec2, want[4])
            and torch.equal(ctx.last_chunk.n_past, n_past + 16)
            and all(torch.equal(a, b) for a, b in zip(
                _flat_cache(ctx.cache_k + ctx.cache_v), _flat_cache(twin[0] + twin[1]))))
    no_ban = banned not in got[1].tolist()
    first_ok = got[:, 0].tolist() == want_first
    ok = (same and no_ban and first_ok and diff <= 2e-2 * scale and diff4 <= 2e-2 * scale
          and k4 == cfg.n_layer)
    print(f"ondevice: per-row B=2 n_past {list(starts)} (kv_window {window}), greedy SamplingVec, "
          f"row 1 banning token {banned}: 16 steps replayed equal to the eager decode_chunk "
          f"(tokens, key, recent, n_past, caches) {same}; banned token absent {no_ban}; first "
          f"step's logits against each row alone at B=1: max |diff| {diff:.6g}, with "
          f"FUSED_ATTN=1 (K4 at the rows' own positions, {k4} launches) {diff4:.6g} (logit "
          f"scale {scale:.4g}, limit 2e-2 of it); first tokens {got[:, 0].tolist()} (want "
          f"{want_first}) {'ok' if ok else 'MISMATCH'}", flush=True)
    del ctx, twin
    torch.cuda.empty_cache()
    return ok


def ondevice_oob(torch, cfg, params) -> bool:
    """The out-of-range per-row insert: a forward of T=2 tokens with n_past
    [5, S-1] on a B=2 cache of S=256 slots (row 1 writes slot S-1 and drops
    slot S, as a frozen speculative row would) runs without a device
    assert, its logits finite, and writes exactly slots 5, 6 of row 0 and
    S-1 of row 1; then the insert alone (transformer._cache_insert_rows) of
    the same random K/V into bf16 and q8 caches at n_past [5, S-1, S+3] on
    the card against the CPU, bit for bit over every slot."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV

    s = 256
    ck, cv = transformer.init_cache(cfg, 2, s, device="cuda")
    toks = torch.tensor([[11, 12], [13, 14]], device="cuda")
    logits = transformer.forward(cfg, params, toks, torch.tensor([5, s - 1], device="cuda"),
                                 ck, cv, kv_window=s)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    written = sorted({(int(r), int(p)) for c in ck + cv
                      for r, p in (c.abs().amax(dim=(2, 3)) > 0).nonzero().tolist()})
    forward_ok = finite and written == [(0, 5), (0, 6), (1, s - 1)]
    del ck, cv
    gen = torch.Generator().manual_seed(9)
    n_past = torch.tensor([5, s - 1, s + 3])
    val = torch.randn((3, 2, cfg.kv_heads, cfg.head_dim), generator=gen) * 3
    old = torch.randn((3, s, cfg.kv_heads, cfg.head_dim), generator=gen) * 50
    same = {}
    for name in ("bf16", "q8"):
        out = []
        for dev in ("cpu", "cuda"):
            cache = (old.to(torch.bfloat16) if name == "bf16" else
                     QuantKV(old.clamp(-127, 127).to(torch.int8), old[..., 0].abs() + 0.1))
            cache = (cache.to(dev) if name == "bf16" else
                     QuantKV(cache.data.to(dev), cache.scale.to(dev)))
            transformer._cache_insert_rows(cache, val.to(dev),
                                           transformer._row_slots(n_past.to(dev), s, 2))
            out.append([c.cpu() for c in _flat_cache([cache])])
        same[name] = all(torch.equal(a, b) for a, b in zip(*out))
    ok = forward_ok and all(same.values())
    print(f"ondevice: out-of-range per-row insert: forward T=2 at n_past [5, {s - 1}] on {s} "
          f"slots ran, logits finite {finite}, slots written {written}; the insert alone at "
          f"n_past [5, {s - 1}, {s + 3}] on the card equal to the CPU bit for bit "
          f"{json.dumps(same)} {'ok' if ok else 'MISMATCH'}", flush=True)
    return ok


def ondevice_bench(torch, card, cfg, params):
    """ms/token of 64 tokens from a 128-token prompt (decode from n_past
    128, kv_window 256, as the `bench: ... replayed` lines): generate_ondevice
    greedy and sampled, chunk 16 (the time of each Context.decode_chunk
    call, its one host copy included, over its tokens), beside the host loop
    generate with the same sampling (eval + sample ms/token and
    Timings.t_sample_ms a token); median of 3 passes after a warm-up pass,
    in turns greedy, sampled, sampled, greedy.  Then the profiler over one
    chunk of each: device busy a token against the profiled chunk's own host
    time (idle share) and the kernels that take it; and the host's enqueue
    time of the chunk's graph replays against their device time."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import (DeviceSampling,
                                                                 generate_ondevice, make_recent,
                                                                 prng_key)
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate

    ctx = Context(cfg, params, n_ctx=2048, device="cuda")
    prompt = [1] + np.random.default_rng(4).integers(3, cfg.n_vocab, 127).tolist()
    real = ctx.decode_chunk
    spent = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        spent.append((time.perf_counter() - t0, kw["n_steps"], kw["kv_window"]))
        return out

    meds = {}
    for turn, name in enumerate(("greedy", "sampled", "sampled", "greedy")):
        ds = DeviceSampling(**(GREEDY_DS if name == "greedy" else SAMPLED_DS))
        runs = []
        with Clocks() as clocks:
            for i in range(4):
                ctx.reset()
                spent.clear()
                ctx.decode_chunk = timed
                generate_ondevice(ctx, prompt, 65, sampling=ds, seed=i, chunk=16, eos_token=-1)
                del ctx.decode_chunk
                windows = sorted({w for _, _, w in spent})
                if i:
                    runs.append(sum(t for t, _, _ in spent) / sum(n for _, n, _ in spent) * 1e3)
        hosts, samples = [], []
        for i in range(4):
            ctx.reset()
            gp = GenerateParams(n_predict=64, ignore_eos=True, sampling=_host_sampling(ds), seed=i)
            list(generate(ctx, prompt, gp))
            tm = ctx.timings
            ctx.timings = type(tm)()
            if i:
                hosts.append((tm.t_eval_ms + tm.t_sample_ms) / tm.n_eval)
                samples.append(tm.t_sample_ms / tm.n_sample)
        med = meds[name] = statistics.median(runs)
        print(f"bench: q4_0 {name} (turn {turn + 1}) generate_ondevice chunk 16 "
              f"decode_ms_per_token (kv_window {windows}, n_past 128-191) median={med:.3f} "
              f"min={min(runs):.3f} runs={[round(v, 3) for v in runs]} ({clocks}); "
              f"host loop generate median={statistics.median(hosts):.3f} ms/token (eval + "
              f"sample) of which "
              f"Timings.t_sample_ms {statistics.median(samples):.3f} ms/token "
              f"runs={[round(v, 3) for v in hosts]} [{card}]", flush=True)
    from torch.profiler import ProfilerActivity, profile

    ctx.reset()
    ctx.eval(prompt)
    tok = torch.full((1,), 7, dtype=torch.int64, device="cuda")
    key = prng_key(0, "cuda")
    for name, kw in (("greedy", GREEDY_DS), ("sampled", SAMPLED_DS)):
        ds = DeviceSampling(**kw)
        recent = (make_recent([prompt], ds.repeat_last_n, cfg.n_vocab, device="cuda")
                  if ds.penalized else None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ctx.decode_chunk(tok, 128, key, n_steps=16, ds=ds, kv_window=256, recent=recent)
            wall = (time.perf_counter() - t0) * 1e3 / 16
        rows = _kernel_rows(prof, 16)
        if not rows:
            print(f"trace: q4_0 {name} chunk: the profiler recorded no kernel time (not "
                  f"measured)", flush=True)
            continue
        busy = sum(r[0] for r in rows)
        print(f"trace: q4_0 {name} chunk of 16 (kv_window 256): device busy {busy:.3f} ms a "
              f"token of {wall:.3f} ms a token on the host clock of the profiled chunk (idle "
              f"{100 * (1 - busy / wall):.1f}%; unprofiled {meds[name]:.3f}), "
              f"{sum(r[1] for r in rows)} kernels a token [{card}]", flush=True)
        for ms, k, kname in rows[:6]:
            print(f"trace:   {ms:8.4f} ms/token  x{k:<4d} {kname[:90]}", flush=True)
        # where a replay's host time goes: the host's enqueue of one replay
        # from an idle card, and of 16 back to back, against their ends (the
        # step index set back to 0 first: the graph writes token `step` of 16)
        ch = ctx.last_chunk
        one, enq, total = [], [], []
        for _ in range(3):
            ch.step.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ch.graph.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            one.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
            ch.step.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(16):
                ch.graph.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq.append((t1 - t0) / 16 * 1e3)
            total.append((time.perf_counter() - t0) / 16 * 1e3)
        print(f"trace: q4_0 {name} chunk graph: one replay from an idle card enqueued in "
              f"{statistics.median(a for a, _ in one):.3f} ms, done in "
              f"{statistics.median(b for _, b in one):.3f} ms; 16 back to back enqueued in "
              f"{statistics.median(enq):.3f} ms a replay, done in {statistics.median(total):.3f} "
              f"ms a replay [{card}]", flush=True)
    print(f"ondevice: bench {graph_summary(ctx)}", flush=True)
    del ctx
    torch.cuda.empty_cache()


def ondevice_phase(torch, counters, card, built=None) -> bool:
    """On-device decode on LLaMA-7B q4_0 (32 layers, built from seed 0
    unless built gives the weights): greedy B=1 512 + 64 chunk 16 (129 K2 a
    token; agreement with the host loop printed), sampled (temp 0.8, top-k
    40, top-p 0.95, repeat penalty 1.1) 512 + 64, the int8 configuration
    128 + 16 chunk 8 on a q8 cache (129 K7 + 32 K4 a token), the per-row
    B=2 chunk, the out-of-range insert, and the bench and trace lines."""
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    t0 = time.perf_counter()
    cfg, params = built or build_llama(device="cuda", seed=0, ftype="q4_0")
    ok, _ = ondevice_run(torch, counters, cfg, params, "q4_0 greedy", GREEDY_DS, 512, 64, 16,
                         torch.bfloat16, {"qmm_q4_0_kfold": 129}, PATH_KERNELS["q4_0"],
                         host=True)
    ok2, _ = ondevice_run(torch, counters, cfg, params, "q4_0 sampled", SAMPLED_DS, 512, 64, 16,
                          torch.bfloat16, {"qmm_q4_0_kfold": 129}, PATH_KERNELS["q4_0"], seed=7)
    ok &= ok2
    with env(**INT8):
        ok3, _ = ondevice_run(torch, counters, cfg, params, "q4_0 int8-config", GREEDY_DS, 128,
                              16, 8, torch.int8, {"qmm_q8x": 129, "mha_decode": 32},
                              PATH_KERNELS["q4_0_int8_f16"])
    ok &= ok3
    ok &= ondevice_rows(torch, cfg, params)
    ok &= ondevice_oob(torch, cfg, params)
    ondevice_bench(torch, card, cfg, params)
    print(f"ondevice: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return ok


def _tool_output(mod, argv):
    """(rc, stdout bytes) of a CLI tool's main run in this process."""
    import contextlib
    import io

    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
        out.flush()
    return rc, buf.getvalue()


def families_cli(counters) -> bool:
    """`main --arch bonsai` (4 greedy tokens) and `embedding --arch bonsai`
    on a Bonsai GGJT of the port's formats/fixtures.py (n_embd 256, 2 heads
    of 128, every matmul inside the kernels' gate), on the card and on the
    CPU: the same text, K2 launched on the card; the embedding's values
    within 1e-2 of their scale (bf16 activations rounded apart by another
    summation order)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.cli import embedding as embedding_mod
    from llama_cpp_q_4_0_tpu_torch.cli import main as main_mod
    from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_falcon_like_ggjt
    from llama_cpp_q_4_0_tpu_torch.kernels.build import BUILD_DIR

    tmp = os.path.join(BUILD_DIR, "smoke-families")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "bonsai-256.ggjt")
    try:
        make_falcon_like_ggjt(path, "bonsai", n_embd=256, n_head=2, n_vocab=512, seed=4)
        runs = {}
        for dev in ("cuda", "cpu"):
            _zero(counters)
            rc, text = _tool_output(main_mod, ["-m", path, "--arch", "bonsai", "-p", "Hello",
                                               "-n", "4", "--temp", "0", "-c", "64",
                                               "--device", dev])
            launched = {k: v for k, v in _read(counters).items() if v}
            rc2, emb = _tool_output(embedding_mod, ["-m", path, "--arch", "bonsai", "-p",
                                                    "Hello world", "-c", "64", "--device", dev])
            vals = np.asarray([float(v) for v in emb.decode().splitlines()[0].split()]
                              if rc2 == 0 else [])
            runs[dev] = (rc, text, launched, rc2, vals)
        (rc, text, launched, rc2, vals), (crc, ctext, _, crc2, cvals) = runs["cuda"], runs["cpu"]
        err = float(np.abs(vals - cvals).max()) if vals.shape == cvals.shape == (256,) else 1e9
        tol = 1e-2 * float(np.abs(cvals).max()) if cvals.size else 0.0
        ok = (rc == crc == rc2 == crc2 == 0 and text == ctext and text.startswith(b"Hello")
              and launched.get("qmm_q4_0_kfold", 0) > 0 and err <= tol
              and bool(np.isfinite(vals).all()))
        print(f"families: main --arch bonsai on the card {text!r}, on the CPU {ctext!r} "
              f"(equal {text == ctext}; card launches {json.dumps(launched)}); embedding "
              f"--arch bonsai card vs CPU max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _add(launches: dict, totals: dict) -> None:
    for k, v in totals.items():
        launches[k] = launches.get(k, 0) + v


def family_kernels(torch, recs: dict) -> bool:
    """The kernels of the GPT-NeoX path at the shapes it gives them, each
    against its plain version: K1 at NEOX_SHAPES[:4], timed at b=512 (the
    prefill) and checked at b=128; K2 and K7 timed at b=1 on NEOX_SHAPES and
    through check_gemv at every row of GEMV_ROWS (the split plan at K =
    24576, graph replays); K7's tile timed at b=128 (the int8
    configuration's prefill); K3 at FAMILY_FLASH.  recs[kernel] keeps the
    largest error; the times print only."""
    timer = Timer(torch)
    ok = True

    def merge(kernel, rec):
        recs[kernel]["max_abs_err"] = max(recs[kernel].get("max_abs_err", 0.0),
                                          rec["max_abs_err"])

    for name, b, timed in (("qmm_q4_0/gptneox", 512, True), ("qmm_q4_0/gptneox", 128, False),
                           ("qmm_q4_0_kfold/gptneox", 1, True), ("qmm_q8x/gptneox", 1, True),
                           ("qmm_q8x/gptneox", 128, True)):
        rec = {}
        ok &= check_qmm(torch, timer, name, b, rec, time_it=timed)
        merge(name.split("/")[0], rec)
        torch.cuda.empty_cache()
    ok &= check_gemv(torch, NEOX_GEMV, ())
    rec = {}
    ok &= check_flash(torch, timer, rec, FAMILY_FLASH)
    merge("flash_prefill", rec)
    torch.cuda.empty_cache()
    return ok


def families_phase(torch, counters, launches: dict, recs: dict) -> bool:
    """The GPT-NeoX, Falcon and Bonsai families on the card, synthetic q4_0
    weights built from seed 0, every Context step a replayed graph held
    against its eager twin bit for bit (graph_run), each model 512 + 64 on a
    bf16 cache and 128 + 16 in the int8 configuration (q8 cache):
      GPT-NeoX at StableLM-Base-Alpha-7B widths (n_embd 6144, 48 heads of
        128, n_rot 32, n_ff 24576, vocab 50688), 16 layers: 65 K2 a decode
        token, 64 K1 + 16 K3 + 1 K2 a 512-token prefill; 65 K7 + 16 K4 a
        token and 65 K7 + 16 K3 a 128-token prefill in the int8
        configuration; a generate_ondevice run (chunks against eager
        twins), Context.embed and eval_embd, the bench and trace lines;
      Falcon-7B widths (n_embd 4544, 71 heads of 64 over one KV head, n_ff
        18176, vocab 65024), 16 layers: every matmul outside the kernels'
        gate, so the bf16 product and no matmul kernel; plain prefill
        attention (head width 64); 16 K4 a token in the int8 configuration
        (rep 71), a generate_ondevice run there; bench and trace lines;
      Bonsai, 2 layers at widths inside the gate (n_embd 2048, 16 heads of
        128, one KV head): graph runs, and against the CPU (default and
        int8 configuration);
    the GPT-NeoX path's kernels at its shapes (family_kernels) and a 2-layer
    GPT-NeoX at the same widths against the CPU (default and int8
    configuration); K4 at H=71, G=1, D=64 against its plain version
    (FALCON_MHA); `main --arch bonsai` and `embedding` card against CPU.
    launches gains each run's launches, recs the kernels' largest errors."""
    from llama_cpp_q_4_0_tpu_torch.synth import build_bonsai, build_falcon, build_gptneox

    t0 = time.perf_counter()
    ok = family_kernels(torch, recs)
    rec = {}
    ok &= check_mha(torch, Timer(torch), rec, cases=FALCON_MHA)
    recs["mha_decode"]["max_abs_err"] = max(recs["mha_decode"].get("max_abs_err", 0.0),
                                            rec["max_abs_err"])
    torch.cuda.empty_cache()
    print(f"families: kernel checks done {time.perf_counter() - t0:.1f} s", flush=True)

    def built(name, cfg):
        torch.cuda.synchronize()
        print(f"families: synthetic {name} q4_0 built on the card (n_layer={cfg.n_layer} "
              f"n_embd={cfg.n_embd} n_head={cfg.n_head} kv_heads={cfg.kv_heads} "
              f"n_rot={cfg.n_rot} n_ff={cfg.n_ff} n_vocab={cfg.n_vocab}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)", flush=True)

    # GPT-NeoX: the slice's kernel path
    cfg, params = build_gptneox(device="cuda", seed=0)
    built("GPT-NeoX (StableLM-Base-Alpha-7B widths, 16 layers)", cfg)
    model_bounds("GPT-NeoX-6144 q4_0", params, cfg.n_layer, heads=(48, 48, 128))
    totals = {}
    ok &= graph_run(torch, counters, cfg, params, "gptneox", 512, 64, torch.bfloat16,
                    {"qmm_q4_0_kfold": 65},
                    want_prefill={"qmm_q4_0": 64, "flash_prefill": 16, "qmm_q4_0_kfold": 1},
                    totals=totals)
    with env(**INT8):
        ok &= graph_run(torch, counters, cfg, params, "gptneox int8-config", 128, 16,
                        torch.int8, {"qmm_q8x": 65, "mha_decode": 16},
                        want_prefill={"qmm_q8x": 65, "flash_prefill": 16}, totals=totals)
    _add(launches, totals)
    torch.cuda.empty_cache()
    good, _ = ondevice_run(torch, counters, cfg, params, "gptneox greedy", GREEDY_DS, 512, 64,
                           16, torch.bfloat16, {"qmm_q4_0_kfold": 65},
                           PATH_KERNELS["q4_0"])
    ok &= good
    ok &= graph_embed(torch, cfg, params)
    torch.cuda.empty_cache()
    bench_instruments(torch, cfg, params, "gptneox")
    ck, cv = transformer_cache(torch, cfg, torch.int8)
    with env(**INT8):
        med, _ = decode_ms(torch, cfg, params, ck, cv, 65, 256)
        del ck, cv
        graph_instruments(torch, cfg, params, "gptneox int8-config", None, {256: med},
                          cache_dtype=torch.int8)
    del params
    torch.cuda.empty_cache()
    # 2 layers at the same widths against the CPU: 4 K2 a layer and the
    # head's a decode token (4 K7 + 1 K4 a layer in the int8 configuration).
    # The limit is 2e-2 of the logit scale in both configurations: this
    # synthetic model (layer norms, GELU) carries an ulp-sized difference
    # into the logits as far as the card departs from the CPU, q8 rounding
    # flips included, as the probe's line shows
    for int8, want in ((False, {"qmm_q4_0_kfold": 9}),
                       (True, {"qmm_q8x": 9, "mha_decode": 2})):
        ok &= two_layer_vs_cpu(torch, counters, "q4_0", int8=int8, want_per_token=want,
                               build=build_gptneox, frac=2e-2, probe=True)[0]
        torch.cuda.empty_cache()
    print(f"families: gptneox done {time.perf_counter() - t0:.1f} s", flush=True)

    # Falcon: off the kernels' gate, K4 at rep 71 in the int8 configuration
    # 16 of Falcon-7B's 32 layers, to keep the whole run in its time (every
    # matmul takes the same off-gate product at any depth)
    cfg, params = build_falcon(n_layer=16, device="cuda", seed=0)
    built("Falcon (Falcon-7B widths, 16 layers)", cfg)
    model_bounds("Falcon-4544 q4_0", params, cfg.n_layer, heads=(71, 1, 64))
    totals = {}
    ok &= graph_run(torch, counters, cfg, params, "falcon", 512, 64, torch.bfloat16, {},
                    want_prefill={}, totals=totals)
    with env(**INT8):
        ok &= graph_run(torch, counters, cfg, params, "falcon int8-config", 128, 16,
                        torch.int8, {"mha_decode": cfg.n_layer}, want_prefill={},
                        totals=totals)
        good, _ = ondevice_run(torch, counters, cfg, params, "falcon int8-config", GREEDY_DS,
                               128, 16, 8, torch.int8, {"mha_decode": cfg.n_layer},
                               ("mha_decode",))
        ok &= good
    _add(launches, totals)
    torch.cuda.empty_cache()
    bench_instruments(torch, cfg, params, "falcon", passes=3, n_tok=16)
    ck, cv = transformer_cache(torch, cfg, torch.int8)
    with env(**INT8):
        med, _ = decode_ms(torch, cfg, params, ck, cv, 65, 256, n_tok=16)
        del ck, cv
        graph_instruments(torch, cfg, params, "falcon int8-config", None, {256: med},
                          cache_dtype=torch.int8, passes=3, n_tok=16)
    del params
    torch.cuda.empty_cache()
    print(f"families: falcon done {time.perf_counter() - t0:.1f} s", flush=True)

    # Bonsai, 2 layers inside the gate: replays, and the card against the CPU
    cfg, params = build_bonsai(device="cuda", seed=0)
    built("Bonsai (2 layers)", cfg)
    totals = {}
    ok &= graph_run(torch, counters, cfg, params, "bonsai", 512, 64, torch.bfloat16,
                    {"qmm_q4_0_kfold": 9},
                    want_prefill={"qmm_q4_0": 8, "flash_prefill": 2, "qmm_q4_0_kfold": 1},
                    totals=totals)
    with env(**INT8):
        ok &= graph_run(torch, counters, cfg, params, "bonsai int8-config", 128, 16,
                        torch.int8, {"qmm_q8x": 9, "mha_decode": 2},
                        want_prefill={"qmm_q8x": 9, "flash_prefill": 2}, totals=totals)
    _add(launches, totals)
    del params
    torch.cuda.empty_cache()
    for int8 in (False, True):
        ok &= two_layer_vs_cpu(torch, counters, "q4_0", int8=int8, build=build_bonsai)[0]
        torch.cuda.empty_cache()
    ok &= families_cli(counters)
    print(f"families: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return ok


# ------------------------------------------------------------------ session

def _greedy(ctx, n: int):
    """n greedy decode steps from ctx.logits: (tokens, each step's logits)."""
    import numpy as np

    toks, logits = [], []
    for _ in range(n):
        toks.append(int(np.argmax(ctx.logits[0, -1])))
        logits.append(ctx.eval([[toks[-1]]]))
    return toks, logits


def _same_run(a, b) -> bool:
    """Two _greedy runs equal bit for bit: tokens and every step's logits."""
    import numpy as np

    return a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


def _cache_ptrs(ctx):
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV

    return [t.data_ptr() for c in (*ctx.cache_k, *ctx.cache_v)
            for t in ((c.data, c.scale) if isinstance(c, QuantKV) else (c,))]


def _pair_mag(torch, w, n_rot: int, neox: bool):
    """Each element's rotation pair magnitude (its own beyond n_rot)."""
    half = n_rot // 2
    a, b = (w[..., :half], w[..., half:n_rot]) if neox else (w[..., 0:n_rot:2],
                                                           w[..., 1:n_rot:2])
    mag = torch.sqrt(a * a + b * b)
    mag = torch.cat([mag, mag], dim=-1) if neox else mag.repeat_interleave(2, dim=-1)
    return torch.cat([mag, w[..., n_rot:].abs()], dim=-1)


def pair_ulps(torch, got, want, n_rot: int, neox: bool) -> float:
    """The largest |got - want| of a rotated bf16 K in bf16 ulps of its
    rotation pair's magnitude (tests/test_torch_session.py): a shifted K was
    rounded at its old position and rotated again, which spreads that
    rounding (half an ulp of each component) over both components of the
    pair; with the two final roundings the difference stays within about
    1.7 ulps of the pair's magnitude."""
    g, w = got.float(), want.float()
    mag = _pair_mag(torch, w, n_rot, neox)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    return float(((g - w).abs() / ulp).max())


def pair_rel(torch, got, want, n_rot: int, neox: bool) -> float:
    """The largest |got - want| of a rotated f32 K relative to its rotation
    pair's magnitude.  RoPE's angle p * f is an f32 product: the shift
    composes the angles of the old position and of -n_discard, each rounded
    apart from the new position's, so at positions of a few hundred the
    rotation moves by up to 1.5 ulps of the largest angle (ulp(543) = 2^-14),
    times the pair's magnitude; JAX's test of 1e-5 relative runs at
    positions below 8."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / _pair_mag(torch, w, n_rot, neox).clamp(min=1e-30)).max())


def bf16_ulps(torch, got, want) -> int:
    """The largest distance of two bf16 tensors in ulps (their bit patterns
    ordered as their values)."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(b >= 0x8000, -(b & 0x7FFF), b)

    return int((ordered(got) - ordered(want)).abs().max())


# the kernels' launches a perplexity chunk of 512 tokens on 7B q4_0: every
# matmul of the 512-row prefill takes K1 (wqkv, wo, gate/up, w2 in 32 layers
# and the 512-row head, logits_all), K3 the whole-prompt attention at n_past
# 0; -b 256 runs two pieces (2 x 129 K1), the second at n_past 256 through the
# cache-window attention; the on-device loop's forward takes no
# attention_fn (JAX's _chunk_nll), so no K3
PPL_LAUNCHES = {"b512": {"qmm_q4_0": 129, "flash_prefill": 32},
                "b256": {"qmm_q4_0": 258, "flash_prefill": 32},
                "b512_noflash": {"qmm_q4_0": 129},
                "ondevice": {"qmm_q4_0": 129}}


def session_ppl(torch, counters, card, cfg, params, stream, launches: dict):
    """Perplexity of 7B q4_0 over 4 chunks of 512 (n_ctx 1024 Context, bf16
    cache): the host loop at -b 512 and -b 256, the host loop under
    FLASH_PREFILL=0 (the on-device loop's attention) and the on-device loop.
    Each runs once to capture its graphs, then again with the launch counts
    set to 0: ms a chunk (host clock) and the launches a chunk, checked.
    Holds the on-device value to the like-for-like host one (FLASH_PREFILL=0)
    within |d ln ppl| <= 1e-4 (f32 against f64 logsumexp); the K3 runs'
    differences print.  The counted runs' launches are added to launches.
    Returns (ok, {run: ppl})."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.perplexity import perplexity, perplexity_ondevice

    ctx = Context(cfg, params, n_ctx=1024, device="cuda")
    runs = {"b512": ({}, lambda: perplexity(ctx, stream, n_ctx=512, n_batch=512)),
            "b256": ({}, lambda: perplexity(ctx, stream, n_ctx=512, n_batch=256)),
            "b512_noflash": ({"FLASH_PREFILL": "0"},
                             lambda: perplexity(ctx, stream, n_ctx=512, n_batch=512)),
            "ondevice": ({}, lambda: perplexity_ondevice(ctx, stream, n_ctx=512))}
    ok, ppl = True, {}
    n_chunk = len(stream) // 512
    for name, (sw, fn) in runs.items():
        with env(**sw):
            fn()  # captures
            torch.cuda.synchronize()
            _zero(counters)
            t0 = time.perf_counter()
            res = fn()
            ms = (time.perf_counter() - t0) * 1e3 / n_chunk
            _add(launches, _read(counters))
            launched = {k: v / n_chunk for k, v in _read(counters).items() if v}
        good = launched == PPL_LAUNCHES[name] and np.isfinite(res.ppl)
        ok &= good
        ppl[name] = res.ppl
        print(f"session: 7B q4_0 perplexity {name} over {n_chunk} chunks of 512: ppl "
              f"{res.ppl!r} (chunks {[round(c, 4) for c in res.chunk_ppls]}), {ms:.2f} ms a "
              f"chunk (host clock, replayed), launches a chunk {json.dumps(launched)} (want "
              f"{json.dumps(PPL_LAUNCHES[name])}) {'ok' if good else 'MISMATCH'} [{card}]",
              flush=True)
    d = abs(np.log(ppl["ondevice"]) - np.log(ppl["b512_noflash"]))
    ok &= bool(d <= 1e-4)
    print(f"session: |d ln ppl| on-device vs host (FLASH_PREFILL=0, the same attention) "
          f"{d:.3e} (limit 1e-4) {'ok' if d <= 1e-4 else 'MISMATCH'}; host with K3 "
          f"(-b 512) vs on-device {abs(np.log(ppl['ondevice']) - np.log(ppl['b512'])):.3e}, "
          f"-b 256 vs on-device {abs(np.log(ppl['ondevice']) - np.log(ppl['b256'])):.3e} "
          f"(printed: K3's f32 attention against the bf16-operand chain)", flush=True)
    print(f"session: perplexity {graph_summary(ctx)}", flush=True)
    del ctx
    torch.cuda.empty_cache()
    return ok, ppl


def session_ppl_vs_cpu(torch, seed: int) -> bool:
    """The 2-layer 7B-width q4_0 model (two_layer_vs_cpu's, seed 1):
    perplexity over 2 chunks of 128 on the card and on the CPU's plain
    path, held to |d ln ppl| <= 2 x two_layer_vs_cpu's logit limit (2e-2 of
    the CPU logits' scale): each token's NLL (logsumexp minus the target's
    logit) moves by at most twice the largest logit deviation."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.perplexity import perplexity
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    cfg, params = build_llama(n_layer=2, device="cuda", seed=1, ftype="q4_0")
    stream = np.random.default_rng(seed + 1).integers(3, cfg.n_vocab, 2 * 128)
    res, scale = {}, 0.0
    for dev, p in (("cuda", params), ("cpu", _params_to(params, "cpu"))):
        ctx = Context(cfg, p, n_ctx=128, device=dev)
        t0 = time.perf_counter()
        res[dev] = perplexity(ctx, stream, n_ctx=128, n_batch=128).ppl
        print(f"session: 2-layer 7B-width q4_0 perplexity on {dev}: {res[dev]!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if dev == "cpu":
            scale = float(np.abs(ctx.logits).max())
        del ctx
    d = abs(np.log(res["cuda"]) - np.log(res["cpu"]))
    tol = 2 * 2e-2 * scale
    ok = bool(d <= tol and np.isfinite(res["cuda"]))
    print(f"session: 2-layer card vs CPU |d ln ppl| {d:.3e} (limit 2 x 2e-2 x {scale:.3f} = "
          f"{tol:.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
    del params
    torch.cuda.empty_cache()
    return ok


LLAMA7B_HPARAMS = {"n_vocab": 32000, "n_embd": 4096, "n_mult": 256, "n_head": 32,
                   "n_layer": 32, "n_rot": 128}


def session_state(torch, card, cfg, params, prompt, tmp) -> bool:
    """State round trips on 7B q4_0 (n_ctx 1024, bf16 cache): a 512-token
    prefill and 32 greedy tokens, the state S taken, 32 more (the
    uninterrupted run).  Each restore of S must continue like it bit for bit
    (32 greedy tokens, every step's logits): set_state of S's bytes into a
    fresh Context; set_state into the same Context, whose step graphs are
    captured, its cache tensors at their addresses; load_session of a zip
    session into the second Context.  A .ggsn save loaded into the second
    Context: its slots equal S's cast through f16.  Then the KV shift
    (shift_kv_cache(n_keep=32, n_discard=256)): layer 0's surviving prompt
    slots against a fresh eval of the surviving prompt tokens (bf16: V
    within one ulp, K within two ulps of each rotation pair's magnitude,
    pair_ulps; an f32 cache: V within 1e-5 relative, K within two f32 ulps
    of the largest RoPE angle times the pair's magnitude, pair_rel), 16
    more tokens finite."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.session import (
        get_state, load_session, save_session, set_state, shift_kv_cache,
        state_from_bytes, state_to_bytes)

    ok = True

    def check(label, good, extra=""):
        nonlocal ok
        ok &= bool(good)
        print(f"session: {label}{extra} {'ok' if good else 'MISMATCH'}", flush=True)

    a = Context(cfg, params, n_ctx=1024, device="cuda")
    a.eval([prompt])
    head = _greedy(a, 32)
    t0 = time.perf_counter()
    state = get_state(a)
    blob = state_to_bytes(state)
    t_get = (time.perf_counter() - t0) * 1e3
    ref = _greedy(a, 32)
    tokens = prompt + head[0]
    b = Context(cfg, params, n_ctx=1024, device="cuda")
    t0 = time.perf_counter()
    set_state(b, state_from_bytes(blob))
    torch.cuda.synchronize()
    t_set = (time.perf_counter() - t0) * 1e3
    print(f"session: 7B state at n_past {state['n_past']}: get_state + state_to_bytes "
          f"{t_get:.1f} ms, {len(blob)} bytes; state_from_bytes + set_state {t_set:.1f} ms "
          f"(host clock) [{card}]", flush=True)
    check("set_state into a fresh Context continues bit for bit (32 tokens, logits)",
          _same_run(_greedy(b, 32), ref))
    ptrs = _cache_ptrs(a)
    set_state(a, state)
    same_ptrs = _cache_ptrs(a) == ptrs
    zpath, gpath = os.path.join(tmp, "s.bin"), os.path.join(tmp, "s.ggsn")
    t0 = time.perf_counter()
    save_session(zpath, a, tokens)
    t_zip = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    save_session(gpath, a, tokens, hparams=LLAMA7B_HPARAMS, ftype=2)
    t_ggsn = (time.perf_counter() - t0) * 1e3
    check("set_state into the same Context (graphs captured) continues bit for bit",
          _same_run(_greedy(a, 32), ref) and same_ptrs,
          f"; cache tensors at their addresses {same_ptrs}")
    ptrs = _cache_ptrs(b)
    t0 = time.perf_counter()
    loaded = load_session(zpath, b)
    t_zload = (time.perf_counter() - t0) * 1e3
    check("zip session save/load continues bit for bit",
          loaded == tokens and _same_run(_greedy(b, 32), ref) and _cache_ptrs(b) == ptrs,
          f" (save {t_zip:.1f} ms, load {t_zload:.1f} ms, {os.path.getsize(zpath)} bytes)")
    t0 = time.perf_counter()
    loaded = load_session(gpath, b)
    t_gload = (time.perf_counter() - t0) * 1e3
    n = len(tokens)
    f16 = all(torch.equal(y[:, :n], x[:, :n].float().half().to(torch.bfloat16))
              for x, y in zip((*a.cache_k, *a.cache_v), (*b.cache_k, *b.cache_v)))
    check("GGSN save/load: the loaded cache equals the saved one cast through f16 bit for bit",
          loaded == tokens and f16 and b.n_past == n and _cache_ptrs(b) == ptrs,
          f" (save {t_ggsn:.1f} ms, load {t_gload:.1f} ms, {os.path.getsize(gpath)} bytes)")
    # the KV shift, from S
    set_state(a, state)
    n_keep, n_discard = 32, 256
    survivors = prompt[:n_keep] + prompt[n_keep + n_discard:]
    ptrs = _cache_ptrs(a)
    t0 = time.perf_counter()
    shift_kv_cache(a, n_keep, n_discard)
    torch.cuda.synchronize()
    t_shift = (time.perf_counter() - t0) * 1e3
    b.reset()
    b.eval([survivors])
    m = len(survivors)
    k_ulps = pair_ulps(torch, a.cache_k[0][:, :m], b.cache_k[0][:, :m], cfg.n_rot,
                       cfg.rope_neox)
    v_ulps = bf16_ulps(torch, a.cache_v[0][:, :m], b.cache_v[0][:, :m])
    tail = _greedy(a, 16)
    check(f"shift_kv_cache(n_keep={n_keep}, n_discard={n_discard}) on bf16: layer 0's "
          f"{m} prompt slots against a fresh eval",
          k_ulps <= 2 and v_ulps <= 1 and a.n_past == n - n_discard + 16
          and _cache_ptrs(a) == ptrs and all(np.isfinite(x).all() for x in tail[1]),
          f": K {k_ulps:.3f} ulps of its pair's magnitude (limit 2), V {v_ulps} ulp (limit "
          f"1); {t_shift:.1f} ms (host clock); 16 more tokens finite {tail[0][:8]}...")
    del a, b
    torch.cuda.empty_cache()
    # the same on an f32 cache
    f = Context(cfg, params, n_ctx=1024, device="cuda", cache_dtype=torch.float32)
    f.eval([prompt])
    _greedy(f, 32)
    shift_kv_cache(f, n_keep, n_discard)
    k0, v0 = f.cache_k[0][:, :m].clone(), f.cache_v[0][:, :m].clone()
    f.reset()
    f.eval([survivors])
    # the largest angle the shift composes: position n_prompt + 31, frequency 1
    theta_ulp = 2.0 ** (math.floor(math.log2(len(prompt) + 31)) - 23)
    k_rel = pair_rel(torch, k0, f.cache_k[0][:, :m], cfg.n_rot, cfg.rope_neox)
    v_err = float(((v0 - f.cache_v[0][:, :m]).abs() - 1e-5 * f.cache_v[0][:, :m].abs()).max())
    check("shift_kv_cache on f32: layer 0 against a fresh eval",
          k_rel <= 2 * theta_ulp and v_err <= 1e-5,
          f": K {k_rel:.3e} of its pair's magnitude (limit 2 ulps of the largest angle, "
          f"{2 * theta_ulp:.3e}), V within 1e-5 relative (max |d| - 1e-5 |want| {v_err:.3e})")
    del f, k0, v0
    torch.cuda.empty_cache()
    return ok


# the f8 cache's runs: K2 for all 129 matmuls a decode token; under
# FUSED_ATTN=1 also K4 over the e4m3 window in each of 32 layers
F8_PER_TOKEN = {"q4_0_f8": {"qmm_q4_0_kfold": 129},
                "q4_0_f8_fused": {"qmm_q4_0_kfold": 129, "mha_decode": 32}}


def session_f8(torch, counters, card, cfg, params, stream, ppl_bf16, launches: dict) -> bool:
    """7B q4_0 with --cache-type f8, 512 + 32 greedy tokens through Context +
    generate, in the default attention and under FUSED_ATTN=1 (K4 reads the
    e4m3 window): the decode launches checked, the tokens printed; the
    replayed decode ms/token of the bf16 and f8 caches, each with and
    without FUSED_ATTN=1; the on-device perplexity of the f8 cache beside
    the bf16 cache's.  The generate runs' launches are added to launches."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.perplexity import perplexity_ondevice

    ok, toks = True, {}
    for path, sw in (("q4_0_f8", {}), ("q4_0_f8_fused", {"FUSED_ATTN": "1"})):
        with env(**sw):
            good, launched, per_token, _, _, toks[path] = end_to_end(
                torch, counters, "q4_0", n_prompt=512, n_decode=32, path=path,
                cache_dtype=torch.float8_e4m3fn, built=(cfg, params))
        _add(launches, launched)
        good &= per_token == F8_PER_TOKEN[path]
        ok &= good
        print(f"session: {path} decode launches a token {json.dumps(per_token)} (want "
              f"{json.dumps(F8_PER_TOKEN[path])}); tokens {toks[path]} "
              f"{'ok' if good else 'MISMATCH'} [{card}]", flush=True)
    same = next((i for i, (x, y) in enumerate(zip(toks["q4_0_f8"], toks["q4_0_f8_fused"]))
                 if x != y), len(toks["q4_0_f8"]))
    # replayed decode ms/token at window 1024 (n_past 513-544), each cache and
    # attention path in turn, the first (captured) step left out
    prompt = [1] + np.random.default_rng(0).integers(3, cfg.n_vocab, 511).tolist()
    for label, dt, sw in (("bf16 cache", torch.bfloat16, {}),
                          ("f8 cache", torch.float8_e4m3fn, {}),
                          ("bf16 cache, FUSED_ATTN=1", torch.bfloat16, {"FUSED_ATTN": "1"}),
                          ("f8 cache, FUSED_ATTN=1", torch.float8_e4m3fn, {"FUSED_ATTN": "1"})):
        with env(**sw):
            ctx = Context(cfg, params, n_ctx=2048, device="cuda", cache_dtype=dt)
            ctx.eval([prompt])
            tok = int(np.argmax(ctx.eval([[int(np.argmax(ctx.logits[0, -1]))]])[0, -1]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32):
                tok = int(np.argmax(ctx.eval([[tok]])[0, -1]))
            ms = (time.perf_counter() - t0) * 1e3 / 32
        print(f"session: 7B q4_0 {label}, replayed decode at window 1024 (n_past "
              f"514-545): {ms:.3f} ms/token (host clock, 32 tokens) [{card}]", flush=True)
        del ctx
    ctx = Context(cfg, params, n_ctx=512, device="cuda", cache_dtype=torch.float8_e4m3fn)
    res = perplexity_ondevice(ctx, stream, n_ctx=512)
    ok &= bool(np.isfinite(res.ppl))
    print(f"session: greedy tokens of the f8 cache agreeing between the default attention and "
          f"K4 before the first difference: {same} of {len(toks['q4_0_f8'])}; on-device "
          f"perplexity of the f8 cache {res.ppl!r} beside the bf16 cache's {ppl_bf16!r} "
          f"(d ln ppl {np.log(res.ppl) - np.log(ppl_bf16):+.4e}) [{card}]", flush=True)
    del ctx
    torch.cuda.empty_cache()
    return ok


def _tool_run(mod, argv, stdin: str = ""):
    """(rc, stdout bytes, stderr text) of a CLI tool's main in this process,
    stdin fed from a string; the stderr passes through after the run."""
    import contextlib
    import io

    err = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stderr(err):
            rc, out = _tool_output(mod, argv)
    finally:
        sys.stdin = saved
    sys.stderr.write(err.getvalue())
    return rc, out, err.getvalue()


def session_cli(counters, card, tmp) -> bool:
    """The tools of the slice on the 2-layer 7B-width q4_0 GGJT
    (write_ggjt_7b_width): `main --prompt-cache` twice on a zip and on a
    .ggsn path (the second run prints `session: reused`), `main -i -n 2`
    with two lines on stdin (on the card and on the CPU, --memory-f32, the
    same text; the CPU's plain path takes ~2.6 s a forward at this width),
    `main -f --n-keep 8 -c 64 -n 80` (80 tokens through context swaps),
    `perplexity -f PAPERS.md -c 128 -b 64` and `--on-device` (--memory-f32:
    held to each other within 1e-4 in ln ppl, the printed line as JAX's
    tests check it), and `save-load-state`."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.cli import main as main_mod
    from llama_cpp_q_4_0_tpu_torch.cli import perplexity as ppl_mod
    from llama_cpp_q_4_0_tpu_torch.cli import save_load_state as sls_mod

    path = os.path.join(tmp, "llama7b-width-2layer-q4_0.ggjt")
    write_ggjt_7b_width(path, "q4_0")
    base = ["-m", path, "--temp", "0", "-s", "1"]
    ok = True

    def check(label, good, extra=""):
        nonlocal ok
        ok &= bool(good)
        print(f"cli-session: {label}{extra} {'ok' if good else 'FAILED'}", flush=True)

    for suffix in (".bin", ".ggsn"):
        cache = os.path.join(tmp, "prompt-cache" + suffix)
        runs = [_tool_run(main_mod, [*base, "-p", "Once upon a time", "-n", "8", "-c", "256",
                                     "--prompt-cache", cache]) for _ in range(2)]
        reused = [l for l in runs[1][2].splitlines() if l.startswith("session: reused")]
        check(f"main --prompt-cache {suffix} twice",
              runs[0][0] == runs[1][0] == 0 and reused and "session: reused" not in runs[0][2],
              f": {reused}; texts {runs[0][1]!r}, {runs[1][1]!r}")
    text = {}
    for dev in ("cuda", "cpu"):
        _zero(counters)
        rc, out, _ = _tool_run(main_mod, [*base, "-p", "Hello", "-n", "2", "-c", "256", "-i",
                                          "--memory-f32", "--device", dev],
                               stdin="Tell me more\nAnd then\n")
        text[dev] = (rc, out, {k: v for k, v in _read(counters).items() if v})
    check("main -i, two lines on stdin, card vs CPU",
          text["cuda"][0] == text["cpu"][0] == 0 and text["cuda"][1] == text["cpu"][1]
          and text["cuda"][1].count(b"\n> ") == 3
          and text["cuda"][2].get("qmm_q4_0_kfold", 0) > 0,
          f": card {text['cuda'][1]!r}, CPU {text['cpu'][1]!r}, card launches "
          f"{json.dumps(text['cuda'][2])}")
    pfile = os.path.join(tmp, "prompt.txt")
    with open(pfile, "w") as fh:
        fh.write("Once upon a time there was a small model on a large card")
    rc, out, err = _tool_run(main_mod, [*base, "-f", pfile, "--n-keep", "8", "-c", "64",
                                        "-n", "80", "--ignore-eos"])
    m = re.search(r"prompt eval time = .* / (\d+) tokens", err)
    evaluated = int(m.group(1)) if m else 0
    check("main -f --n-keep 8 -c 64 -n 80 (context swaps)", rc == 0 and evaluated > 64,
          f": {len(out)} bytes; {evaluated} prompt tokens evaluated (over 64: swapped)")
    text_file = os.path.join(ROOT, "PAPERS.md")
    ppl = {}
    for label, extra in (("host", []), ("--on-device", ["--on-device"])):
        rc, out, _ = _tool_run(ppl_mod, ["-m", path, "-f", text_file, "-c", "128", "-b", "64",
                                         "--memory-f32", *extra])
        m = re.search(rb"Final estimate: PPL = ([0-9.]+) over (\d+) tokens", out)
        ppl[label] = float(m.group(1)) if rc == 0 and m else float("nan")
        print(f"cli-session: perplexity {label}: rc={rc} {out.decode().strip()!r}", flush=True)
    d = abs(np.log(ppl["host"]) - np.log(ppl["--on-device"]))
    check("perplexity -c 128 -b 64 host vs --on-device on the card (--memory-f32)",
          d <= 1e-4, f": |d ln ppl| {d:.3e} (limit 1e-4) [{card}]")
    rc, out, _ = _tool_run(sls_mod, ["-m", path, "-c", "256", "-n", "8"])
    check("save-load-state", rc == 0 and b"generations identical" in out,
          f": {out.decode().strip()!r}")
    return ok


def session_phase(torch, counters, card, built, seed: int, launches: dict) -> bool:
    """The session slice on 7B q4_0 at full depth (the e2e phase's weights):
    perplexity three ways and like-for-like (session_ppl), the 2-layer model
    card vs CPU (session_ppl_vs_cpu), state round trips, sessions and the KV
    shift (session_state), the f8 cache (session_f8) and the tools
    (session_cli).  The token streams are drawn from seed; the launches of
    the perplexity and f8 runs are added to launches."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.kernels.build import BUILD_DIR
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    t0 = time.perf_counter()
    cfg, params = built or build_llama(device="cuda", seed=0, ftype="q4_0")
    rng = np.random.default_rng(seed)
    stream = rng.integers(3, cfg.n_vocab, 4 * 512)
    prompt = [1] + rng.integers(3, cfg.n_vocab, 511).tolist()
    tmp = os.path.join(BUILD_DIR, "smoke-session")
    os.makedirs(tmp, exist_ok=True)
    try:
        ok, ppl = session_ppl(torch, counters, card, cfg, params, stream, launches)
        print(f"time: session perplexity {time.perf_counter() - t0:.1f} s", flush=True)
        ok &= session_ppl_vs_cpu(torch, seed)
        print(f"time: session 2-layer {time.perf_counter() - t0:.1f} s", flush=True)
        ok &= session_state(torch, card, cfg, params, prompt, tmp)
        print(f"time: session state {time.perf_counter() - t0:.1f} s", flush=True)
        ok &= session_f8(torch, counters, card, cfg, params, stream, ppl["ondevice"],
                         launches)
        print(f"time: session f8 {time.perf_counter() - t0:.1f} s", flush=True)
        ok &= session_cli(counters, card, tmp)
        print(f"time: session cli {time.perf_counter() - t0:.1f} s", flush=True)
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def transformer_cache(torch, cfg, dtype):
    """A model's KV caches on the card, n_ctx 2048."""
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    return transformer.init_cache(cfg, 1, cfg.n_ctx, dtype=dtype, device="cuda")


# ------------------------------------------------------------------- spec

SPEC_K, SPEC_STEPS = 7, 8  # drafts a verify (T = 8 rows), rounds a chunk
# the launches of one verify forward of 7B q4_0 (4 matmuls a layer and the
# head, each at k+1 rows), and in the int8 configuration
SPEC_VERIFY = {"qmm_q4_0_kfold": 129}
SPEC_VERIFY_INT8 = {"qmm_q8x": 129, "mha_decode": 32}


def spec_prompt(seed: int, n_vocab: int, n: int = 512):
    """n token ids from seed: a 64-token pattern repeated, so that prompt
    lookup finds matches."""
    import numpy as np

    pattern = np.random.default_rng(seed).integers(3, n_vocab, 64).tolist()
    return (pattern * (n // 64 + 1))[:n]


def _clone_caches(caches):
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV

    return [QuantKV(c.data.clone(), c.scale.clone()) if isinstance(c, QuantKV) else c.clone()
            for c in caches]


def spec_twin(torch, counters, ctx, method, eager, log, draft=None):
    """Wrap ctx.<method> (verify, spec_chunk or draft_spec_chunk): each call
    also runs eager(twins, *args, **kw), the graph's eager twin (the round
    functions of runtime/device_spec.py, speculative.verify_step), on twin
    caches from the same inputs; the twins take the Contexts' caches at the
    first call, after the prefill.  Every result must equal the call's bit
    for bit (log["equal"]); the caller compares the caches after the run
    (spec_caches_equal).  The launches of each call are counted alone (the
    twin's apart) into log["path"] and, per verify round, log["rounds"].
    Returns the function that takes the wrapper off."""
    real = getattr(ctx, method)
    ctxs = [ctx] + ([draft] if draft is not None else [])

    def checked(*a, **kw):
        if log["twins"] is None:
            log["twins"] = [(_clone_caches(c.cache_k), _clone_caches(c.cache_v)) for c in ctxs]
        _add(log["path"], _read(counters))  # the prefill's, outside the wrapper
        captured = len(ctx.graphs())
        _zero(counters)
        got = real(*a, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _read(counters).items() if v}
        _add(log["path"], launched)
        _zero(counters)
        want = eager(log["twins"], *a, **kw)
        torch.cuda.synchronize()
        _zero(counters)
        rounds = kw.get("n_steps", 1)
        log["calls"] += 1
        log["equal"] += all(torch.equal(torch.as_tensor(g).cuda(), w) for g, w in zip(got, want))
        log["replayed"] += len(ctx.graphs()) == captured
        log["rounds"].append({k: v / rounds for k, v in launched.items()})
        log["rows"].add(kw["k"] + 1 if "k" in kw else a[0].shape[1])
        log["windows"].add(kw["kv_window"])
        return got

    setattr(ctx, method, checked)
    return lambda: delattr(ctx, method)


def spec_caches_equal(torch, log, ctxs) -> bool:
    """The Contexts' caches equal their twins' after a checked run."""
    return all(torch.equal(a, b) for c, (tk, tv) in zip(ctxs, log["twins"])
               for a, b in zip(_flat_cache(c.cache_k + c.cache_v), _flat_cache(tk + tv)))


def _new_log():
    return {"twins": None, "calls": 0, "equal": 0, "replayed": 0, "rounds": [], "rows": set(),
            "windows": set(), "path": {}}


def timed_run(ctxs, fn):
    """fn() with the time of every ctx.eval call (the prefills) apart:
    (fn's result, seconds of fn, seconds outside the evals)."""
    spent = [0.0]
    evals = [c.eval for c in ctxs]

    def wrap(real):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return timed

    for c, real in zip(ctxs, evals):
        c.eval = wrap(real)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        for c in ctxs:
            del c.eval
    total = time.perf_counter() - t0
    return out, total, total - spent[0]


def spec_parting(torch, cfg, params, prompt, ref, got, cache_dtype, window):
    """Where a speculative run's greedy tokens got part from the plain
    chunk's ref: (ok, text).  Equal: ok.  Else at the first difference p the
    plain replayed decode step's logits (Context.eval of ref[:p] one token a
    step after the prompt) give the top-2 margin, and verify forwards of 8
    rows whose row j predicts p (j = 0..7; the accepted prefix ref before
    it, the run's own tokens after) the largest |verify - decode| logit
    difference there; ok only when the margin is below that difference (a
    true near-tie)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    p = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if p is None:
        return len(got) == len(ref), f"equal to the plain chunk's {len(ref)} greedy tokens"
    ctx = Context(cfg, params, n_ctx=1024, device="cuda", cache_dtype=cache_dtype)
    ctx.eval([prompt])
    for t in ref[:p]:
        ctx.eval([[t]])
    dec = ctx.logits[0, -1]
    top = np.sort(dec)[::-1]
    margin = float(top[0] - top[1])
    saved = _clone_caches(ctx.cache_k + ctx.cache_v)
    seq = list(prompt) + list(ref[:p]) + list(got[p:]) + [0] * 8
    diff = 0.0
    for j in range(8):
        start = len(prompt) + p - 1 - j
        toks = torch.tensor([seq[start:start + 8]], device="cuda")
        logits = transformer.forward(cfg, ctx.params, toks, start, ctx.cache_k, ctx.cache_v,
                                     last_only=False, kv_window=window)
        diff = max(diff, float(np.abs(logits[0, j].float().cpu().numpy() - dec).max()))
        for a, b in zip(_flat_cache(ctx.cache_k + ctx.cache_v), _flat_cache(saved)):
            a.copy_(b)
    del ctx, saved
    torch.cuda.empty_cache()
    return margin < diff, (f"parts from the plain chunk at token {p} of {len(ref)} ({ref[p]} "
                           f"vs {got[p]}): the plain logits' top-2 margin {margin:.6f} against "
                           f"the largest |verify - decode| logit difference there {diff:.6f}"
                           f" ({'a near-tie' if margin < diff else 'NOT a near-tie'})")


def spec_trace(torch, card, run_chunk, n: int, label: str, unit: str) -> None:
    """torch.profiler over one call of run_chunk (n rounds or decode steps
    replayed; a first call captures, a second is timed unprofiled): device
    busy a unit against the host time a unit of the unprofiled call (idle
    share) and of the profiled one, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    run_chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_chunk()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chunk()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = _kernel_rows(prof, n)
    if not rows:
        print(f"trace: {label}: the profiler recorded no kernel time (not measured)", flush=True)
        return
    busy = sum(r[0] for r in rows)
    print(f"trace: {label}: device busy {busy:.3f} ms a {unit} of {plain:.3f} ms a {unit} on the "
          f"host clock unprofiled (idle {100 * (1 - busy / plain):.1f}%; profiled {wall:.3f}), "
          f"{sum(r[1] for r in rows)} kernels a {unit} [{card}]", flush=True)
    for ms, k, kname in rows[:6]:
        print(f"trace:   {ms:8.4f} ms/{unit}  x{k:<4d} {kname[:90]}", flush=True)


def spec_loop(torch, counters, card, cfg, params, label, run, prompt, ref, method, eager,
              want_round, cache_dtype, window, draft_cfg=None, draft_params=None):
    """One speculative loop on 7B: run(ctx, draft_ctx, stats) -> tokens, on a
    fresh Context (n_ctx 1024; and a draft Context when draft_cfg is given),
    first checked (spec_twin on ctx.<method>: every call equal to its eager
    twin bit for bit, the caches after the run, each verify round's launches
    equal to want_round, the greedy tokens against ref through spec_parting),
    then again timed: ms a token emitted after the first (the prefills
    apart).  Returns (ok, ms a token, the SpecStats, the path's launches,
    the Contexts)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.speculative import SpecStats

    ctx = Context(cfg, params, n_ctx=1024, device="cuda", cache_dtype=cache_dtype)
    dctx = (None if draft_cfg is None else
            Context(draft_cfg, draft_params, n_ctx=1024, device="cuda", cache_dtype=cache_dtype))
    ctxs = [c for c in (ctx, dctx) if c is not None]
    ptrs = [_cache_ptrs(c) for c in ctxs]
    log = _new_log()
    _zero(counters)
    off = spec_twin(torch, counters, ctx, method, eager, log, draft=dctx)
    t0 = time.perf_counter()
    stats = SpecStats()
    toks = run(ctx, dctx, stats)
    seconds = time.perf_counter() - t0
    off()
    _add(log["path"], _read(counters))
    same_cache = spec_caches_equal(torch, log, ctxs)
    rounds_ok = all(r == want_round for r in log["rounds"])
    near, parting = spec_parting(torch, cfg, params, prompt, ref, toks, cache_dtype, window)
    for c in ctxs:
        c.reset()
    timed_stats = SpecStats()
    again, total, after = timed_run(ctxs, lambda: run(ctx, dctx, timed_stats))
    ms = after / max(1, len(again) - 1) * 1e3
    same_ptrs = [_cache_ptrs(c) for c in ctxs] == ptrs
    ok = (log["calls"] > 0 and log["equal"] == log["calls"] and log["replayed"] > 0
          and same_cache and rounds_ok and near and again == toks and same_ptrs
          and len(toks) == len(ref))
    print(f"spec: {label}: {log['calls']} {method} calls ({seconds:.1f} s with the eager twin), "
          f"{log['replayed']} replayed; results equal to the eager twin bit for bit at "
          f"{log['equal']} of {log['calls']}; caches identical {same_cache}, never rebound "
          f"{same_ptrs}; a verify round's launches {json.dumps(log['rounds'][-1] if log['rounds'] else {})} "
          f"at {sorted(log['rows'])} rows (want {json.dumps(want_round)} every round: "
          f"{rounds_ok}); kv_window {sorted(log['windows'])}; {parting}; the timed run's tokens "
          f"the same {again == toks} {'ok' if ok else 'MISMATCH'}", flush=True)
    print(f"bench: spec {label} ms_per_emitted_token={ms:.3f} ({len(again) - 1} tokens after "
          f"the first in {after * 1e3:.1f} ms, prefills apart; {total * 1e3:.1f} ms in all); "
          f"{timed_stats.tokens_per_step:.3f} tokens per verify, acceptance "
          f"{timed_stats.acceptance:.3f} ({timed_stats.n_accepted}/{timed_stats.n_drafted}), "
          f"{timed_stats.n_verify} verifies [{card}]", flush=True)
    print(f"graphs: spec {label} {graph_summary(ctx)}", flush=True)
    return ok, ms, timed_stats, log["path"], ctx, dctx


def spec_plain(torch, card, cfg, params, prompt, n, cache_dtype):
    """The plain greedy references on a fresh Context (n_ctx 1024): the
    on-device chunk (generate_ondevice, chunk 16; its tokens are the
    speculative runs' reference), then timed again (ms a token: the
    decode_chunk calls over their tokens), and the host loop generate of the
    replayed step (Timings.t_eval_ms a decode token).  Returns (tokens,
    chunk ms a token, step ms a token, the Context)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, generate_ondevice
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    ctx = Context(cfg, params, n_ctx=1024, device="cuda", cache_dtype=cache_dtype)
    ds = DeviceSampling(temp=-1.0)
    ref = generate_ondevice(ctx, prompt, n, sampling=ds, chunk=16, eos_token=-1)
    ctx.reset()
    real, spent = ctx.decode_chunk, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        spent.append((time.perf_counter() - t0, kw["n_steps"]))
        return out

    ctx.decode_chunk = timed
    again = generate_ondevice(ctx, prompt, n, sampling=ds, chunk=16, eos_token=-1)
    del ctx.decode_chunk
    chunk_ms = sum(t for t, _ in spent) / sum(s for _, s in spent) * 1e3
    ctx.reset()
    ctx.timings = type(ctx.timings)()
    greedy = SamplingParams(temp=0.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    host = list(generate(ctx, prompt, GenerateParams(n_predict=n, ignore_eos=True,
                                                     sampling=greedy), eos_token=-1))
    step_ms = ctx.timings.t_eval_ms / ctx.timings.n_eval
    agree = next((i for i, (a, b) in enumerate(zip(ref, host)) if a != b), len(ref))
    print(f"bench: spec plain references ({len(prompt)} + {n}): on-device chunk 16 "
          f"{chunk_ms:.3f} ms/token (tokens the same again {again == ref}); the replayed step "
          f"through generate {step_ms:.3f} ms/token (greedy tokens agreeing with the chunk's "
          f"before the first difference: {agree} of {n}) [{card}]", flush=True)
    return ref, chunk_ms, step_ms, ctx


def spec_runs(torch, counters, card, cfg, params, prompt, n, cache_dtype, want, loops, tag):
    """The plain references, then each speculative loop of loops (names of
    "host", "ondevice", "self_draft", "draft_2layer", "draft_other": the
    host loop, prompt lookup on the card, the target as its own draft, its
    first 2 blocks as the draft, a 2-layer model of other weights as the
    draft) through spec_loop on them; the on-device loop's round and the
    plain chunk's decode step then under the profiler.  Returns (ok, the
    path's launches)."""
    import dataclasses

    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models.transformer import TransformerParams
    from llama_cpp_q_4_0_tpu_torch.runtime import device_spec, speculative
    from llama_cpp_q_4_0_tpu_torch.runtime.context import _bucket
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    ds = DeviceSampling(temp=-1.0)
    # the kv_window of every call of the runs: the bucket of the run's end
    window = min(_bucket(len(prompt) + n + 1), 1024)
    sp = speculative.SpecParams(n_draft=SPEC_K)
    ref, chunk_ms, step_ms, plain = spec_plain(torch, card, cfg, params, prompt, n, cache_dtype)
    path = {}
    ok = True

    def verify_twin(tw, tokens, n_past, key, recent=None, *, ds, kv_window):
        x = torch.from_numpy(np.atleast_2d(np.asarray(tokens, np.int64))).cuda()
        return speculative.verify_step(cfg, params, x, n_past, tw[0][0], tw[0][1], key,
                                       recent if ds.penalized else None, ds=ds,
                                       kv_window=kv_window)

    def chunk_twin(tw, hist, n_hist, key, done, sv=None, **kw):
        out = device_spec.spec_chunk(cfg, params, hist, n_hist, tw[0][0], tw[0][1], key, done,
                                     sv, **kw)
        return tuple(out[i] for i in (0, 1, 4, 5, 6, 7, 8))

    def draft_twin(tw, draft, tok, n_past, key, done, recent, **kw):
        out = device_spec.draft_spec_chunk(cfg, params, draft.cfg, draft.params, tok, n_past,
                                           tw[0][0], tw[0][1], tw[1][0], tw[1][1], key, done,
                                           recent, **kw)
        return tuple(out[i] for i in (0, 1, 6, 7, 8, 9, 10))

    two = TransformerParams(tok_embeddings=params.tok_embeddings, blocks=params.blocks[:2],
                            out_norm_w=params.out_norm_w, out_norm_b=params.out_norm_b,
                            output=params.output)
    other = build_llama(n_layer=2, n_embd=cfg.n_embd, n_head=cfg.n_head, n_ff=cfg.n_ff,
                        n_vocab=cfg.n_vocab, device="cuda", seed=1, ftype="q4_0") \
        if "draft_other" in loops else (None, None)
    def host(c, d, st, cnt):
        return speculative.generate_speculative(c, prompt, cnt, sampling=ds, spec=sp,
                                                ignore_eos=True, stats=st)

    def ondevice(c, d, st, cnt):
        return device_spec.generate_ondevice_spec(c, prompt, cnt, sampling=ds, spec=sp,
                                                  n_steps=SPEC_STEPS, ignore_eos=True, stats=st)

    def drafted(c, d, st, cnt):
        return device_spec.generate_ondevice_spec_draft(c, d, prompt, cnt, sampling=ds,
                                                        n_draft=SPEC_K, n_steps=SPEC_STEPS,
                                                        ignore_eos=True, stats=st)

    small = {"qmm_q4_0_kfold": 129 + (SPEC_K + 1) * 9}  # 8 steps of a 2-layer draft, a verify
    # name: (label, the Context method checked, its eager twin, a round's launches, the
    # draft model, the loop, the tokens it generates)
    table = {
        "host": ("host loop (generate_speculative, prompt lookup, k 7)", "verify", verify_twin,
                 want, None, None, host, n),
        "ondevice": ("generate_ondevice_spec (k 7, n_steps 8)", "spec_chunk", chunk_twin, want,
                     None, None, ondevice, n),
        "self_draft": ("generate_ondevice_spec_draft, the target as its own draft",
                       "draft_spec_chunk", draft_twin,
                       {k: v * (SPEC_K + 2) for k, v in want.items()}, cfg, params, drafted, n),
        "draft_2layer": ("generate_ondevice_spec_draft, a 2-layer draft of the target's first "
                         "blocks", "draft_spec_chunk", draft_twin, small,
                         dataclasses.replace(cfg, n_layer=2), two, drafted, n),
        # every draft rejected: a round a token, so 32 tokens
        "draft_other": ("generate_ondevice_spec_draft, a 2-layer draft of other weights (seed "
                        "1)", "draft_spec_chunk", draft_twin, small, other[0], other[1], drafted,
                        32),
    }
    res = {}
    for name in loops:
        label, method, eager, want_round, dcfg, dparams, loop, cnt = table[name]
        good, ms, st, launched, ctx, dctx = spec_loop(
            torch, counters, card, cfg, params, f"{tag} {label}",
            lambda c, d, st, loop=loop, cnt=cnt: loop(c, d, st, cnt), prompt, ref[:cnt], method,
            eager, want_round, cache_dtype, window, dcfg, dparams)
        ok &= good
        _add(path, launched)
        res[name] = (ms, st)
        if name == "ondevice":
            # one chunk of 8 rounds replayed under the profiler, from the run's end
            hist = torch.zeros((1, 1024), dtype=torch.int64, device="cuda")
            seq = list(prompt) + ref
            hist[0, :len(seq)] = torch.tensor(seq)
            m = torch.tensor([len(seq) - 64], device="cuda")
            kw = dict(k=SPEC_K, n_steps=SPEC_STEPS, ds=ds, kv_window=window, max_ngram=3,
                      min_ngram=1, eos=-1, ignore_eos=True)
            spec_trace(torch, card, lambda: ctx.spec_chunk(
                hist, m, prng_key(0, "cuda"), torch.zeros(1, dtype=torch.bool, device="cuda"),
                **kw), SPEC_STEPS, f"spec {tag} a verify round (generate_ondevice_spec's graph, "
                f"T=8, kv_window {window})", "round")
        del ctx, dctx
        torch.cuda.empty_cache()
    tok = torch.full((1,), ref[-1], dtype=torch.int64, device="cuda")
    spec_trace(torch, card, lambda: plain.decode_chunk(
        tok, len(prompt) + 32, prng_key(0, "cuda"), n_steps=16, ds=ds, kv_window=window), 16,
        f"spec {tag} a plain decode step (the on-device chunk's graph, kv_window {window})",
        "token")
    del plain
    torch.cuda.empty_cache()
    line = "; ".join(f"{k} {ms:.3f} ({st.tokens_per_step:.2f} tokens/verify)"
                     for k, (ms, st) in res.items())
    print(f"bench: spec {tag} ms per emitted token: {line}; beside the replayed step "
          f"{step_ms:.3f} and the on-device chunk {chunk_ms:.3f} [{card}]", flush=True)
    return ok, path


def lora_tensors(seed: int, n_layer: int, e: int = 4096, r: int = 16):
    """A rank-r ggla adapter's tensors from seed on wq, wk, wv and wo of
    every block (A stored [K, r], B [N, r]; deltas of the weights' size)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for layer in range(n_layer):
        for name in ("wq", "wk", "wv", "wo"):
            base = f"layers.{layer}.attention.{name}.weight"
            out[base + ".loraA"] = (rng.standard_normal((e, r)) * 0.02).astype(np.float32)
            out[base + ".loraB"] = (rng.standard_normal((e, r)) * 0.02).astype(np.float32)
    return out


def spec_lora_7b(torch, counters, card, cfg, params, seed) -> bool:
    """The unmerged adapter (lora_tensors, 32 blocks) on the 32-layer
    synthetic model: the replayed decode step's ms/token with the adapter
    and without it (kv_window 256, n_past 128), the adapted step's launches
    (each of wq, wk, wv unfused: 193 K2 a token), and the bases untouched
    (the same tensors, data_ptr and bytes)."""
    import statistics

    from llama_cpp_q_4_0_tpu_torch.formats.ggla import GglaFile
    from llama_cpp_q_4_0_tpu_torch.models.fuse import defuse_projections, fuse_projections
    from llama_cpp_q_4_0_tpu_torch.models.lora import apply_lora
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    base = defuse_projections(cfg, params)
    before = {(i, f): (getattr(b, f), getattr(b, f).levels_t.data_ptr(),
                       getattr(b, f).levels_t.clone())
              for i, b in enumerate(base.blocks) if i in (0, 31) for f in ("wq", "wo")}
    adapted = fuse_projections(cfg, apply_lora(
        base, GglaFile(16, 32, lora_tensors(seed, cfg.n_layer, cfg.n_embd)), merge=False))
    ms = {}
    for label, p in (("without", params), ("with", adapted)):
        ctx = Context(cfg, p, n_ctx=1024, device="cuda")
        runs = []
        for i in range(4):
            ctx.n_past = 128
            _zero(counters)
            t0 = time.perf_counter()
            for _ in range(64):
                ctx.eval([[7]])
            if i:
                runs.append((time.perf_counter() - t0) / 64 * 1e3)
        per_token = {k: v // 64 for k, v in _read(counters).items() if v}
        ms[label] = (statistics.median(runs), per_token)
        del ctx
    untouched = all(adapted.blocks[i].__dict__[f].base is w and w.levels_t.data_ptr() == ptr
                    and torch.equal(w.levels_t, saved)
                    for (i, f), (w, ptr, saved) in before.items())
    ok = (untouched and ms["with"][1] == {"qmm_q4_0_kfold": 6 * cfg.n_layer + 1}
          and ms["without"][1] == {"qmm_q4_0_kfold": 4 * cfg.n_layer + 1})
    print(f"bench: spec lora 7B q4_0 replayed decode_ms_per_token (kv_window 256, n_past 128-191) "
          f"with an unmerged rank-16 adapter on wq, wk, wv, wo of 32 blocks "
          f"{ms['with'][0]:.3f} (launches a token {json.dumps(ms['with'][1])}), without "
          f"{ms['without'][0]:.3f} ({json.dumps(ms['without'][1])}); the bases untouched (the "
          f"same tensors, data_ptr and bytes) {untouched} {'ok' if ok else 'MISMATCH'} [{card}]",
          flush=True)
    del adapted, base
    torch.cuda.empty_cache()
    return ok


def spec_cli(counters, path) -> bool:
    """`main --draft 7` on the card, greedy, 24 tokens of the GGJT at path:
    the host loop, --ondevice-sampling (the loop on the card) and
    --draft-model (the file as its own draft), each with rc 0, its stats
    line and K2 launched; the text beside plain `main`'s (printed)."""
    from llama_cpp_q_4_0_tpu_torch.cli import main as main_mod

    base = ["-m", path, "-p", "Once upon a time", "-n", "24", "-c", "256", "--temp", "0",
            "-s", "1", "--ignore-eos", "--device", "cuda"]
    _, plain, _ = _tool_run(main_mod, base)
    ok = True
    for extra in (["--draft", "7"], ["--draft", "7", "--ondevice-sampling"],
                  ["--draft", "7", "--draft-model", path, "--ondevice-sampling"]):
        _zero(counters)
        rc, out, err = _tool_run(main_mod, [*base, *extra])
        launched = {k: v for k, v in _read(counters).items() if v}
        stats = next((l for l in err.splitlines() if l.startswith("speculative:")), None)
        good = rc == 0 and stats is not None and launched.get("qmm_q4_0_kfold", 0) > 0
        ok &= good
        print(f"spec: main {' '.join(extra)} -n 24 on the card: rc {rc}, {stats!r}, launches "
              f"{json.dumps(launched)}; text the same as plain main's {out == plain} "
              f"{'ok' if good else 'FAILED'}", flush=True)
    return ok


def spec_lora_2layer(torch, counters, seed, tmp) -> bool:
    """On the tools phase's 2-layer 7B-width q4_0 GGJT (write_ggjt_7b_width):
    `main --draft` on the card (spec_cli); with a rank-16 ggla adapter on
    wq, wk, wv and wo of both blocks (lora_tensors): `main --lora` merged
    and `--lora-unmerged`, -n 3,
    --memory-f32, on the card in this process and on the CPU in two child
    processes of 4 threads each that run meanwhile (waited for, or killed on
    an error), the same text; then, on the unmerged adapted params,
    EmbdInput (eval_tokens, eval_float of 4 projected rows, generate 2
    greedy tokens) on the card and on the CPU: the same tokens, and the
    logits after eval_float within two_layer_vs_cpu's limit (2e-2 of the CPU
    logits' scale)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.cli import main as main_mod
    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu_torch.formats.ggla import write_ggla
    from llama_cpp_q_4_0_tpu_torch.models.fuse import fuse_projections
    from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
    from llama_cpp_q_4_0_tpu_torch.models.lora import apply_lora
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.embd_input import EmbdInput, LinearProjector
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    path = os.path.join(tmp, "llama7b-width-2layer-q4_0.ggjt")
    adapter = os.path.join(tmp, "adapter.ggla")
    write_ggjt_7b_width(path, "q4_0")
    write_ggla(adapter, 16, 32, lora_tensors(seed, 2))
    modes = {"merged": [], "--lora-unmerged": ["--lora-unmerged"]}
    args = ["-m", path, "-p", "Hello", "-n", "3", "-c", "256", "--temp", "0", "-s", "1",
            "--memory-f32", "--lora", adapter]
    t0 = time.perf_counter()
    cpu = {mode: subprocess.Popen(
        [sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args, *extra, "--device",
         "cpu"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "OMP_NUM_THREADS": "4"}) for mode, extra in modes.items()}
    ok = True
    try:
        card_out = {}
        for mode, extra in modes.items():
            _zero(counters)
            t1 = time.perf_counter()
            rc, out, _ = _tool_run(main_mod, [*args, *extra, "--device", "cuda"])
            card_out[mode] = (rc, out, {k: v for k, v in _read(counters).items() if v},
                              time.perf_counter() - t1)
        ok &= spec_cli(counters, path)
        gf = read_ggjt(path)
        cfg = config_from_ggjt(gf, n_ctx=256)
        rng = np.random.default_rng(seed)
        proj = LinearProjector(rng.standard_normal((cfg.n_embd, 64)).astype(np.float32) * 0.05)
        feats = rng.standard_normal((4, 64)).astype(np.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            p = fuse_projections(cfg, apply_lora(load_transformer(gf, cfg, device=dev,
                                                                  fuse=False),
                                                 adapter, merge=False))
            m = EmbdInput(Context(cfg, p, n_ctx=256, device=dev, cache_dtype=torch.float32),
                          None, SamplingParams(temp=0.0))
            m.eval_tokens([1, 15043, 29892])
            m.eval_float(proj(feats))
            res[dev] = (m.ctx.logits.copy(), list(m.generate(2, eos_token=-1)))
            del m, p
        for mode, proc in cpu.items():
            out, err = proc.communicate(timeout=600)
            sys.stderr.write(err.decode(errors="replace"))
            rc, card_text, launched, secs = card_out[mode]
            good = (rc == proc.returncode == 0 and card_text == out
                    and launched.get("qmm_q4_0_kfold", 0) > 0)
            ok &= good
            print(f"spec: main --lora ({mode}) -n 3 card vs CPU: card {card_text!r} ({secs:.1f} s, "
                  f"launches {json.dumps(launched)}), CPU {out!r} (a child process, "
                  f"{time.perf_counter() - t0:.1f} s after both started) "
                  f"{'ok' if good else 'MISMATCH'}", flush=True)
    finally:
        for proc in cpu.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    scale = float(np.abs(res["cpu"][0]).max())
    dev_max = float(np.abs(res["cuda"][0] - res["cpu"][0]).max())
    good = dev_max <= 2e-2 * scale and res["cuda"][1] == res["cpu"][1]
    ok &= good
    print(f"spec: EmbdInput over the unmerged adapter (eval_tokens 3, eval_float 4 rows, generate "
          f"2) card vs CPU: logits after eval_float max |d| {dev_max:.3e} (limit 2e-2 x "
          f"{scale:.3f}), tokens {res['cuda'][1]} vs {res['cpu'][1]} "
          f"{'ok' if good else 'MISMATCH'}", flush=True)
    return ok


def spec_phase(torch, counters, card, built, seed: int, launches: dict) -> bool:
    """Speculative decoding and LoRA on 7B q4_0 at full depth (the e2e
    phase's weights; built from seed 0 alone), n_ctx 1024, bf16 cache: the
    prompt of spec_prompt(seed), 128 greedy tokens through the host loop,
    generate_ondevice_spec, and generate_ondevice_spec_draft with the target
    as its own draft, with its first 2 blocks and with a 2-layer model of
    other weights as the draft (spec_runs);
    the int8 configuration (QMM_Q8X=1, FUSED_ATTN=1, q8 cache) 128 + 64
    through generate_ondevice_spec (129 K7 + 32 K4 a verify round); the
    unmerged adapter on the 32-layer model (spec_lora_7b) and the 2-layer
    GGJT's LoRA and embd-input card vs CPU (spec_lora_2layer).  The path's
    launches (the runs', not their twins') are added to launches."""
    from llama_cpp_q_4_0_tpu_torch.kernels.build import BUILD_DIR
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    t0 = time.perf_counter()
    cfg, params = built or build_llama(device="cuda", seed=0, ftype="q4_0")
    prompt = spec_prompt(seed, cfg.n_vocab)
    ok, path = spec_runs(torch, counters, card, cfg, params, prompt, 128, torch.bfloat16,
                         SPEC_VERIFY, ("host", "ondevice", "self_draft", "draft_2layer",
                                       "draft_other"), "q4_0")
    print(f"time: spec q4_0 {time.perf_counter() - t0:.1f} s", flush=True)
    with env(**INT8):
        ok8, path8 = spec_runs(torch, counters, card, cfg, params, prompt[:128], 64, torch.int8,
                               SPEC_VERIFY_INT8, ("ondevice",), "q4_0 int8-config")
    ok &= ok8
    _add(path, path8)
    print(f"time: spec int8 {time.perf_counter() - t0:.1f} s", flush=True)
    ok &= spec_lora_7b(torch, counters, card, cfg, params, seed)
    print(f"time: spec lora 7B {time.perf_counter() - t0:.1f} s", flush=True)
    tmp = os.path.join(BUILD_DIR, "smoke-spec")
    os.makedirs(tmp, exist_ok=True)
    try:
        ok &= spec_lora_2layer(torch, counters, seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill", "qmm_q8x", "mha_decode")
    ok &= all(path.get(k, 0) > 0 for k in kernels)
    _add(launches, {k: path.get(k, 0) for k in kernels})
    print(f"spec: the path's launches (the runs', their twins apart) {json.dumps(path)}; every "
          f"kernel of the path launched {all(path.get(k, 0) > 0 for k in kernels)}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ok


# ------------------------------------------------------------------ serve

SERVE_SLOTS, SERVE_CTX, SERVE_N = 16, 2048, 64
# the launches of one [n_slots, 1] tick forward (4 matmuls a layer and the
# head at b = n_slots; a verify round of 4 slots x 8 rows is b = 32), and a
# decode step in the int8 configuration
SERVE_TICK = {"qmm_q4_0_kfold": 129}
SERVE_TICK_INT8 = {"qmm_q8x": 129, "mha_decode": 32}
SERVE_CHECKED = 3  # calls of each kind a run holds against their eager twins
# the int8 pass's prompt lengths: 4 short, and 4 long of three lane chunks
SERVE_INT8_LENS = ((150, 400), (1100, 1500))


def serve_prompts(seed: int, n_vocab: int):
    """20 prompts from seed, in the order of one burst: the first 16 fill
    the slots, 8 short ones (32-256 tokens: one batched [8, 256] admission,
    MAX_PALLAS_ROWS rows) between 8 long ones (520-900: two chunks each of
    the chunked lane, one prompt at a time on a bf16 cache; 900 + 64 tokens
    keep a chunked tick's window at 1024, where the default attention over
    16 rows costs half its 2048 figure); 4 short ones (257-479) wait behind
    them and admit as slots free."""
    import numpy as np

    rng = np.random.default_rng(seed + 16)
    short, long_ = rng.integers(32, 257, 8), rng.integers(520, 901, 8)
    lens = [int(x) for pair in zip(short, long_) for x in pair]
    lens += [int(x) for x in rng.integers(257, 480, 4)]
    return [[1] + rng.integers(3, n_vocab, n_tok - 1).tolist() for n_tok in lens]


def serve_reference(cfg, params, prompts, n: int, cache_dtype):
    """Each prompt's greedy tokens through a single-session Context (n_ctx
    2048, EOS ends it, as in the engine) with the logits of every step."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    ctx = Context(cfg, params, n_ctx=SERVE_CTX, device="cuda", cache_dtype=cache_dtype)
    out = []
    for prompt in prompts:
        ctx.reset()
        logits = ctx.eval([prompt])[0, -1]
        toks, rows = [], []
        for _ in range(n):
            rows.append(logits)
            t = int(np.argmax(logits))
            if t == 2:
                break
            toks.append(t)
            logits = ctx.eval([[t]])[0, -1]
        out.append((toks, rows))
    del ctx
    return out


def serve_checks(torch, counters, eng, log):
    """Wrap the engine: every tick (the Context's "tick" step), chunk and
    speculative round it runs, up to SERVE_CHECKED of each, also runs its
    eager twin on a copy of the caches from the same inputs (the results
    and the caches after must equal bit for bit); every call's launches are
    counted alone (the twin's apart) by kind, and every admission forward's
    by route (log["route"]: batched, slot, prefix or lane) against the
    count its shape predicts: 4 matmuls a layer at the call's rows and the
    head at its batch's, each K1 above 32 rows and K2 at 32 or fewer (K7 up
    to 128 rows under QMM_Q8X=1), and K3 a layer where the flash prefill is
    taken.
    Returns the function that takes the wrappers off."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.models import transformer
    from llama_cpp_q_4_0_tpu_torch.runtime import device_sample, device_spec

    ctx = eng.ctx
    real = {"tick": ctx._run, "chunk": ctx.decode_chunk, "spec": ctx.spec_chunk}

    def eager(kind, twins, a, kw):
        ck, cv = twins
        if kind == "tick":
            call = a[0]
            return [transformer.forward(
                ctx.cfg, call.params, torch.from_numpy(call.x).cuda(),
                torch.from_numpy(np.asarray(call.n_past)).cuda(), ck, cv,
                last_only=True, kv_window=call.kv_window)]
        if kind == "chunk":
            kw = {k: v for k, v in kw.items() if k != "to_host"}
            toks, _, _, key, recent, mu = device_sample.decode_chunk(
                ctx.cfg, ctx.params, *a[:2], ck, cv, a[2], **kw)
            return [toks, key, recent, mu]
        out = device_spec.spec_chunk(ctx.cfg, ctx.params, *a[:2], ck, cv, *a[2:], **kw)
        return [out[0], out[1], *out[4:]]

    def wrap(kind):
        def checked(*a, **kw):
            check = log["checked"][kind] < SERVE_CHECKED
            twins = ((_clone_caches(ctx.cache_k), _clone_caches(ctx.cache_v)) if check
                     else None)
            torch.cuda.synchronize()
            _zero(counters)
            got = real[kind](*a, **kw)
            torch.cuda.synchronize()
            launched = {k: v for k, v in _read(counters).items() if v}
            _add(log["path"], launched)
            steps = kw.get("n_steps", 1)
            per = {k: v // steps for k, v in launched.items()}
            log["per_step"][kind].append(per if all(v % steps == 0 for v in launched.values())
                                         else launched)
            if check:
                got_l = [got] if kind == "tick" else list(got)
                _zero(counters)
                want = eager(kind, twins, a, kw)
                torch.cuda.synchronize()
                same = all(torch.equal(torch.as_tensor(g).cuda(), w)
                           for g, w in zip(got_l, want))
                same &= all(torch.equal(x, y) for x, y in zip(
                    _flat_cache(ctx.cache_k + ctx.cache_v), _flat_cache(twins[0] + twins[1])))
                log["checked"][kind] += 1
                log["equal"][kind] += same
                del twins
            _zero(counters)
            return got
        return checked

    ctx._run, ctx.decode_chunk, ctx.spec_chunk = wrap("tick"), wrap("chunk"), wrap("spec")
    real_fwd = eng._forward

    def fwd(params, toks, n_past, ck, cv, *, kv_window, last, attention_fn=None):
        torch.cuda.synchronize()
        _zero(counters)
        out = real_fwd(params, toks, n_past, ck, cv, kv_window=kv_window, last=last,
                       attention_fn=attention_fn)
        torch.cuda.synchronize()
        got = {k: v for k, v in _read(counters).items() if v}
        _add(log["path"], got)
        m, t = toks.shape
        q8x = os.environ.get("QMM_Q8X") == "1"  # K7 up to 128 rows (QMM_Q8X_MAX_B)

        def kernel(rows):
            if q8x and rows <= 128:
                return "qmm_q8x"
            return "qmm_q4_0" if rows > 32 else "qmm_q4_0_kfold"

        want, n_layer = {}, eng.cfg.n_layer
        for k, n in ((kernel(m * t), 4 * n_layer), (kernel(m), 1),
                     ("flash_prefill", n_layer if attention_fn is not None else 0)):
            if n:
                want[k] = want.get(k, 0) + n
        name = "prefix" if log["route"] == "slot" and n_past else log["route"]
        log["admits"].setdefault(name, []).append((m, t, got == want))
        _zero(counters)
        return out

    def routed(name, fn):
        def call(*a, **kw):
            before, log["route"] = log["route"], name
            try:
                return fn(*a, **kw)
            finally:
                log["route"] = before
        return call

    eng._forward = fwd
    eng._admit_batched = routed("batched", eng._admit_batched)
    eng._admit_one = routed("slot", eng._admit_one)
    eng._continue_prefill = routed("lane", eng._continue_prefill)
    return lambda: [delattr(o, n) for o, n in ((ctx, "_run"), (ctx, "decode_chunk"),
                                               (ctx, "spec_chunk"), (eng, "_forward"),
                                               (eng, "_admit_batched"), (eng, "_admit_one"),
                                               (eng, "_continue_prefill"))]


def _serve_log():
    kinds = ("tick", "chunk", "spec")
    return {"checked": dict.fromkeys(kinds, 0), "equal": dict.fromkeys(kinds, 0),
            "per_step": {k: [] for k in kinds}, "admits": {}, "path": {}, "route": None,
            "ttft": {}}


def serve_submit(eng, prompts, n):
    """Every prompt as a greedy request (EOS ends it), submitted as one
    burst before the engine starts (so that the admissions' routes follow
    from the prompts alone), then read; the engine is stopped after.
    Returns (tokens by request, the seconds from the start to each first
    token)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import Request
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    greedy = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    reqs = [eng.submit(Request(list(p), n_predict=n, sampling=greedy)) for p in prompts]
    t0 = time.perf_counter()
    eng.start()
    outs, ttft = [], []
    try:
        for r in reqs:
            out, first = [], None
            for t in r.tokens(timeout=300):
                first = first or time.perf_counter()
                out.append(t)
            outs.append(out)
            ttft.append((first or time.perf_counter()) - t0)
    finally:
        eng.stop()
    return outs, ttft


def serve_parting(refs, outs, limit: float):
    """Each request's tokens against its single session's: (equal, near-tie
    partings, unexplained).  A parting at token p is a near tie when the
    single session's top-2 logit margin there is at most limit."""
    import numpy as np

    same = near = bad = 0
    notes = []
    for i, ((ref, rows), got) in enumerate(zip(refs, outs)):
        p = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b), None)
        if p is None and len(ref) == len(got):
            same += 1
            continue
        if p is None:
            p = min(len(ref), len(got))
        top = np.sort(rows[p])[::-1] if p < len(rows) else None
        margin = float(top[0] - top[1]) if top is not None else float("inf")
        if margin <= limit:
            near += 1
        else:
            bad += 1
        notes.append(f"request {i} parts at token {p} (margin {margin:.5f}"
                     f"{' <=' if margin <= limit else ' >'} {limit:.5f})")
    return same, near, bad, notes


def serve_mode(torch, counters, card, eng, label, prompts, refs, limit, want_step, kind,
               n=SERVE_N):
    """One checked run of the engine over one burst of prompts: the ticks'
    eager twins and launches a step (want_step), the admissions' launches
    by route, each request's tokens against its single session (refs;
    partings must be near ties, margin <= limit; with limit None the limit
    is the agreement of the engine's own host-sampled logits with the
    single session's, measured in this run), the caches never rebound, no
    request open after stop.  Returns (ok, limit, log); log["ttft"] holds
    the seconds to each request's first token by admission route."""
    import numpy as np

    log = _serve_log()
    off = serve_checks(torch, counters, eng, log)
    route_of, emitted = {}, {}
    real_activate, real_emit = eng._activate, eng._emit

    def activate(slot, req, prompt, row_logits):
        pre = eng._prefix
        route_of[req.id] = ("prefix" if pre is not None and prompt[:len(pre[0])] == pre[0]
                            else log["route"])
        return real_activate(slot, req, prompt, row_logits)

    def emit(slot, row_logits):
        emitted.setdefault(slot.req.id, []).append(np.asarray(row_logits))
        return real_emit(slot, row_logits)

    eng._activate = activate
    if limit is None:
        eng._emit = emit
    ptrs = [t.data_ptr() for t in _flat_cache(eng.cache_k + eng.cache_v)]
    t0 = time.perf_counter()
    try:
        outs, ttft = serve_submit(eng, prompts, n)
    finally:
        off()
        del eng._activate
        eng.__dict__.pop("_emit", None)
    secs = time.perf_counter() - t0
    scale = None
    if limit is None:
        limit, scale = serve_agreement(refs, [emitted.get(i, []) for i in range(len(prompts))])
    same_ptrs = ptrs == [t.data_ptr() for t in _flat_cache(eng.cache_k + eng.cache_v)]
    same, near, bad, notes = serve_parting(refs, outs, limit)
    steps = log["per_step"][kind]
    steps_ok = bool(steps) and all(s == want_step for s in steps)
    twins_ok = log["checked"][kind] > 0 and log["equal"] == log["checked"]
    admits_ok = all(ok for v in log["admits"].values() for *_, ok in v)
    open_after = eng.n_active + len(eng._pending)
    ok = (twins_ok and steps_ok and admits_ok and bad == 0 and same_ptrs and open_after == 0
          and all(len(o) > 0 for o in outs) and (scale is None or limit <= 0.05 * scale))
    for i, r in route_of.items():
        log["ttft"].setdefault(r, []).append(ttft[i])
    st = eng.stats()
    routes = {k: f"{len(v)} at {sorted({(m, t) for m, t, _ in v})[:4]}"
              for k, v in log["admits"].items()}
    agree = (f"; the engine's logits within {limit:.5f} of the single session's where the "
             f"tokens agree (logits up to {scale:.3f}): the agreement limit"
             if scale is not None else f"; near ties: margin <= {limit:.5f}")
    print(f"serve: {label}: {len(prompts)} requests in {secs:.1f} s ({st['n_ticks']} ticks, "
          f"{st['n_tokens_out']} tokens); calls held against the eager twin {log['checked']}, "
          f"equal {log['equal']}; {kind} launches a step {json.dumps(steps[-1] if steps else {})} "
          f"at every one of {len(steps)} (want {json.dumps(want_step)}: {steps_ok}); admission "
          f"forwards by route {routes}, launches as predicted {admits_ok}{agree}; against the "
          f"single session: {same} equal, {near} near-tie partings, {bad} unexplained"
          f"{'; ' + '; '.join(notes[:4]) if notes else ''}; caches never rebound {same_ptrs}; "
          f"open after stop {open_after} {'ok' if ok else 'MISMATCH'} [{card}]", flush=True)
    for r, v in sorted(log["ttft"].items()):
        print(f"serve: {label} time to first token, {r} admissions, one burst of "
              f"{len(prompts)}: median {statistics.median(v) * 1e3:.1f} ms, min "
              f"{min(v) * 1e3:.1f}, max {max(v) * 1e3:.1f} over {len(v)} [{card}]", flush=True)
    return ok, limit, log


def serve_occupancy(torch, eng, label, card, n_vocab, profile_at=None, levels=(1, 4, 8, 16)):
    """Tokens/s summed over the slots and ms a tick at each occupancy of
    levels on a fresh engine eng (a chunked tick's window follows every slot's
    last position, the idle ones' too, as in the JAX engine): k requests of
    128-token prompts (window 256), SERVE_N greedy tokens each, timed from
    the moment every request has its first token to the last token.
    At profile_at the same window runs under torch.profiler (the device's
    busy time a tick and its idle share, the top kernels)."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import Request
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    greedy = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    rng = np.random.default_rng(5)
    if profile_at:  # the profiler's first session in a process may record no device time
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    eng.start()
    try:
        for k in levels:
            step_ms = None
            for traced in ((False, True) if k == profile_at else (False,)):
                # the traced pass is short (8 host ticks, 2 chunked ones): the
                # profiler's own cost grows with the kernels it records; it
                # stops once the engine is idle again
                n_pred = SERVE_N if not traced else 9 if eng.chunk == 1 else 2 * eng.chunk + 1
                reqs = [eng.submit(Request([1] + rng.integers(3, n_vocab, 127).tolist(),
                                           n_predict=n_pred, sampling=greedy))
                        for _ in range(k)]
                firsts = [r.out.get(timeout=300) for r in reqs]  # None: done at once
                n0, t0 = eng.n_ticks, time.perf_counter()
                if traced:
                    from torch.profiler import ProfilerActivity, profile

                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.__enter__()
                outs = [[] if f is None else list(r.tokens(timeout=300))
                        for r, f in zip(reqs, firsts)]
                while eng._inflight or eng.n_active:  # the engine idle again
                    time.sleep(0.01)
                torch.cuda.synchronize()
                if traced:
                    prof.__exit__(None, None, None)
                secs = time.perf_counter() - t0
                ticks = max(1, eng.n_ticks - n0)
                toks = sum(len(o) + (len(f) - 1 if isinstance(f, list) else 0)
                           for o, f in zip(outs, firsts))
                if not traced:
                    step_ms = secs * 1e3 / ticks / eng.chunk
                    print(f"serve: {label} occupancy {k}: {toks / secs:.1f} tokens/s summed "
                          f"over the slots, {secs * 1e3 / ticks:.3f} ms a tick ({ticks} ticks, "
                          f"{toks} tokens after the first, {secs:.3f} s) [{card}]", flush=True)
                    continue
                rows = _kernel_rows(prof, 1)
                # K2 launches 4 a layer and 1 for the head a step
                steps = (sum(n for _, n, key in rows if "PackedGemv" in key)
                         / (4 * eng.cfg.n_layer + 1))
                if not rows or not steps:
                    print(f"trace: serve {label}: the profiler recorded no kernel time "
                          f"(not measured)", flush=True)
                    continue
                busy = sum(r[0] for r in rows) / steps
                print(f"trace: serve {label} occupancy {k}: device busy {busy:.3f} ms a step "
                      f"of {step_ms:.3f} ms unprofiled (idle {100 * (1 - busy / step_ms):.1f}%),"
                      f" {sum(r[1] for r in rows) / steps:.0f} kernels a step ({steps:.1f} "
                      f"steps profiled) [{card}]", flush=True)
                for ms, n, key in rows[:6]:
                    print(f"trace:   {ms / steps:8.4f} ms/step  x{n / steps:<6.1f} {key[:90]}",
                          flush=True)
    finally:
        eng.stop()


def serve_agreement(refs, outs_logits):
    """The largest |engine - single session| logit difference over the
    steps where a request's tokens still agree, and the largest logit
    magnitude there: the engine path's agreement with the single session."""
    import numpy as np

    diff = scale = 0.0
    for (ref, rows), got in zip(refs, outs_logits):
        for j, (r, g) in enumerate(zip(rows, got)):
            if j >= len(ref) or g.argmax() != ref[j]:
                break
            diff = max(diff, float(np.abs(r - g).max()))
            scale = max(scale, float(np.abs(r).max()))
    return diff, scale


def serve_server(torch, counters, card, seed) -> bool:
    """`server --parallel 4 --parallel-chunk 8` on a 2-layer 7B-width q4_0
    GGJT (cli/server.py's start_server, on localhost): concurrent streaming
    /completion posts and streaming /v1/chat/completions, then /stats; each
    /completion's pieces against the single-session server's on the same
    file (without --parallel).  A difference must start at a near tie of
    the single session's greedy run: a top-2 margin within this model's
    agreement limit at b = 4, measured by a checked host-tick engine run of
    the same prompts on the single-session server's weights (serve_mode)."""
    import http.client
    import threading

    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.cli import server
    from llama_cpp_q_4_0_tpu_torch.kernels.build import BUILD_DIR
    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import BatchEngine

    tmp = os.path.join(BUILD_DIR, "smoke-serve")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "llama7b-width-2layer-q4_0.ggjt")
    servers = []
    try:
        write_ggjt_7b_width(path, "q4_0")

        def up(*extra):
            args = server.build_parser().parse_args(
                ["-m", path, "-c", "512", "--port", "0", "--device", "cuda", *extra])
            httpd, eng, lm = server.start_server(args)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append((httpd, eng))
            return httpd.server_address[1], eng, lm

        def post(port, route, body):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request("POST" if body is not None else "GET", route,
                         None if body is None else json.dumps(body))
            r = conn.getresponse()
            raw = r.read().decode()
            conn.close()
            if "event-stream" in (r.getheader("Content-Type") or ""):
                return r.status, [json.loads(x[6:]) for x in raw.split("\n")
                                  if x.startswith("data: ") and x[6:] != "[DONE]"]
            return r.status, json.loads(raw)

        # prompts of 20-60 words (the file's vocabulary is bytes: 80-240
        # tokens, past 32, so that the single session's prefill and the
        # engine's admissions both take K1); greedy without the default
        # repeat penalty, so that a token is an argmax
        rng = np.random.default_rng(seed + 17)
        words = ["the", "cat", "sat", "on", "a", "mat", "and", "then", "it", "ran", "far"]
        prompts = [" ".join(rng.choice(words, int(rng.integers(20, 60)))) for _ in range(6)]
        greedy = {"n_predict": 16, "temperature": -1.0, "repeat_penalty": 1.0, "stream": True}
        single_port, _, lm = up()
        want = {p: post(single_port, "/completion", {"prompt": p, **greedy}) for p in prompts}
        toks = [lm.tokenizer.tokenize(p, bos=True) for p in prompts]
        refs = serve_reference(lm.cfg, lm.ctx.params, toks, 16, torch.bfloat16)
        eng = BatchEngine(lm.cfg, lm.ctx.params, n_slots=4, n_ctx=512)
        good, limit, _ = serve_mode(torch, counters, card, eng, "2-layer 7B-width host ticks, 4 "
                                    "slots (the server check's agreement limit)", toks, refs,
                                    None, {"qmm_q4_0_kfold": 9}, "tick", n=16)
        del eng
        port, eng, _ = up("--parallel", "4", "--parallel-chunk", "8")
        got, chats = {}, []

        def one(p):
            got[p] = post(port, "/completion", {"prompt": p, **greedy})

        def chat(i):
            chats.append(post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": prompts[i]}], "max_tokens": 8,
                "temperature": -1.0, "stream": True}))

        _zero(counters)
        t0 = time.perf_counter()
        threads = ([threading.Thread(target=one, args=(p,)) for p in prompts]
                   + [threading.Thread(target=chat, args=(i,)) for i in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        secs = time.perf_counter() - t0
        launched = {k: v for k, v in _read(counters).items() if v}
        st, stats = post(port, "/stats", None)
        same = near = 0
        notes = []
        for p, (ref, rows) in zip(prompts, refs):
            a = [e["content"] for e in want[p][1] if not e["stop"]]
            b = [e["content"] for e in got[p][1] if not e["stop"]]
            if a == b:
                same += 1
                continue
            j = next(i for i, (x, y) in enumerate(zip(a + [None], b + [None])) if x != y)
            top = np.sort(rows[j])[::-1] if j < len(rows) else None
            margin = float(top[0] - top[1]) if top is not None else float("inf")
            near += margin <= limit
            notes.append(f"parts at token {j} (margin {margin:.5f})")
        chats_ok = len(chats) == 2 and all(s == 200 and ev[-1]["choices"][0]["finish_reason"]
                                           for s, ev in chats)
        ok = (good and all(got[p][0] == 200 for p in prompts) and chats_ok and st == 200
              and stats["n_requests_done"] == len(prompts) + 2 and stats["mode"] == "chunked"
              and launched.get("qmm_q4_0_kfold", 0) > 0 and same + near == len(prompts))
        print(f"serve: server --parallel 4 --parallel-chunk 8 on a 2-layer 7B-width q4_0 GGJT: "
              f"{len(prompts)} streaming /completion and 2 streaming /v1/chat/completions posts "
              f"at once in {secs:.2f} s; /stats {json.dumps(stats)}; greedy pieces equal to the "
              f"single-session server's for {same} of {len(prompts)}, {near} part at a near tie "
              f"(margin <= {limit:.5f}){'; ' + '; '.join(notes) if notes else ''}; launches "
              f"{json.dumps(launched)} {'ok' if ok else 'MISMATCH'} [{card}]", flush=True)
        return ok
    finally:
        for httpd, eng in servers:
            httpd.shutdown()
            httpd.server_close()
            if eng is not None:
                eng.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def serve_phase(torch, counters, card, built, seed: int, launches: dict) -> bool:
    """The serving engine on 7B q4_0 at full depth (the e2e phase's weights)
    at 16 slots x 2048 with a bf16 cache: the 20 requests of
    serve_prompts(seed) (batched, per-slot and lane admissions) with 64
    greedy tokens through host ticks and through chunk-16 ticks two in
    flight, each request against its single session; tokens/s and ms a tick
    at occupancy 1-16 with a traced tick; speculative ticks at 4 slots (k =
    7, chunk 4) over patterned prompts behind a registered prefix; the int8
    configuration (QMM_Q8X=1, FUSED_ATTN=1, q8 cache) at 8 slots, chunk 16,
    with a lane cohort of 4; the engine's memory estimate against the card's
    peak; `server --parallel`.  The path's launches (not the twins') are
    added to launches."""
    import numpy as np

    from llama_cpp_q_4_0_tpu_torch.runtime import batch_engine as be
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling
    from llama_cpp_q_4_0_tpu_torch.synth import build_llama

    t0 = time.perf_counter()
    cfg, params = built or build_llama(device="cuda", seed=0, ftype="q4_0")
    prompts = serve_prompts(seed, cfg.n_vocab)
    refs = serve_reference(cfg, params, prompts, SERVE_N, torch.bfloat16)
    print(f"time: serve references {time.perf_counter() - t0:.1f} s", flush=True)
    ok, path = True, {}

    def engine(**kw):
        torch.cuda.empty_cache()
        return be.BatchEngine(cfg, params, n_ctx=SERVE_CTX, **kw)

    # host ticks, 16 slots: the agreement limit at b = 16 comes from this run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = engine(n_slots=SERVE_SLOTS, cache_dtype=torch.bfloat16)
    weights, kv = be.estimate_engine_hbm(eng.params, cfg, SERVE_SLOTS, SERVE_CTX,
                                         torch.bfloat16)
    good, limit, log = serve_mode(torch, counters, card, eng, "host ticks, 16 slots",
                                  prompts, refs, None, SERVE_TICK, "tick")
    ok &= good and {"batched", "lane"} <= set(log["admits"])
    _add(path, log["path"])
    peak = torch.cuda.max_memory_allocated() - base
    print(f"serve: estimate_engine_hbm weights {weights / 2**30:.3f} GiB + KV {kv / 2**30:.3f} "
          f"GiB = {(weights + kv) / 2**30:.3f} GiB; torch.cuda.max_memory_allocated above the "
          f"weights {peak / 2**30:.3f} GiB (the KV, the graphs' pool, the twins' cache copies, "
          f"the admissions' staging) [{card}]", flush=True)
    print(f"graphs: serve host {graph_summary(eng.ctx)}", flush=True)
    del eng
    eng = engine(n_slots=SERVE_SLOTS, cache_dtype=torch.bfloat16)
    serve_occupancy(torch, eng, "host ticks", card, cfg.n_vocab, profile_at=16)
    del eng
    print(f"time: serve host {time.perf_counter() - t0:.1f} s", flush=True)

    # chunk-16 ticks, two in flight
    chunked = dict(n_slots=SERVE_SLOTS, chunk=16, cache_dtype=torch.bfloat16,
                   per_request_sampling=True, device_sampling=DeviceSampling(temp=-1.0))
    eng = engine(**chunked)
    good, _, log = serve_mode(torch, counters, card, eng, "chunk 16, two in flight",
                              prompts, refs, limit, SERVE_TICK, "chunk")
    ok &= good
    _add(path, log["path"])
    print(f"graphs: serve chunked {graph_summary(eng.ctx)}", flush=True)
    del eng
    eng = engine(**chunked)
    serve_occupancy(torch, eng, "chunk 16", card, cfg.n_vocab, profile_at=16, levels=(1, 16))
    del eng
    print(f"time: serve chunked {time.perf_counter() - t0:.1f} s", flush=True)

    # speculative ticks: 4 slots, k = 7, chunk 4, patterned prompts behind a
    # registered prefix (a verify is [4, 8]: K2 at b = 32)
    pre = spec_prompt(seed, cfg.n_vocab, 128)
    sprompts = [pre + spec_prompt(seed + 1 + i, cfg.n_vocab, 384) for i in range(4)]
    srefs = serve_reference(cfg, params, sprompts, SERVE_N, torch.bfloat16)
    eng = engine(n_slots=4, chunk=4, spec_draft=7, cache_dtype=torch.bfloat16,
                 device_sampling=DeviceSampling(temp=-1.0))
    eng.register_prefix(pre)
    good, _, log = serve_mode(torch, counters, card, eng, "speculative, 4 slots, k 7, chunk 4",
                              sprompts, srefs, limit, SERVE_TICK, "spec")
    st = eng.stats()
    ok &= good and "prefix" in log["admits"] and st["spec_rounds"] > 0
    _add(path, log["path"])
    t1 = time.perf_counter()
    n0, k0 = eng.n_ticks, eng.n_tokens_out
    serve_submit(eng, sprompts, SERVE_N)
    secs = time.perf_counter() - t1
    st = eng.stats()
    print(f"serve: speculative ticks: {st['spec_rounds']} slot-rounds, "
          f"{1 + st['spec_accepted'] / max(1, st['spec_rounds']):.3f} tokens a verify, "
          f"acceptance {st['spec_acceptance']:.3f} ({st['spec_accepted']}/{st['spec_drafted']}); "
          f"unchecked again: {(eng.n_tokens_out - k0) / secs:.1f} tokens/s summed over 4 slots "
          f"({eng.n_tokens_out - k0} tokens in {secs:.3f} s, prefix admissions included, "
          f"{eng.n_ticks - n0} ticks) [{card}]", flush=True)
    del eng
    print(f"time: serve spec {time.perf_counter() - t0:.1f} s", flush=True)

    # the int8 configuration: 8 slots, chunk 16, q8 cache; 4 short prompts
    # and 4 long ones of three lane chunks (one cohort)
    rng = np.random.default_rng(seed + 18)
    iprompts = [[1] + rng.integers(3, cfg.n_vocab, int(n) - 1).tolist()
                for n in [*rng.integers(*SERVE_INT8_LENS[0], 4),
                          *rng.integers(*SERVE_INT8_LENS[1], 4)]]
    with env(**INT8):
        irefs = serve_reference(cfg, params, iprompts, 32, torch.int8)
        eng = engine(n_slots=8, chunk=16, cache_dtype=torch.int8, per_request_sampling=True,
                     device_sampling=DeviceSampling(temp=-1.0))
        good, _, log = serve_mode(torch, counters, card, eng,
                                  "int8 configuration (QMM_Q8X=1 FUSED_ATTN=1, q8 cache), "
                                  f"8 slots, chunk 16, lane width {eng.lane_width}", iprompts,
                                  irefs, limit, SERVE_TICK_INT8, "chunk", n=32)
    ok &= good and log["admits"].get("lane", [(0, 0, 0)])[0][0] > 1
    _add(path, log["path"])
    del eng
    torch.cuda.empty_cache()
    print(f"time: serve int8 {time.perf_counter() - t0:.1f} s", flush=True)

    ok &= serve_server(torch, counters, card, seed)
    kernels = ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill", "qmm_q8x", "mha_decode")
    ok &= all(path.get(k, 0) > 0 for k in kernels)
    _add(launches, {k: path.get(k, 0) for k in kernels})
    print(f"serve: the path's launches (the runs', their twins apart) {json.dumps(path)}; every "
          f"kernel of the path launched {all(path.get(k, 0) > 0 for k in kernels)}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ok


# the phases of the full run, in their order
FULL_RUN = ("kernels", "e2e", "graphs", "ondevice", "session", "spec", "serve", "families",
            "q8chaos", "cli")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(FULL_RUN),
                    help="comma-separated subset of kernels,e2e,graphs,ondevice,session,spec,"
                         "serve,families,"
                         "q8chaos,cli,sass,k7k3,"
                         "k7repeat,int8prefill,planes,tiles,attn,gemv,busy,splits; the result "
                         "lines print only for the default " + ",".join(FULL_RUN))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the session, spec and serve phases' token streams and "
                         "adapters")
    opts = ap.parse_args(argv)
    phases = set(opts.phases.split(","))
    full = phases == set(FULL_RUN)
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
    if "kernels" in phases:
        ptxas_report(build)
    if "sass" in phases:
        sass_counts(build)
    if "k7k3" in phases:
        timer = Timer(torch)
        ok = check_flash(torch, timer, {})
        for b in (128, 512):
            ok &= check_qmm(torch, timer, "qmm_q8x", b, {})
        if not ok:
            return fail("K7 or K3 disagrees with its plain version")
        del timer
    if "tiles" in phases:
        timer = Timer(torch)
        for name, b in TILE_AB:
            check_qmm(torch, timer, name, b, {})
        del timer
    if "attn" in phases:
        check_mha(torch, Timer(torch), {}, ab=True)
    if "busy" in phases:
        busy_phase(torch)
    if "splits" in phases:
        splits_phase(torch)
    if "gemv" in phases and not check_gemv(torch):
        return fail("a decode GEMV disagrees with its plain version, with its own launch "
                    "again or in a CUDA graph, or on 2-byte planes with its f32 twin")
    if "planes" in phases and not check_planes(torch, Timer(torch), {}):
        return fail("a kernel on 2-byte planes differs from its f32-plane run or "
                    "disagrees with its plain version")
    if "k7repeat" in phases and not check_q8x_repeats(torch):
        return fail("K7's tile launched again differs from its first launch or its "
                    "plain version")
    if "int8prefill" in phases:
        from llama_cpp_q_4_0_tpu_torch.models import transformer
        from llama_cpp_q_4_0_tpu_torch.synth import build_llama

        cfg, params = build_llama(device="cuda", seed=0, ftype="q4_0")
        ck, cv = transformer.init_cache(cfg, 1, cfg.n_ctx, dtype=torch.int8, device="cuda")
        int8_prefill_128(torch, cfg, params, ck, cv)
        del params, ck, cv

    recs = {k: {} for k in ("qmm_q4_0", "qmm_q4_0_kfold", "flash_prefill",
                            "qmm_packed_bias", "qmm_int8", "qmm_int8_bias",
                            "qmm_q8x", "mha_decode", "hbm_stream", "qmm_q4_0/q3_K",
                            "qmm_q4_0_kfold/q3_K", "qmm_q8x/q3_K")}
    if "kernels" in phases:
        timer = Timer(torch)
        # K1 runs above 32 rows, K2 at 32 or fewer; K5, K6 and K6b at both.
        # The prefill tile (K1, K5, K6, K6b) is timed at b=128 and 512 and
        # checked at b=33 (the ragged row), 64 and 2048 (the smallest and
        # largest prefill buckets), on both group sizes (OTHER_FORMS)
        ok = check_qmm(torch, timer, "qmm_q4_0_kfold", 1, recs["qmm_q4_0_kfold"])
        # b = 8 (a verify), 16 (a serving tick at 16 slots) and 32 (a
        # speculative tick of 4 slots x 8 rows)
        for b in (8, 16, 32):
            ok &= check_qmm(torch, timer, "qmm_q4_0_kfold", b, None)
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
        for name, forms in OTHER_FORMS.items():
            for form in forms:
                for b in FORM_ROWS.get(name, (1, 33, 64, 512, 2048)):
                    ok &= check_qmm(torch, timer, name, b, recs[name], other_form=form)
        ok &= check_seed(torch)
        # K7: b=1 (decode; beside K2 above), its tile timed at b=128 (the
        # cap; beside K1 at b=128) and b=512 (under QMM_Q8X_MAX_B=512; beside
        # K1 above) and checked at b=33, 64 and 2048
        ok &= check_q8x_quantizer(torch)
        ok &= check_quantize_kv(torch)
        ok &= check_qmm(torch, timer, "qmm_q8x", 1, recs["qmm_q8x"])
        ok &= check_qmm(torch, timer, "qmm_q8x", 8, None)
        for b in (128, 512):
            big = {}
            ok &= check_qmm(torch, timer, "qmm_q8x", b, big)
            recs["qmm_q8x"]["max_abs_err"] = max(recs["qmm_q8x"]["max_abs_err"],
                                                 big["max_abs_err"])
        for b in (33, 64, 2048):
            ok &= check_qmm(torch, timer, "qmm_q8x", b, recs["qmm_q8x"], time_it=False)
        ok &= check_q3k(torch, timer, recs)
        ok &= check_planes(torch, timer, recs)
        ok &= check_gemv(torch)
        ok &= check_q8x_repeats(torch)
        ok &= check_mha(torch, timer, recs["mha_decode"])
        ok &= check_stream(torch, timer, recs["hbm_stream"])
        if not ok:
            return fail("a kernel disagrees with its plain version")
        del timer
        torch.cuda.empty_cache()

    def elapsed(phase):
        print(f"time: {phase} done {time.perf_counter() - t0:.1f} s after the build began",
              flush=True)

    if "kernels" in phases:
        elapsed("kernels")
    counters = [qmm.launches, fp.launches, md.launches, st.launches]
    launches = {}
    q4 = None  # the q4_0 weights, taken again by its 2-byte, int8 and graph runs
    if "e2e" in phases:
        for ftype in ("q4_0", "q4_K_M"):
            ok, path_launches, per_token, cfg, params, toks = end_to_end(
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
            if ftype == "q4_0":
                q4 = (cfg, params)
                err = q4_0_planes(torch, counters, cfg, params, toks, launches)
                if err:
                    return fail(err)
            del params
            torch.cuda.empty_cache()
        # Q3_K_M: K1 and K2 on q3_K (wq, wk, gate/up), K5 on q4_K (wv, wo,
        # w2), K6 for the q6_K head; per 512-token prefill 96 K1 + 96 K5 tile
        # launches, 32 K3 and the head's last row
        ok, path_launches, per_token, cfg, params, _ = end_to_end(torch, counters, "q3_K_M")
        if not ok:
            return fail("q3_K_M end-to-end run: non-finite logits or a kernel of the "
                        "path never launched")
        n_dec = path_launches["qmm_q4_0_kfold"] // 96
        want = {"qmm_q4_0": 96, "flash_prefill": 32, "qmm_q4_0_kfold": 96 * n_dec,
                "qmm_packed_bias": 96 * (1 + n_dec), "qmm_int8": 1 + n_dec}
        got = {k: path_launches[k] for k in want}
        if got != want or per_token != Q3KM_PER_TOKEN:
            return fail(f"q3_K_M launches {got} != {want}, or per decode token "
                        f"{per_token} != {Q3KM_PER_TOKEN}")
        launches["qmm_q4_0/q3_K"] = path_launches["qmm_q4_0"]
        launches["qmm_q4_0_kfold/q3_K"] = path_launches["qmm_q4_0_kfold"]
        model_bounds("LLaMA-7B q3_K_M", params, cfg.n_layer)
        bench_instruments(torch, cfg, params, "q3_K_M")
        err = q3_k_m_bf16(torch, counters, cfg, params, launches)
        if err:
            return fail(err)
        del params
        torch.cuda.empty_cache()
        # and in the int8 configuration, a 128-token prompt (K7's tile) and
        # 16 decode steps: K7 for every q3_K matmul, K4 over the q8 cache
        with env(**INT8):
            ok, path_launches, per_token, cfg, params, _ = end_to_end(
                torch, counters, "q3_K_M", n_prompt=128, n_decode=16, path="q3_K_M_int8",
                cache_dtype=torch.int8)
        want = {"qmm_q8x": 96, "qmm_packed_bias": 96, "qmm_int8": 1, "mha_decode": 32}
        if not ok or per_token != want:
            return fail(f"q3_K_M int8-configuration run: non-finite logits, a kernel of "
                        f"the path never launched, or decode launches {per_token} != {want}")
        launches["qmm_q8x/q3_K"] = path_launches["qmm_q8x"]
        del params
        torch.cuda.empty_cache()
        # the int8 configuration: K7 for every matmul of at most 128 rows, K4
        # over the q8 cache in every decode step
        with env(**INT8):
            ok, path_launches, per_token, cfg, params, _ = end_to_end(
                torch, counters, "q4_0", path="q4_0_int8", cache_dtype=torch.int8, built=q4)
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
        ok, path_launches, _, cfg, params, _ = end_to_end(
            torch, counters, "q5_K_M", n_prompt=128, n_decode=16)
        if not ok:
            return fail("q5_K_M end-to-end run: non-finite logits or a kernel "
                        "of the path never launched")
        launches["qmm_int8_bias"] = path_launches["qmm_int8_bias"]
        del params
        torch.cuda.empty_cache()
        for ftype in ("q4_0", "q4_K_M", "q3_K_M"):
            if not two_layer_vs_cpu(torch, counters, ftype)[0]:
                return fail(f"2-layer {ftype} model on the card disagrees with "
                            "the CPU plain path")
            torch.cuda.empty_cache()
        if not two_layer_vs_cpu(torch, counters, "q4_0", int8=True)[0]:
            return fail("2-layer q4_0 int8 configuration on the card disagrees with "
                        "the CPU, or K7/K4 never launched")
        torch.cuda.empty_cache()
        # shapes outside the kernels' gate, routed as the JAX dispatch does: a
        # 32001-entry head and w2 at K = 8640 take the bf16 product, no kernel
        # (per decode token 3 K2 + 2 K5 a layer)
        if not two_layer_vs_cpu(torch, counters, "q3_K_M", n_vocab=32001, n_ff=8640,
                                want_per_token={"qmm_q4_0_kfold": 6, "qmm_packed_bias": 4})[0]:
            return fail("2-layer q3_K_M model with a 32001-entry vocabulary and n_ff "
                        "8640 disagrees with the CPU or launched a kernel off the gate")
        torch.cuda.empty_cache()
        # the block formats on f16 planes (QMM_F16_SCALES=1): q4_1 through K5,
        # q5_0 and q8_0 through K6, q5_1 through K6b; the bf16 forms of K7
        # (Q3_K_M in the int8 configuration) and K6b (Q5_K_M)
        for ftype, planes, int8, form, kernel in (
                ("q4_1", "f16", False, None, None),
                ("q5_0", "f16", False, "qmm_int8/f16", "qmm_int8"),
                ("q8_0", "f16", False, None, None),
                ("q5_1", "f16", False, "qmm_int8_bias/f16", "qmm_int8_bias"),
                ("q3_K_M", "bf16", True, "qmm_q8x/bf16", "qmm_q8x"),
                ("q5_K_M", "bf16", False, "qmm_int8_bias/bf16", "qmm_int8_bias")):
            ok, launched = two_layer_vs_cpu(torch, counters, ftype, int8=int8, planes=planes,
                                            gate_cpu=ftype != "q8_0")
            if not ok or (kernel and not launched.get(kernel)):
                return fail(f"2-layer {ftype} model on {planes} planes disagrees with the "
                            f"CPU, or {kernel} never launched")
            if form:
                launches[form] = launched[kernel]
            torch.cuda.empty_cache()
    if "e2e" in phases:
        elapsed("e2e")
    if "graphs" in phases:
        if not graphs_phase(torch, counters, built=q4):
            return fail("a replayed step differs from its eager forward (logits, tokens, "
                        "cache or launches)")
        elapsed("graphs")
    if "ondevice" in phases:
        if not ondevice_phase(torch, counters, card, built=q4):
            return fail("on-device decode: a replayed chunk differs from its eager twin, a "
                        "launch count, the per-row chunk or the out-of-range insert")
        elapsed("ondevice")
    if "session" in phases:
        if not session_phase(torch, counters, card, q4, opts.seed, launches):
            return fail("the session slice: a perplexity run (launches, host against "
                        "on-device, card against CPU), a state restore or session file not "
                        "continuing bit for bit, the KV shift, the f8 cache's launches, or a "
                        "tool")
        elapsed("session")
    if "spec" in phases:
        if not spec_phase(torch, counters, card, q4, opts.seed, launches):
            return fail("speculative decoding or LoRA: a replayed verify or round differing "
                        "from its eager twin, a launch count, greedy tokens parting from the "
                        "plain chunk's off a near-tie, the caches rebound, the adapted bases "
                        "touched, or LoRA / embd-input card against CPU")
        elapsed("spec")
    if "serve" in phases:
        if not serve_phase(torch, counters, card, q4, opts.seed, launches):
            return fail("the serving engine: a replayed tick, chunk or round differing from its "
                        "eager twin, a launch count, a request's greedy tokens parting from its "
                        "single session off a near tie, the caches rebound, a request left open, "
                        "or the server")
        elapsed("serve")
    del q4
    torch.cuda.empty_cache()
    if "families" in phases:
        if not families_phase(torch, counters, launches, recs):
            return fail("a family's kernel at its shapes, replayed step or chunk against "
                        "its eager twin, a launch count, K4 at 71 heads over one, GPT-NeoX "
                        "or Bonsai against the CPU, or the CLI on a Bonsai file")
        elapsed("families")
    if "q8chaos" in phases:
        q8chaos_phase(torch)
        elapsed("q8chaos")
    if "cli" in phases:
        if not cli_phase("q4_0", ("Hello", "The capital of France is",
                                  "Once upon a time"), counters):
            return fail("the main CLI failed on the q4_0 file")
        ok, launches["hbm_stream"] = benchmark_phase(counters)
        if not ok:
            return fail("benchmark-matmult failed on the card")
        if not cli_phase("Q4_K_M", ("Hello", "Once upon a time")):
            return fail("the main CLI failed on the Q4_K_M file")
        if not cli_phase("Q3_K_M", ("Hello", "Once upon a time")):
            return fail("the main CLI failed on the Q3_K_M file")
    if "cli" in phases:
        elapsed("cli")
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
    # the q3_K forms of K1, K2 and K7 (pack zero 4, 16-groups), on the Q3_K_M
    # path's counts
    for name in ("qmm_q4_0", "qmm_q4_0_kfold", "qmm_q8x"):
        meta[f"{name}/q3_K"] = meta[name]
    # the 2-byte plane forms of the six matmul kernels (PLANE_FORMS)
    for name in PLANE_FORMS:
        meta[name] = meta[name.split("/")[0]]
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
