"""The plain reference of GPT-NeoX with the parallel residual, in float32.

It reads the raw tensors (the q4_0 blocks and f32 vectors that the program's
loader reads too) and dequantizes them itself, one layer at a time, and runs
the whole forward of each sequence with no cache: for each layer

    h = LayerNorm(x; ln1);  q, k, v = split(h Wqkv^T + b)   (per head: q_h | k_h | v_h)
    q, k = rope(q, k) on the first rotary_pct * D dims of each head (rotate-half)
    a = softmax(q k^T / sqrt(D) + causal mask) v;  attn = a Wo^T + bo
    mlp = gelu(LayerNorm(x; ln2) Wup^T + bup) Wdown^T + bdown
    x = x + attn + mlp

then LayerNorm(x; ln_f) and the head.  One departure from the published
model: GELU takes its tanh form, the formula llama.cpp's GPT-NeoX path (and
so the program) evaluates; StableLM's config names the exact "gelu".

``lowp`` rounds what enters each product and each cached K and V (the
control's lower precision); None keeps float32.  TF32 is off while it runs.
"""

from __future__ import annotations

import math

import torch

from .. import raw as rawmod

QUERY_BLOCK = 512  # query rows of one attention block (bounds the score matrix)


def _ln(x, w, b, eps):
    m = x.mean(-1, keepdim=True)
    var = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(var + eps) * w + b


def _rope(x, pos, n_rot, base):
    """x [T, H, D]: the first n_rot dims of each head rotated in two halves."""
    half = n_rot // 2
    inv = base ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2.0 / n_rot)
    ang = pos.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x0, x1, rest = x[..., :half], x[..., half:n_rot], x[..., n_rot:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos, rest], dim=-1)


def _attention(q, k, v):
    """Causal attention, q, k, v [T, H, D] -> [T, H * D], in query blocks."""
    t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)  # [H, D, T], [H, T, D]
    out = []
    for s in range(0, t, QUERY_BLOCK):
        qb = q[s:s + QUERY_BLOCK].permute(1, 0, 2)  # [H, b, D]
        sc = torch.matmul(qb, kt) * scale  # [H, b, T]
        rows = torch.arange(s, s + qb.shape[1], device=q.device)[:, None]
        sc = sc.masked_fill(torch.arange(t, device=q.device)[None, :] > rows, float("-inf"))
        out.append(torch.matmul(torch.softmax(sc, dim=-1), vt).permute(1, 0, 2))
    return torch.cat(out, dim=0).reshape(t, h * d)


def logits_at(conf, raw, seqs, wanted, device, lowp=None):
    """For each sequence of seqs (lists of token ids), the f32 logits at the
    positions wanted[i] (each predicting the token after it): a list of
    [len(wanted[i]), V] tensors on device."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(conf, raw, seqs, wanted, device, lowp or (lambda x: x))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(conf, raw, seqs, wanted, device, lowp):
    e, h = conf["hidden_size"], conf["num_attention_heads"]
    d, eps = e // h, conf["layer_norm_eps"]
    n_rot, base = int(conf["rotary_pct"] * d), float(conf["rotary_emb_base"])

    def vec(name):
        return rawmod.vector(raw[name], device)

    def mm(x, w, b):
        return lowp(x) @ w.T + b

    toks = [torch.tensor(s, dtype=torch.int64) for s in seqs]
    xs = [rawmod.q4_0_rows(raw["gpt_neox.embed_in.weight"], t, device) for t in toks]
    for i in range(conf["num_hidden_layers"]):
        p = f"gpt_neox.layers.{i}"
        at, mlp = p + ".attention.", p + ".mlp."
        wqkv = rawmod.dequantize_q4_0(raw[at + "query_key_value.weight"], device)
        wo = rawmod.dequantize_q4_0(raw[at + "dense.weight"], device)
        wup = rawmod.dequantize_q4_0(raw[mlp + "dense_h_to_4h.weight"], device)
        wdown = rawmod.dequantize_q4_0(raw[mlp + "dense_4h_to_h.weight"], device)
        bqkv, bo = vec(at + "query_key_value.bias"), vec(at + "dense.bias")
        bup, bdown = vec(mlp + "dense_h_to_4h.bias"), vec(mlp + "dense_4h_to_h.bias")
        ln1 = vec(p + ".input_layernorm.weight"), vec(p + ".input_layernorm.bias")
        ln2 = vec(p + ".post_attention_layernorm.weight"), vec(p + ".post_attention_layernorm.bias")
        for j, x in enumerate(xs):
            t = x.shape[0]
            qkv = mm(_ln(x, *ln1, eps), wqkv, bqkv).reshape(t, h, 3, d)
            pos = torch.arange(t, device=device)
            q = _rope(qkv[:, :, 0], pos, n_rot, base)
            k = lowp(_rope(qkv[:, :, 1], pos, n_rot, base))
            v = lowp(qkv[:, :, 2].contiguous())
            attn = mm(_attention(q, k, v), wo, bo)
            up = torch.nn.functional.gelu(mm(_ln(x, *ln2, eps), wup, bup), approximate="tanh")
            xs[j] = x + attn + mm(up, wdown, bdown)
        del wqkv, wo, wup, wdown
    head = rawmod.dequantize_q4_0(raw["embed_out.weight"], device)
    lnf = vec("gpt_neox.final_layer_norm.weight"), vec("gpt_neox.final_layer_norm.bias")
    out = []
    for x, want in zip(xs, wanted):
        sel = x[torch.as_tensor(want, dtype=torch.int64, device=device)]
        out.append(lowp(_ln(sel, *lnf, eps)) @ head.T)
    return out
