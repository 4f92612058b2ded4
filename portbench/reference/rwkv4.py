"""The plain reference of RWKV v4, in float32 (the WKV recurrence in float64).

It reads the raw tensors (the q4_0 blocks and f32 vectors that the program's
loader reads too) and dequantizes them itself, one layer at a time.  Every
sequence runs from a zero state; for each layer, with xx the previous
position's value of the same quantity (zero before the first):

    a = LayerNorm(x; ln1);  r = sigmoid(mix(a, xx; mix_r) Wr^T)
    k = mix(a, xx; mix_k) Wk^T;  v = mix(a, xx; mix_v) Wv^T
    wkv_t = (num_{t-1} + e^{u + k_t} v_t) / (den_{t-1} + e^{u + k_t})
    num_t = e^{w} num_{t-1} + e^{k_t} v_t;  den_t = e^{w} den_{t-1} + e^{k_t}
    x = x + (r * wkv) Wo^T
    c = LayerNorm(x; ln2);  x = x + sigmoid(mix(c, cc; fmix_r) Wfr^T) * (relu(mix(c, cc; fmix_k) Wfk^T)^2 Wfv^T)

with u = time_first and w = time_decay as the file stores it (already
-exp(decay)); x is halved after every ``rescale_every`` layers, as the
file's layout asks (its converter divides the output weights to match).
The embedding goes through the pre-norm (ln0) first; the head reads
LayerNorm(x; ln_out).  The WKV sums are kept in float64 without the running
maximum the program's stable form carries.

``lowp`` rounds what enters each product (the control's lower precision);
None keeps float32.  TF32 is off while it runs.
"""

from __future__ import annotations

import torch

from .. import raw as rawmod


def _ln(x, w, b, eps):
    m = x.mean(-1, keepdim=True)
    var = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(var + eps) * w + b


def _shift(x):
    """[S, T, E] -> the previous position's values, zero before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _mix(cur, prev, m):
    return cur * m + prev * (1.0 - m)


def logits_at(conf, raw, seqs, wanted, device, lowp=None):
    """For each sequence of seqs (lists of token ids), the f32 logits at the
    positions wanted[i]: a list of [len(wanted[i]), V] tensors on device.
    The sequences run together, padded to the longest (a padded position
    follows the real ones and is never read)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(conf, raw, seqs, wanted, device, lowp or (lambda x: x))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(conf, raw, seqs, wanted, device, lowp):
    eps = conf["layer_norm_eps"]
    n, t_max = len(seqs), max(len(s) for s in seqs)
    toks = torch.zeros((n, t_max), dtype=torch.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s, dtype=torch.int64)

    def vec(name):
        return rawmod.vector(raw[name], device)

    def mm(x, name):
        return lowp(x) @ rawmod.dequantize_q4_0(raw[name], device).T

    x = rawmod.q4_0_rows(raw["rwkv.embeddings.weight"], toks.reshape(-1), device)
    x = _ln(x.reshape(n, t_max, -1), vec("rwkv.blocks.0.pre_ln.weight"),
            vec("rwkv.blocks.0.pre_ln.bias"), eps)
    for i in range(conf["n_layer"]):
        p = f"rwkv.blocks.{i}"
        att, ff = p + ".attention.", p + ".feed_forward."
        a = _ln(x, vec(p + ".ln1.weight"), vec(p + ".ln1.bias"), eps)
        aa = _shift(a)
        r = torch.sigmoid(mm(_mix(a, aa, vec(att + "time_mix_receptance")),
                             att + "receptance.weight"))
        k = mm(_mix(a, aa, vec(att + "time_mix_key")), att + "key.weight")
        v = mm(_mix(a, aa, vec(att + "time_mix_value")), att + "value.weight")
        wkv = _wkv(k.double(), v.double(), vec(att + "time_first").double(),
                   vec(att + "time_decay").double())
        x = x + mm(r * wkv.float(), att + "output.weight")
        c = _ln(x, vec(p + ".ln2.weight"), vec(p + ".ln2.bias"), eps)
        cc = _shift(c)
        fr = torch.sigmoid(mm(_mix(c, cc, vec(ff + "time_mix_receptance")),
                              ff + "receptance.weight"))
        fk = torch.square(torch.relu(mm(_mix(c, cc, vec(ff + "time_mix_key")),
                                        ff + "key.weight")))
        x = x + fr * mm(fk, ff + "value.weight")
        if conf["rescale_every"] > 0 and (i + 1) % conf["rescale_every"] == 0:
            x = x * 0.5
    head = rawmod.dequantize_q4_0(raw["head.weight"], device)
    lnw, lnb = vec("rwkv.ln_out.weight"), vec("rwkv.ln_out.bias")
    out = []
    for j, want in enumerate(wanted):
        sel = x[j, torch.as_tensor(want, dtype=torch.int64, device=device)]
        out.append(lowp(_ln(sel, lnw, lnb, eps)) @ head.T)
    return out


def _wkv(k, v, u, w):
    """The WKV of every position, k, v [S, T, E] float64, one position at a
    time from num = den = 0."""
    s, t, e = k.shape
    num = torch.zeros((s, e), dtype=k.dtype, device=k.device)
    den = torch.zeros_like(num)
    ew = torch.exp(w)
    out = torch.empty_like(k)
    ek, euk = torch.exp(k), torch.exp(u + k)
    for j in range(t):
        out[:, j] = (num + euk[:, j] * v[:, j]) / (den + euk[:, j])
        num = ew * num + ek[:, j] * v[:, j]
        den = ew * den + ek[:, j]
    return out
