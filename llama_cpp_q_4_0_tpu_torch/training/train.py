"""Training step: loss, autograd and the optimizers.

The port of the JAX package's training stack:
  - ggml_build_backward's hand-written per-op VJPs (ggml.c:15954-16989)
      -> torch.autograd through the same ``transformer.forward`` that
         inference runs (the dense bf16 product takes JAX's gradient
         rounding, ops/qmatmul.py ``Bf16Product``)
  - ggml_opt Adam / L-BFGS with line search (ggml.c:18352-19153) -> the
    optax transforms the JAX package chains, ported here op for op:
    ``adamw`` (scale_by_adam, add_decayed_weights, scale by -lr),
    ``clip_by_global_norm`` and ``lbfgs`` (scale_by_lbfgs's two-loop
    recursion, scale by -1, and the zoom line search of
    ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')``)
  - ggml_cross_entropy_loss -> cross_entropy_loss below

An optimizer state is the structure optax builds (tuples of the transforms'
NamedTuples, with optax's field names), so that a checkpoint names its
leaves as the JAX package's does.  The state's tensors are updated in place,
as the JAX step donates them; the step returns new param tensors.  Scalar
leaves (counts, the line search's step size, value and info) are 0-d CPU
tensors; the weights of the L-BFGS memory stay on the params' device.

The line search decides on the host, in f32 as optax computes in f32: each
evaluation of the loss brings its value and its slope along the direction
to the host in one copy, so an L-BFGS step synchronises 1 + (its line-search
steps) times; Adam's step synchronises only where the caller reads the loss.

Over a (dp, sp, tp) mesh (``make_train_step(..., mesh=...)``, the JAX step
on params placed by ``shard_transformer``) each rank holds its slices of
the params and of a state laid out like them: the loss is
parallel/mesh_train.py's, every gradient is summed over dp and sp in few
host calls (``value_and_grad``), the global reductions (``tree_vdot``,
``tree_sqnorm``, so the clip and L-BFGS) sum a tp-split leaf's parts over
tp and count a replicated leaf once, and the line search decides on rank
0's value and slope, broadcast, so every rank takes the same branch and
their collectives pair up.  Adam is elementwise on the slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models import transformer
from ..models.config import ModelConfig
from ..models.transformer import TransformerParams, init_cache
from .tree import flatten_with_path, leaves, tree_map

F32 = np.float32
_INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class OptParams:
    """ggml_opt_params analogue (ggml.h:1354-1419), trimmed to what the
    trainer exposes (train-text-from-scratch.cpp --adam/--lbfgs flags)."""

    kind: str = "adam"  # adam | lbfgs
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # gclip (ggml.h:1392); 0 = off
    lbfgs_m: int = 6  # history size (ggml.h:1403)


# -- optax's state containers, field for field -------------------------------


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByLBFGSState(NamedTuple):
    count: torch.Tensor
    params: Any
    updates: Any
    diff_params_memory: Any
    diff_updates_memory: Any
    weights_memory: torch.Tensor


class ZoomLinesearchInfo(NamedTuple):
    num_linesearch_steps: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


class ScaleByZoomLinesearchState(NamedTuple):
    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: Any
    info: ZoomLinesearchInfo


# -- tree arithmetic ----------------------------------------------------------


def _host(v, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype)


def _dev(v, like: torch.Tensor) -> torch.Tensor:
    """An f32 host value as a 0-d tensor on like's device, filled there (a
    tensor, not a Python scalar, so that the card divides and multiplies by
    exactly this value)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _promote(*ts) -> torch.dtype:
    """JAX's promotion of (non-weak) arrays: a 0-d f32 array and a bf16
    array give f32, where torch would keep the dimensioned tensor's bf16."""
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def _jmul(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """s * y with JAX's result dtype."""
    dt = _promote(s, y)
    return s.to(dt) * y.to(dt)


def _sum_in_order(parts: list) -> torch.Tensor:
    """optax's reduce(add, parts, initializer=0): left to right, each sum in
    the promoted dtype (two bf16 parts add in bf16)."""
    total = parts[0]
    for d in parts[1:]:
        dt = _promote(total, d)
        total = (total.float() + d.float()).to(dt)
    return total


def _over_tp(parts: list, tree, mesh) -> list:
    """parts (each leaf's f32 sum) with a tp-split leaf's summed over tp, in
    one host call: the whole leaf's sum on every rank."""
    if mesh is None or mesh.shape["tp"] == 1:
        return parts
    from ..parallel.mesh import psum
    from ..parallel.shard import leaf_spec

    split = [i for i, (path, x) in enumerate(flatten_with_path(tree))
             if "tp" in leaf_spec(path, x)]
    if split:
        summed = psum(torch.stack([parts[i] for i in split]), mesh, "tp")
        for j, i in enumerate(split):
            parts[i] = summed[j]
    return parts


def tree_vdot(a, b, mesh=None) -> torch.Tensor:
    """optax.tree.vdot: each leaf's dot (f32 sums, rounded to the leaves'
    promoted dtype, as XLA's bf16 dot), summed in leaf order.  mesh: a and
    b are a rank's slices (the dot of the whole trees)."""
    xs, ys = leaves(a), leaves(b)
    parts = _over_tp([torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
                      for x, y in zip(xs, ys)], a, mesh)
    return _sum_in_order([p.to(_promote(x, y)) for p, x, y in zip(parts, xs, ys)])


def tree_sqnorm(a, mesh=None) -> torch.Tensor:
    """optax.tree.norm(squared=True): each leaf's squares in its dtype,
    summed in f32 and rounded to it, then the leaves in order.  mesh: a is
    a rank's slices (the whole tree's norm)."""
    xs = leaves(a)
    parts = _over_tp([torch.dot(x.reshape(-1), x.reshape(-1)) if x.dtype == torch.float32
                      else (x * x).float().sum() for x in xs], a, mesh)
    return _sum_in_order([p.to(x.dtype) for p, x in zip(parts, xs)])


def tree_add_scale(a, s: torch.Tensor, b):
    """a + s * b (optax.tree.add_scale): the product rounded, then the sum,
    in JAX's promoted dtype."""
    return tree_map(lambda x, y: x + _jmul(s, y), a, b)


def value_and_grad(fn: Callable, params, mesh=None):
    """(fn(params), d fn / d params) with the params' structure; a leaf the
    loss does not reach gets zeros, as jax.grad gives it.  mesh: params are
    a rank's slices and fn the mesh loss; each gradient is summed over dp
    and sp (every leaf is replicated over both), flattened into few host
    calls."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        value = fn(p)
        flat = leaves(p)
        grads = torch.autograd.grad(value, flat, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(t) for g, t in zip(grads, flat)]
    if mesh is not None:
        from ..parallel.mesh import psum_flat

        grads = psum_flat(grads, mesh, ("dp", "sp"))
    it = iter(grads)
    return value.detach(), tree_map(lambda _: next(it), p)


def _agreed(t: torch.Tensor, mesh) -> torch.Tensor:
    """t as rank 0 of the mesh holds it, on every rank (the host decisions
    of the line search)."""
    if mesh is None:
        return t
    from ..parallel.mesh import broadcast

    return broadcast(t, mesh, None, 0)


def apply_updates(params, updates):
    """optax.apply_updates: p + u in the param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# -- the transforms -----------------------------------------------------------


class Transform:
    """optax.GradientTransformationExtraArgs: init(params) -> state,
    update(updates, state, params, **extra) -> (updates, state).  The extra
    arguments (value, grad, value_fn; mesh, where the trees are a rank's
    slices) reach every transform; only the clip, L-BFGS and the line search
    read them."""

    def init(self, params):
        return EmptyState()

    def update(self, updates, state, params=None, **extra):
        return updates, state


class Chain(Transform):
    def __init__(self, *txs: Transform):
        self.txs = txs

    def init(self, params):
        return tuple(t.init(params) for t in self.txs)

    def update(self, updates, state, params=None, **extra):
        new = []
        for t, s in zip(self.txs, state):
            updates, s = t.update(updates, s, params, **extra)
            new.append(s)
        return updates, tuple(new)


class Scale(Transform):
    def __init__(self, step_size: float):
        self.step_size = step_size

    def update(self, updates, state, params=None, **extra):
        return tree_map(lambda g: self.step_size * g, updates), state


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, updates, state, params=None, **extra):
        return tree_map(lambda g, p: g + self.weight_decay * p, updates, params), state


class ClipByGlobalNorm(Transform):
    """optax.clip_by_global_norm: every leaf scaled by max_norm / ||g|| when
    the global norm reaches max_norm (a select on the device, no sync)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, updates, state, params=None, **extra):
        g_norm = torch.sqrt(tree_sqnorm(updates, extra.get("mesh")).float())
        trigger = g_norm < self.max_norm
        return tree_map(lambda t: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * self.max_norm),
                        updates), state


class ScaleByAdam(Transform):
    """optax.scale_by_adam (eps_root 0, no Nesterov); the moments are
    updated in place.  The bias corrections 1 - b**count are computed on the
    host in f32 (XLA's pow of an integer exponent can round an ulp apart)."""

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return ScaleByAdamState(count=_host(0, torch.int32),
                                mu=tree_map(torch.zeros_like, params),
                                nu=tree_map(torch.zeros_like, params))

    def update(self, updates, state, params=None, **extra):
        b1, b2 = self.b1, self.b2
        count = min(int(state.count) + 1, _INT32_MAX)
        bc1 = F32(1) - np.power(F32(b1), F32(count))
        bc2 = F32(1) - np.power(F32(b2), F32(count))

        def one(g, m, v):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            return (m / _dev(bc1, m)) / (torch.sqrt(v / _dev(bc2, v)) + self.eps)

        out = tree_map(one, updates, state.mu, state.nu)
        return out, state._replace(count=_host(count, torch.int32))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Chain:
    """optax.adamw's chain: scale_by_adam, add_decayed_weights, scale(-lr)."""
    return Chain(ScaleByAdam(b1, b2, eps), AddDecayedWeights(weight_decay), Scale(-lr))


class ScaleByLBFGS(Transform):
    """optax.scale_by_lbfgs (scale_init_precond=True): the memory of the
    last m parameter and update differences, written in place at slot
    (count - 1) % m, and the two-loop recursion (Nocedal and Wright,
    algorithm 7.4) over it.  Slots not yet written hold zeros and weight 0,
    for which both loops are exact no-ops, so they are skipped."""

    def __init__(self, memory_size: int = 10):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size

    def init(self, params):
        m = self.m
        first = leaves(params)[0]
        return ScaleByLBFGSState(
            count=_host(0, torch.int32),
            params=tree_map(torch.zeros_like, params),
            updates=tree_map(torch.zeros_like, params),
            diff_params_memory=tree_map(lambda t: t.new_zeros((m, *t.shape)), params),
            diff_updates_memory=tree_map(lambda t: t.new_zeros((m, *t.shape)), params),
            weights_memory=torch.zeros(m, dtype=torch.float32, device=first.device))

    def update(self, updates, state, params=None, **extra):
        m = self.m
        mesh = extra.get("mesh")
        count = int(state.count)
        idx, prev = count % m, (count - 1) % m
        dpm, dum, rhos = state.diff_params_memory, state.diff_updates_memory, state.weights_memory
        if count > 0:
            tree_map(lambda mem, p, q: torch.sub(p, q, out=mem[prev]), dpm, params, state.params)
            tree_map(lambda mem, u, v: torch.sub(u, v, out=mem[prev]), dum, updates,
                     state.updates)
            dp = tree_map(lambda mem: mem[prev], dpm)
            du = tree_map(lambda mem: mem[prev], dum)
            vdot = tree_vdot(du, dp, mesh).float()
            rhos[prev] = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            den = tree_sqnorm(du, mesh).float()
            identity_scale = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:  # the first step: nothing to remember, a capped 1 / ||u||
            tree_map(lambda mem: mem[prev].zero_(), dpm)
            tree_map(lambda mem: mem[prev].zero_(), dum)
            rhos[prev] = 0.0
            norm = torch.sqrt(tree_sqnorm(updates, mesh).float())
            identity_scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        # the slots written so far: those of steps 1..count
        filled = {(count - 1 - j) % m for j in range(min(count, m))}
        order = [i for i in ((idx + j) % m for j in range(m)) if i in filled]
        # the right loop keeps the updates' dtype (optax casts its carry
        # back), the identity scale promotes a bf16 leaf to f32, and the left
        # loop stays there
        vec = tree_map(torch.clone, updates)
        alphas = {}
        for i in reversed(order):
            alpha = rhos[i] * tree_vdot(tree_map(lambda mem: mem[i], dpm), vec, mesh).float()
            tree_map(lambda v, mem: v.copy_(v.float() - alpha * mem[i].float()), vec, dum)
            alphas[i] = alpha
        vec = tree_map(lambda v: v.mul_(identity_scale) if v.dtype == torch.float32
                       else _jmul(identity_scale, v), vec)
        for i in order:
            beta = rhos[i] * tree_vdot(tree_map(lambda mem: mem[i], dum), vec, mesh).float()
            tree_map(lambda v, mem: v.add_(_jmul(alphas[i] - beta, mem[i])), vec, dpm)
        return vec, state._replace(count=_host(min(count + 1, _INT32_MAX), torch.int32),
                                   params=params, updates=updates)


class ScaleByZoomLinesearch(Transform):
    """optax.scale_by_zoom_linesearch with its defaults (tol 0, increase
    factor 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
    interval_threshold 1e-5, no max step size) and initial guess 'one':
    the interval search (Nocedal and Wright, algorithm 3.5) and the zoom
    (3.6) with cubic, quadratic and bisection steps and the safe step, each
    decision as optax takes it, on f32 scalars on the host."""

    slope_rtol, curv_rtol, approx_dec_rtol = F32(1e-4), F32(0.9), F32(1e-6)
    increase_factor, interval_threshold, tol = F32(2.0), F32(1e-5), F32(0.0)

    def __init__(self, max_linesearch_steps: int = 20):
        self.max_steps = max_linesearch_steps

    def init(self, params):
        vdt = leaves(params)[0].dtype
        return ScaleByZoomLinesearchState(
            learning_rate=_host(1.0, vdt), value=_host(float("inf"), vdt),
            grad=tree_map(torch.zeros_like, params),
            info=ZoomLinesearchInfo(num_linesearch_steps=_host(0, torch.int32),
                                    decrease_error=_host(float("inf")),
                                    curvature_error=_host(float("inf"))))

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        """optax's _compute_decrease_error: the Armijo error, or the
        approximate Wolfe one where smaller; NaN (and so a failed probe)
        counts as infinite.  np.maximum / np.minimum carry NaN as jnp's do."""
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - F32(2 * 1e-4 - 1.0) * slope_init
        delta = value - value_init - self.approx_dec_rtol * abs(value_init)
        err = np.maximum(np.minimum(np.maximum(approx, delta), err), F32(0))
        return F32(np.inf) if np.isnan(err) else F32(err)

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(abs(slope) - self.curv_rtol * abs(slope_init), F32(0))
        return F32(np.inf) if np.isnan(err) else F32(err)

    def update(self, updates, state, params=None, *, value, grad, value_fn, **extra):
        mesh = extra.get("mesh")
        first = leaves(params)[0]
        # optax keeps the step size and the value in the first param's dtype
        # between line-search steps (a bf16 RWKV embedding rounds them)
        vdt = first.dtype
        if vdt == torch.float32:
            rnd = F32
        else:
            def rnd(v):
                return F32(torch.tensor(float(v)).to(vdt).float().item())

        def probe(stepsize):
            """(value, grad, slope) at params + stepsize * updates."""
            step = tree_add_scale(params, _dev(stepsize, first), updates)
            v, g = value_and_grad(value_fn, step, mesh)
            del step
            v_h, s_h = _agreed(torch.stack([v.float(), tree_vdot(g, updates, mesh).float()]),
                               mesh).tolist()
            return F32(v_h), g, F32(s_h)

        value_init, slope_init = (F32(x) for x in _agreed(torch.stack(
            [value.float(), tree_vdot(updates, grad, mesh).float()]), mesh).tolist())
        st = dict(count=0, stepsize=F32(0), value=rnd(value_init), grad=grad, slope=slope_init,
                  decrease_error=F32(np.inf), curvature_error=F32(np.inf),
                  interval_found=False, done=False, failed=False,
                  low=F32(0), value_low=value_init, slope_low=slope_init,
                  high=F32(0), value_high=value_init, slope_high=slope_init,
                  cubic_ref=F32(0), value_cubic_ref=value_init,
                  safe_stepsize=F32(0), safe_value=value_init, safe_grad=grad)
        with np.errstate(all="ignore"):
            while not (st["done"] or st["failed"]):
                if st["interval_found"]:
                    self._zoom(st, probe, value_init, slope_init)
                else:
                    self._search(st, probe, value_init, slope_init)
                if st["failed"]:
                    self._safe_step(st)
                st.update(stepsize=rnd(st["stepsize"]), value=rnd(st["value"]))
        lr = st["stepsize"]
        scaled = tree_map(lambda u: _dev(lr, u) * u, updates)
        return scaled, ScaleByZoomLinesearchState(
            learning_rate=_host(float(lr), vdt), value=_host(float(st["value"]), vdt),
            grad=tree_map(lambda g, like: g.to(like.dtype), st["grad"], grad),
            info=ZoomLinesearchInfo(
                num_linesearch_steps=_host(st["count"], torch.int32),
                decrease_error=_host(float(st["decrease_error"])),
                curvature_error=_host(float(st["curvature_error"]))))

    def _search(self, st, probe, value_init, slope_init):
        """optax's _search_interval."""
        it = st["count"]
        prev_step, prev_value, prev_slope = st["stepsize"], st["value"], st["slope"]
        new_step = F32(1.0) if it == 0 else F32(self.increase_factor * prev_step)
        value, grad, slope = probe(new_step)
        dec = self._decrease_error(new_step, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        err = max(dec, curv)
        if dec <= self.tol:
            st.update(safe_stepsize=new_step, safe_value=value, safe_grad=grad)
        set_high = bool(dec > 0.0) or bool(value >= prev_value and it > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            low = (new_step, value, slope, prev_step, prev_value, prev_slope)
        else:
            low = (prev_step, prev_value, prev_slope, new_step, value, slope)
        found = set_high or set_low or bool(err <= self.tol)
        done = bool(err <= self.tol)  # max_stepsize None: never reached
        st.update(count=it + 1, stepsize=new_step, value=value, grad=grad, slope=slope,
                  decrease_error=dec, curvature_error=curv, interval_found=found, done=done,
                  failed=(it + 1 >= self.max_steps) and not done,
                  low=low[0], value_low=low[1], slope_low=low[2],
                  high=low[3], value_high=low[4], slope_high=low[5],
                  cubic_ref=low[0], value_cubic_ref=low[1])

    def _zoom(self, st, probe, value_init, slope_init):
        """optax's _zoom_into_interval."""
        it = st["count"]
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
        cubic_ref, value_cubic_ref = st["cubic_ref"], st["value_cubic_ref"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
        too_small = bool(delta <= self.interval_threshold)
        mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                              value_cubic_ref)
        use_cubic = bool(mid_cubic > left + cubic_chk) and bool(mid_cubic < right - cubic_chk)
        mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = not use_cubic and bool(mid_quad > left + quad_chk) \
            and bool(mid_quad < right - quad_chk)
        if use_cubic:
            middle = mid_cubic
        elif use_quad:
            middle = mid_quad
        else:
            middle = F32((low + high) / F32(2))
        value, grad, slope = probe(middle)
        dec = self._decrease_error(middle, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        err = max(dec, curv)
        if dec <= self.tol and value < st["safe_value"]:
            st.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = bool(err <= self.tol)
        set_high_mid = bool(dec > 0.0) or bool(value >= value_low)
        set_high_low = bool(slope * (high - low) >= 0.0) and not set_high_mid
        new_high = (middle, value, slope) if set_high_mid else (high, value_high, slope_high)
        if set_high_low:
            new_high = (low, value_low, slope_low)
        new_low = (middle, value, slope) if not set_high_mid else (low, value_low, slope_low)
        cubic = (high, value_high) if set_high_mid or set_high_low else (low, value_low)
        failed = (it + 1 >= self.max_steps
                  or (too_small and st["safe_stepsize"] > 0.0)) and not done
        st.update(count=it + 1, stepsize=middle, value=value, grad=grad, slope=slope,
                  decrease_error=dec, curvature_error=curv, done=done, failed=failed,
                  low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                  high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                  cubic_ref=cubic[0], value_cubic_ref=cubic[1])

    def _safe_step(self, st):
        """optax's _try_safe_step: fall back on the best step with sufficient
        decrease, or keep the last one."""
        if st["safe_stepsize"] > 0.0 or np.isinf(st["decrease_error"]):
            st.update(stepsize=st["safe_stepsize"], value=st["safe_value"],
                      grad=st["safe_grad"])


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin in f32: the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a; NaN when there is none."""
    C = fpa
    db, dc = F32(b - a), F32(c - a)
    denom = F32(F32(F32(db * dc) ** 2) * F32(db - dc))
    r0, r1 = F32(fb - fa - F32(C * db)), F32(fc - fa - F32(C * dc))
    A = F32(F32(F32(dc * dc) * r0) + F32(-F32(db * db) * r1)) / denom
    B = F32(F32(-F32(F32(dc * dc) * dc) * r0) + F32(F32(F32(db * db) * db) * r1)) / denom
    radical = F32(B * B) - F32(F32(3.0) * A) * C
    return F32(a + F32(-B + np.sqrt(radical)) / F32(F32(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    """optax's _quadmin in f32."""
    db = F32(b - a)
    B = F32(fb - fa - F32(fpa * db)) / F32(db * db)
    return F32(a - fpa / F32(F32(2.0) * B))


def lbfgs(memory_size: int = 10, max_linesearch_steps: int = 20) -> Chain:
    """optax.lbfgs's chain: scale_by_lbfgs, scale(-1), the zoom line search."""
    return Chain(ScaleByLBFGS(memory_size), Scale(-1.0),
                 ScaleByZoomLinesearch(max_linesearch_steps))


def make_optimizer(op: OptParams) -> Transform:
    if op.kind == "adam":
        tx = adamw(op.lr, b1=op.beta1, b2=op.beta2, eps=op.eps, weight_decay=op.weight_decay)
    elif op.kind == "lbfgs":
        tx = lbfgs(memory_size=op.lbfgs_m)
    else:
        raise ValueError(op.kind)
    if op.grad_clip > 0:
        tx = Chain(ClipByGlobalNorm(op.grad_clip), tx)
    return tx


def init_opt_state(tx: Transform, params):
    """tx.init: every leaf a buffer of its own (none aliases the params)."""
    return tx.init(params)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL (ggml_cross_entropy_loss; the trainer's one-hot
    targets, train-text-from-scratch.cpp get_example_targets)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())
    return nll.mean()


def squared_error_loss(logits: torch.Tensor, targets_onehot: torch.Tensor) -> torch.Tensor:
    """rwkv_opt's squared-error option (rwkv.cpp:1384-1401)."""
    d = logits.float() - targets_onehot.float()
    return torch.sum(d * d)


def lm_loss(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor,
            targets: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """Full-sequence causal LM loss. tokens/targets: [B, T] integer, on the
    params' device; the forward writes an f32 cache of its own.  mesh: the
    params are this rank's slices and tokens/targets its [B/dp, T/sp] block
    (parallel/mesh_train.py); the loss is the whole batch's."""
    if mesh is not None:
        from ..parallel.mesh_train import mesh_lm_loss

        return mesh_lm_loss(cfg, params, tokens, targets, mesh)
    b, t = tokens.shape
    cache_k, cache_v = init_cache(cfg, b, t, dtype=torch.float32, device=tokens.device)
    logits = transformer.forward(cfg, params, tokens, 0, cache_k, cache_v, last_only=False)
    return cross_entropy_loss(logits, targets)


def make_train_step(cfg: ModelConfig, tx: Transform,
                    loss_fn: Callable | None = None, *, mesh=None) -> Callable:
    """step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss): the loss and its gradient, tx's update (the line search
    evaluating loss_fn again on the same batch) and the new params.  The
    state is updated in place (the JAX step donates it; its L-BFGS step
    does not, which the in-place memory makes moot) and the params returned
    are new tensors.  mesh: JAX's step on sharded params: params and state
    are this rank's slices (``shard_transformer``, ``tx.init`` of them),
    tokens and targets its block (``shard_tokens(...,
    sequence_parallel=True)``), loss_fn a loss over the mesh (default
    ``lm_loss(..., mesh=mesh)``); every rank of the mesh calls it."""
    loss_fn = loss_fn or partial(lm_loss, cfg, mesh=mesh)

    def step(params, opt_state, tokens, targets):
        fn = partial(_bound, loss_fn, tokens=tokens, targets=targets)
        loss, grads = value_and_grad(fn, params, mesh)
        updates, opt_state = tx.update(grads, opt_state, params, value=loss, grad=grads,
                                       value_fn=fn, mesh=mesh)
        return apply_updates(params, updates), opt_state, loss

    return step


def _bound(loss_fn, p, *, tokens, targets):
    return loss_fn(p, tokens, targets)
