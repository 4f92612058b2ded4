"""The port's training stack against the JAX package's: the loss and its
gradients, the dense bf16 product's gradient rounding, Adam and L-BFGS steps
(optax's zoom line search step for step), the stacked and remat forwards,
checkpoints in both directions and the ggjt export.  Both packages start from
the same params: the JAX init's, carried across as numpy."""

import dataclasses
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llama_cpp_q_4_0_tpu.models.config import ModelConfig as JaxConfig
from llama_cpp_q_4_0_tpu.training import OptParams as JaxOptParams
from llama_cpp_q_4_0_tpu.training import checkpoint as jckpt
from llama_cpp_q_4_0_tpu.training import init_opt_state as jax_init_opt
from llama_cpp_q_4_0_tpu.training import init_transformer as jax_init
from llama_cpp_q_4_0_tpu.training import make_optimizer as jax_make_optimizer
from llama_cpp_q_4_0_tpu.training import make_train_step as jax_make_step
from llama_cpp_q_4_0_tpu.training import stacked as jstacked
from llama_cpp_q_4_0_tpu.training.train import lm_loss as jax_lm_loss
from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
from llama_cpp_q_4_0_tpu_torch.models import transformer
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul
from llama_cpp_q_4_0_tpu_torch.training import checkpoint as tckpt
from llama_cpp_q_4_0_tpu_torch.training import stacked as tstacked
from llama_cpp_q_4_0_tpu_torch.training import train as T
from llama_cpp_q_4_0_tpu_torch.training.model import init_transformer
from llama_cpp_q_4_0_tpu_torch.training.tree import flatten_with_path, leaves, tree_map

WIDTHS = dict(n_vocab=64, n_embd=32, n_mult=16, n_head=2, n_layer=2, n_rot=16, n_ctx=16)


def numpy_tree(p):
    leaf = (lambda v: None if v is None else np.asarray(v))
    return {"tok_embeddings": leaf(p.tok_embeddings),
            "blocks": [{f.name: leaf(getattr(b, f.name)) for f in dataclasses.fields(b)}
                       for b in p.blocks],
            "out_norm_w": leaf(p.out_norm_w), "out_norm_b": leaf(p.out_norm_b),
            "output": leaf(p.output)}


def configs(mode: str):
    return (JaxConfig.llama(**WIDTHS, compute_dtype=mode),
            ModelConfig.llama(**WIDTHS, compute_dtype=mode))


@pytest.fixture(scope="module")
def setup():
    """tests/test_training.py's setup (its config, init and batch), with
    the port's params carried across from the JAX init."""
    jcfg, cfg = configs("bfloat16")
    jp = jax_init(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (4, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    tp = params_from_numpy(numpy_tree(jp), device="cpu")
    return jcfg, cfg, jp, tp, tokens, targets


def _batch(tokens, targets):
    return (jnp.asarray(tokens), jnp.asarray(targets),
            torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())


def _grads(mode, setup):
    _, _, jp, tp, tokens, targets = setup
    jcfg, cfg = configs(mode)
    jt, jy, tt, ty = _batch(tokens, targets)
    jl, jg = jax.value_and_grad(lambda p: jax_lm_loss(jcfg, p, jt, jy))(jp)
    tl, tg = T.value_and_grad(lambda p: T.lm_loss(cfg, p, tt, ty), tp)
    names = [k for k, _ in flatten_with_path(tg, "params")]
    return (float(jl), float(tl), names, [np.asarray(g) for g in jax.tree.leaves(jg)],
            [g.numpy() for g in leaves(tg)])


def bf16_ulps(want, got):
    """|got - want| in bf16 ulps of want's magnitude."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / ulp


def test_init_transformer_fields_and_shapes(setup):
    """The port's init sets and leaves None the JAX init's fields, at its
    shapes, in f32 (the draws are the generator's own)."""
    jcfg, cfg, jp, _, _, _ = setup
    tp = init_transformer(cfg, torch.Generator().manual_seed(0))
    want = jckpt._flatten(jp, "params")
    got = dict(flatten_with_path(tp, "params"))
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32, k
    assert float(got["params.blocks[0].attn_norm_w"].min()) == 1.0
    assert abs(float(got["params.output"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_lm_loss_matches_jax(setup, mode):
    jl, tl, *_ = _grads(mode, setup)
    assert abs(tl - jl) <= 1e-6 * abs(jl), (jl, tl)


def test_grads_f32_match_jax(setup):
    """f32 compute: every gradient leaf within rtol 1e-5 of JAX's, with an
    absolute floor of 1e-5 of the leaf's largest magnitude (elements that
    cancel to near zero differ in their last f32 bits only)."""
    _, _, names, want, got = _grads("float32", setup)
    assert len(want) == len(got) == 21
    for name, a, b in zip(names, want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max(), err_msg=name)


def test_grads_bf16_match_jax(setup):
    """Default bf16 compute.  The output head and the last layer are within
    one bf16 ulp elementwise.  Upstream of them an activation that rounds to
    bf16 an ulp apart (f32 sums in another order) moves a few cotangents by
    an ulp, which the first layer's attention carries into its weights: every
    leaf stays within 1e-2 of its scale and at most 0.5% of any leaf's
    elements are more than 2 bf16 ulps from JAX's (0.2% measured).  Without
    the backward's bf16 rounding of the cotangents 15.6% are (a variant with
    f32 cotangents, measured)."""
    _, _, names, want, got = _grads("bfloat16", setup)
    for name, a, b in zip(names, want, got):
        u = bf16_ulps(a, b)
        assert np.abs(a - b).max() <= 1e-2 * np.abs(a).max(), name
        assert np.mean(u > 2) <= 5e-3, (name, float(np.mean(u > 2)))
        if ".blocks[0]." not in name and name != "params.tok_embeddings":
            assert u.max() <= 1.0, (name, float(u.max()))


def test_bf16_product_gradient_rounds_as_jax():
    """One dense bf16 product: the port's gradients are JAX's transpose of
    dot_general(bf16, bf16, preferred f32) bit for bit (each cotangent the f32
    product with the other bf16 operand, rounded to bf16), and so is plain
    autograd through the cast chain, whose cast backward rounds alike; f32
    cotangents would sit up to half a bf16 ulp away."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    g = rng.standard_normal((37, 48)).astype(np.float32)

    def f(x, w):
        return jax.lax.dot_general(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                                   (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    with torch.enable_grad():
        got = qmatmul.q_matmul(xt, wt)
        dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
        plain = qmatmul.bf16_f32(xt) @ qmatmul.bf16_f32(wt).T
        px, pw = torch.autograd.grad(plain, (xt, wt), torch.from_numpy(g))
    names = {type(f).__name__ for f, _ in got.grad_fn.next_functions if f is not None}
    assert any("Bf16Product" in n for n in names), names
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(dx.numpy(), jdx)
    np.testing.assert_array_equal(dw.numpy(), jdw)
    np.testing.assert_array_equal(px.numpy(), jdx)
    np.testing.assert_array_equal(pw.numpy(), jdw)
    xb, wb = qmatmul.bf16_f32(torch.from_numpy(x)), qmatmul.bf16_f32(torch.from_numpy(w))
    fx = (torch.from_numpy(g) @ wb).numpy()
    assert not np.array_equal(fx, jdx) and bf16_ulps(jdx, fx).max() <= 0.5
    # without grad the Function records no graph, and its product is the
    # cast chain's bit for bit
    with torch.no_grad():
        inf = qmatmul.q_matmul(xt, wt)
        assert inf.grad_fn is None
        np.testing.assert_array_equal(inf.numpy(), plain.detach().numpy())


def _saved_bytes(fn):
    """Bytes of the distinct storages that fn's forward saves for its
    backward (what stays allocated between the forward and the backward)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t.detach()  # t itself, an output kept, would close a cycle through its node

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_bf16_product_saves_two_byte_copies():
    """What the dense bf16 product keeps for its backward: the operands'
    bf16 copies, half the bytes of the f32 widenings that autograd of the
    plain cast chain keeps."""
    x = torch.randn(37, 64, requires_grad=True)
    w = torch.randn(48, 64, requires_grad=True)

    got = _saved_bytes(lambda: qmatmul.q_matmul(x, w))
    plain = _saved_bytes(lambda: qmatmul.bf16_f32(x) @ qmatmul.bf16_f32(w).T)
    assert got == 2 * (37 + 48) * 64 and plain == 2 * got, (got, plain)


def _run_both(setup, kind, clip, n, mode="float32"):
    _, _, jp, tp, tokens, targets = setup
    jcfg, cfg = configs(mode)
    jt, jy, tt, ty = _batch(tokens, targets)
    jtx = jax_make_optimizer(JaxOptParams(kind=kind, lr=1e-2, grad_clip=clip))
    js, jstep = jax_init_opt(jtx, jp), jax_make_step(jcfg, jtx, donate=False)
    ttx = T.make_optimizer(T.OptParams(kind=kind, lr=1e-2, grad_clip=clip))
    ts, tstep = T.init_opt_state(ttx, tp), T.make_train_step(cfg, ttx)
    a, b, rows = jp, tp, []
    for _ in range(n):
        a, js, la = jstep(a, js, jt, jy)
        b, ts, lb = tstep(b, ts, tt, ty)
        row = [float(la), float(lb)]
        if kind == "lbfgs":
            jz, tz = (js[1][2], ts[1][2]) if clip else (js[2], ts[2])
            row += [int(jz.info.num_linesearch_steps), int(tz.info.num_linesearch_steps),
                    float(jz.learning_rate), float(tz.learning_rate)]
        rows.append(row)
    return rows, (a, js), (b, ts)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adam_steps_match_jax(setup, clip):
    """10 steps of adamw (chained after clip_by_global_norm when clip > 0):
    the losses within 1e-5 relative, f32 compute."""
    rows, (a, _), (b, _) = _run_both(setup, "adam", clip, 10)
    for la, lb in rows:
        assert abs(la - lb) <= 1e-5 * abs(la), rows
    assert rows[-1][0] < rows[0][0]
    for x, y in zip(jax.tree.leaves(a), leaves(b)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(x)).max())


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_lbfgs_steps_match_jax(setup, clip):
    """4 steps of optax.lbfgs (memory 6, zoom line search): the losses
    within 1e-5 relative, the line search's step counts equal to optax's
    info.num_linesearch_steps and its accepted step sizes within 1e-4."""
    rows, _, _ = _run_both(setup, "lbfgs", clip, 4)
    for la, lb, ja, tb, jlr, tlr in rows:
        assert abs(la - lb) <= 1e-5 * abs(la), rows
        assert ja == tb, rows
        assert abs(jlr - tlr) <= 1e-4 * abs(jlr), rows
    assert rows[-1][0] < rows[0][0]


def _rosen_jax(p):
    x = jnp.concatenate([p["a"], p["b"].reshape(-1)])
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_torch(p):
    x = torch.cat([p["a"], p["b"].reshape(-1)])
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("memory", [3, 10])
def test_zoom_linesearch_matches_optax_on_rosenbrock(memory):
    """The port of optax.lbfgs on a two-leaf Rosenbrock valley, whose line
    searches zoom (cubic, quadratic and bisection steps; 3 to 6 steps a
    search here): 20 iterations with optax's step counts, the values within
    1e-5 relative for the first 10 and within 1e-3 after (f32 roundings
    apart grow along the valley: 1.6e-4 measured at iteration 20)."""
    rng = np.random.default_rng(0)
    init = {"a": rng.uniform(-2, 2, 4).astype(np.float32),
            "b": rng.uniform(-2, 2, (2, 3)).astype(np.float32)}
    jtx = optax.with_extra_args_support(optax.lbfgs(memory_size=memory))
    ttx = T.lbfgs(memory_size=memory)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    counts = []
    for i in range(20):
        jv, jg = jax.value_and_grad(_rosen_jax)(jp)
        u, js = jtx.update(jg, js, jp, value=jv, grad=jg, value_fn=_rosen_jax)
        jp = optax.apply_updates(jp, u)
        tv, tg = T.value_and_grad(_rosen_torch, tp)
        u, ts = ttx.update(tg, ts, tp, value=tv, grad=tg, value_fn=_rosen_torch)
        tp = T.apply_updates(tp, u)
        counts.append((int(js[2].info.num_linesearch_steps),
                       int(ts[2].info.num_linesearch_steps)))
        assert counts[-1][0] == counts[-1][1], counts
        gap = abs(float(jv) - float(tv)) / abs(float(jv))
        assert gap <= (1e-5 if i < 10 else 1e-3), (i, float(jv), float(tv))
    assert max(c for c, _ in counts) >= 3, counts
    assert float(_rosen_torch(tp)) < float(_rosen_torch({k: torch.from_numpy(v)
                                                         for k, v in init.items()}))


def test_stacked_matches_loop_and_jax(setup):
    """The stacked forward against the port's loop forward and the JAX
    stacked forward (2e-4, the JAX stacked gate); remat against no remat bit
    for bit, logits and gradients; unstack round-trips exactly."""
    jcfg, cfg, jp, tp, tokens, targets = setup
    jt, jy, tt, ty = _batch(tokens, targets)
    ck, cv = transformer.init_cache(cfg, 4, 16, dtype=torch.float32, device="cpu")
    ref = transformer.forward(cfg, tp, tt, 0, ck, cv, last_only=False).numpy()
    sp = tstacked.stack_params(tp)
    jref = np.asarray(jstacked.stacked_forward(jcfg, jstacked.stack_params(jp), jt))
    outs = {}
    for remat in (False, True):
        got = tstacked.stacked_forward(cfg, sp, tt, remat=remat).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, jref, rtol=2e-4, atol=2e-4)
        outs[remat] = (got, T.value_and_grad(
            lambda p: tstacked.stacked_lm_loss(cfg, p, tt, ty, remat=remat), sp))
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    assert float(outs[True][1][0]) == float(outs[False][1][0])
    for a, b in zip(leaves(outs[True][1][1]), leaves(outs[False][1][1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    back = tstacked.unstack_params(sp, cfg.n_layer)
    for a, b in zip(leaves(back), leaves(tp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_remat_keeps_fewer_saved_tensors(setup):
    """remat keeps each layer's input for the backward, not its
    activations: the stacked loss saves under a quarter of the bytes it
    saves without remat (0.11 at these widths), which a remat that did
    nothing would not."""
    _, cfg, _, tp, tokens, targets = setup
    _, _, tt, ty = _batch(tokens, targets)
    sp = tree_map(lambda t: t.detach().requires_grad_(True), tstacked.stack_params(tp))
    kept = {remat: _saved_bytes(lambda: tstacked.stacked_lm_loss(cfg, sp, tt, ty, remat=remat))
            for remat in (False, True)}
    assert kept[True] < kept[False] / 4, kept


def test_stacked_train_step_matches_jax(setup):
    """6 remat steps of the stacked trainer, f32 compute: the losses within
    1e-5 relative of the JAX stacked step's."""
    _, _, jp, tp, tokens, targets = setup
    jcfg, cfg = configs("float32")
    jt, jy, tt, ty = _batch(tokens, targets)
    jtx = jax_make_optimizer(JaxOptParams(kind="adam", lr=1e-2))
    ttx = T.make_optimizer(T.OptParams(kind="adam", lr=1e-2))
    a, b = jstacked.stack_params(jax.tree.map(jnp.copy, jp)), tstacked.stack_params(tp)
    js, ts = jax_init_opt(jtx, a), ttx.init(b)
    jstep = jstacked.make_stacked_train_step(jcfg, jtx, remat=True)
    tstep = tstacked.make_stacked_train_step(cfg, ttx, remat=True)
    losses = []
    for _ in range(6):
        a, js, la = jstep(a, js, jt, jy)
        b, ts, lb = tstep(b, ts, tt, ty)
        losses.append((float(la), float(lb)))
    for la, lb in losses:
        assert abs(la - lb) <= 1e-5 * abs(la), losses
    assert losses[-1][1] < losses[0][1]


def _states(setup, kind, stacked):
    jcfg, cfg, jp, tp, _, _ = setup
    op = dict(kind=kind, lr=1e-2, grad_clip=1.0)
    jtx, ttx = jax_make_optimizer(JaxOptParams(**op)), T.make_optimizer(T.OptParams(**op))
    if stacked:
        jp, tp = jstacked.stack_params(jp), tstacked.stack_params(tp)
    return jcfg, cfg, jp, tp, jax_init_opt(jtx, jp), ttx.init(tp)


def _zip_contents(path):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    return meta, arrays


@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
@pytest.mark.parametrize("stacked", [False, True])
def test_checkpoint_keys_and_meta_match_jax(tmp_path, setup, kind, stacked):
    """The port's checkpoint has JAX's keys (optax's paths for the state),
    shapes, dtypes and meta.json, for Adam and L-BFGS, stacked and not."""
    jcfg, cfg, jp, tp, js, ts = _states(setup, kind, stacked)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save_checkpoint(jpath, jcfg, jp, js, step=3, extra={"stacked": stacked})
    tckpt.save_checkpoint(tpath, cfg, tp, ts, step=3, extra={"stacked": stacked})
    jm, ja = _zip_contents(jpath)
    tm, ta = _zip_contents(tpath)
    assert tm == jm
    assert list(ta) == list(ja)
    for k in ja:
        assert ta[k].shape == ja[k].shape and ta[k].dtype == ja[k].dtype, k


@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
def test_checkpoint_cross_loads_bit_for_bit(tmp_path, setup, kind):
    """After a step in each package: the JAX checkpoint loads into the port
    and the port's into JAX, every leaf bit for bit."""
    jcfg, cfg, jp, tp, js, ts = _states(setup, kind, False)
    tokens, targets = setup[4], setup[5]
    jt, jy, tt, ty = _batch(tokens, targets)
    jp, js, _ = jax_make_step(jcfg, jax_make_optimizer(JaxOptParams(kind=kind, lr=1e-2,
                                                                     grad_clip=1.0)),
                              donate=False)(jp, js, jt, jy)
    ttx = T.make_optimizer(T.OptParams(kind=kind, lr=1e-2, grad_clip=1.0))
    tp, ts, _ = T.make_train_step(cfg, ttx)(tp, ts, tt, ty)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save_checkpoint(jpath, jcfg, jp, js, step=1)
    tckpt.save_checkpoint(tpath, cfg, tp, ts, step=1)
    # JAX -> port
    cfg2, p2, s2, st = tckpt.load_checkpoint(jpath, tp, ts)
    assert st == 1 and cfg2 == cfg
    want = {**jckpt._flatten(jp, "params"), **jckpt._flatten(js, "opt")}
    got = dict(flatten_with_path(p2, "params") + flatten_with_path(s2, "opt"))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].numpy().dtype == v.dtype
    # port -> JAX
    _, jp2, js2, st = jckpt.load_checkpoint(tpath, jp, js)
    assert st == 1
    want = dict(flatten_with_path(tp, "params") + flatten_with_path(ts, "opt"))
    got = {**jckpt._flatten(jp2, "params"), **jckpt._flatten(js2, "opt")}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
def test_resumed_step_bit_for_bit(tmp_path, setup, kind):
    """Two steps, a checkpoint, then a step from the loaded state equals the
    step from the live state bit for bit (loss and params)."""
    _, cfg, _, tp, tokens, targets = setup
    _, _, tt, ty = _batch(tokens, targets)
    ttx = T.make_optimizer(T.OptParams(kind=kind, lr=1e-2, grad_clip=1.0))
    step = T.make_train_step(cfg, ttx)
    p, s = tp, ttx.init(tp)
    for _ in range(2):
        p, s, _ = step(p, s, tt, ty)
    path = str(tmp_path / "c.ckpt")
    tckpt.save_checkpoint(path, cfg, p, s, step=2)
    like_p = init_transformer(cfg, torch.Generator().manual_seed(5))
    _, p2, s2, _ = tckpt.load_checkpoint(path, like_p, ttx.init(like_p))
    a = step(p, s, tt, ty)
    b = step(p2, s2, tt, ty)
    assert float(a[2]) == float(b[2])
    for x, y in zip(leaves(a[0]), leaves(b[0])):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("qtype", ["F32", "F16", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0"])
def test_save_llama_ggjt_bytes_match_jax(tmp_path, setup, qtype):
    """The exported ggjt's bytes equal the JAX package's for each qtype."""
    from llama_cpp_q_4_0_tpu.formats.export import save_llama_ggjt as jax_save
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JT
    from llama_cpp_q_4_0_tpu_torch.formats.export import save_llama_ggjt
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

    jcfg, cfg, jp, tp, _, _ = setup
    vocab = [(f"t{i}".encode(), -float(i)) for i in range(cfg.n_vocab)]
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jax_save(jpath, jcfg, jp, vocab, JT[qtype])
    save_llama_ggjt(tpath, cfg, tp, vocab, GGMLType[qtype])
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_no_grad_leaks_from_inference(setup, monkeypatch):
    """The forward carries gradients now; inference takes none.  Every
    forward output seen while Context.eval, perplexity, speculative decoding
    and the serving engine run (grad mode on in this thread) has
    requires_grad False, and so does each direct call of the forwards those
    run; lm_loss on params that require grad does require it."""
    from llama_cpp_q_4_0_tpu_torch.runtime import batch_engine
    from llama_cpp_q_4_0_tpu_torch.runtime import perplexity as ppl
    from llama_cpp_q_4_0_tpu_torch.runtime import speculative
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    _, cfg, _, tp, tokens, targets = setup
    cfg = dataclasses.replace(cfg, n_ctx=64)
    seen = []
    real = transformer.forward

    def recorder(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[0] if isinstance(out, tuple) else out)
        return out

    monkeypatch.setattr(transformer, "forward", recorder)
    assert torch.is_grad_enabled()
    ctx = Context(cfg, tp, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    ctx.eval(np.asarray([[1, 5, 9]]))
    ctx.eval(np.asarray([[7]]))
    ppl.perplexity(ctx, list(range(1, 33)), n_ctx=16, n_batch=16)
    ctx.reset()
    speculative.generate_speculative(ctx, [1, 5, 9, 5, 9, 5], 4)
    eng = batch_engine.BatchEngine(cfg, tp, n_slots=2, n_ctx=64, cache_dtype=torch.float32,
                                   device="cpu")
    eng.start()
    try:
        req = eng.submit(batch_engine.Request([3, 5, 7], n_predict=3,
                                              sampling=SamplingParams(temp=-1.0)))
        while req.out.get(timeout=120) is not None:
            pass
    finally:
        eng.stop()
    ck, cv = transformer.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    chunk = torch.arange(1, 17)[None]
    direct = [ppl.chunk_nll(cfg, tp, chunk, ck, cv, 0, 16)]
    ck, cv = transformer.init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    key = prng_key(0, torch.device("cpu"))
    ids, _ = speculative.verify_step(cfg, tp, torch.tensor([[1, 5, 9]]), 0, ck, cv, key, None,
                                     ds=DeviceSampling(temp=-1.0), kv_window=64)
    direct.append(ids)
    assert len(seen) >= 8
    assert not any(t.requires_grad for t in seen + direct)
    _, _, tt, ty = _batch(tokens, targets)
    live = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    assert T.lm_loss(setup[1], live, tt, ty).requires_grad


def test_checkpoint_refuses_compressed_npz(tmp_path, setup):
    """Both packages store arrays.npz uncompressed (np.savez in a stored
    entry); a checkpoint whose arrays.npz is deflated is refused, while the
    stored one with the same arrays loads bit for bit."""
    _, cfg, _, tp, _, _ = setup
    ttx = T.make_optimizer(T.OptParams(kind="adam", lr=1e-2))
    state = ttx.init(tp)
    stored, packed = str(tmp_path / "s.ckpt"), str(tmp_path / "c.ckpt")
    tckpt.save_checkpoint(stored, cfg, tp, state, step=7)
    meta, arrays = _zip_contents(stored)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(packed, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("arrays.npz", buf.getvalue())
    with pytest.raises(ValueError, match="compressed"):
        tckpt.load_checkpoint(packed, tp, ttx.init(tp))
    _, p2, s2, st = tckpt.load_checkpoint(stored, tp, ttx.init(tp))
    assert st == 7
    got = dict(flatten_with_path(p2, "params") + flatten_with_path(s2, "opt"))
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

