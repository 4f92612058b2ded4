"""rwkv_opt in the port against the JAX package's, on the 1-layer f32 RWKV
file of tests/test_aux.py: the errors before and after, the weights and the
advanced state written into the RwkvContext's own tensors (its replayed
graphs hold them by address), and the next step equal to an eager forward
on them."""

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_rwkv_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read
from llama_cpp_q_4_0_tpu.models.loading import config_from_ggjt as jax_config
from llama_cpp_q_4_0_tpu.models.loading import load_rwkv as jax_load
from llama_cpp_q_4_0_tpu.quant.types import GGMLType
from llama_cpp_q_4_0_tpu.runtime.context import RwkvContext as JaxRwkvContext
from llama_cpp_q_4_0_tpu.training.rwkv_opt import rwkv_opt as jax_rwkv_opt
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import rwkv
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_rwkv
from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext
from llama_cpp_q_4_0_tpu_torch.training.rwkv_opt import rwkv_opt
from llama_cpp_q_4_0_tpu_torch.training.tree import leaves


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rwkv_opt")
    out = {}
    for name, qtype in (("f32", GGMLType.F32), ("q4_0", GGMLType.Q4_0)):
        out[name] = str(d / f"r-{name}.bin")
        make_rwkv_ggjt(out[name], n_vocab=128, n_embd=32, n_layer=1, qtype=qtype)
    return out


def _port_ctx(path):
    gf = read_ggjt(path, "rwkv")
    cfg = config_from_ggjt(gf, n_ctx=64)
    return RwkvContext(cfg, load_rwkv(gf, cfg, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def jax_errors(files):
    out = {}
    for loss in ("squared_error", "cross_entropy"):
        gf = jax_read(files["f32"], "rwkv")
        cfg = jax_config(gf, n_ctx=64)
        ctx = JaxRwkvContext(cfg, jax_load(gf, cfg))
        ctx.eval(np.asarray([[5, 9]], np.int32))
        out[loss] = jax_rwkv_opt(ctx, token=11, actual=42, n_iter=4, loss=loss)
    return out


def _ptrs(ctx):
    views = leaves(ctx.params) + leaves(ctx._params_prefill)
    return [t.data_ptr() for t in views + list(ctx.state.values())]


@pytest.mark.parametrize("loss", ["squared_error", "cross_entropy"])
def test_rwkv_opt_matches_jax_in_place(files, jax_errors, loss):
    """error_before within 1e-5 of JAX's and error_after within 1e-2 of the
    larger error's scale of JAX's (the four L-BFGS steps take optax's step
    counts; bf16 weights round the small differences of each step apart);
    under the squared error the error falls (cross-entropy pushes the
    target logit past 1, in both packages).  n_past 3; the params and state
    tensors keep their addresses, the weights moved, and the next step of the
    context equals the eager forward of the new weights on the new state bit
    for bit."""
    jb, ja = jax_errors[loss]
    ctx = _port_ctx(files["f32"])
    ctx.eval(np.asarray([[5, 9]]))
    ptrs = _ptrs(ctx)
    head = ctx.params.head.clone()
    before, after = rwkv_opt(ctx, token=11, actual=42, n_iter=4, loss=loss)
    assert abs(before - jb) <= 1e-5 * abs(jb), (before, jb)
    assert np.isfinite(after)
    assert abs(after - ja) <= 1e-2 * max(abs(jb), abs(ja)), (after, ja)
    if loss == "squared_error":
        assert after < before, (before, after)
    assert ctx.n_past == 3
    assert _ptrs(ctx) == ptrs
    assert not torch.equal(ctx.params.head, head)
    state = {k: t.clone() for k, t in ctx.state.items()}
    logits = ctx.eval(np.asarray([[11]]))
    call = ctx.last_call
    want, new = rwkv.forward(ctx.cfg, call.params, torch.from_numpy(call.x), state,
                             valid=torch.from_numpy(call.valid), last_only=call.last_only)
    np.testing.assert_array_equal(logits, want.numpy())
    for k, t in ctx.state.items():
        np.testing.assert_array_equal(t.numpy(), new[k].numpy())
    assert np.isfinite(logits).all()


def test_rwkv_opt_refuses_quantized_params(files):
    ctx = _port_ctx(files["q4_0"])
    ctx.eval(np.asarray([[5, 9]]))
    with pytest.raises(ValueError, match="dense"):
        rwkv_opt(ctx, token=11, actual=42, n_iter=1)
