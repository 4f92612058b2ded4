"""Multi-process worlds for the port's parallel tests.

The port's sharded paths run one process a rank, so a test of them spawns a
world: ``run_world(n, path, func, out)`` starts n processes of this script,
each of which joins a gloo group (``parallel.distributed.initialize`` with a
``file://`` store under out, on the CPU) and calls ``func(rank, out)`` of
the test module at ``path``.  The JAX references run in one fresh child
process a test file, ``run_jax(path, func, out)`` (the suite's virtual
8-device CPU mesh; large shard_map compiles late in a long process have
crashed jaxlib, tests/test_tp.py), and hand their results over as files
under out: the params as the numpy tree ``convert.params_from_numpy``
takes, the outputs as ``.npz``.

Run as a script: ``python tests/torch_worlds.py jax PATH FUNC OUT [ARG...]`` or
``python tests/torch_worlds.py port PATH FUNC OUT RANK N INIT``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


def _env(**extra):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join([ROOT, TESTS])}
    env.update(extra)
    return env


def _fail(what: str, outs) -> None:
    raise AssertionError(what + "\n" + "\n".join(o[-4000:] for o in outs))


def run_jax(path: str, func: str, out: str, timeout: float = 600) -> None:
    """func(out) of the test module at path, in a fresh JAX process."""
    r = subprocess.run([sys.executable, __file__, "jax", path, func, out], cwd=ROOT,
                       env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        _fail(f"JAX reference {func} failed (rc {r.returncode})", [r.stdout, r.stderr])


def run_jax_parallel(path: str, func: str, out: str, arg_lists, timeout: float = 600) -> None:
    """func(out, *args) of the test module at path for each args of
    arg_lists (strings), each in its own fresh JAX process, all started
    together: XLA's compiles of independent references overlap."""
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, __file__, "jax", path, func, out, *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in arg_lists]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for args, p, (o, e) in zip(arg_lists, procs, outs):
        if p.returncode:
            _fail(f"JAX reference {func}{tuple(args)} failed (rc {p.returncode})", [o, e])


def run_world(n: int, path: str, func: str, out: str, timeout: float = 600) -> None:
    """func(rank, out) of the test module at path on each rank of an n-process
    gloo world.  Every rank must exit 0; the first failure kills the rest."""
    init = f"file://{os.path.join(out, f'store-{func}')}"
    procs = [subprocess.Popen([sys.executable, __file__, "port", path, func, out, str(r),
                               str(n), init], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.returncode is not None):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        _fail(f"world {func} of {n} ranks failed: rcs {[p.returncode for p in procs]}", outs)


def save(out: str, name: str, obj) -> None:
    with open(os.path.join(out, name + ".pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out: str, name: str):
    with open(os.path.join(out, name + ".pkl"), "rb") as f:
        return pickle.load(f)


def np_tree(params) -> dict:
    """A JAX TransformerParams as the numpy tree of convert.params_from_numpy."""
    import numpy as np

    from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor

    def leaf(v):
        if v is None:
            return None
        if isinstance(v, QTensor):
            return {"levels_t": np.asarray(v.levels_t), "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None if v.gbias_t is None else np.asarray(v.gbias_t),
                    "gsize": v.gsize, "qtype": int(v.qtype), "shape": tuple(v.shape),
                    "pack_zero": v.pack_zero}
        return np.asarray(v)

    return {"tok_embeddings": leaf(params.tok_embeddings),
            "blocks": [{f.name: leaf(getattr(b, f.name)) for f in dataclasses.fields(b)}
                       for b in params.blocks],
            "out_norm_w": leaf(params.out_norm_w), "out_norm_b": leaf(params.out_norm_b),
            "output": leaf(params.output)}


def jax_cfg_dict(cfg) -> dict:
    """A JAX ModelConfig's fields, for the port's ModelConfig(**...)."""
    return dataclasses.asdict(cfg)


def port_model(out: str, name: str):
    """(ModelConfig, TransformerParams) on the CPU of what the JAX child
    saved under name: its config's fields and its params' numpy tree."""
    from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
    from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig

    cfg, tree = load(out, name)
    return ModelConfig(**cfg), params_from_numpy(tree, device="cpu")


def _module(path: str):
    spec = importlib.util.spec_from_file_location(
        "world_" + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(argv) -> None:
    kind, path, func, out = argv[:4]
    sys.path[:0] = [ROOT, TESTS]
    if kind == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        getattr(_module(path), func)(out, *argv[4:])
        return
    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    rank, n, init = int(argv[4]), int(argv[5]), argv[6]
    distributed.initialize(init, n, rank, backend="gloo")
    try:
        with torch.no_grad():
            getattr(_module(path), func)(rank, out)
        distributed.sync_hosts("done")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
