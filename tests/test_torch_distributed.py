"""A 2-process smoke of the port's parallel/distributed.py, as
tests/test_distributed_smoke.py checks the JAX one: ``initialize`` (gloo,
named by the caller; a second call is a no-op), ``is_primary``,
``pod_mesh(tp=1)`` laid out (2, 1, 1) with JAX's axis names, an all-gather
whose blocks sum to 3.0, and ``sync_hosts``."""

import os

from torch_worlds import load, run_world, save

HERE = os.path.abspath(__file__)


def port_world(rank: int, out: str) -> None:
    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel import distributed
    from llama_cpp_q_4_0_tpu_torch.parallel.mesh import all_gather

    distributed.initialize("tcp://127.0.0.1:1", 2, rank, backend="gloo")  # no-op: initialized
    mesh = distributed.pod_mesh(tp=1, device="cpu")
    got = all_gather(torch.tensor([float(rank + 1)]), mesh, "dp")
    distributed.sync_hosts("smoke")
    save(out, f"got_{rank}", {"primary": distributed.is_primary(),
                              "shape": mesh.devices.shape, "axes": mesh.axis_names,
                              "world": torch.distributed.get_world_size(),
                              "backend": torch.distributed.get_backend(),
                              "sum": float(got.sum())})


def test_two_process_distributed(tmp_path):
    run_world(2, HERE, "port_world", str(tmp_path), timeout=180)
    for rank in range(2):
        g = load(str(tmp_path), f"got_{rank}")
        assert g["primary"] == (rank == 0)
        assert g["shape"] == (2, 1, 1) and g["axes"] == ("dp", "sp", "tp")
        assert g["world"] == 2 and g["backend"] == "gloo"
        assert g["sum"] == 3.0  # 1.0 from rank 0 + 2.0 from rank 1
