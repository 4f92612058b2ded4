"""What the benchmark may import, and that its parts are found by name."""

import ast
import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX_SIDE = {"jax", "jaxlib", "flax", "llama_cpp_q_4_0_tpu"}
PROGRAM = "llama_cpp_q_4_0_tpu_torch"


def modules_imported(path):
    """Top-level names of every module a file imports (a relative import
    names this package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else node.module.split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        found = modules_imported(path) & JAX_SIDE
        assert not found, f"{path} imports {found}"


def test_names_are_compared_whole():
    """The program's name begins with the JAX package's: only a whole
    top-level name counts."""
    assert PROGRAM.split(".")[0] not in JAX_SIDE
    assert PROGRAM.startswith("llama_cpp_q_4_0_tpu")


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert PROGRAM not in modules_imported(path), path
    # nor does the arithmetic it uses
    for name in ("raw.py", "roofline.py", "shapes.py", "traffic.py"):
        assert PROGRAM not in modules_imported(os.path.join(HERE, name)), name


def test_new_parts_are_found_by_name(tmp_path):
    """A configuration, a mix, limits and a metric added as new files in a
    copy are found through BENCHMARK.json with no file of the copy edited."""
    from portbench import harness

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: open(p, "rb").read() for p in map(str, (root / "portbench").rglob("*"))
              if os.path.isfile(p)}
    conf = json.load(open(root / "portbench" / "configs" / "stablelm-alpha-7b-q4_0.json"))
    conf["num_hidden_layers"] = 3
    (root / "portbench" / "configs" / "new-model.json").write_text(json.dumps(conf))
    mix = json.load(open(root / "portbench" / "traffic" / "chat32.json"))
    mix["clients"] = 7
    (root / "portbench" / "traffic" / "newmix.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "new-model.newmix.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.5}}))
    (root / "portbench" / "metrics" / "new.metric.py").write_text(
        "def read(r):\n    return r.window_s * 2\n")
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "portbench/configs/new-model.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new-model.newmix", "config": "new-model",
                               "traffic": "newmix", "chips": 1, "why": "x"})
    cell, c, m, lim = harness.cell_parts(bench, "new-model.newmix", str(root))
    assert c["num_hidden_layers"] == 3 and m["clients"] == 7 and lim["logit_gap"]["limit"] == 0.5
    reader = harness.metric_reader("new.metric", str(root))
    assert reader.read(harness.Readings(None, 1.5, None, 0, 0, 0, [], [])) == 3.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"


def test_every_cell_has_its_parts():
    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell, conf, mix, lim = harness.cell_parts(bench, w["name"])
        assert lim["logit_gap"]["limit"] > 0
    for m in bench["per_layer"]:
        assert hasattr(harness.metric_reader(m["name"]), "read")


OWN_MIX = '''"""A mix of its own: every request greedy with 6 tokens out, served by a
loop of its own: one burst of 6 requests at the open, nothing sent after."""
import os
import queue
import time

from portbench import harness, traffic

MIX = {"entry": "engine", "clients": 6, "slots": 4, "n_ctx": 256,
       "prompt": {"dist": "uniform", "min": 8, "max": 40},
       "output": {"dist": "uniform", "min": 4, "max": 8},
       "sampling": {"temp": 0.8, "top_k": 40}, "greedy_share": 1.0, "pool": 64}
SEEN = []


def requests(mix, seed, n_vocab, count):
    reqs = traffic.stratified(mix, seed, n_vocab, count)
    for r in reqs:
        r.n_predict = 6
    return reqs


class Server(harness.EngineServer):
    def __init__(self, *args):
        super().__init__(*args)
        SEEN.append(("switch", os.environ.get("PORTBENCH_TEST_SWITCH")))
        SEEN.append(("cache", str(self.engine.cache_dtype)))

    def window(self, pool, seconds, on_open=None, on_close=None):
        sink, burst = queue.Queue(), pool[:6]
        c0, t_open = self.counters(), time.perf_counter()
        for r in burst:
            self._submit(r, sink)
        left = len(burst)
        while left:
            i, t, item = sink.get(timeout=120)
            if item is None:
                burst[i].done, left = t, left - 1
            else:
                burst[i].tokens.append(item)
                burst[i].times.append(t)
        c1 = self.counters()
        self.engine.stop()
        SEEN.append(("served", [len(r.tokens) for r in burst]))
        return burst, c0, c1, t_open, max(time.perf_counter(), t_open + seconds), set()
'''


def test_a_py_mix_and_the_program_options_are_found_by_name(tmp_path):
    """A mix added as a module brings its own requests and its own client
    loop; a configuration names the program's switches and its cache type;
    both are used by a whole run, with no file of the copy edited."""
    import time

    import torch

    from portbench import harness, traffic

    data = tmp_path / "data"
    (data / "traffic").mkdir(parents=True)
    (data / "traffic" / "tiny-own.py").write_text(OWN_MIX)
    conf = json.load(open(os.path.join(HERE, "tests", "data", "tiny-gptneox.json")))
    conf.update(cache_type="f32", env={"PORTBENCH_TEST_SWITCH": "on"})
    mix = traffic.load("tiny-own", str(data))
    res = harness.run_cell(conf, mix, {"logit_gap": {"limit": 0.025}}, seed=2 ** 31 + 7,
                           seconds=1.0, trace=False, device=torch.device("cpu"),
                           t_process=time.time(), log=lambda *a, **k: None)
    seen = dict(mix["module"].SEEN)
    assert seen["switch"] == "on" and "PORTBENCH_TEST_SWITCH" not in os.environ
    assert seen["cache"] == "torch.float32"
    assert seen["served"] == [6] * 6
    assert res["attempted"] == 6 and res["correct"], res["checks"]
