"""dtxlint for the port (datatunerx_tpu_torch/analysis) against the
reference's (datatunerx_tpu/analysis).

- The framework (suppressions, baseline, JSON and exit codes, config,
  ``--changed``, ``--select``, DTX000, the program graph, autofix) runs
  through one body on both packages (``pkg``); where a test needs a rule
  whose construct is JAX's, each package gets its own construct on the
  same line.
- The shared-construct rules (DTX006/007/009/011/012) and the program
  graph's fixtures give identical rendered findings through both linters.
- DTX001–005, 008 and 010: the reference's fixture pair beside its
  PyTorch twin, line for line — the same rule, line and message shape on
  the positive, nothing on the negative.
- The port's package lints clean against ``dtxlint-torch-baseline.json``
  (DTX001 only), sharing one package lint through a fixture.
"""

import ast
import dataclasses
import json
import os
import subprocess
import textwrap

import pytest

from tests.torch_twin import PKGS, Twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = PKGS

M = Twin(
    lint_source="analysis.core:lint_source",
    lint_paths="analysis.core:lint_paths",
    LintConfig="analysis.config:LintConfig",
    load_config="analysis.config:load_config",
    mesh_axes_for="analysis.config:mesh_axes_for",
    lint_program="analysis.program:lint_program",
    main="analysis.cli:main",
    fix_source="analysis.fix:fix_source",
    apply_edits="analysis.fix:apply_edits",
    SpanEdit="analysis.fix:SpanEdit",
    OverlapError="analysis.fix:OverlapError",
    save_baseline="analysis.baseline:save_baseline",
    load_baseline="analysis.baseline:load_baseline",
    partition="analysis.baseline:partition",
    rules_by_id="analysis.rules:rules_by_id",
)


@pytest.fixture(params=PKGS)
def pkg(request):
    return M.use(request.param)


def cfg():
    return M.LintConfig(mesh_axes=("dp", "fsdp", "tp", "sp"))


def run(src, config=None):
    return M.lint_source(textwrap.dedent(src), path="fixture.py",
                         config=config or cfg())


def rule_ids(src, config=None):
    return [f.rule for f in run(src, config).findings]


def pick(srcs):
    """The source of the package in use: ``{REF: ..., PORT: ...}``."""
    return srcs[M.pkg]


def lint_with(pkg_name, src, config_kw=None):
    M.use(pkg_name)
    conf = M.LintConfig(**(config_kw or {"mesh_axes":
                                          ("dp", "fsdp", "tp", "sp")}))
    return M.lint_source(textwrap.dedent(src), path="fixture.py",
                         config=conf).findings


# one line of device work at import, each package's construct, on line 2
DEVICE_WORK = {
    REF: "import jax.numpy as jnp\nA = jnp.ones((2,))\n",
    PORT: 'import torch\nA = torch.ones((2,), device="cuda")\n',
}


# --------------------------------------- shared constructs: identical output
DRAIN_LEAK_CLASS = """
import subprocess
import threading


class ReplicaSet:
    def __init__(self):
        self._lock = threading.Lock()
        self.target = 0
        self._procs = {}
        self._t = threading.Thread(target=self._supervise, daemon=True)
        self._t.start()

    def _supervise(self):
        while True:
            if len(self._procs) < self.target:
                self.spawn(str(len(self._procs)))

    def spawn(self, name):
        self._procs[name] = subprocess.Popen(["serve"])

    def scale(self, n):
        self.target = n

    def drain(self, name):
        self._procs[name].draining = True
"""

SHARED = {
    # name: (source, expected rule ids in order)
    "dtx006_007_drain_leak": (DRAIN_LEAK_CLASS, None),
    "dtx006_clean": ("""
    import threading

    class ReplicaSet:
        def __init__(self):
            self._lock = threading.Lock()
            self.target = 0
            self._t = threading.Thread(target=self._loop, daemon=True)

        def _loop(self):
            while True:
                with self._lock:
                    n = self.target

        def scale(self, n):
            with self._lock:
                self.target = n
    """, []),
    "dtx007_clean": ("""
    import subprocess
    import threading

    class ReplicaSet:
        def __init__(self):
            self._procs = {}

        def spawn(self, name):
            self._procs[name] = subprocess.Popen(["serve"])

        def close(self):
            procs = list(self._procs.values())
            for proc in procs:
                proc.terminate()

    def run_once():
        proc = subprocess.Popen(["true"])
        proc.wait()

    def fire_and_forget(fn):
        threading.Thread(target=fn, daemon=True).start()

    def handoff():
        return subprocess.Popen(["true"])
    """, []),
    "dtx009_flags": ("""
    import queue
    import subprocess
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = queue.Queue()

        def tick(self):
            with self._lock:
                item = self._q.get()
                subprocess.run(["sync-replica"])
            return item
    """, ["DTX009", "DTX009"]),
    "dtx009_clean": ("""
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._session = Session()

        def tick(self, proc, item_q):
            with self._lock:
                item = item_q.get(timeout=1.0)
                proc.wait(timeout=10)
            with self._session:  # not a lock: naming-based on purpose
                proc.communicate()
            proc.wait()  # blocking, but no lock held
            return item
    """, []),
    "dtx011_flags": ("""
    import threading

    class Pool:
        def __init__(self):
            self._alloc_lock = threading.Lock()
            self._stats_lock = threading.Lock()

        def allocate(self):
            with self._alloc_lock:
                with self._stats_lock:
                    return 1

        def report(self):
            with self._stats_lock:
                with self._alloc_lock:
                    return 2
    """, ["DTX011"]),
    "dtx011_clean": ("""
    import threading

    class Pool:
        def __init__(self):
            self._alloc_lock = threading.Lock()
            self._stats_lock = threading.Lock()

        def allocate(self):
            with self._alloc_lock:
                with self._stats_lock:
                    return 1

        def audit(self):
            with self._alloc_lock:
                with self._stats_lock:
                    return 2

        def stats_only(self):
            with self._stats_lock:
                return 3
    """, []),
    "dtx011_multi_item": ("""
    import threading

    _a_lock = threading.Lock()
    _b_lock = threading.Lock()

    def fwd():
        with _a_lock, _b_lock:
            pass

    def rev():
        with _b_lock, _a_lock:
            pass
    """, ["DTX011"]),
    "dtx012_flags": ("""
    import threading

    class Ticker:
        def start(self):
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

        def _run(self):
            while True:
                pass
    """, ["DTX012"]),
    "dtx012_clean": ("""
    import threading

    class EventLoop:
        def __init__(self):
            self._stop = threading.Event()

        def start(self):
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

        def _run(self):
            while not self._stop.is_set():
                pass

        def close(self):
            self._stop.set()

    class Joined:
        def start(self):
            self._t = threading.Thread(target=print, daemon=True)
            self._t.start()

        def close(self):
            self._t.join(timeout=5)

    class Scoped:
        def run_once(self):
            t = threading.Thread(target=print, daemon=True)
            t.start()
            t.join()
    """, []),
    "dtx012_escaping_handle": ("""
    import threading

    class Registry:
        def __init__(self):
            self._loaders = []

        def kick(self):
            t = threading.Thread(target=print, daemon=True)
            self._loaders.append(t)
            t.start()

        def close(self):
            workers = [w for w in self._loaders if w.is_alive()]
            for w in workers:
                w.join(timeout=5)

    class Promoter:
        def start(self):
            t = threading.Thread(target=print, daemon=True)
            self._promo = t
            t.start()

        def close(self):
            t = self._promo
            t.join(timeout=5)
    """, []),
    "dtx012_timer": ("""
    import threading

    class Debounce:
        def arm(self):
            self._timer = threading.Timer(1.0, print)
            self._timer.daemon = True
            self._timer.start()

        def close(self):
            self._timer.cancel()

    class NeverStarted:
        def build(self):
            self._t = threading.Thread(target=print, daemon=True)
    """, []),
    "dtx012_non_daemon": ("""
    import threading

    class Plain:
        def start(self):
            self._t = threading.Thread(target=print)
            self._t.start()
    """, None),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rule_fixture_identical_through_both_linters(name):
    src, want = SHARED[name]
    got = {p: [f.render() for f in lint_with(p, src)] for p in PKGS}
    assert got[REF] == got[PORT]
    ids = [r.split()[1] for r in got[PORT]]
    if want is not None:
        assert ids == want
    if name == "dtx006_007_drain_leak":
        assert "DTX006" in ids and "DTX007" in ids
    if name == "dtx012_non_daemon":
        assert "DTX012" not in ids
    if name == "dtx012_flags":
        assert "no shutdown evidence" in got[PORT][0]
        assert "self._t" in got[PORT][0]
    if name == "dtx011_flags":
        assert "lock-order inversion" in got[PORT][0]
        assert "opposite order" in got[PORT][0]


# ------------------------- retargeted rules: the reference's pair and twin
# name: (reference source, port source, expected rule ids on both); each
# twin keeps its construct on the reference's line
TWINS = {
    "dtx001_flags": ("""
    import jax
    import numpy as np

    def log_metrics(m):
        return float(m["loss"])

    def train_step(state, batch):
        out = state.apply(batch)
        log_metrics(out)
        return np.asarray(out)
    """, """
    import torch
    import numpy as np

    def log_metrics(m):
        return float(m["loss"])

    def train_step(state, batch):
        out = state.apply(batch)
        log_metrics(out)
        return out.cpu()
    """, ["DTX001", "DTX001"]),
    "dtx001_clean": ("""
    import numpy as np

    def train_step(state, batch):
        return state.apply(batch)

    def summarize(metrics):
        # same calls, but not reachable from a hot function
        return float(metrics["loss"]), np.asarray(metrics["hist"])

    def parse(v):
        return float("1.5")
    """, """
    import numpy as np

    def train_step(state, batch):
        return state.apply(batch)

    def summarize(metrics):
        # same calls, but not reachable from a hot function
        return float(metrics["loss"]), metrics["hist"].tolist()

    def parse(v):
        return float("1.5")
    """, []),
    "dtx002_flags": ("""
    import jax

    def compile_all(fns):
        out = []
        for f in fns:
            out.append(jax.jit(f))
        return out
    """, """
    import torch

    def compile_all(fns):
        out = []
        for f in fns:
            out.append(torch.compile(f))
        return out
    """, ["DTX002"]),
    "dtx002_clean": ("""
    import jax

    step = jax.jit(lambda x: x + 1)

    def run(n):
        for i in range(n):
            step(i)
        return jax.jit(lambda y: y, static_argnums=(0,))
    """, """
    import torch

    step = torch.compile(lambda x: x + 1)

    def run(n):
        for i in range(n):
            step(i)
        return torch.jit.script(lambda y: y)
    """, []),
    "dtx003_flags": ("""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(x):
        if jnp.any(x > 0):
            return x
        return -x
    """, """
    import torch
    import torch

    @torch.compile
    def f(x):
        if torch.any(x > 0):
            return x
        return -x
    """, ["DTX003"]),
    "dtx003_clean": ("""
    import jax
    import jax.numpy as jnp

    def impl(x):
        if x.ndim == 2:  # static under tracing
            return jnp.sum(x, axis=-1)
        return jnp.where(x > 0, x, -x)

    f = jax.jit(impl)

    def eager(x):
        # not jitted: Python control flow on values is fine
        if jnp.any(x > 0):
            return x
        return -x
    """, """
    import torch
    import torch

    def impl(x):
        if x.ndim == 2:  # static under compilation
            return torch.sum(x, dim=-1)
        return torch.where(x > 0, x, -x)

    f = torch.compile(impl)

    def eager(x):
        # not compiled: Python control flow on values is fine
        if torch.any(x > 0):
            return x
        return -x
    """, []),
    "dtx004_flags": ("""
    import jax

    def double(key):
        a = jax.random.normal(key, (2,))
        b = jax.random.uniform(key, (2,))
        return a + b

    def loop(key):
        return [jax.random.normal(key, (2,)) for _ in range(3)] if False \\
            else _loop(key)

    def _loop(key):
        out = []
        for i in range(3):
            out.append(jax.random.normal(key, (2,)))
        return out
    """, """
    from datatunerx_tpu_torch.ops import prng

    def double(key):
        a = prng.gumbel(key, (2,))
        b = prng.uniform(key, (2,))
        return a + b

    def loop(key):
        return [prng.gumbel(key, (2,)) for _ in range(3)] if False \\
            else _loop(key)

    def _loop(key):
        out = []
        for i in range(3):
            out.append(prng.gumbel(key, (2,)))
        return out
    """, ["DTX004", "DTX004"]),
    "dtx004_clean": ("""
    import jax

    def good(key, flag):
        k1, k2 = jax.random.split(key)
        a = jax.random.normal(k1, (2,))
        if flag:
            b = jax.random.uniform(k2, (2,))
        else:
            b = jax.random.normal(k2, (2,))
        return a + b

    def carry(key):
        out = []
        for i in range(3):
            key, sub = jax.random.split(key)
            out.append(jax.random.normal(sub, (2,)))
        return out

    def streams(key):
        # fold_in with distinct data is the documented idiom, not reuse
        return [jax.random.normal(jax.random.fold_in(key, i), (2,))
                for i in range(3)]
    """, """
    from datatunerx_tpu_torch.ops import prng

    def good(key, flag):
        k1, k2 = prng.split(key)
        a = prng.gumbel(k1, (2,))
        if flag:
            b = prng.uniform(k2, (2,))
        else:
            b = prng.gumbel(k2, (2,))
        return a + b

    def carry(key):
        out = []
        for i in range(3):
            key, sub = prng.split(key)
            out.append(prng.gumbel(sub, (2,)))
        return out

    def streams(key):
        # fold_in with distinct data is the documented idiom, not reuse
        return [prng.gumbel(prng.fold_in(key, i), (2,))
                for i in range(3)]
    """, []),
    "dtx005_flags": ("""
    from jax.sharding import PartitionSpec as P

    def spec():
        return P("data", None)
    """, """
    from datatunerx_tpu_torch.parallel.sharding import shard_tree

    def spec(tree, mesh):
        return shard_tree(tree, mesh, axes=("data", "tp"))
    """, ["DTX005"]),
    "dtx005_clean": ("""
    from jax.sharding import PartitionSpec as P

    def spec():
        return P(("dp", "fsdp"), None, "tp")
    """, """
    from datatunerx_tpu_torch.parallel.sharding import shard_tree

    def spec(tree, mesh):
        return shard_tree(tree, mesh, axes=("fsdp", "tp"))
    """, []),
    "dtx005_collective_clean": ("""
    import jax

    def reduce_ok(x, axis_name):
        y = jax.lax.pmean(x, "dp")
        z = jax.lax.psum(x, ("dp", "fsdp"))
        i = jax.lax.axis_index("tp")
        # a VARIABLE axis name (ring attention's parameter) is out of
        # static reach — must not be flagged
        return jax.lax.ppermute(y + z + i, axis_name, [(0, 1)])
    """, """
    from datatunerx_tpu_torch.parallel.sharding import gather_dim

    def reduce_ok(x, mesh, axis):
        y = mesh.group(("dp",))
        z = mesh.extent(("dp", "fsdp"))
        i = mesh.coords["tp"] + "abc".index("b")
        # a VARIABLE axis name (ring attention's parameter) is out of
        # static reach — must not be flagged
        return gather_dim(x, 1, mesh, axis), y, z, i
    """, []),
    "dtx008_flags": ("""
    import jax
    import jax.numpy as jnp

    TABLE = jnp.ones((8,))

    def f(x, fill=jnp.zeros((4,))):
        return x + fill

    N_DEV = jax.device_count()
    """, """
    import torch
    import torch

    TABLE = torch.ones((8,)).cuda()

    def f(x, fill=torch.zeros((4,), device="cuda")):
        return x + fill

    NAME = torch.cuda.get_device_name()
    """, ["DTX008"] * 3),
    "dtx008_clean": ("""
    import jax
    import jax.numpy as jnp

    DTYPE = jnp.float32

    def make_table():
        return jnp.ones((8,))

    f = jax.jit(make_table)
    g = lambda: jnp.zeros((4,))
    """, """
    import torch
    import torch

    DTYPE = torch.bfloat16

    def make_table():
        return torch.ones((8,), device="cuda")

    f = torch.compile(make_table)
    g = lambda: torch.zeros((4,)).cuda()
    """, []),
    "dtx010_flags": ("""
    import jax

    step = jax.jit(lambda s, b: s, donate_argnums=(0,))

    def run(state, batch):
        out = step(state, batch)
        return out, state
    """, """
    import torch

    g = new_graph()  # a torch.cuda.CUDAGraph, made when first needed

    def run(static_out, batch):
        out = static_out; g.replay()
        return out, batch

    def capture(model, x):
        with torch.cuda.graph(g):
            static_out = model(x)
    """, ["DTX010"]),
    "dtx010_clean": ("""
    import jax

    step = jax.jit(lambda s, b: s, donate_argnums=(0,))

    def train(state, batches):
        for b in batches:
            state = step(state, b)
        return state

    def reset(state, batch):
        _ = step(state, batch)
        state = make_state()
        return state
    """, """
    import torch

    g = new_graph()  # a torch.cuda.CUDAGraph, made when first needed

    def train(static_out, batches):
        for b in batches:
            g.replay(); out = static_out.clone()
        return out

    def reset(static_out, batch):
        first = static_out; g.replay()
        first = static_out.clone()
        return first

    def capture(model, x):
        with torch.cuda.graph(g):
            static_out = model(x)
    """, []),
    "dtx010_conditional_rebind": ("""
    import jax

    step = jax.jit(lambda s, b: s, donate_argnums=(0,))

    def run(state, batch, err):
        out = step(state, batch)
        if err:
            state = make_state()
        return out, state

    def fine(state, batch, err):
        out = step(state, batch)
        if err:
            state = make_state()
            log(state)
        return out
    """, """
    import torch

    g = new_graph()  # a torch.cuda.CUDAGraph, made when first needed

    def run(static_out, batch, err):
        state = static_out; g.replay()
        if err:
            state = static_out.clone()
        return batch, state

    def fine(static_out, batch, err):
        state = static_out; g.replay()
        if err:
            state = static_out.clone()
            log(state)
        with torch.cuda.graph(g):
            static_out = batch
    """, ["DTX010"]),
}

DTX005_COLLECTIVE = ("""
import jax

def gather(x):
    i = jax.lax.axis_index("mdl")
    return jax.lax.all_gather(x, axis_name=("dp", "model")), i
""", """
import torch

def gather(x, mesh):
    i = mesh.index(("mdl",))
    return mesh.group(("dp", "model")), mesh.shape["x"], i
""")


# a phrase of each rule's message both linters share (the message shape)
SHAPE = {"DTX001": " in hot path (", "DTX002": "inside a loop",
         "DTX003": "Python `if` on the ", "DTX004": "PRNG key `key`",
         "DTX005": "is not a declared mesh axis (dp, fsdp, sp, tp)",
         "DTX008": " runs at ", "DTX010": " and is read after"}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_retargeted_rule_twin_fixture_pair(name):
    ref_src, port_src, want = TWINS[name]
    assert len(textwrap.dedent(ref_src).splitlines()) \
        <= len(textwrap.dedent(port_src).splitlines())
    ref = lint_with(REF, ref_src)
    port = lint_with(PORT, port_src)
    if want is not None:
        assert [f.rule for f in ref] == want
    assert [(f.rule, f.line) for f in port] \
        == [(f.rule, f.line) for f in ref]
    for f in ref + port:
        assert SHAPE[f.rule] in f.message, f.render()


def test_dtx005_twin_counts_every_undeclared_axis():
    # the collective pair: the reference flags "mdl" and "model"; the port
    # twin flags the same two on the same lines, plus a table key
    ref = lint_with(REF, DTX005_COLLECTIVE[0])
    port = lint_with(PORT, DTX005_COLLECTIVE[1])
    assert [f.line for f in ref] == [5, 6]
    assert [(f.line, f.message.split("'")[1]) for f in port] \
        == [(5, "mdl"), (6, "model"), (6, "x")]


def test_dtx001_port_sync_set():
    src = """
    import numpy as np
    import torch

    def train_step(x, ev):
        a = x.item()
        b = x.tolist()
        c = x.cpu()
        d = x.detach().numpy()
        e = x.to("cpu")
        f = x.to(device=torch.device("cpu"))
        g = bool(x.any())
        h = np.asarray(x)
        torch.cuda.synchronize()
        ev.synchronize()
        x.to("cuda")  # device-side: no host sync
        return int(3)  # a constant: no host sync
    """
    labels = [f.message.split(" in hot path")[0]
              for f in lint_with(PORT, src)]
    assert labels == [".item()", ".tolist()", ".cpu()", ".numpy()",
                      '.to("cpu")', '.to("cpu")', "bool() on a device value",
                      "np.asarray()", "torch.cuda.synchronize()",
                      ".synchronize()"]


def test_dtx004_same_findings_against_ops_prng_and_jax_random():
    body = """
    def double(key):
        a = {m}.bernoulli(key, 0.5, (2,))
        b = {m}.uniform(key, (2,))
        return a + b

    def rollout(key, n):
        out = []
        for i in range(n):
            out.append({m}.uniform(key, (2,)))
            key, sub = {m}.split(key)
        return out
    """
    body = textwrap.dedent(body)
    ref = lint_with(REF, "import jax\n" + body.format(m="jax.random"))
    port = lint_with(PORT, "from datatunerx_tpu_torch.ops import prng "
                           "as jr\n" + body.format(m="jr"))
    norm = [f.render().replace("jax.random.split", "prng.split")
            for f in ref]
    assert norm == [f.render() for f in port]
    # double use; loop reuse; the split after the loop's draw reuses too
    assert [f.rule for f in port] == ["DTX004"] * 3


# ------------------------------------------------------- hot-region markers
def test_hot_region_markers_flag_sync_inside_region_only(pkg):
    src = """
    import numpy as np

    def load_config(path):
        return np.asarray([1.0])  # called outside the region: cold

    def fetch_metrics(m):
        return np.asarray(m)  # called FROM the region: hot by propagation

    def main(batches):
        cfg = load_config("x")
        # dtxlint: hot-begin
        out = [fetch_metrics(b) for b in batches]
        # dtxlint: hot-end
        return cfg, out
    """
    res = run(src)
    assert [f.rule for f in res.findings] == ["DTX001"]
    assert res.findings[0].line == 8  # the asarray inside fetch_metrics


def test_hot_region_sync_flagged_lexically_and_clean_without_markers(pkg):
    marked = """
    def main(batches):
        # dtxlint: hot-begin
        for b in batches:
            loss = float(step(b))
        # dtxlint: hot-end
        return loss
    """
    assert rule_ids(marked) == ["DTX001"]
    unmarked = "\n".join(ln for ln in textwrap.dedent(marked).splitlines()
                         if "dtxlint" not in ln)
    assert rule_ids(unmarked) == []


# ------------------------------------------------------------ program graph
def _write_pkg(tmp_path, files):
    pkg_dir = tmp_path / "pkg"
    pkg_dir.mkdir(parents=True)
    (pkg_dir / "__init__.py").write_text("")
    for name, src in files.items():
        (pkg_dir / name).write_text(textwrap.dedent(src))
    return pkg_dir


def _prog(pkg_dir):
    res, _ = M.lint_program([str(pkg_dir)], config=M.LintConfig(cache=""))
    return res


PROGRAM = {
    "cross_module_sync": ({
        "helpers.py": """
            import numpy as np

            def to_host(x):
                return np.asarray(x)
        """,
        "train.py": """
            from pkg.helpers import to_host

            def train_step(state, batch):
                return to_host(state)
        """}, ["DTX001"]),
    "helper_not_hot": ({
        "helpers.py": """
            import numpy as np

            def to_host(x):
                return np.asarray(x)
        """,
        "train.py": """
            from pkg.helpers import to_host

            def train_step(state, batch):
                return state

            def summarize(metrics):
                return to_host(metrics)  # cold caller: no finding
        """}, []),
    "blocking_leaf": ({
        "net.py": """
            import requests

            def fetch(url):
                return requests.get(url)
        """,
        "pool.py": """
            import threading

            from pkg.net import fetch

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()

                def refresh(self):
                    with self._lock:
                        return fetch("http://replica/health")
        """}, ["DTX009"]),
    "thread_target_reference": ({
        "pool.py": """
            import threading
            import time

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._stop = threading.Event()

                def _reap(self, name):
                    time.sleep(0.1)

                def _start_reap(self, name):
                    threading.Thread(
                        target=self._reap, args=(name,), daemon=True
                    ).start()

                def reconcile(self):
                    with self._lock:
                        self._start_reap("r0")

                def close(self):
                    self._stop.set()
        """}, []),
    "cross_module_lock_inversion": ({
        "alloc.py": """
            import threading

            from pkg.stats import record

            ALLOC_LOCK = threading.Lock()

            def reserve():
                with ALLOC_LOCK:
                    record()

            def touch():
                with ALLOC_LOCK:
                    return 1
        """,
        "stats.py": """
            import threading

            STATS_LOCK = threading.Lock()

            def record():
                with STATS_LOCK:
                    return 2

            def flush():
                from pkg.alloc import touch

                with STATS_LOCK:
                    touch()
        """}, ["DTX011"]),
    "cross_module_consistent_order": ({
        "alloc.py": """
            import threading

            from pkg.stats import record

            ALLOC_LOCK = threading.Lock()

            def reserve():
                with ALLOC_LOCK:
                    record()

            def touch():
                with ALLOC_LOCK:
                    return 1
        """,
        "stats.py": """
            import threading

            STATS_LOCK = threading.Lock()

            def record():
                with STATS_LOCK:
                    return 2

            def flush():
                with STATS_LOCK:
                    return 3
        """}, []),
    "handle_dropped_by_callee": ({
        "util.py": """
            def log_proc(proc):
                print(proc.pid)

            def reap(proc):
                proc.wait()
        """,
        "runner.py": """
            import subprocess

            from pkg.util import log_proc, reap

            def leaky():
                proc = subprocess.Popen(["serve"])
                log_proc(proc)  # callee only drops it: still ours to reap

            def fine():
                proc = subprocess.Popen(["serve"])
                log_proc(proc)
                reap(proc)  # a callee disposes: ownership handed over
        """}, ["DTX007"]),
}


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_program_graph_fixture_identical_through_both_linters(name,
                                                              tmp_path):
    files, want = PROGRAM[name]
    renders = {}
    for p in PKGS:
        M.use(p)
        renders[p] = [f.render() for f in _prog(
            _write_pkg(tmp_path / p.rsplit("_", 1)[-1], files)).findings]
    assert renders[REF] == [r.replace("/torch/", "/tpu/")
                            for r in renders[PORT]]
    assert [r.split()[1] for r in renders[PORT]] == want
    if name == "cross_module_sync":
        assert "helpers.py" in renders[PORT][0]
        assert "train_step" in renders[PORT][0]
    if name == "blocking_leaf":
        assert "pool.py" in renders[PORT][0]
        assert "requests.get" in renders[PORT][0]
    if name == "cross_module_lock_inversion":
        assert "pkg.alloc.ALLOC_LOCK" in renders[PORT][0]
        assert "pkg.stats.STATS_LOCK" in renders[PORT][0]
    if name == "handle_dropped_by_callee":
        assert "runner.py" in renders[PORT][0]
        assert "`proc`" in renders[PORT][0]


# ---------------------------------------------------------------- autofix
FIX_HOIST = {
    REF: ("""
        import jax
        import jax.numpy as jnp


        def compile_steps(n):
            out = []
            for i in range(n):
                step = jax.jit(lambda x: x + 1)
                out.append(step(i))
            return out


        def pad(x, fill=jnp.zeros((4,))):
            return x + fill
    """, "step = jax.jit", "fill = jnp.zeros((4,))"),
    PORT: ("""
        import torch
        import torch


        def compile_steps(n):
            out = []
            for i in range(n):
                step = torch.compile(lambda x: x + 1)
                out.append(step(i))
            return out


        def pad(x, fill=torch.zeros((4,), device="cuda")):
            return x + fill
    """, "step = torch.compile",
        'fill = torch.zeros((4,), device="cuda")'),
}


def test_fix_hoists_jit_and_defers_default_arg(pkg):
    src, hoisted, deferred = pick(FIX_HOIST)
    src = textwrap.dedent(src)
    fixed, res = M.fix_source(src, "m.py")
    assert res.changed and res.applied == 2 and res.unfixable == 0
    assert M.lint_source(fixed, path="m.py", config=cfg()).findings == []
    assert fixed.index(hoisted) < fixed.index("for i in range(n):")
    assert "fill=None" in fixed and deferred in fixed
    again, res2 = M.fix_source(fixed, "m.py")
    assert again == fixed and not res2.changed and res2.applied == 0


def test_fix_refuses_loop_dependent_jit_and_module_constants(pkg):
    src = textwrap.dedent(pick({
        REF: """
            import jax
            import jax.numpy as jnp

            TABLE = jnp.ones((8,))

            def compile_all(fns):
                out = []
                for f in fns:
                    g = jax.jit(f)
                    out.append(g)
                return out
        """,
        PORT: """
            import torch
            import torch

            TABLE = torch.ones((8,)).cuda()

            def compile_all(fns):
                out = []
                for f in fns:
                    g = torch.compile(f)
                    out.append(g)
                return out
        """}))
    fixed, res = M.fix_source(src, "m.py")
    assert fixed == src and not res.changed
    assert res.applied == 0 and res.unfixable == 2


PRNG_FIX = {
    REF: ("import jax\n", "jax.random", "normal", "uniform"),
    PORT: ("from datatunerx_tpu_torch.ops import prng\n", "prng",
           "gumbel", "uniform"),
}


def test_fix_dtx004_inserts_key_split_for_double_consumption(pkg):
    head, m, first, second = pick(PRNG_FIX)
    src = head + textwrap.dedent(f"""

        def sample(key):
            a = {m}.{first}(key, (4,))
            b = {m}.{second}(key, (4,))
            return a + b
    """)
    fixed, res = M.fix_source(src, "m.py")
    assert res.changed and res.applied == 1 and res.unfixable == 0
    assert M.lint_source(fixed, path="m.py", config=cfg()).findings == []
    assert f"key, key_split1 = {m}.split(key)" in fixed
    assert fixed.index(f"= {m}.split") < fixed.index(f"{m}.{first}")
    assert f"{m}.{first}(key_split1, (4,))" in fixed
    assert f"{m}.{second}(key, (4,))" in fixed
    again, res2 = M.fix_source(fixed, "m.py")
    assert again == fixed and not res2.changed and res2.applied == 0


def test_fix_dtx004_loop_reuse_splits_per_iteration(pkg):
    head, m, first, _ = pick(PRNG_FIX)
    src = head + textwrap.dedent(f"""

        def rollout(key, n):
            out = []
            for i in range(n):
                out.append({m}.{first}(key, (2,)))
            return out
    """)
    fixed, res = M.fix_source(src, "m.py")
    assert res.changed and res.applied == 1
    assert M.lint_source(fixed, path="m.py", config=cfg()).findings == []
    assert fixed.index("for i in range(n):") \
        < fixed.index(f"key, key_split1 = {m}.split(key)")
    assert f"{m}.{first}(key_split1, (2,))" in fixed
    again, res2 = M.fix_source(fixed, "m.py")
    assert again == fixed and not res2.changed


def test_fix_dtx004_respects_aliases_and_refuses_bare_imports(pkg):
    alias, bare = pick({
        REF: ("from jax import random as jr\n",
              "from jax.random import normal, uniform\n"),
        PORT: ("from datatunerx_tpu_torch.ops import prng as jr\n",
               "from datatunerx_tpu_torch.ops.prng import gumbel as normal,"
               " uniform\n")})
    _, _, first, _ = pick(PRNG_FIX)
    src = alias + textwrap.dedent(f"""

        def sample(key):
            a = jr.{first}(key, (4,))
            b = jr.uniform(key, (4,))
            return a + b
    """)
    fixed, res = M.fix_source(src, "m.py")
    assert res.applied == 1
    assert "key, key_split1 = jr.split(key)" in fixed
    assert M.lint_source(fixed, path="m.py", config=cfg()).findings == []
    src2 = bare + textwrap.dedent("""

        def sample(key):
            a = normal(key, (4,))
            b = uniform(key, (4,))
            return a + b
    """)
    fixed2, res2 = M.fix_source(src2, "m.py")
    assert fixed2 == src2 and not res2.changed and res2.unfixable == 1


def test_fix_dtx004_clean_split_idiom_untouched(pkg):
    head, m, first, second = pick(PRNG_FIX)
    src = head + textwrap.dedent(f"""

        def sample(key):
            key, sub = {m}.split(key)
            a = {m}.{first}(sub, (4,))
            b = {m}.{second}(key, (4,))
            return a + b
    """)
    fixed, res = M.fix_source(src, "m.py")
    assert fixed == src and not res.changed and res.applied == 0


def test_apply_edits_adjacent_ok_overlap_refused(pkg):
    assert M.apply_edits("abcdef", [M.SpanEdit(0, 2, "X"),
                                    M.SpanEdit(2, 4, "Y")]) == "XYef"
    with pytest.raises(M.OverlapError):
        M.apply_edits("abcdef", [M.SpanEdit(0, 3, "X"),
                                 M.SpanEdit(2, 4, "Y")])
    with pytest.raises(M.OverlapError):
        M.apply_edits("ab", [M.SpanEdit(1, 5, "X")])


DEFAULT_ARG = {
    REF: ("import jax.numpy as jnp\n"
          "def f(x, fill=jnp.zeros((4,))):\n"
          "    return x + fill\n"),
    PORT: ("import torch\n"
           'def f(x, fill=torch.zeros((4,), device="cuda")):\n'
           "    return x + fill\n"),
}


def test_cli_fix_check_then_fix_then_check_clean(pkg, tmp_path, capsys):
    p = tmp_path / "m.py"
    src = pick(DEFAULT_ARG)
    p.write_text(src)
    common = ["--no-config", "--no-baseline", "--no-cache"]
    assert M.main([str(p), "--fix", "--check"] + common) == 1
    assert p.read_text() == src
    assert M.main([str(p), "--fix"] + common) == 0
    assert "fill=None" in p.read_text()
    assert M.main([str(p), "--fix", "--check"] + common) == 0
    capsys.readouterr()


def test_fix_dtx008_docstring_only_body_keeps_docstring(pkg):
    src = pick(DEFAULT_ARG).replace(
        "    return x + fill\n",
        '    """Docstring must stay first."""\n')
    fixed, res = M.fix_source(src, "m.py", config=M.LintConfig())
    assert res.applied == 1
    fn = ast.parse(fixed).body[-1]
    assert ast.get_docstring(fn) == "Docstring must stay first."
    assert "if fill is None:" in fixed


# -------------------------------------------------------------- CLI paths
def _git(*args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *args], check=True, capture_output=True)


def test_cli_changed_lints_only_files_differing_from_head(pkg, tmp_path,
                                                          capsys,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    _git("init", "-q")
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    (tmp_path / "stale.py").write_text(pick(DEVICE_WORK))
    _git("add", "-A")
    _git("commit", "-qm", "base")
    common = ["--changed", "--no-config", "--no-baseline", "--no-cache"]
    assert M.main([str(tmp_path)] + common) == 0
    assert "no changed python files" in capsys.readouterr().out
    clean.write_text(pick(DEVICE_WORK))
    assert M.main([str(tmp_path)] + common) == 1
    out = capsys.readouterr().out
    assert "clean.py" in out and "stale.py" not in out
    sub = tmp_path / "sub"
    sub.mkdir()
    monkeypatch.chdir(sub)
    assert M.main([str(tmp_path)] + common) == 1
    assert "clean.py" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    _git("add", "-A")
    _git("commit", "-qm", "wip")
    (tmp_path / "fresh.py").write_text(pick(DEVICE_WORK))
    assert M.main([str(tmp_path)] + common) == 1
    assert "fresh.py" in capsys.readouterr().out


def test_cli_format_json_holds_on_early_exit_paths(pkg, tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    _git("init", "-q")
    p = tmp_path / "m.py"
    p.write_text("def f():\n    return 1\n")
    _git("add", "-A")
    _git("commit", "-qm", "base")
    common = ["--no-config", "--no-baseline", "--no-cache", "--format",
              "json"]
    assert M.main([str(tmp_path), "--changed"] + common) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 2 and doc["findings"] == [] and not doc["failed"]
    p.write_text(pick({
        REF: "import jax\n\nfor i in range(2):\n    g = jax.jit(f)\n"
             "    g(i)\n",
        PORT: "import torch\n\nfor i in range(2):\n"
              "    g = torch.compile(f)\n    g(i)\n"}))
    assert M.main([str(p), "--fix", "--check"] + common) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["failed"] and doc["fix"]["fixed"] == 1 \
        and doc["would_change"] == ["m.py"]


def test_cli_json_output_and_exit_codes(pkg, tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(pick(DEVICE_WORK))
    rc = M.main([str(bad), "--format", "json", "--no-config",
                 "--no-baseline", "--no-cache"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["failed"]
    assert doc["version"] == 2
    assert doc["cache"] == {"analyzed": 1, "reused": 0}
    assert doc["findings"][0]["rule"] == "DTX008"
    assert doc["findings"][0]["line"] == 2
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert M.main([str(good), "--no-config", "--no-baseline",
                   "--no-cache"]) == 0


def test_cli_write_baseline_then_clean(pkg, tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(pick(DEVICE_WORK))
    base = tmp_path / "base.json"
    assert M.main([str(bad), "--no-config", "--no-cache", "--baseline",
                   str(base), "--write-baseline"]) == 0
    assert M.main([str(bad), "--no-config", "--no-cache", "--baseline",
                   str(base)]) == 0
    capsys.readouterr()


def test_select_runs_only_named_rules(pkg, tmp_path):
    head, m, first, second = pick(PRNG_FIX)
    src = (pick(DEVICE_WORK) + head
           + f"def f(key):\n    a = {m}.{first}(key, (2,))\n"
           f"    return a + {m}.{second}(key, (2,))\n")
    p = tmp_path / "m.py"
    p.write_text(src)
    res = M.lint_paths([str(p)], config=M.LintConfig())
    assert {f.rule for f in res.findings} == {"DTX004", "DTX008"}
    res = M.lint_paths([str(p)], config=M.LintConfig(),
                       rules=M.rules_by_id(["DTX004"]))
    assert {f.rule for f in res.findings} == {"DTX004"}


def test_config_disable_and_toml_subset(pkg, tmp_path):
    keys = textwrap.dedent("""
        baseline = "b.json"
        disable = ["DTX008"]
        hot-functions = [
            "train_step",
            "hot_*",
        ]
        mesh-axes = ["dp", "tp"]
    """)
    if M.pkg == REF:
        (tmp_path / "pyproject.toml").write_text(
            '[project]\nname = "x"\n\n[tool.dtxlint]' + keys)
    else:
        (tmp_path / "dtxlint-torch.toml").write_text(
            keys + '\n[other]\nbaseline = "wrong.json"\n')
    conf = M.load_config(str(tmp_path))
    assert conf.baseline == "b.json"
    assert conf.disable == ("DTX008",)
    assert conf.hot_functions == ("train_step", "hot_*")
    assert conf.mesh_axes == ("dp", "tp")
    assert M.lint_source(pick(DEVICE_WORK), config=conf).findings == []


def test_port_config_is_its_own_file_not_the_pyproject_table(tmp_path):
    """Pinned divergence: the port never reads ``[tool.dtxlint]`` (the
    reference's table, with the JAX package's baseline and mesh module)."""
    (tmp_path / "pyproject.toml").write_text(
        '[tool.dtxlint]\nbaseline = "ref.json"\ndisable = ["DTX008"]\n')
    sub = tmp_path / "pkg"
    sub.mkdir()
    M.use(PORT)
    assert M.load_config(str(sub)) == M.LintConfig()
    M.use(REF)
    assert M.load_config(str(sub)).baseline == "ref.json"
    M.use(PORT)
    (tmp_path / "dtxlint-torch.toml").write_text('baseline = "port.json"\n')
    conf = M.load_config(str(sub))
    assert conf.baseline == "port.json" and conf.disable == ()
    assert conf.root == str(tmp_path)
    repo = M.load_config(ROOT)
    assert repo.baseline == "dtxlint-torch-baseline.json"
    assert repo.cache.startswith("build/")
    assert repo.mesh_module == "datatunerx_tpu_torch/parallel/mesh.py"
    assert "datatunerx_tpu_torch/serving/migration.py:DTX001" \
        in repo.per_file_disable


def test_per_file_disable_is_config_level_not_suppression(pkg):
    conf = M.LintConfig(per_file_disable=("*/generated/*.py:DTX008",
                                          "legacy_*.py:all"))
    src = pick(DEVICE_WORK)
    res = M.lint_source(src, path="pkg/generated/tables.py", config=conf)
    assert res.findings == [] and res.suppressed == 0
    assert M.lint_source(src, path="legacy_x.py", config=conf).findings == []
    kept = M.lint_source(src, path="pkg/other.py", config=conf)
    assert [f.rule for f in kept.findings] == ["DTX008"]


def test_inline_suppression_comment_silences_one_rule(pkg):
    imp, work = pick(DEVICE_WORK).splitlines()
    rhs = work.split(" = ", 1)[1]
    src = (f"{imp}\n"
           f"A = {rhs}  # dtxlint: disable=DTX008 -- frozen table\n"
           f"B = {rhs}  # dtxlint: disable=DTX001\n"
           f"C = {rhs}  # dtxlint: disable=all\n")
    res = run(src)
    assert [(f.rule, f.line) for f in res.findings] == [("DTX008", 3)]
    assert res.suppressed == 2


def test_baseline_roundtrip_and_partition(pkg, tmp_path):
    res = run(pick(DEVICE_WORK))
    assert len(res.findings) == 1
    path = tmp_path / "baseline.json"
    M.save_baseline(str(path), res.findings)
    carried = M.load_baseline(str(path))
    new, baselined = M.partition(res.findings, carried)
    assert new == [] and len(baselined) == 1
    new, baselined = M.partition(res.findings * 2, carried)
    assert len(new) == 1 and len(baselined) == 1
    assert M.load_baseline(str(tmp_path / "missing.json")) == {}


def test_syntax_error_reports_dtx000_not_crash(pkg):
    res = M.lint_source("def broken(:\n", path="x.py")
    assert [f.rule for f in res.findings] == ["DTX000"]
    other = REF if M.pkg == PORT else PORT
    assert [f.render() for f in lint_with(other, "def broken(:\n")] \
        == [f.render().replace("x.py", "fixture.py") for f in res.findings]


def test_mesh_axes_extracted_from_mesh_module(pkg):
    conf = M.load_config(ROOT)
    assert conf.mesh_module.startswith(M.pkg + "/")
    assert set(M.mesh_axes_for(conf)) == {"dp", "fsdp", "tp", "sp"}


# ------------------------------------------------- the port lints clean
@pytest.fixture(scope="module")
def port_lint(tmp_path_factory):
    """One cold program lint of the port's package per module (cache in a
    temporary file)."""
    M.use(PORT)
    conf = dataclasses.replace(
        M.load_config(ROOT),
        cache=str(tmp_path_factory.mktemp("lint") / "cache.json"))
    res, stats = M.lint_program([os.path.join(ROOT, PORT)], config=conf)
    return res, (conf, stats)


def test_port_lints_clean_against_its_baseline(port_lint):
    """One cold lint of the port, then everything that reads it: nothing
    outside the baseline, a DTX001-only baseline with every entry in the
    ROADMAP, DTX002/003/010 quiet (they guard the CUDA-graph and compile
    work the ROADMAP queues), and a warm cached run giving the same."""
    res, (conf, stats) = port_lint
    assert stats.analyzed == stats.files > 0
    M.use(PORT)
    baseline = M.load_baseline(conf.resolve(conf.baseline))
    new, carried = M.partition(res.findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    # policy: the baseline carries DTX001 host syncs only, every one of
    # them still found (nothing stale) and listed by file:line
    assert {key[0] for key in baseline} == {"DTX001"}
    assert len(carried) == sum(baseline.values())
    with open(os.path.join(ROOT, "ROADMAP.md"), encoding="utf-8") as f:
        roadmap = f.read()
    for f in carried:
        assert f"{f.path}:{f.line}" in roadmap, f.render()
    assert not [f for f in res.findings
                if f.rule in ("DTX002", "DTX003", "DTX010")]
    for rule in ("retrace", "tracer", "donation"):
        doc = M.mod(f"analysis.rules.{rule}").__doc__
        assert "finds nothing in it" in " ".join(doc.split())
    warm, warm_stats = M.lint_program([os.path.join(ROOT, PORT)],
                                      config=conf)
    assert warm_stats.reused == warm_stats.files == stats.files
    assert warm_stats.analyzed == 0
    assert [f.render() for f in warm.findings] \
        == [f.render() for f in res.findings]
