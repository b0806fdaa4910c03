"""The port as an installed package: the project's wheel, built from a copy
of the tree and installed with ``pip install --target``, carries the port's
CUDA sources, its C++ packer and its UI, imports from outside the checkout
and builds under ``XDG_CACHE_HOME``, never under the install; a checkout
still builds under ``build/``. Also the control plane's ``/ui`` and
``/trainermetrics`` on the port's manager (the twin of
``tests/test_apiserver_cli.py::test_ui_served_and_trainermetrics``).

The wheel is built once per module (``pip wheel --no-build-isolation
--no-index``: setuptools from this environment, nothing fetched)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest

from datatunerx_tpu_torch import native
from datatunerx_tpu_torch.ops import _build
from datatunerx_tpu_torch.utils import build_dirs

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "datatunerx_tpu_torch"
# the files the port builds or serves from, relative to its package
DATA = sorted([p.relative_to(PORT).as_posix() for p in
               list((PORT / "csrc").glob("*.cu"))
               + list((PORT / "csrc").glob("*.cuh"))]
              + ["native/packer.cpp", "operator/ui.html"])

_BLOCKER = textwrap.dedent("""
    import sys

    class Block:
        BLOCKED = ("jax", "jaxlib", "datatunerx_tpu")

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
""")


def _pip(*args):
    subprocess.run([sys.executable, "-m", "pip", *args], check=True,
                   capture_output=True, timeout=600)


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(wheel path, install target): the wheel of a copy of the tree
    (``pyproject.toml`` and both packages), installed with ``--target``."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    shutil.copy2(ROOT / "pyproject.toml", src)
    for name in ("datatunerx_tpu", "datatunerx_tpu_torch"):
        shutil.copytree(ROOT / name, src / name,
                        ignore=shutil.ignore_patterns("__pycache__"))
    _pip("wheel", "--no-deps", "--no-build-isolation", "--no-index", "-q",
         "-w", str(tmp / "wheels"), str(src))
    (whl,) = (tmp / "wheels").glob("*.whl")
    site = tmp / "site"
    _pip("install", "--no-deps", "--no-index", "-q", "--target", str(site),
         str(whl))
    return whl, site


def _child(site, cache, code, tmp_path):
    """Run ``code`` under the import blocker from a directory of its own,
    with only ``site`` on the path and ``cache`` as XDG_CACHE_HOME; returns
    the JSON object it prints last."""
    cwd = tmp_path / "cwd"
    cwd.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONHOME")}
    env.update(PYTHONPATH=str(site),
               XDG_CACHE_HOME=str(cache), PYTHONNOUSERSITE="1")
    proc = subprocess.run(
        [sys.executable, "-s", "-c", _BLOCKER + textwrap.dedent(code)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_wheel_ships_the_ports_sources_packer_and_ui(installed):
    whl, _ = installed
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
        for rel in DATA:
            name = f"datatunerx_tpu_torch/{rel}"
            assert name in names, name
            assert z.read(name) == (PORT / rel).read_bytes(), name
    assert len(DATA) == 13  # 9 .cu, 2 .cuh, the packer, the UI


def test_wheel_leaves_the_references_ui_out(installed):
    """The JAX package declares no package data: its wheel lacks
    ``operator/ui.html``, as before (ROADMAP, "Shared with the
    reference"); only the port's package data was added."""
    whl, _ = installed
    with zipfile.ZipFile(whl) as z:
        names = z.namelist()
    assert "datatunerx_tpu/operator/ui.html" not in names
    assert not [n for n in names if n.startswith("datatunerx_tpu/")
                and not n.endswith(".py")]


def test_installed_port_resolves_outside_the_checkout(installed, tmp_path):
    _, site = installed
    cache = tmp_path / "xdg"
    got = _child(site, cache, """
        import json, sys
        import datatunerx_tpu_torch as pkg
        from datatunerx_tpu_torch import native
        from datatunerx_tpu_torch.ops import _build
        from datatunerx_tpu_torch.operator import apiserver
        print(json.dumps({
            "pkg": pkg.__file__, "csrc": str(_build.CSRC),
            "sources": [p.name for p in _build._sources()],
            "digest": _build._digest(_build._sources()),
            "kernels": str(_build.BUILD_DIR),
            "native": str(native.BUILD_DIR),
            "apiserver": apiserver.__file__,
            "blocked": sorted({m.split(".")[0] for m in sys.modules}
                              & {"jax", "jaxlib", "datatunerx_tpu"})}))
    """, tmp_path)
    site, cache = str(site), str(cache)
    for key in ("pkg", "csrc", "apiserver"):
        assert got[key].startswith(site + os.sep), (key, got[key])
    assert got["sources"] == [p.name for p in _build._sources()]
    assert got["digest"] == _build._digest(_build._sources())
    assert got["kernels"] == os.path.join(
        cache, "datatunerx_tpu_torch", "torch_kernels")
    assert got["native"] == os.path.join(
        cache, "datatunerx_tpu_torch", "torch_native")
    assert not got["kernels"].startswith(site)
    assert not got["native"].startswith(site)
    assert got["blocked"] == []


def test_installed_native_packer_builds_in_the_cache(installed, tmp_path):
    """g++ builds the installed ``packer.cpp`` under XDG_CACHE_HOME, and
    ``pack_to_block``/``pad_to_block`` through it give the checkout's
    arrays (the checkout's own native packer, and its Python loops)."""
    from datatunerx_tpu_torch.data import preprocess
    from tests.test_native import _examples

    _, site = installed
    cache = tmp_path / "xdg"
    exs = _examples(np.random.default_rng(3), n=120, max_len=60)
    exs = [{k: [int(t) for t in v] for k, v in e.items()} for e in exs]
    (tmp_path / "exs.json").write_text(json.dumps(exs))
    got = _child(site, cache, f"""
        import json
        import numpy as np
        from datatunerx_tpu_torch import native
        from datatunerx_tpu_torch.data import preprocess
        exs = json.load(open({str(tmp_path / "exs.json")!r}))
        so = native._library_path()
        fresh = not so.exists()
        ok = native.available()
        out = {{op: {{k: v.tolist() for k, v in getattr(preprocess, op)(
                    exs, 64, pad_id=0, use_native=True).items()}}
               for op in ("pack_to_block", "pad_to_block")}}
        print(json.dumps({{"lib": str(so), "fresh": fresh, "ok": ok,
                          "built_s": native.build_seconds, "out": out}}))
    """, tmp_path)
    assert got["ok"] and got["fresh"] and got["built_s"] > 0
    assert got["lib"].startswith(os.path.join(
        str(cache), "datatunerx_tpu_torch", "torch_native") + os.sep)
    assert not got["lib"].startswith(str(site))
    assert native.available()
    for op, arrays in got["out"].items():
        for use_native in (True, False):
            want = getattr(preprocess, op)(exs, 64, pad_id=0,
                                           use_native=use_native)
            assert sorted(arrays) == sorted(want), op
            for k in want:
                np.testing.assert_array_equal(np.asarray(arrays[k],
                                                         np.int32),
                                              want[k], err_msg=f"{op}:{k}")


def test_compile_only_entry_builds_into_the_cache(installed, tmp_path):
    """``python -m datatunerx_tpu_torch.ops._build`` compiles every source
    into the cache and loads nothing (a stand-in ``nvcc`` writes each
    output: this box has no CUDA toolkit); a second run finds the build."""
    _, site = installed
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {log}
        out=""
        while [ $# -gt 0 ]; do
          if [ "$1" = "-o" ]; then out="$2"; shift; fi
          shift
        done
        : > "$out"
    """))
    nvcc.chmod(0o755)
    cache = tmp_path / "xdg"
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONHOME", "CUDA_HOME")}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache),
               PATH=f"{bin_dir}{os.pathsep}{env.get('PATH', '')}")
    want = (cache / "datatunerx_tpu_torch" / "torch_kernels"
            / f"libdtx_kernels-{_build._digest(_build._sources())}.so")
    for run in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "datatunerx_tpu_torch.ops._build"],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.startswith(str(want)), proc.stdout
        assert want.exists()
        lines = log.read_text().splitlines()
        # one compile per source and one link, all on the first run
        assert len(lines) == len(_build._sources()) + 1, (run, lines)
    compiled = sorted(Path(a.split(" -c ")[1].split()[0]).name
                      for a in lines if " -c " in a)
    assert compiled == [p.name for p in _build._sources()]
    assert all(a.split(" -c ")[1].startswith(str(site)) for a in lines
               if " -c " in a)
    assert list(want.parent.iterdir()) == [want]


def test_a_kernel_without_its_sources_still_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no CUDA sources under"):
        _build.library()
    with pytest.raises(RuntimeError, match="no CUDA sources under"):
        _build.compile_library()
    assert not (tmp_path / "kernels").exists()


def test_a_missing_packer_source_leaves_the_python_loops(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(native, "_SRC", tmp_path / "packer.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native._library_path() is None
    assert native.available() is False
    exs = [{"input_ids": [1, 2, 3], "labels": [1, 2, 3]}]
    assert native.pack_batch_native(exs, 8, 0, -100) is None
    assert not (tmp_path / "native").exists()


def test_a_checkout_builds_under_build():
    assert build_dirs.checkout_root() == ROOT
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    assert native.BUILD_DIR == ROOT / "build" / "torch_native"
    assert _build.CSRC == PORT / "csrc"


@pytest.mark.parametrize("pyproject, xdg, want", [
    (None, "x", "x/datatunerx_tpu_torch/torch_native"),
    ('[project]\nname = "other"\n', "x", "x/datatunerx_tpu_torch/torch_native"),
    ('[project]\nname = "datatunerx-tpu"\n', "x", "build/torch_native"),
    (None, "", "home/.cache/datatunerx_tpu_torch/torch_native"),
])
def test_build_dir_rule(monkeypatch, tmp_path, pyproject, xdg, want):
    """A package beside this project's ``pyproject.toml`` builds under the
    root's ``build/``; any other under ``$XDG_CACHE_HOME`` (``~/.cache``
    when it is unset or empty)."""
    pkg = tmp_path / "root" / "datatunerx_tpu_torch"
    pkg.mkdir(parents=True)
    if pyproject is not None:
        (pkg.parent / "pyproject.toml").write_text(pyproject)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / xdg) if xdg else "")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    base = pkg.parent if want.startswith("build/") else tmp_path
    assert build_dirs.build_dir("torch_native", pkg) == base / want


# ------------------------------------------- the control plane's UI twin
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def test_ui_served_and_trainermetrics_on_the_ports_manager(tmp_path):
    """The port's ``/ui`` answers 200 with its ``ui.html`` (the reference's
    file, byte for byte), and ``/trainermetrics/{ns}/{name}`` reads the
    trainer's jsonl series through the port's ``LocalProcessBackend``."""
    from datatunerx_tpu_torch.operator.api import Finetune, ObjectMeta
    from datatunerx_tpu_torch.operator.apiserver import serve_api
    from datatunerx_tpu_torch.operator.backends import (
        FakeServingBackend, LocalProcessBackend)
    from datatunerx_tpu_torch.operator.manager import build_manager
    from datatunerx_tpu_torch.operator.store import ObjectStore

    ui = (PORT / "operator" / "ui.html").read_bytes()
    assert ui == (ROOT / "datatunerx_tpu" / "operator" / "ui.html"
                  ).read_bytes()
    store = ObjectStore()
    backend = LocalProcessBackend(str(tmp_path / "work"), device="cpu")
    mgr = build_manager(store, backend, FakeServingBackend(),
                        storage_path=str(tmp_path / "s"), with_scoring=False)
    store.create(Finetune(metadata=ObjectMeta(name="run-ui"),
                          spec={"llm": "x", "dataset": "y"}))
    watch = tmp_path / "work" / "run-ui" / "result" / "watch"
    watch.mkdir(parents=True)
    with open(watch / "trainer_log.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"current_steps": i + 1, "total_steps": 3,
                                "loss": 2.0 - i * 0.5, "lr": 1e-4}) + "\n")
    srv, port = serve_api(store, manager=mgr, port=0)
    try:
        for path in ("/", "/ui", "/ui/"):
            code, ctype, body = _get(f"http://127.0.0.1:{port}{path}")
            assert code == 200 and body == ui, path
            assert ctype.startswith("text/html")
        code, _, body = _get(
            f"http://127.0.0.1:{port}/trainermetrics/default/run-ui")
        assert code == 200
        assert [row["loss"] for row in json.loads(body)["train"]] == [
            2.0, 1.5, 1.0]
        code, _, _ = _get(
            f"http://127.0.0.1:{port}/trainermetrics/default/nope")
        assert code == 404
    finally:
        srv.shutdown()
        srv.server_close()

