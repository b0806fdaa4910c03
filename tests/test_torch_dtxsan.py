"""dtxsan for the port (datatunerx_tpu_torch/analysis/sanitizers) against
the reference's: the scenarios of ``tests/test_dtxsan.py`` through one
body on both packages (a lock-order cycle reported with both stacks, a
leaked thread named by its spawn site, the pytest plugin failing a leaking
test, the report and baseline contract), the port's SAN003 over what it
builds (the kernel library, the native packer), and the pinned divergence
of ``dtx-torch san``: its pytest child loads the port's plugin and gets the
classes under ``DTX_TORCH_SAN``, never ``DTX_SAN`` (which makes the tests'
conftest load the reference's plugin)."""

import contextlib
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from tests.torch_twin import PKGS, Twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = PKGS

S = Twin(
    LOCK_SANITIZER="analysis.sanitizers.lockorder:LOCK_SANITIZER",
    LockOrderViolation="analysis.sanitizers.lockorder:LockOrderViolation",
    THREAD_SANITIZER="analysis.sanitizers.threads:THREAD_SANITIZER",
    allow_thread="analysis.sanitizers.threads:allow_thread",
    Collector="analysis.sanitizers.runtime:Collector",
    parse_classes="analysis.sanitizers.runtime:parse_classes",
    evaluate="analysis.sanitizers.report:evaluate",
    write_raw="analysis.sanitizers.report:write_raw",
    load_raw="analysis.sanitizers.report:load_raw",
    build_doc="analysis.sanitizers.report:build_doc",
    save_baseline="analysis.baseline:save_baseline",
    san_main="analysis.sanitizers.cli:main",
)


@pytest.fixture(params=PKGS)
def pkg(request):
    return S.use(request.param)


@contextlib.contextmanager
def _lock_san():
    san = S.LOCK_SANITIZER
    was = san.enabled
    san.install()
    san.reset()
    try:
        yield san
    finally:
        san.reset()
        if not was:
            san.uninstall()


@contextlib.contextmanager
def _thread_san():
    san = S.THREAD_SANITIZER
    was = san.installed
    san.install()
    try:
        yield san
    finally:
        if not was:
            san.uninstall()


def test_lockorder_abba_cycle_reports_both_stacks(pkg):
    with _lock_san() as san:
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def order_ab():
            with lock_a:
                with lock_b:
                    pass

        def order_ba():
            with lock_b:
                with lock_a:
                    pass

        for fn in (order_ab, order_ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        assert san.edge_count() == 2
        col = S.Collector()
        found = san.scan_into(col)
        assert len(found) == 1
        f = found[0]
        assert f.rule == "SAN001" and "lock-order cycle" in f.message
        assert "opposite order was observed" in f.message
        assert f.path.endswith("test_torch_dtxsan.py")
        detail = col.findings[0].detail
        assert detail.count("edge ") == 2
        assert detail.count("acquisition stack:") == 2
        assert "order_ab" in detail and "order_ba" in detail
        san.scan_into(col)
        assert len(col.findings) == 1


def test_lockorder_consistent_order_and_self_deadlock(pkg, monkeypatch):
    with _lock_san() as san:
        lock_a, lock_b = threading.Lock(), threading.Lock()
        for _ in range(2):
            with lock_a:
                with lock_b:
                    pass
        assert san.scan_into(S.Collector()) == []
    col = S.Collector()
    monkeypatch.setattr(S.mod("analysis.sanitizers.runtime"), "COLLECTOR",
                        col)
    with _lock_san():
        lock = threading.Lock()
        lock.acquire()
        try:
            with pytest.raises(S.LockOrderViolation, match="self-deadlock"):
                lock.acquire()
        finally:
            lock.release()
    assert len(col.findings) == 1
    assert "non-reentrant Lock" in col.findings[0].finding.message


def test_thread_leak_detected_with_spawn_site(pkg):
    with _thread_san() as san:
        before = set(threading.enumerate())
        stop = threading.Event()
        t = threading.Thread(target=stop.wait, name="leaky-probe-1",
                             daemon=True)
        t.start()
        try:
            col = S.Collector()
            found = san.audit(before, col, testid="test_thread_leak",
                              grace=0.05)
            assert len(found) == 1
            f = found[0]
            assert f.rule == "SAN002" and "'leaky-probe'" in f.message
            assert f.path.endswith("test_torch_dtxsan.py")
            detail = col.findings[0].detail
            assert "first leaked past: test_thread_leak" in detail
            assert "spawn stack:" in detail
        finally:
            stop.set()
            t.join(timeout=5)
        # joined before the audit, or let through: clean
        before = set(threading.enumerate())
        done = threading.Thread(target=lambda: None)
        done.start()
        done.join()
        stop2 = threading.Event()
        kept = S.allow_thread(threading.Thread(target=stop2.wait,
                                               daemon=True))
        kept.start()
        try:
            assert san.audit(before, S.Collector(), grace=0.05) == []
        finally:
            stop2.set()
            kept.join(timeout=5)


def test_plugin_fails_leaking_test(pkg, tmp_path):
    """End to end: a test that leaks a thread FAILS under the package's
    plugin, naming the spawn site. The port's plugin reads DTX_TORCH_SAN
    (DTX_SAN stays unset in its child: conftest keys on it)."""
    (tmp_path / "test_leak.py").write_text(textwrap.dedent("""
        import threading

        def test_leaves_a_worker():
            stop = threading.Event()
            threading.Thread(target=stop.wait, name="orphan",
                             daemon=True).start()
            assert True
    """))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DTX_SAN", "DTX_TORCH_SAN")}
    env.update({"DTX_SAN_FOREIGN": "1", "DTX_SAN_THREAD_GRACE": "0.1",
                "PYTHONPATH": ROOT,
                ("DTX_SAN" if pkg == REF else "DTX_TORCH_SAN"): "thread"})
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "test_leak.py", "-q",
         "-p", f"{pkg}.analysis.sanitizers.plugin",
         "-p", "no:cacheprovider"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0, proc.stdout
    assert "dtxsan thread-leak" in proc.stdout
    assert "'orphan'" in proc.stdout


def test_report_baseline_and_cli_contract(pkg, tmp_path, capsys):
    col = S.Collector()
    col.add("SAN001", (str(tmp_path / "a.py"), 3), "cycle x", detail="s1")
    col.add("SAN002", (str(tmp_path / "b.py"), 9), "leak y", detail="s2")
    findings, suppressed = col.snapshot()
    raw = tmp_path / "raw.json"
    S.write_raw(str(raw), findings, suppressed, counters={"builds": 1},
                classes=("lock", "thread"))
    loaded, sup, counters, classes = S.load_raw(str(raw))
    assert [sf.finding.key() for sf in loaded] \
        == [sf.finding.key() for sf in findings]
    assert loaded[0].detail == "s1" and classes == ["lock", "thread"]
    ev = S.evaluate(loaded, sup, no_baseline=True)
    assert ev["failed"] and len(ev["new"]) == 2
    bl = tmp_path / "baseline.json"
    S.save_baseline(str(bl), [sf.finding for sf in loaded])
    ev2 = S.evaluate(loaded, sup, baseline_path=str(bl))
    assert not ev2["failed"] and ev2["baselined"] == 2
    doc = S.build_doc(ev, counters=counters, classes=classes, pytest_exit=0)
    assert set(doc) == {"version", "findings", "baselined", "suppressed",
                        "failed", "classes", "counters", "pytest_exit"}
    assert S.san_main(["--from-report", str(raw), "--no-baseline",
                       "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["failed"]
    assert S.san_main(["--module-budget", "nonsense"]) == 2
    pc = S.parse_classes
    assert pc("1") == ("lock", "thread", "compile")
    assert pc("thread, bogus") == ("thread",) and pc("off") == ()


def test_port_policy_files_and_empty_baseline():
    from datatunerx_tpu_torch.analysis.sanitizers import report

    assert report.default_baseline_path() \
        == os.path.join(ROOT, "dtxsan-torch-baseline.json")
    assert report.default_report_path() \
        == os.path.join(ROOT, ".dtxsan-torch-report.json")
    with open(report.default_baseline_path(), encoding="utf-8") as f:
        assert json.load(f)["findings"] == []


def test_dtx_torch_san_child_loads_the_ports_plugin(monkeypatch, tmp_path,
                                                    capsys):
    """Pinned divergence: the child gets ``-p <port plugin>`` and
    ``DTX_TORCH_SAN``, and no ``DTX_SAN`` (which would make conftest load
    the reference's plugin and wrap ``threading.Lock`` twice)."""
    from datatunerx_tpu_torch.analysis.sanitizers import cli

    seen = {}

    def fake_call(cmd, env):
        seen["cmd"], seen["env"] = cmd, env
        S.use(PORT)
        S.write_raw(env["DTX_SAN_REPORT"], [], 0, counters={},
                    classes=("lock", "thread"))
        return 0

    monkeypatch.setenv("DTX_SAN", "1")
    monkeypatch.setattr(cli.subprocess, "call", fake_call)
    report = tmp_path / "r.json"
    assert cli.main(["--san", "lock,thread", "--report", str(report),
                     "--", "tests/test_torch_loadgen.py", "-q"]) == 0
    assert seen["cmd"][1:5] == ["-m", "pytest", "-p",
                               "datatunerx_tpu_torch.analysis.sanitizers."
                               "plugin"]
    assert seen["cmd"][5:] == ["tests/test_torch_loadgen.py", "-q"]
    assert "DTX_SAN" not in seen["env"]
    assert seen["env"]["DTX_TORCH_SAN"] == "lock,thread"
    assert "0 findings" in capsys.readouterr().out
    # the default run is the port's own tests
    cli.main(["--report", str(report)])
    assert seen["cmd"][-1] == "-q"
    assert all(os.path.basename(a).startswith("test_torch_")
               for a in seen["cmd"][5:-1])
    capsys.readouterr()


# ------------------------------------------------ SAN003 over the port's builds
@pytest.fixture
def compile_san():
    from datatunerx_tpu_torch.analysis.sanitizers.compile import (
        COMPILE_SANITIZER,
    )

    was = COMPILE_SANITIZER.installed
    yield COMPILE_SANITIZER
    if not was:
        COMPILE_SANITIZER.uninstall()


def test_compile_budget_counts_the_native_build(compile_san, tmp_path,
                                                monkeypatch):
    from datatunerx_tpu_torch import native
    from datatunerx_tpu_torch.analysis.sanitizers.compile import (
        CompileBudgetExceeded,
        compile_budget,
    )

    native.get_lib()  # built (or loaded) outside any window
    with compile_budget(0, label="warm"):
        assert native.available()  # loaded: zero builds
    # a fresh build directory forces one g++ build
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    S.use(PORT)
    col = S.Collector()
    before = compile_san.counts()
    with pytest.raises(CompileBudgetExceeded, match="compile budget"):
        with compile_budget(0, label="fresh-native", collector=col):
            assert native.available()
    after = compile_san.counts()
    assert after["native_builds"] == before["native_builds"] + 1
    assert after["builds"] == before["builds"] + 1
    f0 = col.findings[0].finding
    assert f0.rule == "SAN003" and "fresh-native" in f0.message
    # the site is the code that asked for the library, not the build helper
    assert "test_torch_dtxsan.py" in f0.message
    assert "native/__init__.py" not in f0.message


def test_compile_budget_counts_the_kernel_library_build(compile_san,
                                                        tmp_path,
                                                        monkeypatch):
    """On a machine without nvcc the kernel library's build is attempted
    and fails; the attempt still counts (the window records it; raising is
    off), and uninstall restores the build function."""
    from datatunerx_tpu_torch.analysis.sanitizers.compile import (
        compile_budget,
    )
    from datatunerx_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    S.use(PORT)
    col = S.Collector()
    before = compile_san.counts()["kernel_builds"]
    with compile_budget(0, raise_on_exceed=False, collector=col) as w:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.library()
    assert w.seen == 1 and len(col.findings) == 1
    assert compile_san.counts()["kernel_builds"] == before + 1
    assert "test_torch_dtxsan.py" in col.findings[0].finding.message
    wrapped = _build._build
    compile_san.uninstall()
    assert _build._build is not wrapped
    assert getattr(_build._build, "__wrapped__", None) is None
