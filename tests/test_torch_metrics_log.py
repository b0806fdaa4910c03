"""The port's training metrics (``datatunerx_tpu_torch/training/
metrics_log.py``) held against the JAX package's: remote-write bytes equal
for equal samples, a live receiver on localhost gets them, an unreachable
address never raises, the ``watch/metrics.prom`` mirror is byte-equal for
equal records, the prefetch-depth advisory fires once on sustained stalls
(resizing the port's live ``HostPrefetcher``) and stays quiet on a healthy
pipeline, and the port CLI with ``--metrics_export_address`` pushes one
WriteRequest a logging step and writes the JAX CLI's
``watch/metrics.prom`` families. Every comparison is exact."""

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from datatunerx_tpu.training import metrics_log as jlog
from datatunerx_tpu_torch.training import metrics_log as tlog

SAMPLES = [
    ({"dtx_train_loss": 1.25, "dtx_train_lr": 3e-4, "dtx_train_epoch": 0.5},
     {"uid": "run-1", "phase": "train"}),
    ({"dtx_eval_loss": float("nan"), "dtx_eval_perplexity": 12.0},
     {"uid": "", "phase": "eval"}),
    ({"m": 0.0, "big": 1e300, "neg": -7.0, "none": None},
     {"z": "ü", "a": "x" * 200}),
    ({}, {"uid": "u"}),
]


def _unsnappy(data: bytes) -> bytes:
    """Decode a snappy block of literal elements (what the encoder
    writes)."""
    n, shift, i = 0, 0, 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while i < len(data):
        tag = data[i]
        assert tag & 3 == 0, "only literals are written"
        ln = (tag >> 2) + 1
        out += data[i + 1:i + 1 + ln]
        i += 1 + ln
    assert len(out) == n
    return bytes(out)


@pytest.mark.parametrize("case", range(len(SAMPLES)))
def test_remote_write_bytes_equal(case):
    metrics, labels = SAMPLES[case]
    ts = 1_700_000_000_123
    want = jlog.encode_write_request(metrics, labels, ts)
    got = tlog.encode_write_request(metrics, labels, ts)
    assert got == want
    assert tlog.snappy_compress_literal(got) == \
        jlog.snappy_compress_literal(want)
    assert _unsnappy(tlog.snappy_compress_literal(got)) == got
    big = bytes(range(256)) * 3
    assert tlog.snappy_compress_literal(big) == \
        jlog.snappy_compress_literal(big)


class _Receiver:
    """A remote-write endpoint on localhost that keeps every POST."""

    def __init__(self):
        self.posts = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.posts.append((self.path, dict(self.headers),
                                    self.rfile.read(n)))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture()
def receiver():
    r = _Receiver()
    yield r
    r.close()


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_push_reaches_a_live_receiver_and_never_raises(receiver):
    metrics, labels = SAMPLES[0]
    assert tlog.push_remote_write(receiver.url + "/", metrics, labels)
    (path, headers, body), = receiver.posts
    assert path == "/api/v1/write"
    assert headers["Content-Encoding"] == "snappy"
    assert headers["Content-Type"] == "application/x-protobuf"
    assert headers["X-Prometheus-Remote-Write-Version"] == "0.1.0"
    raw = _unsnappy(body)
    assert b"dtx_train_loss" in raw and b"run-1" in raw
    # a closed port and an address no socket can reach
    for addr in (f"http://127.0.0.1:{_closed_port()}", "http://127.0.0.1:0"):
        assert tlog.push_remote_write(addr, metrics, labels,
                                      timeout=1.0) is False


def _records():
    return [(1, {"loss": 2.5, "lr": 1e-4, "epoch": 0.1, "rouge-1": 0.25}),
            (2, {"loss": 2.0, "lr": 2e-4, "epoch": 0.2,
                 "pipe_step_wait_ms": 0.5, "bad": "x"})]


def test_metrics_prom_mirror_equal(tmp_path, monkeypatch, capsys):
    texts = []
    for mod, name in ((jlog, "j"), (tlog, "t")):
        lg = mod.MetricsLogger(str(tmp_path / name), 10, uid="u-1")
        for step, m in _records():
            lg.log_train(step, m)
        lg.log_eval(2, {"eval_loss": 1.5, "perplexity": 4.5})
        with open(tmp_path / name / "watch" / "metrics.prom") as f:
            texts.append(f.read())
        with open(tmp_path / name / "watch" / "trainer_log.jsonl") as f:
            recs = [json.loads(ln) for ln in f]
        texts.append(sorted(k for r in recs for k in r))
    assert texts[2:] == texts[:2]
    assert 'dtx_train_loss{uid="u-1"} 2' in texts[2]
    assert "dtx_eval_perplexity" in texts[2]


class _FakePrefetcher:
    def __init__(self):
        self.depths = []

    def resize(self, depth):
        self.depths.append(depth)
        return depth


@pytest.mark.parametrize("slow", [True, False], ids=["stalls", "healthy"])
def test_prefetch_advisory_fires_once(tmp_path, monkeypatch, capsys, slow):
    monkeypatch.setenv("DTX_PREFETCH_ADVISE_RECORDS", "4")
    monkeypatch.setenv("DTX_PREFETCH_ADVISE_MS", "5.0")
    out = []
    for mod, name in ((jlog, "j"), (tlog, "t")):
        lg = mod.MetricsLogger(str(tmp_path / name), 20, prefetch_depth=3)
        pf = _FakePrefetcher()
        lg.attach_prefetcher(pf)
        for step in range(1, 13):
            lg.log_train(step, {"loss": 1.0,
                                "pipe_step_wait_ms": 20.0 if slow else 0.5})
        out.append((lg.prefetch_advisory, pf.depths,
                    lg.effective_prefetch_depth()))
    assert out[1] == out[0]
    advisory, depths, effective = out[1]
    if slow:
        assert advisory["suggested_prefetch_depth"] == 6
        assert advisory["retuned"] is True
        assert depths == [6] and effective == 6
        assert capsys.readouterr().out.count("[advice]") == 2
    else:
        assert advisory is None and depths == [] and effective == 3


def test_host_prefetcher_resize_is_live():
    from datatunerx_tpu_torch.data.prefetch import HostPrefetcher

    made = []

    def source():
        for i in range(50):
            made.append(i)
            yield i

    pf = HostPrefetcher(source, depth=1)
    try:
        deadline = time.monotonic() + 10
        while len(made) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.05)
        assert len(made) == 2  # one queued, one blocked on put()
        assert pf.resize(5) == 5
        while len(made) < 6:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert list(pf) == list(range(50))
        with pytest.raises(ValueError):
            pf.resize(0)
    finally:
        pf.close()


def _types(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE "))


def test_cli_pushes_a_write_request_each_logging_step(tmp_path, receiver):
    """The port CLI with ``--metrics_export_address``: one WriteRequest a
    logged step carrying the loss sample, and ``watch/metrics.prom`` with
    the JAX CLI's metric families (the pipe_* gauges a run logs depend on
    thread timing in both packages, so those are compared as a prefix
    set)."""
    from datatunerx_tpu.tuning.train import main as jmain
    from datatunerx_tpu_torch.tuning.train import main as tmain
    from tests.test_torch_train_cli import _argv

    assert tmain(_argv(tmp_path, "port", device="cpu",
                       metrics_export_address=receiver.url)) == 0
    train_posts = [b for p, _, b in receiver.posts
                   if b"dtx_train_loss" in _unsnappy(b)]
    assert len(train_posts) == 3
    for body in train_posts:
        raw = _unsnappy(body)
        assert b"port" in raw and b"train" in raw
    assert any(b"dtx_eval_perplexity" in _unsnappy(b)
               for _, _, b in receiver.posts)
    receiver.posts.clear()
    assert jmain(_argv(tmp_path, "jax",
                       metrics_export_address=receiver.url)) == 0
    assert len([b for p, _, b in receiver.posts
                if b"dtx_train_loss" in _unsnappy(b)]) == 3
    fams = []
    for name in ("jax", "port"):
        path = os.path.join(tmp_path, name, "watch", "metrics.prom")
        with open(path) as f:
            fams.append([t for t in _types(f.read())
                         if not t.startswith("dtx_train_pipe_")])
    assert fams[1] == fams[0]
    assert "dtx_train_loss" in fams[1] and "dtx_build_info" in fams[1]
