"""The port's ``dtx-torch`` (``datatunerx_tpu_torch/cli.py``) against the
JAX package's ``dtx``.

- ``serve`` hands the port's gateway or server ``main`` the reference's
  argv plus ``--device`` (default ``cuda``), and reaches no module of the
  JAX package (both ``main``s are captured, not run).
- The operator's REST verbs (``apply``, ``get``, ``delete``, ``status``,
  ``logs``) against the reference ``operator/apiserver.py`` print what the
  reference CLI prints, errors included.
- Those six subcommands and ``experiment``, ``replay`` and ``install``
  exist (their own tests: ``tests/test_torch_{experiment_loop,loadgen,
  install}.py``); ``--help`` names the two left out, ``lint`` and ``san``.
"""

import json

import pytest

from datatunerx_tpu import cli as jcli
from datatunerx_tpu_torch import cli as tcli

SERVE_ARGS = [
    ["serve", "--model_path", "preset:tinyllama-1.1b"],
    ["serve", "--model_path", "/m", "--slots", "8", "--kv_block_size", "16",
     "--role", "decode", "--device", "cpu"],
    ["serve", "--model_path", "/m", "--replicas", "2", "--kv_block_size",
     "16", "--role", "prefill,decode", "--prefill_threshold", "512",
     "--fleet_prefix_mb", "64", "--fleet_handoff", "1",
     "--tenants_config", '{"t": {"tier": "bulk"}}', "--workdir", "/w"],
    ["serve", "--model_path", "/m", "--gateway", "--device", "cpu",
     "--policy", "round_robin"],
]


def _captured(monkeypatch, cli, root):
    """Run ``cli.main`` with both serve targets of ``root`` captured:
    returns (target module, argv)."""
    import importlib

    seen = []
    for mod in ("gateway.server", "serving.server"):
        m = importlib.import_module(f"{root}.{mod}")
        monkeypatch.setattr(
            m, "main", lambda argv, mod=mod: seen.append((mod, argv)) or 0)
    return seen


def _drop_device(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:], argv[i + 1]


@pytest.mark.parametrize("args", SERVE_ARGS,
                         ids=["server", "server-cpu", "gateway", "gw-cpu"])
def test_serve_argv_is_the_references_plus_device(monkeypatch, args):
    want_seen = _captured(monkeypatch, jcli, "datatunerx_tpu")
    ref_args = [a for a in args]
    if "--device" in ref_args:
        ref_args, _ = _drop_device(ref_args)
    assert jcli.main(ref_args) == 0
    got_seen = _captured(monkeypatch, tcli, "datatunerx_tpu_torch")
    assert tcli.main(list(args)) == 0
    [(want_mod, want)], [(got_mod, got)] = want_seen, got_seen
    assert got_mod == want_mod
    assert got_mod == ("gateway.server" if "--replicas" in args
                       or "--gateway" in args else "serving.server")
    rest, device = _drop_device(got)
    assert rest == want
    assert device == ("cpu" if "cpu" in args else "cuda")
    assert not any("datatunerx_tpu." in a for a in got)
    if got_mod == "serving.server":
        from datatunerx_tpu_torch.serving.server import parse_args

        assert parse_args(got).device == device


# ------------------------------------------------------------ REST verbs

@pytest.fixture()
def api():
    from datatunerx_tpu.operator.apiserver import serve_api
    from datatunerx_tpu.operator.store import ObjectStore
    from datatunerx_tpu.operator.webhooks import AdmittingStore

    srv, port = serve_api(AdmittingStore(ObjectStore()), port=0)
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()


def _dataset(name):
    return {"kind": "Dataset", "metadata": {"name": name},
            "spec": {"datasetMetadata": {"datasetInfo": {
                "subsets": [{"splits": {"train": {"file": "/data/t.csv"}}}],
                "features": [{"name": "instruction", "mapTo": "q"},
                             {"name": "response", "mapTo": "a"}]}}}}


def _session(main, server, manifest, capsys, tag):
    """One CLI session against a fresh kind of object names: what each
    command printed, and how it exited."""
    docs = [_dataset(f"{tag}-ds"),
            {"kind": "Hyperparameter", "metadata": {"name": f"{tag}-hp"},
             "spec": {}}]
    manifest.write_text(json.dumps(docs))
    steps = [["apply", "-f", str(manifest)],
             ["apply", "-f", str(manifest)],
             ["get", "datasets"],
             ["get", "hp", f"{tag}-hp", "-o", "json"],
             ["get", "ds", f"{tag}-ds"],
             ["status", "missing-job"],
             ["delete", "dataset", f"{tag}-ds"],
             ["get", "dataset", f"{tag}-ds"],
             ["get", "frobnicator"],
             ["logs", "nobody"]]
    out = []
    for step in steps:
        try:
            rc = main(["--server", server, *step])
        except SystemExit as e:
            rc = f"exit: {e.code}".replace(tag, "TAG")
        text = capsys.readouterr().out
        out.append((step[0], rc, text.replace(tag, "TAG")))
    return out


def test_rest_verbs_print_what_the_reference_prints(api, tmp_path, capsys):
    # tags of one length, so that the tables' column widths agree
    want = _session(jcli.main, api, tmp_path / "a.json", capsys, "jax1")
    got = _session(tcli.main, api, tmp_path / "b.json", capsys, "port")

    def scrub(rows):  # the two sessions' objects differ in uid and version
        out = []
        for verb, rc, text in rows:
            if text.startswith("{"):
                doc = json.loads(text)
                doc["metadata"] = {k: v for k, v in doc["metadata"].items()
                                   if k not in ("uid", "creation_timestamp",
                                                "resource_version")}
                text = json.dumps(doc, sort_keys=True)
            out.append((verb, rc, text))
        return out

    assert scrub(got) == scrub(want)
    assert "TAG-ds created" in got[0][2] and "configured" in got[1][2]
    assert got[6][2] == "Dataset/TAG-ds deleted\n"


def test_only_the_ported_subcommands(capsys):
    with pytest.raises(SystemExit) as ei:
        tcli.main(["--help"])
    assert ei.value.code == 0
    text = capsys.readouterr().out
    assert ("{apply,get,delete,status,logs,serve,experiment,replay,"
            "install}") in text
    assert "not ported" not in text
    # experiment needs -f and replay a target (its own parser, dispatched
    # before dtx-torch's)
    for cmd in ("experiment", "replay"):
        with pytest.raises(SystemExit) as ei:
            tcli.main([cmd])
        assert ei.value.code == 2
    capsys.readouterr()
    # lint and san are the port's analysis/ CLIs, dispatched before
    # argparse as the reference's are: their own flags and exit codes
    assert tcli.main(["lint", "--list-rules"]) == 0
    rules = capsys.readouterr().out
    assert all(f"DTX{i:03d}" in rules for i in range(1, 13))
    assert tcli.main(["san", "--module-budget", "nonsense"]) == 2
    assert "dtx-torch san: bad --module-budget" in capsys.readouterr().err
