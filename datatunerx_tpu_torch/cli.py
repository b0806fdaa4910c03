"""dtx-torch — the port's ``dtx`` (the port's copy of
``datatunerx_tpu/cli.py``, with its REST verbs and ``serve``).

Talks to the operator's REST API (operator/apiserver.py):

  dtx-torch apply -f resources.json|yaml   create/update CRs (a single
                                           object or a list; JSON, or YAML
                                           if pyyaml is available)
  dtx-torch get <kind> [name] [-n ns] [-o json]
  dtx-torch delete <kind> <name> [-n ns]
  dtx-torch status <finetunejob-name>      condensed pipeline view
  dtx-torch logs <finetune-name>           trainer log tail (local backend)
  dtx-torch serve --model_path P           serve directly (no operator) on
      [--replicas N] [--gateway]           --device (default cuda); with
      [--device cuda|cpu]                  N > 1 or --gateway the port's
                                           gateway fronts N port servers
  dtx-torch experiment -f spec.json        the closed experiment loop
      [--backend fake|local]               (experiment/runner.py); local
      [--device cuda|cpu]                  trainers run on --device
  dtx-torch replay [args...]               load replay + chaos + SLO
                                           verdict (loadgen/replay.py; its
                                           flags pass through)
  dtx-torch install [--dry-run]            CRDs, RBAC, config and the
                                           controller-manager Deployment
  dtx-torch lint [paths...]                static analysis of the port
                                           (analysis/; dtxlint's flags)
  dtx-torch san [args...] [-- pytest...]   pytest under the runtime
                                           sanitizers (analysis/sanitizers)

Server address from --server or DTX_SERVER (default http://127.0.0.1:8080);
bearer auth via DTX_API_TOKEN when the server requires it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

from datatunerx_tpu_torch.operator.install import OPERATOR_IMAGE

_GROUP_BY_KIND = {
    "Finetune": "finetune.datatunerx.io",
    "FinetuneJob": "finetune.datatunerx.io",
    "FinetuneExperiment": "finetune.datatunerx.io",
    "LLM": "core.datatunerx.io",
    "Hyperparameter": "core.datatunerx.io",
    "LLMCheckpoint": "core.datatunerx.io",
    "Dataset": "extension.datatunerx.io",
    "Scoring": "extension.datatunerx.io",
}
_KIND_ALIASES = {k.lower(): k for k in _GROUP_BY_KIND}
_KIND_ALIASES.update({k.lower() + "s": k for k in _GROUP_BY_KIND})
_KIND_ALIASES.update({"ftj": "FinetuneJob", "ftexp": "FinetuneExperiment",
                      "ft": "Finetune", "hp": "Hyperparameter", "ds": "Dataset"})


def _kind(raw: str) -> str:
    k = _KIND_ALIASES.get(raw.lower())
    if not k:
        sys.exit(f"error: unknown kind {raw!r}; one of {sorted(_GROUP_BY_KIND)}")
    return k


def _url(server: str, kind: str, ns: str = None, name: str = None) -> str:
    group = _GROUP_BY_KIND[kind]
    url = f"{server}/apis/{group}/v1beta1/{kind.lower()}"
    if ns:
        url += f"/{ns}"
        if name:
            url += f"/{name}"
    return url


def _request(method: str, url: str, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"}
    if os.environ.get("DTX_API_TOKEN"):
        headers["Authorization"] = f"Bearer {os.environ['DTX_API_TOKEN']}"
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.load(e)
        except Exception:
            return e.code, {"error": e.reason}
    except urllib.error.URLError as e:
        sys.exit(f"error: cannot reach API server at {url.split('/apis')[0]}: {e.reason}")


def _load_docs(path: str):
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # optional

            docs = [d for d in yaml.safe_load_all(text) if d]
        except ImportError:
            sys.exit("error: pyyaml not available; use JSON manifests")
    else:
        loaded = json.loads(text)
        docs = loaded if isinstance(loaded, list) else [loaded]
    return docs


def cmd_apply(args):
    for doc in _load_docs(args.filename):
        kind = _kind(doc.get("kind", ""))
        meta = doc.get("metadata", {})
        ns = meta.get("namespace", "default")
        name = meta.get("name")
        code, resp = _request("POST", _url(args.server, kind), doc)
        if code == 409:  # exists → fetch rv and update
            code_get, current = _request("GET", _url(args.server, kind, ns, name))
            if code_get == 200:
                doc.setdefault("metadata", {})["resource_version"] = (
                    current["metadata"]["resource_version"]
                )
                doc["metadata"]["uid"] = current["metadata"]["uid"]
                code, resp = _request("PUT", _url(args.server, kind, ns, name), doc)
        if code in (200, 201):
            print(f"{kind}/{name} {'created' if code == 201 else 'configured'}")
        else:
            sys.exit(f"error applying {kind}/{name}: {resp.get('error', resp)}")


def cmd_get(args):
    kind = _kind(args.kind)
    if args.name:
        code, resp = _request("GET", _url(args.server, kind, args.namespace, args.name))
        if code != 200:
            sys.exit(f"error: {resp.get('error')}")
        if args.output == "json":
            print(json.dumps(resp, indent=1, default=str))
        else:
            _print_table(kind, [resp])
        return
    code, resp = _request("GET", _url(args.server, kind) + f"/{args.namespace}")
    if code != 200:
        sys.exit(f"error: {resp.get('error')}")
    if args.output == "json":
        print(json.dumps(resp, indent=1, default=str))
    else:
        _print_table(kind, resp.get("items", []))


def _print_table(kind, items):
    rows = []
    for it in items:
        meta, status = it.get("metadata", {}), it.get("status", {})
        state = status.get("state", "")
        extra = ""
        if kind == "FinetuneJob":
            extra = str(status.get("result", {}).get("score", ""))
        elif kind == "FinetuneExperiment":
            extra = str(status.get("bestVersion", {}).get("score", ""))
        elif kind == "Scoring":
            state = ""
            extra = str(status.get("score", ""))
        rows.append((meta.get("name", ""), state, extra))
    name_w = max([4] + [len(r[0]) for r in rows]) + 2
    state_w = max([5] + [len(r[1]) for r in rows]) + 2
    print(f"{'NAME':<{name_w}}{'STATE':<{state_w}}SCORE")
    for name, state, extra in rows:
        print(f"{name:<{name_w}}{state:<{state_w}}{extra}")


def cmd_delete(args):
    kind = _kind(args.kind)
    code, resp = _request("DELETE", _url(args.server, kind, args.namespace, args.name))
    if code != 200:
        sys.exit(f"error: {resp.get('error')}")
    print(f"{kind}/{args.name} deleted")


def cmd_status(args):
    code, job = _request(
        "GET", _url(args.server, "FinetuneJob", args.namespace, args.name))
    if code != 200:
        sys.exit(f"error: {job.get('error')}")
    status = job.get("status", {})
    result = status.get("result", {})
    print(f"FinetuneJob {args.name}")
    print(f"  state:      {status.get('state', '')}")
    print(f"  finetune:   {status.get('finetuneStatus', {}).get('state', '')}")
    print(f"  serve:      {result.get('serve', '')}")
    print(f"  score:      {result.get('score', '')}")
    print(f"  checkpoint: {result.get('checkpointPath', '')}")


def cmd_logs(args):
    code, resp = _request("GET", f"{args.server}/logs/{args.namespace}/{args.name}")
    if code != 200:
        sys.exit(f"error: {resp.get('error')}")
    print(resp.get("log", ""), end="")


def cmd_serve(args):
    """Launch the port's serving directly (no operator): one
    ``datatunerx_tpu_torch.serving.server``, or — with --replicas N /
    --gateway — ``datatunerx_tpu_torch.gateway.server`` fronting N port
    server subprocesses (routing, admission control, failover), every
    server on ``--device``."""
    common = [
        "--model_path", args.model_path,
        "--checkpoint_path", args.checkpoint_path,
        "--template", args.template,
        "--max_seq_len", str(args.max_seq_len),
        "--port", str(args.port),
        "--quantization", args.quantization,
        "--slots", str(args.slots),
        "--adapters", args.adapters,
        "--adapter_pool", str(args.adapter_pool),
        "--adapter_rank_max", str(args.adapter_rank_max),
        "--kv_block_size", str(args.kv_block_size),
        "--kv_blocks", str(args.kv_blocks),
        "--kv_overcommit", args.kv_overcommit,
        "--paged_kernel", args.paged_kernel,
        "--spec_draft_config", args.spec_draft_config,
        "--spec_k", str(args.spec_k),
        "--spec_mode", args.spec_mode,
        "--spec_tree", args.spec_tree,
        "--sampling_epilogue", args.sampling_epilogue,
        "--prefill_token_budget", str(args.prefill_token_budget),
    ]
    if args.replicas > 1 or args.gateway:
        from datatunerx_tpu_torch.gateway.server import main as gateway_main

        argv = common + [
            "--replicas", str(max(args.replicas, 1)),
            "--policy", args.policy,
            "--max_queue", str(args.max_queue),
            "--token_budget", str(args.token_budget),
            "--role", args.role,
            "--prefill_threshold", str(args.prefill_threshold),
            "--fleet_prefix_mb", str(args.fleet_prefix_mb),
            "--fleet_handoff", str(int(args.fleet_handoff)),
            "--fleet_spill", str(int(args.fleet_spill)),
            "--tenants_config", args.tenants_config,
            "--host_adapter_cache_mb", str(args.host_adapter_cache_mb),
            "--device", args.device,
        ]
        if args.workdir:
            argv += ["--workdir", args.workdir]
        return gateway_main(argv)
    from datatunerx_tpu_torch.serving.server import main as serving_main

    argv = common + [
        "--tenants_config", args.tenants_config,
        "--host_adapter_cache_mb", str(args.host_adapter_cache_mb),
        "--device", args.device,
    ]
    if args.role:
        # single server: one role, not a cycle (serving.server validates)
        argv += ["--role", args.role]
    return serving_main(argv)


def cmd_experiment(args):
    """Run a closed-loop experiment (experiment/runner.py): N jobs
    elastically scheduled on a shared slice pool, continuous scoring into
    a live leaderboard, winner promoted through canary traffic weights."""
    from datatunerx_tpu_torch.experiment.runner import main as experiment_main

    argv = ["-f", args.filename, "--backend", args.backend,
            "--workdir", args.workdir,
            "--max_ticks", str(args.max_ticks),
            "--tick_s", str(args.tick_s),
            "--device", args.device]
    if args.status_json:
        argv += ["--status_json", args.status_json]
    return experiment_main(argv)


def _passthrough_tail(argv, cmd):
    """The argv tail after ``cmd`` when it is the subcommand — allowing
    the one global option (``--server``) before it — else None. ``replay``
    (loadgen) owns its full flag surface, so it must bypass argparse
    entirely: a REMAINDER positional drops leading optionals like
    ``--url``, so it dispatches before parsing."""
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--server":
            i += 2
            continue
        if tok.startswith("--server="):
            i += 1
            continue
        return argv[i + 1:] if tok == cmd else None
    return None


def cmd_replay(args):
    # unreachable in practice — main() dispatches replay before argparse —
    # kept so the help-listing subparser has an action
    from datatunerx_tpu_torch.loadgen.replay import main as replay_main

    return replay_main([])


def cmd_install(args):
    """One-command install (reference dtx-ctl + Helm, INSTALL.md:26-48)."""
    from datatunerx_tpu_torch.operator.install import (
        install,
        render_install_manifests,
    )

    env = {}
    for item in args.set or []:
        key, sep, val = item.partition("=")
        if not sep:
            sys.exit(f"error: --set expects KEY=VALUE, got {item!r}")
        env[key] = val

    kw = dict(
        namespace=args.namespace,
        image=args.image,
        env=env,
        storage_path=args.storage_path,
        leader_elect=args.leader_elect,
        replicas=args.replicas,
        include_webhooks=not args.no_webhooks,
    )
    if args.dry_run:
        docs = render_install_manifests(**kw)
        try:
            import yaml

            print(yaml.safe_dump_all(docs, sort_keys=False), end="")
        except ImportError:
            print(json.dumps(docs, indent=1))
        return
    from datatunerx_tpu_torch.operator.kubeclient import KubeClient

    client = KubeClient(base_url=args.kube_url,
                        namespace=args.namespace)
    ns = kw.pop("namespace")
    for line in install(client, namespace=ns, **kw):
        print(line)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    lint_tail = _passthrough_tail(argv, "lint")
    if lint_tail is not None:
        from datatunerx_tpu_torch.analysis.cli import main as lint_main

        return lint_main(lint_tail)
    replay_tail = _passthrough_tail(argv, "replay")
    if replay_tail is not None:
        from datatunerx_tpu_torch.loadgen.replay import main as replay_main

        return replay_main(replay_tail)
    san_tail = _passthrough_tail(argv, "san")
    if san_tail is not None:
        from datatunerx_tpu_torch.analysis.sanitizers.cli import (
            main as san_main,
        )

        return san_main(san_tail)
    p = argparse.ArgumentParser(prog="dtx-torch")
    p.add_argument("--server", default=os.environ.get("DTX_SERVER",
                                                      "http://127.0.0.1:8080"))
    sub = p.add_subparsers(dest="cmd", required=True)

    ap = sub.add_parser("apply")
    ap.add_argument("-f", "--filename", required=True)
    ap.set_defaults(fn=cmd_apply)

    gp = sub.add_parser("get")
    gp.add_argument("kind")
    gp.add_argument("name", nargs="?")
    gp.add_argument("-n", "--namespace", default="default")
    gp.add_argument("-o", "--output", choices=["table", "json"], default="table")
    gp.set_defaults(fn=cmd_get)

    dp = sub.add_parser("delete")
    dp.add_argument("kind")
    dp.add_argument("name")
    dp.add_argument("-n", "--namespace", default="default")
    dp.set_defaults(fn=cmd_delete)

    sp = sub.add_parser("status")
    sp.add_argument("name")
    sp.add_argument("-n", "--namespace", default="default")
    sp.set_defaults(fn=cmd_status)

    lp = sub.add_parser("logs")
    lp.add_argument("name")
    lp.add_argument("-n", "--namespace", default="default")
    lp.set_defaults(fn=cmd_logs)

    vp = sub.add_parser(
        "serve",
        help="serve a model directly: single server, or --replicas N / "
             "--gateway for the multi-replica inference gateway")
    vp.add_argument("--model_path", required=True)
    vp.add_argument("--checkpoint_path", default="")
    vp.add_argument("--template", default="llama2")
    vp.add_argument("--max_seq_len", type=int, default=1024)
    vp.add_argument("--port", type=int, default=8000)
    vp.add_argument("--quantization", default="",
                    choices=["", "int8", "int4", "nf4"])
    vp.add_argument("--slots", type=int, default=4)
    vp.add_argument("--adapters", default="",
                    help="named LoRA adapters: name=ckpt[,name=ckpt…]")
    vp.add_argument("--adapter_pool", type=int, default=0,
                    help="dynamic multi-adapter pool: N device slots adapters "
                         "load into at runtime (load-on-miss + LRU evict "
                         "via POST/DELETE /admin/adapters; 0 = static "
                         "--adapters stack)")
    vp.add_argument("--adapter_rank_max", type=int, default=8,
                    help="pool rank ceiling; lower ranks are zero-padded, "
                         "higher ranks rejected")
    vp.add_argument("--kv_block_size", type=int, default=0,
                    help="paged KV cache block size in tokens (0 = dense)")
    vp.add_argument("--kv_blocks", type=int, default=0,
                    help="paged pool size in blocks (default: dense parity)")
    vp.add_argument("--kv_overcommit", default="off",
                    choices=["off", "on"],
                    help="on: lazy block reserve + on-demand growth + COW "
                         "prefix blocks + youngest-first preemption (more "
                         "concurrent sessions per GPU); off = eager "
                         "reserve, byte-identical to the classic engine")
    vp.add_argument("--paged_kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="paged attention CUDA kernels: auto = on under "
                         "CUDA, on = force (their plain versions on the "
                         "CPU), off = the gather path")
    vp.add_argument("--spec_draft_config", default="",
                    help="speculative decoding draft: model path, "
                         "preset:<name>, or take:N (target's first N "
                         "layers); empty = off")
    vp.add_argument("--spec_k", type=int, default=4,
                    help="draft proposals per verify step")
    vp.add_argument("--spec_mode", default="auto",
                    choices=["auto", "on", "off"],
                    help="speculative decoding: auto = adaptive, on = "
                         "pinned, off = plain decode")
    vp.add_argument("--spec_tree", default="",
                    help="tree drafts 'WxD' (width x depth, e.g. 4x3): one "
                         "batched verify over W branches, accept the "
                         "longest surviving path; needs "
                         "--spec_draft_config; empty = chain drafts")
    vp.add_argument("--sampling_epilogue", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused sampling CUDA kernel: auto = on under "
                         "CUDA, on = force (its plain version on the CPU), "
                         "off = the legacy sampler")
    vp.add_argument("--prefill_token_budget", type=int, default=0,
                    help="prefill tokens per scheduler tick between decode "
                         "chunks (0 = unbounded)")
    vp.add_argument("--role", default="",
                    help="disaggregation role(s): a single role for one "
                         "server (prefill/decode/mixed), or a comma-"
                         "separated cycle for gateway-spawned replicas "
                         "(e.g. 'prefill,decode'); empty = all mixed")
    vp.add_argument("--prefill_threshold", type=int, default=0,
                    help="gateway: prompts of >= this many tokens prefer "
                         "role=prefill replicas (0 = role-blind routing)")
    vp.add_argument("--fleet_prefix_mb", type=float, default=0.0,
                    help="gateway: fleet-shared prefix tier budget in MB "
                         "(0 = off)")
    vp.add_argument("--fleet_handoff", type=int, default=0,
                    help="gateway: 1 = prefill→decode session handoff")
    vp.add_argument("--fleet_spill", type=int, default=0,
                    help="gateway: 1 = spill preemption-parked sessions "
                         "to peers with free KV blocks")
    vp.add_argument("--tenants_config", default="",
                    help="tenant directory (JSON file path or inline JSON "
                         "object): enables the multi-tenant QoS plane — "
                         "pinned/standard/bulk tiers, weighted-fair "
                         "admission shares, per-tenant KV block quotas "
                         "(empty = plane off, byte-identical serving)")
    vp.add_argument("--host_adapter_cache_mb", type=float, default=0.0,
                    help="host-RAM adapter tier budget in MB: evicted "
                         "pool adapters reload from host arrays instead "
                         "of storage (0 = off)")
    vp.add_argument("--replicas", type=int, default=1,
                    help="replica count; > 1 puts the gateway in front")
    vp.add_argument("--gateway", action="store_true",
                    help="front even a single replica with the gateway "
                         "(admission control + metrics + rolling restart)")
    vp.add_argument("--policy", default="least_busy",
                    choices=["least_busy", "round_robin"])
    vp.add_argument("--max_queue", type=int, default=64)
    vp.add_argument("--token_budget", type=int, default=32768)
    vp.add_argument("--workdir", default="",
                    help="gateway replica log directory")
    vp.add_argument("--device", default="cuda",
                    help="torch device of the server(s); cpu only when "
                         "asked")
    vp.set_defaults(fn=cmd_serve)

    ep = sub.add_parser(
        "experiment",
        help="run a closed-loop experiment: shared slice pool, continuous "
             "scoring, canary promotion (experiment/)")
    ep.add_argument("-f", "--filename", required=True,
                    help="experiment spec JSON")
    ep.add_argument("--backend", choices=["fake", "local"], default="fake")
    ep.add_argument("--workdir", default="experiment-jobs")
    ep.add_argument("--max_ticks", type=int, default=2000)
    ep.add_argument("--tick_s", type=float, default=0.05)
    ep.add_argument("--status_json", default="")
    ep.add_argument("--device", default="cuda",
                    help="torch device of the local backend's trainers; "
                         "cpu only when asked")
    ep.set_defaults(fn=cmd_experiment)

    rp = sub.add_parser(
        "replay",
        help="trace-driven load replay + chaos harness with SLO verdict "
             "(loadgen/); args pass through",
        add_help=False)
    rp.set_defaults(fn=cmd_replay)

    ip = sub.add_parser(
        "install",
        help="install CRDs + RBAC + operator Deployment + config "
             "(reference dtx-ctl/Helm flow, INSTALL.md:26-48)")
    ip.add_argument("-n", "--namespace", default="datatunerx-dev")
    ip.add_argument("--image", default=OPERATOR_IMAGE)
    ip.add_argument("--storage-path", default="/storage")
    ip.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="operator env config; credential keys "
                         "(S3_ACCESS_KEY, S3_SECRET_KEY, REGISTRY_USER, "
                         "REGISTRY_PASSWORD) land in a Secret, the rest in "
                         "a ConfigMap")
    ip.add_argument("--leader-elect", action="store_true")
    ip.add_argument("--replicas", type=int, default=1)
    ip.add_argument("--no-webhooks", action="store_true",
                    help="skip the admission webhook Service + configurations")
    ip.add_argument("--dry-run", action="store_true",
                    help="print the manifests instead of applying")
    ip.add_argument("--kube-url", default=os.environ.get("DTX_KUBE_URL"),
                    help="apiserver base URL (default: in-cluster config)")
    ip.set_defaults(fn=cmd_install)

    args = p.parse_args(argv)
    rc = args.fn(args)
    return int(rc) if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
