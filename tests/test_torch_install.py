"""The port's install bundle (``datatunerx_tpu_torch/operator/{crdgen,
install}.py`` and ``dtx-torch install``) against the reference's, on the
CPU.

- The 5 scenarios of ``tests/test_install.py`` run on both packages
  through one parametrised body (``pkg``), each against
  ``tests/fake_apiserver.py``;
- the port renders the reference's CRDs (the CRs are one API), so the
  published ``deploy/crds/`` match both (``tests/test_crd_schemas.py``'s
  check), and its webhook manifests and RBAC are the reference's;
- the whole bundle equals the reference's but for the two card
  divergences, each pinned here: the Deployment runs ``python -m
  datatunerx_tpu_torch.operator.manager`` and its default image is the
  port's operator image (``--image``, the reference's key).
"""


import importlib

import pytest
import yaml

from tests.fake_apiserver import FakeKubeApiServer
from tests.torch_twin import PKGS, Twin

M = Twin(
    cli_main="cli:main",
    apply_manifest="operator.install:apply_manifest",
    install="operator.install:install",
    render_install_manifests="operator.install:render_install_manifests",
    KubeClient="operator.kubeclient:KubeClient",
)


@pytest.fixture(params=PKGS)
def pkg(request):
    return M.use(request.param)


@pytest.fixture()
def apiserver():
    srv = FakeKubeApiServer().start()
    yield srv
    srv.stop()


def test_render_bundle_shape(pkg):
    docs = M.render_install_manifests(
        namespace="dtx-ns",
        env={"S3_ACCESS_KEY": "ak", "S3_SECRET_KEY": "sk",
             "S3_ENDPOINT": "http://minio:9000", "STORAGE_PATH": "/st"},
    )
    kinds = [d["kind"] for d in docs]
    assert kinds.count("CustomResourceDefinition") == 8
    for required in ("Namespace", "ServiceAccount", "ClusterRole",
                     "ClusterRoleBinding", "ConfigMap", "Secret", "Service",
                     "MutatingWebhookConfiguration",
                     "ValidatingWebhookConfiguration", "Deployment"):
        assert required in kinds, f"missing {required}"
    # credentials in the Secret, plain config in the ConfigMap
    secret = next(d for d in docs if d["kind"] == "Secret")
    cm = next(d for d in docs if d["kind"] == "ConfigMap")
    assert set(secret["stringData"]) == {"S3_ACCESS_KEY", "S3_SECRET_KEY"}
    assert cm["data"]["S3_ENDPOINT"] == "http://minio:9000"
    assert "S3_SECRET_KEY" not in cm["data"]
    # deployment wires both via envFrom and runs the kube backend
    dep = next(d for d in docs if d["kind"] == "Deployment")
    c = dep["spec"]["template"]["spec"]["containers"][0]
    assert any("configMapRef" in e for e in c["envFrom"])
    assert "--backend=kube" in c["args"]
    assert dep["metadata"]["namespace"] == "dtx-ns"


def test_install_applies_cleanly_and_idempotently(pkg, apiserver):
    client = M.KubeClient(base_url=apiserver.url)
    lines = M.install(client, namespace="dtx-ns",
                      env={"S3_ACCESS_KEY": "ak"})
    assert all(line.endswith("created") for line in lines), lines

    # CRDs present, cluster-scoped
    crds = client.request(
        "GET", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions")
    names = {i["metadata"]["name"] for i in crds["items"]}
    assert "finetunejobs.finetune.datatunerx.io" in names
    assert "datasets.extension.datatunerx.io" in names

    # second run: everything updates in place (create-or-update)
    lines2 = M.install(client, namespace="dtx-ns",
                       env={"S3_ACCESS_KEY": "ak2"})
    assert all(line.endswith("configured") for line in lines2), lines2
    sec = client.request(
        "GET", "/api/v1/namespaces/dtx-ns/secrets/dtx-credentials")
    assert sec["stringData"]["S3_ACCESS_KEY"] == "ak2"


def test_dry_run_output_applies_against_fake(pkg, apiserver, capsys):
    """The --dry-run manifests are the install: applying its output must
    produce the same objects (VERDICT done-criterion)."""
    rc = M.cli_main(["install", "--dry-run", "-n", "dtx-ns",
                     "--set", "S3_ACCESS_KEY=k", "--set", "STORAGE_PATH=/st"])
    assert rc == 0
    out = capsys.readouterr().out
    import yaml

    docs = [d for d in yaml.safe_load_all(out) if d]
    client = M.KubeClient(base_url=apiserver.url)
    for doc in docs:
        assert M.apply_manifest(client, doc, namespace="dtx-ns") == "created"
    dep = client.request(
        "GET",
        "/apis/apps/v1/namespaces/dtx-ns/deployments/"
        "datatunerx-tpu-controller-manager")
    assert dep["spec"]["template"]["spec"]["containers"][0]["command"][0] == \
        "python"


def test_cli_install_against_fake_server(pkg, apiserver, capsys):
    rc = M.cli_main(["install", "-n", "dtx-ns", "--kube-url", apiserver.url,
                     "--set", "S3_ACCESS_KEY=k"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "deployment/datatunerx-tpu-controller-manager created" in out
    assert "namespace/dtx-ns created" in out


def test_webhook_service_routes_to_operator(pkg):
    docs = M.render_install_manifests(namespace="nsx")
    svc = next(d for d in docs if d["kind"] == "Service")
    vwc = next(d for d in docs
               if d["kind"] == "ValidatingWebhookConfiguration")
    cc = vwc["webhooks"][0]["clientConfig"]["service"]
    assert cc["name"] == svc["metadata"]["name"]
    assert cc["namespace"] == "nsx"
    assert svc["spec"]["ports"][0]["port"] == 9443


# ------------------------------------------------------- across packages

def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _container(docs):
    dep = next(d for d in docs if d["kind"] == "Deployment")
    return dep["spec"]["template"]["spec"]["containers"][0]


PORT_IMAGE = "datatunerx-tpu/operator-cuda:latest"


@pytest.mark.parametrize("kw", [
    dict(),
    dict(namespace="dtx-ha", replicas=2, leader_elect=True,
         env={"S3_ACCESS_KEY": "ak", "S3_ENDPOINT": "http://m:9000"}),
    dict(namespace="nsx", include_webhooks=False, storage_path="/st",
         image="registry.local/op:1"),
])
def test_the_bundles_are_equal_but_for_the_pinned_divergences(kw):
    ref, port = (_mod(p, "operator.install").render_install_manifests(**kw)
                 for p in PKGS)
    assert [d["kind"] for d in port] == [d["kind"] for d in ref]
    rc, pc = _container(ref), _container(port)
    # the divergences: the port's manager module, and its image by default
    assert rc["command"] == ["python", "-m",
                             "datatunerx_tpu.operator.manager"]
    assert pc["command"] == ["python", "-m",
                             "datatunerx_tpu_torch.operator.manager"]
    if "image" in kw:
        assert pc["image"] == rc["image"] == kw["image"]
    else:
        assert rc["image"] == "datatunerx-tpu/operator:latest"
        assert pc["image"] == PORT_IMAGE
    for c in (rc, pc):
        c.pop("command")
        c.pop("image")
    assert port == ref


def test_the_port_renders_the_reference_crds_and_webhooks():
    ref, port = (_mod(p, "operator.crdgen") for p in PKGS)
    assert port.all_crds() == ref.all_crds()
    for ns in ("datatunerx-dev", "nsx"):
        assert port.webhook_manifests(ns) == ref.webhook_manifests(ns)


def test_published_crds_match_the_ports_crdgen():
    """``deploy/crds/`` is the reference's published CRDs: the port's
    ``crdgen`` renders each of them (``tests/test_crd_schemas.py``'s
    check, on the port)."""
    from datatunerx_tpu_torch.operator.crdgen import all_crds
    from tests.test_crd_schemas import _load_published_crds

    published = {d["metadata"]["name"]: d for d in _load_published_crds()}
    crds = all_crds()
    assert sorted(published) == sorted(c["metadata"]["name"] for c in crds)
    for crd in crds:
        assert published[crd["metadata"]["name"]] == crd


def test_cli_install_defaults_to_the_port_image(capsys):
    from datatunerx_tpu_torch.cli import main

    assert main(["install", "--dry-run", "-n", "dtx-ns"]) in (0, None)
    docs = [d for d in yaml.safe_load_all(capsys.readouterr().out) if d]
    c = _container(docs)
    assert c["image"] == PORT_IMAGE
    assert c["command"][-1] == "datatunerx_tpu_torch.operator.manager"
    assert main(["install", "--dry-run", "--image", "x/y:1"]) in (0, None)
    docs = [d for d in yaml.safe_load_all(capsys.readouterr().out) if d]
    assert _container(docs)["image"] == "x/y:1"
