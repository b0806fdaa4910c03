"""The port's images agree with the names its control plane renders:
``Dockerfile.torch`` (the operator) and ``Dockerfile.torch-trainer`` (the
training JobSet and the serving Deployment), the Makefile's
``IMG_*_CUDA`` tags, ``operator/install.OPERATOR_IMAGE``,
``operator/config.get_base_image()`` and ``ManifestBackend``'s fallbacks.
Neither image is built here (no docker): these are static checks of the
files."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from datatunerx_tpu_torch.operator import backends, config, install

ROOT = Path(__file__).resolve().parent.parent
DOCKERFILES = {"operator": ROOT / "Dockerfile.torch",
               "trainer": ROOT / "Dockerfile.torch-trainer"}


def _makefile_var(name):
    m = re.search(rf"^{name}\s*\?=\s*(\S+)\s*$",
                  (ROOT / "Makefile").read_text(), re.MULTILINE)
    assert m, name
    return m.group(1)


def _instructions(path):
    """(instruction, argument) pairs, continuation lines joined."""
    text = re.sub(r"\\\n", " ", path.read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


@pytest.fixture(autouse=True)
def _default_env(monkeypatch):
    monkeypatch.delenv("BASE_IMAGE", raising=False)


def test_makefile_tags_are_the_control_planes_images():
    assert _makefile_var("IMG_OPERATOR_CUDA") == install.OPERATOR_IMAGE
    assert _makefile_var("IMG_TRAINER_CUDA") == config.get_base_image()
    assert config.get_base_image() == "datatunerx-tpu/trainer-cuda:latest"
    make = (ROOT / "Makefile").read_text()
    assert ("docker build -t $(IMG_OPERATOR_CUDA) -f Dockerfile.torch ."
            in make)
    assert ("docker build -t $(IMG_TRAINER_CUDA) -f Dockerfile.torch-trainer"
            " ." in make)
    assert "python -m datatunerx_tpu_torch.ops._build" in make


@pytest.mark.parametrize("image, module", [
    ("operator", "datatunerx_tpu_torch.operator.manager"),
    ("trainer", "datatunerx_tpu_torch.tuning.train")])
def test_entrypoints_name_port_modules(image, module):
    entry = [json.loads(arg) for word, arg in
             _instructions(DOCKERFILES[image]) if word == "ENTRYPOINT"]
    assert entry == [["python", "-m", module]]
    assert importlib.util.find_spec(module) is not None
    # the manifests run the same modules in this image
    assert hasattr(importlib.import_module(module), "main")


def test_install_renders_the_operator_images_module():
    (dep,) = [d for d in install.render_install_manifests()
              if d["kind"] == "Deployment"]
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    assert c["image"] == install.OPERATOR_IMAGE
    entry = [json.loads(arg) for word, arg in
             _instructions(DOCKERFILES["operator"]) if word == "ENTRYPOINT"]
    assert c["command"] == entry[0]


@pytest.mark.parametrize("image", sorted(DOCKERFILES))
def test_images_hold_the_port_alone(image):
    steps = _instructions(DOCKERFILES[image])
    copies = [arg.split()[0] for word, arg in steps if word == "COPY"]
    assert sorted(copies) == ["datatunerx_tpu_torch", "pyproject.toml"]
    pips = [arg for word, arg in steps
            if word == "RUN" and "pip install" in arg]
    assert pips
    for arg in pips:
        for name in ("jax", "flax", "optax", "orbax", "transformers"):
            assert name not in arg, (image, arg)


def test_trainer_image_builds_the_kernels_into_its_cache():
    steps = _instructions(DOCKERFILES["trainer"])
    (base,) = [arg for word, arg in steps if word == "FROM"]
    assert base.startswith("nvidia/cuda:") and "-devel-" in base
    env = " ".join(arg for word, arg in steps if word == "ENV")
    assert re.search(r"XDG_CACHE_HOME=/\S+", env)
    runs = [arg for word, arg in steps if word == "RUN"]
    build = next(i for i, arg in enumerate(runs)
                 if "python -m datatunerx_tpu_torch.ops._build" in arg)
    install_at = next(i for i, arg in enumerate(runs)
                      if "pip install --no-cache-dir /src" in arg)
    # built after the install, from the installed package (the source copy
    # removed, so nothing resolves to a checkout)
    assert install_at < build and "rm -rf /src" in runs[install_at]
    assert "native.available()" in runs[build]
    assert "index-url https://download.pytorch.org/whl/cu" in " ".join(runs)


def test_manifest_fallbacks_are_the_base_image(tmp_path):
    """A spec without an image trains and serves on the trainer image
    (where the reference falls back to its TPU trainer and serving images);
    an image in the spec wins."""
    mb = backends.ManifestBackend(str(tmp_path))
    train = {"args": ["--model_name_or_path", "m"]}
    serve = {"model_path": "/m"}

    def images(train, serve):
        js = mb.render_training("t", train)
        dep = mb.render_serving("s", serve)[0]
        return (js["spec"]["replicatedJobs"][0]["template"]["spec"][
                    "template"]["spec"]["containers"][0]["image"],
                dep["spec"]["template"]["spec"]["containers"][0]["image"])

    assert images(train, serve) == (config.get_base_image(),) * 2
    # the operator's generated training spec carries image None when the
    # Finetune names none
    assert images(dict(train, image=None), dict(serve, image=None)) == (
        config.get_base_image(),) * 2
    assert images(dict(train, image="r/t:1"), dict(serve, image="r/s:2")) \
        == ("r/t:1", "r/s:2")
