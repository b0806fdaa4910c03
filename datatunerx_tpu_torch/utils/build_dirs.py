"""Where the port's native builds go: the CUDA kernel library
(``ops/_build.py``) and the C++ packer (``native/``).

In a checkout (the package's parent directory holds this project's
``pyproject.toml``) a build goes to ``build/<name>/`` under the repository
root, which ``.gitignore`` lists. An installed package never writes into
site-packages: its builds go to
``${XDG_CACHE_HOME:-~/.cache}/datatunerx_tpu_torch/<name>/``. Both builds
name their library by a hash of its sources and flags, so one cache serves
every installed version side by side.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
_PROJECT = re.compile(r'^name\s*=\s*"datatunerx-tpu"\s*$', re.MULTILINE)


def checkout_root(package: Path = PACKAGE):
    """The repository root when ``package`` sits in a checkout of this
    project, else None."""
    pyproject = package.parent / "pyproject.toml"
    try:
        text = pyproject.read_text()
    except OSError:
        return None
    return package.parent if _PROJECT.search(text) else None


def build_dir(name: str, package: Path = PACKAGE) -> Path:
    """The directory of the build ``name`` (``torch_kernels``,
    ``torch_native``) for the package at ``package``."""
    root = checkout_root(package)
    if root is not None:
        return root / "build" / name
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return Path(cache) / package.name / name
