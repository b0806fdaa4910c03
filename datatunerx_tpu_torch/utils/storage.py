"""File IO for datasets, manifests and exports (the port of
``datatunerx_tpu/utils/storage.py``), local paths only.

The reference also takes fsspec URIs (``gs://``, ``s3://``, ``memory://``);
object stores are not ported yet (ROADMAP Queue 1 item 11), and a URI raises
with that item's name rather than being written as a local path.
"""

from __future__ import annotations

import os

_URI_MARK = "://"


def is_uri(path: str) -> bool:
    return _URI_MARK in str(path)


def _local(path: str) -> str:
    if is_uri(path):
        raise NotImplementedError(
            f"object-store URIs are not ported yet ({path!r}; ROADMAP Queue 1 "
            "item 11): pass a local path")
    return path


def join(base: str, *parts: str) -> str:
    return os.path.join(_local(base), *parts)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def read_text(path: str) -> str:
    with open(_local(path), "r") as f:
        return f.read()


def write_text(path: str, content: str) -> None:
    parent = os.path.dirname(_local(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
