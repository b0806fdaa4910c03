"""Object-storage plane: URI-aware file IO for datasets, manifests,
checkpoints and exports (the port of ``datatunerx_tpu/utils/storage.py``).

Every dataset, manifest and storage path may be a plain local path or an
fsspec URI (``gs://``, ``s3://``, ``memory://``, ``file://`` …): a
deployment points ``STORAGE_PATH`` at a bucket, and tests use
``memory://``. ``fsspec`` is imported only when a URI is used, and a URI
whose scheme fsspec cannot open raises; it is never written as a local
path. ``s3://`` credentials and endpoint come from the reference's
environment surface (``object_store_options``, a copy of ref
``operator/config.py:34-53``); ``gs://`` relies on the environment's
default credentials.
"""

from __future__ import annotations

import os
import posixpath
from typing import List

_URI_MARK = "://"


def _env(key: str, default: str = "") -> str:
    return os.environ.get(key, default)


def get_s3_endpoint() -> str:
    return _env("S3_ENDPOINT")


def get_s3_access_key() -> str:
    return _env("S3_ACCESSKEYID")


def get_s3_secret_key() -> str:
    return _env("S3_SECRETACCESSKEY")


def get_s3_secure() -> bool:
    return _env("S3_SECURE", "false").lower() in ("true", "1")


def object_store_options(uri: str) -> dict:
    """fsspec storage options for an ``s3://`` URI from ``S3_ENDPOINT``,
    ``S3_ACCESSKEYID``, ``S3_SECRETACCESSKEY`` and ``S3_SECURE``; ``{}``
    for any other scheme."""
    if not uri.startswith("s3://"):
        return {}
    opts: dict = {}
    if get_s3_access_key():
        opts["key"] = get_s3_access_key()
    if get_s3_secret_key():
        opts["secret"] = get_s3_secret_key()
    if get_s3_endpoint():
        scheme = "https" if get_s3_secure() else "http"
        endpoint = get_s3_endpoint()
        if "://" not in endpoint:
            endpoint = f"{scheme}://{endpoint}"
        opts["client_kwargs"] = {"endpoint_url": endpoint}
    return opts


def is_uri(path: str) -> bool:
    return _URI_MARK in str(path)


def join(base: str, *parts: str) -> str:
    """os.path.join for local paths, a posix join for URIs (so a local
    separator never lands in an object key)."""
    if is_uri(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


def _dirname(path: str) -> str:
    return posixpath.dirname(path) if is_uri(path) else os.path.dirname(path)


def _fs(path: str):
    import fsspec

    fs, _, _ = fsspec.get_fs_token_paths(
        path, storage_options=object_store_options(str(path)))
    return fs


def exists(path: str) -> bool:
    if not is_uri(path):
        return os.path.exists(path)
    return _fs(path).exists(path)


def makedirs(path: str) -> None:
    if not is_uri(path):
        os.makedirs(path, exist_ok=True)
        return
    _fs(path).makedirs(path, exist_ok=True)


def open_uri(path: str, mode: str = "r"):
    """Open a local path or URI for reading or writing."""
    if not is_uri(path):
        return open(path, mode,
                    newline="" if "r" in mode and "b" not in mode else None)
    import fsspec

    return fsspec.open(path, mode, **object_store_options(str(path))).open()


def read_text(path: str) -> str:
    with open_uri(path, "r") as f:
        return f.read()


def write_text(path: str, content: str) -> None:
    parent = _dirname(path)
    if parent:
        makedirs(parent)
    with open_uri(path, "w") as f:
        f.write(content)


def listdir(path: str) -> List[str]:
    if not is_uri(path):
        return sorted(os.listdir(path))
    return sorted(posixpath.basename(p.rstrip("/"))
                  for p in _fs(path).ls(path))


def glob(pattern: str) -> List[str]:
    """Paths matching a glob ``pattern`` (a URI pattern's matches come
    back without their scheme, as fsspec gives them)."""
    if not is_uri(pattern):
        import glob as _glob

        return sorted(_glob.glob(pattern))
    return sorted(_fs(pattern).glob(pattern))


def move(src: str, dst: str) -> None:
    """Rename ``src`` to ``dst``: a local rename or fsspec's ``mv`` (a
    rename for ``file://``, a copy then a delete on an object store, where
    the copied object appears whole)."""
    if not is_uri(src):
        os.replace(src, dst)
        return
    _fs(src).mv(src, dst)


def remove_tree(path: str) -> None:
    """Delete a directory (or a URI prefix) and everything under it."""
    if not is_uri(path):
        import shutil

        shutil.rmtree(path)
        return
    _fs(path).rm(path, recursive=True)
