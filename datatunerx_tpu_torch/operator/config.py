"""Operator environment config (the port of
``datatunerx_tpu/operator/config.py``; reference pkg/config/config.go:7-87,
viper env bindings). The reference's keys, so one deployment's environment
drives either operator; the defaults of the image and the accelerator are
the port's (the CUDA trainer image, an H100 80 GB node pool). S3 creds
become object-store endpoints (GCS or S3-compatible)."""

from __future__ import annotations

import os


def _get(key: str, default: str = "") -> str:
    return os.environ.get(key, default)


def get_s3_endpoint() -> str:
    return _get("S3_ENDPOINT")


def get_s3_access_key() -> str:
    return _get("S3_ACCESSKEYID")


def get_s3_secret_key() -> str:
    return _get("S3_SECRETACCESSKEY")


def get_s3_bucket() -> str:
    return _get("S3_BUCKET")


def get_s3_secure() -> bool:
    return _get("S3_SECURE", "false").lower() in ("true", "1")


def object_store_options(uri: str) -> dict:
    """fsspec storage options for a dataset/checkpoint URI, from the same env
    surface the reference binds via viper (S3_ENDPOINT/S3_ACCESSKEYID/
    S3_SECRETACCESSKEY/S3_SECURE, reference pkg/config/config.go:29-55).
    Consumed by utils/storage when opening s3:// URIs; gs:// relies on
    workload identity / application-default credentials."""
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


def get_registry_url() -> str:
    return _get("REGISTRY_URL")


def get_registry_repo() -> str:
    return _get("REGISTRY_REPOSITORY_NAME")


def get_registry_user() -> str:
    return _get("REGISTRY_USERNAME")


def get_registry_password() -> str:
    return _get("REGISTRY_PASSWORD")


def get_mount_path() -> str:
    return _get("MOUNT_PATH", "/data")


def get_base_image() -> str:
    # the port's trainer image for GPU pods (the reference operator's default
    # is its TPU-host trainer image)
    return _get("BASE_IMAGE", "datatunerx-tpu/trainer-cuda:latest")


def get_default_model_path() -> str:
    return _get("LLM_URL", "/models/llama2-7b")


def get_metrics_export_address() -> str:
    return _get("METRICS_EXPORT_ADDRESS")


def get_storage_path() -> str:
    return _get("STORAGE_PATH", "/storage")


def get_log_level() -> str:
    return _get("LOG_LEVEL", "info")


def get_operator_namespace() -> str:
    """Reference pkg/util/util.go:32-42: serviceaccount namespace file with
    datatunerx-dev fallback."""
    path = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return _get("OPERATOR_NAMESPACE", "datatunerx-dev")


def get_tpu_topology() -> str:
    """The default slice topology for training jobs (the reference's key,
    kept for one environment across both operators)."""
    return _get("TPU_TOPOLOGY", "")


def get_tpu_accelerator() -> str:
    """The node pool's accelerator label (the reference's key; the value
    ``ManifestBackend`` selects GPU nodes by)."""
    return _get("TPU_ACCELERATOR", "nvidia-h100-80gb")
