"""Child-resource generation (reference pkg/util/generate/generate.go).

GenerateFinetune          → Finetune CR from a FinetuneJob spec (generate.go:27-53)
build_trainer_args        → the CLI flag list (replaces getRayJobEntrypoint,
                            finetune_controller.go:451-516; fixes the
                            hardcoded lora_target and trailing-space flag bugs,
                            SURVEY.md §7.5)
generate_training_spec    → backend-agnostic training workload spec
generate_serving_spec     → serving workload (replaces GenerateRayService,
                            generate.go:160-329; no image bake — serving mounts
                            the checkpoint URI directly, SURVEY.md §7.1)
generate_builtin_scoring  → Scoring CR, built-in plugin (generate.go:331-341)
generate_plugin_scoring   → Scoring CR with user plugin (generate.go:343-358)
"""

from __future__ import annotations

import json
import random
import string
from typing import List, Optional

from datatunerx_tpu_torch.operator import config
from datatunerx_tpu_torch.operator.api import (
    Finetune,
    FinetuneJob,
    ObjectMeta,
    Scoring,
)
from datatunerx_tpu_torch.operator.labels import (
    LABEL_FINETUNE_BINDING,
    generate_instance_label,
)
from datatunerx_tpu_torch.operator.store import set_owner

# Hyperparameter CR parameter keys (SURVEY.md §2.3; merge at
# finetune_controller.go:682-758). Values arrive as strings (reference quirk).
PARAMETER_KEYS = (
    "scheduler", "optimizer", "int4", "int8", "loRA_R", "loRA_Alpha",
    "loRA_Dropout", "learningRate", "epochs", "blockSize", "batchSize",
    "warmupRatio", "weightDecay", "gradAccSteps", "trainerType", "PEFT",
    "FP16",
    # additions to the reference CRD
    "meshShape", "loRATarget", "packSequences", "attention",
    "rewardModel",  # --stage ppo: rm-stage run dir under the storage path
    "quantImpl",  # pallas (fused kernels, default) | xla (dequant+dot)
)


def rand_suffix(n: int = 5) -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def generate_finetune(job: FinetuneJob) -> Finetune:
    """Reference generate.go:27-53: embed job.spec.finetune.finetuneSpec,
    defaulting image/path from env config."""
    ft_spec = dict(job.spec.get("finetune", {}).get("finetuneSpec", {}))
    image = dict(ft_spec.get("image", {}))
    if not image.get("name"):
        image["name"] = config.get_base_image()
    if not image.get("path"):
        image["path"] = config.get_default_model_path()
    ft_spec["image"] = image
    ft_spec.setdefault("node", 1)
    name = job.spec.get("finetune", {}).get("name") or f"{job.metadata.name}-finetune"
    ft = Finetune(
        metadata=ObjectMeta(
            name=name,
            namespace=job.metadata.namespace,
            labels={**generate_instance_label(job.metadata.name),
                    LABEL_FINETUNE_BINDING: job.metadata.name},
        ),
        spec=ft_spec,
    )
    set_owner(ft, job)
    return ft


def merge_hyperparameters(base: dict, overrides: Optional[dict]) -> dict:
    """Field-by-field override merge (reference updateHyperparameters,
    finetune_controller.go:682-758): only explicitly-set override fields win."""
    merged = {k: base.get(k) for k in PARAMETER_KEYS if base.get(k) is not None}
    for k, v in (overrides or {}).items():
        if v is not None:
            merged[k] = v
    return merged


def build_trainer_args(
    finetune: Finetune,
    dataset_spec: dict,
    parameters: dict,
    uid: Optional[str] = None,
    num_workers: Optional[int] = None,  # slice placement overrides spec.node
) -> List[str]:
    """The trainer CLI flag list (replaces getRayJobEntrypoint,
    finetune_controller.go:457-514). Same contract, three reference bugs fixed:
    canonical --lora_rank spelling (alias still accepted), lora_target comes
    from parameters instead of being hardcoded, no trailing-space flag."""
    info = dataset_spec.get("datasetMetadata", {}).get("datasetInfo", {})
    subsets = info.get("subsets", [{}])
    splits = subsets[0].get("splits", {}) if subsets else {}

    model_path = finetune.spec.get("image", {}).get("path")
    if not model_path:
        raise ValueError(
            f"{finetune.metadata.namespace}/{finetune.metadata.name}: "
            "finetune.spec.image.path is required"
        )
    args: List[str] = ["--model_name_or_path", model_path]
    train_file = splits.get("train", {}).get("file")
    if not train_file:
        raise ValueError("dataset has no train split file")
    args += ["--train_path", train_file]
    if splits.get("validate", {}).get("file"):
        args += ["--evaluation_path", splits["validate"]["file"]]

    features = info.get("features") or []
    columns = {
        f["mapTo"]: f["name"]
        for f in features
        if f.get("mapTo") and f.get("name") in ("instruction", "response",
                                                "chosen", "rejected")
    }
    if columns:
        import json as _json

        args += ["--columns", _json.dumps(columns)]

    args += ["--output_dir", "result"]
    args += ["--lora_target", parameters.get("loRATarget", "q_proj,v_proj")]
    if parameters.get("scheduler"):
        args += ["--lr_scheduler_type", str(parameters["scheduler"])]
    if parameters.get("optimizer"):
        args += ["--optim", str(parameters["optimizer"]).lower()]

    if _truthy(parameters.get("int8")):
        args += ["--quantization", "int8"]
    elif _truthy(parameters.get("int4")):
        args += ["--quantization", "int4"]

    # trainerType selects the training stage (Hyperparameter CR field the
    # reference carries but never consumes): sft (default) | dpo | rm | ppo
    tt = str(parameters.get("trainerType", "")).lower()
    if tt in ("dpo", "rm", "ppo"):
        args += ["--stage", tt]
    if tt == "ppo" and parameters.get("rewardModel"):
        # an --stage rm run directory (<storage_path>/<uid>)
        args += ["--reward_model", str(parameters["rewardModel"])]

    args += ["--finetuning_type", "lora" if is_peft(parameters) else "full"]
    for flag, key in (
        ("--lora_rank", "loRA_R"),
        ("--lora_alpha", "loRA_Alpha"),
        ("--lora_dropout", "loRA_Dropout"),
        ("--learning_rate", "learningRate"),
        ("--num_train_epochs", "epochs"),
        ("--block_size", "blockSize"),
        ("--per_device_train_batch_size", "batchSize"),
        ("--warmup_ratio", "warmupRatio"),
        ("--weight_decay", "weightDecay"),
        ("--gradient_accumulation_steps", "gradAccSteps"),
    ):
        if parameters.get(key) is not None:
            args += [flag, str(parameters[key])]
    if parameters.get("FP16") is not None:
        args += ["--fp16", str(_truthy(parameters["FP16"])).lower()]
    if parameters.get("meshShape"):
        ms = parameters["meshShape"]
        if isinstance(ms, dict):  # CRD object form {dcn, dp, fsdp, tp, sp}
            ms = ",".join(f"{k}={v}" for k, v in ms.items())
        args += ["--mesh", str(ms)]
    if parameters.get("attention"):
        args += ["--attention", str(parameters["attention"])]
    if parameters.get("quantImpl"):
        args += ["--quant_impl", str(parameters["quantImpl"])]
    if _truthy(parameters.get("packSequences")):
        args += ["--pack_sequences", "true"]

    node = int(finetune.spec.get("node", 1) or 1)
    args += ["--num_workers", str(num_workers or max(node, 1))]
    args += ["--storage_path", config.get_storage_path()]
    if config.get_metrics_export_address():
        args += ["--metrics_export_address", config.get_metrics_export_address()]
    args += ["--uid", uid or finetune.metadata.uid]
    return args


def _truthy(v) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def is_peft(parameters: dict) -> bool:
    """The PEFT truthiness contract (default true, empty string counts as
    set-true — reference quirk). THE single definition: webhooks.py and
    capacity.py admission must model exactly the job this module renders."""
    return str(parameters.get("PEFT", "true")).lower() in ("true", "1", "")


def generate_training_spec(finetune: Finetune, args: List[str],
                           num_hosts: Optional[int] = None) -> dict:
    node = int(finetune.spec.get("node", 1) or 1)
    return {
        "args": args,
        # with slice placement, host count must match the ASSIGNED slice —
        # a multi-host podslice expects exactly its host count of workers
        "num_hosts": num_hosts or max(node, 1),
        "image": finetune.spec.get("image", {}).get("name"),
        "labels": generate_instance_label(finetune.metadata.name),
        "env": {},
    }


def generate_serving_spec(job: FinetuneJob, checkpoint: dict) -> dict:
    """Replaces GenerateRayService (generate.go:160-329). No baked image: the
    server gets the base model path + checkpoint URI directly."""
    serve_cfg = job.spec.get("serveConfig", {}) or {}
    return {
        "model_path": checkpoint.get("llmPath")
        or checkpoint.get("image", {}).get("path")
        or config.get_default_model_path(),
        "checkpoint_path": checkpoint.get("checkpointPath", ""),
        "labels": generate_instance_label(job.metadata.name),
        "node_selector": serve_cfg.get("nodeSelector", {}),
        "tolerations": serve_cfg.get("tolerations", []),
        # serve-time base quantization (serving/engine.py): fit big models on
        # one card's memory; an addition to ServeConfig
        "quantization": serve_cfg.get("quantization", ""),
        # continuous-batching slot count (serving/server.py --slots; 1 =
        # single-request engine); an addition to ServeConfig
        "slots": serve_cfg.get("slots"),
        # dynamic multi-adapter pool (serving --adapter_pool /
        # --adapter_rank_max + /admin/adapters): adapters as runtime data
        "adapter_pool": serve_cfg.get("adapterPool"),
        "adapter_rank_max": serve_cfg.get("adapterRankMax"),
        # multi-replica serving behind the inference gateway
        # (gateway/server.py, replaces the reference's Ray Serve tier):
        # replicas > 1 or gateway=true puts the gateway in front
        "replicas": int(serve_cfg.get("replicas") or 1),
        "gateway": bool(serve_cfg.get("gateway")),
        "policy": serve_cfg.get("policy", "least_busy"),
        "min_replicas": int(serve_cfg.get("minReplicas") or 1),
        "max_replicas": int(serve_cfg.get("maxReplicas")
                            or serve_cfg.get("replicas") or 1),
        # paged-KV overcommit + speculative decoding (serving/server.py
        # --kv_overcommit / --spec_draft_config / --spec_k / --spec_mode)
        "kv_overcommit": serve_cfg.get("kvOvercommit") or "",
        "spec_draft_config": serve_cfg.get("specDraft") or "",
        "spec_k": serve_cfg.get("specK"),
        "spec_mode": serve_cfg.get("specMode") or "",
        "spec_tree": serve_cfg.get("specTree") or "",
        "sampling_epilogue": serve_cfg.get("samplingEpilogue") or "",
        # disaggregated fleet plane (gateway/server.py --role /
        # --prefill_threshold / --fleet_*): replica roles, the shared
        # prefix tier, prefill→decode handoff, peer KV spill
        "role": serve_cfg.get("role") or "",
        "prefill_threshold": serve_cfg.get("prefillThreshold"),
        "fleet_prefix_mb": serve_cfg.get("fleetPrefixMb"),
        "fleet_handoff": bool(serve_cfg.get("fleetHandoff")),
        "fleet_spill": bool(serve_cfg.get("fleetSpill")),
        # multi-tenant QoS plane (datatunerx_tpu/tenancy/): the inline map
        # renders to one --tenants_config JSON argument (camelCase keys
        # mapped onto the directory schema); tenantsConfig is a mounted
        # file path passed through verbatim
        "tenants_config": _tenants_config_from(serve_cfg),
        "host_adapter_cache_mb": serve_cfg.get("hostAdapterCacheMb"),
    }


def _tenants_config_from(serve_cfg: dict) -> str:
    """serveConfig.tenants (inline map) or .tenantsConfig (file path) →
    the one --tenants_config string both servers load."""
    inline = serve_cfg.get("tenants")
    if isinstance(inline, dict) and inline:
        from datatunerx_tpu_torch.tenancy import tenant_entry_from_crd

        return json.dumps({str(n): tenant_entry_from_crd(e)
                           if isinstance(e, dict) else e
                           for n, e in inline.items()},
                          sort_keys=True)
    return serve_cfg.get("tenantsConfig") or ""


def generate_builtin_scoring(job: FinetuneJob, inference_url: str) -> Scoring:
    """Reference generate.go:331-341: plugin-less Scoring CR. Probes may be
    customized per job via spec.scoringProbes [{prompt, reference}]."""
    spec = {
        "inferenceService": inference_url,
        "plugin": {"loadPlugin": False},
    }
    if job.spec.get("scoringProbes"):
        spec["probes"] = job.spec["scoringProbes"]
    # dataset-driven scoring: evaluate over the Dataset CR's test/validate
    # split instead of probes ("auto" = the job's own training dataset)
    ds_ref = job.spec.get("scoringDatasetRef")
    if ds_ref:
        if ds_ref == "auto":
            ds_ref = (job.spec.get("finetune", {})
                      .get("finetuneSpec", {}).get("dataset"))
        spec["datasetRef"] = ds_ref
        if job.spec.get("scoringMetric"):
            spec["metric"] = job.spec["scoringMetric"]
        if job.spec.get("scoringMaxExamples"):
            spec["maxExamples"] = job.spec["scoringMaxExamples"]
    sc = Scoring(
        metadata=ObjectMeta(
            name=job.metadata.name,
            namespace=job.metadata.namespace,
            labels=generate_instance_label(job.metadata.name),
        ),
        spec=spec,
    )
    set_owner(sc, job)
    return sc


def generate_plugin_scoring(job: FinetuneJob, inference_url: str) -> Scoring:
    """Reference generate.go:343-358: user-plugin Scoring CR."""
    cfg = job.spec.get("scoringPluginConfig", {}) or {}
    sc = Scoring(
        metadata=ObjectMeta(
            name=job.metadata.name,
            namespace=job.metadata.namespace,
            labels=generate_instance_label(job.metadata.name),
        ),
        spec={
            "inferenceService": inference_url,
            "plugin": {
                "loadPlugin": True,
                "name": cfg.get("name"),
                "parameters": cfg.get("parameters"),
            },
        },
    )
    set_owner(sc, job)
    return sc
