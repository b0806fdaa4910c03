"""Admission webhooks: validation + defaulting for the 5 webhook-registered
kinds (reference cmd/controller-manager/app/controller_manager.go:114-134
registers FinetuneJob, FinetuneExperiment, LLM, Hyperparameter, Dataset; the
validate/default bodies live in the unvendored meta-server module, so rules
here are re-derived from field semantics, SURVEY.md §2.3 + parser asserts,
cmd/tuning/parser.py:211-221).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from datatunerx_tpu_torch.operator.api import (
    CustomResource,
    Dataset,
    FinetuneExperiment,
    FinetuneJob,
    Hyperparameter,
    LLM,
    Scoring,
)

SCHEDULERS = ("cosine", "linear", "constant", "constant_with_warmup",
              "cosine_with_restarts", "polynomial")
OPTIMIZERS = ("adamw", "adam", "sgd", "adafactor", "lion")
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj")


class AdmissionError(Exception):
    pass


def _require(cond: bool, msg: str):
    if not cond:
        raise AdmissionError(msg)


# ------------------------------------------------------------- validators

def validate_hyperparameter(obj: CustomResource):
    p = obj.spec.get("parameters", {})
    _require(isinstance(p, dict), "spec.parameters must be an object")
    if p.get("scheduler"):
        _require(str(p["scheduler"]).lower() in SCHEDULERS,
                 f"scheduler must be one of {SCHEDULERS}")
    if p.get("optimizer"):
        _require(str(p["optimizer"]).lower() in OPTIMIZERS,
                 f"optimizer must be one of {OPTIMIZERS}")
    _require(not (_truthy(p.get("int4")) and _truthy(p.get("int8"))),
             "int4 and int8 are mutually exclusive")
    for key, lo, hi in (("loRA_Dropout", 0.0, 1.0), ("warmupRatio", 0.0, 1.0)):
        if p.get(key) is not None:
            v = _num(p[key], key)
            _require(lo <= v <= hi, f"{key} must be in [{lo}, {hi}]")
    for key in ("loRA_R", "epochs", "blockSize", "batchSize", "gradAccSteps"):
        if p.get(key) is not None:
            v = _num(p[key], key)
            _require(v > 0, f"{key} must be positive")
    if p.get("learningRate") is not None:
        _require(_num(p["learningRate"], "learningRate") > 0,
                 "learningRate must be positive")
    if p.get("loRATarget"):
        for t in str(p["loRATarget"]).split(","):
            _require(t.strip() in LORA_TARGETS,
                     f"invalid lora target {t.strip()!r}")
    if p.get("trainerType"):
        tt = str(p["trainerType"]).lower()
        _require(tt in ("sft", "dpo", "rm", "ppo"),
                 "trainerType must be sft, dpo, rm, or ppo")
        if tt == "ppo":
            _require(bool(p.get("rewardModel")),
                     "trainerType ppo requires parameters.rewardModel (an "
                     "rm-stage run directory under the storage path)")
        if tt in ("dpo", "rm", "ppo"):
            # catch the unrunnable combo at admission, not after the JobSet
            # burned its retries: DPO needs the LoRA policy/reference trick,
            # RM keeps the reward model a frozen-base adapter + value head.
            from datatunerx_tpu_torch.operator.generate import is_peft

            _require(is_peft(p),
                     f"trainerType {tt} requires PEFT (LoRA) — the frozen "
                     "base serves as DPO reference policy / RM backbone")


def validate_dataset(obj: CustomResource):
    info = obj.spec.get("datasetMetadata", {}).get("datasetInfo", {})
    subsets = info.get("subsets")
    _require(bool(subsets), "datasetInfo.subsets must not be empty")
    train = subsets[0].get("splits", {}).get("train", {})
    _require(bool(train.get("file")), "subsets[0].splits.train.file is required")
    for f in info.get("features", []) or []:
        _require(f.get("name") in ("instruction", "response",
                                   "chosen", "rejected"),
                 "feature name must be one of instruction/response (SFT) "
                 "or chosen/rejected (DPO preference datasets)")
        _require(bool(f.get("mapTo")), "feature mapTo is required")


def validate_llm(obj: CustomResource):
    _require(bool(obj.metadata.name), "llm name required")


def validate_finetunejob(obj: CustomResource):
    ft = obj.spec.get("finetune", {})
    _require(isinstance(ft, dict) and bool(ft.get("finetuneSpec")),
             "spec.finetune.finetuneSpec is required")
    spec = ft["finetuneSpec"]
    for key in ("llm", "dataset"):
        _require(bool(spec.get(key)), f"finetuneSpec.{key} is required")
    _require(bool((spec.get("hyperparameter") or {}).get("hyperparameterRef")),
             "finetuneSpec.hyperparameter.hyperparameterRef is required")
    node = spec.get("node", 1)
    _require(int(node) >= 1, "finetuneSpec.node must be >= 1")
    plugin = obj.spec.get("scoringPluginConfig")
    if plugin and plugin.get("name") is not None:
        _require(bool(str(plugin["name"]).strip()),
                 "scoringPluginConfig.name must be non-empty when set")
    _validate_probes(obj.spec.get("scoringProbes"))
    _validate_serve_config(obj.spec.get("serveConfig") or {})


def _validate_serve_config(cfg: dict):
    _require(isinstance(cfg, dict), "serveConfig must be an object")
    for key in ("replicas", "minReplicas", "maxReplicas", "slots",
                "adapterPool", "adapterRankMax"):
        if cfg.get(key) is not None:
            v = _num(cfg[key], f"serveConfig.{key}")
            _require(v >= 1 and float(v).is_integer(),
                     f"serveConfig.{key} must be a positive integer")
    if cfg.get("adapterRankMax") is not None:
        _require(cfg.get("adapterPool") is not None,
                 "serveConfig.adapterRankMax requires adapterPool (the "
                 "rank ceiling only shapes a dynamic pool)")
    lo = int(float(cfg.get("minReplicas", 1) or 1))
    hi = cfg.get("maxReplicas")
    if hi is not None:
        _require(int(float(hi)) >= lo,
                 "serveConfig.maxReplicas must be >= minReplicas")
    if cfg.get("policy") is not None:
        _require(str(cfg["policy"]) in ("least_busy", "round_robin"),
                 "serveConfig.policy must be least_busy or round_robin")
    if cfg.get("kvOvercommit") not in (None, ""):
        _require(str(cfg["kvOvercommit"]) in ("off", "on"),
                 "serveConfig.kvOvercommit must be off or on")
    if cfg.get("specMode") not in (None, ""):
        _require(str(cfg["specMode"]) in ("auto", "on", "off"),
                 "serveConfig.specMode must be auto, on, or off")
    if cfg.get("samplingEpilogue") not in (None, ""):
        _require(str(cfg["samplingEpilogue"]) in ("auto", "on", "off"),
                 "serveConfig.samplingEpilogue must be auto, on, or off")
    if cfg.get("specTree") not in (None, ""):
        # validated here (not just at engine start) so a bad tree spec is
        # refused at admission instead of crash-looping replicas. Format
        # mirrors serving.speculative.parse_spec_tree — kept dependency-
        # free: admission imports no serving module.
        _require(cfg.get("specDraft") not in (None, ""),
                 "serveConfig.specTree requires specDraft (tree drafts "
                 "are proposed by the draft model)")
        parts = str(cfg["specTree"]).lower().split("x")
        ok = (len(parts) == 2 and parts[0].strip().isdigit()
              and parts[1].strip().isdigit())
        _require(ok, "serveConfig.specTree must be 'WxD' (branch width x "
                     "draft depth, e.g. '4x3')")
        w, d = int(parts[0]), int(parts[1])
        _require(1 <= w <= 64 and 1 <= d <= 16,
                 "serveConfig.specTree width must be 1..64 and depth "
                 "1..16")
    for key in ("specK", "prefillThreshold"):
        if cfg.get(key) is not None:
            v = _num(cfg[key], f"serveConfig.{key}")
            _require(v >= 1 and float(v).is_integer(),
                     f"serveConfig.{key} must be a positive integer")
    if cfg.get("fleetPrefixMb") is not None:
        _require(_num(cfg["fleetPrefixMb"],
                      "serveConfig.fleetPrefixMb") > 0,
                 "serveConfig.fleetPrefixMb must be > 0")
    if cfg.get("role") not in (None, ""):
        roles = [r.strip() for r in str(cfg["role"]).split(",") if r.strip()]
        _require(bool(roles), "serveConfig.role must name at least one role")
        for r in roles:
            _require(r in ("prefill", "decode", "mixed"),
                     "serveConfig.role entries must be prefill, decode, "
                     "or mixed")
        gateway = bool(cfg.get("gateway")) or \
            int(float(cfg.get("replicas") or 1)) > 1
        _require(len(roles) == 1 or gateway,
                 "serveConfig.role cycles need the gateway (replicas > 1 "
                 "or gateway=true) to distribute them")
    tenants = cfg.get("tenants")
    if tenants is not None:
        from datatunerx_tpu_torch.tenancy import (
            tenant_entry_from_crd,
            validate_tenant_entry,
        )

        _require(isinstance(tenants, dict) and bool(tenants),
                 "serveConfig.tenants must be a non-empty object mapping "
                 "tenant name to its policy")
        _require(cfg.get("tenantsConfig") in (None, ""),
                 "serveConfig.tenants and tenantsConfig are mutually "
                 "exclusive (inline map or mounted file, not both)")
        for name, entry in tenants.items():
            entry = (tenant_entry_from_crd(entry)
                     if isinstance(entry, dict) else entry)
            try:
                validate_tenant_entry(str(name), entry)
            except ValueError as e:
                _require(False, f"serveConfig.tenants: {e}")
    if cfg.get("hostAdapterCacheMb") is not None:
        _require(_num(cfg["hostAdapterCacheMb"],
                      "serveConfig.hostAdapterCacheMb") >= 0,
                 "serveConfig.hostAdapterCacheMb must be >= 0")


def validate_finetuneexperiment(obj: CustomResource):
    jobs = obj.spec.get("finetuneJobs")
    _require(bool(jobs), "spec.finetuneJobs must not be empty")
    names = [j.get("name") for j in jobs]
    _require(all(names), "every finetuneJobs entry needs a name")
    _require(len(set(names)) == len(names), "finetuneJobs names must be unique")
    for j in jobs:
        shim = FinetuneJob(metadata=obj.metadata, spec=j.get("spec", {}))
        validate_finetunejob(shim)


# -------------------------------------------------------------- defaulters

def default_finetunejob(obj: CustomResource):
    spec = obj.spec.setdefault("finetune", {}).setdefault("finetuneSpec", {})
    spec.setdefault("node", 1)
    serve = obj.spec.setdefault("serveConfig", {})
    # gateway-tier defaults: single replica unless asked; asking for
    # replicas > 1 implies the gateway fronts them
    serve.setdefault("replicas", 1)
    if int(float(serve.get("replicas") or 1)) > 1:
        serve.setdefault("gateway", True)
    if serve.get("gateway"):
        serve.setdefault("policy", "least_busy")
        serve.setdefault("minReplicas", 1)
        serve.setdefault("maxReplicas",
                         max(int(float(serve.get("replicas") or 1)), 1))


def default_hyperparameter(obj: CustomResource):
    p = obj.spec.setdefault("parameters", {})
    p.setdefault("scheduler", "cosine")
    p.setdefault("optimizer", "adamw")
    p.setdefault("loRA_R", "8")
    p.setdefault("loRA_Alpha", "32")
    p.setdefault("loRA_Dropout", "0.1")
    p.setdefault("learningRate", "2e-4")
    p.setdefault("epochs", "1")
    p.setdefault("blockSize", "1024")
    p.setdefault("batchSize", "4")
    p.setdefault("gradAccSteps", "1")
    p.setdefault("PEFT", "true")


def _validate_probes(probes):
    if probes is None:
        return
    _require(isinstance(probes, list) and probes,
             "scoring probes must be a non-empty list")
    for pr in probes:
        _require(isinstance(pr, dict)
                 and isinstance(pr.get("prompt"), str) and pr["prompt"]
                 and isinstance(pr.get("reference"), str) and pr["reference"],
                 "each scoring probe needs non-empty 'prompt' and 'reference'")


def validate_scoring(obj: CustomResource):
    _require(bool(obj.spec.get("inferenceService")),
             "spec.inferenceService is required")
    _validate_probes(obj.spec.get("probes"))


VALIDATORS: Dict[str, Callable] = {
    Hyperparameter.kind: validate_hyperparameter,
    Dataset.kind: validate_dataset,
    LLM.kind: validate_llm,
    FinetuneJob.kind: validate_finetunejob,
    FinetuneExperiment.kind: validate_finetuneexperiment,
    Scoring.kind: validate_scoring,
}
DEFAULTERS: Dict[str, Callable] = {
    FinetuneJob.kind: default_finetunejob,
    Hyperparameter.kind: default_hyperparameter,
}


def admit(obj: CustomResource) -> CustomResource:
    """Defaulting then validation — raises AdmissionError on rejection."""
    defaulter = DEFAULTERS.get(obj.kind)
    if defaulter:
        defaulter(obj)
    validator = VALIDATORS.get(obj.kind)
    if validator:
        validator(obj)
    return obj


class AdmittingStore:
    """Store wrapper applying admission on create/update (webhook-equivalent
    choke point, since there is no API server in front)."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def create(self, obj):
        return self._store.create(admit(obj))

    def update(self, obj):
        admit(obj)
        return self._store.update(obj)


def _truthy(v) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def _num(v, key: str) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        raise AdmissionError(f"{key} must be numeric, got {v!r}")
