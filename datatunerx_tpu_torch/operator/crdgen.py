"""CRD + webhook-configuration manifest rendering for the 8 kinds (the port's
copy of ``datatunerx_tpu/operator/crdgen.py``: the CRs are one API, so the
CRDs are the reference's).

The reference gets its CRDs from `make manifests` (controller-gen over the
meta-server Go types, reference Makefile:96-113); here the source of truth is
operator/api.py + the webhook validation rules, rendered as
apiextensions.k8s.io/v1 CustomResourceDefinitions with the status subresource
enabled (the split KubeObjectStore.update relies on).

Lives in the package so `dtx-torch install` can render a complete install
bundle without a repo checkout.
"""

from __future__ import annotations

from datatunerx_tpu_torch.operator.api import ALL_KINDS
from datatunerx_tpu_torch.operator.webhooks import OPTIMIZERS, SCHEDULERS

ANY = {"x-kubernetes-preserve-unknown-fields": True}
STR = {"type": "string"}
INT = {"type": "integer"}
BOOL = {"type": "boolean"}


def obj(props: dict, required=None, open_ended=True) -> dict:
    d: dict = {"type": "object", "properties": props}
    if required:
        d["required"] = list(required)
    if open_ended:
        # forward-compatible: extra fields tolerated (the admission webhook
        # enforces the strict rules)
        d["x-kubernetes-preserve-unknown-fields"] = True
    return d


def arr(items: dict) -> dict:
    return {"type": "array", "items": items}


HYPERPARAMETERS = obj({
    "scheduler": {"type": "string", "enum": sorted(SCHEDULERS)},
    "optimizer": {"type": "string", "enum": sorted(OPTIMIZERS)},
    "int4": STR, "int8": STR,
    "loRA_R": STR, "loRA_Alpha": STR, "loRA_Dropout": STR,
    "learningRate": STR, "epochs": STR, "blockSize": STR, "batchSize": STR,
    "warmupRatio": STR, "weightDecay": STR, "gradAccSteps": STR,
    "trainerType": STR, "PEFT": STR, "FP16": STR,
    # TPU additions (SURVEY.md §7.1 Hyperparameter row)
    "topology": STR,
    # CLOSED node (open_ended=False): the SPMD driver consumes exactly these
    # axes (tuning/train.py:149-157) — unknown keys here are typos that
    # would silently change the mesh, so the apiserver prunes them
    "meshShape": obj({"dcn": INT, "dp": INT, "fsdp": INT, "tp": INT,
                      "sp": INT}, open_ended=False),
    "packSequences": STR,
    "loRATarget": STR, "attention": STR,
    "rewardModel": STR,  # trainerType ppo: rm-stage run dir
    "quantImpl": {"type": "string", "enum": ["pallas", "xla"]},
})

FINETUNE_SPEC = obj({
    "dataset": STR,
    "llm": STR,
    "hyperparameter": obj({
        "hyperparameterRef": STR,
        "overrides": HYPERPARAMETERS,
    }),
    "image": obj({"name": STR, "path": STR, "imagePullPolicy": STR}),
    "node": INT,
    "resource": ANY,
    "backoffLimit": INT,
}, required=["dataset", "llm"])

SPECS = {
    "Finetune": FINETUNE_SPEC,
    "FinetuneJob": obj({
        "finetune": obj({"name": STR, "finetuneSpec": FINETUNE_SPEC},
                        required=["finetuneSpec"]),
        "scoringPluginConfig": obj({"name": STR, "parameters": STR}),
        "serveConfig": obj({
            "nodeSelector": ANY, "tolerations": arr(ANY),
            # TPU additions (generate.py generate_serving_spec)
            "quantization": {"type": "string",
                             "enum": ["", "int8", "int4", "nf4"]},
            "slots": INT,
            # dynamic multi-adapter plane (serving --adapter_pool /
            # --adapter_rank_max): N HBM pool slots tenant adapters load
            # into at runtime via /admin/adapters, rank-padded to the max
            "adapterPool": INT,
            "adapterRankMax": INT,
            # gateway tier (gateway/server.py): N replicas behind one
            # endpoint with routing/admission/failover; min/max bound the
            # autoscale hint the controller applies
            "replicas": INT,
            "gateway": BOOL,
            "policy": {"type": "string",
                       "enum": ["least_busy", "round_robin"]},
            "minReplicas": INT,
            "maxReplicas": INT,
            # paged-KV overcommit (serving --kv_overcommit): admission by
            # prompt-need + headroom, on-demand growth, preempt-and-park
            "kvOvercommit": {"type": "string", "enum": ["", "off", "on"]},
            # speculative decoding (serving --spec_draft_config/--spec_k/
            # --spec_mode): draft-propose / verify-k decode
            "specDraft": STR,
            "specK": INT,
            "specMode": {"type": "string",
                         "enum": ["", "auto", "on", "off"]},
            # tree-draft verification (serving --spec_tree): 'WxD' flattens
            # a W-wide, D-deep token tree into one batched verify forward
            "specTree": STR,
            # fused on-chip sampling epilogue (serving --sampling_epilogue):
            # decode programs sample in the traced computation instead of
            # materializing full-vocab logits for the host sampler
            "samplingEpilogue": {"type": "string",
                                 "enum": ["", "auto", "on", "off"]},
            # disaggregated fleet plane (gateway/server.py): role is a
            # single role for one server or a comma cycle the gateway
            # assigns across spawned replicas; prompts >= the threshold
            # prefer prefill specialists; the fleet knobs enable the
            # shared prefix tier / prefill→decode handoff / peer KV spill
            "role": STR,
            "prefillThreshold": INT,
            "fleetPrefixMb": {"type": "number"},
            "fleetHandoff": BOOL,
            "fleetSpill": BOOL,
            # multi-tenant QoS plane (datatunerx_tpu/tenancy/): tenants is
            # an inline tenant -> {tier, adapters, share, kvBlockQuota,
            # ttftP95Ms} map (webhook-validated) or tenantsConfig a file
            # path mounted into the pod; hostAdapterCacheMb bounds the
            # host-RAM adapter tier evicted pool adapters fall back to
            "tenants": ANY,
            "tenantsConfig": STR,
            "hostAdapterCacheMb": {"type": "number"},
        }),
    }, required=["finetune"]),
    "FinetuneExperiment": obj({
        "finetuneJobs": arr(obj({"name": STR, "spec": ANY})),
        "pending": BOOL,
    }, required=["finetuneJobs"]),
    "LLM": obj({"path": STR, "image": ANY}),
    "Hyperparameter": obj({"parameters": HYPERPARAMETERS}),
    "LLMCheckpoint": obj({
        "llm": ANY, "dataset": ANY, "hyperparameter": ANY,
        "image": ANY, "checkpoint": STR, "checkpointImage": ANY,
        "metrics": ANY,
    }),
    "Dataset": obj({
        "datasetMetadata": obj({
            "datasetInfo": obj({
                "subsets": arr(obj({
                    "name": STR,
                    "splits": obj({
                        "train": obj({"file": STR}),
                        "validate": obj({"file": STR}),
                        "test": obj({"file": STR}),
                    }),
                })),
                "features": arr(obj({"name": STR, "mapTo": STR})),
            }),
        }),
    }, required=["datasetMetadata"]),
    "Scoring": obj({
        "inferenceService": STR,
        # named adapter on a multi-adapter engine: N Scorings against ONE
        # endpoint compare N tuned checkpoints side-by-side (BASELINE row 6)
        "model": STR,
        "plugin": obj({"loadPlugin": BOOL, "name": STR, "parameters": STR}),
        # closed: the scorer consumes exactly prompt/reference per probe
        "probes": arr(obj({"prompt": STR, "reference": STR},
                          open_ended=False)),
        # dataset-driven scoring (beyond the reference's probe-only sibling)
        "datasetRef": STR,
        "metric": {"type": "string", "enum": ["generation", "perplexity"]},
        "maxExamples": INT,
    }),
}


def crd_for(cls) -> dict:
    group, _, version = cls.api_version.partition("/")
    plural = cls.kind.lower() + "s"
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": {
                "kind": cls.kind,
                "listKind": f"{cls.kind}List",
                "plural": plural,
                "singular": cls.kind.lower(),
            },
            "scope": "Namespaced",
            "versions": [{
                "name": version,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "schema": {
                    "openAPIV3Schema": {
                        "type": "object",
                        "properties": {
                            "spec": SPECS[cls.kind],
                            "status": ANY,
                        },
                    },
                },
                "additionalPrinterColumns": [{
                    "name": "State",
                    "type": "string",
                    "jsonPath": ".status.state",
                }],
            }],
        },
    }


def all_crds() -> list:
    return [crd_for(cls) for cls in ALL_KINDS]


def webhook_manifests(namespace: str = "datatunerx-dev") -> list:
    """Deploy-time Mutating/ValidatingWebhookConfiguration manifests
    (service-style clientConfig; the operator's cert manager injects the
    caBundle at startup — reference cert-rotator behavior,
    controller_manager.go:83-111). The test/dev path installs url-style
    configs directly via operator.webhook_server.install_webhooks."""
    from datatunerx_tpu_torch.operator.webhook_server import webhook_configurations

    configs = webhook_configurations(ca_bundle_b64="", base_url="")
    for cfg in configs:
        for wh in cfg["webhooks"]:
            path = wh["clientConfig"]["url"].rsplit("/", 1)[-1]
            wh["clientConfig"] = {
                "service": {
                    "name": "datatunerx-webhook-service",
                    "namespace": namespace,
                    "path": f"/{path}",
                    "port": 9443,
                },
                "caBundle": "",  # injected by the operator at startup
            }
    return configs
