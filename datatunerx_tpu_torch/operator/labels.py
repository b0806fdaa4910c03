"""Well-known labels (reference pkg/util/label/label.go:3-35)."""

LABEL_INSTANCE = "finetune.datatunerx.io/instance"
LABEL_COMPONENT = "finetune.datatunerx.io/component"
LABEL_PART_OF = "finetune.datatunerx.io/part-of"
LABEL_FINETUNE_BINDING = "finetune.datatunerx.io/finetunebinding"


def generate_instance_label(name: str) -> dict:
    return {LABEL_INSTANCE: name}


def generate_component_label(component: str) -> dict:
    return {LABEL_COMPONENT: component}
