"""Event reasons (reference pkg/events/events.go:3-6)."""

REASON_FINETUNE_JOB_CREATED = "FinetuneJobCreated"
REASON_FINETUNE_JOB_FAILED = "FinetuneJobFailed"
REASON_CHECKPOINT_CAPTURED = "CheckpointCaptured"
REASON_SERVE_READY = "ServeReady"
REASON_SCORING_COMPLETE = "ScoringComplete"
