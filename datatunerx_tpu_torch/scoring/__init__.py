"""Scoring helpers of the port (``datatunerx_tpu/scoring``): the text
metrics that generative eval logs."""
