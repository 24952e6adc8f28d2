"""Logging tables, tracing, checkpoints and the bars dictionary
(counterpart: evo_tpu/utils/)."""
