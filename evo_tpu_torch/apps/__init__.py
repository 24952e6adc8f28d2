"""The experiment apps (counterpart: evo_tpu/apps/): the shared scaffolding,
the epoch-loop trainer, visualizers and the bars test."""
