"""The experiment apps (counterpart: evo_tpu/apps/): the shared scaffolding,
the epoch-loop trainer, visualizers, the bars test, image denoising and
inpainting, and feature learning."""
