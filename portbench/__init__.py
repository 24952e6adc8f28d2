"""The benchmark of evo_tpu_torch (``python3 portbench/run.py``; see run.py)."""
