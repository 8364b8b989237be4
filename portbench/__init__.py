"""The benchmark of m4ri_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards.  ``run.py`` runs one cell once; README.md says how the parts
are found by name."""
