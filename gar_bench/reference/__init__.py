"""Plain PyTorch references of what the benchmark's cells run: geometry,
the normal pyramid, the GAR, render inverting. They import nothing of the
program (``stylerenderer_tpu_torch``) and take nothing it made."""
