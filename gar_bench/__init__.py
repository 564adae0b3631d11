"""The benchmark of the PyTorch and CUDA port (``stylerenderer_tpu_torch``)
on one NVIDIA H100: ``python3 -m gar_bench --workload NAME --seed N
--seconds S --trace 0|1`` (``run.py``)."""
