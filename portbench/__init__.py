"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by data (``BENCHMARK.json`` at the repository root, and the
configurations, traffic mixes, kinds and per-layer metrics of this
folder), the plain reference that decides ``correct``, and the frozen
yardstick of the roofline shares. Run ``portbench/run.py``."""
