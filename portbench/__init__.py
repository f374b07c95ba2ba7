"""The benchmark of the PyTorch/CUDA port (fissure_segmentation_tpu_torch):
one command runs one cell of BENCHMARK.json once (portbench/run.py);
README.md says how cells, configurations, traffic mixes and metrics are
added as files."""
