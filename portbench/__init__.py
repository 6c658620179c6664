"""The benchmark of `helmnet_tpu_torch`, the PyTorch and CUDA port, on
NVIDIA H100 cards. `python3 -m portbench.run --help`; README.md."""
