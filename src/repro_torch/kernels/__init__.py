"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (`ref.py`). CUDA sources live in `csrc/` and are built
at first use by `build.py`."""
