"""Hand-written Hopper kernels of the port. Each ``<name>/`` holds the CUDA
source (``csrc/``), its wrapper and its plain PyTorch version (``ref.py``);
``build.py`` compiles the sources with nvcc on first use."""
