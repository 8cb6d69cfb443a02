# Hand-written CUDA kernels for the hot spots the reference runs as Pallas
# TPU kernels: <name>/csrc/*.cu + the wrapper + ops.py + ref.py.
