"""PyTorch/CUDA port of the TASM tile-based storage manager.

Mirrors the layout of the JAX reference package ``repro`` (``codec/``,
``core/``, ``kernels/``, ``data/``) and shares none of its code: the
framework-free modules are copies, and the decode kernel on the scan path
is a hand-written CUDA kernel for Hopper (``kernels/decode/csrc``).  Scans
decode on the CUDA device unless ``DecodeConfig(device="cpu")`` is passed.
"""
