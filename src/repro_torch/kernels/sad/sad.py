"""Wrapper of the CUDA kernel ``csrc/sad_search.cu``: exhaustive block
motion search, ``cur [N, B, B]`` and ``windows [N, B+2R, B+2R]`` f32 ->
``dy, dx [N] int32`` and ``sad [N] f32``.

The wrapper checks what the kernel takes (f32, contiguous, on one CUDA
device, the block and its window within ``MAX_TILE_BYTES``), allocates the
outputs, launches on PyTorch's current stream without synchronising, and
raises if the launch was refused.  Any data pointer is taken: the kernel
stages with 16-byte copies only where both inputs are 16-byte aligned, and
a contiguous view at another offset takes its scalar staging path, with
the same results.  ``LAUNCHES`` counts launches, so a run
can show that its motion search went through the kernel.  The library is
built at first use (see ``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary, LaunchCounter
from repro_torch.kernels.sad.ref import search_geometry

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sad_search.cu"
#: the largest block and window the kernel takes (``kMaxTileBytes`` in the
#: source: 48 KB less 256 B, the first version's limit)
MAX_TILE_BYTES = 48 * 1024 - 256


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.sad_search
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


def sad_search(cur_blocks: torch.Tensor, ref_windows: torch.Tensor):
    """cur_blocks: [N, B, B]; ref_windows: [N, B+2R, B+2R], f32 on one CUDA
    device.  Returns ``(dy, dx, sad)`` there: int32, int32, f32, each
    [N]."""
    for name, x in (("cur_blocks", cur_blocks), ("ref_windows", ref_windows)):
        if x.device.type != "cuda" or x.device != cur_blocks.device:
            raise ValueError(f"sad_search needs both tensors on one CUDA "
                             f"device, got {name} on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"sad_search needs float32, got {name} "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"sad_search needs contiguous tensors; {name} "
                             f"is not")
    n, b, r = search_geometry(cur_blocks, ref_windows)
    w = b + 2 * r
    if (b * b + w * w) * 4 > MAX_TILE_BYTES:
        raise ValueError(f"sad_search: a {b}x{b} block and its {w}x{w} "
                         f"window take {(b * b + w * w) * 4} B of shared "
                         f"memory, more than {MAX_TILE_BYTES}")
    lib = LIBRARY.load()
    dev = cur_blocks.device
    dy = torch.empty(n, dtype=torch.int32, device=dev)
    dx = torch.empty(n, dtype=torch.int32, device=dev)
    sad = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sad_search(cur_blocks.data_ptr(), ref_windows.data_ptr(),
                             dy.data_ptr(), dx.data_ptr(), sad.data_ptr(), n,
                             b, r, stream)
    if err != 0:
        raise RuntimeError(f"sad_search launch failed: CUDA error {err}")
    LAUNCHES.add()
    return dy, dx, sad
