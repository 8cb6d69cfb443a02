"""Public entry of the SAD motion-search kernel, and the frame-level host
helper.

A tensor on a CUDA device goes to the CUDA kernel (``sad.py``), cast to
f32; a tensor on the CPU goes to the plain PyTorch version (``ref.py``).
Nothing falls back from one to the other.  The reference pads N to a
multiple of its Pallas block only for the TPU grid; a CUDA launch has no
per-shape compile, so N is used as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sad.ref import sad_search_ref
from repro_torch.kernels.sad.sad import sad_search


def sad_search_op(cur_blocks: torch.Tensor, ref_windows: torch.Tensor):
    """cur_blocks: [N, B, B]; ref_windows: [N, B+2R, B+2R] -> ``(dy, dx,
    sad)``, int32, int32, f32, each [N], on the tensors' device."""
    if cur_blocks.device.type == "cuda":
        return sad_search(cur_blocks.to(torch.float32).contiguous(),
                          ref_windows.to(torch.float32).contiguous())
    if cur_blocks.device.type != "cpu":
        raise ValueError(f"sad_search_op runs on cuda or cpu, got "
                         f"{cur_blocks.device}")
    return sad_search_ref(cur_blocks, ref_windows)


def frame_motion_blocks(cur: np.ndarray, ref: np.ndarray, *, b: int = 16,
                        r: int = 8):
    """Host helper: cut a frame into blocks + padded search windows."""
    H, W = cur.shape
    assert H % b == 0 and W % b == 0
    ref_pad = np.pad(ref, r, mode="edge")
    blocks, windows = [], []
    for y in range(0, H, b):
        for x in range(0, W, b):
            blocks.append(cur[y:y + b, x:x + b])
            windows.append(ref_pad[y:y + b + 2 * r, x:x + b + 2 * r])
    return np.stack(blocks), np.stack(windows)
