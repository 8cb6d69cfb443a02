"""Plain PyTorch block motion search (sum of absolute differences): the
CUDA kernel's reference and the CPU path.

Same contract as the kernel ``csrc/sad_search.cu``: an exhaustive +-R
search of each current block over its search window, compared in f32.
The (2R+1)^2 candidate SADs are built in row-major ``(dy, dx)`` order and
``torch.argmin`` takes the first minimum, so ties keep the first candidate
in that order, as the kernel's ``(sad, index)`` argmin does.
"""
from __future__ import annotations

import torch


def search_geometry(cur_blocks: torch.Tensor,
                    ref_windows: torch.Tensor) -> tuple[int, int, int]:
    """``(N, B, R)`` of a search, or ValueError where the shapes are not
    ``[N>=1, B, B]`` blocks and ``[N, B+2R, B+2R]`` windows."""
    if cur_blocks.dim() != 3 or ref_windows.dim() != 3:
        raise ValueError(f"sad search needs [N, B, B] blocks and [N, W, W] "
                         f"windows, got {tuple(cur_blocks.shape)} and "
                         f"{tuple(ref_windows.shape)}")
    n, b, b2 = cur_blocks.shape
    nw, w, w2 = ref_windows.shape
    if b != b2 or w != w2:
        raise ValueError(f"sad search needs square blocks and windows, got "
                         f"{tuple(cur_blocks.shape)} and "
                         f"{tuple(ref_windows.shape)}")
    if n < 1 or nw != n or b < 1:
        raise ValueError(f"sad search needs N >= 1 blocks and as many "
                         f"windows, got {n} and {nw}")
    if w < b or (w - b) % 2:
        raise ValueError(f"sad search needs a window of B + 2R >= B, got "
                         f"B={b} and a window of {w}")
    return n, b, (w - b) // 2


def sad_search_ref(cur_blocks: torch.Tensor, ref_windows: torch.Tensor):
    """cur_blocks: [N, B, B]; ref_windows: [N, B+2R, B+2R], any real dtype.

    Returns ``(best_dy [N] int32, best_dx [N] int32, best_sad [N] f32)``
    with displacement in [0, 2R] (subtract R for signed motion)."""
    _, b, r = search_geometry(cur_blocks, ref_windows)
    r2 = 2 * r + 1  # candidate positions per axis
    cur = cur_blocks.to(torch.float32)
    win = ref_windows.to(torch.float32)
    sads = torch.stack([(cur - win[:, dy:dy + b, dx:dx + b]).abs()
                        .sum(dim=(1, 2))
                        for dy in range(r2) for dx in range(r2)], dim=1)
    best = torch.argmin(sads, dim=1)
    return ((best // r2).to(torch.int32), (best % r2).to(torch.int32),
            sads.gather(1, best[:, None])[:, 0])
