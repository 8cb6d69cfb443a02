"""Public wrapper of the batched multi-tile decode, with the shared
power-of-two size bucketing.

Every block-count-shaped entry point pads its stream length to
:func:`pad_bucket` — the next power of two — so the number of distinct
stream shapes grows logarithmically with the largest batch ever seen
instead of linearly with every distinct tile layout.  Callers that assemble
the stream themselves (``codec.batch``) allocate at the bucket size directly
so padding costs nothing.

A tensor on a CUDA device goes to the CUDA kernel (``decode.py``); a tensor
on the CPU goes to the plain PyTorch version (``ref.py``).  Nothing falls
back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode.decode import decode_gop_blocks
from repro_torch.kernels.decode.ref import decode_fused_ref

#: floor for the padded column count — tiny batches share one bucket
MIN_COLUMNS = 64


def pad_bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo): the shared size bucket.

    Padding every variable block/column count up to a bucket keeps the
    number of distinct stream shapes bounded (one per octave) no matter how
    many distinct tile shapes a workload produces."""
    if n <= lo:
        return lo
    return 1 << (int(n) - 1).bit_length()


def resolve_device(device) -> torch.device:
    """The decode device; raises if it names a CUDA device this process
    cannot reach (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"decode device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to decode on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"decode device must be cuda or cpu, got {dev}")
    return dev


def decode_fused_op(q: torch.Tensor, *, qp: int) -> torch.Tensor:
    """[F, M, 8, 8] int16 -> [F, M, 8, 8] f32 reconstructed frames, on
    ``q``'s device.

    Row 0 is dequantized with the intra matrix, rows 1+ with the inter
    matrix, each block IDCT'd, then summed cumulatively over F (the
    closed-loop GOP reconstruction).

    M is padded to :func:`pad_bucket` columns (zero coefficients decode to
    zero pixels, sliced off before return), F is used as-is — callers
    bucket it (``codec.batch`` pads GOP depth with trailing zero-coefficient
    frames, which never perturb the leading cumulative sums).
    """
    m = q.shape[1]
    mp = pad_bucket(m, lo=MIN_COLUMNS)
    if mp != m:
        q = torch.cat(
            [q, q.new_zeros((q.shape[0], mp - m, 8, 8))], dim=1)
    if q.device.type == "cuda":
        out = decode_gop_blocks(q.contiguous(), qp)
    else:
        out = decode_fused_ref(q, qp)
    return out[:, :m]
