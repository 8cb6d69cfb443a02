from repro_torch.kernels.decode.decode import LAUNCHES, decode_gop_blocks
from repro_torch.kernels.decode.ops import (MIN_COLUMNS, decode_fused_op,
                                            pad_bucket, resolve_device)
from repro_torch.kernels.decode.ref import decode_fused_ref

__all__ = ["decode_fused_op", "decode_fused_ref", "decode_gop_blocks",
           "pad_bucket", "resolve_device", "LAUNCHES", "MIN_COLUMNS"]
