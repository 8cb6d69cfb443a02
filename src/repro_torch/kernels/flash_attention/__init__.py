from repro_torch.kernels.flash_attention.flash import (LAUNCHES, LIBRARY,
                                                       flash_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_op",
           "LAUNCHES", "LIBRARY"]
