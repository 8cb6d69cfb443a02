from repro_torch.kernels.flash_attention.flash import (LAUNCHES, LIBRARY,
                                                       flash_attention)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    LAUNCHES as BWD_LAUNCHES, LIBRARY as BWD_LIBRARY, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention_lse_op,
                                                     flash_attention_op)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["attention_bwd_ref", "attention_lse_ref", "attention_ref",
           "BWD_LAUNCHES", "BWD_LIBRARY", "FlashAttentionFn",
           "flash_attention", "flash_attention_bwd", "flash_attention_lse_op",
           "flash_attention_op",
           "LAUNCHES", "LIBRARY"]
