# Hand-written CUDA kernels for the hot spots the reference runs as Pallas
# TPU kernels: <name>/csrc/*.cu + the wrapper + ops.py + ref.py, built by
# build.py at first use.
from repro_torch.kernels.dct import dct_quant_op, dct_quant_ref
from repro_torch.kernels.decode import decode_fused_op, decode_fused_ref
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_op)
from repro_torch.kernels.idct import idct_dequant_op, idct_dequant_ref
from repro_torch.kernels.sad import (frame_motion_blocks, sad_search_op,
                                     sad_search_ref)

__all__ = ["attention_ref", "dct_quant_op", "dct_quant_ref",
           "decode_fused_op", "decode_fused_ref", "flash_attention_op",
           "frame_motion_blocks", "idct_dequant_op", "idct_dequant_ref",
           "sad_search_op", "sad_search_ref"]
