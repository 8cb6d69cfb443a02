from repro_torch.kernels.idct.idct import LAUNCHES, LIBRARY, idct_dequant
from repro_torch.kernels.idct.ops import idct_dequant_op
from repro_torch.kernels.idct.ref import idct_dequant_ref

__all__ = ["idct_dequant", "idct_dequant_op", "idct_dequant_ref",
           "LAUNCHES", "LIBRARY"]
