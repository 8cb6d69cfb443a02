from repro_torch.kernels.dct.dct import LAUNCHES, LIBRARY, dct_quant
from repro_torch.kernels.dct.ops import dct_quant_op
from repro_torch.kernels.dct.ref import dct_quant_ref

__all__ = ["dct_quant", "dct_quant_op", "dct_quant_ref", "LAUNCHES",
           "LIBRARY"]
