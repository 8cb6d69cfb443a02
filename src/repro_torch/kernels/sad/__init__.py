from repro_torch.kernels.sad.ops import frame_motion_blocks, sad_search_op
from repro_torch.kernels.sad.ref import sad_search_ref
from repro_torch.kernels.sad.sad import LAUNCHES, LIBRARY, sad_search

__all__ = ["frame_motion_blocks", "sad_search", "sad_search_op",
           "sad_search_ref", "LAUNCHES", "LIBRARY"]
