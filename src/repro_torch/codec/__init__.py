from repro_torch.codec.transform import (dct2_blocks, idct2_blocks, to_blocks,
                                         from_blocks)
from repro_torch.codec.encode import (
    EncoderConfig,
    encode_tile,
    encode_tiles,
    decode_tile,
    encoded_size_bytes,
)
from repro_torch.codec.psnr import psnr
