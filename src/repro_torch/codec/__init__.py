from repro_torch.codec.encode import (
    EncoderConfig,
    encode_tile,
    decode_tile,
    encoded_size_bytes,
)
