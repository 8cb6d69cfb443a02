"""The LM side of the port: the models of the zoo (``zoo``), their layers
and attention, and the carry-across of the reference's parameters
(``convert``)."""
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.zoo import (Model, decode_step, encode_frames,
                                    forward, init_cache, init_cache_specs,
                                    init_model, input_specs, logits_fn,
                                    loss_fn)

__all__ = ["Model", "decode_step", "encode_frames", "forward", "init_cache",
           "init_cache_specs", "init_model", "input_specs", "logits_fn",
           "loss_fn", "params_from_numpy"]
