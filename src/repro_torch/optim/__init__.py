"""Optimizer substrate: AdamW, schedules, accumulation, compression (the
port of ``repro.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule
from .grad_compress import (compress_int8, decompress_int8,
                            compressed_psum_cb)
from .accumulation import accumulate_grads

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_int8", "decompress_int8", "compressed_psum_cb",
           "accumulate_grads"]
