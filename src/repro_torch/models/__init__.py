from repro_torch.models.api import (CallOpts, decode_step, forward, init_cache,
                                    init_params, prefill)

__all__ = ["CallOpts", "init_params", "forward", "prefill", "decode_step",
           "init_cache"]
