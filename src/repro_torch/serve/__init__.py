"""Serving subsystem of the port: continuous-batching ensemble inference
over trained DML populations, on the card."""
from repro_torch.serve.cache import batch_axis, init_arena, write_slot
from repro_torch.serve.engine import MODES, ServeEngine
from repro_torch.serve.ensemble import (combine_logits, load_serving_params,
                                        make_router, prompt_ce,
                                        prompt_ce_clients)
from repro_torch.serve.scheduler import Request, SlotScheduler

__all__ = [
    "MODES", "ServeEngine", "SlotScheduler", "Request",
    "batch_axis", "init_arena", "write_slot",
    "combine_logits", "load_serving_params", "make_router", "prompt_ce",
    "prompt_ce_clients",
]
