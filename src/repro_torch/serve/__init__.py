"""Serving: continuous-batching NWP decode under live traffic.

* `repro_torch.serve.engine.ServeEngine` — fixed-slot session cache on the
  device, continuous batching over ``model.decode_step``, top-k candidates,
  atomic checkpoint hot-swap.
* `repro_torch.serve.frontend` — `NwpRequest` / `SessionResult` / the queue.
* `repro_torch.serve.reference` — the single-session path the engine must
  match token for token.
* `repro_torch.serve.sampling` — per-session keyed sampling and candidates.
"""
from repro_torch.serve.engine import ServeEngine, validate_cache_layout
from repro_torch.serve.frontend import NwpRequest, RequestQueue, SessionResult
from repro_torch.serve.reference import reference_generate

__all__ = ["ServeEngine", "NwpRequest", "RequestQueue", "SessionResult",
           "reference_generate", "validate_cache_layout"]
