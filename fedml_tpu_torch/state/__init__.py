"""Client-state subsystem (the port's counterpart of ``fedml_tpu/state``):
``store``, the sharded disk-backed per-client state store with an LRU
host-RAM cache (its persistent-field path), and ``residuals``, the cross-silo EF-residual history on
it. The JAX package's virtual populations (``population.py``) are not
ported yet (ROADMAP Queue 1, item 23)."""

from fedml_tpu_torch.state.residuals import (LegacyResidualLayout,
                                             SiloResidualStore)
from fedml_tpu_torch.state.store import (DEFAULT_CACHE_CLIENTS,
                                         DEFAULT_SHARD_CLIENTS,
                                         ClientStateStore, StoreFlusher)

__all__ = [
    "ClientStateStore", "DEFAULT_CACHE_CLIENTS", "DEFAULT_SHARD_CLIENTS",
    "LegacyResidualLayout", "SiloResidualStore", "StoreFlusher",
]
