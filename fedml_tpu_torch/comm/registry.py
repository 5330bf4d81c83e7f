"""Backend selection by string: the reference's ``--backend MPI|GRPC|MQTT``
switch (client_manager.py:22-35); the port's copy of
``fedml_tpu/comm/registry.py``.

The port runs the in-process router ("INPROC", and "MPI", which the JAX
package maps to it on one host). The socket transports raise and name
their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter

#: backends of the JAX package that the port does not run yet
NOT_PORTED = {
    "TCP": "the TCP transport with reliable.py",
    "GRPC": "the gRPC transport with reliable.py",
    "GRPC_PROTO": "the gRPC transport with reliable.py",
    "MQTT": "the MQTT transport",
    "ROUTED": "the routed broker transport",
    "BROKER": "the routed broker transport",
}


def create_comm_manager(backend: str, rank: int, size: int,
                        router: Optional[InProcRouter] = None
                        ) -> BaseCommunicationManager:
    """``backend``: "INPROC" (or its alias "MPI"): ranks are threads of
    one process over a shared :class:`InProcRouter`."""
    key = backend.upper()
    if key in ("INPROC", "MPI"):
        if router is None:
            raise ValueError("INPROC backend needs a shared InProcRouter")
        return InProcCommManager(router, rank, size)
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} ({NOT_PORTED[key]}) is not ported yet: "
            "ROADMAP Queue 1, Slice D item 22b (transports)")
    raise ValueError(f"unknown backend: {backend!r}")
