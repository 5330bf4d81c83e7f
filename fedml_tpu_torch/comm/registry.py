"""Backend selection by string: the reference's ``--backend MPI|GRPC|MQTT``
switch (client_manager.py:22-35); the port's copy of
``fedml_tpu/comm/registry.py``.

``fault_plan`` (a ``comm.faults.FaultPlan``, a DSL string or JSON, see
``parse_fault_plan``) wraps the endpoint in the seeded fault injector;
``None`` or an empty plan returns the bare backend.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.faults import FaultyCommManager, parse_fault_plan
from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter


def create_comm_manager(
        backend: str, rank: int, size: int,
        router: Optional[InProcRouter] = None,
        addresses: Optional[Dict[int, Tuple[str, int]]] = None,
        wire_codec: bool = True,
        token: Optional[bytes] = None,
        fault_plan=None) -> BaseCommunicationManager:
    """``backend``: "INPROC" (ranks are threads of one process over a
    shared :class:`InProcRouter`; "MPI" is its alias on one host), "TCP"
    (framed sockets, cross-host), "GRPC" (chunked client-streaming RPC),
    "GRPC_PROTO" (the reference's proto wire and JSON codec), "MQTT"
    (broker pub/sub with the reference topic scheme) or "ROUTED" ("BROKER":
    dial-out frames through the native broker, native/router.cpp, with the
    shared-secret ``token``). ``addresses`` is ``{rank: (host, port)}`` for
    TCP and the gRPC pair, ``{"broker": (host, port)}`` for MQTT and
    ``{"router": (host, port)}`` for ROUTED.

    ``wire_codec=False`` (the JAX package's in-process object hand-off)
    is refused: the in-process router always ships encoded frames, so the
    wire bytes are always counted."""
    plan = parse_fault_plan(fault_plan)
    inner = _create_backend(backend, rank, size, router, addresses,
                            wire_codec, token)
    if plan is None or plan.empty:
        return inner
    return FaultyCommManager(inner, plan, rank)


def _create_backend(backend: str, rank: int, size: int, router, addresses,
                    wire_codec: bool, token) -> BaseCommunicationManager:
    key = backend.upper()
    if key in ("ROUTED", "BROKER"):
        if addresses is None or "router" not in addresses:
            raise ValueError(
                'ROUTED backend needs addresses={"router": (host, port)}')
        from fedml_tpu_torch.comm.routed import RoutedCommManager
        return RoutedCommManager(rank, addresses["router"], token=token)
    if key in ("INPROC", "MPI"):
        if not wire_codec:
            raise NotImplementedError(
                "wire_codec=False (the object hand-off) is not ported: the "
                "in-process router always ships encoded frames")
        if router is None:
            raise ValueError("INPROC backend needs a shared InProcRouter")
        return InProcCommManager(router, rank, size)
    if key in ("TCP", "GRPC", "GRPC_PROTO"):
        if addresses is None:
            raise ValueError(f"{key} backend needs {{rank: (host, port)}}")
        if key == "TCP":
            from fedml_tpu_torch.comm.tcp import TcpCommManager
            return TcpCommManager(rank, addresses)
        if key == "GRPC":
            from fedml_tpu_torch.comm.grpc_backend import GrpcCommManager
            return GrpcCommManager(rank, addresses)
        from fedml_tpu_torch.comm.grpc_proto import ProtoGrpcCommManager
        return ProtoGrpcCommManager(rank, addresses)
    if key == "MQTT":
        if addresses is None or "broker" not in addresses:
            raise ValueError(
                'MQTT backend needs addresses={"broker": (host, port)}')
        from fedml_tpu_torch.comm.mqtt import MqttCommManager
        host, port = addresses["broker"]
        return MqttCommManager(host, port, client_id=rank,
                               client_num=size - 1)
    raise ValueError(f"unknown backend: {backend!r}")
