"""Compression policy ladder for the cross-silo wire (the port's copy of
``fedml_tpu/comm/policy.py``).

Replaces the boolean ``compress`` flag with a named policy selecting how
much of the communication-efficiency stack engages, uplink AND downlink:

========================  ==========================  =====================
policy                    uplink (client -> server)   downlink (server -> clients)
========================  ==========================  =====================
``none``                  full precision              full precision
``delta_int8``            int8 delta vs the held      int8 delta vs the
                          global                      silos' mirror model
``topk_ef``               top-k delta + error         top-k delta vs the
                          feedback (exact values)     mirror
``topk_ef_int8``          top-k + int8 survivors +    top-k + int8 delta vs
                          error feedback              the mirror
========================  ==========================  =====================

Uplink error feedback is an explicit per-silo residual buffer
(ops/sparsify.py); downlink error feedback is implicit — the server
compresses the difference between its exact global model and the *mirror*
(the model state every silo actually holds, advanced by exactly what each
broadcast decodes to), so un-sent mass automatically rides in the next
round's delta. (The JAX package's FedAsync server refuses compression: its
global moves every update, so no stable base exists in either direction;
the port has no FedAsync server yet.)

Selection: launchers expose ``--compression``; the
``FEDML_TPU_TORCH_COMPRESSION`` environment variable overrides any
string/None selection (a kill switch / fleet-wide experiment knob) but
never an explicit :class:`CompressionPolicy` instance (programmatic callers
that already resolved a policy keep it). ``topk_ef:0.05``-style suffixes
set the keep fraction.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

POLICY_NAMES = ("none", "delta_int8", "topk_ef", "topk_ef_int8")
ENV_VAR = "FEDML_TPU_TORCH_COMPRESSION"


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    name: str = "none"
    #: keep-fraction for the top-k policies (both directions)
    topk_frac: float = 0.01
    #: disable the downlink half only (uplink keeps the policy) — the
    #: bit-exact resume-parity mode: downlink deltas quantize against a
    #: mirror a freshly resumed federation cannot reconstruct, so the
    #: first post-resume broadcast degrades to full precision and the
    #: trajectory matches only within quantization noise
    downlink: bool = True

    def __post_init__(self):
        if self.name not in POLICY_NAMES:
            raise ValueError(f"unknown compression policy {self.name!r} "
                             f"(choose from {'|'.join(POLICY_NAMES)})")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac {self.topk_frac} outside (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.name != "none"

    @property
    def uplink_topk(self) -> bool:
        return self.name in ("topk_ef", "topk_ef_int8")

    @property
    def uplink_int8(self) -> bool:
        return self.name in ("delta_int8", "topk_ef_int8")

    @property
    def downlink_enabled(self) -> bool:
        return self.enabled and self.downlink


def parse_policy(text: str) -> CompressionPolicy:
    """``"topk_ef_int8"`` or ``"topk_ef:0.05"`` -> a policy object."""
    name, _, frac = text.strip().partition(":")
    if frac:
        return CompressionPolicy(name, topk_frac=float(frac))
    return CompressionPolicy(name)


def resolve_compression(
        policy: Union[CompressionPolicy, str, None] = None, *,
        compress: bool = False) -> CompressionPolicy:
    """One resolution path for every launcher and manager.

    Precedence: an explicit :class:`CompressionPolicy` instance wins
    outright (already resolved upstream); otherwise
    ``$FEDML_TPU_TORCH_COMPRESSION`` overrides the string/None selection;
    otherwise the string; otherwise the legacy boolean ``compress`` flag,
    which maps to ``delta_int8`` with ``downlink=False``, the EXACT
    pre-policy behavior (uplink int8 only, full-precision broadcasts): a
    script that always passed ``--compress`` must not silently start
    receiving quantized broadcasts.
    """
    if isinstance(policy, CompressionPolicy):
        return policy
    env = os.environ.get(ENV_VAR, "").strip()
    if env:
        return parse_policy(env)
    if policy:
        return parse_policy(policy)
    if compress:
        return CompressionPolicy("delta_int8", downlink=False)
    return CompressionPolicy("none")
