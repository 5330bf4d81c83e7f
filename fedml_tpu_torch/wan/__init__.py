"""WAN-realistic cross-silo federation (the port's copy of
``fedml_tpu/wan``): seeded diurnal availability traces, heterogeneous
client profiles and availability-restricted cohort sampling, driving
the port's cross-silo stack (README "WAN-realistic federation").

The layer is a world model that runs nothing itself: a
:class:`WanWorld` is handed to the cross-silo launch (``--wan_trace`` /
``--wan_profiles`` / ``--wan_round_s``, or ``wan=``), and the protocol's
own machinery (deadline eviction, JOIN, BACKPRESSURE) meets the
population dynamics.
Everything population-side is a pure function of ``(seed, client_id,
round)``, so a churn run replays bit for bit under one seed.
"""

from fedml_tpu_torch.wan.profiles import (ClientProfiles, ProfileConfig,
                                          parse_wan_profiles)
from fedml_tpu_torch.wan.trace import (AvailabilityTrace, FlapBurst,
                                       TraceConfig, parse_wan_trace)
from fedml_tpu_torch.wan.world import (WanAgent, WanWorld, build_wan_world,
                                       compose_fault_plan)

__all__ = [
    "AvailabilityTrace", "ClientProfiles", "FlapBurst", "ProfileConfig",
    "TraceConfig", "WanAgent", "WanWorld", "build_wan_world",
    "compose_fault_plan", "parse_wan_profiles", "parse_wan_trace",
]
