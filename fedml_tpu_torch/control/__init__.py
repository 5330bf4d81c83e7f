"""The elastic federation control plane (Bonawitz et al., MLSys 2019), the
port's counterpart of ``fedml_tpu/control/``: it makes the cross-silo
coordinator survivable and its schedule adaptive.

- :class:`~fedml_tpu_torch.control.checkpoint.ServerControlCheckpointer`:
  durable snapshots of the server's round-schedule state (round index,
  live set, compression mirror, pending replies, the streaming fold's
  partial sum, steering windows) and the round/cohort ledger, so a killed
  and restarted server resumes mid-schedule;
  :class:`~fedml_tpu_torch.control.checkpoint.AsyncCheckpointWriter`
  writes them from a thread of its own.
- :class:`~fedml_tpu_torch.control.pace.PaceSteerer`: each round's
  deadline (p90 x margin, clamped) and quorum target from the observed
  report latencies, in place of the static ``round_deadline_s`` and
  ``min_quorum_frac`` when ``pace_steering`` is on.
- :class:`~fedml_tpu_torch.control.admission.JoinAdmissionController`:
  a token bucket between a mass-rejoin flood and the server's
  full-precision resync path, answered with BACKPRESSURE.
- ``control/manifest.py``: which server attributes a snapshot carries
  and which restart fresh.
- ``control/failover_harness.py``: the kill-the-server oracle, in process
  and as a SIGKILLed subprocess.
"""

from fedml_tpu_torch.control.admission import JoinAdmissionController
from fedml_tpu_torch.control.checkpoint import (GROUP_COMMIT_LINES,
                                                GROUP_COMMIT_MS,
                                                AsyncCheckpointWriter,
                                                ServerControlCheckpointer)
from fedml_tpu_torch.control.pace import QUORUM_CEIL, PaceSteerer


class SchedulingStallError(RuntimeError):
    """A round used up its deadline-extension budget
    (``max_deadline_extensions``) while below quorum: the federation
    cannot make progress. The server checkpoints its final state,
    FINISHes the silos, and the launcher raises this instead of extending
    forever."""


def build_control_plane(server_checkpoint_dir=None, pace_steering=False,
                        join_rate_limit=0.0, round_deadline_s=None,
                        min_quorum_frac=0.5, max_deadline_extensions=25,
                        checkpoint_sync=False):
    """The control-plane options as the round servers' keyword arguments
    (``server_ckpt``, ``pace``, ``join_admission``,
    ``max_deadline_extensions``). All defaults give the inert
    configuration, the servers' behavior without a control plane.

    Snapshots are written asynchronously by default (a writer thread, a
    depth-1 newest-wins slot, group-committed ledger fsyncs: the round
    thread pays only the capture); ``checkpoint_sync`` snapshots inline
    at every boundary with an fsync per ledger line."""
    if pace_steering and not round_deadline_s:
        raise ValueError(
            "--pace_steering needs --round_deadline_s as the base "
            "deadline steering starts from (and falls back to until "
            "enough report latencies are observed)")

    def make_ckpt():
        if checkpoint_sync:
            return ServerControlCheckpointer(server_checkpoint_dir)
        return AsyncCheckpointWriter(ServerControlCheckpointer(
            server_checkpoint_dir, group_commit_lines=GROUP_COMMIT_LINES,
            group_commit_ms=GROUP_COMMIT_MS))

    return {
        "server_ckpt": make_ckpt() if server_checkpoint_dir else None,
        # the floor is the static quorum, capped at the steering ceiling
        # (a 1.0 floor would pin steering at the full barrier, the
        # deadlock the deadline exists to break)
        "pace": (PaceSteerer(base_deadline_s=round_deadline_s,
                             quorum_floor=min(min_quorum_frac,
                                              QUORUM_CEIL))
                 if pace_steering else None),
        "join_admission": (JoinAdmissionController(join_rate_limit)
                           if join_rate_limit and join_rate_limit > 0
                           else None),
        "max_deadline_extensions": max_deadline_extensions,
    }


__all__ = ["AsyncCheckpointWriter", "JoinAdmissionController",
           "PaceSteerer", "QUORUM_CEIL", "SchedulingStallError",
           "ServerControlCheckpointer", "build_control_plane"]
