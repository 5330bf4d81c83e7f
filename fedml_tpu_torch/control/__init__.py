"""The control plane's error type and its JOIN token bucket (the port's
part of ``fedml_tpu/control/``): :class:`SchedulingStallError` and
:class:`~fedml_tpu_torch.control.admission.JoinAdmissionController`,
which backs the WAN world's shadow mass-JOIN bucket. The rest of the
control plane (the server snapshots, pace steering, the server's JOIN
admission) is ROADMAP Slice D item 23 and raises
``NotImplementedError`` in the launchers."""

from fedml_tpu_torch.control.admission import JoinAdmissionController


class SchedulingStallError(RuntimeError):
    """A round used up its deadline-extension budget
    (``max_deadline_extensions``) while below quorum: the federation
    cannot make progress. The server FINISHes the silos and the launcher
    raises this instead of extending forever."""


__all__ = ["JoinAdmissionController", "SchedulingStallError"]
