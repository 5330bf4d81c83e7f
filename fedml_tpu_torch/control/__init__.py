"""The control plane's error type (the port's part of
``fedml_tpu/control/__init__.py``). The rest of the control plane (the
server snapshots, pace steering, JOIN admission) is ROADMAP Slice D item
23 and raises ``NotImplementedError`` in the launchers."""


class SchedulingStallError(RuntimeError):
    """A round used up its deadline-extension budget
    (``max_deadline_extensions``) while below quorum: the federation
    cannot make progress. The server FINISHes the silos and the launcher
    raises this instead of extending forever."""


__all__ = ["SchedulingStallError"]
