"""The server snapshot's field manifest (the port's copy of
``fedml_tpu/control/manifest.py``, with the port's attribute names).

Every attribute a round-based cross-silo server manager writes from its
message and round loop is in exactly one of two sets:

- :data:`SERVER_CHECKPOINT_FIELDS`: round-schedule state that
  ``_capture_control_state`` snapshots at round boundaries and deadline
  extensions and ``_restore_control_state`` puts back on failover. A new
  field forgotten here resets silently on restart, and the resumed
  schedule parts from the unkilled run.
- :data:`SERVER_EPHEMERAL_FIELDS`: state that means nothing across a
  process restart (armed timers, wall-clock origins, terminal latches),
  deliberately not snapshotted; each entry says why.

``tests/test_torch_control_manifest.py`` walks the server classes' ASTs
against these sets. The module imports nothing heavy, so reading it costs
no framework import.
"""

from __future__ import annotations

#: the round-schedule state captured by ``_capture_control_state`` and
#: restored by ``_restore_control_state`` (algorithms/fedavg_cross_silo.py)
SERVER_CHECKPOINT_FIELDS = frozenset({
    # -- the schedule's position ----------------------------------------------
    "round_idx",            # the sampling cursor: cohorts and client seeds
                            # are pure functions of (seed, round_idx)
    "global_model",         # the aggregated model entering the round
    "_round_cohort",        # the cohort broadcast for the open round
    # -- liveness and the fault-tolerance ledger --------------------------
    "liveness",             # the live set, the evict/rejoin counts and the
                            # latency window (last-seen wall clocks are not
                            # restored: they restart with the process)
    "live_history",         # one {round, reported, live, partial} a round
    "ft_counters",          # partial rounds, stale replies, ...
    "cp_counters",          # checkpoints, restores, adjustments, throttles
    "_resynced_round",      # the one-resync-a-round throttle of JOIN
    # -- the downlink compression chain -----------------------------------
    "_bcast_seq",           # the broadcast version counter
    "_mirror",              # the model every in-sync silo holds
    "_mirror_fp",
    "_worker_base",         # each silo's reported (seq, fingerprint):
                            # captured for forensics, CLEARED on restore
                            # (value-level staleness across a failover is
                            # undetectable, so the first broadcast after a
                            # restore rebases at full precision)
    # -- pace steering ------------------------------------------------------
    "round_deadline_s",     # the current (possibly steered) deadline
    "min_quorum_frac",      # the current (possibly steered) quorum
    "_evict_on_deadline",   # which close policy the schedule runs
    "_extensions_this_round",
    # -- the open round (mid-round snapshots: extensions, the stall path) --
    "aggregator",           # pending reports, weights, uploaded flags and
                            # the streaming fold's partial sum
    # -- subclass state -----------------------------------------------------
    "server_opt_state",     # FedOptServerManager's persistent optimizer
    "partial_rounds",       # QuorumFedAvgServerManager's below-strength log
})

#: deliberately not snapshotted; each entry says why a fresh start is right
SERVER_EPHEMERAL_FIELDS = frozenset({
    "_timer",               # the armed threading.Timer: re-armed by the
                            # first broadcast after a restore
    "_timer_lock",          # guards _timer and _finished within a process
    "_finished",            # the no-more-timers latch of a finished server:
                            # a restored server has not finished
    "_bcast_at",            # the monotonic origin of the open round's
                            # report latencies: meaningless in a new process
    "scheduling_error",     # a terminal latch: a run that died on it is
                            # over, not resumable past the error
    "_control_restored",    # the one-shot restore latch: a fresh process
                            # restores at most once
    "_model_version",       # the snapshot serializer's version token: a
                            # restarted server starts a fresh serializer
                            # cache, so the counter may restart too
    "_gm_capture_cache",    # (version, host copy) of global_model, derived
                            # from it and rebuilt by the first capture
    "device",               # the launch's device: a restore puts the
                            # captured arrays on this server's own device
    "_wire_credited_up",    # transport bytes already credited to the
    "_wire_credited_down",  # timer: a restarted server has a fresh endpoint
                            # whose counters start at zero
    "_wan_pending_joins",   # WAN-deferred JOINs awaiting their trace: a
                            # restored server loses them and the silos'
                            # JOIN retries rebuild them
    "_wan_join_deferrals",  # the WAN anti-starvation valve's per-round
                            # count: resets harmlessly (the valve re-arms)
    "_server_tx",           # FedOpt's optimizer functions, built from the
                            # launch's flags (its state is server_opt_state)
})

#: server classes with no round schedule to resume: FedAsync merges every
#: update into a version counter, so a restarted one is a fresh server
UNCHECKPOINTED_SERVER_CLASSES = frozenset({"AsyncFedAvgServerManager"})
