"""The documented metric registry: every RoundTimer name, one table (the
port's counterpart of ``fedml_tpu/obs/registry.py``, with the JAX names).

``RoundTimer``'s phase/counter/gauge maps are ``defaultdict``s: a typo'd
name at a ``timer.count(...)`` call site silently creates a NEW key and
the intended series stops moving. This registry is the single source of
truth for every metric name the port may emit (``tests/test_torch_obs.py``
scans the package's literal names against it), and the flight recorder
and the merge tool treat these names as the per-round timeline's schema
(unknown keys still round-trip: the registry constrains what the TREE
emits, not what a log may carry).

The table keeps every row of the JAX package's. A metric the port does
not produce yet keeps its row, and :data:`PENDING` names the ROADMAP item
that brings it; :data:`PORT_ONLY` adds the phases that only the port's
cross-silo actors and fused driver time.
"""

from __future__ import annotations

from typing import Dict

#: metric kinds: how RoundTimer aggregates the series
KIND_PHASE = "phase"      # wall-clock totals + call counts (timer.phase/add)
KIND_COUNTER = "counter"  # monotone event counts (timer.count)
KIND_GAUGE = "gauge"      # high-water marks, max-aggregated (timer.gauge)
#: fields of the per-round ``perf`` flight record (obs/perf.py) — derived
#: from a closed round's deltas, not a RoundTimer series; registered here
#: so FT017 pins the names the same way it pins the timer's
KIND_DERIVED = "derived"


def _m(kind: str, subsystem: str, meaning: str) -> Dict[str, str]:
    return {"kind": kind, "subsystem": subsystem, "meaning": meaning}


#: name -> {kind, subsystem, meaning}. Sorted by family, then name.
METRICS: Dict[str, Dict[str, str]] = {
    # -- round phases (drivers: fedavg sim, mesh/SPMD, fused) --------------
    "pack": _m(KIND_PHASE, "round pipeline",
               "host-side cohort pack (pad-and-mask shard assembly)"),
    "upload": _m(KIND_PHASE, "round pipeline",
                 "H2D transfer of the packed cohort"),
    "dispatch": _m(KIND_PHASE, "round pipeline",
                   "device round dispatch (async enqueue of the jitted "
                   "round program)"),
    "device_wait": _m(KIND_PHASE, "round pipeline",
                      "eval-boundary drain of pending device compute"),
    "eval": _m(KIND_PHASE, "round pipeline",
               "global train/test union evaluation"),
    "prefetch_wait": _m(KIND_PHASE, "prefetch",
                        "caller time blocked on an in-flight prefetch "
                        "slot (pack latency NOT hidden by the pipeline)"),
    # -- prefetch counters (parallel/prefetch.py) --------------------------
    "prefetch_hit": _m(KIND_COUNTER, "prefetch",
                       "round consumed a speculatively packed cohort"),
    "prefetch_miss": _m(KIND_COUNTER, "prefetch",
                        "round packed inline (cold start / misprediction "
                        "/ dataset swap)"),
    # -- wire accounting (comm backends via launch_federation) -------------
    "comm_bytes_up": _m(KIND_COUNTER, "comm",
                        "client->server wire bytes, actual encoded frame "
                        "lengths"),
    "comm_bytes_down": _m(KIND_COUNTER, "comm",
                          "server->client wire bytes, actual encoded "
                          "frame lengths"),
    # -- server round hot path (serialize-once broadcast + streaming fold) -
    "bcast_fanout_ms": _m(KIND_GAUGE, "comm",
                          "slowest round-open broadcast fan-out: wall "
                          "time from first enqueue to the round thread "
                          "regaining control (NOT wire drain — the "
                          "per-peer writer threads absorb slow links)"),
    "send_queue_depth": _m(KIND_GAUGE, "comm",
                           "peak per-peer send-queue depth observed at "
                           "broadcast enqueue (bounded queue; overflow "
                           "sheds the peer through the eviction path)"),
    "codec_encode_ms": _m(KIND_GAUGE, "comm",
                          "slowest downlink compression encode (top-k/"
                          "EF select + quantize + mirror advance) on "
                          "the round thread before a broadcast"),
    "agg_fold_ms": _m(KIND_GAUGE, "round pipeline",
                      "slowest streaming-fold step (decode + in-order "
                      "prefix fold of one reply, or the round-close "
                      "drain of the out-of-order buffer)"),
    "agg_buffered_peak": _m(KIND_GAUGE, "round pipeline",
                            "peak out-of-order reply buffer size held by "
                            "the streaming aggregator (contiguous-prefix "
                            "replies fold immediately and never buffer)"),
    # -- fault tolerance (PR-5 layer; rolled up by launch_federation) ------
    "ft_retries": _m(KIND_COUNTER, "fault tolerance",
                     "transport send retries across every endpoint"),
    "ft_dedup_drops": _m(KIND_COUNTER, "fault tolerance",
                         "duplicate frames shed by receive-side "
                         "[epoch, seq] dedup"),
    "ft_conn_errors": _m(KIND_COUNTER, "fault tolerance",
                         "connection-level errors observed by the "
                         "transports"),
    "ft_faults_injected": _m(KIND_COUNTER, "fault tolerance",
                             "chaos-harness faults injected "
                             "(comm/faults.py)"),
    "ft_evictions": _m(KIND_COUNTER, "fault tolerance",
                       "silos evicted from the live set (deadline miss "
                       "or send failure)"),
    "ft_rejoins": _m(KIND_COUNTER, "fault tolerance",
                     "silos re-admitted to the live set (JOIN or a live "
                     "reply)"),
    "ft_partial_rounds": _m(KIND_COUNTER, "fault tolerance",
                            "rounds closed with a weighted partial "
                            "aggregate"),
    "ft_stale_replies": _m(KIND_COUNTER, "fault tolerance",
                           "replies for an already-closed round, "
                           "discarded"),
    "ft_corrupt_frames": _m(KIND_COUNTER, "fault tolerance",
                            "replies that failed payload decode and were "
                            "dropped"),
    "ft_join_resyncs": _m(KIND_COUNTER, "fault tolerance",
                          "full-precision mirror resyncs sent to "
                          "rejoining silos"),
    "ft_heartbeats": _m(KIND_COUNTER, "fault tolerance",
                        "heartbeat messages the server processed"),
    "ft_deadline_extensions": _m(KIND_COUNTER, "fault tolerance",
                                 "below-quorum deadline extensions"),
    # -- elastic control plane (PR-7 layer) --------------------------------
    "cp_checkpoints": _m(KIND_COUNTER, "control plane",
                         "server control-state snapshots saved"),
    "cp_restores": _m(KIND_COUNTER, "control plane",
                      "server control-state restores (failover resumes)"),
    "cp_deadline_adjustments": _m(KIND_COUNTER, "control plane",
                                  "pace-steering deadline/quorum changes"),
    "cp_joins_throttled": _m(KIND_COUNTER, "control plane",
                             "JOINs rejected with BACKPRESSURE by "
                             "admission control"),
    "cp_steered_deadline_s": _m(KIND_GAUGE, "control plane",
                                "largest pace-steered round deadline"),
    "cp_resync_latency_skips": _m(KIND_COUNTER, "control plane",
                                  "rejoin-resync reply latencies excluded "
                                  "from the pace-steering window (they "
                                  "measure the outage, not the silo's "
                                  "pace — the churn-poisoning guard)"),
    "cp_capture_ms": _m(KIND_GAUGE, "control plane",
                        "slowest control-state capture (the host-copy "
                        "cost the round thread pays per snapshot — with "
                        "the async writer this IS the round thread's "
                        "whole checkpoint bill)"),
    "cp_flush_ms": _m(KIND_GAUGE, "control plane",
                      "slowest snapshot serialize+fsync+publish (inline "
                      "in --checkpoint_sync mode; the writer thread's "
                      "last completed flush in async mode)"),
    "cp_writer_queue_coalesced": _m(KIND_COUNTER, "control plane",
                                    "snapshots replaced in the async "
                                    "writer's depth-1 newest-wins slot "
                                    "before publishing (backpressure: "
                                    "the writer fell behind the round "
                                    "cadence)"),
    "cp_fsync_total": _m(KIND_COUNTER, "control plane",
                         "every fsync the control-plane checkpointer "
                         "issued over the run (blobs, sidecars, "
                         "directory entries, ledger), folded into the "
                         "timer after the close barrier"),
    "cp_ledger_fsyncs": _m(KIND_COUNTER, "control plane",
                           "ledger.jsonl group-commit fsyncs (subset "
                           "of cp_fsync_total; one per N-line/T-ms "
                           "batch plus the flush-on-close tail)"),
    # -- WAN world model (fedml_tpu/wan/) -----------------------------------
    "wan_cohort_rejections": _m(KIND_COUNTER, "wan",
                                "cohort-draw candidates skipped because "
                                "the availability trace marked them "
                                "offline"),
    "wan_forced_cohorts": _m(KIND_COUNTER, "wan",
                             "cohort slots filled from the unrestricted "
                             "stream because the available population "
                             "was exhausted (graceful degradation, "
                             "never a stall)"),
    "wan_offline_drops": _m(KIND_COUNTER, "wan",
                            "broadcasts a silo dropped because its "
                            "embodied device was trace-offline (no "
                            "training, no reply — the deadline eviction "
                            "path removes it)"),
    "wan_delay_injected_ms": _m(KIND_COUNTER, "wan",
                                "total injected report delay across the "
                                "fleet (the heterogeneous straggler "
                                "profiles), milliseconds"),
    "wan_join_deferred": _m(KIND_COUNTER, "wan",
                            "JOINs answered with BACKPRESSURE because "
                            "the silo's device was still trace-offline "
                            "(the deterministic rejoin gate)"),
    "wan_mass_joins": _m(KIND_COUNTER, "wan",
                         "estimated population-scale device arrivals "
                         "per round (the trace's churn wave, "
                         "sample-scaled)"),
    "wan_mass_leaves": _m(KIND_COUNTER, "wan",
                          "estimated population-scale device departures "
                          "per round"),
    "wan_mass_join_throttled": _m(KIND_COUNTER, "wan",
                                  "population JOIN-wave arrivals the "
                                  "shadow admission bucket (same rate as "
                                  "--join_rate_limit, sim clock) would "
                                  "have throttled"),
    "wan_available_frac": _m(KIND_GAUGE, "wan",
                             "highest per-round population availability "
                             "fraction observed (the per-round "
                             "trajectory rides the round records' "
                             "wan_available_frac field)"),
    # -- federation scheduler (sched/) --------------------------------------
    "sched_device_time": _m(KIND_PHASE, "scheduler",
                            "wall-clock this job held the shared device "
                            "gate (fair-share accounting; solo runs "
                            "without a gate emit none). On the card the "
                            "host's hold: launches are asynchronous, so "
                            "it is device time only where the section "
                            "ends in a host copy"),
    "sched_gate_wait": _m(KIND_PHASE, "scheduler",
                          "wall-clock this job's actors queued for a "
                          "device slot behind co-tenants (contention "
                          "visibility per tenant)"),
    "sched_device_acquires": _m(KIND_COUNTER, "scheduler",
                                "device-gate grants to this job "
                                "(deficit-round-robin turns taken)"),
    "sched_unrouted_frames": _m(KIND_COUNTER, "scheduler",
                                "frames arriving at a shared fabric "
                                "endpoint for a job not running there "
                                "(counted on the physical endpoint, "
                                "dropped)"),
    # -- federated serving tier (fedml_tpu/serve/) -------------------------
    "serve_requests": _m(KIND_COUNTER, "serving",
                         "predict requests accepted by the batch "
                         "coalescer (shed requests count too — they "
                         "entered the submit path)"),
    "serve_batches": _m(KIND_COUNTER, "serving",
                        "coalesced batches dispatched to the warmed "
                        "predict program"),
    "serve_shed": _m(KIND_COUNTER, "serving",
                     "requests rejected by load shedding (full bounded "
                     "queue or a deadline that died in the queue — the "
                     "429 analogue)"),
    "serve_swap_ms": _m(KIND_GAUGE, "serving",
                        "slowest hot-swap (async device_put + atomic "
                        "reference flip) installing a round's model "
                        "into the endpoint; the first install's "
                        "bucket-ladder compile is excluded (one-off)"),
    "serve_p50_ms": _m(KIND_GAUGE, "serving",
                       "median request latency (submit to reply) over "
                       "the coalescer's bounded window, high-watered"),
    "serve_p99_ms": _m(KIND_GAUGE, "serving",
                       "p99 request latency over the coalescer's "
                       "bounded window, high-watered"),
    "serve_staleness_rounds": _m(KIND_GAUGE, "serving",
                                 "largest trained-vs-serving round gap "
                                 "observed (the staleness bound's "
                                 "measured counterpart)"),
    # -- tiered client-state store (state/store.py) ------------------------
    "state_cache_hits": _m(KIND_COUNTER, "state store",
                           "shard reads served from the resident LRU"),
    "state_cache_misses": _m(KIND_COUNTER, "state store",
                             "shard reads that faulted in from disk / "
                             "the generator"),
    "state_evictions": _m(KIND_COUNTER, "state store",
                          "shards evicted from the resident LRU"),
    "state_bytes_read": _m(KIND_COUNTER, "state store",
                           "bytes faulted in from disk shards"),
    "state_bytes_written": _m(KIND_COUNTER, "state store",
                              "bytes spilled to disk shards"),
    # -- host ---------------------------------------------------------------
    "host_rss_peak_mb": _m(KIND_GAUGE, "host",
                           "peak resident set size of this process (MB)"),
    # -- observability (fedml_tpu/obs/) -------------------------------------
    "obs_anomalies": _m(KIND_COUNTER, "observability",
                        "anomaly records written to the flight log "
                        "(slow round / stall / deadline extension); "
                        "per-round attribution rides the anomaly "
                        "record's own round field — a slow-round bump "
                        "lands after end_round, i.e. in the next "
                        "round's counter delta"),
    "obs_profiled_rounds": _m(KIND_COUNTER, "observability",
                              "rounds captured by an anomaly-armed "
                              "one-shot profiler window (bumped at "
                              "the window's close, so the delta lands "
                              "in the following round's record)"),
    "obs_fsync_batches": _m(KIND_COUNTER, "observability",
                            "flight-recorder group-commit fsyncs (one "
                            "per batch of sync-worthy round/anomaly "
                            "records — N lines or T ms, whichever "
                            "first); credited after end_round, so the "
                            "delta lands in the following round's "
                            "record"),
    # -- perf flight deck (obs/perf.py): per-round derived perf record ------
    "mfu": _m(KIND_DERIVED, "perf",
              "model FLOP utilization: achieved FLOP/s over the fleet "
              "BF16 dense tensor-core peak (the NVIDIA table in "
              "obs/perf.py x device count; $FEDML_TPU_PEAK_FLOPS "
              "overrides the per-device figure); omitted on the CPU and "
              "unknown cards"),
    "achieved_flops_per_s": _m(KIND_DERIVED, "perf",
                               "round program FLOPs (analytic "
                               "dispatch-count cost model, "
                               "utils/flops.py) over the measured round "
                               "duration"),
    "comm_compute_overlap_frac": _m(KIND_DERIVED, "perf",
                                    "fraction of host pack+upload hidden "
                                    "behind device compute by the round "
                                    "pipeline (prefetch-hit rounds: "
                                    "1 - prefetch_wait/(pack+upload); "
                                    "serial rounds read 0)"),
    "wire_bytes_per_sec_up": _m(KIND_DERIVED, "perf",
                                "client->server wire throughput this "
                                "round (encoded frame bytes / duration)"),
    "wire_bytes_per_sec_down": _m(KIND_DERIVED, "perf",
                                  "server->client wire throughput this "
                                  "round (encoded frame bytes / "
                                  "duration)"),
    "device_mem_peak_mb": _m(KIND_GAUGE, "perf",
                             "peak device bytes allocated (torch.cuda."
                             "memory_stats allocated_bytes.all.peak), "
                             "MB; omitted on the CPU"),
    "device_mem_in_use_mb": _m(KIND_DERIVED, "perf",
                               "current device bytes allocated (torch."
                               "cuda.memory_stats allocated_bytes.all."
                               "current) at round close, MB; omitted "
                               "on the CPU"),
}


#: the JAX names the port does not emit yet -> the ROADMAP item that
#: brings each (the row stays; nothing is dropped)
PENDING: Dict[str, str] = {
    **{n: "Slice D item 23 (serving)" for n in METRICS
       if n.startswith("serve_")},
    **{n: "Slice D item 23 (state/population.py)" for n in METRICS
       if n.startswith("state_")},
}

#: phases only the port times (its cross-silo actors and fused driver)
PORT_ONLY: Dict[str, Dict[str, str]] = {
    "apply": _m(KIND_PHASE, "cross-silo silo",
                "decode + install of a broadcast model on the silo's "
                "device"),
    "train": _m(KIND_PHASE, "cross-silo silo",
                "the silo's local training of its sampled client"),
    "encode": _m(KIND_PHASE, "cross-silo silo",
                 "the silo's reply encode (compression policy)"),
    "bcast_encode": _m(KIND_PHASE, "cross-silo server",
                       "the server's broadcast encode (full model or a "
                       "compressed mirror delta)"),
    "decode": _m(KIND_PHASE, "cross-silo server",
                 "the server's decode of one reply"),
    "fold": _m(KIND_PHASE, "cross-silo server",
               "the streaming fold of one reply, and the round-close "
               "aggregate"),
    "checkpoint": _m(KIND_PHASE, "cross-silo server",
                     "the round state's save after a round"),
    "capture": _m(KIND_PHASE, "fused driver",
                  "one CUDA-graph capture of a fused round"),
}


def metric_names() -> frozenset:
    """Every registered metric name: the JAX rows and the port's own."""
    return frozenset(METRICS) | frozenset(PORT_ONLY)


def markdown_table() -> str:
    """The registry as a GitHub markdown table (regenerate with
    ``python -m fedml_tpu_torch.obs registry``); the ``port`` column says
    whether the port emits a metric or which ROADMAP item brings it."""
    rows = ["| metric | kind | subsystem | meaning | port |",
            "|---|---|---|---|---|"]
    table = {**METRICS, **PORT_ONLY}
    for name in sorted(table):
        m = table[name]
        port = PENDING.get(name, "emitted" if name in METRICS
                           else "emitted (port only)")
        rows.append(f"| `{name}` | {m['kind']} | {m['subsystem']} | "
                    f"{m['meaning']} | {port} |")
    return "\n".join(rows)
