"""Seeded fault injection for any comm backend (the port's copy of
``fedml_tpu/comm/faults.py``).

``FaultyCommManager`` wraps a ``BaseCommunicationManager`` and injects
faults from a seeded, declarative :class:`FaultPlan`:

- ``drop``       the message never reaches the transport;
- ``delay``      the send is deferred ``delay_ms`` (reorders streams);
- ``duplicate``  the message is sent twice with the same wire seq (the
                 receive-side dedup must shed the copy);
- ``corrupt``    array bytes of the encoded frame are bit-flipped (the
                 header and scalars stay intact, so the payload decodes
                 into garbage the payload-level guards must catch);
- ``disconnect`` the endpoint goes dark for ``duration_ms``, both ways (a
                 link partition: messages are dropped, no socket is
                 closed).

Every draw comes from one ``random.Random`` seeded from ``(plan.seed,
rank)``, the JAX package's stream bit for bit, so a fault run replays. An
empty plan is never wrapped (``comm/registry.py``), and rules with ``p=0``
draw but never fire: both leave the federation's bits unchanged. The
launchers take it as ``--fault_plan`` (a DSL string, inline JSON, or a
.json path).

DSL: rules separated by ``;``, each ``op:key=val,key=val``; a bare
``seed=N`` token sets the plan seed. Example::

    seed=7;drop:p=0.1,msg_type=4;delay:p=0.2,delay_ms=50;duplicate:p=0.3

Self-addressed messages (the deadline servers' timer ticks) are exempt
unless a rule sets ``include_self=1``: faulting the server's own clock
would test the harness, not the protocol.

The port's frame header is JSON where the JAX package's is msgpack, so a
``corrupt`` rule flips other bytes than the JAX package's (the draws are
the same; the frame lengths they index differ).
"""

from __future__ import annotations

import json
import logging
import os
import random
import struct
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Sequence, Union

from fedml_tpu_torch.comm.message import Message

_OPS = ("drop", "delay", "duplicate", "corrupt", "disconnect")


@dataclass(frozen=True)
class FaultRule:
    """One declarative fault: what (``op``), when (``p`` / ``after`` /
    ``max_count``) and which messages (the sender / receiver / msg_type /
    direction filters; ``None`` matches everything)."""

    op: str
    p: float = 1.0
    delay_ms: float = 0.0        # delay op
    duration_ms: float = 100.0   # disconnect op
    msg_type: Optional[int] = None
    sender: Optional[int] = None
    receiver: Optional[int] = None
    direction: str = "send"      # send | recv
    after: int = 0               # skip the first N matching messages
    max_count: Optional[int] = None  # stop injecting after N faults
    include_self: bool = False   # match self-addressed (timer) messages

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(one of {', '.join(_OPS)})")
        if self.direction not in ("send", "recv"):
            raise ValueError(f"fault direction must be send|recv, "
                             f"got {self.direction!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {self.p}")

    def matches(self, msg: Message, direction: str) -> bool:
        if self.direction != direction:
            return False
        if not self.include_self \
                and msg.get_sender_id() == msg.get_receiver_id():
            return False
        if self.msg_type is not None and msg.get_type() != self.msg_type:
            return False
        if self.sender is not None and msg.get_sender_id() != self.sender:
            return False
        return self.receiver is None \
            or msg.get_receiver_id() == self.receiver


_RULE_FIELDS = {f.name for f in fields(FaultRule)}
_INT_FIELDS = {"msg_type", "sender", "receiver", "after", "max_count"}
_BOOL_FIELDS = {"include_self"}


@dataclass(frozen=True)
class FaultPlan:
    """A seeded set of fault rules; an ``empty`` plan is not wrapped."""

    seed: int = 0
    rules: Sequence[FaultRule] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    @property
    def empty(self) -> bool:
        return not self.rules

    def rng_for(self, rank: int) -> random.Random:
        """One deterministic stream an endpoint (the JAX package's seed
        formula): decorrelated across ranks, replayable across runs."""
        return random.Random((int(self.seed) * 1_000_003
                              + int(rank)) ^ 0x5EED)


def _coerce(key: str, val: str):
    if key not in _RULE_FIELDS:
        raise ValueError(f"unknown fault-rule key {key!r} "
                         f"(known: {sorted(_RULE_FIELDS)})")
    if key in ("op", "direction"):
        return val
    if key in _BOOL_FIELDS:
        return str(val).strip().lower() in ("1", "true", "yes")
    if key in _INT_FIELDS:
        return int(val)
    return float(val)


def parse_fault_plan(spec: Union[None, str, dict, list, FaultPlan],
                     seed: int = 0) -> Optional[FaultPlan]:
    """The ``--fault_plan`` front door: an existing plan, inline JSON
    (``{"seed": 1, "rules": [...]}`` or a bare rule list), a path to a
    .json file, or the DSL (module docstring). ``None`` for a spec that
    holds no plan, so the launchers skip the wrapper."""
    if spec is None or isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, (dict, list)):
        return _plan_from_obj(spec, seed)
    s = str(spec).strip()
    if not s:
        return None
    if s.startswith("{") or s.startswith("["):
        return _plan_from_obj(json.loads(s), seed)
    if s.endswith(".json"):
        if not os.path.exists(s):
            raise FileNotFoundError(f"--fault_plan file not found: {s}")
        with open(s, "r", encoding="utf-8") as fh:
            return _plan_from_obj(json.load(fh), seed)
    rules: List[FaultRule] = []
    for token in s.split(";"):
        token = token.strip()
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token.split("=", 1)[1])
            continue
        op, _, rest = token.partition(":")
        kw = {"op": op.strip()}
        for pair in filter(None, (p.strip() for p in rest.split(","))):
            k, _, v = pair.partition("=")
            kw[k.strip()] = _coerce(k.strip(), v.strip())
        rules.append(FaultRule(**kw))
    return FaultPlan(seed=seed, rules=rules)


def merge_plans(a: Union[None, str, dict, list, FaultPlan],
                b: Union[None, str, dict, list, FaultPlan]
                ) -> Optional[FaultPlan]:
    """Compose two plans into one schedule: the rules concatenate in order
    (the first plan's match first) and the first non-empty plan's seed
    keys every endpoint's stream; ``None`` or empty operands pass
    through."""
    a = parse_fault_plan(a)
    b = parse_fault_plan(b)
    if a is None or a.empty:
        return b
    if b is None or b.empty:
        return a
    return FaultPlan(seed=a.seed, rules=(*a.rules, *b.rules))


def _plan_from_obj(obj, seed: int) -> FaultPlan:
    if isinstance(obj, list):
        obj = {"rules": obj}
    rules = [FaultRule(**{k: r[k] for k in r}) for r in obj.get("rules", ())]
    return FaultPlan(seed=int(obj.get("seed", seed)), rules=rules)


def server_kill_plan(seed: int = 0, after_broadcasts: int = 2,
                     down_ms: float = 2000.0,
                     extra_rules: Sequence[FaultRule] = ()) -> FaultPlan:
    """The server-kill scenario: after ``after_broadcasts`` SYNC
    broadcasts leave the server, its endpoint goes dark for ``down_ms``,
    nothing in or out (the fleet's view of a server crash). Its own
    deadline ticks stay exempt. ``extra_rules`` join the same seeded
    plan."""
    kill = FaultRule(op="disconnect", direction="send", sender=0,
                     msg_type=2, after=after_broadcasts, max_count=1,
                     duration_ms=down_ms)
    return FaultPlan(seed=seed, rules=(kill, *extra_rules))


def _corrupt_frame(msg: Message, rng: random.Random) -> Optional[Message]:
    """Bit-flip array bytes of the encoded frame; the header and scalars
    stay intact, so the frame still decodes, into garbage the
    payload-level guards (the compression fingerprints, top-k index
    bounds) must refuse. None when the message carries no array bytes."""
    frame = bytearray(msg.to_bytes())
    (hlen,) = struct.unpack_from("<I", frame, 0)
    body_start = 4 + hlen
    body_len = len(frame) - body_start
    if body_len <= 0:
        return None
    n_flips = max(8, body_len // 64)
    for _ in range(n_flips):
        frame[body_start + rng.randrange(body_len)] ^= 0xFF
    return Message.from_bytes(bytes(frame))


class FaultyCommManager:
    """A duck-typed ``BaseCommunicationManager`` that injects faults.

    Not a subclass: the byte accounting and the seq dedup belong to the
    inner backend (the wrapper sits above the reliable-delivery layer,
    so a plan exercises it); the wrapper owns only its fault state and
    its own observers."""

    def __init__(self, inner, plan: FaultPlan, rank: int):
        self.inner = inner
        self.plan = plan
        self.rank = rank
        self._rng = plan.rng_for(rank)
        self._rng_lock = threading.Lock()
        self._observers: list = []
        self._matched = defaultdict(int)   # rule idx -> messages matched
        self._fired = defaultdict(int)     # rule idx -> faults injected
        self._down_until = 0.0
        self.counters: Dict[str, int] = defaultdict(int)
        #: pending ``delay`` sends: id -> (timer, message); whichever of
        #: the timer and stop_receive_message claims an entry first sends it
        self._pending: Dict[int, tuple] = {}
        self._pending_ids = 0
        #: (job, counter name) -> count: the wrapper's own per-tenant
        #: slice (see ``BaseCommunicationManager._job_counters``)
        self._job_counters: Dict[tuple, int] = defaultdict(int)
        inner.add_observer(_InnerTap(self))

    # -- byte accounting: the inner backend owns the wire ------------------
    @property
    def bytes_sent(self) -> int:
        return self.inner.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self.inner.bytes_received

    def job_bytes(self, job):
        return self.inner.job_bytes(job)

    def job_counters(self, job) -> Dict[str, int]:
        out = dict(self.inner.job_counters(job))
        with self._rng_lock:
            for (j, name), v in self._job_counters.items():
                if j == job:
                    out[name] = out.get(name, 0) + int(v)
        return out

    def purge_streams(self, job) -> None:
        self.inner.purge_streams(job)

    def bump(self, name: str, n: int = 1, job=None) -> None:
        with self._rng_lock:
            self.counters[name] += int(n)
            if job is not None:
                self._job_counters[(job, name)] += int(n)

    def all_counters(self) -> Dict[str, int]:
        """The wrapper's fault counts merged with the inner backend's
        transport counters (retries, dedup_drops, ...)."""
        out = dict(getattr(self.inner, "counters", {}))
        with self._rng_lock:
            for k, v in self.counters.items():
                out[k] = out.get(k, 0) + v
        return out

    # -- fault engine ------------------------------------------------------
    def _pick(self, msg: Message, direction: str) -> Optional[FaultRule]:
        if self.plan.empty:
            return None
        if time.monotonic() < self._down_until \
                and msg.get_sender_id() != msg.get_receiver_id():
            # inside a disconnect window everything on the wire is lost,
            # both ways; self-addressed ticks never leave the process
            return FaultRule(op="drop", direction=direction)
        for i, rule in enumerate(self.plan.rules):
            if not rule.matches(msg, direction):
                continue
            with self._rng_lock:
                self._matched[i] += 1
                if self._matched[i] <= rule.after:
                    continue
                if rule.max_count is not None \
                        and self._fired[i] >= rule.max_count:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                self._fired[i] += 1
            return rule
        return None

    def _apply_send(self, msg: Message, rule: FaultRule) -> None:
        self.bump("faults_injected")
        self.bump(f"fault_{rule.op}")
        if rule.op == "drop":
            return
        if rule.op == "disconnect":
            self._down_until = time.monotonic() + rule.duration_ms / 1e3
            return  # the triggering message is the partition's first loss
        if rule.op == "delay":
            with self._rng_lock:
                key = self._pending_ids
                self._pending_ids += 1
                t = threading.Timer(rule.delay_ms / 1e3, self._late_send,
                                    args=(key,))
                t.daemon = True
                self._pending[key] = (t, msg)
            t.start()
            return
        if rule.op == "duplicate":
            # the inner backend stamps the seq on the first send and the
            # stamp is idempotent: the copy ships the same seq
            self.inner.send_message(msg)
            self.inner.send_message(msg)
            return
        if rule.op == "corrupt":
            with self._rng_lock:
                bad = _corrupt_frame(msg, self._rng)
            self.inner.send_message(bad if bad is not None else msg)

    def _late_send(self, key: int) -> None:
        with self._rng_lock:
            entry = self._pending.pop(key, None)
        if entry is None:  # flushed by stop_receive_message
            return
        try:
            self.inner.send_message(entry[1])
        except Exception:  # delayed past shutdown: log, keep the thread
            logging.warning("fault-injected delayed send failed "
                            "(backend shut down?)", exc_info=True)

    # -- BaseCommunicationManager surface ----------------------------------
    def send_message(self, msg: Message) -> None:
        rule = self._pick(msg, "send")
        if rule is None:
            self.inner.send_message(msg)
            return
        self._apply_send(msg, rule)

    def broadcast(self, msgs, on_error=None) -> Dict[str, int]:
        """Fan-out through the fault engine: each peer's message takes the
        wrapper's own send path (so the rules apply a peer), one after
        another. The per-peer error contract of
        ``BaseCommunicationManager.broadcast``."""
        enqueued = 0
        for msg in msgs:
            try:
                self.send_message(msg)
            except OSError as exc:
                if on_error is None:
                    raise
                on_error(msg.get_receiver_id(), exc)
            enqueued += 1
        return {"enqueued": enqueued, "max_queue_depth": 0}

    def add_observer(self, observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer) -> None:
        self._observers.remove(observer)

    def _deliver(self, msg: Message) -> None:
        """The inbound path (the inner backend's notify): apply the
        recv-side rules, then dispatch to this wrapper's observers."""
        rule = self._pick(msg, "recv")
        if rule is not None:
            self.bump("faults_injected")
            self.bump(f"fault_{rule.op}")
            if rule.op == "drop":
                return
            if rule.op == "disconnect":
                self._down_until = (time.monotonic()
                                    + rule.duration_ms / 1e3)
                return
            if rule.op == "duplicate":
                # above the transport's dedup: observers see the copy
                self._dispatch(msg)
            elif rule.op == "corrupt":
                with self._rng_lock:
                    bad = _corrupt_frame(msg, self._rng)
                if bad is not None:
                    msg = bad
            elif rule.op == "delay":
                time.sleep(rule.delay_ms / 1e3)
        self._dispatch(msg)

    def _dispatch(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        """Send every delayed message still waiting now, in order, cancel
        its timer, then stop the inner backend. (The JAX package leaves
        the timers running past the stop; here no timer outlives its
        endpoint, and a delayed FINISH still reaches its silo.)"""
        with self._rng_lock:
            pending, self._pending = self._pending, {}
        for key in sorted(pending):
            timer, msg = pending[key]
            timer.cancel()
            try:
                self.inner.send_message(msg)
            except Exception:  # the peer may be gone: the run is over
                logging.debug("delayed send flushed at stop failed",
                              exc_info=True)
        for timer, _ in pending.values():
            if timer is not threading.current_thread():
                timer.join(timeout=1.0)
        self.inner.stop_receive_message()


class _InnerTap:
    """The observer bridging the inner backend's notify to the wrapper's
    recv-side path (the wrapper itself is not the observer, so observers
    added to it stay off the inner backend's list)."""

    def __init__(self, wrapper: FaultyCommManager):
        self._wrapper = wrapper

    def receive_message(self, msg_type: int, msg: Message) -> None:
        self._wrapper._deliver(msg)
