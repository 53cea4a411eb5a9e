"""The production :class:`~cruise_control_tpu_torch.kafka.wire.KafkaWire` over
``confluent_kafka`` (VERDICT round-2 item #3; upstream analog: the Java
``AdminClient`` usage in ``executor/Executor.java`` and the consumers in
``monitor/sampling/CruiseControlMetricsReporterSampler.java``).

Every RPC the framework issues is translated to the client's future-based
admin API, plus Producer/per-call-Consumer for the wire topics.  The module
imports ``confluent_kafka`` lazily (at wire construction), so it is
importable — and unit-testable against a mocked ``confluent_kafka`` injected
in ``sys.modules`` — in environments without the client library.

Two client-coverage notes, so nothing fails mysteriously in production:

* ``librdkafka`` (confluent_kafka's engine) historically lacks the KIP-455
  reassignment RPCs and the log-dir RPCs that the Java AdminClient has
  always had.  This wire feature-detects each method on the constructed
  ``AdminClient`` and raises :class:`UnsupportedRpcError` — naming the
  missing client method — instead of guessing.  The call shapes follow the
  client's admin conventions (request mapping in, ``{key: future}`` out) so
  a client release that adds them slots in.
* errors are mapped onto the wire's typed hierarchy
  (:class:`~cruise_control_tpu_torch.kafka.wire.WireTimeoutError` /
  :class:`~cruise_control_tpu_torch.kafka.wire.RetriableWireError` /
  :class:`~cruise_control_tpu_torch.kafka.wire.FatalWireError` /
  :class:`~cruise_control_tpu_torch.kafka.wire.WireError`) using the
  ``KafkaError`` ``retriable()`` / ``fatal()`` / code introspection, so the
  executor's retry policy is client-agnostic.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.kafka.wire import (
    FatalWireError,
    KafkaWire,
    RetriableWireError,
    TopicPartition,
    UnsupportedRpcError,
    WireError,
    WireTimeoutError,
)
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("kafka")

#: KafkaError codes treated as timeouts (client-local _TIMED_OUT is
#: negative; broker REQUEST_TIMED_OUT is 7)
_TIMEOUT_CODES = frozenset({-185, 7})
#: create_topics: already-exists is success for the idempotent create path
_TOPIC_ALREADY_EXISTS = 36


def _kafka_error_of(exc) -> Optional[object]:
    """The ``KafkaError`` inside a ``KafkaException`` (or the error itself)."""
    args = getattr(exc, "args", ())
    err = args[0] if args else None
    return err if hasattr(err, "code") else (
        exc if hasattr(exc, "code") else None
    )


def translate_error(exc, rpc: str) -> WireError:
    """``confluent_kafka`` exception → typed wire error (never raises)."""
    err = _kafka_error_of(exc)
    if err is None:
        return WireError(f"{rpc}: {exc!r}")
    code = err.code()
    msg = f"{rpc}: {err.str() if hasattr(err, 'str') else err} (code {code})"
    if code in _TIMEOUT_CODES:
        return WireTimeoutError(msg)
    if getattr(err, "fatal", lambda: False)():
        return FatalWireError(msg)
    if getattr(err, "retriable", lambda: False)():
        return RetriableWireError(msg)
    return WireError(msg)


class VirtualOffset(int):
    """A consume cursor: the ``int`` the :class:`KafkaWire` seam promises
    (count of records from the log origin up to the consumer's
    per-partition positions) that ALSO carries those positions.  Passing
    it back to :meth:`ConfluentKafkaWire.consume` resumes this consumer's
    exact positions with no shared-snapshot lookup — so two concurrent
    consumers that happen to land on the same virtual offset with
    different per-partition positions (a produce racing their drains on a
    multi-partition topic) can never clobber each other's resume point.
    A plain int (a cursor persisted by a previous process) falls back to
    the snapshot table, then to the count-based skip."""

    starts: Dict[int, int]

    def __new__(cls, value: int, starts: Dict[int, int]):
        self = super().__new__(cls, value)
        self.starts = dict(starts)
        return self

    def __getnewargs__(self):
        # int's default pickle/deepcopy protocol passes (int(self),) to
        # __new__, which would crash on the missing ``starts`` — carry it,
        # so a persisted cursor round-trips with its exact positions
        return (int(self), self.starts)


class ConfluentKafkaWire(KafkaWire):
    """See module docstring.  One instance per cluster; admin + producer are
    shared (both are thread-safe in the client), consumers are created per
    ``consume`` call (the seam's concurrent-consume contract)."""

    #: RPC classes accepted in the ``timeouts`` override map — the
    #: upstream ``*.timeout.ms`` family mapped onto this wire's surface
    #: (upstream: ``describe.cluster.timeout.ms``,
    #: ``list.partition.reassignments.timeout.ms``,
    #: ``logdir.response.timeout.ms``; SURVEY.md §5.6 / CONFIG_DELTA §1)
    TIMEOUT_CLASSES = (
        "describe_cluster", "metadata", "reassignment", "logdirs",
        "produce", "consume",
    )

    def __init__(
        self,
        bootstrap_servers: str,
        client_config: Optional[Dict[str, object]] = None,
        timeout_s: float = 30.0,
        timeouts: Optional[Dict[str, float]] = None,
    ):
        import confluent_kafka
        from confluent_kafka.admin import AdminClient

        self._ck = confluent_kafka
        self._admin_mod = __import__(
            "confluent_kafka.admin", fromlist=["admin"]
        )
        self.timeout_s = timeout_s
        unknown = set(timeouts or ()) - set(self.TIMEOUT_CLASSES)
        if unknown:
            raise ValueError(
                f"unknown RPC timeout class(es) {sorted(unknown)}; "
                f"valid: {list(self.TIMEOUT_CLASSES)}"
            )
        #: per-RPC-class overrides (seconds); anything absent falls back
        #: to the consolidated ``timeout_s``
        self.timeouts: Dict[str, float] = dict(timeouts or {})
        self._conf: Dict[str, object] = {
            "bootstrap.servers": bootstrap_servers,
            **(client_config or {}),
        }
        self._admin = AdminClient(dict(self._conf))
        self._producer = confluent_kafka.Producer(dict(self._conf))
        #: consume cursor SNAPSHOTS keyed by (topic, virtual offset we
        #: returned) → per-partition offsets.  Keyed snapshots (not one
        #: mutable per-topic cursor) let several independent consumers —
        #: e.g. one sampler per metric fetcher — each resume exactly from
        #: the cursor they were handed, concurrently.  Bounded LRU.
        self._cursors: Dict[Tuple[str, int], Dict[int, int]] = {}
        self._cursor_lock = threading.Lock()
        self._max_cursor_snapshots = 64
        self._warned_unsupported_list = False

    # ---- plumbing --------------------------------------------------------------
    def _rpc(self, name: str):
        fn = getattr(self._admin, name, None)
        if fn is None:
            raise UnsupportedRpcError(
                f"the installed confluent_kafka AdminClient has no "
                f"{name}() — this RPC needs a client release with the "
                f"corresponding KIP support (the Java AdminClient has it)"
            )
        return fn

    def _t(self, rpc_class: str) -> float:
        """Effective timeout (seconds) for an RPC class — the per-class
        override when configured, else the consolidated default."""
        return self.timeouts.get(rpc_class, self.timeout_s)

    def _result(self, future, rpc: str, timeout: Optional[float] = None):
        try:
            return future.result(
                timeout=self.timeout_s if timeout is None else timeout)
        except self._ck.KafkaException as e:  # noqa: B904
            raise translate_error(e, rpc) from e
        except Exception as e:  # future timeout / cancellation
            if type(e).__name__ in ("TimeoutError", "CancelledError"):
                raise WireTimeoutError(f"{rpc}: {e!r}") from e
            raise

    def _each_result(self, futures: Dict, rpc: str,
                     timeout: Optional[float] = None) -> Dict:
        return {k: self._result(f, f"{rpc}[{k}]", timeout=timeout)
                for k, f in futures.items()}

    def _tp(self, topic: str, partition: int):
        return self._ck.TopicPartition(topic, partition)

    # ---- metadata -------------------------------------------------------------
    def describe_cluster(self) -> Dict[int, dict]:
        if getattr(self._admin, "describe_cluster", None) is not None:
            desc = self._result(
                self._admin.describe_cluster(
                    request_timeout=self._t("describe_cluster")
                ),
                "describe_cluster",
                timeout=self._t("describe_cluster"),
            )
            return {
                n.id: {"rack": getattr(n, "rack", None) or ""}
                for n in desc.nodes
            }
        # older clients: broker list via metadata (no rack information)
        md = self._admin.list_topics(timeout=self._t("describe_cluster"))
        return {b: {"rack": ""} for b in md.brokers}

    def describe_topics(self) -> Dict[str, List[dict]]:
        md = self._admin.list_topics(timeout=self._t("metadata"))
        out: Dict[str, List[dict]] = {}
        for name, tmd in md.topics.items():
            rows = []
            for pid, pmd in sorted(tmd.partitions.items()):
                err = getattr(pmd, "error", None)
                if err is not None and err.code() != 0:
                    raise translate_error(err, f"describe_topics[{name}]")
                rows.append({
                    "partition": pid,
                    "leader": pmd.leader,
                    "replicas": list(pmd.replicas),
                    "isr": list(pmd.isrs),
                })
            out[name] = rows
        return out

    # ---- reassignment ---------------------------------------------------------
    def alter_partition_reassignments(
        self, targets: Dict[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        fn = self._rpc("alter_partition_reassignments")
        req = {
            self._tp(t, p): (None if new is None else list(new))
            for (t, p), new in targets.items()
        }
        self._each_result(
            fn(req, request_timeout=self._t("reassignment")),
            "alter_partition_reassignments",
            timeout=self._t("reassignment"),
        )

    def list_partition_reassignments(self) -> Dict[TopicPartition, dict]:
        # READ probe: degrade to empty when the client lacks the RPC —
        # the server must still boot (startup recovery calls this
        # unconditionally) and leadership-only operation must still work;
        # an actual MOVE attempt (alter_...) stays loud.
        try:
            fn = self._rpc("list_partition_reassignments")
        except UnsupportedRpcError as e:
            if not self._warned_unsupported_list:
                self._warned_unsupported_list = True
                LOG.warning(
                    "list_partition_reassignments unsupported by the "
                    "installed client — reporting no in-flight "
                    "reassignments (%s)", e,
                )
            return {}
        listing = self._result(
            fn(request_timeout=self._t("reassignment")),
            "list_partition_reassignments",
            timeout=self._t("reassignment"),
        )
        out: Dict[TopicPartition, dict] = {}
        for tp, st in listing.items():
            key = (tp.topic, tp.partition) if hasattr(tp, "topic") else tp
            out[key] = {
                "replicas": list(st.replicas),
                "adding": list(getattr(st, "adding_replicas", ())),
                "removing": list(getattr(st, "removing_replicas", ())),
            }
        return out

    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        fn = self._rpc("elect_leaders")
        election_type = getattr(self._ck, "ElectionType", None)
        kind = election_type.PREFERRED if election_type else "PREFERRED"
        result = self._result(
            fn(kind, [self._tp(t, p) for t, p in partitions]),
            "elect_leaders",
        )
        # per-partition errors arrive as a map, not an exception; the
        # client may hand back bare KafkaErrors OR KafkaExceptions
        # wrapping them — unwrap either
        for tp, err in (result or {}).items():
            code = getattr(_kafka_error_of(err), "code", lambda: 0)()
            if err is not None and code != 0:
                # ELECTION_NOT_NEEDED (84): the preferred leader already
                # leads — success for our callers
                if code == 84:
                    continue
                raise translate_error(err, f"elect_leaders[{tp}]")

    # ---- configs --------------------------------------------------------------
    def _config_resource(self, rtype: str, name: str, **kwargs):
        ConfigResource = self._admin_mod.ConfigResource
        restype = getattr(
            getattr(ConfigResource, "Type", None) or self._admin_mod,
            rtype.upper(),
        )
        return ConfigResource(restype, name, **kwargs)

    def describe_configs(self, rtype: str, name: str) -> Dict[str, str]:
        res = self._config_resource(rtype, name)
        futures = self._admin.describe_configs([res])
        entries = self._result(
            next(iter(futures.values())), f"describe_configs[{rtype}:{name}]"
        )
        out = {}
        for key, entry in entries.items():
            value = getattr(entry, "value", entry)
            if value is not None:
                out[key] = str(value)
        return out

    def incremental_alter_configs(
        self, rtype: str, name: str, updates: Dict[str, Optional[str]]
    ) -> None:
        ConfigEntry = self._admin_mod.ConfigEntry
        op = self._admin_mod.AlterConfigOpType
        entries = [
            ConfigEntry(
                k,
                v if v is not None else "",
                incremental_operation=(op.SET if v is not None else op.DELETE),
            )
            for k, v in updates.items()
        ]
        res = self._config_resource(rtype, name, incremental_configs=entries)
        futures = self._rpc("incremental_alter_configs")([res])
        self._each_result(futures, f"incremental_alter_configs[{rtype}:{name}]")

    # ---- log dirs (JBOD) ------------------------------------------------------
    def alter_replica_log_dirs(
        self, moves: Dict[Tuple[str, int, int], str]
    ) -> None:
        fn = self._rpc("alter_replica_log_dirs")
        # replica addressing (Java TopicPartitionReplica): plain
        # (topic, partition, broker) tuples keyed to the target dir
        futures = fn({(t, p, b): d for (t, p, b), d in moves.items()})
        self._each_result(futures, "alter_replica_log_dirs")

    def describe_log_dirs(self) -> Dict[int, Dict[str, dict]]:
        fn = self._rpc("describe_log_dirs")
        md = self._admin.list_topics(timeout=self._t("metadata"))
        brokers = list(md.brokers)
        listing = self._each_result(
            fn(brokers, request_timeout=self._t("logdirs")),
            "describe_log_dirs", timeout=self._t("logdirs"),
        )
        out: Dict[int, Dict[str, dict]] = {}
        for broker, dirs in listing.items():
            out[broker] = {}
            for d, info in dirs.items():
                replicas = [
                    (tp.topic, tp.partition) if hasattr(tp, "topic") else tp
                    for tp in getattr(info, "replicas", ())
                ]
                # clients may attach a KafkaError with code 0 (NO_ERROR)
                # to healthy dirs — truthiness would mark everything
                # offline and trip cluster-wide disk self-healing
                err = getattr(info, "error", None)
                offline = err is not None and (
                    getattr(err, "code", lambda: 1)() != 0
                )
                out[broker][d] = {
                    "offline": offline,
                    "replicas": replicas,
                }
        return out

    # ---- topics as logs -------------------------------------------------------
    def create_topic(self, name: str, num_partitions: int = 1,
                     replication_factor: int = 1,
                     configs: Optional[Dict[str, str]] = None) -> None:
        NewTopic = self._admin_mod.NewTopic
        topic = NewTopic(
            name, num_partitions=num_partitions,
            replication_factor=replication_factor, config=dict(configs or {}),
        )
        futures = self._admin.create_topics([topic])
        try:
            self._each_result(futures, f"create_topic[{name}]")
        except WireError as e:
            cause = _kafka_error_of(e.__cause__) if e.__cause__ else None
            if cause is not None and cause.code() == _TOPIC_ALREADY_EXISTS:
                return  # idempotent create
            raise

    def produce(self, topic: str, records: Sequence[bytes],
                keys: Optional[Sequence[bytes]] = None) -> None:
        errors: List[object] = []

        def on_delivery(err, _msg):
            if err is not None:
                errors.append(err)

        for i, rec in enumerate(records):
            key = keys[i] if keys is not None else None
            try:
                self._producer.produce(
                    topic, value=rec, key=key, on_delivery=on_delivery,
                )
            except BufferError:
                # local queue full (batches > queue.buffering.max.messages):
                # service the delivery queue to drain, then retry once
                self._producer.poll(self._t("produce"))
                try:
                    self._producer.produce(
                        topic, value=rec, key=key, on_delivery=on_delivery,
                    )
                except BufferError as e:
                    raise RetriableWireError(
                        f"produce[{topic}]: local queue still full after "
                        f"drain ({i}/{len(records)} enqueued)"
                    ) from e
        remaining = self._producer.flush(self._t("produce"))
        if remaining:
            raise WireTimeoutError(
                f"produce[{topic}]: {remaining} records undelivered after "
                f"{self._t('produce')}s"
            )
        if errors:
            raise translate_error(
                self._ck.KafkaException(errors[0]), f"produce[{topic}]"
            )

    def consume(self, topic: str, offset: int) -> Tuple[List[bytes], int]:
        """Drain the topic from the seam's single-log virtual ``offset``.

        The seam models a topic as one offset-addressed log; real topics
        have partitions.  This wire keeps SNAPSHOTS mapping each virtual
        offset it has returned to the per-partition offsets behind it:
        passing such an offset back resumes every partition exactly (each
        independent consumer — e.g. one sampler per fetcher — holds its
        own cursor and resumes its own snapshot, concurrently).  An
        unknown offset (0, or a cursor from a previous process) re-reads
        from the broker's earliest offsets and drops the first
        ``offset - trimmed`` records, where ``trimmed`` is the record
        count the broker has deleted below the earliest watermarks — so a
        retention-trimmed topic never double-drops live records.  The
        count-based skip is exact for single-partition topics (this
        wire's auto-created topics default to one partition), approximate
        across partitions otherwise, which the samplers tolerate (records
        carry their own timestamps).

        Each call builds its own consumer (concurrent-consume contract)
        and reads to the high watermarks captured at entry, so a
        concurrent producer cannot stall the drain.
        """
        own = getattr(offset, "starts", None) if offset != 0 else None
        if own is not None:
            # the caller handed back a VirtualOffset we returned: resume
            # its exact per-partition positions, immune to any other
            # consumer's snapshots
            resume, starts = True, dict(own)
        else:
            with self._cursor_lock:
                snapshot = self._cursors.get((topic, int(offset)))
                resume = snapshot is not None and offset != 0
                starts = dict(snapshot) if resume else {}
        consumer = self._ck.Consumer({
            **self._conf,
            "group.id": f"cruise-control-wire-{uuid.uuid4().hex}",
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
        })
        records: List[bytes] = []
        ends: Dict[int, int] = {}
        trimmed = 0
        try:
            md = consumer.list_topics(topic, timeout=self._t("consume"))
            tmd = md.topics.get(topic)
            if tmd is None or getattr(tmd, "error", None):
                return [], offset
            parts = sorted(tmd.partitions)
            assignment = []
            for p in parts:
                lo, hi = consumer.get_watermark_offsets(
                    self._tp(topic, p), timeout=self._t("consume")
                )
                trimmed += lo
                start = max(starts.get(p, lo), lo)
                ends[p] = hi
                starts[p] = start
                if start < hi:
                    tp = self._tp(topic, p)
                    tp.offset = start
                    assignment.append(tp)
            if assignment:
                consumer.assign(assignment)
            done = {p for p in parts if starts[p] >= ends[p]}
            while len(done) < len(parts):
                msg = consumer.poll(timeout=self._t("consume"))
                if msg is None:
                    break  # drained what the broker would give us
                err = msg.error()
                if err is not None:
                    if err.code() == -191:  # _PARTITION_EOF
                        done.add(msg.partition())
                        continue
                    raise translate_error(err, f"consume[{topic}]")
                p = msg.partition()
                if msg.offset() >= ends[p]:
                    done.add(p)
                    continue
                records.append(msg.value())
                starts[p] = msg.offset() + 1
                if starts[p] >= ends[p]:
                    done.add(p)
        finally:
            consumer.close()
        if not resume:
            # re-read from earliest: virtual position counts from the log
            # origin, so records below the earliest watermark are already
            # "behind" the caller's cursor — only skip what is still
            # readable past it
            records = records[max(0, offset - trimmed):]
        # The virtual offset is DEFINED as the sum of per-partition
        # positions measured from the log origin.  This equals the old
        # offset+records arithmetic whenever the resume snapshot summed to
        # ``offset`` (the normal case), and stays truthful when it did not
        # (a min-merged collision snapshot sums below its key): a re-read
        # must not inflate the cursor past the count of records ever
        # produced, or a later restart's count-based skip would drop live
        # records.
        next_virtual = sum(starts.values())
        with self._cursor_lock:
            # Two concurrent consumers can end at the SAME virtual offset
            # with DIFFERENT per-partition positions (a produce racing the
            # drains on a multi-partition topic).  Overwriting would make
            # one consumer's next resume skip records it never read; merge
            # with per-partition minimums instead — a re-read is tolerable
            # (records carry their own timestamps), a skip is data loss.
            prior = self._cursors.pop((topic, next_virtual), None)
            snap = starts
            if prior is not None and prior != starts:
                # a partition absent from one side means that consumer
                # never read it (e.g. added after its drain): the only
                # conservative position for it is 0 → resume falls back to
                # the earliest offset, a re-read — never the OTHER
                # consumer's position, which would skip records
                snap = {
                    p: min(starts.get(p, 0), prior.get(p, 0))
                    for p in set(starts) | set(prior)
                }
            self._cursors[(topic, next_virtual)] = snap
            while len(self._cursors) > self._max_cursor_snapshots:
                self._cursors.pop(next(iter(self._cursors)))
        # the returned cursor carries THIS consumer's exact positions even
        # when the shared snapshot above was min-merged with a collision
        return records, VirtualOffset(next_virtual, starts)
