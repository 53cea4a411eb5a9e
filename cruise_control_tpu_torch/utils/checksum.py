"""Per-record CRC32 framing for the durable JSONL logs (ISSUE 13).

Both durable stores — the execution checkpoint
(:mod:`cruise_control_tpu_torch.executor.journal`) and the telemetry event
journal (:mod:`cruise_control_tpu_torch.telemetry.events`) — are append-only
JSONL files whose readers previously trusted any line that parsed as
JSON.  A torn final line from a real crash is expected and safe, but a
*bit-flipped* record that still parses (a digit changed inside the
positionally-encoded plan, a task state letter swapped) was adopted
verbatim by resume reconciliation.  This module closes that hole:

* :func:`stamp_line` splices a ``"crc"`` field — the CRC32 of the
  serialized record WITHOUT that field — into a serialized JSON object
  as its last member.  The framed line is still one valid JSON object,
  so naive per-line readers keep working.
* :func:`parse_line` classifies one line as ``ok`` (CRC verified),
  ``legacy`` (no ``crc`` field — a record written before this framing;
  format version 1, still loaded), ``corrupt`` (CRC mismatch) or
  ``undecodable`` (not JSON at all — a torn write).

Format versioning is the trailer itself: version-1 lines carry no
``crc`` member and load exactly as before; version-2 lines verify.  A
mixed file is legitimate (an upgraded process appending to a v1 log).

Verification re-serializes the parsed record minus ``crc`` with both
separator styles the writers use (compact and default) — JSON types
round-trip exactly through ``json.loads``/``json.dumps`` with stable
key order, so a byte-identical reconstruction means an intact record.
A flip inside the ``"crc"`` key *name* itself cannot sneak a record
into the legacy path either: a crc-less record whose LAST member still
verifies the rest as an 8-hex CRC is a damaged frame, classified
``corrupt`` (a true v1 record colliding with that shape is a 2^-32
accident).
"""

from __future__ import annotations

import json
import zlib
from typing import List, Optional, Sequence, Tuple

CRC_FIELD = "crc"

#: the two serialization styles the journal writers use; verification
#: tries both so compacted and streamed records check alike
_SEPARATOR_STYLES = ((",", ":"), (", ", ": "))


def _crc(text: str) -> str:
    return format(zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF, "08x")


def stamp_line(line: str, compact: bool = True) -> str:
    """Splice a ``crc`` member (over ``line`` as given) into a serialized
    JSON *object* as its last field.  ``compact`` must match the
    separator style ``line`` was serialized with, so the framed line
    stays style-consistent."""
    if not line.endswith("}"):  # pragma: no cover - writer contract
        raise ValueError("stamp_line needs a serialized JSON object")
    sep = ',"crc":"%s"}' if compact else ', "crc": "%s"}'
    return line[:-1] + sep % _crc(line)


_HEX8 = frozenset("0123456789abcdef")


def _verifies(rest: dict, crc: str) -> bool:
    return any(
        _crc(json.dumps(rest, default=str, separators=seps)) == crc
        for seps in _SEPARATOR_STYLES
    )


def record_status(rec: dict) -> str:
    """``ok`` / ``legacy`` / ``corrupt`` for an already-parsed record."""
    crc = rec.get(CRC_FIELD)
    if not isinstance(crc, str):
        # no "crc" member — usually a v1 (pre-framing) record.  But a
        # bit flip inside the "crc" KEY NAME also lands here with the
        # payload intact: if the record's last member is an 8-hex string
        # that verifies the rest, this is a damaged FRAME, not a legacy
        # record — refuse it rather than adopt a line whose trailer was
        # provably hit
        if rec:
            last_key = next(reversed(rec))
            val = rec[last_key]
            if (last_key != CRC_FIELD and isinstance(val, str)
                    and len(val) == 8 and set(val) <= _HEX8):
                rest = {k: v for k, v in rec.items() if k != last_key}
                if _verifies(rest, val):
                    return "corrupt"
        return "legacy"
    rest = {k: v for k, v in rec.items() if k != CRC_FIELD}
    return "ok" if _verifies(rest, crc) else "corrupt"


def parse_line(line) -> Tuple[Optional[dict], str]:
    """``(record, status)`` for one journal line (str or bytes);
    ``record`` is None unless status is ``ok`` or ``legacy``.  Bytes
    that are not valid UTF-8 (bit rot can hit any byte) classify as
    ``undecodable`` like any other torn line."""
    if isinstance(line, bytes):
        try:
            line = line.decode("utf-8")
        except UnicodeDecodeError:
            return None, "undecodable"
    try:
        rec = json.loads(line)
    except ValueError:
        return None, "undecodable"
    if not isinstance(rec, dict):
        return None, "undecodable"
    status = record_status(rec)
    if status == "corrupt":
        return None, "corrupt"
    return rec, status


def scan_lines(lines: Sequence) -> Tuple[List[dict], List[int], int]:
    """Classify every non-empty line (str or bytes): returns
    ``(records, bad_indices, num_nonempty)`` where ``bad_indices`` index
    into the non-empty line sequence and ``records`` holds the parsed
    good records IN ORDER — the caller applies its
    torn-tail-vs-mid-file policy."""
    records: List[dict] = []
    bad: List[int] = []
    idx = 0
    for line in lines:
        if not line.strip():
            continue
        rec, status = parse_line(line)
        if rec is not None:
            records.append(rec)
        else:
            bad.append(idx)
        idx += 1
    return records, bad, idx
