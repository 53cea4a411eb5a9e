"""cccli — command-line client for the REST API (upstream
``cruise-control-client`` ``cccli``; SURVEY.md §2.9).

One subcommand per endpoint; async operations long-poll the
``User-Task-ID`` header until the server reports completion.  Pure stdlib
(``urllib``) — the reference uses ``requests``, but the protocol is four
lines of HTTP.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

USER_TASK_HEADER = "User-Task-ID"


class CruiseControlClient:
    def __init__(self, base_url: str, user: Optional[str] = None,
                 password: Optional[str] = None, poll_interval_s: float = 0.2,
                 timeout_s: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        self._auth = None
        if user is not None:
            token = base64.b64encode(
                f"{user}:{password or ''}".encode()
            ).decode()
            self._auth = f"Basic {token}"

    # ---- transport --------------------------------------------------------------
    def _request(self, method: str, endpoint: str, params: Dict[str, str],
                 task_id: Optional[str] = None) -> Tuple[int, dict, str]:
        query = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None}
        )
        url = f"{self.base_url}/{endpoint}" + (f"?{query}" if query else "")
        req = urllib.request.Request(url, method=method)
        if self._auth:
            req.add_header("Authorization", self._auth)
        if task_id:
            req.add_header(USER_TASK_HEADER, task_id)
        try:
            # a socket timeout bounds EVERY request: without it a wedged
            # server blocks the caller forever — timeout_s otherwise only
            # bounds the 202 poll loop
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = json.loads(resp.read().decode() or "{}")
                return resp.status, body, resp.headers.get(USER_TASK_HEADER, "")
        except urllib.error.HTTPError as e:
            body = json.loads(e.read().decode() or "{}")
            return e.code, body, e.headers.get(USER_TASK_HEADER, "")

    def get(self, endpoint: str, **params) -> dict:
        code, body, _ = self._request("GET", endpoint, params)
        if code >= 400:
            raise CruiseControlError(code, body)
        return body

    def post(self, endpoint: str, **params) -> dict:
        """POST; for async endpoints, poll until the task completes."""
        code, body, task_id = self._request("POST", endpoint, params)
        deadline = time.time() + self.timeout_s
        while code == 202 and task_id:
            if time.time() > deadline:
                raise TimeoutError(f"task {task_id} still running")
            time.sleep(self.poll_interval_s)
            # re-issue the same request with the task id (upstream cccli
            # semantics) so response-shaping params like verbose= survive
            code, body, task_id = self._request(
                "POST", endpoint, params, task_id=task_id
            )
        if code >= 400:
            raise CruiseControlError(code, body)
        return body


class CruiseControlError(RuntimeError):
    def __init__(self, code: int, body: dict):
        super().__init__(f"HTTP {code}: {body.get('errorMessage', body)}")
        self.code = code
        self.body = body


# ---------------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cccli", description="Cruise Control TPU command-line client"
    )
    p.add_argument("-a", "--address", default="http://127.0.0.1:9090",
                   help="server address (http://host:port)")
    p.add_argument("--user")
    p.add_argument("--password")
    sub = p.add_subparsers(dest="command", required=True)

    for name in ("state", "load", "kafka_cluster_state", "user_tasks",
                 "review_board"):
        sub.add_parser(name)
    pl = sub.add_parser("partition_load")
    pl.add_argument("--resource", default="DISK")
    pl.add_argument("--entries", type=int, default=20)
    pr = sub.add_parser("proposals")
    pr.add_argument("--verbose", action="store_true")
    pr.add_argument("--ignore-cache", action="store_true")

    def mutating(name):
        sp = sub.add_parser(name)
        # dryrun by default (upstream cccli safety): --no-dryrun executes
        sp.add_argument("--dryrun", action=argparse.BooleanOptionalAction,
                        default=True)
        sp.add_argument("--goals", help="comma-separated goal names")
        sp.add_argument("--engine", choices=["greedy", "cuda"])
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--review-id", type=int)
        return sp

    rb = mutating("rebalance")
    rb.add_argument("--rebalance-disk", action="store_true",
                    help="JBOD intra-broker disk balancing")
    rb.add_argument("--kafka-assigner", action="store_true",
                    help="legacy kafka-assigner mode goals")
    for name in ("add_broker", "remove_broker", "demote_broker"):
        sp = mutating(name)
        sp.add_argument("brokers", help="comma-separated broker ids")
    mutating("fix_offline_replicas")
    tc = sub.add_parser("topic_configuration")
    tc.add_argument("--replication-factor", type=int, required=True)
    tc.add_argument("--topic", help="topic name regex to scope the change")
    tc.add_argument("--dryrun", action=argparse.BooleanOptionalAction,
                    default=True)
    sub.add_parser("rightsize")
    sub.add_parser("stop_proposal_execution")
    sub.add_parser("pause_sampling")
    sub.add_parser("resume_sampling")
    ad = sub.add_parser("admin")
    ad.add_argument("--enable-self-healing-for")
    ad.add_argument("--disable-self-healing-for")
    ad.add_argument("--concurrent-partition-movements-per-broker", type=int)
    ad.add_argument("--concurrent-leader-movements", type=int)
    rv = sub.add_parser("review")
    rv.add_argument("--approve", help="comma-separated review ids")
    rv.add_argument("--discard", help="comma-separated review ids")
    rv.add_argument("--reason")
    sub.add_parser("train")
    return p


def run_command(client: CruiseControlClient, args: argparse.Namespace) -> dict:
    cmd = args.command
    if cmd in ("state", "load", "kafka_cluster_state", "user_tasks",
               "review_board"):
        return client.get(cmd)
    if cmd == "partition_load":
        return client.get(cmd, resource=args.resource, entries=args.entries)
    if cmd == "proposals":
        return client.get(
            cmd,
            verbose=str(args.verbose).lower(),
            ignore_proposal_cache=str(args.ignore_cache).lower(),
        )
    if cmd in ("rebalance", "fix_offline_replicas", "add_broker",
               "remove_broker", "demote_broker"):
        params = {
            "dryrun": str(args.dryrun).lower(),
            "goals": args.goals,
            "engine": args.engine,
            "verbose": str(args.verbose).lower(),
        }
        if args.review_id is not None:
            params["review_id"] = str(args.review_id)
        if cmd in ("add_broker", "remove_broker", "demote_broker"):
            params["brokerid"] = args.brokers
        if cmd == "rebalance" and args.rebalance_disk:
            params["rebalance_disk"] = "true"
        if cmd == "rebalance" and args.kafka_assigner:
            params["kafka_assigner"] = "true"
        return client.post(cmd, **params)
    if cmd == "topic_configuration":
        params = {
            "replication_factor": str(args.replication_factor),
            "dryrun": str(args.dryrun).lower(),
        }
        if args.topic:
            params["topic"] = args.topic
        return client.post(cmd, **params)
    if cmd in ("rightsize", "stop_proposal_execution", "pause_sampling",
               "resume_sampling", "train"):
        return client.post(cmd)
    if cmd == "admin":
        return client.post(
            cmd,
            enable_self_healing_for=args.enable_self_healing_for,
            disable_self_healing_for=args.disable_self_healing_for,
            concurrent_partition_movements_per_broker=(
                None
                if args.concurrent_partition_movements_per_broker is None
                else str(args.concurrent_partition_movements_per_broker)
            ),
            concurrent_leader_movements=(
                None if args.concurrent_leader_movements is None
                else str(args.concurrent_leader_movements)
            ),
        )
    if cmd == "review":
        return client.post(
            cmd, approve=args.approve, discard=args.discard,
            reason=args.reason,
        )
    raise ValueError(f"unknown command {cmd}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    client = CruiseControlClient(
        f"{args.address.rstrip('/')}/kafkacruisecontrol",
        user=args.user, password=args.password,
    )
    try:
        out = run_command(client, args)
    except (CruiseControlError, TimeoutError) as e:
        print(str(e), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.address}: {e.reason}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
