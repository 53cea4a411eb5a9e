"""``python -m cruise_control_tpu_torch.whatif --artifact PATH`` — run
the what-if subsystem's two gated measurements (the N≥64 batched sweep
on the card and the proactive-vs-reactive scenario twins) and write/print
the ``cc-tpu-whatif/1`` artifact.  Exits 1 when any gate fails.  Until
the port has the scenario simulator (ROADMAP A9) it stops at the
proactive leg with ``NotImplementedError``."""

from __future__ import annotations

import argparse
import json
import sys

from cruise_control_tpu_torch.whatif.artifact import (
    MIN_FUTURES,
    make_artifact,
    measure_batch,
    measure_proactive,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cruise_control_tpu_torch.whatif",
        description="what-if subsystem artifact (cc-tpu-whatif/1)",
    )
    parser.add_argument("--artifact", metavar="PATH",
                        help="write the artifact JSON here")
    parser.add_argument("--futures", type=int, default=MIN_FUTURES,
                        help="batched sweep size (default %(default)s)")
    parser.add_argument("--best-of", type=int, default=3,
                        help="timing repetitions (default %(default)s)")
    args = parser.parse_args(argv)

    batch = measure_batch(num_futures=args.futures, best_of=args.best_of)
    proactive = measure_proactive()
    art = make_artifact(batch, proactive)
    blob = json.dumps(art, indent=1, sort_keys=True)
    if args.artifact:
        with open(args.artifact, "w") as f:
            f.write(blob + "\n")
        print(f"artifact written: {args.artifact}")
    else:
        print(blob)
    for gate, ok in sorted(art["gates"].items()):
        print(f"  {'PASS' if ok else 'FAIL'} {gate}")
    return 0 if art["allOk"] else 1


if __name__ == "__main__":
    sys.exit(main())
