"""Time K1 ``grid_top_r``, K11 ``top_select`` and K17 ``grid_patch`` on the
card at the plan search's shapes, through a checkout's own
``chip_smoke.py`` checks.

    python3 cruise_control_tpu_torch/tools/time_kernels.py [--root DIR]
        [--label NAME]

``--root`` (default: the checkout that holds this script) names the
checkout whose ``chip_smoke.py`` and package are imported, for example an
older commit unpacked with ``git archive``, so that two versions of the
kernels can be timed in turns within one run on one card.  Run it by its
path, not with ``-m``: the package must come from that checkout.

Each kernel is held bit for bit to its plain twin and timed by
``chip_smoke.py`` itself (its records print as it emits them: wrapper ms
by CUDA events, device ms of the kernel alone by ``torch.profiler``, the
plain twin, the bound, and for K11 ``torch.topk`` and a stable descending
``torch.sort`` of the same keys, timed by CUDA events as the wrapper is).
After each, one summary line ``{"tree": ..., "case": ..., "name": ...,
...}``.  The cases: K11 on chip_smoke's tie-rich priority at 60 000 →
8 192 / 2 048 / 1 024, 1 000 → 1 000, 73 728 → 2 048, 8 252 000 → 2 048
and 3 000 000 → 8 192 (and, where the checkout has ``top_select_grid``,
60 000 → 8 192 launched on the selecting blocks alone); K1 over the
1 000-broker / 20 000-partition and 50-broker / 1 000-partition fixtures'
first-step grids and at replication factors 1, 2, 4 and 8; K1's row-list
and carry forms and K17 on the first patching step of an incremental
search.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

KEYS = ("K", "D", "S", "N", "k", "blocks", "attrs", "ms", "device_ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "library_sort_ms")
#: K11's (N, k): the repool's top-K (and smaller k), its top-D, the
#: score-only round's grid and columnar keys, the north star's slots
TOP_SHAPES = ((60_000, 8192), (60_000, 2048), (60_000, 1024), (1000, 1000),
              (73_728, 2048), (8_252_000, 2048), (3_000_000, 8192))


def load_smoke(root: Path):
    """``root``'s chip_smoke.py as a module, its package first on the
    path."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here),
                    help="checkout whose chip_smoke.py and package to time")
    ap.add_argument("--label", default=None, help="tree label in records")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    root = Path(args.root).resolve()
    cs = load_smoke(root)
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.ops import grid as G
    from cruise_control_tpu_torch.ops import kernels

    pkg = Path(G.__file__).resolve().parents[1]
    if pkg.parent != root:
        raise SystemExit(f"time_kernels: the package came from {pkg}, not "
                         f"{root}; run the script by its path")
    label = args.label or str(root)
    dev = torch.device("cuda")

    def summary(name, rec):
        cs.emit({"tree": label, "name": name, "case": rec.get("case"),
                 **{k: rec[k] for k in KEYS if k in rec}})

    cs.emit({"tree": label, "phase": "env", "nvidia_smi": cs.nvidia_smi(),
             "package": str(pkg)})
    kernels.build(list(cs.KERNELS))
    for n, k in TOP_SHAPES:
        a, kw = cs.synthetic_priority(dev, n=n, k=k)
        name = f"top_select[{n}->{k}]"
        summary(name, cs.check_top_select("time", name, a, kw, True)[name])
        if (n, k) == TOP_SHAPES[0] and hasattr(PK, "top_select_grid"):
            # the same call with the rank spread over the selecting
            # blocks alone (one per 4 096 keys)
            x, hi, lo, flat = a
            # (typed by the wrapper's launch above)
            lib = kernels.load("top_select")
            g = -(-n // PK._TOP_PER_BLOCK)

            def launch():
                kernels.launched("top_select", lib.top_select_launch(
                    x.data_ptr(), n, k, kw["S"], hi.data_ptr(),
                    lo.data_ptr(), flat.data_ptr(), kw["state"].data_ptr(),
                    kw["ws"].data_ptr(), g, kernels.stream(dev)))
            summary(f"{name}@selecting_blocks", {
                "N": n, "k": k, "blocks": g,
                "device_ms": cs.device_ms(launch, "top_select_kernel")})
        del a, kw
    fixtures = [("midscale", cs.MIDSCALE),
                ("50b_1k", dict(cs.SMALL, seed=42))]
    fixtures += [(f"rf{S}", dict(seed=5, num_brokers=200, num_racks=20,
                                 num_partitions=4000, replication_factor=S))
                 for S in (1, 2, 4, 8)]
    for case, fixture in fixtures:
        args_, consts = cs.grid_inputs(random_cluster(**fixture), {}, dev)
        rec = cs.check_grid_top_r(case, args_, consts)
        packed = G.grid_terms(*args_[:6], consts)
        rec["device_ms"] = cs.device_ms(
            lambda: G.launch_grid_top_r(packed, args_[7]),
            "grid_top_r_kernel")
        summary("grid_top_r", rec)
        del args_, packed
    recs = cs.check_incremental_kernels(
        "midscale", random_cluster(**cs.MIDSCALE), {}, dev, True)
    for name in ("grid_top_r[rows]", "grid_top_r[carry_full]", "grid_patch"):
        summary(name, recs[name])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
