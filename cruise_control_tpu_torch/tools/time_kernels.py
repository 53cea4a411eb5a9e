"""Time K1 ``grid_top_r``, K11 ``top_select``, K17 ``grid_patch``, K9
``recompute_aggregates``, K12 ``whatif_verdict``, K4 ``budget_accept`` and
K7 ``compact_rows`` on the card at the shapes their paths give them,
through a checkout's own ``chip_smoke.py`` checks.

    python3 cruise_control_tpu_torch/tools/time_kernels.py [--root DIR]
        [--label NAME] [--only NAME[,NAME...]]

``--root`` (default: the checkout that holds this script) names the
checkout whose ``chip_smoke.py`` and package are imported, for example an
older commit unpacked with ``git archive``, so that two versions of the
kernels can be timed in turns within one run on one card.  Run it by its
path, not with ``-m``: the package must come from that checkout.
``--only`` keeps the named kernels (default: all seven).

Each kernel is held bit for bit to its plain twin and timed by
``chip_smoke.py`` itself (its records print as it emits them: wrapper ms
by CUDA events, device ms of the kernel alone by ``torch.profiler``, the
plain twin, the bound, the library call where there is one).  After each,
one summary line ``{"tree": ..., "case": ..., "name": ..., ...}``.  The
cases: K11 on chip_smoke's tie-rich priority at 60 000 → 8 192 / 2 048 /
1 024, 1 000 → 1 000, 73 728 → 2 048, 8 252 000 → 2 048 and 3 000 000 →
8 192 (and, where the checkout has ``top_select_grid``, 60 000 → 8 192
launched on the selecting blocks alone); K1 over the 1 000-broker /
20 000-partition and 50-broker / 1 000-partition fixtures' first-step
grids and at replication factors 1, 2, 4 and 8; K1's row-list and carry
forms and K17 on the first patching step of an incremental search; K9 on
the 1 000 / 20 000 uploaded model (mean and percentile loads), at the
north star's 3 M slots and on the skewed placement (one broker hosting a
quarter of the slots) at 1 000 and at 10 000 brokers; K12 at 50 / 1 000
× 64, 1 000 / 20 000 × 64 and × 256, the north star × 64 and the two
skewed cases, then the batched call around it (``evaluate_batch``, best
of 5, with its host compile and upload) at 50 / 1 000 × 64 and 1 000 /
20 000 × 64 and × 256.  K9 and K12
also get every launch's device ms by name (memsets included) and their
host side (``host_us``): the whole wrapper, its one ctypes call that makes
every launch, the layout query (a ctypes call with no CUDA work) and the
``index_add_`` yardstick, each in host µs a call.  K4 runs on the
1 000 / 20 000 first step's cohort and on chip_smoke's cut and skewed
cohorts (one destination, one source, 777 rows, 1 row, 10 000 brokers),
K7 on that first step's 5 000 keys and on the tie-rich keys at 5 000
(C = 1 024, 777, 1) and 50 000; each record adds the kernel's resources
(``attrs``) and, where the checkout's kernel has phase stamps
(``CC_STAMP`` in its source), its device time split by phase: the kernel
is built once more with ``-DCC_PHASE_STAMPS`` and run alone 30 times, and
``device_ms_by_phase`` / ``phase_cycles`` are the median ms
(``%globaltimer``) and SM cycles (``clock64``) between its stamps.
Needs a card.
"""


from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

KEYS = ("K", "D", "S", "N", "k", "P", "B", "blocks",
        "top_broker_share", "attrs", "ms",
        "C", "NB", "NROW", "distinct_dst", "distinct_src",
        "device_ms", "device_ms_by_phase", "phase_cycles", "stamped_ms",
        "launch_ms_by_name", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "library_sort_ms",
        "evaluate_batch_ms", "compile_futures_ms", "h2d_scale_ms",
        "host_us")
ALL = ("top_select", "grid_top_r", "grid_patch", "recompute_aggregates",
       "whatif_verdict", "budget_accept", "compact_rows")
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


def helper(cs, here: Path, name: str):
    """chip_smoke's function ``name``, from this script's own checkout
    when ``cs`` (an older one) has none."""
    if hasattr(cs, name):
        return getattr(cs, name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", here / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return getattr(own, name)


def host_us(fn, reps: int = 50, rounds: int = 7):
    """[min, median] host µs that a call of ``fn`` takes to return, over
    ``rounds`` runs of ``reps`` calls.  The calls only enqueue work, and
    ``reps`` of them stay well inside the card's launch queue, so no call
    waits for the card."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return [times[0], times[len(times) // 2]]


def host_split(wrapper, library, launch=None, layout=None):
    """The host side of one kernel call (see :func:`host_us`); the launch
    call and the layout query where the checkout's wrapper has them."""
    wrapper()
    rec = {"wrapper": host_us(wrapper), "library": host_us(library)}
    if launch is not None:
        rec["launch_call"] = host_us(launch)
        rec["layout_call"] = host_us(layout)
    return rec


def launch_ms(cs, fn):
    """Device ms a call of ``fn`` by launch name, memsets included."""
    return cs.device_ms(fn, "", by_name=True)


def stamped_library(kernels, name: str):
    """Kernel ``name`` built with ``-DCC_PHASE_STAMPS`` beside its library,
    or None when its source has no stamps (an older checkout)."""
    src = kernels.CSRC / f"{name}.cu"
    if "CC_STAMP" not in src.read_text():
        return None
    path = kernels.library_path(name)
    path = path.with_name(path.name.replace(f"lib{name}-",
                                            f"lib{name}-stamps-"))
    if not path.exists():
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DCC_PHASE_STAMPS",
             "-o", str(path), str(src)], capture_output=True, text=True)
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"stamped build of {name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(path))
    lib.cc_phase_stamps.argtypes = [ctypes.c_void_p]
    lib.cc_phase_stamps.restype = ctypes.c_int
    return lib


def phase_split(kernels, name: str, phases, run, reps: int = 30):
    """``run()`` (one launch of kernel ``name``'s wrapper) on the stamped
    build, ``reps`` times alone → {"device_ms_by_phase", "phase_cycles",
    "stamped_ms"}: the median ms and SM cycles between consecutive stamps,
    and of the whole stamped launch; {} when the kernel has no stamps."""
    lib = stamped_library(kernels, name)
    if lib is None:
        return {}
    n = len(phases) + 1
    buf = torch.zeros(2 * n, dtype=torch.int64, device="cuda")
    saved = kernels._loaded.get(name)
    kernels.launched(name, lib.cc_phase_stamps(buf.data_ptr()))
    kernels._loaded[name] = lib
    rows = []
    try:
        for _ in range(reps):
            buf.zero_()
            run()
            torch.cuda.synchronize()
            rows.append(buf.view(n, 2).cpu().tolist())
    finally:
        lib.cc_phase_stamps(None)
        if saved is None:
            kernels._loaded.pop(name, None)
        else:
            kernels._loaded[name] = saved

    def med(i, j, col):
        return statistics.median(r[j][col] - r[i][col] for r in rows)
    return {
        "device_ms_by_phase": {p: med(i, i + 1, 0) * 1e-6
                               for i, p in enumerate(phases)},
        "phase_cycles": {p: med(i, i + 1, 1) for i, p in enumerate(phases)},
        "stamped_ms": med(0, n - 1, 0) * 1e-6}


def time_budget_accept(cs, summary, random_cluster, dev, here):
    """K4 on the 1 000 / 20 000 first step's cohort and chip_smoke's cut
    and skewed cohorts."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    calls, _ = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {}, dev)
    cases = {"midscale": calls["budget_accept"],
             **helper(cs, here, "cohort_cases")(calls, dev)}
    check = helper(cs, here, "check_budget_accept")
    phases = getattr(SK, "budget_accept_phases", lambda r: ())(2)
    for case, (args, kw) in cases.items():
        rec = check(case, args, kw, False, True)["budget_accept"]
        rec.update(phase_split(SK.kernels, "budget_accept", phases,
                               lambda: SK.budget_accept(*args, **kw)))
        if hasattr(SK, "budget_accept_attrs"):
            rec["attrs"] = SK.budget_accept_attrs(
                args[0].capacity.shape[0], *args[4].shape)
        summary("budget_accept", rec)


def time_compact_rows(cs, summary, random_cluster, dev, here):
    """K7 on the 1 000 / 20 000 first step's keys and chip_smoke's
    tie-rich keys at 5 000 and 50 000."""
    from cruise_control_tpu_torch.analyzer import compact_kernel as K7

    calls, _ = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {}, dev)
    cases = {"midscale": calls["compact_rows"],
             **{c: (a, {}) for c, a in
                helper(cs, here, "compaction_cases")(dev).items()}}
    phases = getattr(K7, "COMPACT_ROWS_PHASES", ())
    for case, (args, kw) in cases.items():
        rec = cs.check_compact_rows(case, args, kw, False, True)[
            "compact_rows"]
        rec.update(phase_split(K7.kernels, "compact_rows", phases,
                               lambda: K7.compact_rows(*args, **kw)))
        if hasattr(K7, "compact_rows_attrs"):
            rec["attrs"] = K7.compact_rows_attrs(args[11], rec["NROW"])
        summary("compact_rows", rec)


def time_top_select(cs, summary, PK, kernels, dev):
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


def time_grid(cs, summary, G, random_cluster, dev, only):
    fixtures = [("midscale", cs.MIDSCALE),
                ("50b_1k", dict(cs.SMALL, seed=42))]
    fixtures += [(f"rf{S}", dict(seed=5, num_brokers=200, num_racks=20,
                                 num_partitions=4000, replication_factor=S))
                 for S in (1, 2, 4, 8)]
    if "grid_top_r" in only:
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
        if name.split("[")[0] in only:
            summary(name, recs[name])


def time_recompute_aggregates(cs, summary, random_cluster, dev, here):
    """K9 on the uploaded 1 000 / 20 000 model (mean and percentile
    loads), at the north star's 3 M slots and on the skewed placement at
    both sizes."""
    import dataclasses

    from cruise_control_tpu_torch.analyzer import commit_kernels as K89

    mid = random_cluster(**cs.MIDSCALE)
    m_mid = cs.first_step_calls(mid, {}, dev)[0]["recompute_aggregates"][0][0]
    m_pct = cs.first_step_calls(cs.with_percentile(mid), {}, dev)[0][
        "recompute_aggregates"][0][0]
    skew = helper(cs, here, "skew_placement")
    slot_loads = helper(cs, here, "aggregate_slot_loads")
    m_skew = dataclasses.replace(m_mid, assignment=skew(m_mid.assignment))
    m_ns = cs.north_star_placement(dev)
    m_ns_skew = dataclasses.replace(m_ns, assignment=skew(m_ns.assignment))
    kernels = K89.kernels
    st = kernels.stream(dev)
    sms = kernels.sm_count(dev)
    for case, m, cap in (
            ("midscale", m_mid, False), ("midscale_percentile", m_pct, True),
            ("north_star_slots", m_ns, True), ("skew", m_skew, False),
            ("north_star_skew", m_ns_skew, True)):
        rec = cs.check_recompute_aggregates(case, m, cap, True)
        P, S = m.assignment.shape
        B, NR = m.capacity.shape
        rec["launch_ms_by_name"] = launch_ms(
            cs, lambda: K89.recompute_aggregates(m))
        # the host side: the wrapper, the yardstick and, where the wrapper
        # makes one buffer, its one ctypes call on a buffer of its own and
        # the layout query
        rows, ids = slot_loads(m)
        split = [lambda: K89.recompute_aggregates(m),
                 lambda: torch.zeros((B + 1, NR), device=dev).index_add_(
                     0, ids, rows)]
        buf = None
        if hasattr(K89, "_agg_layout"):
            lib = kernels.load("recompute_aggregates")
            buf = torch.empty(K89._agg_layout(P, S, B, cap, sms)[1],
                              dtype=torch.uint8, device=dev)
            ptrs = [x.data_ptr() if x is not None else None for x in (
                m.assignment, m.leader_slot, m.leader_load, m.follower_load,
                m.leader_cload, m.follower_cload)]
            off = (ctypes.c_longlong * 8)()
            split += [
                lambda: kernels.launched(
                    "recompute_aggregates", lib.recompute_aggregates_launch(
                        *ptrs, P, S, B, sms, buf.data_ptr(), st)),
                lambda: lib.recompute_aggregates_layout(P, S, B, int(cap),
                                                        sms, off)]
        rec["host_us"] = host_split(*split)
        summary("recompute_aggregates", rec)
        del m, buf, rows, ids


def time_whatif_verdict(cs, summary, random_cluster, dev, here):
    """K12 at 50 / 1 000 × 64, 1 000 / 20 000 × 64 and × 256, the north
    star × 64 and the two skewed cases, then ``evaluate_batch``."""
    from cruise_control_tpu_torch.whatif import artifact as A
    from cruise_control_tpu_torch.whatif import verdict_kernels as VK
    from cruise_control_tpu_torch.whatif.compiler import compile_futures
    from cruise_control_tpu_torch.whatif.engine import verdict_inputs

    def inputs(state, n):
        return verdict_inputs(state, compile_futures(
            state, A.artifact_futures(state, n)), device=dev)

    small = random_cluster(seed=42, **cs.SMALL)
    mid = random_cluster(**cs.MIDSCALE)
    margs = inputs(mid, cs.WHATIF_FUTURES)
    hot = helper(cs, here, "skew_placement")(margs[0])
    alive_hot = margs[7].clone()
    alive_hot[:, 0] = False
    dead_hot = alive_hot.clone()
    dead_hot[::2, 0] = True
    cases = [("50b_1k_x64", lambda: inputs(small, cs.WHATIF_FUTURES)),
             ("midscale_x64", lambda: margs),
             ("midscale_x256", lambda: inputs(mid, cs.WHATIF_MAX_FUTURES)),
             ("north_star_x64", lambda: cs.whatif_north_star(dev)),
             ("skew_x64", lambda: (hot,) + margs[1:7] + (alive_hot,)
              + margs[8:]),
             ("skew_dead_x64", lambda: (hot,) + margs[1:7] + (dead_hot,)
              + margs[8:])]
    kernels = VK.kernels
    st = kernels.stream(dev)
    sms = kernels.sm_count(dev)
    for case, make in cases:
        args = make()
        rec = cs.check_whatif_verdict(
            case, args, plain_reps=2 if "north" in case else 10)
        rec["launch_ms_by_name"] = launch_ms(
            cs, lambda: VK.whatif_verdict(*args))
        # the host side: the wrapper, the yardstick and, where the wrapper
        # makes one buffer, its one ctypes call (every launch) on a buffer
        # of its own and the layout query
        N, P = args[8].shape
        S, B, R = args[0].shape[1], args[4].shape[0], args[4].shape[1]
        rows, ids = cs.whatif_slot_loads(args)
        split = [lambda: VK.whatif_verdict(*args),
                 lambda: torch.zeros((N * (B + 1), R), device=dev)
                 .index_add_(0, ids, rows)]
        buf = None
        if hasattr(VK, "_layout"):
            lib = kernels.load("whatif_verdict")
            buf = torch.empty(VK._layout(N, P, S, B, sms)[1],
                              dtype=torch.uint8, device=dev)
            ptrs = [x.data_ptr() for x in args]
            off = (ctypes.c_longlong * 14)()
            split += [
                lambda: kernels.launched(
                    "whatif_verdict", lib.whatif_verdict_launch(
                        *ptrs, N, P, S, B, sms, buf.data_ptr(), st)),
                lambda: lib.whatif_verdict_layout(N, P, S, B, sms, off)]
        rec["host_us"] = host_split(*split)
        summary("whatif_verdict", rec)
        del args, buf, rows, ids
    # the batched call around K12: compile, upload, evaluate_batch
    for case, state, n in (("50b_1k_x64", small, cs.WHATIF_FUTURES),
                           ("midscale_x64", mid, cs.WHATIF_FUTURES),
                           ("midscale_x256", mid, cs.WHATIF_MAX_FUTURES)):
        rec = cs.whatif_timing(case, state, n, dev)
        summary("evaluate_batch", {
            "case": case, "N": rec["batch"],
            "evaluate_batch_ms": rec["evaluate_batch_s"] * 1e3,
            "compile_futures_ms": rec["compile_futures_s"] * 1e3,
            "h2d_scale_ms": rec["h2d_scale_ms"],
            "device_ms": rec["k12_device_ms"]})


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here),
                    help="checkout whose chip_smoke.py and package to time")
    ap.add_argument("--label", default=None, help="tree label in records")
    ap.add_argument("--only", default=",".join(ALL),
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(ALL):
        raise SystemExit(f"time_kernels: --only takes {ALL}")
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
    if "top_select" in only:
        time_top_select(cs, summary, PK, kernels, dev)
    if {"grid_top_r", "grid_patch"} & only:
        time_grid(cs, summary, G, random_cluster, dev, only)
    if "recompute_aggregates" in only:
        time_recompute_aggregates(cs, summary, random_cluster, dev, here)
    if "whatif_verdict" in only:
        time_whatif_verdict(cs, summary, random_cluster, dev, here)
    if "budget_accept" in only:
        time_budget_accept(cs, summary, random_cluster, dev, here)
    if "compact_rows" in only:
        time_compact_rows(cs, summary, random_cluster, dev, here)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
