"""Time sixteen kernels — K1 ``grid_top_r``, K11 ``top_select``, K17
``grid_patch``, K16 ``stale_sets``, K9 ``recompute_aggregates``, K12
``whatif_verdict``, K4
``budget_accept``, K7 ``compact_rows``, K3 ``per_src_top``, K13 (a)
``round_keys``, K8 ``commit_batch``, K5 ``match_batch``, K2
``grid_terms``, K6 ``score_candidates``, K10 ``pool_tables`` and K15
``corrected_accept`` — on the card at the shapes their paths give them,
through a checkout's own ``chip_smoke.py`` checks.

    python3 cruise_control_tpu_torch/tools/time_kernels.py [--root DIR]
        [--label NAME] [--only NAME[,NAME...]]

``--root`` (default: the checkout that holds this script) names the
checkout whose ``chip_smoke.py`` and package are imported, for example an
older commit unpacked with ``git archive``, so that two versions of the
kernels can be timed in turns within one run on one card.  Run it by its
path, not with ``-m``: the package must come from that checkout.
``--only`` keeps the named kernels (default: all sixteen).

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
forms on the first patching step of an incremental search; K16 and K17 on
the first patching step at 1 000 / 20 000 (mean and percentile loads),
the ragged cluster, 50 / 1 000, 10 000 brokers and the north star's
10 000 brokers / 1 000 000 partitions (this checkout's
``patch_step_calls``, ``RESCORE_B10K`` and ``RESCORE_WIDE_KW``), each
bit for bit against its twin (recorded, not raised), acting and idle —
K16 on an inactive step, K17 gated (FRESH = 1) — with ``device_ms_runs``,
``graph_ms`` (16 launches in a captured graph), the plain twin, the
bound from the case's stale counts, ``attrs``, the ``ptxas`` report and
the phases (``STALE_SETS_PHASES``, ``GRID_PATCH_PHASES``); K9 on
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
(``%globaltimer``) and SM cycles (``clock64``) between its stamps.  K3
runs as the step calls it on the 1 000 / 20 000 first step and
chip_smoke's ``src_top_cases`` (10 000, 20 000 and 45 000 brokers, every
row on one broker, every score +inf, Q = 1 and 8, -0.0 / +0.0 ties,
1 024 rows over 45 000 brokers, 32 768 rows), held bit for bit to its
plain twins on CPU copies, with its phases where stamped.  K13 (a) runs
on the 1 000 / 20 000 first score-only round: the grid key beside
``torch.neg(torch.cat(...))`` with the wrapper's host side split, and the
columnar key as the round makes it (K14, and the round's K13 (a)
launches, counted).  K8 runs on the 1 000 / 20 000 first step and
chip_smoke's ``commit_cases``, K5 in the step's three forms
(``match_forms``) and on ``match_cases``, both through this script's own
checkout's checks (so an older ``--root`` is held the same way; a
mismatch is recorded, not raised), with their phases where stamped
(``phases_run`` counts the stamped ones: the auction stamps no round after
its fixed point) and K5's ``rounds_to_fixed_outputs``.  K2 and K6 run on
the 1 000 / 20 000 first step (mean and percentile loads), on chip_smoke's
``score_terms_cases`` built from it (chosen slots emptied, exclusions, a
pool padded with -1, zero capacities, 10 000 brokers; K6 also on moves
and transfers mixed and in its two carry forms) and ``slot_cases`` (50 /
1 000, replication factors 1 and 8), K2 writing the brokers' cost table
and K6 reading it (a tree whose wrappers take no ``bcost`` runs without
it), each bit for bit against the twins on the card (a mismatch is
recorded, not raised), with ``device_ms_runs`` (the median device ms of
30 launches, in each of two runs), the wrapper ms, ``attrs`` where the
library exports them and, on each kernel's first record, the build's
``ptxas`` report.  K10 runs on the 1 000 / 20 000 first step's repool
(full, through chip_smoke's ``check_pool_tables`` with its incremental
form, then alone), on the 50 / 1 000 first repool and on this checkout's
``pool_cases`` (incremental over every row, at its budget and one above
it, every partition excluded, must-move slots with a dead broker, two
gated launches, 10 000 brokers, replication factors 1 and 8, the north
star's 10 000 brokers / 1 000 000 partitions), each launch on its carry
and touched set restored, bit for bit against the twin (recorded, not
raised), with ``device_ms_runs``, each launch's device ms by name, its
phases where stamped, and ``attrs`` where exported; on the first case
also ``graph_ms``: K10, one K11 and the whole repool, gated and acting,
in a captured graph of 16 calls, launch gaps included.  K15 runs on the
1 000 / 20 000 corrected first step in four forms (mean and percentile
loads, ``cohort_stack_tol`` 1.0 and 0.25) and this checkout's
``corrected_cases`` (one destination, one source, 777 rows, 1 row,
10 000 brokers, 65 536 rows over 66 000 brokers), likewise.
Needs a card.
"""


from __future__ import annotations

import argparse
import copy
import ctypes
import functools
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

KEYS = ("K", "D", "S", "N", "k", "P", "B", "L", "Q", "blocks",
        "top_broker_share", "attrs", "ms",
        "C", "NB", "NROW", "distinct_dst", "distinct_src",
        "device_ms", "device_ms_by_phase", "phase_cycles", "stamped_ms",
        "launch_ms_by_name", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "library_sort_ms",
        "evaluate_batch_ms", "compile_futures_ms", "h2d_scale_ms",
        "host_us", "bit_equal", "k14_ms",
        "library_two_calls_ms", "round_keys_launches_a_round",
        "M_step", "commits", "touched_brokers", "A", "cohort_rows",
        "dest_cap", "rounds_to_fixed_outputs", "phases_run", "error",
        "W", "device_ms_runs", "ptxas", "bcost", "graph_ms", "rows_budget",
        "touched", "repool", "full", "qualified", "accepted", "stack_tol",
        "form", "config", "budgets", "stale", "R", "CB", "has_cap",
        "stale_columns", "feasible_cells")
ALL = ("top_select", "grid_top_r", "grid_patch", "stale_sets",
       "recompute_aggregates",
       "whatif_verdict", "budget_accept", "compact_rows", "per_src_top",
       "round_keys", "commit_batch", "match_batch", "grid_terms",
       "score_candidates", "pool_tables", "corrected_accept")
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


@functools.lru_cache(maxsize=None)
def own_smoke(here: Path):
    """This script's own checkout's chip_smoke.py as a module: its checks
    and cases hold an older ``--root`` checkout's kernels too (they reach
    the kernels through the package that checkout put first)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", here / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


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
    "stamped_ms"}: the median ms and SM cycles between consecutive stamps
    (of one block: SM cycles of two blocks do not compare), and of the
    whole stamped launch; {} when the kernel has no stamps."""
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
        d = [r[j][col] - r[i][col] for r in rows if r[i][0] and r[j][0]]
        return statistics.median(d) if d else None
    # a kernel of several blocks stamps each block's phases in turn: a
    # phase named None spans two blocks' stamps and is not reported, and
    # the launch spans its earliest and latest stamp; a phase the launch
    # skipped (an auction's rounds after its fixed point) has no stamp
    # and is left out, and `phases_run` counts the stamped ones
    ms = {p: med(i, i + 1, 0) for i, p in enumerate(phases) if p}
    return {
        "device_ms_by_phase": {p: t * 1e-6 for p, t in ms.items()
                               if t is not None},
        "phase_cycles": {p: med(i, i + 1, 1)
                         for i, p in enumerate(phases)
                         if p and ms[p] is not None},
        "phases_run": statistics.median(
            sum(1 for t, _ in r[1:] if t) for r in rows),
        "stamped_ms": statistics.median(
            max(t for t, _ in r if t) - min(t for t, _ in r if t)
            for r in rows) * 1e-6}


def time_budget_accept(cs, summary, random_cluster, dev, here):
    """K4 on the 1 000 / 20 000 first step's cohort and chip_smoke's cut
    and skewed cohorts."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    calls, _ = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {}, dev)
    cases = {"midscale": calls["budget_accept"],
             **cs.cohort_cases(calls, dev)}
    check = cs.check_budget_accept
    phases = SK.budget_accept_phases(2)
    for case, (args, kw) in cases.items():
        rec = check(case, args, kw, False, True)["budget_accept"]
        rec.update(phase_split(SK.kernels, "budget_accept", phases,
                               lambda: SK.budget_accept(*args, **kw)))
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
                cs.compaction_cases(dev).items()}}
    phases = K7.COMPACT_ROWS_PHASES
    for case, (args, kw) in cases.items():
        rec = cs.check_compact_rows(case, args, kw, False, True)[
            "compact_rows"]
        rec.update(phase_split(K7.kernels, "compact_rows", phases,
                               lambda: K7.compact_rows(*args, **kw)))
        rec["attrs"] = K7.compact_rows_attrs(args[11], rec["NROW"])
        summary("compact_rows", rec)


def time_per_src_top(cs, summary, random_cluster, dev, here):
    """K3 on the 1 000 / 20 000 first step and chip_smoke's
    ``src_top_cases``, as the step calls it."""
    import dataclasses

    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    calls, _ = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {}, dev)
    base = calls["per_src_top"]
    del calls
    cases = {"midscale": base,
             **cs.src_top_cases(*base, dev)}
    phases = SK.PER_SRC_TOP_PHASES
    for case, (args, kw) in cases.items():
        m, lp, lsl, ls, slot, src, vals, B, Q = args

        def step():
            bl, top, sb = SK.per_src_top(*args, **kw)
            return [*bl, *top, sb]
        got = step()
        # the plain twins on CPU copies: an older checkout's twin keeps, on
        # the card, whichever of two tied zeros its scatter-min meets last
        pm = dataclasses.replace(m, assignment=m.assignment.cpu(),
                                 leader_slot=m.leader_slot.cpu(),
                                 capacity=m.capacity.cpu())
        sb, rb = SK.per_src_top_inputs_plain(pm, slot.cpu(), src.cpu(),
                                             vals.cpu(), **kw)
        bl, top = SK.per_src_top_plain(pm, lp.cpu(), lsl.cpu(), ls.cpu(), sb,
                                       rb, B, Q)
        cs.bitwise(f"{case} per_src_top", got, [*bl, *top, sb])
        rec = {"case": case, "B": B, "Q": Q, "L": lp.shape[0],
               "K": slot.shape[0], "dest_terms": kw.get("dest_terms", False),
               "bit_equal": True, "ms": cs.cuda_ms(step),
               "device_ms": cs.device_ms(step, "per_src_top_"),
               "launch_ms_by_name": launch_ms(cs, step),
               "host_us": host_us(step)}
        rec.update(phase_split(SK.kernels, "per_src_top", phases, step))
        rec["attrs"] = SK.per_src_top_attrs(slot.shape[0], lp.shape[0], B)
        summary("per_src_top", rec)
        del got, step


def time_commit_batch(cs, summary, random_cluster, dev, here):
    """K8 on the 1 000 / 20 000 first step and chip_smoke's
    ``commit_cases``, each launch on the step's carry restored."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89

    own = own_smoke(here)
    calls, has_cap = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {},
                                         dev)
    cases = {"midscale": calls["commit_batch"],
             **own.commit_cases(calls, dev)}
    phases = K89.COMMIT_BATCH_PHASES
    for case, (args, kw) in cases.items():
        try:
            rec = own.check_commit_batch(case, args, kw, has_cap, True)[
                "commit_batch"]
        except AssertionError as e:
            summary("commit_batch", {"case": case, "bit_equal": False,
                                     "error": str(e)})
            continue
        rec["bit_equal"] = True
        a = copy.deepcopy(args)
        state0 = a[15].state.clone()

        def run():
            a[15].state.copy_(state0)
            K89.commit_batch(*a, **kw)
        rec.update(phase_split(K89.kernels, "commit_batch", phases, run))
        summary("commit_batch", rec)
        del a


def time_match_batch(cs, summary, random_cluster, dev, here):
    """K5 on the 1 000 / 20 000 first step in the step's three forms and
    on chip_smoke's ``match_cases``."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    own = own_smoke(here)
    calls, has_cap = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {},
                                         dev)
    args, kw = calls["match_batch"]
    cases = {("midscale" if n == "match_batch" else
              "midscale_" + n.split("[")[1][:-1]): (a, k)
             for n, a, k in own.match_forms(args, kw)}
    cases.update(own.match_cases(calls, dev))
    for case, (args, kw) in cases.items():
        try:
            rec = own.check_match_batch(case, args, kw, has_cap, True)[
                "match_batch"]
        except AssertionError as e:
            summary("match_batch", {"case": case, "bit_equal": False,
                                    "error": str(e)})
            continue
        rec["bit_equal"] = True
        rounds = kw.get("rounds") or args[0].shape[1]
        phases = SK.match_batch_phases(rounds)
        rec.update(phase_split(SK.kernels, "match_batch", phases,
                               lambda: SK.match_batch(*args, **kw)))
        summary("match_batch", rec)


def device_ms_runs(fn, tag: str, reps: int = 30, runs: int = 2):
    """For each of ``runs`` runs, the median over ``reps`` calls of
    ``fn`` of the device ms a call spends in kernels whose names hold
    ``tag`` (summed over a call's launches), by ``torch.profiler``; a run
    whose profile caught no such kernel is taken again (up to 3 times)."""
    out = []
    for _ in range(runs):
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[  # cclint: disable=profiler-discipline -- times kernels in older checkouts too (--root), which predate kernel_budget.profiler_session
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and tag in e.name)
            if ev:
                break
        if not ev:
            out.append(None)
            continue
        per = max(1, round(len(ev) / reps))
        out.append(statistics.median(
            sum(t for _, t in ev[i:i + per])
            for i in range(0, len(ev), per)) * 1e-3)
    return out


def lib_attrs(kernels, name: str, *args):
    """Kernel ``name``'s exported ``<name>_attrs(args..., int* out)``
    (:func:`ops.kernels.attrs`), or None where its library has none."""
    fn = getattr(kernels.load(name), f"{name}_attrs", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return kernels.attrs(name, fn, *args)


def ptxas_report(kernels, name: str):
    """The ``ptxas`` report of kernel ``name``'s build (its ``.log``)."""
    log = kernels.library_path(name).with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if ln.strip()] if log.exists() else None


@functools.lru_cache(maxsize=None)
def score_cases(cs, here, random_cluster, dev):
    """K2's and K6's cases, built once a run: the 1 000 / 20 000 first
    step (mean and percentile loads), chip_smoke's ``score_terms_cases``
    on it and ``slot_cases`` (50 / 1 000, replication factors 1 and 8) →
    {case: (K2 args or None, (K6 args, kw) or None)}."""
    from cruise_control_tpu_torch.ops import grid as G

    cases = {}
    mid = random_cluster(**cs.MIDSCALE)
    for case, state in (("midscale_percentile", cs.with_percentile(mid)),
                        ("midscale", mid)):
        calls, _ = cs.first_step_calls(state, {}, dev)
        a2, _ = calls["grid_rescore"]
        cases[case] = (a2[:6] + a2[7:], calls["score_candidates"])
    cases.update(cs.score_terms_cases(calls, dev))
    cases.update(cs.slot_cases(dev))
    return cases


def _bit_equal(cs, here, label, got, want) -> bool:
    try:
        cs.bitwise(label, got, want)
        return True
    except AssertionError:
        return False


def time_grid_terms(cs, summary, random_cluster, dev, here):
    """K2 on every case of :func:`score_cases` that has K2 inputs, writing
    the cost table into one buffer, as the step does."""
    from cruise_control_tpu_torch.ops import grid as G

    first = True
    for case, (a2, _) in score_cases(cs, here, random_cluster,
                                     dev).items():
        if a2 is None:
            continue
        m = a2[0]
        B = m.capacity.shape[0]
        kw = {"bcost": torch.empty(B, device=dev)}

        def own(fn, *a):
            packed = fn(*a)
            return [packed[k] for k in ("src_f", "src_i", "dst_f", "dst_i",
                                        "bcost")]
        got = own(G.grid_terms, *a2)
        torch.cuda.synchronize()
        want = own(G.grid_terms_plain, *a2[:7])
        run = lambda: G.grid_terms(*a2, **kw)  # noqa: E731
        S, W = m.assignment.shape[1], m.pload.shape[1]
        rec = {"case": case, "K": a2[3].shape[0], "D": a2[5].shape[0],
               "S": S, "W": W, "B": B,
               "bit_equal": _bit_equal(cs, here, f"{case} grid_terms", got,
                                       want),
               "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run, "grid_terms_"),
               "attrs": lib_attrs(G.kernels, "grid_terms", S, W)}
        if first:
            rec["ptxas"] = ptxas_report(G.kernels, "grid_terms")
            first = False
        summary("grid_terms", rec)
        del got, want


def time_score_candidates(cs, summary, random_cluster, dev, here):
    """K6 on every case of :func:`score_cases` that has K6 inputs."""
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    outputs = cs.score_outputs
    first = True
    for case, (_, k6) in score_cases(cs, here, random_cluster,
                                     dev).items():
        if k6 is None:
            continue
        a6, kw6 = k6
        m = a6[0]
        got = outputs(False, *a6, **kw6)
        torch.cuda.synchronize()
        want = outputs(True, *a6, **kw6)
        kw = dict(kw6, checked=True)
        run = lambda: K6.score_candidates(*a6, **kw)  # noqa: E731
        S, W = m.assignment.shape[1], m.pload.shape[1]
        rows = kw6.get("rows")
        rec = {"case": case, "N": a6[4].shape[0] if rows is None
               else int(kw6["n_rows"][0]),
               "S": S, "W": W, "B": m.capacity.shape[0],
               "bit_equal": _bit_equal(cs, here, f"{case} score_candidates",
                                       got, want),
               "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run, "score_candidates_"),
               "attrs": lib_attrs(K6.kernels, "score_candidates", S, W)}
        if first:
            rec["ptxas"] = ptxas_report(K6.kernels, "score_candidates")
            first = False
        summary("score_candidates", rec)
        del got, want


def _checked(check, summary, name, case, *args):
    """A checkout's bit-for-bit check of one case → True, or the mismatch
    recorded (not raised) → False."""
    try:
        check(case, *args)
        return True
    except AssertionError as e:
        summary(name, {"case": case, "bit_equal": False, "error": str(e)})
        return False


def graph_ms(cs, fn, n: int = 16) -> float:
    """Ms a call of ``fn`` takes inside a captured CUDA graph of ``n``
    calls (CUDA events around its replays): the launch gaps included, as a
    captured step chunk pays them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cs.cuda_ms(g.replay) / n


def repool_graph_ms(cs, args):
    """K10 alone and the whole repool (K10, K11 three times) on ``args``
    inside a captured graph → ms a call: gated (the carry asks for no
    repool), one K11 gated, and acting (the carry and touched set
    restored first; the two restoring copies' own graph time taken off)."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS

    m, ca, pb, st0, budget = copy.deepcopy(args)
    gated = st0.clone()
    gated[SS.NEED_POOL] = 0
    st = st0.clone()
    tpp0 = pb.tpp.clone()
    S = m.assignment.shape[1]

    def restore():
        st.copy_(st0)
        pb.tpp.copy_(tpp0)
    copies = graph_ms(cs, restore)
    return {
        "k10_gated": graph_ms(cs, lambda: PK.pool_tables(
            m, ca, pb, gated, budget, checked=True)),
        "k11_gated": graph_ms(cs, lambda: PK.top_select(
            pb.prio.view(-1), pb.kp, pb.ks, pb.slot, S=S, state=gated,
            ws=pb.select_ws)),
        "repool_gated": graph_ms(cs, lambda: C._repool(
            m, ca, pb, gated, budget, checked=True)),
        "k10_acting": graph_ms(cs, lambda: (restore(), PK.pool_tables(
            m, ca, pb, st, budget, checked=True))) - copies,
        "repool_acting": graph_ms(cs, lambda: (restore(), C._repool(
            m, ca, pb, st, budget, checked=True))) - copies,
        "restore_copies": copies}


def time_pool_tables(cs, summary, random_cluster, dev, here):
    """K10 on the 1 000 / 20 000 first repool (full; with its incremental
    form through chip_smoke's check), the 50 / 1 000 first repool and
    this checkout's ``pool_cases``, each launch on its carry and touched
    set restored."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS

    own = own_smoke(here)
    calls, _ = cs.first_step_calls(random_cluster(**cs.MIDSCALE), {}, dev)
    full = calls["pool_tables"][0]
    del calls
    recs = cs.check_pool_tables("midscale", full, {}, False, True)
    for name, rec in recs.items():
        summary(name, rec)
    cases = {"midscale": full,
             "50b_1k": own.repool_args(random_cluster(seed=42, **cs.SMALL),
                                       dev),
             **own.pool_cases(full, dev)}
    phases = PK.POOL_TABLES_PHASES
    first = True
    for case, args in cases.items():
        m, ca, pb, st0, budget = args
        if not _checked(own.check_pool_case, summary, "pool_tables", case,
                        args):
            continue
        a = copy.deepcopy(args)
        tpp0 = pb.tpp.clone()

        def run():
            a[3].copy_(st0)
            a[2].tpp.copy_(tpp0)
            PK.pool_tables(*a, checked=True)
        run()
        P, S = m.assignment.shape
        rec = {"case": case, "P": P, "S": S, "B": m.capacity.shape[0],
               "rows_budget": budget, "touched": int(tpp0.sum()),
               "repool": int(a[3][SS.REPOOL]), "full": int(a[3][SS.FULL]),
               "bit_equal": True, "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run, "pool_tables_"),
               "launch_ms_by_name": launch_ms(cs, run),
               "attrs": PK.pool_tables_attrs(S)}
        if rec["repool"]:
            rec.update(phase_split(PK.kernels, "pool_tables", phases, run))
        if first:
            rec["ptxas"] = ptxas_report(PK.kernels, "pool_tables")
            rec["graph_ms"] = repool_graph_ms(cs, args)
            first = False
        summary("pool_tables", rec)
        del a


def time_corrected_accept(cs, summary, random_cluster, dev, here):
    """K15 on the 1 000 / 20 000 corrected first step in four forms and on
    this checkout's ``corrected_cases``."""
    from cruise_control_tpu_torch.analyzer import corrected_kernel as K15

    own = own_smoke(here)
    mid = random_cluster(**cs.MIDSCALE)
    cases = {}
    for tag, state in (("midscale", mid),
                       ("midscale_percentile", cs.with_percentile(mid))):
        for tol in (1.0, 0.25):
            calls, _ = cs.first_step_calls(
                state, {"cohort_mode": "corrected", "cohort_stack_tol": tol},
                dev)
            cases[f"{tag}_tol{tol}"] = calls["corrected_accept"]
    cases.update(own.corrected_cases(cs.with_percentile(mid),
                                     {"cohort_stack_tol": 0.25}, dev))
    phases = K15.CORRECTED_ACCEPT_PHASES
    first = True
    for case, (args, kw) in cases.items():
        if not _checked(own.check_corrected_case, summary,
                        "corrected_accept", case, args, kw):
            continue
        kw = dict(kw, checked=True)
        run = lambda: K15.corrected_accept(*args, **kw)  # noqa: E731
        Cn, NB = args[7].shape
        rec = {"case": case, "C": Cn, "NB": NB,
               "B": args[0].capacity.shape[0],
               "qualified": int(args[8].sum()),
               "stack_tol": args[1].cohort_stack_tol, "bit_equal": True,
               "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run,
                                                "corrected_accept_kernel"),
               "attrs": K15.corrected_accept_attrs(
                   Cn, NB, args[0].capacity.shape[0])}
        rec.update(phase_split(K15.kernels, "corrected_accept", phases, run))
        if first:
            rec["ptxas"] = ptxas_report(K15.kernels, "corrected_accept")
            rec["plain_ms"] = cs.cuda_ms(lambda: K15._corrected_accept(
                *args, snap_score=kw["snap_score"]), reps=15)
            first = False
        summary("corrected_accept", rec)


def time_round_keys(cs, summary, random_cluster, dev):
    """K13 (a) on the 1 000 / 20 000 first score-only round: the grid key
    beside ``torch.neg(torch.cat(...))``, the wrapper's host side split;
    the columnar key as the round makes it."""
    import dataclasses

    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer import round_kernels as RK

    r = cs.round_inputs(random_cluster(**cs.MIDSCALE), {}, dev)
    kernels = RK.kernels
    bitwise = cs.bitwise
    vals, ls = r["forms"]["grid"][0]
    n = vals.numel() + ls.numel()
    keys = lambda: RK.round_keys(vals, ls)  # noqa: E731
    lib = lambda: torch.neg(torch.cat((vals.reshape(-1), ls)))  # noqa: E731
    bitwise("round_keys grid", keys(), RK.round_keys_plain(vals, ls))
    key = torch.empty(n, dtype=torch.float32, device=dev)
    clib = kernels.load("round_pack")
    st = kernels.stream(dev)
    summary("round_keys", {
        "case": "grid", "N": n, "bit_equal": True, "ms": cs.cuda_ms(keys),
        "device_ms": cs.device_ms(keys, "round_pack_keys"),
        "library_two_calls_ms": cs.cuda_ms(lib),
        "host_us": {
            "wrapper": host_us(keys), "library": host_us(lib),
            "launch_call": host_us(lambda: clib.round_keys_launch(
                vals.data_ptr(), vals.numel(), ls.data_ptr(), ls.numel(),
                key.data_ptr(), st)),
            "empty": host_us(lambda: torch.empty(n, dtype=torch.float32,
                                                 device=dev)),
            "stream": host_us(lambda: kernels.stream(dev)),
            "bind": host_us(lambda: kernels.bind(
                "round_pack", "round_keys_launch", ())),
        }})
    # the columnar key as the round makes it: K14 alone (a round launches
    # no K13 (a) there, counted)
    m, cfg, ca, K, D = (r[k] for k in ("m", "cfg", "ca", "K", "D"))
    cfg = dataclasses.replace(cfg, scoring="columnar")
    kp, ks, dp = r["forms"]["columnar"][2][:3]
    a14 = (m, cfg, ca, kp, ks, dp, r["consts"], r["tconsts"])
    before = RK.round_keys.launches
    C._round(m, cfg, ca, K, D, r["consts"], r["tconsts"])
    torch.cuda.synchronize()
    k14 = lambda: RK.score_columnar(*a14)  # noqa: E731
    bitwise("round_keys columnar", k14(),
            RK.round_keys_plain(RK.score_columnar_plain(*a14[:6])))
    s14 = k14()
    summary("round_keys", {
        "case": "columnar", "N": s14.numel(), "bit_equal": True,
        "round_keys_launches_a_round": RK.round_keys.launches - before,
        "k14_ms": cs.cuda_ms(k14),
        "launch_ms_by_name": launch_ms(cs, k14),
        "library_ms": cs.cuda_ms(lambda: torch.neg(s14))})


def time_top_select(cs, summary, PK, kernels, dev):
    for n, k in TOP_SHAPES:
        a, kw = cs.synthetic_priority(dev, n=n, k=k)
        name = f"top_select[{n}->{k}]"
        summary(name, cs.check_top_select("time", name, a, kw, True)[name])
        if (n, k) == TOP_SHAPES[0]:
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


def time_grid(cs, summary, G, random_cluster, dev):
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
    for name in ("grid_top_r[rows]", "grid_top_r[carry_full]"):
        summary(name, recs[name])


def rescore_fixtures(cs, own, random_cluster):
    """K16's and K17's fixtures → [(case, make state, config)]: 1 000 /
    20 000 (mean and percentile loads), the ragged cluster, 50 / 1 000
    (8 commits a step: at its default batch no step of the first 16
    patches), 10 000 brokers and the north star's 10 000 brokers /
    1 000 000 partitions (both at this checkout's ``RESCORE_WIDE_KW``)."""
    ragged = dict(seed=5, num_brokers=77, num_racks=7, num_partitions=3001,
                  dead_brokers=3)
    return [
        ("midscale", lambda: random_cluster(**cs.MIDSCALE), {}),
        ("midscale_percentile",
         lambda: cs.with_percentile(random_cluster(**cs.MIDSCALE)), {}),
        ("ragged", lambda: random_cluster(**ragged),
         {"max_source_replicas": 1999, "device_batch_per_step": 8}),
        ("50b_1k", lambda: random_cluster(seed=42, **cs.SMALL),
         {"device_batch_per_step": 8}),
        ("b10k", lambda: random_cluster(**own.RESCORE_B10K),
         own.RESCORE_WIDE_KW),
        ("north_star", own.north_star_state, own.RESCORE_WIDE_KW)]


def _outputs(fn, idx):
    """``fn`` run on its arguments → those at ``idx`` (it writes them in
    place)."""
    def run(*a, **kw):
        fn(*a, **kw)
        return [a[i] for i in idx]
    return run


def time_stale_sets_case(cs, summary, RK, case, a, kw, cfg_kw, first):
    """K16 on one case's first patching step, acting and inactive."""
    from cruise_control_tpu_torch.analyzer import step_state as SS

    m, kp, dp, lp = a[0], a[1], a[2], a[3]
    P, S = m.assignment.shape
    B = a[5].shape[0]
    K, D, L = kp.shape[0], dp.shape[0], lp.shape[0]
    RB, CB, LB = (a[i].shape[0] for i in (8, 9, 10))
    for form in ("acting", "inactive"):
        args = copy.deepcopy(a)
        if form == "inactive":
            args[7][SS.ACTIVE] = 0
        out = (7, 8, 9, 10, 11)
        got = _outputs(RK.stale_sets, out)(*copy.deepcopy(args), **kw)
        torch.cuda.synchronize()
        want = _outputs(RK.stale_sets_plain, out)(*copy.deepcopy(args))
        counts = [int(x) for x in want[4].cpu()]
        targs, pargs = copy.deepcopy(args), copy.deepcopy(args)
        run = lambda: RK.stale_sets(*targs, **kw)  # noqa: E731
        rec = {"case": case, "form": form, "config": cfg_kw, "K": K, "D": D,
               "L": L, "B": B, "P": P, "budgets": [RB, CB, LB],
               "stale": counts if form == "acting" else None,
               "bit_equal": _bit_equal(cs, None, f"{case} stale_sets", got,
                                       want),
               "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run, "stale_sets_kernel"),
               "graph_ms": graph_ms(cs, run),
               "plain_ms": cs.cuda_ms(
                   lambda: RK.stale_sets_plain(*pargs), reps=15),
               "attrs": lib_attrs(RK.kernels, "stale_sets", K, D, L)}
        if form == "acting":
            rec.update(cs.bound(*RK.stale_sets_work(K, D, L, B, P, RB, CB,
                                                    LB)))
            rec.update(phase_split(RK.kernels, "stale_sets",
                                   RK.STALE_SETS_PHASES, run))
            if first:
                rec["ptxas"] = ptxas_report(RK.kernels, "stale_sets")
        summary("stale_sets", rec)


def time_grid_patch_case(cs, summary, RK, G, case, a, kw, has_cap, cfg_kw,
                         first):
    """K17 on one case's first patching step and gated (the carry's FRESH
    flag set)."""
    from cruise_control_tpu_torch.analyzer import step_state as SS

    m, cfg, ca, kp, ks, dp, packed, cidx, _, tb, dt, bd, st = a
    K, D, S = packed["K"], packed["D"], packed["S"]
    CB, R, B = cidx.shape[0], dt.shape[1], tb.shape[0]
    dp_c = torch.where(cidx >= 0, dp[cidx.clamp_min(0).long()], -1)
    feas = int(torch.isfinite(G.move_grid_scores(
        m, cfg, ca, kp, ks, dp_c.to(torch.int32))).sum())
    n_stale = int((cidx >= 0).sum())
    pkw = {k: v for k, v in kw.items() if k != "checked"}
    for form in ("patch", "gated"):
        args = copy.deepcopy(a)
        if form == "gated":
            args[12][SS.FRESH] = 1
        got = _outputs(RK.grid_patch, (10, 11))(*copy.deepcopy(args), **kw)
        torch.cuda.synchronize()
        want = _outputs(RK.grid_patch_plain, (10, 11))(*copy.deepcopy(args),
                                                       **pkw)
        targs, pargs = copy.deepcopy(args), copy.deepcopy(args)
        run = lambda: RK.grid_patch(*targs, **kw)  # noqa: E731
        rec = {"case": case, "form": form, "config": cfg_kw, "K": K, "D": D,
               "S": S, "B": B, "CB": CB, "R": R, "has_cap": has_cap,
               "stale_columns": n_stale, "feasible_cells": feas,
               "bit_equal": _bit_equal(cs, None, f"{case} grid_patch", got,
                                       want),
               "ms": cs.cuda_ms(run),
               "device_ms_runs": device_ms_runs(run, "grid_patch_kernel"),
               "graph_ms": graph_ms(cs, run),
               "attrs": RK.grid_patch_attrs(S, has_cap, CB, D)}
        if form == "patch":
            rec.update(cs.bound(*RK.grid_patch_work(K, D, B, S, R, CB,
                                                    n_stale, feas)))
            rec["plain_ms"] = cs.cuda_ms(
                lambda: RK.grid_patch_plain(*pargs, **pkw), reps=15)
            rec.update(phase_split(RK.kernels, "grid_patch",
                                   RK.GRID_PATCH_PHASES, run))
            if first:
                rec["ptxas"] = ptxas_report(RK.kernels, "grid_patch")
        summary("grid_patch", rec)


def time_rescore(cs, summary, random_cluster, dev, here, only):
    """K16 and K17 on the first patching step of an incremental search on
    each of :func:`rescore_fixtures` (this checkout's ``patch_step_calls``
    on the ``--root`` checkout's package), each bit for bit against its
    twin on the card (recorded, not raised)."""
    from cruise_control_tpu_torch.analyzer import rescore_kernels as RK
    from cruise_control_tpu_torch.ops import grid as G

    own = own_smoke(here)
    first = True
    for case, make, cfg_kw in rescore_fixtures(cs, own, random_cluster):
        try:
            calls, has_cap, _ = own.patch_step_calls(make(), cfg_kw, dev)
        except AssertionError as e:
            summary("stale_sets", {"case": case, "config": cfg_kw,
                                   "error": str(e)})
            continue
        if "stale_sets" in only:
            (a, kw), = calls["stale_sets"]
            time_stale_sets_case(cs, summary, RK, case, a, kw, cfg_kw, first)
        if "grid_patch" in only:
            (a, kw), = calls["grid_patch"]
            time_grid_patch_case(cs, summary, RK, G, case, a, kw, has_cap,
                                 cfg_kw, first)
        first = False
        del calls
        torch.cuda.empty_cache()


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
    skew = cs.skew_placement
    slot_loads = cs.aggregate_slot_loads
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
    hot = cs.skew_placement(margs[0])
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
    if "grid_top_r" in only:
        time_grid(cs, summary, G, random_cluster, dev)
    if {"stale_sets", "grid_patch"} & only:
        time_rescore(cs, summary, random_cluster, dev, here, only)
    if "recompute_aggregates" in only:
        time_recompute_aggregates(cs, summary, random_cluster, dev, here)
    if "whatif_verdict" in only:
        time_whatif_verdict(cs, summary, random_cluster, dev, here)
    if "budget_accept" in only:
        time_budget_accept(cs, summary, random_cluster, dev, here)
    if "compact_rows" in only:
        time_compact_rows(cs, summary, random_cluster, dev, here)
    if "per_src_top" in only:
        time_per_src_top(cs, summary, random_cluster, dev, here)
    if "round_keys" in only:
        time_round_keys(cs, summary, random_cluster, dev)
    if "commit_batch" in only:
        time_commit_batch(cs, summary, random_cluster, dev, here)
    if "match_batch" in only:
        time_match_batch(cs, summary, random_cluster, dev, here)
    if "grid_terms" in only:
        time_grid_terms(cs, summary, random_cluster, dev, here)
    if "score_candidates" in only:
        time_score_candidates(cs, summary, random_cluster, dev, here)
    if "pool_tables" in only:
        time_pool_tables(cs, summary, random_cluster, dev, here)
    if "corrected_accept" in only:
        time_corrected_accept(cs, summary, random_cluster, dev, here)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
