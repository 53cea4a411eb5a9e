"""transfer-discipline — host↔device copies go through the ledger.

The mesh observatory (``telemetry/mesh_budget.py``) accounts every
host↔device copy: Kineto shows copies as anonymous memcpy records, the
:class:`~cruise_control_tpu_torch.telemetry.mesh_budget.TransferLedger`
names them per logical fn (``cc_transfer_bytes{direction=,fn=}``).  A raw
upload or read-back outside the sanctioned modules reopens the hole: the
copy happens, the ledger stays blind, and the mesh artifact can no longer
say where the transfer bytes went.

Findings, outside the sanctioned modules (``ops/`` and ``telemetry/``
wholesale, plus the two upload sites: ``models/cluster_state.py:
ClusterState.to`` and ``analyzer/cuda_optimizer.py:
CudaGoalOptimizer._device_model``, which builds the ``DeviceModel``):

* H2D — ``.to(<device>)`` (a ``device=`` keyword, or a first argument
  whose dotted name ends in ``device`` or is ``dev``), ``.cuda()``, and
  ``torch.as_tensor(..., device=)``;
* D2H — ``.cpu()``/``.numpy()``/``.tolist()``/``.item()`` on an
  expression rooted in a parameter annotated ``torch.Tensor`` or
  ``*DeviceModel``, and ``np.asarray``/``np.array`` of such a
  parameter.  The root is the annotation, as in the reference, so the
  host numpy code of ``analyzer/goals/*`` is never read as a copy.

Route them through ``mesh_budget.device_put(x, device, fn=...)`` /
``mesh_budget.fetch(x, fn=...)``; a function that makes the copy itself
and charges it with ``mesh_budget.note_transfer(...)`` is on the ledger
too.  ``.to(torch.float32)`` and other dtype conversions are not
copies.  Evaluated over the phase-1 summaries (no re-parse).
"""

from __future__ import annotations

import pathlib
from typing import List, Set

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "transfer-discipline"

#: numpy module names whose asarray/array read a tensor back
_NP_MODULES = frozenset(("np", "numpy", "onp"))

#: annotations (as written) that prove a param holds device tensors
_DEVICE_ANNOTATIONS = frozenset(("torch.Tensor", "Tensor"))

#: the read-backs a tensor method makes
_D2H_TAILS = frozenset(("cpu", "numpy", "tolist", "item"))

#: modules allowed to move bytes raw: the kernel and transfer layers
_ALLOWED_DIRS = ("ops", "telemetry")
#: (path suffix, function key) of the upload sites
_ALLOWED_FUNCS = (
    (("models", "cluster_state.py"), "ClusterState.to"),
    (("analyzer", "cuda_optimizer.py"), "CudaGoalOptimizer._device_model"),
)


def _allowed_dir(path: str) -> bool:
    parts = pathlib.PurePath(path).parts
    return len(parts) >= 2 and parts[-2] in _ALLOWED_DIRS


def _allowed_func(path: str, fn: str) -> bool:
    parts = pathlib.PurePath(path).parts
    return any(parts[-2:] == sfx and (fn == key or fn.startswith(key + ">"))
               for sfx, key in _ALLOWED_FUNCS)


def _is_device_annotation(ann: str) -> bool:
    return ann in _DEVICE_ANNOTATIONS or ann.endswith("DeviceModel")


def _names_device(expr: str) -> bool:
    tail = expr.rsplit(".", 1)[-1]
    return tail == "dev" or tail.endswith("device")


def _h2d(call) -> bool:
    head, _, tail = call.callee.rpartition(".")
    placed = "device" in set(call.kwargs) - set(call.none_kwargs)
    if tail == "to" and head:
        return placed or bool(call.arg_exprs and call.arg_exprs[0]
                              and _names_device(call.arg_exprs[0]))
    if tail == "cuda" and head:
        return True
    return call.callee == "torch.as_tensor" and placed


class TransferDisciplineRule:
    id = RULE_ID
    summary = ("raw host↔device copies (.to(device), .cuda(), "
               "torch.as_tensor(device=), .cpu()/.numpy()/.tolist()/"
               ".item() of a tensor parameter) outside ops/, telemetry/ "
               "and the model upload sites — route them through the mesh "
               "observatory's ledger (mesh_budget.device_put / fetch) so "
               "cc_transfer_bytes{fn=} can name what the copy costs")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            if _allowed_dir(s.path):
                continue
            np_modules: Set[str] = set(_NP_MODULES)
            for _level, from_mod, name, alias in s.imports:
                if from_mod is None and name == "numpy":
                    np_modules.add(alias)
            for fn in s.functions.values():
                if _allowed_func(s.path, fn.name) or any(
                        c.callee.rsplit(".", 1)[-1] == "note_transfer"
                        for c in fn.calls):
                    continue
                where = fn.name or "<module>"
                for call in fn.calls:
                    if _h2d(call):
                        findings.append(Finding(
                            path=s.path, line=call.lineno, rule=self.id,
                            message=(
                                f"raw {call.callee}() in {where} copies "
                                "to the device outside the transfer "
                                "ledger — use telemetry/mesh_budget."
                                "device_put(x, device, fn=...) so the "
                                "H2D bytes are charged to a named fn in "
                                "cc_transfer_bytes"
                            ),
                        ))
                        continue
                    head, _, tail = call.callee.rpartition(".")
                    if tail in _D2H_TAILS and head:
                        expr = head
                    elif (tail in ("asarray", "array")
                          and head in np_modules and call.arg_exprs
                          and call.arg_exprs[0]):
                        expr = call.arg_exprs[0]
                    else:
                        continue
                    root = expr.split(".", 1)[0]
                    ann = fn.annotations.get(root, "")
                    if root in fn.params and _is_device_annotation(ann):
                        findings.append(Finding(
                            path=s.path, line=call.lineno, rule=self.id,
                            message=(
                                f"{call.callee}() in {where} reads a "
                                f"device tensor ({root}: {ann}) back to "
                                "the host outside the ledger — use "
                                "telemetry/mesh_budget.fetch(x, fn=...) "
                                "so the D2H bytes are charged to a named "
                                "fn"
                            ),
                        ))
        return findings
