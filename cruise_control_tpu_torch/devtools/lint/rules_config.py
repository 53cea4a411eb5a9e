"""config-key-drift — the config surface stays closed under three views.

The port's typed registry (``cruise_control_tpu_torch/config/
cruise_control_config.py``: the reference's keys with the ``cuda.*``
engine group), the code that reads it (``cfg.get*/
get_configured_instance*`` call sites), and the port's generated
reference table (``docs/CONFIGURATION_TORCH.md``) must agree:

* every string key a getter call site uses must be DEFINED — an
  undefined key raises ``ConfigException`` at runtime, on whatever
  code path finally reaches it;
* every defined key must appear in the doc table, and every doc-table
  key must be defined — the doc is generated (``python -m
  cruise_control_tpu_torch.config > docs/CONFIGURATION_TORCH.md``), so
  drift means someone edited one side by hand or forgot to regenerate.

This is a project rule: it runs once per pass with the whole file set,
reading the registry (imported — the module is dependency-free — so
loop-defined keys like the per-RPC timeout family are captured exactly)
and the checked-in doc.  ``docs/CONFIGURATION.md`` is the reference's
table and is not read here.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Set, Tuple

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "config-key-drift"

#: getter names unique enough to claim on any receiver
_TYPED_GETTERS = {"get_int", "get_double", "get_list", "get_boolean",
                  "get_configured_instance", "get_configured_instances"}
#: plain .get() is claimed only on config-ish receivers (dict.get is
#: everywhere; these names are the repo's config-object vocabulary)
_CONFIG_RECEIVERS = {"cfg", "config", "cc_config", "cruise_config"}

#: the port's generated table (the reference's is docs/CONFIGURATION.md)
DOC_NAME = "CONFIGURATION_TORCH.md"

_DOC_KEY_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")


def _pkg_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def config_module_path() -> pathlib.Path:
    return _pkg_root() / "config" / "cruise_control_config.py"


def doc_path() -> pathlib.Path:
    return _pkg_root().parent / "docs" / DOC_NAME


def defined_keys() -> Set[str]:
    """The authoritative key set, from the live registry (captures the
    loop-defined per-RPC timeout family a static scan would miss)."""
    from cruise_control_tpu_torch.config.cruise_control_config import (
        DEFAULT_CONFIG_DEF,
    )

    return set(DEFAULT_CONFIG_DEF.keys())


def doc_keys(text: str) -> Dict[str, int]:
    """key → first line number in the CONFIGURATION_TORCH.md table."""
    out: Dict[str, int] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _DOC_KEY_RE.match(line)
        if m and m.group(1) not in ("key",):  # table header row
            out.setdefault(m.group(1), lineno)
    return out


def used_keys(tree: ast.AST, nodes=None) -> Iterable[Tuple[str, int]]:
    """(key, lineno) for every config-getter call site with a literal
    string key in this tree."""
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        claimed = f.attr in _TYPED_GETTERS
        if not claimed and f.attr == "get":
            recv = f.value
            name = (recv.id if isinstance(recv, ast.Name)
                    else recv.attr if isinstance(recv, ast.Attribute)
                    else None)
            claimed = name in _CONFIG_RECEIVERS
        if not claimed:
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value, node.args[0].lineno


def key_def_line(config_src: str, key: str) -> int:
    """Best-effort line anchor for a defined key in the config source
    (loop-defined keys anchor at the loop tuple's line)."""
    needle = f'"{key}"'
    for lineno, line in enumerate(config_src.splitlines(), start=1):
        if needle in line:
            return lineno
    return 1


class ConfigKeyDriftRule:
    id = RULE_ID
    summary = ("config keys used in code must be defined; defined keys "
               "and docs/CONFIGURATION_TORCH.md must match exactly")
    project_rule = True

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        """Runs over the phase-1 summaries (getter call sites are
        pre-extracted into ``ModuleSummary.config_keys``, so warm cached
        runs never re-walk an AST for this rule)."""
        out: List[Finding] = []
        try:
            defined = defined_keys()
        except Exception as e:  # config module broken: one loud finding
            return [Finding(str(config_module_path()), 1, self.id,
                            f"config registry failed to load: {e!r}")]
        for s in project.summaries:
            for key, lineno in s.config_keys:
                if key not in defined:
                    out.append(Finding(
                        s.path, lineno, self.id,
                        f"config key '{key}' is not defined in "
                        "config/cruise_control_config.py — a request "
                        "reaching this call raises ConfigException",
                    ))
        doc = doc_path()
        cfg_path = config_module_path()
        if not doc.exists():
            out.append(Finding(str(cfg_path), 1, self.id,
                               f"{doc} is missing — regenerate with "
                               "'python -m cruise_control_tpu_torch.config'"))
            return out
        documented = doc_keys(doc.read_text())
        cfg_src = cfg_path.read_text()
        for key in sorted(defined - set(documented)):
            out.append(Finding(
                str(cfg_path), key_def_line(cfg_src, key), self.id,
                f"defined config key '{key}' is missing from "
                f"docs/{DOC_NAME} — regenerate the table",
            ))
        for key in sorted(set(documented) - defined):
            out.append(Finding(
                str(doc), documented[key], self.id,
                f"docs/{DOC_NAME} documents '{key}' which is not "
                "defined — regenerate the table",
            ))
        return out
