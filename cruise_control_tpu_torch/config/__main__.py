"""``python -m cruise_control_tpu_torch.config`` — dump the config-key surface as
markdown (the generator for ``docs/CONFIGURATION.md``; upstream documents
its ~300 keys in the wiki's Configurations page, SURVEY.md §5.6)."""

from __future__ import annotations

import collections

from cruise_control_tpu_torch.config.cruise_control_config import DEFAULT_CONFIG_DEF


def main() -> None:
    groups = collections.defaultdict(list)
    for key in DEFAULT_CONFIG_DEF.keys().values():
        groups[key.group or "misc"].append(key)
    print("# Configuration keys")
    print()
    print("Generated by `python -m cruise_control_tpu_torch.config > "
          "docs/CONFIGURATION.md`. Key names keep the upstream dotted "
          "surface so reference `cruisecontrol.properties` files map over.")
    for group in sorted(groups):
        print(f"\n## {group}\n")
        print("| key | type | default | importance | doc |")
        print("|---|---|---|---|---|")
        for k in sorted(groups[group], key=lambda k: k.name):
            default = "" if k.default is None else f"`{k.default}`"
            # escape table-breaking characters in free-text docs
            doc = " ".join(k.doc.split()).replace("|", "\\|")
            print(
                f"| `{k.name}` | {k.type.value} | {default} "
                f"| {k.importance.value} | {doc} |"
            )


if __name__ == "__main__":
    main()
