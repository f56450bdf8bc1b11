"""Spec-dict argparse generator (reference source/utils.py:7-53; copied
from ``bert4clickpath_tpu/utils/cli.py``, which imports no jax).

Builds a parser from ``{name: default_or_type}``:

* a *type* (e.g. ``float``) -> required ``--name`` of that type;
* a bool default -> single-hyphen switch ``-name`` (store_true/false),
  matching the reference's quirk;
* any other default -> optional ``--name`` with that default and type;
* ``None`` -> optional ``--name`` accepting any string.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping, Optional, Sequence


def parse_spec_args(
    spec: Mapping[str, Any], argv: Optional[Sequence[str]] = None
) -> dict[str, Any]:
    parser = argparse.ArgumentParser()
    for name, arg_spec in spec.items():
        if isinstance(arg_spec, type):
            parser.add_argument(f"--{name}", type=arg_spec, required=True)
        elif arg_spec is None:
            parser.add_argument(f"--{name}", default=None)
        elif isinstance(arg_spec, bool):
            action = "store_true" if arg_spec else "store_false"
            parser.add_argument(f"-{name}", action=action)
        else:
            parser.add_argument(f"--{name}", type=type(arg_spec), default=arg_spec)
    return vars(parser.parse_args(argv))
