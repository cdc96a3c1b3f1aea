"""Fatal-error reporting (reference: src/common/module/abor1.F90).

The reference prints the message on unit 0 and calls abort(); here a typed
exception serves the same purpose while remaining catchable by harnesses.
"""

from __future__ import annotations

import sys

__all__ = ["Abor1Error", "abor1"]


class Abor1Error(RuntimeError):
    """Unrecoverable configuration/runtime error."""


def abor1(message: str) -> None:
    print(f"ABOR1: {message}", file=sys.stderr)
    raise Abor1Error(message)
