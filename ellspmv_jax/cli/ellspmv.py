"""`ellspmv` — ELLPACK SpMV benchmark CLI (the reference's ellspmv.c:1226
main, rebuilt on this library)."""

from __future__ import annotations

import sys

from ellspmv_jax.cli.common import run


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return run(argv, "ellspmv", "ell")


if __name__ == "__main__":
    raise SystemExit(main())
