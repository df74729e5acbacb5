"""`csrspmv` — CSR SpMV benchmark CLI (the reference's csrspmv.c:1766 main,
rebuilt on this library; partition flags map to device sharding)."""

from __future__ import annotations

import sys

from ellspmv_jax.cli.common import run


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return run(argv, "csrspmv", "csr")


if __name__ == "__main__":
    raise SystemExit(main())
