"""`verify-checksums` — SHA256 model-file integrity check
(scripts/verify-checksum-models.py): one OK / FAILED / MISSING line a file
of a SHA256SUMS file, the counts on stderr, rc 1 if any file failed or is
missing."""

from __future__ import annotations

import argparse
import hashlib
import os
import sys


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("verify-checksums", description=__doc__)
    p.add_argument("sums", help="SHA256SUMS-format file: '<hex>  <path>'")
    p.add_argument("--root", default=None,
                   help="base dir for relative paths (default: sums dir)")
    return p


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def run(args) -> int:
    root = args.root or os.path.dirname(os.path.abspath(args.sums))
    bad = missing = ok = 0
    with open(args.sums) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            expected, _, rel = line.partition("  ")
            path = rel if os.path.isabs(rel) else os.path.join(root, rel)
            if not os.path.exists(path):
                print(f"{rel}: MISSING")
                missing += 1
                continue
            actual = sha256_file(path)
            if actual == expected.lower():
                print(f"{rel}: OK")
                ok += 1
            else:
                print(f"{rel}: FAILED (got {actual})")
                bad += 1
    print(f"{ok} ok, {bad} failed, {missing} missing", file=sys.stderr)
    return 1 if (bad or missing) else 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
