"""Registry maintenance CLI.

    python -m fm_returnprediction_tpu_torch.registry ls                 # list entries
    python -m fm_returnprediction_tpu_torch.registry verify             # deep-check
    python -m fm_returnprediction_tpu_torch.registry verify --shallow   # sizes only
    python -m fm_returnprediction_tpu_torch.registry gc --keep 4        # collect
    python -m fm_returnprediction_tpu_torch.registry gc --dry-run

The root resolves from ``--registry-dir`` or ``FMRP_REGISTRY_DIR``.
``verify`` exits 1 when any entry fails its manifest (the corrupt rows
are printed; a later fetch of a corrupt entry would heal it by dropping
and recompiling, ``verify`` just finds them eagerly). ``gc`` applies the
documented retention policy: newest ``--keep`` per executable
(program, signature) / artifact name, torn entries always dropped;
``--drop-skewed`` additionally removes kernel libraries built under
another stack (torch, CUDA, nvcc, card; opt-in — skew is judged against
the CURRENT process's stack, so run it from the consumers' node, not a
login box).
"""

from __future__ import annotations

import argparse
import sys

from fm_returnprediction_tpu_torch.registry.store import Registry, registry_dir


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n / 1:.1f}{unit}"
        n /= 1024
    return f"{n}B"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fm_returnprediction_tpu_torch.registry",
        description="Inspect and maintain the kernel-library/artifact "
                    "registry.",
    )
    parser.add_argument("--registry-dir", default=None,
                        help="registry root (default: FMRP_REGISTRY_DIR)")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("ls", help="list every entry")
    p_verify = sub.add_parser("verify", help="verify entry manifests")
    p_verify.add_argument("--shallow", action="store_true",
                          help="sizes/structure only (skip content hashes)")
    p_gc = sub.add_parser("gc", help="apply the retention policy")
    p_gc.add_argument("--keep", type=int, default=4,
                      help="entries retained per program/artifact name "
                           "(default 4)")
    p_gc.add_argument("--drop-skewed", action="store_true",
                      help="also drop kernel libraries built under another "
                           "torch/CUDA/nvcc/card — run this from the "
                           "CONSUMERS' stack: skew is judged against the "
                           "current process, so a login node or a local "
                           "upgrade would wipe other stacks' live entries")
    p_gc.add_argument("--dry-run", action="store_true",
                      help="report what would be dropped, drop nothing")
    args = parser.parse_args(argv)

    root = args.registry_dir or registry_dir()
    if root is None:
        print("no registry root: pass --registry-dir or set "
              "FMRP_REGISTRY_DIR", file=sys.stderr)
        return 2
    reg = Registry(root)

    if args.command == "ls":
        rows = reg.ls()
        if not rows:
            print(f"registry {reg.root}: empty")
            return 0
        for row in rows:
            label = row.get("program") or row.get("name") or ""
            extra = " ".join(
                f"{k}={row[k]}" for k in ("backend", "torch", "jax", "created_at")
                if k in row
            )
            flag = "" if row["readable"] else "  [TORN]"
            print(f"{row['kind']:<10} {label:<24} "
                  f"{_fmt_bytes(row['bytes']):>9}  {row['path']}"
                  f"{('  ' + extra) if extra else ''}{flag}")
        total = sum(r["bytes"] for r in rows)
        print(f"{len(rows)} entries, {_fmt_bytes(total)}")
        return 0

    if args.command == "verify":
        bad = reg.verify(deep=not args.shallow)
        for row in bad:
            print(f"CORRUPT {row['path']}: {row['error']}", file=sys.stderr)
        print(f"{'FAILED' if bad else 'ok'}: {len(bad)} corrupt entr"
              f"{'y' if len(bad) == 1 else 'ies'}")
        return 1 if bad else 0

    if args.command == "gc":
        dropped = reg.gc(keep=args.keep,
                         drop_skewed=args.drop_skewed,
                         dry_run=args.dry_run)
        verb = "would drop" if args.dry_run else "dropped"
        for row in dropped:
            print(f"{verb} {row['path']}: {row['reason']}")
        print(f"{verb} {len(dropped)} entr"
              f"{'y' if len(dropped) == 1 else 'ies'}")
        return 0

    return 2  # unreachable: sub.required


if __name__ == "__main__":
    sys.exit(main())
