"""Published claims of the port against its newest measured bench line.

The port's counterpart of ``scripts/check_claims.py``, with the same
``check``: ``fish_tts_tpu_torch/CLAIMS.json`` holds the headline numbers
that the README's port section publishes, under the keys of the line
``python -m fish_tts_tpu_torch.scripts.bench`` prints; each claim is
compared with the newest bench record of a card (or an explicit ``--bench``
file), and a claim more than ``--tol`` (15% by default) better than the
measurement is flagged.

Records: the ``BENCH_r*.json`` files at the repository's root whose
``parsed`` line names an NVIDIA card in its ``device``.  A record of another
device (the JAX bench's TPU lines) is never one of the port's.  With none,
there is nothing to check.

Exit code 1 when a claim drifts.

Usage: python -m fish_tts_tpu_torch.scripts.check_claims [--bench FILE] [--tol 0.15]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
CLAIMS = pathlib.Path(__file__).resolve().parents[1] / "CLAIMS.json"

# keys where LARGER is better; everything else in CLAIMS.json is
# smaller-is-better (rtf_*, ttfa_*, init_*)
LARGER_IS_BETTER = re.compile(
    r"tok_per_sec|frames_per_sec|x_realtime|semantic_tokens_per_sec|value"
)


def is_card_record(parsed: dict) -> bool:
    """Whether a bench line was measured on an NVIDIA card."""
    return "nvidia" in str(parsed.get("device", "")).lower()


def newest_bench(root: pathlib.Path = ROOT) -> tuple[str, dict] | None:
    """(file name, parsed line) of the newest card record under ``root``."""
    best = None
    for f in root.glob("BENCH_r*.json"):
        m = re.match(r"BENCH_r(\d+)\.json", f.name)
        if not m:
            continue
        try:
            parsed = json.loads(f.read_text()).get("parsed") or {}
        except (OSError, ValueError, AttributeError):
            continue
        if not is_card_record(parsed):
            continue
        if best is None or int(m.group(1)) > best[0]:
            best = (int(m.group(1)), f.name, parsed)
    return (best[1], best[2]) if best else None


def check(claims: dict, bench: dict, tol: float) -> list[str]:
    """Return drift messages: claims that beat the measurement by > tol."""
    drift = []
    for key, claimed in claims.items():
        if key.startswith("_") or not isinstance(claimed, (int, float)):
            continue
        measured = bench.get(key)
        if not isinstance(measured, (int, float)) or measured == 0:
            continue
        if LARGER_IS_BETTER.search(key):
            ratio = claimed / measured          # >1 means claim is rosier
        else:
            ratio = measured / claimed          # smaller-is-better metrics
        if ratio > 1.0 + tol:
            drift.append(
                f"{key}: claimed {claimed} vs measured {measured} "
                f"({(ratio - 1) * 100:.0f}% rosier than the record)")
    return drift


def main(argv: list[str] | None = None, root: pathlib.Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default=None,
                    help="bench JSON file (default: the newest card record BENCH_r*.json)")
    ap.add_argument("--tol", type=float, default=0.15)
    args = ap.parse_args(argv)

    if not CLAIMS.exists():
        print("# no CLAIMS.json — nothing to check", file=sys.stderr)
        return 0
    claims = json.loads(CLAIMS.read_text())

    if args.bench:
        raw = json.loads(pathlib.Path(args.bench).read_text())
        bench = raw.get("parsed", raw)
        src = args.bench
    else:
        nb = newest_bench(root)
        if nb is None:
            print("# no card BENCH_r*.json found — nothing to check", file=sys.stderr)
            return 0
        src, bench = nb

    drift = check(claims, bench, args.tol)
    if drift:
        print(f"# CLAIMS DRIFT vs {src} (tol {args.tol:.0%}):", file=sys.stderr)
        for d in drift:
            print(f"#   {d}", file=sys.stderr)
        return 1
    print(f"# claims consistent with {src} (tol {args.tol:.0%})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
