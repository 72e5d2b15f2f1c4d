"""Hash-throughput runner.

Runs the two hash benches in child processes (one at a time; this parent
never imports JAX, so one process holds the card) and writes their JSON
lines to one file (default chiprun_out/hash.jsonl):

* ``bench_hash.py``   — device-math rate (cubes -> packed hashes/s/chip)
* ``bench_e2e_hash.py`` — end-to-end videos/s incl. host decode, both
  host-preproc and device-preproc variants (one line carries both).

Usage: python tools/bench_hash_all.py   (VDF_HASH_OUT overrides the path)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)


def main() -> None:
    out_path = os.environ.get(
        "VDF_HASH_OUT", os.path.join(_REPO, "chiprun_out", "hash.jsonl")
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = []
    for script in ("bench_hash.py", "bench_e2e_hash.py"):
        print(f"# running {script} ...", file=sys.stderr, flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.join(_HERE, script)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            raise RuntimeError(f"{script} failed")
        line = proc.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        print(line, flush=True)
        with open(out_path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in results) + "\n")
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
