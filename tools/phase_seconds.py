#!/usr/bin/env python3
"""The seconds each phase of ``chip_smoke.py`` takes, for one or more
checkouts run in turns on one NVIDIA GPU.

    python3 tools/phase_seconds.py PARENT_DIR . [--log-dir DIR]

Each argument is the root of a checkout.  ``python3 chip_smoke.py`` runs
from that root in a fresh process (it builds that checkout's kernels into
its own ``build/``), and every line of its standard output is stamped
with the host clock as it arrives.  A phase's seconds are the time from
the previous JSON line (the start, for the first) to its own line; lines
that are not JSON (a spawned rank's report) belong to the phase they
precede.  Prints one JSON line a checkout: its exit code, its total
seconds, each phase's seconds, in order, and each phase's peak memory
readings (every ``peak_memory_bytes*`` key of its line and of the runs
nested in it, such as a parallel phase's ``zero1`` run); then
``nvidia-smi``'s name and power limit of the card.  The raw output of each run goes to
``LOG_DIR/phase_seconds_<i>.log``.  Exits non-zero when a run does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _peaks(obj: dict, prefix: str = "") -> dict:
    """The ``peak_memory_bytes*`` numbers of a phase line, by their key
    (a nested run's prefixed with its own key)."""
    out = {}
    for k, v in obj.items():
        if k.startswith("peak_memory_bytes") and isinstance(v, (int, float)):
            out[prefix + k] = v
        elif isinstance(v, dict) and not prefix:
            out.update(_peaks(v, k + "."))
    return out


def run(root: str, log_path: str) -> dict:
    """One run of ``root``'s ``chip_smoke.py``, its lines stamped."""
    t0 = time.perf_counter()
    last = t0
    phases, peaks = [], {}
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, bufsize=1)
    with open(log_path, "w") as log:
        for line in proc.stdout:
            now = time.perf_counter()
            log.write(f"{now - t0:10.3f} {line}")
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                name = obj.get("phase", "kernels" if "kernels" in obj
                               else "ok" if "ok" in obj else "?")
                phases.append([name, round(now - last, 3)])
                last = now
                if _peaks(obj):
                    peaks[name] = _peaks(obj)
    rc = proc.wait()
    return {"checkout": root, "rc": rc,
            "total_s": round(time.perf_counter() - t0, 3),
            "phase_seconds": phases, "peaks": peaks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--log-dir", default="build/phase_seconds")
    args = ap.parse_args()
    os.makedirs(args.log_dir, exist_ok=True)
    worst = 0
    for i, root in enumerate(args.checkouts):
        out = run(os.path.abspath(root),
                  os.path.join(args.log_dir, f"phase_seconds_{i}.log"))
        print(json.dumps(out), flush=True)
        worst = worst or out["rc"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
