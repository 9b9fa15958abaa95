"""Wall time of `chip_smoke.py`, path by path, for one or more checkouts.

    python3 tools/smoke_wall.py DIR [DIR ...]

Runs `python3 chip_smoke.py` with no arguments in each DIR in turn (a
checkout or an unpacked `git archive`; to compare two trees on one card,
give both in one call). Each run's output goes to DIR/smoke_wall.log,
every line stamped with the seconds since that run started. Prints one
JSON line a run: the directory, the exit code, the wall seconds and, for
every value of the "phase" key in the run's JSON records, the seconds at
its first and last record. A main path prints its records as it goes or
all at its end, so compare the same phase's stamps between two runs, not
the gaps within one. Needs no JAX: it only starts the script and reads
its output.
"""
import json
import os
import subprocess
import sys
import time

TIMEOUT_S = 1500


def time_run(root):
    root = os.path.abspath(root)
    phases = {}
    t0 = time.perf_counter()
    with open(os.path.join(root, "smoke_wall.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "chip_smoke.py"], cwd=root, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            for line in proc.stdout:
                t = time.perf_counter() - t0
                log.write("%.3f %s" % (t, line))
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(rec.get("phase"),
                                                        str):
                    first, _ = phases.get(rec["phase"], (t, t))
                    phases[rec["phase"]] = (first, t)
            rc = proc.wait(timeout=TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"root": root, "rc": rc,
            "seconds": time.perf_counter() - t0,
            "phases": {k: {"first_s": a, "last_s": b}
                       for k, (a, b) in phases.items()}}


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    rcs = []
    for root in sys.argv[1:]:
        rec = time_run(root)
        rcs.append(rec["rc"])
        print(json.dumps(rec), flush=True)
    sys.exit(max(abs(rc) for rc in rcs))


if __name__ == "__main__":
    main()
