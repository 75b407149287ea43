"""Turn the ``[stages]`` and ``[trace]`` JSON lines of a ``chip_smoke.py``
log into one table per path: per scope the stage clock's elapsed ms, the
host's ms, the device's busy ms and launches from the trace, the entries
and the synchronising copies and reads.

    python3 chip_smoke.py > smoke.log
    python3 scripts/stages_table_torch.py smoke.log [--depth 2]

It measures nothing: every number is one the log holds.
"""

import argparse
import json


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log")
    ap.add_argument("--depth", type=int, default=3,
                    help="deepest scope nesting to list")
    args = ap.parse_args()
    clock, trace = {}, {}
    with open(args.log) as f:
        for line in f:
            for tag, into in (("[stages] {", clock), ("[trace] {", trace)):
                if line.startswith(tag):
                    rec = json.loads(line[len(tag) - 1:])
                    if "path" in rec:
                        into[rec["path"]] = rec
    for path, c in clock.items():
        t = trace.get(path, {})
        print(f"\n{path}: wall {c['wall_ms']} ms under the clock "
              f"(spread {c['wall_ms_spread']}), {c['frames']} frame(s); "
              f"busy {t.get('busy_ms')} ms and {t.get('launches')} launches "
              f"per traced frame (traced wall {t.get('traced_wall_ms')} ms); "
              f"{c['host_syncs_per_frame']} synchronising copies and reads")
        print("| scope | entries | elapsed ms | host ms | busy ms | "
              "launches | syncs |")
        print("|---|---|---|---|---|---|---|")
        for name, v in c["scopes"].items():
            if name.count("/") - name.startswith("glue/") >= args.depth:
                continue
            b = t.get("scopes", {}).get(name, {})
            print(f"| {name} | {v['entries']:g} | {v['elapsed_ms']:.2f} | "
                  f"{v['host_ms']:.2f} | {b.get('ms', 0):.2f} | "
                  f"{b.get('launches', 0):g} | {v['syncs']:g} |")


if __name__ == "__main__":
    main()
