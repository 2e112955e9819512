"""The control of a cell's correctness check: the reference, computed
with bfloat16 storage (every stage's input, taps, spectrum and output
rounded), put in the program's place on the outputs a run would compare,
at the cell's own sizes.  It has to come out as not correct; its readings
set the upper end of the cell's limit (``limits/<cell>.json``).  The
benchmark's runs never run it.

    python -m portbench.control --workload <cell> --seeds 11,12,13

One line of JSON a seed, then one with the smallest reading.  It runs on
one card whatever the cell asks for (the reference is not sharded).
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(spec: dict, seeds: list[int], device, each=None) -> list[dict]:
    """The control's ``max_rel_err`` on each seed; ``each`` sees every
    reading as it comes."""
    from portbench import harness
    from portbench.compare import compare

    out = []
    for seed in seeds:
        ctx = harness.make_ctx(spec, seed, 0.0, False, device)
        items = harness.entry_of(spec).control_items(ctx)
        got = compare(ctx.stages, items, spec["traffic"]["ref_rows"], control=True)
        out.append({"seed": seed, "max_rel_err": got["max_rel_err"], "items": len(items)})
        if each is not None:
            each(out[-1])
    return out


def main(argv=None) -> int:
    from portbench import harness

    p = argparse.ArgumentParser(prog="python -m portbench.control", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    limit = spec["limits"]["max_rel_err"]
    def show(r: dict) -> None:
        print(json.dumps(dict(r, workload=args.workload, limit=limit,
                              fails=not r["max_rel_err"] <= limit)), flush=True)

    rows = readings(spec, [int(s) for s in args.seeds.split(",")], torch.device("cuda", 0),
                    show)
    print(json.dumps({"workload": args.workload, "smallest": min(r["max_rel_err"] for r in rows),
                      "limit": limit, "card": harness.card(torch.device("cuda", 0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
