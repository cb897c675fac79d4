"""Prefill ms and decode tok/s of two checkouts of the port, in turns on
one card (A, B, B, A per round), so that host and card drift falls on
both sides alike.

    PYTHONPATH=src python -m repro_torch.launch.serve_ab <root A> <root B> \\
        [--rounds 2] [--reps 3]

Each turn is a fresh process that imports ``repro_torch`` from
``<root>/src`` (building that checkout's kernels), draws TinyLlama-1.1B
at full width from a generator seeded 0 on the card, and calls that
checkout's ``serve()`` at batch 8, prompt 1024, gen 64 once to warm up,
then ``--reps`` times, reporting ``serve()``'s own clocks.  The last
line is a JSON object with every run of both roots and their medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

TURN = r"""
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch import models
from repro_torch.configs import registry
from repro_torch.launch.serve import serve
cfg = registry.get_arch("tinyllama-1.1b")
model = models.Transformer(cfg, models.init_params(
    models.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
    "cuda"))
kw = dict(batch=8, prompt_len=1024, gen=64, device="cuda", params=model)
serve(cfg, **kw)
runs = [serve(cfg, **kw)[1] for _ in range(int(sys.argv[2]))]
print(json.dumps({"prefill_ms": [r["prefill_s"] * 1e3 for r in runs],
                  "tok_per_s": [r["tok_per_s"] for r in runs]}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    out = {"card": card, "a": args.root_a, "b": args.root_b,
           "runs": {"a": {"prefill_ms": [], "tok_per_s": []},
                    "b": {"prefill_ms": [], "tok_per_s": []}}}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            root = args.root_a if side == "a" else args.root_b
            res = subprocess.run(
                [sys.executable, "-c", TURN, root, str(args.reps)],
                capture_output=True, text=True, check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            for key, vals in got.items():
                out["runs"][side][key] += vals
            print(f"[turn] {side} {root}: {got}", flush=True)
    out["median"] = {side: {k: statistics.median(v) for k, v in r.items()}
                     for side, r in out["runs"].items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
