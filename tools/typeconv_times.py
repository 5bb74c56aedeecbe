#!/usr/bin/env python3
"""Time one tree's CUDA typeconv (Algorithm 1, int32 -> float32) on the card.

    python3 tools/typeconv_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default).  The timer, the cases, the random inputs and both
bounds come from this tree's ``chip_smoke.py`` whatever ``--src`` is, so
two trees are timed by one method and held to one bound: the integer
instructions per element are counted in the SASS of this tree's kernel
for each n, and priced at the card's integer rate (``chip_smoke.int_rate``).
To compare two commits, unpack the other one into a git-ignored directory
(``git archive``) and run this script once per tree in one call, in the
order A, B, B, A.

Cases (chip_smoke's ``TC_CASES``): [64, 4096] and [4096, 4096] at n = 8,
and [4096, 4096] at n = 16 and n = 25.  Each row: the device time
(chip_smoke's ``Timer``: CUDA-graph replay, L2 flushed, median of 30),
``.float()``'s, the plain version's and the eager call time; the bytes
bound and the integer bound with the kernel's share of each; the SASS's
and the paper's operations per element; and whether the result is
bit-equal to ``.float()``.  Prints the card's name and power limit and one
line per case; writes everything as JSON to
``build/typeconv_times/<label>.json``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def this_tree_ops_per_elem(cs) -> dict:
    """{n: integer instructions per element} from the SASS of this tree's
    typeconv library (built here if needed), whatever ``--src`` is."""
    spec = importlib.util.spec_from_file_location(
        "_this_tree_build",
        os.path.join(ROOT, "src", "repro_torch", "kernels", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build(["typeconv"])
    return cs.typeconv_sass(cs.sass_listing(
        build.library_path("typeconv")))["ops_per_elem"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("typeconv_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.typeconv.kernel import int_to_f32_cuda

    rate = cs.int_rate(torch)
    ops = this_tree_ops_per_elem(cs)
    out = {"label": args.label, "src": os.path.abspath(args.src),
           "card": cs.card_line(), "int_rate": rate, "ops_per_elem": ops,
           "rows": []}
    cs.log(f"[{args.label}] {out['card']}; repro_torch from {out['src']}; "
           f"integer rate {rate['ops_per_s']:.4e} ops/s ({rate['sms']} SMs x "
           f"{rate['max_sm_mhz']:.0f} MHz x {rate['per_sm_clock']})")
    _build.build(["typeconv"])
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["floor_us"] = 1e3 * timer(lambda: timer.flush[:1].zero_())
    for shape, n in cs.TC_CASES:
        a = cs.typeconv_input(torch, gen, n, shape)
        got = int_to_f32_cuda(a, n)
        row = cs.typeconv_row(torch, timer, a, n, int_to_f32_cuda, ops[n],
                              rate["ops_per_s"])
        row.update(bit_equal=bool(torch.equal(got, a.float())),
                   max_abs_err=(got - a.float()).abs().max().item())
        out["rows"].append(row)
        cs.log(f"[{args.label}] {cs.typeconv_text(row)}; bit-equal "
               f"{row['bit_equal']}")
        del a, got
    cs.log(f"[{args.label}] timer floor {out['floor_us']:.2f} us")

    os.makedirs(os.path.join(ROOT, "build", "typeconv_times"), exist_ok=True)
    path = os.path.join(ROOT, "build", "typeconv_times", f"{args.label}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"[{args.label}] wrote {path}")
    return 0 if all(r["bit_equal"] for r in out["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
