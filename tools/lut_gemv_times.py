#!/usr/bin/env python3
"""Time one tree's CUDA LUT-GEMV on the card, under two timing methods.

    python3 tools/lut_gemv_times.py [--src DIR] [--label NAME] [--sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default).  The timer, the shapes and the random weights come
from this tree's ``chip_smoke.py`` whatever ``--src`` is, so two trees are
timed by one method.  To compare two commits, unpack the other one into a
git-ignored directory (``git archive``) and run this script once per tree
in one call, in the order A, B, B, A.

For both LUT-GEMV flavours (b = 4, G = 128, abits = 8 on the int path) and
``torch.matmul`` on the dequantized weight it takes, at full-width
tinymistral_248m's five weight shapes and every M of ``--ms``:

* the device time per call, CUDA-graph replay with L2 flushed before each
  (median of 30), under both methods: ``spin`` (chip_smoke's ``Timer``:
  the card spins ~100 us before the start event, so the host's enqueue of
  the replay is not timed) and ``nospin`` (no spin);
* the M = 8 times summed over a decode step's 85 calls, and the 85 calls
  replayed as one graph with no flush;
* the max abs error of each flavour against its plain version.

``--sweep`` (a tree whose plan has ``with_splits``) also times every
split count of a tile up to the cluster's limit at M = 8 and 64, with the
plan's own count marked.  Prints the card's name and power limit and one
line per result; writes everything as JSON to
``build/lut_gemv_times/<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = {"spin": 200_000, "nospin": 0}
GROUP, BITS, ABITS = 128, 4, 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--ms", default="8,64,256")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("lut_gemv_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core.quant import dequantize, quantize_activations
    from repro_torch.kernels import _build
    from repro_torch.kernels.lut_gemv import kernel as kmod
    from repro_torch.kernels.lut_gemv.ref import lut_matmul_ref, \
        lut_matmul_ref_int

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"label": args.label, "src": os.path.abspath(args.src),
           "card": cs.card_line(), "shapes": [], "step": {}, "floor_us": {},
           "sweep": []}
    cs.log(f"[{args.label}] {out['card']}; repro_torch from {out['src']}")
    _build.build(["lut_gemv"])
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = sorted(set(cs.MATMULS.values()))
    calls_per_step = {kn: 0 for kn in shapes}
    for name, kn in cs.MATMULS.items():
        calls_per_step[kn] += 1 if name == "lm_head" else 12

    def timed(fn) -> dict:
        res = {}
        for method, cycles in METHODS.items():
            timer.spin_cycles = cycles
            res[method] = 1e3 * timer(fn)
        return res

    for method, cycles in METHODS.items():
        timer.spin_cycles = cycles
        out["floor_us"][method] = 1e3 * timer(
            lambda: timer.flush[:1].zero_())

    for m in (int(v) for v in args.ms.split(",")):
        for k, n in shapes:
            qt = cs.rand_qtensor(torch, gen, k, n, BITS, GROUP, False)
            wd = dequantize(qt)
            x = torch.randn((m, k), device="cuda", generator=gen)
            xq, xs = quantize_activations(x, ABITS)
            f32 = lambda: kmod.lut_matmul_cuda(x, qt)
            int_ = lambda: kmod.lut_matmul_int_cuda(xq, xs, qt, ABITS)
            row = dict(m=m, k=k, n=n,
                       err_f32=(f32() - lut_matmul_ref(x, qt)).abs().max()
                       .item(),
                       err_int=(int_() - lut_matmul_ref_int(xq, xs, qt))
                       .abs().max().item(),
                       f32_us=timed(f32), int_us=timed(int_),
                       library_us=timed(lambda: torch.matmul(x, wd)))
            if hasattr(kmod, "_card_plan"):       # a tree with a launch plan
                row["splits"] = kmod._card_plan(m, k, qt, 0, x.device).splits
            out["shapes"].append(row)
            cs.log(f"[{args.label}] M={m} ({k}, {n}) splits "
                   f"{row.get('splits', '-')}: " + "; ".join(
                       f"{what} " + " / ".join(
                           f"{row[what][mt]:.2f}" for mt in METHODS)
                       for what in ("f32_us", "int_us", "library_us"))
                   + f" (spin / nospin); err {row['err_f32']:.2e} / "
                   f"{row['err_int']:.2e}")
            if args.sweep and m in (8, 64) and hasattr(kmod, "with_splits"):
                sweep(cs, torch, timer, kmod, out, args.label, m, qt, x, xq,
                      xs, lut_matmul_ref(x, qt))

    for method in METHODS:
        for what in ("f32_us", "int_us", "library_us"):
            out["step"][f"sum_{what[:-3]}_ms_{method}"] = 1e-3 * sum(
                r[what][method] * calls_per_step[r["k"], r["n"]]
                for r in out["shapes"] if r["m"] == 8)

    # a decode step's 85 calls, each on its own weights, as one graph
    layers = [{name: cs.rand_qtensor(torch, gen, k, n, BITS, GROUP, False)
               for name, (k, n) in cs.MATMULS.items() if name != "lm_head"}
              for _ in range(12)]
    head = cs.rand_qtensor(torch, gen, *cs.MATMULS["lm_head"], BITS, GROUP,
                           False)
    xk = {k: torch.randn((8, k), device="cuda", generator=gen)
          for k in (1024, 4096)}
    xqk = {k: quantize_activations(v, ABITS) for k, v in xk.items()}
    wds = [dequantize(qt) for layer in layers for qt in layer.values()]
    wds.append(dequantize(head))
    steps = {
        "f32": lambda: [kmod.lut_matmul_cuda(xk[qt.k], qt)
                        for qt in [*(q for lay in layers
                                     for q in lay.values()), head]],
        "int": lambda: [kmod.lut_matmul_int_cuda(*xqk[qt.k], qt, ABITS)
                        for qt in [*(q for lay in layers
                                     for q in lay.values()), head]],
        "library": lambda: [torch.matmul(xk[w.shape[0]], w) for w in wds]}
    for method, cycles in METHODS.items():
        timer.spin_cycles = cycles
        for what, fn in steps.items():
            out["step"][f"graph_{what}_ms_{method}"] = timer.replay_ms(fn)
    names = [f"{kind}_{what}" for kind in ("sum", "graph")
             for what in ("f32", "int", "library")]
    cs.log(f"[{args.label}] per decode step (b=4, M=8, 85 calls; spin / "
           f"nospin): " + "; ".join(
               f"{name} " + " / ".join(f"{out['step'][f'{name}_ms_{mt}']:.4f}"
                                      for mt in METHODS) for name in names)
           + f" ms; timer floor {out['floor_us']['spin']:.2f} / "
           f"{out['floor_us']['nospin']:.2f} us")

    os.makedirs(os.path.join(ROOT, "build", "lut_gemv_times"), exist_ok=True)
    path = os.path.join(ROOT, "build", "lut_gemv_times",
                        f"{args.label}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"[{args.label}] wrote {path}")
    return 0


def sweep(cs, torch, timer, kmod, out, label, m, qt, x, xq, xs, ref):
    """Every split count of a tile up to the cluster's limit (and the
    slab count), f32 and int, with the spin method; the plan's own marked."""
    timer.spin_cycles = METHODS["spin"]
    p = kmod._card_plan(m, qt.k, qt, 0, x.device)
    cells = []
    for s in range(1, min(kmod.MAX_SPLITS, p.slabs) + 1):
        q = kmod.with_splits(p, s)
        f32 = lambda: kmod._launch(x, None, None, qt, q, 0, x.device)
        int_ = lambda: kmod._launch(None, xq, xs, qt, q, ABITS, x.device)
        err = (f32() - ref).abs().max().item()
        if err > cs.LUT_ATOL + cs.LUT_RTOL * ref.abs().max().item():
            cs.fail(f"split sweep M={m} ({qt.k}, {qt.n}) splits {s}: max "
                    f"abs err {err:.3e}")
        cell = dict(m=m, k=qt.k, n=qt.n, splits=s, blocks=q.blocks,
                    planned=s == p.splits, f32_us=1e3 * timer(f32),
                    int_us=1e3 * timer(int_), err_f32=err)
        out["sweep"].append(cell)
        cells.append(cell)
    cs.log(f"[{label}] sweep M={m} ({qt.k}, {qt.n}), splits: f32 / int us: "
           + "; ".join(f"{c['splits']}{'*' if c['planned'] else ''} "
                       f"{c['f32_us']:.2f} / {c['int_us']:.2f}"
                       for c in cells))


if __name__ == "__main__":
    sys.exit(main())
