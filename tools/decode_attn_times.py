#!/usr/bin/env python3
"""Time one tree's CUDA decode attention on the card.

    python3 tools/decode_attn_times.py [--src DIR] [--label NAME] [--sweep]
        [--probe] [--stage-bytes N] [--table BS]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default).  The timer, the cases, the random inputs and the bound
come from this tree's ``chip_smoke.py`` whatever ``--src`` is, so two trees
are timed by one method.  To compare two commits, unpack the other one into
a git-ignored directory (``git archive``) and run this script once per tree
in one call, in the order A, B, B, A.

At tinymistral_248m's widths (8 lanes, 32 query heads over 8 kv heads of
width 32, int8 K/V, ring mode, window 4096) it times the main path's call
at chip_smoke's three cases: S = 512 at a wrapped ring's positions, S = 4096
with every slot valid, and S = 512 at the engine's positions (p in
[40, 100)).  Each row: the device time (chip_smoke's ``Timer``: CUDA-graph
replay, L2 flushed, median of 30), the plain version's, SDPA's on the
dequantized K/V, the eager call time, the bound over the valid slots and
the max abs error against the plain version; then the call again and a
library copy that moves the bound's bytes (torch's ``copy_`` of an int8
buffer of half of them) under both flushes: written (the ``Timer``'s,
leaving L2 dirty) and read (``Timer.flush_by_read``, leaving L2 clean).

``--sweep`` (a tree whose plan has ``with_splits``) also times every split
count up to the cluster's limit in each case, the plan's own marked;
``--stage-bytes N`` plans this run's stages with N bytes instead of the
plan's ``STAGE_BYTES``.
``--table BS`` (a tree with the table mode) also times the table mode over
a block pool of BS-token blocks (chip_smoke's ``paged_inputs``: shuffled
tables with gaps, one lane all trash) at S = 512 and 4096 with every
lane's slots valid and at the engine's positions (p in [40, 100)), each
beside ring mode on the same rows laid out contiguously, the plain
version, SDPA and the bound over the valid slots (chip_smoke's
``table_row``).
``--probe`` (such a tree) times the same sweep at S = 4096, under both
flushes, on layouts that
tell bytes, compute and the access pattern apart: the main layout (8
sequences x 8 kv heads: a head's rows 32 bytes apart from the next
position's by 256), 64 sequences x 1 kv head (the same rows and work, each
head's rows contiguous), f32 K/V (4x the bytes, the same work) and G = 1
(8 query heads: a quarter of the work, the same bytes).
Prints the card's name and power limit and one line per result; writes
everything as JSON to ``build/decode_attn_times/<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--stage-bytes", type=int, default=0)
    ap.add_argument("--table", type=int, default=0, metavar="BS")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("decode_attn_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import kernel as kmod
    from repro_torch.kernels.decode_attn.ref import decode_attention_ring_ref

    if args.stage_bytes:            # the plan's stage size, for this run
        kmod.STAGE_BYTES = args.stage_bytes
        kmod.plan.cache_clear()
    out = {"label": args.label, "src": os.path.abspath(args.src),
           "card": cs.card_line(), "rows": [], "sweep": [],
           "stage_bytes": getattr(kmod, "STAGE_BYTES", None)}
    cs.log(f"[{args.label}] {out['card']}; repro_torch from {out['src']}")
    _build.build(["decode_attn"])
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["floor_us"] = 1e3 * timer(lambda: timer.flush[:1].zero_())
    b, h, kvh, d = cs.ATTN_B, cs.ATTN_KV * cs.ATTN_G, cs.ATTN_KV, cs.ATTN_D
    x512, x4096 = cs.attn_inputs(torch, gen, 512), cs.attn_inputs(torch, gen,
                                                                   4096)
    pos = lambda lo, hi: torch.randint(lo, hi, (b,), device="cuda",
                                       generator=gen, dtype=torch.int32)
    cases = {"main": (x512, torch.tensor([3, 300, 511, 512, 700, 1023, 1500,
                                          2047], dtype=torch.int32,
                                         device="cuda")),
             "s4096": (x4096, pos(4095, 3 * 4096)),
             "engine": (x512, pos(40, 100))}
    for name, (x, position) in cases.items():
        s = x["kq"].shape[1]
        args_ = (x["q"], x["kq"], x["vq"], position, x["ksc"], x["vsc"])
        ref = decode_attention_ring_ref(*args_[:4], cs.ATTN_WINDOW,
                                        *args_[4:])
        err = (kmod.decode_attention_cuda(*args_, cs.ATTN_WINDOW, ring=True)
               - ref).abs().max().item()
        row = cs.attention_row(torch, timer, x, position,
                               kmod.decode_attention_cuda)
        # the same call and a library copy that moves the bound's bytes
        # (torch's copy_ of an int8 buffer of half of them) under both
        # flushes
        half = int(row["bound_ms"] * cs.HBM_BYTES_PER_S * 1e-3) // 2
        src = torch.ones(half, dtype=torch.int8, device="cuda")
        dst = torch.empty_like(src)
        call = lambda: kmod.decode_attention_cuda(*args_, cs.ATTN_WINDOW,
                                                  ring=True)
        for mode in ("write", "read"):
            timer.flush_by_read = mode == "read"
            row[f"{mode}_flush_us"] = 1e3 * timer(call)
            row[f"{mode}_flush_copy_us"] = 1e3 * timer(lambda: dst.copy_(src))
        timer.flush_by_read = False
        del src, dst
        row.update(case=name, max_abs_err=err)
        if hasattr(kmod, "card_plan"):           # a tree with a launch plan
            p = kmod.card_plan(b, h, kvh, d, s, cs.ATTN_WINDOW, True, True,
                               x["q"].device)
            row.update(splits=p.splits, blocks=p.blocks)
        out["rows"].append(row)
        cs.log(f"[{args.label}] {name}: S={s}, {row['valid_slots']} valid "
               f"slots, splits {row.get('splits', '-')}: "
               f"{1e3 * row['ms']:.2f} us; plain {1e3 * row['plain_ms']:.2f}"
               f", SDPA {1e3 * row['library_ms']:.2f}, eager call "
               f"{1e3 * row['call_ms']:.2f} us; bound "
               f"{1e3 * row['bound_ms']:.3f} us ({100 * row['bound_share']:.1f}"
               f"% of it); max abs err {err:.2e}; write / read flush: "
               f"{row['write_flush_us']:.2f} / {row['read_flush_us']:.2f} us,"
               f" a library copy of the bound's bytes "
               f"{row['write_flush_copy_us']:.2f} / "
               f"{row['read_flush_copy_us']:.2f} us")
        if args.sweep and hasattr(kmod, "with_splits"):
            p = kmod.card_plan(b, h, kvh, d, s, cs.ATTN_WINDOW, True, True,
                               x["q"].device)
            cells = []
            for lg in range(kmod.MAX_SPLITS.bit_length()):
                q = kmod.with_splits(p, 1 << lg)
                fn = lambda: kmod._launch(*args_, cs.ATTN_WINDOW, True, q)
                e = (fn() - ref).abs().max().item()
                if e > cs.ATTN_TOL * (1 + ref.abs().max().item()):
                    cs.fail(f"split sweep {name} splits {1 << lg}: max abs "
                            f"err {e:.3e}")
                cells.append(dict(case=name, splits=1 << lg,
                                  blocks=q.blocks, planned=q == p,
                                  us=1e3 * timer(fn), err=e))
            out["sweep"].extend(cells)
            cs.log(f"[{args.label}] sweep {name}, splits: us " + "; ".join(
                f"{c['splits']}{'*' if c['planned'] else ''} {c['us']:.2f}"
                for c in cells))
    if args.table:
        out["table"] = table(cs, torch, timer, kmod, gen, args.label,
                             args.table)
    if args.probe and hasattr(kmod, "with_splits"):
        out["probe"] = probe(cs, torch, timer, kmod, gen, args.label)
    cs.log(f"[{args.label}] timer floor {out['floor_us']:.2f} us")

    os.makedirs(os.path.join(ROOT, "build", "decode_attn_times"),
                exist_ok=True)
    path = os.path.join(ROOT, "build", "decode_attn_times",
                        f"{args.label}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"[{args.label}] wrote {path}")
    return 0


def table(cs, torch, timer, kmod, gen, label, bs):
    """Table mode at block size ``bs``: S 512 and 4096 with every slot of
    a lane valid, and S 512 at the engine's positions."""
    if not hasattr(kmod, "table_row"):
        cs.log(f"[{label}] this tree has no table mode")
        return []
    b, kvh, g, d = cs.ATTN_B, cs.ATTN_KV, cs.ATTN_G, cs.ATTN_D
    rows = []
    for name, s, pos in (("table_s512", 512, 511), ("table_s4096", 4096, 4095),
                         ("table_engine", 512, None)):
        x = cs.paged_inputs(torch, gen, b, kvh, g, d, s, bs, True, pos)
        if pos is None:
            x["pos"][:-1] = torch.randint(40, 100, (b - 1,), device="cuda",
                                          generator=gen, dtype=torch.int32)
        row = cs.table_row(torch, timer, x, kmod.decode_attention_cuda)
        p = kmod.card_plan(b, kvh * g, kvh, d, row["s"], cs.ATTN_WINDOW,
                           True, True, x["q"].device)
        row.update(case=name, splits=p.splits, blocks=p.blocks)
        rows.append(row)
        cs.log(f"[{label}] {name}: S={row['s']}, BS {bs}, "
               f"{row['valid_slots']} valid slots, splits {p.splits}: table "
               f"mode {1e3 * row['ms']:.2f} us, ring mode on the same rows "
               f"{1e3 * row['ring_ms']:.2f} us "
               f"({100 * row['indirection']:+.1f}%); plain "
               f"{1e3 * row['plain_ms']:.2f}, SDPA "
               f"{1e3 * row['library_ms']:.2f}, eager call "
               f"{1e3 * row['call_ms']:.2f} us; bound "
               f"{1e3 * row['bound_ms']:.3f} us "
               f"({100 * row['bound_share']:.1f}% of it)")
    return rows


def probe(cs, torch, timer, kmod, gen, label):
    """Every split count at S = 4096, all slots valid, ring mode, on four
    layouts: (B, KV, G, quantized)."""
    from repro_torch.core.quant import quantize_kv
    s, d, res = 4096, cs.ATTN_D, []
    for b, kvh, g, quant in ((8, 8, 4, True), (64, 1, 4, True),
                             (8, 8, 4, False), (8, 8, 1, True)):
        q = torch.randn((b, kvh * g, d), device="cuda", generator=gen)
        k = torch.randn((b, s, kvh, d), device="cuda", generator=gen)
        v = torch.randn((b, s, kvh, d), device="cuda", generator=gen)
        ks = vs = None
        if quant:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        pos = torch.full((b,), 2 * s, dtype=torch.int32, device="cuda")
        p = kmod.card_plan(b, kvh * g, kvh, d, s, cs.ATTN_WINDOW, True, quant,
                           q.device)
        cells = {}
        for mode in ("write", "read"):
            timer.flush_by_read = mode == "read"
            cells[mode] = []
            for lg in range(kmod.MAX_SPLITS.bit_length()):
                pl = kmod.with_splits(p, 1 << lg)
                cells[mode].append(1e3 * timer(lambda: kmod._launch(
                    q, k, v, pos, ks, vs, cs.ATTN_WINDOW, True, pl)))
        timer.flush_by_read = False
        clusters = [kmod.max_clusters(p.gm, quant, 1 << lg, p.smem)
                    for lg in range(kmod.MAX_SPLITS.bit_length())] \
            if hasattr(kmod, "max_clusters") else []
        res.append(dict(b=b, kv=kvh, g=g, quantized=quant, us=cells,
                        planned=p.splits, max_clusters=clusters))
        cs.log(f"[{label}] probe B={b} KV={kvh} G={g} "
               f"{'int8' if quant else 'f32'}: splits 1..16 us, write flush "
               + " / ".join(f"{c:.2f}" for c in cells["write"])
               + "; read flush "
               + " / ".join(f"{c:.2f}" for c in cells["read"])
               + f" (plan {p.splits}); clusters held at once "
               + " / ".join(str(c) for c in clusters))
    return res


if __name__ == "__main__":
    sys.exit(main())
