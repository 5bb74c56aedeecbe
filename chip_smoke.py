#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, as the chip check runs it

Phases (each passes or the script exits nonzero):
  1. build  — nvcc builds every kernel of the port from ``src/repro_torch/csrc``
     and the SASS of every kernel is checked for int->float conversion
     instructions (there must be none: Algorithm 1 and the int8 KV widening
     use integer and float bit operations, and no kernel divides at run
     time); typeconv's SASS must also hold no FLO, POPC or BREV (each would
     do a step of the conversion without Algorithm 1), and its integer
     instructions per element are counted in the vector loop of each n's
     instance; the card's 32-bit integer rate (64 per SM per clock) is read
     from its SM count and highest SM clock;
  2. kernels — each kernel against its plain PyTorch version on the card, at
     the main path's shapes, then timed (CUDA events, median of 30 launches,
     L2 flushed before each) beside its plain version, one PyTorch library
     call and its bound; both LUT-GEMV flavours must also give bit-identical
     results on two calls at every decode shape, and are timed per shape at
     M = 8 (decode) and M = 64 (prefill) beside the split count their launch
     plan chose; decode attention is timed at the main path's call (S 512,
     a wrapped ring), at S = 4096 and at the engine's positions (p in
     [40, 100)), each beside its launch plan and a bound over the valid
     slots; its table mode (the paged engine's) must agree with its plain
     version and be bit-equal to ring mode on the same rows laid out
     contiguously over D x G x S x block size x K/V type x window, and is
     timed at the engine's shape (block size 16, every slot of 7 lanes
     valid, the 8th lane's table all trash) at S 512 and 4096 beside ring
     mode on the same rows; typeconv must be bit-equal
     to ``.float()`` for every n in
     2..25, with 0 and +-(2**(n-1) - 1), a count that is not a multiple of 4
     and views at odd offsets, and is timed at [64, 4096] and [4096, 4096]
     (n = 8) and at [4096, 4096] (n = 16, 25) beside two bounds: its bytes
     and its SASS's integer instructions at the integer rate;
  3. model  — full-width tinymistral_248m (random weights, seed 0, int8 KV):
     one prefill of 2 prompts and 4 greedy decode steps on the card through
     the kernels and on the CPU through the plain versions.  Under uniform:4
     the logits must agree and the tokens must be identical; under
     uniform:4a8, where int8 activation rounding amplifies f32 rounding
     differences, every int LUT-GEMV launch of the card run must agree with
     its plain version on the same inputs;
  4. engine — the continuous-batching Engine serves 16 requests under
     uniform:4 and uniform:4a8; the kernels' launch counters must show every
     decode step sent all 85 weight matmuls through the plan's LUT-GEMV and
     every layer's attention through the decode-attention kernel, and the
     other LUT-GEMV was not launched; one decode step's device time, and its
     12 attention launches as one graph on the engine's own cache;
  5. paged — the engine over a paged pool (uniform:4, block size 16): run A
     serves phase 4's 16 requests over 8 lanes' worth of blocks without
     prefix sharing, and its tokens must equal the ring engine's; run B
     serves 16 requests in four groups sharing a 32-token prefix over one
     lane's 32 blocks, twice, and must complete them all with prefix hits,
     preemptions, every block returned and the same tokens both times; in
     both runs every decode step's attention must go through the table mode
     (none through ring mode) and its 85 weight matmuls through the LUT-GEMV;
     one full-pool paged step is timed beside the ring step, and a paged and
     a ring engine at equal KV bytes report how many requests they held;
  6. plans — mixed-precision plans on phase 4's 16 requests: plan R (rules,
     one segment: w_gate/w_up 2 bits, w_down 3, wq/wk/wv 6 with 6-bit
     activations, wo 5 with 4-bit, lm_head 8) on the ring pool with int8
     KV, every LUT-GEMV launch held against its plain version; plan S (a
     solved auto plan in three segments, layers 0-3 / 4-9 / 10-11, f32 KV)
     greedy card against CPU with phase 3's prompts and steps, and ring
     against paged engine (phase 5 run A's admission); plan S-a (S with
     4/6/8-bit activations on the MLP), held launch by launch, ring against
     paged.  Each LUT-GEMV instance (bits, abits) must launch exactly as
     often as the plan's layers, matrices and passes make it; one
     full-pool step of each plan is timed, and the LUT-GEMV's 85-call step
     as one graph at each weight bit width 2-8;
  7. planner — the Planner on the card (raw f32 weights, group 128): it
     probes and solves auto:q4a8,kv=auto (plan A8) and auto:q4 (plan Q4),
     printing the probe forwards, probe and solve seconds, the KV decision
     (the KV probe's decode steps over an f32 cache counted) and the solved
     allocation; both plans serve phase 4's 16 requests, every LUT-GEMV
     launch held against its plain version and each instance launched
     exactly as the solved tree implies, A8 on the paged pool too (ring
     and paged tokens equal); on phase 3's prompts Q4 card against CPU
     end to end and A8 launch by launch (its 4-bit activation codes turn
     f32 rounding into logit differences, as the CPU against itself with
     noise shows);
     the probes at full width and 2 layers on the card and on the CPU
     (every score within the CPU tests' tolerance, equal allocations); a
     live replan (replan(), then a re-solve under the tapped traffic and
     apply_plan) after 8 decode iterations, token-identical to an engine
     that served the final plan; the cost model refit to the bit-serial
     LUT-GEMV's timings on the card, and an SLO solve priced on it.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Exits nonzero without a
result when no CUDA device is visible.  Longer output (compiler log, the
result as JSON) goes to ``build/chip_smoke/``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# Hopper issues 64 32-bit integer instructions per SM per clock (a quarter
# of its f32 rate; the CUDA programming guide's throughput table); the
# card's rate is this times its SM count and highest SM clock (int_rate)
INT_OPS_PER_SM_CLOCK = 64

# Tolerances.  The f32 LUT-GEMV sums K <= 4096 products in another order than
# the plain version's matmul, so results differ by f32 rounding of that sum
# (the integer path on quantized data too, before its per-row scale);
# the integer path is exact on integer-valued data (integer codebook, unit
# scales, every partial sum below 2**24) and must be bit-equal; decode
# attention keeps the reference tests' 2e-5 (tests/test_kernels.py:80); the
# full model compounds f32 rounding through 12 layers and int8 KV rounding.
LUT_RTOL, LUT_ATOL = 1e-4, 1e-4
ATTN_TOL = 2e-5
MODEL_RTOL, MODEL_ATOL = 1e-3, 1e-3

# tinymistral_248m's weight matmuls (K, N) and their calls per decode step
MATMULS = {"wq": (1024, 1024), "wk": (1024, 256), "wv": (1024, 256),
           "wo": (1024, 1024), "w_gate": (1024, 4096), "w_up": (1024, 4096),
           "w_down": (4096, 1024), "lm_head": (1024, 32005)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time and eager call time of a function on the card.

    ``__call__``: ``fn`` is captured once into a CUDA graph, and the median
    of ``iters`` replays is taken, each between two CUDA events after an L2
    flush (64 MB written).  Before the start event the card spins for
    ~100 us, so the host has enqueued the replay before the card reaches
    the event: no host gap is timed.  That is the device time of the call's
    kernels, without the Python and launch overhead; a graph of one
    1-element fill gives the method's floor (phase 2's
    ``timer_floor_ms``).  With ``spin_cycles = 0`` the card does not spin
    and the host's enqueue of the replay is timed whenever it outlasts the
    flush (``tools/lut_gemv_times.py`` compares the two methods).  With
    ``flush_by_read`` the flush reads the 64 MB instead (a sum), so L2 is
    left holding clean lines: the written flush leaves ~50 MB of dirty
    lines that the timed call's misses must write back to device memory
    first (``tools/decode_attn_times.py`` compares the two).
    ``call_ms``: host wall time per call over back-to-back eager calls,
    what a caller pays per call including that overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
        self.spin_cycles = 200_000        # ~100 us at the H100's clocks
        self.flush_by_read = False

    def __call__(self, fn, iters: int = 30) -> float:
        return self.replay_ms(fn, iters, flush=True)

    def replay_ms(self, fn, iters: int = 10, flush: bool = False) -> float:
        """Median device time of a CUDA-graph replay of ``fn``, with an L2
        flush before each replay or none."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        times = []
        for _ in range(iters):
            if flush and self.flush_by_read:
                self.flush.sum()
            elif flush:
                self.flush.zero_()
            if self.spin_cycles:
                torch.cuda._sleep(self.spin_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times)

    def call_ms(self, fn, iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3


def timings(timer, kernel, plain, library) -> dict:
    return {"ms": timer(kernel), "plain_ms": timer(plain),
            "library_ms": timer(library), "call_ms": timer.call_ms(kernel)}


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_rate(torch) -> dict:
    """The card's 32-bit integer instruction rate and where its three
    factors come from."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return {"ops_per_s": INT_OPS_PER_SM_CLOCK * sms * mhz * 1e6,
            "per_sm_clock": INT_OPS_PER_SM_CLOCK, "sms": sms,
            "max_sm_mhz": mhz,
            "from": "64 / SM / clock (CUDA programming guide, Hopper) x "
                    "torch.cuda.get_device_properties(0)."
                    "multi_processor_count x nvidia-smi clocks.max.sm"}


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------

SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# opcodes that would convert without Algorithm 1: int->float, find leading
# one, population count, bit reverse (and their uniform-datapath forms)
TYPECONV_BANNED = ("I2F", "FLO", "POPC", "BREV")


def sass_listing(path) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(text: str) -> dict:
    """Each function of a ``cuobjdump -sass`` listing: its instructions as
    (address, opcode, operands), branch labels resolved to addresses."""
    funcs, insns, labels, pending = {}, None, None, []
    for line in text.splitlines():
        if "Function : " in line:
            insns, labels, pending = [], {}, []
            funcs[line.split("Function : ")[1].strip()] = (insns, labels)
            continue
        if insns is None:
            continue
        m = SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = SASS_INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    out = {}
    for name, (insns, labels) in funcs.items():
        resolved = []
        for addr, op, rest in insns:
            target = None
            if op.split(".")[0] == "BRA":
                lab = re.search(r"\((\.L_x_\d+)\)", rest)
                hexa = re.search(r"0x([0-9a-f]+)", rest.split(";")[0])
                target = labels.get(lab.group(1)) if lab else \
                    int(hexa.group(1), 16) if hexa else None
            resolved.append((addr, op, target))
        out[name] = resolved
    return out


def banned_counts(insns) -> dict:
    """How many instructions of each TYPECONV_BANNED kind (I2F also counts
    I2FP; U-prefixed uniform-datapath forms count with their kind)."""
    counts = dict.fromkeys(TYPECONV_BANNED, 0)
    for _, op, _ in insns:
        base = op.split(".")[0]
        base = base[1:] if base.startswith("U") else base
        for kind in TYPECONV_BANNED:
            if base == kind or (kind == "I2F" and base.startswith("I2F")):
                counts[kind] += 1
    return counts


def vector_loop(insns):
    """The loop (a backward branch's address range) with the most 16-byte
    loads: (its instructions but NOPs, the elements its int4 loads bring),
    or None."""
    best_loads, best = 0, None
    for addr, op, target in insns:
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in insns if target <= a <= addr and o != "NOP"]
        loads = sum(o.startswith("LDG") and ".128" in o for o in body)
        if loads > best_loads:
            best_loads, best = loads, (body, 4 * loads)
    return best


def typeconv_sass(text: str) -> dict:
    """typeconv's SASS: the banned opcodes over the whole library, and for
    each n's kernel instance the integer instructions per element of its
    vector loop (every instruction of the loop body, loads, stores and
    branch included, over the elements one iteration converts)."""
    funcs = sass_functions(text)
    every = [i for insns in funcs.values() for i in insns]
    res = {"banned": banned_counts(every), "ops_per_elem": {},
           "loop_opcodes": {}}
    for name, insns in funcs.items():
        m = re.search(r"int_to_f32_kernelILi(\d+)E", name)
        loop = vector_loop(insns) if m else None
        if loop:
            n = int(m.group(1))
            body, elems = loop
            res["ops_per_elem"][n] = len(body) / elems
            res["loop_opcodes"][n] = dict(collections.Counter(
                o.split(".")[0] for o in body).most_common())
    return res


# decode attention at tinymistral's widths: the engine's 8 lanes, 32 query
# heads over 8 kv heads of width 32, int8 K/V, the model's window
ATTN_B, ATTN_KV, ATTN_G, ATTN_D, ATTN_WINDOW = 8, 8, 4, 32, 4096


def attn_inputs(torch, gen, s):
    """Random q and K/V of ``s`` slots at tinymistral's widths: f32 and int8
    with scales."""
    b, kvh, g, d = ATTN_B, ATTN_KV, ATTN_G, ATTN_D
    from repro_torch.core.quant import quantize_kv
    x = {"q": torch.randn((b, kvh * g, d), device="cuda", generator=gen),
         "kf": torch.randn((b, s, kvh, d), device="cuda", generator=gen),
         "vf": torch.randn((b, s, kvh, d), device="cuda", generator=gen)}
    x["kq"], x["ksc"] = quantize_kv(x["kf"])
    x["vq"], x["vsc"] = quantize_kv(x["vf"])
    return x


def attention_row(torch, timer, x, position, kernel) -> dict:
    """The main path's call, ``kernel`` (a decode_attention_cuda) in ring
    mode on int8 K/V at ``position``, timed beside its plain version and SDPA
    on the dequantized K/V (the library call; the dequantization is not
    timed).  The bound counts what this call needs: q, the output, the
    positions, and the K and V rows and scales of the valid slots only."""
    from repro_torch.kernels.decode_attn.ref import \
        decode_attention_ring_ref, ring_valid
    q, kq, vq, ksc, vsc = (x[n] for n in ("q", "kq", "vq", "ksc", "vsc"))
    b, s, kvh, d = kq.shape
    h = q.shape[1]
    valid = ring_valid(position, s, ATTN_WINDOW)
    slots = int(valid.sum())
    kdq = (kq.float() * ksc).transpose(1, 2).contiguous()   # [B, KV, S, D]
    vdq = (vq.float() * vsc).transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    nbytes = 2 * 4 * q.numel() + 4 * b + slots * kvh * (2 * d + 2 * 4)
    bound, by = bound_ms(nbytes, 4 * slots * h * d)
    row = timings(
        timer,
        lambda: kernel(q, kq, vq, position, ksc, vsc, ATTN_WINDOW, ring=True),
        lambda: decode_attention_ring_ref(q, kq, vq, position, ATTN_WINDOW,
                                          ksc, vsc),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kdq, vdq, attn_mask=mask, enable_gqa=True))
    row.update(s=s, valid_slots=slots, bound_ms=bound, bound_by=by,
               bound_share=bound / row["ms"])
    return row


def paged_inputs(torch, gen, b, kv, g, d, s, bs, quantized, position=None):
    """q and a block pool of int8 (with scales) or f32 K/V holding ``b``
    lanes of mbs = ceil(S / BS) blocks each, shuffled among twice as many
    blocks (gaps between a lane's blocks) plus a trash block (the last);
    int32 tables [B, mbs], the last lane's entries all trash.  Positions
    never wrap (paged lanes): ``position`` for every lane but the last, or
    0, one block, the lane's last slot and spread ones; the trash lane
    sits at a frozen 5."""
    from repro_torch.core.quant import quantize_kv
    mbs = -(-s // bs)
    nb = 2 * b * mbs
    shape = (nb + 1, bs, kv, d)
    x = {"q": torch.randn((b, kv * g, d), device="cuda", generator=gen),
         "k": torch.randn(shape, device="cuda", generator=gen),
         "v": torch.randn(shape, device="cuda", generator=gen),
         "ks": None, "vs": None}
    if quantized:
        x["k"], x["ks"] = quantize_kv(x["k"])
        x["v"], x["vs"] = quantize_kv(x["v"])
    perm = torch.randperm(nb, device="cuda", generator=gen)
    tables = perm[:b * mbs].reshape(b, mbs).to(torch.int32).contiguous()
    tables[-1] = nb
    if position is None:
        pos = [0, bs, mbs * bs - 1] + [97 * i % (mbs * bs)
                                       for i in range(3, b)]
    else:
        pos = [position] * b
    x["tables"] = tables
    x["pos"] = torch.tensor(pos[:b - 1] + [5], dtype=torch.int32,
                            device="cuda")
    return x


def table_row(torch, timer, x, kernel) -> dict:
    """Table mode at ``x`` (``paged_inputs``) timed beside ring mode on the
    same rows laid out contiguously (the gap is the price of the
    indirection), the plain version (the reference's gather, then ring
    attention) and SDPA on the gathered, dequantized K/V (the library call;
    neither the gather nor the dequantization is timed).  The bound counts
    what the call needs: q, the output, the positions, the tables, and the
    K and V rows and scales of the valid slots only."""
    from repro_torch.kernels.decode_attn.ref import decode_attention_paged_ref, \
        gather_blocks, ring_valid
    q, k, v, ks, vs, tables, pos = (x[n] for n in ("q", "k", "v", "ks", "vs",
                                                   "tables", "pos"))
    b, h, d = q.shape
    bs, kvh = k.shape[1], k.shape[2]
    s = tables.shape[1] * bs
    gather = lambda a: gather_blocks(a, tables)
    kc, vc, ksc, vsc = gather(k), gather(v), gather(ks), gather(vs)
    valid = ring_valid(pos, s, ATTN_WINDOW)
    slots = int(valid.sum())
    kdq = (kc.float() * ksc).transpose(1, 2).contiguous()
    vdq = (vc.float() * vsc).transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    nbytes = (2 * 4 * q.numel() + 4 * b + 4 * tables.numel()
              + slots * kvh * (2 * d + 2 * 4))
    bound, by = bound_ms(nbytes, 4 * slots * h * d)
    row = timings(
        timer,
        lambda: kernel(q, k, v, pos, ks, vs, ATTN_WINDOW, ring=True,
                       tables=tables),
        lambda: decode_attention_paged_ref(q, k, v, pos, tables, ATTN_WINDOW,
                                           ks, vs),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kdq, vdq, attn_mask=mask, enable_gqa=True))
    row["ring_ms"] = timer(lambda: kernel(q, kc, vc, pos, ksc, vsc,
                                          ATTN_WINDOW, ring=True))
    row.update(s=s, block_size=bs, valid_slots=slots, bound_ms=bound,
               bound_by=by, bound_share=bound / row["ms"],
               indirection=row["ms"] / row["ring_ms"] - 1)
    return row


# typeconv: bit-equality cases (shape, element offset of the view) for
# every n, and the timed cases (shape, n)
TC_CHECKS = (((64, 4096), 0), ((777,), 0), ((64 * 4096 - 1,), 1),
             (((1 << 23) + 5,), 3))
TC_CASES = (((64, 4096), 8), ((4096, 4096), 8), ((4096, 4096), 16),
            ((4096, 4096), 25))


def typeconv_input(torch, gen, n, shape, offset=0):
    """Random n-bit ints (|a| < 2**(n-1)) of ``shape``, a view at element
    ``offset`` of a fresh card buffer, with 0 and +-(2**(n-1) - 1) at both
    ends."""
    lim = 1 << (n - 1)
    buf = torch.randint(-lim + 1, lim, (offset + math.prod(shape),),
                        device="cuda", generator=gen, dtype=torch.int32)
    a = buf[offset:]
    ends = torch.tensor([0, lim - 1, -(lim - 1)], dtype=torch.int32,
                        device="cuda")
    a[:3], a[-3:] = ends, ends
    return a.view(shape)


def typeconv_row(torch, timer, a, n, kernel, ops_per_elem, int_ops_per_s):
    """``kernel(a, n)`` timed beside the plain version and ``.float()``,
    with two bounds: the bytes (4 read and 4 written per element) at the
    memory rate, and ``ops_per_elem`` integer instructions per element (the
    count in this tree's SASS for n) at the card's integer rate."""
    from repro_torch.core.typeconv import logic_ops
    from repro_torch.kernels.typeconv.ref import int_to_f32_plain
    row = timings(timer, lambda: kernel(a, n), lambda: int_to_f32_plain(a, n),
                  lambda: a.float())
    t_bytes = bound_ms(8 * a.numel(), 0)[0]
    t_ops = bound_ms(0, ops_per_elem * a.numel(), int_ops_per_s)[0]
    row["bound_ms"], row["bound_by"] = bound_ms(
        8 * a.numel(), ops_per_elem * a.numel(), int_ops_per_s)
    row.update(shape=list(a.shape), n=n, int_ops_per_elem=ops_per_elem,
               paper_ops_per_elem=logic_ops(n), bytes_bound_ms=t_bytes,
               int_ops_bound_ms=t_ops, bytes_share=t_bytes / row["ms"],
               int_ops_share=t_ops / row["ms"],
               bound_share=row["bound_ms"] / row["ms"])
    return row


def typeconv_text(row) -> str:
    return (f"{row['shape']} n={row['n']}: {1e3 * row['ms']:.2f} us (.float()"
            f" {1e3 * row['library_ms']:.2f}, plain {1e3 * row['plain_ms']:.2f}"
            f", eager call {1e3 * row['call_ms']:.2f} us); bytes bound "
            f"{1e3 * row['bytes_bound_ms']:.2f} us ({100 * row['bytes_share']:.1f}"
            f"% of it), integer bound {1e3 * row['int_ops_bound_ms']:.2f} us at "
            f"{row['int_ops_per_elem']:.3f} ops per element (paper "
            f"{row['paper_ops_per_elem']:.1f}; {100 * row['int_ops_share']:.1f}"
            f"% of it)")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(rt):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for name, text in logs.items():
            f.write(f"==== {name}\n{text}\n")
    regs = [int(line.split("Used ")[1].split()[0])
            for text in logs.values() for line in text.splitlines()
            if "Used " in line and "registers" in line]
    spills = [line.strip() for text in logs.values()
              for line in text.splitlines()
              if "spill" in line and not line.strip().endswith(
                  "0 bytes spill stores, 0 bytes spill loads")]
    log(f"[build] nvcc built {sorted(logs) or 'nothing (cached)'} in "
        f"{secs:.1f} s; max registers/thread {max(regs) if regs else 'n/a'}; "
        f"spilling kernels: {len(spills)}")
    listings = {}
    for name in ("lut_gemv", "typeconv", "decode_attn"):
        listings[name] = sass_listing(_build.library_path(name))
        if "Function" not in listings[name]:
            fail(f"cuobjdump printed no SASS for {name}")
        n_i2f = listings[name].count("I2F")
        log(f"[build] {name}: {n_i2f} I2F instructions in the SASS")
        if n_i2f:
            fail(f"{name} converts int->float with I2F; codes must be "
                 "widened with integer and float bit operations only")
    with open(os.path.join(OUT_DIR, "typeconv.sass"), "w") as f:
        f.write(listings["typeconv"])
    tc = typeconv_sass(listings["typeconv"])
    log("[build] typeconv SASS: " + ", ".join(
        f"{n} {kind}" for kind, n in tc["banned"].items()) + " instructions")
    if any(tc["banned"].values()):
        fail("typeconv's SASS converts without Algorithm 1: "
             f"{tc['banned']}")
    if sorted(tc["ops_per_elem"]) != list(range(2, 26)):
        fail("no vector loop found in the SASS of typeconv's instances for "
             f"n = {sorted(set(range(2, 26)) - set(tc['ops_per_elem']))}")
    log("[build] typeconv integer instructions per element (vector loop "
        "body / elements per iteration), n = 2..25: " + ", ".join(
            f"{tc['ops_per_elem'][n]:.3f}" for n in range(2, 26))
        + f"; n = 8 loop body {tc['loop_opcodes'][8]}")
    import torch
    rate = int_rate(torch)
    log(f"[build] 32-bit integer rate {rate['ops_per_s']:.4e} ops/s = "
        f"{rate['per_sm_clock']} / SM / clock x {rate['sms']} SMs x "
        f"{rate['max_sm_mhz']:.0f} MHz ({rate['from']})")
    rt["typeconv_sass"], rt["int_rate"] = tc, rate
    rt["build_s"] = secs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def rand_qtensor(torch, gen, k, n, bits, group, integer):
    from repro_torch.core.quant import QTensor, _uniform_codebook, \
        words_per_group
    rows = (k // group) * words_per_group(bits, group)
    packed = torch.randint(-2**31, 2**31, (rows, n), dtype=torch.int64,
                           device="cuda", generator=gen).to(torch.int32)
    if integer:
        scales = torch.ones((k // group, n), device="cuda")
        codebook = (torch.arange(1 << bits, dtype=torch.float32,
                                 device="cuda") - (1 << (bits - 1)))
    else:
        scales = 0.02 + 0.06 * torch.rand((k // group, n), device="cuda",
                                          generator=gen)
        codebook = _uniform_codebook(bits, device="cuda")
    return QTensor(packed=packed, scales=scales, codebook=codebook,
                   bits=bits, group_size=group, k=k)


def phase_kernels(rt):
    import torch
    from repro_torch.core.quant import dequantize, quantize_activations
    from repro_torch.kernels.decode_attn.kernel import card_plan, \
        decode_attention_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref, \
        decode_attention_ring_ref
    from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda, \
        lut_matmul_int_cuda, plan
    from repro_torch.kernels.lut_gemv.ref import lut_matmul_ref, \
        lut_matmul_ref_int
    from repro_torch.kernels.typeconv.kernel import int_to_f32_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    group = 128

    # --- LUT-GEMV: correctness grid --------------------------------------
    # f32 path and int path on quantized data (real codebook and scales,
    # activations quantized from f32 as the model does) within rtol/atol;
    # int path on integer-valued data bit-equal
    errs = {"lut_matmul": 0.0, "lut_matmul_int": 0.0}
    int_real_err = 0.0

    def within(name, y, ref):
        err = (y - ref).abs()
        if not bool((err <= LUT_ATOL + LUT_RTOL * ref.abs()).all()):
            fail(f"{name}: max err {err.max().item():.3e}")
        return err.max().item()

    shapes = sorted(set(MATMULS.values()))
    for m in (8, 64):
        for k, n in shapes:
            for bits in (2, 3, 4, 8):
                case = f"m={m} k={k} n={n} b={bits}"
                qt = rand_qtensor(torch, gen, k, n, bits, group, False)
                x = torch.randn((m, k), device="cuda", generator=gen)
                errs["lut_matmul"] = max(errs["lut_matmul"], within(
                    f"lut_matmul {case}", lut_matmul_cuda(x, qt),
                    lut_matmul_ref(x, qt)))
                qi = rand_qtensor(torch, gen, k, n, bits, group, True)
                for abits in (4, 8):
                    xq, xs = quantize_activations(x, abits)
                    int_real_err = max(int_real_err, within(
                        f"lut_matmul_int {case} a={abits} (quantized data)",
                        lut_matmul_int_cuda(xq, xs, qt, abits),
                        lut_matmul_ref_int(xq, xs, qt)))
                    qmax = (1 << (abits - 1)) - 1
                    xq = torch.randint(-qmax, qmax + 1, (m, k), device="cuda",
                                       generator=gen, dtype=torch.int32)
                    xs = 0.01 + torch.rand((m, 1), device="cuda",
                                           generator=gen)
                    yi = lut_matmul_int_cuda(xq, xs, qi, abits)
                    refi = lut_matmul_ref_int(xq, xs, qi)
                    err = (yi - refi).abs().max().item()
                    if not torch.equal(yi, refi):
                        fail(f"lut_matmul_int {case} a={abits}: not "
                             f"bit-equal, max err {err:.3e}")
                    errs["lut_matmul_int"] = max(errs["lut_matmul_int"], err)
    torch.cuda.synchronize()
    log(f"[kernels] lut_matmul: 40 cases within rtol {LUT_RTOL} / atol "
        f"{LUT_ATOL} (max abs err {errs['lut_matmul']:.3e}); lut_matmul_int:"
        f" 80 cases on quantized data within the same (max abs err "
        f"{int_real_err:.3e}), 80 cases on integer data bit-equal (max abs "
        f"err {errs['lut_matmul_int']:.3e})")

    # --- LUT-GEMV: the launch plan and determinism at the decode shapes --
    plans = {(m, k, n): plan(m, k, n, group, 4)
             for m in (8, 64) for k, n in shapes}
    log("[kernels] LUT-GEMV launch plan (b=4, G=128; splits x tiles = "
        "blocks): " + "; ".join(
            f"M={m} ({k}, {n}) {p.splits}x{p.tiles}={p.blocks}"
            for (m, k, n), p in plans.items()))
    for k, n in shapes:
        qt = rand_qtensor(torch, gen, k, n, 4, group, False)
        x = torch.randn((8, k), device="cuda", generator=gen)
        xq, xs = quantize_activations(x, 8)
        for name, fn in (("lut_matmul", lambda: lut_matmul_cuda(x, qt)),
                         ("lut_matmul_int",
                          lambda: lut_matmul_int_cuda(xq, xs, qt, 8))):
            if not torch.equal(fn(), fn()):
                fail(f"{name} M=8 ({k}, {n}): two calls on the same inputs "
                     "differ")
    log(f"[kernels] lut_matmul and lut_matmul_int: two calls bit-identical "
        f"at all {len(shapes)} decode shapes (M=8, b=4)")

    # --- LUT-GEMV: timing per shape at M = 8 (decode) and 64 (prefill) ---
    lut_rows = {"lut_matmul": [], "lut_matmul_int": []}
    for m in (8, 64):
        for k, n in shapes:
            qt = rand_qtensor(torch, gen, k, n, 4, group, False)
            wd = dequantize(qt)
            x = torch.randn((m, k), device="cuda", generator=gen)
            xq, xs = quantize_activations(x, 8)
            xqf = xq.float()
            qbytes = 4 * (qt.packed.numel() + qt.scales.numel()
                          + qt.codebook.numel())
            p = plans[m, k, n]
            common = dict(m=m, k=k, n=n, splits=p.splits, blocks=p.blocks,
                          ops=2 * m * k * n)
            lut_rows["lut_matmul"].append(dict(
                **common, **timings(timer, lambda: lut_matmul_cuda(x, qt),
                                    lambda: lut_matmul_ref(x, qt),
                                    lambda: torch.matmul(x, wd)),
                nbytes=qbytes + 4 * m * k + 4 * m * n))
            lut_rows["lut_matmul_int"].append(dict(
                **common, **timings(
                    timer, lambda: lut_matmul_int_cuda(xq, xs, qt, 8),
                    lambda: lut_matmul_ref_int(xq, xs, qt),
                    lambda: torch.matmul(xqf, wd)),
                nbytes=qbytes + 4 * m * k + 4 * m + 4 * m * n))

    # --- LUT-GEMV: a decode step's 85 calls as one CUDA graph --------------
    # each layer's 7 matmuls on their own weights and lm_head, in the decode
    # step's order, replayed with no flush between calls: the device time a
    # decode step spends in the LUT-GEMV, launch gaps included
    layers = [{name: rand_qtensor(torch, gen, k, n, 4, group, False)
               for name, (k, n) in MATMULS.items() if name != "lm_head"}
              for _ in range(12)]
    head = rand_qtensor(torch, gen, *MATMULS["lm_head"], 4, group, False)
    xk = {k: torch.randn((8, k), device="cuda", generator=gen)
          for k in (1024, 4096)}
    xqk = {k: quantize_activations(v, 8) for k, v in xk.items()}
    step_calls = {
        "lut_matmul": lambda qt: lut_matmul_cuda(xk[qt.k], qt),
        "lut_matmul_int": lambda qt: lut_matmul_int_cuda(*xqk[qt.k], qt, 8)}
    step_graph = {}
    for name, call in step_calls.items():
        def step(call=call):
            for layer in layers:
                for qt in layer.values():
                    call(qt)
            call(head)
        step_graph[name] = timer.replay_ms(step)
    # the library's step: torch.matmul on every weight dequantized
    wds = [dequantize(qt) for layer in layers for qt in layer.values()]
    wds.append(dequantize(head))
    step_graph["library"] = timer.replay_ms(
        lambda: [torch.matmul(xk[w.shape[0]], w) for w in wds])
    floor = timer(lambda: timer.flush[:1].zero_())
    log(f"[kernels] LUT-GEMV decode step as one graph (85 calls, no flush): "
        f"lut_matmul {step_graph['lut_matmul']:.4f} ms, lut_matmul_int "
        f"{step_graph['lut_matmul_int']:.4f} ms, library (torch.matmul on "
        f"the dequantized weights) {step_graph['library']:.4f} ms; the "
        f"per-call timer's floor (a 1-element fill) {1e3 * floor:.2f} us")
    del layers, head, wds

    def per_step(rows):
        """Totals over one decode step's 85 calls (the M = 8 rows); the
        bound is that of the step's whole work (its bytes, or its f32
        operations).  Every row gets its own bound and share of it."""
        for r in rows:
            r["bound_ms"], r["bound_by"] = bound_ms(r["nbytes"], r["ops"])
            r["bound_share"] = r["bound_ms"] / r["ms"]
        by_shape = {(r["k"], r["n"]): r for r in rows if r["m"] == 8}
        calls = {}
        for name, kn in MATMULS.items():
            calls[kn] = calls.get(kn, 0) + (1 if name == "lm_head" else 12)
        tot = {key: sum(by_shape[kn][key] * c for kn, c in calls.items())
               for key in ("ms", "plain_ms", "library_ms", "call_ms", "nbytes",
                           "ops")}
        tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("nbytes"),
                                                    tot.pop("ops"))
        return tot

    # --- decode attention -------------------------------------------------
    b, s, kvh, g, d = ATTN_B, 512, ATTN_KV, ATTN_G, ATTN_D
    h = kvh * g
    attn_err = 0.0
    x = attn_inputs(torch, gen, s)
    q, kf, vf, kq, ksc, vq, vsc = (x[n] for n in ("q", "kf", "vf", "kq", "ksc",
                                                  "vq", "vsc"))
    lengths = torch.randint(1, s + 1, (b,), device="cuda", generator=gen,
                            dtype=torch.int32)
    # a ring that has wrapped: positions past S for most lanes
    position = torch.tensor([3, 300, 511, 512, 700, 1023, 1500, 2047],
                            dtype=torch.int32, device="cuda")
    for quant in (False, True):
        kk, vv = (kq, vq) if quant else (kf, vf)
        scs = (ksc, vsc) if quant else (None, None)
        for window in (None, 100):
            out = decode_attention_cuda(q, kk, vv, lengths, *scs, window,
                                        ring=False)
            ref = decode_attention_ref(q, kk, vv, lengths, *scs, window)
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL):
                fail(f"decode_attention lengths quant={quant} "
                     f"window={window}: max err {err:.3e}")
            attn_err = max(attn_err, err)
        for window in (4096, 300):
            out = decode_attention_cuda(q, kk, vv, position, *scs, window,
                                        ring=True)
            ref = decode_attention_ring_ref(q, kk, vv, position, window,
                                            *scs)
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL):
                fail(f"decode_attention ring quant={quant} window={window}:"
                     f" max err {err:.3e}")
            attn_err = max(attn_err, err)
    log(f"[kernels] decode_attention: 8 cases (lengths/ring x int8/f32 x 2 "
        f"windows) within {ATTN_TOL} (max abs err {attn_err:.3e})")
    main_call = lambda: decode_attention_cuda(q, kq, vq, position, ksc, vsc,
                                              ATTN_WINDOW, ring=True)
    if not torch.equal(main_call(), main_call()):
        fail("decode_attention: two calls on the same inputs differ")
    # timing: the main path's call (ring mode, int8 KV, model window) at the
    # wrapped positions above, at S = 4096 with every slot valid, and at
    # the engine's positions (prompts of 8-64 tokens plus up to 32 new)
    long = attn_inputs(torch, gen, 4096)
    cases = {"main": (x, position),
             "s4096": (long, torch.randint(4095, 3 * 4096, (b,),
                                           device="cuda", generator=gen,
                                           dtype=torch.int32)),
             "engine": (x, torch.randint(40, 100, (b,), device="cuda",
                                         generator=gen, dtype=torch.int32))}
    attn_rows = {}
    for name, (xx, pos) in cases.items():
        ss = xx["kq"].shape[1]
        p = card_plan(b, h, kvh, d, ss, ATTN_WINDOW, True, True, q.device)
        row = attention_row(torch, timer, xx, pos, decode_attention_cuda)
        row.update(case=name, splits=p.splits, blocks=p.blocks,
                   cluster=p.splits, lanes_per_row=p.lanes,
                   rows_per_stage=p.tw, smem=p.smem)
        attn_rows[name] = row
        log(f"[kernels] decode_attention {name}: S={ss}, {row['valid_slots']}"
            f" valid slots; plan {p.splits} splits (cluster of {p.splits}) x "
            f"{b * kvh} (b, kv) = {p.blocks} blocks, {p.lanes} lanes/row, "
            f"{p.tw} rows/stage, {p.smem} B shared; {1e3 * row['ms']:.2f} "
            f"us (plain {1e3 * row['plain_ms']:.2f}, SDPA "
            f"{1e3 * row['library_ms']:.2f}, bound {1e3 * row['bound_ms']:.3f}"
            f" us by {row['bound_by']}, {100 * row['bound_share']:.1f}% of "
            f"it)")
    del long

    # --- decode attention, table mode ------------------------------------
    # against its plain version at ATTN_TOL and bit-equal to ring mode on
    # the same rows laid out contiguously (one plan, one row order: only
    # row_of differs), over D x G x S x BS x K/V type x window, with
    # shuffled tables with gaps and a lane all trash
    from repro_torch.kernels.decode_attn.ref import decode_attention_paged_ref, \
        gather_blocks
    table_err, table_cases = 0.0, 0
    for d_ in (32, 128):
        for g_ in (1, 4):
            for s_ in (512, 4096):
                for bs in (8, 12, 16):
                    for quant in (False, True):
                        pg = paged_inputs(torch, gen, 4, 2, g_, d_, s_, bs,
                                          quant)
                        args_ = (pg["q"], pg["k"], pg["v"], pg["pos"])
                        scs = (pg["ks"], pg["vs"])
                        gat = lambda a: None if a is None else \
                            gather_blocks(a, pg["tables"])
                        for window in (4096, 300):
                            case = (f"D={d_} G={g_} S={s_} BS={bs} "
                                    f"quant={quant} window={window}")
                            out = decode_attention_cuda(
                                *args_, *scs, window, ring=True,
                                tables=pg["tables"])
                            ref = decode_attention_paged_ref(
                                *args_, pg["tables"], window, *scs)
                            err = (out - ref).abs().max().item()
                            if not torch.allclose(out, ref, rtol=ATTN_TOL,
                                                  atol=ATTN_TOL):
                                fail(f"decode_attention table {case}: max "
                                     f"err {err:.3e}")
                            ring = decode_attention_cuda(
                                pg["q"], gat(pg["k"]), gat(pg["v"]),
                                pg["pos"], gat(pg["ks"]), gat(pg["vs"]),
                                window, ring=True)
                            if not torch.equal(out, ring):
                                fail(f"decode_attention table {case}: not "
                                     "bit-equal to ring mode on the same "
                                     "rows")
                            table_err = max(table_err, err)
                            table_cases += 1
    log(f"[kernels] decode_attention table mode: {table_cases} cases (D "
        f"32/128 x G 1/4 x S 512/4096 x BS 8/12/16 x int8/f32 x window "
        f"4096/300, shuffled tables with gaps, a lane all trash) within "
        f"{ATTN_TOL} of the plain version (max abs err {table_err:.3e}) and "
        f"bit-equal to ring mode on the same rows")
    attn_err = max(attn_err, table_err)
    # timing at the engine's shape (B 8, KV 8, G 4, D 32, int8, BS 16) with
    # every slot of 7 lanes valid (the 8th lane's table all trash), at S 512
    # and 4096
    for name, s_ in (("table_s512", 512), ("table_s4096", 4096)):
        pg = paged_inputs(torch, gen, b, kvh, g, d, s_, 16, True, s_ - 1)
        p = card_plan(b, h, kvh, d, s_, ATTN_WINDOW, True, True, q.device)
        row = table_row(torch, timer, pg, decode_attention_cuda)
        row.update(case=name, splits=p.splits, blocks=p.blocks)
        attn_rows[name] = row
        log(f"[kernels] decode_attention {name}: S={s_}, BS 16, "
            f"{row['valid_slots']} valid slots, plan {p.splits} splits x "
            f"{b * kvh} (b, kv) = {p.blocks} blocks; table mode "
            f"{1e3 * row['ms']:.2f} us, ring mode on the same rows "
            f"{1e3 * row['ring_ms']:.2f} us ({100 * row['indirection']:+.1f}"
            f"% for the indirection); plain {1e3 * row['plain_ms']:.2f}, "
            f"SDPA {1e3 * row['library_ms']:.2f}, bound "
            f"{1e3 * row['bound_ms']:.3f} us by {row['bound_by']} "
            f"({100 * row['bound_share']:.1f}% of it)")
        del pg
    attn_row = dict(attn_rows["main"],
                    rows=[attn_rows[n] for n in ("s4096", "engine",
                                                 "table_s512",
                                                 "table_s4096")])

    # --- typeconv ---------------------------------------------------------
    tc_err, tc_cases = 0.0, 0
    for n_bits in range(2, 26):
        for shape, offset in TC_CHECKS:
            a = typeconv_input(torch, gen, n_bits, shape, offset)
            out, ref = int_to_f32_cuda(a, n_bits), a.float()
            tc_err = max(tc_err, (out - ref).abs().max().item())
            if not torch.equal(out, ref):
                fail(f"int_to_f32 n={n_bits} {list(shape)} at offset "
                     f"{offset}: not bit-equal to .float(), max err "
                     f"{tc_err:.3e}")
            tc_cases += 1
    log(f"[kernels] int_to_f32: {tc_cases} cases bit-equal to .float() "
        f"(n = 2..25 x (shape, element offset) {list(TC_CHECKS)}, 0 and "
        f"+-(2**(n-1) - 1) at both ends; max abs err {tc_err:.3e})")
    ops, rate = rt["typeconv_sass"]["ops_per_elem"], rt["int_rate"]
    tc_rows = []
    for shape, n_bits in TC_CASES:
        a = typeconv_input(torch, gen, n_bits, shape)
        tc_rows.append(typeconv_row(torch, timer, a, n_bits, int_to_f32_cuda,
                                    ops[n_bits], rate["ops_per_s"]))
        log(f"[kernels] int_to_f32 {typeconv_text(tc_rows[-1])}")
        del a
    tc_row = dict(tc_rows[0], rows=tc_rows[1:], int_rate=rate)

    rt["kernels"] = {
        "lut_matmul": dict(per_step(lut_rows["lut_matmul"]),
                           max_abs_err=errs["lut_matmul"],
                           step_graph_ms=step_graph["lut_matmul"],
                           library_step_graph_ms=step_graph["library"],
                           timer_floor_ms=floor,
                           shapes=lut_rows["lut_matmul"]),
        "lut_matmul_int": dict(per_step(lut_rows["lut_matmul_int"]),
                               max_abs_err=max(errs["lut_matmul_int"],
                                               int_real_err),
                               step_graph_ms=step_graph["lut_matmul_int"],
                               library_step_graph_ms=step_graph["library"],
                               timer_floor_ms=floor,
                               shapes=lut_rows["lut_matmul_int"]),
        "decode_attention": dict(attn_row, max_abs_err=attn_err),
        "int_to_f32": dict(tc_row, max_abs_err=tc_err),
    }
    for name, row in rt["kernels"].items():
        log(f"[kernels] {name}: device {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']}); eager call "
            f"{row['call_ms']:.4f} ms")
        for r in row.get("shapes", []):
            log(f"[kernels]   M={r['m']} ({r['k']}, {r['n']}) splits "
                f"{r['splits']}: {1e3 * r['ms']:.2f} us, library "
                f"{1e3 * r['library_ms']:.2f} us, bound "
                f"{1e3 * r['bound_ms']:.2f} us ({100 * r['bound_share']:.1f}%"
                f" of it)")


# ---------------------------------------------------------------------------
# phase 3: full-width model, card vs CPU
# ---------------------------------------------------------------------------

def full_model(rt):
    import torch
    import repro_torch.configs as C
    from repro_torch.models import lm
    if "raw" not in rt:
        cfg = C.get_config("tinymistral_248m")
        gen = torch.Generator(device="cuda").manual_seed(0)
        rt["cfg"] = cfg
        rt["raw"] = lm.init_params(cfg, gen, device="cuda")
    return rt["cfg"], rt["raw"]


def run_greedy(torch, lm, params, cfg, toks, lengths, steps, device,
               quant_kv=True):
    logits, cache = lm.prefill(params, toks, cfg, 512, quant_kv, lengths,
                               device=device)
    out_logits, out_toks = [logits.float().cpu()], []
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1)
        out_toks.append(tok.cpu())
        logits, cache = lm.decode_step(params, tok[:, None], cache, cfg,
                                       quant_kv, device=device)
        out_logits.append(logits.float().cpu())
    out_toks.append(torch.argmax(logits, dim=-1).cpu())
    return torch.stack(out_logits), torch.stack(out_toks)


def model_prompts(cfg):
    """Phase 3's two right-padded prompts (40 and 27 tokens of 48)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = np.array([40, 27], np.int32)
    toks = np.zeros((2, 48), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, cfg.vocab, size=n)
    return toks, lengths


def phase_model(rt):
    import torch
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
        quantize_params
    cfg, raw = full_model(rt)
    toks, lengths = model_prompts(cfg)
    rt["model_err"] = {}
    for plan, act_bits in (("uniform:4", None), ("uniform:4a8", 8)):
        params, b0, b1 = quantize_params(raw, QuantPolicy(
            bits=4, group_size=128, min_size=1024, act_bits=act_bits))
        t0 = time.perf_counter()
        if act_bits is None:
            gl, gt = run_greedy(torch, lm, params, cfg, toks, lengths, 4,
                                "cuda")
        else:
            with Held(torch, plan) as held:
                gl, gt = run_greedy(torch, lm, params, cfg, toks, lengths, 4,
                                    "cuda")
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        cpu_params = map_tensors(params, lambda t: t.cpu())
        t0 = time.perf_counter()
        cl, ct = run_greedy(torch, lm, cpu_params, cfg, toks, lengths, 4,
                            "cpu")
        t_cpu = time.perf_counter() - t0
        if act_bits is not None:
            pl = run_perturbed(torch, lm, cpu_params, cfg, toks, lengths)
            noise_err = (pl - cl).abs().max().item()
        del params, cpu_params
        err = (gl - cl).abs().max().item()
        log(f"[model] tinymistral_248m full width, {plan} ({b0 / b1:.2f}x "
            f"smaller weights), int8 KV: prefill [2, 48] + 4 decode steps; "
            f"card {t_gpu:.2f} s, CPU {t_cpu:.2f} s; logits max abs err "
            f"{err:.3e} (max |logit| {cl.abs().max().item():.2f}); greedy "
            f"tokens card {gt.T.tolist()} CPU {ct.T.tolist()}")
        if (tuple(gl.shape) != (5, 2, cfg.vocab)
                or not torch.isfinite(gl).all()):
            fail(f"{plan}: card logits of shape {tuple(gl.shape)}, or not "
                 "finite")
        rt["model_err"][plan] = err
        if act_bits is not None:
            # int8 activation rounding turns f32 rounding differences into
            # logit differences as large as the card's (the CPU against
            # itself with f32-rounding-sized noise shows how large), so the
            # card is held to its plain version launch by launch, on the
            # card's own inputs, instead of end to end
            # prefill and 4 decode steps, 85 weight matmuls each
            calls = sum(held.calls.values())
            if calls < 5 * ((len(MATMULS) - 1) * cfg.n_layers + 1):
                fail(f"{plan}: only {calls} int LUT-GEMV launches")
            log(f"[model] {plan}: all {calls} int LUT-GEMV launches "
                f"within rtol {LUT_RTOL} / atol {LUT_ATOL} of their plain "
                f"version on the same inputs (max abs err "
                f"{held.err['int']:.3e}); card vs CPU not compared end to end: "
                f"the CPU against itself with activations scaled by 1 + "
                f"1e-7 N(0, 1) before each quantization differs by "
                f"{noise_err:.3e}")
            rt["model_err"][plan + " per launch"] = held.err["int"]
            rt["model_err"][plan + " CPU vs CPU with noise"] = noise_err
            continue
        if not torch.allclose(gl, cl, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"{plan}: card and CPU logits differ by {err:.3e}")
        if not torch.equal(gt, ct):
            fail(f"{plan}: greedy tokens differ")
        log(f"[model] {plan}: logits within rtol {MODEL_RTOL} / atol "
            f"{MODEL_ATOL}, greedy tokens identical on card and CPU")


def run_perturbed(torch, lm, params, cfg, toks, lengths):
    """The logits of ``run_greedy`` on the CPU with every activation scaled
    by 1 + 1e-7 N(0, 1) before its int8 quantization: noise of the size of
    f32 rounding, which is all that separates the card's inputs from the
    CPU's."""
    from repro_torch.kernels.lut_gemv import ops
    quantize = ops.quantize_activations
    gen = torch.Generator().manual_seed(1)

    def noisy(x, bits):
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype)
        return quantize(x * (1 + 1e-7 * noise), bits)

    ops.quantize_activations = noisy
    try:
        return run_greedy(torch, lm, params, cfg, toks, lengths, 4, "cpu")[0]
    finally:
        ops.quantize_activations = quantize


# ---------------------------------------------------------------------------
# phase 4: the engine, through the kernels
# ---------------------------------------------------------------------------

def phase_engine(rt):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn.ops import decode_attention_ring
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    rt["engine"] = {}
    for plan, lut, other in (("uniform:4", "lut_matmul", "lut_matmul_int"),
                             ("uniform:4a8", "lut_matmul_int", "lut_matmul")):
        eng = Engine(raw, cfg, EngineConfig(
            batch_size=8, cache_len=512, quant_kv=True, plan=plan,
            group_size=128), device="cuda")
        for prompt in engine_requests(cfg):
            eng.submit(prompt, max_new_tokens=32)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(_build.launches)
        st = eng.stats()
        toks = [c.tokens for c in done]
        rt.setdefault("ring_tokens", {})[plan] = {c.uid: c.tokens
                                                  for c in done}
        if len(done) != 16 or any(len(t) != 32 for t in toks):
            fail(f"{plan}: expected 16 completions of 32 tokens")
        if any(not 0 <= tok < cfg.vocab for t in toks for tok in t):
            fail(f"{plan}: token id out of range")
        # every decode step: each layer's 7 weight matmuls and lm_head
        # through the plan's LUT-GEMV, each layer's attention through the
        # decode-attention kernel, and nothing through the other LUT-GEMV
        need_lut = st["decode_iterations"] * (
            (len(MATMULS) - 1) * cfg.n_layers + 1)
        need_attn = st["decode_iterations"] * cfg.n_layers
        log(f"[engine] {plan}: {st['requests']} requests, "
            f"{st['generated_tokens']} tokens in {dt:.3f} s = "
            f"{st['generated_tokens'] / dt:.1f} tok/s; decode "
            f"{st['measured_tps']:.1f} tok/s over {st['decode_iterations']} "
            f"steps; mean latency {st['mean_latency_s']:.3f} s, p99 "
            f"{st['p99_latency_s']:.3f} s, mean TTFT {st['mean_ttft_s']:.3f}"
            f" s; launches {counts}")
        if (counts[lut] < need_lut or counts["decode_attention"] < need_attn
                or counts[other]):
            fail(f"{plan}: {lut} launched {counts[lut]} times (need >= "
                 f"{need_lut}), decode_attention {counts['decode_attention']}"
                 f" (need >= {need_attn}), {other} {counts[other]} (need 0)")
        # where a decode step's time goes: its kernels alone (CUDA graph
        # replay of one full-pool step) against the eager step the engine
        # runs (kernels + Python + launch overhead)
        tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
        one_step = lambda: lm.decode_step(eng.params, tok, eng.cache, cfg,
                                          quant_kv=True, device="cuda")
        step_dev, step_wall = timer(one_step), timer.call_ms(one_step)
        # the step's 12 attention launches as one graph (no flush, as the
        # LUT-GEMV's step graph in phase 2) on the engine's own cache and
        # positions
        layers = eng.cache["layers"]
        pos = eng.cache["length"].to(torch.int32)
        qa = torch.randn((8, cfg.n_heads, cfg.head_dim), device="cuda")
        attn_dev = timer.replay_ms(lambda: [decode_attention_ring(
            qa, layers["k"][i], layers["v"][i], pos, cfg.window or 512,
            layers["k_scale"][i], layers["v_scale"][i])
            for i in range(cfg.n_layers)])
        log(f"[engine] {plan}: one decode step (8 lanes): device "
            f"{step_dev:.3f} ms, eager wall {step_wall:.3f} ms "
            f"({100 * (1 - step_dev / step_wall):.1f}% of the step is host "
            f"and launch overhead); its {cfg.n_layers} attention launches "
            f"as one graph {attn_dev:.4f} ms (positions "
            f"{pos.tolist()})")
        rt["engine"][plan] = dict(
            step_device_ms=step_dev, step_wall_ms=step_wall,
            attention_step_graph_ms=attn_dev,
            tokens=st["generated_tokens"], seconds=dt,
            tok_per_s=st["generated_tokens"] / dt,
            decode_tok_per_s=st["measured_tps"],
            decode_steps=st["decode_iterations"],
            prefill_steps=st["prefill_iterations"],
            mean_latency_s=st["mean_latency_s"],
            p99_latency_s=st["p99_latency_s"],
            mean_ttft_s=st["mean_ttft_s"], launches=counts)


# ---------------------------------------------------------------------------
# phase 5: the paged engine, through the kernels' table mode
# ---------------------------------------------------------------------------

PAGED = dict(batch_size=8, cache_len=512, quant_kv=True, plan="uniform:4",
             group_size=128, kv_block_size=16)


def engine_requests(cfg, seed=0):
    """Phase 4's 16 requests: prompts of 8-64 random tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 65)))
            .tolist() for _ in range(16)]


def prefix_requests(cfg, n=16, seed=1):
    """``n`` prompts in four groups, each group sharing a 32-token prefix,
    then 8-32 more tokens each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, cfg.vocab, size=32).tolist() for _ in range(4)]
    return [stems[i % 4] + rng.integers(0, cfg.vocab, size=int(
        rng.integers(8, 33))).tolist() for i in range(n)]


def serve_counted(torch, eng, prompts, max_new=32):
    """Serve ``prompts`` with the launch counters set to 0 just before and
    read just after: ({uid: tokens}, counts, seconds)."""
    from repro_torch.kernels import _build
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.launches)
    return {u: eng.completions[u].tokens for u in uids}, counts, dt


def check_paged_launches(name, st, counts, cfg):
    """Every decode step: each layer's attention through the table mode
    and none through ring mode, the 85 weight matmuls through the f32
    LUT-GEMV and none through the int one."""
    steps = st["decode_iterations"]
    ring = counts["decode_attention"] - counts["decode_attention_table"]
    need_lut = steps * ((len(MATMULS) - 1) * cfg.n_layers + 1)
    table = counts["decode_attention_table"]
    if (table < steps * cfg.n_layers or ring
            or counts["lut_matmul"] < need_lut or counts["lut_matmul_int"]):
        fail(f"paged {name}: table-mode attention {table} (need >= "
             f"{steps * cfg.n_layers}), ring mode {ring} (need 0), "
             f"lut_matmul {counts['lut_matmul']} (need >= {need_lut}), "
             f"lut_matmul_int {counts['lut_matmul_int']} (need 0)")


def phase_paged(rt):
    import torch
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    res = rt["paged"] = {}

    # run A: phase 4's 16 requests, a pool of 8 lanes x 32 blocks, no
    # sharing: admission and prefill groups are the ring engine's, so the
    # tokens must be the ring engine's exactly
    eng = Engine(raw, cfg, EngineConfig(**PAGED, kv_pool_blocks=8 * 32,
                                        share_prefix=False), device="cuda")
    got, counts, dt = serve_counted(torch, eng, engine_requests(cfg))
    st = eng.stats()
    check_paged_launches("run A", st, counts, cfg)
    ring = rt["ring_tokens"]["uniform:4"]
    same = sum(got[u] == ring[u] for u in ring)
    log(f"[paged] run A (16 requests, 256 blocks of 16, no sharing): "
        f"{st['generated_tokens']} tokens in {dt:.3f} s, decode "
        f"{st['measured_tps']:.1f} tok/s over {st['decode_iterations']} "
        f"steps; {same} of 16 completions equal the ring engine's; launches "
        f"{counts}")
    if got != ring:
        fail(f"paged run A: tokens differ from the ring engine's ({same} of "
             "16 equal)")
    res["A"] = dict(tokens=st["generated_tokens"], seconds=dt,
                    decode_tok_per_s=st["measured_tps"],
                    decode_steps=st["decode_iterations"], launches=counts,
                    equal_to_ring=same, block_pool=st["block_pool"])

    # one full-pool paged decode step, device (graph replay) and eager wall,
    # at the ring step's positions: each lane on its own 32 blocks
    tables = torch.arange(8 * 32, dtype=torch.int32,
                          device="cuda").reshape(8, 32)
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    step = lambda: lm.decode_step(eng.params, tok, eng.cache, cfg,
                                  quant_kv=True, device="cuda",
                                  block_tables=tables)
    step_dev, step_wall = timer(step), timer.call_ms(step)
    ring_step = rt["engine"]["uniform:4"]
    log(f"[paged] one full-pool paged decode step (8 lanes, positions "
        f"{eng.cache['length'].tolist()}): device {step_dev:.3f} ms, eager "
        f"wall {step_wall:.3f} ms; the ring step "
        f"{ring_step['step_device_ms']:.3f} / "
        f"{ring_step['step_wall_ms']:.3f} ms")
    res["step_device_ms"], res["step_wall_ms"] = step_dev, step_wall
    del eng

    # run B: 16 requests sharing four 32-token prefixes, 32 new tokens each,
    # a pool of one lane's 32 blocks: sharing and preemption; twice
    prompts = prefix_requests(cfg)
    runs = []
    for rep_ in range(2):
        eng = Engine(raw, cfg, EngineConfig(**PAGED, kv_pool_blocks=32),
                     device="cuda")
        got, counts, dt = serve_counted(torch, eng, prompts)
        st = eng.stats()
        pool = st["block_pool"]
        eng.block_mgr.check_invariants()
        check_paged_launches("run B", st, counts, cfg)
        if (len(got) != 16 or any(len(t) != 32 for t in got.values())
                or pool["preemptions"] == 0 or pool["shared_hits"] == 0
                or pool["used_blocks"] != 0):
            fail(f"paged run B: {len(got)} completions, pool {pool}")
        runs.append(got)
        log(f"[paged] run B #{rep_ + 1} (16 requests in 4 prefix groups, 32 "
            f"blocks of 16): {st['generated_tokens']} tokens in {dt:.3f} s "
            f"over {st['decode_iterations']} decode and "
            f"{st['prefill_iterations']} prefill steps; pool {pool}; "
            f"launches {counts}")
    if runs[0] != runs[1]:
        fail("paged run B: two runs gave different tokens")
    ring_eng = Engine(raw, cfg, EngineConfig(
        **{k: v for k, v in PAGED.items() if k != "kv_block_size"}),
        device="cuda")
    ring, _, _ = serve_counted(torch, ring_eng, prompts)
    same = sum(runs[0][u] == ring[u] for u in ring)
    log(f"[paged] run B: the same tokens twice; {same} of 16 completions "
        f"equal the ring engine's on the same requests (preempted requests "
        f"recompute their KV by prefill, sharers read the registrant's)")
    res["B"] = dict(tokens=st["generated_tokens"], seconds=dt,
                    decode_steps=st["decode_iterations"],
                    prefill_steps=st["prefill_iterations"],
                    launches=counts, block_pool=pool, equal_to_ring=same)
    del eng, ring_eng

    # equal KV bytes: 2 ring lanes of 512 tokens against 64 blocks of 16
    # shared by up to 8 lanes, on 8 requests of run B's prefix groups
    peaks = {}
    for name, fields in (("ring", dict(batch_size=2)),
                         ("paged", dict(batch_size=8, kv_block_size=16,
                                        kv_pool_blocks=64))):
        kw = {k: v for k, v in PAGED.items() if k != "kv_block_size"}
        eng = Engine(raw, cfg, EngineConfig(**{**kw, **fields}),
                     device="cuda")
        serve_counted(torch, eng, prompts[:8])
        peaks[name] = eng.stats()["peak_active"]
        del eng
    log(f"[paged] equal KV bytes (1024 token rows): peak_active paged "
        f"{peaks['paged']}, ring {peaks['ring']}")
    if peaks["paged"] <= peaks["ring"]:
        fail(f"equal KV bytes: the paged pool held {peaks['paged']} requests"
             f" at once, the ring pool {peaks['ring']}")
    res["peak_active_equal_bytes"] = peaks


# ---------------------------------------------------------------------------
# phase 6: mixed-precision plans
# ---------------------------------------------------------------------------

# plan R: per-path rules, one segment; lm_head falls to the default 8 bits
# with f32 activations
PLAN_R = "rules:w_gate|w_up=2,w_down=3,wq|wk|wv=6a6,wo=5a4,default=8"
# plan S's three segments of the 12 layers
SEGMENTS = ((0, 4), (4, 10), (10, 12))
RING6 = dict(batch_size=8, cache_len=512, quant_kv=True, group_size=128)
# f32 launches are held at the reference tests' LUT-GEMV tolerance, int
# launches at phase 2's tolerance for quantized data
F32_RTOL, F32_ATOL = 1e-5, 1e-4
LUT_BITS = (2, 3, 4, 5, 6, 8)


def plan_s(acts=False):
    """Plan S: a solved auto plan cutting the stack into SEGMENTS (attention
    8 / 4 / 6 bits, w_gate and w_up 5 / 3 / 4, w_down 6 / 4 / 8, lm_head 6)
    with f32 KV; with ``acts``, plan S-a: activations of w_gate, w_up and
    w_down at 8 / 6 / 4 bits."""
    def per(*bits):
        return [b for (lo, hi), b in zip(SEGMENTS, bits) for _ in range(lo,
                                                                         hi)]
    unit = lambda blk, m: f"['blocks']['{blk}']['{m}']"
    w = {unit("attn", m): per(8, 4, 6) for m in ("wq", "wk", "wv", "wo")}
    w.update({unit("mlp", m): per(5, 3, 4) for m in ("w_gate", "w_up")})
    w[unit("mlp", "w_down")] = per(6, 4, 8)
    w["['lm_head']"] = 6
    spec = {"mode": "auto", "weight_bits": 4, "kv_bits": 32,
            "weights_per_unit": w}
    if acts:
        spec["acts_per_unit"] = {unit("mlp", m): per(8, 6, 4)
                                 for m in ("w_gate", "w_up", "w_down")}
    return spec


def instance_name(key) -> str:
    bits, abits = key
    return f"b{bits}" + (f"a{abits}" if abits else "")


def expected_instances(params, lm, decode_steps, prefill_steps) -> dict:
    """Launches of each LUT-GEMV instance (bits, abits) a run of
    ``decode_steps`` decode and ``prefill_steps`` prefill passes makes:
    every layer's 7 matrices and lm_head once per pass, and wk, wv once
    more per prefill (the prefill cache recomputes K and V)."""
    out = collections.Counter()

    def add(qt, per_prefill=1):
        key = (qt.bits, qt.abits or 0)
        out[key] += decode_steps + per_prefill * prefill_steps
    for _, layer in lm.iter_layers(params):
        for mats in layer.values():
            if isinstance(mats, dict):
                for m, qt in mats.items():
                    if m in MATMULS:
                        add(qt, 2 if m in ("wk", "wv") else 1)
    add(params["lm_head"])
    return dict(out)


class Held:
    """Within the block, every LUT-GEMV launch is held against its plain
    version on the launch's own inputs (the weight dequantized once per
    tensor): f32 launches at F32_RTOL / F32_ATOL, int launches at LUT_RTOL
    / LUT_ATOL.  The plain version launches nothing, so the counters
    still count the kernel's launches only."""

    def __init__(self, torch, name):
        from repro_torch.kernels.lut_gemv import ops
        self.ops, self.torch, self.name = ops, torch, name
        self.calls = collections.Counter()
        self.err = {"f32": 0.0, "int": 0.0}
        self._w = {}

    def _weight(self, qt):
        from repro_torch.core.quant import dequantize
        key = (qt.packed.data_ptr(), qt.bits)
        if key not in self._w:
            self._w[key] = dequantize(qt)
        return self._w[key]

    def _check(self, kind, y, ref, what):
        rtol, atol = ((F32_RTOL, F32_ATOL) if kind == "f32"
                      else (LUT_RTOL, LUT_ATOL))
        err = (y - ref).abs()
        if not bool((err <= atol + rtol * ref.abs()).all()):
            fail(f"{self.name}: {kind} LUT-GEMV {what}: max err "
                 f"{err.max().item():.3e}")
        self.err[kind] = max(self.err[kind], err.max().item())

    def __enter__(self):
        ops, torch = self.ops, self.torch
        self.f32, self.int = ops.lut_matmul_cuda, ops.lut_matmul_int_cuda

        def f32(x, qt):
            y = self.f32(x, qt)
            self._check("f32", y, torch.matmul(x, self._weight(qt)),
                        f"b{qt.bits} x {tuple(x.shape)} N={qt.n}")
            self.calls[(qt.bits, 0)] += 1
            return y

        def int_(xq, xs, qt, abits):
            y = self.int(xq, xs, qt, abits)
            ref = torch.matmul(xq.to(torch.float32), self._weight(qt)) * xs
            self._check("int", y, ref, f"b{qt.bits}a{abits} x "
                        f"{tuple(xq.shape)} N={qt.n}")
            self.calls[(qt.bits, abits)] += 1
            return y
        ops.lut_matmul_cuda, ops.lut_matmul_int_cuda = f32, int_
        return self

    def __exit__(self, *exc):
        self.ops.lut_matmul_cuda = self.f32
        self.ops.lut_matmul_int_cuda = self.int
        self._w.clear()
        return False


def serve_plan(torch, lm, Engine, EngineConfig, raw, cfg, name, plan,
               prompts, held=False, **fields):
    """Serve ``prompts`` (32 new tokens each) under ``plan``; check that
    every LUT-GEMV instance launched as often as the plan's layers and
    passes make it, and that attention went through ring or table mode
    only.  Returns (engine, {uid: tokens}, record)."""
    from repro_torch.kernels import _build
    eng = Engine(raw, cfg, EngineConfig(**{**RING6, **fields}, plan=plan),
                 device="cuda")
    with (Held(torch, name) if held else contextlib.nullcontext()) as h:
        got, counts, dt = serve_counted(torch, eng, prompts)
        inst = dict(_build.lut_instances)
    st = eng.stats()
    steps, pre = st["decode_iterations"], st["prefill_iterations"]
    want = expected_instances(eng.params, lm, steps, pre)
    table = counts["decode_attention_table"]
    need_attn = steps * cfg.n_layers
    if inst != want:
        fail(f"{name}: LUT-GEMV launches per instance "
             f"{ {instance_name(k): v for k, v in inst.items()} }, the plan "
             f"needs { {instance_name(k): v for k, v in want.items()} }")
    if (counts["decode_attention"] < need_attn
            or table != (counts["decode_attention"] if eng.paged else 0)):
        fail(f"{name}: decode_attention {counts['decode_attention']} (need "
             f">= {need_attn}), table mode {table}")
    if len(got) != len(prompts) or any(len(t) != 32 for t in got.values()):
        fail(f"{name}: expected {len(prompts)} completions of 32 tokens")
    rec = dict(plan_hash=st["plan_hash"], plan_mode=st["plan_mode"],
               kv_bits=st["kv_bits"], paged=eng.paged,
               segments=len(lm.block_segments(eng.params)),
               tokens=st["generated_tokens"], seconds=dt,
               decode_tok_per_s=st["measured_tps"], decode_steps=steps,
               prefill_steps=pre, launches=counts,
               instances={instance_name(k): v for k, v in sorted(inst.items())},
               weight_compression=st["weight_compression"],
               planned_tps_sail_model=st["planned_tps"])
    if held:
        if sum(h.calls.values()) != counts["lut_matmul"] + \
                counts["lut_matmul_int"]:
            fail(f"{name}: {sum(h.calls.values())} launches held of "
                 f"{counts['lut_matmul'] + counts['lut_matmul_int']}")
        rec.update(held=sum(h.calls.values()), held_err=dict(h.err))
    kv_dtype = eng.cache["layers"]["k"].dtype
    if kv_dtype != (torch.int8 if st["kv_bits"] == 8 else torch.float32):
        fail(f"{name}: a {st['kv_bits']}-bit KV pool of {kv_dtype}")
    log(f"[plans] {name}: plan {st['plan_hash']} ({st['plan_mode']}, "
        f"{rec['segments']} segment(s), {st['weight_compression']}x smaller "
        f"weights), {st['kv_bits']}-bit KV, {'paged' if eng.paged else 'ring'}"
        f": {st['generated_tokens']} tokens in {dt:.3f} s, decode "
        f"{st['measured_tps']:.1f} tok/s over {steps} decode and {pre} "
        f"prefill passes; LUT-GEMV launches per instance {rec['instances']} "
        f"(= the plan's layers x matrices x passes)"
        + (f"; all {rec['held']} held against the plain version (max abs err"
           f" f32 {h.err['f32']:.3e}, int {h.err['int']:.3e})" if held
           else "") + f"; attention {counts['decode_attention']} launches, "
        f"{table} in table mode")
    return eng, got, rec


def step_device_ms(torch, timer, lm, eng, cfg):
    """One full-pool decode step of ``eng`` replayed as a CUDA graph."""
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    return timer(lambda: lm.decode_step(eng.params, tok, eng.cache, cfg,
                                        quant_kv=eng.kv_bits == 8,
                                        device="cuda"))


def lut_step_graphs(torch, timer, gen):
    """The LUT-GEMV's 85 calls of a decode step at M = 8 as one CUDA
    graph, per weight bit width (f32 activations): each call first held
    against its plain version, then the step timed beside its bound and
    torch.matmul on the dequantized weights."""
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda
    xk = {k: torch.randn((8, k), device="cuda", generator=gen)
          for k in sorted({k for k, _ in MATMULS.values()})}
    rows = {}
    for bits in LUT_BITS:
        qts = [rand_qtensor(torch, gen, k, n, bits, 128, False)
               for name, (k, n) in MATMULS.items() if name != "lm_head"
               for _ in range(12)]
        qts.append(rand_qtensor(torch, gen, *MATMULS["lm_head"], bits, 128,
                                False))
        wds = [dequantize(qt) for qt in qts]
        err = 0.0
        for qt, wd in zip(qts, wds):
            y, ref = lut_matmul_cuda(xk[qt.k], qt), torch.matmul(xk[qt.k], wd)
            e = (y - ref).abs()
            if not bool((e <= F32_ATOL + F32_RTOL * ref.abs()).all()):
                fail(f"lut_matmul b={bits} ({qt.k}, {qt.n}): max err "
                     f"{e.max().item():.3e}")
            err = max(err, e.max().item())
        ms = timer.replay_ms(lambda: [lut_matmul_cuda(xk[qt.k], qt)
                                      for qt in qts])
        lib = timer.replay_ms(lambda: [torch.matmul(xk[w.shape[0]], w)
                                       for w in wds])
        nbytes = sum(4 * (qt.packed.numel() + qt.scales.numel()
                          + qt.codebook.numel()) + 4 * 8 * (qt.k + qt.n)
                     for qt in qts)
        ops = sum(2 * 8 * qt.k * qt.n for qt in qts)
        bound, by = bound_ms(nbytes, ops)
        rows[bits] = dict(step_graph_ms=ms, library_step_graph_ms=lib,
                          bytes=nbytes, bytes_bound_ms=nbytes
                          / HBM_BYTES_PER_S * 1e3, bound_ms=bound,
                          bound_by=by, max_abs_err=err)
        log(f"[plans] LUT-GEMV decode step, b={bits} (85 calls, M=8, G=128, "
            f"f32 activations): {ms:.4f} ms as one graph; torch.matmul on "
            f"the dequantized weights {lib:.4f} ms; bytes "
            f"{nbytes / 1e6:.1f} MB -> {rows[bits]['bytes_bound_ms']:.4f} ms "
            f"at 3.35 TB/s, bound {bound:.4f} ms by {by}; each call within "
            f"rtol {F32_RTOL} / atol {F32_ATOL} of its plain version (max "
            f"abs err {err:.3e})")
        del qts, wds
    return rows


def phase_plans(rt):
    import torch
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
        quantize_params
    from repro_torch.planning import as_plan
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(6)
    res = rt["plans"] = {"runs": {}, "step_device_ms": {}}
    plans = {"R": PLAN_R, "S": plan_s(), "S-a": plan_s(acts=True)}
    res["plan_hash"] = {n: as_plan(p).spec_hash for n, p in plans.items()}
    log("[plans] plan hashes: " + ", ".join(
        f"{n} {h}" for n, h in res["plan_hash"].items()))
    prompts = engine_requests(cfg)
    serve = lambda name, plan, **kw: serve_plan(
        torch, lm, Engine, EngineConfig, raw, cfg, name, plan, prompts, **kw)
    paged = dict(kv_block_size=16, kv_pool_blocks=8 * 32, share_prefix=False)

    # plan R: ring pool, int8 KV, every launch held
    eng, _, res["runs"]["R ring"] = serve("R ring", PLAN_R, held=True)
    if isinstance(eng.params["blocks"], list) or eng.kv_bits != 8:
        fail("plan R: expected one segment and int8 KV")
    res["step_device_ms"]["R"] = step_device_ms(torch, timer, lm, eng, cfg)
    del eng

    # plan S on the card against the CPU, phase 3's prompts and steps
    toks, lengths = model_prompts(cfg)
    policy = as_plan(plans["S"]).to_policy(QuantPolicy(
        bits=4, group_size=128, min_size=1024))
    params, _, _ = quantize_params(raw, policy)
    if len(params["blocks"]) != len(SEGMENTS):
        fail(f"plan S: {len(params['blocks'])} segments")
    gl, gt = run_greedy(torch, lm, params, cfg, toks, lengths, 4, "cuda",
                        quant_kv=False)
    torch.cuda.synchronize()
    cl, ct = run_greedy(torch, lm, map_tensors(params, lambda t: t.cpu()),
                        cfg, toks, lengths, 4, "cpu", quant_kv=False)
    del params
    err = (gl - cl).abs().max().item()
    log(f"[plans] S: prefill [2, 48] + 4 decode steps, f32 KV, card vs CPU: "
        f"logits max abs err {err:.3e}; greedy tokens card {gt.T.tolist()} "
        f"CPU {ct.T.tolist()}")
    if not torch.isfinite(gl).all() or not torch.equal(gt, ct):
        fail("plan S: card and CPU greedy tokens differ (or logits not "
             "finite)")
    if not torch.allclose(gl, cl, rtol=MODEL_RTOL, atol=MODEL_ATOL):
        fail(f"plan S: card and CPU logits differ by {err:.3e}")
    res["S card vs cpu logits err"] = err

    # plan S and S-a: ring against paged (run A's admission), f32 KV
    for name, held in (("S", False), ("S-a", True)):
        eng, ring, res["runs"][f"{name} ring"] = serve(
            f"{name} ring", plans[name], held=held)
        res["step_device_ms"][name] = step_device_ms(torch, timer, lm, eng,
                                                     cfg)
        del eng
        eng, pg, res["runs"][f"{name} paged"] = serve(
            f"{name} paged", plans[name], held=held, **paged)
        del eng
        same = sum(pg[u] == ring[u] for u in ring)
        log(f"[plans] {name}: {same} of 16 paged completions equal the ring "
            "engine's (f32 KV)")
        if pg != ring:
            fail(f"plan {name}: paged tokens differ from the ring engine's")
    u4 = rt["engine"]["uniform:4"]["step_device_ms"]
    log("[plans] one full-pool decode step (8 lanes), device time as a CUDA "
        "graph: " + ", ".join(f"{n} {ms:.3f} ms"
                              for n, ms in res["step_device_ms"].items())
        + f"; uniform:4 {u4:.3f} ms (phase 4)")
    res["step_device_ms"]["uniform:4 (phase 4)"] = u4
    res["lut_step_graph"] = lut_step_graphs(torch, timer, gen)


# ---------------------------------------------------------------------------
# phase 7: the Planner
# ---------------------------------------------------------------------------

# the probe scores of the card against the CPU's, at the CPU tests'
# tolerances (tests/test_torch_planner.py): output scores at rtol 1e-4;
# activation scores at 1e-3, since their 4-bit activation codes turn f32
# rounding differences into score differences of ~1e-4; the KV probe's
# per-layer values at 1e-3
SCORE_RTOL = {"scores": 1e-4, "act": 1e-3}
SCORE_ATOL, KV_RTOL = 1e-9, 1e-3
PLANNER_BASE = dict(bits=4, group_size=128, min_size=1024)


def solve_on_card(torch, Planner, base, raw, cfg, plan, res, name):
    """Probe and solve ``plan`` on the card; the KV probe's launches are
    counted with the counters set to 0 just before it and read after."""
    from repro_torch.core import sensitivity as sens
    from repro_torch.kernels import _build
    planner = Planner(raw, cfg, plan, base=base)
    joint = planner.plan.act_bits is not None
    _build.reset_launches()
    t0 = time.perf_counter()
    planner._ensure_scores(joint)
    torch.cuda.synchronize()
    t_probe = time.perf_counter() - t0
    probe_counts = dict(_build.launches)
    kv = None
    if planner.plan.kv_bits == "auto":
        _build.reset_launches()
        t0 = time.perf_counter()
        planner._resolve_kv(planner.plan)
        torch.cuda.synchronize()
        t_kv = time.perf_counter() - t0
        kv = dict(seconds=t_kv, launches=dict(_build.launches),
                  **planner._kv_scores)
    t0 = time.perf_counter()
    result = planner.solve()
    t_solve = time.perf_counter() - t0
    spec, rep = result.spec, result.report
    segs = sens.segment_count(rep.bits_by_unit)
    rec = dict(plan=plan, spec_hash=spec.spec_hash,
               probe_forwards=planner.probe_stats["forwards"],
               probe_seconds=t_probe, probe_launches=probe_counts,
               solve_seconds=t_solve, segments=segs, kv=kv,
               kv_bits=spec.kv_bits, feasible=rep.feasible,
               weights_per_unit=spec.to_json()["weights_per_unit"],
               acts_per_unit=spec.to_json().get("acts_per_unit"),
               planned_tps_sail_model=result.cost.tokens_per_second)
    if any(probe_counts.values()):
        fail(f"{name}: the probes launched kernels {probe_counts}; they run "
             "lm.forward on f32 weights (plain matmuls)")
    if not spec.solved or rep is None:
        fail(f"{name}: the Planner returned an unsolved plan")
    log(f"[planner] {name} = {plan}: {rec['probe_forwards']} probe forwards "
        f"in {t_probe:.2f} s on the card, solve {t_solve:.3f} s; plan "
        f"{spec.spec_hash}, {segs} segment(s), feasible {rep.feasible}, "
        f"kv_bits {spec.kv_bits}"
        + ("" if kv is None else
           f" (KV probe: {len(kv['per_layer'])} layers in {kv['seconds']:.2f}"
           f" s, relative error {kv['relative']:.3e} against the tolerance "
           f"{planner.kv_tolerance}; {kv['launches']['decode_attention']} "
           f"decode-attention launches over an f32 KV cache)"))
    log(f"[planner] {name} weights_per_unit "
        f"{json.dumps(rec['weights_per_unit'], sort_keys=True)}")
    if rec["acts_per_unit"] is not None:
        log(f"[planner] {name} acts_per_unit "
            f"{json.dumps(rec['acts_per_unit'], sort_keys=True)}")
    res["solves"][name] = rec
    return planner, result


def probe_scores(sens, params, cfg, tokens, base):
    """The three probes of a model on the device its weights live on,
    timed."""
    t0 = time.perf_counter()
    out = dict(scores=sens.output_sensitivity(params, cfg, tokens, base),
               act=sens.activation_sensitivity(params, cfg, tokens, base),
               kv=sens.kv_sensitivity(params, cfg, tokens))
    out["seconds"] = time.perf_counter() - t0
    return out


def probe_parity(torch, sens, raw, cfg, base, res):
    """(c): the probes at full width and 2 layers, card against CPU, and
    the two allocations their scores solve to."""
    import dataclasses
    from repro_torch.models.sail_linear import _walk, map_tensors
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    raw2 = dict(raw)
    raw2["blocks"] = _walk(raw["blocks"], lambda _, x: x[:2].contiguous())
    tokens = sens.calibration_tokens(cfg.vocab)
    card = probe_scores(sens, raw2, cfg2, tokens, base)
    torch.cuda.synchronize()
    cpu = probe_scores(sens, map_tensors(raw2, lambda t: t.cpu()), cfg2,
                       tokens, base)
    worst = {}
    for kind in ("scores", "act"):
        worst[kind] = (0.0, None)
        for key, errs in cpu[kind].items():
            for b, c in errs.items():
                g = card[kind][key][b]
                gap = abs(g - c) / max(abs(c), 1e-30)
                if gap > worst[kind][0]:
                    worst[kind] = (gap, (key, b))
                if abs(g - c) > SCORE_ATOL + SCORE_RTOL[kind] * abs(c):
                    fail(f"probe parity: {kind} {key} at {b}: card {g!r}, "
                         f"CPU {c!r}")
    kv_gap = max(abs(g - c) / max(abs(c), 1e-30) for g, c in
                 zip(card["kv"]["per_layer"], cpu["kv"]["per_layer"]))
    if kv_gap > KV_RTOL:
        fail(f"probe parity: KV per layer card {card['kv']['per_layer']} CPU "
             f"{cpu['kv']['per_layer']}")
    solve = dict(match_uniform=4, abits_candidates=(4, 6, 8),
                 match_uniform_abits=8, tokens=tokens)
    allocs = {}
    for side, got in (("card", card), ("cpu", cpu)):
        _, rep = sens.calibrate_policy(raw2, cfg2, base, scores=got["scores"],
                                       act_scores=got["act"], **solve)
        allocs[side] = rep.bits_by_unit
    if allocs["card"] != allocs["cpu"]:
        for key in allocs["cpu"]:
            if allocs["card"][key] != allocs["cpu"][key]:
                log(f"[planner] flipped unit {key}: card state "
                    f"{allocs['card'][key]} scores "
                    f"{card['scores'][key]} / {card['act'][key]}; CPU state "
                    f"{allocs['cpu'][key]} scores {cpu['scores'][key]} / "
                    f"{cpu['act'][key]}")
        fail("probe parity: the card's scores and the CPU's solve to "
             "different allocations")
    n = sum(len(e) for e in cpu["scores"].values()) + \
        sum(len(e) for e in cpu["act"].values())
    log(f"[planner] probe parity, full width at 2 layers (the only cut): "
        f"{n} output and activation scores; worst relative gap card vs CPU "
        f"{worst['scores'][0]:.3e} at {worst['scores'][1]} among output "
        f"scores (rtol {SCORE_RTOL['scores']}), {worst['act'][0]:.3e} at "
        f"{worst['act'][1]} among activation scores (rtol "
        f"{SCORE_RTOL['act']}), atol {SCORE_ATOL}; KV per layer within "
        f"{kv_gap:.3e} (rtol {KV_RTOL}), "
        f"relative {card['kv']['relative']:.3e} / {cpu['kv']['relative']:.3e};"
        f" the joint match-uniform-4a8 allocations are equal "
        f"({len(allocs['cpu'])} units); probes took {card['seconds']:.2f} s on"
        f" the card, {cpu['seconds']:.2f} s on the CPU")
    res["probe_parity"] = dict(
        worst_rel_gap={k: v[0] for k, v in worst.items()},
        worst_at={k: str(v[1]) for k, v in worst.items()},
        kv_worst_rel_gap=kv_gap,
        scores=n, card_seconds=card["seconds"], cpu_seconds=cpu["seconds"],
        allocations_equal=True)


def live_replan(torch, planning, Engine, EngineConfig, raw, cfg, spec,
                planner, prompts, res):
    """(d): replan() and replan(resolve=True) + apply_plan after 8 decode
    iterations of an engine with a tap; its tokens against an engine that
    served the final plan from the start (or, when the re-solve changed the
    allocation, one that swapped to it at the same iteration)."""
    import dataclasses
    eng = Engine(raw, cfg, EngineConfig(**RING6, plan=spec, tap_capacity=256),
                 device="cuda")
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    while eng.decode_iterations < 8:
        eng.step()
    swap_at = eng.iterations
    cheap = eng.replan()
    unsolved = dataclasses.replace(eng.plan, weights_per_unit=None,
                                   acts_per_unit=None)
    resolver = planning.Planner(raw, cfg, unsolved, base=planner.base,
                                tokens=planner._tokens,
                                scores=planner._scores,
                                act_scores=planner._act_scores)
    t0 = time.perf_counter()
    result = resolver.replan(eng.tap, resolve=True)
    t_resolve = time.perf_counter() - t0
    changed = result.policy != eng.quant_policy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.apply_plan(result, force_requantize=True)
    torch.cuda.synchronize()
    t_apply = time.perf_counter() - t0
    eng.run()
    got = {c.uid: c.tokens for c in eng.completions.values()}
    st = eng.stats()
    final = eng.plan
    ref_run = Engine(raw, cfg, EngineConfig(
        **RING6, plan=spec if changed else final, retain_raw=changed),
        device="cuda")
    for p in prompts:
        ref_run.submit(p, max_new_tokens=32)
    if changed:
        while ref_run.iterations < swap_at:
            ref_run.step()
        ref_run.apply_plan(final)
    ref_run.run()
    want = {c.uid: c.tokens for c in ref_run.completions.values()}
    same = sum(got[u] == want[u] for u in want)
    log(f"[planner] live replan after 8 decode iterations (iteration "
        f"{swap_at}): replan() measured a PRT hit rate of "
        f"{cheap.measured_prt_hit_rate:.4f} on {eng.tap.rows_seen} tapped "
        f"rows; replan(resolve=True) re-solved in {t_resolve:.2f} s to plan "
        f"{final.spec_hash} ({'a new' if changed else 'the same'} "
        f"allocation); apply_plan's requantization took {t_apply:.3f} s; "
        f"replan_count {st['replan_count']}, prt_hit_rate "
        f"{st['prt_hit_rate']:.4f}; {same} of {len(want)} completions equal "
        f"an engine that served "
        + ("the final plan from the start" if not changed else
           "the first plan and swapped to the final one at the same "
           "iteration"))
    if got != want or st["replan_count"] != 2:
        fail(f"live replan: {same} of {len(want)} completions equal, "
             f"replan_count {st['replan_count']}")
    res["live_replan"] = dict(
        swap_iteration=swap_at, prt_hit_rate=st["prt_hit_rate"],
        cheap_prt_hit_rate=cheap.measured_prt_hit_rate,
        replan_count=st["replan_count"], resolve_seconds=t_resolve,
        apply_plan_seconds=t_apply, allocation_changed=changed,
        final_plan=final.spec_hash, tapped_rows=st["tapped_rows"],
        equal=same)


def cost_calibration(torch, planning, raw, cfg, base, planner, res):
    """(e): the cost model refit to the bit-serial LUT-GEMV's timings on
    the card, and an SLO solve priced on that fitted machine."""
    import dataclasses
    t0 = time.perf_counter()
    cal = planning.run_calibration(device="cuda")
    t_cal = time.perf_counter() - t0
    prov = cal.provenance()
    c = {k: round(v, 6) for k, v in cal.machine_overrides.items()}
    log(f"[planner] cost calibration on {card_line()} ({cal.backend}): "
        f"{len(cal.points)} grid points of the bit-serial LUT-GEMV (batch 8, "
        f"K 512, N 256) in {t_cal:.2f} s; fitted constants of this host's "
        f"effective SAIL machine (not the H100's LUT-GEMV speed) {c}; "
        f"{len(cal.dispatch_cycles)} dispatch cells; max_rel_err "
        f"{cal.max_rel_err:.4f}, mean_rel_err {cal.mean_rel_err:.4f}; stream "
        f"bandwidth {cal.dram_bw_measured:.4e} bytes/s (64 MiB f32 read + "
        "write)")
    vals = list(cal.machine_overrides.values()) + \
        list(cal.dispatch_cycles.values())
    if len(cal.points) != 36 or not all(math.isfinite(v) and v >= 0
                                        for v in vals):
        fail(f"cost calibration: {len(cal.points)} points, constants {vals}")
    plan = dataclasses.replace(planning.PlanSpec.parse("auto:q4a8"),
                               calibration=prov)
    anchor = dataclasses.replace(base, act_bits=8)
    target = planning.plan_cost_model(plan, batch=8).evaluate(
        raw, anchor).tokens_per_second
    slo_plan = dataclasses.replace(plan, target_tps=target, slo_batch=8)
    solver = planning.Planner(raw, cfg, slo_plan, base=base,
                              tokens=planner._tokens, scores=planner._scores,
                              act_scores=planner._act_scores)
    t0 = time.perf_counter()
    result = solver.solve()
    t_solve = time.perf_counter() - t0
    if result.spec.calibration != prov or not result.spec.solved:
        fail("cost calibration: the SLO plan lost its calibration provenance")
    log(f"[planner] auto:q4a8,slo={target:.1f} priced on the fitted machine "
        f"(target = uniform 4a8's modeled tok/s on it at batch 8): solved in "
        f"{t_solve:.3f} s to plan {result.spec.spec_hash}, modeled "
        f"{result.cost.tokens_per_second:.1f} tok/s on the effective "
        f"machine, meets_slo {result.meets_slo}, feasible "
        f"{result.report.feasible}; plan.calibration carries the provenance "
        f"(backend {prov['backend']!r})")
    res["calibration"] = dict(
        seconds=t_cal, backend=cal.backend, constants=cal.machine_overrides,
        dispatch_cycles={f"{a}:{b}": v for (a, b), v in
                         sorted(cal.dispatch_cycles.items())},
        max_rel_err=cal.max_rel_err, mean_rel_err=cal.mean_rel_err,
        stream_bytes_per_s=cal.dram_bw_measured, card=card_line(),
        slo_target_effective_machine=target, slo_plan=result.spec.spec_hash,
        slo_meets=result.meets_slo, slo_solve_seconds=t_solve)


def phase_planner(rt):
    import torch
    from repro_torch import planning
    from repro_torch.core import sensitivity as sens
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
        quantize_params
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    base = QuantPolicy(**PLANNER_BASE)
    res = rt["planner"] = {"solves": {}, "runs": {}, "step_device_ms": {}}

    # (a) solve on the card
    planner, r_a8 = solve_on_card(torch, planning.Planner, base, raw, cfg,
                                  "auto:q4a8,kv=auto", res, "A8")
    _, r_q4 = solve_on_card(torch, planning.Planner, base, raw, cfg,
                            "auto:q4", res, "Q4")

    # (b) serve what was solved, every launch held and counted by instance
    prompts = engine_requests(cfg)
    serve = lambda name, plan, **kw: serve_plan(
        torch, lm, Engine, EngineConfig, raw, cfg, name, plan, prompts,
        held=True, **kw)
    paged = dict(kv_block_size=16, kv_pool_blocks=8 * 32, share_prefix=False)
    for name, result in (("A8", r_a8), ("Q4", r_q4)):
        eng, ring, res["runs"][f"{name} ring"] = serve(f"{name} ring",
                                                       result.spec)
        res["step_device_ms"][name] = step_device_ms(torch, timer, lm, eng,
                                                     cfg)
        del eng
        if name == "A8":
            eng, pg, res["runs"]["A8 paged"] = serve("A8 paged", result.spec,
                                                     **paged)
            del eng
            same = sum(pg[u] == ring[u] for u in ring)
            log(f"[planner] A8: {same} of 16 paged completions equal the "
                "ring engine's")
            if pg != ring:
                fail("plan A8: paged tokens differ from the ring engine's")
    log("[planner] one full-pool decode step (8 lanes), device time as a "
        "CUDA graph: " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in
                                   res["step_device_ms"].items()))

    # the solved plans on the card against the CPU, phase 3's prompts and
    # steps: Q4 (f32 activations) end to end, as phase 6 holds plan S; A8
    # launch by launch, as phase 3 holds uniform:4a8, beside the CPU
    # against itself with f32-rounding-sized noise before each activation
    # quantization (4-bit activation codes turn such noise into logit
    # differences as large as the card's)
    toks, lengths = model_prompts(cfg)
    res["card_vs_cpu"] = {}
    for name, result in (("Q4", r_q4), ("A8", r_a8)):
        params, _, _ = quantize_params(raw, result.policy)
        qkv = result.spec.kv_bits != 32
        with Held(torch, f"{name} card vs CPU") as held:
            gl, gt = run_greedy(torch, lm, params, cfg, toks, lengths, 4,
                                "cuda", quant_kv=qkv)
        torch.cuda.synchronize()
        cpu_params = map_tensors(params, lambda t: t.cpu())
        del params
        cl, ct = run_greedy(torch, lm, cpu_params, cfg, toks, lengths, 4,
                            "cpu", quant_kv=qkv)
        err = (gl - cl).abs().max().item()
        rec = dict(logits_err=err, tokens_equal=bool(torch.equal(gt, ct)),
                   held=sum(held.calls.values()), held_err=dict(held.err))
        noise = ""
        if name == "A8":
            pl = run_perturbed(torch, lm, cpu_params, cfg, toks, lengths)
            rec["cpu_vs_cpu_with_noise_err"] = (pl - cl).abs().max().item()
            noise = (f"; the CPU against itself with activations scaled by "
                     f"1 + 1e-7 N(0, 1) before each quantization differs by "
                     f"{rec['cpu_vs_cpu_with_noise_err']:.3e}")
        del cpu_params
        log(f"[planner] {name}: prefill [2, 48] + 4 decode steps, "
            f"{'int8' if qkv else 'f32'} KV, card vs CPU: logits max abs err "
            f"{err:.3e}; greedy tokens card {gt.T.tolist()} CPU "
            f"{ct.T.tolist()}; all {rec['held']} LUT-GEMV launches of the "
            f"card run within tolerance of their plain version on the same "
            f"inputs (max abs err f32 {held.err['f32']:.3e}, int "
            f"{held.err['int']:.3e}){noise}")
        if not torch.isfinite(gl).all() or rec["held"] < 5 * 85:
            fail(f"plan {name}: card logits not finite, or only "
                 f"{rec['held']} LUT-GEMV launches held")
        if name == "Q4" and not (rec["tokens_equal"] and torch.allclose(
                gl, cl, rtol=MODEL_RTOL, atol=MODEL_ATOL)):
            fail(f"plan Q4: card and CPU differ (logits {err:.3e}, tokens "
                 f"equal {rec['tokens_equal']})")
        res["card_vs_cpu"][name] = rec

    # (c) probe parity at full width, 2 layers
    probe_parity(torch, sens, raw, cfg, base, res)

    # (d) live replan
    live_replan(torch, planning, Engine, EngineConfig, raw, cfg, r_a8.spec,
                planner, prompts, res)

    # (e) the cost model refit on the card
    cost_calibration(torch, planning, raw, cfg, base, planner, res)


def kernels_line(rt) -> dict:
    """``launches`` is each kernel's count from the engine run of the plan
    that routes through it (the standalone int_to_f32 is on neither path:
    its device function is inlined into the int LUT-GEMV, so its count is
    read from the uniform:4a8 run and is expected to be 0)."""
    meta = {
        "lut_matmul": ("src/repro_torch/csrc/lut_gemv.cu",
                       "src/repro/kernels/lut_gemv/kernel.py:138",
                       "uniform:4", True, "decode step: 85 calls, M=8, b=4"),
        "lut_matmul_int": ("src/repro_torch/csrc/lut_gemv.cu",
                           "src/repro/kernels/lut_gemv/kernel.py:174",
                           "uniform:4a8", True, "decode step: 85 calls, M=8, "
                           "b=4, abits=8"),
        "decode_attention": ("src/repro_torch/csrc/decode_attn.cu",
                             "src/repro/kernels/decode_attn/kernel.py:79",
                             "uniform:4", True, "one launch: B=8 S=512 KV=8 "
                             "G=4 D=32, int8 ring; rows: S 4096, the engine's "
                             "positions, table mode (BS 16) at S 512 and "
                             "4096"),
        "int_to_f32": ("src/repro_torch/csrc/typeconv.cu",
                       "src/repro/kernels/typeconv/kernel.py:75",
                       "uniform:4a8", False,
                       "one launch: [64, 4096] int32, n=8"),
    }
    out = []
    for name, (src, replaces, plan, on_path, per) in meta.items():
        row = rt["kernels"][name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": rt["engine"][plan]["launches"][name],
                 "launches_run": plan, "on_main_path": on_path, "per": per}
        if name == "decode_attention":      # the paged runs' table mode
            entry["launches_table"] = {
                run: rt["paged"][run]["launches"]["decode_attention_table"]
                for run in ("A", "B")}
            # phase 7: the solved plans' engine runs, and the KV probe's
            # decode steps over an f32 cache
            entry["launches_planner"] = {
                run: rec["launches"]["decode_attention"]
                for run, rec in rt["planner"]["runs"].items()}
            entry["launches_planner"]["kv probe (f32 KV)"] = \
                rt["planner"]["solves"]["A8"]["kv"]["launches"][
                    "decode_attention"]
        if name.startswith("lut_matmul"):   # phases 6-7, per instance
            entry["launches_plans"] = {
                run: {k: v for k, v in rec["instances"].items()
                      if ("a" in k) == (name == "lut_matmul_int")}
                for run, rec in list(rt["plans"]["runs"].items())
                + list(rt["planner"]["runs"].items())}
            entry["step_graph_ms_per_bits"] = {
                f"b{b}": row["step_graph_ms"]
                for b, row in rt["plans"]["lut_step_graph"].items()}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "call_ms", "bytes_bound_ms",
                    "int_ops_bound_ms", "int_ops_per_elem",
                    "paper_ops_per_elem", "int_rate", "step_graph_ms",
                    "library_step_graph_ms", "timer_floor_ms", "shapes",
                    "rows"):
            if key in row:
                entry[key] = row[key]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    rt = {}
    t_all = time.perf_counter()
    for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                     ("model", phase_model), ("engine", phase_engine),
                     ("paged", phase_paged), ("plans", phase_plans),
                     ("planner", phase_planner)):
        t0 = time.perf_counter()
        fn(rt)
        log(f"[{name}] phase passed in {time.perf_counter() - t0:.1f} s")
    line = kernels_line(rt)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump({"card": card_line(), "kernels": line["kernels"],
                   "engine": rt["engine"], "paged": rt["paged"],
                   "plans": rt["plans"], "planner": rt["planner"],
                   "build_s": rt["build_s"],
                   "model_err": rt["model_err"]}, f, indent=1)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
