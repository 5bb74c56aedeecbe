#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, as the chip check runs it
    python3 chip_smoke.py --phases build,families   # some phases (no result)

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
  Phases 3-10 serve tinymistral_248m at its full width cut to its first
  SERVE_LAYERS (4) of 12 layers; "85" and "12" below are its counts at
  full depth (7 weight matmuls a layer and lm_head, one attention a layer).
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
     run C serves two requests of one 37-token prompt (sharing its partly
     filled third block) at temperature 0.7: the first decode write must
     copy the shared block (``cow_count`` > 0) and the tokens must equal
     the CPU's on the same quantized tree;
  6. plans — mixed-precision plans on phase 4's 16 requests: plan R (rules,
     one segment: w_gate/w_up 2 bits, w_down 3, wq/wk/wv 6 with 6-bit
     activations, wo 5 with 4-bit, lm_head 8) on the ring pool with int8
     KV, every LUT-GEMV launch held against its plain version; plan S (a
     solved auto plan in three segments, layers 0 / 1-2 / 3, f32 KV)
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
     noise shows; the CPU's dequantized weights come from the card,
     bit-equal, as in phase 11);
     the probes at full width and 2 layers on the card and on the CPU
     (every score within the CPU tests' tolerance, equal allocations); at
     full width cut to 3 layers, A8 solved again and a live replan
     (replan(), then a re-solve under the tapped traffic and apply_plan)
     after 8 decode iterations, token-identical to an engine that served
     the final plan; the cost model refit to the bit-serial LUT-GEMV's
     timings on the card, and an SLO solve priced on it at 3 layers;
  8. sampling — phase 4's requests at temperature 0.7 (seed 7) on the ring
     and the paged pool (run A's admission): equal tokens per request,
     not all greedy's; again on the ring under uniform:4a8; every kernel
     launch counted as in phases 4-5.  The engine's draw on [8, 32005]
     logits of one such step on the card and on the CPU (and in numpy):
     the words and uniforms bit-equal, the Gumbel noise within 4 ulp at
     max(|g|, 1), the tokens equal; its device time as a graph beside the
     uniform:4 step's.  mode="batch" (cohorts of 8, one lm.prefill each,
     unmasked decode in ring mode): greedy tokens equal phase 4's
     continuous run, or part from it at a near-tie by phase 10's rule (its
     cohort prefills run the LUT-GEMV at other M, so in another summation
     order), the LUT-GEMV's launches counted at each cohort prefill's M.
     quantize=False (f32 weights, int8 KV) on phase 3's prompts and steps:
     tokens equal on card and CPU, decode attention launched and the
     LUT-GEMV not; one full-pool step timed;
  9. speculation — self-speculative decoding under uniform:4,draft=q2:k4
     on phase 4's requests: greedy tokens equal phase 4's on the ring and
     the paged pool (run A's admission), with rejected drafts and, on the
     paged pool, rollback truncates that drop blocks; per round the draft's
     k steps launch the b2 LUT-GEMV instance 85 times each at M 8, verify
     the b4 instance 85 times at M 40 (its K split as at M 8, so a verified
     row is the decode step's bit for bit: checked on copies of one pool),
     and decode attention 12 x (2k + 1) times in ring or table mode;
     verify's per-token attention held against the chunk-causal composite;
     uniform:4,draft=q2a8:k4 (the int LUT-GEMV in the draft); T 0.7 ring
     equal to paged, every ring LUT-GEMV launch held against its plain
     version; phase 3's prompts card against CPU at full width cut to 2
     layers; draft=auto solved on the card (the measured
     acceptance of bits 2-4, the pick held to the pricing grid's argmax);
     the controller shedding under an SLO the 8-lane pool cannot meet
     (tokens unchanged) and capped by the free blocks of a 32-block paged
     pool; the round's draft and verify device time as CUDA graphs beside
     the plain step, and decode tokens/s with and without the draft;
 10. tp — tensor-parallel serving: ranks spawned by ``torch.multiprocessing``
     (gloo, every rank on the one card) each build phase 4's full-width
     weights and keep their shard.  At tp=2, wire 32, phase 4's 16 requests
     under uniform:4 on the ring and on the paged pool (run A's admission),
     and at tp=4 on the ring: greedy tokens equal phase 4's, or a request
     parts at a near-tie (tp=1's top-2 gap below the two runs' logit
     difference there, every earlier logits row within the model
     tolerance).  At tp=2, wire 8, uniform:4a8 on the ring: its agreement
     with phase 4's uniform:4a8 tokens (the reference parts there too),
     every int LUT-GEMV launch held against its plain version.  Each rank's
     launches are counted exactly (85 LUT-GEMV per pass, 12 decode
     attentions per step) and by shape, and ``allreduce_bytes_per_iter``
     checked; the eager step's wall time against its 24 all-reduces alone,
     and a rank's 85-call LUT-GEMV step at the sharded shapes as one graph;
 11. families — the dense and MoE decoders, uniform:4, int8 KV, random
     weights made on the card.  (a) llama2_7b at full width and depth (32
     layers, d 4096, 32 x 128 heads): init and quantize on the card, the
     f32 tree freed; phase 4's 16 requests on the ring and on the paged
     pool (run A's admission), tokens equal; one prefill pass and two
     decode steps with every LUT-GEMV and decode-attention launch held
     against its plain version and counted exactly (225 LUT-GEMV and 32
     attentions per decode step); the step's device time as a graph and
     its eager wall, its 225 LUT-GEMV calls as one graph beside their
     bound and torch.matmul on the dequantized weights, its 32 attentions
     as one graph beside their bound; the model cut to 2 layers card
     against CPU (phase 3's prompts and tolerance).  (b)
     granite_moe_1b_a400m the same way at full depth, with its MoE
     layers' and dense expert einsums' share of the step.  (c)
     llama2_13b, llama3_2_1b, qwen3_0_6b, h2o_danube_3_4b, starcoder2_7b
     and mixtral_8x7b at full width cut to 2 layers (mixtral to 1, for
     the run's time): four requests on the
     ring and phase 3's prompts card against CPU, every launch held.  (d)
     the smoke configs with narrow heads (D 20 and D 12) on the ring and
     the paged pool, every launch held, tokens equal to the CPU engine's;
     decode attention timed at D 20 beside D 128.  The CPU's dequantized
     weights come from the card (bit-equal, checked), its products stay
     on the CPU.  (e) the quantizers card against CPU on seeded inputs:
     ``quantize_kv`` on a [8, 512, 8, 128] K tensor, ``quantize_activations``
     on [8, 4096] at 4 and 8 bits, ``quantize_int`` on one [4096, 4096]
     weight at 2-8 bits and ``quantize``'s codes, scales and codebook at
     every supported width, every uniform and NF codebook: codes, scales
     and codebooks bit-equal, beside the count of elements the formula
     before true division (a Python-scalar divisor) put apart on the card.
 12. others — the hybrid, recurrent, vision and encoder-decoder families,
     uniform:4, int8 KV, random weights made on the card, at full width
     and depth.  (a) hymba_1_5b (group 128: only w_down is quantized, the
     K = 1600 matrices stay f32): phase 4's 16 requests on the ring
     (exact-length prefill); one prefill pass and two decode steps with
     every launch held and counted exactly (32 LUT-GEMV and 32 attentions
     per step); the step's device time as a graph and its eager wall, its
     f32 matmuls and its G 5 attentions as graphs.  (b) xlstm_350m the same
     way (139 LUT-GEMV per step, no attention; w_if at N 8), the share of
     its mLSTM state updates in the step, and the requests again under
     uniform:4a8 with every int LUT-GEMV launch held.  (c)
     phi_3_vision_4_2b: phase 4's requests text-only on the ring and the
     paged pool (tokens equal); 8 lanes through lm.prefill after 576
     seeded prefix embeddings, then 32 greedy steps, every launch held and
     counted (225 and 32 per step); the prefill and the step timed.  (d)
     whisper_large_v3 (32 + 32 layers) through models/encdec.py:
     serve_prefill over 8 x 1500 seeded frames, then 32 greedy
     serve_decode_step calls, every launch held and counted (256 LUT-GEMV
     and 32 ring + 32 lengths-mode attentions per step); the encoder pass,
     the step, the 32 cross-attentions as a graph beside their bound and
     SDPA, and the LUT-GEMV at the encoder's M 12000.  (e) each config cut
     to 2 layers (xlstm: one super-block of 4; whisper: 2 + 2) card
     against CPU on phase 3's prompts (phi with the prefix; whisper on 2 x
     1500 frames and 4 steps): f32 KV every pass at phase 3's tolerance,
     int8 KV the prefill (whisper: the cross K/V) and the tokens.  Decode
     attention at hymba's shape and at whisper's cross-attention (f32,
     lengths mode, S 1500) beside its plain version, SDPA and its bound.
 13. train — (a) tinymistral_248m at full width and depth (248M parameters,
     f32, remat) trains 20 steps of B 8 x T 512 on SyntheticLM through
     build_train_step and TrainLoop: every loss finite and the mean of the
     last 5 below the first 5's; the median step's eager wall time and
     device span (CUDA events), tokens/s, the step's f32 operations
     against the 67 TFLOP/s peak, max_memory_allocated.  (b) 2 layers of
     the same width, B 2 x T 128, 3 steps from the same weights on the card
     and on the CPU: losses and grad norms within 1e-5 relative, step 1's
     gradients within 1e-4 of each leaf's max.  (c) 2 layers: 4 steps with
     checkpoints every 2, then a new loop restores and runs to step 8; its
     losses against one uninterrupted 8-step run's within 1e-6 relative.
     (d) the tree trained in (a) served by the engine under uniform:4 (ring,
     int8 KV, 8 requests of 16 new tokens), every launch held and counted
     exactly per decode step and prefill pass; its 2-layer cut card against
     CPU as in phase 11.  (e) the reference's defaults at train_4k: the
     training losses' chunked attention against the one-pass form at T
     4096, B 2 (values and gradients within 2e-5 of max(1, |max|), each
     form's time and peak memory): tinymistral's heads over its window of
     4096 (the full sweep) and hymba's over its window of 1024 (the band);
     then build_train_step(cfg, None) for tinymistral at full width and
     depth with every argument at the reference's defaults (bf16 compute,
     auto_microbatches' 16 microbatches), one step on 16 rows x 4097
     tokens (a cut of train_4k's 256 rows: one row a microbatch), and the
     same step at bf16_compute=False: the loss calls and their rows, both
     losses finite, the masters f32, the losses within 2e-2; each step's
     time, peak memory, f32 operations and kernel launches (none).
 14. dist — (a) the model of phase 13 trained data-parallel by two gloo
     ranks spawned on the one card (FSDP, B 8 x T 512 global, phase 13's
     batches and schedule), 3 steps to a checkpoint written by rank 0 and
     one step more, against the one-device step from the same init:
     losses, nll and grad norms within 1e-5 relative, the checkpoint's
     parameters within 1e-4 of each leaf's max; each step's wall time, its
     all-reduces' time and bytes, max_memory_allocated per rank.  (b) the
     compressed all-reduce on CUDA tensors over the two ranks, two rounds
     with error feedback: codes and error state bit-equal to its plain
     computation on the CPU, the mean within one f32 ulp.  (c) rank 0 saves
     the checkpointed tree quantized under the engine's uniform:4 plan; it
     restores from the raw template alone bit-equal to the same tree
     quantized in memory, with the engine's plan, and serves phase 13's
     requests with the in-memory tree's tokens, every launch held and
     counted exactly; its 2-layer cut under a mixed plan with activation
     bits restores with its two segments and abits and runs card against
     CPU with equal tokens (the int LUT-GEMV launched).  (d) the dp=2
     checkpoint resumes on one device; its next step within 1e-5 of the
     dp=2 run's.  (e) the model of (a) trained tensor-parallel at mesh
     (1, 2): two gloo ranks on the one card, 3 steps of (a)'s batches to a
     checkpoint written by rank 0 (gathered over both axes), against (a)'s
     one-device steps from the same init: losses, nll and grad norms within
     1e-5 relative, the parameter updates under (a)'s check, the leaves
     the model axis leaves whole (the final norm) bit-equal on both ranks;
     each step's wall time, its all-reduces' time and bytes by kind (the
     activations' sums, the vocabulary and norm gathers, the data axis),
     max_memory_allocated per rank.  (f) the same at (2, 2), four ranks
     with FSDP, cut to 2 layers, against the one-device run of the cut;
     its checkpoint resumes on one device, the next step within 1e-5 of
     the uninterrupted one-device run's.  (g) the other decoders that
     train tensor-parallel, at (1, 2) as in (e), each against its
     one-device run from the same init: granite (MoE: experts split on F,
     router gathered) at full width and depth, 3 steps of B 8 x T 512;
     starcoder2 (attention biases sharded with their heads) at full width
     cut to 1 layer (its attention biases drawn nonzero), 2 steps of B 4
     x T 512; no checkpoint (each rank's slices and first moment come back
     as a file).  The ranks run first; the one-device run then routes by
     their top-k experts, since a summation order that moves a router
     logit by an ulp flips a near-tie (the tokens whose own top-k differs,
     and their largest logit margin, are counted).  (e)'s checks and
     figures (a key bias's updates held through its first moment:
     KEY_BIAS), the all-reduces also by the routing weights' gradient,
     granite's routing equal on both ranks, and the kernels the steps
     launched (none).
 15. examples — each ``examples_torch/*.py`` imported by path and called
     in-process (nothing rebuilt), every kernel launch counted exactly and
     held against its plain version.  (a) quickstart on the card: sections
     1, 4 and 5 the CPU run's characters, section 2's three LUT-GEMV
     launches (M 8, b 2 / 4 / 8) and section 3's int_to_f32 launch (10000
     elements, n 25, bit-equal to ``.float()``).  (b) serve_batched at the
     smoke config on the card and on the CPU from one tree (greedy tokens
     equal, or a parting at a near-tie by phase 10's rule), under
     ``--plan uniform:4a8`` (the int LUT-GEMV), and ``--full``:
     tinymistral_248m at full width and depth, 8 requests x 16 tokens,
     timed (tokens/s, TTFT, compression, peak memory), then served again
     on the same engine under the holds with the same tokens; launches
     exact per decode step and prefill pass.  (c) quantize_and_eval at its
     defaults, card against CPU from one initial tree: every eval loss
     within EX_QE_TOL, the compression column equal, the LUT-GEMV launched
     14 times a quantized forward at M 512 (again under ``--nf``).  (d)
     train_lm's tiny preset 40 steps to a checkpoint (the loss goes
     down), resumed to 60 (its last loss within EX_RESUME_RTOL of an
     uninterrupted run's), and the 100m preset for 3 steps (8
     microbatches from ``auto_microbatches``; step time, peak memory);
     no kernel launched.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Exits nonzero without a
result when no CUDA device is visible.  Longer output (compiler log, the
result as JSON) goes to ``build/chip_smoke/``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import warnings

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


def attn_inputs(torch, gen, s, b=ATTN_B, kvh=ATTN_KV, g=ATTN_G, d=ATTN_D):
    """Random q and K/V of ``s`` slots, by default at tinymistral's widths:
    f32 and int8 with scales."""
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
             (((1 << 23) + 5,), 3), ((10000,), 0))   # the last: quickstart's
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

# phases 3-10 serve tinymistral_248m at its full width cut to this many of
# its 12 layers: their eager decode steps are host-bound, so a run's time
# grows with the depth, and at 12 layers the script passed 1000 s
SERVE_LAYERS = 4


def serving_model(device):
    """Phases 3-10's model: tinymistral_248m (random weights, seed 0) at full
    width, its first SERVE_LAYERS layers; (cfg, raw tree)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.models import lm
    cfg = C.get_config("tinymistral_248m")
    raw = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    raw, cfg = cut_layers(raw, cfg, SERVE_LAYERS)
    return cfg, raw


def full_model(rt):
    if "raw" not in rt:
        rt["cfg"], rt["raw"] = serving_model("cuda")
    return rt["cfg"], rt["raw"]


def run_greedy(torch, lm, params, cfg, toks, lengths, steps, device,
               quant_kv=True, prefix=None, cache_len=512):
    if prefix is not None:
        prefix = prefix.to(device)
    logits, cache = lm.prefill(params, toks, cfg, cache_len, quant_kv,
                               lengths, device=device, prefix_embeds=prefix)
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
            # prefill and 4 decode steps, each layer's 7 weight matmuls
            # and lm_head each
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

    def noisy(x, bits, k_sharded=False):
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype)
        return quantize(x * (1 + 1e-7 * noise), bits, k_sharded)

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
        # the step's attention launches (one a layer) as one graph (no
        # flush, as the LUT-GEMV's step graph in phase 2) on the engine's
        # own cache and positions
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
    and none through ring mode, the weight matmuls (7 a layer and
    lm_head) through the f32 LUT-GEMV and none through the int one."""
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
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import map_tensors
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

    # run C: copy-on-write.  Two requests with one 37-token prompt share
    # all three of its blocks, the third partly filled; the first decode
    # write into it copies it (append_slot returns "cow"), and sampling
    # (T 0.7) makes the two write different tokens into their own copies.
    # The CPU serves the card engine's quantized tree as given
    # (quantize=False) through the plain versions
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 37).tolist()
    fields = dict(PAGED, kv_pool_blocks=32, temperature=0.7, seed=7)
    eng = Engine(raw, cfg, EngineConfig(**fields), device="cuda")
    got, counts, dt = serve_counted(torch, eng, [prompt, prompt], max_new=8)
    st = eng.stats()
    pool = st["block_pool"]
    check_paged_launches("run C", st, counts, cfg)
    del fields["plan"]
    cpu_eng = Engine(map_tensors(eng.params, lambda t: t.cpu()), cfg,
                     EngineConfig(**fields, quantize=False), device="cpu")
    del eng
    cpu_uids = [cpu_eng.submit(p, max_new_tokens=8) for p in (prompt, prompt)]
    cpu_eng.run()
    want = {u: cpu_eng.completions[u].tokens for u in cpu_uids}
    cpu_pool = cpu_eng.stats()["block_pool"]
    del cpu_eng
    log(f"[paged] run C (copy-on-write: 2 requests of one 37-token prompt, "
        f"T 0.7): pool {pool}; tokens card {got}, CPU {want}")
    if pool["cow_count"] == 0 or cpu_pool["cow_count"] != pool["cow_count"]:
        fail(f"paged run C: cow_count {pool['cow_count']} on the card, "
             f"{cpu_pool['cow_count']} on the CPU (need equal and > 0)")
    if got != want or len(set(map(tuple, got.values()))) != 2:
        fail("paged run C: card tokens differ from the CPU's, or the two "
             "requests did not diverge")
    res["C"] = dict(tokens=got, cpu_tokens=want, launches=counts,
                    block_pool=pool)

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
# plan S's three segments of the SERVE_LAYERS layers
SEGMENTS = ((0, 1), (1, 3), (3, 4))
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
    still count the kernel's launches only.  ``cache=False`` dequantizes
    the weight at each launch instead (a 7B model's f32 weights would
    take 26 GB)."""

    def __init__(self, torch, name, cache=True):
        from repro_torch.kernels.lut_gemv import ops
        self.ops, self.torch, self.name = ops, torch, name
        self.calls = collections.Counter()
        self.err = {"f32": 0.0, "int": 0.0}
        self._w, self._cache = {}, cache

    def _weight(self, qt):
        from repro_torch.core.quant import dequantize
        if not self._cache:
            return dequantize(qt)
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

        def f32(x, qt, plan_rows=None):
            y = self.f32(x, qt, plan_rows)
            self._check("f32", y, torch.matmul(x, self._weight(qt)),
                        f"b{qt.bits} x {tuple(x.shape)} N={qt.n}")
            self.calls[(qt.bits, 0)] += 1
            return y

        def int_(xq, xs, qt, abits, plan_rows=None):
            y = self.int(xq, xs, qt, abits, plan_rows)
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
# the live replan's and the SLO solve's depth (phase 7 (d), (e))
LIVE_LAYERS = 3


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
    from repro_torch.models.sail_linear import map_tensors
    raw2, cfg2 = cut_layers(raw, cfg, 2)
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
    log(f"[planner] live replan at full width, {cfg.n_layers} layers, after "
        f"8 decode iterations (iteration "
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
        layers=cfg.n_layers,
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
    log(f"[planner] auto:q4a8,slo={target:.1f} at {cfg.n_layers} layers "
        f"priced on the fitted machine "
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
        slo_meets=result.meets_slo, slo_solve_seconds=t_solve,
        slo_layers=cfg.n_layers)


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
        # the CPU's dequantization taken from the card (bit-equal, checked)
        with CardDequant(torch):
            cl, ct = run_greedy(torch, lm, cpu_params, cfg, toks, lengths, 4,
                                "cpu", quant_kv=qkv)
            if name == "A8":
                pl = run_perturbed(torch, lm, cpu_params, cfg, toks, lengths)
        err = (gl - cl).abs().max().item()
        rec = dict(logits_err=err, tokens_equal=bool(torch.equal(gt, ct)),
                   held=sum(held.calls.values()), held_err=dict(held.err))
        noise = ""
        if name == "A8":
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
        if not torch.isfinite(gl).all() or rec["held"] < 5 * (
                (len(MATMULS) - 1) * cfg.n_layers + 1):
            fail(f"plan {name}: card logits not finite, or only "
                 f"{rec['held']} LUT-GEMV launches held")
        if name == "Q4" and not (rec["tokens_equal"] and torch.allclose(
                gl, cl, rtol=MODEL_RTOL, atol=MODEL_ATOL)):
            fail(f"plan Q4: card and CPU differ (logits {err:.3e}, tokens "
                 f"equal {rec['tokens_equal']})")
        res["card_vs_cpu"][name] = rec

    # (c) probe parity at full width, 2 layers
    probe_parity(torch, sens, raw, cfg, base, res)

    # (d) live replan and (e) the cost model refit on the card, with its SLO
    # solve, at full width cut to LIVE_LAYERS layers: A8 solved again there
    # (the joint solve's time grows with the units: 85 at 12 layers took
    # 57 s on the card's host)
    raw_cut, cfg_cut = cut_layers(raw, cfg, LIVE_LAYERS)
    planner_cut, r_cut = solve_on_card(
        torch, planning.Planner, base, raw_cut, cfg_cut, "auto:q4a8,kv=auto",
        res, f"A8 at {LIVE_LAYERS} layers")
    live_replan(torch, planning, Engine, EngineConfig, raw_cut, cfg_cut,
                r_cut.spec, planner_cut, prompts, res)
    cost_calibration(torch, planning, raw_cut, cfg_cut, base, planner_cut,
                     res)


# ---------------------------------------------------------------------------
# phase 8: temperature sampling, run-to-completion, unquantized serving
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.7, seed=7)
RING = {k: v for k, v in PAGED.items() if k != "kv_block_size"}
# the sampled noise is held at its own scale: |d| <= 4 ulp of f32 at
# max(|g|, 1) (where -log(-log u) nears 0, one ulp of the inner log is
# thousands of ulps of the result)
GUMBEL_ULP = 4


class CountByM:
    """Within the block, counts the f32 LUT-GEMV's launches by the rows M
    of their activations (the launch itself is unchanged)."""

    def __init__(self):
        from repro_torch.kernels.lut_gemv import ops
        self.ops, self.by_m = ops, collections.Counter()

    def __enter__(self):
        self.f32 = self.ops.lut_matmul_cuda

        def f32(x, qt, plan_rows=None):
            self.by_m[int(x.shape[0])] += 1
            return self.f32(x, qt, plan_rows)
        self.ops.lut_matmul_cuda = f32
        return self

    def __exit__(self, *exc):
        self.ops.lut_matmul_cuda = self.f32
        return False


def check_ring_launches(name, st, counts, cfg, lut, other):
    """Every decode step: each layer's attention through ring mode (none
    through table mode), the weight matmuls (7 a layer and lm_head)
    through ``lut`` and none through ``other``."""
    steps = st["decode_iterations"]
    need_lut = steps * ((len(MATMULS) - 1) * cfg.n_layers + 1)
    if (counts["decode_attention"] < steps * cfg.n_layers
            or counts["decode_attention_table"] or counts[lut] < need_lut
            or counts[other]):
        fail(f"{name}: decode_attention {counts['decode_attention']} (need "
             f">= {steps * cfg.n_layers}, table mode "
             f"{counts['decode_attention_table']} of them), {lut} "
             f"{counts[lut]} (need >= {need_lut}), {other} {counts[other]} "
             "(need 0)")


def noise_ulps(np, got, want) -> float:
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    return float((np.abs(got.astype(np.float64) - want.astype(np.float64))
                  / scale).max())


def phase_sampling(rt):
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import map_tensors
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    res = rt["sampling"] = {"runs": {}}
    prompts = engine_requests(cfg)
    greedy = rt["ring_tokens"]["uniform:4"]
    u4_step = rt["engine"]["uniform:4"]["step_device_ms"]

    def record(name, eng, got, counts, dt):
        st = eng.stats()
        if (len(got) != len(prompts) or any(len(t) != 32 for t in got.values())
                or any(not 0 <= tok < cfg.vocab for t in got.values()
                       for tok in t)):
            fail(f"{name}: expected {len(prompts)} completions of 32 tokens "
                 "in the vocabulary")
        res["runs"][name] = dict(
            tokens=st["generated_tokens"], seconds=dt,
            decode_tok_per_s=st["measured_tps"],
            decode_steps=st["decode_iterations"],
            prefill_steps=st["prefill_iterations"], launches=counts)
        log(f"[sampling] {name}: {st['generated_tokens']} tokens in {dt:.3f} "
            f"s over {st['decode_iterations']} decode and "
            f"{st['prefill_iterations']} prefill steps; launches {counts}")
        return st

    # (a) sampled serving: ring, paged (phase 5 run A's admission), and the
    # ring under uniform:4a8 (the int LUT-GEMV serves a sampled run)
    runs = {}
    for name, fields in (("ring T0.7", RING),
                         ("paged T0.7", dict(PAGED, kv_pool_blocks=8 * 32,
                                             share_prefix=False)),
                         ("ring uniform:4a8 T0.7",
                          dict(RING, plan="uniform:4a8"))):
        eng = Engine(raw, cfg, EngineConfig(**fields, **SAMPLED),
                     device="cuda")
        got, counts, dt = serve_counted(torch, eng, prompts)
        st = record(name, eng, got, counts, dt)
        if eng.paged:
            check_paged_launches(name, st, counts, cfg)
        elif "4a8" in name:
            check_ring_launches(name, st, counts, cfg, "lut_matmul_int",
                                "lut_matmul")
        else:
            check_ring_launches(name, st, counts, cfg, "lut_matmul",
                                "lut_matmul_int")
            sampler_eng = eng
        runs[name] = got
    ring, paged = runs["ring T0.7"], runs["paged T0.7"]
    same = sum(paged[u] == ring[u] for u in ring)
    off_greedy = sum(ring[u] != greedy[u] for u in ring)
    log(f"[sampling] T 0.7, seed 7: {same} of 16 paged completions equal the "
        f"ring engine's; {off_greedy} of 16 differ from greedy (phase 4)")
    if paged != ring:
        fail(f"sampled paged tokens differ from the ring engine's ({same} of "
             "16 equal)")
    if off_greedy == 0:
        fail("sampled tokens equal greedy for every request")
    res.update(paged_equal_ring=same, differ_from_greedy=off_greedy)

    # (b) the draw itself: logits of one full-pool step of the sampled ring
    # engine, the same uids and indices on the card and on the CPU
    tok = torch.as_tensor(sampler_eng._cur[:, None], device="cuda")
    logits, _ = lm.decode_step(sampler_eng.params, tok, sampler_eng.cache,
                               cfg, quant_kv=True, device="cuda")
    del sampler_eng
    uids = np.arange(9, 17, dtype=np.int64)
    index = np.array([32, 5, 0, 70000, 31, 1, 2, 3], np.int64)
    card = prng.draw_rows(logits, uids, index, 7, 0.7)
    cpu = prng.draw_rows(logits.cpu(), uids, index, 7, 0.7)
    plain = prng.draw_rows_np(logits.cpu().numpy(), uids, index, 7, 0.7)
    bits_equal = (torch.equal(card.bits.cpu(), cpu.bits) and bool(
        (cpu.bits.numpy().view(np.uint32) == plain.bits).all()))
    u_equal = (torch.equal(card.uniform.cpu().view(torch.int32),
                           cpu.uniform.view(torch.int32)) and bool(
        (cpu.uniform.numpy().view(np.uint32)
         == plain.uniform.view(np.uint32)).all()))
    g_ulp = noise_ulps(np, card.gumbel.cpu().numpy(), cpu.gumbel.numpy())
    g_ulp_plain = noise_ulps(np, card.gumbel.cpu().numpy(), plain.gumbel)
    toks_equal = (torch.equal(card.tokens.cpu(), cpu.tokens)
                  and bool((cpu.tokens.numpy() == plain.tokens).all()))
    k0, k1 = prng.row_keys(7, uids, index)
    keys = torch.from_numpy(np.stack([k0, k1], 1).view(np.int32)).cuda()
    draw_ms = timer(lambda: prng.draw_with_keys(logits, keys, 0.7))
    argmax_ms = timer(lambda: torch.argmax(logits, dim=-1))
    draw_call_ms = timer.call_ms(
        lambda: prng.draw_rows(logits, uids, index, 7, 0.7).tokens.cpu())
    log(f"[sampling] one draw over B 8 x V {cfg.vocab} (uids {uids.tolist()},"
        f" indices {index.tolist()}): words bit-equal card / CPU / numpy "
        f"{bits_equal}, uniforms bit-equal {u_equal}, Gumbel noise within "
        f"{g_ulp:.1f} ulp of the CPU's ({g_ulp_plain:.1f} of numpy's), "
        f"tokens equal {toks_equal} ({card.tokens.tolist()}); device "
        f"{draw_ms:.4f} ms as a graph ({100 * draw_ms / u4_step:.1f}% of a "
        f"full-pool uniform:4 step's {u4_step:.3f} ms; greedy argmax "
        f"{argmax_ms:.4f} ms), eager call with the host's keys and the copy "
        f"of the tokens {draw_call_ms:.3f} ms")
    if not (bits_equal and u_equal and toks_equal and g_ulp <= GUMBEL_ULP
            and g_ulp_plain <= GUMBEL_ULP):
        fail("the draw on the card differs from the CPU's")
    res["draw"] = dict(draw_device_ms=draw_ms, argmax_device_ms=argmax_ms,
                       draw_call_ms=draw_call_ms,
                       share_of_uniform4_step=draw_ms / u4_step,
                       gumbel_ulp_cpu=g_ulp, gumbel_ulp_numpy=g_ulp_plain,
                       tokens=card.tokens.tolist())
    del logits, card, cpu

    # (c) run-to-completion: phase 4's requests in cohorts of 8, greedy
    eng = Engine(raw, cfg, EngineConfig(**RING, mode="batch"), device="cuda")
    rows = Recorder(eng)
    with CountByM() as by:
        got, counts, dt = serve_counted(torch, eng, prompts)
    st = record("batch", eng, got, counts, dt)
    check_ring_launches("batch", st, counts, cfg, "lut_matmul",
                        "lut_matmul_int")
    # each cohort prefill: 9 launches a layer (wk, wv twice) at M =
    # cohort x its longest prompt, lm_head at M = cohort
    per_prefill = sum(expected_instances(eng.params, lm, 0, 1).values()) - 1
    want_m = collections.Counter()
    for c in range(0, len(prompts), 8):
        cohort = prompts[c:c + 8]
        want_m[len(cohort) * max(len(p) for p in cohort)] += per_prefill
    got_m = {m: by.by_m[m] for m in want_m}
    same = sum(got[u] == greedy[u] for u in greedy)
    log(f"[sampling] batch mode (2 cohorts of 8, one lm.prefill each, "
        f"unmasked decode over its ring cache): {same} of 16 completions "
        f"equal the continuous engine's (phase 4); decode attention "
        f"{counts['decode_attention']} launches in ring mode over "
        f"{st['decode_iterations']} steps; f32 LUT-GEMV launches by M "
        f"{dict(sorted(by.by_m.items()))}, at the cohort prefills' M "
        f"{got_m} (need {dict(want_m)})")
    # a cohort prefill runs the LUT-GEMV at other M than the continuous
    # engine's prefill groups (another K split, another summation order):
    # a request may part from it only at a near-tie, by phase 10's rule
    # against a continuous engine's logits on the same requests
    ties = {}
    parted = first_parting(got, greedy)
    if parted:
        del eng
        ref = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
        ref_rows = Recorder(ref)
        again, _, _ = serve_counted(torch, ref, prompts)
        if again != greedy:
            fail("batch mode: the continuous rerun's tokens differ from "
                 "phase 4's")
        del ref
        for uid, step_j in parted.items():
            tie = ties[str(uid)] = near_tie(torch, rows.rows, ref_rows.rows,
                                            int(uid), step_j)
            log(f"[sampling] batch mode: request {uid} parts at token "
                f"{step_j}: the continuous engine's top-2 gap "
                f"{tie['gap']:.3e}, batch vs continuous logits differ by "
                f"{tie['diff']:.3e} there and by {tie['err_before']:.3e} "
                "before")
            if not tie["explained"]:
                fail(f"batch mode: request {uid} parts from the continuous "
                     f"engine at token {step_j} and no near-tie explains it")
    if got_m != dict(want_m) or sum(by.by_m.values()) != counts["lut_matmul"]:
        fail("batch mode: LUT-GEMV launches at the cohort prefills' M "
             f"{got_m}, need {dict(want_m)}")
    res["runs"]["batch"].update(lut_launches_by_m=dict(by.by_m),
                                equal_to_continuous=same, near_ties=ties)
    eng = None

    # (d) unquantized: the raw f32 tree, int8 KV, phase 3's prompts and
    # steps (prefill + 4 decode steps), card against CPU
    toks, lengths = model_prompts(cfg)
    short = [toks[i, :n].tolist() for i, n in enumerate(lengths)]
    fields = dict(RING, quantize=False)
    del fields["plan"]
    eng = Engine(raw, cfg, EngineConfig(**fields), device="cuda")
    got, counts, dt = serve_counted(torch, eng, short, max_new=5)
    st = eng.stats()
    step_ms = step_device_ms(torch, timer, lm, eng, cfg)
    del eng
    cpu_eng = Engine(map_tensors(raw, lambda t: t.cpu()), cfg,
                     EngineConfig(**fields), device="cpu")
    cpu_uids = [cpu_eng.submit(p, max_new_tokens=5) for p in short]
    cpu_eng.run()
    want = {u: cpu_eng.completions[u].tokens for u in cpu_uids}
    del cpu_eng
    log(f"[sampling] quantize=False (f32 weights, plain matmuls), int8 KV, "
        f"prefill of phase 3's prompts + 4 decode steps: card {got}, CPU "
        f"{want}; launches {counts}; one full-pool step device "
        f"{step_ms:.3f} ms = {step_ms / u4_step:.3f} x uniform:4's "
        f"{u4_step:.3f} ms; weight compression {st['weight_compression']}, "
        f"plan {st['plan_hash']}")
    if got != want:
        fail("quantize=False: card and CPU greedy tokens differ")
    if (counts["decode_attention"] < st["decode_iterations"] * cfg.n_layers
            or counts["lut_matmul"] or counts["lut_matmul_int"]):
        fail(f"quantize=False: launches {counts}: decode attention must "
             "launch every step and the LUT-GEMV never")
    res["runs"]["quantize=False"] = dict(
        tokens=got, cpu_tokens=want, launches=counts,
        decode_steps=st["decode_iterations"], step_device_ms=step_ms,
        step_ratio_to_uniform4=step_ms / u4_step)


# ---------------------------------------------------------------------------
# phase 9: self-speculative decoding and the SLO controller
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_PLAN = f"uniform:4,draft=q2:k{SPEC_K}"
SPEC_INT_PLAN = f"uniform:4,draft=q2a8:k{SPEC_K}"
RUN_A = dict(PAGED, kv_pool_blocks=8 * 32, share_prefix=False)


def spec_launch_check(name, st, counts, by_m, inst, cfg, draft_key, paged):
    """Every round: the draft's k steps, a pass's LUT-GEMV launches (7 a
    layer and lm_head) each at M 8 under the draft's instance; verify's
    pass at M = 8 x (k + 1) under the served b4 instance; decode attention
    layers x k times for the draft and layers x (k + 1) for verify, all in
    ring or all in table mode."""
    rounds = st["speculative"]["rounds"]
    per_pass = (len(MATMULS) - 1) * cfg.n_layers + 1
    m_verify = 8 * (SPEC_K + 1)
    attn = rounds * cfg.n_layers * (2 * SPEC_K + 1)
    table = counts["decode_attention_table"]
    want_table = counts["decode_attention"] if paged else 0
    ok = (inst.get(draft_key, 0) == rounds * SPEC_K * per_pass
          and by_m.get(m_verify, 0) == rounds * per_pass
          and counts["decode_attention"] == attn and table == want_table)
    log(f"[speculation] {name}: {rounds} rounds; LUT-GEMV launches per "
        f"instance { {instance_name(k): v for k, v in sorted(inst.items())} }"
        f", f32 flavour by M {dict(sorted(by_m.items()))} (verify at M "
        f"{m_verify}: {by_m.get(m_verify, 0)}, need {rounds * per_pass}; "
        f"draft {instance_name(draft_key)}: {inst.get(draft_key, 0)}, need "
        f"{rounds * SPEC_K * per_pass}); decode attention "
        f"{counts['decode_attention']} (need {attn} = rounds x "
        f"{cfg.n_layers} x (2k + 1))"
        f", {table} in table mode")
    if not ok:
        fail(f"{name}: launches do not match the rounds run")


def serve_spec(torch, Engine, EngineConfig, raw, cfg, name, fields, prompts,
               max_new=32):
    """Serve ``prompts`` under ``fields`` with the counters reset just
    before and LUT-GEMV launches counted by M; returns (engine, tokens,
    counts, by_m, instances, seconds, truncates that dropped a block)."""
    from repro_torch.kernels import _build
    eng = Engine(raw, cfg, EngineConfig(**fields), device="cuda")
    dropped = []
    if eng.paged:
        truncate = eng.block_mgr.truncate

        def spy(uid, n):
            out = truncate(uid, n)
            if out:
                dropped.append(out)
            return out
        eng.block_mgr.truncate = spy
    with CountByM() as by:
        got, counts, dt = serve_counted(torch, eng, prompts, max_new)
        inst = dict(_build.lut_instances)
    if (len(got) != len(prompts)
            or any(len(t) != max_new for t in got.values())
            or any(not 0 <= tok < cfg.vocab for t in got.values()
                   for tok in t)):
        fail(f"{name}: expected {len(prompts)} completions of {max_new} "
             "tokens in the vocabulary")
    return eng, got, counts, dict(by.by_m), inst, dt, dropped


def verify_vs_decode(torch, lm, eng, cfg):
    """Verify's rows against the decode step's on the same cache: five
    tokens per lane through one verify_step (M 40) and through five
    decode steps (M 8) from two copies of the engine's pool.  Returns
    (bit-equal, max abs difference)."""
    def copy(cache):
        return {"length": cache["length"].clone(),
                "layers": {n: a.clone() for n, a in cache["layers"].items()}}
    base = copy(eng.cache)
    base["length"] = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab, (8, SPEC_K + 1), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(9))
    vl, vcache = lm.verify_step(eng.params, toks, copy(base), cfg,
                                quant_kv=True, device="cuda")
    dcache, rows = copy(base), []
    for t in range(SPEC_K + 1):
        dl, dcache = lm.decode_step(eng.params, toks[:, t:t + 1], dcache, cfg,
                                    quant_kv=True, device="cuda")
        rows.append(dl)
    dl = torch.stack(rows, 1)
    same = torch.equal(vl, dl) and all(
        torch.equal(vcache["layers"][n], dcache["layers"][n])
        for n in vcache["layers"])
    return same, (vl - dl).abs().max().item()


def verify_attention_err(torch, blk, eng, cfg):
    """Verify's per-token decode attention (the kernel, ring mode, at
    position + t) against the reference's chunk-causal composite on the
    engine's dequantized cache, lanes at positions 40-100: max abs err."""
    from repro_torch.core.quant import dequantize_kv
    from repro_torch.kernels.decode_attn.ops import decode_attention_ring
    layers = eng.cache["layers"]
    k = dequantize_kv(layers["k"][0], layers["k_scale"][0])
    v = dequantize_kv(layers["v"][0], layers["v_scale"][0])
    gen = torch.Generator("cuda").manual_seed(3)
    q = torch.randn((8, SPEC_K + 1, cfg.n_heads, cfg.head_dim),
                    device="cuda", generator=gen)
    pos = torch.arange(40, 104, 8, dtype=torch.int32, device="cuda")
    got = torch.stack([decode_attention_ring(
        q[:, t].contiguous(), layers["k"][0], layers["v"][0], pos + t,
        cfg.window or 512, layers["k_scale"][0], layers["v_scale"][0])
        for t in range(SPEC_K + 1)], 1)
    want = blk._verify_attend(q, k, v, pos, cfg, k.shape[1])
    return (got - want).abs().max().item()


def phase_speculation(rt):
    import dataclasses

    import torch
    from repro_torch import planning
    from repro_torch.kernels import _build
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, _walk, \
        map_tensors
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw = full_model(rt)
    timer = Timer(torch)
    res = rt["speculation"] = {"runs": {}}
    prompts = engine_requests(cfg)
    greedy = rt["ring_tokens"]["uniform:4"]

    def record(name, eng, got, counts, by_m, inst, dt, dropped):
        st = eng.stats()
        sp = st["speculative"]
        res["runs"][name] = dict(
            tokens=st["generated_tokens"], seconds=dt,
            decode_tok_per_s=st["measured_tps"],
            rounds=st["decode_iterations"],
            prefill_steps=st["prefill_iterations"], launches=counts,
            lut_launches_by_m=by_m,
            instances={instance_name(k): v for k, v in sorted(inst.items())},
            speculative=sp, truncates_dropping_blocks=len(dropped),
            equal_to_greedy=sum(got[u] == greedy.get(u) for u in got))
        log(f"[speculation] {name}: {st['generated_tokens']} tokens in "
            f"{dt:.3f} s, decode {st['measured_tps']:.1f} tok/s over "
            f"{st['decode_iterations']} rounds; "
            + (f"{sp['accepted']} of {sp['drafted']} drafts accepted "
               f"({sp['acceptance_rate']:.3f}); " if sp else "")
            + f"{res['runs'][name]['equal_to_greedy']} of 16 completions "
            "equal plain greedy (phase 4)"
            + (f"; {len(dropped)} truncates dropped "
               f"{sum(dropped)} blocks" if eng.paged else ""))
        return st

    # (a) greedy speculation on the ring and the paged pool (run A's
    # admission)
    for name, fields in (("ring q2:k4", RING), ("paged q2:k4", RUN_A)):
        eng, got, counts, by_m, inst, dt, dropped = serve_spec(
            torch, Engine, EngineConfig, raw, cfg, name,
            dict(fields, plan=SPEC_PLAN), prompts)
        st = record(name, eng, got, counts, by_m, inst, dt, dropped)
        sp = st["speculative"]
        spec_launch_check(name, st, counts, by_m, inst, cfg, (2, 0),
                          eng.paged)
        if got != greedy:
            bad = [u for u in greedy if got[u] != greedy[u]]
            fail(f"{name}: tokens differ from plain greedy decoding for "
                 f"requests {bad}")
        if not sp["accepted"] < sp["drafted"]:
            fail(f"{name}: no draft was rejected: no rollback ran")
        if eng.paged:
            if not dropped:
                fail(f"{name}: no rollback truncate dropped a block")
            eng.block_mgr.check_invariants()
        else:
            ring_eng = eng
        del eng

    # verify's rows are the decode step's, bit for bit: why greedy
    # speculation commits plain decoding's tokens on the card
    same, diff = verify_vs_decode(torch, lm, ring_eng, cfg)
    attn_err = verify_attention_err(torch, blk, ring_eng, cfg)
    log(f"[speculation] verify_step of 5 tokens x 8 lanes (LUT-GEMV at M 40, "
        f"K split as at M 8) against 5 decode steps on copies of one pool: "
        f"logits and KV bit-equal {same} (max abs diff {diff:.3e}); its "
        f"per-token attention against the chunk-causal composite: max abs "
        f"err {attn_err:.3e}")
    if not same:
        fail("verify rows differ from the decode step's")
    if attn_err > ATTN_TOL:
        fail(f"verify attention differs from the composite by {attn_err:.3e}")
    res.update(verify_bit_equal_decode=same, verify_attention_err=attn_err)
    del ring_eng

    # (b) an int draft (q2a8) under the f32 b4 verify
    name = "ring q2a8:k4"
    eng, got, counts, by_m, inst, dt, dropped = serve_spec(
        torch, Engine, EngineConfig, raw, cfg, name,
        dict(RING, plan=SPEC_INT_PLAN), prompts)
    st = record(name, eng, got, counts, by_m, inst, dt, dropped)
    spec_launch_check(name, st, counts, by_m, inst, cfg, (2, 8), False)
    if got != greedy:
        fail(f"{name}: tokens differ from plain greedy decoding")
    if counts["lut_matmul_int"] != inst.get((2, 8), 0):
        fail(f"{name}: int LUT-GEMV launches outside the draft")
    del eng

    # (c) sampled speculation at T 0.7: ring equal to paged, every ring
    # LUT-GEMV launch held against its plain version; phase 3's prompts
    # and steps with greedy speculation, card against CPU
    runs = {}
    for name, fields in (("ring q2:k4 T0.7", RING),
                         ("paged q2:k4 T0.7", RUN_A)):
        with (Held(torch, name) if not fields.get("kv_block_size")
              else contextlib.nullcontext()) as held:
            eng, got, counts, by_m, inst, dt, dropped = serve_spec(
                torch, Engine, EngineConfig, raw, cfg, name,
                dict(fields, plan=SPEC_PLAN, **SAMPLED), prompts)
        st = record(name, eng, got, counts, by_m, inst, dt, dropped)
        if not eng.paged:
            if sum(held.calls.values()) != counts["lut_matmul"]:
                fail(f"{name}: {sum(held.calls.values())} launches held of "
                     f"{counts['lut_matmul']}")
            res["runs"][name]["held_err"] = dict(held.err)
            log(f"[speculation] {name}: all {counts['lut_matmul']} LUT-GEMV "
                f"launches (verify's at M 40 with decode's K split) within "
                f"rtol {F32_RTOL} / atol {F32_ATOL} of their plain version "
                f"(max abs err {held.err['f32']:.3e})")
        spec_launch_check(name, st, counts, by_m, inst, cfg, (2, 0),
                          eng.paged)
        runs[name] = got
        del eng
    ring, paged = runs["ring q2:k4 T0.7"], runs["paged q2:k4 T0.7"]
    same_rp = sum(ring[u] == paged[u] for u in ring)
    off_greedy = sum(ring[u] != greedy[u] for u in ring)
    log(f"[speculation] T 0.7, seed 7: {same_rp} of 16 paged completions "
        f"equal the ring's; {off_greedy} of 16 differ from greedy")
    if ring != paged or off_greedy == 0:
        fail("sampled speculation: ring and paged differ, or equal greedy")
    # at full width cut to 2 layers: the CPU's plain LUT-GEMV dequantizes
    # each weight per call, and a round is k + 1 passes
    toks, lengths = model_prompts(cfg)
    short = [toks[i, :n].tolist() for i, n in enumerate(lengths)]
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    raw2 = dict(raw)
    raw2["blocks"] = _walk(raw["blocks"], lambda _, x: x[:2].contiguous())
    card_eng = Engine(raw2, cfg2, EngineConfig(**dict(RING, plan=SPEC_PLAN)),
                      device="cuda")
    card_uids = [card_eng.submit(p, max_new_tokens=5) for p in short]
    card_eng.run()
    card = {u: card_eng.completions[u].tokens for u in card_uids}
    del card_eng
    t0 = time.perf_counter()
    cpu_eng = Engine(map_tensors(raw2, lambda t: t.cpu()), cfg2,
                     EngineConfig(**dict(RING, plan=SPEC_PLAN)), device="cpu")
    cpu_uids = [cpu_eng.submit(p, max_new_tokens=5) for p in short]
    cpu_eng.run()
    cpu = {u: cpu_eng.completions[u].tokens for u in cpu_uids}
    cpu_sp = cpu_eng.stats()["speculative"]
    cpu_s = time.perf_counter() - t0
    del cpu_eng
    log(f"[speculation] phase 3's prompts, 5 tokens, greedy {SPEC_PLAN}, "
        f"full width at 2 layers: "
        f"card {card}, CPU {cpu} (CPU {cpu_sp['rounds']} rounds, "
        f"{cpu_sp['accepted']} of {cpu_sp['drafted']} drafts accepted, "
        f"{cpu_s:.1f} s with the quantization)")
    if card != cpu:
        fail("greedy speculation: card and CPU tokens differ")
    res.update(sampled_paged_equal_ring=same_rp,
               sampled_differ_from_greedy=off_greedy,
               card_vs_cpu=dict(card=card, cpu=cpu))

    # (d) draft=auto solved on the card: the measured acceptance of bits
    # 2-4 and the pick, held to the port's own pricing grid
    base = QuantPolicy(bits=4, group_size=128, min_size=1024)
    t0 = time.perf_counter()
    planner = planning.Planner(raw, cfg, "uniform:4,draft=auto", base=base)
    solved = planner.solve().spec
    solve_s = time.perf_counter() - t0
    acc = {bits: planner._draft_acceptance[(bits, None)]
           for bits in planner.DRAFT_BITS_GRID}
    policy = planning.PlanSpec.parse("uniform:4").to_policy(base)
    cost = planner.cost
    fixed = planner.fixed_bytes()
    units = planning.policy_units(raw, policy)
    plain_tps = cost.batch / cost.iteration_seconds(
        cost.cycles(units), cost.qbytes(units, 128) + fixed)
    grid = {}
    for bits, alpha in acc.items():
        d_units = planning.policy_units(raw, QuantPolicy(
            bits=bits, group_size=128, min_size=1024))
        for k in planner.DRAFT_K_GRID:
            secs = planning.speculative_round_seconds(cost, units, d_units,
                                                      128, fixed, k)
            grid[(bits, k)] = cost.batch * planning.expected_tokens_per_round(
                alpha, k) / secs
    best = max(grid, key=grid.get)
    want = (None if grid[best] < plain_tps * planner.DRAFT_MIN_GAIN
            else best)
    got_pick = (None if solved.draft is None
                else (solved.draft.weight_bits, solved.draft.k))
    eng = Engine(raw, cfg, EngineConfig(
        **dict(RING, plan="uniform:4,draft=auto")), device="cuda")
    log(f"[speculation] draft=auto on the card ({solve_s:.1f} s): measured "
        f"acceptance {acc} (teacher-forced, 32 tokens after the 32-token "
        f"calibration prompt); pick {solved.draft} = the grid's argmax "
        f"{want} (best modeled {grid[best]:.0f} tok/s at (bits, k) {best} "
        f"against plain {plain_tps:.0f} tok/s on the SAIL machine model, "
        f"gain needed {planner.DRAFT_MIN_GAIN}); the engine serves plan "
        f"{eng.plan.format()}")
    if got_pick != want or eng.plan != solved:
        fail(f"draft=auto: pick {got_pick}, the grid's argmax {want}, engine "
             f"plan {eng.plan.format()}")
    res["draft_auto"] = dict(acceptance=acc, pick=got_pick,
                             grid_argmax=list(best),
                             grid_best_tps_sail_model=grid[best],
                             plain_tps_sail_model=plain_tps, seconds=solve_s)
    del eng

    # (e) the controller: an SLO the 8-lane pool cannot meet on the ring,
    # and the free-block bound on a paged pool of 32 blocks
    probe = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
    slo = probe.planned_tps() * 1.5
    del probe
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the engine warns: SLO not met
        eng, got, counts, by_m, inst, dt, _ = serve_spec(
            torch, Engine, EngineConfig, raw, cfg, "controller ring",
            dict(RING, slo=slo, controller=True), prompts)
    c = eng.stats()["controller"]
    log(f"[speculation] controller, ring, SLO {slo:.0f} tok/s (1.5 x the "
        f"plan's modeled at 8 lanes): batch cap {c['batch_cap']}, shed "
        f"{c['shed']}, shrink {c['shrink']}, {c['checks']} drift checks "
        f"(replan {c['replan']}, skipped {c['skipped']}); peak active "
        f"{eng.peak_active}; {sum(got[u] == greedy[u] for u in greedy)} of 16"
        f" completions equal the uncontrolled run's")
    if not (c["batch_cap"] < 8 and c["shed"] > 0 and eng.peak_active
            <= c["batch_cap"]) or got != greedy:
        fail("controller: no shedding under an infeasible SLO, or the "
             "tokens changed")
    res["controller_ring"] = dict(c, peak_active=eng.peak_active,
                                  decode_tok_per_s=eng.stats()["measured_tps"],
                                  launches=counts)
    del eng
    eng = Engine(raw, cfg, EngineConfig(**PAGED, kv_pool_blocks=32,
                                        controller=True), device="cuda")
    caps = []
    batch_cap = eng.controller.batch_cap

    def spy(pool, free_cap=None):
        cap = batch_cap(pool, free_cap=free_cap)
        caps.append((free_cap, cap))
        return cap
    eng.controller.batch_cap = spy
    got, counts, dt = serve_counted(torch, eng, prompts)
    st = eng.stats()
    bound = min(f for f, _ in caps)
    log(f"[speculation] controller, paged pool of 32 blocks of 16: the free-"
        f"block bound fell to {bound} lanes (caps applied "
        f"{sorted(collections.Counter(cap for _, cap in caps).items())}), "
        f"peak active {eng.peak_active}, preemptions "
        f"{st['block_pool']['preemptions']}; "
        f"{sum(got[u] == greedy[u] for u in greedy)} of 16 completions equal"
        f" the uncontrolled run's")
    # a preempted request resumes from a re-prefill, whose KV rounds
    # otherwise than the decode steps' did, so its later tokens may part
    # from the ring's: reported, not required
    if bound >= 8 or any(cap > max(min(8, f), 1) for f, cap in caps):
        fail("controller, paged: the free-block bound did not bind, or a cap"
             " passed it")
    res["controller_paged"] = dict(min_free_cap=bound,
                                   equal_to_greedy=sum(got[u] == greedy[u]
                                                       for u in greedy),
                                   peak_active=eng.peak_active,
                                   block_pool=st["block_pool"],
                                   controller=st["controller"])
    del eng

    # (f) the round's device time: the draft's k steps and verify, each as
    # one CUDA graph, against the plain uniform:4 step, on one pool
    eng = Engine(raw, cfg, EngineConfig(**dict(RING, plan=SPEC_PLAN)),
                 device="cuda")
    eng.cache["length"] = torch.full((8,), 100, dtype=torch.int32,
                                     device="cuda")
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    vt = torch.zeros((8, SPEC_K + 1), dtype=torch.int64, device="cuda")
    t_draft = timer(lambda: lm.draft_tokens(
        eng.spec_decoder.draft_params, tok, eng.cache, cfg, SPEC_K,
        quant_kv=True, device="cuda"))
    t_verify = timer(lambda: lm.verify_step(eng.params, vt, eng.cache, cfg,
                                            quant_kv=True, device="cuda"))
    t_step = timer(lambda: lm.decode_step(eng.params, tok, eng.cache, cfg,
                                          quant_kv=True, device="cuda"))
    del eng
    ring_run = res["runs"]["ring q2:k4"]["speculative"]
    lane_rounds = ring_run["drafted"] / SPEC_K
    per_round = (ring_run["accepted"] + lane_rounds) / lane_rounds
    per_token = (t_draft + t_verify) / per_round
    spec_tps = res["runs"]["ring q2:k4"]["decode_tok_per_s"]
    plain_tps_card = rt["engine"]["uniform:4"]["decode_tok_per_s"]
    log(f"[speculation] {card_line()}: one round's device time (CUDA graphs, "
        f"8 lanes, positions 100+): draft {SPEC_K} steps under q2 "
        f"{t_draft:.3f} ms + verify of {SPEC_K + 1} tokens {t_verify:.3f} ms "
        f"= {t_draft + t_verify:.3f} ms for {per_round:.3f} tokens per lane "
        f"(measured in the ring run) = {per_token:.3f} ms per token, against "
        f"the plain uniform:4 step's {t_step:.3f} ms "
        f"({per_token / t_step:.3f} x); engine decode {spec_tps:.1f} tok/s "
        f"with the draft against {plain_tps_card:.1f} tok/s without (phase "
        f"4), same requests")
    res["round"] = dict(card=card_line(), draft_ms=t_draft,
                        verify_ms=t_verify, plain_step_ms=t_step,
                        tokens_per_lane_round=per_round,
                        ms_per_token=per_token,
                        ratio_to_plain_step=per_token / t_step,
                        decode_tok_per_s_draft=spec_tps,
                        decode_tok_per_s_plain=plain_tps_card)


# ---------------------------------------------------------------------------
# phase 10: tensor-parallel serving
# ---------------------------------------------------------------------------

# TP runs: (name, engine fields, wire bits, the phase 4 tokens they are held
# to; None: agreement printed only)
TP_RUNS = {2: (("ring", dict(RING), 32, "uniform:4"),
               ("paged", dict(RUN_A), 32, "uniform:4"),
               ("ring wire 8", dict(RING, plan="uniform:4a8,tp=2,wire=8"), 8,
                None)),
           4: (("ring", dict(RING), 32, "uniform:4"),)}
TP_BLOCK = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Recorder:
    """Wraps an engine's sampler: keeps every live request's logits row on
    the host by (uid, sample index), the row that chose that token."""

    def __init__(self, eng):
        self.rows, self.sample = {}, eng._sample
        eng._sample = self

    def __call__(self, logits, uids=None, indices=None):
        host = logits.float().cpu()
        for i, (uid, idx) in enumerate(zip(uids, indices)):
            if int(uid):
                self.rows[(int(uid), int(idx))] = host[i]
        return self.sample(logits, uids, indices)


class CountByShape:
    """Within the block, counts each kernel's launches by the shapes it was
    launched at (the launches themselves are unchanged)."""

    def __init__(self):
        from repro_torch.kernels.decode_attn import ops as attn
        from repro_torch.kernels.lut_gemv import ops as lut
        self.lut, self.attn = lut, attn
        self.counts = collections.Counter()

    def __enter__(self):
        lut, attn, counts = self.lut, self.attn, self.counts
        self.f32, self.int = lut.lut_matmul_cuda, lut.lut_matmul_int_cuda
        self.da = attn.decode_attention_cuda

        def f32(x, qt, plan_rows=None):
            counts[f"lut_matmul M{x.shape[0]} K{qt.k} N{qt.n}"] += 1
            return self.f32(x, qt, plan_rows)

        def int_(xq, xs, qt, abits, plan_rows=None):
            counts[f"lut_matmul_int M{xq.shape[0]} K{qt.k} N{qt.n}"] += 1
            return self.int(xq, xs, qt, abits, plan_rows)

        def da(q, k, v, lens, k_scale, v_scale, window, ring, tables=None):
            mode = ("table" if tables is not None else "ring" if ring
                    else "lengths")
            counts[f"decode_attention B{q.shape[0]} H{q.shape[1]} "
                   f"KV{k.shape[-2]} D{q.shape[2]} {mode}"] += 1
            return self.da(q, k, v, lens, k_scale, v_scale, window,
                           ring=ring, tables=tables)
        lut.lut_matmul_cuda, lut.lut_matmul_int_cuda = f32, int_
        attn.decode_attention_cuda = da
        return self

    def __exit__(self, *exc):
        self.lut.lut_matmul_cuda = self.f32
        self.lut.lut_matmul_int_cuda = self.int
        self.attn.decode_attention_cuda = self.da
        return False


class HeldAttn:
    """Within the block, every decode-attention launch is held against its
    plain version (ring or table mode as launched) on the launch's own
    inputs at ATTN_TOL; the plain version launches nothing."""

    def __init__(self, torch, name):
        from repro_torch.kernels.decode_attn import ops
        self.ops, self.torch, self.name = ops, torch, name
        self.calls, self.err = 0, 0.0

    def __enter__(self):
        from repro_torch.kernels.decode_attn.ref import (
            decode_attention_paged_ref, decode_attention_ref,
            decode_attention_ring_ref)
        self.da = self.ops.decode_attention_cuda

        def da(q, k, v, lens, k_scale, v_scale, window, ring, tables=None):
            out = self.da(q, k, v, lens, k_scale, v_scale, window,
                          ring=ring, tables=tables)
            if tables is not None:
                ref = decode_attention_paged_ref(q, k, v, lens, tables,
                                                 window, k_scale, v_scale)
            elif ring:
                ref = decode_attention_ring_ref(q, k, v, lens, window,
                                                k_scale, v_scale)
            else:
                ref = decode_attention_ref(q, k, v, lens, k_scale, v_scale,
                                           window)
            if not self.torch.allclose(out, ref, rtol=ATTN_TOL,
                                       atol=ATTN_TOL):
                fail(f"{self.name}: decode attention B{q.shape[0]} "
                     f"H{q.shape[1]} KV{k.shape[-2]} "
                     f"{'table' if tables is not None else 'ring'}: max err "
                     f"{(out - ref).abs().max().item():.3e}")
            self.err = max(self.err, (out - ref).abs().max().item())
            self.calls += 1
            return out
        self.ops.decode_attention_cuda = da
        return self

    def __exit__(self, *exc):
        self.ops.decode_attention_cuda = self.da
        return False


def first_parting(got, want):
    """{uid: the first sample index where ``got`` parts from ``want``}."""
    out = {}
    for uid, toks in got.items():
        ref = want[uid]
        j = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                 None)
        if j is not None or len(toks) != len(ref):
            out[uid] = j if j is not None else min(len(toks), len(ref))
    return out


def near_tie(torch, rows, ref_rows, uid, step):
    """The tokens rule of phase 10 for a request that parts from tp=1 at
    ``step``: every earlier logits row within MODEL_RTOL / MODEL_ATOL of
    tp=1's, and at ``step`` tp=1's top-2 gap below the two rows' largest
    difference (a near-tie that summation order may flip)."""
    err = max(((rows[(uid, j)] - ref_rows[(uid, j)]).abs().max().item()
               for j in range(step)), default=0.0)
    before = all(torch.allclose(rows[(uid, j)], ref_rows[(uid, j)],
                                rtol=MODEL_RTOL, atol=MODEL_ATOL)
                 for j in range(step))
    top = ref_rows[(uid, step)].topk(2).values
    gap = (top[0] - top[1]).item()
    diff = (rows[(uid, step)] - ref_rows[(uid, step)]).abs().max().item()
    return dict(uid=uid, step=step, gap=gap, diff=diff, err_before=err,
                explained=before and gap < diff)


def check_tp_launches(name, tp, st, counts, cfg, flavour, paged):
    """Exact launch counts on this rank: every decode step sends its
    layers x 7 sharded weight matmuls and lm_head through the plan's
    LUT-GEMV flavour, every prefill pass those and each layer's wk and wv
    again (the cache's K/V are recomputed), none through the other
    flavour; every decode step its attention per layer through the
    decode-attention kernel (table mode on the paged pool).  Returns the
    LUT-GEMV count the passes need."""
    layers = cfg.n_layers
    need = ((len(TP_BLOCK) * layers + 1) * st["decode_iterations"]
            + ((len(TP_BLOCK) + 2) * layers + 1) * st["prefill_iterations"])
    other = "lut_matmul" if flavour == "lut_matmul_int" else "lut_matmul_int"
    attn = st["decode_iterations"] * layers
    table = counts["decode_attention_table"]
    if (counts[flavour] != need or counts[other]
            or counts["decode_attention"] != attn
            or table != (attn if paged else 0)):
        fail(f"tp={tp} {name}: {flavour} {counts[flavour]} (need {need}), "
             f"{other} {counts[other]} (need 0), decode_attention "
             f"{counts['decode_attention']} (need {attn}), table mode "
             f"{table}")


def tp_step_graph(torch, timer, eng, cfg, gen):
    """One rank's LUT-GEMV calls of a decode step (M 8) at the sharded
    shapes of ``eng``'s tree as one CUDA graph: each call first held
    against its plain version, then the step timed beside torch.matmul on
    the dequantized weights and its bytes bound."""
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda
    from repro_torch.models import lm
    qts = [p_l[part][m] for _, p_l in lm.iter_layers(eng.params)
           for part, names in (("attn", TP_BLOCK[:4]), ("mlp", TP_BLOCK[4:]))
           for m in names]
    qts.append(eng.params["lm_head"])
    xk = {qt.k: torch.randn((8, qt.k), device=qt.packed.device,
                            generator=gen) for qt in qts}
    wds = [dequantize(qt) for qt in qts]
    err = 0.0
    for qt, wd in zip(qts, wds):
        y, ref = lut_matmul_cuda(xk[qt.k], qt), torch.matmul(xk[qt.k], wd)
        e = (y - ref).abs()
        if not bool((e <= F32_ATOL + F32_RTOL * ref.abs()).all()):
            fail(f"tp LUT-GEMV ({qt.k}, {qt.n}): max err {e.max().item():.3e}")
        err = max(err, e.max().item())
    ms = timer.replay_ms(lambda: [lut_matmul_cuda(xk[qt.k], qt) for qt in qts])
    lib = timer.replay_ms(lambda: [torch.matmul(xk[w.shape[0]], w)
                                   for w in wds])
    nbytes = sum(4 * (qt.packed.numel() + qt.scales.numel()
                      + qt.codebook.numel()) + 4 * 8 * (qt.k + qt.n)
                 for qt in qts)
    bound, by = bound_ms(nbytes, sum(2 * 8 * qt.k * qt.n for qt in qts))
    return dict(calls=len(qts), step_graph_ms=ms, library_step_graph_ms=lib,
                bytes=nbytes, bound_ms=bound, bound_by=by, max_abs_err=err,
                shapes=sorted({(qt.k, qt.n) for qt in qts}))


def tp_rank(rank, tp, want, out_dir):
    """One rank of phase 10 (every rank runs this on the same requests;
    rank 0 logs and writes ``tp<tp>.json``): full-width tinymistral (seed
    0, phase 4's weights) served tp ways over gloo, all ranks on the one
    card."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import tp_all_reduce, tp_context
    from repro_torch.launch.mesh import describe, rank_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    dev = rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda msg: None)
    cfg, raw = serving_model(dev)
    prompts = engine_requests(cfg)
    res = {"group": describe(), "runs": {}}
    say(f"[tp] tp={tp}: {res['group']}, every rank on {dev} "
        f"({torch.cuda.get_device_name(dev)}): the ranks share one card")
    rows = {}
    for name, fields, wire, held_to in TP_RUNS[tp]:
        eng = Engine(raw, cfg, EngineConfig(**fields, tp=tp, wire=wire),
                     device=dev)
        rec = Recorder(eng) if rank == 0 else None
        a8 = eng.quant_policy.act_bits is not None
        flavour = "lut_matmul_int" if a8 else "lut_matmul"
        with CountByShape() as shapes, Held(torch, f"tp={tp} {name}") as \
                held, HeldAttn(torch, f"tp={tp} {name}") as held_attn:
            got, counts, dt = serve_counted(torch, eng, prompts)
        st = eng.stats()
        if len(got) != 16 or any(len(t) != 32 for t in got.values()):
            fail(f"tp={tp} {name}: expected 16 completions of 32 tokens")
        check_tp_launches(name, tp, st, counts, cfg, flavour, eng.paged)
        bytes_want = int(2 * (tp - 1) / tp * 8 * 2 * cfg.n_layers
                         * cfg.d_model * wire / 8)
        if st["tp"]["allreduce_bytes_per_iter"] != bytes_want:
            fail(f"tp={tp} {name}: allreduce_bytes_per_iter "
                 f"{st['tp']['allreduce_bytes_per_iter']} != {bytes_want}")
        ref = want[held_to or "uniform:4a8"]
        parted = first_parting(got, ref)
        run = dict(paged=eng.paged, wire_bits=wire, plan_hash=st["plan_hash"],
                   tokens=st["generated_tokens"], seconds=dt,
                   decode_tok_per_s=st["measured_tps"],
                   decode_steps=st["decode_iterations"],
                   prefill_steps=st["prefill_iterations"], launches=counts,
                   by_shape=dict(sorted(shapes.counts.items())),
                   tp_stats=st["tp"],
                   equal_requests=16 - len(parted),
                   equal_tokens=sum(a == b for u in got
                                    for a, b in zip(got[u], ref[u])),
                   parted={str(u): j for u, j in parted.items()})
        if (sum(held.calls.values()) != counts[flavour]
                or held_attn.calls != counts["decode_attention"]):
            fail(f"tp={tp} {name}: {sum(held.calls.values())} LUT-GEMV "
                 f"launches held of {counts[flavour]}, {held_attn.calls} "
                 f"decode-attention launches of {counts['decode_attention']}")
        run.update(held=sum(held.calls.values()),
                   held_err=held.err["int" if a8 else "f32"],
                   held_attn=held_attn.calls, held_attn_err=held_attn.err)
        if rec is not None:
            rows[name] = rec.rows
        res["runs"][name] = run
        # a decode step's launches: its LUT-GEMV calls are the M 8 ones
        per_step = {k: v / st["decode_iterations"]
                    for k, v in shapes.counts.items()
                    if " M8 " in k or k.startswith("decode")}
        say(f"[tp] tp={tp} {name} (wire {wire}, {st['plan_hash']}): "
            f"{st['generated_tokens']} tokens in {dt:.3f} s, decode "
            f"{st['measured_tps']:.1f} tok/s over {st['decode_iterations']} "
            f"steps; {run['equal_requests']} of 16 requests and "
            f"{run['equal_tokens']} of 512 tokens equal phase 4's "
            f"{'uniform:4' if held_to else 'uniform:4a8'}"
            + (f" (first parting {run['parted']})" if parted else "")
            + f"; per rank {counts[flavour]} {flavour} launches = "
            f"{len(TP_BLOCK) * cfg.n_layers + 1} x "
            f"{st['decode_iterations']} decode steps + "
            f"{(len(TP_BLOCK) + 2) * cfg.n_layers + 1} x "
            f"{st['prefill_iterations']} prefill passes, "
            f"{counts['decode_attention']} decode attention = "
            f"{cfg.n_layers} x "
            f"{st['decode_iterations']} steps"
            + (f" ({counts['decode_attention_table']} in table mode)"
               if eng.paged else "")
            + f"; decode-step launches by shape {per_step}; "
            f"allreduce_bytes_per_iter {st['tp']['allreduce_bytes_per_iter']}"
            + f"; all {run['held']} {flavour} launches (prefill and decode) "
            f"within rtol {LUT_RTOL if a8 else F32_RTOL} / atol "
            f"{LUT_ATOL if a8 else F32_ATOL} of their plain version (max abs "
            f"err {run['held_err']:.3e}), all {run['held_attn']} "
            f"decode-attention launches within {ATTN_TOL} of theirs (max abs"
            f" err {run['held_attn_err']:.3e})")
        if name == "ring":
            ring = eng
        else:
            del eng

    # where a tp step's time goes: the eager step (every rank at once, on
    # the one card) against its 2 all-reduces a layer alone, at the step's
    # shape
    timer = Timer(torch)
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)

    def step():
        with ring._tp():
            return lm.decode_step(ring.params, tok, ring.cache, ring._mcfg,
                                  quant_kv=True, device=dev)
    part = torch.randn((8, 1, cfg.d_model), device=dev)
    buf = torch.empty_like(part)

    def reduces():
        with tp_context(None, 32):
            for _ in range(2 * cfg.n_layers):
                buf.copy_(part)
                tp_all_reduce(buf)
    step_ms, reduce_ms = timer.call_ms(step), timer.call_ms(reduces)
    res["step_wall_ms"], res["allreduce_ms"] = step_ms, reduce_ms
    say(f"[tp] tp={tp}: one decode step (8 lanes) eager wall {step_ms:.3f} "
        f"ms per rank; its {2 * cfg.n_layers} all-reduces of [8, 1, "
        f"{cfg.d_model}] f32 alone {reduce_ms:.3f} ms "
        f"({100 * reduce_ms / step_ms:.1f}% of the step; gloo through the "
        "host, the ranks sharing one card)")
    dist.barrier()
    if rank == 0:
        # the LUT-GEMV step graph alone on the card (the other ranks are
        # done: their shapes are rank 0's)
        res["lut_step_graph"] = tp_step_graph(
            torch, timer, ring, cfg, torch.Generator(device=dev).manual_seed(1))
        g = res["lut_step_graph"]
        say(f"[tp] tp={tp}: one rank's LUT-GEMV decode step ({g['calls']} "
            f"calls, M 8, b 4, shapes (K, N) {g['shapes']}) as one graph "
            f"{g['step_graph_ms']:.4f} ms; torch.matmul on the dequantized "
            f"weights {g['library_step_graph_ms']:.4f} ms; bound "
            f"{g['bound_ms']:.4f} ms by {g['bound_by']}; each call within "
            f"rtol {F32_RTOL} / atol {F32_ATOL} of its plain version (max "
            f"abs err {g['max_abs_err']:.3e})")
        # a request that parted from tp=1: its logits against a tp=1
        # engine's on the same requests (the near-tie rule)
        if any(r["parted"] for n, r in res["runs"].items()
               if n != "ring wire 8"):
            del ring
            eng = Engine(raw, cfg, EngineConfig(**RING), device=dev)
            rec = Recorder(eng)
            got, _, _ = serve_counted(torch, eng, prompts)
            if got != want["uniform:4"]:
                fail("tp=1 rerun: tokens differ from phase 4's")
            res["near_ties"] = {}
            for name, run in res["runs"].items():
                if name == "ring wire 8":
                    continue
                for uid, step_j in run["parted"].items():
                    tie = near_tie(torch, rows[name], rec.rows, int(uid),
                                   step_j)
                    res["near_ties"][f"{name} uid {uid}"] = tie
                    say(f"[tp] tp={tp} {name}: request {uid} parts at "
                        f"token {step_j}: tp=1's top-2 gap {tie['gap']:.3e}"
                        f", tp={tp} vs tp=1 logits differ by "
                        f"{tie['diff']:.3e} there and by "
                        f"{tie['err_before']:.3e} before")
                    if not tie["explained"]:
                        fail(f"tp={tp} {name}: request {uid} parts at "
                             f"token {step_j} and no near-tie explains it")
        with open(os.path.join(out_dir, f"tp{tp}.json"), "w") as f:
            json.dump(res, f, indent=1)


def phase_tp(rt):
    import torch
    from repro_torch.launch.mesh import run_ranks
    want = {plan: rt["ring_tokens"][plan] for plan in ("uniform:4",
                                                      "uniform:4a8")}
    res = rt["tp"] = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    for tp in TP_RUNS:
        path = os.path.join(OUT_DIR, f"tp{tp}.json")
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        run_ranks(tp_rank, tp, args=(tp, want, OUT_DIR))
        with open(path) as f:
            res[f"tp={tp}"] = json.load(f)
        res[f"tp={tp}"]["seconds"] = time.perf_counter() - t0
    one = rt["engine"]["uniform:4"]["step_wall_ms"]
    log(f"[tp] {card_line()}: eager wall ms per decode step (8 lanes) tp=1 "
        f"{one:.3f} (phase 4), "
        + ", ".join(f"{k} {r['step_wall_ms']:.3f} ({100 * r['allreduce_ms'] / r['step_wall_ms']:.1f}% in its all-reduces)"
                    for k, r in res.items())
        + "; no whole-step graph under TP: collectives are not captured; "
        f"{torch.cuda.device_count()} card(s) visible, all ranks on cuda:0")


# ---------------------------------------------------------------------------
# phase 11: the dense and MoE families
# ---------------------------------------------------------------------------

# (c): the other six configs of the slice, at their full widths cut to 2
# layers; (d): the smoke configs whose head width is not a multiple of 8
# (llama2_13b's D 20 at G 1, starcoder2_7b's D 12 at G 3)
FAMILY_CUT = ("llama2_13b", "llama3_2_1b", "qwen3_0_6b", "h2o_danube_3_4b",
              "starcoder2_7b", "mixtral_8x7b")
# (c)'s depth: 2 layers, mixtral's 1: its CPU side (8 dequantized experts
# of 4096 x 14336 a layer) made it the phase's slowest part, 37.7 s of the
# whole run's 839 s at 2 layers, which phase 14 (e)-(f) brought near 1000 s
# on a slower host
FAMILY_CUT_LAYERS = {"mixtral_8x7b": 1}
NARROW = ("llama2_13b", "starcoder2_7b")
# phase 5 run A's pool: 8 lanes x 32 blocks of 16, no sharing, so admission
# and prefill groups are the ring engine's
# (a), (b) and phase 12's serves at full depth: phase 4's 16 requests, 16
# new tokens each (two waves of 8 lanes; host-bound eager steps)
FAMILY_NEW = 16
FAMILY_PAGED = dict(kv_block_size=16, kv_pool_blocks=8 * 32,
                    share_prefix=False)
# the smoke configs' widths (64-80) take groups of 8
NARROW_RING = dict(batch_size=4, cache_len=64, quant_kv=True,
                   plan="uniform:4", group_size=8)
NARROW_PAGED = dict(kv_block_size=8, kv_pool_blocks=4 * 8,
                    share_prefix=False)


def family_model(torch, arch, layers=None, smoke=False):
    """``arch``'s config (full, or smoke; cut to ``layers``) and its random
    weights made on the card from seed 0."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.models import lm
    cfg = C.get_smoke(arch) if smoke else C.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, lm.init_params(cfg, gen, device="cuda")


def cut_layers(raw, cfg, n):
    """The first ``n`` layers of a raw tree (copies; the rest shared) and
    the config cut to them."""
    import dataclasses
    from repro_torch.models.sail_linear import _walk
    out = dict(raw)
    out["blocks"] = _walk(raw["blocks"], lambda _, x: x[:n].clone())
    return out, dataclasses.replace(cfg, n_layers=n)


def lut_calls(params):
    """(LUT-GEMV launches of one decode step, of one prefill pass) of a
    quantized tree: each layer's quantized matrices once (a MoE layer's
    router; its experts go through einsum_q, no kernel; an xlstm
    super-block's sub-layers), the attention's wk and wv once more in
    prefill (the cache's K/V), and a quantized lm_head once (a tied head is
    a plain product)."""
    from repro_torch.core.quant import QTensor
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import flatten_with_paths
    dec = pre = 0
    for _, layer in lm.iter_layers(params):
        for path, w in flatten_with_paths(layer):
            if isinstance(w, QTensor):
                dec += 1
                pre += 2 if path in ("['attn']['wk']", "['attn']['wv']") \
                    else 1
    head = int(isinstance(params.get("lm_head"), QTensor))
    return dec + head, pre + head


class CardDequant:
    """Within the block, the CPU's plain versions (the LUT-GEMV's and
    ``einsum_q``'s) take each CPU weight's dequantization from the card,
    once per weight: unpacking is integer work and scaling one f32 multiply
    per element, so the two are bit-equal (checked on the first weight),
    and an 8-core host CPU unpacks tens of millions of weights per
    second, minutes per pass at these widths.  Every product stays on the
    CPU."""

    def __init__(self, torch):
        from repro_torch.kernels.lut_gemv import ref
        from repro_torch.models import sail_linear
        self.torch, self.ref, self.sl = torch, ref, sail_linear
        self.memo, self.checked = {}, None

    def _card(self, fn, w):
        import dataclasses
        key = (w.packed.data_ptr(), tuple(w.packed.shape))
        if key not in self.memo:
            dev = dataclasses.replace(w, packed=w.packed.cuda(),
                                      scales=w.scales.cuda(),
                                      codebook=w.codebook.cuda())
            self.memo[key] = fn(dev).cpu()
            if self.checked is None:
                self.checked = bool(self.torch.equal(self.memo[key], fn(w)))
                if not self.checked:
                    fail("the card's dequantization differs from the CPU's")
        return self.memo[key]

    def __enter__(self):
        from repro_torch.core.quant import QTensor
        from repro_torch.models.sail_linear import StackedQTensor
        deq, deq_any = self.ref.dequantize, self.sl.dequantize_any
        self.saved = deq, deq_any
        on_cpu = lambda w: (isinstance(w, (QTensor, StackedQTensor))
                            and w.packed.device.type == "cpu")
        self.ref.dequantize = lambda w: (self._card(deq, w) if on_cpu(w)
                                         else deq(w))
        self.sl.dequantize_any = lambda w: (self._card(deq_any, w)
                                            if on_cpu(w) else deq_any(w))
        return self

    def __exit__(self, *exc):
        self.ref.dequantize, self.sl.dequantize_any = self.saved
        self.memo.clear()
        return False


def held_passes(torch, lm, params, cfg, toks, lengths, steps, name,
                cache=True, quant_kv=True, attn=None, prefix=None,
                cache_len=512, mixed=False):
    """Prefill ``toks`` (after ``prefix`` embeddings when given) and run
    ``steps`` greedy decode steps on the card (int8 KV, or f32),
    every LUT-GEMV and decode-attention launch held against its plain
    version on its own inputs, the launches of each pass counted from 0
    and checked exactly: ``lut_calls`` per prefill pass and decode step
    (``mixed``: of the f32 and int LUT-GEMV together, a plan with
    activation bits), ``attn`` attentions per step (default one per layer;
    xlstm has none), nothing else.  Returns (logits [steps + 1, B, V] and
    tokens on the host, record)."""
    from repro_torch.kernels import _build
    dec, pre = lut_calls(params)
    attn = cfg.n_layers if attn is None else attn
    passes = []
    with Held(torch, name, cache=cache) as held, \
            HeldAttn(torch, name) as held_attn:
        _build.reset_launches()
        t0 = time.perf_counter()
        logits, kv = lm.prefill(params, toks, cfg, cache_len, quant_kv,
                                lengths, device="cuda", prefix_embeds=prefix)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        passes.append(dict(_build.launches))
        out_l, out_t = [logits.float().cpu()], []
        for _ in range(steps):
            tok = torch.argmax(logits, dim=-1)
            out_t.append(tok.cpu())
            _build.reset_launches()
            logits, kv = lm.decode_step(params, tok[:, None], kv, cfg,
                                        quant_kv, device="cuda")
            passes.append(dict(_build.launches))
            out_l.append(logits.float().cpu())
        out_t.append(torch.argmax(logits, dim=-1).cpu())
    for i, c in enumerate(passes):
        want = (pre, 0) if i == 0 else (dec, attn)
        lut = c["lut_matmul"] + (c["lut_matmul_int"] if mixed else 0)
        if ((lut, c["decode_attention"]) != want
                or (c["lut_matmul_int"] and not mixed)
                or c["decode_attention_table"]):
            fail(f"{name}: pass {i} launched {c}; want LUT-GEMV "
                 f"{want[0]}, decode attention {want[1]} (ring), nothing else")
    rec = dict(lut_per_prefill=pre, lut_per_decode_step=dec,
               attention_per_decode_step=attn, held_prefill_s=prefill_s,
               launches=dict(sum((collections.Counter(c) for c in passes),
                                 collections.Counter())),
               held_lut=sum(held.calls.values()), held_attention=held_attn.calls,
               max_abs_err_lut=held.err["f32"],
               max_abs_err_lut_int=held.err["int"],
               max_abs_err_attention=held_attn.err)
    return torch.stack(out_l), torch.stack(out_t), rec


def card_vs_cpu(torch, lm, params, cfg, name, attn=None, prefix=None):
    """Phase 3's prompts and steps (prefill [2, 48] + 4 decode steps) on the
    card, every launch held, against the CPU, greedy tokens equal.  With
    f32 KV every pass's logits at phase 3's tolerance; with int8 KV the
    prefill's (which reads no cache), since a K or V value at an int8
    rounding tie goes either way on the two sides (the decode steps'
    worst difference is recorded)."""
    from repro_torch.models.sail_linear import map_tensors
    toks, lengths = model_prompts(cfg)
    cpu = map_tensors(params, lambda t: t.cpu())
    out = {}
    for kv in ("int8", "f32"):
        t0 = time.perf_counter()
        gl, gt, rec = held_passes(torch, lm, params, cfg, toks, lengths, 4,
                                  f"{name} {kv} KV", quant_kv=kv == "int8",
                                  attn=attn, prefix=prefix,
                                  cache_len=CACHE_LEN.get(cfg.frontend, 512))
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CardDequant(torch) as cd:
            cl, ct = run_greedy(torch, lm, cpu, cfg, toks, lengths, 4, "cpu",
                                quant_kv=kv == "int8", prefix=prefix,
                                cache_len=CACHE_LEN.get(cfg.frontend, 512))
        t_cpu = time.perf_counter() - t0
        per_pass = (gl - cl).abs().amax(dim=(1, 2)).tolist()
        held = gl if kv == "f32" else gl[:1]
        rec.update(logits_err_per_pass=per_pass,
                   tokens_equal=bool(torch.equal(gt, ct)),
                   card_tokens=gt.T.tolist(), cpu_tokens=ct.T.tolist(),
                   max_abs_logit=cl.abs().max().item(),
                   dequant_bit_equal=cd.checked, card_s=t_card, cpu_s=t_cpu)
        out[f"{kv} KV"] = rec
        rows = "" if prefix is None else f"{prefix.shape[1]} prefix rows + "
        log(f"[families] {name}, {kv} KV: prefill [2, {rows}48] + 4 decode "
            f"steps, "
            f"uniform:4, card vs CPU: logits max abs err per pass "
            f"{', '.join(f'{e:.3e}' for e in per_pass)} (max |logit| "
            f"{rec['max_abs_logit']:.2f}); greedy tokens card "
            f"{gt.T.tolist()} CPU {ct.T.tolist()}; card {t_card:.2f} s "
            f"(every launch held: {rec['held_lut']} LUT-GEMV, max abs err "
            f"{rec['max_abs_err_lut']:.3e}; {rec['held_attention']} decode "
            f"attention, {rec['max_abs_err_attention']:.3e}; per pass exactly"
            f" {rec['lut_per_prefill']} / {rec['lut_per_decode_step']} "
            f"LUT-GEMV and {rec['attention_per_decode_step']} attentions), "
            f"CPU {t_cpu:.2f} s")
        if (tuple(gl.shape) != (5, 2, cfg.vocab)
                or not torch.isfinite(gl).all() or not rec["tokens_equal"]
                or not torch.allclose(held, cl[:len(held)], rtol=MODEL_RTOL,
                                      atol=MODEL_ATOL)):
            fail(f"{name}, {kv} KV: card and CPU differ (logits per pass "
                 f"{per_pass}, shape {tuple(gl.shape)}, tokens equal "
                 f"{rec['tokens_equal']})")
    return out


def serve_families(torch, eng, prompts, cfg, name, max_new, table,
                   attn=None, lut="lut_matmul"):
    """Serve ``prompts`` counted (``serve_counted``) and check that every
    decode step went through the LUT-GEMV (``lut``: the f32 or the int
    flavour) and through ``attn`` decode attentions (default one per
    layer) in ring or table mode (and never the other mode or the other
    LUT-GEMV).  Returns ({uid: tokens}, record)."""
    attn = cfg.n_layers if attn is None else attn
    other_lut = "lut_matmul_int" if lut == "lut_matmul" else "lut_matmul"
    got, counts, dt = serve_counted(torch, eng, prompts, max_new)
    st = eng.stats()
    dec, _ = lut_calls(eng.params)
    steps = st["decode_iterations"]
    other = (counts["decode_attention"] - counts["decode_attention_table"]
             if table else counts["decode_attention_table"])
    mode = counts["decode_attention"] - other
    if (len(got) != len(prompts) or any(len(t) != max_new
                                        for t in got.values())
            or any(not 0 <= x < cfg.vocab for t in got.values() for x in t)):
        fail(f"{name}: expected {len(prompts)} completions of {max_new} "
             "tokens in the vocabulary")
    if (counts[lut] < steps * dec or mode < steps * attn
            or other or counts[other_lut]):
        fail(f"{name}: {steps} decode steps launched {counts}; need >= "
             f"{steps * dec} {lut} and >= {steps * attn} "
             f"{'table' if table else 'ring'}-mode attentions")
    rec = dict(tokens=st["generated_tokens"], seconds=dt,
               decode_steps=steps, decode_tok_per_s=st["measured_tps"],
               prefill_passes=st["prefill_iterations"], launches=counts)
    log(f"[families] {name}: {len(prompts)} requests, "
        f"{st['generated_tokens']} tokens in {dt:.2f} s, decode "
        f"{st['measured_tps']:.1f} tok/s over {steps} steps; launches "
        f"{counts}")
    return got, rec


def lut_step(torch, timer, params):
    """A decode step's LUT-GEMV calls on ``params``' own weights at M = 8,
    in the step's order, as one graph (no flush), beside torch.matmul on
    the dequantized weights and the step's bound."""
    from repro_torch.core.quant import QTensor, dequantize
    from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import flatten_with_paths
    qts = [w for _, layer in lm.iter_layers(params)
           for _, w in flatten_with_paths(layer) if isinstance(w, QTensor)]
    if isinstance(params.get("lm_head"), QTensor):
        qts.append(params["lm_head"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    xk = {k: torch.randn((8, k), device="cuda", generator=gen)
          for k in {qt.k for qt in qts}}
    ms = timer.replay_ms(lambda: [lut_matmul_cuda(xk[qt.k], qt)
                                  for qt in qts])
    nbytes = sum(4 * (qt.packed.numel() + qt.scales.numel()
                      + qt.codebook.numel()) + 4 * 8 * (qt.k + qt.n)
                 for qt in qts)
    ops = sum(2 * 8 * qt.k * qt.n for qt in qts)
    bound, by = bound_ms(nbytes, ops)
    wds = [dequantize(qt) for qt in qts]
    lib = timer.replay_ms(lambda: [torch.matmul(xk[w.shape[0]], w)
                                   for w in wds])
    del wds
    return dict(calls=len(qts), step_graph_ms=ms, library_step_graph_ms=lib,
                bound_ms=bound, bound_by=by, bytes=nbytes,
                bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=ops / F32_OPS_PER_S * 1e3)


def attention_step(torch, timer, cache, cfg):
    """The decode step's attentions (one per layer, ring mode) on a decode
    cache's K/V and positions as one graph (no flush), and their bound
    over the valid slots."""
    from repro_torch.kernels.decode_attn.ops import decode_attention_ring
    from repro_torch.kernels.decode_attn.ref import ring_valid
    layers = cache["layers"]
    pos = cache["length"].to(torch.int32)
    b, s = layers["k"].shape[1], layers["k"].shape[2]
    window = cfg.window or s
    q = torch.randn((b, cfg.n_heads, cfg.head_dim), device="cuda")
    ms = timer.replay_ms(lambda: [decode_attention_ring(
        q, layers["k"][i], layers["v"][i], pos, window, layers["k_scale"][i],
        layers["v_scale"][i]) for i in range(cfg.n_layers)])
    slots = int(ring_valid(pos, s, window).sum())
    nbytes = cfg.n_layers * (2 * 4 * q.numel() + 4 * b + slots * cfg.n_kv
                             * (2 * cfg.head_dim + 2 * 4))
    bound, by = bound_ms(nbytes, cfg.n_layers * 4 * slots * cfg.n_heads
                         * cfg.head_dim)
    return dict(calls=cfg.n_layers, step_graph_ms=ms, bound_ms=bound,
                bound_by=by, valid_slots=slots, positions=pos.tolist())


def family_full(torch, timer, arch, res):
    """(a) / (b): ``arch`` at full width and depth: init and quantize on the
    card (the f32 tree freed once both engines hold their quantized trees),
    phase 4's 16 requests on the ring and on the paged pool (tokens equal),
    one prefill pass and two decode steps with every launch held, the step
    timed, and the model cut to 2 layers card against CPU."""
    import gc
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, \
        flatten_with_paths, quantize_params
    from repro_torch.serving.engine import Engine, EngineConfig
    rec = res[arch] = {}
    t0 = time.perf_counter()
    cfg, raw = family_model(torch, arch)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["raw_gb"] = sum(4 * t.numel() for _, t in flatten_with_paths(raw)) / 1e9
    raw2, cfg2 = cut_layers(raw, cfg, 2)
    t0 = time.perf_counter()
    ring = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
    paged = Engine(raw, cfg, EngineConfig(**RING, **FAMILY_PAGED),
                   device="cuda")
    torch.cuda.synchronize()
    rec["quantize_s"] = time.perf_counter() - t0
    rec["compression"] = ring.compression
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    rec["card_gb_served"] = torch.cuda.memory_allocated() / 1e9
    log(f"[families] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} x {cfg.head_dim} heads over {cfg.n_kv} kv heads, "
        f"vocab {cfg.vocab}: f32 init on the card ({rec['raw_gb']:.2f} GB) "
        f"{rec['init_s']:.1f} s; two "
        f"engines quantized uniform:4 ({ring.compression:.2f}x smaller) in "
        f"{rec['quantize_s']:.1f} s; f32 tree freed: "
        f"{rec['card_gb_served']:.2f} GB allocated with both engines' "
        f"weights and KV pools")
    prompts = engine_requests(cfg)
    got, rec["ring"] = serve_families(torch, ring, prompts, cfg,
                                      f"{arch} ring", FAMILY_NEW,
                                      table=False)
    pg, rec["paged"] = serve_families(torch, paged, prompts, cfg,
                                      f"{arch} paged", FAMILY_NEW,
                                      table=True)
    same = sum(pg[u] == got[u] for u in got)
    rec["paged_equal_ring"] = same
    log(f"[families] {arch}: {same} of {len(got)} paged completions equal "
        "the ring engine's")
    if pg != got:
        fail(f"{arch}: paged tokens differ from the ring engine's")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    toks, lengths = model_prompts(cfg)
    t0 = time.perf_counter()
    _, _, rec["held"] = held_passes(torch, lm, ring.params, cfg, toks,
                                    lengths, 2, f"{arch} held",
                                    cache=cfg.family == "moe")
    h = rec["held"]
    log(f"[families] {arch}: one prefill pass [2, 48] and two decode steps "
        f"at full depth, every launch held in {time.perf_counter() - t0:.1f}"
        f" s: exactly {h['lut_per_prefill']} LUT-GEMV per prefill pass and "
        f"{h['lut_per_decode_step']} per decode step, "
        f"{h['attention_per_decode_step']} decode attentions (ring mode) per "
        f"step; {h['held_lut']} LUT-GEMV within rtol {F32_RTOL} / atol "
        f"{F32_ATOL} (max abs err {h['max_abs_err_lut']:.3e}), "
        f"{h['held_attention']} attentions within {ATTN_TOL} (max abs err "
        f"{h['max_abs_err_attention']:.3e})")
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    one_step = lambda: lm.decode_step(ring.params, tok, ring.cache, cfg,
                                      quant_kv=True, device="cuda")
    rec["step_device_ms"] = timer(one_step)
    rec["step_wall_ms"] = timer.call_ms(one_step, iters=10)
    rec["attention_step"] = attention_step(torch, timer, ring.cache, cfg)
    if cfg.family == "moe":
        rec["expert_step"] = expert_step(torch, timer, ring.params, cfg)
    else:
        rec["lut_step"] = lut_step(torch, timer, ring.params)
    step_log(arch, cfg, rec)
    del ring
    gc.collect()
    torch.cuda.empty_cache()
    params2, _, _ = quantize_params(raw2, QuantPolicy(bits=4, group_size=128,
                                                      min_size=1024))
    del raw2
    rec["card_vs_cpu_2_layers"] = card_vs_cpu(torch, lm, params2, cfg2,
                                              f"{arch} at 2 layers")
    return rec


def expert_step(torch, timer, params, cfg):
    """A decode step's MoE layers (router, then the dense expert einsums,
    which dequantize every expert on every call) at 8 rows as one graph,
    and the expert einsums alone."""
    from repro_torch.models import lm, moe
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn((8, cfg.d_model), device="cuda", generator=gen)
    layers = [layer["moe"] for _, layer in lm.iter_layers(params)]
    moe_ms = timer.replay_ms(lambda: [moe.apply_moe_dense(p, h, cfg)
                                      for p in layers])
    ffn_ms = timer.replay_ms(lambda: [moe._expert_ffn(
        p, h, cfg, "td,edf->tef", "tef,efd->ted") for p in layers])
    return dict(layers=len(layers), moe_graph_ms=moe_ms,
                expert_einsums_graph_ms=ffn_ms)


def step_log(arch, cfg, rec):
    a = rec["attention_step"]
    line = (f"[families] {arch} on {card_line()}: one full-pool decode step "
            f"(8 lanes): device {rec['step_device_ms']:.3f} ms as a graph, "
            f"eager wall {rec['step_wall_ms']:.3f} ms "
            f"({100 * (1 - rec['step_device_ms'] / rec['step_wall_ms']):.1f}% "
            f"host and launch overhead); decode "
            f"{rec['ring']['decode_tok_per_s']:.1f} tok/s in the ring run; "
            f"its {a['calls']} attentions as one graph "
            f"{a['step_graph_ms']:.4f} ms (bound {a['bound_ms']:.4f} ms by "
            f"{a['bound_by']} over {a['valid_slots']} valid slots)")
    if "lut_step" in rec:
        g = rec["lut_step"]
        line += (f"; its {g['calls']} LUT-GEMV calls (M 8) as one graph "
                 f"{g['step_graph_ms']:.4f} ms, torch.matmul on the "
                 f"dequantized weights {g['library_step_graph_ms']:.4f} ms, "
                 f"bound {g['bound_ms']:.4f} ms by {g['bound_by']} (bytes "
                 f"{g['bytes'] / 1e9:.3f} GB -> {g['bytes_bound_ms']:.4f} ms,"
                 f" f32 operations {g['ops_bound_ms']:.4f} ms)")
    else:
        e = rec["expert_step"]
        line += (f"; its {e['layers']} MoE layers (router and dense experts, "
                 f"8 rows) as one graph {e['moe_graph_ms']:.3f} ms, the "
                 f"expert einsums alone {e['expert_einsums_graph_ms']:.3f} ms "
                 f"({100 * e['expert_einsums_graph_ms'] / rec['step_device_ms']:.1f}"
                 f"% of the step)")
    log(line)


def family_cut(torch, arch, res):
    """(c): ``arch`` at full width cut to 2 layers (FAMILY_CUT_LAYERS):
    four of phase 4's requests (8 new tokens) on the ring with every
    launch held, and the card against the CPU."""
    import gc
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    rec = res[arch] = {}
    layers = FAMILY_CUT_LAYERS.get(arch, 2)
    depth = f"{layers} layer{'s' if layers > 1 else ''}"
    cfg, raw = family_model(torch, arch, layers=layers)
    eng = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
    del raw
    gc.collect()
    with Held(torch, arch) as held, HeldAttn(torch, arch) as held_attn:
        _, rec["ring"] = serve_families(torch, eng, engine_requests(cfg)[:4],
                                        cfg, f"{arch} ({depth}) ring", 8,
                                        table=False)
    rec["ring"].update(held_lut=sum(held.calls.values()),
                       held_attention=held_attn.calls,
                       max_abs_err_lut=held.err["f32"],
                       max_abs_err_attention=held_attn.err)
    rec["card_vs_cpu"] = card_vs_cpu(torch, lm, eng.params, cfg,
                                     f"{arch} at {depth}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def family_narrow(torch, timer, arch, res):
    """(d): a smoke config with a narrow head on the card, ring and paged,
    every launch held; its tokens against the CPU engine's."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.models.sail_linear import map_tensors
    rec = res[f"{arch} smoke"] = {}
    cfg, raw = family_model(torch, arch, smoke=True)
    prompts = [p[:12] for p in engine_requests(cfg)[:6]]
    out = {}
    for name, fields in (("ring", NARROW_RING),
                         ("paged", {**NARROW_RING, **NARROW_PAGED})):
        eng = Engine(raw, cfg, EngineConfig(**fields), device="cuda")
        with Held(torch, arch) as held, HeldAttn(torch, arch) as held_attn:
            out[name], rec[name] = serve_families(
                torch, eng, prompts, cfg, f"{arch} smoke {name}", 16,
                table=name == "paged")
        rec[name].update(held_lut=sum(held.calls.values()),
                         held_attention=held_attn.calls,
                         max_abs_err_lut=held.err["f32"],
                         max_abs_err_attention=held_attn.err)
    cpu = Engine(map_tensors(raw, lambda t: t.cpu()), cfg,
                 EngineConfig(**NARROW_RING), device="cpu")
    for p in prompts:
        cpu.submit(p, max_new_tokens=16)
    want = {c.uid: c.tokens for c in cpu.run()}
    rec["ring_equal_paged"] = out["ring"] == out["paged"]
    rec["ring_equal_cpu"] = out["ring"] == want
    log(f"[families] {arch} smoke (D {cfg.head_dim}, G "
        f"{cfg.n_heads // cfg.n_kv}): {rec['ring']['held_attention']} ring "
        f"and {rec['paged']['held_attention']} table-mode attentions within "
        f"{ATTN_TOL} of the plain version (max abs err "
        f"{max(rec['ring']['max_abs_err_attention'], rec['paged']['max_abs_err_attention']):.3e}"
        f"); ring tokens equal paged {rec['ring_equal_paged']}, equal the "
        f"CPU engine's {rec['ring_equal_cpu']}")
    if not (rec["ring_equal_paged"] and rec["ring_equal_cpu"]):
        fail(f"{arch} smoke: ring, paged and CPU tokens differ")
    return rec


def narrow_timing(torch, timer, res):
    """Decode attention at D 20 beside D 128 (B 8, KV 4, G 1, S 512, int8
    ring, wrapped positions), each beside its plain version, SDPA and its
    bound."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(2)
    position = torch.tensor([3, 300, 511, 512, 700, 1023, 1500, 2047],
                            dtype=torch.int32, device="cuda")
    rows = {}
    for d in (20, 128):
        x = attn_inputs(torch, gen, 512, b=8, kvh=4, g=1, d=d)
        rows[f"D{d}"] = row = attention_row(torch, timer, x, position,
                                            decode_attention_cuda)
        log(f"[families] decode_attention D {d} (B 8, KV 4, G 1, S 512, "
            f"int8 ring, {row['valid_slots']} valid slots): "
            f"{1e3 * row['ms']:.2f} us (plain {1e3 * row['plain_ms']:.2f}, "
            f"SDPA {1e3 * row['library_ms']:.2f}, bound "
            f"{1e3 * row['bound_ms']:.3f} us by {row['bound_by']})")
    res["narrow_timing"] = rows


# (e): the quantizers' seeded inputs
QUANT_KV_SHAPE = (8, 512, 8, 128)
QUANT_ACT_SHAPE = (8, 4096)
QUANT_W_SHAPE = (4096, 4096)
QUANT_GROUP = 128


def quant_card_vs_cpu(torch, res):
    """(e): each quantizer on the card against the CPU on the same seeded
    inputs, codes, scales and codebooks bit-equal; beside, the elements
    the formula before true division (the absmax, or the codebook grid,
    divided by a Python scalar, which CUDA turns into a product with the
    reciprocal) put apart on the card."""
    from repro_torch.core import quant as Q
    gen = torch.Generator().manual_seed(11)
    kv = torch.randn(QUANT_KV_SHAPE, generator=gen)
    act = torch.randn(QUANT_ACT_SHAPE, generator=gen) * 3.0
    w = torch.randn(QUANT_W_SHAPE, generator=gen) * 0.02
    rows = {}

    def nonzero(absmax):
        return torch.where(absmax == 0, torch.ones_like(absmax), absmax)

    def parent_codebook(bits):
        if bits == 1:
            return Q._uniform_codebook(1, device="cuda")
        grid = (torch.arange(1 << bits, dtype=torch.float32, device="cuda")
                - float(1 << (bits - 1)))
        return grid / float(max((1 << (bits - 1)) - 1, 1))

    def row(name, card, cpu, parent):
        rows[name] = dict(
            elements=sum(b.numel() for b in cpu),
            differ=sum(int((a.cpu() != b).sum()) for a, b in zip(card, cpu)),
            differ_parent=sum(int((a.cpu() != b).sum())
                              for a, b in zip(parent, cpu)))

    k = kv.cuda()
    scale = nonzero(k.abs().amax(dim=-1, keepdim=True)) / 127.0
    row("quantize_kv", Q.quantize_kv(k), Q.quantize_kv(kv),
        (torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8),
         scale))
    x = act.cuda()
    for bits in (4, 8):
        qmax = (1 << (bits - 1)) - 1
        scale = nonzero(x.abs().amax(dim=-1, keepdim=True)) / qmax
        row(f"quantize_activations a{bits}", Q.quantize_activations(x, bits),
            Q.quantize_activations(act, bits),
            (torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32),
             scale))
    wc = w.cuda()
    wg = wc.reshape(-1, QUANT_GROUP, wc.shape[1])
    for bits in range(2, 9):
        qmax = (1 << (bits - 1)) - 1
        scale = nonzero(wg.abs().amax(dim=1)) / qmax
        codes = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax - 1,
                            qmax).reshape(wc.shape).to(torch.int32)
        row(f"quantize_int b{bits}", Q.quantize_int(wc, bits, QUANT_GROUP),
            Q.quantize_int(w, bits, QUANT_GROUP), (codes, scale))
    for bits in Q.SUPPORTED_BITS:
        row(f"quantize b{bits}", Q._group_codes(wc, bits, QUANT_GROUP, None),
            Q._group_codes(w, bits, QUANT_GROUP, None),
            Q._group_codes(wc, bits, QUANT_GROUP, parent_codebook(bits)))
    for bits in range(1, 9):
        row(f"uniform codebook b{bits}",
            (Q._uniform_codebook(bits, device="cuda"),),
            (Q._uniform_codebook(bits),), (parent_codebook(bits),))
        row(f"nf codebook b{bits}", (Q.nf_codebook(bits, device="cuda"),),
            (Q.nf_codebook(bits),), (Q.nf_codebook(bits, device="cuda"),))
    res["quantizers"] = rows
    apart = {k: v for k, v in rows.items() if v["differ"]}
    log(f"[families] (e) quantizers card vs CPU: "
        f"{sum(v['elements'] for v in rows.values())} elements over "
        f"{len(rows)} outputs, {sum(v['differ'] for v in rows.values())} "
        f"apart; the formula before true division: "
        + ", ".join(f"{k} {v['differ_parent']} of {v['elements']}"
                    for k, v in rows.items() if v["differ_parent"]))
    if apart:
        fail(f"families (e): quantizers differ on the card: {apart}")


def phase_families(rt):
    import torch
    timer = Timer(torch)
    res = rt["families"] = {}
    seconds = res["seconds"] = {}
    subs = [("llama2_7b", lambda: family_full(torch, timer, "llama2_7b",
                                              res)),
            ("granite_moe_1b_a400m", lambda: family_full(
                torch, timer, "granite_moe_1b_a400m", res))]
    subs += [(f"{a} (cut)", lambda a=a: family_cut(torch, a, res))
             for a in FAMILY_CUT]
    subs += [(f"{a} smoke", lambda a=a: family_narrow(torch, timer, a, res))
             for a in NARROW]
    subs.append(("narrow timing", lambda: narrow_timing(torch, timer, res)))
    subs.append(("quantizers", lambda: quant_card_vs_cpu(torch, res)))
    for name, fn in subs:
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        log(f"[families] {name}: {seconds[name]:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: the hybrid, recurrent, vision and encoder-decoder families
# ---------------------------------------------------------------------------

# the decode cache's ring: phi-3-vision's holds its 576 prefix rows, the
# prompt and the new tokens
CACHE_LEN = {"vision": 1024}
# whisper: the decoder's ring, its greedy steps, and the 4-bit policy the
# engine would use (the reference's launcher refuses encdec, so whisper is
# quantized and served through models/encdec.py directly)
WHISPER = "whisper_large_v3"
WHISPER_RING, WHISPER_STEPS = 512, 32
WHISPER_POLICY = dict(bits=4, group_size=128, min_size=1024)
# phi-3-vision: the lanes of its prefix prefill and its greedy steps
VISION = "phi_3_vision_4_2b"
VISION_LANES, VISION_STEPS = 8, 32


def cut_blocks(raw, cfg, nb):
    """The first ``nb`` blocks of a raw decoder tree (an xlstm block is a
    super-block of ``slstm_every`` layers) and the config cut to them."""
    import dataclasses
    per = cfg.slstm_every if cfg.family == "ssm" else 1
    out, _ = cut_layers(raw, cfg, nb)
    return out, dataclasses.replace(cfg, n_layers=nb * per)


def attn_per_step(cfg) -> int:
    """Decode attentions per step: one per layer, none for xlstm."""
    return 0 if cfg.family == "ssm" else cfg.n_layers


def plain_step(torch, timer, params, cfg):
    """The f32 weight matmuls of hymba's decode step (every leaf ``mm``
    takes as a plain ``x @ w``: those whose K the group does not divide)
    at M 8, as one graph (flush), and their bytes."""
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import flatten_with_paths
    names = ("['wq']", "['wk']", "['wv']", "['wo']", "['w_gate']",
             "['w_up']", "['w_down']", "['w_in']", "['w_bcdt']", "['w_dt']",
             "['w_out']")
    ws = [w for _, layer in lm.iter_layers(params)
          for p, w in flatten_with_paths(layer)
          if p.endswith(names) and isinstance(w, torch.Tensor)]
    if isinstance(params.get("lm_head"), torch.Tensor):
        ws.append(params["lm_head"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    xk = {k: torch.randn((8, k), device="cuda", generator=gen)
          for k in {w.shape[0] for w in ws}}
    ms = timer(lambda: [xk[w.shape[0]] @ w for w in ws])
    return dict(calls=len(ws), graph_ms=ms,
                bytes=sum(4 * w.numel() for w in ws))


def mlstm_state_step(torch, timer, cache, cfg):
    """The mLSTM state updates of one decode step (every mLSTM layer's
    ``mlstm_step`` at the cache's lanes, random q / k / v and gates) as
    one graph (flush), and the bytes of the states they read and write."""
    from repro_torch.models.xlstm import mlstm_step
    states = [st for name, st in cache["layers"].items()
              if name.startswith("mlstm")]
    b, h, dh = states[0].n.shape[1:]
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = [torch.randn((b, h, dh), device="cuda", generator=gen)
           for _ in range(3)]
    ifg = [torch.randn((b, h), device="cuda", generator=gen)
           for _ in range(2)]
    calls = [(st.c[i], st.n[i], st.m[i]) for st in states
             for i in range(st.c.shape[0])]
    ms = timer(lambda: [mlstm_step(c, n, m, *qkv, *ifg)
                        for c, n, m in calls])
    return dict(layers=len(calls), graph_ms=ms,
                state_bytes=sum(2 * 4 * c.numel() for c, _, _ in calls))


def recurrent_full(torch, timer, arch, res):
    """(a) / (b): hymba or xlstm at full width and depth on the ring:
    phase 4's 16 requests (exact-length prefill); one prefill pass and two
    decode steps with every launch held and counted exactly; the step's
    device time as a graph and its eager wall; hymba's f32 matmuls and
    attentions as graphs, xlstm's mLSTM state updates as a graph and its
    requests again under uniform:4a8 (the int LUT-GEMV, every launch
    held)."""
    import gc
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import flatten_with_paths
    from repro_torch.serving.engine import Engine, EngineConfig
    rec = res[arch] = {}
    t0 = time.perf_counter()
    cfg, raw = family_model(torch, arch)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["raw_gb"] = sum(4 * t.numel() for _, t in flatten_with_paths(raw)) / 1e9
    attn = attn_per_step(cfg)
    cut = cut_blocks(raw, cfg, 1 if cfg.family == "ssm" else 2)
    ring = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
    a8 = (Engine(raw, cfg, EngineConfig(**dict(RING, plan="uniform:4a8")),
                 device="cuda") if cfg.family == "ssm" else None)
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    quantized = sorted(p for p, w in flatten_with_paths(ring.params)
                       if not isinstance(w, torch.Tensor))
    rec["quantized_paths"] = quantized
    dec, pre = lut_calls(ring.params)
    log(f"[others] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, f32 init "
        f"on the card ({rec['raw_gb']:.2f} GB) {rec['init_s']:.1f} s; "
        f"uniform:4 at group 128 quantizes {len(quantized)} leaves "
        f"({ring.compression:.2f}x smaller): {dec} LUT-GEMV per decode step,"
        f" {attn} attentions")
    prompts = engine_requests(cfg)
    _, rec["ring"] = serve_families(torch, ring, prompts, cfg,
                                    f"{arch} ring", FAMILY_NEW, table=False,
                                    attn=attn)
    toks, lengths = model_prompts(cfg)
    t0 = time.perf_counter()
    _, _, rec["held"] = held_passes(torch, lm, ring.params, cfg, toks,
                                    lengths, 2, f"{arch} held", attn=attn)
    h = rec["held"]
    log(f"[others] {arch}: one prefill pass [2, 48] and two decode steps at "
        f"full depth, every launch held in {time.perf_counter() - t0:.1f} s: "
        f"exactly {h['lut_per_prefill']} / {h['lut_per_decode_step']} "
        f"LUT-GEMV per prefill pass / decode step and {attn} attentions per "
        f"step; {h['held_lut']} LUT-GEMV within rtol {F32_RTOL} / atol "
        f"{F32_ATOL} (max abs err {h['max_abs_err_lut']:.3e}), "
        f"{h['held_attention']} attentions within {ATTN_TOL} (max abs err "
        f"{h['max_abs_err_attention']:.3e})")
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    one_step = lambda: lm.decode_step(ring.params, tok, ring.cache, cfg,
                                      quant_kv=True, device="cuda")
    rec["step_device_ms"] = timer(one_step)
    rec["step_wall_ms"] = timer.call_ms(one_step, iters=10)
    rec["lut_step"] = lut_step(torch, timer, ring.params)
    line = (f"[others] {arch} on {card_line()}: one full-pool decode step (8 "
            f"lanes): device {rec['step_device_ms']:.3f} ms as a graph, eager"
            f" wall {rec['step_wall_ms']:.3f} ms; decode "
            f"{rec['ring']['decode_tok_per_s']:.1f} tok/s in the ring run "
            f"({rec['ring']['prefill_passes']} exact-length prefill passes); "
            f"its {rec['lut_step']['calls']} LUT-GEMV calls (M 8) as one "
            f"graph {rec['lut_step']['step_graph_ms']:.4f} ms (bound "
            f"{rec['lut_step']['bound_ms']:.4f} ms by "
            f"{rec['lut_step']['bound_by']})")
    if cfg.family == "hybrid":
        rec["attention_step"] = attention_step(torch, timer, ring.cache, cfg)
        rec["f32_step"] = plain_step(torch, timer, ring.params, cfg)
        a, f = rec["attention_step"], rec["f32_step"]
        line += (f"; its {f['calls']} f32 matmuls (x @ w, M 8, "
                 f"{f['bytes'] / 1e9:.3f} GB) as one graph "
                 f"{f['graph_ms']:.4f} ms = "
                 f"{100 * f['graph_ms'] / rec['step_device_ms']:.1f}% of the "
                 f"step; its {a['calls']} attentions (G 5, D 64) as one graph"
                 f" {a['step_graph_ms']:.4f} ms (bound {a['bound_ms']:.4f} ms"
                 f" by {a['bound_by']})")
    else:
        rec["mlstm_state"] = m = mlstm_state_step(torch, timer, ring.cache,
                                                  cfg)
        line += (f"; its {m['layers']} mLSTM state updates (C [8, 4, 512, "
                 f"512], {m['state_bytes'] / 1e9:.3f} GB read and written) "
                 f"as one graph {m['graph_ms']:.4f} ms = "
                 f"{100 * m['graph_ms'] / rec['step_device_ms']:.1f}% of the "
                 f"step (bytes bound "
                 f"{m['state_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    log(line)
    del ring
    gc.collect()
    torch.cuda.empty_cache()
    if a8 is not None:
        with Held(torch, f"{arch} uniform:4a8") as held:
            got8, rec["ring 4a8"] = serve_families(
                torch, a8, prompts, cfg, f"{arch} ring uniform:4a8",
                FAMILY_NEW,
                table=False, attn=attn, lut="lut_matmul_int")
        rec["ring 4a8"].update(held_lut=sum(held.calls.values()),
                               max_abs_err_lut=held.err["int"])
        log(f"[others] {arch} uniform:4a8: {rec['ring 4a8']['held_lut']} int "
            f"LUT-GEMV launches held within rtol {LUT_RTOL} / atol "
            f"{LUT_ATOL} (max abs err {held.err['int']:.3e})")
        del a8
        gc.collect()
        torch.cuda.empty_cache()
    raw2, cfg2 = cut
    params2, _, _ = quantize_params_card(raw2)
    del raw2
    rec["card_vs_cpu"] = card_vs_cpu(torch, lm, params2, cfg2,
                                     f"{arch} at {cfg2.n_layers} layers",
                                     attn=attn_per_step(cfg2))
    return rec


def quantize_params_card(raw):
    from repro_torch.models.sail_linear import QuantPolicy, quantize_params
    return quantize_params(raw, QuantPolicy(bits=4, group_size=128,
                                            min_size=1024))


def vision_prefix(torch, cfg, b, seed=3):
    """``b`` lanes of prefix embeddings (the stubbed CLIP patches), from a
    seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.vision_tokens, cfg.d_model), device="cuda",
                       generator=gen)


def vision_full(torch, timer, res):
    """(c): phi-3-vision at full width and depth: phase 4's requests
    text-only on the ring and on the paged pool (tokens equal); 8 lanes
    through ``lm.prefill`` with 576 prefix embeddings, then 32 greedy
    decode steps, every launch held and counted exactly; the prefill's
    and the step's times; the model cut to 2 layers card against CPU
    (with the prefix)."""
    import gc
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    rec = res[VISION] = {}
    t0 = time.perf_counter()
    cfg, raw = family_model(torch, VISION)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    raw2, cfg2 = cut_layers(raw, cfg, 2)
    ring = Engine(raw, cfg, EngineConfig(**RING), device="cuda")
    paged = Engine(raw, cfg, EngineConfig(**RING, **FAMILY_PAGED),
                   device="cuda")
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    prompts = engine_requests(cfg)
    got, rec["ring"] = serve_families(torch, ring, prompts, cfg,
                                      f"{VISION} ring (text only)",
                                      FAMILY_NEW, table=False)
    pg, rec["paged"] = serve_families(torch, paged, prompts, cfg,
                                      f"{VISION} paged (text only)",
                                      FAMILY_NEW, table=True)
    rec["paged_equal_ring"] = sum(pg[u] == got[u] for u in got)
    if pg != got:
        fail(f"{VISION}: paged tokens differ from the ring engine's")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    # 8 lanes: 576 prefix rows, then phase 4's first 8 prompts right-padded
    lens = np.array([len(p) for p in prompts[:VISION_LANES]], np.int32)
    toks = np.zeros((VISION_LANES, int(lens.max())), np.int64)
    for i, p in enumerate(prompts[:VISION_LANES]):
        toks[i, :len(p)] = p
    prefix = vision_prefix(torch, cfg, VISION_LANES)
    cl = CACHE_LEN["vision"]
    logits, cache = lm.prefill(ring.params, toks, cfg, cl, True, lens,
                               device="cuda", prefix_embeds=prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(ring.params, toks, cfg, cl, True, lens,
                               device="cuda", prefix_embeds=prefix)
    torch.cuda.synchronize()
    rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    rec["prefill_rows"] = [VISION_LANES, cfg.vision_tokens + toks.shape[1]]
    t0 = time.perf_counter()
    gl, gt, rec["held"] = held_passes(
        torch, lm, ring.params, cfg, toks, lens, VISION_STEPS,
        f"{VISION} prefix", prefix=prefix, cache_len=cl)
    h = rec["held"]
    if not torch.isfinite(gl).all() or tuple(gl.shape) != (
            VISION_STEPS + 1, VISION_LANES, cfg.vocab):
        fail(f"{VISION}: prefix logits not finite or of shape {gl.shape}")
    rec["prefix_tokens"] = gt.T.tolist()
    log(f"[others] {VISION}: 8 lanes of {cfg.vision_tokens} prefix embeddings"
        f" and prompts of {lens.tolist()} tokens (T {rec['prefill_rows'][1]}"
        f"), prefill {rec['prefill_ms']:.1f} ms eager, then {VISION_STEPS} "
        f"greedy decode steps, every launch held in "
        f"{time.perf_counter() - t0:.1f} s: exactly {h['lut_per_prefill']} / "
        f"{h['lut_per_decode_step']} LUT-GEMV per prefill pass / step and "
        f"{h['attention_per_decode_step']} attentions per step; max abs err "
        f"{h['max_abs_err_lut']:.3e} LUT-GEMV, "
        f"{h['max_abs_err_attention']:.3e} attention")
    tok = torch.zeros((VISION_LANES, 1), dtype=torch.int64, device="cuda")
    one_step = lambda: lm.decode_step(ring.params, tok, cache, cfg,
                                      quant_kv=True, device="cuda")
    rec["step_device_ms"] = timer(one_step)
    rec["step_wall_ms"] = timer.call_ms(one_step, iters=10)
    rec["attention_step"] = attention_step(torch, timer, cache, cfg)
    rec["lut_step"] = lut_step(torch, timer, ring.params)
    step_log(VISION, cfg, rec)
    del ring, cache
    gc.collect()
    torch.cuda.empty_cache()
    params2, _, _ = quantize_params_card(raw2)
    del raw2
    rec["card_vs_cpu"] = card_vs_cpu(
        torch, lm, params2, cfg2, f"{VISION} at 2 layers",
        prefix=vision_prefix(torch, cfg2, 2))
    return rec


def whisper_frames(torch, cfg, b, seed=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.enc_seq, cfg.d_model), device="cuda",
                       generator=gen)


def whisper_held(torch, params, cfg, frames, steps, quant_kv, name):
    """``serve_prefill`` over ``frames`` and ``steps`` greedy
    ``serve_decode_step`` calls on the card, every launch held against its
    plain version and counted exactly: 6 LUT-GEMV per encoder layer and the
    cross wk / wv per decoder layer in prefill, 8 LUT-GEMV and 2 attentions
    (the self-attention's ring, the cross-attention's lengths mode) per
    decoder layer per step.  Returns (logits [steps, B, V], tokens, cross
    K/V on the host, record)."""
    from repro_torch.kernels import _build
    from repro_torch.models import encdec
    le, ld = cfg.n_enc_layers, cfg.n_layers
    want_pre, want_dec, want_attn = 6 * le + 2 * ld, 8 * ld, 2 * ld
    passes = []
    b = frames.shape[0]
    with Held(torch, name) as held, HeldAttn(torch, name) as held_attn:
        _build.reset_launches()
        t0 = time.perf_counter()
        cache = encdec.serve_prefill(params, frames, cfg, WHISPER_RING,
                                     quant_kv, device="cuda")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        passes.append(dict(_build.launches))
        cross = (cache["layers"]["ck"][:, :, :4].cpu(),
                 cache["layers"]["cv"][:, :, :4].cpu())
        tok = torch.full((b, 1), 1, dtype=torch.int64, device="cuda")
        out_l, out_t = [], []
        for _ in range(steps):
            _build.reset_launches()
            logits, cache = encdec.serve_decode_step(params, tok, cache, cfg,
                                                     quant_kv, device="cuda")
            passes.append(dict(_build.launches))
            out_l.append(logits.float().cpu())
            tok = torch.argmax(logits, dim=-1)[:, None]
            out_t.append(tok[:, 0].cpu())
    for i, c in enumerate(passes):
        want = (want_pre, 0) if i == 0 else (want_dec, want_attn)
        if ((c["lut_matmul"], c["decode_attention"]) != want
                or c["lut_matmul_int"] or c["decode_attention_table"]):
            fail(f"{name}: pass {i} launched {c}; want LUT-GEMV {want[0]}, "
                 f"decode attention {want[1]}, nothing else")
    rec = dict(lut_per_prefill=want_pre, lut_per_decode_step=want_dec,
               attention_per_decode_step=want_attn, held_prefill_s=prefill_s,
               held_lut=sum(held.calls.values()),
               held_attention=held_attn.calls,
               max_abs_err_lut=held.err["f32"],
               max_abs_err_attention=held_attn.err,
               launches=dict(sum((collections.Counter(c) for c in passes),
                                 collections.Counter())))
    return torch.stack(out_l), torch.stack(out_t), cross, rec


def whisper_cpu(torch, params, cfg, frames, steps, quant_kv):
    """The same passes on the CPU (plain versions, the dequantized weights
    from the card): (logits, tokens, cross K/V)."""
    from repro_torch.models import encdec
    cache = encdec.serve_prefill(params, frames.cpu(), cfg, WHISPER_RING,
                                 quant_kv, device="cpu")
    cross = (cache["layers"]["ck"][:, :, :4].clone(),
             cache["layers"]["cv"][:, :, :4].clone())
    tok = torch.full((frames.shape[0], 1), 1, dtype=torch.int64)
    out_l, out_t = [], []
    for _ in range(steps):
        logits, cache = encdec.serve_decode_step(params, tok, cache, cfg,
                                                 quant_kv, device="cpu")
        out_l.append(logits.float())
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_t.append(tok[:, 0])
    return torch.stack(out_l), torch.stack(out_t), cross


def cross_attention_step(torch, timer, cache, cfg):
    """The decode step's 32 cross-attentions (lengths mode over the f32
    cross K/V, every slot valid) on the cache as one graph (flush), beside
    their bytes bound and SDPA on the same K/V (laid out [B, KV, S, D]
    beforehand, not timed)."""
    from repro_torch.models.encdec import cross_attend
    ck, cv = cache["layers"]["ck"], cache["layers"]["cv"]
    l, b, s, kv, d = ck.shape
    q = torch.randn((b, cfg.n_heads, d), device="cuda")
    ms = timer(lambda: [cross_attend(q, ck[i], cv[i]) for i in range(l)])
    nbytes = l * (2 * 4 * ck[0].numel() + 2 * 4 * q.numel())
    bound, by = bound_ms(nbytes, l * 4 * b * s * cfg.n_heads * d)
    kt = [ck[i].transpose(1, 2).contiguous() for i in range(l)]
    vt = [cv[i].transpose(1, 2).contiguous() for i in range(l)]
    q4 = q[:, :, None, :]
    sdpa = timer(lambda: [torch.nn.functional.scaled_dot_product_attention(
        q4, kt[i], vt[i], enable_gqa=True) for i in range(l)])
    del kt, vt
    return dict(calls=l, graph_ms=ms, sdpa_graph_ms=sdpa, bound_ms=bound,
                bound_by=by, bytes=nbytes)


def lut_rows_m(torch, timer, params, m):
    """The LUT-GEMV at M = ``m`` (the encoder's rows) on one encoder
    layer's w_up and w_down, each beside torch.matmul on the dequantized
    weight and its bound."""
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda
    from repro_torch.models import lm
    layer = lm.layer_params(params["enc_blocks"], 0)["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name in ("w_up", "w_down"):
        qt = layer[name]
        x = torch.randn((m, qt.k), device="cuda", generator=gen)
        wd = dequantize(qt)
        nbytes = 4 * (qt.packed.numel() + qt.scales.numel()) + 4 * m * (
            qt.k + qt.n)
        bound, by = bound_ms(nbytes, 2 * m * qt.k * qt.n)
        rows[f"{name} K{qt.k} N{qt.n}"] = dict(
            ms=timer(lambda: lut_matmul_cuda(x, qt), iters=10),
            library_ms=timer(lambda: torch.matmul(x, wd), iters=10),
            bound_ms=bound, bound_by=by)
    return rows


def whisper_full(torch, timer, res):
    """(d): whisper at full width and depth (32 + 32 layers): quantized on
    the card, ``serve_prefill`` over 8 lanes of 1500 frames and 32 greedy
    ``serve_decode_step`` calls, every launch held and counted exactly; the
    encoder pass, the step, the cross-attentions and the LUT-GEMV at the
    encoder's M timed; then cut to 2 + 2 layers, card against CPU."""
    import dataclasses
    import gc
    import repro_torch.configs as C
    from repro_torch.models import encdec
    from repro_torch.models.sail_linear import (QuantPolicy,
                                                flatten_with_paths,
                                                quantize_params, _walk)
    rec = res[WHISPER] = {}
    cfg = C.get_config(WHISPER)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    raw = encdec.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    cut = dict(raw)
    for name in ("enc_blocks", "dec_blocks"):
        cut[name] = _walk(raw[name], lambda _, x: x[:2].clone())
    cfg2 = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    params, b0, b1 = quantize_params(raw, QuantPolicy(**WHISPER_POLICY))
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    rec["compression"] = b0 / b1
    dec_bytes = sum(4 * (w.packed.numel() + w.scales.numel())
                    if hasattr(w, "packed") else 4 * w.numel()
                    for _, w in flatten_with_paths(params["dec_blocks"]))
    rec["decoder_weight_gb"] = dec_bytes / 1e9
    frames = whisper_frames(torch, cfg, 8)
    t0 = time.perf_counter()
    gl, gt, _, rec["held"] = whisper_held(
        torch, params, cfg, frames, WHISPER_STEPS, True, f"{WHISPER} held")
    h = rec["held"]
    if not torch.isfinite(gl).all() or tuple(gl.shape) != (
            WHISPER_STEPS, 8, cfg.vocab):
        fail(f"{WHISPER}: logits not finite or of shape {gl.shape}")
    rec["tokens"] = gt.T.tolist()
    log(f"[others] {WHISPER}: serve_prefill over 8 x {cfg.enc_seq} frames and"
        f" {WHISPER_STEPS} greedy decode steps, every launch held in "
        f"{time.perf_counter() - t0:.1f} s: exactly {h['lut_per_prefill']} "
        f"LUT-GEMV per prefill (the encoder's at M {8 * cfg.enc_seq}, the "
        f"cross K/V's), {h['lut_per_decode_step']} LUT-GEMV and "
        f"{h['attention_per_decode_step']} attentions (ring + lengths mode) "
        f"per step; max abs err {h['max_abs_err_lut']:.3e} LUT-GEMV, "
        f"{h['max_abs_err_attention']:.3e} attention; tokens lane 0 "
        f"{rec['tokens'][0][:8]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = encdec.serve_prefill(params, frames, cfg, WHISPER_RING, True,
                                 device="cuda")
    torch.cuda.synchronize()
    rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    encdec.encode(params, frames, cfg, device="cuda")
    torch.cuda.synchronize()
    rec["encoder_ms"] = (time.perf_counter() - t0) * 1e3
    tok = torch.ones((8, 1), dtype=torch.int64, device="cuda")
    for _ in range(4):
        encdec.serve_decode_step(params, tok, cache, cfg, True, device="cuda")
    one_step = lambda: encdec.serve_decode_step(params, tok, cache, cfg,
                                                True, device="cuda")
    rec["step_device_ms"] = timer(one_step)
    rec["step_wall_ms"] = timer.call_ms(one_step, iters=10)
    rec["cross_attention"] = x = cross_attention_step(torch, timer, cache,
                                                      cfg)
    rec["lut_m12000"] = lut_rows_m(torch, timer, params, 8 * cfg.enc_seq)
    log(f"[others] {WHISPER} on {card_line()}: encoder pass (8 x "
        f"{cfg.enc_seq} frames, 32 layers) {rec['encoder_ms']:.1f} ms eager, "
        f"serve_prefill {rec['prefill_ms']:.1f} ms; one decode step (8 lanes)"
        f" device {rec['step_device_ms']:.3f} ms as a graph, eager wall "
        f"{rec['step_wall_ms']:.3f} ms; its {x['calls']} cross-attentions "
        f"(S {cfg.enc_seq}, f32, {x['bytes'] / 1e9:.3f} GB) as one graph "
        f"{x['graph_ms']:.4f} ms = "
        f"{100 * x['graph_ms'] / rec['step_device_ms']:.1f}% of the step "
        f"(bound {x['bound_ms']:.4f} ms by {x['bound_by']}, SDPA "
        f"{x['sdpa_graph_ms']:.4f} ms); the decoder's weights "
        f"{rec['decoder_weight_gb']:.3f} GB; LUT-GEMV at M {8 * cfg.enc_seq}: "
        + ", ".join(f"{k} {r['ms']:.3f} ms (torch.matmul {r['library_ms']:.3f}"
                    f", bound {r['bound_ms']:.3f} by {r['bound_by']})"
                    for k, r in rec["lut_m12000"].items()))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    params2, _, _ = quantize_params(cut, QuantPolicy(**WHISPER_POLICY))
    del cut
    frames2 = whisper_frames(torch, cfg2, 2, seed=5)
    from repro_torch.models.sail_linear import map_tensors
    cpu = map_tensors(params2, lambda t: t.cpu())
    out = rec["card_vs_cpu"] = {}
    for kv in ("int8", "f32"):
        q = kv == "int8"
        gl, gt, gx, r = whisper_held(torch, params2, cfg2, frames2, 4, q,
                                     f"{WHISPER} 2 + 2 layers {kv} KV")
        t0 = time.perf_counter()
        with CardDequant(torch) as cd:
            cl, ct, cx = whisper_cpu(torch, cpu, cfg2, frames2, 4, q)
        per_pass = (gl - cl).abs().amax(dim=(1, 2)).tolist()
        cross_err = max((a - b).abs().max().item() for a, b in zip(gx, cx))
        r.update(logits_err_per_pass=per_pass, cross_kv_err=cross_err,
                 tokens_equal=bool(torch.equal(gt, ct)),
                 dequant_bit_equal=cd.checked,
                 cpu_s=time.perf_counter() - t0)
        out[f"{kv} KV"] = r
        log(f"[others] {WHISPER} at 2 + 2 layers, {kv} KV: card vs CPU "
            f"(2 x {cfg.enc_seq} frames, 4 decode steps): cross K/V max abs "
            f"err {cross_err:.3e}, logits per step "
            f"{', '.join(f'{e:.3e}' for e in per_pass)}; tokens equal "
            f"{r['tokens_equal']}; CPU {r['cpu_s']:.1f} s")
        held = gl if kv == "f32" else gl[:0]
        if (not r["tokens_equal"] or cross_err > MODEL_ATOL
                or not torch.allclose(held, cl[:len(held)], rtol=MODEL_RTOL,
                                      atol=MODEL_ATOL)):
            fail(f"{WHISPER} 2 + 2 layers, {kv} KV: card and CPU differ")
    return rec


def phase_others(rt):
    import torch
    timer = Timer(torch)
    res = rt["others"] = {}
    seconds = res["seconds"] = {}
    subs = [(arch, lambda a=arch: recurrent_full(torch, timer, a, res))
            for arch in ("hymba_1_5b", "xlstm_350m")]
    subs += [(VISION, lambda: vision_full(torch, timer, res)),
             (WHISPER, lambda: whisper_full(torch, timer, res)),
             ("attention rows", lambda: other_attention_rows(torch, timer,
                                                             res))]
    for name, fn in subs:
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        log(f"[others] {name}: {seconds[name]:.1f} s")


def other_attention_rows(torch, timer, res):
    """Decode attention at the new paths' shapes, each beside its plain
    version, SDPA and its bound: hymba's ring call (B 8, KV 5, G 5, D 64,
    S 512, int8, wrapped positions) and whisper's cross-attention call
    (lengths mode, f32, B 8, KV 20, G 1, D 64, S 1500, every slot valid)."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    position = torch.tensor([3, 300, 511, 512, 700, 1023, 1500, 2047],
                            dtype=torch.int32, device="cuda")
    x = attn_inputs(torch, gen, 512, b=8, kvh=5, g=5, d=64)
    rows = {"hymba ring G5 D64": attention_row(torch, timer, x, position,
                                               decode_attention_cuda)}
    b, s, kv, d = 8, 1500, 20, 64
    q = torch.randn((b, kv, d), device="cuda", generator=gen)
    k = torch.randn((b, s, kv, d), device="cuda", generator=gen)
    v = torch.randn((b, s, kv, d), device="cuda", generator=gen)
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lens, None, None, None, ring=False)
    err = (out - decode_attention_ref(q, k, v, lens)).abs().max().item()
    if err > ATTN_TOL:
        fail(f"cross-attention row: max err {err:.3e} above {ATTN_TOL}")
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = bound_ms(nbytes, 4 * b * s * kv * d)
    row = timings(
        timer,
        lambda: decode_attention_cuda(q, k, v, lens, None, None, None,
                                      ring=False),
        lambda: decode_attention_ref(q, k, v, lens),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kt, vt))
    row.update(s=s, valid_slots=b * s, bound_ms=bound, bound_by=by,
               bound_share=bound / row["ms"], max_abs_err=err)
    rows["whisper cross lengths f32 S1500"] = row
    for name, r in rows.items():
        log(f"[others] decode_attention {name}: {1e3 * r['ms']:.2f} us "
            f"(plain {1e3 * r['plain_ms']:.2f}, SDPA "
            f"{1e3 * r['library_ms']:.2f}, bound {1e3 * r['bound_ms']:.3f} "
            f"us by {r['bound_by']})")
    res["attention_rows"] = rows


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "tinymistral_248m"
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 512, 20     # (a): full width and depth
CUT_B, CUT_T, CUT_LAYERS = 2, 128, 2           # (b), (c): 2 layers
# (b): the card against the CPU over 3 steps; (c): a resumed run against
# an uninterrupted one (the card's embedding backward accumulates by
# atomics, so the two need not be bit-equal)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4        # step 1's gradients, of each leaf's max
RESUME_RTOL = 1e-6


class TimedStep:
    """A train step timed between two CUDA events on the stream (its
    device span, idle gaps included) and by the host's clock."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.ms, self.wall_ms = torch, fn, [], []

    def __call__(self, params, opt_state, batch):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.fn(params, opt_state, batch)
        end.record()
        end.synchronize()
        self.wall_ms.append((time.perf_counter() - t0) * 1e3)
        self.ms.append(start.elapsed_time(end))
        return out


def train_flops(cfg, b, t) -> dict:
    """f32 operations of one train step under remat: 6 x (the layers'
    matmul parameters + the head) x tokens, the layers' forward again
    (remat), and attention over the valid (causal, windowed) key
    positions: QK and PV, forward, backward (twice) and the recompute."""
    d, f = cfg.d_model, cfg.d_ff
    layer = (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
             + (3 if cfg.act in ("swiglu", "geglu") else 2) * d * f)
    head = d * cfg.vocab
    tokens = b * t
    w = cfg.window or t
    pairs = sum(min(i + 1, w) for i in range(t))
    attn = 4 * b * pairs * cfg.q_dim * cfg.n_layers     # one forward
    matmul = 6 * (layer * cfg.n_layers + head) * tokens
    remat = 2 * layer * cfg.n_layers * tokens
    return dict(matmul=matmul, remat=remat, attention=4 * attn,
                total=matmul + remat + 4 * attn)


def train_data(cfg, b, t):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                  global_batch=b))


def train_loop(torch, cfg, params, b, t, steps, ckpt=None, every=10 ** 9,
               timed=False):
    """A ``TrainLoop`` over ``build_train_step`` on ``params``' device
    (log every step); returns the loop and its (timed) step."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    dev = params["embed"].device
    built = build_train_step(cfg, microbatches=1, bf16_compute=False,
                             device=dev)
    step = TimedStep(torch, built.fn) if timed else built.fn
    loop = TrainLoop(step, params, built.meta["optimizer"].init(params),
                     train_data(cfg, b, t),
                     TrainLoopConfig(total_steps=steps, log_every=1,
                                     checkpoint_every=every,
                                     checkpoint_dir=ckpt))
    return loop, step


def train_full(torch, res):
    """(a): full width and depth, 20 steps of B 8 x T 512."""
    from repro_torch.tree import tree_leaves
    cfg, params = family_model(torch, TRAIN_ARCH)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop, step = train_loop(torch, cfg, params, TRAIN_B, TRAIN_T,
                            TRAIN_STEPS, timed=True)
    t0 = time.perf_counter()
    result = loop.run()
    seconds = time.perf_counter() - t0
    losses = [r["loss"] for r in result["log"]]
    gnorms = [r["grad_norm"] for r in result["log"]]
    if (result["final_step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)):
        fail(f"train: {result['final_step']} steps, losses {losses}")
    first, last = (statistics.mean(losses[:5]),
                   statistics.mean(losses[-5:]))
    if not last < first:
        fail(f"train: the loss did not fall: first 5 {first:.4f}, last 5 "
             f"{last:.4f} ({losses})")
    flops = train_flops(cfg, TRAIN_B, TRAIN_T)
    dev_ms = statistics.median(step.ms[1:])
    wall_ms = statistics.median(step.wall_ms[1:])
    bound_s = flops["total"] / F32_OPS_PER_S
    rec = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, params=n_params,
               batch=TRAIN_B, seq=TRAIN_T, steps=TRAIN_STEPS,
               losses=losses, grad_norms=gnorms, first5=first, last5=last,
               step_device_ms=step.ms, step_wall_ms=step.wall_ms,
               median_step_device_ms=dev_ms, median_step_wall_ms=wall_ms,
               first_step_wall_ms=step.wall_ms[0],
               tok_per_s=TRAIN_B * TRAIN_T / (wall_ms / 1e3),
               flops=flops, bound_ms=bound_s * 1e3,
               share_of_f32_peak=bound_s * 1e3 / dev_ms,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, seconds=seconds)
    res["full"] = rec
    log(f"[train] (a) {TRAIN_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, {n_params / 1e6:.1f}M params, f32, remat): "
        f"{TRAIN_STEPS} steps of B {TRAIN_B} x T {TRAIN_T} in "
        f"{seconds:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean of first 5 {first:.4f}, last 5 {last:.4f}); median step "
        f"{wall_ms:.1f} ms eager wall, {dev_ms:.1f} ms device (CUDA events;"
        f" first step {step.wall_ms[0]:.1f} ms); "
        f"{rec['tok_per_s']:.0f} tok/s; {flops['total'] / 1e12:.3f} TFLOP "
        f"per step (matmul {flops['matmul'] / 1e12:.3f}, remat "
        f"{flops['remat'] / 1e12:.3f}, attention "
        f"{flops['attention'] / 1e12:.3f}): bound {rec['bound_ms']:.1f} ms "
        f"at 67 TFLOP/s = {100 * rec['share_of_f32_peak']:.1f}% of f32 "
        f"peak; max memory allocated "
        f"{rec['max_memory_allocated_gb']:.2f} GB")
    return cfg, loop.params


def train_card_vs_cpu(torch, res):
    """(b): 2 layers of the full width, 3 steps of B 2 x T 128 from the
    same weights on the card and on the CPU."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map
    cfg, params = family_model(torch, TRAIN_ARCH, layers=CUT_LAYERS)
    raw = params_to_numpy(params)
    batch = {k: torch.from_numpy(v) for k, v in
             train_data(cfg, CUT_B, CUT_T).next_batch().items()}
    out = {}
    for dev in ("cuda", "cpu"):
        p = params_from_numpy(raw, device=dev)
        fp = tree_map(lambda x: x.detach().requires_grad_(), p)
        loss, _ = lm.loss_fn(fp, batch, cfg, device=dev)
        grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                      tree_leaves(fp))]
        loop, _ = train_loop(torch, cfg, p, CUT_B, CUT_T, 3)
        loop.run()
        out[dev] = (grads, loop.metrics_log,
                    [x.cpu() for x in tree_leaves(loop.params)])
    (gc, lc, pc), (gp, lp, pp) = out["cuda"], out["cpu"]
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(gc, gp))
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(lc, lp))
    gnorm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(
        b["grad_norm"]) for a, b in zip(lc, lp))
    param_err = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    rec = dict(layers=CUT_LAYERS, batch=CUT_B, seq=CUT_T, steps=3,
               card_losses=[r["loss"] for r in lc],
               cpu_losses=[r["loss"] for r in lp],
               loss_rel_err=loss_err, grad_norm_rel_err=gnorm_err,
               step1_grad_err_of_leaf_max=grad_err,
               max_param_abs_diff_after_3=param_err)
    res["card_vs_cpu"] = rec
    log(f"[train] (b) {CUT_LAYERS} layers, B {CUT_B} x T {CUT_T}, 3 "
        f"steps, card vs CPU: losses {rec['card_losses']} / "
        f"{rec['cpu_losses']} (worst {loss_err:.2e} relative, tolerance "
        f"{TRAIN_LOSS_RTOL}); grad norm worst {gnorm_err:.2e} relative; "
        f"step 1's gradients worst {grad_err:.2e} of a leaf's max "
        f"(tolerance {TRAIN_GRAD_TOL}); largest parameter difference "
        f"after 3 steps {param_err:.3e}")
    if (loss_err > TRAIN_LOSS_RTOL or gnorm_err > TRAIN_LOSS_RTOL
            or grad_err > TRAIN_GRAD_TOL):
        fail("train: the card and the CPU differ beyond the tolerances")


def train_resume(torch, res):
    """(c): 4 steps with checkpoints every 2, then a new loop restores and
    runs to step 8, against one uninterrupted 8-step run."""
    ckpt = os.path.join(OUT_DIR, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        cfg, params = family_model(torch, TRAIN_ARCH, layers=CUT_LAYERS)
        whole, _ = train_loop(torch, cfg, params, CUT_B, CUT_T, 8)
        want = [r["loss"] for r in whole.run()["log"]]
        t0 = time.perf_counter()
        a, _ = train_loop(torch, cfg, params, CUT_B, CUT_T, 4, ckpt=ckpt,
                          every=2)
        a.run()
        _, fresh = family_model(torch, TRAIN_ARCH, layers=CUT_LAYERS)
        b, _ = train_loop(torch, cfg, fresh, CUT_B, CUT_T, 8, ckpt=ckpt)
        restored = b.maybe_restore()
        at = b.step
        got = [r["loss"] for r in b.run()["log"]]
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    err = max(abs(x - y) / abs(y) for x, y in zip(got, want[4:]))
    rec = dict(restored=restored, restored_step=at, resumed_losses=got,
               uninterrupted_losses=want[4:], rel_err=err,
               bit_equal=got == want[4:], seconds=seconds)
    res["resume"] = rec
    log(f"[train] (c) resume on the card: restored at step {at}; steps 5-8 "
        f"{got} against uninterrupted {want[4:]} (worst {err:.2e} "
        f"relative, tolerance {RESUME_RTOL}; bit-equal "
        f"{rec['bit_equal']}); checkpoint runs {seconds:.1f} s")
    if not restored or at != 4 or len(got) != 4 or err > RESUME_RTOL:
        fail("train: the resumed run differs from the uninterrupted one")


def train_serve(torch, cfg, trained, res):
    """(d): the tree trained in (a) quantized ``uniform:4`` and served by the
    engine (ring, int8 KV): 8 requests of 16 new tokens, every launch held
    and counted exactly; its 2-layer cut card against CPU."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    eng = Engine(trained, cfg, EngineConfig(
        batch_size=8, cache_len=512, quant_kv=True, plan="uniform:4",
        group_size=128), device="cuda")
    with Held(torch, "train serve") as held, \
            HeldAttn(torch, "train serve") as held_attn:
        got, counts, dt = serve_counted(torch, eng,
                                        engine_requests(cfg)[:8], 16)
    st = eng.stats()
    dec, pre = lut_calls(eng.params)
    steps, passes = st["decode_iterations"], st["prefill_iterations"]
    want = dict(lut_matmul=dec * steps + pre * passes,
                decode_attention=cfg.n_layers * steps)
    if (len(got) != 8 or any(len(t) != 16 for t in got.values())
            or any(not 0 <= x < cfg.vocab for t in got.values() for x in t)
            or any(counts[k] != v for k, v in want.items())
            or counts["lut_matmul_int"] or counts["decode_attention_table"]):
        fail(f"train serve: {len(got)} completions, launches {counts}, want "
             f"{want} ({dec} LUT-GEMV and {cfg.n_layers} attentions per "
             f"decode step, {pre} LUT-GEMV per prefill pass)")
    rec = dict(requests=8, max_new=16, seconds=dt, decode_steps=steps,
               prefill_passes=passes, lut_per_decode_step=dec,
               lut_per_prefill=pre, attention_per_decode_step=cfg.n_layers,
               launches=counts, held_lut=sum(held.calls.values()),
               max_abs_err_lut=held.err["f32"],
               held_attention=held_attn.calls,
               max_abs_err_attention=held_attn.err,
               decode_tok_per_s=st["measured_tps"],
               first_tokens={u: t[:8] for u, t in sorted(got.items())})
    log(f"[train] (d) trained tree, uniform:4, ring, int8 KV: 8 requests x "
        f"16 tokens in {dt:.2f} s ({steps} decode steps, {passes} prefill "
        f"passes); launches {counts}, exactly {dec} LUT-GEMV and "
        f"{cfg.n_layers} attentions per decode step and {pre} LUT-GEMV per "
        f"prefill pass; every launch held ({rec['held_lut']} LUT-GEMV, max "
        f"abs err {held.err['f32']:.3e}; {held_attn.calls} attentions, "
        f"{held_attn.err:.3e}); first tokens "
        f"{[t[:4] for t in rec['first_tokens'].values()]}")
    cut, cfg2 = cut_layers(trained, cfg, CUT_LAYERS)
    rec["cut"] = card_vs_cpu(torch, lm, quantize_params_card(cut)[0], cfg2,
                             f"trained {TRAIN_ARCH} cut to {CUT_LAYERS}")
    res["serve"] = rec


# (e): the chunked attention against the one-pass form at T 4096, on a
# batch the one-pass form fits: tinymistral's heads over its window of
# 4096 (the full sweep) and hymba's window of 1024 (the band)
LONG_T, LONG_ATTN_B = 4096, 2
LONG_ATTN = {"tinymistral full sweep": dict(kv=8, g=4, d=32, window=4096),
             "hymba band": dict(kv=5, g=5, d=64, window=1024)}
LONG_ATTN_TOL = 2e-5         # of max(1, the one-pass form's largest value)
DEFAULT_SHAPE = "train_4k"
DEFAULT_ROWS = 16            # a cut of train_4k's 256 rows: one a microbatch
DEFAULT_BF16_RTOL = 2e-2     # the bf16 step's loss against the f32 step's


def long_attention(torch, res):
    """(e) (i): ``layers.chunked_attention`` (the training losses') against
    ``layers.flash_attention`` (one pass) at T 4096, values and the
    gradients of a seeded weighted sum, each form timed (second of two
    runs, forward and backward, CUDA events) with its peak memory."""
    from repro_torch.models import layers
    out = {}
    for name, c in LONG_ATTN.items():
        gen = torch.Generator(device="cuda").manual_seed(5)
        h = c["kv"] * c["g"]
        q, w = (torch.randn((LONG_ATTN_B, LONG_T, h, c["d"]), generator=gen,
                            device="cuda") for _ in range(2))
        k, v = (torch.randn((LONG_ATTN_B, LONG_T, c["kv"], c["d"]),
                            generator=gen, device="cuda") for _ in range(2))
        forms = {
            "one_pass": lambda q_, k_, v_: layers.flash_attention(
                q_, k_, v_, window=c["window"], causal=True),
            "chunked": lambda q_, k_, v_: layers.chunked_attention(
                q_, k_, v_, causal=True, window=c["window"], chunk=512)}
        got = {}
        for form, fn in forms.items():
            for _ in range(2):
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                y = fn(*leaves)
                grads = torch.autograd.grad(torch.sum(y * w), leaves)
                end.record()
                end.synchronize()
            got[form] = dict(
                out=y.detach(), grads=grads, ms=start.elapsed_time(end),
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        ref, new = got["one_pass"], got["chunked"]
        scale = lambda x: max(1.0, float(x.abs().max()))
        err = float((new["out"] - ref["out"]).abs().max()) / scale(
            ref["out"])
        grad_err = max(float((a - b).abs().max()) / scale(b)
                       for a, b in zip(new["grads"], ref["grads"]))
        band = LONG_T > 2 * (c["window"] + 512)
        rec = dict(b=LONG_ATTN_B, t=LONG_T, heads=h, **c, band=band,
                   max_err=err, max_grad_err=grad_err,
                   **{f"{f}_ms": g["ms"] for f, g in got.items()},
                   **{f"{f}_peak_gb": g["peak_gb"] for f, g in got.items()})
        out[name] = rec
        log(f"[train] (e) attention, {name} (B {LONG_ATTN_B}, T {LONG_T}, "
            f"H {h}, KV {c['kv']}, D {c['d']}, window {c['window']}, "
            f"{'band' if band else 'full sweep'}): chunked against one "
            f"pass {err:.3e} in values, {grad_err:.3e} in gradients (of "
            f"max(1, |max|), tolerance {LONG_ATTN_TOL}); forward and "
            f"backward {new['ms']:.1f} ms chunked, {ref['ms']:.1f} ms one "
            f"pass; peak {new['peak_gb']:.3f} / {ref['peak_gb']:.3f} GB "
            f"above the inputs; {card_line()}")
        if err > LONG_ATTN_TOL or grad_err > LONG_ATTN_TOL:
            fail(f"train: chunked attention ({name}) differs from the "
                 f"one-pass form")
        del got, q, k, v, w
    res["long_attention"] = out


def default_step(torch, res):
    """(e) (ii): ``build_train_step(cfg, None)`` for tinymistral at full
    width and depth with every argument at the reference's defaults
    (train_4k, bf16 compute, ``auto_microbatches``' count), one step on
    ``DEFAULT_ROWS`` rows of 4097 tokens, then the same step built at
    ``bf16_compute=False``: the microbatches run (loss calls and their
    rows) equal to ``auto_microbatches``', both losses finite, the masters
    f32, the two losses within 2e-2; each step's time, peak memory and
    kernel launches (none)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import SHAPES
    from repro_torch.launch.steps import auto_microbatches, build_train_step
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg, params = family_model(torch, TRAIN_ARCH)
    seq = SHAPES[DEFAULT_SHAPE]["seq"]
    batch = {k: torch.from_numpy(v) for k, v in
             train_data(cfg, DEFAULT_ROWS, seq).next_batch().items()}
    want_m = auto_microbatches(cfg, None, DEFAULT_SHAPE)
    flops = train_flops(cfg, DEFAULT_ROWS, seq)
    rows = []
    loss_fn = lm.loss_fn

    def counted(p, b, *a, **kw):
        rows.append(int(b["tokens"].shape[0]))
        return loss_fn(p, b, *a, **kw)

    out = {}
    for bf16 in (True, False):
        built = (build_train_step(cfg, None) if bf16 else
                 build_train_step(cfg, None, bf16_compute=False))
        opt_state = built.meta["optimizer"].init(params)
        rows.clear()
        lm.loss_fn = counted
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launches()
            step = TimedStep(torch, built.fn)
            new, _, m = step(params, opt_state, batch)
            launches = dict(_build.launches)
        finally:
            lm.loss_fn = loss_fn
        loss = float(m["loss"])
        masters = all(p.dtype == torch.float32
                      and bool(torch.isfinite(p).all())
                      for p in tree_leaves(new))
        rec = dict(bf16_compute=bf16,
                   microbatches=built.meta["microbatches"],
                   loss_rows=list(rows), loss=loss,
                   grad_norm=float(m["grad_norm"]), masters_f32=masters,
                   wall_ms=step.wall_ms[0], device_ms=step.ms[0],
                   base_gb=base / 1e9,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9, launches=launches,
                   f32_bound_ms=flops["total"] / F32_OPS_PER_S * 1e3)
        out["bf16" if bf16 else "f32"] = rec
        log(f"[train] (e) default step, {TRAIN_ARCH} full width and depth "
            f"({cfg.n_layers} layers), {DEFAULT_SHAPE}, bf16_compute={bf16}"
            f": {rec['microbatches']} microbatches (auto_microbatches "
            f"{want_m}; loss calls of {rows} rows), {DEFAULT_ROWS} x "
            f"{seq + 1} tokens (a cut of {SHAPES[DEFAULT_SHAPE]['batch']} "
            f"rows); loss {loss:.6f}, grad norm {rec['grad_norm']:.4f}; "
            f"step {rec['wall_ms']:.1f} ms wall, {rec['device_ms']:.1f} ms "
            f"device span; max memory allocated "
            f"{rec['max_memory_allocated_gb']:.2f} GB ({rec['base_gb']:.2f} "
            f"GB before the step); {flops['total'] / 1e12:.3f} TFLOP f32 "
            f"(matmul {flops['matmul'] / 1e12:.3f}, remat "
            f"{flops['remat'] / 1e12:.3f}, attention "
            f"{flops['attention'] / 1e12:.3f}): bound "
            f"{rec['f32_bound_ms']:.1f} ms at 67 TFLOP/s; kernel launches "
            f"{launches}; {card_line()}")
        if (rec["microbatches"] != want_m or rows != [DEFAULT_ROWS // want_m]
                * want_m or not math.isfinite(loss) or not masters
                or any(launches.values())):
            fail(f"train: the default step ({bf16=}) ran {rows} rows a "
                 f"microbatch for {want_m} microbatches, loss {loss}, "
                 f"masters f32 and finite {masters}, launches {launches}")
        del new, opt_state, built
        gc.collect()
        torch.cuda.empty_cache()
    err = abs(out["bf16"]["loss"] - out["f32"]["loss"]) / abs(
        out["f32"]["loss"])
    out["loss_rel_err"] = err
    log(f"[train] (e) bf16 loss against f32: {err:.3e} relative "
        f"(tolerance {DEFAULT_BF16_RTOL})")
    if err > DEFAULT_BF16_RTOL:
        fail("train: the bf16 default step's loss parts from the f32 step's")
    res["default_step"] = out


def phase_train(rt):
    import torch
    res = rt["train"] = {}
    seconds = res["seconds"] = {}
    t0 = time.perf_counter()
    cfg, trained = train_full(torch, res)
    seconds["full"] = time.perf_counter() - t0
    for name, fn in (("card_vs_cpu", lambda: train_card_vs_cpu(torch, res)),
                     ("resume", lambda: train_resume(torch, res)),
                     ("serve", lambda: train_serve(torch, cfg, trained,
                                                   res))):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    long_attention(torch, res)
    default_step(torch, res)
    seconds["defaults"] = time.perf_counter() - t0
    log(f"[train] seconds {seconds}")


# ---------------------------------------------------------------------------
# phase 14: data- and tensor-parallel training, quantized checkpoints
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_STEPS = 3                 # (a): steps to the checkpoint, then one more
DIST_PARAM_TOL = 1e-4          # (a): parameters after them, of a leaf's max
# (a): each element's update (after - init) against one device's, within
# DIST_UPDATE_TOL of its leaf's largest update plus one f32 ulp of the
# parameter per step; at most DIST_UPDATE_OUTLIERS of a leaf's elements
# may miss it (Adam's early steps are ~lr * sign(m): where the gradient
# lies within rounding of 0 the two runs can step apart); a leaf left at
# its init misses it in most elements
DIST_UPDATE_TOL = 1e-3
DIST_UPDATE_OUTLIERS = 1e-2
# (b): one layer's gradient shapes, two rounds
COMPRESS_SHAPES = {"wq": (1024, 1024), "w_up": (1024, 4096), "norm": (1024,)}
# (c): the 2-layer cut's mixed plan: wq at 4 bits in layer 0 and 6 in layer
# 1 (two segments), w_up's activations at 8 bits (the int LUT-GEMV)
CUT_ALLOCATION = dict(per_path={"['blocks']['attn']['wq']": (4, 6)},
                      act_per_path={"['blocks']['mlp']['w_up']": 8})
SERVE_FIELDS = dict(batch_size=8, cache_len=512, quant_kv=True)
# (e), (f): the tensor-parallel runs' mesh (data, model) and depth (None:
# full depth)
TP_TRAIN = {"e": ((1, 2), None), "f": ((2, 2), CUT_LAYERS)}
# (g): the other decoders trained tensor-parallel at (1, 2), full width,
# without a checkpoint (each rank's slices come back as a file): (config,
# depth (None: full), B, T, steps).  starcoder2's full depth is ~115 GB of
# f32 training state on one card, so its one-device reference forces the
# cut to 1 layer; mixtral's one full-width layer is ~27 GB for that
# reference alone, and its tensor-parallel path is granite's code, so it is
# held on the CPU only (tests/test_torch_tp_train.py)
TP_OTHERS = {"g_granite": ("granite_moe_1b_a400m", None, 8, 512, 3),
             "g_starcoder2": ("starcoder2_7b", 1, 4, 512, 2)}
# (g): a key bias's gradient is what is left once softmax cancels the part
# shared by every key of a query (only RoPE's rotation of the bias differs
# by key position, and its slow frequencies barely turn over T 512), so
# many of its elements lie within rounding of 0, where Adam's first steps
# (~lr * sign(m)) part two runs.  Its updates may miss the update check
# where its first moment (the gradients' average) is one device's within
# TRAIN_GRAD_TOL of the tree's largest, as tests/test_torch_train.py holds
# a key bias's gradient at the tree's largest gradient
KEY_BIAS = "['bk']"


class AllReduceLog:
    """Within the block, every ``torch.distributed.all_reduce`` of this
    process is timed, the card synchronized on both sides (a gloo
    all-reduce of CUDA tensors blocks the host anyway), and its bytes
    counted: [(bytes, seconds, wait seconds)].  A 1-element all-reduce on
    the same group goes first and is timed apart: the wait for the peers
    to reach the collective (on one card, their compute), so the seconds
    are the transfer's own."""

    def __init__(self, torch):
        import torch.distributed as dist
        self.torch, self.dist, self.calls = torch, dist, []
        self.groups = []            # each call's process group

    def __enter__(self):
        self.orig = self.dist.all_reduce

        def timed(t, *args, **kw):
            group = kw.get("group", args[1] if len(args) > 1 else None)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.orig(self.torch.zeros(1, device=t.device), group=group)
            t1 = time.perf_counter()
            out = self.orig(t, *args, **kw)
            self.torch.cuda.synchronize()
            self.calls.append((t.numel() * t.element_size(),
                               time.perf_counter() - t1, t1 - t0))
            self.groups.append(group)
            return out
        self.dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig
        return False


class MetricsStep:
    """A step function whose metrics (host floats) are kept per call."""

    def __init__(self, fn):
        self.fn, self.metrics = fn, []

    def __call__(self, params, opt_state, batch):
        out = self.fn(params, opt_state, batch)
        self.metrics.append({k: float(v) for k, v in out[2].items()})
        return out


class DispatchLog:
    """Within the block, the top-k experts of every MoE router call of this
    process are kept on the card (a copy each, no host sync inside the
    step); ``digest()`` hashes them in call order.

    With ``replay`` (another run's top-k experts, call by call) each call
    routes to the replayed experts instead, weighted by this run's own
    router logits (so the router's gradient is this run's), and counts
    the tokens whose own top-k set differs from the replayed one, with
    the largest margin between their k-th and (k+1)-th logits: a
    summation order that moves a logit by an ulp flips a near-tie, and
    capacity dispatch then reshuffles the experts' buffers, so two runs
    of the same model part without any fault; replaying one run's
    routing holds the rest of the other to it."""

    def __init__(self, replay=None):
        self.topi, self.replay = [], replay
        self.flips, self.margins = [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router_probs

        def kept(p, x, cfg):
            out = self.orig(p, x, cfg)
            logits, topi = out[0], out[2]
            self.topi.append(topi.detach().clone())
            if self.replay is None:
                return out
            want = self.replay[len(self.topi) - 1].to(topi.device,
                                                      torch.int64)
            k = cfg.top_k
            differ = (torch.sort(topi, -1).values
                      != torch.sort(want, -1).values).any(-1)
            top = torch.topk(logits.detach(), k + 1, dim=-1).values
            margin = top[..., k - 1] - top[..., k]
            self.flips.append(differ.sum())
            self.margins.append(torch.where(differ, margin,
                                            torch.zeros_like(margin)).amax())
            topv = torch.gather(logits, -1, want)
            return logits, topv, want, torch.softmax(topv, dim=-1)
        moe._router_probs = kept
        return self

    def __exit__(self, *exc):
        self.moe._router_probs = self.orig
        return False

    def digest(self) -> str:
        import hashlib
        h = hashlib.sha256()
        for t in self.topi:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def flipped(self) -> dict:
        """Under ``replay``: the tokens whose own top-k set differed from
        the replayed one, over all calls, and the largest margin between
        their k-th and (k+1)-th router logits."""
        return dict(calls=len(self.flips),
                    tokens=int(sum(int(f) for f in self.flips)),
                    of_tokens=sum(t.shape[0] for t in self.topi),
                    largest_margin=max((float(m) for m in self.margins),
                                       default=0.0))


def seeded_biases(torch, params):
    """(g): every bias (the attention's, the LayerNorms'), zeros at init as
    in the reference, drawn 0.1 N(0, 1) on the card, seeded by the leaf's
    path (the same on every process), as the CPU tests draw them: a bias added to the
    wrong heads then moves the loss, and each leaf's parameter error is
    measured against a parameter, not against its first updates."""
    import zlib
    from repro_torch.models.sail_linear import _walk

    def one(path, x):
        if not path.endswith(("['bq']", "['bk']", "['bv']", "['bo']",
                              "['bias']")):
            return x
        gen = torch.Generator(device=x.device).manual_seed(
            zlib.crc32(path.encode()))
        return 0.1 * torch.randn(x.shape, generator=gen, device=x.device)
    return _walk(params, one)


def tp_run(part):
    """(config, mesh (data, model), depth, B, T, steps) of a
    tensor-parallel run of phase 14."""
    if part in TP_TRAIN:
        shape, layers = TP_TRAIN[part]
        return TRAIN_ARCH, shape, layers, TRAIN_B, TRAIN_T, DIST_STEPS
    arch, layers, b, t, steps = TP_OTHERS[part]
    return arch, (1, 2), layers, b, t, steps


def compressed_rounds(torch, rank, world, dev, group):
    """(b): two rounds of ``make_compressed_allreduce`` on CUDA tensors
    over the data-parallel group, each rank's gradients drawn on the card
    from its seed; the same rounds computed plainly on the CPU for every
    rank (the reference's formulas: one scale per tensor, codes rounded
    half to even, the residual rounded once, the ranks summed in order).
    The codes and the error state must be bit-equal, the mean within one
    f32 ulp per element."""
    import numpy as np
    from repro_torch.dist.compress import (_quantize, init_error_state,
                                           make_compressed_allreduce)
    fn = make_compressed_allreduce(group)
    err, cpu_err = None, [None] * world
    rec = dict(rounds=2, shapes=COMPRESS_SHAPES, ms=[], codes_bit_equal=True,
               err_bit_equal=True, mean_max_ulps=0.0, elements=0)
    for rd in range(2):
        grads = []
        for r in range(world):
            gen = torch.Generator(device=dev).manual_seed(1000 * rd + r)
            grads.append({k: torch.randn(s, generator=gen, device=dev) * 1e-3
                          for k, s in COMPRESS_SHAPES.items()})
        mine = grads[rank]
        err = init_error_state(mine) if err is None else err
        codes = {k: _quantize(mine[k] + err[k])[0] for k in mine}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, err = fn(mine, err)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        ys = []
        for r in range(world):
            e = cpu_err[r] or {k: torch.zeros(s) for k, s in
                               COMPRESS_SHAPES.items()}
            x = {k: grads[r][k].cpu() + e[k] for k in e}
            y, cpu_err[r] = {}, {}
            for k, v in x.items():
                c, scale = _quantize(v)
                y[k] = c.to(torch.float32) * scale
                cpu_err[r][k] = (v.double() - c.double() * scale.double()
                                 ).to(torch.float32)
                if r == rank and not torch.equal(codes[k].cpu(), c):
                    rec["codes_bit_equal"] = False
            ys.append(y)
        for k in mine:
            want = ys[0][k]
            for r in range(1, world):
                want = want + ys[r][k]
            want = want / world
            got = mean[k].cpu()
            ulps = ((got - want).abs() / torch.from_numpy(
                np.spacing(want.abs().numpy()))).max()
            rec["mean_max_ulps"] = max(rec["mean_max_ulps"], float(ulps))
            rec["elements"] += want.numel()
            if not torch.equal(err[k].cpu(), cpu_err[rank][k]):
                rec["err_bit_equal"] = False
    if (not rec["codes_bit_equal"] or not rec["err_bit_equal"]
            or rec["mean_max_ulps"] > 1):
        fail(f"dist (b): the compressed all-reduce on the card differs from "
             f"its plain computation: {rec}")
    return rec


def mesh_rank_train(torch, rank, shape, layers, ckpt, arch=TRAIN_ARCH,
                    b=TRAIN_B, t=TRAIN_T, steps=DIST_STEPS, biases=False):
    """Phase 14's rank set-up: ``arch`` (tinymistral) at full width (cut
    to ``layers``; None: full depth) made on this rank's card from seed 0,
    its ``build_train_step`` over a ``(data, model)`` mesh of ``shape``
    (FSDP as ``make_plan`` decides), this rank's slices, and a
    ``TrainLoop`` of ``steps`` timed steps on global batches of B x T
    (phase 13's) whose final checkpoint goes to ``ckpt`` (None: none);
    ``biases``: ``seeded_biases``.  Run the loop inside ``with ars:`` and each step's all-reduces land in
    ``spans``.  Returns a dict
    of those objects and the parameter counts."""
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    from repro_torch.tree import tree_leaves
    dev = rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"))
    cfg, params = family_model(torch, arch, layers=layers)
    if biases:
        params = seeded_biases(torch, params)
    built = build_train_step(cfg, mesh=mesh, microbatches=1,
                             bf16_compute=False, device=dev)
    dp = built.meta["dp"]
    n_params = sum(p.numel() for p in tree_leaves(params))
    params = dp.shard(params)
    n_local = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timed = TimedStep(torch, built.fn)
    step = MetricsStep(timed)
    ars, spans = AllReduceLog(torch), []

    def marked(p, o, b):
        first = len(ars.calls)
        out = step(p, o, b)
        spans.append((first, len(ars.calls)))
        return out
    loop = TrainLoop(marked, params, built.meta["optimizer"].init(params),
                     train_data(cfg, b, t),
                     TrainLoopConfig(total_steps=steps, log_every=1,
                                     checkpoint_every=10 ** 9,
                                     checkpoint_dir=ckpt), dp=dp)
    return dict(dev=dev, mesh=mesh, cfg=cfg, built=built, dp=dp,
                plan=built.meta["plan"], loop=loop, timed=timed, step=step,
                ars=ars, spans=spans, params=n_params, local_params=n_local)


def step_records(run, kind=None) -> list:
    """Each step's wall time and device span, and its all-reduces: time,
    share of the step, the wait for the peers, bytes each; with ``kind``
    (call index -> name) their count, bytes and time by kind."""
    timed, ars = run["timed"], run["ars"]
    out = []
    for i, (first, end) in enumerate(run["spans"]):
        calls = ars.calls[first:end]
        ar_s = sum(c[1] for c in calls)
        wait_s = sum(c[2] for c in calls)
        rec = dict(
            wall_ms=timed.wall_ms[i], device_ms=timed.ms[i],
            allreduces=len(calls), allreduce_ms=ar_s * 1e3,
            allreduce_share=ar_s * 1e3 / timed.wall_ms[i],
            wait_ms=wait_s * 1e3, wait_share=wait_s * 1e3 / timed.wall_ms[i],
            allreduce_bytes=[c[0] for c in calls],
            allreduce_each_ms=[c[1] * 1e3 for c in calls],
            wait_each_ms=[c[2] * 1e3 for c in calls])
        if kind is not None:
            kinds = rec["kinds"] = {}
            for j in range(first, end):
                k = kinds.setdefault(kind(j), dict(count=0, bytes=0, ms=0.0))
                k["count"] += 1
                k["bytes"] += ars.calls[j][0]
                k["ms"] += ars.calls[j][1] * 1e3
        out.append(rec)
    return out


def dist_rank(rank, world, out_dir, ckpt, qdir):
    """One rank of phase 14 (every rank runs this; rank 0 logs and writes
    ``dist.json``): (a) full-width tinymistral trained data-parallel over
    gloo, all ranks on the one card, FSDP as ``make_plan`` decides, on the
    global batches of phase 13, a checkpoint after ``DIST_STEPS`` and one
    step more; (b) the compressed all-reduce; (c) rank 0 saves the
    checkpointed tree quantized under the engine's ``uniform:4`` plan."""
    import torch
    from repro_torch.checkpoint import save_quantized
    from repro_torch.launch.mesh import describe
    from repro_torch.serving.engine import Engine, EngineConfig
    t0 = time.perf_counter()
    seconds = {}
    run = mesh_rank_train(torch, rank, (world, 1), None, ckpt)
    dev, dp, loop, built = run["dev"], run["dp"], run["loop"], run["built"]
    plan, cfg = run["plan"], run["cfg"]
    seconds["init"] = time.perf_counter() - t0
    with run["ars"]:
        t0 = time.perf_counter()
        loop.run()         # 3 steps, then the checkpoint's gather and write
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, m4 = built.fn(loop.params, loop.opt_state,
                            loop.data.next_batch())
        m4 = {k: float(v) for k, v in m4.items()}
        seconds["step4"] = time.perf_counter() - t0
    rec = dict(group=describe(run["mesh"]), device=str(dev),
               plan=dict(dp_axes=plan.dp_axes, tp_axis=plan.tp_axis,
                         fsdp=plan.fsdp),
               params=run["params"], local_params=run["local_params"],
               metrics=run["step"].metrics, step4=m4,
               per_step=step_records(run),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 1e9, seconds=seconds)
    t0 = time.perf_counter()
    rec["compress"] = compressed_rounds(torch, rank, world, dev, dp.group)
    seconds["compress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = dp.gather(loop.params)
    if rank == 0:
        eng = Engine(full, cfg, EngineConfig(**SERVE_FIELDS, plan="uniform:4",
                                             group_size=128), device=dev)
        save_quantized(qdir, DIST_STEPS, eng.params, eng.quant_policy,
                       plan=eng.plan)
    seconds["save_quantized"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"dist_rank{rank}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def one_device_run(torch, layers=None):
    """Phase 13's one-device step (cut to ``layers``) from the mesh runs'
    init on the same global batches: DIST_STEPS steps (the init, the
    parameters and AdamW's moments after them, on the host), then one
    more; (that record, the four steps' metrics)."""
    from repro_torch.tree import tree_leaves
    cfg, params = family_model(torch, TRAIN_ARCH, layers=layers)
    ref = dict(init=[x.cpu() for x in tree_leaves(params)])
    loop, step = train_loop(torch, cfg, params, TRAIN_B, TRAIN_T,
                            DIST_STEPS)
    step = MetricsStep(step)
    loop.step_fn = step
    loop.run()
    ref.update(after=[x.cpu() for x in tree_leaves(loop.params)],
               mu=[x.cpu() for x in tree_leaves(loop.opt_state.mu)],
               nu=[x.cpu() for x in tree_leaves(loop.opt_state.nu)])
    loop.lcfg.total_steps = DIST_STEPS + 1
    loop.run()
    return ref, step.metrics


def tp_reference(torch, part):
    """(g): ``part``'s one-device run from the ranks' init on the same
    global batches, routed by the ranks' top-k experts where they wrote
    them (``DispatchLog``'s replay): (the init, the parameters and AdamW's
    moments after the steps, on the card; the steps' metrics; the
    replay's count of differing routings, None without one)."""
    from repro_torch.tree import tree_leaves
    arch, _, layers, b, t, steps = tp_run(part)
    cfg, params = family_model(torch, arch, layers=layers)
    params = seeded_biases(torch, params)
    loop, step = train_loop(torch, cfg, params, b, t, steps)
    step = MetricsStep(step)
    loop.step_fn = step
    routing = os.path.join(OUT_DIR, f"tp_{part}_routing.pt")
    replay = torch.load(routing) if os.path.exists(routing) else None
    with DispatchLog(replay) as routed:
        loop.run()              # the step does not write its inputs
    ref = dict(init=tree_leaves(params), after=tree_leaves(loop.params),
               mu=tree_leaves(loop.opt_state.mu),
               nu=tree_leaves(loop.opt_state.nu))
    return ref, step.metrics, (routed.flipped() if replay else None)


def dist_reference(torch, res):
    """(a)'s and (e)'s reference: the one-device run at full depth."""
    ref, metrics = one_device_run(torch)
    res["one_device"] = dict(metrics=metrics)
    return ref


def update_agreement(torch, params, opt, ref) -> dict:
    """(a): per leaf, the dp run's update (after - init) against one
    device's on the same init: the fraction of elements outside
    DIST_UPDATE_TOL of the leaf's largest update plus DIST_STEPS ulps, the
    same fraction for the parameters left at their init (what a run that
    never wrote its parameters back would read), and the worst element
    with both runs' updates and AdamW moments (a moment the run did not
    send back, None).  Where the run sent its first moment (the
    gradients' average), each leaf's largest difference from one
    device's, of the tree's largest first moment (``mu_err_of_tree``)."""
    from repro_torch.tree import tree_flatten_with_path, tree_leaves
    inf = torch.tensor(float("inf"), device="cuda")
    leaves = []
    flat = tree_flatten_with_path(params)
    none = [None] * len(flat)
    mus = tree_leaves(opt.mu) if getattr(opt, "mu", None) is not None \
        else none
    nus = tree_leaves(opt.nu) if getattr(opt, "nu", None) is not None \
        else none
    mu_top = max(float(m.abs().max()) for m in ref["mu"])
    for i, ((path, p), mu, nu) in enumerate(zip(flat, mus, nus)):
        p0, w = ref["init"][i].cuda(), ref["after"][i].cuda()
        top = (w - p0).abs().amax()
        tol = (DIST_UPDATE_TOL * top
               + DIST_STEPS * (torch.nextafter(w.abs(), inf) - w.abs()))
        r = ((p - w).abs() / tol).flatten()
        j = int(r.argmax())
        leaves.append(dict(
            leaf=path, elements=r.numel(), largest_update=float(top),
            outside=int((r > 1).sum()),
            outside_fraction=float((r > 1).float().mean()),
            unchanged_fraction=float(((p0 - w).abs() > tol).float().mean()),
            worst_over_tol=float(r[j]), index=j,
            update_one=float((w - p0).flatten()[j]),
            update_dp=float((p - p0).flatten()[j]),
            mu_one=float(ref["mu"][i].flatten()[j]),
            mu_dp=None if mu is None else float(mu.flatten()[j]),
            sqrt_nu_one=float(ref["nu"][i].flatten()[j].sqrt()),
            sqrt_nu_dp=None if nu is None else float(nu.flatten()[j].sqrt()),
            mu_err_of_tree=None if mu is None else float(
                (mu - ref["mu"][i].cuda()).abs().max()) / mu_top))
    worst = max(leaves, key=lambda x: x["worst_over_tol"])
    return dict(
        tol=DIST_UPDATE_TOL, outliers_allowed=DIST_UPDATE_OUTLIERS,
        outside=sum(x["outside"] for x in leaves),
        elements=sum(x["elements"] for x in leaves),
        worst_fraction=max(leaves, key=lambda x: x["outside_fraction"]),
        worst_element=worst,
        unchanged_least=min(leaves, key=lambda x: x["unchanged_fraction"]),
        leaves_outside=[x for x in leaves if x["outside"]])


def dist_hold(torch, res, ranks, ref, ckpt, phase13=None):
    """(a): each rank's metrics against the one-device step's, the
    checkpoint's parameters and updates against its (phase 13's first
    losses recorded beside them when it ran)."""
    from repro_torch.checkpoint import restore
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_flatten_with_path
    import repro_torch.configs as C
    one = res["one_device"]["metrics"]
    worst = 0.0
    for r, rec in enumerate(ranks):
        for m, w in zip(rec["metrics"] + [rec["step4"]], one):
            if m["step"] != w["step"]:
                fail(f"dist (a): rank {r} step {m['step']} against "
                     f"{w['step']}")
            for key in ("loss", "nll", "grad_norm"):
                worst = max(worst, abs(m[key] - w[key]) / abs(w[key]))
    cfg = C.get_config(TRAIN_ARCH)
    raw = lm.init_params(cfg, None, device="meta")
    step0 = torch.zeros((), dtype=torch.int32, device="meta")
    (params, opt), extras = restore(ckpt, (raw, AdamWState(step0, raw, raw)),
                                    step=DIST_STEPS, device="cuda")
    param_err, param_leaf = max(
        (float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30),
         path) for (path, a), b in zip(tree_flatten_with_path(params),
                                       ref["after"]))
    upd = update_agreement(torch, params, opt, ref)
    del opt
    res["hold"] = dict(metrics_rel_err=worst, param_err_of_leaf_max=param_err,
                       param_err_leaf=param_leaf, updates=upd,
                       checkpoint_step=extras["step"])
    if phase13 is not None:
        res["hold"]["phase13_losses"] = phase13["full"]["losses"][
            :DIST_STEPS + 1]
    log(f"[dist] (a) dp={DIST_WORLD} against the one-device step, "
        f"{DIST_STEPS + 1} steps: loss / nll / grad norm worst "
        f"{worst:.2e} relative (tolerance {TRAIN_LOSS_RTOL}); parameters "
        f"after {DIST_STEPS} steps (rank 0's checkpoint, full arrays) worst "
        f"{param_err:.2e} of a leaf's max in {param_leaf} (tolerance "
        f"{DIST_PARAM_TOL})")
    wf, we, wu = (upd["worst_fraction"], upd["worst_element"],
                  upd["unchanged_least"])
    log(f"[dist] (a) updates (after - init) against one device's, within "
        f"{DIST_UPDATE_TOL} of each leaf's largest update + {DIST_STEPS} "
        f"ulps: {upd['outside']} of {upd['elements']} elements outside; "
        f"worst leaf {wf['leaf']} {wf['outside']} of {wf['elements']} "
        f"({wf['outside_fraction']:.2e}, allowed {DIST_UPDATE_OUTLIERS}); "
        f"worst element {we['leaf']}[{we['index']}] at {we['worst_over_tol']:.3g}"
        f"x the tolerance: update {we['update_one']:.4e} (one device) / "
        f"{we['update_dp']:.4e} (dp), largest in its leaf "
        f"{we['largest_update']:.4e}, AdamW mu {we['mu_one']:.4e} / "
        f"{we['mu_dp']:.4e} against sqrt(nu) {we['sqrt_nu_one']:.4e} / "
        f"{we['sqrt_nu_dp']:.4e}; parameters left at their init would have "
        f"at least {wu['unchanged_fraction']:.3f} of a leaf's elements "
        f"outside ({wu['leaf']})")
    if worst > TRAIN_LOSS_RTOL or param_err > DIST_PARAM_TOL \
            or wf["outside_fraction"] > DIST_UPDATE_OUTLIERS \
            or extras["step"] != DIST_STEPS:
        fail("dist (a): the data-parallel run differs from one device")
    return cfg, params


def dist_serve(torch, res, cfg, trained, qdir):
    """(c): the tree rank 0 saved, restored from the raw template alone,
    bit-equal to the same tree quantized in memory, its plan the engine's;
    both served (ring, int8 KV, 8 of phase 4's requests x 16 tokens), the
    restored one with every launch held and counted exactly."""
    from repro_torch.checkpoint import restore_quantized, restored_plan
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.tree import tree_flatten_with_path
    prompts = engine_requests(cfg)[:8]
    mem = Engine(trained, cfg, EngineConfig(**SERVE_FIELDS, plan="uniform:4",
                                            group_size=128), device="cuda")
    t0 = time.perf_counter()
    back, extras = restore_quantized(
        qdir, lm.init_params(cfg, None, device="meta"), device="cuda")
    restore_s = time.perf_counter() - t0
    a, b = tree_flatten_with_path(mem.params), tree_flatten_with_path(back)
    bit_equal = ([p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in
        zip(a, b)))
    plan = restored_plan(extras)
    plan_equal = plan == mem.plan and plan.spec_hash == mem.plan.spec_hash
    want_tokens, _, _ = serve_counted(torch, mem, prompts, 16)
    del mem
    eng = Engine(back, cfg, EngineConfig(**SERVE_FIELDS, quantize=False),
                 device="cuda")
    with Held(torch, "dist serve") as held, \
            HeldAttn(torch, "dist serve") as held_attn:
        got, counts, dt = serve_counted(torch, eng, prompts, 16)
    st = eng.stats()
    dec, pre = lut_calls(eng.params)
    steps, passes = st["decode_iterations"], st["prefill_iterations"]
    want = dict(lut_matmul=dec * steps + pre * passes,
                decode_attention=cfg.n_layers * steps)
    rec = dict(leaves=len(b), bit_equal=bit_equal, plan_equal=plan_equal,
               spec_hash=plan.spec_hash, restore_s=restore_s,
               tokens_equal=[got[u] for u in sorted(got)]
               == [want_tokens[u] for u in sorted(want_tokens)], seconds=dt,
               decode_steps=steps, prefill_passes=passes,
               lut_per_decode_step=dec, lut_per_prefill=pre,
               attention_per_decode_step=cfg.n_layers, launches=counts,
               held_lut=sum(held.calls.values()),
               max_abs_err_lut=held.err["f32"],
               held_attention=held_attn.calls,
               max_abs_err_attention=held_attn.err,
               first_tokens={u: t[:4] for u, t in sorted(got.items())})
    res["serve"] = rec
    log(f"[dist] (c) uniform:4 tree saved by rank 0, restored from the raw "
        f"template in {restore_s:.2f} s: {len(b)} leaves bit-equal "
        f"{bit_equal}, plan {plan.spec_hash} equal {plan_equal}; served 8 x "
        f"16 tokens ({steps} decode steps, {passes} prefill passes): tokens "
        f"equal to the in-memory tree's {rec['tokens_equal']}; launches "
        f"{counts}, want {dec} LUT-GEMV and {cfg.n_layers} attentions per "
        f"decode step, {pre} per prefill pass; every launch held "
        f"({rec['held_lut']} LUT-GEMV, max abs err {held.err['f32']:.3e}; "
        f"{held_attn.calls} attentions, {held_attn.err:.3e})")
    if (not bit_equal or not plan_equal or not rec["tokens_equal"]
            or len(got) != 8 or any(len(t) != 16 for t in got.values())
            or any(counts[k] != v for k, v in want.items())
            or counts["lut_matmul_int"] or counts["decode_attention_table"]):
        fail(f"dist (c): restored tree served wrongly: {rec}")


def dist_cut(torch, res, cfg, trained, qdir):
    """(c): the 2-layer cut under a mixed plan with activation bits (two
    segments, w_up's int LUT-GEMV), saved, restored from the raw template
    alone with its segmentation and abits, and run card against CPU."""
    from repro_torch.checkpoint import restore_quantized, save_quantized
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import (BitAllocation, QTensor,
                                                QuantPolicy, StackedQTensor,
                                                map_tensors, quantize_params)
    from repro_torch.tree import tree_flatten_with_path
    cut, cfg2 = cut_layers(trained, cfg, CUT_LAYERS)
    pol = QuantPolicy(bits=4, group_size=128,
                      allocation=BitAllocation(**CUT_ALLOCATION))
    q, _, _ = quantize_params(cut, pol)
    save_quantized(qdir, 0, q, pol)
    back, extras = restore_quantized(
        qdir, lm.init_params(cfg2, None, device="meta"), device="cuda")
    a, b = tree_flatten_with_path(q), tree_flatten_with_path(back)
    bit_equal = ([p for p, _ in a] == [p for p, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b)))

    def statics(tree):
        out = {}
        for i, seg in enumerate(tree["blocks"]):
            for name, sub in seg.items():
                for k, w in (sub.items() if isinstance(sub, dict) else ()):
                    if isinstance(w, (QTensor, StackedQTensor)):
                        out[f"[{i}]['{name}']['{k}']"] = [w.bits, w.abits]
        return out
    segments = len(back["blocks"]) if isinstance(back["blocks"], list) else 1
    toks, lengths = model_prompts(cfg2)
    gl, gt, rec = held_passes(torch, lm, back, cfg2, toks, lengths, 4,
                              "dist cut a8", mixed=True)
    with CardDequant(torch):
        cl, ct = run_greedy(torch, lm, map_tensors(back, lambda t: t.cpu()),
                            cfg2, toks, lengths, 4, "cpu")
    rec.update(bit_equal=bit_equal, segments=segments,
               statics=statics(back), statics_equal=statics(back) ==
               statics(q), policy=extras["quant_policy"],
               tokens_equal=bool(torch.equal(gt, ct)),
               card_tokens=gt.T.tolist(), cpu_tokens=ct.T.tolist(),
               logits_err_per_pass=(gl - cl).abs().amax(dim=(1, 2)).tolist())
    res["cut"] = rec
    log(f"[dist] (c) {CUT_LAYERS}-layer cut under {CUT_ALLOCATION}: "
        f"restored bit-equal {bit_equal}, {segments} segments, (bits, abits) "
        f"{rec['statics']}; card vs CPU greedy tokens equal "
        f"{rec['tokens_equal']} ({rec['card_tokens']}), logits max abs err "
        f"per pass {', '.join(f'{e:.3e}' for e in rec['logits_err_per_pass'])}"
        f"; launches {rec['launches']} (int LUT-GEMV max abs err "
        f"{rec['max_abs_err_lut_int']:.3e}, f32 {rec['max_abs_err_lut']:.3e})")
    if (not bit_equal or segments != 2 or not rec["statics_equal"]
            or not rec["tokens_equal"] or not rec["launches"].get(
                "lut_matmul_int") or not torch.isfinite(gl).all()):
        fail(f"dist (c): the restored a8 cut is wrong: {rec}")


def dist_resume(torch, res, ranks, ckpt):
    """(d): the dp=2 checkpoint resumed on one device: its next step's
    metrics against the dp=2 run continued."""
    cfg, fresh = family_model(torch, TRAIN_ARCH)
    loop, step = train_loop(torch, cfg, fresh, TRAIN_B, TRAIN_T,
                            DIST_STEPS + 1, ckpt=ckpt)
    step = MetricsStep(step)
    loop.step_fn = step
    restored = loop.maybe_restore()
    at = loop.step
    loop.run()
    got, want = step.metrics[-1], ranks[0]["step4"]
    err = max(abs(got[k] - want[k]) / abs(want[k])
              for k in ("loss", "nll", "grad_norm"))
    res["resume"] = dict(restored=restored, restored_step=at, step=got,
                         dp_step=want, rel_err=err)
    log(f"[dist] (d) the dp={DIST_WORLD} checkpoint resumed on one device at "
        f"step {at}: step {got['step']} loss {got['loss']:.6f} against the "
        f"dp={DIST_WORLD} run's {want['loss']:.6f} (worst {err:.2e} "
        f"relative, tolerance {TRAIN_LOSS_RTOL})")
    if not restored or at != DIST_STEPS or got["step"] != DIST_STEPS + 1 \
            or err > TRAIN_LOSS_RTOL:
        fail("dist (d): the resumed step differs from the dp=2 run's")


def tp_train_rank(rank, part, out_dir, ckpt):
    """One rank of (e), (f) or (g): the part's config at full width (depth
    as ``tp_run`` says) trained over the part's (data, model) mesh, every
    rank on the one card, FSDP as ``make_plan`` decides, on global batches
    of the part's B x T; its steps, then the loop's final checkpoint
    (gathered over both axes, written by rank 0), or without ``ckpt`` this
    rank's slices and AdamW first moment written to
    ``tp_<part>_rank<r>.pt`` and rank 0's routing to
    ``tp_<part>_routing.pt``.  Rank r writes
    ``tp_<part>_rank<r>.json``: metrics, each step's wall time and device
    span, its all-reduces by kind, the digest of the leaves the model axis
    leaves whole and of a MoE model's routing (the top-k experts of every
    router call), the kernels launched, max_memory_allocated."""
    import hashlib
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import describe
    from repro_torch.tree import tree_leaves
    arch, shape, layers, b, t, steps = tp_run(part)
    t0 = time.perf_counter()
    seconds = {}
    run = mesh_rank_train(torch, rank, shape, layers, ckpt, arch=arch, b=b,
                          t=t, steps=steps, biases=part in TP_OTHERS)
    dp, loop, ars, cfg = run["dp"], run["loop"], run["ars"], run["cfg"]
    seconds["init"] = time.perf_counter() - t0
    _build.reset_launches()
    with ars, DispatchLog() as routed:
        t0 = time.perf_counter()
        loop.run()            # the steps, then the gather and rank 0's write
        seconds["train"] = time.perf_counter() - t0
    launches = dict(_build.launches)
    act = b // shape[0] * t * cfg.d_model * 4
    route = b // shape[0] * t * cfg.top_k * 4

    def kind(i):
        nbytes, group = ars.calls[i][0], ars.groups[i]
        if group is not None and group is dp.tp_group:
            if nbytes == act:
                return "activations"
            if cfg.n_experts and nbytes == route:
                return "routing weights' gradient"
            return "model gathers" if nbytes > 64 else "model scalars"
        if group is not None and group is dp.group:
            return "data axis"
        return "other"
    whole = [p for p, m in zip(tree_leaves(loop.params), dp.model_dims)
             if m is None]
    digest = hashlib.sha256(b"".join(
        p.cpu().numpy().tobytes() for p in whole)).hexdigest()
    plan, mesh = run["plan"], run["mesh"]
    rec = dict(part=part, arch=arch, shape=shape, layers=cfg.n_layers,
               batch=(b, t), group=describe(mesh), device=str(run["dev"]),
               coords=(mesh.coord("data"), mesh.coord("model")),
               plan=dict(dp_axes=plan.dp_axes, tp_axis=plan.tp_axis,
                         fsdp=plan.fsdp),
               params=run["params"], local_params=run["local_params"],
               metrics=run["step"].metrics,
               per_step=step_records(run, kind), activation_bytes=act,
               whole_leaves=len(whole),
               whole_elements=sum(p.numel() for p in whole),
               whole_digest=digest, model_dims=dp.model_dims,
               launches=launches,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                   run["dev"]) / 1e9, seconds=seconds)
    t0 = time.perf_counter()
    if routed.topi:
        rec.update(dispatch_digest=routed.digest(),
                   router_calls=len(routed.topi))
        if ckpt is None and rank == 0:  # the one-device run routes by it
            torch.save([x.to(torch.uint8).cpu() for x in routed.topi],
                       os.path.join(out_dir, f"tp_{part}_routing.pt"))
    if ckpt is None:
        torch.save({"params": [p.cpu() for p in tree_leaves(loop.params)],
                    "mu": [m.cpu() for m in tree_leaves(loop.opt_state.mu)]},
                   os.path.join(out_dir, f"tp_{part}_rank{rank}.pt"))
    seconds["save"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"tp_{part}_rank{rank}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def tp_train_ranks(rank, parts, out_dir, ckpts):
    """``tp_train_rank`` for each of ``parts`` (each with its ``ckpts``
    entry) in turn, in one spawn of ranks: (e) and (g), which share the
    (1, 2) mesh, pay for the ranks' start once."""
    import torch
    for part, ckpt in zip(parts, ckpts):
        tp_train_rank(rank, part, out_dir, ckpt)
        gc.collect()            # the last part's trees, before the next
        torch.cuda.empty_cache()


def tp_rank_params(torch, part, ranks, cfg):
    """(g): the parameters and AdamW's first moment after a (1, M) run,
    from the M ranks' slices (each leaf whole on every rank, or
    concatenated along its model dim), on the card."""
    import types
    from repro_torch.models import lm
    from repro_torch.tree import tree_unflatten
    saved = [torch.load(os.path.join(OUT_DIR, f"tp_{part}_rank{r}.pt"))
             for r in range(len(ranks))]
    dims = ranks[0]["model_dims"]
    template = lm.init_params(cfg, None, device="meta")

    def whole(key):
        return tree_unflatten(template, [
            (xs[0] if m is None else torch.cat(xs, dim=m)).cuda()
            for m, xs in zip(dims, zip(*(d[key] for d in saved)))])
    return whole("params"), types.SimpleNamespace(mu=whole("mu"), nu=None)


def tp_train_hold(torch, res, part, ref, one, ckpt, replayed=None):
    """(e), (f), (g): the ranks' metrics against the one-device run's
    ``one`` (within TRAIN_LOSS_RTOL), the whole leaves' digests equal
    across each data coordinate's model ranks (and a MoE model's routing
    digests), the checkpoint's parameters (without ``ckpt``: the ranks'
    slices) and updates against ``ref`` under (a)'s checks; ``replayed``:
    the one-device run routed by the ranks' experts, its own routing
    differing where ``replayed`` counts."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.checkpoint import restore
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_flatten_with_path
    arch, shape, layers, _, _, steps = tp_run(part)
    world = shape[0] * shape[1]
    ranks = []
    for r in range(world):
        with open(os.path.join(OUT_DIR, f"tp_{part}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    worst = 0.0
    for rec in ranks:
        for m, w in zip(rec["metrics"], one):
            if m["step"] != w["step"]:
                fail(f"dist ({part}): step {m['step']} against {w['step']}")
            for key in ("loss", "nll", "grad_norm"):
                worst = max(worst, abs(m[key] - w[key]) / abs(w[key]))
    digests = collections.defaultdict(set)
    routings = collections.defaultdict(set)
    for rec in ranks:
        digests[rec["coords"][0]].add(rec["whole_digest"])
        routings[rec["coords"][0]].add(rec.get("dispatch_digest"))
    whole_equal = all(len(d) == 1 for d in digests.values())
    dispatch_equal = all(len(d) == 1 for d in routings.values())
    cfg = C.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if ckpt is None:
        (params, opt), extras = tp_rank_params(torch, part, ranks, cfg), \
            {"step": steps}
    else:
        raw = lm.init_params(cfg, None, device="meta")
        step0 = torch.zeros((), dtype=torch.int32, device="meta")
        (params, opt), extras = restore(
            ckpt, (raw, AdamWState(step0, raw, raw)), step=steps,
            device="cuda")
    param_err, param_leaf = max(
        (float((a - b.to(a.device)).abs().max())
         / max(float(b.abs().max()), 1e-30), path)
        for (path, a), b in zip(tree_flatten_with_path(params),
                                ref["after"]))
    upd = update_agreement(torch, params, opt, ref)
    del params, opt
    r0 = ranks[0]
    # the leaves held to the update check (a key bias whose first moment is
    # one device's may miss it: KEY_BIAS)
    key_bias = [x for x in upd["leaves_outside"] if x["leaf"].endswith(
        KEY_BIAS) and x["mu_err_of_tree"] is not None
        and x["mu_err_of_tree"] <= TRAIN_GRAD_TOL]
    held = max((x["outside_fraction"] for x in upd["leaves_outside"]
                if x not in key_bias), default=0.0)
    hold = dict(metrics_rel_err=worst, whole_leaves_equal=whole_equal,
                dispatch_equal=dispatch_equal, replayed=replayed,
                param_err_of_leaf_max=param_err, param_err_leaf=param_leaf,
                updates=upd, held_outside_fraction=held,
                key_bias_by_first_moment=key_bias,
                checkpoint_step=extras["step"])
    res[f"tp_{part}"] = dict(ranks=ranks, hold=hold,
                             one_device=dict(metrics=one))
    wf = upd["worst_fraction"]
    log(f"[dist] ({part}) {r0['arch']} {r0['group']}, {r0['layers']} "
        f"layers, B {r0['batch'][0]} x T {r0['batch'][1]}, every rank "
        f"on {r0['device']} ({card_line()}), plan {r0['plan']}: each rank "
        f"holds {r0['local_params'] / 1e6:.1f}M of "
        f"{r0['params'] / 1e6:.1f}M parameters; per step (rank 0) "
        + "; ".join(f"{s['wall_ms']:.1f} ms wall, {s['device_ms']:.1f} ms "
                    f"device, {s['allreduces']} all-reduces "
                    f"{s['allreduce_ms']:.1f} ms "
                    f"({100 * s['allreduce_share']:.1f}%, "
                    f"{sum(s['allreduce_bytes']) / 1e6:.1f} MB) after waiting "
                    f"{s['wait_ms']:.1f} ms ({100 * s['wait_share']:.1f}%)"
                    for s in r0["per_step"])
        + "; by kind in the last step "
        + ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e6:.1f} MB "
                    f"{v['ms']:.1f} ms"
                    for k, v in r0["per_step"][-1]["kinds"].items())
        + f"; max memory allocated per rank "
        f"{[round(r['max_memory_allocated_gb'], 2) for r in ranks]} GB")
    if "dispatch_digest" in r0:
        log(f"[dist] ({part}) routing: the top-k experts of "
            f"{r0['router_calls']} router calls equal on every model rank "
            f"{dispatch_equal}")
    if replayed is not None:
        log(f"[dist] ({part}) the one-device run routed by the ranks' "
            f"top-k experts (weighted by its own router logits): its own "
            f"top-k set differed in {replayed['tokens']} of "
            f"{replayed['of_tokens']} token routings over "
            f"{replayed['calls']} calls, the largest margin between the "
            f"k-th and (k+1)-th logit among them "
            f"{replayed['largest_margin']:.3e}")
    mu_errs = [x["mu_err_of_tree"] for x in upd["leaves_outside"]
               if x["mu_err_of_tree"] is not None]
    if mu_errs:
        log(f"[dist] ({part}) AdamW's first moment against one device's, "
            f"of the tree's largest, in the leaves with updates outside: "
            + ", ".join(f"{x['leaf']} {x['mu_err_of_tree']:.2e} "
                        f"({x['outside']} of {x['elements']} outside)"
                        for x in upd["leaves_outside"])
            + f"; key biases held by their first moment (tolerance "
            f"{TRAIN_GRAD_TOL}): {[x['leaf'] for x in key_bias]}")
    log(f"[dist] ({part}) kernels launched by the steps (rank 0) "
        f"{r0['launches']}; one device's metrics {one}")
    log(f"[dist] ({part}) against one device, {steps} steps: loss / "
        f"nll / grad norm worst {worst:.2e} relative (tolerance "
        f"{TRAIN_LOSS_RTOL}); the {r0['whole_leaves']} leaves the model axis "
        f"leaves whole ({r0['whole_elements']} elements) bit-equal across "
        f"model ranks {whole_equal}; parameters ("
        f"{'the ranks' if ckpt is None else 'rank 0'}'s "
        f"{'slices' if ckpt is None else 'checkpoint'}) worst "
        f"{param_err:.2e} of a leaf's max in {param_leaf}; updates "
        f"{upd['outside']} of {upd['elements']} elements outside, worst leaf "
        f"{wf['leaf']} {wf['outside_fraction']:.2e} (allowed "
        f"{DIST_UPDATE_OUTLIERS})")
    if worst > TRAIN_LOSS_RTOL or not whole_equal or not dispatch_equal \
            or param_err > DIST_PARAM_TOL \
            or held > DIST_UPDATE_OUTLIERS \
            or extras["step"] != steps \
            or any(len(rec["metrics"]) != steps for rec in ranks) \
            or len(one) < steps:
        fail(f"dist ({part}): the tensor-parallel run differs from one "
             f"device")


def tp_train_resume(torch, res, ckpt, one):
    """(f): the (2, 2) checkpoint resumed on one device: its next step's
    metrics against the uninterrupted one-device run's."""
    _, layers = TP_TRAIN["f"]
    cfg, fresh = family_model(torch, TRAIN_ARCH, layers=layers)
    loop, step = train_loop(torch, cfg, fresh, TRAIN_B, TRAIN_T,
                            DIST_STEPS + 1, ckpt=ckpt)
    step = MetricsStep(step)
    loop.step_fn = step
    restored = loop.maybe_restore()
    at = loop.step
    loop.run()
    got, want = step.metrics[-1], one[DIST_STEPS]
    err = max(abs(got[k] - want[k]) / abs(want[k])
              for k in ("loss", "nll", "grad_norm"))
    res["tp_f"]["resume"] = dict(restored=restored, restored_step=at,
                                 step=got, one_device_step=want, rel_err=err)
    log(f"[dist] (f) the (2, 2) checkpoint resumed on one device at step "
        f"{at}: step {got['step']} loss {got['loss']:.6f} against the "
        f"uninterrupted one-device run's {want['loss']:.6f} (worst "
        f"{err:.2e} relative, tolerance {TRAIN_LOSS_RTOL})")
    if not restored or at != DIST_STEPS or got["step"] != DIST_STEPS + 1 \
            or err > TRAIN_LOSS_RTOL:
        fail("dist (f): the resumed step differs from one device's")


def phase_dist(rt):
    import torch
    from repro_torch.launch.mesh import run_ranks
    res = rt["dist"] = {}
    seconds = res["seconds"] = {}
    ckpt = os.path.join(OUT_DIR, "dist_ckpt")
    qdir = os.path.join(OUT_DIR, "dist_quant")
    cut_dir = os.path.join(OUT_DIR, "dist_quant_cut")
    tp_dirs = {part: os.path.join(OUT_DIR, f"tp_{part}_ckpt")
               for part in TP_TRAIN}
    dirs = (ckpt, qdir, cut_dir) + tuple(tp_dirs.values())
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        ref = dist_reference(torch, res)
        torch.cuda.empty_cache()
        seconds["one_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks(dist_rank, DIST_WORLD,
                  args=(DIST_WORLD, OUT_DIR, ckpt, qdir))
        seconds["ranks"] = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_WORLD):
            with open(os.path.join(OUT_DIR, f"dist_rank{r}.json")) as f:
                ranks.append(json.load(f))
        res["ranks"] = ranks
        r0 = ranks[0]
        log(f"[dist] {r0['group']}, every rank on {r0['device']} "
            f"({card_line()}), plan {r0['plan']}: each rank holds "
            f"{r0['local_params'] / 1e6:.1f}M of {r0['params'] / 1e6:.1f}M "
            f"parameters; B {TRAIN_B} x T {TRAIN_T} global, "
            f"{TRAIN_B // DIST_WORLD} rows per rank; per step (rank 0) "
            + "; ".join(f"{s['wall_ms']:.1f} ms wall, {s['device_ms']:.1f} "
                        f"ms device, {s['allreduces']} all-reduces "
                        f"{s['allreduce_ms']:.1f} ms "
                        f"({100 * s['allreduce_share']:.1f}%) after waiting "
                        f"{s['wait_ms']:.1f} ms "
                        f"({100 * s['wait_share']:.1f}%) for the peer"
                        for s in r0["per_step"])
            + f"; all-reduce bytes in the last step "
            f"{r0['per_step'][-1]['allreduce_bytes']}; max memory allocated "
            f"per rank "
            f"{[round(r['max_memory_allocated_gb'], 2) for r in ranks]} GB; "
            f"compressed all-reduce {r0['compress']['elements']} elements x 2 "
            f"rounds {[round(x, 2) for x in r0['compress']['ms']]} ms, codes "
            f"and error state bit-equal, mean within "
            f"{r0['compress']['mean_max_ulps']:.1f} ulp")
        t0 = time.perf_counter()
        cfg, trained = dist_hold(torch, res, ranks, ref, ckpt,
                                 rt.get("train"))
        seconds["hold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks(tp_train_ranks, 2, args=(
            ["e"] + list(TP_OTHERS), OUT_DIR,
            [tp_dirs["e"]] + [None] * len(TP_OTHERS)))
        seconds["tp (1, 2) ranks, (e) and (g)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_train_hold(torch, res, "e", ref, res["one_device"]["metrics"],
                      tp_dirs["e"])
        del ref
        seconds["tp (1, 2) hold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist_serve(torch, res, cfg, trained, qdir)
        seconds["serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist_cut(torch, res, cfg, trained, cut_dir)
        seconds["cut"] = time.perf_counter() - t0
        del trained
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dist_resume(torch, res, ranks, ckpt)
        seconds["resume"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref, one = one_device_run(torch, TP_TRAIN["f"][1])
        torch.cuda.empty_cache()
        run_ranks(tp_train_rank, 4, args=("f", OUT_DIR, tp_dirs["f"]))
        tp_train_hold(torch, res, "f", ref, one, tp_dirs["f"])
        tp_train_resume(torch, res, tp_dirs["f"], one)
        seconds["tp (2, 2)"] = time.perf_counter() - t0
        del ref
        for part in TP_OTHERS:             # (g): its ranks ran with (e)'s
            gc.collect()        # cycles that hold earlier steps' tensors
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ref, one, replayed = tp_reference(torch, part)
            seconds[f"{part} one device"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tp_train_hold(torch, res, part, ref, one, None, replayed)
            del ref
            seconds[f"{part} hold"] = time.perf_counter() - t0
            log(f"[dist] ({part}) seconds: rank 0 "
                f"{res[f'tp_{part}']['ranks'][0]['seconds']}, one device "
                f"{seconds[f'{part} one device']:.1f}, hold "
                f"{seconds[f'{part} hold']:.1f}")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
        for part in TP_OTHERS:
            for name in (f"tp_{part}_rank0.pt", f"tp_{part}_rank1.pt",
                         f"tp_{part}_routing.pt"):
                path = os.path.join(OUT_DIR, name)
                if os.path.exists(path):
                    os.remove(path)
    log(f"[dist] seconds {seconds}")


# ---------------------------------------------------------------------------
# phase 15: the examples (examples_torch/), called in-process
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
# (a): quickstart's printed lines: section 1 (its title and NBW 1-4),
# section 4 (the PRT hit rate) and section 5 (Table II and Fig. 12)
QS_SECTIONS = {"1": slice(1, 6), "4": slice(15, 17), "5": slice(18, 25)}
# (c): the printed eval losses (4 decimals, ~5.6), card against CPU after
# 30 AdamW steps from the same initial tree
EX_QE_TOL = 1e-3
EX_QE_ROW = re.compile(r"(Q ?\d|f32|mix) +(-?[\d.]+) +([-+][\d.]+|-) +"
                       r"([\d.]+x) +(.*)")
EX_QE_SWEEP = 6              # Q8, Q6, Q5, Q4, Q3, Q2
# (d): tiny to a checkpoint, then resumed; the last loss against an
# uninterrupted run (the card's embedding backward accumulates by atomics)
EX_TINY_STEPS, EX_RESUME_STEPS = 40, 60
EX_RESUME_RTOL = 1e-5
EX_100M_STEPS = 3
EX_SERVED = re.compile(r"\(([\d.]+) tok/s measured on (.*), (\d+) model "
                       r"iterations, mean TTFT")


def example(name):
    """``examples_torch/<name>.py`` loaded by path (a script, not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quietly(fn, *args):
    """(``fn(*args)``, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


@contextlib.contextmanager
def counted(torch):
    """The launch counters set to 0 on entry; on exit the yielded dict
    holds what the block launched."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    counts = {}
    yield counts
    torch.cuda.synchronize()
    counts.update(_build.launches)


class HeldTypeconv:
    """Within the block, every int_to_f32 launch is held bit for bit
    against ``.float()`` on the launch's own input."""

    def __init__(self, torch, name):
        from repro_torch.kernels.typeconv import ops
        self.ops, self.torch, self.name = ops, torch, name
        self.calls, self.elements, self.ns = 0, 0, []

    def __enter__(self):
        torch = self.torch
        self.fn = self.ops.int_to_f32_cuda

        def conv(a, n):
            out = self.fn(a, n)
            want = a.to(torch.float32)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                fail(f"{self.name}: int_to_f32 n {n} on {tuple(a.shape)}: "
                     f"{int((out != want).sum())} elements differ from "
                     ".float()")
            self.calls += 1
            self.elements += a.numel()
            self.ns.append(n)
            return out
        self.ops.int_to_f32_cuda = conv
        return self

    def __exit__(self, *exc):
        self.ops.int_to_f32_cuda = self.fn
        return False


def examples_quickstart(torch, res):
    """(a): quickstart on the card against its CPU run."""
    qs = example("quickstart")
    _, want = quietly(qs.main, ["--device", "cpu"])
    with counted(torch) as counts, \
            Held(torch, "quickstart", cache=False) as held, \
            HeldTypeconv(torch, "quickstart") as tc:
        errs, got = quietly(qs.main, ["--device", "cuda"])
    same = {k: got[s] == want[s] for k, s in QS_SECTIONS.items()}
    need = dict(lut_matmul=3, int_to_f32=1, lut_matmul_int=0,
                decode_attention=0)
    if (len(got) != len(want) or not all(same.values())
            or any(counts[k] != v for k, v in need.items())
            or held.calls != {(b, 0): 1 for b in (2, 4, 8)}
            or tc.ns != [25] or tc.elements != 10000
            or "bit-exact vs astype(float32): True" not in got[13]):
        fail(f"examples (a) quickstart: sections equal to the CPU run's "
             f"{same}, launches {counts} (need {need}), LUT-GEMV held "
             f"{dict(held.calls)}, int_to_f32 at n {tc.ns} on "
             f"{tc.elements} elements; section 3: {got[12:14]}")
    res["runs"]["quickstart"] = dict(
        launches=counts, max_abs_err_lut=held.err["f32"],
        kernel_vs_plain={f"Q{b}": e for b, e in errs.items()},
        int_to_f32_elements=tc.elements, equal_to_cpu=same,
        section2=got[7:11], section3=got[13])
    log(f"[examples] (a) quickstart on the card: sections 1, 4 and 5 equal "
        f"the CPU run's; {got[7]}: "
        + "; ".join(line.strip().split(";")[0] for line in got[8:11])
        + f" (every launch held at rtol {F32_RTOL} / atol {F32_ATOL}); "
        f"int_to_f32 at n 25 on 10000 elements bit-equal to .float(); "
        f"launches {counts}")


def serve_counts(name, eng, cfg, counts, before, flavour):
    """Exact launches of the serves since ``before`` (the engine's stats
    then): each decode step its quantized matrices through ``flavour``
    and each layer's attention in ring mode, each prefill pass the
    matrices and wk / wv again; nothing else.  Returns the step and pass
    counts."""
    st = eng.stats()
    steps = st["decode_iterations"] - before.get("decode_iterations", 0)
    passes = st["prefill_iterations"] - before.get("prefill_iterations", 0)
    dec, pre = lut_calls(eng.params)
    other = "lut_matmul" if flavour == "lut_matmul_int" else "lut_matmul_int"
    need = {flavour: dec * steps + pre * passes, other: 0,
            "decode_attention": cfg.n_layers * steps,
            "decode_attention_table": 0, "int_to_f32": 0}
    if any(counts[k] != v for k, v in need.items()):
        fail(f"examples {name}: launches {counts}, need {need} ({dec} "
             f"LUT-GEMV and {cfg.n_layers} attentions per decode step, "
             f"{pre} LUT-GEMV per prefill pass; {steps} steps, {passes} "
             "passes)")
    return dict(decode_steps=steps, prefill_passes=passes,
                lut_per_decode_step=dec, lut_per_prefill=pre,
                attention_per_decode_step=cfg.n_layers)


def serve_held(torch, sb, params, cfg, args, name, flavour):
    """``build_engine`` and ``serve`` on the card, every launch held and
    counted: (engine, {uid: tokens}, record, logits rows, lines)."""
    dev = torch.device("cuda")
    eng, head = quietly(sb.build_engine, params, cfg, args, dev)
    rows = Recorder(eng)
    with counted(torch) as counts, Held(torch, name) as held, \
            HeldAttn(torch, name) as held_attn:
        comps, lines = quietly(sb.serve, eng, cfg, args, dev)
    rec = serve_counts(name, eng, cfg, counts, {}, flavour)
    rec.update(launches=counts, held_lut=sum(held.calls.values()),
               max_abs_err_lut=held.err["int" if "int" in flavour
                                         else "f32"],
               held_attention=held_attn.calls,
               max_abs_err_attention=held_attn.err)
    return eng, {c.uid: c.tokens for c in comps}, rec, rows, head + lines


def examples_serve(torch, res):
    """(b): serve_batched at the smoke config on the card and the CPU, at
    full width and depth (timed, then served again under the holds), and
    under uniform:4a8."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    sb = example("serve_batched")
    runs = res["runs"]
    args = sb.parse_args(["--device", "cuda"])
    cfg = sb.model_config(args)
    raw = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.cuda(), raw)
    eng, got, rec, rows, lines = serve_held(torch, sb, card, cfg, args,
                                            "serve_batched smoke",
                                            "lut_matmul")
    del eng
    cpu_args = sb.parse_args(["--device", "cpu"])
    ceng, cpu_lines = quietly(sb.build_engine, raw, cfg, cpu_args,
                              torch.device("cpu"))
    cpu_rows = Recorder(ceng)
    comps, served = quietly(sb.serve, ceng, cfg, cpu_args,
                            torch.device("cpu"))
    cpu_lines += served
    want = {c.uid: c.tokens for c in comps}
    ties = {}
    for uid, step in first_parting(got, want).items():
        tie = ties[str(uid)] = near_tie(torch, rows.rows, cpu_rows.rows,
                                        uid, step)
        if not tie["explained"]:
            fail(f"examples (b) smoke: request {uid} parts from the CPU's "
                 f"at token {step}, no near-tie explains it ({tie})")
    name = torch.cuda.get_device_name(0)
    if (len(got) != args.requests or lines[0] != cpu_lines[0]
            or f"measured on {name}" not in lines[1]):
        fail(f"examples (b) smoke: {len(got)} completions; {lines[:2]} "
             f"against the CPU's {cpu_lines[:1]}")
    rec.update(equal_to_cpu=sum(got[u] == want[u] for u in want),
               near_ties=ties, first_tokens={u: t[:8] for u, t in got.items()})
    runs["serve_batched smoke"] = rec
    log(f"[examples] (b) serve_batched smoke ({cfg.name}): {lines[0]}; "
        f"{rec['equal_to_cpu']} of {len(want)} requests' greedy tokens "
        f"equal the CPU's, near-ties {ties}; launches {rec['launches']}, "
        f"exactly {rec['lut_per_decode_step']} LUT-GEMV and "
        f"{rec['attention_per_decode_step']} attentions per decode step, "
        f"{rec['lut_per_prefill']} LUT-GEMV per prefill pass, every launch "
        f"held (max abs err {rec['max_abs_err_lut']:.3e} / "
        f"{rec['max_abs_err_attention']:.3e})")

    # uniform:4a8 at the smoke config: the int LUT-GEMV
    a8 = sb.parse_args(["--device", "cuda", "--plan", "uniform:4a8"])
    eng, got8, rec, _, _ = serve_held(torch, sb, card, cfg, a8,
                                      "serve_batched uniform:4a8",
                                      "lut_matmul_int")
    rec["equal_to_uniform4"] = sum(got8[u] == got[u] for u in got)
    runs["serve_batched --plan uniform:4a8"] = rec
    del eng, card
    log(f"[examples] (b) serve_batched --plan uniform:4a8: launches "
        f"{rec['launches']} (exact), every int LUT-GEMV launch held (max "
        f"abs err {rec['max_abs_err_lut']:.3e}); {rec['equal_to_uniform4']} "
        f"of {len(got)} requests equal uniform:4's tokens")

    # --full: tinymistral_248m at full width and depth, timed as the
    # example runs it, then the same requests again under the holds
    torch.cuda.reset_peak_memory_stats()
    with counted(torch) as counts:
        (eng, comps), lines = quietly(sb.main, ["--full"])
    cfg = eng.cfg
    rec = serve_counts("serve_batched --full", eng, cfg, counts, {},
                       "lut_matmul")
    first = {c.uid: c.tokens for c in comps}
    m = EX_SERVED.search(lines[1])
    st = eng.stats()
    rec.update(launches=counts, tok_per_s=float(m.group(1)),
               mean_ttft_s=st["mean_ttft_s"],
               decode_tok_per_s=st["measured_tps"],
               compression=eng.compression, layers=cfg.n_layers,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30, lines=lines)
    before = eng.stats()
    with counted(torch) as counts, \
            Held(torch, "serve_batched --full") as held, \
            HeldAttn(torch, "serve_batched --full") as held_attn:
        again, _ = quietly(sb.serve, eng, cfg, sb.parse_args(["--full"]),
                           torch.device("cuda"))
    held_rec = serve_counts("serve_batched --full (held)", eng, cfg, counts,
                            before, "lut_matmul")
    same = [c.tokens for c in again[len(first):]] == list(first.values())
    if (len(first) != 8 or any(len(t) != 16 for t in first.values())
            or not same or held_rec != {k: rec[k] for k in held_rec}):
        fail(f"examples (b) --full: {len(first)} completions, the held "
             f"rerun's tokens equal: {same}, its passes {held_rec} against "
             f"{rec}")
    held_rec.update(launches=counts, held_lut=sum(held.calls.values()),
                    max_abs_err_lut=held.err["f32"],
                    held_attention=held_attn.calls,
                    max_abs_err_attention=held_attn.err)
    runs["serve_batched --full"] = rec
    runs["serve_batched --full (held rerun)"] = held_rec
    del eng
    log(f"[examples] (b) serve_batched --full ({cfg.name}, "
        f"{cfg.n_layers} layers, {card_line()}): {lines[0]}; {lines[1]}; "
        f"decode {rec['decode_tok_per_s']:.1f} tok/s, mean TTFT "
        f"{rec['mean_ttft_s'] * 1e3:.1f} ms, max memory allocated "
        f"{rec['max_memory_allocated_gb']:.2f} GB; launches "
        f"{rec['launches']}, exactly {rec['lut_per_decode_step']} LUT-GEMV "
        f"and {rec['attention_per_decode_step']} attentions per decode step "
        f"({rec['decode_steps']} steps), {rec['lut_per_prefill']} LUT-GEMV "
        f"per prefill pass ({rec['prefill_passes']}); the held rerun: same "
        f"tokens, every launch held (max abs err "
        f"{held_rec['max_abs_err_lut']:.3e} / "
        f"{held_rec['max_abs_err_attention']:.3e})")


def qe_rows(lines):
    return {m.group(1): m.groups()[1:]
            for m in map(EX_QE_ROW.fullmatch, lines) if m}


def examples_quantize(torch, res):
    """(c): quantize_and_eval at its defaults, card against CPU from one
    initial tree, every LUT-GEMV launch held and counted by M; again
    under --nf on the card."""
    import repro_torch.configs as C
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, quantize_params
    from repro_torch.tree import tree_map
    qe = example("quantize_and_eval")
    args = qe.parse_args(["--device", "cuda"])
    cfg = C.get_smoke(args.arch)
    init = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    t0 = time.perf_counter()
    _, want = quietly(qe.run, init, cfg, qe.parse_args(["--device", "cpu"]),
                      torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    rows = {}
    for flag in ([], ["--nf"]):
        name = " ".join(["quantize_and_eval"] + flag)
        t0 = time.perf_counter()
        with counted(torch) as counts, \
                Held(torch, name, cache=False) as held, CountByM() as by_m:
            trained, got = quietly(qe.run, tree_map(lambda t: t.cuda(), init),
                                   cfg, qe.parse_args(["--device", "cuda"]
                                                      + flag),
                                   torch.device("cuda"))
        seconds = time.perf_counter() - t0
        dec = lut_calls(quantize_params(trained, QuantPolicy(
            bits=4, group_size=32, min_size=1024))[0])[0]
        rows[name] = qe_rows(got)
        need = {8 * 64: (EX_QE_SWEEP + 1) * dec}     # B x T rows a pass
        if (dict(by_m.by_m) != need or counts["lut_matmul"] != sum(
                need.values()) or counts["lut_matmul_int"]
                or counts["decode_attention"] or counts["int_to_f32"]
                or len(rows[name]) != EX_QE_SWEEP + 2):
            fail(f"examples (c) {name}: launches {counts}, by M "
                 f"{dict(by_m.by_m)} (need {need}: {dec} a forward), rows "
                 f"{list(rows[name])}")
        res["runs"][name] = dict(launches=counts, by_m=dict(by_m.by_m),
                                 lut_per_forward=dec, seconds=seconds,
                                 max_abs_err_lut=held.err["f32"],
                                 lines=got)
    mine, cpu = rows["quantize_and_eval"], qe_rows(want)
    diff = {k: abs(float(mine[k][0]) - float(cpu[k][0])) for k in cpu}
    comp = {k: mine[k][2] == cpu[k][2] for k in cpu}
    if list(mine) != list(cpu) or max(diff.values()) > EX_QE_TOL \
            or not all(comp.values()):
        fail(f"examples (c): eval losses card against CPU {diff} (tolerance "
             f"{EX_QE_TOL}), compression equal {comp}")
    rec = res["runs"]["quantize_and_eval"]
    rec.update(loss_diff_vs_cpu=diff, cpu_seconds=cpu_s, cpu_lines=want)
    log(f"[examples] (c) quantize_and_eval ({cfg.name}): card "
        f"{rec['seconds']:.1f} s, CPU {cpu_s:.1f} s; eval losses card "
        f"against CPU within "
        f"{max(diff.values()):.1e} (tolerance {EX_QE_TOL}): "
        + ", ".join(f"{k} {mine[k][0]}/{cpu[k][0]}" for k in mine)
        + f"; compression column equal; launches {rec['launches']} all at "
        f"M {list(rec['by_m'])} ({rec['lut_per_forward']} a forward, every "
        f"launch held, max abs err {rec['max_abs_err_lut']:.3e}); --nf: "
        + ", ".join(f"{k} {v[0]}" for k, v in rows["quantize_and_eval --nf"]
                    .items())
        + f", launches {res['runs']['quantize_and_eval --nf']['launches']}")


class LoggedStep:
    """A train step timed (``TimedStep``) that also keeps its losses."""

    def __init__(self, torch, fn):
        self.timed, self.losses = TimedStep(torch, fn), []

    def __call__(self, params, opt_state, batch):
        out = self.timed(params, opt_state, batch)
        self.losses.append(float(out[2]["loss"]))
        return out


def examples_train(torch, res):
    """(d): train_lm's tiny preset to a checkpoint, resumed, against an
    uninterrupted run; the 100m preset timed for three steps."""
    import dataclasses
    from repro_torch.models import lm
    tl = example("train_lm")
    runs, ckpt = res["runs"], os.path.join(OUT_DIR, "examples_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # the example installs the loop's SIGTERM / SIGINT handlers: this
    # process keeps its own
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        out = {}
        for name, argv in (
                ("tiny", ["--steps", str(EX_TINY_STEPS), "--ckpt", ckpt]),
                ("tiny resumed", ["--steps", str(EX_RESUME_STEPS), "--ckpt",
                                  ckpt]),
                ("tiny uninterrupted", ["--steps", str(EX_RESUME_STEPS)])):
            t0 = time.perf_counter()
            with counted(torch) as counts:
                result, lines = quietly(tl.main, argv)
            out[name] = result
            runs[f"train_lm {name}"] = dict(
                launches=counts, seconds=time.perf_counter() - t0,
                losses={r["step"]: r["loss"] for r in result["log"]},
                lines=lines)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        for s, handler in saved.items():
            signal.signal(s, handler)
    first = out["tiny"]["log"]
    resumed = runs["train_lm tiny resumed"]["lines"]
    last, whole = (out["tiny resumed"]["log"][-1]["loss"],
                   out["tiny uninterrupted"]["log"][-1]["loss"])
    if (not first[-1]["loss"] < first[0]["loss"]
            or f"resumed from step {EX_TINY_STEPS}" not in resumed
            or out["tiny resumed"]["final_step"] != EX_RESUME_STEPS
            or abs(last - whole) > EX_RESUME_RTOL * abs(whole)
            or any(sum(r["launches"].values()) for k, r in runs.items()
                   if k.startswith("train_lm"))):
        fail(f"examples (d) train_lm tiny: losses {first[0]['loss']} -> "
             f"{first[-1]['loss']}; resumed {resumed[-3:]}: last loss "
             f"{last} against {whole} uninterrupted (rtol "
             f"{EX_RESUME_RTOL})")
    log(f"[examples] (d) train_lm tiny: loss {first[0]['loss']:.4f} -> "
        f"{first[-1]['loss']:.4f} in {EX_TINY_STEPS} steps; resumed from "
        f"step {EX_TINY_STEPS} to {EX_RESUME_STEPS}: last loss {last!r} "
        f"against {whole!r} uninterrupted (|d| {abs(last - whole):.2e}); "
        f"no kernel launched")

    # 100m: the reference's real driver config at full width
    args = tl.parse_args(["--preset", "100m", "--steps", str(EX_100M_STEPS)])
    dev = torch.device("cuda")
    cfg = tl.preset_cfg(args.preset, args.arch)
    torch.cuda.reset_peak_memory_stats()
    with counted(torch) as counts:
        built, head = quietly(tl.build, cfg, dev)
        step = LoggedStep(torch, built.fn)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                dev)
        try:
            result, lines = quietly(tl.train,
                                    dataclasses.replace(built, fn=step),
                                    params, cfg, args)
        finally:
            for s, handler in saved.items():
                signal.signal(s, handler)
    del params
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    micro = built.meta["microbatches"]
    if (micro != 8 or result["final_step"] != EX_100M_STEPS
            or len(step.losses) != EX_100M_STEPS
            or not all(math.isfinite(x) for x in step.losses)
            or sum(counts.values())):
        fail(f"examples (d) train_lm 100m: {micro} microbatches (need 8), "
             f"losses {step.losses}, launches {counts}")
    runs["train_lm 100m"] = dict(
        launches=counts, microbatches=micro, losses=step.losses,
        step_ms=step.timed.ms, step_wall_ms=step.timed.wall_ms,
        max_memory_allocated_gb=mem, batch=args.batch, seq=args.seq,
        lines=head + lines)
    log(f"[examples] (d) train_lm --preset 100m ({lines[0]}): "
        f"{EX_100M_STEPS} steps of B {args.batch} x T {args.seq} in "
        f"{micro} microbatches (auto_microbatches at train_4k), losses "
        f"{[round(x, 4) for x in step.losses]}, step device span "
        f"{[round(x, 1) for x in step.timed.ms]} ms, wall "
        f"{[round(x, 1) for x in step.timed.wall_ms]} ms, max memory "
        f"allocated {mem:.2f} GB ({card_line()})")


def phase_examples(rt):
    import torch
    res = rt["examples"] = {"runs": {}, "seconds": {}}
    for part, fn in (("quickstart", examples_quickstart),
                     ("serve_batched", examples_serve),
                     ("quantize_and_eval", examples_quantize),
                     ("train_lm", examples_train)):
        t0 = time.perf_counter()
        fn(torch, res)
        gc.collect()
        torch.cuda.empty_cache()
        res["seconds"][part] = time.perf_counter() - t0
    log(f"[examples] seconds {res['seconds']}")


def examples_fields(examples: dict, name: str) -> dict:
    """Kernel ``name``'s launches in phase 15's runs of the examples and
    its held sets' worst errors."""
    runs = examples["runs"]
    out = {"launches_examples": {run: rec["launches"].get(name, 0)
                                 for run, rec in runs.items()}}
    if name.startswith("lut_matmul"):
        out["max_abs_err_examples"] = {
            run: rec["max_abs_err_lut"] for run, rec in runs.items()
            if "max_abs_err_lut" in rec and rec["launches"].get(name)}
    if name == "decode_attention":
        out["max_abs_err_examples"] = {
            run: rec["max_abs_err_attention"] for run, rec in runs.items()
            if "max_abs_err_attention" in rec}
    if name == "int_to_f32":
        out["max_abs_err_examples"] = {"quickstart": 0.0}
    return out


def dist_fields(dist: dict, name: str) -> dict:
    """Kernel ``name``'s launches in phase 14's serving of the restored
    trees and its held sets' worst errors (training launches none)."""
    serve, cut = dist["serve"], dist["cut"]
    out = {"launches_dist": {"restored uniform:4": serve["launches"][name],
                             "restored a8 cut": cut["launches"].get(name,
                                                                    0)}}
    # the tensor-parallel training runs' steps, rank 0 (expected 0)
    out["launches_dist"].update({
        f"tp train {k[3:]}": v["ranks"][0]["launches"][name]
        for k, v in dist.items() if k.startswith("tp_")})
    if name == "lut_matmul":
        out["max_abs_err_dist"] = max(serve["max_abs_err_lut"],
                                      cut["max_abs_err_lut"])
    if name == "lut_matmul_int":
        out["max_abs_err_dist"] = cut["max_abs_err_lut_int"]
    if name == "decode_attention":
        out["max_abs_err_dist"] = max(serve["max_abs_err_attention"],
                                      cut["max_abs_err_attention"])
    return out


def train_fields(train: dict, name: str) -> dict:
    """Kernel ``name``'s launches in phase 13's serving of the trained tree
    and in (e)'s default steps, and its held sets' worst errors (training
    itself launches none)."""
    serve = train["serve"]
    out = {"launches_train": {
        "serve": serve["launches"][name],
        **{f"cut {kv}": rec["launches"].get(name, 0)
           for kv, rec in serve["cut"].items()},
        **{f"{DEFAULT_SHAPE} step {k}": rec["launches"].get(name, 0)
           for k, rec in train["default_step"].items()
           if isinstance(rec, dict)}}}
    if name == "lut_matmul":
        out["max_abs_err_train"] = max(
            [serve["max_abs_err_lut"]] + [r["max_abs_err_lut"]
                                          for r in serve["cut"].values()])
    if name == "decode_attention":
        out["max_abs_err_train"] = max(
            [serve["max_abs_err_attention"]]
            + [r["max_abs_err_attention"] for r in serve["cut"].values()])
    return out


def others_fields(others: dict, name: str) -> dict:
    """Kernel ``name``'s launches in phase 12's runs, each held set's worst
    error, and the new paths' step and attention timings."""
    fam = {k: v for k, v in others.items()
           if k not in ("seconds", "attention_rows")}
    out = {"launches_others": {
        f"{arch} {run}": rec[run]["launches"].get(name, 0)
        for arch, rec in fam.items()
        for run in ("ring", "paged", "ring 4a8", "held") if run in rec
        and "launches" in rec[run]}}
    if name in ("lut_matmul", "lut_matmul_int", "decode_attention"):
        key = ("max_abs_err_attention" if name == "decode_attention"
               else "max_abs_err_lut")
        errs = held_errors(fam, key)
        errs = {k: v for k, v in errs.items()
                if ("4a8" in k) == (name == "lut_matmul_int")}
        out["max_abs_err_others"] = errs
        out["per_decode_step_others"] = {
            arch: rec["held"]["attention_per_decode_step" if name ==
                              "decode_attention" else "lut_per_decode_step"]
            for arch, rec in fam.items()}
    if name == "decode_attention":
        out["rows_others"] = others["attention_rows"]
        out["whisper_cross_attention_step"] = fam[WHISPER]["cross_attention"]
    if name == "lut_matmul":
        out["whisper_lut_m12000"] = fam[WHISPER]["lut_m12000"]
    return out


def held_errors(tree: dict, key: str, prefix: str = "") -> dict:
    """{path: value} of every ``key`` in a nested record (phase 11's held
    sets' worst errors)."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            if key in sub:
                out[prefix + name] = sub[key]
            out.update(held_errors(sub, key, f"{prefix}{name} "))
    return out


def families_fields(families: dict, name: str) -> dict:
    """Kernel ``name``'s launches in phase 11's runs (all ``uniform:4``: the
    int LUT-GEMV and typeconv are on none of them), each held set's worst
    error, and the llama2_7b step's and the narrow heads' timings."""
    fam = {k: v for k, v in families.items()
           if k not in ("seconds", "narrow_timing", "quantizers")}
    out = {"launches_families": {
        f"{arch} {run}": rec[run]["launches"][name]
        for arch, rec in fam.items() for run in ("ring", "paged")
        if run in rec}}
    if name in ("lut_matmul", "decode_attention"):
        key = ("max_abs_err_lut" if name == "lut_matmul"
               else "max_abs_err_attention")
        out["max_abs_err_families"] = held_errors(fam, key)
    if name == "lut_matmul":
        out["llama2_7b_step_graph"] = fam["llama2_7b"]["lut_step"]
    if name == "decode_attention":
        out["llama2_7b_attention_step_graph"] = \
            fam["llama2_7b"]["attention_step"]
        out["narrow_head_rows"] = families["narrow_timing"]
    return out


def kernels_line(rt) -> dict:
    """``launches`` is each kernel's count from the engine run of the plan
    that routes through it (the standalone int_to_f32 is on neither path:
    its device function is inlined into the int LUT-GEMV, so its count is
    read from the uniform:4a8 run and is expected to be 0; quickstart's
    section 3 launches it, ``launches_examples``)."""
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
        # phase 8: the sampled, batch-mode and unquantized runs, and
        # phase 5's copy-on-write run
        entry["launches_sampling"] = {
            run: rec["launches"][name]
            for run, rec in rt["sampling"]["runs"].items()}
        entry["launches_sampling"]["paged C (copy-on-write)"] = \
            rt["paged"]["C"]["launches"][name]
        # phase 9: the speculative runs (draft, verify and rollback) and the
        # controlled ones
        entry["launches_speculation"] = {
            run: rec["launches"][name]
            for run, rec in rt["speculation"]["runs"].items()}
        entry["launches_speculation"]["controller ring"] = \
            rt["speculation"]["controller_ring"]["launches"][name]
        if name == "lut_matmul":
            entry["launches_speculation_by_m"] = {
                run: rec["lut_launches_by_m"]
                for run, rec in rt["speculation"]["runs"].items()}
        if name.startswith("lut_matmul"):   # phases 6-7, per instance
            entry["launches_plans"] = {
                run: {k: v for k, v in rec["instances"].items()
                      if ("a" in k) == (name == "lut_matmul_int")}
                for run, rec in list(rt["plans"]["runs"].items())
                + list(rt["planner"]["runs"].items())}
            entry["step_graph_ms_per_bits"] = {
                f"b{b}": row["step_graph_ms"]
                for b, row in rt["plans"]["lut_step_graph"].items()}
        # phase 10: one rank's launches by shape in each tensor-parallel run
        entry["launches_tp"] = {
            f"{tp} {run}": {k: v for k, v in rec["by_shape"].items()
                            if k.split(" ")[0] == name}
            for tp, r in rt["tp"].items() for run, rec in r["runs"].items()}
        if name == "decode_attention" or name.startswith("lut_matmul"):
            # every launch of those runs held against its plain version
            entry["max_abs_err_tp"] = {
                f"{tp} {run}": rec["held_attn_err" if name ==
                                   "decode_attention" else "held_err"]
                for tp, r in rt["tp"].items()
                for run, rec in r["runs"].items()
                if rec["launches"].get(name)}
        entry.update(families_fields(rt["families"], name))
        entry.update(others_fields(rt["others"], name))
        entry.update(train_fields(rt["train"], name))
        entry.update(dist_fields(rt["dist"], name))
        entry.update(examples_fields(rt["examples"], name))
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
    phases = (("build", phase_build), ("kernels", phase_kernels),
              ("model", phase_model), ("engine", phase_engine),
              ("paged", phase_paged), ("plans", phase_plans),
              ("planner", phase_planner), ("sampling", phase_sampling),
              ("speculation", phase_speculation), ("tp", phase_tp),
              ("families", phase_families), ("others", phase_others),
              ("train", phase_train), ("dist", phase_dist),
              ("examples", phase_examples))
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--phases"] else None
    for name, fn in phases:
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        fn(rt)
        log(f"[{name}] phase passed in {time.perf_counter() - t0:.1f} s")
    if only is not None:
        # a development run of some phases: no kernel line, no result
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "phases.json"), "w") as f:
            json.dump({k: rt[k] for k in ("families", "others", "planner",
                                          "train", "dist", "examples",
                                          "build_s")
                       if k in rt}, f, indent=1, default=str)
        log(f"phases {only} passed in {time.perf_counter() - t_all:.1f} s")
        return 0
    line = kernels_line(rt)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump({"card": card_line(), "kernels": line["kernels"],
                   "engine": rt["engine"], "paged": rt["paged"],
                   "plans": rt["plans"], "planner": rt["planner"],
                   "sampling": rt["sampling"],
                   "speculation": rt["speculation"], "tp": rt["tp"],
                   "families": rt["families"], "others": rt["others"],
                   "train": rt["train"], "dist": rt["dist"],
                   "examples": rt["examples"], "build_s": rt["build_s"],
                   "model_err": rt["model_err"]}, f, indent=1)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
