"""Serving launcher for the PyTorch/CUDA port (SAIL quantized path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinymistral_248m \\
        --smoke --device cpu

Random weights from a seeded ``torch.Generator``, quantized to ``--ql``
bits or by a precision ``--plan``, int8 KV unless ``--no-quant-kv`` (or the
plan's ``kv=8|32``), continuous batching over ``--batch`` KV-pool slots
(``--mode batch``: run-to-completion cohorts of ``--batch``;
``--prefill-budget``: new prompt tokens admitted per iteration).
``--device`` defaults to ``cuda`` and the run fails rather than fall back
when CUDA is missing.  ``--arch`` takes any decoder of
``repro_torch.configs.ARCHS`` (hymba and xlstm serve on the ring pool;
phi-3-vision's requests are text-only here); whisper, an encoder-decoder,
is served through ``models.encdec`` and refused here, as the reference's
launcher refuses it.

    # a plan: grammar string or a solved plan.json
    ... --plan 'rules:mlp=3,attn=5a8,default=4' --save-plan plan.json
    ... --plan plan.json          # reuse: no recalibration at startup
    # an auto plan: the Planner probes the model and solves it at startup
    ... --plan 'auto:q4a8,kv=auto' --save-plan plan.json
    # SLO-driven: derive the cycle+DRAM budgets from a target tokens/s
    ... --slo 80 --tap 512        # tap live traffic for later replans
    # self-speculative decoding: a q2 draft of the same weights, k = 4
    ... --plan 'uniform:4,draft=q2:k4'      # or draft=auto
    # the SLO controller: shed admissions against the SLO, replan on drift
    ... --slo 2000 --controller --deadband 0.25 --check-every 8
    # tensor-parallel: the quantized tree sharded over 2 spawned ranks
    ... --tp 2 --wire 8            # or a plan's tp=2,wire=8

``--tp M`` (or a plan's ``tp=M``) spawns M ranks of one gloo process group
(``launch.mesh.run_ranks``); each builds the same engine on the same
requests and keeps its shard, rank r on ``cuda:(r % device_count)`` (or
the CPU with ``--device cpu``), and rank 0 prints the report.
``--bit-policy`` remains as a deprecated alias routed through
``PlanSpec.parse``.  The modeled tokens/s it prints are the paper's SAIL
machine's (``planning.DecodeCostModel``), not the card's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ql", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=None,
                    help="quantization group size (default min(128, d_model))")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--no-quant-kv", action="store_true")
    ap.add_argument("--plan", default=None,
                    help="precision plan: a grammar string "
                         "(uniform:<b>[a<ab>] | rules:<regex>=<b>[a<ab>],"
                         "... | auto:q<b>[a<ab>][,prt=...][,maxseg=<n>]"
                         "[,slo=<tps>] | auto:<f>bpw) or a path to a "
                         "plan.json written by --save-plan (solved plans "
                         "serve without recalibration)")
    ap.add_argument("--slo", type=float, default=None,
                    help="target decode tokens/s at --batch: auto plans "
                         "derive their cycle AND DRAM-byte budgets from "
                         "this instead of a fixed constant (implies "
                         "auto:q<ql>a8,prt=measured when --plan is "
                         "omitted)")
    ap.add_argument("--save-plan", default=None,
                    help="write the engine's (solved) plan JSON here")
    ap.add_argument("--tap", type=int, default=0, metavar="ROWS",
                    help="capture per-layer decode activations into an "
                         "ActivationTap of this capacity (enables online "
                         "PRT recalibration via Engine.replan)")
    ap.add_argument("--controller", action="store_true",
                    help="attach the SLO controller "
                         "(repro_torch.serving.control.SloController): "
                         "sheds/shrinks occupancy against --slo and gates "
                         "replans on measured-vs-modeled drift")
    ap.add_argument("--deadband", type=float, default=None,
                    help="controller: |anchored drift| tolerated without "
                         "action (default 0.25)")
    ap.add_argument("--cooldown", type=int, default=None,
                    help="controller: decode iterations between actions "
                         "(default 32)")
    ap.add_argument("--check-every", type=int, default=None,
                    help="controller: decode iterations between drift "
                         "checks (default 8)")
    ap.add_argument("--bit-policy", default=None,
                    help="DEPRECATED alias for --plan (grammar strings "
                         "only)")
    ap.add_argument("--mode", choices=("continuous", "batch"),
                    default="continuous")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max new prefill tokens admitted per iteration")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards: spawn this many ranks, "
                         "each serving its slice of the quantized tree "
                         "(a plan carrying tp= overrides this knob)")
    ap.add_argument("--wire", type=int, default=32, choices=(8, 32),
                    help="all-reduce precision under --tp: 32 exact f32 "
                         "partial sums, 8 int8 + one scale per tensor")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.planning import plan_from_arg

    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-only arch for the LM server")
    resolve_device(args.device)
    plan = plan_from_arg(args.plan) if args.plan is not None else None
    world = (plan.tp if plan is not None and isinstance(plan.tp, int)
             else args.tp)
    if world > 1:
        run_ranks(_serve, world, args=(args, plan))
    else:
        _serve(0, args, plan)


def _serve(rank: int, args, plan) -> None:
    """Build the engine on this rank's device, serve the seeded requests,
    and (rank 0) print the report."""
    import torch

    import repro_torch.configs as C
    from repro_torch.launch.mesh import rank_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig

    dev = rank_device(rank, args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    controller = None
    if args.controller:
        knobs = {k: v for k, v in (("deadband", args.deadband),
                                   ("cooldown", args.cooldown),
                                   ("check_every", args.check_every))
                 if v is not None}
        controller = knobs or True
    eng = Engine(params, cfg, EngineConfig(
        batch_size=args.batch, cache_len=args.cache_len, ql=args.ql,
        plan=plan, slo=args.slo, tap_capacity=args.tap,
        controller=controller, bit_policy=args.bit_policy, mode=args.mode,
        prefill_budget=args.prefill_budget,
        group_size=(args.group_size if args.group_size is not None
                    else min(128, cfg.d_model)),
        quant_kv=not args.no_quant_kv, tp=args.tp, wire=args.wire),
        device=dev)
    pol, st = eng.quant_policy, eng.stats()
    desc = (f"mixed-precision plan {eng.plan.format()}"
            if st["mixed_precision"] else
            f"Q{pol.bits}{'' if pol.act_bits is None else f'a{pol.act_bits}'}")
    tp_desc = ("" if st["tp"] is None else
               f", tp={st['tp']['shards']} (wire={st['tp']['wire_bits']})")
    if rank == 0:
        print(f"{cfg.name} on {dev}: {desc} weights (plan "
              f"{st['plan_hash']}, {eng.compression:.2f}x compression), "
              f"{'int8' if st['kv_bits'] == 8 else 'f32'} KV, {args.mode} "
              f"scheduling{tp_desc}")
    if args.save_plan and rank == 0:
        eng.plan.save(args.save_plan)
        print(f"wrote plan {eng.plan.spec_hash} to {args.save_plan}")

    on_token = None
    if args.stream and rank == 0:
        on_token = lambda uid, tok: print(f"  [uid {uid}] {tok}")
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        n = int(rng.integers(4, 16))
        eng.submit(rng.integers(0, cfg.vocab, size=n).tolist(),
                   max_new_tokens=args.max_new, on_token=on_token)
    t0 = time.perf_counter()
    eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if rank != 0:
        return
    st = eng.stats()
    print(f"{st['requests']} requests, {st['generated_tokens']} tokens, "
          f"{st['generated_tokens'] / dt:.2f} tok/s, "
          f"mean latency {st['mean_latency_s']:.3f}s "
          f"(p99 {st['p99_latency_s']:.3f}s), "
          f"mean TTFT {st['mean_ttft_s']:.3f}s, "
          f"{st['iterations']} model iterations "
          f"({st['prefill_iterations']} prefill / "
          f"{st['decode_iterations']} decode, "
          f"{st['prefill_tokens']} prompt tokens)")
    if st["measured_tps"] is not None:
        print(f"decode: measured {st['measured_tps']:.1f} tok/s on {dev}; "
              f"the SAIL machine model prices the plan at "
              f"{st['planned_tps']:.0f} tok/s at the full pool (raw drift "
              f"{st['drift']:+.3f}: a comparison of two machines, not a "
              "calibration check)")
    if st["speculative"] is not None:
        sp = st["speculative"]
        rate = ("n/a" if sp["acceptance_rate"] is None
                else f"{sp['acceptance_rate']:.3f}")
        acts = ("" if sp["draft_act_bits"] is None
                else f"a{sp['draft_act_bits']}")
        print(f"speculative: draft q{sp['draft_bits']}{acts}, k={sp['k']}: "
              f"{sp['rounds']} rounds, {sp['accepted']} of {sp['drafted']} "
              f"drafts accepted ({rate})")
    if st["controller"] is not None:
        c = st["controller"]
        print(f"controller: batch cap {c['batch_cap']}, "
              f"{c['checks']} drift checks, "
              f"shed {c['shed']} / shrink {c['shrink']} / "
              f"replan {c['replan']} / resolve {c['resolve']} / "
              f"skipped {c['skipped']}")
    if eng.tap is not None:
        print(f"tap: {st['tapped_rows']} activation rows captured across "
              f"{eng.tap.n_layers} layers (Engine.replan() recalibrates "
              f"measured PRT discounts from them)")


if __name__ == "__main__":
    main()
