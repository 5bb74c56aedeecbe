"""Serving launcher for the PyTorch/CUDA port (SAIL quantized path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinymistral_248m \\
        --smoke --device cpu

Random weights from a seeded ``torch.Generator``, quantized to ``--ql``
bits or by a precision ``--plan``, int8 KV unless ``--no-quant-kv`` (or the
plan's ``kv=8|32``), continuous batching over ``--batch`` KV-pool slots.
``--device`` defaults to ``cuda`` and the run fails rather than fall back
when CUDA is missing.

    # a plan: grammar string or a solved plan.json
    ... --plan 'rules:mlp=3,attn=5a8,default=4' --save-plan plan.json
    ... --plan plan.json          # reuse: no recalibration at startup
    # an auto plan: the Planner probes the model and solves it at startup
    ... --plan 'auto:q4a8,kv=auto' --save-plan plan.json
    # SLO-driven: derive the cycle+DRAM budgets from a target tokens/s
    ... --slo 80 --tap 512        # tap live traffic for later replans

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
    ap.add_argument("--bit-policy", default=None,
                    help="DEPRECATED alias for --plan (grammar strings "
                         "only)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import repro_torch.configs as C
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.planning import plan_from_arg
    from repro_torch.serving.engine import Engine, EngineConfig

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    plan = plan_from_arg(args.plan) if args.plan is not None else None
    eng = Engine(params, cfg, EngineConfig(
        batch_size=args.batch, cache_len=args.cache_len, ql=args.ql,
        plan=plan, slo=args.slo, tap_capacity=args.tap,
        bit_policy=args.bit_policy,
        group_size=(args.group_size if args.group_size is not None
                    else min(128, cfg.d_model)),
        quant_kv=not args.no_quant_kv), device=dev)
    pol, st = eng.quant_policy, eng.stats()
    desc = (f"mixed-precision plan {eng.plan.format()}"
            if st["mixed_precision"] else
            f"Q{pol.bits}{'' if pol.act_bits is None else f'a{pol.act_bits}'}")
    print(f"{cfg.name} on {dev}: {desc} weights (plan {st['plan_hash']}, "
          f"{eng.compression:.2f}x compression), "
          f"{'int8' if st['kv_bits'] == 8 else 'f32'} KV, continuous "
          "scheduling")
    if args.save_plan:
        eng.plan.save(args.save_plan)
        print(f"wrote plan {eng.plan.spec_hash} to {args.save_plan}")

    on_token = None
    if args.stream:
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
    if eng.tap is not None:
        print(f"tap: {st['tapped_rows']} activation rows captured across "
              f"{eng.tap.n_layers} layers (Engine.replan() recalibrates "
              f"measured PRT discounts from them)")


if __name__ == "__main__":
    main()
