"""Serving launcher for the PyTorch/CUDA port (SAIL quantized path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinymistral_248m \\
        --smoke --device cpu

Random weights from a seeded ``torch.Generator``, quantized to ``--ql``
bits (or ``--plan uniform:<b>[a<ab>]``), int8 KV unless ``--no-quant-kv``,
continuous batching over ``--batch`` KV-pool slots.  ``--device`` defaults
to ``cuda`` and the run fails rather than fall back when CUDA is missing.
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
                    help="precision plan: uniform:<b>[a<ab>]")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import repro_torch.configs as C
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, EngineConfig

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    eng = Engine(params, cfg, EngineConfig(
        batch_size=args.batch, cache_len=args.cache_len, ql=args.ql,
        plan=args.plan,
        group_size=(args.group_size if args.group_size is not None
                    else min(128, cfg.d_model)),
        quant_kv=not args.no_quant_kv), device=dev)
    pol = eng.quant_policy
    print(f"{cfg.name} on {dev}: Q{pol.bits}"
          f"{'' if pol.act_bits is None else f'a{pol.act_bits}'} weights "
          f"({eng.compression:.2f}x compression), "
          f"{'f32' if args.no_quant_kv else 'int8'} KV, continuous scheduling")

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


if __name__ == "__main__":
    main()
