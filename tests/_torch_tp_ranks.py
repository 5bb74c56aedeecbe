"""The rank side of ``tests/test_torch_tp.py``: two gloo ranks on the CPU
(``repro_torch.launch.mesh.run_ranks``) run every multi-process case of
that file once and each writes its results to ``<out>/rank<r>.pkl``.

    python tests/_torch_tp_ranks.py <out dir> <params.pkl>

``params.pkl`` holds the reference's smoke weights as a numpy tree.  The
file imports only the port: the test process holds the results against
the JAX reference.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np

ARCH = "tinymistral_248m"
PROMPTS = [[3, 5, 7, 2, 9], [4, 4, 1], [8, 2, 6, 1, 1, 5], [7]]
# the reference's engine settings (tests/test_tp.py)
ENGINE = dict(batch_size=4, cache_len=64, quantize=True, ql=4, group_size=32,
              min_size=1024, quant_kv=True)
WIRE8 = dict(batch_size=2, cache_len=64, quantize=True, ql=4, group_size=32,
             min_size=1024, quant_kv=True)
WIRE8_PROMPT = [3, 1, 4, 1, 5]
B, K, N, G = 4, 128, 64, 32


def _serve(eng, prompts, max_new):
    for p in prompts:
        eng.submit(list(p), max_new)
    eng.run()
    return [eng.completions[u].tokens for u in sorted(eng.completions)]


def _integer_qtensor(torch, rng, wb, ab):
    """An integer codebook and unit scales: every product and partial sum
    is an exact f32 integer, so any split of the reduction agrees to the
    bit (the reference's test_tp.py data)."""
    from repro_torch.core.quant import QTensor, pack_grouped
    if wb == 1:
        book = torch.tensor([-1.0, 1.0])
    else:
        book = torch.arange(1 << wb, dtype=torch.float32) - float(1 << (wb - 1))
    codes = torch.from_numpy(rng.integers(0, 1 << wb, size=(K, N)))
    return QTensor(packed=pack_grouped(codes, wb, G),
                   scales=torch.ones((K // G, N)), codebook=book, bits=wb,
                   group_size=G, k=K, abits=ab)


def lut_cases(torch, rank, tp):
    """Column- and row-parallel LUT-GEMV (plain versions) against the one
    unsharded call, wbits x abits, on integer-valued data whose activation
    scale is exactly 1 (the row-parallel int path needs the group's
    absmax for that: its K-slice alone may not hold a row's max)."""
    import dataclasses
    from repro_torch.core.quant import quantize_activations
    from repro_torch.dist.sharding import tp_all_reduce, tp_context
    from repro_torch.kernels.lut_gemv.ops import lut_matmul
    from repro_torch.serving.distributed import slice_params
    rng = np.random.default_rng(0)
    out = {}
    for wb in (1, 2, 3, 4, 8):
        for ab in (4, 6, 8):
            qt = _integer_qtensor(torch, rng, wb, ab)
            qmax = (1 << (ab - 1)) - 1
            x = rng.integers(-qmax, qmax + 1, size=(B, K)).astype(np.float32)
            x[:, 0] = qmax
            x = torch.from_numpy(x)
            f32 = dataclasses.replace(qt, abits=None)
            single = lut_matmul(x, f32)
            single_int = lut_matmul(x, qt)
            col = lut_matmul(x, slice_params({"wq": f32}, rank, tp)["wq"])
            cols = slice(rank * N // tp, (rank + 1) * N // tp)
            row_qt = slice_params({"w_down": qt}, rank, tp)["w_down"]
            x_local = x[:, rank * K // tp:(rank + 1) * K // tp].contiguous()
            with tp_context(None, 32):
                row = tp_all_reduce(lut_matmul(x_local, row_qt,
                                               k_sharded=True))
            out[f"w{wb}a{ab}"] = {
                "scale_one": bool((quantize_activations(x, ab)[1] == 1).all()),
                "col": torch.equal(col, single[:, cols]),
                "row": torch.equal(row, single_int),
                "row_k": row_qt.k,
                "int_matches_float": torch.equal(single, single_int)}
    return out


def rank_cases(rank, out_dir, params_path):
    import torch
    import torch.distributed as dist

    import repro_torch.configs as TC
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import tp_all_reduce, tp_context
    from repro_torch.serving.distributed import TPServing
    from repro_torch.serving.engine import Engine, EngineConfig

    tp = dist.get_world_size()
    res = {"rank": rank}
    # the all-reduce: each rank holds one part of seeded normal data
    parts = np.random.default_rng(7).standard_normal((tp, 8, 64)).astype(
        np.float32)
    mine = torch.from_numpy(parts[rank].copy())
    with tp_context(None, 32):
        res["wire32"] = tp_all_reduce(mine.clone()).numpy()
    with tp_context(None, 8):
        res["wire8"] = [tp_all_reduce(mine.clone()).numpy()
                        for _ in range(2)]
    res["lut"] = lut_cases(torch, rank, tp)

    cfg = TC.get_smoke(ARCH)
    with open(params_path, "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cpu")
    for pool, extra in (("ring", {}), ("paged", {"kv_block_size": 8})):
        for shards in (1, tp):
            eng = Engine(params, cfg, EngineConfig(**ENGINE, **extra,
                                                   tp=shards, wire=32),
                         device="cpu")
            res[f"{pool}_tp{shards}"] = _serve(eng, PROMPTS, 6)
            if pool == "ring":
                res[f"stats_tp{shards}"] = eng.stats()["tp"]
                if shards > 1:
                    res["cache_shape"] = tuple(eng.cache["layers"]["k"].shape)
    # the controller acts on rank 0's step times, broadcast: every rank
    # checks, sheds and caps alike (an SLO no occupancy meets)
    eng = Engine(params, cfg, EngineConfig(**ENGINE, tp=tp, plan="uniform:4",
                                           slo=1e8,
                                           controller=dict(check_every=1)),
                 device="cpu")
    res["controlled"] = _serve(eng, PROMPTS, 6)
    res["controller"] = eng.stats()["controller"]
    for plan, knob in (("uniform:4a8,tp=2,wire=8", 1), ("uniform:4a8", 1),
                       ("uniform:4,tp=2,wire=8", 1),
                       ("uniform:4a8,tp=2,wire=32", 1)):
        eng = Engine(params, cfg, EngineConfig(**WIRE8, plan=plan, tp=knob),
                     device="cpu")
        res[plan] = _serve(eng, [WIRE8_PROMPT], 5)
        res[plan + " stats"] = eng.stats()["tp"]
    try:
        Engine(params, cfg, EngineConfig(**ENGINE, tp=tp,
                                         plan="uniform:4,draft=q2:k4"),
               device="cpu")
        res["draft"] = None
    except ValueError as err:
        res["draft"] = str(err)
    # a group of the wrong size: every rank makes the group, rank 0 uses it
    alone = dist.new_group([0])
    if rank == 0:
        try:
            TPServing(cfg, tp, group=alone)
            res["mismatch"] = None
        except ValueError as err:
            res["mismatch"] = str(err)
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def main(out_dir: str, params_path: str) -> None:
    import torch

    from repro_torch.launch.mesh import run_ranks
    torch.set_num_threads(1)
    run_ranks(rank_cases, 2, args=(out_dir, params_path),
              rendezvous_dir=out_dir)


if __name__ == "__main__":
    main(*sys.argv[1:])
