"""Quickstart: SAIL's mechanisms in five minutes, on the H100 port.

  1. bit-exact batched LUT-GEMV (the paper's Fig. 2 algorithm);
  2. the CUDA LUT-dequant matmul kernel vs its plain PyTorch version;
  3. Algorithm-1 in-memory int->f32 conversion, bit-equal to the hardware
     conversion (the CUDA kernel on the card);
  4. the pattern-aware LUT's repeat rate on quantized activations;
  5. the calibrated SAIL machine model reproducing headline paper numbers.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` and raises when torch sees no CUDA
device; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import lut_gemv, pattern, prng, quant, typeconv
from repro_torch.device import resolve_device
from repro_torch.kernels.lut_gemv import ops as lut_ops, ref as lut_ref
from repro_torch.kernels.typeconv import ops as tc_ops

RULE = "=" * 70


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the kernels' plain versions")
    return ap.parse_args(argv)


def draws():
    """The normal draws of sections 2 and 4 (the reference's
    ``jax.random.normal``), from seeded CPU generators: the same numbers
    on every device."""
    normal = lambda seed, shape: torch.randn(
        shape, generator=torch.Generator().manual_seed(seed))
    return {"w": normal(0, (512, 256)), "x": normal(2, (8, 512)),
            "acts": normal(3, (8, 256))}


def section_lut_gemv(device):
    """Section 1: the integer LUT-GEMV at NBW 1-4 against a plain integer
    matmul, on the reference's ``PRNGKey(0)`` / ``PRNGKey(1)`` draws."""
    xq = torch.from_numpy(prng.randint(0, (8, 256), -127, 128)).to(device)
    wq = torch.from_numpy(prng.randint(1, (256, 128), -8, 8)).to(device)
    lines = ["1. Batched LUT-GEMV (paper Fig. 2) — exact integer semantics"]
    for nbw in (1, 2, 3, 4):
        out = lut_gemv.lut_gemv(xq, wq, nbw=nbw, abits=8)
        ref = lut_gemv.reference_int_gemv(xq, wq)
        counts = lut_gemv.lut_gemv_op_counts(8, 256, 128, nbw)
        lines.append(f"  NBW={nbw}: exact={bool((out == ref).all())}  "
                     f"LUT entries={counts['lut_entries']:3d}  "
                     f"lookups={counts['lookups']}")
    return lines


def section_kernel(w, x, device):
    """Section 2: ``lut_matmul`` (the CUDA kernel on the card) against
    ``lut_matmul_ref`` at Q2, Q4 and Q8, group 128.  Returns the printed
    lines and, per width, the kernel-vs-plain error."""
    w, x = w.to(device), x.to(device)
    title = ("CUDA kernel (sm_90a) vs its plain PyTorch version"
             if device.type == "cuda" else
             "the kernel's plain PyTorch version (no kernel on the CPU)")
    lines, errs = [f"2. LUT-dequant matmul: {title}"], {}
    for bits in (2, 4, 8):
        qt = quant.quantize(w, bits, group_size=128)
        y_k = lut_ops.lut_matmul(x, qt)
        y_r = lut_ref.lut_matmul_ref(x, qt)
        errs[bits] = float((y_k - y_r).abs().max())
        exact = x @ w
        rel = float((y_r - exact).abs().max() / exact.abs().max())
        lines.append(f"  Q{bits}: kernel-vs-oracle max err {errs[bits]:.1e}; "
                     f"quantization rel err {rel:.3f}; "
                     f"weight bytes {qt.nbytes():,} vs {w.numel() * 4:,}")
    return lines, errs


def section_typeconv(a, device):
    """Section 3: Algorithm 1 on int32 ``a`` at n 25 (the CUDA kernel on
    the card), against the native conversion."""
    r = tc_ops.int_to_f32(torch.from_numpy(a).to(device), n=25)
    exact = bool((r.cpu().numpy() == a.astype(np.float32)).all())
    return ["3. Algorithm 1: in-memory int->f32 (logic ops only)",
            f"  bit-exact vs astype(float32): {exact}  "
            f"(cycles per 512-lane array batch: "
            f"{typeconv.sram_cycles(25):.0f})"]


def section_pattern(acts, device):
    """Section 4: the PRT hit rate of 8-bit activation codes at NBW 3."""
    aq, _ = quant.quantize_activations(acts.to(device), 8)
    st = pattern.measure_repeat_rate(aq.cpu(), nbw=3)
    return ["4. Pattern-aware LUT (PRT): measured repeat rate on activations",
            f"  PRT hit rate {st.hit_rate:.1%} (paper reports ~17% repeats "
            f"-> {pattern.PAPER_CYCLE_REDUCTION:.1%} cycle reduction)"]


def section_machine_model():
    """Section 5: the SAIL and ARM machine models against Table II, and
    the Fig. 12 staircase (no device work)."""
    lines = ["5. SAIL machine model vs paper (Table II, 16 threads, batch 8)",
             f"  {'model':12s} {'ql':3s} {'SAIL model':>11s} {'paper':>8s} "
             f"{'ARM model':>10s} {'paper':>8s}"]
    for (mn, ql) in [("7b", 2), ("7b", 4), ("7b", 8), ("13b", 2)]:
        m = cm.LLAMA2_7B if mn == "7b" else cm.LLAMA2_13B
        srow = cm.PAPER_TABLE_II[(mn, ql)]
        lines.append(f"  llama2-{mn:5s} Q{ql}  "
                     f"{cm.sail_tokens_per_second(m, ql, 16, 8):11.2f} "
                     f"{srow['sail'][4]:8.2f} "
                     f"{cm.arm_tokens_per_second(m, ql, 16, 8):10.2f} "
                     f"{srow['arm'][4]:8.2f}")
    bd = cm.gemv_breakdown()
    base = bd["baseline"]
    lines.append(f"  Fig.12 staircase (speedup over CPU baseline): "
                 f"NC {base/bd['neural_cache']:.2f}x, "
                 f"LUT {base/bd['lut']:.2f}x, "
                 f"LUT+TC {base/bd['lut_tc']:.2f}x (paper: 3.81x)")
    return lines


def main(argv=None):
    """Prints the five sections; returns section 2's kernel-vs-plain
    errors by width."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    d = draws()
    a = np.random.randint(-(1 << 24) + 1, 1 << 24,
                          size=10000).astype(np.int32)
    show = lambda lines: print("\n".join([RULE] + lines))
    show(section_lut_gemv(device))
    lines, errs = section_kernel(d["w"], d["x"], device)
    show(lines)
    show(section_typeconv(a, device))
    show(section_pattern(d["acts"], device))
    show(section_machine_model())
    return errs


if __name__ == "__main__":
    main()
