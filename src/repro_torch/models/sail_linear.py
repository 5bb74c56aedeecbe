"""SailLinear: quantized-weight matmul dispatch (port of
``repro.models.sail_linear``).

Every weight matmul goes through ``mm(x, w)``: a plain tensor takes
``x @ w``; a ``QTensor`` takes the LUT-GEMV (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors; with ``abits`` set, the
integer-activation path).  ``quantize_params`` converts a parameter tree
to the serving format; embeddings and 1-D parameters stay f32.

Mixed precision: ``QuantPolicy`` resolves bits per parameter path —
explicit ``rules`` (regex, first match) over an ``allocation``
(:class:`BitAllocation`, a scalar or a per-layer tuple per path) over the
uniform ``bits`` — and activation bits the same way (``act_rules`` /
``allocation.act_per_path`` / ``act_bits``).  A per-layer tuple on a
``blocks`` leaf cuts the layer stack into segments, each maximal in the
joint (wbits, abits) assignment: ``params["blocks"]`` becomes a list of
stacked trees that ``models.lm`` walks back to back.  Each quantized
leaf carries its own ``bits`` and ``abits``, so ``mm`` needs nothing
else: every call launches the LUT-GEMV instance of its leaf's pair.

Fake-quant survives only as the Planner's calibration probe: an
``ActQuantWeight`` wraps a plain weight whose matmul inputs ``mm``
quantizes per token (``act_fake_quant``) behind a per-layer gate, so one
forward probes one layer of a stack.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, \
    Union

import torch

from repro_torch.core.quant import (SUPPORTED_ABITS, SUPPORTED_BITS, QTensor,
                                    _uniform_codebook, nf_codebook, quantize)

__all__ = ["ActQuantWeight", "BitAllocation", "QTensor", "QuantPolicy",
           "StackedQTensor", "act_fake_quant", "mm", "nf_codebook",
           "quantize_params", "map_tensors", "flatten_with_paths"]


def act_fake_quant(x: torch.Tensor, abits: int) -> torch.Tensor:
    """Per-token activation quantize->dequantize at ``abits``: the error a
    SAIL matmul serving ``abits`` activations sees on its inputs (any
    leading shape; the last axis is the token's feature vector)."""
    from repro_torch.core.quant import quantize_activations
    xq, xs = quantize_activations(x, abits)
    return (xq.to(torch.float32) * xs).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ActQuantWeight:
    """Probe wrapper: a plain weight whose *matmul inputs* are quantized.

    ``activation_sensitivity`` uses it to measure the error of quantizing
    one unit's activations at ``abits`` while everything else stays at the
    baseline.  ``gate`` (a scalar tensor, or ``[L]`` for a stacked weight)
    turns the fake-quant on per layer; indexing a stacked probe slices the
    weight and the gate together, as the reference's scan does."""
    w: torch.Tensor
    gate: torch.Tensor
    abits: int

    def __getitem__(self, i) -> "ActQuantWeight":
        return ActQuantWeight(w=self.w[i], gate=self.gate[i],
                              abits=self.abits)


def _apply_act_quant(x: torch.Tensor, w: Any):
    """Unwrap an ``ActQuantWeight`` probe: the gate-blended fake-quant
    ``x + gate * (fq - x)`` (the reference's arithmetic, so gate 0 leaves x
    bit-equal).  Returns the (possibly probed) activations and the plain
    weight."""
    if isinstance(w, ActQuantWeight):
        fq = act_fake_quant(x, w.abits)
        x = x + w.gate.to(x.dtype) * (fq - x)
        w = w.w
    return x, w


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w [K, N] with QTensor dispatch."""
    x, w = _apply_act_quant(x, w)
    if isinstance(w, QTensor):
        from repro_torch.kernels.lut_gemv.ops import lut_matmul
        lead = x.shape[:-1]
        y = lut_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
        return y.reshape(*lead, w.n)
    return x @ w


@dataclasses.dataclass(frozen=True)
class StackedQTensor:
    """QTensor stacked along a leading layer axis."""
    packed: torch.Tensor      # [L, (K//G)*wpg, N] int32 bit patterns
    scales: torch.Tensor      # [L, K//G, N]
    codebook: torch.Tensor    # [L, 2**bits] (or [2**bits])
    bits: int
    group_size: int
    k: int
    abits: Optional[int] = None

    def __getitem__(self, i) -> QTensor:
        cb = self.codebook if self.codebook.ndim == 1 else self.codebook[i]
        return QTensor(packed=self.packed[i], scales=self.scales[i],
                       codebook=cb, bits=self.bits,
                       group_size=self.group_size, k=self.k,
                       abits=self.abits)

    @property
    def n(self) -> int:
        return self.packed.shape[-1]


# Bits for one path: a scalar, or one entry per stacked layer.
BitsSpec = Union[int, Tuple[int, ...]]


def _bits_spec_to_json(per_path: Mapping[str, BitsSpec]) -> Dict[str, Any]:
    return {p: (list(map(int, b)) if isinstance(b, (tuple, list))
                else int(b))
            for p, b in per_path.items()}


def _bits_spec_from_json(spec: Mapping[str, Any]) -> Dict[str, BitsSpec]:
    return {p: (tuple(int(x) for x in b) if isinstance(b, (list, tuple))
                else int(b))
            for p, b in spec.items()}


@dataclasses.dataclass(frozen=True)
class BitAllocation:
    """Per-path bit-width assignment (a solved plan's allocation).

    ``per_path`` maps keystr paths (``['blocks']['mlp']['w_down']``) to a
    scalar weight bits or, for stacked ``blocks`` leaves, a per-layer
    tuple; ``act_per_path`` carries the activation precision the same way
    (absent paths keep the policy's ``act_bits`` fallback).  JSON-safe via
    ``to_spec``/``from_spec``; the flat weight-only spec format parses.
    """
    per_path: Mapping[str, BitsSpec]
    act_per_path: Mapping[str, BitsSpec] = dataclasses.field(
        default_factory=dict)

    def lookup(self, path: str) -> Optional[BitsSpec]:
        return self.per_path.get(path)

    def lookup_act(self, path: str) -> Optional[BitsSpec]:
        return self.act_per_path.get(path)

    def to_spec(self) -> Dict[str, Any]:
        if not self.act_per_path:
            return _bits_spec_to_json(self.per_path)   # flat format
        return {"weights": _bits_spec_to_json(self.per_path),
                "activations": _bits_spec_to_json(self.act_per_path)}

    @staticmethod
    def from_spec(spec: Mapping[str, Any]) -> "BitAllocation":
        if "weights" in spec and "activations" in spec:
            return BitAllocation(
                per_path=_bits_spec_from_json(spec["weights"]),
                act_per_path=_bits_spec_from_json(spec["activations"]))
        return BitAllocation(per_path=_bits_spec_from_json(spec))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int = 4                  # uniform fallback precision
    group_size: int = 128
    min_size: int = 65536          # don't quantize small tensors
    skip_embed: bool = True        # gathers can't stream through LUT-GEMV
    # None | tensor (single-precision policies only) | callable bits ->
    # tensor (e.g. ``nf_codebook``: mixed policies need one per bits)
    codebook: Optional[Any] = None
    rules: Tuple[Tuple[str, int], ...] = ()     # (regex, bits), first match
    allocation: Optional[BitAllocation] = None  # a solved plan's allocation
    # activation precision: uniform fallback (None = f32 activations) and
    # per-path overrides, resolved like the weight side
    act_bits: Optional[int] = None
    act_rules: Tuple[Tuple[str, int], ...] = ()

    def bits_for(self, path: str) -> BitsSpec:
        """The bit width of one parameter path: rules > allocation >
        uniform fallback."""
        for pat, b in self.rules:
            if re.search(pat, path):
                return _check_bits(int(b))
        if self.allocation is not None:
            got = self.allocation.lookup(path)
            if got is not None:
                return got
        return self.bits

    def abits_for(self, path: str) -> Optional[BitsSpec]:
        """The activation precision of one parameter path (``None`` = f32
        activations for this matmul): act_rules > allocation > act_bits."""
        for pat, b in self.act_rules:
            if re.search(pat, path):
                return _check_abits(int(b))
        if self.allocation is not None:
            got = self.allocation.lookup_act(path)
            if got is not None:
                return got
        return self.act_bits

    def codebook_for(self, bits: int) -> Optional[torch.Tensor]:
        """The codebook of a leaf at ``bits`` (None: the uniform one)."""
        if self.codebook is None:
            return None
        if callable(self.codebook):
            return self.codebook(bits)
        if self.codebook.shape[-1] != (1 << bits):
            raise ValueError(
                f"explicit codebook has {self.codebook.shape[-1]} entries "
                f"but a leaf resolved to {bits} bits (2**{bits} needed) — "
                "mixed policies need a callable codebook factory")
        return self.codebook

    def is_mixed(self) -> bool:
        return (bool(self.rules) or bool(self.act_rules)
                or self.allocation is not None)

    def to_spec(self) -> Dict[str, Any]:
        """JSON-safe description (the reference stores it in checkpoint
        manifests)."""
        cb = self.codebook
        if cb is not None:
            if not callable(cb):
                raise ValueError(
                    "explicit codebook tensors are not spec-serializable; "
                    "use a named factory (nf_codebook) or None")
            if getattr(cb, "__name__", "") != "nf_codebook":
                raise ValueError(f"unknown codebook factory {cb!r}")
            cb = "nf"
        return {"bits": int(self.bits), "group_size": int(self.group_size),
                "min_size": int(self.min_size),
                "skip_embed": bool(self.skip_embed), "codebook": cb,
                "rules": [[p, int(b)] for p, b in self.rules],
                "allocation": (self.allocation.to_spec()
                               if self.allocation is not None else None),
                "act_bits": (int(self.act_bits)
                             if self.act_bits is not None else None),
                "act_rules": [[p, int(b)] for p, b in self.act_rules]}

    @staticmethod
    def from_spec(spec: Mapping[str, Any]) -> "QuantPolicy":
        cb = spec.get("codebook")
        if cb == "nf":
            cb = nf_codebook
        elif cb is not None:
            raise ValueError(f"unknown codebook spec {cb!r}")
        alloc = spec.get("allocation")
        act_bits = spec.get("act_bits")
        return QuantPolicy(
            bits=int(spec.get("bits", 4)),
            group_size=int(spec.get("group_size", 128)),
            min_size=int(spec.get("min_size", 65536)),
            skip_embed=bool(spec.get("skip_embed", True)),
            codebook=cb,
            rules=tuple((p, int(b)) for p, b in spec.get("rules", ())),
            allocation=(BitAllocation.from_spec(alloc)
                        if alloc else None),
            act_bits=int(act_bits) if act_bits is not None else None,
            act_rules=tuple((p, int(b))
                            for p, b in spec.get("act_rules", ())))


def _check_bits(b: int) -> int:
    if b not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {b}")
    return b


def _check_abits(b: Optional[int]) -> Optional[int]:
    if b is not None and b not in SUPPORTED_ABITS:
        raise ValueError(
            f"activation bits must be one of {SUPPORTED_ABITS} or None, "
            f"got {b}")
    return b


def _should_quantize(path: str, w, policy: QuantPolicy) -> bool:
    return (isinstance(w, torch.Tensor) and w.ndim == 2
            and w.numel() >= policy.min_size
            and not (policy.skip_embed and "embed" in path)
            and w.shape[0] % policy.group_size == 0)


def _should_quantize_stacked(path: str, w, policy: QuantPolicy) -> bool:
    """Layer-stacked [L, K, N] weights."""
    return (isinstance(w, torch.Tensor) and w.ndim == 3
            and "embed" not in path
            and w.shape[-2] % policy.group_size == 0
            and w.shape[-2] * w.shape[-1] >= policy.min_size)


def _scalar_bits(spec: BitsSpec, path: str, offset: int,
                 seg_len: Optional[int], check=_check_bits):
    """Resolve a BitsSpec to the single static bits of one leaf/segment."""
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        if seg_len is None:
            raise ValueError(
                f"per-layer bits on non-stacked leaf {path}: {spec}")
        window = set(spec[offset:offset + seg_len])
        if len(window) != 1:
            raise ValueError(
                f"heterogeneous bits {spec} for {path} require a top-level "
                "'blocks' stack (segmentation); got an unsplittable tree")
        return check(None if spec[offset] is None else int(spec[offset]))
    return check(int(spec))


def _quantize_stacked(w: torch.Tensor, bits: int, policy: QuantPolicy,
                      abits: Optional[int] = None) -> StackedQTensor:
    """Quantize a stacked weight one layer at a time (bounded scratch);
    the codebook is tiled along the layer axis as the reference does."""
    cb = policy.codebook_for(bits)
    codebook = (_uniform_codebook(bits, device=w.device) if cb is None
                else cb.to(device=w.device, dtype=torch.float32))
    packed, scales = [], []
    for layer in w:
        qt = quantize(layer, bits, policy.group_size, codebook)
        packed.append(qt.packed)
        scales.append(qt.scales)
    return StackedQTensor(
        packed=torch.stack(packed), scales=torch.stack(scales),
        codebook=codebook[None].repeat(w.shape[0], 1), bits=bits,
        group_size=policy.group_size, k=w.shape[-2], abits=abits)


def _walk(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """Map ``fn(path, leaf)`` over a dict/list tree; paths use the
    reference's ``keystr`` form (``['blocks']['attn']['wq']``)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in the order the reference's
    ``tree_flatten_with_path`` gives (dict keys sorted)."""
    if isinstance(tree, dict):
        tree = {k: tree[k] for k in sorted(tree)}
    out: List[Tuple[str, Any]] = []
    _walk(tree, lambda p, x: out.append((p, x)))
    return out


def map_tensors(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor of a tree, QTensor fields included
    (e.g. ``map_tensors(params, lambda t: t.to("cpu"))``)."""
    def leaf(_, x):
        if isinstance(x, (QTensor, StackedQTensor)):
            return dataclasses.replace(x, packed=fn(x.packed),
                                       scales=fn(x.scales),
                                       codebook=fn(x.codebook))
        return fn(x) if isinstance(x, torch.Tensor) else x
    return _walk(tree, leaf)


def _quantize_tree(params, policy: QuantPolicy, offset: int = 0):
    """Quantize one tree whose resolved bits are uniform per leaf.

    ``offset`` is the absolute layer index of stacked leaves' first slice
    (nonzero when quantizing a blocks segment).  Returns (tree,
    bytes_before, bytes_after)."""
    sizes = [0, 0]

    def leaf(pstr, w):
        sizes[0] += w.numel() * w.element_size()
        if _should_quantize(pstr, w, policy):
            b = _scalar_bits(policy.bits_for(pstr), pstr, 0, None)
            ab = _scalar_bits(policy.abits_for(pstr), pstr, 0, None,
                              check=_check_abits)
            qt = quantize(w, b, policy.group_size,
                          codebook=policy.codebook_for(b))
            qt = dataclasses.replace(qt, abits=ab)
            sizes[1] += qt.nbytes()
            return qt
        if _should_quantize_stacked(pstr, w, policy):
            b = _scalar_bits(policy.bits_for(pstr), pstr, offset,
                             w.shape[0])
            ab = _scalar_bits(policy.abits_for(pstr), pstr, offset,
                              w.shape[0], check=_check_abits)
            st = _quantize_stacked(w, b, policy, abits=ab)
            sizes[1] += 4 * (st.packed.numel() + st.scales.numel())
            return st
        sizes[1] += w.numel() * w.element_size()
        return w

    out = _walk(params, leaf)
    return out, sizes[0], sizes[1]


def _segment_bounds(params, policy: QuantPolicy) -> Optional[List[int]]:
    """Layer cut points implied by per-layer bit specs on blocks leaves.

    Both the weight and the activation allocation segment the stack: a
    segment is maximal in the joint (wbits, abits) assignment.  Returns
    None when no segmentation is needed (no per-layer spec, or all
    per-layer specs constant)."""
    if not (isinstance(params, dict) and "blocks" in params
            and not isinstance(params["blocks"], (list, tuple))):
        return None
    n_layers = None
    per_layer: List[Tuple[int, ...]] = []
    for pstr, w in flatten_with_paths({"blocks": params["blocks"]}):
        if not (_should_quantize(pstr, w, policy)
                or _should_quantize_stacked(pstr, w, policy)):
            continue
        for spec in (policy.bits_for(pstr), policy.abits_for(pstr)):
            if not isinstance(spec, (tuple, list)):
                continue
            if w.ndim < 3:
                raise ValueError(
                    f"per-layer bits on non-stacked leaf {pstr}")
            if len(spec) != w.shape[0]:
                raise ValueError(
                    f"allocation for {pstr} has {len(spec)} entries, stack "
                    f"has {w.shape[0]} layers")
            if n_layers is None:
                n_layers = w.shape[0]
            per_layer.append(tuple(spec))
    if not per_layer:
        return None
    cuts = [0]
    for layer in range(1, n_layers):
        if any(s[layer] != s[layer - 1] for s in per_layer):
            cuts.append(layer)
    cuts.append(n_layers)
    return cuts if len(cuts) > 2 else None


def quantize_params(params, policy: QuantPolicy = QuantPolicy()):
    """Convert a parameter tree to the SAIL serving format.

    Bits are resolved per path (``policy.bits_for`` / ``abits_for``); a
    per-layer tuple on a ``blocks`` leaf splits the stack into segments
    and the returned tree carries ``params["blocks"]`` as a list of
    stacked trees (layers ``[a, b)`` each, sliced from the raw stack).
    Returns (quantized tree, bytes_before, bytes_after)."""
    bounds = _segment_bounds(params, policy)
    if bounds is None:
        return _quantize_tree(params, policy)
    rest = {k: v for k, v in params.items() if k != "blocks"}
    out, before, after = _quantize_tree(rest, policy)
    segments = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sub = _walk(params["blocks"], lambda _, x: x[a:b])
        qseg, sb, sa = _quantize_tree({"blocks": sub}, policy, offset=a)
        segments.append(qseg["blocks"])
        before += sb
        after += sa
    out = dict(out)
    out["blocks"] = segments
    return out, before, after
