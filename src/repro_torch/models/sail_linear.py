"""SailLinear: quantized-weight matmul dispatch (port of
``repro.models.sail_linear``).

Every weight matmul goes through ``mm(x, w)``: a plain tensor takes
``x @ w``; a ``QTensor`` takes the LUT-GEMV (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors; with ``abits`` set, the
integer-activation path).  The MoE expert einsums go through
``einsum_q``: as in the reference, a quantized expert stack is
dequantized and multiplied by ``torch.einsum`` (with ``abits``, on the
per-token integer codes, the scale applied to the output), outside any
kernel.  ``quantize_params`` converts a parameter tree to the serving
format; embeddings and 1-D parameters stay f32.

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
                                    _uniform_codebook, dequantize,
                                    nf_codebook, quantize,
                                    quantize_activations, words_per_group)
from repro_torch.models.common import promote
from repro_torch.tree import register_dataclass

__all__ = ["ActQuantWeight", "BitAllocation", "QTensor", "QuantPolicy",
           "StackedQTensor", "act_fake_quant", "dequantize_any", "einsum_q",
           "mm", "nf_codebook", "quantize_params", "quantized_shapes",
           "map_tensors", "flatten_with_paths"]


def act_fake_quant(x: torch.Tensor, abits: int) -> torch.Tensor:
    """Per-token activation quantize->dequantize at ``abits``: the error a
    SAIL matmul serving ``abits`` activations sees on its inputs (any
    leading shape; the last axis is the token's feature vector)."""
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


def mm(x: torch.Tensor, w: Any, plan_rows: Optional[int] = None,
       k_sharded: bool = False) -> torch.Tensor:
    """x [..., K] @ w [K, N] with QTensor dispatch (``plan_rows`` and
    ``k_sharded``: see ``kernels.lut_gemv.ops.lut_matmul``).  Only a
    ``QTensor`` (one matrix) takes the LUT-GEMV: a layer's expert stack is
    a ``StackedQTensor`` and goes through :func:`einsum_q`.  A plain
    product of two dtypes runs in the wider one, as the reference's ``x @
    w`` promotes (training's bf16 weights against f32 activations)."""
    x, w = _apply_act_quant(x, w)
    if isinstance(w, QTensor):
        from repro_torch.kernels.lut_gemv.ops import lut_matmul
        lead = x.shape[:-1]
        y = lut_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                       plan_rows, k_sharded)
        return y.reshape(*lead, w.n)
    x, w = promote(x, w)
    return x @ w


@dataclasses.dataclass(frozen=True)
class StackedQTensor:
    """QTensor stacked along leading axes: layers [L, ...], or a MoE
    layer stack's experts [L, E, ...]."""
    packed: torch.Tensor      # [*lead, (K//G)*wpg, N] int32 bit patterns
    scales: torch.Tensor      # [*lead, K//G, N]
    codebook: torch.Tensor    # [lead[0], 2**bits] (or [2**bits])
    bits: int
    group_size: int
    k: int
    abits: Optional[int] = None

    def __getitem__(self, i):
        """Slice ``i`` of the first leading axis: a ``QTensor`` when that
        leaves one matrix, else a ``StackedQTensor`` with a 1-D codebook (a
        layer's experts, as the reference's scan slices them)."""
        cb = self.codebook if self.codebook.ndim == 1 else self.codebook[i]
        packed, scales = self.packed[i], self.scales[i]
        cls = QTensor if packed.ndim == 2 else StackedQTensor
        return cls(packed=packed, scales=scales, codebook=cb,
                   bits=self.bits, group_size=self.group_size, k=self.k,
                   abits=self.abits)

    @property
    def n(self) -> int:
        return self.packed.shape[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (unquantized) weight shape."""
        return tuple(self.packed.shape[:-2]) + (self.k, self.n)


register_dataclass(StackedQTensor, ("packed", "scales", "codebook"))


# above this many weights a stack is dequantized one matrix at a time
_DEQUANT_CHUNK = 1 << 26


def dequantize_any(w) -> torch.Tensor:
    """Tensor | QTensor | StackedQTensor -> f32 tensor (the plain path)."""
    if isinstance(w, QTensor):
        return dequantize(w)
    if not isinstance(w, StackedQTensor):
        return w
    cb = w.codebook if w.codebook.ndim == 1 else w.codebook[0]
    lead = tuple(w.packed.shape[:-2])
    packed = w.packed.reshape((-1,) + tuple(w.packed.shape[-2:]))
    scales = w.scales.reshape((-1,) + tuple(w.scales.shape[-2:]))
    one = lambda p, s: QTensor(packed=p, scales=s, codebook=cb, bits=w.bits,
                               group_size=w.group_size, k=w.k)
    if packed.shape[0] * w.k * w.n > _DEQUANT_CHUNK:
        out = torch.stack([dequantize(one(p, s))
                           for p, s in zip(packed, scales)])
    else:
        # the matrices side by side along N: one unpack for the stack
        e = packed.shape[0]
        wide = dequantize(one(packed.permute(1, 0, 2).reshape(-1, e * w.n),
                              scales.permute(1, 0, 2).reshape(-1, e * w.n)))
        out = wide.reshape(w.k, e, w.n).permute(1, 0, 2)
    return out.reshape(lead + (w.k, w.n))


def _einsum_scale_to_out(spec: str, xs: torch.Tensor
                         ) -> Optional[torch.Tensor]:
    """Per-token activation scales ``xs`` [..., 1] broadcast to the einsum
    output, where x's last subscript is the contracted one and every other
    x subscript is kept in the output (every MoE expert einsum); else
    None (the caller folds the scale into the input)."""
    lhs, out = spec.split("->")
    x_sub = lhs.split(",")[0]
    keep = x_sub[:-1]
    if x_sub[-1] in out or any(c not in out for c in keep):
        return None
    xs_t = xs[..., 0].permute([keep.index(c) for c in out if c in keep])
    it = iter(xs_t.shape)
    return xs_t.reshape([next(it) if c in keep else 1 for c in out])


def einsum_q(spec: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``torch.einsum(spec, x, w)`` where ``w`` may be quantized (the MoE
    expert einsums): the stack is dequantized on every call, as the
    reference does.  With ``abits`` the integer path runs: per-token
    activation codes enter the einsum and their scale multiplies the
    output."""
    x, w = _apply_act_quant(x, w)
    if not isinstance(w, (QTensor, StackedQTensor)):
        return torch.einsum(spec, x, w)
    wd = dequantize_any(w).to(x.dtype)
    if w.abits is not None and x.is_floating_point():
        xq, xs = quantize_activations(x, w.abits)
        xs_out = _einsum_scale_to_out(spec, xs)
        if xs_out is not None:
            y = torch.einsum(spec, xq.to(torch.float32),
                             wd.to(torch.float32))
            return (y * xs_out).to(x.dtype)
        x = (xq.to(torch.float32) * xs).to(x.dtype)
    return torch.einsum(spec, x, wd)


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
    """Layer-stacked [L, K, N] weights and MoE experts [L, E, K, N]."""
    return (isinstance(w, torch.Tensor) and w.ndim >= 3
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
    """Quantize a stacked weight one matrix at a time (bounded scratch),
    over every leading dim; the codebook is tiled along the first one only,
    as the reference does, so a layer's slice carries a 1-D codebook."""
    cb = policy.codebook_for(bits)
    codebook = (_uniform_codebook(bits, device=w.device) if cb is None
                else cb.to(device=w.device, dtype=torch.float32))
    lead = tuple(w.shape[:-2])
    packed, scales = [], []
    for mat in w.reshape((-1,) + tuple(w.shape[-2:])):
        qt = quantize(mat, bits, policy.group_size, codebook)
        packed.append(qt.packed)
        scales.append(qt.scales)
    packed, scales = torch.stack(packed), torch.stack(scales)
    return StackedQTensor(
        packed=packed.reshape(lead + tuple(packed.shape[1:])),
        scales=scales.reshape(lead + tuple(scales.shape[1:])),
        codebook=codebook[None].repeat(lead[0], 1), bits=bits,
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


def _abstract_quantized(w: torch.Tensor, bits: int, policy: QuantPolicy,
                        abits: Optional[int], stacked: bool):
    """The ``QTensor`` (``StackedQTensor``) that quantizing ``w`` would
    give, its tensors empty on the meta device: the shapes and dtypes of
    ``quantize`` / ``_quantize_stacked``."""
    *lead, k, n = w.shape
    groups = k // policy.group_size
    cb = policy.codebook_for(bits)
    levels = (1 << bits) if cb is None else cb.shape[-1]
    meta = lambda shape, dt=torch.float32: torch.empty(
        tuple(shape), dtype=dt, device="meta")
    fields = dict(bits=bits, group_size=policy.group_size, k=k, abits=abits)
    packed = meta(lead + [groups * words_per_group(bits, policy.group_size),
                          n], torch.int32)
    scales = meta(lead + [groups, n])
    if not stacked:
        return QTensor(packed=packed, scales=scales, codebook=meta([levels]),
                       **fields)
    return StackedQTensor(packed=packed, scales=scales,
                          codebook=meta([lead[0], levels]), **fields)


def _quantize_tree(params, policy: QuantPolicy, offset: int = 0,
                   abstract: bool = False):
    """Quantize one tree whose resolved bits are uniform per leaf.

    ``offset`` is the absolute layer index of stacked leaves' first slice
    (nonzero when quantizing a blocks segment); ``abstract``: build each
    quantized leaf's shapes only (``_abstract_quantized``).  Returns (tree,
    bytes_before, bytes_after)."""
    sizes = [0, 0]

    def leaf(pstr, w):
        sizes[0] += w.numel() * w.element_size()
        if _should_quantize(pstr, w, policy):
            b = _scalar_bits(policy.bits_for(pstr), pstr, 0, None)
            ab = _scalar_bits(policy.abits_for(pstr), pstr, 0, None,
                              check=_check_abits)
            if abstract:
                qt = _abstract_quantized(w, b, policy, ab, stacked=False)
            else:
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
            st = (_abstract_quantized(w, b, policy, ab, stacked=True)
                  if abstract else _quantize_stacked(w, b, policy, abits=ab))
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
    return _quantize_params(params, policy, abstract=False)


def quantized_shapes(params, policy: QuantPolicy = QuantPolicy()):
    """The tree ``quantize_params(params, policy)[0]`` would give, by the
    same rules, with every tensor empty on the meta device (the
    reference's ``jax.eval_shape`` of it): ``params`` may be real or meta
    tensors."""
    meta = _walk(params, lambda _, w: torch.empty(
        tuple(w.shape), dtype=w.dtype, device="meta"))
    return _quantize_params(meta, policy, abstract=True)[0]


def _quantize_params(params, policy: QuantPolicy, abstract: bool):
    bounds = _segment_bounds(params, policy)
    if bounds is None:
        return _quantize_tree(params, policy, abstract=abstract)
    rest = {k: v for k, v in params.items() if k != "blocks"}
    out, before, after = _quantize_tree(rest, policy, abstract=abstract)
    segments = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sub = _walk(params["blocks"], lambda _, x: x[a:b])
        qseg, sb, sa = _quantize_tree({"blocks": sub}, policy, offset=a,
                                      abstract=abstract)
        segments.append(qseg["blocks"])
        before += sb
        after += sa
    out = dict(out)
    out["blocks"] = segments
    return out, before, after
