"""PlanSpec: the typed source of truth for precision planning (port of
``repro.planning.spec``, copied: the same grammar, JSON and ``spec_hash``).

One frozen, JSON-serializable object describes a serving deployment's
precision configuration:

  * the *request*: mode (uniform / rules / auto), the uniform ``ql`` and
    activation precision, regex rules, the auto-mode budget anchor
    (match-uniform bits, bits-per-weight, or an SLO target tokens/s),
    cost-model knobs (NBW, PRT mode, scan-segment cap), and the KV flag;
  * the *solution*: per-unit weight/activation bit assignments filled in
    by a Planner — a solved plan rebuilds its ``QuantPolicy`` (and
    therefore the exact mixed parameter tree) without re-running
    calibration (``planning.planner.Planner`` solves an ``auto`` plan).

The string grammar is a thin :meth:`PlanSpec.parse` /
:meth:`PlanSpec.format` layer over it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

PLAN_VERSION = 1

_MODES = ("uniform", "rules", "auto")
_PRT_MODES = ("off", "paper", "measured")


def _bits_to_json(per_unit: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        p: (list(map(int, b)) if isinstance(b, (tuple, list)) else int(b))
        for p, b in per_unit.items()
    }


def _bits_from_json(spec: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        p: (tuple(int(x) for x in b) if isinstance(b, (list, tuple)) else int(b))
        for p, b in spec.items()
    }


def _parse_bits_token(tok: str) -> Tuple[Optional[int], Optional[int]]:
    """``"4"`` -> (4, None); ``"4a6"`` -> (4, 6); ``"a8"`` -> (None, 8)
    (an activation-only rule token)."""
    m = re.fullmatch(r"(\d+)?(?:a(\d+))?", tok.strip())
    if not m or (m.group(1) is None and m.group(2) is None):
        raise ValueError(f"bad bits token {tok!r} (expected <b>, <b>a<ab>, or a<ab>)")
    return (
        int(m.group(1)) if m.group(1) else None,
        int(m.group(2)) if m.group(2) else None,
    )


def _fmt_bits(bits: Optional[int], abits: Optional[int]) -> str:
    head = "" if bits is None else str(bits)
    return f"{head}a{abits}" if abits is not None else head


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """The draft half of a self-speculative plan.

    Self-speculative decoding serves ONE weight tree under two plans:
    ``k`` tokens are proposed per round with this aggressive low-bit
    precision and verified in one batched multi-token forward under the
    plan's own (conservative) precision.  ``acceptance`` records the
    measured greedy acceptance rate from the solver's calibration batch
    (None until a Planner measured it) — it feeds the expected
    accepted-tokens/s objective, not the serving datapath.

    Grammar token: ``q<b>[a<ab>]:k<k>`` (e.g. ``q2a8:k4``).
    """

    weight_bits: int = 4
    act_bits: Optional[int] = None
    k: int = 4
    acceptance: Optional[float] = None

    def __post_init__(self):
        from repro_torch.core.quant import SUPPORTED_ABITS, SUPPORTED_BITS

        if self.weight_bits not in SUPPORTED_BITS:
            raise ValueError(
                f"draft weight_bits must be one of {SUPPORTED_BITS}, "
                f"got {self.weight_bits}"
            )
        if self.act_bits is not None and self.act_bits not in SUPPORTED_ABITS:
            raise ValueError(
                f"draft act_bits must be one of {SUPPORTED_ABITS} or None, got {self.act_bits}"
            )
        if self.k < 1:
            raise ValueError(f"draft k must be >= 1, got {self.k}")
        if self.acceptance is not None and not 0.0 <= self.acceptance <= 1.0:
            raise ValueError(f"draft acceptance must be in [0, 1], got {self.acceptance}")

    def format(self) -> str:
        return f"q{_fmt_bits(self.weight_bits, self.act_bits)}:k{self.k}"

    @staticmethod
    def parse(tok: str) -> "DraftSpec":
        m = re.fullmatch(r"q([^:]+):k(\d+)", tok.strip())
        if not m:
            raise ValueError(f"bad draft token {tok!r} (expected q<b>[a<ab>]:k<k> or auto)")
        bits, abits = _parse_bits_token(m.group(1))
        if bits is None:
            raise ValueError(f"draft token {tok!r} must pin weight bits")
        return DraftSpec(weight_bits=bits, act_bits=abits, k=int(m.group(2)))

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "weight_bits": int(self.weight_bits),
            "act_bits": self.act_bits,
            "k": int(self.k),
        }
        if self.acceptance is not None:
            out["acceptance"] = float(self.acceptance)
        return out

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "DraftSpec":
        return DraftSpec(
            weight_bits=int(spec["weight_bits"]),
            act_bits=(int(spec["act_bits"]) if spec.get("act_bits") is not None else None),
            k=int(spec.get("k", 4)),
            acceptance=(
                float(spec["acceptance"]) if spec.get("acceptance") is not None else None
            ),
        )


def _coerce_draft(val) -> Optional[Union[str, "DraftSpec"]]:
    """None | "auto" | DraftSpec | grammar token | DraftSpec JSON dict."""
    if val is None or val == "auto" or isinstance(val, DraftSpec):
        return val
    if isinstance(val, str):
        return DraftSpec.parse(val)
    if isinstance(val, Mapping):
        return DraftSpec.from_json(val)
    raise ValueError(f"draft must be None, 'auto', a DraftSpec, a q<b>[a<ab>]:k<k> token, or a JSON dict; got {val!r}")


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One regex precision override: paths matching ``pattern`` serve at
    ``weight_bits`` (and ``act_bits`` activations when given).  A None
    ``weight_bits`` pins only the activation side (legacy independent
    ``act_rules`` entries); at least one side must be set."""

    pattern: str
    weight_bits: Optional[int]
    act_bits: Optional[int] = None

    def __post_init__(self):
        if self.weight_bits is None and self.act_bits is None:
            raise ValueError(f"rule {self.pattern!r} pins neither weights nor activations")

    def to_json(self) -> list:
        return [self.pattern, self.weight_bits, self.act_bits]

    @staticmethod
    def from_json(spec) -> "PlanRule":
        pat, wb = spec[0], spec[1]
        ab = spec[2] if len(spec) > 2 else None
        return PlanRule(
            pat,
            int(wb) if wb is not None else None,
            int(ab) if ab is not None else None,
        )


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One precision-serving plan (request + optional solved allocation).

    ``weight_bits`` is the uniform ``ql`` (modes uniform/rules) or the
    match-uniform budget anchor (mode auto); ``act_bits`` is the lutmm
    activation precision (``None`` = f32 activations).  ``target_tps``
    turns an auto solve into an SLO solve: the Planner derives the cycle
    AND byte budgets from the target decode tokens/s at ``slo_batch``
    instead of matching the uniform reference's projected cycles.
    ``weights_per_unit`` / ``acts_per_unit`` carry the solved per-path
    (per-layer for scan stacks) assignment; a solved plan is the source
    of truth — checkpoints and ``--plan plan.json`` rebuild the policy
    from it with no recalibration.
    """

    mode: str = "uniform"
    # uniform precision / auto budget anchor; None (rules mode only)
    # inherits the serving default
    weight_bits: Optional[int] = 4
    act_bits: Optional[int] = None
    rules: Tuple[PlanRule, ...] = ()
    # auto-mode budget anchors (exactly one is used: target_tps wins,
    # then budget_bpw, else match-uniform at weight_bits/act_bits)
    budget_bpw: Optional[float] = None
    target_tps: Optional[float] = None
    slo_batch: Optional[int] = None
    # cost-model knobs
    nbw: Union[int, str] = "auto"
    prt: str = "paper"
    max_segments: Optional[int] = None
    # serving flags
    quant_kv: bool = True
    # KV-cache precision as a plan dimension: None (defer to the engine's
    # ``quant_kv`` flag), "auto" (Planner probes per-layer KV sensitivity
    # and picks 8 vs 32), or a concrete 8 / 32.  int8 KV shrinks every
    # paged block, so the same byte budget admits more concurrent users.
    kv_bits: Optional[Union[int, str]] = None
    group_size: Optional[int] = None
    min_size: Optional[int] = None
    # self-speculative draft plan: None (no speculation), "auto" (the
    # Planner grid-solves (draft bits, k) for expected accepted tokens/s
    # against a calibration-measured acceptance curve), or a concrete
    # DraftSpec / "q<b>[a<ab>]:k<k>" token.  Joined the schema late;
    # omitted from JSON when unset so older plan hashes are unchanged.
    draft: Optional[Union[str, "DraftSpec"]] = None
    # tensor-parallel shard count as the plan's fifth axis: None (defer
    # to the engine's ``tp`` flag), "auto" (Planner picks the smallest
    # shard count that meets the SLO — trading bits against shards at a
    # fixed target), or a concrete M.  ``wire`` is the all-reduce
    # precision (32 exact, 8 int8+scale compressed partial sums).
    # Joined the schema late; omitted from JSON when unset so older plan
    # hashes are unchanged.
    tp: Optional[Union[int, str]] = None
    wire: Optional[int] = None
    # solved allocation (None until a Planner ran)
    weights_per_unit: Optional[Mapping[str, Any]] = None
    acts_per_unit: Optional[Mapping[str, Any]] = None
    # measured-hardware provenance: fitted cost-model constants from
    # ``planning.calibrate_cost`` (``CalibrationResult.provenance()``).
    # When present, Planner budgets against the fitted machine, and the
    # saved plan records exactly which hardware it was priced for.
    calibration: Optional[Mapping[str, Any]] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.prt not in _PRT_MODES:
            raise ValueError(f"prt must be one of {_PRT_MODES}, got {self.prt!r}")
        if not (self.nbw == "auto" or int(self.nbw) in (1, 2, 3, 4)):
            raise ValueError(f"nbw must be 'auto' or 1..4, got {self.nbw!r}")
        from repro_torch.core.quant import SUPPORTED_ABITS, SUPPORTED_BITS

        if self.weight_bits is None:
            if self.mode != "rules":
                raise ValueError("weight_bits may only be None in rules mode")
        elif self.budget_bpw is None and self.weight_bits not in SUPPORTED_BITS:
            raise ValueError(f"weight_bits must be one of {SUPPORTED_BITS}, got {self.weight_bits}")
        if self.act_bits is not None and self.act_bits not in SUPPORTED_ABITS:
            raise ValueError(
                f"act_bits must be one of {SUPPORTED_ABITS} or None, got {self.act_bits}"
            )
        if self.max_segments is not None and self.max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {self.max_segments}")
        if self.target_tps is not None and self.target_tps <= 0:
            raise ValueError(f"target_tps must be positive, got {self.target_tps}")
        if self.kv_bits not in (None, "auto", 8, 32):
            raise ValueError(f"kv_bits must be None, 'auto', 8, or 32, got {self.kv_bits!r}")
        if not (self.tp is None or self.tp == "auto" or
                (isinstance(self.tp, int) and self.tp >= 1)):
            raise ValueError(f"tp must be None, 'auto', or an int >= 1, got {self.tp!r}")
        if self.wire not in (None, 8, 32):
            raise ValueError(f"wire must be None, 8, or 32, got {self.wire!r}")
        object.__setattr__(self, "draft", _coerce_draft(self.draft))

    # -- solved state -----------------------------------------------------

    @property
    def solved(self) -> bool:
        """Auto plans become solved once a Planner filled the per-unit
        assignment; uniform/rules plans are directly servable.  A
        ``kv_bits`` of ``"auto"`` keeps any plan unsolved — the Planner
        must first probe KV sensitivity and pin a concrete 8 or 32.  A
        ``draft`` of ``"auto"`` likewise: the Planner must grid-solve
        the (draft bits, k) pair against measured acceptance first; a
        ``tp`` of ``"auto"`` needs the Planner to pin a shard count."""
        if self.kv_bits == "auto" or self.draft == "auto" or self.tp == "auto":
            return False
        return self.mode != "auto" or self.weights_per_unit is not None

    def with_solution(self, weights_per_unit, acts_per_unit=None) -> "PlanSpec":
        return dataclasses.replace(
            self,
            weights_per_unit=dict(weights_per_unit),
            acts_per_unit=dict(acts_per_unit) if acts_per_unit else None,
        )

    @property
    def spec_hash(self) -> str:
        """Stable content hash (provenance key in ``Engine.stats()`` and
        serve-bench artifacts — plan churn shows up as hash churn)."""
        blob = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    # -- string grammar (backward compat) ---------------------------------

    @staticmethod
    def parse(spec: str) -> "PlanSpec":
        """Parse the legacy ``--bit-policy`` grammar into a PlanSpec.

          uniform:<b>[a<ab>][,kv=...][,draft=...][,tp=...][,wire=...]
                                              one precision everywhere
          rules:<regex>=<b>[a<ab>],...        per-path overrides
                                              (``default=``/``*=`` sets the
                                              fallback precision)
          auto:q<b>[a<ab>][,<opt>...]         calibrated allocation within
                                              the uniform-(b[, ab]) budget
          auto:<f>bpw[,<opt>...]              ... within f bits/weight

        Auto options: ``prt=off|paper|measured``, ``maxseg=<n>``,
        ``a=<ab>``, ``kv=8|32|auto`` (KV-cache precision; ``auto`` probes
        per-layer KV sensitivity), ``slo=<tps>`` (derive the budgets
        from a target decode tokens/s instead of the uniform reference),
        and ``draft=q<b>[a<ab>]:k<k>|auto`` (self-speculative draft
        plan; ``auto`` grid-solves the draft-bits/k pair on measured
        acceptance).  ``tp=<M>|auto`` shards the quantized weight tree
        M ways (``auto`` picks the smallest M meeting the SLO) and
        ``wire=8|32`` sets the all-reduce precision.  ``kv=``,
        ``draft=``, ``tp=``, and ``wire=`` also apply to uniform mode.
        """
        kind, _, rest = spec.partition(":")
        if kind == "uniform":
            head, *opts = [p.strip() for p in rest.split(",") if p.strip()]
            bits, abits = _parse_bits_token(head)
            kw: Dict[str, Any] = {}
            for opt in opts:
                key, _, val = opt.partition("=")
                if key == "kv":
                    kw["kv_bits"] = val if val == "auto" else int(val)
                elif key == "draft":
                    kw["draft"] = val if val == "auto" else DraftSpec.parse(val)
                elif key == "tp":
                    kw["tp"] = val if val == "auto" else int(val)
                elif key == "wire":
                    kw["wire"] = int(val)
                else:
                    raise ValueError(
                        f"unknown uniform option {opt!r} in {spec!r} "
                        "(only kv=8|32|auto, draft=q<b>[a<ab>]:k<k>|auto, "
                        "tp=<M>|auto, and wire=8|32)")
            return PlanSpec(mode="uniform", weight_bits=bits,
                            act_bits=abits, **kw)
        if kind == "rules":
            rules = []
            default_bits, default_act = None, None
            for part in filter(None, rest.split(",")):
                pat, _, b = part.rpartition("=")
                if not pat:
                    raise ValueError(f"bad rule {part!r} in {spec!r}")
                bits, abits = _parse_bits_token(b)
                if pat in ("default", "*"):
                    default_bits, default_act = bits, abits
                else:
                    rules.append(PlanRule(pat, bits, abits))
            return PlanSpec(
                mode="rules",
                weight_bits=default_bits,
                act_bits=default_act,
                rules=tuple(rules),
            )
        if kind == "auto":
            parts = [p.strip() for p in rest.split(",") if p.strip()]
            if not parts:
                raise ValueError(f"empty auto spec {spec!r}")
            budget = parts[0]
            kw: Dict[str, Any] = {"mode": "auto"}
            if budget.startswith("q"):
                bits, abits = _parse_bits_token(budget[1:])
                kw["weight_bits"] = bits
                kw["act_bits"] = abits
            elif budget.endswith("bpw"):
                kw["budget_bpw"] = float(budget[:-3])
            else:
                raise ValueError(f"auto budget must be q<b>[a<ab>] or <f>bpw, got {budget!r}")
            for opt in parts[1:]:
                key, _, val = opt.partition("=")
                if key == "prt":
                    if val not in _PRT_MODES:
                        raise ValueError(f"prt must be off|paper|measured, got {val!r}")
                    kw["prt"] = val
                elif key == "maxseg":
                    if int(val) < 1:
                        raise ValueError(f"maxseg must be >= 1, got {val}")
                    kw["max_segments"] = int(val)
                elif key == "a":
                    kw["act_bits"] = int(val)
                elif key == "kv":
                    kw["kv_bits"] = val if val == "auto" else int(val)
                elif key == "slo":
                    kw["target_tps"] = float(val)
                elif key == "draft":
                    kw["draft"] = val if val == "auto" else DraftSpec.parse(val)
                elif key == "tp":
                    kw["tp"] = val if val == "auto" else int(val)
                elif key == "wire":
                    kw["wire"] = int(val)
                else:
                    raise ValueError(f"unknown auto option {opt!r} in {spec!r}")
            return PlanSpec(**kw)
        raise ValueError(f"unknown bit policy {spec!r} (expected uniform:/rules:/auto:)")

    def format(self) -> str:
        """Canonical grammar string of the *request* (the inverse of
        :meth:`parse` up to spec equivalence; the solved per-unit
        assignment has no grammar form — serialize those as JSON)."""
        if self.mode == "uniform":
            head = f"uniform:{_fmt_bits(self.weight_bits, self.act_bits)}"
            if self.kv_bits is not None:
                head += f",kv={self.kv_bits}"
            if self.draft is not None:
                head += f",draft={self._fmt_draft()}"
            if self.tp is not None:
                head += f",tp={self.tp}"
            if self.wire is not None:
                head += f",wire={self.wire}"
            return head
        if self.mode == "rules":
            parts = [f"{r.pattern}={_fmt_bits(r.weight_bits, r.act_bits)}" for r in self.rules]
            if self.weight_bits is not None or self.act_bits is not None:
                parts.append(f"default={_fmt_bits(self.weight_bits, self.act_bits)}")
            return "rules:" + ",".join(parts)
        if self.budget_bpw is not None:
            head = f"auto:{self.budget_bpw}bpw"
        else:
            head = f"auto:q{_fmt_bits(self.weight_bits, self.act_bits)}"
        opts = []
        if self.prt != "paper":
            opts.append(f"prt={self.prt}")
        if self.max_segments is not None:
            opts.append(f"maxseg={self.max_segments}")
        if self.kv_bits is not None:
            opts.append(f"kv={self.kv_bits}")
        if self.target_tps is not None:
            opts.append(f"slo={self.target_tps:g}")
        if self.draft is not None:
            opts.append(f"draft={self._fmt_draft()}")
        if self.tp is not None:
            opts.append(f"tp={self.tp}")
        if self.wire is not None:
            opts.append(f"wire={self.wire}")
        return ",".join([head] + opts)

    def _fmt_draft(self) -> str:
        return self.draft if isinstance(self.draft, str) else self.draft.format()

    # -- JSON round-trip --------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "version": PLAN_VERSION,
            "mode": self.mode,
            "weight_bits": int(self.weight_bits) if self.weight_bits is not None else None,
            "act_bits": self.act_bits,
            "nbw": self.nbw,
            "prt": self.prt,
            "quant_kv": bool(self.quant_kv),
        }
        if self.rules:
            out["rules"] = [r.to_json() for r in self.rules]
        # kv_bits, tp and wire joined the schema late; omitted when unset
        # so older plan hashes are unchanged
        keys = (
            "budget_bpw",
            "target_tps",
            "slo_batch",
            "max_segments",
            "kv_bits",
            "group_size",
            "min_size",
            "tp",
            "wire",
        )
        for key in keys:
            val = getattr(self, key)
            if val is not None:
                out[key] = val
        if self.draft is not None:
            out["draft"] = self.draft if isinstance(self.draft, str) else self.draft.to_json()
        if self.weights_per_unit is not None:
            out["weights_per_unit"] = _bits_to_json(self.weights_per_unit)
        if self.acts_per_unit is not None:
            out["acts_per_unit"] = _bits_to_json(self.acts_per_unit)
        if self.calibration is not None:
            out["calibration"] = dict(self.calibration)
        return out

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "PlanSpec":
        if "weight_bits" not in spec and "mode" in spec:
            # legacy parse_bit_policy dict (pre-PlanSpec engine configs)
            return PlanSpec.from_legacy_dict(spec)
        version = int(spec.get("version", PLAN_VERSION))
        if version > PLAN_VERSION:
            raise ValueError(f"plan version {version} is newer than {PLAN_VERSION}")
        wpu = spec.get("weights_per_unit")
        apu = spec.get("acts_per_unit")
        cal = spec.get("calibration")
        return PlanSpec(
            mode=spec.get("mode", "uniform"),
            weight_bits=(
                int(spec["weight_bits"]) if spec.get("weight_bits") is not None else None
            ),
            act_bits=(int(spec["act_bits"]) if spec.get("act_bits") is not None else None),
            rules=tuple(PlanRule.from_json(r) for r in spec.get("rules", ())),
            budget_bpw=(float(spec["budget_bpw"]) if spec.get("budget_bpw") is not None else None),
            target_tps=(float(spec["target_tps"]) if spec.get("target_tps") is not None else None),
            slo_batch=(int(spec["slo_batch"]) if spec.get("slo_batch") is not None else None),
            nbw=spec.get("nbw", "auto"),
            prt=spec.get("prt", "paper"),
            max_segments=(
                int(spec["max_segments"]) if spec.get("max_segments") is not None else None
            ),
            quant_kv=bool(spec.get("quant_kv", True)),
            kv_bits=(
                spec.get("kv_bits")
                if spec.get("kv_bits") in (None, "auto")
                else int(spec["kv_bits"])
            ),
            group_size=(int(spec["group_size"]) if spec.get("group_size") is not None else None),
            min_size=(int(spec["min_size"]) if spec.get("min_size") is not None else None),
            draft=_coerce_draft(spec.get("draft")),
            tp=(
                spec.get("tp")
                if spec.get("tp") in (None, "auto")
                else int(spec["tp"])
            ),
            wire=(int(spec["wire"]) if spec.get("wire") is not None else None),
            weights_per_unit=(_bits_from_json(wpu) if wpu is not None else None),
            acts_per_unit=(_bits_from_json(apu) if apu is not None else None),
            calibration=(dict(cal) if cal is not None else None),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @staticmethod
    def load(path: str) -> "PlanSpec":
        with open(path) as f:
            return PlanSpec.from_json(json.load(f))

    # -- legacy dict bridge (parse_bit_policy's output format) ------------

    def to_legacy_dict(self) -> Dict[str, Any]:
        """The legacy ``parse_bit_policy`` dict of this plan (the format
        pre-PlanSpec engine configs carry)."""
        if self.mode == "uniform":
            out: Dict[str, Any] = {"mode": "uniform", "bits": int(self.weight_bits)}
            if self.act_bits is not None:
                out["abits"] = int(self.act_bits)
            return out
        if self.mode == "rules":
            out = {
                "mode": "rules",
                "rules": [
                    (r.pattern, int(r.weight_bits))
                    for r in self.rules
                    if r.weight_bits is not None
                ],
            }
            act_rules = [(r.pattern, int(r.act_bits)) for r in self.rules if r.act_bits is not None]
            if act_rules:
                out["act_rules"] = act_rules
            if self.weight_bits is not None:
                out["bits"] = int(self.weight_bits)
            if self.act_bits is not None:
                out["abits"] = int(self.act_bits)
            return out
        out = {"mode": "auto"}
        if self.budget_bpw is not None:
            out["budget_bpw"] = float(self.budget_bpw)
        else:
            out["match_uniform"] = int(self.weight_bits)
        if self.act_bits is not None:
            out["abits"] = int(self.act_bits)
        if self.prt != "paper":
            out["prt"] = self.prt
        if self.max_segments is not None:
            out["max_segments"] = int(self.max_segments)
        if self.target_tps is not None:
            out["target_tps"] = float(self.target_tps)
        return out

    @staticmethod
    def from_legacy_dict(spec: Mapping[str, Any]) -> "PlanSpec":
        spec = dict(spec)
        mode = spec.pop("mode", None)
        known = {
            "bits",
            "abits",
            "rules",
            "act_rules",
            "match_uniform",
            "budget_bpw",
            "prt",
            "max_segments",
            "target_tps",
        }
        extra = set(spec) - known
        if extra:
            raise ValueError(
                f"unsupported legacy bit_policy keys {sorted(extra)} — these "
                "solver options moved to repro_torch.planning.Planner / "
                "repro_torch.core.sensitivity.calibrate_policy"
            )
        if mode == "uniform":
            return PlanSpec(
                mode="uniform",
                weight_bits=int(spec["bits"]),
                act_bits=(int(spec["abits"]) if spec.get("abits") is not None else None),
            )
        if mode == "rules":
            act = {p: int(b) for p, b in spec.get("act_rules", ())}
            rules = tuple(PlanRule(p, int(b), act.pop(p, None)) for p, b in spec.get("rules", ()))
            # act-only patterns (no weight rule) keep their own entry —
            # resolve_bit_policy applied the two rule lists independently
            rules += tuple(PlanRule(p, None, b) for p, b in act.items())
            bits = spec.get("bits")
            return PlanSpec(
                mode="rules",
                weight_bits=int(bits) if bits is not None else None,
                act_bits=(int(spec["abits"]) if spec.get("abits") is not None else None),
                rules=rules,
            )
        if mode == "auto":
            kw: Dict[str, Any] = {"mode": "auto"}
            if "match_uniform" in spec:
                kw["weight_bits"] = int(spec["match_uniform"])
            if spec.get("budget_bpw") is not None:
                kw["budget_bpw"] = float(spec["budget_bpw"])
            if spec.get("abits") is not None:
                kw["act_bits"] = int(spec["abits"])
            if spec.get("prt") is not None:
                kw["prt"] = spec["prt"]
            if spec.get("max_segments") is not None:
                kw["max_segments"] = int(spec["max_segments"])
            if spec.get("target_tps") is not None:
                kw["target_tps"] = float(spec["target_tps"])
            return PlanSpec(**kw)
        raise ValueError(f"unknown legacy bit_policy dict mode {mode!r}")

    # -- QuantPolicy bridge ------------------------------------------------

    def to_policy(self, base=None):
        """Materialize the ``QuantPolicy`` this plan serves with.

        ``base`` supplies the serving defaults the plan doesn't pin
        (group_size / min_size / codebook / fallback act_bits).  Unsolved
        auto plans raise — run them through a ``Planner`` first.
        """
        from repro_torch.models.sail_linear import BitAllocation, QuantPolicy

        base = base or QuantPolicy()
        if not self.solved:
            raise ValueError(
                "auto plan has no solved allocation — use repro_torch."
                "planning.Planner.solve (or Engine/resolve_plan, which run it)"
            )
        kw: Dict[str, Any] = {
            "group_size": self.group_size if self.group_size is not None else base.group_size,
            "min_size": self.min_size if self.min_size is not None else base.min_size,
        }
        if self.mode == "uniform":
            return dataclasses.replace(
                base,
                bits=int(self.weight_bits),
                act_bits=self.act_bits if self.act_bits is not None else base.act_bits,
                **kw,
            )
        if self.mode == "rules":
            return dataclasses.replace(
                base,
                bits=int(self.weight_bits) if self.weight_bits is not None else base.bits,
                rules=tuple(
                    (r.pattern, int(r.weight_bits))
                    for r in self.rules
                    if r.weight_bits is not None
                ),
                act_rules=tuple(
                    (r.pattern, int(r.act_bits)) for r in self.rules if r.act_bits is not None
                ),
                act_bits=self.act_bits if self.act_bits is not None else base.act_bits,
                **kw,
            )
        allocation = BitAllocation(
            per_path=dict(self.weights_per_unit),
            act_per_path=dict(self.acts_per_unit or {}),
        )
        return dataclasses.replace(
            base,
            bits=int(self.weight_bits),
            act_bits=self.act_bits if self.act_bits is not None else base.act_bits,
            allocation=allocation,
            **kw,
        )

    @staticmethod
    def from_policy(policy, quant_kv: bool = True) -> "PlanSpec":
        """Best-effort PlanSpec for an explicit ``QuantPolicy`` (legacy
        ``bit_policy=QuantPolicy(...)`` configs and checkpoint manifests)
        — the codebook, which is not plan state, stays on the policy."""
        alloc = policy.allocation
        if alloc is not None:
            return PlanSpec(
                mode="auto",
                weight_bits=int(policy.bits),
                act_bits=policy.act_bits,
                quant_kv=quant_kv,
                group_size=int(policy.group_size),
                min_size=int(policy.min_size),
                weights_per_unit=dict(alloc.per_path),
                acts_per_unit=(dict(alloc.act_per_path) if alloc.act_per_path else None),
            )
        if policy.rules or policy.act_rules:
            act = {p: int(b) for p, b in policy.act_rules}
            rules = tuple(PlanRule(p, int(b), act.pop(p, None)) for p, b in policy.rules)
            rules += tuple(PlanRule(p, None, b) for p, b in act.items())
            return PlanSpec(
                mode="rules",
                weight_bits=int(policy.bits),
                act_bits=policy.act_bits,
                rules=rules,
                quant_kv=quant_kv,
                group_size=int(policy.group_size),
                min_size=int(policy.min_size),
            )
        return PlanSpec(
            mode="uniform",
            weight_bits=int(policy.bits),
            act_bits=policy.act_bits,
            quant_kv=quant_kv,
            group_size=int(policy.group_size),
            min_size=int(policy.min_size),
        )
