"""Self-speculative decoding: two precision plans over ONE weight tree
(port of ``repro.serving.speculative``).

SAIL's LUT-GEMV makes precision a serving-time knob: the same raw weight
tree quantizes to any bit width, and fewer bits stream fewer bytes per
token.  So the draft of draft-model speculative decoding needs no second
model: it is the same network requantized aggressively (e.g. q2 where the
served plan is q4), resident beside the served tree.

One speculative **round** per engine iteration:

1. **draft** — ``lm.draft_tokens`` runs k single-token decode steps under
   the draft tree, sampling between them (argmax when greedy, else
   categorical on the DRAFT_SALT key stream).  The draft's KV lands in the
   shared cache at draft precision.
2. **verify** — ``lm.verify_step`` feeds the pending token and the k
   drafts through the served tree in one multi-token forward (each weight
   matmul one LUT-GEMV call over B x (k+1) rows), overwriting every slot
   the draft wrote.  Row i is the target distribution for draft i+1; row k
   prices the bonus token.
3. **accept / rollback** — :meth:`SpeculativeDecoder.accept`: the
   agreed argmax prefix when greedy; at temperature > 0 the p/q coin flip
   with residual resampling, on key streams salted apart from the engine's
   committed-token sampler.  The engine commits the accepted prefix, sets
   each lane's cache length to its accepted frontier (the whole rollback
   on the ring) and truncates paged block tables with
   ``BlockSpaceManager.truncate``.

The acceptance rule runs on the host in float64 numpy, as the reference's
does; its uniforms are ``jax.random.uniform`` on a thrice-folded key,
reproduced bit for bit by ``core.prng``.  The Planner prices the
draft/verify bit gap with ``planning.speculative_round_seconds`` (the SAIL
machine model) against a measured acceptance (:func:`measure_acceptance`,
run on the device the raw tree lives on).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.models.sail_linear import QuantPolicy, quantize_params

#: planning-time acceptance assumed before anything is measured (the
#: reference's value); a DraftSpec.acceptance or a measurement overrides it
DEFAULT_ACCEPTANCE = 0.8


def draft_policy(base: QuantPolicy, draft) -> QuantPolicy:
    """The draft tree's quantization policy: uniform at the DraftSpec's
    bits, with the served policy's grouping knobs."""
    return QuantPolicy(bits=draft.weight_bits, group_size=base.group_size,
                       min_size=base.min_size, skip_embed=base.skip_embed,
                       codebook=base.codebook, act_bits=draft.act_bits)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _stream_uniform(seed: int, uid: int, idx: int, salt: int) -> float:
    """``jax.random.uniform(fold_in(fold_in(fold_in(PRNGKey(seed), uid),
    idx), salt))``, bit for bit."""
    key = prng.fold_in(prng.fold_in(prng.fold_in(prng.prng_key(seed),
                                                 int(uid)), int(idx)), salt)
    return float(prng.uniform(key, ()))


def _stream_categorical(seed: int, uid: int, idx: int, salt: int,
                        probs: np.ndarray) -> int:
    """Inverse-CDF draw from ``probs`` on the salted per-request stream."""
    u = _stream_uniform(seed, uid, idx, salt)
    return int(min(np.searchsorted(np.cumsum(probs), u), len(probs) - 1))


def accept_greedy(draft: np.ndarray, targets: np.ndarray):
    """The greedy acceptance rule on the verify rows' argmax ``targets``
    [B, k+1]: each lane's agreed prefix length and the token after it (the
    correction, or the bonus when all k agree).  The engine takes the
    argmax on the device and sends only it to the host."""
    b, k = draft.shape
    matches = draft == targets[:, :k]
    n_acc = np.where(matches.all(axis=1), k,
                     np.argmin(matches, axis=1)).astype(np.int64)
    return n_acc, targets[np.arange(b), n_acc]


class SpeculativeDecoder:
    """Holds the draft weight tree and the acceptance machinery.

    Built by the engine while the raw f32 tree is in hand; the draft tree
    stays resident for the engine's lifetime.  ``draft_units`` are kept
    for the cost model, so the engine and the controller price a round
    without the raw tree."""

    def __init__(self, raw_params, cfg, draft, base_policy: QuantPolicy):
        from repro_torch import planning
        self.cfg = cfg
        self.spec = draft                    # planning.DraftSpec
        self.k = int(draft.k)
        self.policy = draft_policy(base_policy, draft)
        self.draft_units = planning.policy_units(raw_params, self.policy)
        self.draft_params, _, _ = quantize_params(raw_params, self.policy)
        # counters behind stats()["speculative"]
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0

    # -- planning-side numbers --------------------------------------------

    def assumed_acceptance(self) -> float:
        """Per-token acceptance used for pricing: the running measurement
        once 64 drafts have been judged, else the DraftSpec's measured
        value, else the default."""
        if self.drafted >= 64:
            return self.accepted / self.drafted
        if self.spec.acceptance is not None:
            return float(self.spec.acceptance)
        return DEFAULT_ACCEPTANCE

    def expected_tokens(self) -> float:
        from repro_torch.planning import expected_tokens_per_round
        return expected_tokens_per_round(self.assumed_acceptance(), self.k)

    # -- accept / rollback -------------------------------------------------

    def accept(self, draft: np.ndarray, verify_logits: np.ndarray,
               draft_logits: Optional[np.ndarray],
               temperature: float = 0.0, seed: int = 0,
               uids: Optional[np.ndarray] = None,
               indices: Optional[np.ndarray] = None):
        """The speculative-sampling acceptance rule over lanes.

        draft [B, k] drafted tokens; verify_logits [B, k+1, V] from the
        served tree.  Returns ``(n_acc [B], next_tok [B])``: each lane's
        accepted prefix length and the round's new pending token (the
        correction drawn at the first rejection, or the bonus draw when
        every draft was accepted).  Greedy (temperature 0) is exact argmax
        equality, so the committed tokens are plain decoding's."""
        b, k = draft.shape
        if temperature <= 0.0:
            return accept_greedy(draft, np.argmax(verify_logits, axis=-1))
        p = _softmax(verify_logits.astype(np.float64) / temperature)
        q = _softmax(draft_logits.astype(np.float64) / temperature)
        n_acc = np.zeros((b,), np.int64)
        next_tok = np.zeros((b,), np.int64)
        for i in range(b):
            uid = int(uids[i])
            base_idx = int(indices[i])
            a = k
            for j in range(k):
                d = int(draft[i, j])
                ratio = p[i, j, d] / max(q[i, j, d], 1e-30)
                u = _stream_uniform(seed, uid, base_idx + j, lm.ACCEPT_SALT)
                if u > ratio:
                    a = j
                    resid = np.maximum(p[i, j] - q[i, j], 0.0)
                    z = resid.sum()
                    probs = resid / z if z > 0 else p[i, j]
                    next_tok[i] = _stream_categorical(
                        seed, uid, base_idx + j, lm.RESAMPLE_SALT, probs)
                    break
            if a == k:
                next_tok[i] = _stream_categorical(
                    seed, uid, base_idx + k, lm.BONUS_SALT, p[i, k])
            n_acc[i] = a
        return n_acc, next_tok

    # -- observability -----------------------------------------------------

    def note_round(self, lanes: int, accepted: int) -> None:
        self.rounds += 1
        self.drafted += lanes * self.k
        self.accepted += int(accepted)

    def stats(self) -> Dict[str, Any]:
        return {
            "k": self.k,
            "draft_bits": self.policy.bits,
            "draft_act_bits": self.policy.act_bits,
            "rounds": self.rounds,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "acceptance_rate": (self.accepted / self.drafted
                                if self.drafted else None),
            "expected_tokens_per_round": self.expected_tokens(),
        }


def measure_acceptance(raw_params, cfg, base_policy: QuantPolicy,
                       draft_bits: int, act_bits: Optional[int] = None,
                       prompt=None, n_tokens: int = 32) -> float:
    """Measured per-token greedy acceptance of a draft bit width, on the
    device the raw tree lives on.

    Teacher-forced agreement: a greedy continuation under the served tree
    (quantized with ``base_policy``), then the same sequence fed through
    the draft tree, counting the positions where the draft's argmax is the
    continuation's next token (the event "draft token accepted" of a
    greedy round).  One number per (draft_bits, act_bits), independent of
    k.  Both trees prefill into an f32 KV cache, as the reference does."""
    dev = raw_params["embed"].device
    dp = QuantPolicy(bits=int(draft_bits), group_size=base_policy.group_size,
                     min_size=base_policy.min_size,
                     skip_embed=base_policy.skip_embed,
                     codebook=base_policy.codebook, act_bits=act_bits)
    cons, _, _ = quantize_params(raw_params, base_policy)
    draft, _, _ = quantize_params(raw_params, dp)
    if prompt is None:
        prompt = [1, 2, 3, 5, 8, 13]
    prompt = [int(t) % cfg.vocab for t in prompt]
    cache_len = min(cfg.window or 4096, len(prompt) + n_tokens + 1)
    argmax = lambda logits: int(torch.argmax(logits[0]))

    def feed(params, seq):
        """The argmax after each position of ``seq``, teacher-forced."""
        logits, cache = lm.prefill(params, [seq[:1]], cfg, cache_len,
                                   device=dev)
        preds = [argmax(logits)]
        for t in seq[1:]:
            logits, cache = lm.decode_step(params, [[t]], cache, cfg,
                                           device=dev)
            preds.append(argmax(logits))
        return preds

    # the continuation under the served tree
    logits, cache = lm.prefill(cons, [prompt], cfg, cache_len, device=dev)
    ref = []
    tok = argmax(logits)
    for _ in range(n_tokens):
        ref.append(tok)
        logits, cache = lm.decode_step(cons, [[tok]], cache, cfg, device=dev)
        tok = argmax(logits)
    seq = prompt + ref
    preds = feed(draft, seq)
    # preds[i] is the draft's argmax after seq[:i+1]: an accepted draft
    # token when it equals the continuation's token seq[i+1]
    hits = sum(1 for i in range(len(prompt) - 1, len(seq) - 1)
               if preds[i] == seq[i + 1])
    return hits / max(len(seq) - len(prompt), 1)
