"""ActivationTap: per-layer activation capture inside ``Engine.step()``
(port of ``repro.planning.tap``).

``lm.decode_step(capture_layer_inputs=True)`` returns each layer's block
input (the vectors the DFM would stream through the PRT); the engine hands
them to the tap every ``capture_every``-th decode iteration, and
``Planner.replan(tap)`` turns the captured batches into measured per-layer
PRT discounts — and, with ``resolve=True``, a fresh allocation — as traffic
shifts.

The tap keeps a bounded ring per layer (``capacity`` rows), so a
long-running engine pays constant memory and replans always see the most
recent traffic window.  ``observe`` moves one iteration's captured tensor
to the host once; that copy is the only synchronisation the tap adds.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch


class ActivationTap:
    """Bounded per-layer ring buffer of decode-time activation rows."""

    def __init__(self, capacity: int = 512, capture_every: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if capture_every < 1:
            raise ValueError(f"capture_every must be >= 1, got {capture_every}")
        self.capacity = int(capacity)
        self.capture_every = int(capture_every)
        self._rows: Dict[int, deque] = {}
        self.observations = 0  # decode iterations captured
        self.rows_seen = 0  # activation rows captured (across layers)

    def should_capture(self, iteration: int) -> bool:
        """Subsample capture to every ``capture_every``-th iteration (the
        host copy forces a device sync, so heavy serving loops may not
        want every step)."""
        return iteration % self.capture_every == 0

    def observe(self, layer_inputs, active_mask=None) -> None:
        """Record one decode iteration's layer inputs.

        ``layer_inputs``: [L, B, 1, D] (or [L, B, D]) block inputs from
        ``lm.decode_step(capture_layer_inputs=True)``, a tensor on any
        device or an array.  ``active_mask`` ([B] bool) drops retired
        slots' dead lanes: their activations are stale values the engine
        ignores, and they would pollute the measured repeat statistics.
        """
        if isinstance(layer_inputs, torch.Tensor):
            arr = layer_inputs.float().cpu().numpy()
        else:
            arr = np.asarray(layer_inputs, np.float32)
        if arr.ndim == 4:  # [L, B, T=1, D]
            arr = arr[:, :, 0, :]
        if arr.ndim != 3:
            raise ValueError(f"layer_inputs must be [L, B, D], got {arr.shape}")
        if active_mask is not None:
            mask = np.asarray(active_mask, bool)
            arr = arr[:, mask, :]
        if arr.shape[1] == 0:
            return
        for layer in range(arr.shape[0]):
            ring = self._rows.get(layer)
            if ring is None:
                ring = self._rows[layer] = deque(maxlen=self.capacity)
            ring.extend(arr[layer])
        self.observations += 1
        self.rows_seen += int(arr.shape[0] * arr.shape[1])

    # -- consumers --------------------------------------------------------

    @property
    def n_layers(self) -> int:
        return len(self._rows)

    def __len__(self) -> int:
        """Rows currently held for layer 0 (the ring fill level)."""
        ring = self._rows.get(0)
        return len(ring) if ring is not None else 0

    def rows(self, layer: int) -> Optional[np.ndarray]:
        """f32 [n, D] captured batch for one layer (None if empty)."""
        ring = self._rows.get(layer)
        if not ring:
            return None
        return np.stack(ring).astype(np.float32)

    def calib(self, max_rows: Optional[int] = None) -> Optional[Dict]:
        """Per-layer calibration mapping for ``DecodeCostModel`` /
        ``Planner.replan``: ``{layer: [n, D] f32, None: merged}`` (the
        ``None`` entry is the cross-layer fallback for units without their
        own capture).  Returns None when nothing was captured."""
        if not self._rows:
            return None
        out: Dict = {}
        for layer in sorted(self._rows):
            batch = self.rows(layer)
            if batch is None:
                continue
            if max_rows is not None and batch.shape[0] > max_rows:
                batch = batch[-max_rows:]
            out[layer] = batch
        if not out:
            return None
        merged = np.concatenate(list(out.values()), axis=0)
        if max_rows is not None and merged.shape[0] > max_rows:
            merged = merged[-max_rows:]
        out[None] = merged
        return out

    def clear(self) -> None:
        self._rows.clear()
