"""Per-frame parameters on the device (the port of tpuvf's ``_stage_params``
and ``_frame_params``, ``tpuvf/runtime/pipeline.py:713-742``).

Each frame the pipeline re-reads every active element's traced values
(`Element.traced_values`): the scalars the step reads on the device, and
values handed over as they are (a LUT table already on the device, the
compositor's host numbers).  tpuvf re-reads the scalars every frame and
keeps the staged copy of an array while the element hands over the same
object; the port does the same: it compares the scalars by value and
stages them again only when one changed.

A staged frame's scalars lie in one float32 device vector, and each
parameter is a 0-dim view of it.  On a GPU the values go through a pinned
host buffer and one non-blocking copy, so staging never waits for the
frames already queued (a ``torch.tensor(v, device="cuda")`` per scalar is
a pageable, blocking copy each).  The pinned buffers are taken in turns,
and a buffer is written again only after the copy that read it has run
(an event recorded behind the copy).  A staged vector is never written in
place: a changed frame gets a new one, so a queued step keeps reading its
own values.  A batch (`stage_rows`) stacks its frames' scalars into one
(n, k) buffer with one copy, and each frame reads its row.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# {element name: (scalars {key: float}, other values {key: value})}
Reads = Dict[str, Tuple[Dict[str, float], Dict]]


def read_params(elements, device) -> Reads:
    """Every element's traced values for this frame, read on the host."""
    return {e.name: e.traced_values(device) for e in elements}


class ParamStager:
    """Stages the scalars of `read_params` on one device."""

    SLOTS = 2  # pinned buffers, taken in turns

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: List[list] = []  # [pinned buffer, event or None]
        self._turn = 0
        self._last = None  # (keys, values) of the last staged frame
        self._views: List[torch.Tensor] = []

    @staticmethod
    def _layout(reads: Reads):
        keys = tuple((n, k) for n, (scalars, _) in reads.items()
                     for k in scalars)
        values = tuple(v for _, (scalars, _) in reads.items()
                       for v in scalars.values())
        return keys, values

    @staticmethod
    def _assemble(reads: Reads, views) -> Dict[str, Dict]:
        params, it = {}, iter(views)
        for name, (scalars, other) in reads.items():
            p = {k: next(it) for k in scalars}
            p.update(other)
            params[name] = p
        return params

    def frame(self, reads: Reads) -> Dict[str, Dict]:
        """One frame's params: the last staged scalars while none changed,
        else a freshly staged vector."""
        keys, values = self._layout(reads)
        if (keys, values) != self._last:
            self._views = list(self._stage([values])[0]) if values else []
            self._last = (keys, values)
        return self._assemble(reads, self._views)

    def stage_rows(self, rows: List[Reads]) -> List[Dict[str, Dict]]:
        """A batch's params, one dict a frame, from one (n, k) copy; every
        row must have the same keys."""
        layouts = [self._layout(r) for r in rows]
        if any(keys != layouts[0][0] for keys, _ in layouts):
            raise ValueError("a batch's frames must stage the same params")
        values = [v for _, v in layouts]
        if not values[0]:
            return [self._assemble(r, ()) for r in rows]
        staged = self._stage(values)
        return [self._assemble(r, list(staged[j])) for j, r in enumerate(rows)]

    def _stage(self, values: List[tuple]) -> torch.Tensor:
        """(n, k) host values -> a new (n, k) float32 tensor on the device."""
        if self.device.type != "cuda":
            return torch.tensor(values, dtype=torch.float32, device=self.device)
        n, k = len(values), len(values[0])
        if len(self._slots) < self.SLOTS:
            self._slots.append([None, None])
        slot = self._slots[self._turn % len(self._slots)]
        self._turn += 1
        if slot[1] is not None:
            slot[1].synchronize()  # the copy that read this buffer has run
        if slot[0] is None or slot[0].numel() < n * k:
            slot[0] = torch.empty(n * k, dtype=torch.float32, pin_memory=True)
        host = slot[0][:n * k].view(n, k)
        host.copy_(torch.tensor(values, dtype=torch.float32))
        out = host.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out
