"""Faults planted under the timed path: each has to turn a run's ``correct``
false.  ``plant(name, patch)`` installs one through ``patch(obj, attr,
value)`` (``setattr``, or pytest's ``monkeypatch.setattr``).  Each wraps
``Pipeline._deliver`` and waits on the frame's event before it touches the
read-back bytes, so it acts the same on a card as on the CPU.

- ``altered``: an answer altered where it is produced, a block of every
  frame's bytes flipped;
- ``slot``: the same, in one slot of the batch graph only (frames
  ``SLOT`` modulo 8);
- ``stale``: a step that hands on its last output, every frame after the
  first delivered with the previous frame's bytes;
- ``half``: half of each batch left out, every odd frame never delivered.
"""

from __future__ import annotations

SLOT = 5


def _deliver_wrapper(patch, body):
    from tpuvf_torch.runtime.pipeline import Pipeline

    real = Pipeline._deliver

    def deliver(self, index, copies, event, retry=None):
        if event is not None:
            event.synchronize()
        copies = body(index, copies)
        if copies is not None:
            return real(self, index, copies, None, retry)

    patch(Pipeline, "_deliver", deliver)


def _flip(copies):
    for _, _, flat in copies:
        flat[:64] ^= 0x40
    return copies


def altered(patch):
    _deliver_wrapper(patch, lambda index, copies: _flip(copies))


def slot(patch):
    _deliver_wrapper(patch, lambda index, copies: (
        _flip(copies) if index % 8 == SLOT else copies))


def stale(patch):
    last = {}

    def body(index, copies):
        held = [(s, layout, flat.clone()) for s, layout, flat in copies]
        out = last.get("prev", copies)
        last["prev"] = held
        return out

    _deliver_wrapper(patch, body)


def half(patch):
    _deliver_wrapper(patch, lambda index, copies: (
        copies if index % 2 == 0 else None))


FAULTS = {"altered": altered, "slot": slot, "stale": stale, "half": half}


def plant(name: str, patch=setattr) -> None:
    FAULTS[name](patch)
