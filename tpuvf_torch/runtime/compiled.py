"""The compiled step: a frame's whole step over fixed buffers, captured once
per key as a CUDA graph and replayed (the port of tpuvf's
``jax.jit(make_step(...), donate_argnums=(1,))``, its one program per
variant, ``_variant_step``/``_select_step``, and ``_locate_failure``,
``tpuvf/runtime/pipeline.py:344-498``, ``:1847-1891``).

The body is `Pipeline.step_sources`' walk over the DAG, run on buffers
that stay put from frame to frame:

- **inputs**: each source's host-layout bytes land in a fixed device buffer
  (`upload`: one host copy into a fresh pinned buffer, one non-blocking
  copy; `load_inputs` copies a batch's uploaded frame there); the split
  into canonical planes (``from_host_layout``) runs inside the body;
- **params**: the frame's staged scalars land in one fixed float32 vector,
  and every compositor's draw table in one fixed int32 buffer
  (``kernels/composite.py``), by one pinned non-blocking copy each, made
  outside the body and skipped while nothing changed (`stage`), or copied
  from a batch's staged rows (`stage_batch`, `load_staged`).  They are
  written in place: replays on one stream read them in order;
- **state**: the carried state is read from fixed buffers and, at the end
  of the body, copied back into them (``copy_``), so no state buffer
  aliases an input or an output (vfdeinterlace carries an RGB input's
  planes as its texture).  A state handed in that is not the fixed
  buffers (a rebuild's carry, a mesh run's, a caller's) is copied in first;
- **outputs**: each sink's ``device_payload`` (the host-layout permutation,
  a vfvideosink's render) runs inside the body; its pieces are the graph's
  own buffers, which the caller copies to the host right after the replay,
  before the next replay can write them.

On CUDA the body is captured as a ``torch.cuda.CUDAGraph`` on a side
stream of the pipeline's device and replayed on the current stream.  A
key's first frame runs the body eagerly, before any capture: that run
builds what is built at first use (the kernel library, the launchers'
per-card attribute and occupancy caches, a vfvideosink's render plan),
none of which may happen during a capture.  Its second frame captures and
replays; every later frame only replays.  Before a capture, as
``torch.cuda.graph`` does, the cyclic garbage collector runs and the
allocator's cache is emptied, and the collector stays off during the
capture: a dead pipeline's graphs, events or pinned buffers freed inside a
capture would invalidate it.  On the CPU every frame runs the
body eagerly over the same fixed buffers, so the CPU tests exercise the
buffers, the key, the state write-back and the draw tables; only the
capture needs the card.

**The key** of a graph holds whatever the launches take by value: the
static signature, each source's buffer flags (``__meta__``, e.g.
vfdeinterlace's ``tff``; without ``pts``, which reaches nothing), the
state's structure, shapes, dtypes and host leaves (``has_prev``), the
identity of tensors handed over as they are (a LUT table) and any other
host value an element reads outside the table (a compositor's pad numbers
go into its draw table and so never into the key).  Staged scalars and
draw tables are never in the key: a brightness ramp or a moving pad
replays one graph.  A vfvideosink's window change
(`SinkElement.payload_key`) drops the graphs, as a rebuild does.  At most
`MAX_GRAPHS` graphs are kept (the least recently used goes first): each
holds its intermediates in a private memory pool of the caching
allocator.

**Counters.**  `keys`, `captures`, `replays` and `eager` (frames run
without a graph) count the step's work; each capture's wall time adds to
``PipelineStats.compile_seconds``.  A replay runs no Python, so each graph
records the kernel launches its capture made (each wrapper's
``launches``) and adds them to the counters at every replay after the
first, which runs the captured frame itself.

**Failures.**  A capture that an element's op breaks raises
``PipelineError`` naming that element (`Pipeline.step_sources` wraps each
stage); nothing then runs the step eagerly in its place.  A fault that
surfaces at a replay, or at the wait on its event, names no stage: the
pipeline re-runs the frame eagerly on fresh state (`Pipeline.
_locate_failure`, tpuvf's twin) and names the element whose op fails.
"""

from __future__ import annotations

import gc
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuvf_torch.core.frame import HostLayout, from_host_layout
from tpuvf_torch.elements.compositor import DRAW_TABLE
from tpuvf_torch.kernels import (composite, deinterlace, emit, lut, overlay,
                                 resample)
from tpuvf_torch.runtime.observability import PipelineError
from tpuvf_torch.runtime.staging import ParamStager

META = "__meta__"


def launch_counters() -> tuple:
    """Every kernel wrapper that counts its launches (``launches``)."""
    return (resample.resample_rows, resample.resample_cols, emit.emit,
            lut.lut3d, composite.composite_fold,
            deinterlace.deinterlace_frame, overlay.overlay_frame)


# -- state trees: dicts, tuples and lists of tensors and host values ----------


def _tree_key(tree):
    """The structure, tensor shapes and dtypes, and host leaves of a state
    tree, hashable."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _tree_key(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_tree_key(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype)
    return ("host", tree)


def _value_key(value):
    """A value handed over as it is: a tensor by identity, else itself."""
    if isinstance(value, torch.Tensor):
        return ("tensor", value.data_ptr(), tuple(value.shape), value.dtype)
    try:
        hash(value)
    except TypeError:
        return ("repr", repr(value))
    return value


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _zip_tree(fn, fixed, new, where=""):
    """fn(fixed leaf, new leaf) over two trees of one structure -> a tree of
    fn's results; raises where the structures differ."""
    if isinstance(new, dict):
        if not isinstance(fixed, dict) or fixed.keys() != new.keys():
            raise ValueError(f"state of {where} changed its structure")
        return {k: _zip_tree(fn, fixed[k], new[k], where) for k in new}
    if isinstance(new, (tuple, list)):
        if type(fixed) is not type(new) or len(fixed) != len(new):
            raise ValueError(f"state of {where} changed its structure")
        return type(new)(_zip_tree(fn, a, b, where)
                         for a, b in zip(fixed, new))
    if isinstance(new, torch.Tensor) != isinstance(fixed, torch.Tensor):
        raise ValueError(f"state of {where} changed its structure")
    return fn(fixed, new)


def _copy_leaf(fixed, new):
    """Copy a tensor leaf into its fixed buffer (nothing when it is that
    buffer); -> the leaf the carried state holds."""
    if not isinstance(new, torch.Tensor):
        return new
    if new.shape != fixed.shape or new.dtype != fixed.dtype:
        raise ValueError(f"a state tensor changed from {tuple(fixed.shape)} "
                         f"{fixed.dtype} to {tuple(new.shape)} {new.dtype}")
    if new.data_ptr() != fixed.data_ptr():
        fixed.copy_(new)
    return fixed


class _Entry:
    """One key's captured graph, its outputs, the state it leaves and the
    launches its capture made (the key maps to None between its eager
    frame and its capture)."""

    def __init__(self, graph, payloads, state, launches):
        self.graph = graph
        self.payloads = payloads
        self.state = state
        self.launches = launches


class CompiledStep:
    """The step of one build of `pipe` over fixed buffers on its device
    (module doc).  `run`, `run_live` and `run_batched` without a mesh step
    through it; the mesh path and `Pipeline.step`/`step_sources` stay
    eager.  At most `MAX_GRAPHS` captured graphs are kept."""

    MAX_GRAPHS = 8

    def __init__(self, pipe):
        self.pipe = pipe
        self.device = pipe.device
        self.keys = self.captures = self.replays = self.eager = 0
        self._entries: "OrderedDict[tuple, Optional[_Entry]]" = OrderedDict()
        self._stager = ParamStager(self.device)
        self._layouts = {}  # source name -> HostLayout
        self._inputs = {}  # source name -> fixed flat device buffer
        self._pieces = {}  # source name -> its host-layout views
        for src in pipe.sources:
            layout = HostLayout(pipe._source_spec(src))
            flat = torch.empty(layout.nbytes, dtype=torch.uint8,
                               device=self.device)
            self._layouts[src.name] = layout
            self._inputs[src.name] = flat
            self._pieces[src.name] = layout._views(flat)
        self._aggs = pipe._table_layout()  # [(stage, offset, size)]
        size = sum(n for _, _, n in self._aggs)
        self._tables = torch.zeros(size, dtype=torch.int32,
                                   device=self.device)
        self._table_views = {st.element.name: self._tables[o:o + n]
                             for st, o, n in self._aggs}
        self._scalars: Optional[torch.Tensor] = None  # fixed float32 (k,)
        self._scalar_keys = None
        self._scalar_views: List[torch.Tensor] = []
        self._staged = None  # what the fixed params hold, while known
        self._state = None  # the fixed state buffers
        self._stream = None  # the side stream captures run on
        self._sink_keys = self._payload_keys()

    # -- inputs ---------------------------------------------------------------

    def upload(self, name: str, host_frame) -> None:
        """Source `name`'s host frame -> its fixed input buffer."""
        self._layouts[name].upload_into(host_frame, self._inputs[name])

    def load_inputs(self, name: str, pieces: List[torch.Tensor]) -> None:
        """Uploaded host-layout pieces on the device -> the fixed input."""
        for fixed, piece in zip(self._pieces[name], pieces):
            fixed.copy_(piece.reshape(fixed.shape))

    # -- params ---------------------------------------------------------------

    def _scalar_buffer(self, keys, k: int) -> None:
        if self._scalars is None:
            self._scalars = torch.zeros(k, dtype=torch.float32,
                                        device=self.device)
            self._scalar_keys = keys
            self._scalar_views = list(self._scalars)
        elif keys != self._scalar_keys:
            raise ValueError("a build's traced parameters changed their keys")

    def stage(self, reads, metas) -> None:
        """This frame's scalars and draw tables -> the fixed buffers, one
        pinned non-blocking copy each, none while they did not change."""
        keys, values = ParamStager._layout(reads)
        self._scalar_buffer(keys, len(values))
        table = self.pipe._frame_tables(reads, metas)
        last = self._staged or (None, None)
        if values and values != last[0]:
            self._stager.put(torch.tensor(values, dtype=torch.float32),
                             self._scalars)
        if table is not None and (last[1] is None
                                  or not np.array_equal(table, last[1])):
            self._stager.put(torch.from_numpy(table), self._tables)
        self._staged = (values, table)

    def stage_batch(self, rows, metas) -> list:
        """A batch's scalars and draw tables, one frame a row, each staged
        with one copy -> per frame (scalars row, tables row) on the device,
        for `load_staged`."""
        layouts = [ParamStager._layout(r) for r in rows]
        if any(keys != layouts[0][0] for keys, _ in layouts):
            raise ValueError("a batch's frames must stage the same params")
        self._scalar_buffer(layouts[0][0], len(layouts[0][1]))
        scalars = (self._stager.put(torch.tensor(
            [v for _, v in layouts], dtype=torch.float32))
            if layouts[0][1] else [None] * len(rows))
        tables = [None] * len(rows)
        if self._aggs:
            tables = self._stager.table_rows(
                [self.pipe._frame_tables(r, m) for r, m in zip(rows, metas)])
        return list(zip(scalars, tables))

    def load_staged(self, staged) -> None:
        """One frame's rows of `stage_batch` -> the fixed buffers."""
        scalars, tables = staged
        if scalars is not None:
            self._scalars.copy_(scalars)
        if tables is not None:
            self._tables.copy_(tables)
        self._staged = None

    def _params(self, reads) -> Dict[str, Dict]:
        params = ParamStager._assemble(reads, self._scalar_views)
        for name, view in self._table_views.items():
            params[name] = dict(params[name], **{DRAW_TABLE: view})
        return params

    # -- the key --------------------------------------------------------------

    def _payload_keys(self):
        return tuple(sink.payload_key() for sink in self.pipe.sinks)

    def _key(self, reads, metas, state) -> tuple:
        aggs = {st.element.name for st, _, _ in self._aggs}
        others = tuple(
            (name, tuple((k, _value_key(v)) for k, v in other.items()))
            for name, (_, other) in reads.items() if name not in aggs)
        flags = tuple((name, tuple(sorted(
            (k, v) for k, v in (meta or {}).items() if k != "pts")))
            for name, meta in sorted(metas.items()))
        return (self.pipe._built_signature, flags, others, _tree_key(state))

    # -- state ----------------------------------------------------------------

    def _load_state(self, state):
        """The carried state -> the fixed buffers (allocated from the first
        state seen); -> the state the body reads."""
        if self._state is None:
            self._state = _map_tree(
                lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                state)
            return self._state
        return {name: _zip_tree(_copy_leaf, self._state[name], s, name)
                for name, s in state.items()}

    def _write_back(self, new_state):
        """The body's new state -> the fixed buffers; -> the carried state
        (the fixed buffers and the new host leaves)."""
        return {name: _zip_tree(_copy_leaf, self._state[name], s, name)
                for name, s in new_state.items()}

    # -- the step -------------------------------------------------------------

    def _body(self, reads, metas, state, index: int):
        inputs = {name: dict(from_host_layout(self._pieces[name],
                                              self._layouts[name].spec),
                             **{META: meta})
                  for name, meta in metas.items()}
        out, new_state = self.pipe.step_sources(inputs, state,
                                                self._params(reads), index)
        payloads = self.pipe._payloads(out, index)
        return payloads, self._write_back(new_state)

    def step(self, reads, metas, state, index: int):
        """Frame `index`'s step over the fixed buffers (inputs uploaded,
        params staged): -> ([(sink, layout, device pieces)], the carried
        state).  Eager on a key's first frame and on the CPU; else the
        key's graph, captured on its second frame."""
        sink_keys = self._payload_keys()
        if sink_keys != self._sink_keys:  # a sink's render plan changed
            self._entries.clear()
            self._sink_keys = sink_keys
        key = self._key(reads, metas, state)
        state = self._load_state(state)
        if key not in self._entries:  # the key's first frame: eager
            self.keys += 1
            self._entries[key] = None
            while len(self._entries) > self.MAX_GRAPHS:
                self._entries.popitem(last=False)
            self.eager += 1
            return self._body(reads, metas, state, index)
        self._entries.move_to_end(key)
        if self.device.type != "cuda":
            self.eager += 1
            return self._body(reads, metas, state, index)
        entry = self._entries[key]
        if entry is None:  # the second frame: capture, then replay
            entry = self._entries[key] = self._capture(reads, metas, state,
                                                       index)
        else:
            for wrapper, n in entry.launches.items():
                wrapper.launches += n
        entry.graph.replay()
        self.replays += 1
        return entry.payloads, entry.state

    def _capture(self, reads, metas, state, index: int) -> _Entry:
        """Capture the body as a CUDA graph on a side stream (not run: its
        replay runs it).  A failure raises PipelineError naming the element
        whose op broke the capture, else "<pipeline>".  The capture is
        begun and ended by hand, so a capture that fails still restores
        the current stream."""
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        failed = None
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        # as torch.cuda.graph does: dead objects (another pipeline's graphs,
        # events, pinned buffers) are freed now, and the collector stays off
        # during the capture, where such a free invalidates it
        gc.collect()
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        try:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                graph.capture_begin()
                try:
                    payloads, new_state = self._body(reads, metas, state,
                                                     index)
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    failed = exc
                try:
                    graph.capture_end()
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    if failed is None:
                        failed = exc
        finally:
            if collecting:
                gc.enable()
        self.pipe.stats.compile_seconds += time.perf_counter() - t0
        if failed is not None:
            if isinstance(failed, PipelineError):
                raise failed
            raise PipelineError("<pipeline>", index, failed) from failed
        self.captures += 1
        launches = {w: w.launches - b for w, b in zip(counters, before)
                    if w.launches != b}
        return _Entry(graph, payloads, new_state, launches)
