"""The compiled step: a frame's, a batch's or a dp shard's whole step over
fixed buffers, captured once per key as a CUDA graph and replayed (the port
of tpuvf's ``jax.jit(make_step(...), donate_argnums=(1,))``, its one
program per variant, ``_variant_step``/``_select_step``, its one program a
batch, ``jax.jit(batch_step)`` over ``lax.scan``, the per-shard scan inside
``parallel_batch_fn``'s ``shard_map``, and ``_locate_failure``;
``tpuvf/runtime/pipeline.py:344-498``, ``:1847-1891``, ``:2012-2039``,
``tpuvf/parallel/mesh.py:74-192``).

A **frame's body** is `Pipeline.step_sources`' walk over the DAG, run on
buffers that stay put from frame to frame:

- **inputs**: each source's host-layout bytes land in a fixed device buffer
  (`upload`, `Pipeline._upload_rows`: one host copy into a fresh pinned
  buffer, one non-blocking copy); the split into canonical planes
  (``from_host_layout``) runs inside the body;
- **params**: the frame's staged scalars land in one fixed float32 row,
  and every compositor's draw table in one fixed int32 row
  (``kernels/composite.py``), by one pinned non-blocking copy each, made
  outside the body and skipped while nothing changed (`stage`,
  `_ParamRows`).  They are written in place: replays on one stream read
  them in order;
- **state**: the carried state is read from fixed buffers and, at the end
  of the body, copied back into them (``copy_``), so no state buffer
  aliases an input or an output (vfdeinterlace carries an RGB input's
  planes as its texture).  A state handed in that is not the fixed
  buffers (a rebuild's carry, a mesh run's, a caller's) is copied in first;
- **outputs**: each sink's ``device_payload`` (the host-layout permutation,
  a vfvideosink's render) runs inside the body; its pieces are the graph's
  own buffers, which the caller copies to the host right after the replay,
  before the next replay can write them.

A **batch's body** (`step_batch`, `Pipeline.run_batched` without a mesh)
runs n frames' bodies back to back over n sets of those buffers: n fixed
input rows a source, one (n, k) float32 scalar block and one (n, T) int32
table block (`stage_batch`, one copy each), frame j reading row j, so a
ramp within a batch is data, not a key.  The state runs through the n
frames inside the body (frame j+1 reads what frame j left) and is copied
back into the fixed state buffers once, at the end.  Each frame's
payloads are the graph's own buffers, n sets of them.

A **dp shard's body** (`ShardStep`, `Pipeline.run_batched(mesh=...)`) is
the shard's sub-batch (``batch_size/dp`` frames) through
`Pipeline._step_bands`, its bands included, over the shard's own fixed
input rows on its first card, each mesh card's (n, k)/(n, T) param rows
and its per-band state tiles, with the same write-back.  Its graph is
captured on the shard's first card and replayed on that card's current
stream, so shards on different cards run at once.  A shard whose bands
lie on several distinct cards gathers halo rows across cards, which one
card's capture cannot hold: such a shard runs its body eagerly every
batch, and each of its frames counts in `eager`.

On CUDA a body is captured as a ``torch.cuda.CUDAGraph`` on a side
stream of its card and replayed on the current stream; nothing is run by
the capture itself, its replay runs it.  Work done at first use (the
kernel library, the launchers' per-card attribute and occupancy caches,
a vfvideosink's render plan) may not happen during a capture, so every
frame key runs once eagerly first:

- a frame graph's key (`_key`) is captured on its second frame and
  replayed after;
- a batch graph's key is ``(n, the n frame keys)``, a shard graph's adds
  the mesh layout's key, the shard and its cards.  Each frame key there
  is its frame's with the state key the previous frame's key leaves,
  learnt (`_after`) when that key last ran eagerly.  A batch whose frame
  keys are all known is captured at once and replayed; one with an
  unknown frame key runs eagerly and learns them.  So a 16-frame call
  in batches of 8 runs batch 0 eagerly and captures batch 1, greedy-H's
  included (its first batch carries ``has_prev=False`` on frame 0 and so
  has another key than its second); a call after `run` has seen the
  chain's keys captures its first batch;
- a short tail (n < batch_size) takes its own key, as tpuvf re-traces for
  a shorter tail.

Before a capture, as ``torch.cuda.graph`` does, the cyclic garbage
collector runs and the allocator's cache is emptied, and the collector
stays off during the capture: a dead pipeline's graphs, events or pinned
buffers freed inside a capture would invalidate it.  `graphs` is False on
the CPU, where every body runs eagerly over the same fixed buffers, so the
CPU tests exercise the buffers, the keys, the state threading and
write-back and the draw tables; only the capture needs the card.  The
reference runs of the card's checks set it False too.

**The key** of a frame holds whatever the launches take by value: the
static signature, each source's buffer flags (``__meta__``, e.g.
vfdeinterlace's ``tff``; without ``pts``, which reaches nothing), the
state's structure, shapes, dtypes and host leaves (``has_prev``), the
identity of tensors handed over as they are (a LUT table) and any other
host value an element reads outside the table (a compositor's pad numbers
go into its draw table and so never into the key).  Staged scalars and
draw tables are never in the key: a brightness ramp or a moving pad
replays one graph.  A vfvideosink's window change
(`SinkElement.payload_key`) drops the graphs and the learnt keys, as a
rebuild does.

**Memory.**  Each graph holds its intermediates and its outputs in a
private memory pool of the caching allocator: a batch graph n frames'
worth (n payload sets), beside the n fixed input rows of its batch size.
At most `MAX_GRAPHS` frame graphs and, on a limit of their own,
`MAX_BATCH_GRAPHS` batch and shard graphs are kept (the least recently
used goes first): a capture costs a collection and an emptied cache
(100-600 ms on the card), so the limit leaves room for a full batch's and
a tail's key on each shard of a four-card mesh.

**Counters.**  `keys` (frame keys learnt), `captures` and `replays` (frame
graphs), `batch_captures` and `batch_replays` (batch and shard graphs)
and `eager` (frames run without a graph) count the step's work; each
capture's wall time adds to ``PipelineStats.compile_seconds``.  A replay
runs no Python, so each graph records the kernel launches its capture made
(each wrapper's ``launches``; a batch graph n frames' worth) and adds them
to the counters at every replay after the first, which runs the captured
body itself.

**Failures.**  A capture that an element's op breaks raises
``PipelineError`` naming that element at its frame (`Pipeline.
step_sources` wraps each stage; a batch's frames carry the batch's first
index, as tpuvf's one dispatch a batch does); nothing then runs the step
eagerly in its place.  A fault that surfaces at a replay, or at the wait
on its event, names no stage: the pipeline re-runs the frame (a batch's
first frame) eagerly on fresh state (`Pipeline._locate_failure`, tpuvf's
twin) and names the element whose op fails.  What stays eager:
`Pipeline.step`/`step_sources`, and the shards over several cards.
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
from tpuvf_torch.runtime.device import on_device
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


class _Carry:
    """The fixed buffers of a carried state: {element: state}, or a list of
    them (a shard's bands).  `load` copies a state in (the first state
    seen is cloned into new buffers), `back` copies the body's new state
    in; each -> the fixed buffers with the state's host leaves."""

    def __init__(self):
        self.fixed = None

    def load(self, state):
        if self.fixed is None:
            self.fixed = _map_tree(
                lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                state)
            return self.fixed
        return self.back(state)

    def back(self, state):
        return _carry(self.fixed, state)


def _carry(fixed, state):
    if isinstance(state, list):
        if not isinstance(fixed, list) or len(fixed) != len(state):
            raise ValueError("a shard's bands changed")
        return [_carry(f, s) for f, s in zip(fixed, state)]
    return {name: _zip_tree(_copy_leaf, fixed[name], s, name)
            for name, s in state.items()}


# -- fixed buffers ------------------------------------------------------------


def _input_rows(layouts: Dict[str, HostLayout], device, n: int):
    """n fixed input rows a source on `device` -> ({source name: (n, nbytes)
    uint8}, {source name: [each row's host-layout views]})."""
    flats = {name: torch.empty((n, lay.nbytes), dtype=torch.uint8,
                               device=device)
             for name, lay in layouts.items()}
    return flats, {name: [layouts[name]._views(row) for row in flat]
                   for name, flat in flats.items()}


class _ParamRows:
    """n frames' params in fixed buffers on one device, one row a frame:
    the staged scalars, (n, k) float32, and every compositor's draw table
    back to back (``Pipeline._table_layout``), (n, T) int32.  `stage`
    writes them with one pinned non-blocking copy each, none while they
    did not change; a body reads frame j's row through `params`."""

    def __init__(self, device, n: int, aggs):
        self.n = n
        self.device = device
        self.aggs = aggs  # [(stage, offset, size)]
        size = sum(s for _, _, s in aggs)
        self.tables = (torch.zeros((n, size), dtype=torch.int32,
                                   device=device) if aggs else None)
        self.scalars: Optional[torch.Tensor] = None
        self.keys = None
        self._views: List[list] = []  # each row's 0-dim scalar views
        self._last = (None, None)  # what the buffers hold

    def stage(self, stager: ParamStager, rows, tables) -> None:
        """The frames' reads (`read_params`, one a row) and draw tables
        (`Pipeline._frame_tables`, one a row, None without a compositor)
        -> the fixed buffers."""
        layouts = [ParamStager._layout(r) for r in rows]
        keys = layouts[0][0]
        if any(k != keys for k, _ in layouts):
            raise ValueError("a batch's frames must stage the same params")
        if self.scalars is None:
            self.scalars = torch.zeros((self.n, len(keys)),
                                       dtype=torch.float32,
                                       device=self.device)
            self.keys = keys
            self._views = [list(row) for row in self.scalars]
        elif keys != self.keys:
            raise ValueError("a build's traced parameters changed their keys")
        values = tuple(v for _, v in layouts)
        table = np.stack(tables) if self.tables is not None else None
        last_values, last_table = self._last
        if keys and values != last_values:
            stager.put(torch.tensor(values, dtype=torch.float32),
                       self.scalars)
        if table is not None and (last_table is None
                                  or not np.array_equal(table, last_table)):
            stager.put(torch.from_numpy(table), self.tables)
        self._last = (values, table)

    def params(self, j: int, reads) -> Dict[str, Dict]:
        """Frame j's params: its scalars as 0-dim views of row j, each
        compositor's draw table a view of row j, other values as read."""
        params = ParamStager._assemble(reads, self._views[j])
        for st, offset, size in self.aggs:
            name = st.element.name
            params[name] = dict(params[name], **{
                DRAW_TABLE: self.tables[j, offset:offset + size]})
        return params


class _Entry:
    """One key's captured graph, what its capture's body returned (its
    outputs and the state it leaves: the graph's own buffers), and the
    launches its capture made."""

    def __init__(self, graph, result, launches):
        self.graph = graph
        self.result = result
        self.launches = launches

    def count(self) -> None:
        """A replay's launches -> the kernels' counters."""
        for wrapper, n in self.launches.items():
            wrapper.launches += n


class CompiledStep:
    """The steps of one build of `pipe` over fixed buffers on its devices
    (module doc): `run` and `run_live` step a frame through `step`,
    `run_batched` a batch through `step_batch`, and on a mesh each dp
    shard's sub-batch through `shard`'s `ShardStep`.  `Pipeline.step`/
    `step_sources` stay eager.  At most `MAX_GRAPHS` frame graphs and
    `MAX_BATCH_GRAPHS` batch and shard graphs are kept.  With `graphs`
    False (the CPU) every body runs eagerly."""

    MAX_GRAPHS = 8
    MAX_BATCH_GRAPHS = 16  # a batch and a tail key a shard on 4 cards

    def __init__(self, pipe):
        self.pipe = pipe
        self.device = pipe.device
        self.graphs = self.device.type == "cuda"
        self.keys = self.captures = self.replays = self.eager = 0
        self.batch_captures = self.batch_replays = 0
        self._entries: "OrderedDict[tuple, Optional[_Entry]]" = OrderedDict()
        self._batches: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._after: Dict[tuple, tuple] = {}  # frame key -> state key after
        self._stager = ParamStager(self.device)
        self._layouts = {src.name: HostLayout(pipe._source_spec(src))
                         for src in pipe.sources}
        self._rows: Dict[int, tuple] = {}  # n -> _input_rows
        self._inputs = self.batch_inputs(1)  # a frame's fixed inputs
        self._aggs = pipe._table_layout()  # [(stage, offset, size)]
        self._agg_names = {st.element.name for st, _, _ in self._aggs}
        self._params_at: Dict[tuple, _ParamRows] = {}  # (device, n)
        self._state = _Carry()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._shards: Dict[tuple, ShardStep] = {}
        self._sink_keys = self._payload_keys()

    # -- inputs ---------------------------------------------------------------

    def batch_inputs(self, n: int) -> Dict[str, torch.Tensor]:
        """The fixed inputs of a batch of n: {source name: (n, nbytes)}."""
        if n not in self._rows:
            self._rows[n] = _input_rows(self._layouts, self.device, n)
        return self._rows[n][0]

    def upload(self, name: str, host_frame, index=None) -> None:
        """Source `name`'s host frame -> its fixed input (a frame's); its
        spans add to the pipeline's `edge_seconds`, `index` in their args."""
        self._layouts[name].upload_into([host_frame], self._inputs[name],
                                        self.pipe.stats.edge_seconds, index)

    # -- params ---------------------------------------------------------------

    def param_rows(self, device, n: int) -> _ParamRows:
        """The fixed param rows of a batch of n on `device`."""
        key = (torch.device(device), n)
        if key not in self._params_at:
            self._params_at[key] = _ParamRows(key[0], n, self._aggs)
        return self._params_at[key]

    def stage(self, reads, metas) -> None:
        """This frame's scalars and draw tables -> its fixed rows."""
        self.stage_batch([reads], [metas])

    def stage_batch(self, rows, metas) -> None:
        """A batch's scalars and draw tables, one frame a row -> the fixed
        rows of its size, one copy each (`_ParamRows.stage`)."""
        tables = [self.pipe._frame_tables(r, m) for r, m in zip(rows, metas)]
        self.param_rows(self.device, len(rows)).stage(self._stager, rows,
                                                      tables)

    # -- keys -----------------------------------------------------------------

    def _payload_keys(self):
        return tuple(sink.payload_key() for sink in self.pipe.sinks)

    def _check_sinks(self) -> None:
        """A sink's render plan changed: its graphs and learnt keys go."""
        sink_keys = self._payload_keys()
        if sink_keys != self._sink_keys:
            self._entries.clear()
            self._batches.clear()
            self._after.clear()
            self._sink_keys = sink_keys

    def _key(self, reads, metas, state_key) -> tuple:
        """A frame's key (module doc); `state_key` is its state's
        `_tree_key`."""
        others = tuple(
            (name, tuple((k, _value_key(v)) for k, v in other.items()))
            for name, (_, other) in reads.items()
            if name not in self._agg_names)
        flags = tuple((name, tuple(sorted(
            (k, v) for k, v in (meta or {}).items() if k != "pts")))
            for name, meta in sorted(metas.items()))
        return (self.pipe._built_signature, flags, others, state_key)

    def _learn(self, key, state) -> None:
        """Frame key `key` ran eagerly and left `state`."""
        if key not in self._after:
            self.keys += 1
        self._after[key] = _tree_key(state)

    def _frame_keys(self, key_of, n: int, state_key):
        """The keys of n frames, frame i's `key_of(i, its state key)`, each
        state key the one its predecessor's key left when it last ran
        eagerly; None while one of them has not run."""
        keys = []
        for i in range(n):
            key = key_of(i, state_key)
            state_key = self._after.get(key)
            if state_key is None:
                return None
            keys.append(key)
        return tuple(keys)

    # -- state ----------------------------------------------------------------

    def _load_state(self, state):
        """The carried state -> the fixed buffers (allocated from the first
        state seen); -> the state the body reads."""
        return self._state.load(state)

    # -- the frame step -------------------------------------------------------

    def _body(self, reads, metas, state, index: int):
        payloads, state = self._batch_body([reads], [metas], state, index)
        return payloads[0], state

    def step(self, reads, metas, state, index: int):
        """Frame `index`'s step over the fixed buffers (inputs uploaded,
        params staged): -> ([(sink, layout, device pieces)], the carried
        state).  Eager on a key's first frame and without `graphs`; else
        the key's graph, captured on its second frame."""
        self._check_sinks()
        state = self._load_state(state)
        key = self._key(reads, metas, _tree_key(state))

        def body():
            return self._body(reads, metas, state, index)

        if key not in self._entries:  # the key's first frame: eager
            self._entries[key] = None
            while len(self._entries) > self.MAX_GRAPHS:
                self._entries.popitem(last=False)
            self.eager += 1
            return body()
        self._entries.move_to_end(key)
        if not self.graphs:
            self.eager += 1
            return body()
        entry = self._entries[key]
        if entry is None:  # the second frame: capture, then replay
            entry = self._entries[key] = self._capture(body, self.device,
                                                       index)
            self.captures += 1
        else:
            entry.count()
        entry.graph.replay()
        self.replays += 1
        return entry.result

    # -- the batch step -------------------------------------------------------

    def _batch_body(self, rows, metas, state, index: int):
        """n frames' bodies over the fixed rows of a batch of n, the state
        threaded through them and written back once; -> ([each frame's
        payloads], the carried state)."""
        pieces = self._rows[len(rows)][1]
        prm = self.param_rows(self.device, len(rows))
        out = []
        for j, (reads, meta) in enumerate(zip(rows, metas)):
            key = self._key(reads, meta, _tree_key(state))
            inputs = {name: dict(from_host_layout(
                pieces[name][j], self._layouts[name].spec), **{META: m})
                for name, m in meta.items()}
            planes, state = self.pipe.step_sources(
                inputs, state, prm.params(j, reads), index)
            out.append(self.pipe._payloads(planes, index))
            self._learn(key, state)
        return out, self._state.back(state)

    def step_batch(self, rows, metas, state, index: int):
        """A batch's steps (inputs in `batch_inputs(n)`, params staged by
        `stage_batch`), `index` its first frame's: -> ([each frame's
        [(sink, layout, device pieces)]], the carried state).  One replay
        of the batch key's graph; eager while a frame key is unknown and
        without `graphs`."""
        self._check_sinks()
        state = self._load_state(state)
        keys = self._frame_keys(
            lambda j, sk: self._key(rows[j], metas[j], sk), len(rows),
            _tree_key(state))
        return self._run_batch(
            None if keys is None else ("batch", len(rows), keys),
            lambda: self._batch_body(rows, metas, state, index),
            self.device, len(rows), index)

    def _run_batch(self, key, body, device, frames: int, index: int):
        """`body` (`frames` frames): eager while `key` is None and without
        `graphs`, else `key`'s graph, captured at its first use, then
        replayed; -> what the body returns."""
        if key is None or not self.graphs:
            self.eager += frames
            return body()
        entry = self._batches.get(key)
        if entry is None:
            entry = self._capture(body, device, index)
            self.batch_captures += 1
            self._batches[key] = entry
            while len(self._batches) > self.MAX_BATCH_GRAPHS:
                self._batches.popitem(last=False)
        else:
            self._batches.move_to_end(key)
            entry.count()
        entry.graph.replay()
        self.batch_replays += 1
        return entry.result

    # -- the mesh -------------------------------------------------------------

    def shard(self, lay, d: int, plan: Dict) -> "ShardStep":
        """Dp shard `d` of mesh layout `lay`, its bands' builds `plan`
        (`Pipeline._shard_plan`)."""
        key = (lay.key, d, plan["devices"])
        if key not in self._shards:
            self._shards[key] = ShardStep(self, key, plan)
        return self._shards[key]

    # -- the capture ----------------------------------------------------------

    def _capture(self, body, device, index: int) -> _Entry:
        """Capture `body` as a CUDA graph on a side stream of `device` (not
        run: its replay runs it).  A failure raises PipelineError naming
        the element whose op broke the capture, else "<pipeline>", at
        frame `index`.  The capture is begun and ended by hand, so a
        capture that fails still restores the current stream."""
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        failed = None
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        # as torch.cuda.graph does: dead objects (another pipeline's graphs,
        # events, pinned buffers) are freed now, and the collector stays off
        # during the capture, where such a free invalidates it
        gc.collect()
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        try:
            with torch.cuda.device(device), \
                    torch.cuda.stream(self._streams[device]):
                graph.capture_begin()
                try:
                    result = body()
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
        launches = {w: w.launches - b for w, b in zip(counters, before)
                    if w.launches != b}
        return _Entry(graph, result, launches)


class ShardStep:
    """One dp shard of a mesh layout over fixed buffers (module doc): its
    sub-batch's input rows on its first card (`inputs`), its bands' state
    tiles; the param rows are the compiled step's, one set a card.  Its
    frame keys add the layout's key and the shard's cards to a frame's;
    its graph key adds the shard itself, its frames' rows and the batch's
    size (the param rows it reads).  Graphs and counters are the compiled
    step's."""

    def __init__(self, compiled: CompiledStep, key: tuple, plan: Dict):
        self.compiled = compiled
        self.pipe = compiled.pipe
        self.key = key  # (layout key, shard, its cards)
        self.plan = plan
        self.devices = plan["devices"]
        self.device = self.devices[0]
        # one card holds the whole capture; several gather across cards
        self.one_card = len(set(self.devices)) == 1
        self._rows: Dict[int, tuple] = {}  # m -> _input_rows
        self._state = _Carry()

    def inputs(self, m: int) -> Dict[str, torch.Tensor]:
        """The fixed inputs of a sub-batch of m frames on the shard's first
        card: {source name: (m, nbytes)}."""
        if m not in self._rows:
            self._rows[m] = _input_rows(self.compiled._layouts,
                                        self.device, m)
        return self._rows[m][0]

    def _frame_key(self, reads, metas, state_key) -> tuple:
        return (self.key[0], self.devices) + self.compiled._key(
            reads, metas, state_key)

    def _body(self, frames, metas, rows, params, state, index: int):
        c, pipe, devs = self.compiled, self.pipe, self.devices
        pieces = self._rows[len(frames)][1]
        out = []
        for i, j in enumerate(frames):
            key = self._frame_key(rows[j][devs[0]], metas[j],
                                  _tree_key(state))
            inputs = {name: pipe._source_bands(
                name, from_host_layout(pieces[name][i],
                                       c._layouts[name].spec), m, devs)
                for name, m in metas[j].items()}
            planes, state = pipe._step_bands(
                self.plan, inputs, state,
                [params[dev].params(j, rows[j][dev]) for dev in devs], index)
            with on_device(devs[0]):
                out.append(pipe._payloads(planes, index + j))
            c._learn(key, state)
        return out, self._state.back(state)

    def step(self, frames, metas, rows, params, state, index: int):
        """The shard's frames (`frames`: their places in the batch, whose
        first frame is `index`; inputs uploaded into `inputs(len(frames))`,
        `params` {card: the batch's `_ParamRows`}; `metas` and `rows` the
        batch's, `rows` {card: reads} a frame) through `_step_bands` over
        the fixed buffers: -> ([each frame's payloads], the carried band
        states).  One replay of the shard key's graph where its bands lie
        on one card; eager while a frame key is unknown, without `graphs`
        and across cards."""
        c = self.compiled
        c._check_sinks()
        state = self._state.load(state)
        keys = c._frame_keys(
            lambda i, sk: self._frame_key(rows[frames[i]][self.device],
                                          metas[frames[i]], sk),
            len(frames), _tree_key(state))
        n = next(iter(params.values())).n
        key = (None if keys is None or not self.one_card
               else ("shard",) + self.key + (tuple(frames), n, keys))
        return c._run_batch(
            key, lambda: self._body(frames, metas, rows, params, state,
                                    index),
            self.device, len(frames), index)
