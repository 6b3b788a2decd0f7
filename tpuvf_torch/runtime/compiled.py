"""The compiled step: a batch's or a dp shard's whole step over fixed
buffers, captured once per key as a CUDA graph and replayed; a frame of
`Pipeline.run` and `run_live` is a batch of one (the port of tpuvf's
``jax.jit(make_step(...), donate_argnums=(1,))``, its one program per
variant, ``_variant_step``/``_select_step``, its one program a batch,
``jax.jit(batch_step)`` over ``lax.scan``, the per-shard scan inside
``parallel_batch_fn``'s ``shard_map``, and ``_locate_failure``;
``tpuvf/runtime/pipeline.py:344-498``, ``:1847-1891``, ``:2012-2039``,
``tpuvf/parallel/mesh.py:74-192``).

A **batch's body** (`step_batch`, every frame loop but the mesh's) runs n
frames' bodies back to back, each `Pipeline.step_sources`' walk over the
DAG, on buffers that stay put from batch to batch:

- **inputs**: n fixed input rows a source (`batch_inputs`): each frame's
  host-layout bytes land in its row (`upload_rows`,
  ``HostLayout.upload_into``): a frame from a source's recurring frame pool,
  page-locked once by the pipeline's ``HostRegistry``, is copied straight
  from the source's arrays; any other through one host copy into a fresh
  pinned buffer and one non-blocking copy.  A source whose rows all hold
  their buffers already (the step records each row's buffer index,
  cleared at the start of every loop call, `forget_uploads`) is neither
  generated nor uploaded again.  On CUDA those copies run on a copy
  stream of the step's own, ordered by two events: the copy stream waits
  on `_inputs_free`, recorded on the compute stream right after the last
  step that read the fixed inputs (before its readback is enqueued, so an
  upload runs beside the previous batch's readback), and the compute
  stream waits on `_inputs_ready`, recorded after the copies, before the
  next step.  The split into canonical planes (``from_host_layout``) runs
  inside the body;
- **params**: the frames' staged scalars land in one fixed (n, k) float32
  block, and every compositor's draw table in one fixed (n, T) int32 block
  (``kernels/composite.py``), by one pinned non-blocking copy each, made
  outside the body on the compute stream and skipped while nothing changed
  (`stage_batch`, `_ParamRows`), frame j reading row j, so a ramp is data,
  not a key.  They are written in place: the steps on that stream read
  them in order;
- **state**: the carried state is read from fixed buffers, runs through
  the n frames inside the body (frame j+1 reads what frame j left) and is
  copied back into the fixed buffers once, at the end (``copy_``), so no
  state buffer aliases an input or an output (vfdeinterlace carries an RGB
  input's planes as its texture).  A state handed in that is not the fixed
  buffers (a rebuild's carry, a mesh run's, a caller's) is copied in first;
- **outputs**: each sink's ``device_payload`` (the host-layout permutation,
  a vfvideosink's render) runs inside the body; its pieces, n sets of them,
  are the graph's own buffers, which the caller copies to the host right
  after the replay.  On CUDA a piece that would be a view of the fixed
  inputs (a plane a chain passes on as it came in) is copied inside the
  body (`_unaliased`): its readback follows `_inputs_free`, so the next
  upload may already be writing those inputs.

On CUDA a key has two graphs over the same fixed inputs, params and
state, each with its own payloads: two output sets, which the batches take
in turns (`_turn`), each captured at its first use, so a batch's readback
runs on the step's readback stream (`reading_back`) beside the next
batch's replay.  Three events order
them: the readback stream waits on `_step_done`, recorded on the compute
stream right after the batch's step (where `_inputs_free` is), before it
copies the batch's payloads;
`_outputs_free` of the set is recorded on the readback stream after the
copies, and the compute stream waits on it before the set's next replay,
two batches later; each frame's event (``Pipeline._readback``) is recorded
on the readback stream.  The replays, and so the write-back of the state,
stay in order on the compute stream.  An eager batch's payloads come from
the caching allocator on the compute stream, so each piece is marked as
used on the readback stream (``record_stream``) before its copy.  The
frame loop waits on batch b's events, handing it to the sinks, before it
enqueues batch b+2, so its order alone keeps batch b's copies ahead of the
replay that writes their set again and of the reuse of their memory;
`_outputs_free` and ``record_stream`` keep the step right for a caller
that waits later.

A **dp shard's body** (`ShardStep`, `Pipeline.run_batched(mesh=...)`) is
the shard's sub-batch (``batch_size/dp`` frames) through
`Pipeline._step_bands`, its bands included, over the shard's own fixed
input rows on its first card (`ShardStep.upload_rows`: every row through a
host copy on the current stream, no copy stream, no registered memory),
each mesh card's (n, k)/(n, T) param rows and its per-band state tiles,
with the same write-back.  The shard is the one step that keeps one output
set and reads back on its current stream.  Its graph is captured on the
shard's first card and replayed on that card's current stream, so shards
on different cards run at once.  A shard whose bands lie on several
distinct cards gathers halo rows across cards, which one card's capture
cannot hold: such a shard runs its body eagerly every batch, and each of
its frames counts in `eager`.

On CUDA a body is captured as a ``torch.cuda.CUDAGraph`` on a side
stream of its card and replayed on the current stream; nothing is run by
the capture itself, its replay runs it.  Work done at first use (the
kernel library, the launchers' per-card attribute and occupancy caches,
a vfvideosink's render plan) may not happen during a capture, so every
frame key runs once eagerly first.  A batch graph's key is ``(n, the n
frame keys)``, a shard graph's adds the mesh layout's key, the shard and
its cards.  Each frame key there is its frame's with the state key the
previous frame's key leaves, learnt (`_after`) when that key last ran
eagerly.  A batch whose frame keys are all known is captured at once and
replayed; one with an unknown frame key runs eagerly and learns them.  So
a frame (a batch of one) is captured on its key's second sighting; a
16-frame call in batches of 8 runs batch 0 eagerly and captures batch 1,
greedy-H's included (its first batch carries ``has_prev=False`` on frame
0 and so has another key than its second); a call after `run` has seen
the chain's keys captures its first batch; a short tail (n < batch_size)
takes its own key, as tpuvf re-traces for a shorter tail.

Before a key's first capture, as ``torch.cuda.graph`` does, the cyclic
garbage collector runs and the allocator's cache is emptied, and the
collector stays off during every capture: a dead pipeline's graphs,
events or pinned buffers freed inside a capture would invalidate it.  A
key's other output set is captured at its own first use without them: on
a cold live run the collection and the emptied cache take most of the
first capture's tick, the set's capture a few milliseconds.  `graphs` is
False on the CPU, where every body runs eagerly over the same fixed
buffers, so the CPU tests exercise the buffers, the keys, the state
threading and write-back and the draw tables; only the capture needs the
card.  The reference runs of the card's checks set it False too.

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
private memory pool of the caching allocator: n frames' worth (n payload
sets), beside the n fixed input rows of its batch size; a key on CUDA has
two such graphs, its two output sets.  At most `MAX_GRAPHS` batch and
shard keys keep their graphs (the least recently used goes first): a
key's first capture costs a collection and an emptied cache (100-600 ms
on the card), so the limit leaves room for a full batch's and a tail's
key on each shard of a four-card mesh.

**Counters.**  `keys` (frame keys learnt), `batch_captures` and
`batch_replays` (keys captured, and replays of their graphs) and `eager`
(frames run without a graph) count the step's work; `captures` and
`replays` stay 0 (``vfbench/harness.py`` reads them by name).  Each
capture's wall time adds to ``PipelineStats.compile_seconds``.  A replay
runs no Python, so each key records the kernel launches a capture made
(each wrapper's ``launches``, n frames' worth), which stay counted for
the replay right after the capture, and adds them to the counters at
every other replay.  The frames read back on the readback stream add to
``PipelineStats.readback_async``.

**Failures.**  A capture that an element's op breaks raises
``PipelineError`` naming that element at its batch's first frame
(`Pipeline.step_sources` wraps each stage; a batch's frames carry the
batch's first index, as tpuvf's one dispatch a batch does); nothing then
runs the step eagerly in its place.  A fault that surfaces at a replay, or
at the wait on its event, names no stage: the pipeline re-runs the batch's
first frame eagerly on fresh state (`Pipeline._locate_failure`, tpuvf's
twin) and names the element whose op fails.  What stays eager:
`Pipeline.step`/`step_sources`, and the shards over several cards.
"""

from __future__ import annotations

import gc
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuvf_torch.core.frame import HostLayout, from_host_layout
from tpuvf_torch.elements.compositor import DRAW_TABLE
from tpuvf_torch.kernels import (composite, deinterlace, emit, lut, overlay,
                                 resample)
from tpuvf_torch.runtime.device import on_device
from tpuvf_torch.runtime.observability import PipelineError, trace
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


def _host_frames(pipe, name: str, buffers, index) -> list:
    """Source `name`'s host frames of `buffers` (buffer indices), a buffer
    that several rows take generated once (span
    ``tpuvf_torch.upload.source``, `index` in its args)."""
    src = pipe[name]
    spec = pipe._source_spec(src)
    hosts = {}
    with trace("tpuvf_torch.upload.source", pipe.stats.edge_seconds, index):
        for j in buffers:
            if j not in hosts:
                hosts[j] = src.generate(j, spec)
    return [hosts[j] for j in buffers]


def _unaliased(payloads, flats) -> list:
    """`_payloads` ([(sink, layout, pieces)]) with each piece that shares
    storage with one of `flats`, the fixed inputs, replaced by its copy: a
    plane a chain passes on as it came in (an I420 output, an NV12 output's
    Y plane, an elided chain) is read back after `_inputs_free`, by when the
    copy stream may be writing the next upload into the fixed inputs."""
    held = {flat.untyped_storage().data_ptr() for flat in flats}
    return [(sink, layout,
             [p.clone() if p.untyped_storage().data_ptr() in held else p
              for p in pieces])
            for sink, layout, pieces in payloads]


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
    """One key's captured graphs, each with what its capture's body
    returned (its outputs and the state it leaves: the graph's own
    buffers), as `sets` {output set: (graph, result)}: a batch key's two
    on CUDA, a shard key's one (module doc); and the launches a capture
    made."""

    def __init__(self):
        self.sets: Dict[int, tuple] = {}
        self.launches: Dict = {}

    def count(self) -> None:
        """A replay's launches -> the kernels' counters."""
        for wrapper, n in self.launches.items():
            wrapper.launches += n


class CompiledStep:
    """The steps of one build of `pipe` over fixed buffers on its devices
    (module doc): the frame loops step a batch, a frame being a batch of
    one, through `step_batch`, and on a mesh each dp shard's sub-batch
    through `shard`'s `ShardStep`.  `Pipeline.step`/`step_sources` stay
    eager.  At most `MAX_GRAPHS` batch and shard keys keep their graphs.
    With `graphs` False (the CPU) every body runs eagerly."""

    MAX_GRAPHS = 16  # a batch and a tail key a shard on 4 cards

    def __init__(self, pipe):
        self.pipe = pipe
        self.device = pipe.device
        self.graphs = self.device.type == "cuda"
        self.keys = self.captures = self.replays = self.eager = 0
        self.batch_captures = self.batch_replays = 0
        self._batches: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._after: Dict[tuple, tuple] = {}  # frame key -> state key after
        self._stager = ParamStager(self.device)
        self._layouts = {src.name: HostLayout(pipe._source_spec(src))
                         for src in pipe.sources}
        # the uploads' copy stream and its two events (module doc), CUDA only
        self._copy = self._inputs_free = self._inputs_ready = None
        if self.device.type == "cuda":
            self._copy = torch.cuda.Stream(self.device)
            self._inputs_free = torch.cuda.Event()
            self._inputs_ready = torch.cuda.Event()
        self._reads_source = False  # the last upload copied a source's own
        # the readback's stream and its events (module doc), CUDA only
        self._readback = self._step_done = None
        self._outputs_free = ()
        if self.device.type == "cuda":
            self._readback = torch.cuda.Stream(self.device)
            self._step_done = torch.cuda.Event()
            self._outputs_free = (torch.cuda.Event(), torch.cuda.Event())
        self._turn = 0  # the output set of the last batch
        self._eager_out = False  # the last batch's payloads are not a graph's
        self._rows: Dict[int, tuple] = {}  # n -> _input_rows
        # (n, source name) -> the buffer indices its n rows hold
        self._uploaded: Dict[tuple, list] = {}
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
            if self._copy is not None:  # freed only after its copies
                for flat in self._rows[n][0].values():
                    flat.record_stream(self._copy)
        return self._rows[n][0]

    def forget_uploads(self) -> None:
        """Forget which buffer each fixed input row holds: the next upload
        writes every row (a frame loop's call starts with this)."""
        self._uploaded.clear()

    def upload_rows(self, selections, index=None) -> None:
        """Each frame's picked buffers (``Pipeline._select_buffers``, one a
        frame) -> its row of `batch_inputs(n)`, after the copies the last
        upload read from a source's memory (`await_copies`).  A source
        whose rows all hold their buffers already is skipped; of any other
        every row's buffer is generated (`_host_frames`) and copied by one
        ``HostLayout.upload_into`` with the pipeline's ``HostRegistry``:
        on CUDA on the copy stream, after the last step that read the fixed
        inputs and before the next (module doc).  The frames copied
        straight from the source's memory and those filled add to the
        pipeline's `upload_direct` and `upload_filled`; the spans add to
        its `edge_seconds`, `index`, the batch's first frame, in their
        args."""
        self.await_copies()
        n = len(selections)
        for name, flat in self.batch_inputs(n).items():
            want = [sel[name][0] for sel in selections]
            if self._uploaded.get((n, name)) == want:
                continue
            self._upload(name, _host_frames(self.pipe, name, want, index),
                         flat, index)
            self._uploaded[(n, name)] = want

    def _upload(self, name: str, host_frames, out: torch.Tensor,
                index) -> None:
        """Source `name`'s host frames -> the rows `out` (`upload_rows`)."""
        stats = self.pipe.stats
        layout = self._layouts[name]
        if self._copy is None:
            direct = layout.upload_into(host_frames, out, stats.edge_seconds,
                                        index)
        else:
            self._copy.wait_event(self._inputs_free)
            with torch.cuda.stream(self._copy):
                direct = layout.upload_into(host_frames, out,
                                            stats.edge_seconds, index,
                                            self.pipe._host_memory)
            self._inputs_ready.record(self._copy)
            self._reads_source = self._reads_source or direct > 0
        stats.upload_direct += direct
        stats.upload_filled += len(host_frames) - direct

    def await_copies(self) -> None:
        """Wait until the copies read straight from a source's memory are
        done, so that the source may reuse that memory: `upload_rows` calls
        this before a source hands out its next frames.  By then the copies
        have mostly ended beside the previous readback."""
        if self._reads_source:
            self._inputs_ready.synchronize()
            self._reads_source = False

    def _over_inputs(self, run):
        """`run()`, a step that reads the fixed inputs -> its result, on
        the compute stream after the copy stream's last upload, and
        `_inputs_free` recorded right after it, before the caller enqueues
        the readback."""
        if self._copy is None:
            return run()
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self._inputs_ready)
        try:
            return run()
        finally:
            self._inputs_free.record(stream)

    # -- params ---------------------------------------------------------------

    def param_rows(self, device, n: int) -> _ParamRows:
        """The fixed param rows of a batch of n on `device`."""
        key = (torch.device(device), n)
        if key not in self._params_at:
            self._params_at[key] = _ParamRows(key[0], n, self._aggs)
        return self._params_at[key]

    def stage_batch(self, rows, metas, index=None) -> None:
        """A batch's scalars and draw tables, one frame a row -> the fixed
        rows of its size, one copy each (`_ParamRows.stage`); `index`, the
        first frame's, numbers the frames in the spans of their tables."""
        tables = [self.pipe._frame_tables(
            r, m, None if index is None else index + j)
            for j, (r, m) in enumerate(zip(rows, metas))]
        self.param_rows(self.device, len(rows)).stage(self._stager, rows,
                                                      tables)

    # -- keys -----------------------------------------------------------------

    def _payload_keys(self):
        return tuple(sink.payload_key() for sink in self.pipe.sinks)

    def _check_sinks(self) -> None:
        """A sink's render plan changed: its graphs and learnt keys go."""
        sink_keys = self._payload_keys()
        if sink_keys != self._sink_keys:
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

    # -- the step -------------------------------------------------------------

    def _batch_body(self, rows, metas, state, index: int):
        """n frames' bodies over the fixed rows of a batch of n, the state
        threaded through them and written back once; -> ([each frame's
        payloads], the carried state)."""
        flats, pieces = self._rows[len(rows)]
        prm = self.param_rows(self.device, len(rows))
        out = []
        for j, (reads, meta) in enumerate(zip(rows, metas)):
            key = self._key(reads, meta, _tree_key(state))
            inputs = {name: dict(from_host_layout(
                pieces[name][j], self._layouts[name].spec), **{META: m})
                for name, m in meta.items()}
            planes, state = self.pipe.step_sources(
                inputs, state, prm.params(j, reads), index)
            payloads = self.pipe._payloads(planes, index)
            if self._copy is not None:  # read back after `_inputs_free`
                payloads = _unaliased(payloads, flats.values())
            out.append(payloads)
            self._learn(key, state)
        return out, self._state.back(state)

    def step_batch(self, rows, metas, state, index: int):
        """A batch's steps (inputs uploaded by `upload_rows`, params staged
        by `stage_batch`), `index` its first frame's: -> ([each frame's
        [(sink, layout, device pieces)]], the carried state).  One replay
        of the batch key's graph; eager while a frame key is unknown and
        without `graphs`.  On CUDA the batches take the two output sets in
        turns, each replay after the readback of the set's last batch
        (`reading_back`, module doc)."""
        self._check_sinks()
        state = self._load_state(state)
        keys = self._frame_keys(
            lambda j, sk: self._key(rows[j], metas[j], sk), len(rows),
            _tree_key(state))
        key = None if keys is None else ("batch", len(rows), keys)
        self._eager_out = key is None or not self.graphs
        stream = None
        if self._readback is not None:
            self._turn = 1 - self._turn
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._outputs_free[self._turn])
        out = self._over_inputs(lambda: self._run_batch(
            key, lambda: self._batch_body(rows, metas, state, index),
            self.device, len(rows), index, self._turn))
        if stream is not None:
            self._step_done.record(stream)
        return out

    @contextmanager
    def reading_back(self, outs):
        """Enqueue inside the readback of `outs`, the last `step_batch`'s
        payloads: on CUDA on the readback stream, after `_step_done`, the
        pieces of an eager batch marked as used there, and the output set's
        `_outputs_free` recorded after the copies (module doc); the frames
        add to ``PipelineStats.readback_async``.  Elsewhere on the current
        stream."""
        if self._readback is None:
            yield
            return
        stream = self._readback
        stream.wait_event(self._step_done)
        if self._eager_out:
            for payloads in outs:
                for _, _, pieces in payloads:
                    for piece in pieces:
                        piece.record_stream(stream)
        with torch.cuda.stream(stream):
            yield
        self._outputs_free[self._turn].record(stream)
        self.pipe.stats.readback_async += len(outs)

    def _run_batch(self, key, body, device, frames: int, index: int,
                   turn: int = 0):
        """`body` (`frames` frames): eager while `key` is None and without
        `graphs`, else the graph of `key`'s output set `turn`, captured at
        the set's first use (the key's first capture after a collection),
        then replayed; -> what the body returns."""
        if key is None or not self.graphs:
            self.eager += frames
            return body()
        entry = self._batches.get(key) or _Entry()
        if turn in entry.sets:
            entry.count()
        else:
            entry.sets[turn] = self._capture(body, device, index, entry)
        if key in self._batches:
            self._batches.move_to_end(key)
        else:
            self.batch_captures += 1
            self._batches[key] = entry
            while len(self._batches) > self.MAX_GRAPHS:
                self._batches.popitem(last=False)
        graph, result = entry.sets[turn]
        graph.replay()
        self.batch_replays += 1
        return result

    # -- the mesh -------------------------------------------------------------

    def shard(self, lay, d: int, plan: Dict) -> "ShardStep":
        """Dp shard `d` of mesh layout `lay`, its bands' builds `plan`
        (`Pipeline._shard_plan`)."""
        key = (lay.key, d, plan["devices"])
        if key not in self._shards:
            self._shards[key] = ShardStep(self, key, plan)
        return self._shards[key]

    # -- the capture ----------------------------------------------------------

    def _capture(self, body, device, index: int, entry: _Entry) -> tuple:
        """Capture `body` as one of `entry`'s CUDA graphs on a side stream
        of `device` (not run: its replay runs it), after a synchronize and,
        before the key's first graph, a collection and an emptied cache;
        the collector stays off during the capture.  -> (graph, what the
        body returned); the capture's launches stay counted, for the replay
        that follows, and are `entry`'s.  A failure raises PipelineError
        naming the element whose op broke the capture, else "<pipeline>",
        at frame `index`.  The capture is begun and ended by hand, so a
        capture that fails still restores the current stream."""
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        failed = None
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        if not entry.sets:
            # as torch.cuda.graph does: dead objects (another pipeline's
            # graphs, events, pinned buffers) are freed now, and the
            # collector stays off during the capture, where such a free
            # invalidates it
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
        entry.launches = {w: w.launches - b for w, b in zip(counters, before)
                          if w.launches != b}
        return graph, result


class ShardStep:
    """One dp shard of a mesh layout over fixed buffers (module doc): its
    sub-batch's input rows on its first card (`inputs`, `upload_rows`),
    one output set read back on its current stream, its bands' state
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

    def upload_rows(self, selections, index=None) -> None:
        """Each of the shard's frames' picked buffers -> its row of
        `inputs(m)`, every row, per source one host copy and one
        non-blocking copy on the current stream (module doc); the frames
        add to the pipeline's `upload_filled`."""
        stats = self.pipe.stats
        for name, flat in self.inputs(len(selections)).items():
            frames = _host_frames(self.pipe, name,
                                  [sel[name][0] for sel in selections], index)
            self.compiled._layouts[name].upload_into(
                frames, flat, stats.edge_seconds, index)
            stats.upload_filled += len(frames)

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
