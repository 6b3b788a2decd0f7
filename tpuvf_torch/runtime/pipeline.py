"""Pipeline graph: negotiation, build, frame loop (port of
``tpuvf.runtime.pipeline`` without its TPU link-layout plans).

- **Negotiation** happens once: FrameSpecs propagate in topological order
  from the sources through each element's `transform_spec` rule,
  constrained by per-link caps filters.  An aggregator (vfcompositor) names
  its unnamed request pads ``sink_%u`` in link order and negotiates its
  output from every pad's spec.
- **Build** plans every non-passthrough element for one ``torch.device``:
  tap tables, masks and coordinate fields move to the device once, and each
  element contributes a ``process(planes, state, params)`` function (an
  aggregator a ``process(pad_inputs, state, params)``).
- **Passthrough elision**: elements reporting `is_passthrough` are dropped
  from the graph's step.
- **Step**: the built stages run over the DAG eagerly on the device.
  Per-source buffer metadata (``"__meta__"`` in a source's input dict)
  travels with the frame; a filter element gets it as
  ``params["__meta__"]`` (vfdeinterlace's per-buffer field order), an
  aggregator as ``params["__pad_meta__"][pad]``.
- **Run**: an output clock at the fastest branch tail's frame rate picks,
  for each output frame, every source's latest buffer whose pts is due
  (repeating or dropping as the rates differ; the GstVideoAggregator
  model).  Each picked host frame is uploaded once (through a pinned host
  buffer on a GPU) and split into canonical planes on the device, and reused
  while it stays picked.  tpuvf's one-frame overlap: frame i's step, each
  sink's ``device_payload`` (the host-layout permutation,
  ``core.frame.host_layout``; a vfvideosink's render) and the non-blocking
  copies into the sink's readback buffer (two a sink, pinned on a GPU,
  taken in turns) are enqueued before the run waits on frame i-1's event
  and hands frame i-1 to its sinks (a sink that keeps its frames,
  ``KEEPS_PAYLOAD``, gets a copy), through each sink's host codec chain
  (pngenc, jpegenc, y4menc, which run on the host between their branch's
  tail and its sink).
- **Tee**: a tee's branches read the same device planes; with more than one
  sink the step returns ``{sink name: planes}`` and every sink gets its own
  host payload.

- **Overlay folds**: a vfoverlay that follows a vfcompositor with an RGB
  output (through passthrough elements) becomes a final mix draw of the
  compositor's fold, and its own stage a passthrough (tpuvf's
  ``_plan_overlay_folds``).
- **Rebuilds** keep each element's carried state whose structure and
  tensor shapes still match (tpuvf's rule), so a property write that
  rebuilds does not restart a grain counter or drop a previous frame.
- **Per-frame params and controllers**: before every frame `run` syncs the
  controlled properties (`Element.control`) to the output clock's frame
  index, rebuilds if a write changed the structure, and re-reads every
  element's traced values, staging the scalars on the device only when one
  changed (`runtime/staging.py`), and each compositor's draw table
  (its prepare pass on the host).  `run_batched` enqueues a batch as one
  step, its params staged as one (n, k) block; `run_live` paces `run` on
  the output clock and drops late ticks.
- **The compiled step** (`runtime/compiled.py`): `run` and `run_live`
  run each frame's step over fixed buffers, on the card as one replay of
  a CUDA graph captured once per key (tpuvf's one jitted program per
  variant); `run_batched` runs a batch's n steps as one graph (tpuvf's
  one program a batch, a ``lax.scan``), and on a mesh each dp shard's
  sub-batch, its bands included, as one graph on its card (each shard's
  local scan inside tpuvf's ``shard_map``).  `step`/`step_sources` and a
  shard whose bands lie on several cards run eagerly.  A fault the fused
  step cannot name is located by re-running the frame (a batch's first)
  eagerly on fresh state (`_locate_failure`).
- **Navigation**: a vfvideosink's pointer events route upstream through
  the compositors' hit tests to the source (`_wire_navigation`).

- **dp/sp sharding** (``run_batched(mesh=..., sp_axis=...)``, tpuvf's
  ``tpuvf/parallel/``): a batch's frames split over the mesh's dp shards,
  each with its own carried state, and each frame's rows over its sp bands,
  the stages run in lock-step over the bands (``parallel/``).  Branches that
  feed a compositor's pads run replicated, full rows on every band
  (`_sp_plan`).  Bitwise equal to the unsharded run.

The device is explicit: ``Pipeline(device="cuda")`` raises when CUDA is not
available; nothing falls back to the CPU.  On the CPU the same loop runs
with ordinary host buffers and no events.  tpuvf's split/quad/grid link
layouts are not ported, nor its sp pad plan, which serves only them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuvf_torch.core.element import Element, SinkElement, SourceElement
from tpuvf_torch.core.frame import HostLayout, from_host_layout
from tpuvf_torch.core.spec import CapsFilter, FrameSpec
from tpuvf_torch.elements.compositor import DRAW_TABLE
from tpuvf_torch.parallel import bands as pbands
from tpuvf_torch.parallel import mesh as pmesh
from tpuvf_torch.runtime.compiled import CompiledStep
from tpuvf_torch.runtime.device import get_device, on_device
from tpuvf_torch.runtime.observability import (  # noqa: F401 - re-exported
    PipelineError,
    PipelineStats,
    get_logger,
    trace,
)
from tpuvf_torch.runtime.staging import ParamStager, read_params

META = "__meta__"
_log = get_logger("pipeline")


@dataclass
class Link:
    upstream: Element
    downstream: Element
    caps: Optional[CapsFilter] = None
    sink_pad: Optional[str] = None  # for aggregator request pads
    spec: Optional[FrameSpec] = None  # filled by negotiate()


@dataclass
class Stage:
    element: Element
    in_spec: Optional[FrameSpec]  # None for an aggregator
    out_spec: FrameSpec
    passthrough: bool
    process: Optional[callable] = None


def _strip_meta(planes: Dict) -> Dict:
    return {k: v for k, v in planes.items() if k != META}


def _fans_out(element) -> bool:
    return getattr(element, "FAN_OUT", False)


def _is_codec(element) -> bool:
    return getattr(element, "HOST_CODEC", False)


def _is_aggregator(element) -> bool:
    from tpuvf_torch.elements.compositor import Compositor  # circular-safe

    return isinstance(element, Compositor)


def same_layout(old, new) -> bool:
    """Whether carried state `old` can stand in for a fresh `new`: the same
    nesting (dict keys, tuple and list lengths) and every leaf's shape the
    same (a tensor's, or () for a Python number), as tpuvf compares its
    state pytrees (``tpuvf/runtime/pipeline.py:311-327``)."""
    if isinstance(new, dict) or isinstance(old, dict):
        return (isinstance(new, dict) and isinstance(old, dict)
                and old.keys() == new.keys()
                and all(same_layout(old[k], new[k]) for k in new))
    if isinstance(new, (tuple, list)) or isinstance(old, (tuple, list)):
        return (type(old) is type(new) and len(old) == len(new)
                and all(same_layout(a, b) for a, b in zip(old, new)))
    if old is None or new is None:
        return old is None and new is None
    return tuple(getattr(old, "shape", ())) == tuple(getattr(new, "shape", ()))


class Pipeline:
    def __init__(self, device="cuda"):
        self.device = get_device(device)
        self.elements: List[Element] = []
        self.links: List[Link] = []
        self._by_name: Dict[str, Element] = {}
        self.stages: List[Stage] = []
        self.state: Optional[Dict] = None
        self._negotiated = False
        self._built_signature = None
        self._codec_chain: Dict[str, List[Element]] = {}
        self._rings: Dict[str, List[torch.Tensor]] = {}
        self._stager = ParamStager(self.device)
        self.navigation_events: List[Dict] = []
        self.stats = PipelineStats()
        self._compiled_step: Optional[CompiledStep] = None
        self._reset_mesh()

    # Pipeline.run's totals (tpuvf's stats), readable and resettable here
    @property
    def frames(self) -> int:
        return self.stats.frames

    @frames.setter
    def frames(self, value: int) -> None:
        self.stats.frames = value

    @property
    def wall_seconds(self) -> float:
        return self.stats.wall_seconds

    @wall_seconds.setter
    def wall_seconds(self, value: float) -> None:
        self.stats.wall_seconds = value

    # -- construction ------------------------------------------------------

    def add(self, element: Element) -> Element:
        if element.name in self._by_name:
            raise ValueError(f"duplicate element name {element.name!r}")
        self.elements.append(element)
        self._by_name[element.name] = element
        return element

    def link(self, upstream, downstream, caps=None, sink_pad=None) -> Link:
        ln = Link(upstream, downstream, caps, sink_pad)
        self.links.append(ln)
        return ln

    def rename(self, element: Element, name: str) -> None:
        if name in self._by_name and self._by_name[name] is not element:
            raise ValueError(f"duplicate element name {name!r}")
        self._by_name.pop(element.name, None)
        element.name = name
        self._by_name[name] = element

    def __getitem__(self, name: str) -> Element:
        return self._by_name[name]

    # -- graph helpers -----------------------------------------------------

    def _incoming(self, element) -> List[Link]:
        return [ln for ln in self.links if ln.downstream is element]

    def _outgoing(self, element) -> List[Link]:
        return [ln for ln in self.links if ln.upstream is element]

    @property
    def sources(self) -> List[SourceElement]:
        return [e for e in self.elements if isinstance(e, SourceElement)]

    @property
    def sinks(self) -> List[SinkElement]:
        return [e for e in self.elements if isinstance(e, SinkElement)]

    def _topo_order(self) -> List[Element]:
        indeg = {id(e): len(self._incoming(e)) for e in self.elements}
        ready = [e for e in self.elements if indeg[id(e)] == 0]
        order = []
        while ready:
            e = ready.pop(0)
            order.append(e)
            for ln in self._outgoing(e):
                indeg[id(ln.downstream)] -= 1
                if indeg[id(ln.downstream)] == 0:
                    ready.append(ln.downstream)
        if len(order) != len(self.elements):
            raise ValueError("pipeline graph has a cycle or dangling link")
        return order

    # -- negotiation -------------------------------------------------------

    def negotiate(self) -> None:
        """Link rules, then FrameSpecs in topological order (tpuvf's
        ``negotiate``, ``tpuvf/runtime/pipeline.py:162-240``): a source's
        src pad links once, a tee takes one input and feeds at least one
        branch, every branch of a tee carries its input spec (a branch caps
        filter that rejects it is an error: tee never converts)."""
        if not self.sources:
            raise ValueError("pipeline has no source")
        for e in self.elements:
            ins, outs = self._incoming(e), self._outgoing(e)
            if isinstance(e, SourceElement):
                if ins:
                    raise ValueError(f"source {e.name} has inputs")
                if len(outs) > 1:
                    raise ValueError(
                        f"source {e.name} has {len(outs)} downstream links; "
                        f"a src pad links once — use a tee to fan out")
            elif isinstance(e, SinkElement):
                if len(ins) != 1 or outs:
                    raise ValueError(f"sink {e.name} needs exactly 1 input "
                                     f"and no outputs")
            elif _is_aggregator(e):
                if not ins or len(outs) != 1:
                    raise ValueError(f"{e.name} needs at least one input and "
                                     f"exactly one output")
            elif _fans_out(e):
                if len(ins) != 1 or not outs:
                    raise ValueError(
                        f"tee {e.name} needs exactly one input and at "
                        f"least one output branch")
            elif len(ins) != 1 or len(outs) != 1:
                raise ValueError(f"element {e.name} must have exactly one "
                                 f"input and one output")
        for e in self._topo_order():
            outs = self._outgoing(e)
            if isinstance(e, SourceElement):
                spec = e.output_spec(outs[0].caps if outs else None)
            elif isinstance(e, SinkElement):
                e.prepare(self._incoming(e)[0].spec)
                continue
            elif _is_aggregator(e):
                # unnamed request pads take sink_%u names in link order
                ins = self._incoming(e)
                used = {ln.sink_pad for ln in ins if ln.sink_pad}
                next_idx = 0
                for ln in ins:
                    if ln.sink_pad is None:
                        while f"sink_{next_idx}" in used:
                            next_idx += 1
                        ln.sink_pad = f"sink_{next_idx}"
                        used.add(ln.sink_pad)
                    e.get_pad(ln.sink_pad)  # ensure the pad bag exists
                spec = e.aggregate_spec({ln.sink_pad: ln.spec for ln in ins},
                                        outs[0].caps)
            elif _fans_out(e):
                spec = self._incoming(e)[0].spec
                for ln in outs:
                    if ln.caps is not None and not ln.caps.accepts(spec):
                        raise ValueError(
                            f"tee {e.name}: branch caps {ln.caps} reject "
                            f"the stream spec {spec} (tee cannot convert; "
                            f"put a convertscale on the branch)")
            else:
                spec = e.transform_spec(self._incoming(e)[0].spec,
                                        outs[0].caps)
            for ln in outs:
                ln.spec = spec
        self._negotiated = True

    # -- build -------------------------------------------------------------

    def _static_signature(self):
        """Per-element static config + passthrough decisions: a property
        write that changes either needs a rebuild."""
        sig = []
        for st in self.stages:
            e = st.element
            sig.append((e.name, e.static_config(st.in_spec, st.out_spec),
                        e.is_passthrough(st.in_spec, st.out_spec)))
        return tuple(sig)

    def _plan_overlay_folds(self) -> Dict[str, List[Element]]:
        """{compositor name: [vfoverlay, ...]} for each ``vfcompositor !
        (passthroughs) ! vfoverlay`` chain whose overlay rect blends run as
        final mix draws of the compositor's fold (port of tpuvf's
        ``_plan_overlay_folds``, ``tpuvf/runtime/pipeline.py:541-606``,
        without its link layouts).  The compositor has one outgoing link
        and an RGB output (for a YUV output the separate overlay mixes after
        the YUV round trip: other values); the walk goes through
        passthrough elements and foldable overlays (image loaded, same
        format and size in and out) and stops at anything else, an overlay
        that cannot fold included."""
        from tpuvf_torch.core.formats import RGB_FORMATS
        from tpuvf_torch.elements.overlay import Overlay

        folds: Dict[str, List[Element]] = {}
        for e in self.elements:
            outs = self._outgoing(e)
            if (not _is_aggregator(e) or len(outs) != 1
                    or outs[0].spec.format not in RGB_FORMATS):
                continue
            chain, node = [], outs[0].downstream
            while True:
                ins, nouts = self._incoming(node), self._outgoing(node)
                if len(ins) != 1 or len(nouts) != 1:
                    break
                i_s, o_s = ins[0].spec, nouts[0].spec
                if isinstance(node, Overlay):
                    if not node.fold_into_aggregate_ok(i_s, o_s):
                        break
                    chain.append(node)
                elif (_is_codec(node)
                        or isinstance(node, (SourceElement, SinkElement))
                        or not node.is_passthrough(i_s, o_s)):
                    break
                node = nouts[0].downstream
            if chain:
                folds[e.name] = chain
        return folds

    def build(self) -> None:
        t0 = time.perf_counter()
        if not self._negotiated:
            self.negotiate()
        stages: List[Stage] = []
        state: Dict[str, object] = {}
        folds = self._plan_overlay_folds()
        folded = {id(ov) for chain in folds.values() for ov in chain}
        for e in self._topo_order():
            if isinstance(e, (SourceElement, SinkElement)):
                continue
            out_spec = self._outgoing(e)[0].spec
            if _is_aggregator(e):
                pad_specs = {ln.sink_pad: ln.spec for ln in sorted(
                    self._incoming(e), key=lambda ln: ln.sink_pad)}
                process = e.make_aggregate(
                    pad_specs, out_spec, self.device,
                    fold_overlays=tuple(folds.get(e.name, ())))
                stages.append(Stage(e, None, out_spec, False, process))
                state[e.name] = e.init_state(None, out_spec, self.device)
                continue
            in_spec = self._incoming(e)[0].spec
            if (id(e) in folded or _is_codec(e)
                    or e.is_passthrough(in_spec, out_spec)):
                # a folded overlay blends inside the compositor's fold; a
                # host codec encodes at its sink's edge
                stages.append(Stage(e, in_spec, out_spec, True))
                continue
            process = e.make_process(
                in_spec, out_spec, e.static_config(in_spec, out_spec),
                self.device)
            stages.append(Stage(e, in_spec, out_spec, False, process))
            state[e.name] = e.init_state(in_spec, out_spec, self.device)
        # a rebuild keeps carried state that still fits (a grain counter, a
        # previous frame), on the device where it lies
        for name, old in (self.state or {}).items():
            if name in state and same_layout(old, state[name]):
                state[name] = old
        self.stages = stages
        self.state = state
        self._folds = folds
        # the sp plan (tpuvf computes it at build): aggregator-feeding
        # branches run replicated under sp; per-shard state and band builds
        # are this build's
        self._sp_replicated, self._sp_rep_sources, self._sp_graph_ok = \
            self._sp_plan()
        self._reset_mesh()
        self._compiled_step = None  # its graphs are the old build's
        self._built_signature = self._static_signature()
        self._codec_chain = self._collect_codec_chain()
        for sink in self.sinks:
            if self._codec_chain[sink.name] and not sink.HOST_PAYLOAD:
                raise ValueError(
                    f"{sink.name} renders device planes; a host codec "
                    f"cannot precede it")
        if self.device.type == "cuda":
            from tpuvf_torch.kernels import _build

            _build.load()  # the first-use kernel build counts as build time
        self.stats = PipelineStats(
            compile_seconds=time.perf_counter() - t0,
            per_element_active={st.element.name: not st.passthrough
                                for st in stages})
        self._wire_navigation()

    def _wire_navigation(self) -> None:
        """Route navigation events from the vfvideosink upstream (tpuvf's
        ``_wire_navigation``, ``tpuvf/runtime/pipeline.py:607-664``): the
        sink maps window coordinates into video space; a compositor on the
        way hit-tests its pads (`Compositor.navigation_event`), rescales
        into the hit pad's input and goes on up that branch; an element
        that resizes rescales the coordinates (the videoscale src-event
        convention).  The routed event, with the source's name, lands in
        `navigation_events` and reaches the source's
        ``navigation_callback`` if it has one; a pointer over no pad stops
        at the compositor."""
        from tpuvf_torch.elements.videosink import VideoSink

        self.navigation_events = []
        sink = next((s for s in self.sinks if isinstance(s, VideoSink)), None)
        if sink is None:
            return

        def route(ev: Dict) -> None:
            node = self._incoming(sink)[0].upstream
            x, y = ev["pointer_x"], ev["pointer_y"]
            while not isinstance(node, SourceElement):
                ins = self._incoming(node)
                if _is_aggregator(node):
                    hit = node.navigation_event(
                        x, y, {ln.sink_pad: ln.spec for ln in ins})
                    if hit is None:
                        return  # no pad under the pointer
                    pad, x, y = hit
                    node = next(ln.upstream for ln in ins
                                if ln.sink_pad == pad)
                    continue
                if not ins:
                    break
                outs = self._outgoing(node)
                if outs and outs[0].spec is not None:
                    i_s, o_s = ins[0].spec, outs[0].spec
                    if (i_s.width, i_s.height) != (o_s.width, o_s.height):
                        x = x * i_s.width / o_s.width
                        y = y * i_s.height / o_s.height
                node = ins[0].upstream
            routed = dict(ev, pointer_x=x, pointer_y=y, source=node.name)
            self.navigation_events.append(routed)
            callback = getattr(node, "navigation_callback", None)
            if callback is not None:
                callback(routed)

        sink.navigation_callback = route

    def _collect_codec_chain(self) -> Dict[str, List[Element]]:
        """{sink name: host codecs} at each sink edge, upstream order (port
        of tpuvf's ``_collect_codec_chain``, ``tpuvf/runtime/pipeline.py:
        666-703``): the walk up from a sink goes through passthrough
        elements (so ``pngenc ! queue ! filesink`` encodes) and stops at a
        tee (a codec upstream of a fan-out would encode every branch).  A
        codec no sink reaches this way would write unencoded bytes, so the
        graph is rejected instead."""
        passthrough = {id(st.element) for st in self.stages if st.passthrough}
        chains: Dict[str, List[Element]] = {}
        reachable: set = set()
        for sink in self.sinks:
            codecs: List[Element] = []
            node = self._incoming(sink)[0].upstream
            while node is not None and not _fans_out(node):
                if _is_codec(node):
                    codecs.append(node)
                elif id(node) not in passthrough:
                    break
                ins = self._incoming(node)
                node = ins[0].upstream if ins else None
            codecs.reverse()
            chains[sink.name] = codecs
            reachable.update(id(c) for c in codecs)
        stray = [e.name for e in self.elements
                 if _is_codec(e) and id(e) not in reachable]
        if stray:
            raise ValueError(
                f"host-codec element(s) {stray} must form a contiguous chain "
                f"directly upstream of a sink (only passthrough elements "
                f"in between)")
        return chains

    # -- dp/sp sharding: the sp plan and its gate ---------------------------

    def _sp_plan(self):
        """tpuvf's ``_sp_plan`` (``tpuvf/runtime/pipeline.py:500-537``):
        under sp row sharding the branches FEEDING aggregator pads run
        replicated (every band computes the whole pad: a pad's draw offset
        crosses band edges anywhere), while the aggregator and everything
        downstream shard rows.  -> (replicated element names, replicated
        source names, ok); ok is False when a node feeds both a replicated
        branch and a sharded consumer."""
        comps = [e for e in self.elements if _is_aggregator(e)]
        if not comps:
            return set(), set(), True
        replicated: set = set()
        stack = [ln.upstream for c in comps for ln in self._incoming(c)]
        while stack:
            n = stack.pop()
            if n.name in replicated:
                continue
            replicated.add(n.name)
            stack.extend(ln.upstream for ln in self._incoming(n))
        ok = all(ln.downstream.name in replicated
                 or _is_aggregator(ln.downstream)
                 for e in self.elements if e.name in replicated
                 for ln in self._outgoing(e))
        rep_sources = {s.name for s in self.sources if s.name in replicated}
        return replicated, rep_sources, ok

    def _validate_sp(self, mesh, sp_axis: str) -> None:
        """tpuvf's ``_validate_sp`` for builds with no phase links
        (``tpuvf/runtime/pipeline.py:1638-1712``, granularity 1): the axis
        is in the mesh, the graph can shard, every active stage outside the
        replicated branches is `sp_row_shardable`, and every sharded plane
        height splits into even rows per band, at least 4 (field parity,
        chroma half-rows, the 4:2:0 row-pair pack).  tpuvf's pad plan for
        misaligned phase links has nothing to align here."""
        if sp_axis not in mesh.axis_names:
            raise ValueError(
                f"sp_axis {sp_axis!r} not in mesh axes {mesh.axis_names}")
        sp = mesh.shape[sp_axis]
        if sp <= 1:
            return
        if not self._sp_graph_ok:
            raise ValueError(
                "graph cannot row-shard: a branch feeds both an aggregator "
                "pad (replicated under sp) and a sharded consumer; run "
                "with dp only")
        for st in self.stages:
            if st.passthrough or st.element.name in self._sp_replicated:
                continue  # replicated branches run unsharded
            e = st.element
            if not e.sp_row_shardable(st.in_spec, st.out_spec):
                raise ValueError(
                    f"element {e.name} ({e.ELEMENT_NAME}) does not support "
                    f"spatial row sharding for its negotiated specs "
                    f"{st.in_spec} -> {st.out_spec}; run with dp only")
        for h in self._sp_heights():
            rows = h // sp
            if h % sp or rows % 2 or rows < 4:
                raise ValueError(
                    f"plane height {h} cannot split over sp={sp}: needs "
                    f"h % sp == 0 with even rows/shard >= 4 (field parity, "
                    f"chroma half-rows and the 4-row blur halo)")

    def _sp_heights(self) -> List[int]:
        """Heights of the planes that shard under sp: the active stages'
        outside the replicated branches, and the non-replicated sources'
        (tpuvf's ``_sp_heights``)."""
        heights = []
        for st in self.stages:
            if st.passthrough or st.element.name in self._sp_replicated:
                continue
            if st.in_spec is not None:
                heights.append(st.in_spec.height)
            heights.append(st.out_spec.height)
        for s in self.sources:
            if s.name not in self._sp_rep_sources:
                heights.append(self._source_spec(s).height)
        return heights

    # -- execution ---------------------------------------------------------

    def params(self) -> Dict[str, Dict]:
        """This frame's params of every active element (tpuvf's
        ``_frame_params``): the traced values re-read, the scalars as 0-dim
        views of one device vector staged again only when one changed
        (`runtime/staging.py`); values such as the compositor's pad
        geometry (host numbers) as the element hands them over."""
        return self._stager.frame(read_params(self._active(), self.device))

    def _source_spec(self, source: SourceElement) -> FrameSpec:
        return self._outgoing(source)[0].spec

    @property
    def compiled(self) -> CompiledStep:
        """The compiled step of this build (made at its first use; a
        rebuild or `reset` drops it with its graphs)."""
        if self._built_signature is None:
            self.build()
        if self._compiled_step is None:
            self._compiled_step = CompiledStep(self)
        return self._compiled_step

    def _table_layout(self) -> list:
        """[(aggregator stage, offset, size)] of the compositors' draw
        tables in one flat buffer, in stage order."""
        out, offset = [], 0
        for st in self.stages:
            if st.in_spec is None and not st.passthrough:
                out.append((st, offset, st.process.table_size))
                offset += st.process.table_size
        return out

    def _pad_meta(self, metas: Dict) -> Dict[str, Dict]:
        """{aggregator name: {pad: buffer flags}} from {source name:
        flags}, as the flags travel in `step_sources`: through every
        one-input element, not through an aggregator."""
        out = {}
        for st, _, _ in self._table_layout():
            pads = out[st.element.name] = {}
            for ln in self._incoming(st.element):
                node = ln.upstream
                while not isinstance(node, SourceElement) and not \
                        _is_aggregator(node):
                    node = self._incoming(node)[0].upstream
                pads[ln.sink_pad] = (metas.get(node.name)
                                     if isinstance(node, SourceElement)
                                     else None)
        return out

    def _frame_tables(self, reads, metas):
        """A frame's draw tables (the compositors' prepare passes on
        their host values and their pads' flags), back to back as
        `_table_layout` lays them out; None without a compositor."""
        layout = self._table_layout()
        if not layout:
            return None
        pad_meta = self._pad_meta(metas)
        flat = np.empty(sum(n for _, _, n in layout), np.int32)
        for st, offset, n in layout:
            name = st.element.name
            st.process.draw_table(reads[name][1], pad_meta[name],
                                  out=flat[offset:offset + n])
        return flat

    def upload(self, host_frame) -> Dict[str, torch.Tensor]:
        """The only source's host frame -> canonical device planes."""
        if len(self.sources) != 1:
            raise ValueError(f"{len(self.sources)} sources: use "
                             f"upload_sources")
        return self.upload_sources({self.sources[0].name: host_frame})[
            self.sources[0].name]

    def upload_sources(self, host_frames: Dict) -> Dict[str, Dict]:
        """{source name: host frame} -> {source name: device planes}: one
        host copy into a fresh buffer (pinned on a GPU), one non-blocking
        copy to the device, the split into canonical planes there."""
        out = {}
        for name, frame in host_frames.items():
            spec = self._source_spec(self[name])
            out[name] = from_host_layout(
                HostLayout(spec).upload(frame, self.device), spec)
        return out

    def step(self, planes: Dict, state: Dict, params: Dict,
             frame_index: int = 0):
        """Run the built stages on the only source's device planes:
        -> (tail planes, state).  Launches work on the device and returns
        without waiting for it."""
        if len(self.sources) != 1:
            raise ValueError(f"{len(self.sources)} sources: use step_sources")
        return self.step_sources({self.sources[0].name: planes}, state,
                                 params, frame_index)

    def step_sources(self, inputs: Dict[str, Dict], state: Dict,
                     params: Dict, frame_index: int = 0):
        """Run the built stages over the DAG on {source name: device planes,
        optionally with ``"__meta__"``}: -> (tail planes, state), the tail
        planes as ``{sink name: planes}`` when there is more than one sink.
        A stage's failure raises PipelineError naming the element and
        `frame_index` (Pipeline.run passes its loop's index).  A
        compositor's draw table, when `params` holds none, is computed
        from its params and its pads' buffer flags and staged here."""
        produced: Dict[int, Dict] = {}

        def value_of(elem) -> Dict:
            if isinstance(elem, SourceElement):
                return inputs[elem.name]
            return produced[id(elem)]

        new_state = dict(state)
        for st in self.stages:
            e = st.element
            ins = self._incoming(e)
            if st.passthrough:
                produced[id(e)] = value_of(ins[0].upstream)
                continue
            try:
                if st.in_spec is None:  # aggregator: one input per pad
                    pad_inputs, pad_meta = {}, {}
                    for ln in ins:
                        v = value_of(ln.upstream)
                        pad_meta[ln.sink_pad] = v.get(META)
                        pad_inputs[ln.sink_pad] = _strip_meta(v)
                    prm = dict(params.get(e.name, {}))
                    prm["__pad_meta__"] = pad_meta
                    if DRAW_TABLE not in prm:  # the prepare pass, staged
                        prm[DRAW_TABLE] = self._stager.table(
                            st.process.draw_table(prm, pad_meta))
                    out, new_state[e.name] = st.process(
                        pad_inputs, state.get(e.name, ()), prm)
                else:
                    src = value_of(ins[0].upstream)
                    meta = src.get(META)
                    prm = params.get(e.name, {})
                    if meta is not None:  # the buffer's flags reach the filter
                        prm = dict(prm, **{META: meta})
                    out, new_state[e.name] = st.process(
                        _strip_meta(src), state.get(e.name, ()), prm)
                    if meta is not None:
                        out = dict(out, **{META: meta})  # flags travel
            except Exception as exc:
                raise PipelineError(e.name, frame_index, exc) from exc
            produced[id(e)] = out
        sinks = self.sinks
        if len(sinks) > 1:
            return {sk.name: _strip_meta(value_of(
                        self._incoming(sk)[0].upstream))
                    for sk in sinks}, new_state
        if sinks:
            tail = value_of(self._incoming(sinks[0])[0].upstream)
        elif self.stages:
            tail = value_of(self.stages[-1].element)
        else:
            tail = inputs[self.sources[0].name]
        return _strip_meta(tail), new_state

    # -- output clock + per-source buffer selection -------------------------

    def _clock(self):
        """Output timeline rate (the aggregator's srcpad clock: the
        negotiated tail spec's fps, max input fps for a compositor; with
        several sinks the fastest branch tail's) plus per-source timing
        info."""
        if self.sinks:
            tail_spec = max((self._incoming(s)[0].spec for s in self.sinks),
                            key=lambda sp: float(sp.fps))
        elif self.stages:
            tail_spec = self.stages[-1].out_spec
        else:
            tail_spec = self._source_spec(self.sources[0])
        out_fps = float(tail_spec.fps) or 25.0
        infos = []
        for s in self.sources:
            spec = self._source_spec(s)
            infos.append((s, spec, float(spec.fps) or out_fps,
                          s.timestamp_offset(), s.num_frames()))
        return out_fps, infos

    @staticmethod
    def _clock_num_frames(out_fps, infos, num_frames):
        """Output frame count: the stream runs until ALL sources are past
        their last buffer (aggregator EOS semantics), capped by the
        caller."""
        ends = []
        for _, _, fps, off, n in infos:
            if n is None:
                ends = None  # unbounded source: the caller must bound the run
                break
            ends.append(off + n / fps)
        computed = None
        if ends:
            computed = max(1, int(math.ceil(max(ends) * out_fps - 1e-6)))
        if num_frames is None:
            if computed is None:
                raise ValueError("unbounded pipeline: pass num_frames or "
                                 "set num-buffers on the source")
            return computed
        return min(num_frames, computed) if computed is not None else num_frames

    @staticmethod
    def _select_buffers(k, out_fps, infos):
        """Timestamp-driven buffer selection for output frame k: each source
        contributes its latest buffer with pts <= the output deadline.
        -> {source name: (buffer index, meta dict of host numbers)}."""
        deadline = k / out_fps + 1e-9
        sel = {}
        for s, spec, fps, off, n in infos:
            j = int(math.floor((deadline - off) * fps))
            if (n is not None and j >= n
                    and s.buffer_pts(n - 1, spec) + 1.0 / fps > deadline):
                # custom pts later than the frame rate implies: the last
                # buffer is not due or not over yet, so the stream has not
                # ended (tpuvf marks it ended here, showing a buffer before
                # its pts); with default pts this never holds
                j = n - 1
            # refine for sources with custom (monotonic) per-buffer pts
            limit = n if n is not None else j + 2
            while j + 1 < limit and s.buffer_pts(j + 1, spec) <= deadline:
                j += 1
            while j >= 0 and s.buffer_pts(j, spec) > deadline:
                j -= 1
            started = j >= 0
            ended = n is not None and j >= n
            gen_j = min(max(j, 0), n - 1) if n is not None else max(j, 0)
            flags = s.buffer_meta(gen_j, spec)
            sel[s.name] = (gen_j, {
                "pts": s.buffer_pts(gen_j, spec),
                "tff": 1 if flags.get("tff", True) else 0,
                # started: the stream has produced its first buffer;
                # eos: past the last buffer (held = frozen last frame)
                "active": 1.0 if started else 0.0,
                "eos": 1.0 if ended else 0.0,
            })
        return sel

    # -- per-frame params, controllers, rebuilds ------------------------------

    def _active(self) -> List[Element]:
        return [st.element for st in self.stages if not st.passthrough]

    def _controlled(self) -> List[Element]:
        return [e for e in self.elements if e._controllers]

    def _maybe_rebuild(self) -> bool:
        """Rebuild when a property write changed an element's static config
        or passthrough state (tpuvf's ``_maybe_rebuild``); the build keeps
        the carried state that still fits."""
        if (self._built_signature is not None
                and self._static_signature() == self._built_signature):
            return False
        _log.info("static property change -> rebuilding pipeline")
        self.build()
        return True

    @staticmethod
    def _structure(st: Stage):
        if st.in_spec is None:  # an aggregator's plan is its build's
            return None, False
        e = st.element
        return (e.static_config(st.in_spec, st.out_spec),
                e.is_passthrough(st.in_spec, st.out_spec))

    def _ctl_structure(self) -> Dict[str, tuple]:
        """Static config and passthrough state of every controlled element:
        `run_batched` keeps one structure per call (tpuvf's
        ``_ctl_structure``, ``tpuvf/runtime/pipeline.py:744-760``)."""
        return {st.element.name: self._structure(st) for st in self.stages
                if st.element._controllers}

    def _ctl_sync(self, frame: int, structure) -> None:
        """Sync the controlled elements to `frame` and check that their
        structure is still the call's (tpuvf's ``_ctl_frame_params``)."""
        for st in self.stages:
            el = st.element
            if not el._controllers:
                continue
            el.sync_frame(frame)
            if self._structure(st) != structure.get(el.name):
                raise ValueError(
                    f"controlled property schedule on {el.name!r} changes "
                    f"pipeline structure at frame {frame} (static config "
                    f"or passthrough flips) — run_batched keeps one "
                    f"structure per call; use run() for structural "
                    f"animation, or split the schedule across calls")

    def reset(self) -> None:
        """The PAUSED->READY analog (tpuvf's ``reset``,
        ``tpuvf/runtime/pipeline.py:1347-1369``): drop the stages, the
        built signature, the carried state (vfdeinterlace's previous frame,
        vfvideofilter's grain counter), the codec chains, the readback
        buffers, the staged params, the compiled step and the negotiation,
        so the next run starts fresh."""
        self.stages = []
        self._built_signature = None
        self.state = None
        self._codec_chain = {}
        self._rings = {}
        self._stager = ParamStager(self.device)
        self._compiled_step = None
        self._reset_mesh()
        self._negotiated = False

    def _reset_mesh(self) -> None:
        """Drop the mesh runs' per-shard state, band builds and stagers."""
        self._mesh_state = None  # (layout key, [shard][band] states)
        self._band_builds: Dict[tuple, Dict] = {}
        self._mesh_stagers: Dict[torch.device, ParamStager] = {}

    # -- frame loops --------------------------------------------------------

    def latency(self):
        """(min, max) latency in seconds, the GstAggregator latency-query
        analog (tpuvf's ``latency``): 0 (nothing is buffered ahead of the
        clock) and one output period (a live run emits or drops each tick
        within one)."""
        out_fps, _ = self._clock()
        return 0.0, 1.0 / out_fps

    def _paced_indices(self, num_frames, out_fps, time_fn, sleep_fn):
        """Live pacing on the output clock (tpuvf's ``_paced_indices``,
        ``tpuvf/runtime/pipeline.py:1451-1484``): frame 0 is the preroll,
        unpaced (the first-use kernel build spends no tick); then frame k is
        due at t0 + k/out_fps.  Early: sleep until it is due.  Late by a
        full tick or more: the missed ticks are dropped
        (`stats.frames_dropped`) and the loop goes on at the newest due
        frame."""
        if num_frames <= 0:
            return
        yield 0
        t0 = time_fn()  # frame 0 presented now; frame k due at t0 + k/fps
        k = 1
        while k < num_frames:
            due = int((time_fn() - t0) * out_fps)
            if due > k:
                skipped = min(due, num_frames) - k
                self.stats.frames_dropped += skipped
                _log.debug("live QoS: dropping %d late frame(s) at tick %d",
                           skipped, k)
                k += skipped
                if k >= num_frames:
                    return
            deadline = t0 + k / out_fps
            now = time_fn()
            if now < deadline:
                sleep_fn(deadline - now)
            yield k
            k += 1

    def run_live(self, num_frames: Optional[int] = None, *, time_fn=None,
                 sleep_fn=None) -> int:
        """`run` paced on the output clock (`_paced_indices`): late ticks
        are dropped into `stats.frames_dropped`; `time_fn` and `sleep_fn`
        (default: time.perf_counter, time.sleep) can be injected.  With the
        one-frame overlap the frame due at tick k is enqueued at tick k and
        handed to its sinks at the next tick, after frame k+1's work is
        enqueued: tpuvf's order, which consumes frame i-1 once frame i is
        dispatched."""
        return self._run(num_frames, (time_fn or time.perf_counter,
                                      sleep_fn or time.sleep))

    def run(self, num_frames: Optional[int] = None) -> int:
        """Frame loop with tpuvf's one-frame overlap (``tpuvf/runtime/
        pipeline.py:1496-1636``).  Per frame i: sync the controlled
        properties to i and rebuild if a property write changed the
        structure (carried state kept, upload cache cleared); re-read the
        params; upload frame i's new host buffers; enqueue the step, each
        sink's host-layout permutation (or render) and the copies to the
        host, record an event; only then wait on frame i-1's event and hand
        frame i-1 to its sinks.  So a property written while frame i-1 is
        delivered takes effect at frame i+1, as in tpuvf.  A step failure
        first delivers the pending frame (best effort; the original error
        wins); a sink failure reports the frame it was consuming.  Every
        sink is finalized at the end of a run that did not fail."""
        return self._run(num_frames)

    def _run(self, num_frames: Optional[int], pace=None) -> int:
        if self._built_signature is None:
            self.build()
        out_fps, infos = self._clock()
        num_frames = self._clock_num_frames(out_fps, infos, num_frames)
        # schedules index the output frame on the clock, the k that picks
        # the sources' buffers
        controlled = self._controlled()
        indices = (range(num_frames) if pace is None
                   else self._paced_indices(num_frames, out_fps, *pace))
        state = self.state
        compiled = self.compiled
        uploaded = {}  # source name -> buffer index in its fixed input
        pending = []  # frame i-1's readback, delivered after frame i's step
        count = 0
        edge = self.stats.edge_seconds
        t_run = time.perf_counter()
        for i in indices:
            with trace("tpuvf_torch.params", edge, i):
                for el in controlled:
                    el.sync_frame(i)
                self.state = state  # a rebuild merges the current carry
                if self._maybe_rebuild():
                    state = self.state
                    compiled = self.compiled
                    uploaded.clear()
            try:
                with trace("tpuvf_torch.params", edge, i):
                    selection = self._select_buffers(i, out_fps, infos)
                    reads = read_params(self._active(), self.device)
                    metas = {name: meta
                             for name, (_, meta) in selection.items()}
                    compiled.stage(reads, metas)
                    retry = self._eager_retry(selection, reads)
                with trace("tpuvf_torch.upload", edge, i):
                    for name, (j, _) in selection.items():
                        if uploaded.get(name) != j:  # a repeat keeps its bytes
                            src = self[name]
                            with trace("tpuvf_torch.upload.source", edge, i):
                                host = src.generate(j, self._source_spec(src))
                            compiled.upload(name, host, i)
                            uploaded[name] = j
                with trace("tpuvf_torch.enqueue", edge, i):
                    payloads, state = self._step_or_locate(
                        lambda: compiled.step(reads, metas, state, i), i,
                        retry)
                self.state = state
                # slots in turns by frames run, not by index: a live run
                # skips indices
                with trace("tpuvf_torch.readback", edge, i):
                    readback = self._readback(payloads, i, count % 2, retry)
            except Exception:
                self._flush_pending(pending)
                raise
            pending = self._hand_over(pending, [readback])
            count += 1
        return self._end_run(count, t_run, pending)

    def _step_or_locate(self, step, index: int, retry):
        """`step()`, a compiled step; a fault that names no element (a
        replay's) is located by the eager re-run `retry`
        (`_locate_failure`) and raised at frame `index`."""
        try:
            return step()
        except PipelineError:
            raise
        except Exception as exc:
            raise self._locate_failure(index, exc, retry) from exc

    def _eager_retry(self, selection, reads):
        """A frame's eager re-run on fresh state, for `_locate_failure`:
        its buffers generated and uploaded anew (the fixed inputs hold a
        later frame by the time a fault surfaces), its params staged from
        its host reads."""

        def retry():
            inputs = {}
            for name, (j, meta) in selection.items():
                src = self[name]
                host = src.generate(j, self._source_spec(src))
                inputs[name] = dict(self.upload_sources({name: host})[name],
                                    **{META: meta})
            params = ParamStager(self.device).frame(reads)
            self.step_sources(inputs, self._fresh_state(), params)

        return retry

    def _fresh_state(self) -> Dict:
        return {st.element.name: st.element.init_state(
                    st.in_spec, st.out_spec, self.device)
                for st in self.stages if not st.passthrough}

    def _locate_failure(self, index: int, exc: Exception,
                        retry) -> PipelineError:
        """tpuvf's ``_locate_failure`` (``tpuvf/runtime/pipeline.py:
        1873-1891``): a fault of the compiled step names no stage, so the
        frame is re-run eagerly on fresh state; the element whose op fails
        there is named, else "<pipeline>".  Best effort: a fault that
        leaves the card unusable fails the re-run's first op."""
        if retry is not None:
            try:
                retry()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            except PipelineError as located:
                return PipelineError(located.element, index, exc)
            except Exception:  # noqa: BLE001 - not reproduced: unnamed
                pass
        return PipelineError("<pipeline>", index, exc)

    def _hand_over(self, pending, readbacks) -> list:
        """The loops' common end of a frame (`run`) or a batch
        (`run_batched`), once its readbacks are enqueued: hand the frames
        enqueued one frame or batch earlier to their sinks (`_deliver`,
        whose spans ``tpuvf_torch.wait`` and ``tpuvf_torch.consume`` add to
        `stats.edge_seconds` as the loops' spans before it do).  ->
        `readbacks`, the new pending frames."""
        for rb in pending:
            self._deliver(*rb)
        return readbacks

    def _end_run(self, count: int, t_run: float, pending) -> int:
        """Deliver the last pending frames, wait for the device, count the
        run and finalize every sink."""
        for rb in pending:
            self._deliver(*rb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.frames += count
        self.stats.wall_seconds += time.perf_counter() - t_run
        _log.info("run complete: %s", self.stats.summary())
        for sink in self.sinks:
            sink.finalize()
        return count

    def run_batched(self, num_frames: int, batch_size: int = 8, mesh=None,
                    sp_axis: Optional[str] = None,
                    independent_streams: bool = False) -> int:
        """Throughput mode (tpuvf's ``run_batched``, ``tpuvf/runtime/
        pipeline.py:1916-2198``): `batch_size` frames a batch, enqueued as
        one step with no host wait.

        On entry the controlled elements are synced to frame 0 and a
        property write since the last build rebuilds; the structure then
        stays for the call, and a schedule that changes it raises at the
        first frame where it does.  Per batch: each frame's buffers picked
        on the output clock and uploaded into its row of the compiled
        step's fixed inputs for a batch of n, with one host copy and one
        non-blocking copy per source; every frame's params re-read after
        its controllers' sync and staged into the fixed (n, k) scalar and
        (n, T) draw-table rows, one copy each, each frame reading its row;
        then the batch's n steps as one step (`CompiledStep.step_batch`:
        on the card one replay of the batch key's CUDA graph, once each
        frame key has run eagerly) and each frame's readback into buffers
        of the batch's own (two sets a sink, taken in turns per batch), one
        event a frame.  Batch b-1 is handed to the sinks while batch b
        computes.  The carried state runs through the frames in order,
        across batches and calls, and is `run`'s.  A step failure raises
        PipelineError at the batch's first frame index, as tpuvf's one
        dispatch a batch does (a replay's fault located by the first
        frame's eager re-run); a sink failure names its frame.

        With `mesh` (``parallel.mesh.make_mesh``, a 'dp' axis required),
        each batch splits over the dp shards, shard d taking the frames
        ``[d*b/dp, (d+1)*b/dp)`` (`batch_size` a multiple of dp), each shard
        carrying its own state across batches and calls (`_mesh_state`,
        resumed by the next call on a mesh of the same axes; a dp=1 run
        publishes it to `state`).  A stateful element whose output depends
        on its history refuses dp > 1 unless `independent_streams` says the
        shards are independent streams.  With `sp_axis` naming a mesh axis
        of size > 1, each frame's rows split into bands over it and the
        stages run in lock-step over the bands (`_step_bands`), after
        `_validate_sp`; the bands are joined before the sinks.  Each
        shard's sub-batch is one step (`CompiledStep.shard`): one graph
        replay on its card where its bands lie on one card, eager where
        they lie on several.  Bitwise equal to the run without a mesh.
        `sp_axis` without a mesh, and `independent_streams` without one,
        have no effect, as in tpuvf."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if self._built_signature is None:
            self.build()
        controlled = self._controlled()
        for el in controlled:
            el.sync_frame(0)
        self._maybe_rebuild()
        lay = None
        if mesh is not None:
            lay = self._mesh_layout(mesh, sp_axis, batch_size,
                                    independent_streams)
        out_fps, infos = self._clock()
        num_frames = self._clock_num_frames(out_fps, infos, num_frames)
        structure = self._ctl_structure()
        if lay is not None:
            return self._run_mesh(lay, num_frames, batch_size, out_fps,
                                  infos, structure)
        state = self.state
        compiled = self.compiled
        pending: List[tuple] = []
        done = batch = 0
        edge = self.stats.edge_seconds
        t_run = time.perf_counter()
        while done < num_frames:
            n = min(batch_size, num_frames - done)
            try:
                with trace("tpuvf_torch.params", edge, done):
                    rows = []
                    for j in range(n):
                        self._ctl_sync(done + j, structure)
                        rows.append(read_params(self._active(), self.device))
                    selections = [self._select_buffers(done + j, out_fps,
                                                       infos)
                                  for j in range(n)]
                    metas = [{name: meta for name, (_, meta) in sel.items()}
                             for sel in selections]
                    compiled.stage_batch(rows, metas)
                    retries = [self._eager_retry(sel, r)
                               for sel, r in zip(selections, rows)]
                with trace("tpuvf_torch.upload", edge, done):
                    self._upload_rows(selections, compiled.batch_inputs(n),
                                      done)
                with trace("tpuvf_torch.enqueue", edge, done):
                    outs, state = self._step_or_locate(
                        lambda: compiled.step_batch(rows, metas, state, done),
                        done, retries[0])
                self.state = state
                with trace("tpuvf_torch.readback", edge, done):
                    readbacks = [self._readback(
                        outs[j], done + j, (batch % 2) * batch_size + j,
                        retries[j]) for j in range(n)]
            except Exception:
                self._flush_pending(pending)
                raise
            pending = self._hand_over(pending, readbacks)
            done += n
            batch += 1
        return self._end_run(done, t_run, pending)

    # -- the mesh path (dp/sp) ------------------------------------------------

    def _mesh_layout(self, mesh, sp_axis, batch_size: int,
                     independent_streams: bool) -> pmesh.Layout:
        """tpuvf's checks of a mesh run, in its order
        (``tpuvf/runtime/pipeline.py:1965-1994``), -> the runner's layout."""
        if "dp" not in mesh.shape:
            raise ValueError(
                f"mesh {dict(mesh.shape)} has no 'dp' axis — build it "
                f"with {{'dp': 1, ...}} for sp-only sharding")
        dp = mesh.shape["dp"]
        if batch_size % dp != 0:
            raise ValueError(f"batch_size {batch_size} must divide by dp={dp}")
        if dp > 1 and not independent_streams:
            # each dp shard carries its own history: splitting ONE stream
            # across shards would rewrite it for a stateful element
            unsafe = [st.element.name for st in self.stages
                      if not st.passthrough and st.in_spec is not None
                      and not st.element.dp_shard_safe(st.in_spec,
                                                       st.out_spec)]
            if unsafe:
                raise ValueError(
                    f"element(s) {unsafe} carry cross-frame state whose "
                    f"output changes when ONE stream is batch-split across "
                    f"dp={dp} shards (each shard sees its own history).  "
                    f"Pass independent_streams=True if the dp shards map to "
                    f"independent streams, or run with dp=1")
        if sp_axis is not None:
            self._validate_sp(mesh, sp_axis)
        return pmesh.layout(mesh, sp_axis)

    def _shard_plan(self, devices: tuple) -> Dict:
        """The band builds of one dp shard whose bands lie on `devices`
        (cached per build): {"devices", "process": {element: [process per
        band]}, "bands": {element: [Band] or None}}.  A replicated branch's
        element (and every element without sp) runs its frame's process on
        each band's device; a sharded one its band build
        (`Element.make_process(..., band=)`, `Compositor.make_aggregate(
        ..., band=)`) over `bands.plan_bands`' windows."""
        plan = self._band_builds.get(devices)
        if plan is not None:
            return plan
        sp = len(devices)
        plan = {"devices": devices, "process": {}, "bands": {}}
        for st in self.stages:
            if st.passthrough:
                continue
            e = st.element
            banded = sp > 1 and e.name not in self._sp_replicated
            if st.in_spec is None:
                pad_specs = {ln.sink_pad: ln.spec for ln in sorted(
                    self._incoming(e), key=lambda ln: ln.sink_pad)}
                folds = tuple(self._folds.get(e.name, ()))
                out_rows = st.out_spec.height
                band_list = (pbands.plan_bands(out_rows, out_rows, sp, 0)
                             if banded else None)

                def make(dev, band, e=e, pad_specs=pad_specs, folds=folds,
                         st=st):
                    return e.make_aggregate(pad_specs, st.out_spec, dev,
                                            fold_overlays=folds, band=band)
            else:
                band_list = (pbands.plan_bands(
                    st.out_spec.height, st.in_spec.height, sp,
                    e.band_reach(st.in_spec, st.out_spec))
                    if banded else None)

                def make(dev, band, e=e, st=st):
                    return e.make_process(
                        st.in_spec, st.out_spec,
                        e.static_config(st.in_spec, st.out_spec), dev,
                        band=band)
            if band_list is None:
                # the frame's process, one build a device
                built = {self.device: st.process}
                for dev in devices:
                    if dev not in built:
                        built[dev] = make(dev, None)
                procs = [built[dev] for dev in devices]
            else:
                procs = [make(dev, b) for dev, b in zip(devices, band_list)]
            plan["process"][e.name] = procs
            plan["bands"][e.name] = band_list
        self._band_builds[devices] = plan
        return plan

    def _source_bands(self, name: str, planes: Dict, meta, devices) -> list:
        """A source's uploaded frame -> its planes per band: the band's
        rows (`bands.split_rows`), or the whole frame on every band's
        device for a replicated source (one feeding a compositor pad)."""
        if len(devices) == 1:
            per_band = [planes]
        elif name in self._sp_rep_sources:
            per_band = [{k: v.to(dev) for k, v in planes.items()}
                        for dev in devices]
        else:
            split = {k: pbands.split_rows(v, devices)
                     for k, v in planes.items()}
            per_band = [{k: split[k][s] for k in planes}
                        for s in range(len(devices))]
        return [dict(p, **{META: meta}) for p in per_band]

    def _step_bands(self, plan: Dict, inputs: Dict[str, list], states: list,
                    params: list, frame_index: int):
        """`step_sources` over one dp shard's bands, stage by stage: every
        band finishes a stage before any band starts the next.  `inputs`
        holds each source's planes per band (`_source_bands`), `states` and
        `params` one dict a band.  A banded stage is handed its input
        window (`Band.in_lo`..`in_hi` of every plane and of every
        plane-shaped state leaf, gathered from the bands that hold those
        rows); a replicated stage (or any stage without sp) its band's
        whole planes, and bands on one device share its one run.  -> (the
        tail's planes per band, or {sink name: planes per band}; new states
        per band)."""
        devices = plan["devices"]
        produced: Dict[int, list] = {}

        def value_of(elem) -> list:
            if isinstance(elem, SourceElement):
                return inputs[elem.name]
            return produced[id(elem)]

        new = [dict(st) for st in states]
        for st in self.stages:
            e = st.element
            ins = self._incoming(e)
            if st.passthrough:
                produced[id(e)] = value_of(ins[0].upstream)
                continue
            band_list = plan["bands"][e.name]
            outs: list = []
            try:
                for s, dev in enumerate(devices):
                    if band_list is None and dev in devices[:s]:
                        # same device, same whole planes: one run serves
                        t = devices.index(dev)
                        outs.append(outs[t])
                        new[s][e.name] = new[t][e.name]
                        continue
                    with on_device(dev):
                        out, new[s][e.name] = self._band_stage(
                            st, [value_of(ln.upstream) for ln in ins], s,
                            plan, states, params[s])
                    outs.append(out)
            except Exception as exc:
                raise PipelineError(e.name, frame_index, exc) from exc
            produced[id(e)] = outs

        def joined(per_band: list) -> Dict:
            if len(per_band) == 1:
                return _strip_meta(per_band[0])
            return {k: pbands.all_rows([b[k] for b in per_band], devices[0])
                    for k in per_band[0] if k != META}

        sinks = self.sinks
        if len(sinks) > 1:
            return {sk.name: joined(value_of(self._incoming(sk)[0].upstream))
                    for sk in sinks}, new
        if sinks:
            tail = value_of(self._incoming(sinks[0])[0].upstream)
        elif self.stages:
            tail = value_of(self.stages[-1].element)
        else:
            tail = inputs[self.sources[0].name]
        return joined(tail), new

    def _band_stage(self, st: Stage, upstream: list, s: int, plan: Dict,
                    states: list, params: Dict):
        """Stage `st` on band `s` of a shard (`_step_bands`): `upstream`
        holds each input link's planes per band -> (output planes, state)."""
        e = st.element
        dev = plan["devices"][s]
        process = plan["process"][e.name][s]
        band_list = plan["bands"][e.name]
        if st.in_spec is None:  # aggregator: every pad whole
            pad_inputs, pad_meta = {}, {}
            for ln, per_band in zip(self._incoming(e), upstream):
                pad_meta[ln.sink_pad] = per_band[s].get(META)
                pad_inputs[ln.sink_pad] = _strip_meta(per_band[s])
            prm = dict(params.get(e.name, {}))
            prm["__pad_meta__"] = pad_meta
            return process(pad_inputs, states[s].get(e.name, ()), prm)
        src = upstream[0]
        meta = src[s].get(META)
        if band_list is None:
            planes = _strip_meta(src[s])
            state = states[s].get(e.name, ())
        else:
            band = band_list[s]
            planes = {}
            for k in src[0]:
                if k == META:
                    continue
                pieces = [b[k] for b in src]
                lo, hi = pbands.plane_rows(
                    band.in_lo, band.in_hi,
                    pieces[0].shape[-2] * len(pieces), band.in_height)
                planes[k] = pbands.window(pieces, lo, hi, dev)
            state = pmesh.state_window([b.get(e.name, ()) for b in states],
                                       band, dev)
        prm = params.get(e.name, {})
        if meta is not None:
            prm = dict(prm, **{META: meta})
        out, state = process(planes, state, prm)
        if meta is not None:
            out = dict(out, **{META: meta})  # flags travel
        return out, state

    def load_mesh_state(self, mesh, sp_axis: Optional[str],
                        shard_states: List[Dict]) -> None:
        """Resume the next ``run_batched(mesh=mesh, sp_axis=sp_axis)`` from
        one whole-frame state per dp shard (``runtime.params.from_tpuvf``
        of tpuvf's tiled ``_mesh_state`` with ``tiled=True``): each shard's
        state is cut into its bands as a run would carry it."""
        if self._built_signature is None:
            self.build()
        lay = pmesh.layout(mesh, sp_axis)
        if len(shard_states) != lay.dp:
            raise ValueError(f"{len(shard_states)} shard states for "
                             f"dp={lay.dp}")
        replicated = self._sp_replicated if lay.sp > 1 else frozenset()
        tiles = [pmesh.tile_state(st, lay, replicated)[d]
                 for d, st in enumerate(shard_states)]
        self._mesh_state = (lay.key, tiles)

    def _run_mesh(self, lay: pmesh.Layout, num_frames: int, batch_size: int,
                  out_fps, infos, structure) -> int:
        """`run_batched`'s loop on a mesh layout (see its docstring): per
        batch, every frame's params re-read after its controllers' sync and
        staged on each mesh card (`CompiledStep.param_rows`: one (n, k) and
        one (n, T) copy a card, each shard's bands reading their frames'
        rows), each shard's frames uploaded to its fixed input rows on its
        first card, then each shard's sub-batch through `_step_bands` in
        one step (`CompiledStep.shard`, one graph replay where its bands
        lie on one card) and its readbacks from that card.  A replay's
        fault is located by the batch's first frame re-run eagerly on the
        pipeline's device."""
        replicated = self._sp_replicated if lay.sp > 1 else frozenset()
        compiled = self.compiled
        shards = [compiled.shard(lay, d, self._shard_plan(devs))
                  for d, devs in enumerate(lay.devices)]
        held = self._mesh_state
        if held is not None and held[0] == lay.key:
            states = held[1]
        else:
            states = pmesh.tile_state(self.state, lay, replicated)
        devices = list(dict.fromkeys(d for devs in lay.devices for d in devs))
        for dev in devices:
            self._mesh_stagers.setdefault(dev, ParamStager(dev))
        pending: List[tuple] = []
        done = batch = 0
        edge = self.stats.edge_seconds
        t_run = time.perf_counter()
        while done < num_frames:
            n = min(batch_size, num_frames - done)
            readbacks = []
            try:
                with trace("tpuvf_torch.params", edge, done):
                    rows = []
                    for j in range(n):
                        self._ctl_sync(done + j, structure)
                        rows.append({dev: read_params(self._active(), dev)
                                     for dev in devices})
                        if j == 0:  # the eager re-run's, on the pipeline's
                            first = read_params(self._active(), self.device)
                    selections = [self._select_buffers(done + j, out_fps,
                                                       infos)
                                  for j in range(n)]
                    metas = [{name: meta for name, (_, meta) in sel.items()}
                             for sel in selections]
                    tables = [self._frame_tables(rows[j][devices[0]],
                                                 metas[j]) for j in range(n)]
                    params = {}
                    for dev in devices:
                        params[dev] = compiled.param_rows(dev, n)
                        with on_device(dev):  # the stager's event on its card
                            params[dev].stage(self._mesh_stagers[dev],
                                              [r[dev] for r in rows], tables)
                    retry = self._eager_retry(selections[0], first)
                parts = pmesh.shard_frames(lay, batch_size, n)
                with trace("tpuvf_torch.upload", edge, done):
                    for d, frames in parts:
                        self._upload_rows([selections[j] for j in frames],
                                          shards[d].inputs(len(frames)), done)
                for d, frames in parts:
                    with on_device(lay.devices[d][0]):
                        with trace("tpuvf_torch.enqueue", edge, (done, d)):
                            outs, states[d] = self._step_or_locate(
                                lambda: shards[d].step(frames, metas, rows,
                                                       params, states[d],
                                                       done),
                                done, retry)
                        with trace("tpuvf_torch.readback", edge, (done, d)):
                            readbacks += [self._readback(
                                payloads, done + j,
                                (batch % 2) * batch_size + j)
                                for j, payloads in zip(frames, outs)]
            except Exception:
                self._flush_pending(pending)
                raise
            pending = self._hand_over(pending, readbacks)
            done += n
            batch += 1
        self._mesh_state = (lay.key, states)
        if lay.dp == 1:
            # one shard's state is the stream's: run() and a run without a
            # mesh go on from it
            self.state = pmesh.untile_state(states[0], self.device,
                                            replicated)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self._end_run(done, t_run, pending)

    def _upload_rows(self, selections, inputs: Dict[str, torch.Tensor],
                     index: int):
        """Each frame's picked buffers (`_select_buffers`, one a frame) ->
        its row of the fixed inputs `inputs` ({source name: (n, nbytes)
        device buffer}, a compiled step's): per source one host copy and
        one non-blocking copy (`HostLayout.upload_into`); a buffer that
        several frames pick is generated once (span
        ``tpuvf_torch.upload.source``).  `index`, the batch's first frame,
        rides in the spans' args."""
        edge = self.stats.edge_seconds
        for name, flat in inputs.items():
            src = self[name]
            spec = self._source_spec(src)
            hosts = {}
            with trace("tpuvf_torch.upload.source", edge, index):
                for sel in selections:
                    j = sel[name][0]
                    if j not in hosts:
                        hosts[j] = src.generate(j, spec)
            HostLayout(spec).upload_into(
                [hosts[sel[name][0]] for sel in selections], flat, edge,
                index)

    def _ring_buffer(self, sink, layout: HostLayout, slot: int):
        """Sink `sink`'s readback buffer `slot` (pinned on a GPU).  `run`
        takes slots 0 and 1 in turns, so frame i's copies never land in
        frame i-1's, which is being delivered, and a frame two later reuses
        one after it was delivered; `run_batched` takes two sets of
        batch_size slots, one set a batch in turns."""
        ring = self._rings.get(sink.name)
        if ring is None or ring[0].numel() != layout.nbytes:
            ring = self._rings[sink.name] = []
        pinned = self.device.type == "cuda"
        while len(ring) <= slot:
            ring.append(layout.buffer(pinned))
        return ring[slot]

    def _payloads(self, out, index: int) -> list:
        """Frame `index`'s step output -> [(sink, layout, device pieces)]:
        each sink's `device_payload` (the host-layout permutation, a
        vfvideosink's render), enqueued on the device."""
        sinks = self.sinks
        payloads = []
        for sink in sinks:
            planes = out[sink.name] if len(sinks) > 1 else out
            try:
                layout, pieces = sink.device_payload(
                    planes, self._incoming(sink)[0].spec)
            except Exception as exc:
                raise PipelineError(sink.name, index, exc) from exc
            payloads.append((sink, layout, pieces))
        return payloads

    def _readback(self, payloads, index: int, slot: int, retry=None):
        """`_payloads` -> (index, [(sink, layout, host buffer)], event,
        retry): the non-blocking copies into each sink's readback buffer
        `slot`, then one event recorded after them (None on the CPU);
        `retry` re-runs the frame eagerly should its wait fail.  The loops
        call it inside their span ``tpuvf_torch.readback``."""
        copies = []
        for sink, layout, pieces in payloads:
            try:
                copies.append((sink, layout, layout.readback(
                    pieces, self._ring_buffer(sink, layout, slot))))
            except Exception as exc:
                raise PipelineError(sink.name, index, exc) from exc
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return index, copies, event, retry

    def _deliver(self, index: int, copies, event, retry=None) -> None:
        """Wait on frame `index`'s event, then run each sink's host codec
        chain and `deliver` its payload (tpuvf's ``_consume_all``,
        ``tpuvf/runtime/pipeline.py:1893-1914``), naming the sink whose
        consume or codec failed.  A device fault that surfaces at the wait
        is located by the frame's eager re-run (`_locate_failure`), or
        names "<pipeline>".  Spans ``tpuvf_torch.wait`` (the event, empty
        on the CPU) and ``tpuvf_torch.consume``."""
        edge = self.stats.edge_seconds
        with trace("tpuvf_torch.wait", edge, index):
            if event is not None:
                try:
                    event.synchronize()
                except Exception as exc:
                    raise self._locate_failure(index, exc, retry) from exc
        with trace("tpuvf_torch.consume", edge, index):
            for sink, layout, flat in copies:
                try:
                    codecs = self._codec_chain.get(sink.name, ())
                    # the buffer is reused: a sink that keeps its frames
                    # gets arrays of its own (a codec makes new bytes)
                    payload = layout.payload(
                        flat, copy=sink.KEEPS_PAYLOAD and not codecs)
                    spec = layout.spec
                    for codec in codecs:
                        payload = codec.encode(payload, spec)
                    sink.deliver(payload, spec, index)
                except Exception as exc:
                    raise PipelineError(sink.name, index, exc) from exc

    def _flush_pending(self, pending) -> None:
        """Best-effort delivery of the deferred frames (the previous frame,
        or the previous batch) before a failure propagates: their steps
        already succeeded, so a filesink should not end short of the last
        good output.  Errors here are swallowed: the original failure
        wins."""
        try:
            for rb in pending:
                self._deliver(*rb)
        except Exception:  # noqa: BLE001 - the original failure wins
            pass
