"""Pipeline graph: negotiation, build, frame loop (port of the linear-chain
part of ``tpuvf.runtime.pipeline``).

- **Negotiation** happens once: FrameSpecs propagate from the source through
  each element's `transform_spec` rule, constrained by per-link caps filters.
- **Build** plans every non-passthrough element for one ``torch.device``:
  tap tables, masks and coordinate fields move to the device once, and each
  element contributes a ``process(planes, state, params)`` function.
- **Passthrough elision**: elements reporting `is_passthrough` are dropped
  from the chain.
- **Run**: per frame, the source's host frame is repacked to canonical
  planes and uploaded, the chain runs eagerly on the device, and the sink
  gets the frame back in its host byte layout.

The device is explicit: ``Pipeline(device="cuda")`` raises when CUDA is not
available; nothing falls back to the CPU.  Linear chains only (one source,
one optional sink); tee, compositor, batched and live runs, controllers and
tpuvf's link-layout plans are not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from tpuvf_torch.core.element import Element, SinkElement, SourceElement
from tpuvf_torch.core.frame import host_to_planes, planes_to_host, to_device, to_host
from tpuvf_torch.core.spec import CapsFilter, FrameSpec


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must be available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


class PipelineError(RuntimeError):
    """A per-frame failure, tagged with the element that raised it."""

    def __init__(self, element_name: str, frame_index: int, cause: Exception):
        super().__init__(f"{element_name} (frame {frame_index}): {cause}")
        self.element_name = element_name
        self.frame_index = frame_index
        self.cause = cause


@dataclass
class Link:
    upstream: Element
    downstream: Element
    caps: Optional[CapsFilter] = None
    spec: Optional[FrameSpec] = None  # filled by negotiate()


@dataclass
class Stage:
    element: Element
    in_spec: FrameSpec
    out_spec: FrameSpec
    passthrough: bool
    process: Optional[callable] = None


class Pipeline:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.elements: List[Element] = []
        self.links: List[Link] = []
        self._by_name: Dict[str, Element] = {}
        self.stages: List[Stage] = []
        self.state: Optional[Dict] = None
        self._negotiated = False
        self._built_signature = None
        self.frames = 0
        self.wall_seconds = 0.0

    # -- construction ------------------------------------------------------

    def add(self, element: Element) -> Element:
        if element.name in self._by_name:
            raise ValueError(f"duplicate element name {element.name!r}")
        self.elements.append(element)
        self._by_name[element.name] = element
        return element

    def link(self, upstream, downstream, caps=None) -> Link:
        ln = Link(upstream, downstream, caps)
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

    def _chain(self) -> List[Element]:
        """Elements from the source to the tail, in link order."""
        order = [self.sources[0]]
        while self._outgoing(order[-1]):
            order.append(self._outgoing(order[-1])[0].downstream)
        return order

    # -- negotiation -------------------------------------------------------

    def negotiate(self) -> None:
        if len(self.sources) != 1:
            raise ValueError(f"a linear pipeline needs exactly one source, "
                             f"got {len(self.sources)}")
        for e in self.elements:
            ins, outs = self._incoming(e), self._outgoing(e)
            if len(outs) > 1:
                raise ValueError(f"{e.name} has {len(outs)} downstream links; "
                                 f"only linear chains are supported")
            if isinstance(e, SourceElement):
                if ins:
                    raise ValueError(f"source {e.name} has inputs")
            elif isinstance(e, SinkElement):
                if len(ins) != 1 or outs:
                    raise ValueError(f"sink {e.name} needs exactly 1 input "
                                     f"and no outputs")
            elif len(ins) != 1 or len(outs) != 1:
                raise ValueError(f"element {e.name} must have exactly one "
                                 f"input and one output")
        chain = self._chain()
        if len(chain) != len(self.elements):
            raise ValueError("pipeline graph has a cycle or dangling element")
        for e in chain:
            outs = self._outgoing(e)
            if isinstance(e, SourceElement):
                spec = e.output_spec(outs[0].caps if outs else None)
            elif isinstance(e, SinkElement):
                e.prepare(self._incoming(e)[0].spec)
                continue
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

    def build(self) -> None:
        if not self._negotiated:
            self.negotiate()
        stages: List[Stage] = []
        state: Dict[str, object] = {}
        for e in self._chain():
            if isinstance(e, (SourceElement, SinkElement)):
                continue
            in_spec = self._incoming(e)[0].spec
            out_spec = self._outgoing(e)[0].spec
            if e.is_passthrough(in_spec, out_spec):
                stages.append(Stage(e, in_spec, out_spec, True))
                continue
            process = e.make_process(
                in_spec, out_spec, e.static_config(in_spec, out_spec),
                self.device)
            stages.append(Stage(e, in_spec, out_spec, False, process))
            state[e.name] = e.init_state(in_spec, out_spec, self.device)
        self.stages = stages
        self.state = state
        self._built_signature = self._static_signature()

    # -- execution ---------------------------------------------------------

    def params(self) -> Dict[str, Dict]:
        """Traced per-frame params of every active element, on the device."""
        return {st.element.name: st.element.traced_params(self.device)
                for st in self.stages if not st.passthrough}

    def upload(self, host_frame) -> Dict[str, torch.Tensor]:
        """Source host frame -> canonical device planes."""
        spec = self._outgoing(self.sources[0])[0].spec
        return to_device(host_to_planes(host_frame, spec), self.device)

    def step(self, planes: Dict, state: Dict, params: Dict):
        """Run the built chain on device planes: -> (tail planes, state).
        Launches work on the device and returns without waiting for it."""
        new_state = dict(state)
        for st in self.stages:
            if st.passthrough:
                continue
            name = st.element.name
            try:
                planes, new_state[name] = st.process(
                    planes, state.get(name, ()), params.get(name, {}))
            except Exception as exc:
                raise PipelineError(name, self.frames, exc) from exc
        return planes, new_state

    def run(self, num_frames: Optional[int] = None) -> int:
        """Frame loop: generate -> upload -> step -> readback -> sink."""
        if (self._built_signature is None
                or self._static_signature() != self._built_signature):
            self.build()  # not built yet, or a property write changed it
        src = self.sources[0]
        limit = src.num_frames()
        if num_frames is None:
            if limit is None:
                raise ValueError("unbounded pipeline: pass num_frames or "
                                 "set num-buffers on the source")
            num_frames = limit
        elif limit is not None:
            num_frames = min(num_frames, limit)
        sink = self.sinks[0] if self.sinks else None
        sink_spec = self._incoming(sink)[0].spec if sink else None
        src_spec = self._outgoing(src)[0].spec
        params = self.params()
        state = self.state
        t0 = time.perf_counter()
        for i in range(num_frames):
            planes = self.upload(src.generate(i, src_spec))
            out, state = self.step(planes, state, params)
            self.state = state
            if sink is not None:
                sink.consume(planes_to_host(to_host(out), sink_spec),
                             sink_spec, i)
            self.frames += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_seconds += time.perf_counter() - t0
        if sink is not None:
            sink.finalize()
        return num_frames
