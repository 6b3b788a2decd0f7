"""gst-launch style pipeline-string parser and runner (port of
``tpuvf.cli.launch``).

    python -m tpuvf_torch.cli.launch --device cuda \\
      "videotestsrc num-buffers=5 ! video/x-raw,format=NV12,width=1920,height=1080 \\
       ! vfmetalconvertscale ! video/x-raw,format=BGRA,width=640,height=480 \\
       ! vfmetalvideofilter brightness=0.05 contrast=1.1 saturation=1.2 ! fakesink"

    vfmetalcompositor name=comp sink_1::xpos=160 ... ! fakesink
    videotestsrc ! comp.sink_0  videotestsrc ! comp.sink_1

``-b N`` runs `Pipeline.run_batched` with batches of N frames, ``--live``
`Pipeline.run_live` (late ticks dropped, counted in the closing line).

Grammar handled: `!` links, caps filter tokens (video/x-raw,...), element
properties `key=value`, `name=` assignment, pad properties `pad::key=value`,
named-pad references `name.pad` / `name.` both as link targets (sink pads)
and chain heads (src pads, such as a tee's branches `t. ! queue ! ...`), in
either order in the string.
"""

from __future__ import annotations

import shlex
import sys
from typing import List, Optional, Tuple

from tpuvf_torch.core import registry
from tpuvf_torch.core.element import Element
from tpuvf_torch.core.spec import CapsFilter
from tpuvf_torch.runtime.pipeline import Pipeline


class ParseError(ValueError):
    pass


def tokenize(desc: str) -> List[str]:
    lex = shlex.shlex(desc, posix=True)
    lex.whitespace_split = True
    lex.commenters = ""
    return list(lex)


def _is_caps(tok: str) -> bool:
    return tok.startswith("video/") or tok.startswith("audio/")


def _is_pad_ref(tok: str) -> bool:
    if "=" in tok or _is_caps(tok):
        return False
    if tok.endswith("."):
        return True
    if "." in tok:
        head, _, tail = tok.partition(".")
        return head.isidentifier() and ("::" not in tail)
    return False


def parse_pipeline(desc: str, device="cuda") -> Pipeline:
    """Parse a gst-launch description into a Pipeline on `device`."""
    pipe = Pipeline(device=device)
    auto_idx: dict = {}
    current: Optional[Element] = None  # upstream end of a pending link
    pending_link = False
    pending_caps: Optional[CapsFilter] = None
    # pad-ref links resolved after all elements exist:
    # (other element, caps, target name, target pad, direction)
    deferred: List[Tuple] = []
    pending_src_ref: Optional[Tuple[str, str]] = None  # (name, pad) chain head

    tokens = tokenize(desc)
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "!":
            if current is None and pending_src_ref is None:
                raise ParseError("dangling '!' with no upstream element")
            pending_link = True
            continue
        if _is_caps(tok):
            if not pending_link:
                raise ParseError(f"caps {tok!r} must follow '!'")
            pending_caps = CapsFilter.parse(tok)
            # expect another '!' before the downstream element
            if i < len(tokens) and tokens[i] == "!":
                i += 1
            continue
        if _is_pad_ref(tok):
            name, _, pad = tok.partition(".")
            if pending_link:
                # chain tail: upstream ! name.pad (the named element may be
                # declared later in the string)
                if current is None:
                    raise ParseError(
                        "linking two pad references directly is unsupported")
                deferred.append((current, pending_caps, name, pad or None,
                                 "to"))
                pending_link = False
                pending_caps = None
            else:
                # chain head: name. ! downstream
                pending_src_ref = (name, pad or None)
            current = None
            continue
        if "=" in tok and not pending_link and current is not None:
            key, _, val = tok.partition("=")
            if key == "name":
                pipe.rename(current, val)
            elif "::" in key:
                pad_name, _, prop = key.partition("::")
                if not hasattr(current, "get_pad"):
                    raise ParseError(f"{current.name} does not have request "
                                     f"pads")
                current.get_pad(pad_name).set_from_string(prop, val)
            else:
                current.props.set_from_string(key, val)
            continue
        # otherwise: element factory name
        cls = registry.lookup(tok)
        idx = auto_idx.get(tok, 0)
        auto_idx[tok] = idx + 1
        elem = pipe.add(cls(name=f"{tok}{idx}"))
        if pending_src_ref is not None:
            deferred.append((elem, pending_caps, *pending_src_ref, "from"))
            pending_src_ref = None
        elif pending_link:
            pipe.link(current, elem, caps=pending_caps)
        pending_link = False
        pending_caps = None
        current = elem
    if pending_link:
        raise ParseError("dangling '!' at the end of the pipeline")
    for other, caps, name, pad, direction in deferred:
        try:
            target = pipe[name]
        except KeyError:
            raise ParseError(f"unknown element {name!r} in pad reference") \
                from None
        if direction == "to":
            pipe.link(other, target, caps=caps, sink_pad=pad)
        else:  # "from": target's src pad feeds `other`
            pipe.link(target, other, caps=caps)
    return pipe


def launch(desc: str, device="cuda", num_frames: Optional[int] = None,
           quiet: bool = False, verbose: bool = False, batch: int = 0,
           live: bool = False) -> int:
    """Parse, negotiate, build and run `desc` on `device`: `run_batched`
    with `batch` > 1 (`num_frames` then defaults to the smallest
    num-buffers, tpuvf's rule), `run_live` with `live`, else `run`."""
    pipe = parse_pipeline(desc, device=device)
    pipe.negotiate()
    if verbose:
        # gst-launch -v analog: print every negotiated link caps
        for ln in pipe.links:
            pad = f".{ln.sink_pad}" if ln.sink_pad else ""
            print(f"{ln.upstream.name} -> {ln.downstream.name}{pad}: "
                  f"{ln.spec}")
    pipe.build()
    if batch > 1:
        if num_frames is None:
            limits = [s.num_frames() for s in pipe.sources]
            limits = [n for n in limits if n is not None]
            if not limits:
                raise ValueError("batched mode needs num_frames or "
                                 "num-buffers")
            num_frames = min(limits)
        n = pipe.run_batched(num_frames, batch_size=batch)
    elif live:
        n = pipe.run_live(num_frames)
    else:
        n = pipe.run(num_frames=num_frames)
    if not quiet:
        dropped = pipe.stats.frames_dropped
        tail = f" ({dropped} dropped, live QoS)" if dropped else ""
        print(f"tpuvf_torch-launch: processed {n} frames on {pipe.device}, "
              f"reached end of stream{tail}")
        if verbose:
            print(f"tpuvf_torch-launch: {pipe.stats.summary()}")
    return n


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    num_frames = None
    verbose = False
    quiet = False
    device = "cuda"
    batch = 0
    live = False
    while argv and argv[0].startswith("-"):
        flag = argv.pop(0)
        if flag in ("-n", "--num-frames"):
            num_frames = int(argv.pop(0))
        elif flag in ("-b", "--batch"):
            batch = int(argv.pop(0))
        elif flag == "--live":
            live = True
        elif flag == "--device":
            device = argv.pop(0)
        elif flag in ("-v", "--verbose"):
            verbose = True
        elif flag in ("-q", "--quiet"):
            quiet = True
        else:
            print(f"unknown flag {flag}", file=sys.stderr)
            return 2
    if not argv:
        print("usage: python -m tpuvf_torch.cli.launch [--device cuda|cpu] "
              "[-n N] [-b BATCH] [--live] [-v] [-q] PIPELINE",
              file=sys.stderr)
        return 2
    try:
        launch(" ".join(argv), device=device, num_frames=num_frames,
               quiet=quiet, verbose=verbose, batch=batch, live=live)
        return 0
    except Exception as exc:  # mirror gst-launch: error message + nonzero exit
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
