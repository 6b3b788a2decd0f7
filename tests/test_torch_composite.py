"""K4, the compositor's blend fold, on the CPU: `composite_fold_plain` on
the draw table (`pack_draws`) against a straight transcription of tpuvf's
fold, the wrapper's checks and descriptor packing, and the CUDA source's
layout and operator codes.

The transcription is tpuvf's own code path (``compositor.py``
make_aggregate's background :383-397, make_dst :644-655, the fragment
premultiply :621-626, render_fast :855-886 and _blend_static :669-674) with
tpuvf's dequant/quant.  Tolerances:
- run op by op (``jax.disable_jit``), it rounds every float32 op once, as
  the plain version and the kernel do: bitwise;
- jitted, as tpuvf runs it, XLA's CPU backend may contract OVER's
  ``s + dv * (1 - a)`` into one FMA: <= 1 LSB on under 0.1% of values (the
  FMA class of ROADMAP's parity contract).
Everything else here is exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvf.kernels.color import dequant as t_dequant, quant as t_quant
from tpuvf_torch.elements.compositor import PAD_PROPERTIES
from tpuvf_torch.kernels import _build, color
from tpuvf_torch.kernels import composite as kc
from tpuvf_torch.kernels.composite import (
    MAX_DRAWS,
    OP_ADD,
    OP_OVER,
    OP_SOURCE,
    Background,
    Draw,
    background_colors,
    composite_fold,
    composite_fold_plain,
    pack_draws,
)

torch.set_num_threads(1)

# tpuvf's background canvases (make_aggregate :385-396) by mode
BG_FLOATS = {
    "checker": ((0.5, 0.5, 0.5, 1.0), (0.75, 0.75, 0.75, 1.0)),
    "black": ((0.0, 0.0, 0.0, 1.0),) * 2,
    "white": ((1.0, 1.0, 1.0, 1.0),) * 2,
    "transparent": ((0.0, 0.0, 0.0, 0.0),) * 2,
}


def tpuvf_background(mode, h, w):
    """make_aggregate :383-397, verbatim."""
    if mode == "checker":
        ys, xs = np.mgrid[0:h, 0:w]
        checker = ((xs // 8) + (ys // 8)) % 2
        gray = np.where(checker == 1, np.float32(0.75), np.float32(0.5))
        bg = np.stack([gray, gray, gray, np.ones_like(gray)], axis=0)
    elif mode == "black":
        bg = np.zeros((4, h, w), np.float32)
        bg[3] = 1.0
    elif mode == "white":
        bg = np.ones((4, h, w), np.float32)
    else:
        bg = np.zeros((4, h, w), np.float32)
    return np.round(np.clip(bg, 0, 1) * 255).astype(np.uint8)


def tpuvf_fold(h, w, mode, bg_drawn, draws, jit):
    """tpuvf's fold (render_fast over make_dst, with each draw's fragment
    premultiply), on numpy sources; jitted with the geometry static, or op
    by op."""

    def _blend_static(op, draw, src_v, dst_v, a_v):
        if op == OP_SOURCE:
            return jnp.where(draw > 0, src_v, dst_v)
        if op == OP_ADD:
            return src_v + dst_v  # skipped: src == 0
        return src_v + dst_v * (1.0 - a_v)

    def fold(bg_q, srcs, flags):
        zero = jnp.zeros((), jnp.uint8)
        bg = jnp.asarray(bg_q)
        dst = [jnp.where(flags[0] > 0, bg[c], zero) for c in range(4)]
        for (d, src), draw in zip(zip(draws, srcs), flags[1:]):
            chans = [t_dequant(src[c]) if src.dtype == jnp.uint8 else src[c]
                     for c in range(4)]
            s_a = chans[3] * (jnp.float32(d.k) * draw)
            src_p = [chans[0] * s_a, chans[1] * s_a, chans[2] * s_a, s_a]
            vx0, vy0, vx1, vy1 = d.rect
            if vx1 - vx0 <= 0 or vy1 - vy0 <= 0:
                continue
            ry = slice(vy0 - d.y, vy1 - d.y)
            rx = slice(vx0 - d.x, vx1 - d.x)
            a_v = src_p[3][ry, rx]
            for c in range(4):
                src_v = src_p[c][ry, rx]
                dst_v = t_dequant(dst[c][vy0:vy1, vx0:vx1])
                blended = _blend_static(d.op, draw, src_v, dst_v, a_v)
                dst[c] = dst[c].at[vy0:vy1, vx0:vx1].set(t_quant(blended))
        return jnp.stack(dst)

    srcs = [jnp.asarray(d.src.numpy()) for d in draws]
    flags = jnp.asarray([float(bg_drawn)] + [float(d.draw) for d in draws],
                        jnp.float32)
    args = (tpuvf_background(mode, h, w), srcs, flags)
    if jit:
        return np.asarray(jax.jit(fold)(*args))
    with jax.disable_jit():
        return np.asarray(fold(*args))


def make_draw(rng, h, w, pw, ph, x, y, op, alpha, f32=False, draw=1):
    if f32:
        src = torch.from_numpy(rng.random((4, ph, pw), dtype=np.float32))
    else:
        src = torch.from_numpy(rng.integers(0, 256, (4, ph, pw),
                                            dtype=np.uint8))
    rect = (min(max(x, 0), w), min(max(y, 0), h),
            min(max(x + pw, 0), w), min(max(y + ph, 0), h))
    return Draw(src, x, y, rect, op, float(np.float32(alpha)) * draw, draw)


# (label, canvas h, w, background, bg drawn, draws: (pw, ph, x, y, op,
#  alpha, f32, draw))
CASES = [
    ("config5-shape", 36, 64, "black", True,
     [(64, 36, 0, 0, OP_OVER, 1.0, False, 1),
      (32, 18, 32, 0, OP_OVER, 1.0, True, 1),
      (22, 12, 0, 18, OP_OVER, 0.7, False, 1),
      (22, 12, 32, 18, OP_ADD, 1.0, True, 1)]),
    ("checker-negative-source", 30, 50, "checker", True,
     [(40, 20, -9, -5, OP_SOURCE, 0.6, False, 1),
      (37, 23, 5, 11, OP_SOURCE, 0.0, True, 1),
      (13, 9, 45, 25, OP_OVER, 0.35, False, 1)]),
    ("source-flag-off-keeps-canvas", 24, 32, "white", True,
     [(20, 12, 3, 4, OP_SOURCE, 0.9, False, 0),
      (20, 12, 9, 8, OP_ADD, 0.5, True, 1)]),
    ("add-saturates", 16, 24, "white", True,
     [(24, 16, 0, 0, OP_ADD, 1.0, False, 1),
      (10, 10, 7, 3, OP_ADD, 0.8, True, 1)]),
    ("bg-not-drawn", 18, 20, "checker", False,
     [(20, 18, 0, 0, OP_OVER, 0.5, True, 1)]),
    ("transparent-offscreen", 20, 20, "transparent", True,
     [(8, 8, 30, 2, OP_OVER, 1.0, False, 1),
      (8, 8, -8, 2, OP_OVER, 1.0, False, 1),
      (9, 7, 11, 13, OP_OVER, 0.25, True, 1)]),
    ("more-draws-than-one-launch", 40, 56, "checker", True,
     [(17 + 3 * i, 11 + 2 * i, 4 * i - 6, 3 * i - 4, i % 3, 0.15 + 0.08 * i,
       bool(i % 2), 1) for i in range(MAX_DRAWS + 3)]),
]


@pytest.mark.parametrize("label,h,w,mode,bg_drawn,specs", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_fold_matches_tpuvf_fold(label, h, w, mode, bg_drawn, specs):
    rng = np.random.default_rng(len(label))
    draws = [make_draw(rng, h, w, *s) for s in specs]
    bg = Background(background_colors(BG_FLOATS[mode]))
    sources, table = pack_draws(h, w, draws, bg_drawn)
    got = composite_fold_plain(h, w, bg, sources, table, "cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, h, w)
    want = tpuvf_fold(h, w, mode, bg_drawn, draws, jit=False)
    assert np.array_equal(got.numpy(), want), label
    d = np.abs(got.numpy().astype(np.int32)
               - tpuvf_fold(h, w, mode, bg_drawn, draws, jit=True))
    print(f"{label}: jitted tpuvf max {int(d.max())} LSB, "
          f"{(d > 0).mean():.4%} differ")
    assert d.max() <= 1 and (d > 0).mean() < 0.001  # FMA (module doc)
    before = composite_fold.launches
    assert torch.equal(composite_fold(h, w, bg, sources, table, "cpu"), got)
    assert composite_fold.launches == before  # the CPU path launches nothing


def test_background_colors_are_tpuvfs_quantized_canvas():
    for mode, floats in BG_FLOATS.items():
        bg = Background(background_colors(floats))
        got = kc.background_canvas(19, 27, bg, True, "cpu")
        assert np.array_equal(got.numpy(), tpuvf_background(mode, 19, 27))
    assert background_colors(BG_FLOATS["checker"]) == (
        (128, 128, 128, 255), (191, 191, 191, 255))  # 127.5 rounds to even


def test_quant_of_dequant_is_identity_for_every_u8():
    """Why skipping a draw whose flag is 0 is exact: its blend gives dv,
    and the canvas stores quant(dequant(v)) == v."""
    v = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    assert torch.equal(color.quant(color.dequant(v)), v)
    assert np.array_equal(np.asarray(t_quant(t_dequant(jnp.asarray(
        v.numpy())))), v.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    bg = Background(background_colors(BG_FLOATS["black"]))
    good = make_draw(rng, 16, 16, 8, 8, 2, 2, OP_OVER, 0.5)
    for bad, exc in [
        (good._replace(rect=(0, 0, 17, 8)), ValueError),  # leaves the canvas
        (good._replace(rect=(1, 2, 8, 8)), ValueError),  # left of the source
        (good._replace(rect=(2, 2, 11, 10)), ValueError),  # past its width
        (good._replace(op=3), ValueError),
        (good._replace(src=good.src[:3]), ValueError),
        (good._replace(src=good.src.double()), TypeError),
    ]:
        with pytest.raises(exc):
            composite_fold(16, 16, bg, *pack_draws(16, 16, [bad]), "cpu")
    sources, table = pack_draws(16, 16, [good])
    for bad_table in (table[1:], table.long(), table[None]):
        with pytest.raises(ValueError):
            composite_fold(16, 16, bg, sources, bad_table, "cpu")
    with pytest.raises(ValueError):
        composite_fold(16, 16, bg, sources, table, "meta")


def test_fold_params_pack_the_descriptors():
    rng = np.random.default_rng(4)
    bg = Background(background_colors(BG_FLOATS["checker"]), row0=6)
    draws = [make_draw(rng, 20, 30, 9, 7, -3, 5, OP_ADD, 0.7, f32=True),
             make_draw(rng, 20, 30, 30, 20, 0, 0, OP_SOURCE, 1.0)]
    draws[1] = draws[1]._replace(keep_alpha=True)
    sources, table = pack_draws(20, 30, draws, False, row0=6)
    p = kc._fold_params(20, 30, bg, sources, 0, table, from_canvas=True)
    assert (p.first, p.n_draws, p.height, p.width, p.from_canvas,
            p.row0) == (0, 2, 20, 30, 1, 6)
    assert p.table == table.data_ptr()
    assert [list(row) for row in p.bg] == [[128] * 3 + [255],
                                           [191] * 3 + [255]]
    d0 = p.draws[0]
    assert d0.src == draws[0].src.data_ptr() and d0.src_f32 == 1
    assert (d0.width, d0.height, d0.keep_alpha) == (9, 7, 0)
    assert p.draws[1].src_f32 == 0 and p.draws[1].keep_alpha == 1
    # the table: bg_drawn, then each draw's frame geometry (row0 added),
    # op, k's float32 bits and its flag
    t = table.tolist()
    assert t[0] == 0
    assert t[1:1 + kc.TABLE_FIELDS - 2] == [-3, 11, 0, 11, 6, 18, OP_ADD]
    assert np.int32(t[8]).view(np.float32) == np.float32(0.7)
    assert t[9] == 1 and t[10 + kc.TABLE_FIELDS - 1] == 1
    bg_drawn, placed = kc.placed_draws(20, 30, bg, sources, table)
    assert not bg_drawn
    assert [(d.x, d.y, d.rect) for d in placed] == [
        (d.x, d.y, d.rect) for d in draws]


# -- the CUDA source -----------------------------------------------------------

COMPOSITE_CU = (_build.SOURCE_DIR / "composite.cu").read_text()
C_TYPES = {"const void*": "c_void_p", "const int*": "c_void_p",
           "int": "c_int", "float": "c_float"}


def _struct_fields(name):
    """[(field, C type)] of `struct name { ... };` in composite.cu."""
    body = re.search(r"struct " + name + r" \{(.*?)\};", COMPOSITE_CU,
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        m = re.match(r"(const void\*|const int\*|int|float|uint8_t|DrawDesc) "
                     r"(\w+)"
                     r"((?:\[\w+\])*);", line)
        if m:
            fields.append((m.group(2), m.group(1) + m.group(3)))
    return fields


def test_source_descriptor_layout_matches_the_ctypes_tables():
    want = [(n, C_TYPES[t]) for n, t in _struct_fields("DrawDesc")]
    assert want == [(n, t.__name__) for n, t in kc.DrawDesc._fields_]
    fold = _struct_fields("FoldParams")
    assert [n for n, _ in fold] == [n for n, _ in kc.FoldParams._fields_]
    assert dict(fold)["draws"] == "DrawDesc[kMaxDraws]"
    assert dict(fold)["bg"] == "uint8_t[2][4]"
    assert dict(fold)["table"] == "const int*"
    assert all(t == "int" for n, t in fold
               if n not in ("draws", "bg", "table"))
    assert kc.FoldParams.draws.size == kc.MAX_DRAWS * kc.ctypes.sizeof(
        kc.DrawDesc)
    for name, value in (("kMaxDraws", MAX_DRAWS),
                        ("kTableHead", kc.TABLE_HEAD),
                        ("kTableFields", kc.TABLE_FIELDS)):
        found = re.search(r"constexpr int " + name + r" = (\d+);",
                          COMPOSITE_CU)
        assert int(found.group(1)) == value


def test_source_operator_codes_match_the_wrapper():
    body = re.search(r"enum Op : int \{(.*?)\};", COMPOSITE_CU, re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    ops = dict((d.name, d) for d in PAD_PROPERTIES)["operator"].enum_values
    assert names == ["kOp" + nick.capitalize()
                     for nick, _ in sorted(ops, key=lambda nv: nv[1])]
    assert [v for _, v in sorted(ops, key=lambda nv: nv[1])] == [
        OP_SOURCE, OP_OVER, OP_ADD] == list(range(3))
    assert "composite_fold" in _build.SIGNATURES
