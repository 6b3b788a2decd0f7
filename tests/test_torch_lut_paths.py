"""K3's table paths on the CPU: the shared-memory path's node-table
indexing rendered in torch against `apply_lut_t_plain` (and so against
tpuvf's `apply_lut_t`), and the launcher's choice of path by size (the
mirror `lut.table_path`, which chip_smoke.py holds to the kernel's exported
query on the card).

The kernel's shared-memory path reads a pixel's 8 corners from the node
table ``table[:, 0:3]`` at the clamped indices ``(min(b0 + db, S - 1),
...)``; the rendering here does exactly that, in the kernel's operation
order.  Tolerance: bitwise, NaN equal to NaN (a NaN input's weights are NaN,
and its cell index goes to 0 as in the kernel's fmaxf and XLA's cast).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvf.kernels import filter as tfilter
from tpuvf_torch.kernels import filter as pfilter, lut

torch.set_num_threads(1)


def grade(size, seed):
    rng = np.random.default_rng(seed)
    return rng.random((size, size, size, 3), dtype=np.float32)


def inputs(size, seed, h=6, w=40):
    """Random planes with exact grid points, 0, 1 and a NaN on each axis."""
    rng = np.random.default_rng(seed)
    x = rng.random((4, h, w), dtype=np.float32)
    x[:3, 0, :size] = np.arange(size, dtype=np.float32) / np.float32(size - 1)
    x[:3, 1, 0], x[:3, 1, 1] = 0.0, 1.0
    x[0, 2, 0], x[1, 2, 1], x[2, 2, 2] = np.nan, np.nan, np.nan
    return x


def node_lookup(x, packed, size):
    """The shared-memory path in torch: corners from the node table."""
    nodes = packed[:, :3]
    s1 = float(size - 1)

    def axis(v):
        p = v * s1
        fl = torch.floor(p)
        f = p - fl
        i0 = torch.clamp(torch.nan_to_num(fl, nan=0.0), 0, size - 1).long()
        return (i0, torch.clamp(i0 + 1, max=size - 1)), (1.0 - f, f)

    (r, rw), (g, gw), (b, bw) = axis(x[0]), axis(x[1]), axis(x[2])
    acc = [None] * 3
    for k in range(8):
        db, dg, dr = (k >> 2) & 1, (k >> 1) & 1, k & 1
        node = nodes[((b[db] * size + g[dg]) * size + r[dr]).reshape(-1)]
        wk = (bw[db] * gw[dg]) * rw[dr]
        for c in range(3):
            t = wk * node[:, c].reshape(wk.shape)
            acc[c] = t if acc[c] is None else acc[c] + t
    return torch.stack(acc + [x[3]])


@pytest.mark.parametrize("size", [2, 9, 17, 33])
def test_node_table_indexing_equals_the_plain_version(size):
    packed = pfilter.pack_lut_corners(grade(size, seed=size))
    x = inputs(size, seed=size + 1)
    got = node_lookup(torch.from_numpy(x), torch.from_numpy(packed), size)
    want = torch.stack(pfilter.apply_lut_t_plain(
        tuple(torch.from_numpy(x).unbind(0)), torch.from_numpy(packed), size))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(want[:3, 2, :3]).all()  # the NaN pixels stay NaN
    assert not torch.isnan(want[:3, :2]).any()
    tpuvf = np.stack([np.asarray(c) for c in tfilter.apply_lut_t(
        tuple(jnp.asarray(c) for c in x), jnp.asarray(packed), size)])
    np.testing.assert_array_equal(want.numpy(), tpuvf)  # NaN == NaN here


@pytest.mark.parametrize("size,path", [
    (2, lut.PATH_SHARED), (17, lut.PATH_SHARED), (23, lut.PATH_SHARED),
    (24, lut.PATH_GATHER), (33, lut.PATH_GATHER), (64, lut.PATH_GATHER),
])
def test_path_choice_by_size(size, path):
    assert lut.table_path(size) == path
    # the largest shared-memory node table (float4 nodes) fits the 227 KB a
    # block may take
    assert lut.MAX_SHARED_SIZE ** 3 * 16 <= 232448

