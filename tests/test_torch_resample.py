"""K1/K1b plain versions and the tap planner of the PyTorch port against
tpuvf: the Pallas row kernel in interpret mode, the blockband column einsum,
and the dense sampling-matrix product.

Tolerance for float comparisons: max |diff| <= 1e-6 on values in [0, 1] —
one float32 rounding (ulp <= 6e-8 below 1.0) against the dense sum's or the
matmul's different association of the same two terms.  The tap tables
themselves must equal the matrix nonzeros exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvf.kernels import sample as tsample
from tpuvf.kernels.pallas import resample as presample
from tpuvf_torch.kernels import resample, sample

torch.set_num_threads(1)

TOL = 1e-6


def _taps(t, in_size, filter=sample.LINEAR, mask=None,
          make=resample.make_taps):
    return make(sample.plan_taps(t, in_size, filter, mask), in_size, "cpu")


def _rows(img, t, in_size, filter=sample.LINEAR, mask=None):
    taps = _taps(t, in_size, filter, mask)
    return resample.resample_rows(torch.from_numpy(img), taps).numpy()


def _cols(img, t, in_size, filter=sample.LINEAR, mask=None):
    taps = _taps(t, in_size, filter, mask, resample.make_col_taps)
    return resample.resample_cols(torch.from_numpy(img), taps).numpy()


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("in_h,out_h", [(64, 32), (32, 80), (136, 60)])
def test_rows_match_pallas_interpret(in_h, out_h):
    rng = np.random.default_rng(5)
    img = rng.random((in_h, 256), dtype=np.float32)
    t = tsample.texcoords(out_h)
    want = presample.banded_resample_rows(jnp.asarray(img), t, interpret=True)
    assert _maxdiff(_rows(img, t, in_h), want) <= TOL


def test_rows_padded_operand_match_pallas_interpret():
    """The Pallas kernel's bottom-padded 540-row chroma case: the port reads
    the unpadded plane and must give the same rows."""
    rng = np.random.default_rng(7)
    img = rng.random((540, 128), dtype=np.float32)
    padded = jnp.asarray(np.pad(img, ((0, 4), (0, 0))))
    t = tsample.texcoords(480)
    want = presample.banded_resample_rows(padded, t, interpret=True,
                                          sample_rows=540)
    assert _maxdiff(_rows(img, t, 540), want) <= TOL


def test_rows_letterbox_coords_match_pallas_interpret():
    """Texcoords clipped to the edge (the letterbox-coords case of the
    Pallas tests): clamp-to-edge folds into the taps."""
    rng = np.random.default_rng(6)
    img = rng.random((16, 128), dtype=np.float32)
    tc = np.clip(tsample.texcoords(24, scale=0.5), 0.0, 1.0)
    want = presample.banded_resample_rows(jnp.asarray(img), tc, interpret=True)
    assert _maxdiff(_rows(img, tc, 16), want) <= TOL


GEOMETRIES = [
    # (in, out, filter, scale)
    (36, 24, sample.LINEAR, 1.0),
    (24, 48, sample.LINEAR, 1.0),
    (19, 37, sample.LINEAR, 1.0),
    (64, 40, sample.NEAREST, 1.0),
    (40, 64, sample.NEAREST, 1.0),
    (48, 48, sample.LINEAR, 0.75),   # masked letterbox rows
    (30, 40, sample.NEAREST, 0.6),   # masked letterbox, nearest
]


@pytest.mark.parametrize("in_size,out_size,filt,scale", GEOMETRIES)
def test_plan_taps_equal_matrix_nonzeros(in_size, out_size, filt, scale):
    t = tsample.texcoords(out_size, scale)
    mask = tsample.coverage_mask(out_size, scale)
    dense = tsample.sample_matrix(t, in_size, filt, mask)
    i0, i1, w0, w1 = sample.plan_taps(t, in_size, filt, mask)
    assert i0.dtype == np.int32 and w0.dtype == np.float32
    rebuilt = np.zeros_like(dense)
    rows = np.arange(out_size)
    rebuilt[rows, i0] += w0
    rebuilt[rows, i1] += w1
    assert np.array_equal(rebuilt, dense)  # exact: the matrix's own weights
    assert np.array_equal(sample.texcoords(out_size, scale), t)
    assert np.array_equal(sample.sample_matrix(t, in_size, filt, mask), dense)


@pytest.mark.parametrize("in_size,out_size,filt,scale", GEOMETRIES)
def test_rows_and_cols_match_dense_product(in_size, out_size, filt, scale):
    rng = np.random.default_rng(in_size * 131 + out_size)
    t = tsample.texcoords(out_size, scale)
    mask = tsample.coverage_mask(out_size, scale)
    dense = tsample.sample_matrix(t, in_size, filt, mask).astype(np.float64)
    img = rng.random((2, in_size, 24), dtype=np.float32)  # U and V stacked
    got_rows = _rows(img, t, in_size, filt, mask)
    assert got_rows.shape == (2, out_size, 24)
    assert _maxdiff(got_rows, np.einsum("oh,phw->pow", dense, img)) <= TOL
    imgc = rng.random((3, 20, in_size), dtype=np.float32)
    got_cols = _cols(imgc, t, in_size, filt, mask)
    assert got_cols.shape == (3, 20, out_size)
    assert _maxdiff(got_cols, np.einsum("phw,ow->pho", imgc, dense)) <= TOL
    if not mask.all():  # masked rows are exact zeros
        assert not got_rows[:, ~mask].any() and not got_cols[..., ~mask].any()


def test_cols_match_blockband_einsum():
    """K1b's TPU counterpart: the blockband MXU column contraction."""
    rng = np.random.default_rng(9)
    in_w, out_w = 960, 320
    t = tsample.texcoords(out_w)
    w = tsample.sample_matrix(t, in_w, tsample.LINEAR)
    plan = tsample.blockband_plan(w)
    assert plan is not None
    img = rng.random((16, in_w), dtype=np.float32)
    want = tsample._blockband_cols(jnp.asarray(img), jnp.asarray(w), plan)
    assert _maxdiff(_cols(img, t, in_w), want) <= TOL


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    taps = _taps(tsample.texcoords(8), 16)
    x = torch.zeros(16, 4)
    resample.resample_rows.launches = resample.resample_cols.launches = 0
    assert resample.resample_rows(x, taps).shape == (8, 4)
    with pytest.raises(TypeError):
        resample.resample_rows(x.double(), taps)
    with pytest.raises(ValueError):  # 4 columns, taps expect 16
        resample.resample_cols(x, _taps(tsample.texcoords(8), 16,
                                        make=resample.make_col_taps))
    with pytest.raises(ValueError):  # row taps carry no band plan
        resample.resample_cols(torch.zeros(4, 16), taps)
    with pytest.raises(ValueError):
        resample.make_taps(sample.plan_taps(tsample.texcoords(8), 16), 12,
                           "cpu")
    # the CPU path is the plain version: no kernel launch is counted
    assert resample.resample_rows.launches == 0
    assert resample.resample_cols.launches == 0
