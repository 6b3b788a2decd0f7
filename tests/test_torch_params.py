"""`runtime.params.from_tpuvf`: a tpuvf element's traced params and state
carried into the port agree with the port element's own, bitwise."""

import numpy as np
import pytest
import torch

from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.convertscale import ConvertScale as TConvertScale
from tpuvf.elements.videofilter import VideoFilter as TVideoFilter
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.convertscale import ConvertScale as PConvertScale
from tpuvf_torch.elements.videofilter import VideoFilter as PVideoFilter
from tpuvf_torch.runtime.params import from_tpuvf

torch.set_num_threads(1)

PROPS = {"brightness": 0.05, "contrast": 1.1, "saturation": 1.2, "hue": -0.3,
         "gamma": 2.2, "vignette": 0.4, "noise": 0.25, "invert": True,
         "chroma-key-color": 0xFF1080F0, "chroma-key-tolerance": 0.35}


def test_videofilter_params_and_state_round_trip():
    tel, pel = TVideoFilter(**PROPS), PVideoFilter(**PROPS)
    spec_t, spec_p = TSpec(TFormat.BGRA, 32, 24), PSpec(PFormat.BGRA, 32, 24)
    state = {"frame_index": np.uint32(2**32 - 1)}
    params, pstate = from_tpuvf(tel.traced_params(), state, "cpu")
    own = pel.traced_params("cpu")
    assert set(params) == set(own)
    for k in own:
        assert params[k].dtype == torch.float32 and params[k].dim() == 0
        assert torch.equal(params[k], own[k]), k  # the same float32 bits
        assert params[k].item() == float(tel.traced_params()[k])
    assert pstate["frame_index"].dtype == torch.int64
    assert int(pstate["frame_index"]) == 2**32 - 1
    assert int((pstate["frame_index"] + 1) & 0xFFFFFFFF) == 0  # uint32 wrap
    _, fresh = from_tpuvf({}, tel.init_state(spec_t, spec_t), "cpu")
    assert torch.equal(fresh["frame_index"],
                       pel.init_state(spec_p, spec_p, "cpu")["frame_index"])


def test_convertscale_weight_buffers_are_dropped():
    tel = TConvertScale(**{"add-borders": True})
    in_t, out_t = TSpec(TFormat.NV12, 64, 48), TSpec(TFormat.BGRA, 48, 48)
    tel.make_process(in_t, out_t, tel.static_config(in_t, out_t))
    tparams = tel.traced_params()
    assert any(k.startswith("__buf/") for k in tparams)
    params, state = from_tpuvf(tparams, tel.init_state(in_t, out_t), "cpu")
    assert params == {} and state == ()
    assert PConvertScale(**{"add-borders": True}).traced_params("cpu") == {}


def test_unported_params_raise():
    with pytest.raises(NotImplementedError):
        from_tpuvf({"lut": np.zeros((8, 24), np.uint8)}, (), "cpu")
