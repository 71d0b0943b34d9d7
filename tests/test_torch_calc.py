"""The CALC encoder, preprocessing and HOG descriptor of the torch port
against the JAX package, on the CPU in float32.

Tolerances: encoder outputs (unit vectors) within 1e-5 of Flax, with the
shipped weights and with random parameters on odd and even input sizes (the
asymmetric 'SAME' padding shows only on some of them); ``preprocess`` within
1e-5 on [0, 1] pixels; the HOG descriptor within 1e-5 and a dot product of at
least 0.99999 with the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.models import calc as jcalc  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch.models import calc as pcalc  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def frames():
    seq = generate_sequence(n_frames=2, h=240, w=376, n_points=900, seed=5)
    return [f.astype(np.uint8).astype(np.float32) for f in seq.left]


def _port_encoder(params, input_hw):
    enc = pcalc.CalcEncoder(input_hw).eval()
    enc.load_state_dict(bridge.calc_params_from_flax(_np_tree(params)))
    return enc


def test_shipped_weights_encoder_matches_flax(frames):
    params = jcalc.load_default_params()
    assert params is not None
    x = np.stack([np.asarray(jcalc.preprocess(jnp.asarray(f))) for f in frames])
    ref = np.asarray(jcalc.CalcEncoder().apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_encoder(params, pcalc.INPUT_HW)(_t(x)).numpy()
    assert got.shape == (2, 1064)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(120, 160), (117, 157), (64, 81), (33, 48)])
def test_random_params_encoder_matches_flax(rng, hw):
    enc = jcalc.CalcEncoder()
    params = enc.init(jax.random.PRNGKey(hw[0]), jnp.zeros(hw, jnp.float32))
    x = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
    ref = np.asarray(enc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        port = _port_encoder(params, hw)
        got = port(_t(x)).numpy()
        one = port(_t(x[0])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(one, ref[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(240, 376), (237, 375), (376, 1241)])
def test_preprocess_matches(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    a = np.asarray(jcalc.preprocess(jnp.asarray(img)))
    b = pcalc.preprocess(_t(img)).numpy()
    assert b.shape == (120, 160)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_hog_descriptor_matches(frames):
    for f in frames:
        a = np.asarray(jcalc.hog_descriptor(jnp.asarray(f)))
        b = pcalc.hog_descriptor(_t(f)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        assert float(a @ b) >= 0.99999
    sim_j = float(jcalc.similarity(jcalc.hog_descriptor(jnp.asarray(frames[0])),
                                   jcalc.hog_descriptor(jnp.asarray(frames[1]))))
    sim_p = float(pcalc.similarity(pcalc.hog_descriptor(_t(frames[0])),
                                   pcalc.hog_descriptor(_t(frames[1]))))
    assert abs(sim_j - sim_p) < 1e-5


def test_default_model_loads_the_same_file(frames, tmp_path):
    """``DescriptorModel.default()`` reads the JAX package's shipped file by
    path and gives the JAX default model's descriptors; from_caffe loads the
    reference's Caffe files as JAX's does."""
    import os

    import stereoslam_tpu.models as jmodels

    assert os.path.samefile(pcalc.DEFAULT_WEIGHTS,
                            os.path.join(os.path.dirname(jmodels.__file__), jcalc.DEFAULT_WEIGHTS))
    pm, jm = pcalc.DescriptorModel.default(), jcalc.DescriptorModel.default()
    flat_p = jax.tree_util.tree_leaves_with_path(pm.params)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jm.params))
    assert len(flat_p) == len(flat_j) == 7
    for path, v in flat_p:
        np.testing.assert_array_equal(v, np.asarray(flat_j[path]))
    a = np.asarray(jm(jnp.asarray(frames[0])))
    b = pm(_t(frames[0])).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert float(a @ b) >= 0.99999
    # Without params the model is the HOG projection, as in JAX.
    np.testing.assert_allclose(pcalc.DescriptorModel()(_t(frames[0])).numpy(),
                               np.asarray(jcalc.hog_descriptor(jnp.asarray(frames[0]))), atol=1e-5)
    # The reference's Caffe files (here the tiny net of tests/test_import_caffe.py)
    # load through from_caffe, as in JAX; a missing file raises.
    import _caffe_net

    net_bytes, _, x = _caffe_net.tiny_net(np.random.default_rng(0))
    (tmp_path / "deploy.prototxt").write_text(_caffe_net.TINY_PROTOTXT)
    (tmp_path / "calc.caffemodel").write_bytes(net_bytes)
    pc = pcalc.DescriptorModel.from_caffe(str(tmp_path / "deploy.prototxt"),
                                          str(tmp_path / "calc.caffemodel"))
    jc = jcalc.DescriptorModel.from_caffe(str(tmp_path / "deploy.prototxt"),
                                          str(tmp_path / "calc.caffemodel"))
    np.testing.assert_allclose(pc._caffe.descriptor(_t(x)).numpy(),
                               np.asarray(jc._caffe.descriptor(jnp.asarray(x))), atol=1e-5, rtol=0)
    with pytest.raises(FileNotFoundError):
        pcalc.DescriptorModel.from_caffe(str(tmp_path / "none.prototxt"),
                                         str(tmp_path / "calc.caffemodel"))
