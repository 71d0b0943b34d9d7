"""The torch port's Caffe importer against the JAX package's on the CPU.

Nets are written by hand in the protobuf wire format (tests/_caffe_net.py,
the writer of tests/test_import_caffe.py): that test's tiny net, a net of the
remaining layer types (Sigmoid, TanH, average and global pooling with
padding, Dropout, Power, LRN), and a CALC-shaped net (1x1x120x160 input,
Convolution/ReLU/Pooling/LRN, a 1064-value last blob).  The parsed nets must
be equal field for field; every blob of the forward pass and the descriptor
within 1e-5 of JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import _caffe_net as C  # noqa: E402
from stereoslam_tpu.models import calc as jcalc  # noqa: E402
from stereoslam_tpu.models import import_caffe as J  # noqa: E402
from stereoslam_tpu_torch.models import calc as pcalc  # noqa: E402
from stereoslam_tpu_torch.models import import_caffe as P  # noqa: E402

TOL = 1e-5


def _mixed_net(rng):
    """Every supported layer type the other two nets leave out."""
    Wc = (0.5 * rng.standard_normal((6, 1, 3, 3))).astype(np.float32)
    bc = rng.standard_normal(6).astype(np.float32)
    Wip = (0.3 * rng.standard_normal((7, 6))).astype(np.float32)
    bip = rng.standard_normal(7).astype(np.float32)
    net = (
        C._string(1, "mixed") + C._string(3, "X")
        + b"".join(C._vint(4, d) for d in (1, 1, 13, 17))
        + C._conv_layer("conv", "X", "conv", Wc, bc, stride=1, pad=1)
        + C._layer("sig", "Sigmoid", "conv", "sig")
        + C._pool_layer("ave", "sig", "ave", k=3, s=2, method=1, pad=1)
        + C._layer("tanh", "TanH", "ave", "tanh")
        + C._layer("drop", "Dropout", "tanh", "drop")
        + C._layer("pow", "Power", "drop", "pow")
        + C._lrn_layer("lrn", "pow", "lrn", 3, 0.5, 0.75)
        + C._pool_layer("gmax", "lrn", "gmax", k=1, s=1, global_pooling=True)
        + C._ip_layer("ip", "gmax", "descriptor", Wip, bip)
    )
    return net, rng.standard_normal((13, 17)).astype(np.float32)


def _write(tmp_path, name, data):
    path = tmp_path / name
    (path.write_bytes if isinstance(data, bytes) else path.write_text)(data)
    return str(path)


@pytest.fixture
def nets(rng, tmp_path):
    """name -> (caffemodel path, prototxt path or None, input image)."""
    tiny, _, x_tiny = C.tiny_net(rng)
    mixed, x_mixed = _mixed_net(rng)
    calc_bytes, calc_text = C.calc_shaped_net(seed=5)
    x_calc = rng.random((120, 160)).astype(np.float32)
    return {
        "tiny": (_write(tmp_path, "tiny.caffemodel", tiny),
                 _write(tmp_path, "tiny.prototxt", C.TINY_PROTOTXT), x_tiny),
        "mixed": (_write(tmp_path, "mixed.caffemodel", mixed), None, x_mixed),
        "calc": (_write(tmp_path, "calc.caffemodel", calc_bytes),
                 _write(tmp_path, "calc.prototxt", calc_text), x_calc),
    }


@pytest.mark.parametrize("name", ["tiny", "mixed", "calc"])
def test_parsers_match_jax(nets, name):
    model, proto, _ = nets[name]
    pairs = [(P.load_caffemodel(model), J.load_caffemodel(model))]
    if proto:
        pairs.append((P.load_prototxt_net(proto), J.load_prototxt_net(proto)))
    for a, b in pairs:
        assert (a.name, a.inputs, a.input_shape) == (b.name, b.inputs, b.input_shape)
        assert len(a.layers) == len(b.layers)
        for la, lb in zip(a.layers, b.layers):
            da, db = dataclasses.asdict(la), dataclasses.asdict(lb)
            blobs_a, blobs_b = da.pop("blobs"), db.pop("blobs")
            assert da == db
            assert len(blobs_a) == len(blobs_b)
            for x, y in zip(blobs_a, blobs_b):
                np.testing.assert_array_equal(x, y)
    assert [l.type for l in pairs[0][0].layers] == [l.type for l in pairs[0][1].layers]


@pytest.mark.parametrize("name", ["tiny", "mixed", "calc"])
def test_runner_forward_and_descriptor_match_jax(nets, name):
    model, proto, x = nets[name]
    if proto:
        pr, jr = P.CaffeNetRunner.from_files(proto, model), J.CaffeNetRunner.from_files(proto, model)
    else:
        pr, jr = P.CaffeNetRunner(P.load_caffemodel(model)), J.CaffeNetRunner(J.load_caffemodel(model))
    assert isinstance(pr, torch.nn.Module)
    pb, jb = pr.forward(torch.from_numpy(x)), jr.forward(jnp.asarray(x))
    assert set(pb) == set(jb)
    for k in jb:
        assert tuple(pb[k].shape) == jb[k].shape, k
        np.testing.assert_allclose(pb[k].numpy(), np.asarray(jb[k]), atol=TOL, rtol=0, err_msg=k)
    dp, dj = pr.descriptor(torch.from_numpy(x)).numpy(), np.asarray(jr.descriptor(jnp.asarray(x)))
    assert dp.dtype == np.float32 and dp.shape == dj.shape
    np.testing.assert_allclose(dp, dj, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(dp), 1.0, rtol=1e-5)
    if name == "calc":
        assert dp.shape == (1064,)


def test_tiny_net_matches_manual_forward(rng, tmp_path):
    """tests/test_import_caffe.py's hand-computed forward of the tiny net."""
    net_bytes, weights, x = C.tiny_net(rng)
    model = _write(tmp_path, "tiny.caffemodel", net_bytes)
    Wc, bc, Wip, bip = (w.astype(np.float64) for w in weights)
    xp = np.pad(x, 1)
    conv = np.array([[[(xp[i * 2:i * 2 + 3, j * 2:j * 2 + 3] * Wc[o, 0]).sum() + bc[o]
                       for j in range(5)] for i in range(4)] for o in range(2)])
    relu = np.maximum(conv, 0)
    pool = np.array([[[relu[c, i * 2:i * 2 + 2, j * 2:j * 2 + 2].max() for j in range(3)]
                      for i in range(2)] for c in range(2)])
    want = Wip @ pool.reshape(-1) + bip
    got = P.CaffeNetRunner(P.load_caffemodel(model)).forward(torch.from_numpy(x))["descriptor"][0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_descriptor_model_from_caffe_matches_jax(nets):
    """preprocess (blur, 120x160) -> the Caffe net -> unit (1064,), on a
    camera-sized image, against JAX's DescriptorModel.from_caffe."""
    model, proto, _ = nets["calc"]
    img = (np.random.default_rng(3).random((240, 376)) * 255).astype(np.float32)
    dp = pcalc.DescriptorModel.from_caffe(proto, model)(torch.from_numpy(img)).numpy()
    dj = np.asarray(jcalc.DescriptorModel.from_caffe(proto, model)(jnp.asarray(img)))
    assert dp.shape == (1064,)
    np.testing.assert_allclose(dp, dj, atol=TOL, rtol=0)
    assert float(dp @ dj) >= 0.99999


def test_unsupported_layer_and_missing_file_raise(nets, tmp_path):
    model = nets["tiny"][0]
    extra = C._layer("bad", "Eltwise", "descriptor", "out")
    with open(model, "rb") as fh:
        bad = _write(tmp_path, "bad.caffemodel", fh.read() + extra)
    with pytest.raises(NotImplementedError):
        P.CaffeNetRunner(P.load_caffemodel(bad))
    with pytest.raises(FileNotFoundError):
        pcalc.DescriptorModel.from_caffe(str(tmp_path / "missing.prototxt"), model)
    with pytest.raises(FileNotFoundError):
        pcalc.DescriptorModel.from_caffe(nets["tiny"][1], str(tmp_path / "missing.caffemodel"))
