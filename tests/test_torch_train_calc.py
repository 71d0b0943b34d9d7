"""CALC training in the torch port against the JAX package's, on the CPU.

The JAX package draws its augmentations from ``jax.random`` keys; the port's
loss takes them as arguments (``Augment``), so these tests compute JAX's
draws from the same keys, in ``_random_warp``'s and ``_photometric``'s own
split order, and hand them to the port.  Tolerances:

- the warp and the photometric jitter: 1e-5 on [0, 1] pixels;
- the losses at JAX's init carried across: each term within 1e-5 relative,
  the reconstruction within 1e-2 (the decoder computes in bfloat16, 2^-8
  relative a value); gradients at cosine >= 0.9999 for the encoder, >= 0.999
  for the bfloat16 decoder;
- the training loops from JAX's init with JAX's indices and draws: the
  history within 1e-3 relative, each encoder tensor's total update within 2%
  of its norm (Adam's first steps are about lr * sign(g), so a gradient
  element that rounds to the other sign moves a whole step);
- the corpus renderer: poses and noise keys exact, images within the
  renderer's tolerances (``tests/test_torch_world.py``);
- Flax's init: per-layer std within 5% of 1 / sqrt(fan_in), zero biases,
  nothing beyond two standard deviations of the untruncated normal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.models import calc as jcalc  # noqa: E402
from stereoslam_tpu.models import train_calc as jtc  # noqa: E402
from stereoslam_tpu.utils import world as jworld  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch.models import calc as pcalc  # noqa: E402
from stereoslam_tpu_torch.models import train_calc as ptc  # noqa: E402
from stereoslam_tpu_torch.utils import world as pworld  # noqa: E402
from tests.test_torch_world import assert_images_close  # noqa: E402

H, W, FX = 120, 188, 160.0
LOSS_KW = dict(contrastive_weight=0.5, temperature=0.07, margin_pos=0.965, margin_neg=0.55,
               hinge_weight=4.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def jax_init(seed=0):
    """JAX's own init of the encoder and decoder, as train_encoder* make it."""
    key = jax.random.PRNGKey(seed)
    dummy = jnp.zeros(jcalc.INPUT_HW, jnp.float32)
    enc = jcalc.CalcEncoder()
    enc_p = jax.jit(enc.init)(key, dummy)
    dec_p = jax.jit(jtc._Decoder(hog_dim=ptc.HOG_DIM).init)(key, jax.jit(enc.apply)(enc_p, dummy))
    return {"enc": _np(enc_p), "dec": _np(dec_p)}


def warp_draws(k, h, w):
    k1, k2, k3 = jax.random.split(k, 3)
    ang = jax.random.uniform(k1, (), minval=-0.15, maxval=0.15)
    scale = jax.random.uniform(k2, (), minval=0.9, maxval=1.1)
    shift = jax.random.uniform(k3, (2,), minval=-0.08, maxval=0.08) * jnp.asarray([w, h])
    return ang, scale, shift


def photo_draws(k):
    k1, k2 = jax.random.split(k)
    return (jax.random.uniform(k1, (), minval=0.75, maxval=1.3),
            jax.random.uniform(k2, (), minval=-0.08, maxval=0.08))


def jax_augment(keys, pairs, hw=jcalc.INPUT_HW):
    """The port's ``Augment`` holding the values JAX draws from ``keys``:
    (batch, 5, 2) keys (kw, ka, kb, kwa, kwb) with ``pairs``, else (batch, 2)."""
    h, w = hw
    keys = jnp.asarray(keys)
    warp_keys = [keys[:, 0], keys[:, 3], keys[:, 4]] if pairs else [keys]
    draws = [jax.vmap(lambda k: warp_draws(k, h, w))(kk) for kk in warp_keys]
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    angle = t(np.stack([d[0] for d in draws], 1))
    scale = t(np.stack([d[1] for d in draws], 1))
    shift = t(np.stack([d[2] for d in draws], 1))
    if not pairs:
        return ptc.Augment(angle, scale, shift)
    photo = [jax.vmap(photo_draws)(keys[:, i]) for i in range(3)]
    return ptc.Augment(angle, scale, shift, t(np.stack([p[0] for p in photo], 1)),
                       t(np.stack([p[1] for p in photo], 1)))


def jax_step_keys(seed, steps, batch, pairs):
    """Each step's per-sample keys, split as train_encoder* split them."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.split(sub, batch * 5).reshape(batch, 5, 2) if pairs
                   else jax.random.split(sub, batch))
    return out


@pytest.fixture(scope="module")
def corpus():
    """JAX's render_corpus_pairs at 120x188 (8 pairs), with the poses and
    noise keys it passed to the renderer, and the preprocessed pairs."""
    seen = []
    real = jworld.render_frames_batched

    def spy(T_wc, **kw):
        seen.append((np.array(T_wc), np.array(kw["noise_keys"])))
        return real(T_wc, **kw)

    jworld.render_frames_batched = spy
    try:
        A, B = jtc.render_corpus_pairs(n_places=8, n_scenes=2, h=H, w=W, fx=FX, seed=555)
    finally:
        jworld.render_frames_batched = real
    pa, pb = np.split(jtc.preprocess_corpus(np.concatenate([A, B])), 2)
    return dict(A=A, B=B, seen=seen, pa=pa, pb=pb)


@pytest.fixture(scope="module")
def init():
    return jax_init(0)


def test_warp_and_photometric_match_jax(corpus):
    imgs = corpus["pa"][:6]
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = np.asarray(jax.vmap(jtc._random_warp)(keys, jnp.asarray(imgs)))
    want_p = np.asarray(jax.vmap(jtc._photometric)(keys, jnp.asarray(want)))
    ang, scale, shift = jax.vmap(lambda k: warp_draws(k, *jcalc.INPUT_HW))(keys)
    gain, bias = jax.vmap(photo_draws)(keys)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = ptc._random_warp(t(imgs), t(ang), t(scale), t(shift)).numpy()
    got_p = ptc._photometric(t(want), t(gain), t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=0)
    # The Augment view composes the two on the draws of one key per sample.
    aug = ptc.Augment(t(ang)[:, None], t(scale)[:, None], t(shift)[:, None],
                      t(gain)[:, None], t(bias)[:, None])
    np.testing.assert_allclose(aug.view(t(imgs), 0).numpy(), want_p, atol=1e-5, rtol=0)


def jax_losses(params, a, b, keys):
    """The JAX package's two losses, as train_encoder and train_encoder_pairs
    define them inside their bodies."""
    enc, dec = jcalc.CalcEncoder(), jtc._Decoder(hog_dim=ptc.HOG_DIM)
    hog_t = jax.vmap(jcalc.hog_features)
    kw, ka, kb, kwa, kwb = (keys[:, i] for i in range(5))

    def recon_fn(params):
        warped = jax.vmap(jtc._random_warp)(kw, a)
        return jnp.mean((dec.apply(params["dec"], enc.apply(params["enc"], warped)) - hog_t(a)) ** 2)

    def pair_fn(params):
        warped = jax.vmap(jtc._photometric)(kw, jax.vmap(jtc._random_warp)(kw, a))
        recon = jnp.mean((dec.apply(params["dec"], enc.apply(params["enc"], warped)) - hog_t(a)) ** 2)
        za = enc.apply(params["enc"], jax.vmap(jtc._photometric)(ka, jax.vmap(jtc._random_warp)(kwa, a)))
        zb = enc.apply(params["enc"], jax.vmap(jtc._photometric)(kb, jax.vmap(jtc._random_warp)(kwb, b)))
        S = za @ zb.T
        labels = jnp.arange(a.shape[0])
        logits = S / LOSS_KW["temperature"]
        ce = optax.softmax_cross_entropy_with_integer_labels
        contrast = 0.5 * (jnp.mean(ce(logits, labels)) + jnp.mean(ce(logits.T, labels)))
        off = ~jnp.eye(S.shape[0], dtype=bool)
        hinge = jnp.mean(jax.nn.relu(LOSS_KW["margin_pos"] - jnp.diag(S))) + jnp.mean(
            jax.nn.relu(jnp.where(off, S, -1.0) - LOSS_KW["margin_neg"]))
        total = recon + LOSS_KW["contrastive_weight"] * contrast + LOSS_KW["hinge_weight"] * hinge
        return total, (recon, contrast, hinge)

    both = jax.jit(lambda p: (jax.value_and_grad(recon_fn)(p),
                              jax.value_and_grad(pair_fn, has_aux=True)(p)))
    (recon, g_recon), ((total, aux), g_pair) = both(params)
    return (float(recon), _np(g_recon)), ((float(total),) + tuple(map(float, aux)), _np(g_pair))


def port_grads(enc, dec):
    g = bridge.calc_params_to_flax({k: p.grad for k, p in enc.named_parameters()})
    return {"enc": g, "dec": bridge.decoder_params_to_flax(
        {k: p.grad for k, p in dec.named_parameters()})}


def assert_grads_close(got, want):
    for part, tol in (("enc", 0.9999), ("dec", 0.999)):
        want_l = dict(_leaves(want[part]))
        for name, g in _leaves(got[part]):
            assert _cos(g, want_l[name]) >= tol, (part, name, _cos(g, want_l[name]))


def test_losses_and_gradients_match_jax_at_jax_init(corpus, init):
    a, b = corpus["pa"][:4], corpus["pb"][:4]
    keys = jax.random.split(jax.random.PRNGKey(11), 20).reshape(4, 5, 2)
    (recon_j, g_recon_j), (terms_j, g_pair_j) = jax_losses(
        jax.tree.map(jnp.asarray, init), jnp.asarray(a), jnp.asarray(b), keys)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    enc, dec = ptc.init_modules(init=init, device="cpu")
    recon = ptc.recon_loss(enc, dec, ta, jax_augment(keys[:, 0], pairs=False))
    recon.backward()
    assert _rel(recon, recon_j) <= 1e-2
    assert_grads_close(port_grads(enc, dec), g_recon_j)

    enc, dec = ptc.init_modules(init=init, device="cpu")
    total, aux = ptc.pair_loss(enc, dec, ta, tb, jax_augment(keys, pairs=True), **LOSS_KW)
    total.backward()
    recon, contrast, hinge = (float(x) for x in aux)
    assert _rel(recon, terms_j[1]) <= 1e-2
    assert _rel(contrast, terms_j[2]) <= 1e-5 and _rel(hinge, terms_j[3]) <= 1e-5, (aux, terms_j)
    # The total carries the reconstruction's bfloat16 rounding.
    assert abs(float(total) - terms_j[0]) <= 1e-2 * abs(terms_j[1]) + 1e-5 * abs(terms_j[0])
    assert_grads_close(port_grads(enc, dec), g_pair_j)


def assert_updates_close(got, want, start):
    start_l = dict(_leaves(start))
    for name, w in _leaves(want):
        g = dict(_leaves(got))[name]
        du_w, du_g = w - start_l[name], g - start_l[name]
        assert np.linalg.norm(du_g - du_w) <= 0.02 * np.linalg.norm(du_w), name


def test_train_encoder_pairs_matches_jax(corpus, init):
    A, B = corpus["A"], corpus["B"]
    kw = dict(steps=3, batch=4, seed=0, log_every=1)
    params_j, hist_j = jtc.train_encoder_pairs(A, B, **kw)
    draws = [jax_augment(k, pairs=True) for k in jax_step_keys(0, 3, 4, pairs=True)]
    params, hist = ptc.train_encoder_pairs(A, B, device="cpu", init=init,
                                           augment=lambda i: draws[i], **kw)
    assert len(hist) == len(hist_j) == 3
    np.testing.assert_allclose(np.asarray(hist), np.asarray(hist_j), rtol=1e-3)
    assert_updates_close(params, _np(params_j), init["enc"])


def test_train_encoder_matches_jax(corpus, init):
    imgs = corpus["A"]
    params_j, hist_j = jtc.train_encoder(imgs, steps=2, batch=4, seed=0)
    draws = [jax_augment(k, pairs=False) for k in jax_step_keys(0, 2, 4, pairs=False)]
    params, hist = ptc.train_encoder(imgs, steps=2, batch=4, seed=0, device="cpu", init=init,
                                     augment=lambda i: draws[i])
    np.testing.assert_allclose(hist, hist_j, rtol=1e-3)
    assert_updates_close(params, _np(params_j), init["enc"])


def test_render_corpus_pairs_matches_jax(corpus, monkeypatch):
    seen = []
    real = pworld.render_frames_batched

    def spy(T_wc, **kw):
        seen.append((np.array(T_wc), np.array(kw["noise_keys"])))
        return real(T_wc, **kw)

    monkeypatch.setattr(pworld, "render_frames_batched", spy)
    A, B = ptc.render_corpus_pairs(n_places=8, n_scenes=2, h=H, w=W, fx=FX, seed=555,
                                   device="cpu")
    assert A.shape == B.shape == (8, H, W) and A.device.type == "cpu"
    assert len(seen) == len(corpus["seen"]) == 4
    for (T, k), (Tj, kj) in zip(seen, corpus["seen"]):
        np.testing.assert_array_equal(T, Tj)
        np.testing.assert_array_equal(k, kj)
    assert_images_close(A.numpy(), corpus["A"])
    assert_images_close(B.numpy(), corpus["B"])
    np.testing.assert_allclose(ptc.preprocess_corpus([A, B], "cpu").numpy(),
                               np.concatenate([corpus["pa"], corpus["pb"]]), atol=1e-5, rtol=0)


def test_init_is_flax_lecun_normal():
    enc, dec = ptc.init_modules(seed=0, device="cpu")
    layers = [enc.conv1, enc.conv2, enc.conv3, enc.proj, dec.dense0, dec.dense1]
    for layer in layers:
        wgt = layer.weight.detach().numpy()
        fan_in = wgt[0].size
        std = 1.0 / np.sqrt(fan_in)
        assert abs(wgt.std() / std - 1.0) <= 0.05, (layer, wgt.std(), std)
        assert np.abs(wgt).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
        if layer.bias is not None:
            assert not layer.bias.detach().any()
    again, _ = ptc.init_modules(seed=0, device="cpu")
    assert torch.equal(again.proj.weight, enc.proj.weight)


def test_weight_files_round_trip_across_packages(tmp_path, init):
    for jsave, jload, psave, pload in (
            (jcalc.save_params_npz, jcalc.load_params_npz, pcalc.save_params_npz,
             pcalc.load_params_npz),
            (jtc.save_params, jtc.load_params, ptc.save_params, ptc.load_params)):
        f16 = jsave is jcalc.save_params_npz
        cast = (lambda x: np.asarray(x, np.float16).astype(np.float32)) if f16 else np.asarray
        jsave(str(tmp_path / "jax"), init["enc"])
        psave(str(tmp_path / "port"), init["enc"])
        suffix = ".npz" if f16 else ""
        from_jax = dict(_leaves(pload(str(tmp_path / "jax") + suffix)))
        from_port = dict(_leaves(_np(jload(str(tmp_path / "port") + suffix))))
        want = {k: cast(v) for k, v in _leaves(init["enc"])}
        assert from_jax.keys() == from_port.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(from_jax[k], v)
            np.testing.assert_array_equal(from_port[k], v)
    # Flax layout both ways through the bridge.
    enc, _ = ptc.init_modules(init=init, device="cpu")
    back = dict(_leaves(bridge.calc_params_to_flax(enc.state_dict())))
    for k, v in _leaves(init["enc"]):
        np.testing.assert_array_equal(back[k], v)
    _, dec = ptc.init_modules(init=init, device="cpu")
    back = dict(_leaves(bridge.decoder_params_to_flax(dec.state_dict())))
    for k, v in _leaves(init["dec"]):
        np.testing.assert_array_equal(back[k], v)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    imgs = np.zeros((4, H, W), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptc.train_encoder(imgs, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptc.train_encoder_pairs(imgs, imgs, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptc.render_corpus_pairs(n_places=2, n_scenes=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptc.preprocess_corpus(imgs)


def test_pairs_training_separates_places(corpus):
    """tests/test_config_models.py's bar for the shipped training path, on
    the port's own draws: same place above different place on average by
    0.05, and by more than the untrained encoder, after 60 steps on the 8
    rendered real-parallax pairs.  (On that test's blob images 60 steps are
    too few in either package: the similarities first collapse toward 1.)"""
    A, B = torch.from_numpy(corpus["A"]), torch.from_numpy(corpus["B"])

    def gap(params):
        model = pcalc.DescriptorModel(params)
        za, zb = model(A).numpy(), model(B).numpy()
        np.testing.assert_allclose(np.linalg.norm(za, axis=1), 1.0, atol=1e-3)
        S = za @ zb.T
        return np.diag(S).mean(), S[~np.eye(len(S), dtype=bool)].mean()

    enc, _ = ptc.init_modules(seed=0, device="cpu")
    pos0, neg0 = gap(bridge.calc_params_to_flax(enc.state_dict()))
    params, hist = ptc.train_encoder_pairs(A, B, steps=60, batch=4, seed=0, log_every=20,
                                           device="cpu")
    assert np.isfinite(np.asarray(hist)).all()
    assert hist[-1][0] < hist[0][0], hist
    pos, neg = gap(params)
    assert pos > neg + 0.05, f"pos {pos:.4f} vs neg {neg:.4f}"
    assert pos - neg > pos0 - neg0, f"gap {pos - neg:.4f}, untrained {pos0 - neg0:.4f}"
