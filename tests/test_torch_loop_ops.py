"""Loop-closing ops of the torch port against the JAX package, at 240x376.

Tolerances:
- ``gaussian_blur``, ``resize_bilinear``, ``build_pyramid``: atol 1e-4 on
  [0, 255] pixels (float32 sums in another order);
- ``fast_corner_check_at``, ``hamming_matrix``, ``match_descriptors``: exact;
- ``ic_angles``: atol 1e-4 rad;
- ``brief_descriptors``: bit for bit from the JAX blurred image and angles;
- ``pyramid_orb``: validity, classes and positions exact, descriptor words
  equal on at least 99% of the valid rows (the port's own blur and angles);
- ``quartic_real_roots`` / ``p3p_poses``: the same valid candidates (98% of
  the roots), roots within 1e-3 (relative), pose twists within 1e-3 in the
  median;
- ``pnp_ransac`` on the same index sets: the same best hypothesis, inlier
  set and count, both poses within 0.06 of the truth;
- ``optimize_pose_graph`` on ``tests/test_loop_ops.py``'s loop chain: poses
  within 2e-3, fixed vertices bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.ops import brief as jbrief  # noqa: E402
from stereoslam_tpu.ops import fast as jfast  # noqa: E402
from stereoslam_tpu.ops import hamming as jham  # noqa: E402
from stereoslam_tpu.ops import image as jimage  # noqa: E402
from stereoslam_tpu.ops import orient as jorient  # noqa: E402
from stereoslam_tpu.ops import p3p as jp3p  # noqa: E402
from stereoslam_tpu.ops import pgo as jpgo  # noqa: E402
from stereoslam_tpu.ops import pnp as jpnp  # noqa: E402
from stereoslam_tpu.ops import se3 as jse3  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntrinsics  # noqa: E402
from stereoslam_tpu.ops.orb import pyramid_orb as j_pyramid_orb  # noqa: E402
from stereoslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from stereoslam_tpu_torch.config import SlamConfig  # noqa: E402
from stereoslam_tpu_torch.ops import brief as pbrief  # noqa: E402
from stereoslam_tpu_torch.ops import fast as pfast  # noqa: E402
from stereoslam_tpu_torch.ops import hamming as pham  # noqa: E402
from stereoslam_tpu_torch.ops import image as pimage  # noqa: E402
from stereoslam_tpu_torch.ops import orient as porient  # noqa: E402
from stereoslam_tpu_torch.ops import p3p as pp3p  # noqa: E402
from stereoslam_tpu_torch.ops import pgo as ppgo  # noqa: E402
from stereoslam_tpu_torch.ops import pnp as ppnp  # noqa: E402
from stereoslam_tpu_torch.ops import se3 as pse3  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics  # noqa: E402
from stereoslam_tpu_torch.ops.orb import pyramid_orb  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

INTR = Intrinsics.create(400.0, 400.0, 320.0, 160.0)
JINTR = JIntrinsics.create(400.0, 400.0, 320.0, 160.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _words(d):
    """JAX uint32 descriptor words as the port's int32 words (same bits)."""
    return np.asarray(d).view(np.int32)


@pytest.fixture(scope="module")
def frame():
    seq = generate_sequence(n_frames=2, h=240, w=376, n_points=900, seed=7)
    return seq.left[1].astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def keypoints(frame):
    k = jfast.detect_keypoints(jnp.asarray(frame), 256)
    return np.asarray(k.xy), np.asarray(k.valid)


# ---------------------------------------------------------------- image
@pytest.mark.parametrize("kw", [{}, dict(sigma=1.4, radius=4, sigma_x=3.2, radius_x=8)])
def test_gaussian_blur_matches(frame, kw):
    a = jimage.gaussian_blur(jnp.asarray(frame), **kw)
    b = pimage.gaussian_blur(_t(frame), **kw)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(240, 376), (237, 375)])
def test_resize_and_build_pyramid_match(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    # Eager JAX: under jit XLA may fuse the sample centres into an FMA, and
    # one ulp of a centre moves a 255-step edge by up to 8e-3.
    np.testing.assert_allclose(np.asarray(jimage.resize_bilinear(jnp.asarray(img), (120, 160))),
                               pimage.resize_bilinear(_t(img), (120, 160)).numpy(),
                               atol=1e-4, rtol=0)
    pj = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
    pp = pimage.build_pyramid(_t(img), 8, 1.2)
    assert [a.shape for a in pj] == [tuple(b.shape) for b in pp]
    assert pimage.pyramid_shapes(*shape, 8, 1.2) == jimage.pyramid_shapes(*shape, 8, 1.2)
    for a, b in zip(pj, pp):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------- features
def test_fast_corner_check_at_exact(rng, frame, keypoints):
    xy = np.concatenate([keypoints[0], rng.uniform(-4, [380, 244], (300, 2)).astype(np.float32),
                         np.array([[0, 0], [375, 239], [2.5, 120.5], [3.5, 5.5]], np.float32)])
    for th in (7.0, 20.0):
        a = jfast.fast_corner_check_at(jnp.asarray(frame), jnp.asarray(xy), th)
        b = pfast.fast_corner_check_at(_t(frame), _t(xy), th)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert b.sum() > 50


def test_ic_angles_match(frame, keypoints):
    xy = keypoints[0]
    a = jorient.ic_angles(jnp.asarray(frame), jnp.asarray(xy))
    b = porient.ic_angles(_t(frame), _t(xy))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)


def test_brief_bit_exact_from_jax_blur(rng, frame, keypoints):
    xy = np.concatenate([keypoints[0], np.array([[1, 1], [374, 238], [20, 20]], np.float32)])
    blurred = jimage.gaussian_blur(jnp.asarray(frame))
    ang = np.array(jorient.ic_angles(jnp.asarray(frame), jnp.asarray(xy)))
    ang[-3:] = [3.1, -2.0, 0.7]
    a = jbrief.brief_descriptors(blurred, jnp.asarray(xy), jnp.asarray(ang))
    b = pbrief.brief_descriptors(_t(blurred), _t(xy), _t(ang))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(_words(a), b.numpy())


def test_pyramid_orb_matches(frame, keypoints):
    xy, valid = keypoints
    a = jax.jit(lambda img, xy, v: j_pyramid_orb(img, xy, v, JSlamConfig()))(
        jnp.asarray(frame), jnp.asarray(xy), jnp.asarray(valid))
    b = pyramid_orb(_t(frame), _t(xy), _t(valid), SlamConfig())
    assert b.desc.shape == (256 * 8, 8)
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
    np.testing.assert_array_equal(np.asarray(a.cls), b.cls.numpy())
    np.testing.assert_array_equal(np.asarray(a.xy), b.xy.numpy())
    v = b.valid.numpy()
    same = (_words(a.desc) == b.desc.numpy()).all(-1)[v]
    assert v.sum() > 200 and same.mean() >= 0.99, same.mean()


# ---------------------------------------------------------------- hamming
def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _flip_bits(rng, d, nbits):
    d = d.copy()
    for i in range(len(d)):
        for _ in range(nbits):
            d[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    return d


def test_hamming_matrix_exact(rng):
    a, b = _rand_desc(rng, 70), _rand_desc(rng, 90)
    b[:5] = a[:5]
    b[5] = np.uint32(0xFFFFFFFF)
    d = pham.hamming_matrix(_t(a.view(np.int32)), _t(b.view(np.int32)))
    np.testing.assert_array_equal(np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))),
                                  d.numpy())
    assert (np.diag(d.numpy()[:5, :5]) == 0).all()


def _match_case(rng, case):
    n = 64
    base = _rand_desc(rng, n)
    if case == "noisy_pairs":
        a, b = base, _flip_bits(rng, base, 4)
        cls_a = cls_b = np.arange(n, dtype=np.int32)
        va, vb = np.ones(n, bool), np.ones(n, bool)
    elif case == "dedup_by_class":
        a = np.concatenate([base, _flip_bits(rng, base, 1)])
        b = a
        cls_a = cls_b = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
        va, vb = np.ones(2 * n, bool), np.ones(2 * n, bool)
    else:  # ties: duplicate rows in b, equal-distance clones in a, invalid slots
        b = np.concatenate([base, base[:20]])
        a = np.concatenate([_flip_bits(rng, base, 2), base[:10], base[:10]])
        cls_a = np.concatenate([np.arange(n), np.arange(10), np.arange(10)]).astype(np.int32)
        cls_b = np.concatenate([np.arange(n), np.arange(20)]).astype(np.int32)
        va, vb = rng.uniform(size=len(a)) > 0.1, rng.uniform(size=len(b)) > 0.1
    return a, va, b, vb, cls_a, cls_b, n


@pytest.mark.parametrize("case", ["noisy_pairs", "dedup_by_class", "ties"])
def test_match_descriptors_exact(rng, case):
    a, va, b, vb, ca, cb, n = _match_case(rng, case)
    rj = jham.match_descriptors(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
                                jnp.asarray(ca), jnp.asarray(cb), max_features=n)
    rp = pham.match_descriptors(_t(a.view(np.int32)), _t(va), _t(b.view(np.int32)), _t(vb),
                                _t(ca), _t(cb), max_features=n)
    np.testing.assert_array_equal(np.asarray(rj.best_idx), rp.best_idx.numpy())
    np.testing.assert_array_equal(np.asarray(rj.best_dist), rp.best_dist.numpy())
    np.testing.assert_array_equal(np.asarray(rj.accepted), rp.accepted.numpy())
    assert rp.accepted.sum() > 0.5 * n


# ---------------------------------------------------------------- p3p / pnp
def test_quartic_real_roots_match(rng):
    c = rng.standard_normal((400, 5)).astype(np.float32)
    c = c[np.abs(c[:, 0]) >= 0.05]
    rj, okj = jax.vmap(jp3p.quartic_real_roots)(*[jnp.asarray(c[:, i]) for i in range(5)])
    rp, okp = pp3p.quartic_real_roots(*[_t(c[:, i]) for i in range(5)])
    okj, rj = np.asarray(okj), np.asarray(rj)
    assert (okj == okp.numpy()).mean() >= 0.98
    both = okj & okp.numpy()
    np.testing.assert_allclose(rp.numpy()[both], rj[both], rtol=1e-3, atol=1e-3)
    # The port's roots are the real roots numpy finds.
    misses = 0
    for row, r, ok in zip(c, rp.numpy(), okp.numpy()):
        true = np.roots(row.astype(np.float64))
        true = np.sort(true[np.abs(true.imag) < 1e-6].real)
        got = np.sort(r[ok])
        misses += len(got) != len(true) or (len(true) and np.abs(got - true).max()
                                             > 2e-2 * max(1.0, np.abs(true).max()))
    assert misses <= 0.05 * len(c)


def _p3p_cases(rng, planar, n=40):
    Xs, pns, Ts = [], [], []
    while len(Xs) < n:
        lo, hi = ([-6, -0.01, 5], [6, 0.01, 25]) if planar else ([-5, -3, 4], [5, 3, 30])
        X = rng.uniform(lo, hi, (3, 3)).astype(np.float32)
        xi = (rng.standard_normal(6) * np.array([0.2] * 3 + [0.5] * 3)).astype(np.float32)
        T = pse3.exp(_t(xi)).numpy()
        Pc = (T[:3, :3] @ X.T).T + T[:3, 3]
        if (Pc[:, 2] < 0.5).any():
            continue
        Xs.append(X)
        pns.append(Pc[:, :2] / Pc[:, 2:3])
        Ts.append(T)
    return np.stack(Xs), np.stack(pns).astype(np.float32), np.stack(Ts)


@pytest.mark.parametrize("planar", [False, True])
def test_p3p_poses_match(rng, planar):
    X, pn, T = _p3p_cases(rng, planar)
    cj, okj = jax.jit(jax.vmap(jp3p.p3p_poses))(jnp.asarray(X), jnp.asarray(pn))
    cp, okp = pp3p.p3p_poses(_t(X), _t(pn))
    cj, okj, cp, okp = np.asarray(cj), np.asarray(okj), cp.numpy(), okp.numpy()
    assert (okj == okp).mean() >= 0.98
    # The float32 closed form amplifies rounding: where a candidate is far
    # from the truth in one package it is as far in the other, so the
    # candidates agree in the median, not everywhere.
    both = okj & okp
    err = pse3.log(_t(cp[both]) @ pse3.inv(_t(cj[both]))).abs().amax(-1).numpy()
    assert np.median(err) < 1e-3, np.median(err)
    # And the port recovers the true pose.
    errs = [min(pse3.log(_t(c) @ pse3.inv(_t(t))).abs().max().item() for c in cs[ok])
            for cs, ok, t in zip(cp, okp, T) if ok.any()]
    assert len(errs) >= 0.8 * len(T) and np.median(errs) < 1e-3


def _pnp_case(rng, case):
    if case == "outliers":  # tests/test_loop_ops.py
        N = 80
        X = rng.uniform([-5, -3, 5], [5, 3, 30], (N, 3)).astype(np.float32)
        xi = np.array([0.4, -0.2, 0.3, 0.05, -0.02, 0.08], np.float32)
        valid = np.ones(N, bool)
    elif case == "valid_mask":
        N = 40
        X = rng.uniform([-5, -3, 5], [5, 3, 30], (N, 3)).astype(np.float32)
        xi = np.array([0.1, 0.0, 0.2, 0.0, 0.03, 0.0], np.float32)
        valid = np.arange(N) < 20
    elif case == "planar":  # tests/test_p3p.py
        N = 120
        X = rng.uniform([-10, 1.6, 3], [10, 1.7, 40], (N, 3)).astype(np.float32)
        xi = np.array([0.03, -0.02, 0.01, 0.4, -0.2, 0.8], np.float32)
        valid = np.ones(N, bool)
    else:
        N = 120
        X = rng.uniform([-8, -4, 6], [8, 4, 30], (N, 3)).astype(np.float32)
        xi = np.array([0.02, 0.03, -0.01, -0.3, 0.1, 0.5], np.float32)
        valid = np.ones(N, bool)
    T = pse3.exp(_t(xi)).numpy()
    Pc = (T[:3, :3] @ X.T).T + T[:3, 3]
    px = np.stack([INTR.fx * Pc[:, 0] / Pc[:, 2] + INTR.cx,
                   INTR.fy * Pc[:, 1] / Pc[:, 2] + INTR.cy], 1).astype(np.float32)
    if case == "outliers":
        px[:25] += rng.uniform(25, 120, (25, 2)) * np.sign(rng.standard_normal((25, 2)))
    elif case == "valid_mask":
        px[20:] = rng.uniform(0, 600, (20, 2))
    elif case == "planar":
        px += rng.normal(0, 0.3, px.shape).astype(np.float32)
        out = rng.choice(N, N // 7, replace=False)
        px[out] += rng.uniform(40, 120, (len(out), 2)).astype(np.float32)
    return X, px.astype(np.float32), valid, T


def _jax_sets(valid, key, iterations):
    """The minimal sets ``stereoslam_tpu/ops/pnp.py:106-115`` draws."""
    k3, k6 = jax.random.split(key)
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    sets6 = jax.random.categorical(k6, logits[None, :], shape=(max(iterations // 2, 1), 6))
    sets3 = jax.random.categorical(k3, logits[None, :], shape=(iterations, 3))
    return np.asarray(sets3), np.asarray(sets6)


@jax.jit
def _jax_best(X, px, valid, s3, s6):
    """Index of the hypothesis ``stereoslam_tpu/ops/pnp.py:113-140`` picks:
    every P3P candidate of the sets, then the DLT poses, first best score."""
    norm = jax.vmap(lambda s: jpnp._normalize(px[s], JINTR))
    T_dlt = jax.vmap(jpnp._dlt_pose)(X[s6], norm(s6))
    T3, ok3 = jax.vmap(jp3p.p3p_poses)(X[s3], norm(s3))
    far = jnp.eye(4).at[2, 3].set(-1e9)
    T = jnp.concatenate([jnp.where(ok3.reshape(-1)[:, None, None], T3.reshape(-1, 4, 4), far),
                         T_dlt])
    P = jnp.einsum("kij,nj->kni", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = P[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    r = jnp.stack([JINTR.fx * P[..., 0] / zs + JINTR.cx, JINTR.fy * P[..., 1] / zs + JINTR.cy], -1)
    inl = (jnp.sum((r - px[None]) ** 2, -1) <= 5.991) & (z > 0) & valid[None]
    return jnp.argmax(jnp.sum(inl.astype(jnp.int32), 1))


@pytest.mark.parametrize("case", ["outliers", "valid_mask", "planar", "nonplanar"])
def test_pnp_ransac_same_sets(rng, case):
    X, px, valid, T = _pnp_case(rng, case)
    key = jax.random.PRNGKey(3)
    rj = jax.jit(lambda X, px, v, k: jpnp.pnp_ransac(X, px, v, JINTR, k, iterations=128))(
        jnp.asarray(X), jnp.asarray(px), jnp.asarray(valid), key)
    s3, s6 = _jax_sets(valid, key, 128)
    assert valid[s3].all() and valid[s6].all()
    rp = ppnp.pnp_ransac(_t(X), _t(px), _t(valid), INTR, _t(s3).long(), _t(s6).long())
    assert bool(rp.ok) == bool(rj.ok) and bool(rp.ok)
    assert int(rp.best) == int(_jax_best(X, px, valid, s3, s6))
    assert int(rp.num_inliers) == int(rj.num_inliers)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rp.inliers.numpy())
    err = [pse3.log(_t(np.asarray(Tc)) @ pse3.inv(_t(T))).abs().max().item()
           for Tc in (rp.T_cw, rj.T_cw)]
    assert max(err) < 0.06, err


def test_draw_minimal_sets_only_valid_slots():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 11, 40]] = True
    s3, s6 = ppnp.draw_minimal_sets(valid, torch.Generator().manual_seed(7), 128)
    assert s3.shape == (128, 3) and s6.shape == (64, 6)
    assert valid[s3].all() and valid[s6].all()
    assert set(s3.unique().tolist()) == {3, 7, 11, 40}
    s3, _ = ppnp.draw_minimal_sets(torch.zeros(5, dtype=torch.bool), torch.Generator(), 8)
    assert s3.min() >= 0 and s3.max() < 5


# ---------------------------------------------------------------- pgo
def _loop_chain(rng, K=48, n=40):
    """tests/test_loop_ops.py: a 40-pose circle with odometry drift and one
    exact loop edge n-1 -> 0, in a 48-vertex graph."""
    poses_gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        c, s = np.cos(ang), np.sin(ang)
        T_wc = np.eye(4)
        T_wc[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T_wc[:3, 3] = [5.0 * (1 - c), 0, 5.0 * s]
        poses_gt.append(np.linalg.inv(T_wc))
    poses_gt = np.stack(poses_gt).astype(np.float32)
    rel_meas, est = [], [poses_gt[0]]
    for i in range(1, n):
        rel = poses_gt[i] @ np.linalg.inv(poses_gt[i - 1])
        noise = pse3.exp(_t((rng.standard_normal(6) * np.array([0.01] * 3 + [0.002] * 3))
                            .astype(np.float32))).numpy()
        rel_meas.append(noise @ rel)
        est.append(rel_meas[-1] @ est[-1])
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:n] = np.stack(est)
    vertex_valid = np.arange(K) < n
    fixed = (np.arange(K) == 0) | (np.arange(K) >= n)
    E = 2 * K
    edge_i, edge_j = np.zeros(E, np.int32), np.zeros(E, np.int32)
    edge_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    edge_valid = np.zeros(E, bool)
    for i in range(1, n):
        edge_i[i], edge_j[i], edge_meas[i], edge_valid[i] = i, i - 1, rel_meas[i - 1], True
    edge_i[n], edge_j[n], edge_valid[n] = n - 1, 0, True
    edge_meas[n] = poses_gt[n - 1] @ np.linalg.inv(poses_gt[0])
    return (poses, vertex_valid, fixed, edge_i, edge_j, edge_meas.astype(np.float32),
            edge_valid), poses_gt


def test_optimize_pose_graph_matches(rng):
    fields, poses_gt = _loop_chain(rng)
    n = 40
    out_j = np.asarray(jax.jit(jpgo.optimize_pose_graph)(
        jpgo.PoseGraph(*[jnp.asarray(f) for f in fields])))
    stats = {}
    out_p = ppgo.optimize_pose_graph(ppgo.PoseGraph(*[_t(f) for f in fields]), stats=stats)
    np.testing.assert_allclose(out_p.numpy(), out_j, atol=2e-3)
    np.testing.assert_array_equal(out_p.numpy()[n:], fields[0][n:])
    np.testing.assert_array_equal(out_p.numpy()[0], fields[0][0])
    drift = [np.linalg.norm(np.linalg.inv(T[n - 1])[:3, 3] - np.linalg.inv(poses_gt[n - 1])[:3, 3])
             for T in (fields[0], out_p.numpy())]
    assert drift[1] < 0.35 * drift[0]
    assert 1 <= stats["gn_iters"] <= 20 and stats["cg_iters"] >= stats["gn_iters"]


def test_edge_jacobians_match_jax(rng):
    fields, _ = _loop_chain(rng)
    poses, meas = fields[0][:40], fields[5][1:41]
    Ti, Tj = poses[1:], poses[:-1]
    mi = np.asarray(jse3.inv(jnp.asarray(meas[:39])))
    rj, Jij, Jjj = jax.jit(jax.vmap(jpgo._edge_jacobians))(jnp.asarray(Ti), jnp.asarray(Tj),
                                                             jnp.asarray(mi))
    rp, Jip, Jjp = ppgo._edge_jacobians(_t(Ti), _t(Tj), _t(mi))
    for a, b in ((rj, rp), (Jij, Jip), (Jjj, Jjp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
