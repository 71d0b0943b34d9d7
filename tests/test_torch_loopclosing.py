"""The loop closer of the torch port against the JAX package's, stage by stage
and as a whole, from bridged JAX states.

A JAX ``StereoSlam`` runs ``tests/test_system_loop.py``'s circuit (240x376,
HOG descriptor, that test's loop thresholds) up to the keyframe whose
detection closes the first loop; the state its closer held there goes through
``stereoslam_tpu_torch.bridge`` to the port's closer, which is fed the same
PnP minimal sets (the JAX draws, replayed with ``jax.random``).

Tolerances: verdicts (``found``, ``loop_kf``, ``verified``, ``need_correct``,
``applied``, closed) equal; integer and boolean map and loop fields, the
landmark merge and the remap table exact; similarities within 1e-5; the
verified pose within 1e-3; poses after the pose-graph optimization within
2e-3 and landmark positions within 2e-2 m; ``post_correction_unlink`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu import config as jconfig  # noqa: E402
from stereoslam_tpu.core import loopclosing as jloop  # noqa: E402
from stereoslam_tpu.core import state as jstate  # noqa: E402
from stereoslam_tpu.core.system import StereoSlam as JaxSlam  # noqa: E402
from stereoslam_tpu.models.calc import DescriptorModel as JDescriptorModel  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core import loopclosing as ploop  # noqa: E402
from stereoslam_tpu_torch.core.state import TrackState  # noqa: E402
from stereoslam_tpu_torch.models.calc import DescriptorModel  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from tests.test_loop_guard import _chain_map, _register_edge, _small_cfg  # noqa: E402
from tests.test_torch_loop_ops import _jax_sets  # noqa: E402

INT_FIELDS = ("kf_valid", "kf_frame_id", "kf_feat_lm", "kf_feat_valid", "kf_prev", "kf_loop",
              "n_kf", "lm_valid", "lm_outlier", "lm_first_kf", "lm_obs_count", "n_lm",
              "active_kf", "n_active", "last_ba_frame")


def loop_cfg(mod, seq):
    """tests/test_system_loop.py loop_cfg, for either package's config module."""
    cfg = mod.SlamConfig(
        camera=mod.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                                fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                                bf=seq.fx * seq.baseline),
        features=mod.FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                                   num_features_init_good=50, num_features_tracking_good=50,
                                   num_features_tracking_bad=10),
        map=mod.MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=seq.left.shape[1], image_width=seq.left.shape[2],
    )
    return cfg.replace(
        loop=mod.LoopClosingConfig(similarity_high=0.93, similarity_low=0.92, max_above_low=6,
                                   database_min_size=5, id_gap=10, min_matches=10,
                                   min_inliers=10, correction_threshold=0.5),
        tracking=dataclasses.replace(cfg.tracking, lk_levels=4),
    )


def _np(nt):
    return {k: (_np(v) if hasattr(v, "_asdict") else np.array(v)) for k, v in nt._asdict().items()}


class _Closed(Exception):
    pass


@pytest.fixture(scope="module")
def snap():
    """The JAX closer's inputs and outputs at the first closing keyframe."""
    seq = generate_sequence(n_frames=150, loop_frames=120, trajectory="loop", speed=0.35,
                            seed=7, n_points=900)
    slam = JaxSlam(loop_cfg(jconfig, seq), enable_backend=True, enable_loop=True,
                   descriptor_model=JDescriptorModel())
    lc = slam._loop_closer
    finish = lc.finish_detect
    out = {}

    def hook(map_state, loop, token):
        state = dict(map=_np(map_state), loop=_np(loop), key=lc._key, fs=_np(slam.fs),
                     counters=(lc._host_last_closed, lc._host_db_size))
        res = finish(map_state, loop, token)
        if token is not None and token[0] == "detect" and res[2]:
            remap = lc._last_remap
            out.update(state, token=token, result=(_np(res[0]), _np(res[1]), res[2], res[3]),
                       remap=None if remap is None else np.asarray(remap))
            raise _Closed
        return res

    lc.finish_detect = hook
    with pytest.raises(_Closed):
        for t in range(len(seq.left)):
            assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    out.update(seq=seq, jlc=lc, jcfg=loop_cfg(jconfig, seq), pcfg=loop_cfg(pconfig, seq))
    return out


def _port_closer(s):
    pc = ploop.LoopCloser(s["pcfg"], bridge.intrinsics_from_config(s["pcfg"])[0], "cpu",
                          descriptor_model=DescriptorModel())
    pc._host_last_closed, pc._host_db_size = s["counters"]
    sub = jax.random.split(s["key"])[1]
    iters = s["pcfg"].loop.pnp_ransac_iters
    pc.draw_sets = lambda valid: tuple(torch.from_numpy(x).long()
                                       for x in _jax_sets(valid.numpy(), sub, iters))
    return pc, sub


def _states(s):
    return bridge.map_state_from_numpy(s["map"], "cpu"), bridge.loop_state_from_numpy(s["loop"], "cpu")


def _assert_map_close(got, ref, pose_atol=2e-3, pos_atol=2e-2):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("kf_T_cw", "kf_rel_loop"):
        np.testing.assert_allclose(got[k], ref[k], atol=pose_atol, err_msg=k)
    np.testing.assert_allclose(got["lm_pos"], ref["lm_pos"], atol=pos_atol)


def test_detect_stage(snap):
    kf = snap["token"][1]
    det_j, packed_j = snap["jlc"]._jit_detect(_jax_states(snap)[1], jnp.int32(kf))
    pc, _ = _port_closer(snap)
    det_p, packed_p = pc._detect_impl(_states(snap)[1], kf)
    assert bool(det_p.found) and bool(det_j.found)
    assert int(det_p.loop_kf) == int(det_j.loop_kf)
    assert abs(float(det_p.max_score) - float(det_j.max_score)) < 1e-5
    np.testing.assert_allclose(packed_p.numpy(), np.asarray(packed_j), atol=1e-5)


def _jax_states(s, m=None):
    return (jstate.MapState(**jax.tree.map(jnp.asarray, m or s["map"])),
            jstate.LoopState(**jax.tree.map(jnp.asarray, s["loop"])))


def test_verify_stage_same_sets(snap):
    kf, loop_kf = snap["token"][1], int(snap["result"][3])
    pc, sub = _port_closer(snap)
    mj, lj = _jax_states(snap)
    vj, pj, mj_out = snap["jlc"]._jit_verify(mj, lj, jnp.int32(kf), jnp.int32(loop_kf), sub)
    vp, pp, mp_out = pc._verify_impl(*_states(snap), kf, loop_kf)
    assert bool(vp.verified) == bool(vj.verified) is True
    assert bool(vp.need_correct) == bool(vj.need_correct)
    np.testing.assert_array_equal(vp.match_loop_feat.numpy(), np.asarray(vj.match_loop_feat))
    assert int(vp.num_inliers) == int(vj.num_inliers)
    np.testing.assert_allclose(vp.T_corrected.numpy(), np.asarray(vj.T_corrected), atol=1e-3)
    np.testing.assert_allclose(pp.numpy()[:4], np.asarray(pj), atol=1e-3)
    assert pp[5] == vp.num_inliers and pp[4] >= pp[5]
    _assert_map_close(bridge.map_state_to_numpy(mp_out), _np(mj_out), pose_atol=1e-3, pos_atol=0)


@pytest.fixture(scope="module")
def corrected(snap):
    """The JAX verifier's outputs at the closing keyframe and the JAX
    correction applied to them (whether or not the pose error asked for it)."""
    kf, loop_kf = snap["token"][1], int(snap["result"][3])
    mj, lj = _jax_states(snap)
    vj, _, mj_v = snap["jlc"]._jit_verify(mj, lj, jnp.int32(kf), jnp.int32(loop_kf),
                                          jax.random.split(snap["key"])[1])
    assert bool(vj.verified)
    out = snap["jlc"]._jit_correct(mj_v, lj, jnp.int32(kf), jnp.int32(loop_kf), vj.T_corrected,
                                   vj.match_loop_feat)
    return dict(verify=vj, map_in=_np(mj_v), map=_np(out[0]), loop=_np(out[1]),
                remap=np.asarray(out[2]), packed=np.asarray(out[3]))


def test_correct_stage(snap, corrected):
    """Correction from the JAX verifier's pose and pairs, so that this stage
    alone is compared."""
    kf, loop_kf = snap["token"][1], int(snap["result"][3])
    vj = corrected["verify"]
    pc, _ = _port_closer(snap)
    mp_out, lp_out, remap_p, cp = pc._correct_impl(
        bridge.map_state_from_numpy(corrected["map_in"], "cpu"), _states(snap)[1], kf, loop_kf,
        torch.from_numpy(np.array(vj.T_corrected)), torch.from_numpy(np.array(vj.match_loop_feat)))
    assert bool(cp[0]) == bool(corrected["packed"][0]) is True
    assert (np.asarray(vj.match_loop_feat) >= 0).sum() >= 10
    np.testing.assert_allclose(cp.numpy(), corrected["packed"], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(remap_p.numpy(), corrected["remap"])
    assert (remap_p.numpy() != np.arange(len(remap_p))).sum() > 0   # some landmarks merged
    _assert_map_close(bridge.map_state_to_numpy(mp_out), corrected["map"])
    assert int(lp_out.last_closed_kf) == int(corrected["loop"]["last_closed_kf"]) == kf
    assert pc.times["pgo_gn"] and pc.times["pgo_cg"][0] >= pc.times["pgo_gn"][0]


def test_finish_detect_slice_as_a_whole(snap):
    """One ``finish_detect`` of the port from the JAX state at the closing
    keyframe: the same verdict, loop KF, map, loop database and merge."""
    m_ref, l_ref, closed_ref, loop_kf_ref = snap["result"]
    pc, _ = _port_closer(snap)
    m_p, l_p = _states(snap)
    token = pc.start_detect(l_p, snap["token"][1])
    assert token is not None and token[0] == "detect"
    m_out, l_out, closed, loop_kf = pc.finish_detect(m_p, l_p, token)
    assert (closed, loop_kf) == (closed_ref, loop_kf_ref) and closed
    _assert_map_close(bridge.map_state_to_numpy(m_out), m_ref)
    got_loop = bridge.loop_state_to_numpy(l_out)
    for k in ("db_valid", "orb_class", "orb_valid", "last_closed_kf"):
        np.testing.assert_array_equal(got_loop[k], l_ref[k], err_msg=k)
    np.testing.assert_array_equal(got_loop["orb_desc"].view(np.uint32), l_ref["orb_desc"])
    if snap["remap"] is None:
        assert pc._last_remap is None
    else:
        np.testing.assert_array_equal(pc._last_remap.numpy(), snap["remap"])
    assert pc._host_last_closed == snap["jlc"]._host_last_closed


def test_post_correction_unlink_exact(snap, corrected):
    m_ref = corrected["map"]
    fs = snap["fs"]
    tr = fs["tracks"]
    remap = corrected["remap"]
    lm_idx = np.where(tr["lm_idx"] >= 0, remap[np.maximum(tr["lm_idx"], 0)], tr["lm_idx"])
    intr_j = JIntr.create(*(getattr(snap["jcfg"].camera, k) for k in ("fx", "fy", "cx", "cy")))
    tj, nj = jloop.post_correction_unlink(
        jstate.TrackState(xy=jnp.asarray(tr["xy"]), lm_idx=jnp.asarray(lm_idx),
                          valid=jnp.asarray(tr["valid"])),
        jnp.asarray(fs["T_rk"]), jnp.asarray(fs["ref_kf"]),
        jstate.MapState(**jax.tree.map(jnp.asarray, m_ref)), intr_j)
    tp, n_p = ploop.post_correction_unlink(
        TrackState(xy=torch.from_numpy(tr["xy"]), lm_idx=torch.from_numpy(lm_idx),
                   valid=torch.from_numpy(tr["valid"])),
        torch.from_numpy(fs["T_rk"]), torch.from_numpy(fs["ref_kf"]),
        bridge.map_state_from_numpy(m_ref, "cpu"), bridge.intrinsics_from_config(snap["pcfg"])[0])
    np.testing.assert_array_equal(tp.lm_idx.numpy(), np.asarray(tj.lm_idx))
    assert int(n_p) == int(nj)


@pytest.mark.parametrize("case", ["garbage_rolls_back", "plausible_applies"])
def test_rollback_guard(case):
    """tests/test_loop_guard.py's two correction cases on its chain map."""
    jcfg = _small_cfg()
    pcfg = pconfig.SlamConfig(
        features=pconfig.FeatureConfig(**dataclasses.asdict(jcfg.features)),
        map=pconfig.MapConfig(**dataclasses.asdict(jcfg.map)))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    intr = (160.0, 160.0, 94.0, 60.0)
    jlc = jloop.LoopCloser(jcfg, JIntr.create(*intr), descriptor_model=JDescriptorModel())
    m, T_cw = _chain_map(jcfg, K=48)
    kf_id, loop_kf = 47, 2
    if case == "garbage_rolls_back":
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [80.0, -40.0, 60.0]
    else:
        T = T_cw[kf_id].copy()
        T[0, 3] += 0.25
    m_in = _register_edge(m, kf_id, loop_kf, T)
    loop = jstate.init_loop_state(jcfg)
    no_pairs = np.full((m.kf_feat_lm.shape[1],), -1, np.int32)
    mj, lj, remap_j, cj = jlc._jit_correct(m_in, loop, jnp.int32(kf_id), jnp.int32(loop_kf),
                                           jnp.asarray(T), jnp.asarray(no_pairs))
    pc = ploop.LoopCloser(pcfg, Intrinsics.create(*intr), "cpu", descriptor_model=DescriptorModel())
    mp, lp, remap_p, cp = pc._correct_impl(
        bridge.map_state_from_numpy(_np(m_in), "cpu"), bridge.loop_state_from_numpy(_np(loop), "cpu"),
        kf_id, loop_kf, torch.from_numpy(T), torch.from_numpy(no_pairs))
    applied = case == "plausible_applies"
    assert bool(cp[0]) == bool(cj[0]) == applied
    mp_np = bridge.map_state_to_numpy(mp)
    _assert_map_close(mp_np, _np(mj))
    np.testing.assert_array_equal(remap_p.numpy(), np.asarray(remap_j))
    if applied:
        assert int(mp_np["kf_loop"][kf_id]) == loop_kf
        np.testing.assert_allclose(mp_np["kf_T_cw"][kf_id], T, atol=1e-4)
        assert int(lp.last_closed_kf) == kf_id
    else:
        np.testing.assert_allclose(mp_np["kf_T_cw"][:48], T_cw, atol=1e-6)
        assert int(mp_np["kf_loop"][kf_id]) == -1
        np.testing.assert_array_equal(remap_p.numpy(), np.arange(m.capacity_lm))
