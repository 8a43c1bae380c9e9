"""The port's SIFT bootstrap (``bootstrap_method="sift"``: SIFT on both
frames, ratio-test matching, the essential RANSAC on the reference's draws,
cheirality pose, triangulation) against the JAX bootstrap on the CPU.

Scene and config: ``tests/test_torch_vo.py``'s (the textured scene at
96x160, ``kitti_tuned_config()`` with 128-slot tables), frames 0 and 2,
with the preset's SIFT bootstrap and 128 SIFT features (the table size).
Seed 9: at this size SIFT keeps 30-60 keypoints a frame, and seed 7 (the
KLT slice's) leaves 10-20 matches; the essential RANSAC is also
rounding-sensitive on scenes whose hypotheses score alike (ROADMAP.md
Queue 3 item 5).

Tolerances: the same status; the same ratio matches; landmark counts within
2; the bootstrap pose (|t| = 1) within 1e-3 element by element.
"""
import jax
import numpy as np
import torch

from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.core.config import kitti_tuned_config
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic
from monocular_visual_odometry_va4mr_tpu.ops import match as jmatch
from monocular_visual_odometry_va4mr_tpu.ops import sift as jsift
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    kitti_tuned_config as t_kitti_tuned_config)
from monocular_visual_odometry_va4mr_torch.ops import match as tmatch
from monocular_visual_odometry_va4mr_torch.ops import sift as tsift
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry
from test_torch_vo import JaxBank, jax_state_dict, small_config

torch.set_num_threads(1)

STRIDE = 2
SEED = 9
LM_TOL = 2
POSE_TOL = 1e-3


def sift_config(base):
    return small_config(base).replace(bootstrap_method="sift")


def test_sift_bootstrap_matches_reference():
    scene = synthetic.make_textured_scene(seed=SEED, num_frames=STRIDE + 1,
                                          image_shape=(96, 160), step=1.0)
    f0, f1 = scene.render(0), scene.render(STRIDE)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    jvo = JVO(JCamera.from_matrix(scene.K), sift_config(kitti_tuned_config))
    j = jax_state_dict(jvo.bootstrap(f0, f1, key))

    bank = JaxBank()
    bank.key = key
    tvo = VisualOdometry(Camera.from_matrix(scene.K),
                         sift_config(t_kitti_tuned_config), "cpu",
                         sampler=bank)
    t = tvo.bootstrap(f0, f1).to_numpy()

    # The correspondences the geometry starts from: the same matches.
    sc = tvo.config.sift
    kw = dict(max_features=tvo.config.capacity.max_candidates)
    jf = [jsift.detect_and_compute(np.asarray(f, np.float32), **kw)
          for f in (f0, f1)]
    tf = [tsift.detect_and_compute(torch.from_numpy(f), **kw)
          for f in (f0, f1)]
    j_ok = np.asarray(jmatch.match_ratio(jf[0].desc, jf[0].valid, jf[1].desc,
                                         jf[1].valid, ratio=sc.ratio)[1])
    t_ok = tmatch.match_ratio(tf[0].desc, tf[0].valid, tf[1].desc,
                              tf[1].valid, ratio=sc.ratio)[1].numpy()
    assert j_ok.sum() == t_ok.sum() >= 16

    assert int(j["status"]) == int(t["status"]) == 0
    assert int(j["n_tracked"]) == int(t["n_tracked"]) == int(j_ok.sum())
    n_j, n_t = int(j["lm_valid"].sum()), int(t["lm_valid"].sum())
    assert n_j >= 8 and abs(n_j - n_t) <= LM_TOL
    np.testing.assert_allclose(t["T_CW"], j["T_CW"], rtol=0, atol=POSE_TOL)
