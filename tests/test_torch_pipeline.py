"""Port parity of the whole slice: ``image_step`` over the 20-frame 6-DoF
course of test_pipeline_golden_6dof.py (ring width 2048, render width 560).

The ring images come from the JAX ``split_scan`` and go to both engines;
the port runs on the CPU (the kernels' plain versions).  Per frame:

* ``n_edges`` equal (same smoothness up to float32 reordering, bit-exact
  selection);
* the port's pose within 1 cm and 1e-3 rad of JAX ``image_step``;
* the port's pose within the bounds test_pipeline_golden_6dof.py:96-97
  holds the JAX engine to (2 cm, 2e-3 rad) of the float64 oracle
  ``golden_frame_loop`` (tests/golden.py:375).

The oracle takes minutes on this course, so its poses are recorded below:
``GOLDEN_6DOF`` is ``golden_frame_loop`` run on exactly these scans with
the configuration's parameters (q wxyz, t), printed to 12 decimals.
"""

import numpy as np
import jax.numpy as jnp
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory_6dof
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import pipeline as P

from golden import golden_quat_conj, golden_quat_mul

torch.set_num_threads(1)

N_FRAMES = 20
WIDTH = 560

GOLDEN_6DOF = np.array([
    (1.000000000000, 0.000000000000, 0.000000000000, 0.000000000000, 0.000000000000, 0.000000000000, 0.000000000000),
    (0.999906023619, 0.003082474674, 0.002577426153, 0.013107217689, 0.145816989553, -0.033635297057, 0.039477199990),
    (0.999585393826, 0.006043744199, 0.004041418555, 0.027860016909, 0.469142557485, -0.070534161626, 0.083499992360),
    (0.999041820270, 0.009257558278, 0.004658887719, 0.042520979894, 0.986515326583, -0.084481456258, 0.135785280739),
    (0.998316372663, 0.012177101810, 0.004428565848, 0.056537828656, 1.691384659001, -0.075081291193, 0.189250679904),
    (0.997371389202, 0.014467770688, 0.002715118771, 0.070948035513, 2.508994797558, -0.029209219973, 0.248717070056),
    (0.996272510390, 0.016713143817, 0.000693241514, 0.084624318500, 3.404625589267, 0.083339593066, 0.303834327876),
    (0.994924297618, 0.018819535437, -0.001933176108, 0.098831826483, 4.348681897850, 0.242421514276, 0.358126862408),
    (0.993318411924, 0.020357360228, -0.005396404155, 0.113468009761, 5.299105763744, 0.428924053741, 0.408253693432),
    (0.991421644434, 0.021460446490, -0.009217305567, 0.128598652646, 6.245148110931, 0.629092681644, 0.455488206331),
    (0.989333781021, 0.021956936661, -0.012997637678, 0.143414169725, 7.190478420791, 0.865876247085, 0.499357360360),
    (0.986988315787, 0.022158402368, -0.016938124820, 0.158354569345, 8.125234926954, 1.139244381231, 0.537987713233),
    (0.984418856577, 0.021783339874, -0.020701899263, 0.173252510186, 9.048964076881, 1.482681330268, 0.572167739002),
    (0.981799084747, 0.021012441239, -0.023790836228, 0.187251249966, 9.968958703081, 1.812661931847, 0.600417188433),
    (0.978867642681, 0.019546915230, -0.026408568936, 0.201838162159, 10.871242787254, 2.169766487914, 0.625556585363),
    (0.975770266884, 0.017456844211, -0.028346072898, 0.216250190765, 11.761054333652, 2.541720760170, 0.646255599312),
    (0.972376443626, 0.014921521447, -0.029733798229, 0.231035281554, 12.639147687273, 2.948340466817, 0.661474189511),
    (0.968758232647, 0.011777898228, -0.030157297124, 0.245884739710, 13.502967357396, 3.382847257238, 0.671701081400),
    (0.965190999308, 0.008315785451, -0.030105744321, 0.259674462985, 14.356216164377, 3.851566420024, 0.677823596456),
    (0.961366495968, 0.004192689767, -0.029117937621, 0.273695136040, 15.198611716886, 4.364302236635, 0.683959543297),
])


def _quat_angle(qa, qb):
    d = golden_quat_mul(golden_quat_conj(np.asarray(qa, np.float64)),
                        np.asarray(qb, np.float64))
    return 2.0 * np.arccos(np.clip(abs(d[0]), -1.0, 1.0))


def test_image_step_tracks_jax_and_oracle_6dof():
    jcfg = JConfig(local_map_size=5, ring_width=2048)
    cfg = LiodomConfig(local_map_size=5, ring_width=2048)
    world = BoxWorld(seed=5)
    pos, rots, _ = drive_trajectory_6dof(N_FRAMES, speed=1.0, yaw_rate=0.03)
    jstate = JP.init_state(jcfg)
    state = P.init_state(cfg, device="cpu")
    div_jax_t, div_jax_r, div_gold_t, div_gold_r = [], [], [], []
    for i in range(N_FRAMES):
        scan = world.render(pos[i], rots[i], width=WIDTH, noise=0.01,
                            seed=500 + i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        jstate, jpose, jn = JP.image_step(jstate, img.xyz, img.count, jcfg)
        state, pose, n = P.image_step(
            state, torch.from_numpy(np.array(img.xyz)),
            torch.from_numpy(np.array(img.count)), cfg)
        assert int(n) == int(jn), f"frame {i}: {int(n)} vs {int(jn)} edges"
        assert int(n) > 100
        q, t = pose.q.numpy(), pose.t.numpy()
        div_jax_t.append(float(np.linalg.norm(t - np.asarray(jpose.t))))
        div_jax_r.append(_quat_angle(q, np.asarray(jpose.q)))
        g = GOLDEN_6DOF[i]
        div_gold_t.append(float(np.linalg.norm(t - g[4:])))
        div_gold_r.append(_quat_angle(q, g[:4]))
    assert max(div_jax_t) < 0.01, div_jax_t
    assert max(div_jax_r) < 1e-3, div_jax_r
    assert max(div_gold_t) < 0.02, div_gold_t
    assert max(div_gold_r) < 2e-3, div_gold_r
    # the course moved and drifted (the comparison is not vacuous)
    assert np.linalg.norm(GOLDEN_6DOF[-1, 4:]) > 10.0
    assert np.linalg.norm(GOLDEN_6DOF[-1, 4:] - pos[-1]) > 0.02
