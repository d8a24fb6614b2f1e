"""Odometry output assembly — the ROS-free ``publishOdom`` (the port's copy
of ``liodom_tpu/runtime/publisher.py``; numpy on the host).

The reference publishes, per frame (laser_odometry.cc:395-446):

* ``nav_msgs::Odometry`` in ``fixed_frame -> base_frame`` with the pose
  re-expressed from the laser frame to the base frame (:402);
* twist from the finite-difference delta pose over the frame interval, with
  the angular part through roll/pitch/yaw to dodge Euler singularities
  (:414-428);
* ``geometry_msgs::TwistStamped`` (:431-436);
* optionally the TF ``fixed -> base`` (:438-445, gated by ``publish_tf``).

Here the same quantities are plain dataclasses a transport layer (ROS bridge,
gRPC, logging) can serialise; :class:`OdomPublisher` holds the
previous-frame state needed for the finite differences.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _rpy(R: np.ndarray) -> np.ndarray:
    """ZYX roll/pitch/yaw of a rotation matrix (tf::Matrix3x3::getRPY
    convention used at laser_odometry.cc:420-424)."""
    sy = -R[2, 0]
    sy = np.clip(sy, -1.0, 1.0)
    pitch = np.arcsin(sy)
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


@dataclasses.dataclass
class OdometryMsg:
    """nav_msgs/Odometry equivalent."""

    stamp: float
    frame_id: str
    child_frame_id: str
    pose: np.ndarray            # (4, 4) fixed <- base
    twist_linear: np.ndarray    # (3,) m/s, base frame
    twist_angular: np.ndarray   # (3,) rad/s (roll, pitch, yaw rates)


@dataclasses.dataclass
class TwistMsg:
    """geometry_msgs/TwistStamped equivalent."""

    stamp: float
    frame_id: str
    linear: np.ndarray
    angular: np.ndarray


@dataclasses.dataclass
class TransformMsg:
    """TF equivalent (fixed -> base)."""

    stamp: float
    frame_id: str
    child_frame_id: str
    transform: np.ndarray       # (4, 4)


class OdomPublisher:
    """Per-frame output assembly with finite-difference twist.

    ``t_base_laser``: (4, 4) base <- laser, the static transform the
    reference looks up once at startup (getBaseToLaserTf,
    laser_odometry.cc:368-393).  The engine solves in the laser frame; the
    published pose is re-expressed ``fixed <- base`` exactly like
    laser_odometry.cc:402."""

    def __init__(self, fixed_frame: str = "odom",
                 base_frame: str = "base_link",
                 t_base_laser: Optional[np.ndarray] = None,
                 publish_tf: bool = True):
        self.fixed_frame = fixed_frame
        self.base_frame = base_frame
        self.t_base_laser = (np.eye(4) if t_base_laser is None
                             else np.asarray(t_base_laser, float))
        self._t_laser_base = np.linalg.inv(self.t_base_laser)
        self.publish_tf = publish_tf
        self._prev_pose: Optional[np.ndarray] = None
        self._prev_stamp: Optional[float] = None
        self.history: List[OdometryMsg] = []

    def publish(self, pose_laser: np.ndarray, stamp: float
                ) -> Tuple[OdometryMsg, TwistMsg, Optional[TransformMsg]]:
        """pose_laser: (4, 4) odometry in the laser frame."""
        pose_laser = np.asarray(pose_laser, float)
        # fixed <- base  =  T_bl · (fixed <- laser) · T_lb
        pose_base = self.t_base_laser @ pose_laser @ self._t_laser_base

        lin = np.zeros(3)
        ang = np.zeros(3)
        if self._prev_pose is not None and self._prev_stamp is not None:
            dt = stamp - self._prev_stamp
            if dt > 0:
                delta = np.linalg.inv(self._prev_pose) @ pose_base
                lin = delta[:3, 3] / dt
                ang = _rpy(delta[:3, :3]) / dt
        self._prev_pose = pose_base
        self._prev_stamp = stamp

        odom = OdometryMsg(stamp, self.fixed_frame, self.base_frame,
                           pose_base, lin, ang)
        twist = TwistMsg(stamp, self.base_frame, lin, ang)
        tf = (TransformMsg(stamp, self.fixed_frame, self.base_frame,
                           pose_base) if self.publish_tf else None)
        self.history.append(odom)
        return odom, twist, tf
