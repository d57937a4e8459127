"""Reference-exact float64 oracle of lesson5's motion-distortion correction.

Scalar NumPy port of ``lesson5/src/lidar_undistortion.cc`` preserving its
exact op order and quirks:

- ``PruneImuDeque`` (175-249): seed rotation 0 at the FIRST gyro sample
  before scan start (the deque was pruned to ``>= t_start - 0.1``;
  callers here pass a pre-pruned queue), integrate
  ``rot[k] = rot[k-1] + omega * dt`` for samples inside the scan span,
  STOP at the first sample past scan end.
- ``PruneOdomDeque`` (252-336): start/end odometry messages bracket the
  scan; ``transBt = transBegin^-1 * transEnd`` via pcl's RPY convention;
  only the TRANSLATION increment survives (the rotation increment is
  extracted and discarded — odometry yaw never rotates the beams).
- ``ComputeRotation`` (398-432): per-beam linear interpolation between
  bracketing integrated samples, snapping to the bracket value when the
  beam time falls outside the integrated range.
- ``ComputePosition`` (435-447): linear ratio measured against the
  ODOMETRY MESSAGE times (not the scan span), unclamped.
- ``CorrectLaserScan`` (339-394): anchor transform taken at the first
  VALID beam (invalid leading beams shift the anchor), per-beam
  ``transBt = transStart^-1 * transFinal`` with
  ``pcl::getTransformation`` = Rz(yaw)·Ry(pitch)·Rx(roll), and the
  ``current_point_z = 1.0`` quirk: the planar beam is transformed as
  (x, y, 1), so roll/pitch leak a 1 m lever arm into x/y.  ``point_z=0``
  runs the physically-correct variant (tpuslam's default mode).

Used by tests/test_oracle_parity.py to differential-test
models/undistort.py.
"""

from __future__ import annotations

import math

import numpy as np


def pcl_transformation(x, y, z, roll, pitch, yaw) -> np.ndarray:
    """pcl::getTransformation: T = trans(x,y,z) · Rz(yaw)·Ry(pitch)·Rx(roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    t = np.eye(4)
    t[:3, :3] = (
        np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    )
    t[:3, 3] = (x, y, z)
    return t


class OracleUndistorter:
    def __init__(self, use_imu=True, use_odom=True, point_z=1.0):
        self.use_imu = use_imu
        self.use_odom = use_odom
        self.point_z = float(point_z)

    # lidar_undistortion.cc:175-249
    def prune_imu(self, imu_times, imu_w, t_start, t_end):
        times = np.asarray(imu_times, np.float64)
        w = np.asarray(imu_w, np.float64)  # [K, 3] (wx, wy, wz)
        if len(times) == 0 or times[0] > t_start or times[-1] < t_end:
            raise ValueError("IMU queue does not bracket the scan")
        rot = [np.zeros(3)]
        rt = []
        idx = 0
        for i in range(len(times)):
            if times[i] < t_start:
                if idx == 0:
                    rt = [times[i]]
                    idx = 1
                continue
            if times[i] > t_end:
                break
            dt = times[i] - rt[idx - 1]
            rot.append(rot[idx - 1] + w[i] * dt)
            rt.append(times[i])
            idx += 1
        self.imu_rot = np.asarray(rot[:idx])
        self.imu_time = np.asarray(rt[:idx])
        self.imu_last = idx - 1  # current_imu_index_ after the -1

    # lidar_undistortion.cc:252-336
    def prune_odom(self, odom_times, odom_poses, t_start, t_end):
        """odom_poses: [K, 6] (x, y, z, roll, pitch, yaw)."""
        times = np.asarray(odom_times, np.float64)
        poses = np.asarray(odom_poses, np.float64)
        if len(times) == 0 or times[0] > t_start or times[-1] < t_end:
            raise ValueError("odom queue does not bracket the scan")
        start = end = 0
        for i in range(len(times)):
            if times[i] < t_start:
                start = i
                continue
            if times[i] <= t_end:
                end = i
            else:
                break
        self.odom_t0 = times[start]
        self.odom_t1 = times[end]
        bt = np.linalg.inv(pcl_transformation(*poses[start])) @ (
            pcl_transformation(*poses[end])
        )
        # getTranslationAndEulerAngles: rotation increment DISCARDED
        self.odom_incre = bt[:3, 3].copy()

    # lidar_undistortion.cc:398-432
    def rotation_at(self, t):
        front = 0
        while front < self.imu_last:
            if t < self.imu_time[front]:
                break
            front += 1
        if t > self.imu_time[front] or front == 0:
            return self.imu_rot[front].copy()
        back = front - 1
        rf = (t - self.imu_time[back]) / (
            self.imu_time[front] - self.imu_time[back]
        )
        rb = (self.imu_time[front] - t) / (
            self.imu_time[front] - self.imu_time[back]
        )
        return self.imu_rot[front] * rf + self.imu_rot[back] * rb

    # lidar_undistortion.cc:435-447
    def position_at(self, t):
        ratio = (t - self.odom_t0) / (self.odom_t1 - self.odom_t0)
        return self.odom_incre * ratio

    # lidar_undistortion.cc:339-394
    def correct(self, ranges, angles, range_min, range_max,
                t_start, time_increment):
        ranges = np.asarray(ranges, np.float64)
        angles = np.asarray(angles, np.float64)
        out = np.zeros((len(ranges), 3))
        valid = np.zeros(len(ranges), bool)
        first = True
        trans_start_inv = np.eye(4)
        for i in range(len(ranges)):
            r = ranges[i]
            if not np.isfinite(r) or r < range_min or r > range_max:
                continue
            t = t_start + i * time_increment
            px = r * math.cos(angles[i])
            py = r * math.sin(angles[i])
            rot = self.rotation_at(t) if self.use_imu else np.zeros(3)
            pos = self.position_at(t) if self.use_odom else np.zeros(3)
            tf = pcl_transformation(pos[0], pos[1], pos[2],
                                    rot[0], rot[1], rot[2])
            if first:
                trans_start_inv = np.linalg.inv(tf)
                first = False
            bt = trans_start_inv @ tf
            p = bt @ np.array([px, py, self.point_z, 1.0])
            out[i] = p[:3]
            valid[i] = True
        return out, valid
