from ._precision import f32_math
from .epnp import epnp, epnp_batched, keypoints_to_pose
from .projection import distort_normalized, project_keypoints, undistort_points
from .quaternion import (dcm2quat, quat2dcm, quat_angular_distance, quat_conj, quat_mul,
                         quat_normalize, rodrigues, weighted_mean_quaternion)
from .spn_position import compute_position_spn_batched

__all__ = ["f32_math", "epnp", "epnp_batched", "keypoints_to_pose", "distort_normalized",
           "project_keypoints", "undistort_points", "dcm2quat", "quat2dcm",
           "quat_angular_distance", "quat_conj", "quat_mul", "quat_normalize", "rodrigues",
           "weighted_mean_quaternion", "compute_position_spn_batched"]
