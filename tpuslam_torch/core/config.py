"""Configs copied field for field from ``tpuslam/core/config.py``.

The port cannot import the original: ``tpuslam/core/__init__.py`` pulls in
jax.  Names and defaults are the reference's (lesson2 PCL defaults, lesson3
plicp_odometry.cc:58-186, lesson6 mapper_params_outdoor.yaml + Mapper.cpp
defaults 1448-1964); a CPU test holds ``dataclasses.asdict`` of both
against each other.
"""

from __future__ import annotations

import dataclasses
import math

# correspondence search (not a reference knob): "auto" and "kernel" are
# the port's two values; the JAX package's "xla" / "pallas" are not ported
CORRESPONDENCE_METHODS = ("auto", "kernel")


def _check_method(method: str) -> None:
    if method not in CORRESPONDENCE_METHODS:
        raise ValueError(
            f"correspondence_method {method!r} is not ported; known: "
            f"{CORRESPONDENCE_METHODS}"
        )


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Lesson2 point-to-point ICP (PCL defaults, scan_match_icp.cc:135-164)."""

    max_iterations: int = 10  # PCL default
    max_correspondence_dist: float = 1.0
    transformation_epsilon: float = 1e-8
    # nearest-neighbour search: "auto" = the plain PyTorch chain (as the
    # JAX package chose for ICP); "kernel" = the nearest mode of the
    # csrc/plicp_corr.cu kernel on a CUDA device (its plain version on CPU)
    correspondence_method: str = "auto"
    num_beams: int = 1500

    def __post_init__(self):
        _check_method(self.correspondence_method)


@dataclasses.dataclass(frozen=True)
class PlicpConfig:
    """Lesson3 CSM PL-ICP knobs (plicp_odometry.cc:58-186); names/defaults 1:1.

    Fields that only steer CSM-internal heuristics we do not reproduce
    (corr tricks verification) are kept for config compatibility but
    ignored, as documented per field.
    """

    # keyframe gating (plicp_odometry.cc:63-67; yaml overrides 0.1 / 5)
    kf_dist_linear: float = 0.1
    kf_dist_angular: float = 5.0 * math.pi / 180.0
    kf_scan_count: int = 10

    # CSM core
    max_angular_correction_deg: float = 45.0
    max_linear_correction: float = 1.0
    max_iterations: int = 10
    epsilon_xy: float = 1e-6
    epsilon_theta: float = 1e-6
    max_correspondence_dist: float = 1.0
    sigma: float = 0.010  # noise scale: covariance + sigma weights
    use_corr_tricks: int = 1  # ignored (the search is dense anyway)
    restart: int = 0  # re-run from displaced guess on high error
    restart_threshold_mean_error: float = 0.01
    restart_dt: float = 1.0
    restart_dtheta: float = 0.1
    # scan clustering + neighbourhood normal fit (scan_orientations):
    # feed the alpha test and the ml incidence weights
    clustering_threshold: float = 0.25
    orientation_neighbourhood: int = 20
    use_point_to_line_distance: int = 1
    do_alpha_test: int = 0  # normal-compatibility gate
    do_alpha_test_thresholdDeg: float = 20.0
    outliers_maxPerc: float = 0.90
    outliers_adaptive_order: float = 0.7
    outliers_adaptive_mult: float = 2.0
    do_visibility_test: int = 0  # viewpoint monotonicity cull
    outliers_remove_doubles: int = 1
    do_compute_covariance: int = 0
    debug_verify_tricks: int = 0  # ignored
    use_ml_weights: int = 0  # incidence cos^2 weighting
    use_sigma_weights: int = 0  # uniform 1/sigma^2 scale
    # correspondence search: "auto" and "kernel" both run the
    # csrc/plicp_corr.cu kernel on a CUDA device and its plain version on
    # the CPU; do_alpha_test=1 and use_ml_weights=1 pin the plain chain
    # (the former reorders the gating, the latter needs the matched
    # point's fitted normal)
    correspondence_method: str = "auto"

    num_beams: int = 1500

    def __post_init__(self):
        _check_method(self.correspondence_method)


@dataclasses.dataclass(frozen=True)
class KartoConfig:
    """Lesson6 karto mapper params (mapper_params_outdoor.yaml + Mapper.cpp
    defaults 1448-1964); names 1:1 with the YAML."""

    # general
    use_scan_matching: bool = True
    use_scan_barycenter: bool = True
    minimum_time_interval: float = 3600.0
    minimum_travel_distance: float = 0.2
    minimum_travel_heading: float = 0.174
    scan_buffer_size: int = 70  # yaml outdoor: 110; default Mapper.cpp: 70
    scan_buffer_maximum_scan_distance: float = 20.0  # yaml outdoor: 50
    use_scan_range: float = 12.0  # karto_slam.cc:83 (range threshold)
    link_match_minimum_response_fine: float = 0.8  # Mapper.cpp:1517-1522
    link_scan_maximum_distance: float = 10.0  # Mapper.cpp:1523-1528

    # correlation (sequential matcher)
    correlation_search_space_dimension: float = 0.3
    correlation_search_space_resolution: float = 0.01  # yaml outdoor: 0.05
    correlation_search_space_smear_deviation: float = 0.03

    # loop closure search
    do_loop_closing: bool = True
    loop_search_space_dimension: float = 8.0  # yaml outdoor: 15.0
    loop_search_space_resolution: float = 0.05  # yaml outdoor: 0.1
    loop_search_space_smear_deviation: float = 0.03  # yaml outdoor: 0.3
    loop_search_maximum_distance: float = 4.0  # yaml outdoor: 15.0
    loop_match_minimum_chain_size: int = 10  # yaml outdoor: 5
    loop_match_maximum_variance_coarse: float = 0.4  # yaml outdoor: 3 (sqrt)
    loop_match_minimum_response_coarse: float = 0.8  # yaml outdoor: 0.35
    loop_match_minimum_response_fine: float = 0.8  # yaml outdoor: 0.45

    # scan matcher shaping (Mapper.cpp:309-523); penalty variances are the
    # UNSQUARED reference/YAML values, squared at consumption
    distance_variance_penalty: float = 0.3
    angle_variance_penalty: float = 0.349  # rad (yaml gives 0.1 "degrees")
    fine_search_angle_offset: float = 0.00349
    coarse_search_angle_offset: float = 0.349
    coarse_angle_resolution: float = 0.0349
    minimum_angle_penalty: float = 0.9
    minimum_distance_penalty: float = 0.5
    use_response_expansion: bool = False  # Mapper.cpp:1960-1964 (yaml: true)
    # response-surface computation (not a reference knob): the port takes
    # "auto" or "kernel", both of which run the CUDA kernel on a CUDA
    # device and its plain version on the CPU
    response_method: str = "auto"
    # True = reference-exact GetResponse denominator (every raw beam
    # counts, Mapper.cpp:819-856)
    count_invalid_in_denominator: bool = True
    # the lidar's TRUE beam count; None = num_beams.  Set it when scans
    # are padded beyond the lidar's reading count.
    num_range_readings: int | None = None

    # backend
    use_back_end: bool = True
    solver_type: str = "spa_solver"

    # occupancy grid export (Karto.h:5953-5968)
    min_pass_through: int = 2
    occupancy_threshold: float = 0.1
    resolution: float = 0.05

    num_beams: int = 1500


def outdoor_karto_config() -> KartoConfig:
    """The lesson6 outdoor dataset tuning (mapper_params_outdoor.yaml)."""
    return KartoConfig(
        minimum_travel_distance=0.2,
        minimum_travel_heading=0.174,
        scan_buffer_size=110,
        scan_buffer_maximum_scan_distance=50.0,
        use_scan_range=50.0,
        correlation_search_space_dimension=0.3,
        correlation_search_space_resolution=0.05,
        correlation_search_space_smear_deviation=0.03,
        loop_search_space_dimension=15.0,
        loop_search_space_resolution=0.1,
        loop_search_space_smear_deviation=0.3,
        link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5,
        loop_search_maximum_distance=15.0,
        loop_match_minimum_chain_size=5,
        loop_match_maximum_variance_coarse=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        distance_variance_penalty=0.3,
        # the node passes the raw YAML value to setParamAngleVariancePenalty
        # (karto_slam.cc:216-219), which squares it: effective 0.01 rad^2
        angle_variance_penalty=0.1,
        fine_search_angle_offset=0.00349,
        coarse_search_angle_offset=0.349,
        coarse_angle_resolution=0.0349,
        minimum_angle_penalty=0.9,
        minimum_distance_penalty=0.5,
        use_response_expansion=True,
    )
